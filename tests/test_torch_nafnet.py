"""PyTorch port vs JAX package: NAFNet layers, NAFNet and NAFNetRefFusion,
weight conversion, the network registry, one training step and the
evaluation CLI.  f32 on the CPU: layers to atol/rtol 1e-5, whole models to
atol 2e-4 (as tests/test_torch_restormer.py); bf16 and the training step
with their reasons at each assert."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import textualdegremoval_tpu.models.layers as jl
from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.losses import build_loss as j_build_loss
from textualdegremoval_tpu.models.nafnet import (
    NAFNet as JNAFNet, NAFNetRefFusion as JNAFNetRefFusion,
)
from textualdegremoval_tpu.ops.tlc import (
    local_avg_pool as j_local_avg_pool, tlc_kernel_size as j_tlc_kernel_size,
)
from textualdegremoval_tpu.train import schedules as jsched
from textualdegremoval_tpu.train.trainer import (
    build_optimizer as j_build_optimizer,
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)

import textualdegremoval_tpu_torch.models.layers as pl
from textualdegremoval_tpu_torch.convert import (
    load_jax_params, load_reference_checkpoint,
)
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.nafnet import NAFNet, NAFNetRefFusion
from textualdegremoval_tpu_torch.models.nafnet_dynamic import (
    NAFNetDynamicFusion,
)
from textualdegremoval_tpu_torch.ops.tlc import (
    local_avg_pool, tlc_kernel_size,
)
from textualdegremoval_tpu_torch.train import schedules as sched
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state, make_train_step,
)

from torch_port_util import (  # noqa: F401  (a fixture)
    randn, t, randomize, jax_tree, assert_close, torch_share_of_cores,
)
from torch_oracles import ONAFNet, ONAFNetRefFusion

TINY = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1, 1, 1),
            dec_blk_nums=(1, 1, 1, 1))
TINY_REF = dict(TINY, nf=8, ext_n_blocks=(1, 1, 1, 1),
                reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


@pytest.mark.parametrize("kernel", [(3, 5), (1, 1), (6, 2), (7, 9), (9, 9)])
def test_local_avg_pool_matches_jax(kernel):
    """Box averages with replicate auto_pad; (7, 9) and (9, 9) cover the
    7 x 9 image: the global-mean shortcut."""
    x = randn(np.random.default_rng(0), 2, 7, 9, 4)
    assert_close(local_avg_pool(t(x), kernel), j_local_avg_pool(x, kernel))


def test_tlc_kernel_size_matches_jax():
    for args in [((384, 384), (256, 256), (720, 1280)),
                 ((24, 36), (16, 24), (45, 80))]:
        assert tlc_kernel_size(*args) == j_tlc_kernel_size(*args)


class _SCAHolder(torch.nn.Module):
    """An SCA at attribute `sca` of a block, where its keys convert."""

    def __init__(self, c):
        super().__init__()
        self.sca = pl.SCA(c)


@pytest.mark.parametrize("tlc_kernel", [None, (3, 4)])
def test_sca_matches_jax(tlc_kernel):
    m = randomize(_SCAHolder(12), seed=1, scale=0.3)
    x = randn(np.random.default_rng(2), 2, 6, 8, 12)
    want = jl.SCA(12, tlc_kernel).apply(
        {"params": jax_tree(m, "blk")["sca"]}, jnp.asarray(x))
    assert_close(m.sca(t(x), tlc_kernel), want)


def test_layer_norm_2d_matches_jax():
    m = randomize(pl.LayerNorm2d(12), seed=3, scale=0.5)
    x = randn(np.random.default_rng(4), 2, 6, 8, 12) * 3 + 1
    want = jl.LayerNorm2d(12).apply({"params": jax_tree(m, "norm1")},
                                    jnp.asarray(x))
    assert_close(m(t(x)), want)


@pytest.mark.parametrize("kw", [
    {},                                   # fused route: nafblock_ref on CPU
    {"tlc_kernel": (3, 5)},               # TLC local pool: module path
    {"dw_expand": 1, "ffn_expand": 3},    # other expansions: module path
])
def test_nafblock_matches_jax(kw):
    blk = randomize(pl.NAFBlock(8, **kw), seed=5, scale=0.3)
    x = randn(np.random.default_rng(6), 2, 6, 7, 8)
    want = jl.NAFBlock(8, fused=False, **kw).apply(
        {"params": jax_tree(blk, "blk")}, jnp.asarray(x))
    assert_close(blk(t(x)), want)
    assert_close(blk.module_forward(t(x), kw.get("tlc_kernel")), want)


def _port(cls, kw, seed):
    """Seeded N(0, 0.05^2) parameters, beta and gamma included (zero in a
    fresh network): every block adds to its input, and a tiny network's
    output stays O(1)."""
    return randomize(cls(**kw), seed).eval()


@pytest.mark.parametrize("ref_hw", [(64, 64), (72, 80)])
def test_ref_fusion_matches_jax(ref_hw):
    """(64, 64): lq and ref in one batched MASA encoder pass; (72, 80): two
    passes, the reference padded to 128 x 128."""
    m = _port(NAFNetRefFusion, TINY_REF, seed=7)
    rng = np.random.default_rng(8)
    lq = randn(rng, 1, 60, 64, 3)  # padded to 64 x 64
    ref = randn(rng, 1, *ref_hw, 3)
    params = {"params": convert_state_dict(m.state_dict())}
    want = jax.jit(JNAFNetRefFusion(**TINY_REF).apply)(
        params, jnp.asarray(lq), jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(lq), t(ref))
    assert got.shape == want.shape == lq.shape
    assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("tlc_train_size", [None, (16, 16)])
def test_nafnet_matches_jax(tlc_train_size):
    """The plain trunk, and the Local (TLC) variant, whose SCA pools take
    the module path with their level's kernel."""
    kw = dict(TINY, tlc_train_size=tlc_train_size)
    m = _port(NAFNet, kw, seed=9)
    x = randn(np.random.default_rng(10), 1, 20, 28, 3)  # padded to 32 x 32
    want = jax.jit(JNAFNet(**kw).apply)(
        {"params": convert_state_dict(m.state_dict())}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(m(t(x)), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("cls,jcls,kw", [
    (NAFNetRefFusion, JNAFNetRefFusion, TINY_REF), (NAFNet, JNAFNet, TINY)])
def test_bf16_matches_jax_on_f32_weights(cls, jcls, kw):
    """Compute dtype bf16 over f32 parameters on both sides (JAX
    `dtype=jnp.bfloat16`): the port casts each weight at use and keeps the
    LayerNorm affine in f32.  The frameworks sum in other orders and round
    a conv's bias add differently, so an output of magnitude <= 4 may
    differ by about one bf16 ulp there (2^-6): bound 0.02 absolute.  Each
    of the (up to 14) blocks rounds some ten times, where a Restormer block
    rounds fewer, so the L2 bound is 3e-3 relative, not the Restormer
    test's 1e-3 (measured 1.2e-3 on NAFNetRefFusion)."""
    m = _port(cls, kw, seed=11)
    m.dtype = torch.bfloat16
    rng = np.random.default_rng(12)
    args = [randn(rng, 1, 64, 64, 3) for _ in range(
        2 if cls is NAFNetRefFusion else 1)]
    params = {"params": convert_state_dict(m.state_dict())}
    want = jax.jit(jcls(**kw, dtype=jnp.bfloat16).apply)(
        params, *map(jnp.asarray, args))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = m(*map(t, args))
    assert got.dtype == torch.bfloat16
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)
    assert np.linalg.norm(got - want) <= 3e-3 * np.linalg.norm(want)


@pytest.mark.parametrize("cls,kw", [(NAFNetRefFusion, TINY_REF),
                                    (NAFNet, TINY)])
def test_load_jax_params_round_trips_bitwise(cls, kw):
    src = _port(cls, kw, seed=13)
    tree = convert_state_dict(src.state_dict())
    # the JAX names: the deep encoder's blocks, the middle fuse, ups, SCA
    assert "encoders_3_0" in tree and "ups_0" in tree
    assert tree["encoders_0_0"]["beta"].shape == (1, 1, 1, 8)
    assert "conv" in tree["middle_blks_0"]["sca"]
    if cls is NAFNetRefFusion:
        assert "masa_blk_middle_0_0" in tree and "masa_blk_enc_3_0" in tree
    dst = load_jax_params(cls(**kw), tree)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    tree["ups_0"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(cls(**kw), tree)


def test_deep_encoder_keys_map_to_jax_names():
    from textualdegremoval_tpu_torch.convert import torch_key_to_jax_path

    assert torch_key_to_jax_path("encoders.3.27.sca.1.weight", 4) == (
        "encoders_3_27", "sca", "conv", "kernel")
    assert torch_key_to_jax_path("masa_blk_middle.0.0.gamma", 4) == (
        "masa_blk_middle_0_0", "gamma")
    assert torch_key_to_jax_path("module.ups.2.0.weight", 4) == (
        "ups_2", "kernel")


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("oracle,port", [
    (lambda: ONAFNetRefFusion(**TINY_REF),
     lambda: NAFNetRefFusion(**TINY_REF)),
    (lambda: ONAFNet(**TINY), lambda: NAFNet(**TINY)),
])
def test_reference_checkpoint_loads_strict(tmp_path, oracle, port):
    sd = randomize(oracle(), seed=14).state_dict()
    path = tmp_path / "net_g.pth"
    torch.save({"params": sd}, path)
    m = load_reference_checkpoint(port(), str(path))
    for k, v in sd.items():
        assert torch.equal(m.state_dict()[k], v), k


@pytest.mark.usefixtures("torch_share_of_cores")
def test_define_network_nafnet_family():
    opt = {"type": "NAFNetRefFusion",
           **{k: list(v) if isinstance(v, tuple) else v
              for k, v in TINY_REF.items()}}
    m = define_network(opt, dtype=torch.bfloat16)
    assert isinstance(m, NAFNetRefFusion) and m.tlc_train_size is None
    assert m.dtype == torch.bfloat16
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert sum(isinstance(b, pl.NAFBlock) for b in m.modules()) == 14
    local = define_network({"type": "NAFNetLocal", "width": 8,
                            "enc_blk_nums": [1], "dec_blk_nums": [1],
                            "train_size": [1, 3, 64, 48]})
    assert isinstance(local, NAFNet) and local.tlc_train_size == (64, 48)
    local = define_network({**opt, "type": "NAFNetLocal_RefFusion"})
    assert local.tlc_train_size == (256, 256)
    # the DiffIR net and its Local name build the ported class (no TLC)
    for name in ("NAFNetDynamicFusion", "NAFNetLocalDynamic"):
        dyn = define_network({"type": name, "width": 8, "enc_blk_nums": [1],
                              "dec_blk_nums": [1], "num_words": 2,
                              "train_size": [1, 3, 64, 48]})
        assert isinstance(dyn, NAFNetDynamicFusion) and dyn.num_words == 2


def _batch(seed, b=2, hw=64):
    """lq, a reference that is lq shifted (so the MASA search has one clear
    best match, never a near tie that summation order could flip) and gt."""
    rng = np.random.default_rng(seed)
    lq = rng.random((b, hw, hw, 3), np.float32)
    ref = np.ascontiguousarray(np.roll(lq, (3, -5), (1, 2)))
    return {"lq": lq, "ref": ref,
            "gt": np.clip(lq + 0.1 * randn(rng, b, hw, hw, 3), 0, 1)}


# two trunk levels (a 3-level MASA pyramid): the same code paths as
# TINY_REF, with a JAX train step that compiles in half the time
TINY_STEP = dict(width=8, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1), nf=8,
                 ext_n_blocks=(1, 1), reffusion_n_blocks=(1, 1),
                 lr_block_size=4)


def test_train_step_matches_jax():
    """One step of a tiny NAFNetRefFusion as nafnet_motion_deblur.yml
    trains it: PSNR loss, AdamW 2e-4 / ref 1e-4 cosine, wd 1e-4, clip
    0.01, the masa group frozen (param_fix_iterations 1, the structurally
    frozen step on both sides, so neither counts masa gradients in
    grad_norm), EMA 0.9."""
    model = _port(NAFNetRefFusion, TINY_STEP, seed=15).train()
    batch = _batch(16, hw=32)
    s_lr = {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 10],
            "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
    loss_opt = {"type": "PSNRLoss", "loss_weight": 1, "reduction": "mean"}

    params = convert_state_dict(model.state_dict())
    tx = j_build_optimizer(params, jsched.build_schedule(2e-4, s_lr),
                           jsched.build_schedule(1e-4, s_lr),
                           param_fix_iterations=1)
    jstate = j_create_train_state(params, tx)
    jstep = j_make_train_step(JNAFNetRefFusion(**TINY_STEP).apply,
                              j_build_loss(loss_opt), tx, ema_decay=0.9,
                              donate=False, masa_frozen=True)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    opt = build_optimizer(model, sched.build_schedule(2e-4, s_lr),
                          sched.build_schedule(1e-4, s_lr),
                          param_fix_iterations=1)
    state = create_train_state(model, opt, ema_decay=0.9)
    step = make_train_step(build_loss(loss_opt), ema_decay=0.9,
                           masa_frozen=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = step(state, {k: t(v) for k, v in batch.items()})

    # forward and backward in f32 in other orders: the loss and the norm
    # agree to f32 summation noise
    assert float(m["l_pix"]) == pytest.approx(float(jm["l_pix"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    # the clipped Adam update moves each trunk parameter by about lr; an
    # element whose gradient is near 0 may get its sign from noise, so the
    # bound is on the update, with a few ulps of lr; masa stays frozen
    got = convert_state_dict(state.model.state_dict())
    got_ema = convert_state_dict(state.ema_state_dict())
    for (path, g), (_, w), (_, e), (_, we) in zip(
            _flat(got), _flat(jstate.params), _flat(got_ema),
            _flat(jstate.ema_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=path)
        np.testing.assert_allclose(e, we, rtol=0, atol=2e-7, err_msg=path)
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved and not any("masa" in k for k in moved)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(tree[k])


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("nafnet_evald")
    rng = np.random.default_rng(0)
    for sub in ("hq", "ref"):
        (root / sub).mkdir()
    for i in range(2):
        img = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "hq" / f"{i}.png"), img)
        cv2.imwrite(str(root / "ref" / f"{i}.png"),
                    np.ascontiguousarray(img[::-1]))
    sd = _port(NAFNetRefFusion, TINY_REF, seed=17).state_dict()
    torch.save({"params": sd}, root / "net_g.pth")
    return root


def test_evaluate_cli_matches_jax_cli(eval_dirs):
    from textualdegremoval_tpu.cli.evaluate import main as jax_main
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", "nafnet_deblur", "--sigma", "15", "--tiny_debug",
            "--hqroot", str(eval_dirs / "hq"),
            "--refroot", str(eval_dirs / "ref"),
            "--checkpoint_path", str(eval_dirs / "net_g.pth")]
    want = jax_main(argv)
    got = main(argv + ["--device", "cpu"])
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3
