"""PyTorch port vs JAX package: DRSformer, DRSformerRefFusion and the
200L/SPA variant (use_mefc False), their top-k sparse attention, MSFN,
MEFC and sparse blocks, the weight conversion both ways and the evaluation
CLI's two derain tasks.

f32 on the CPU: ops and modules to 1e-5, whole networks to 1e-5 relative
in L2 (and 1e-4 elementwise, as tests/test_convert.py holds the JAX model
to the torch oracle); bf16 as stated at its tests.  JAX parameters come
from the port's state dict through the JAX package's own
`convert_state_dict`, never `model.init`; the JAX networks run jitted.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.models import drsformer as jd
from textualdegremoval_tpu.ops.attention import (
    tksa_attention as jax_tksa_attention,
)

from textualdegremoval_tpu_torch.convert import (
    load_jax_params, load_reference_checkpoint,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models import drsformer as pd
from textualdegremoval_tpu_torch.ops import tksa_attention

from torch_oracles import ODRSformer
from torch_port_util import assert_close, jax_tree, randn, randomize, t

SMALL = dict(dim=8, num_blocks=(1, 1, 1, 1), heads=(1, 1, 2, 2))
SMALL_REF = dict(SMALL, nf=8, ext_n_blocks=(1, 1, 1, 1),
                 reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


def _rel_l2(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("b,heads,c,n", [
    (2, 1, 4, 64),    # ks 2, 2, 3, 3: two levels coincide
    (1, 2, 8, 48),    # ks 4, 5, 6, 6
    (2, 2, 12, 40),   # ks 6, 8, 9, 9
    (1, 4, 24, 256),  # ks 12, 16, 18, 19
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tksa_attention_matches_jax(b, heads, c, n, dtype):
    """float32 to 1e-5; bf16 inputs, the same f32 statistics and one bf16
    product with v: within 2 bf16 ulps (2^-7 relative) of the JAX
    result's scale, which is C3's bf16 budget at one op."""
    rng = np.random.default_rng(c)
    q, k, v = (randn(rng, b, heads, c, n) for _ in range(3))
    temperature = 0.5 + rng.random((heads, 1, 1), np.float32)
    blend = randn(rng, 4, scale=0.3) + 0.2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_tksa_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              jnp.asarray(temperature), jnp.asarray(blend))
    got = tksa_attention(*(t(a).to(tdt) for a in (q, k, v)), t(temperature),
                         t(blend))
    assert got.dtype == tdt and got.shape == (b, heads, c, n)
    if dtype == "float32":
        assert_close(got, want)
    else:
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2 * 2 ** -7 * np.abs(want).max()


def test_tksa_attention_gradient_reaches_every_input():
    """The masks are comparisons, not a gather: a finite, non-zero
    gradient reaches q, k, v and the four blend weights."""
    rng = np.random.default_rng(3)
    q, k, v = (t(randn(rng, 1, 2, 8, 16)).requires_grad_()
               for _ in range(3))
    blend = t(np.full(4, 0.2, np.float32)).requires_grad_()
    out = tksa_attention(q, k, v, torch.ones(2, 1, 1), blend)
    out.square().sum().backward()
    for g in (q.grad, k.grad, v.grad, blend.grad):
        assert torch.isfinite(g).all() and g.abs().sum() > 0


@pytest.mark.parametrize("port,jax_module,name,c", [
    (lambda: pd.MSFN(8), lambda: jd.MSFN(8), "ffn", 8),
    (lambda: pd.MSFN(12, bias=True), lambda: jd.MSFN(12, use_bias=True),
     "ffn", 12),
    (lambda: pd.TKSAAttention(8, 2), lambda: jd.TKSAAttention(8, 2), "attn",
     8),
    (lambda: pd.SparseTransformerBlock(8, 2),
     lambda: jd.SparseTransformerBlock(8, 2), "blk", 8),
    (lambda: pd.SparseTransformerBlock(16, 1, ln_type="BiasFree",
                                       fusion=True),
     lambda: jd.SparseTransformerBlock(16, 1, ln_type="BiasFree",
                                       fusion=True), "blk", 16),
    (lambda: pd.MEFC(8), lambda: jd.MEFC(8), "encoder_level0", 8),
])
def test_module_matches_jax(port, jax_module, name, c):
    """Each module at the reference's name in its network (the key
    rewrite depends on it), float32, to 1e-5."""
    m = randomize(port(), 5, scale=0.2)
    x = randn(np.random.default_rng(6), 2, 12, 10, c)
    want = jax_module().apply({"params": jax_tree(m, name)}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(m(t(x)), want)


def test_avg_pool_excludes_padding():
    x = randn(np.random.default_rng(7), 2, 5, 7, 3)
    assert_close(pd._AvgPool3x3()(t(x)), jd._avg_pool_3x3(jnp.asarray(x)))


def _net_pair(kind, use_mefc, seed):
    if kind == "plain":
        m = pd.DRSformer(**SMALL, use_mefc=use_mefc)
        j = jd.DRSformer(**SMALL, use_mefc=use_mefc)
    else:
        m = pd.DRSformerRefFusion(**SMALL_REF, use_mefc=use_mefc)
        j = jd.DRSformerRefFusion(**SMALL_REF, use_mefc=use_mefc)
    return randomize(m, seed, scale=0.1).eval(), j


@pytest.mark.parametrize("kind,use_mefc", [("plain", True), ("plain", False),
                                           ("ref", True), ("ref", False)])
def test_network_matches_jax(kind, use_mefc):
    """f32, 36 x 44 px (padded to the trunk's multiple inside): 1e-5
    relative in L2, 1e-4 elementwise."""
    m, j = _net_pair(kind, use_mefc, 11)
    rng = np.random.default_rng(12)
    x = rng.random((1, 36, 44, 3), np.float32)
    ref = rng.random((1, 36, 44, 3), np.float32)
    args = (x,) if kind == "plain" else (x, ref)
    want = jax.jit(j.apply)({"params": convert_state_dict(m.state_dict())},
                            *map(jnp.asarray, args))
    with torch.no_grad():
        got = m(*map(t, args))
    assert got.shape == want.shape == (1, 36, 44, 3)
    assert _rel_l2(got, want) <= 1e-5
    assert_close(got, want, atol=1e-4, rtol=0)


def test_refusion_bf16_matches_jax():
    """bf16 compute, f32 parameters, on the same weights: within C3's
    budget of 3% in L2 (the frameworks round the bf16 products and
    XLA keeps excess precision where torch rounds)."""
    m, j = _net_pair("ref", True, 13)
    m.dtype = torch.bfloat16
    j = j.clone(dtype=jnp.bfloat16)
    rng = np.random.default_rng(14)
    x = rng.random((1, 32, 32, 3), np.float32)
    ref = rng.random((1, 32, 32, 3), np.float32)
    want = jax.jit(j.apply)({"params": convert_state_dict(m.state_dict())},
                            jnp.asarray(x), jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(x), t(ref))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, np.asarray(want.astype(jnp.float32))) <= 3e-2


def test_plain_network_matches_the_torch_oracle():
    """The reference-layout torch oracle (the 200L/SPA trunk, exact-k
    masks) loads into the port with strict=True and gives its output
    (random data has no ties, so >= and exact-k keep the same
    entries)."""
    om = randomize(ODRSformer(**SMALL), seed=15, scale=0.1).eval()
    m = pd.DRSformer(**SMALL, use_mefc=False)
    m.load_state_dict(om.state_dict(), strict=True)
    x = np.random.default_rng(16).random((1, 32, 32, 3), np.float32)
    with torch.no_grad():
        want = om(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert_close(m.eval()(t(x)), want.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("use_mefc", [True, False])
def test_jax_params_load_back(use_mefc):
    """load_jax_params is the inverse of the JAX converter, MEFC included:
    every leaf of the JAX tree lands on its port tensor, none left over."""
    m, _ = _net_pair("ref", use_mefc, 17)
    back = load_jax_params(pd.DRSformerRefFusion(**SMALL_REF,
                                                 use_mefc=use_mefc),
                           convert_state_dict(m.state_dict()))
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_reference_checkpoint_with_mefc_loads_strict(tmp_path):
    """A reference-layout `.pth` (`params`, DDP's `module.` prefix, MEFC's
    subnet keys) loads with strict=True."""
    m, _ = _net_pair("ref", True, 19)
    sd = m.state_dict()
    assert any(".layers.1._ops.3._ops.6.op.1." in k for k in sd)
    path = tmp_path / "net_g.pth"
    torch.save({"params": {f"module.{k}": v for k, v in sd.items()}}, path)
    got = load_reference_checkpoint(pd.DRSformerRefFusion(**SMALL_REF),
                                    str(path))
    for k, v in sd.items():
        assert torch.equal(got.state_dict()[k], v), k


def test_define_network_builds_the_family():
    opt = {"type": "DRSformer200L_SPA_RefFusion", "dim": 8,
           "num_blocks": [1, 1, 1, 1], "heads": [1, 1, 2, 2],
           "LayerNorm_type": "BiasFree", "use_mefc": False, "nf": 8,
           "ext_n_blocks": [1, 1, 1, 1], "reffusion_n_blocks": [1, 1, 1, 1],
           "lr_block_size": 4}
    m = define_network(opt, dtype=torch.bfloat16)
    assert isinstance(m, pd.DRSformerRefFusion) and not m.training
    assert not m.use_mefc and not hasattr(m, "encoder_level0")
    assert m.encoder_level1[0].norm1.ln_type == "BiasFree"
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert m.dtype == torch.bfloat16
    m = define_network(dict(opt, type="DRSformerRefFusion", use_mefc=True))
    assert isinstance(m.encoder_level0, pd.MEFC)
    assert isinstance(define_network({"type": "DRSformer", "dim": 8}),
                      pd.DRSformer)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    import cv2

    from textualdegremoval_tpu_torch.cli.evaluate import (
        TASK_TABLE, shrink_for_smoke,
    )

    root = tmp_path_factory.mktemp("evald")
    rng = np.random.default_rng(0)
    for sub in ("hq", "lq", "ref"):
        (root / sub).mkdir()
    for i in range(2):
        img = (rng.random((32, 40, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "hq" / f"{i}.png"), img)
        noisy = img.astype(np.int16) + rng.integers(-20, 21, img.shape)
        cv2.imwrite(str(root / "lq" / f"{i}.png"),
                    np.clip(noisy, 0, 255).astype(np.uint8))
        cv2.imwrite(str(root / "ref" / f"{i}.png"),
                    np.ascontiguousarray(img[::-1]))
    for task in ("drsformer_derain", "drsformer_derain_200l_spa"):
        m = randomize(define_network(shrink_for_smoke(TASK_TABLE[task])),
                      seed=9, scale=0.1)
        torch.save({"params": m.state_dict()}, root / f"{task}.pth")
    return root


@pytest.mark.parametrize("task", ["drsformer_derain",
                                  "drsformer_derain_200l_spa"])
def test_evaluate_cli_matches_jax_cli(eval_dirs, task):
    """--task ... --tiny_debug with --lqroot on the CPU against the JAX
    CLI on the same checkpoint: PSNR and SSIM to 1e-3."""
    from textualdegremoval_tpu.cli.evaluate import main as jax_main
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", task, "--tiny_debug",
            "--hqroot", str(eval_dirs / "hq"),
            "--lqroot", str(eval_dirs / "lq"),
            "--refroot", str(eval_dirs / "ref"),
            "--checkpoint_path", str(eval_dirs / f"{task}.pth")]
    want = jax_main(argv)
    got = main(argv + ["--device", "cpu"])
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3
    with pytest.raises(SystemExit, match="no Restormer stages"):
        main(argv + ["--device", "cpu", "--chain"])
