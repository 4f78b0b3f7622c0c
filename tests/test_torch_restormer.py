"""PyTorch port vs JAX package: Restormer layers, whole models, weight
conversion, network registry and the evaluation CLI.  f32 on CPU; layers
to atol/rtol 1e-5, whole models to atol 2e-4 (as tests/test_convert.py
holds the JAX model to the torch oracle)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import textualdegremoval_tpu.models.layers as jl
from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.models.restormer import (
    Restormer as JRestormer, RestormerRefFusion as JRestormerRefFusion,
)

import textualdegremoval_tpu_torch.models.layers as pl
from textualdegremoval_tpu_torch.convert import (
    load_jax_params, load_reference_checkpoint,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.restormer import (
    Restormer, RestormerRefFusion,
)

from torch_port_util import randn, t, randomize, jax_tree, assert_close
from torch_oracles import ORestormer, ORestormerRefFusion

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            heads=(1, 1, 2, 2))
TINY_REF = dict(TINY, nf=8, ext_n_blocks=(1, 1, 1, 1),
                reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


@pytest.mark.parametrize("name,port,jax_mod,cin", [
    ("norm1", lambda: pl.ChannelLayerNorm(12, "WithBias"),
     lambda: jl.ChannelLayerNorm(12, "WithBias"), 12),
    ("norm2", lambda: pl.ChannelLayerNorm(12, "BiasFree"),
     lambda: jl.ChannelLayerNorm(12, "BiasFree"), 12),
    ("attn", lambda: pl.MDTAAttention(12, 2),
     lambda: jl.MDTAAttention(12, 2), 12),
    ("ffn", lambda: pl.GDFN(12), lambda: jl.GDFN(12, fused=False), 12),
    ("patch_embed", lambda: pl.OverlapPatchEmbed(3, 8),
     lambda: jl.OverlapPatchEmbed(8), 3),
    ("down1_2", lambda: pl.Downsample(8), lambda: jl.Downsample(8), 8),
    ("up2_1", lambda: pl.Upsample(8), lambda: jl.Upsample(8), 8),
    ("conv_L2", lambda: pl.Conv3x3(4, 8, stride=2),
     lambda: jl.Conv3x3(8, stride=2, impl="conv"), 4),
    ("blk", lambda: pl.ResidualBlock(6), lambda: jl.ResidualBlock(6), 6),
])
def test_layer_matches_jax(name, port, jax_mod, cin):
    m = randomize(port(), seed=1, scale=0.3)
    x = randn(np.random.default_rng(2), 2, 6, 8, cin)
    want = jax_mod().apply({"params": jax_tree(m, name)}, jnp.asarray(x))
    got = pl.conv_nhwc(m, t(x)) if isinstance(m, torch.nn.Conv2d) else m(t(x))
    assert_close(got, want)


def _port_ref_fusion(seed=0, **kw):
    return randomize(RestormerRefFusion(**{**TINY_REF, **kw}), seed).eval()


@pytest.mark.parametrize("ref_hw,kw", [
    ((32, 32), {}),                      # one batched MASA encoder pass
    ((40, 48), {}),                      # lq and ref differ: two passes
    ((32, 32), dict(ln_type="BiasFree", dual_pixel_task=True,
                    inp_channels=6)),    # BiasFree LN, dual-pixel skip
])
def test_ref_fusion_matches_jax(ref_hw, kw):
    m = _port_ref_fusion(**kw)
    rng = np.random.default_rng(3)
    lq = randn(rng, 1, 32, 32, kw.get("inp_channels", 3))
    ref = randn(rng, 1, *ref_hw, 3)
    params = {"params": convert_state_dict(m.state_dict())}
    # jitted: one compile is faster on the CPU than eager op-by-op dispatch
    want = jax.jit(JRestormerRefFusion(**{**TINY_REF, **kw}).apply)(
        params, jnp.asarray(lq), jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(lq), t(ref))
    assert got.shape == want.shape
    assert_close(got, want, atol=2e-4, rtol=0)


def test_restormer_matches_jax():
    m = randomize(Restormer(**TINY), seed=4).eval()
    x = randn(np.random.default_rng(5), 1, 20, 28, 3)  # padded to 24 x 32
    want = jax.jit(JRestormer(**TINY).apply)(
        {"params": convert_state_dict(m.state_dict())}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(m(t(x)), want, atol=2e-4, rtol=0)


def test_load_jax_params_round_trips_bitwise():
    src = _port_ref_fusion(seed=6)
    tree = convert_state_dict(src.state_dict())
    dst = load_jax_params(RestormerRefFusion(**TINY_REF), tree)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    tree["patch_embed"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(RestormerRefFusion(**TINY_REF), tree)


@pytest.mark.parametrize("oracle,port", [
    (lambda: ORestormerRefFusion(**TINY_REF),
     lambda: RestormerRefFusion(**TINY_REF)),
    (lambda: ORestormer(**TINY), lambda: Restormer(**TINY)),
])
def test_reference_checkpoint_loads_strict(tmp_path, oracle, port):
    sd = randomize(oracle(), seed=7).state_dict()
    path = tmp_path / "net_g.pth"
    torch.save({"params": {f"module.{k}": v for k, v in sd.items()}}, path)
    m = load_reference_checkpoint(port(), str(path))
    for k, v in sd.items():
        assert torch.equal(m.state_dict()[k], v), k


def test_define_network():
    opt = {"type": "RestormerRefFusion", "LayerNorm_type": "BiasFree",
           **{k: list(v) if isinstance(v, tuple) else v
              for k, v in TINY_REF.items()}}
    m = define_network(opt, dtype=torch.bfloat16)
    assert isinstance(m, RestormerRefFusion) and not m.training
    assert m.encoder_level1[0].ln_type == "BiasFree"
    # parameters stay f32 (JAX param_dtype); bf16 is the compute dtype
    assert m.dtype == torch.bfloat16
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    # every family of the JAX registry is ported (NAFNetLocalDynamic since
    # the DiffIR slice, tests/test_torch_nafnet.py); a name outside it
    # still raises
    with pytest.raises(KeyError, match="unknown network type"):
        define_network({"type": "NAFNetNothing", "width": 8})


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("evald")
    rng = np.random.default_rng(0)
    for sub in ("hq", "ref"):
        (root / sub).mkdir()
    for i in range(2):
        img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "hq" / f"{i}.png"), img)
        cv2.imwrite(str(root / "ref" / f"{i}.png"),
                    np.ascontiguousarray(img[::-1]))
    sd = _port_ref_fusion(seed=8).state_dict()
    torch.save({"params": sd}, root / "net_g.pth")
    return root


def test_evaluate_cli_matches_jax_cli(eval_dirs):
    from textualdegremoval_tpu.cli.evaluate import main as jax_main
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", "tiny_smoke", "--sigma", "15", "--tiny_debug",
            "--hqroot", str(eval_dirs / "hq"),
            "--refroot", str(eval_dirs / "ref"),
            "--checkpoint_path", str(eval_dirs / "net_g.pth")]
    want = jax_main(argv)
    got = main(argv + ["--device", "cpu"])
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3


def test_evaluate_cli_refuses_what_is_not_ported(eval_dirs):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", "tiny_smoke", "--hqroot", str(eval_dirs / "hq"),
            "--refroot", str(eval_dirs / "ref"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="spatial_shard"):
        main(argv + ["--spatial_shard", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            main(argv[:-2] + ["--device", "cuda"])


def test_ref_fusion_bf16_matches_jax_on_f32_weights():
    """Compute dtype bf16 over f32 parameters on both sides (JAX
    `dtype=jnp.bfloat16`, `param_dtype=float32`): the port casts each weight
    at use and keeps LN affine, temperatures and gates in f32.  The two
    frameworks sum in other orders and may round a conv's bias add
    differently, so an output of magnitude <= 4 may differ by about one
    bf16 ulp there (2^-6): bound 0.02 absolute and 1e-3 relative in L2
    (measured: 3.9e-3 and 1.2e-4)."""
    m = _port_ref_fusion(seed=8)
    m.dtype = torch.bfloat16
    rng = np.random.default_rng(9)
    lq = randn(rng, 1, 32, 32, 3)
    ref = randn(rng, 1, 32, 32, 3)
    params = {"params": convert_state_dict(m.state_dict())}
    want = jax.jit(JRestormerRefFusion(**TINY_REF, dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(lq), jnp.asarray(ref))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = m(t(lq), t(ref))
    assert got.dtype == torch.bfloat16
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
