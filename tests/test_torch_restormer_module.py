"""PyTorch port vs JAX package: the module path of TransformerBlock as a
route (fused=False), with the GDFN kernel (gdfn_fused) and the MDTA
statistics kernel (mdta_pallas) on it.

On the CPU, f32: whole networks on the module path against JAX's module
path (`fused=False`) at 2e-4, as tests/test_torch_restormer.py holds the
default route; the routing options' validation and threading; the
evaluation CLI's --module_blocks / --gdfn_kernel / --mdta_kernel and the
training CLI's --fused off / --gdfn_kernel, and their refusals.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.models.restormer import (
    Restormer as JRestormer, RestormerRefFusion as JRestormerRefFusion,
)

from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.layers import (
    GDFN, TBlockStage, TransformerBlock, TransformerResFusionBlock,
)
from textualdegremoval_tpu_torch.models.restormer import (
    Restormer, RestormerRefFusion,
)

from torch_port_util import randn, t, randomize, assert_close
from test_torch_cli_train import workspace  # noqa: F401

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            heads=(1, 1, 2, 2))
TINY_REF = dict(TINY, nf=8, ext_n_blocks=(1, 1, 1, 1),
                reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)
MODULE_ROUTE = dict(fused=False, gdfn_fused=True, mdta_pallas=True)


def _blocks(model):
    return [m for m in model.modules() if isinstance(m, TransformerBlock)]


@pytest.mark.parametrize("route", [
    MODULE_ROUTE,
    dict(fused=False),                     # the module path op by op
    dict(fused=False, gdfn_fused=True),    # one kernel at a time
])
def test_ref_fusion_module_path_matches_jax(route):
    m = randomize(RestormerRefFusion(**TINY_REF, **route), seed=0).eval()
    rng = np.random.default_rng(3)
    lq = randn(rng, 1, 32, 32, 3)
    ref = randn(rng, 1, 32, 32, 3)
    params = {"params": convert_state_dict(m.state_dict())}
    want = jax.jit(JRestormerRefFusion(**TINY_REF, fused=False).apply)(
        params, jnp.asarray(lq), jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(lq), t(ref))
    assert got.shape == want.shape
    assert_close(got, want, atol=2e-4, rtol=0)


def test_restormer_module_path_matches_jax():
    m = randomize(Restormer(**TINY, **MODULE_ROUTE), seed=4).eval()
    x = randn(np.random.default_rng(5), 1, 20, 28, 3)  # padded to 24 x 32
    want = jax.jit(JRestormer(**TINY, fused=False).apply)(
        {"params": convert_state_dict(m.state_dict())}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(m(t(x)), want, atol=2e-4, rtol=0)


def test_module_path_checkpoints_interchange_with_the_default_route():
    """The routes share parameter names: one state dict loads strictly
    into both, and on the CPU both compute the same function."""
    a = randomize(RestormerRefFusion(**TINY_REF), seed=6).eval()
    b = RestormerRefFusion(**TINY_REF, **MODULE_ROUTE).eval()
    b.load_state_dict(a.state_dict(), strict=True)
    rng = np.random.default_rng(7)
    lq, ref = t(randn(rng, 1, 32, 32, 3)), t(randn(rng, 1, 32, 32, 3))
    with torch.no_grad():
        assert_close(b(lq, ref), a(lq, ref).numpy(), atol=1e-5, rtol=1e-5)


def test_define_network_threads_the_routing_keys():
    opt = {"type": "PromptIRRefFusion", "dim": 48, "num_blocks": [1, 1, 1, 1],
           "num_refinement_blocks": 1, "heads": [1, 2, 4, 8],
           "reffusion_n_blocks": [1, 1, 1, 1], "nf": 8,
           "ext_n_blocks": [1, 1, 1, 1], **MODULE_ROUTE}
    m = define_network(opt)
    blocks = _blocks(m)
    # eight trunk stages, four fusion blocks and the three noise blocks
    assert len(blocks) == 8 + 4 + 3
    assert all(not b.fused and b.ffn.fused and b.attn.use_pallas
               for b in blocks)
    m = define_network({"type": "RestormerRefFusion", **TINY_REF,
                        "fused": False})
    assert all(not b.fused and not b.ffn.fused and not b.attn.use_pallas
               for b in _blocks(m))
    # the default route is unchanged
    assert all(b.fused and not b.ffn.fused and not b.attn.use_pallas
               for b in _blocks(define_network({"type": "Restormer",
                                                **TINY})))


@pytest.mark.parametrize("kwargs,match", [
    (dict(fused="off"), "fused must be a bool"),
    (dict(fused=False, gdfn_fused=1), "gdfn_fused must be a bool"),
    (dict(fused=False, mdta_pallas="on"), "mdta_pallas must be a bool"),
    (dict(gdfn_fused=True), "need.*fused=False"),
    (dict(mdta_pallas=True), "need.*fused=False"),
    (dict(bias=True), "biases"),
    (dict(fused=False, gdfn_fused=True, bias=True), "biases"),
])
def test_block_options_are_validated(kwargs, match):
    for cls in (TransformerBlock, TransformerResFusionBlock):
        with pytest.raises(ValueError, match=match):
            cls(16, 2, **kwargs)


def test_stage_options_are_validated():
    with pytest.raises(ValueError, match="fused=True"):
        TBlockStage(16, 2, 2, chain=True, fused=False)
    with pytest.raises(ValueError, match="chain must be a bool"):
        TBlockStage(16, 2, 2, chain="on")
    # conv biases take the module path, op by op (as in JAX)
    blk = TransformerBlock(16, 2, bias=True, fused=False)
    assert blk.attn.qkv.bias is not None and isinstance(blk.ffn, GDFN)
    x = t(randn(np.random.default_rng(8), 1, 5, 6, 16))
    assert torch.equal(blk(x), blk.module_forward(x))


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("evald_module")
    rng = np.random.default_rng(0)
    for sub in ("hq", "ref"):
        (root / sub).mkdir()
    for i in range(2):
        img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "hq" / f"{i}.png"), img)
        cv2.imwrite(str(root / "ref" / f"{i}.png"),
                    np.ascontiguousarray(img[::-1]))
    return root


def test_evaluate_cli_module_route_matches_default_route(eval_dirs):
    """--module_blocks --gdfn_kernel --mdta_kernel on the CPU: the same
    weights (seed 0) through the module path give the default route's
    scores (both plain on the CPU, the same math)."""
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", "restormer_deblur", "--tiny_debug", "--device", "cpu",
            "--hqroot", str(eval_dirs / "hq"),
            "--refroot", str(eval_dirs / "ref")]
    want = main(argv)
    got = main(argv + ["--module_blocks", "--gdfn_kernel", "--mdta_kernel"])
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3


@pytest.mark.parametrize("flags,match", [
    (["--gdfn_kernel"], "need --module_blocks"),
    (["--mdta_kernel"], "need --module_blocks"),
    (["--chain", "--module_blocks"], "excludes --module_blocks"),
    (["--chain", "--module_blocks", "--gdfn_kernel"], "excludes"),
])
def test_evaluate_cli_refuses_unused_route_options(eval_dirs, flags, match):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    with pytest.raises(SystemExit, match=match):
        main(["--task", "restormer_deblur", "--tiny_debug", "--device",
              "cpu", "--hqroot", str(eval_dirs / "hq"),
              "--refroot", str(eval_dirs / "ref"), *flags])
    with pytest.raises(SystemExit, match="no Restormer stages"):
        main(["--task", "nafnet_deblur", "--tiny_debug", "--device", "cpu",
              "--hqroot", str(eval_dirs / "hq"),
              "--refroot", str(eval_dirs / "ref"), "--module_blocks"])


def test_train_cli_module_route_with_gdfn_kernel(workspace,  # noqa: F811
                                                 monkeypatch):
    from textualdegremoval_tpu_torch.cli.train_restoration import main

    root, cfg = workspace
    monkeypatch.chdir(root)
    state = main(["--opt", cfg, "--max_iters", "2", "--device", "cpu",
                  "--fused", "off", "--gdfn_kernel"])
    assert state.step == 2
    blocks = _blocks(state.model)
    assert blocks and all(not b.fused and b.ffn.fused
                          and not b.attn.use_pallas for b in blocks)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


@pytest.mark.parametrize("flags,match", [
    (["--mdta_kernel"], "forward only"),
    (["--mdta_kernel", "--fused", "off"], "forward only"),
    (["--gdfn_kernel"], "--fused off"),
    (["--gdfn_kernel", "--fused", "on"], "--fused off"),
])
def test_train_cli_refuses_unusable_kernels(workspace,  # noqa: F811
                                            monkeypatch, flags, match):
    from textualdegremoval_tpu_torch.cli.train_restoration import main

    root, cfg = workspace
    monkeypatch.chdir(root)
    with pytest.raises((SystemExit, ValueError), match=match):
        main(["--opt", cfg, "--max_iters", "1", "--device", "cpu", *flags])


def test_resolve_network_fused_kernels_option():
    from textualdegremoval_tpu_torch.cli.train_restoration import (
        resolve_network,
    )

    opt = {"network_g": {"type": "RestormerRefFusion", **TINY_REF}}
    for cfg, fused in (("off", False), ("on", True), ("auto", True),
                       (False, False)):
        m, _, _ = resolve_network({**opt, "train": {"fused_kernels": cfg}})
        assert all(b.fused == fused for b in _blocks(m))
    # the CLI flag overrides the YAML key
    m, _, _ = resolve_network({**opt, "train": {"fused_kernels": "on"}},
                              fused="off", gdfn_kernel=True)
    assert all(not b.fused and b.ffn.fused for b in _blocks(m))
    with pytest.raises(ValueError, match="forward only"):
        resolve_network({"network_g": {**opt["network_g"], "fused": False,
                                       "mdta_pallas": True}})
    with pytest.raises(ValueError, match="unknown value"):
        resolve_network({**opt, "train": {"fused_kernels": "maybe"}})
