"""PyTorch port vs JAX package: PromptIR and PromptIRRefFusion (the
all-in-one task), their prompt block, the torch-style bilinear resize, the
weight conversion and the evaluation CLI.

f32 on the CPU: ops and modules to 1e-5, whole models to 2e-4 (as
tests/test_convert.py holds the JAX model to the torch oracle); bf16 as
stated at its test.  JAX parameters come from the port's state dict
through the JAX package's own `convert_state_dict`, never `model.init`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.models.promptir import (
    PromptGenBlock as JPromptGenBlock, PromptIR as JPromptIR,
    PromptIRRefFusion as JPromptIRRefFusion,
)
from textualdegremoval_tpu.ops.resize import (
    bilinear_resize_torch as jax_bilinear_resize,
)

from textualdegremoval_tpu_torch.convert import (
    load_jax_params, load_reference_checkpoint,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.promptir import (
    PromptGenBlock, PromptIR, PromptIRRefFusion,
)
from textualdegremoval_tpu_torch.ops import bilinear_resize_torch

from torch_oracles import OPromptIR
from torch_port_util import assert_close, jax_tree, randn, randomize, t

# the reference's prompt dims are consistent with its layout only at dim=48
SMALL = dict(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
SMALL_REF = dict(SMALL, nf=48, ext_n_blocks=(1, 1, 1, 1),
                 reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


@pytest.mark.parametrize("hw,out_hw", [
    ((16, 16), (40, 24)),   # up
    ((37, 29), (16, 8)),    # down, no integer factor
    ((64, 64), (17, 33)),   # down in H, up in W
    ((12, 10), (12, 10)),   # same size
])
def test_bilinear_resize_matches_jax(hw, out_hw):
    x = randn(np.random.default_rng(hw[0]), 2, *hw, 5)
    got = bilinear_resize_torch(t(x), *out_hw)
    want = jax_bilinear_resize(jnp.asarray(x), *out_hw)
    assert got.shape == want.shape
    assert_close(got, want)


@pytest.mark.parametrize("dim,size,lin,hw", [
    (64, 64, 96, (20, 28)),    # prompt1's shape, resized down
    (320, 16, 384, (8, 8)),    # prompt3's shape, resized down
    (16, 4, 8, (9, 13)),       # resized up
])
def test_prompt_gen_block_matches_jax(dim, size, lin, hw):
    m = randomize(PromptGenBlock(dim, 5, size, lin), seed=dim, scale=0.3)
    x = randn(np.random.default_rng(size), 2, *hw, lin)
    want = JPromptGenBlock(dim, 5, size, lin).apply(
        {"params": jax_tree(m, "prompt1")}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(m(t(x)), want)


def test_promptir_matches_jax():
    m = randomize(PromptIR(**SMALL), seed=1).eval()
    x = randn(np.random.default_rng(2), 1, 20, 28, 3)  # padded to 24 x 32
    want = jax.jit(JPromptIR(**SMALL).apply)(
        {"params": convert_state_dict(m.state_dict())}, jnp.asarray(x))
    with torch.no_grad():
        got = m(t(x))
    assert got.shape == want.shape
    assert_close(got, want, atol=2e-4, rtol=0)


def _ref_fusion(seed=3, **kw):
    m = randomize(PromptIRRefFusion(**SMALL_REF, **kw), seed).eval()
    with torch.no_grad():  # gates as a trained network's, not zero
        for name, p in m.named_parameters():
            if name.endswith("alpha"):
                p.fill_(0.5)
    return m


def test_promptir_ref_fusion_matches_jax():
    m = _ref_fusion()
    rng = np.random.default_rng(4)
    lq = randn(rng, 1, 32, 32, 3)
    ref = randn(rng, 1, 40, 48, 3)  # lq and ref differ: two MASA passes
    want = jax.jit(JPromptIRRefFusion(**SMALL_REF).apply)(
        {"params": convert_state_dict(m.state_dict())}, jnp.asarray(lq),
        jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(lq), t(ref))
    assert got.shape == want.shape
    assert_close(got, want, atol=2e-4, rtol=0)


def test_promptir_ref_fusion_bf16_matches_jax_on_f32_weights():
    """Compute dtype bf16 over f32 parameters on both sides.  The two
    frameworks sum in other orders and round at other places inside a
    fused XLA computation: each lies 7.9e-3 in relative L2 from the f32
    network, and against each other outputs of magnitude up to 8 differ by
    up to two bf16 ulps (2^-5 there).  Bounds: 0.1 absolute at every
    element, 1e-2 in relative L2 (measured 0.0625 and 6.2e-3; PERF.md
    section 6)."""
    m = _ref_fusion(seed=5)
    m.dtype = torch.bfloat16
    rng = np.random.default_rng(6)
    lq = randn(rng, 1, 32, 32, 3)
    ref = randn(rng, 1, 32, 32, 3)
    want = jax.jit(JPromptIRRefFusion(**SMALL_REF, dtype=jnp.bfloat16).apply)(
        {"params": convert_state_dict(m.state_dict())}, jnp.asarray(lq),
        jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(lq), t(ref))
    assert got.dtype == torch.bfloat16
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_load_jax_params_round_trips_bitwise():
    """Port -> JAX tree (the JAX package's converter) -> port: every tensor
    bitwise, prompt_param through its (1, L, S, S, D) JAX layout and the
    prompt's Dense kernel through (in, out)."""
    src = _ref_fusion(seed=7)
    tree = convert_state_dict(src.state_dict())
    assert tree["prompt3"]["prompt_param"].shape == (1, 5, 16, 16, 320)
    assert tree["prompt1"]["linear_layer"]["kernel"].shape == (96, 5)
    dst = load_jax_params(PromptIRRefFusion(**SMALL_REF), tree)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_reference_checkpoint_with_dead_keys_loads_strict(tmp_path):
    """A reference-layout PromptIR state dict carries parameters that its
    forward never uses (chnl_reduce1-3, reduce_noise_channel_1-3): they
    are dropped, everything else loads with strict=True."""
    sd = randomize(OPromptIR(dim=48, num_blocks=(1, 1, 1, 1),
                             num_refinement_blocks=1), seed=8).state_dict()
    dead = {f"chnl_reduce{i}.weight": torch.ones(4, 4, 1, 1)
            for i in (1, 2, 3)}
    dead.update({f"reduce_noise_channel_{i}.weight": torch.ones(4, 4, 1, 1)
                 for i in (1, 2, 3)})
    path = tmp_path / "net_g.pth"
    torch.save({"params": {f"module.{k}": v
                           for k, v in {**sd, **dead}.items()}}, path)
    m = load_reference_checkpoint(
        PromptIR(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                 heads=(1, 1, 2, 2)), str(path))
    for k, v in sd.items():
        assert torch.equal(m.state_dict()[k], v), k
    # anything else unknown still fails the strict load
    torch.save({"params": {**sd, "extra.weight": torch.ones(1)}}, path)
    with pytest.raises(RuntimeError, match="extra"):
        load_reference_checkpoint(PromptIR(**SMALL, heads=(1, 1, 2, 2)),
                                  str(path))


def test_define_network_builds_promptir():
    from textualdegremoval_tpu_torch.cli.evaluate import TASK_TABLE

    opt = dict(TASK_TABLE["promptir_all_in_one"], chain=True)
    m = define_network(opt, dtype=torch.bfloat16)
    assert isinstance(m, PromptIRRefFusion) and not m.training
    assert m.encoder_level1.chain and m.dtype == torch.bfloat16
    assert m.noise_level3.attn.qkv.weight.shape[1] == 48 * 8 + 320
    assert m.noise_level3.num_heads == 4


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    import cv2

    from textualdegremoval_tpu_torch.cli.evaluate import (
        TASK_TABLE, shrink_for_smoke,
    )

    root = tmp_path_factory.mktemp("evalp")
    rng = np.random.default_rng(0)
    for sub in ("hq", "ref"):
        (root / sub).mkdir()
    for i in range(2):
        img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "hq" / f"{i}.png"), img)
        cv2.imwrite(str(root / "ref" / f"{i}.png"),
                    np.ascontiguousarray(img[::-1]))
    opt = shrink_for_smoke(TASK_TABLE["promptir_all_in_one"])
    m = randomize(define_network(opt), seed=9, scale=0.1)
    torch.save({"params": m.state_dict()}, root / "net_g.pth")
    return root


def test_evaluate_cli_promptir_matches_jax_cli(eval_dirs):
    """--task promptir_all_in_one --tiny_debug on the CPU against the JAX
    CLI on the same checkpoint; --chain gives the same numbers (its plain
    chain on the CPU).  The tiny config's noise_level3 has C = 384 with 2
    heads, 192 channels per head: the widened block kernel takes that on
    the card too."""
    from textualdegremoval_tpu.cli.evaluate import main as jax_main
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", "promptir_all_in_one", "--sigma", "15", "--tiny_debug",
            "--hqroot", str(eval_dirs / "hq"),
            "--refroot", str(eval_dirs / "ref"),
            "--checkpoint_path", str(eval_dirs / "net_g.pth")]
    want = jax_main(argv)
    got = main(argv + ["--device", "cpu"])
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3
    assert main(argv + ["--device", "cpu", "--chain"]) == got


def test_evaluate_cli_refuses_chain_without_restormer_stages(eval_dirs):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    with pytest.raises(SystemExit, match="--chain"):
        main(["--task", "nafnet_deblur", "--tiny_debug", "--chain",
              "--hqroot", str(eval_dirs / "hq"),
              "--refroot", str(eval_dirs / "ref"), "--device", "cpu"])
