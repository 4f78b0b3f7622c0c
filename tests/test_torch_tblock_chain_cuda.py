"""On-card checks of the cross-block chain kernel (csrc/tblock_chain.cu)
and of the whole-block kernel at PromptIR's widths (marked `cuda`; each
skips without a CUDA device).  The file imports neither jax nor the test
helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tblock_chain_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
from textualdegremoval_tpu_torch.models.layers import (
    TBlockStage, TransformerBlock,
)

# kernel vs plain: |k - p| <= atol + rtol |p| at every element (TOL) and
# ||k - p|| <= branch ||p - x|| over what the blocks add (BRANCH_TOL), the
# bounds of chip_smoke.py and the reasons given there
from chip_smoke import BRANCH_TOL, TOL, randomize_block


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check(got, want, x, dtype, depth=1):
    """Phase 3's bounds for one block, times sqrt(depth) against a plain
    chain of `depth` blocks (chip_smoke.py `chain_vs_plain`)."""
    got, want = got.float(), want.float()
    atol, rtol = TOL[dtype]
    scale = depth ** 0.5
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= scale * (atol + rtol * want.abs())).all(), \
        (got - want).abs().max().item()
    branch = (got - want).norm() / (want - x.float()).norm()
    assert branch <= scale * BRANCH_TOL[dtype], branch.item()


def _stage(c, heads, n, ln_type, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    stage = TBlockStage(c, heads, n, ln_type=ln_type, chain=True)
    for blk in stage:
        randomize_block(blk, gen)
    x = torch.randn(2, 37, 53, c, generator=gen)
    return stage.to("cuda", dtype), x.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads,n,ln_type", [
    (48, 1, 3, "WithBias"),
    (96, 2, 2, "BiasFree"),
    (384, 8, 2, "WithBias"),   # gram accumulators in device memory
])
def test_chain_matches_plain_chain(c, heads, n, ln_type, dtype):
    _cuda()
    stage, x = _stage(c, heads, n, ln_type, dtype, seed=c + n)
    ps = [blk.block_params() for blk in stage]
    calls, launches = tb.tblock_chain_fused.calls, tb.tblock_chain_fused.launches
    with torch.inference_mode():
        got = stage(x)
        again = stage(x)
        want = tb.tblock_chain_ref(x, ps, heads, ln_type)
        blocks = x
        for blk in stage:
            blocks = blk(blocks)
    assert tb.tblock_chain_fused.calls == calls + 2
    assert tb.tblock_chain_fused.launches == launches + 2 * (n - 1)
    assert torch.equal(got, again)
    _check(got, blocks, x, dtype, depth=n)
    _check(got, want, x, dtype, depth=n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [704, 320, 160])
def test_block_kernel_at_promptir_widths(c, dtype):
    _cuda()
    gen = torch.Generator().manual_seed(c)
    blk = TransformerBlock(c, 4)
    randomize_block(blk, gen)
    blk = blk.to("cuda", dtype)
    x = torch.randn(1, 19, 27, c, generator=gen).to("cuda", dtype)
    before = tb.tblock_fused.launches
    with torch.inference_mode():
        got = blk(x)
        want = tb.tblock_ref(x, blk.block_params(), 4)
    assert tb.tblock_fused.launches == before + 1
    _check(got, want, x, dtype)


@pytest.mark.cuda
def test_chain_gradients_match_plain_autograd():
    _cuda()
    stage, x = _stage(48, 2, 3, "WithBias", torch.float32, seed=7)
    x.requires_grad_(True)
    g = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(8))
    launches = tb.tblock_chain_fused.launches
    got = torch.autograd.grad(stage(x), [x, *stage.parameters()], g)
    assert tb.tblock_chain_fused.launches == launches + 2
    ps = [blk.block_params() for blk in stage]
    want = torch.autograd.grad(tb.tblock_chain_ref(x, ps, 2), [
        x, *stage.parameters()], g)
    for a, b in zip(got, want):
        assert (a - b).norm() <= 1e-3 * b.norm().clamp_min(1e-30)
