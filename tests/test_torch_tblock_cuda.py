"""On-card checks of the whole-TransformerBlock CUDA kernels (marked `cuda`;
each skips without a CUDA device): the bf16 pipeline (`tblock_pipeline`)
and csrc/tblock.cu's pair, which the route rule picks.  The file imports
neither jax nor the test helpers that do, so the card's machine runs it
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tblock_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
from textualdegremoval_tpu_torch.models.layers import TransformerBlock

# kernel vs plain: |k - p| <= atol + rtol |p| at every element (TOL) and
# ||k - p|| <= branch ||p - x|| over the output (BRANCH_TOL), the bounds
# of chip_smoke.py and the reasons given there
from chip_smoke import BRANCH_TOL, TOL, randomize_block


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _block(c, heads, ln_type, dtype, seed, shape=(2, 37, 53)):
    """A block with weights at a trained block's scale (chip_smoke.py's
    `randomize_block`) and an input on the card."""
    gen = torch.Generator().manual_seed(seed)
    blk = TransformerBlock(c, heads, ln_type=ln_type)
    randomize_block(blk, gen)
    x = torch.randn(*shape, c, generator=gen)
    return blk.to("cuda", dtype), x.to("cuda", dtype)


def _assert_close_to_plain(blk, x, heads, ln_type, dtype):
    with torch.inference_mode():
        got = blk(x).float()
        want = tb.tblock_ref(x, blk.block_params(), heads, ln_type).float()
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= atol + rtol * want.abs()).all(), \
        (got - want).abs().max().item()
    branch = (got - want).norm() / (want - x.float()).norm()
    assert branch <= BRANCH_TOL[dtype], branch.item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads,ln_type", [
    (96, 2, "WithBias"),   # every bf16 product on the tensor cores
    (48, 1, "BiasFree"),
    (40, 2, "WithBias"),   # C % 16 != 0: bf16 1x1s on the FMA path
])
def test_kernel_matches_plain(c, heads, ln_type, dtype):
    _cuda()
    blk, x = _block(c, heads, ln_type, dtype, seed=c)
    before = tb.tblock_fused.launches, tb.tblock_pipeline.launches
    _assert_close_to_plain(blk, x, heads, ln_type, dtype)
    # the bf16 pipeline where C and C / heads are multiples of 8
    pipeline = dtype == torch.bfloat16 and c % 8 == 0 and (c // heads) % 8 == 0
    assert (tb.tblock_fused.launches, tb.tblock_pipeline.launches) == (
        before[0] + 1, before[1] + int(pipeline))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,heads,ln_type", [
    ((1, 64, 64), 768, 8, "WithBias"),   # Restormer's widest block
    ((1, 45, 61), 704, 4, "BiasFree"),   # PromptIR's noise block, ragged
    ((1, 64, 64), 160, 4, "WithBias"),   # 40 channels per head
    ((2, 37, 53), 48, 1, "BiasFree"),    # C below one 64-channel box
])
def test_pipeline_matches_plain_at_full_width(shape, c, heads, ln_type):
    _cuda()
    blk, x = _block(c, heads, ln_type, torch.bfloat16, seed=c, shape=shape)
    before = tb.tblock_pipeline.launches
    _assert_close_to_plain(blk, x, heads, ln_type, torch.bfloat16)
    assert tb.tblock_pipeline.launches == before + 1
    with torch.inference_mode():
        assert torch.equal(blk(x), blk(x))


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable():
    _cuda()
    blk, x = _block(96, 2, "WithBias", torch.bfloat16, seed=1)
    with torch.inference_mode():
        a, b = blk(x), blk(x)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _cuda()
    blk, x = _block(96, 2, "WithBias", torch.bfloat16, seed=2)
    p = blk.block_params()
    with pytest.raises(ValueError, match="contiguous"):
        tb.tblock_fused(x.transpose(1, 2), p, 2, "WithBias")
    with pytest.raises(ValueError, match="dtype"):
        tb.tblock_fused(x.half(), p, 2, "WithBias")
    with pytest.raises(ValueError, match="divisible"):
        tb.tblock_fused(x, p, 5, "WithBias")
    with pytest.raises(ValueError, match="prepare_tblock_weights"):
        tb.tblock_fused(x, p, 2, "WithBias")
