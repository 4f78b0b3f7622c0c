"""On-card checks of the whole-TransformerBlock CUDA kernel (marked `cuda`;
each skips without a CUDA device).  The file imports neither jax nor the
test helpers that do, so the card's machine runs it without JAX:

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


def _block(c, heads, ln_type, dtype, seed):
    """A block with weights at a trained block's scale (chip_smoke.py's
    `randomize_block`) and an input on the card."""
    gen = torch.Generator().manual_seed(seed)
    blk = TransformerBlock(c, heads, ln_type=ln_type)
    randomize_block(blk, gen)
    x = torch.randn(2, 37, 53, c, generator=gen)
    return blk.to("cuda", dtype), x.to("cuda", dtype)


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
    before = tb.tblock_fused.launches
    with torch.inference_mode():
        got = blk(x).float()
        want = tb.tblock_ref(x, blk.block_params(), heads, ln_type).float()
    assert tb.tblock_fused.launches == before + 1
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= atol + rtol * want.abs()).all(), \
        (got - want).abs().max().item()
    branch = (got - want).norm() / (want - x.float()).norm()
    assert branch <= BRANCH_TOL[dtype], branch.item()


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
