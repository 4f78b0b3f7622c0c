"""On-card checks of the whole-NAFBlock CUDA kernel (marked `cuda`; each
skips without a CUDA device).  The file imports neither jax nor the test
helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nafblock_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.nafblock as nb
from textualdegremoval_tpu_torch.models.layers import NAFBlock
from textualdegremoval_tpu_torch.models.nafnet import NAFNetRefFusion

# kernel vs plain: |k - p| <= a max|p| + r |p| at every element (NAF_TOL)
# and ||k - p|| <= branch ||p - x|| over the output (BRANCH_TOL), the
# bounds of chip_smoke.py and the reasons given there
from chip_smoke import BRANCH_TOL, NAF_TOL, randomize_nafblock


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _block(c, dtype, seed, shape=(2, 37, 53)):
    """A block with weights at a trained block's scale (chip_smoke.py's
    `randomize_nafblock`) and an input on the card."""
    gen = torch.Generator().manual_seed(seed)
    blk = NAFBlock(c)
    randomize_nafblock(blk, gen)
    x = torch.randn(*shape, c, generator=gen)
    return blk.to("cuda"), x.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 48, 40])  # 40: bf16 conv1 on FMA loops
def test_kernel_matches_plain(c, dtype):
    _cuda()
    blk, x = _block(c, dtype, seed=c)
    before = nb.nafblock_fused.launches
    with torch.inference_mode():
        got = blk(x).float()
        want = nb.nafblock_ref(x, blk.block_params()).float()
    assert nb.nafblock_fused.launches == before + 1
    a, r = NAF_TOL[dtype]
    assert torch.isfinite(got).all()
    bound = a * want.abs().max() + r * want.abs()
    assert ((got - want).abs() <= bound).all(), \
        (got - want).abs().max().item()
    branch = (got - want).norm() / (want - x.float()).norm()
    assert branch <= BRANCH_TOL[dtype], branch.item()


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable():
    _cuda()
    blk, x = _block(128, torch.bfloat16, seed=1)
    with torch.inference_mode():
        a, b = blk(x), blk(x)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _cuda()
    blk, x = _block(64, torch.bfloat16, seed=2)
    p = blk.block_params()
    kw = nb.prepare_nafblock_weights(p, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        nb.nafblock_fused(x.transpose(1, 2), p, kw)
    with pytest.raises(ValueError, match="dtype"):
        nb.nafblock_fused(x.half(), p, kw)
    with pytest.raises(ValueError, match="prepare_nafblock_weights"):
        nb.nafblock_fused(x, p)
    with pytest.raises(ValueError, match="do not match"):
        nb.nafblock_fused(x.float(), p, kw)


@pytest.mark.cuda
def test_every_parameter_gets_a_finite_gradient():
    """A tiny NAFNetRefFusion on the card, bf16 compute: every block runs
    the kernel pair, and every parameter, through the kernel path's
    autograd.Function, gets a finite gradient."""
    _cuda()
    torch.manual_seed(0)
    model = NAFNetRefFusion(width=16, enc_blk_nums=(1, 1, 1, 2), nf=16,
                            ext_n_blocks=(1, 1, 1, 1), lr_block_size=4,
                            dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("beta", "gamma")):
                p.fill_(0.5)
    model = model.cuda().train()
    gen = torch.Generator().manual_seed(1)
    lq, ref = (torch.rand(2, 64, 64, 3, generator=gen).cuda()
               for _ in range(2))
    before = nb.nafblock_fused.launches
    out = model(lq, ref)
    assert nb.nafblock_fused.launches - before == 15
    assert out.grad_fn is not None
    out.float().square().mean().backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    assert not missing, missing[:5]
