"""On-card checks of the standalone GDFN kernel (csrc/gdfn.cu; marked
`cuda`, each skips without a CUDA device).  The file imports neither jax
nor the test helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_gdfn_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.gdfn as gd
from textualdegremoval_tpu_torch.models.layers import GDFN

# kernel vs plain: |k - p| <= a max|p| + r |p| at every element and
# ||k - p|| <= l2 ||p||, (a, r, l2) of chip_smoke.py's phase 19 and the
# reasons given there; the gradient bound of its phase 6
from chip_smoke import GDFN_TOL, GRAD_L2, gdfn_weights


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(c, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    ws = [w.cuda() for w in gdfn_weights(c, gen)]
    return ws, torch.randn(*shape, c, generator=gen).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,shape", [
    (48, (2, 37, 53)),    # ragged: no tile divides H or W; hidden 127
    (96, (1, 64, 40)),
    (768, (1, 13, 9)),    # the widest GDFN: a smaller tile
])
def test_kernel_matches_plain(c, shape, dtype):
    _cuda()
    ws, x32 = _inputs(c, shape, seed=c)
    x = x32.to(dtype)
    before = gd.gdfn_fused.launches
    with torch.inference_mode():
        got = gd.gdfn_fused(x, *ws).float()
        want = gd.gdfn_ref(x, *ws).float()
    assert gd.gdfn_fused.launches == before + 1
    a, r, l2 = GDFN_TOL[dtype]
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert (diff <= a * want.abs().max() + r * want.abs()).all(), \
        diff.max().item()
    assert diff.norm() <= l2 * want.norm(), (diff.norm() / want.norm()).item()


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable():
    _cuda()
    ws, x = _inputs(96, (2, 37, 53), seed=1)
    x = x.bfloat16()
    with torch.inference_mode():
        assert torch.equal(gd.gdfn_fused(x, *ws), gd.gdfn_fused(x, *ws))


@pytest.mark.cuda
def test_gradient_matches_autograd_through_plain():
    """The kernel forward under autograd, its backward recomputing through
    gdfn_ref: the gradients of x and every weight are autograd's."""
    _cuda()
    ws, x = _inputs(48, (2, 37, 53), seed=2)
    ws = [w.requires_grad_(True) for w in ws]
    x.requires_grad_(True)
    g = torch.randn_like(x)
    got = torch.autograd.grad(gd.gdfn_fused(x, *ws), [x, *ws], g)
    want = torch.autograd.grad(gd.gdfn_ref(x, *ws), [x, *ws], g)
    for a, b in zip(got, want):
        assert (a - b).norm() <= GRAD_L2[torch.float32] * b.norm()


@pytest.mark.cuda
def test_module_takes_the_kernel_and_refuses_what_it_cannot_take():
    _cuda()
    m = GDFN(32, fused=True).cuda()
    x = torch.randn(1, 9, 7, 32, device="cuda")
    before = gd.gdfn_fused.launches
    with torch.inference_mode():
        m(x)
    assert gd.gdfn_fused.launches == before + 1
    ws, _ = _inputs(32, (1, 4, 4), seed=3)
    with pytest.raises(ValueError, match="dtype"):
        gd.gdfn_fused(x.half(), *ws)
    with pytest.raises(ValueError, match="contiguous"):
        gd.gdfn_fused(x.transpose(1, 2), *ws)
    with pytest.raises(ValueError, match="do not match"):
        gd.gdfn_fused(x, *ws, kw=gd.prepare_gdfn_weights(*ws,
                                                         torch.bfloat16))
