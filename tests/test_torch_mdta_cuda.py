"""On-card checks of the MDTA statistics kernels (csrc/mdta.cu; marked
`cuda`, each skips without a CUDA device).  The file imports neither jax
nor the test helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mdta_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.mdta as md
from textualdegremoval_tpu_torch.ops.attention import mdta_attention_nhwc

# attn: |k - p| <= atol + rtol |p| and ||k - p|| <= l2 ||p|| (MDTA_TOL);
# attn . v: |k - p| <= a max|p| + r |p| and l2 (MDTA_OUT_TOL): the bounds
# of chip_smoke.py's phase 20 and the reasons given there
from chip_smoke import MDTA_OUT_TOL, MDTA_TOL


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(shape, c, heads, dtype, seed):
    """q, k, v as strided chunks of one qkv = x . W, and temperatures
    ~ sqrt(C) (chip_smoke.py's phase 20 inputs)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, c, generator=gen)
    w = torch.randn(c, 3 * c, generator=gen) * c ** -0.5
    temp = c ** 0.5 * (0.5 + torch.rand(heads, 1, 1, generator=gen))
    q, k, v = torch.chunk((x @ w).to("cuda", dtype), 3, dim=-1)
    return q, k, v, temp.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads,shape", [
    (96, 2, (2, 37, 53)),    # ragged L, batch 2
    (48, 1, (1, 96, 80)),
    (704, 4, (1, 13, 11)),   # 176 channels per head (PromptIR)
    (160, 4, (1, 40, 24)),   # 40 channels per head
])
def test_kernels_match_plain(c, heads, shape, dtype):
    _cuda()
    q, k, v, temp = _qkv(shape, c, heads, dtype, seed=c)
    assert not q.is_contiguous()
    before = md.mdta_stats.launches
    with torch.inference_mode():
        got = md.mdta_stats(q, k, temp, heads)
        want = md.mdta_stats_ref(q, k, temp, heads)
        out = md.mdta_attention(q, k, v, temp, heads).float()
        want_out = mdta_attention_nhwc(q, k, v, temp, heads).float()
    assert md.mdta_stats.launches == before + 2
    atol, rtol, l2 = MDTA_TOL[dtype]
    diff = (got - want).abs()
    assert (diff <= atol + rtol * want.abs()).all(), diff.max().item()
    assert diff.norm() <= l2 * want.norm()
    a, r, l2 = MDTA_OUT_TOL[dtype]
    diff = (out - want_out).abs()
    assert (diff <= a * want_out.abs().max() + r * want_out.abs()).all(), \
        diff.max().item()
    assert diff.norm() <= l2 * want_out.norm()


@pytest.mark.cuda
def test_kernels_are_bitwise_repeatable():
    _cuda()
    q, k, _, temp = _qkv((1, 64, 64), 96, 2, torch.bfloat16, seed=1)
    with torch.inference_mode():
        assert torch.equal(md.mdta_stats(q, k, temp, 2),
                           md.mdta_stats(q, k, temp, 2))


@pytest.mark.cuda
def test_refuses_gradients_and_what_it_cannot_take():
    _cuda()
    q, k, v, temp = _qkv((1, 8, 8), 16, 2, torch.float32, seed=2)
    before = md.mdta_stats.launches
    with pytest.raises(RuntimeError, match="forward only"):
        md.mdta_attention(q.requires_grad_(True), k, v, temp, 2)
    assert md.mdta_stats.launches == before
    q = q.detach()
    wide_q, wide_k, _, _ = _qkv((1, 4, 4), 200, 1, torch.float32, seed=3)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="exceeds"):
            md.mdta_stats(wide_q, wide_k, torch.ones(1), 1)
        with pytest.raises(ValueError, match="strides"):
            md.mdta_stats(q, k.contiguous(), temp, 2)
        with pytest.raises(ValueError, match="dtypes"):
            md.mdta_stats(q.half(), k.half(), temp, 2)
