"""On-card checks of the flash self-attention CUDA kernel (marked `cuda`;
each skips without a CUDA device).  The file imports neither jax nor the
test helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_flash_attn_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.flash_attn as fa
from textualdegremoval_tpu_torch.models.unet import UNet2DCondition

# kernel vs plain: |k - p| <= a max|p| + r |p| elementwise and
# ||k - p|| <= l2 ||p||, chip_smoke.py's bounds and the reasons given there
from chip_smoke import FLASH_PEAK, FLASH_TOL, TOWER_TOL


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    s = FLASH_PEAK ** 0.5
    return tuple((torch.randn(*shape, generator=gen) * sc).to("cuda", dtype)
                 for sc in (s, s, 1.0))


def _check(got, want, dtype):
    a, r, l2 = FLASH_TOL[dtype]
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= a * w.abs().max() + r * w.abs()).all(), \
        (g - w).abs().max().item()
    assert (g - w).norm() <= l2 * w.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 512, 5, 64), (1, 300, 2, 128),
                                   (1, 1, 1, 64), (3, 70, 1, 64)])
def test_kernel_matches_plain(shape, dtype):
    _cuda()
    q, k, v = _qkv(shape, dtype, seed=shape[1])
    before = fa.flash_attention.launches
    with torch.inference_mode():
        got = fa.flash_attention(q, k, v)
        want = fa.attention_ref(q, k, v)
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _check(got, want, dtype)


@pytest.mark.cuda
def test_kernel_reads_strided_projection_views():
    """q, k, v as views of one fused (B, N, 3, H, D) projection."""
    _cuda()
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 256, 3, 4, 64, generator=gen).to("cuda",
                                                          torch.bfloat16)
    q, k, v = qkv.unbind(2)
    with torch.inference_mode():
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable():
    _cuda()
    q, k, v = _qkv((2, 2048, 5, 64), torch.bfloat16, seed=4)
    with torch.inference_mode():
        assert torch.equal(fa.flash_attention(q, k, v),
                           fa.flash_attention(q, k, v))


@pytest.mark.cuda
def test_backward_raises_instead_of_losing_gradients():
    _cuda()
    q = torch.randn(1, 128, 2, 64, device="cuda", requires_grad=True)
    out = fa.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="A7"):
        out.sum().backward()


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A routed CUDA self-attention launches the kernel; the plain version
    is not called, and an input the kernel does not take raises."""
    _cuda()

    def refuse(*a, **kw):
        raise AssertionError("attention_ref called for a routed shape")

    q, k, v = _qkv((1, 2048, 2, 64), torch.bfloat16, seed=5)
    monkeypatch.setattr(fa, "attention_ref", refuse)
    before = fa.flash_attention.launches
    with torch.inference_mode():
        fa.self_attention(q, k, v, use_flash=True)
    assert fa.flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*(torch.zeros(1, 8, 1, 32, device="cuda"),) * 3)


@pytest.mark.cuda
def test_unet_self_attentions_go_through_the_kernel():
    """A two-level UNet of head_dim 64 at a 32 x 64 latent: its level-0
    self-attentions (N = 2048) launch the kernel, one down and two up, and
    the output equals attn_impl='plain' to chip_smoke.py's tower bound."""
    _cuda()
    torch.manual_seed(0)
    with torch.device("cuda"):
        net = UNet2DCondition(block_out_channels=(64, 128),
                              layers_per_block=1, context_dim=64, head_dim=64)
        plain = UNet2DCondition(block_out_channels=(64, 128),
                                layers_per_block=1, context_dim=64,
                                head_dim=64, attn_impl="plain")
    plain.load_state_dict(net.state_dict())
    gen = torch.Generator("cuda").manual_seed(1)
    lat = torch.randn(1, 32, 64, 4, device="cuda", generator=gen)
    ctx = torch.randn(1, 8, 64, device="cuda", generator=gen)
    ts = torch.tensor([500], device="cuda")
    before = fa.flash_attention.launches
    with torch.inference_mode():
        got = net(lat, ts, ctx, use_global_kv=True)
        launches = fa.flash_attention.launches - before
        want = plain(lat, ts, ctx, use_global_kv=True)
    assert launches == 3  # down_0_attn_0, up_1_attn_{0,1}
    assert (got - want).abs().max() <= TOWER_TOL * want.abs().max()
