"""MDTA attention statistics: plain PyTorch version and CUDA kernel.

Counterpart of textualdegremoval_tpu/ops/pallas/mdta.py.
`mdta_stats_ref` is the plain version of JAX `mdta_stats_pallas`: the
per-head gram q^T k over all pixels, the q and k norms as
rsqrt(max(sum of squares, 1e-24)), the temperature and the row softmax,
all in f32 (the math of the kernel's last grid step, `_finish`), as two
steps, the sums (`mdta_sums_ref`, over a window of rows where asked) and
the finish (`mdta_finish_ref`), between which a row-sharded forward sums
the sums over its ranks.
`mdta_stats` runs it as hand-written Hopper kernels, which replace the
TPU kernel `_make_stats_kernel`, by a rule of the shapes (`_takes_gram`):
bf16 q and k whose widths and strides TMA takes run `mdta_gram`, the gram
and the square sums on csrc/wgrad.cu's TMA + wgmma kernel, then the finish
of csrc/mdta_gram.cu; every other call (float32 included) runs
csrc/mdta.cu, one streaming pass over q and k per head with per-CTA
partial sums and its own finish.  Each finish adds the partials in a fixed
order (bitwise repeatable) and applies the norms, the temperature and the
softmax.  `mdta_attention` is JAX
`mdta_attention_pallas`: the statistics, then attn . v as a plain batched
product in v's dtype, as JAX leaves it outside its kernel.  It is the MDTA
core of TransformerBlock's module path when the block asks for it
(`mdta_pallas=True`, JAX `MDTAAttention(use_pallas=True)`).

q and k may be strided views (the chunks of one qkv tensor): the kernel
takes their strides and copies nothing.  Forward only, as in JAX, whose
kernel cannot be differentiated: a call that would need a gradient
raises.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernels or raises.  `mdta_stats.launches` counts kernel calls on either
route (one pair of launches per call) and `mdta_gram.launches` those on
csrc/mdta_gram.cu's, never plain calls.  What bounds the kernels on the
card is noted at the top of csrc/mdta.cu and csrc/mdta_gram.cu.
"""

from __future__ import annotations

import ctypes

import torch

# Chunk lengths (pixels) of the statistics kernel in order of preference;
# the first whose shared memory fits one block is taken.
_CHUNKS = (128, 64, 32, 16)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) or (B, L, C) -> (B, L, C) for the plain version."""
    return t.reshape(t.shape[0], -1, t.shape[-1])


def mdta_sums_ref(q, k, heads: int, rows=None):
    """The sums the statistics start from, float32: the per-head gram
    q_h^T k_h (B, heads, cph, cph) and the square sums of q and k (B, C).
    q, k: (B, L, C) or (B, H, W, C); rows: (lo, hi), the rows of a
    (B, H, W, C) q and k whose pixels count (all where None: a sharded
    block counts its own rows, not its halo)."""
    if rows is not None:
        q, k = q[:, rows[0]: rows[1]], k[:, rows[0]: rows[1]]
    q, k = _flat(q), _flat(k)
    b, l, c = q.shape
    cph = c // heads
    qf = q.float().reshape(b, l, heads, cph)
    kf = k.float().reshape(b, l, heads, cph)
    gram = torch.einsum("blhc,blhd->bhcd", qf, kf)
    return gram, (qf * qf).sum(1).reshape(b, c), (kf * kf).sum(1).reshape(b, c)


def mdta_finish_ref(gram, qssq, kssq, temperature, heads: int):
    """The softmaxed attention (B, heads, cph, cph), float32, from
    `mdta_sums_ref`'s sums (summed over the ranks where the image is
    sharded): the norms as rsqrt(max(sum of squares, 1e-24)), the
    temperature and the row softmax."""
    b, _, cph, _ = gram.shape
    rq = torch.rsqrt(torch.clamp_min(qssq.reshape(b, heads, cph), 1e-24))
    rk = torch.rsqrt(torch.clamp_min(kssq.reshape(b, heads, cph), 1e-24))
    a = gram * (rq[..., :, None] * rk[..., None, :])
    a = a * temperature.float().reshape(1, heads, 1, 1)
    return torch.softmax(a, dim=-1)


def mdta_stats_ref(q, k, temperature, heads: int) -> torch.Tensor:
    """q, k: (B, L, C) with heads along C (or (B, H, W, C)); temperature:
    heads values in any shape.  Returns the softmaxed attention
    (B, heads, cph, cph) in float32."""
    return mdta_finish_ref(*mdta_sums_ref(q, k, heads), temperature, heads)


def _pixel_strides(t: torch.Tensor):
    """(L, W, sb, sh, sw) of a (B, L, C) or (B, H, W, C) view: pixel l of
    image b at b sb + (l // W) sh + (l % W) sw."""
    if t.dim() == 3:
        return t.shape[1], t.shape[1], t.stride(0), 0, t.stride(1)
    return (t.shape[1] * t.shape[2], t.shape[2], t.stride(0), t.stride(1),
            t.stride(2))


def _launch(lib, q, k, temperature, heads, tl, nsplit, stream):
    """The statistics and finishing kernels on already validated inputs;
    partials and the output are allocated on q's device.  `stream` is a
    cudaStream_t as an int (0 for the default stream)."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _check, _ptr

    b, c = q.shape[0], q.shape[-1]
    cph = c // heads
    l, w, sb, sh, sw = _pixel_strides(q)
    f32 = torch.float32
    gram_part = torch.empty((b, nsplit, heads, cph, cph), dtype=f32,
                            device=q.device)
    qs_part = torch.empty((b, nsplit, c), dtype=f32, device=q.device)
    ks_part = torch.empty((b, nsplit, c), dtype=f32, device=q.device)
    attn = torch.empty((b, heads, cph, cph), dtype=f32, device=q.device)
    temp = temperature.detach().to(f32).reshape(-1).contiguous()
    s = ctypes.c_void_p(stream)
    _check(lib.mdta_stats(
        _ptr(q), _ptr(k), _ptr(gram_part), _ptr(qs_part), _ptr(ks_part), b,
        l, w, c, heads, sb, sh, sw, int(q.dtype == torch.bfloat16), tl,
        nsplit, s), lib, "mdta_stats")
    _check(lib.mdta_finish(
        _ptr(gram_part), _ptr(qs_part), _ptr(ks_part), _ptr(temp),
        _ptr(attn), b, c, heads, nsplit, s), lib, "mdta_finish")
    return attn


def plan(lib, q: torch.Tensor, heads: int, sms: int | None = None):
    """(chunk length, CTAs per (head, image)) of csrc/mdta.cu for q on a
    card of `sms` SMs (default: q's): the first chunk length of _CHUNKS
    that fits shared memory, and about two CTAs per SM, at most one per
    chunk."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import (
        _card, _first_fit)

    b, c = q.shape[0], q.shape[-1]
    l = _pixel_strides(q)[0]
    tl = _first_fit(_CHUNKS, lambda t: lib.mdta_stats_smem(
        c // heads, t, q.element_size()), "mdta_stats")
    sms = sms or _card(q.device)[1]
    return tl, max(1, min(-(-l // tl), -(-2 * sms // (b * heads))))


def _takes_gram(q: torch.Tensor, k: torch.Tensor, heads: int) -> bool:
    """Whether `mdta_stats` runs `mdta_gram` (the rule reads dtype, widths
    and strides only): bf16 q and k, C and cph multiples of 8, one pixel
    stride for the whole image (sh == W sw) and the image, pixel and base
    offsets of both 16-byte aligned, as TMA takes them."""
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype:
        return False
    c = q.shape[-1]
    if c % 8 or heads <= 0 or c % heads or (c // heads) % 8:
        return False
    l, w, sb, sh, sw = _pixel_strides(q)
    if q.dim() == 4 and q.shape[1] > 1 and sh != w * sw:
        return False
    return (sb % 8 == 0 and sw % 8 == 0 and q.data_ptr() % 16 == 0
            and k.data_ptr() % 16 == 0)


def mdta_gram(lib, q, k, temperature, heads: int, sms: int, stream):
    """The statistics as csrc/mdta_gram.cu's two launches, on validated
    inputs that `_takes_gram` admits: the gram and the square sums on
    csrc/wgrad.cu (split over the pixel axis as `_wgrad` splits the
    block's gram), then the finish.  `sms` is the card's SM count,
    `stream` a cudaStream_t as an int.  Returns (B, heads, cph, cph) f32.
    `mdta_gram.launches` counts its calls."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _check, _ptr
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _wgrad_nsplit)

    b, c = q.shape[0], q.shape[-1]
    cph = c // heads
    l, _, sb, _, sw = _pixel_strides(q)
    nsplit = _wgrad_nsplit(lib, q.dtype, l, cph, cph, b * heads, sms)
    f32 = torch.float32
    work = torch.empty(lib.mdta_gram_work(b, c, heads, nsplit), dtype=f32,
                       device=q.device)
    attn = torch.empty((b, heads, cph, cph), dtype=f32, device=q.device)
    temp = temperature.detach().to(f32).reshape(-1).contiguous()
    _check(lib.mdta_stats_gram(
        _ptr(q), _ptr(k), _ptr(temp), _ptr(work), _ptr(attn), b, l, c, heads,
        sw, sb, nsplit, ctypes.c_void_p(stream)), lib, "mdta_stats_gram")
    mdta_gram.launches += 1
    return attn


mdta_gram.launches = 0


def _validate(q, k, heads):
    """Raise on CUDA inputs that the kernels do not take."""
    from textualdegremoval_tpu_torch.ops._build import load_library

    if q.dim() not in (3, 4) or q.shape != k.shape:
        raise ValueError(f"mdta_stats: q and k must be (B, L, C) or (B, H, "
                         f"W, C) of one shape, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise ValueError(f"mdta_stats: unsupported dtypes {q.dtype}, "
                         f"{k.dtype}")
    if k.device != q.device:
        raise ValueError("mdta_stats: q and k on different devices")
    if q.stride() != k.stride() or q.stride(-1) != 1:
        raise ValueError(f"mdta_stats: q and k need the same strides and "
                         f"contiguous channels, got {q.stride()} and "
                         f"{k.stride()}")
    c = q.shape[-1]
    if heads <= 0 or c % heads:
        raise ValueError(f"mdta_stats: C={c} not divisible by heads={heads}")
    lib = load_library()
    if c // heads > lib.mdta_max_cph():
        raise ValueError(f"mdta_stats: {c // heads} channels per head "
                         f"exceeds the kernel's limit of "
                         f"{lib.mdta_max_cph()}")
    return lib


def mdta_stats(q: torch.Tensor, k: torch.Tensor, temperature,
               heads: int) -> torch.Tensor:
    """The softmaxed channel attention (JAX `mdta_stats_pallas`).  q, k:
    (B, L, C) or (B, H, W, C), float32 or bfloat16, views allowed (the
    same strides, channels contiguous); temperature: heads values.
    Returns (B, heads, cph, cph) in float32.

    CPU tensors take `mdta_stats_ref`; CUDA tensors launch the kernels,
    and an input they cannot take raises.  Forward only."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, temperature)):
        raise RuntimeError(
            "mdta_stats is forward only: the JAX kernel it ports "
            "(mdta_stats_pallas) cannot be differentiated either; call it "
            "under torch.no_grad() or take the module path without it")
    if q.device.type == "cpu":
        return mdta_stats_ref(q, k, temperature, heads)
    return _stats_kernel(q, k, temperature, heads)


def _stats_kernel(q, k, temperature, heads):
    """`mdta_stats` on the card: `mdta_gram` where `_takes_gram`, else
    csrc/mdta.cu."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _card

    lib = _validate(q, k, heads)
    stream, sms = _card(q.device)
    if _takes_gram(q, k, heads):
        attn = mdta_gram(lib, q, k, temperature, heads, sms, stream)
    else:
        tl, nsplit = plan(lib, q, heads, sms)
        attn = _launch(lib, q, k, temperature, heads, tl, nsplit, stream)
    mdta_stats.launches += 1
    return attn


mdta_stats.launches = 0


def apply_attention(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """attn . v per head, outside the kernel as in JAX: attn (B, heads,
    cph, cph) cast to v's dtype, v (B, H, W, C).  Returns (B, H, W, C)."""
    b, h, w, c = v.shape
    heads = attn.shape[1]
    vh = v.reshape(b, h * w, heads, c // heads)
    out = torch.einsum("bhcd,blhd->blhc", attn.to(v.dtype), vh)
    return out.reshape(b, h, w, c)


def mdta_attention(q, k, v, temperature, heads: int) -> torch.Tensor:
    """MDTA on NHWC tensors through the statistics kernel (JAX
    `mdta_attention_pallas`).  q, k, v: (B, H, W, C); temperature:
    (heads, 1, 1).  Returns (B, H, W, C) in v's dtype."""
    return apply_attention(mdta_stats(q, k, temperature, heads), v)
