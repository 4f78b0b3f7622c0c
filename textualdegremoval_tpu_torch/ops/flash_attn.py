"""Self-attention routing of the diffusion towers, and the flash-attention
kernel.

Counterpart of textualdegremoval_tpu/ops/flash_attn.py.  `self_attention`
routes as the JAX function does: a self-attention that passes
`flash_applies` (sequence >= 2048 and a multiple of 512, head_dim a
multiple of 64 up to 128) goes to `flash_attention` when the caller asks
for it, everything else to the plain `attention_ref`.  In a 512 px SD UNet
forward that is the five self-attentions at the 64 x 64 latent.

`attention_ref` is the plain version: softmax(q k^T * D^-0.5) v over BNHD
tensors, with the logits and the softmax in float32 and the probabilities
cast to the input dtype before the product with v (the math of
`jax.nn.dot_product_attention`).

`flash_attention` runs the hand-written Hopper kernels of
csrc/flash_attn.cu (forward) and csrc/flash_attn_bwd.cu (backward), which
replace the stock Pallas TPU flash-attention kernel that the JAX function
calls and the two backward kernels of its custom VJP; what bounds them and
what their design does about that is noted at the top of each source.
They read q, k, v (and the incoming gradient) in place (any BNHD strides
whose last dimension is contiguous, such as the (B, N, H*D) projection
outputs viewed per head) and write contiguous outputs.  A CPU tensor takes
`attention_ref`; a CUDA tensor launches the kernels or raises.  Where a
gradient is wanted, the forward is a `torch.autograd.Function` that also
writes each row's log-sum-exp and saves q, k, v, o and lse; its backward
forms di = rowsum(o * do) in torch, as the JAX VJP does in plain jnp, and
launches the dkv kernel, then the dq kernel.  `attention_bwd_ref` is the
plain version of that backward.  `flash_attention.launches` counts forward
launches and `flash_attention.launches_bwd` backward launches (one per
dkv + dq pair), never plain-version calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

_MIN_SEQ = 2048
_BLOCK = 512
HEAD_DIMS = (64, 128)


def flash_applies(q_seq: int, kv_seq: int, head_dim: int) -> bool:
    """The JAX package's routing predicate, unchanged."""
    return (q_seq == kv_seq and q_seq >= _MIN_SEQ and q_seq % _BLOCK == 0
            and head_dim % 64 == 0 and head_dim <= 128)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> torch.Tensor:
    """Plain multi-head attention over (B, N, H, D) tensors, scaled by
    D^-0.5; logits and softmax in float32, output in the input's dtype."""
    n, s, d = q.shape[1], k.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(n, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(rc: int, lib, what: str):
    if rc != 0:
        msg = lib.flash_attn_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def attention_bwd_ref(q, k, v, o, lse, do):
    """Plain version of the backward kernels, in float32: P recomputed as
    exp(q k^T * D^-0.5 - lse) from the forward's row log-sum-exp lse
    (B, H, N), di = rowsum(o * do) from the forward's output o, then
    dv = P^T do, dS = P (do v^T - di), dq = dS k * D^-0.5 and
    dk = dS^T q * D^-0.5.  Returns (dq, dk, dv) in the inputs' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
                  - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    di = (o.float() * dof).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def lse_ref(q, k):
    """Plain version of the forward's row log-sum-exp: (B, H, N) float32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.logsumexp(logits / math.sqrt(q.shape[-1]), dim=-1)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(lib, q, k, v, stream, want_lse: bool = False):
    """The forward kernel on already validated inputs; outputs are
    allocated on q's device.  `stream` is a cudaStream_t as an int (0:
    default).  Returns o, or (o, lse) when `want_lse`."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) \
        if want_lse else None
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    _check(lib.flash_attn_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, n, h, d,
        *strides, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        stream), lib, "flash_attention")
    return (out, lse) if want_lse else out


def _launch_bwd(lib, q, k, v, o, lse, do, stream):
    """The backward kernels on already validated inputs (do in a layout
    that `_validate` takes): di in torch, then dkv, then dq.  Returns
    (dq, dk, dv), contiguous (B, N, H, D)."""
    b, n, h, d = q.shape
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    args = (b, n, h, d, *[s for t in (q, k, v, do) for s in t.stride()[:3]],
            1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    ins = (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(di))
    _check(lib.flash_attn_bwd_dkv(*ins, _ptr(dk), _ptr(dv), *args), lib,
           "flash_attention backward (dkv)")
    _check(lib.flash_attn_bwd_dq(*ins, _ptr(dq), *args), lib,
           "flash_attention backward (dq)")
    return dq, dk, dv


def _readable(t) -> bool:
    """True where the kernels read t in place: each head's rows contiguous,
    the base and the strides 16-byte aligned."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and not any(s % vec for s in t.stride()[:3])


def _validate(q, k, v):
    """Raise on CUDA inputs that the kernel does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, N, H, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: unsupported dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    for t in (q, k, v):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_attention: unsupported device "
                             f"{t.device}")
        if not _readable(t):
            raise ValueError("flash_attention: each head's rows must be "
                             "contiguous and 16-byte aligned (strides "
                             f"{t.stride()})")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_kernel(q, k, v, want_lse=False):
    _validate(q, k, v)
    from textualdegremoval_tpu_torch.ops._build import load_library

    out = _launch(load_library(), q, k, v, _stream(q), want_lse)
    flash_attention.launches += 1
    return out


def _backward_kernel(q, k, v, o, lse, do):
    if not _readable(do):  # a fresh copy is contiguous and aligned
        do = do.clone(memory_format=torch.contiguous_format)
    from textualdegremoval_tpu_torch.ops._build import load_library

    grads = _launch_bwd(load_library(), q, k, v, o, lse, do, _stream(q))
    flash_attention.launches_bwd += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward_kernel(q, k, v, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _backward_kernel(*ctx.saved_tensors, grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over (B, N, H, D) tensors, scaled by D^-0.5.
    CPU tensors take `attention_ref`; CUDA tensors launch the kernels (D
    64 or 128, float32 or bfloat16, any N >= 1) or raise.  The backward
    kernels run where autograd needs a gradient of q, k or v."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    return _forward_kernel(q, k, v)


flash_attention.launches = 0
flash_attention.launches_bwd = 0


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   use_flash: bool) -> torch.Tensor:
    """Multi-head self-attention over BNHD tensors (JAX `self_attention`):
    `flash_attention` where `use_flash` and `flash_applies`, else
    `attention_ref`; identical math."""
    _, n, _, d = q.shape
    if use_flash and flash_applies(n, k.shape[1], d):
        return flash_attention(q, k, v)
    return attention_ref(q, k, v)
