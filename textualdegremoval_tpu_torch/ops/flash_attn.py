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

`flash_attention` runs the hand-written Hopper kernel of csrc/flash_attn.cu,
which replaces the stock Pallas TPU flash-attention kernel that the JAX
function calls; what bounds it and what its design does about that is
noted at the top of the source.  It reads q, k and v in place (any BNHD
strides whose last dimension is contiguous, such as the (B, N, H*D)
projection outputs viewed per head) and writes a contiguous output.  A CPU
tensor takes `attention_ref`; a CUDA tensor launches the kernel or raises.
It is a `torch.autograd.Function` whose backward raises: the backward
kernel comes with pipeline A's training (ROADMAP A7), and a gradient must
not be lost silently.  `flash_attention.launches` counts kernel launches,
never plain-version calls.
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


def _launch(lib, q, k, v, stream):
    """The kernel on already validated inputs; the output is allocated on
    q's device.  `stream` is a cudaStream_t as an int (0: default)."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    _check(lib.flash_attn_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, n, h, d, *strides, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), stream), lib, "flash_attention")
    return out


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
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError("flash_attention: each head's rows must be "
                             "contiguous and 16-byte aligned (strides "
                             f"{t.stride()})")


def _forward_kernel(q, k, v):
    _validate(q, k, v)
    from textualdegremoval_tpu_torch.ops._build import load_library

    out = _launch(load_library(), q, k, v,
                  torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        return _forward_kernel(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet: it comes with "
            "pipeline A's training (ROADMAP A7)")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over (B, N, H, D) tensors, scaled by D^-0.5.
    CPU tensors take `attention_ref`; CUDA tensors launch the kernel (D 64
    or 128, float32 or bfloat16, any N >= 1) or raise."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   use_flash: bool) -> torch.Tensor:
    """Multi-head self-attention over BNHD tensors (JAX `self_attention`):
    `flash_attention` where `use_flash` and `flash_applies`, else
    `attention_ref`; identical math."""
    _, n, _, d = q.shape
    if use_flash and flash_applies(n, k.shape[1], d):
        return flash_attention(q, k, v)
    return attention_ref(q, k, v)
