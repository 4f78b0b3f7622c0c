"""GDFN (gated-dconv FFN): plain PyTorch version and CUDA kernel.

Counterpart of textualdegremoval_tpu/ops/pallas/gdfn.py.  `gdfn_ref` is
the plain version (JAX `gdfn_ref`, the module path's math) and
`gelu_exact` JAX's `_gelu_exact`.  `gdfn_fused` runs the GDFN as the
hand-written Hopper kernel in csrc/gdfn.cu, which replaces the TPU kernel
`_gdfn_fused_impl` (`_make_kernel`): x on a tile plus a 1-pixel halo read
once, the 2h-wide hidden kept in shared memory, only the C-wide output
written.  It is the GDFN of TransformerBlock's module path when the block
asks for it (`gdfn_fused=True`, JAX `GDFN(fused=True)` /
`$TDR_FUSED_GDFN=1`); the whole-block kernel (ops/pallas/tblock.py)
carries the same GDFN body inside its pass B.

Unlike JAX, no shape falls back to `gdfn_ref`: every H and W runs the
kernel, with masked edge tiles.  The gradient is JAX's `custom_vjp`: the
backward recomputes through `gdfn_ref` under autograd, so nothing of the
hidden is kept from the forward.

A CPU tensor takes `gdfn_ref`; a CUDA tensor launches the kernel or
raises.  `gdfn_fused.launches` counts kernel launches, never plain calls.
What bounds the kernel on the card is noted at the top of csrc/gdfn.cu.
"""

from __future__ import annotations

import ctypes
import math

import torch

from textualdegremoval_tpu_torch.ops.dwconv import dwconv

# The kernels' GDFN hidden chunk (kHC in csrc/tblock_common.cuh); the
# hidden width is zero-padded to a multiple of it.
HIDDEN_CHUNK = 32

# Tiles (rows, cols) in order of preference; the first whose shared memory
# fits one block is taken: the larger the tile, the fewer weight reads and
# halo pixels per output pixel.
_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """x * Phi(x) with the exact erf (jax.nn.gelu(approximate=False))."""
    return x * 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def gdfn_ref(x, w1, dwk, w2):
    """x: (B, H, W, C); w1: (C, 2h); dwk: (3, 3, 2h); w2: (h, C)."""
    hidden = w1.shape[1] // 2
    y = x @ w1.to(x.dtype)
    y = dwconv(y, dwk[:, :, None, :])
    g = gelu_exact(y[..., :hidden]) * y[..., hidden:]
    return g @ w2.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def kernel_matrix(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An (inputs, outputs) matrix in the kernels' layout: bf16 as
    (outputs, inputs), as the tensor-core fragments read it; f32
    unchanged."""
    return (t.T if dtype == torch.bfloat16 else t).to(dtype).contiguous()


def pad_gdfn_weights(w1, dwk, w2):
    """The GDFN's weights with the hidden zero-padded to hpad, a multiple
    of HIDDEN_CHUNK, in f32 (JAX `_gdfn_fused_impl`'s split, per chunk):
    w1 (C, 2 hpad) with each chunk's h1 columns followed by its h2
    columns, so that one product makes both halves of a chunk; the taps
    (18, hpad), h1's in rows 0-8; w2 (hpad, C).  Padded hidden channels
    get zero weights, so they add gelu(0) * 0 = 0.  w1: (C, 2h); dwk:
    any shape holding (3, 3, 2h); w2: (h, C).  Returns (w1, taps, w2,
    hpad)."""
    f32 = torch.float32
    c, h2 = w1.shape
    hidden = h2 // 2
    hpad = -(-hidden // HIDDEN_CHUNK) * HIDDEN_CHUNK
    dev = w1.device
    w1 = w1.to(f32)
    w1s = torch.zeros((c, 2, hpad), dtype=f32, device=dev)
    w1s[:, 0, :hidden] = w1[:, :hidden]
    w1s[:, 1, :hidden] = w1[:, hidden:]
    w1s = (w1s.reshape(c, 2, hpad // HIDDEN_CHUNK, HIDDEN_CHUNK)
           .transpose(1, 2).reshape(c, 2 * hpad))
    dwf = dwk.reshape(9, h2).to(f32)
    dwg = torch.zeros((18, hpad), dtype=f32, device=dev)
    dwg[:9, :hidden] = dwf[:, :hidden]
    dwg[9:, :hidden] = dwf[:, hidden:]
    w2s = torch.zeros((hpad, c), dtype=f32, device=dev)
    w2s[:hidden] = w2.reshape(hidden, c).to(f32)
    return w1s, dwg, w2s, hpad


def prepare_gdfn_weights(w1, dwk, w2, dtype: torch.dtype) -> dict:
    """The kernel-layout weights of one GDFN (`pad_gdfn_weights`, matrices
    in `dtype` via `kernel_matrix`, taps f32).  Callers cache the result
    per module."""
    w1s, dwg, w2s, hpad = pad_gdfn_weights(w1, dwk, w2)
    return dict(w1=kernel_matrix(w1s, dtype), dwg=dwg.contiguous(),
                w2=kernel_matrix(w2s, dtype), hpad=hpad, dtype=dtype)


def _launch(lib, x, kw, tile, stream):
    """The kernel on already validated inputs; the output is allocated on
    x's device.  `stream` is a cudaStream_t as an int (0 for the default
    stream)."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _check, _ptr

    b, hgt, wdt, c = x.shape
    out = torch.empty_like(x)
    _check(lib.gdfn_fwd(
        _ptr(x), _ptr(kw["w1"]), _ptr(kw["dwg"]), _ptr(kw["w2"]), _ptr(out),
        b, hgt, wdt, c, kw["hpad"], int(x.dtype == torch.bfloat16), tile[0],
        tile[1], ctypes.c_void_p(stream)), lib, "gdfn_fused")
    return out


def pick_tile(lib, c: int, elem_bytes: int):
    """The first of _TILES whose shared memory fits one block at width c."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _first_fit

    return _first_fit(_TILES, lambda t: lib.gdfn_smem(c, t[0], t[1],
                                                      elem_bytes),
                      "gdfn_fused")


def _forward_kernel(x, kw):
    """Validated launch of the kernel on a CUDA tensor."""
    from textualdegremoval_tpu_torch.ops._build import load_library

    if x.dim() != 4:
        raise ValueError(f"gdfn_fused: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gdfn_fused: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gdfn_fused: x must be contiguous (NHWC)")
    c = x.shape[-1]
    if kw["dtype"] != x.dtype or kw["dwg"].device != x.device \
            or kw["w2"].numel() != c * kw["hpad"]:
        raise ValueError("gdfn_fused: prepared weights do not match x")
    lib = load_library()
    out = _launch(lib, x, kw, pick_tile(lib, c, x.element_size()),
                  torch.cuda.current_stream(x.device).cuda_stream)
    gdfn_fused.launches += 1
    return out


class _GdfnFunction(torch.autograd.Function):
    """The kernel on CUDA with JAX's `custom_vjp` backward: only x and the
    weights are kept, and the backward recomputes through `gdfn_ref`.
    Gradients come back in the shapes of the weight views it was given."""

    @staticmethod
    def forward(ctx, x, kw, w1, dwk, w2):
        ctx.save_for_backward(x, w1, dwk, w2)
        return _forward_kernel(x, kw)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            dx, dw1, ddwk, dw2 = torch.autograd.grad(gdfn_ref(*leaves),
                                                     leaves, g)
        return dx, None, dw1, ddwk, dw2


def gdfn_fused(x: torch.Tensor, w1, dwk, w2, kw: dict | None = None):
    """GDFN (JAX `gdfn_fused`).  x: (B, H, W, C) float32 or bfloat16; w1:
    (C, 2h); dwk: (3, 3, 2h); w2: (h, C); bias-free.  kw: the
    `prepare_gdfn_weights` output for x's dtype, made here when not given
    (GDFN caches it per module).  Returns (B, H, W, C) in x's dtype, with
    no residual.

    CPU tensors take `gdfn_ref`.  CUDA tensors launch the kernel; an input
    it cannot take raises.  When an input needs a gradient, the call runs
    as `_GdfnFunction`, whose backward recomputes through `gdfn_ref`."""
    if x.device.type == "cpu":
        return gdfn_ref(x, w1, dwk, w2)
    if kw is None:
        with torch.no_grad():
            kw = prepare_gdfn_weights(w1, dwk, w2, x.dtype)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w1, dwk, w2))
    if not needs_grad:
        return _forward_kernel(x, kw)
    return _GdfnFunction.apply(x, kw, w1, dwk, w2)


gdfn_fused.launches = 0
