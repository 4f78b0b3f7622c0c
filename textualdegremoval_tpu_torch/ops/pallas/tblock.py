"""Whole Restormer TransformerBlock: plain PyTorch version and CUDA kernel.

Counterpart of textualdegremoval_tpu/ops/pallas/tblock.py.  `tblock_ref` is
the plain version (the JAX `tblock_ref`, identical math to the module
path).  `tblock_fused` runs the block as the hand-written Hopper kernel pair
in csrc/tblock.cu, which replaces the TPU kernels `_make_stats_kernel`
(pass A) and `_make_apply_kernel` (pass B):

* pass A writes per-CTA partial per-head grams and q/k square sums; they
  are added over the partial axis here in a fixed order, so the result is
  bitwise repeatable;
* the glue `_attn_matrix` (norms, temperature, f32 softmax; O(C * cph)) is
  plain torch, as it was plain XLA in the JAX package;
* pass B applies the attention, project_out, both residuals, LN2 and the
  GDFN, and writes only the C-wide output.

What bounds the kernel on the card and what its design does about it is
noted at the top of csrc/tblock.cu.

A CPU tensor goes through `tblock_ref`; a CUDA tensor launches the kernel
or raises.  `tblock_fused.launches` counts kernel launches (one per block
call), never plain-version calls.
"""

from __future__ import annotations

import ctypes

import torch

from textualdegremoval_tpu_torch.ops.attention import mdta_attention_nhwc
from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.norm import (
    bias_free_layer_norm, with_bias_layer_norm,
)
from textualdegremoval_tpu_torch.ops.pallas.gdfn import gdfn_ref

# The kernel's GDFN hidden chunk (kHC in csrc/tblock.cu); the hidden width
# is zero-padded to a multiple of it.
HIDDEN_CHUNK = 32

# Tiles (rows, cols) in order of preference; the first whose shared memory
# fits one block is taken.  Measured on an H100 over the main path's block
# shapes: pass B is fastest at 32 pixels (4 x 8) wherever that fits, even
# at one CTA per SM, pass A at 32-64; smaller tiles lose to halo recompute.
_STATS_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
_APPLY_TILES = ((4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
_SMEM_BLOCK_LIMIT = 227 * 1024


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _ln(x, w, b, ln_type):
    if ln_type == "BiasFree":
        return bias_free_layer_norm(x, w)
    return with_bias_layer_norm(x, w, b)


def _tblock_attn_part(x, p, heads, ln_type):
    c = x.shape[-1]
    y = _ln(x, p["norm1_w"], p.get("norm1_b"), ln_type)
    qkv = y @ p["qkv"].reshape(c, 3 * c).to(y.dtype)
    qkv = dwconv(qkv, p["qkv_dw"])
    q, k, v = torch.split(qkv, c, dim=-1)
    o = mdta_attention_nhwc(q, k, v, p["temperature"], heads)
    o = o @ p["proj"].reshape(c, c).to(o.dtype)
    return x + o


def _tblock_gdfn_part(x, p, ln_type):
    c = x.shape[-1]
    z = _ln(x, p["norm2_w"], p.get("norm2_b"), ln_type)
    h2 = p["gd_in"].shape[-1]
    g = gdfn_ref(z, p["gd_in"].reshape(c, h2),
                 p["gd_dw"].reshape(3, 3, h2),
                 p["gd_out"].reshape(h2 // 2, c))
    return x + g


def tblock_ref(x, p, heads: int, ln_type: str = "WithBias"):
    """Whole TransformerBlock, plain torch.  x: (B, H, W, C).  p keys (JAX
    natural shapes): norm1_w (C,), norm1_b (C,), qkv (1,1,C,3C),
    qkv_dw (3,3,1,3C), temperature (heads,1,1), proj (1,1,C,C), norm2_w,
    norm2_b, gd_in (1,1,C,2h), gd_dw (3,3,1,2h), gd_out (1,1,h,C)."""
    x = _tblock_attn_part(x, p, heads, ln_type)
    return _tblock_gdfn_part(x, p, ln_type)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def prepare_tblock_weights(p, dtype: torch.dtype, ln_type: str) -> dict:
    """Kernel-layout weights of one block (JAX `_prep_block_weights`): split
    q/k/v, taps stacked per pass, the GDFN hidden zero-padded to a multiple
    of HIDDEN_CHUNK.  Matrices in `dtype` (bf16 ones transposed to
    (outputs, inputs)), LN parameters and taps in f32.  Callers cache the result per
    module."""
    f32 = torch.float32
    c = p["norm1_w"].shape[0]
    qkv = p["qkv"].reshape(c, 3 * c).to(f32)
    dwqkv = p["qkv_dw"].reshape(9, 3 * c).to(f32)
    h2 = p["gd_in"].shape[-1]
    hidden = h2 // 2
    hpad = -(-hidden // HIDDEN_CHUNK) * HIDDEN_CHUNK
    dev = qkv.device

    # w1's outputs per hidden chunk: the chunk's h1 columns, then its h2
    # columns, so that one product makes both halves of a chunk
    w1 = p["gd_in"].reshape(c, h2).to(f32)
    w1s = torch.zeros((c, 2, hpad), dtype=f32, device=dev)
    w1s[:, 0, :hidden] = w1[:, :hidden]
    w1s[:, 1, :hidden] = w1[:, hidden:]
    w1s = (w1s.reshape(c, 2, hpad // HIDDEN_CHUNK, HIDDEN_CHUNK)
           .transpose(1, 2).reshape(c, 2 * hpad))
    dwgf = p["gd_dw"].reshape(9, h2).to(f32)
    dwg = torch.zeros((18, hpad), dtype=f32, device=dev)
    dwg[:9, :hidden] = dwgf[:, :hidden]
    dwg[9:, :hidden] = dwgf[:, hidden:]
    w2s = torch.zeros((hpad, c), dtype=f32, device=dev)
    w2s[:hidden] = p["gd_out"].reshape(hidden, c).to(f32)

    def vec(name):
        if ln_type == "BiasFree" or name not in p:
            return torch.zeros(c, dtype=f32, device=dev)
        return p[name].to(f32).contiguous()

    def mat(t):
        """(inputs, outputs) -> the kernel's layout: bf16 (outputs, inputs),
        as the tensor-core fragments read it; f32 unchanged."""
        return (t.T if dtype == torch.bfloat16 else t).to(dtype).contiguous()

    return dict(
        ln1w=p["norm1_w"].to(f32).contiguous(), ln1b=vec("norm1_b"),
        ln2w=p["norm2_w"].to(f32).contiguous(), ln2b=vec("norm2_b"),
        wq=mat(qkv[:, :c]), wk=mat(qkv[:, c:2 * c]), wv=mat(qkv[:, 2 * c:]),
        dwqk=torch.cat([dwqkv[:, :c], dwqkv[:, c:2 * c]], 0).contiguous(),
        dwv=dwqkv[:, 2 * c:].contiguous(),
        wproj=mat(p["proj"].reshape(c, c)),
        w1=mat(w1s), dwg=dwg, w2=mat(w2s), hpad=hpad,
        temperature=p["temperature"].to(f32).reshape(-1).contiguous(),
        dtype=dtype,
    )


def _attn_matrix(gram, qssq, kssq, temperature, heads, dtype):
    """Per-head normalised softmax from the statistics (JAX `_attn_matrix`
    without assembling the block-diagonal C x C matrix).

    gram: (B, heads, cph, cph); qssq, kssq: (B, C).  Returns
    (B, heads, cph, cph) in `dtype`."""
    b, _, cph, _ = gram.shape
    qn = torch.rsqrt(torch.clamp_min(qssq, 1e-24)).reshape(b, heads, cph)
    kn = torch.rsqrt(torch.clamp_min(kssq, 1e-24)).reshape(b, heads, cph)
    g = gram * (qn[..., :, None] * kn[..., None, :])
    g = torch.softmax(g * temperature.reshape(1, heads, 1, 1), dim=-1)
    return g.to(dtype).contiguous()


def _pick_tile(lib, tiles, pass_id, c, heads, elem_bytes):
    for t in tiles:
        if lib.tblock_smem_bytes(pass_id, c, heads, t[0], t[1],
                                 elem_bytes) <= _SMEM_BLOCK_LIMIT:
            return t
    raise ValueError(f"no tile fits shared memory for C={c}")


def _check(rc: int, lib, what: str):
    if rc != 0:
        msg = lib.tblock_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(lib, x, kw, heads, ln_type, stats_tile, apply_tile, nsplit,
            stream) -> torch.Tensor:
    """Pass A, the glue and pass B on already validated inputs.  Outputs and
    partials are allocated on x's device; `stream` is a cudaStream_t as an
    int (0 for the default stream)."""
    b, hgt, wdt, c = x.shape
    cph = c // heads
    f32 = torch.float32
    is_bf16 = int(x.dtype == torch.bfloat16)
    bias_free = int(ln_type == "BiasFree")
    stream = ctypes.c_void_p(stream)

    gram_part = torch.empty((b, nsplit, heads, cph, cph), dtype=f32,
                            device=x.device)
    qs_part = torch.empty((b, nsplit, c), dtype=f32, device=x.device)
    ks_part = torch.empty((b, nsplit, c), dtype=f32, device=x.device)
    _check(lib.tblock_stats(
        _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["wq"]),
        _ptr(kw["wk"]), _ptr(kw["dwqk"]), _ptr(gram_part), _ptr(qs_part),
        _ptr(ks_part), b, hgt, wdt, c, heads, is_bf16, bias_free,
        stats_tile[0], stats_tile[1], nsplit, stream), lib, "tblock_stats")

    attn = _attn_matrix(gram_part.sum(1), qs_part.sum(1), ks_part.sum(1),
                        kw["temperature"], heads, x.dtype)

    out = torch.empty_like(x)
    _check(lib.tblock_apply(
        _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["wv"]),
        _ptr(kw["dwv"]), _ptr(attn), _ptr(kw["wproj"]), _ptr(kw["ln2w"]),
        _ptr(kw["ln2b"]), _ptr(kw["w1"]), _ptr(kw["dwg"]), _ptr(kw["w2"]),
        _ptr(out), b, hgt, wdt, c, heads, kw["hpad"], is_bf16, bias_free,
        apply_tile[0], apply_tile[1], stream), lib, "tblock_apply")
    return out


def tblock_fused(x: torch.Tensor, p, heads: int, ln_type: str = "WithBias",
                 kw: dict | None = None) -> torch.Tensor:
    """Whole TransformerBlock.  x: (B, H, W, C) float32 or bfloat16; p: the
    natural-shape parameter dict of `tblock_ref`; kw: its
    `prepare_tblock_weights` output, built once by the caller and required
    on CUDA (TransformerBlock caches it per module).

    CPU tensors take `tblock_ref`.  CUDA tensors launch the kernel; any
    input it cannot take raises."""
    if x.device.type == "cpu":
        return tblock_ref(x, p, heads, ln_type)
    if x.device.type != "cuda":
        raise ValueError(f"tblock_fused: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"tblock_fused: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tblock_fused: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("tblock_fused: x must be contiguous (NHWC)")
    if ln_type not in ("WithBias", "BiasFree"):
        raise ValueError(f"tblock_fused: unknown ln_type {ln_type!r}")
    b, hgt, wdt, c = x.shape
    if c % heads:
        raise ValueError(f"tblock_fused: C={c} not divisible by heads={heads}")
    cph = c // heads

    from textualdegremoval_tpu_torch.ops._build import load_library

    lib = load_library()
    if cph > lib.tblock_max_cph():
        raise ValueError(f"tblock_fused: {cph} channels per head exceeds "
                         f"{lib.tblock_max_cph()}")
    if lib.tblock_hidden_chunk() != HIDDEN_CHUNK:
        raise RuntimeError("tblock_fused: hidden chunk differs from the kernel")
    if kw is None:
        raise ValueError("tblock_fused: a CUDA tensor needs the block's "
                         "weights from prepare_tblock_weights (kw)")
    if kw["dtype"] != x.dtype or kw["wv"].device != x.device \
            or kw["wv"].shape[0] != c:
        raise ValueError("tblock_fused: prepared weights do not match x")

    eb = x.element_size()
    th, tw = _pick_tile(lib, _STATS_TILES, 0, c, heads, eb)
    ntiles = (-(-hgt // th)) * (-(-wdt // tw))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit = max(1, min(ntiles, -(-2 * sms // (b * heads))))
    out = _launch(lib, x, kw, heads, ln_type, (th, tw),
                  _pick_tile(lib, _APPLY_TILES, 1, c, heads, eb), nsplit,
                  torch.cuda.current_stream(x.device).cuda_stream)
    tblock_fused.launches += 1
    return out


tblock_fused.launches = 0
