"""Whole NAFBlock: plain PyTorch version and CUDA kernels.

Counterpart of textualdegremoval_tpu/ops/pallas/nafblock.py.  `nafblock_ref`
is the plain version (the JAX `nafblock_ref`, identical math to the module
path).  `nafblock_fused` runs the block as hand-written Hopper kernels that
replace the TPU kernels `_make_sum_kernel` (pass A) and
`_make_apply_kernel` (pass B) of `_nafblock_impl`.  One rule picks them
(`_takes_naf_pipeline`):

* a bfloat16 x whose C is a multiple of 8 (every width of the shipped
  NAFNets) runs `naf_pipeline`, a sequence of TMA + wgmma products and
  TMA-fed stencils: csrc/naf_stencil.cu (the gate stencil's sum and apply
  passes, the SCA glue) with csrc/bwd_gemm.cu's NAFBlock epilogues and
  csrc/bwd_stencil.cu's LayerNorm rows, laid out at the top of
  csrc/naf_stencil.cu;
* float32 (the parity path), and a bfloat16 width that the pipeline's TMA
  rows cannot take, run the kernel pair in csrc/nafblock.cu:

* pass A writes per-CTA partial per-channel pixel sums of the gate; they
  are added over the partial axis here in a fixed order, so the result is
  bitwise repeatable;
* the SCA glue (pooled = sum / (H W) in the compute dtype, then
  s = pooled @ sca_w + sca_b; O(C^2) per image) is plain torch, as it was
  plain XLA in the JAX package;
* pass B recomputes the gate, applies s, conv3 and the beta residual, LN2,
  the pointwise gated FFN and the gamma residual, and writes the output.

What bounds each route on the card and what its design does about it is
noted at the top of csrc/naf_stencil.cu and csrc/nafblock.cu.

`nafblock_fused` is differentiable (JAX's `custom_vjp` of the same name):
on CUDA, when an input needs a gradient, it runs as `_NAFBlockFunction`,
whose backward recomputes through `nafblock_ref` one half at a time, as the
JAX `_nafblock_ref_remat` does: the JAX kernel has no backward kernel.
Nothing but the inputs is kept from the forward.

A block on one rank's slab of an image split by rows over
torch.distributed ranks (`shard`, the evaluate CLI's --spatial_shard) runs
on the slab and NAF_HALO row of each neighbour's (tblock.py `_sharded`):
the SCA's pixel sums take the slab's own rows only (the kernels' row
window: csrc/nafblock.cu's `nafblock_sum_rows`, the pipeline's
`naf_gate_stencil_rows`; the plain version's `sca_pool` over them), are
summed in float32 over the ranks and divided by the whole image's pixel
count, and the halo rows are cropped from the output.  Without a shard
every kernel's window is the whole tensor, as before.  A sharded block is
a forward only.

A CPU tensor goes through `nafblock_ref` (plain autograd); a CUDA tensor
launches the kernels or raises.  `nafblock_fused.launches` counts block
calls on the card (either route), never plain-version calls;
`naf_pipeline.launches` counts those that ran the pipeline.
"""

from __future__ import annotations

import torch

from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.norm import layer_norm_2d
from textualdegremoval_tpu_torch.ops.pallas.tblock import (
    _card, _check, _first_fit, _ptr, _sharded,
)

# NAFNet's LayerNorm2d epsilon (ops/norm.py layer_norm_2d)
_EPS = 1e-6

# The kernel's gate-channel chunk (kGC in csrc/nafblock.cu); the gate width
# is zero-padded to a multiple of it.
GATE_CHUNK = 32

# Tiles (rows, cols) in order of preference; the first whose shared memory
# fits one block is taken.  Both passes hold LN1 of the tile and its 1-pixel
# halo at full width, so wide blocks get small tiles.
_TILES = ((4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))

# rows of the neighbours a sharded block reads: the depthwise 3x3 conv's,
# on conv1's output (which the block zero-pads, not x: so the halo holds
# only what the neighbours have, `halo_rows`)
NAF_HALO = 1

# the parameters of each half (the backward differentiates one at a time)
_CONV_KEYS = ("norm1_w", "norm1_b", "w1", "b1", "dw", "dwb", "sca_w", "sca_b",
              "w3", "b3", "beta")
_FFN_KEYS = ("norm2_w", "norm2_b", "w4", "b4", "w5", "b5", "gamma")


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _lin(v, w, b, cin, cout):
    return v @ w.reshape(cin, cout).to(v.dtype) + b.to(v.dtype)


def sca_pool(g, rows=None, reduce=None, pixels=None):
    """The SCA's global mean of the gate g (B, H, W, C), (B, 1, 1, C) in
    g's dtype.  On a slab of a row-sharded image: float32 sums over g's
    rows [lo, hi) = rows (its own, not its halo), summed over the ranks by
    reduce (in place), divided by `pixels`, the whole image's count."""
    if reduce is None:
        return g.mean(dim=(1, 2), keepdim=True)
    sums = g[:, rows[0]: rows[1]].float().sum((1, 2))
    reduce(sums)
    return (sums / pixels).to(g.dtype)[:, None, None]


def _nafblock_conv_part(x, p, rows=None, reduce=None, pixels=None):
    c = x.shape[-1]
    dt = x.dtype
    y = layer_norm_2d(x, p["norm1_w"], p["norm1_b"])
    h = _lin(y, p["w1"], p["b1"], c, 2 * c)
    h = dwconv(h, p["dw"]) + p["dwb"].to(dt)
    g = h[..., :c] * h[..., c:]
    pooled = sca_pool(g, rows, reduce, pixels)
    s = _lin(pooled, p["sca_w"], p["sca_b"], c, c)
    o = _lin(g * s, p["w3"], p["b3"], c, c)
    return x + o * p["beta"].reshape(1, 1, 1, c).to(dt)


def _nafblock_ffn_part(y1, p):
    c = y1.shape[-1]
    z = layer_norm_2d(y1, p["norm2_w"], p["norm2_b"])
    h2 = _lin(z, p["w4"], p["b4"], c, 2 * c)
    o2 = _lin(h2[..., :c] * h2[..., c:], p["w5"], p["b5"], c, c)
    return y1 + o2 * p["gamma"].reshape(1, 1, 1, c).to(y1.dtype)


def nafblock_ref(x, p, shard=None):
    """Whole NAFBlock, plain torch.  x: (B, H, W, C).  p keys (JAX natural
    shapes): norm1_w/b (C,), w1 (1,1,C,2C), b1 (2C,), dw (3,3,1,2C),
    dwb (2C,), sca_w (1,1,C,C), sca_b (C,), w3 (1,1,C,C), b3 (C,),
    beta (1,1,1,C), norm2_w/b, w4 (1,1,C,2C), b4 (2C,), w5 (1,1,C,C),
    b5 (C,), gamma (1,1,1,C).

    shard: a parallel.spatial.RowShard where x is one rank's slab of a
    row-sharded image (tblock.py `_sharded`, NAF_HALO rows)."""
    if shard is not None:
        pixels = shard.height * x.shape[2]
        return _sharded(x, shard, NAF_HALO, lambda ext, rows, reduce:
                        _nafblock_ffn_part(_nafblock_conv_part(
                            ext, p, rows, reduce, pixels), p))
    return _nafblock_ffn_part(_nafblock_conv_part(x, p), p)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def prepare_nafblock_weights(p, dtype: torch.dtype) -> dict:
    """Kernel-layout weights of one block (JAX `_nafblock_impl` :266-289):
    w1 and w4 split into their two C-wide halves, interleaved per gate
    chunk so that one product makes both halves of a chunk; the (18, cpad)
    dwconv taps, f32; conv biases, beta and gamma as f32 arrays holding
    `dtype` values (the JAX kernel's b1 and bg rows, and b1, b4 also in
    the interleaved column order of w1 and w4, "b1i" and "b4i", for the
    pipeline's epilogues); LN affine f32.  The gate width is zero-padded
    to cpad, a multiple of GATE_CHUNK.  Matrices in `dtype`, bf16 ones
    transposed to (outputs, inputs).  Also the SCA 1x1 for the glue.
    Callers cache the result per module."""
    f32 = torch.float32
    c = p["norm1_w"].shape[0]
    cpad = -(-c // GATE_CHUNK) * GATE_CHUNK
    dev = p["norm1_w"].device

    def rounded(v):
        return v.reshape(-1).to(dtype).to(f32)

    def halves(w):
        """(1,1,C,2C) -> (C, 2 cpad): per gate chunk, its first-half
        columns, then its second-half columns."""
        w = w.reshape(c, 2 * c).to(f32)
        ws = torch.zeros((c, 2, cpad), dtype=f32, device=dev)
        ws[:, 0, :c] = w[:, :c]
        ws[:, 1, :c] = w[:, c:]
        return (ws.reshape(c, 2, cpad // GATE_CHUNK, GATE_CHUNK)
                .transpose(1, 2).reshape(c, 2 * cpad))

    def pair(v):
        """(2C,) -> (2, cpad): the two halves' rows."""
        out = torch.zeros((2, cpad), dtype=f32, device=dev)
        out[0, :c], out[1, :c] = v[:c], v[c:]
        return out

    def interleaved(v):
        """(2C,) -> (2 cpad,) in `halves`' column order."""
        return (pair(v).reshape(2, cpad // GATE_CHUNK, GATE_CHUNK)
                .transpose(0, 1).reshape(2 * cpad).contiguous())

    def gate_rows(w):
        """(1,1,C,C) with the gate as input -> (cpad, C)."""
        out = torch.zeros((cpad, c), dtype=f32, device=dev)
        out[:c] = w.reshape(c, c).to(f32)
        return out

    def mat(t):
        """(inputs, outputs) -> the kernel's layout: bf16 (outputs,
        inputs), as the tensor-core fragments read it; f32 unchanged."""
        return (t.T if dtype == torch.bfloat16 else t).to(dtype).contiguous()

    dwf = p["dw"].reshape(9, 2 * c).to(f32)
    taps = torch.zeros((18, cpad), dtype=f32, device=dev)
    taps[:9, :c], taps[9:, :c] = dwf[:, :c], dwf[:, c:]
    return dict(
        ln1w=p["norm1_w"].to(f32).contiguous(),
        ln1b=p["norm1_b"].to(f32).contiguous(),
        ln2w=p["norm2_w"].to(f32).contiguous(),
        ln2b=p["norm2_b"].to(f32).contiguous(),
        w1=mat(halves(p["w1"])), b1=pair(rounded(p["b1"])), taps=taps,
        dwb=pair(rounded(p["dwb"])), w3=mat(gate_rows(p["w3"])),
        w4=mat(halves(p["w4"])), b4=pair(rounded(p["b4"])),
        b1i=interleaved(rounded(p["b1"])), b4i=interleaved(rounded(p["b4"])),
        w5=mat(gate_rows(p["w5"])),
        bg=torch.stack([rounded(p["b3"]), rounded(p["beta"]),
                        rounded(p["b5"]), rounded(p["gamma"])]).contiguous(),
        sca_w=p["sca_w"].reshape(c, c).to(dtype).contiguous(),
        sca_b=p["sca_b"].to(dtype).contiguous(),
        cpad=cpad, dtype=dtype)


def _launch(lib, x, kw, sum_tile, apply_tile, nsplit, stream, rows=None,
            reduce=None, pixels=None):
    """Pass A, the SCA glue and pass B on already validated inputs.  Outputs
    and partials are allocated on x's device; `stream` is a cudaStream_t as
    an int (0 for the default stream).  rows, reduce, pixels: a sharded
    slab's window of rows for the sums, their sum over the ranks and the
    whole image's pixel count (`sca_pool`)."""
    b, hgt, wdt, c = x.shape
    lo, hi = (0, hgt) if rows is None else rows
    cpad = kw["cpad"]
    is_bf16 = int(x.dtype == torch.bfloat16)
    part = torch.empty((b, nsplit, cpad), dtype=torch.float32,
                       device=x.device)
    _check(lib.nafblock_sum_rows(
        _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["w1"]),
        _ptr(kw["b1"]), _ptr(kw["taps"]), _ptr(kw["dwb"]), _ptr(part), b, hgt,
        wdt, c, cpad, is_bf16, sum_tile[0], sum_tile[1], nsplit, lo, hi,
        stream), lib, "nafblock_sum")

    # SCA glue: global mean -> 1x1 (JAX :315-319)
    sums = part.sum(1)
    if reduce is not None:
        reduce(sums)
    pooled = (sums[:, :c] / (hgt * wdt if pixels is None else pixels)).to(
        x.dtype)
    s = (pooled @ kw["sca_w"] + kw["sca_b"]).contiguous()

    out = torch.empty_like(x)
    _check(lib.nafblock_apply(
        _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["w1"]),
        _ptr(kw["b1"]), _ptr(kw["taps"]), _ptr(kw["dwb"]), _ptr(s),
        _ptr(kw["w3"]), _ptr(kw["ln2w"]), _ptr(kw["ln2b"]), _ptr(kw["w4"]),
        _ptr(kw["b4"]), _ptr(kw["w5"]), _ptr(kw["bg"]), _ptr(out), b, hgt,
        wdt, c, cpad, is_bf16, apply_tile[0], apply_tile[1], stream),
        lib, "nafblock_apply")
    return out


def pick_tiles(lib, c: int, elem_bytes: int):
    """The (pass A, pass B) tiles for channel width c: the first of
    _TILES whose shared memory fits one block."""
    return tuple(_first_fit(_TILES, lambda t, pass_id=pass_id:
                            lib.nafblock_smem_bytes(pass_id, c, t[0], t[1],
                                                    elem_bytes),
                            "nafblock_fused")
                 for pass_id in (0, 1))


def _naf_nsplit(lib, b, hgt, wdt, nchunk, sms):
    """Tile splits per (chunk, image) of the gate stencil: at most two full
    waves of its 48 KB CTAs, four an SM, in all, at most one per tile."""
    tiles = (-(-hgt // lib.bwd_stencil_tile(0))
             * -(-wdt // lib.bwd_stencil_tile(1)))
    return max(1, min(tiles, 2 * 4 * sms // (b * nchunk)))


def naf_pipeline(lib, x, kw, sms, stream, rows=None, reduce=None,
                 pixels=None):
    """The bf16 block forward as the Hopper pipeline laid out at the top of
    csrc/naf_stencil.cu, on validated inputs that `_takes_naf_pipeline`
    admits.  `sms` (the card's SMs) sets the stencil's splits; `stream` is
    a cudaStream_t as an int.  Scratch is allocated on x's device and
    dropped as the block goes.  rows, reduce, pixels as `_launch` takes
    them: a sharded slab's SUM pass takes its window, its partials are
    summed here and over the ranks, and the glue takes them as one
    partial over the whole image's pixels.  `naf_pipeline.launches`
    counts its block calls."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import _ln_rows

    b, hgt, wdt, c = x.shape
    cpad, npix = kw["cpad"], b * hgt * wdt
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    bg = kw["bg"]  # rows b3, beta, b5, gamma
    ys = _ln_rows(lib, x, kw["ln1w"], kw["ln1b"], 0, stream, _EPS)[0]
    hids = torch.empty((npix, 2 * cpad), dtype=bf, device=dev)
    _check(lib.naf_gemm_bias(_ptr(ys), _ptr(kw["w1"]), _ptr(kw["b1i"]), None,
                             None, _ptr(hids), npix, 2 * cpad, c, stream),
           lib, "naf_gemm_bias")
    del ys
    nsplit = _naf_nsplit(lib, b, hgt, wdt, cpad // GATE_CHUNK, sms)
    lo, hi = (0, hgt) if rows is None else rows
    part = torch.empty((b, nsplit, cpad), dtype=f32, device=dev)
    _check(lib.naf_gate_stencil_rows(
        _ptr(hids), _ptr(kw["taps"]), _ptr(kw["dwb"]), None, None, _ptr(part),
        b, hgt, wdt, cpad, nsplit, 0, lo, hi, stream), lib,
        "naf_gate_stencil")
    count, nparts = hgt * wdt, nsplit
    if reduce is not None:  # one partial: the sums over every rank's rows
        part = part.sum(1, keepdim=True)
        reduce(part)
        count, nparts = pixels, 1
    s = torch.empty((b, cpad), dtype=f32, device=dev)
    _check(lib.naf_sca_glue(_ptr(part), _ptr(kw["sca_w"]), _ptr(kw["sca_b"]),
                            _ptr(s), b, count, c, cpad, nparts, stream),
           lib, "naf_sca_glue")
    del part
    gs = torch.empty((npix, cpad), dtype=bf, device=dev)
    _check(lib.naf_gate_stencil(_ptr(hids), _ptr(kw["taps"]), _ptr(kw["dwb"]),
                                _ptr(s), _ptr(gs), None, b, hgt, wdt, cpad,
                                nsplit, 1, stream), lib, "naf_gate_stencil")
    del hids, s
    y1 = torch.empty_like(x)
    _check(lib.naf_gemm_bias(_ptr(gs), _ptr(kw["w3"]), _ptr(bg[0]),
                             _ptr(bg[1]), _ptr(x), _ptr(y1), npix, c, cpad,
                             stream), lib, "naf_gemm_bias")
    del gs
    zs = _ln_rows(lib, y1, kw["ln2w"], kw["ln2b"], 0, stream, _EPS)[0]
    g2 = torch.empty((npix, cpad), dtype=bf, device=dev)
    _check(lib.naf_gemm_gate(_ptr(zs), _ptr(kw["w4"]), _ptr(kw["b4i"]),
                             _ptr(g2), npix, 2 * cpad, c, stream), lib,
           "naf_gemm_gate")
    del zs
    out = torch.empty_like(x)
    _check(lib.naf_gemm_bias(_ptr(g2), _ptr(kw["w5"]), _ptr(bg[2]),
                             _ptr(bg[3]), _ptr(y1), _ptr(out), npix, c, cpad,
                             stream), lib, "naf_gemm_bias")
    naf_pipeline.launches += 1
    return out


naf_pipeline.launches = 0


def _takes_naf_pipeline(x: torch.Tensor) -> bool:
    """The forward's route rule: `naf_pipeline` takes a bfloat16 x whose C
    is a multiple of 8 (it reads pixel rows through TMA, whose rows are
    multiples of 16 bytes); float32 and any other bfloat16 width run
    csrc/nafblock.cu's pair."""
    return x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0


def _kernel_library():
    """The kernel library, after checking the gate chunk of both routes."""
    from textualdegremoval_tpu_torch.ops._build import load_library

    lib = load_library()
    if lib.nafblock_gate_chunk() != GATE_CHUNK \
            or lib.naf_gate_chunk() != GATE_CHUNK:
        raise RuntimeError("nafblock_fused: gate chunk differs from the "
                           "kernel")
    return lib


def _validate(x, kw):
    """Raise on a CUDA input, or prepared weights, that the kernels do not
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"nafblock_fused: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"nafblock_fused: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"nafblock_fused: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("nafblock_fused: x must be contiguous (NHWC)")
    if kw is None:
        raise ValueError("nafblock_fused: a CUDA tensor needs the block's "
                         "weights from prepare_nafblock_weights (kw)")
    if kw["dtype"] != x.dtype or kw["w3"].device != x.device \
            or kw["ln1w"].shape[0] != x.shape[-1]:
        raise ValueError("nafblock_fused: prepared weights do not match x")


def _forward_kernel(x, kw, rows=None, reduce=None, pixels=None):
    """Validated launch of the forward kernels on a CUDA tensor: the
    pipeline or the pair, as `_takes_naf_pipeline` rules; rows, reduce and
    pixels as `_launch` takes them."""
    _validate(x, kw)
    lib = _kernel_library()
    stream, sms = _card(x.device)
    if _takes_naf_pipeline(x):
        out = naf_pipeline(lib, x, kw, sms, stream, rows, reduce, pixels)
    else:
        b, hgt, wdt, c = x.shape
        sum_tile, apply_tile = pick_tiles(lib, c, x.element_size())
        ntiles = (-(-hgt // sum_tile[0])) * (-(-wdt // sum_tile[1]))
        nsplit = max(1, min(ntiles, -(-2 * sms // b)))
        out = _launch(lib, x, kw, sum_tile, apply_tile, nsplit, stream, rows,
                      reduce, pixels)
    nafblock_fused.launches += 1
    return out


class _NAFBlockFunction(torch.autograd.Function):
    """The block on CUDA (JAX `_fwd`/`_bwd` of the `custom_vjp`): the
    forward is the kernels (`_forward_kernel`); the backward recomputes through
    `nafblock_ref` one half at a time (the FFN half from y1 recomputed
    without a graph, then the conv half), so only one half's 2C-wide
    intermediates are alive at once.  Gradients come back in the natural
    shapes of the parameter views it was given, so they land on the
    module's parameters."""

    @staticmethod
    def forward(ctx, x, kw, keys, *values):
        out = _forward_kernel(x, kw)
        ctx.save_for_backward(x, *values)
        ctx.keys = keys
        return out

    @staticmethod
    def backward(ctx, g):
        x, *values = ctx.saved_tensors
        p = {k: v.detach().requires_grad_(True)
             for k, v in zip(ctx.keys, values)}
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            with torch.no_grad():
                y1 = _nafblock_conv_part(x, p)
            y1.requires_grad_(True)
            ffn = [k for k in ctx.keys if k in _FFN_KEYS]
            dy1, *gf = torch.autograd.grad(
                _nafblock_ffn_part(y1, p), [y1] + [p[k] for k in ffn], g)
            del y1
            conv = [k for k in ctx.keys if k in _CONV_KEYS]
            dx, *gc = torch.autograd.grad(
                _nafblock_conv_part(x, p), [x] + [p[k] for k in conv], dy1)
        grads = {**dict(zip(ffn, gf)), **dict(zip(conv, gc))}
        return (dx, None, None, *(grads[k] for k in ctx.keys))


def nafblock_fused(x: torch.Tensor, p, kw: dict | None = None, shard=None):
    """Whole NAFBlock.  x: (B, H, W, C) float32 or bfloat16; p: the
    natural-shape parameter dict of `nafblock_ref`; kw: its
    `prepare_nafblock_weights` output, built once by the caller and
    required on CUDA (NAFBlock caches it per module).  shard: a
    parallel.spatial.RowShard where x is one rank's slab of a row-sharded
    image (the kernels run on the slab and its halo, their sums' window
    on the slab's own rows); a forward only, so a call that needs a
    gradient raises.

    CPU tensors take `nafblock_ref`.  CUDA tensors launch the kernels at
    every shape (the bf16 pipeline or csrc/nafblock.cu's pair, as
    `_takes_naf_pipeline` rules); any input they cannot take raises."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in p.values()))
    if shard is not None:
        if needs_grad:
            raise ValueError("nafblock_fused: a row-sharded block is a "
                             "forward only; it has no gradient")
        if x.device.type == "cpu":
            return nafblock_ref(x, p, shard)
        pixels = shard.height * x.shape[2]
        return _sharded(x, shard, NAF_HALO, lambda ext, rows, reduce:
                        _forward_kernel(ext, kw, rows, reduce, pixels))
    if x.device.type == "cpu":
        return nafblock_ref(x, p)
    if not needs_grad:
        return _forward_kernel(x, kw)
    keys = tuple(p)
    return _NAFBlockFunction.apply(x, kw, keys, *(p[k] for k in keys))


nafblock_fused.launches = 0
