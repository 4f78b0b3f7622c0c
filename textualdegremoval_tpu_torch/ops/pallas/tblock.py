"""Whole Restormer TransformerBlock: plain PyTorch version and CUDA kernel.

Counterpart of textualdegremoval_tpu/ops/pallas/tblock.py.  `tblock_ref` is
the plain version (the JAX `tblock_ref`, identical math to the module
path).  `tblock_fused` runs the block as hand-written Hopper kernels that
replace the TPU kernels `_make_stats_kernel` (pass A) and
`_make_apply_kernel` (pass B).  One rule picks them (`_takes_pipeline`):

* a bfloat16 x whose C and C / heads are multiples of 8 (every shipped
  configuration) runs `tblock_pipeline`, a sequence of TMA + wgmma
  products and TMA-fed stencils: csrc/fwd_stencil.cu with csrc/bwd_gemm.cu,
  csrc/bwd_stencil.cu's LayerNorm rows and csrc/wgrad.cu's gram (laid out
  at the top of csrc/fwd_stencil.cu), the glue as one kernel of
  csrc/fwd_stencil.cu that computes what `_attn_matrix` computes;
* float32 (the parity path), and a bfloat16 width the pipeline's TMA rows
  cannot take, run the kernel pair in csrc/tblock.cu:

* pass A writes per-CTA partial per-head grams and q/k square sums; they
  are added over the partial axis here in a fixed order, so the result is
  bitwise repeatable;
* the glue `_attn_matrix` (norms, temperature, f32 softmax; O(C * cph)) is
  plain torch, as it was plain XLA in the JAX package;
* pass B applies the attention, project_out, both residuals, LN2 and the
  GDFN, and writes the C-wide output (and, for the backward, x1 = the
  attention-residual boundary).

What bounds each on the card and what its design does about it is noted
at the top of csrc/fwd_stencil.cu and csrc/tblock.cu.

`tblock_fused` is differentiable (JAX's `custom_vjp` of the same name): on
CUDA, when an input needs a gradient, it runs as `_TBlockFunction`, whose
backward is the two hand-written backward kernels, `gdfn_half_bwd`
(ops/pallas/tblock_bwd.py) then `attn_half_bwd`
(ops/pallas/tblock_attn_bwd.py).  `bwd_mode='save'` keeps (x, x1, stats)
from the forward; `'remat'` keeps only x and recomputes x1 and the
statistics with the forward kernel inside the backward.

A CPU tensor goes through `tblock_ref` (plain autograd); a CUDA tensor
launches the kernels or raises.  `tblock_fused.launches` counts forward
block calls on the card (one per block call, the backward's recompute
under 'remat' included), never plain-version calls;
`tblock_pipeline.launches` counts those that ran the pipeline.

`tblock_chain_fused` runs n blocks in a row as the cross-block chain (JAX
`tblock_chain_fused`, replacing `_tblock_chain_impl` and its
`_make_apply_stats_kernel`), by the same rule as the block:
* bfloat16 at C and C / heads multiples of 8 runs `chain_pipeline`: the
  pipeline's kernels block after block, where each block boundary is one
  launch of csrc/bwd_gemm.cu's chain epilogue (`fwd_gemm_residual_ln`):
  block i's output and block i+1's LN1 rows from the same registers, so
  block i+1 does not read its input again to normalise it (C <= 384,
  `_chain_fuses`; wider stages run the boundary as block i's last product
  and block i+1's LN rows);
* float32 and other bf16 widths run pass A of the first block, then
  csrc/tblock_chain.cu for every block but the last (block i applied and
  block i+1's statistics taken from the output it makes), then pass B of
  the last block.
`tblock_chain_ref` is its plain version; its backward recomputes through
that plain chain, as JAX's does.
"""

from __future__ import annotations

import ctypes

import torch

from textualdegremoval_tpu_torch.ops.attention import mdta_attention_nhwc
from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.norm import (
    bias_free_layer_norm, with_bias_layer_norm,
)
from textualdegremoval_tpu_torch.ops.pallas.gdfn import (  # noqa: F401
    HIDDEN_CHUNK, gdfn_ref, kernel_matrix, pad_gdfn_weights,
)

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
    (outputs, inputs)), LN parameters, taps and temperatures in f32 whatever
    `dtype` is.  Also the transposed matrices that the backward kernels'
    products read (the 1x1s run backwards) and the 27 attention taps in one
    (27, C) array, and all of qkv in one matrix ("wqkv") for the bf16
    backward's products.  Callers cache the result per module."""
    f32 = torch.float32
    c = p["norm1_w"].shape[0]
    qkv = p["qkv"].reshape(c, 3 * c).to(f32)
    dwqkv = p["qkv_dw"].reshape(9, 3 * c).to(f32)
    h2 = p["gd_in"].shape[-1]
    w1s, dwg, w2s, hpad = pad_gdfn_weights(
        p["gd_in"].reshape(c, h2), p["gd_dw"], p["gd_out"].reshape(-1, c))
    dev = qkv.device

    def vec(name):
        if ln_type == "BiasFree" or name not in p:
            return torch.zeros(c, dtype=f32, device=dev)
        return p[name].to(f32).contiguous()

    def mat(t):
        return kernel_matrix(t, dtype)

    proj = p["proj"].reshape(c, c).to(f32)
    wq, wk, wv = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
    # the 27 attention taps: rows 0-8 q, 9-17 k (pass A), 18-26 v (pass B)
    dwall = torch.cat([dwqkv[:, :c], dwqkv[:, c:2 * c], dwqkv[:, 2 * c:]],
                      0).contiguous()
    return dict(
        ln1w=p["norm1_w"].to(f32).contiguous(), ln1b=vec("norm1_b"),
        ln2w=p["norm2_w"].to(f32).contiguous(), ln2b=vec("norm2_b"),
        wq=mat(wq), wk=mat(wk), wv=mat(wv), dwall=dwall, dwqk=dwall[:18],
        dwv=dwall[18:], wproj=mat(proj),
        w1=mat(w1s), dwg=dwg, w2=mat(w2s), hpad=hpad,
        temperature=p["temperature"].to(f32).reshape(-1).contiguous(),
        dtype=dtype,
        # the backward's products run the 1x1s the other way
        wqt=mat(wq.T), wkt=mat(wk.T), wvt=mat(wv.T), wprojt=mat(proj.T),
        w1t=mat(w1s.T), w2t=mat(w2s.T), wqkv=mat(qkv),
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


def _first_fit(tiles, smem_bytes, what: str):
    """The first tile (rows, cols) whose shared memory, smem_bytes(tile),
    fits one block."""
    for t in tiles:
        if smem_bytes(t) <= _SMEM_BLOCK_LIMIT:
            return t
    raise ValueError(f"{what}: no tile fits shared memory")


def _check(rc: int, lib, what: str):
    if rc != 0:
        msg = lib.tblock_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _pass_a(lib, x, kw, heads, ln_type, stats_tile, nsplit, stream):
    """Pass A (tblock_stats) of the block whose weights are kw on x, summed
    over its partials: (gram (B, heads, cph, cph), qssq (B, C), kssq
    (B, C)), f32.  `stream` is a cudaStream_t as an int (0 for the default
    stream)."""
    b, hgt, wdt, c = x.shape
    cph = c // heads
    f32 = torch.float32
    gram_part = torch.empty((b, nsplit, heads, cph, cph), dtype=f32,
                            device=x.device)
    qs_part = torch.empty((b, nsplit, c), dtype=f32, device=x.device)
    ks_part = torch.empty((b, nsplit, c), dtype=f32, device=x.device)
    _check(lib.tblock_stats(
        _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["wq"]),
        _ptr(kw["wk"]), _ptr(kw["dwqk"]), _ptr(gram_part), _ptr(qs_part),
        _ptr(ks_part), b, hgt, wdt, c, heads, int(x.dtype == torch.bfloat16),
        int(ln_type == "BiasFree"), stats_tile[0], stats_tile[1], nsplit,
        ctypes.c_void_p(stream)), lib, "tblock_stats")
    return gram_part.sum(1), qs_part.sum(1), ks_part.sum(1)


def _pass_b(lib, x, kw, attn, heads, ln_type, apply_tile, stream,
            want_x1=False):
    """Pass B (tblock_apply) of the block whose weights are kw on x with
    its softmaxed attention `attn`.  Returns (out, x1 or None)."""
    b, hgt, wdt, c = x.shape
    out = torch.empty_like(x)
    x1 = torch.empty_like(x) if want_x1 else None
    _check(lib.tblock_apply(
        _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["wv"]),
        _ptr(kw["dwv"]), _ptr(attn), _ptr(kw["wproj"]), _ptr(kw["ln2w"]),
        _ptr(kw["ln2b"]), _ptr(kw["w1"]), _ptr(kw["dwg"]), _ptr(kw["w2"]),
        _ptr(out), None if x1 is None else _ptr(x1), b, hgt, wdt, c, heads,
        kw["hpad"], int(x.dtype == torch.bfloat16),
        int(ln_type == "BiasFree"), apply_tile[0], apply_tile[1],
        ctypes.c_void_p(stream)), lib, "tblock_apply")
    return out, x1


def _launch(lib, x, kw, heads, ln_type, stats_tile, apply_tile, nsplit,
            stream, want_x1: bool = False):
    """csrc/tblock.cu: pass A, the glue and pass B on already validated
    inputs.  Outputs and partials are allocated on x's device.  Returns
    out, or with `want_x1` (out, x1, (gram, qssq, kssq)): the
    attention-residual boundary and the pass-A statistics (per-head gram
    (B, heads, cph, cph), square sums (B, C), f32) that the backward
    starts from."""
    stats = _pass_a(lib, x, kw, heads, ln_type, stats_tile, nsplit, stream)
    attn = _attn_matrix(*stats, kw["temperature"], heads, x.dtype)
    out, x1 = _pass_b(lib, x, kw, attn, heads, ln_type, apply_tile, stream,
                      want_x1)
    return (out, x1, stats) if want_x1 else out


def _scratch(buf, name, shape, dtype, device):
    """A scratch tensor: new where buf is None, else buf[name], made on
    first use (a chain's blocks share one buf)."""
    if buf is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if name not in buf:
        buf[name] = torch.empty(shape, dtype=dtype, device=device)
    return buf[name]


def _gate_stencil(lib, hids, dwg, b, hgt, wdt, hpad, sms, stream, gates):
    """csrc/fwd_stencil.cu's gate stencil: gates (npix, hpad) = gelu(dw3x3(
    h1)) dw3x3(h2) of hids (npix, 2 hpad) in W1's interleaved chunks,
    rounded once; TMA's zeros outside the image are the zero padding."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _stencil_nsplit)

    _check(lib.fwd_gate_stencil(
        _ptr(hids), _ptr(dwg), _ptr(gates), b, hgt, wdt, hpad,
        _stencil_nsplit(lib, b, hgt, wdt, hpad // HIDDEN_CHUNK, 4, sms),
        stream), lib, "fwd_gate_stencil")
    return gates


def _pipeline_attn(lib, x, ys, kw, heads, sms, stream, buf=None):
    """The attention half of the pipeline from LN1's rows ys (npix, C):
    lin = y . Wqkv, the q | k | v stencil with its square sums, the gram
    (csrc/wgrad.cu), the glue and fwd_attn_out.  Returns (x1, stats);
    scratch as `_scratch` gives it from buf."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _gemm, _stencil_nsplit, _wgrad,
    )

    b, hgt, wdt, c = x.shape
    cph, hw = c // heads, hgt * wdt
    npix = b * hw
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    lins = _gemm(lib, ys, kw["wqkv"], bf, stream,
                 _scratch(buf, "lins", (npix, 3 * c), bf, dev))
    # q | k | v and the square sums: four 48 KB CTAs per SM
    nsplit = _stencil_nsplit(lib, b, hgt, wdt, -(-3 * c // 64), 4, sms)
    qkv = _scratch(buf, "qkv", (npix, 3 * c), bf, dev)
    ssq_part = torch.empty((b, nsplit, 2 * c), dtype=f32, device=dev)
    _check(lib.fwd_qkv_stencil(_ptr(lins), _ptr(kw["dwall"]), _ptr(qkv),
                               _ptr(ssq_part), b, hgt, wdt, c, nsplit,
                               stream), lib, "fwd_qkv_stencil")
    del lins
    # gram = q_h^T k_h per (image, head), partials over pixel splits summed
    # in a fixed order; the glue kernel makes the attention
    gram = _wgrad(lib, qkv, 3 * c, (hw * 3 * c, cph), qkv[:, c:], 3 * c,
                  (hw * 3 * c, cph), hw, cph, cph, (b, heads), sms, stream)
    ssq = ssq_part.sum(1)
    stats = (gram, torch.empty((b, c), dtype=f32, device=dev),
             torch.empty((b, c), dtype=f32, device=dev))
    attn = torch.empty((b, heads, cph, cph), dtype=bf, device=dev)
    _check(lib.fwd_attn_glue(_ptr(gram), _ptr(ssq), _ptr(kw["temperature"]),
                             _ptr(stats[1]), _ptr(stats[2]), _ptr(attn), b, c,
                             heads, stream), lib, "fwd_attn_glue")
    del ssq_part, ssq
    o = _scratch(buf, "o", (npix, c), bf, dev)
    x1 = _scratch(buf, "x1", x.shape, bf, dev)
    _check(lib.fwd_attn_out(_ptr(qkv), _ptr(attn), _ptr(kw["wproj"]),
                            _ptr(x), _ptr(o), _ptr(x1), b, hw, c, heads,
                            stream), lib, "fwd_attn_out")
    return x1, stats


def _pipeline_gates(lib, x1, kw, ln_type, sms, stream, buf=None):
    """The GDFN half of the pipeline up to its last product: z = LN2(x1),
    hid = z . W1, the gate stencil.  Returns gates (npix, hpad)."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _EPS, _gemm, _ln_rows,
    )

    b, hgt, wdt, c = x1.shape
    npix, hpad = b * hgt * wdt, kw["hpad"]
    dev, bf = x1.device, torch.bfloat16
    zs = _ln_rows(lib, x1, kw["ln2w"], kw["ln2b"], int(ln_type == "BiasFree"),
                  stream, _EPS, _scratch(buf, "zs", (npix, c), bf, dev))[0]
    hids = _gemm(lib, zs, kw["w1"], bf, stream,
                 _scratch(buf, "hids", (npix, 2 * hpad), bf, dev))
    del zs
    return _gate_stencil(lib, hids, kw["dwg"], b, hgt, wdt, hpad, sms,
                         stream, _scratch(buf, "gates", (npix, hpad), bf,
                                          dev))


def tblock_pipeline(lib, x, kw, heads, ln_type, sms, stream,
                    want_x1: bool = False):
    """The bf16 block forward as the Hopper pipeline laid out at the top of
    csrc/fwd_stencil.cu, on validated inputs that `_takes_pipeline`
    admits.  `sms` (the card's SMs) sets the stencils' and the gram's
    splits; `stream` is a cudaStream_t as an int.  Scratch is allocated on
    x's device and dropped as the block goes.  Returns what `_launch`
    returns.  `tblock_pipeline.launches` counts its block calls."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _EPS, _ln_rows)

    npix, c = x.numel() // x.shape[-1], x.shape[-1]
    ys = _ln_rows(lib, x, kw["ln1w"], kw["ln1b"], int(ln_type == "BiasFree"),
                  stream, _EPS)[0]
    x1, stats = _pipeline_attn(lib, x, ys, kw, heads, sms, stream)
    del ys
    gates = _pipeline_gates(lib, x1, kw, ln_type, sms, stream)
    out = torch.empty_like(x)
    _check(lib.fwd_gemm_residual(_ptr(gates), _ptr(kw["w2"]), _ptr(x1),
                                 _ptr(out), npix, c, kw["hpad"], stream), lib,
           "fwd_gemm_residual")
    tblock_pipeline.launches += 1
    return (out, x1, stats) if want_x1 else out


tblock_pipeline.launches = 0


def _takes_pipeline(x: torch.Tensor, heads: int) -> bool:
    """The forward's route rule: `tblock_pipeline` takes a bfloat16 x whose
    C and C / heads are multiples of 8 (it reads pixel rows and heads
    through TMA, whose rows are multiples of 16 bytes); float32 and any
    other bfloat16 width run csrc/tblock.cu's pair."""
    c = x.shape[-1]
    return x.dtype == torch.bfloat16 and c % 8 == 0 and (c // heads) % 8 == 0


def _validate(x: torch.Tensor, heads: int, ln_type: str, what: str) -> None:
    """Raise on a CUDA input that the block kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (NHWC)")
    if ln_type not in ("WithBias", "BiasFree"):
        raise ValueError(f"{what}: unknown ln_type {ln_type!r}")
    c = x.shape[-1]
    if c % heads:
        raise ValueError(f"{what}: C={c} not divisible by heads={heads}")


def _check_weights(kw, x: torch.Tensor, what: str):
    if kw is None:
        raise ValueError(f"{what}: a CUDA tensor needs the block's weights "
                         "from prepare_tblock_weights (kw)")
    if kw["dtype"] != x.dtype or kw["wv"].device != x.device \
            or kw["wv"].shape[0] != x.shape[-1]:
        raise ValueError(f"{what}: prepared weights do not match x")


def _forward_kernel(x, kw, heads, ln_type, want_x1=False):
    """Validated launch of the forward kernels on a CUDA tensor: the
    pipeline or the pair, as `_takes_pipeline` rules."""
    _validate(x, heads, ln_type, "tblock_fused")
    _check_weights(kw, x, "tblock_fused")
    stream, sms = _card(x.device)
    if _takes_pipeline(x, heads):
        res = tblock_pipeline(_kernel_library(x.shape[-1] // heads,
                                              "tblock_fused"), x, kw, heads,
                              ln_type, sms, stream, want_x1)
    else:
        lib = _kernel_library(x.shape[-1] // heads, "tblock_fused")
        stats_tile, apply_tile, nsplit = _block_tiles(lib, x, heads, sms)
        res = _launch(lib, x, kw, heads, ln_type, stats_tile, apply_tile,
                      nsplit, stream, want_x1)
    tblock_fused.launches += 1
    return res


def _kernel_library(cph: int, what: str):
    """The kernel library, after checking that the forward kernels (both
    routes) take `cph` channels per head."""
    from textualdegremoval_tpu_torch.ops._build import load_library

    lib = load_library()
    if cph > lib.tblock_max_cph():
        raise ValueError(f"{what}: {cph} channels per head exceeds the "
                         f"forward kernels' limit of {lib.tblock_max_cph()}")
    if lib.tblock_hidden_chunk() != HIDDEN_CHUNK:
        raise RuntimeError(f"{what}: hidden chunk differs from the kernel")
    return lib


def _card(device):
    """(the current stream as a cudaStream_t int, the number of SMs) of a
    CUDA device."""
    return (torch.cuda.current_stream(device).cuda_stream,
            torch.cuda.get_device_properties(device).multi_processor_count)


def _block_tiles(lib, x, heads, sms=None):
    """Pass A's tile, pass B's tile and pass A's number of CTAs per (head,
    image) for x on a card of `sms` SMs (default: x's): the first tiles of
    the measured orders that fit shared memory, and about two CTAs per
    SM."""
    b, hgt, wdt, c = x.shape
    eb = x.element_size()
    if sms is None:
        sms = _card(x.device)[1]

    def pick(tiles, pass_id):
        return _first_fit(tiles, lambda t: lib.tblock_smem_bytes(
            pass_id, c, heads, t[0], t[1], eb), "tblock_fused")

    th, tw = pick(_STATS_TILES, 0)
    ntiles = (-(-hgt // th)) * (-(-wdt // tw))
    nsplit = max(1, min(ntiles, -(-2 * sms // (b * heads))))
    return (th, tw), pick(_APPLY_TILES, 1), nsplit


class _TBlockFunction(torch.autograd.Function):
    """The block on CUDA with its hand-written backward (JAX `_fwd`/`_bwd`
    of the `custom_vjp`).  Gradients come back in the natural shapes of
    the parameter views it was given, so they land on the module's
    parameters."""

    @staticmethod
    def forward(ctx, x, kw, heads, ln_type, bwd_mode, keys, *values):
        if bwd_mode == "remat":
            out = _forward_kernel(x, kw, heads, ln_type)
            ctx.save_for_backward(x, *values)
        else:
            out, x1, stats = _forward_kernel(x, kw, heads, ln_type,
                                             want_x1=True)
            ctx.save_for_backward(x, *values, x1, *stats)
        ctx.kw, ctx.heads, ctx.ln_type = kw, heads, ln_type
        ctx.bwd_mode, ctx.keys = bwd_mode, keys
        return out

    @staticmethod
    def backward(ctx, g):
        from textualdegremoval_tpu_torch.ops.pallas.tblock_attn_bwd import (
            attn_half_bwd)
        from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
            gdfn_half_bwd)

        saved = ctx.saved_tensors
        n = len(ctx.keys)
        x, p = saved[0], dict(zip(ctx.keys, saved[1:1 + n]))
        if ctx.bwd_mode == "remat":
            _, x1, stats = _forward_kernel(x, ctx.kw, ctx.heads, ctx.ln_type,
                                           want_x1=True)
        else:
            x1, stats = saved[1 + n], tuple(saved[2 + n:])
        dx1, gg = gdfn_half_bwd(x1, g.contiguous(), p, ctx.ln_type, ctx.kw)
        dx, ga = attn_half_bwd(x, dx1, p, ctx.heads, ctx.ln_type, stats,
                               ctx.kw)
        grads = {**gg, **ga}
        return (dx, None, None, None, None, None,
                *(grads[k] for k in ctx.keys))


def tblock_fused(x: torch.Tensor, p, heads: int, ln_type: str = "WithBias",
                 kw: dict | None = None, bwd_mode: str = "save"):
    """Whole TransformerBlock.  x: (B, H, W, C) float32 or bfloat16; p: the
    natural-shape parameter dict of `tblock_ref`; kw: its
    `prepare_tblock_weights` output, built once by the caller and required
    on CUDA (TransformerBlock caches it per module).  bwd_mode: 'save' or
    'remat' (see the module docstring).

    CPU tensors take `tblock_ref`.  CUDA tensors launch the kernels (the
    bf16 pipeline or csrc/tblock.cu's pair, as `_takes_pipeline` rules);
    any input they cannot take raises, and so does a gradient that the
    kernels cannot give: no gradient is ever silently dropped."""
    if x.device.type == "cpu":
        return tblock_ref(x, p, heads, ln_type)
    if bwd_mode not in ("save", "remat"):
        raise ValueError(f"tblock_fused: unknown bwd_mode {bwd_mode!r}")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in p.values()))
    if not needs_grad:
        return _forward_kernel(x, kw, heads, ln_type)
    keys = tuple(p)
    return _TBlockFunction.apply(x, kw, heads, ln_type, bwd_mode, keys,
                                 *(p[k] for k in keys))


tblock_fused.launches = 0


# ---------------------------------------------------------------------------
# Cross-block chain: block i applied and block i+1's statistics in one kernel
# ---------------------------------------------------------------------------

# Tiles of the chain kernel, in order of the work each recomputes on its
# 1-pixel ring ((th + 2) (tw + 2) / (th tw)); the first that fits shared
# memory is taken, with the gram accumulators in shared memory before in
# device memory at the same tile.
_CHAIN_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))


def tblock_chain_ref(x, ps, heads: int, ln_type: str = "WithBias"):
    """n TransformerBlocks one after the other, plain torch (JAX
    `_chain_ref`): `tblock_ref` block by block.  ps: the blocks'
    natural-shape parameter dicts."""
    for p in ps:
        x = tblock_ref(x, p, heads, ln_type)
    return x


def _chain_tile(lib, c, heads, eb):
    """(tile, gram_in_smem) of the chain kernel at width c: the first of
    _CHAIN_TILES that fits one block's shared memory, the gram
    accumulators in shared memory where they fit at that tile."""
    for th, tw in _CHAIN_TILES:
        for in_smem in (1, 0):
            if lib.tblock_chain_smem_bytes(c, heads, th, tw, eb,
                                           in_smem) <= _SMEM_BLOCK_LIMIT:
                return (th, tw), in_smem
    raise ValueError("tblock_chain_fused: no tile fits shared memory")


def _chain_launch(lib, x, kws, heads, ln_type, stats_tile, apply_tile,
                  nsplit_a, chain_tile, gram_in_smem, nsplit, stream):
    """The chain of len(kws) >= 2 blocks on already validated inputs: pass
    A of block 0, the chain kernel for each block but the last (block i
    applied, block i+1's statistics taken), pass B of the last block; the
    glue `_attn_matrix` between them.  Returns the last block's output."""
    b, hgt, wdt, c = x.shape
    cph = c // heads
    f32 = torch.float32
    bf16 = int(x.dtype == torch.bfloat16)
    bias_free = int(ln_type == "BiasFree")
    stats = _pass_a(lib, x, kws[0], heads, ln_type, stats_tile, nsplit_a,
                    stream)
    for kw, kn in zip(kws[:-1], kws[1:]):
        attn = _attn_matrix(*stats, kw["temperature"], heads, x.dtype)
        out = torch.empty_like(x)
        gram_part = torch.empty((b, nsplit, heads, cph, cph), dtype=f32,
                                device=x.device)
        qs_part = torch.empty((b, nsplit, c), dtype=f32, device=x.device)
        ks_part = torch.empty((b, nsplit, c), dtype=f32, device=x.device)
        _check(lib.tblock_chain(
            _ptr(x), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]), _ptr(kw["wv"]),
            _ptr(kw["dwv"]), _ptr(attn), _ptr(kw["wproj"]), _ptr(kw["ln2w"]),
            _ptr(kw["ln2b"]), _ptr(kw["w1"]), _ptr(kw["dwg"]), _ptr(kw["w2"]),
            _ptr(kn["ln1w"]), _ptr(kn["ln1b"]), _ptr(kn["wq"]),
            _ptr(kn["wk"]), _ptr(kn["dwqk"]), _ptr(out), _ptr(gram_part),
            _ptr(qs_part), _ptr(ks_part), b, hgt, wdt, c, heads, kw["hpad"],
            bf16, bias_free, chain_tile[0], chain_tile[1], nsplit,
            gram_in_smem, ctypes.c_void_p(stream)), lib, "tblock_chain")
        tblock_chain_fused.launches += 1
        x = out
        stats = (gram_part.sum(1), qs_part.sum(1), ks_part.sum(1))
    attn = _attn_matrix(*stats, kws[-1]["temperature"], heads, x.dtype)
    return _pass_b(lib, x, kws[-1], attn, heads, ln_type, apply_tile,
                   stream)[0]


def _chain_fuses(c: int) -> bool:
    """Whether `chain_pipeline` fuses its block boundaries at width c: the
    chain epilogue's CTA holds whole rows of out, which its two
    warpgroups' accumulators cover up to 384 columns (csrc/bwd_gemm.cu
    `run_gemm_ln`)."""
    return c <= 384


def chain_pipeline(lib, x, kws, heads, ln_type, sms, stream):
    """The bf16 chain of len(kws) >= 2 blocks on the pipeline's kernels, on
    validated inputs that `_takes_pipeline` admits: block 0's LN1 rows;
    then per block the attention half and the GDFN half up to its gates
    (`_pipeline_attn`, `_pipeline_gates`), and its last product: for every
    block but the last the chain epilogue `fwd_gemm_residual_ln` (out and
    the next block's LN1 rows in one launch; at widths `_chain_fuses`
    refuses, `fwd_gemm_residual` and the next block's LN rows), for the
    last `fwd_gemm_residual`.  The stage's scratch is allocated once and
    shared by its blocks; outputs alternate between two buffers.  Returns
    the last block's output.  Each block boundary counts one
    `tblock_chain_fused.launches` and one `chain_pipeline.launches`."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _EPS, _ln_rows)

    c = x.shape[-1]
    npix, hpad = x.numel() // c, kws[0]["hpad"]
    bias_free = int(ln_type == "BiasFree")
    fused = _chain_fuses(c)
    buf = {}
    ys = _scratch(buf, "ys", (npix, c), torch.bfloat16, x.device)
    _ln_rows(lib, x, kws[0]["ln1w"], kws[0]["ln1b"], bias_free, stream, _EPS,
             ys)
    outs = (torch.empty_like(x), torch.empty_like(x))
    for i, kw in enumerate(kws):
        x1, _ = _pipeline_attn(lib, x, ys, kw, heads, sms, stream, buf)
        gates = _pipeline_gates(lib, x1, kw, ln_type, sms, stream, buf)
        out, kn = outs[i % 2], kws[i + 1] if i + 1 < len(kws) else None
        if kn is not None and fused:
            _check(lib.fwd_gemm_residual_ln(
                _ptr(gates), _ptr(kw["w2"]), _ptr(x1), _ptr(kn["ln1w"]),
                _ptr(kn["ln1b"]), bias_free, _EPS, _ptr(out), _ptr(ys), npix,
                c, hpad, stream), lib, "fwd_gemm_residual_ln")
        else:
            _check(lib.fwd_gemm_residual(_ptr(gates), _ptr(kw["w2"]),
                                         _ptr(x1), _ptr(out), npix, c, hpad,
                                         stream), lib, "fwd_gemm_residual")
            if kn is not None:
                _ln_rows(lib, out, kn["ln1w"], kn["ln1b"], bias_free, stream,
                         _EPS, ys)
        if kn is not None:
            tblock_chain_fused.launches += 1
            chain_pipeline.launches += 1
        x = out
    return x


chain_pipeline.launches = 0


def _chain_kernel(x, kws, heads, ln_type):
    """Validated launches of the chain on a CUDA tensor (len(kws) >= 2):
    `chain_pipeline` or csrc/tblock_chain.cu's route, as `_takes_pipeline`
    rules."""
    _validate(x, heads, ln_type, "tblock_chain_fused")
    lib = _kernel_library(x.shape[-1] // heads, "tblock_chain_fused")
    for kw in kws:
        _check_weights(kw, x, "tblock_chain_fused")
    if len({kw["hpad"] for kw in kws}) != 1:
        raise ValueError("tblock_chain_fused: the blocks' hidden widths "
                         "differ")
    stream, sms = _card(x.device)
    tblock_chain_fused.calls += 1
    if _takes_pipeline(x, heads):
        return chain_pipeline(lib, x, kws, heads, ln_type, sms, stream)
    return chain_kernel_route(lib, x, kws, heads, ln_type, sms, stream)


def chain_kernel_route(lib, x, kws, heads, ln_type, sms, stream):
    """csrc/tblock_chain.cu's route (`_chain_launch`) on validated inputs,
    its tiles and splits picked for a card of `sms` SMs: float32 and the
    bf16 widths the pipeline cannot take (chip_smoke.py also times bf16
    stages on it beside the pipeline's chain)."""
    b, hgt, wdt, c = x.shape
    stats_tile, apply_tile, nsplit_a = _block_tiles(lib, x, heads, sms)
    tile, in_smem = _chain_tile(lib, c, heads, x.element_size())
    per_sm = lib.tblock_chain_ctas_per_sm(c, heads, tile[0], tile[1],
                                          int(x.dtype == torch.bfloat16),
                                          in_smem)
    if per_sm < 1:
        raise RuntimeError(f"tblock_chain_fused: no CTA of tile {tile} fits "
                           f"an SM ({per_sm})")
    ntiles = (-(-hgt // tile[0])) * (-(-wdt // tile[1]))
    nsplit = max(1, min(ntiles, -(-per_sm * sms // b)))
    return _chain_launch(lib, x, kws, heads, ln_type, stats_tile, apply_tile,
                         nsplit_a, tile, in_smem, nsplit, stream)


def _chain_forward(x, ps, heads, ln_type, kws):
    """The chain's forward on a CUDA tensor, without autograd: no block is
    the identity, one block is the whole-block kernel (JAX
    `_tblock_chain_impl` delegates likewise), two or more the chain."""
    if not ps:
        return x
    if kws is None or len(kws) != len(ps):
        raise ValueError("tblock_chain_fused: a CUDA tensor needs every "
                         "block's weights from prepare_tblock_weights (kws)")
    if len(ps) == 1:
        return _forward_kernel(x, kws[0], heads, ln_type)
    return _chain_kernel(x, kws, heads, ln_type)


def _unflatten(keys, values):
    """The per-block parameter dicts from their keys and the flat values."""
    ps, at = [], 0
    for k in keys:
        ps.append(dict(zip(k, values[at:at + len(k)])))
        at += len(k)
    return ps


class _TBlockChainFunction(torch.autograd.Function):
    """The chain on CUDA with the backward of JAX `_chain_bwd`: only x and
    the parameters are kept, and the backward recomputes through the plain
    chain block by block (JAX's per-block `_tblock_ref_remat`): the blocks'
    inputs again without autograd, then from the last block to the first
    each block's plain forward and its vector-Jacobian product.
    Gradients come back in the natural shapes of the parameter views it
    was given."""

    @staticmethod
    def forward(ctx, x, kws, heads, ln_type, keys, *values):
        ctx.save_for_backward(x, *values)
        ctx.heads, ctx.ln_type, ctx.keys = heads, ln_type, keys
        return _chain_forward(x, _unflatten(keys, values), heads, ln_type,
                              kws)

    @staticmethod
    def backward(ctx, g):
        x, *values = ctx.saved_tensors
        heads, ln_type = ctx.heads, ctx.ln_type
        ps = _unflatten(ctx.keys, values)
        with torch.no_grad():
            inputs = [x]
            for p in ps[:-1]:
                inputs.append(tblock_ref(inputs[-1], p, heads, ln_type))
        grads = []
        for xi, p in zip(reversed(inputs), reversed(ps)):
            with torch.enable_grad():
                xi = xi.detach().requires_grad_(True)
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in p.items()}
                y = tblock_ref(xi, leaves, heads, ln_type)
                dx, *dp = torch.autograd.grad(
                    y, [xi, *leaves.values()], g)
            grads = dp + grads
            g = dx
        return (g, None, None, None, None, *grads)


def tblock_chain_fused(x: torch.Tensor, ps, heads: int,
                       ln_type: str = "WithBias", kws=None):
    """n TransformerBlocks with cross-block fusion (JAX
    `tblock_chain_fused`).  x: (B, H, W, C) float32 or bfloat16; ps: the
    blocks' natural-shape parameter dicts (`tblock_ref`'s); kws: their
    `prepare_tblock_weights` outputs, required on CUDA (TransformerBlock
    caches them per module).

    CPU tensors take `tblock_chain_ref`.  CUDA tensors launch the kernels:
    two or more blocks the chain (in bf16 at C and C / heads multiples of
    8 `chain_pipeline`, else tblock.cu's pass A of the first block,
    csrc/tblock_chain.cu for each block but the last, tblock.cu's pass B
    of the last), one block the whole-block kernel.  Any input the kernels
    cannot take raises.  When an input needs a gradient, the call runs as
    `_TBlockChainFunction`, whose backward recomputes through the plain
    chain.

    Counters: `tblock_chain_fused.calls` counts chains of two or more
    blocks run on the card, `tblock_chain_fused.launches` their block
    boundaries (n - 1 per such call, whatever the route;
    `chain_pipeline.launches` counts those of chains on the pipeline);
    the blocks of a chain do not count as `tblock_fused` or
    `tblock_pipeline` launches, a chain of one block does."""
    ps = list(ps)
    if x.device.type == "cpu":
        return tblock_chain_ref(x, ps, heads, ln_type)
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for p in ps
                               for v in p.values()))
    if not needs_grad:
        return _chain_forward(x, ps, heads, ln_type, kws)
    keys = tuple(tuple(p) for p in ps)
    return _TBlockChainFunction.apply(x, kws, heads, ln_type, keys,
                                      *(p[k] for p in ps for k in p))


tblock_chain_fused.calls = 0
tblock_chain_fused.launches = 0
