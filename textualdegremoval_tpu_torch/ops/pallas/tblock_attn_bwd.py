"""Backward of the attention half of the TransformerBlock: plain PyTorch
version, glue and CUDA kernels.

Counterpart of textualdegremoval_tpu/ops/pallas/tblock_attn_bwd.py.  The
half is

    x1 = x + proj(MDTA(dw3x3(LN1(x) . Wqkv)))

and `attn_half_bwd(x, dx1, p, heads, ln_type, stats, kw)` returns dx and
the gradients of norm1_w, norm1_b (WithBias), qkv, qkv_dw, temperature and
proj in their natural shapes.  A CPU tensor takes the plain version,
`attn_half_bwd_ref` (torch.autograd through `_tblock_attn_part`); a CUDA
tensor launches hand-written kernels, or raises.  In place of the TPU
kernels `_make_attn_bwd_stats_kernel` (pass 1) and
`_make_attn_bwd_apply_kernel` (pass 2): in bf16 the LayerNorm and stencil
passes of csrc/bwd_stencil.cu and csrc/fwd_stencil.cu and the products of
csrc/bwd_gemm.cu (laid out at the top of csrc/bwd_stencil.cu; pass 1
keeps y, lin and q | k | v for pass 2, which recomputes none of them, and
takes any number of channels per head), in float32 the two passes of
csrc/tblock_attn_bwd.cu (the same split between the passes; at most 192
channels per head, C up to 704 on a 4 x 4 tile); and the
weight-gradient products of csrc/wgrad.cu.  `attn_half_bwd.launches`
counts calls that launch them.

Between the passes, `_attn_bwd_glue` (softmax, temperature and L2-norm
backward, O(C * cph) per image) is plain torch, as it was plain XLA.  It
works on the forward's per-head statistics, (B, heads, cph, cph) grams and
(B, C) square sums, not on JAX's full C x C gram.
"""

from __future__ import annotations

import torch

from textualdegremoval_tpu_torch.ops.pallas.tblock import (
    _attn_matrix, _check, _check_weights, _first_fit, _ptr, _tblock_attn_part,
    _validate,
)
from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
    _BWD_TILES, _EPS, _check_bf16_width, _dgrad, _gemm, _half_bwd_ref,
    _ln_rows, _ln_rows_bwd, _nsplit, _stencil_nsplit, _wgrad,
)

_ATTN_KEYS = ("norm1_w", "norm1_b", "qkv", "qkv_dw", "temperature", "proj")


def attn_half_bwd_ref(x, dx1, p, heads, ln_type):
    """Plain version: torch.autograd through `_tblock_attn_part`."""
    return _half_bwd_ref(
        lambda a, q: _tblock_attn_part(a, q, heads, ln_type), x, dx1, p,
        _ATTN_KEYS)


def _attn_bwd_glue(da, gram, qssq, kssq, temperature, heads):
    """Softmax + temperature + L2-norm backward on the per-head statistics.

    da, gram: (B, heads, cph, cph) f32, the gradient of the softmax output A
    and the forward's q.k gram; qssq, kssq: (B, C) f32 square sums;
    temperature: (heads, 1, 1).  Returns (m, dqd, dkd, dtemp): m
    (B, heads, cph, cph) f32 with dq = k . m^T + q * dqd and
    dk = q . m + k * dkd per head; dqd, dkd: (B, C) f32; dtemp in
    temperature's shape and dtype."""
    b, _, cph, _ = gram.shape
    c = heads * cph
    qn = torch.rsqrt(torch.clamp_min(qssq, 1e-24)).reshape(b, heads, cph)
    kn = torch.rsqrt(torch.clamp_min(kssq, 1e-24)).reshape(b, heads, cph)
    nrm = qn[..., :, None] * kn[..., None, :]
    ghat = gram * nrm
    tau = temperature.float().reshape(1, heads, 1, 1)
    a = torch.softmax(ghat * tau, dim=-1)
    dz = a * (da - (da * a).sum(-1, keepdim=True))
    dtemp = (dz * ghat).sum((0, 2, 3))
    m = nrm * (tau * dz)
    mg = m * gram
    # the norm path differentiates only where the square sum is above the
    # clamp floor
    dqd = torch.where(qssq > 1e-24, -(qn ** 2 * mg.sum(3)).reshape(b, c), 0.0)
    dkd = torch.where(kssq > 1e-24, -(kn ** 2 * mg.sum(2)).reshape(b, c), 0.0)
    return (m, dqd.contiguous(), dkd.contiguous(),
            dtemp.reshape(temperature.shape).to(temperature.dtype))


# The profiler range around the bf16 pass 1, whose passes share their
# kernels with pass 2 and the forward: a trace tells them apart by it.
PASS1_RANGE = "attn_half_bwd pass 1"


def _attn_pass1_bf16(lib, x, dx1, kw, ln_type, attn, heads, sms, stream):
    """Pass 1 in bf16, the passes laid out at the top of csrc/bwd_stencil.cu
    with JAX pass 1's rounding points (y, lin, v, o and do in bf16): (ys,
    mu, inv, lins, qkv, os, dos), rows of pixels; pass 2 and the
    weight-gradient products read them."""
    b, hgt, wdt, c = x.shape
    npix = b * hgt * wdt
    dev, bf = x.device, torch.bfloat16
    bias_free = int(ln_type == "BiasFree")
    with torch.profiler.record_function(PASS1_RANGE):
        ys, mu, inv = _ln_rows(lib, x, kw["ln1w"], kw["ln1b"], bias_free,
                               stream, _EPS)
        lins = _gemm(lib, ys, kw["wqkv"], bf, stream)
        # q | k | v without the forward's square sums: four 48 KB CTAs per
        # SM
        qkv = torch.empty((npix, 3 * c), dtype=bf, device=dev)
        _check(lib.fwd_qkv_stencil(
            _ptr(lins), _ptr(kw["dwall"]), _ptr(qkv), None, b, hgt, wdt, c,
            _stencil_nsplit(lib, b, hgt, wdt, -(-3 * c // 64), 4, sms),
            stream), lib, "fwd_qkv_stencil")
        os_ = torch.empty((npix, c), dtype=bf, device=dev)
        _check(lib.attn_heads_o(_ptr(qkv), _ptr(attn), _ptr(os_), b,
                                hgt * wdt, c, heads, stream), lib,
               "attn_heads_o")
        dos = _gemm(lib, dx1.view(npix, c), kw["wprojt"], bf, stream)
    return ys, mu, inv, lins, qkv, os_, dos


def _launch_attn_apply_bf16(lib, x, dx1, kw, heads, ln_type, mu, inv, lins,
                            qkv, dos, attn, m, dqd, dkd, sms, stream):
    """Pass 2 in bf16 (csrc/bwd_stencil.cu, csrc/bwd_gemm.cu) on pass 1's
    LN1 moments, lin, q | k | v and do, up to its weight-gradient operand:
    (dx, dln (2, C), dlins, dtap (27, C))."""
    b, hgt, wdt, c = x.shape
    npix = b * hgt * wdt
    dev, f32 = x.device, torch.float32
    dth = torch.empty((npix, 3 * c), dtype=f32, device=dev)
    _check(lib.bwd_head_products(_ptr(qkv), _ptr(dos), _ptr(m), _ptr(attn),
                                 _ptr(dqd), _ptr(dkd), _ptr(dth), b,
                                 hgt * wdt, c, heads, stream), lib,
           "bwd_head_products")
    # two 82 KB CTAs per SM
    dlins = torch.empty((npix, 3 * c), dtype=x.dtype, device=dev)
    nsplit = _stencil_nsplit(lib, b, hgt, wdt, -(-3 * c // 32), 2, sms)
    dtap_part = torch.empty((b * nsplit, 27, c), dtype=f32, device=dev)
    _check(lib.bwd_dlin_stencil(_ptr(dth), _ptr(lins), _ptr(kw["dwall"]),
                                _ptr(dlins), _ptr(dtap_part), b, hgt, wdt, c,
                                nsplit, stream), lib, "bwd_dlin_stencil")
    del dth
    dy = _dgrad(lib, dlins, kw["wqkv"], stream)
    dx, dln = _ln_rows_bwd(lib, x, dy, kw["ln1w"], mu, inv,
                           int(ln_type == "BiasFree"), dx1, sms, stream)
    return dx, dln, dlins, dtap_part.sum(0)


def _launch_attn_bwd(lib, x, dx1, kw, heads, ln_type, stats, stats_tile,
                     apply_tile, nsplit, sms, stream):
    """Pass 1, its products, the glue, pass 2 and its products on validated
    inputs; `stats_tile`, `apply_tile` and `nsplit` are the float32
    passes' (bf16 takes none).  Returns (dx, dwqkv (C, 3C), dtap (27, C),
    dwproj (C, C), dln (2, C), dtemp (heads,))."""
    b, hgt, wdt, c = x.shape
    cph = c // heads
    hw, npix = hgt * wdt, b * hgt * wdt
    dev, dt, f32 = x.device, x.dtype, torch.float32
    is_bf16, bias_free = dt == torch.bfloat16, int(ln_type == "BiasFree")
    gram, qssq, kssq = stats

    attn = _attn_matrix(gram, qssq, kssq, kw["temperature"], heads, dt)
    if is_bf16:
        ys, mu, inv, lins, qkv, os_, dos = _attn_pass1_bf16(
            lib, x, dx1, kw, ln_type, attn, heads, sms, stream)
    else:
        ys, os_, dos = (torch.empty((npix, c), dtype=dt, device=dev)
                        for _ in range(3))
        lins, qkv = (torch.empty((npix, 3 * c), dtype=dt, device=dev)
                     for _ in range(2))
        _check(lib.tblock_attn_bwd_stats(
            _ptr(x), _ptr(dx1), _ptr(kw["ln1w"]), _ptr(kw["ln1b"]),
            _ptr(kw["wq"]), _ptr(kw["wk"]), _ptr(kw["wv"]),
            _ptr(kw["dwall"]), _ptr(attn), _ptr(kw["wprojt"]), _ptr(ys),
            _ptr(lins), _ptr(qkv), _ptr(os_), _ptr(dos), b, hgt, wdt, c,
            heads, bias_free, stats_tile[0], stats_tile[1], stream), lib,
            "tblock_attn_bwd_stats")
    vs, ldv = qkv[:, 2 * c:], 3 * c
    # dA per (image, head) = do_h^T v_h; dWproj = o^T dx1
    da = _wgrad(lib, dos, c, (hw * c, cph), vs, ldv, (hw * ldv, cph), hw,
                cph, cph, (b, heads), sms, stream)
    dwproj = _wgrad(lib, os_, c, (0, 0), dx1, c, (0, 0), npix, c, c, (1, 1),
                    sms, stream)[0, 0]
    del vs, os_

    m, dqd, dkd, dtemp = _attn_bwd_glue(da, gram, qssq, kssq,
                                        kw["temperature"], heads)
    m = m.to(dt)
    if is_bf16:
        dx, dln, dlins, dtap = _launch_attn_apply_bf16(
            lib, x, dx1, kw, heads, ln_type, mu, inv, lins, qkv, dos, attn, m,
            dqd, dkd, sms, stream)
    else:
        mt = m.transpose(-1, -2).contiguous()
        at = attn.transpose(-1, -2).contiguous()
        dx = torch.empty_like(x)
        dlins = torch.empty((npix, 3 * c), dtype=dt, device=dev)
        dtap_part = torch.empty((b * nsplit, 27, c), dtype=f32, device=dev)
        dln_part = torch.empty((b * nsplit, 2, c), dtype=f32, device=dev)
        _check(lib.tblock_attn_bwd_apply(
            _ptr(x), _ptr(dx1), _ptr(kw["ln1w"]), _ptr(qkv), _ptr(lins),
            _ptr(dos), _ptr(kw["wqt"]), _ptr(kw["wkt"]), _ptr(kw["wvt"]),
            _ptr(kw["dwall"]), _ptr(m), _ptr(mt), _ptr(at), _ptr(dqd),
            _ptr(dkd), _ptr(dx), _ptr(dlins), _ptr(dtap_part),
            _ptr(dln_part), b, hgt, wdt, c, heads, bias_free, apply_tile[0],
            apply_tile[1], nsplit, stream), lib, "tblock_attn_bwd_apply")
        dtap, dln = dtap_part.sum(0), dln_part.sum(0)
    del lins, qkv, dos
    dwqkv = _wgrad(lib, ys, c, (0, 0), dlins, 3 * c, (0, 0), npix, c, 3 * c,
                   (1, 1), sms, stream)[0, 0]
    return dx, dwqkv, dtap, dwproj, dln, dtemp


def _natural_attn_grads(p, dwqkv, dtap, dwproj, dln, dtemp, ln_type):
    """Kernel-layout gradients -> the natural shapes of p."""
    grads = {
        "qkv": dwqkv,
        "qkv_dw": torch.cat([dtap[0:9], dtap[9:18], dtap[18:27]], 1),
        "proj": dwproj,
        "temperature": dtemp,
        "norm1_w": dln[0],
    }
    if ln_type != "BiasFree":
        grads["norm1_b"] = dln[1]
    return {k: v.reshape(p[k].shape).to(p[k].dtype) for k, v in grads.items()}


def attn_half_bwd(x, dx1, p, heads, ln_type, stats=None, kw=None):
    """Backward of the attention half.  x, dx1: (B, H, W, C), the block
    input and the gradient at the attention-residual boundary x1; p:
    natural-shape parameter dict (tblock_ref keys); stats: the forward's
    (gram (B, heads, cph, cph), qssq (B, C), kssq (B, C)) and kw the block's
    `prepare_tblock_weights` output, both required on CUDA.  Returns (dx in
    x's dtype, grads in natural shapes and p's dtypes)."""
    if x.device.type == "cpu":
        return attn_half_bwd_ref(x, dx1, p, heads, ln_type)
    _validate(x, heads, ln_type, "attn_half_bwd")
    if dx1.shape != x.shape or dx1.dtype != x.dtype \
            or not dx1.is_contiguous():
        raise ValueError("attn_half_bwd: dx1 must match x (contiguous)")
    if stats is None:
        raise ValueError("attn_half_bwd: a CUDA tensor needs the forward's "
                         "statistics (stats)")
    _check_weights(kw, x, "attn_half_bwd")

    from textualdegremoval_tpu_torch.ops._build import load_library

    _check_bf16_width(x, heads, "attn_half_bwd")

    lib = load_library()
    b, hgt, wdt, c = x.shape
    if x.dtype == torch.float32 and c // heads > lib.tblock_attn_bwd_max_cph():
        raise ValueError(f"attn_half_bwd: {c // heads} channels per head "
                         f"exceeds {lib.tblock_attn_bwd_max_cph()} in float32")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stats_tile, apply_tile, nsplit = None, None, None
    if x.dtype == torch.float32:
        def pick(pass_id):
            return _first_fit(_BWD_TILES, lambda t: (
                lib.tblock_attn_bwd_smem_bytes(pass_id, c, heads, t[0], t[1],
                                               4)), "attn_half_bwd")

        stats_tile, apply_tile = pick(0), pick(1)
        nsplit = _nsplit(
            b, -(-hgt // apply_tile[0]) * -(-wdt // apply_tile[1]), sms)
    dx, dwqkv, dtap, dwproj, dln, dtemp = _launch_attn_bwd(
        lib, x, dx1, kw, heads, ln_type, stats, stats_tile, apply_tile,
        nsplit, sms, torch.cuda.current_stream(x.device).cuda_stream)
    attn_half_bwd.launches += 1
    return dx, _natural_attn_grads(p, dwqkv, dtap, dwproj, dln, dtemp,
                                   ln_type)


attn_half_bwd.launches = 0
