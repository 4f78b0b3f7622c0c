"""Backward of the GDFN half of the TransformerBlock: plain PyTorch version
and CUDA kernel.

Counterpart of textualdegremoval_tpu/ops/pallas/tblock_bwd.py.  The half is

    out = x1 + GDFN(LN2(x1))

and `gdfn_half_bwd(x1, dout, p, ln_type, kw)` returns dx1 and the gradients
of norm2_w, norm2_b (WithBias), gd_in, gd_dw and gd_out in their natural
shapes.  A CPU tensor takes the plain version, `gdfn_half_bwd_ref`
(torch.autograd through `_tblock_gdfn_part`); a CUDA tensor launches the
hand-written kernels that replace the TPU kernel `_make_gdfn_bwd_kernel`,
or raises: in bf16 the LayerNorm and stencil passes of
csrc/bwd_stencil.cu and the products of csrc/bwd_gemm.cu (the sequence is
laid out at the top of csrc/bwd_stencil.cu), in float32 the streaming
kernel csrc/tblock_bwd.cu; then the weight-gradient products of
csrc/wgrad.cu (in bf16 on TMA and wgmma, in float32 a plain tiled
kernel).  `gdfn_half_bwd.launches` counts calls that launch them.

`_ln_fwd_rows`, `_ln_bwd_rows` and `_gelu_grad` are the TPU kernel's row
helpers (f32); the CUDA kernel does the same arithmetic per pixel.
"""

from __future__ import annotations

import math

import torch

from textualdegremoval_tpu_torch.ops.pallas.tblock import (
    HIDDEN_CHUNK, _check, _check_weights, _first_fit, _ptr, _tblock_gdfn_part,
    _validate,
)

_EPS = 1e-5
_GDFN_KEYS = ("norm2_w", "norm2_b", "gd_in", "gd_dw", "gd_out")
# Tiles (rows, cols) in order of preference, the first that fits one
# block's shared memory is taken (as the forward's pass B).
_BWD_TILES = ((4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
# Bytes that the per-split partials of one weight-gradient product may take.
_WGRAD_PARTIAL_BYTES = 256 * 2 ** 20


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf gelu: Phi(x) + x phi(x)."""
    return 0.5 * (1.0 + torch.erf(x * 2.0 ** -0.5)) \
        + x * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x)


def _ln_fwd_rows(xf, w, b, ln_type):
    """LN over the channel axis of f32 rows: (z, zhat, inv, mu * inv), with
    the one-pass var = E[x^2] - mu^2 clamped at 0.  BiasFree normalises the
    uncentred x (zhat = x * inv), as ops/norm.py does."""
    mu = xf.mean(-1, keepdim=True)
    sq = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(sq - mu * mu, 0.0) + _EPS)
    if ln_type == "BiasFree":
        zhat = xf * inv
        return zhat * w, zhat, inv, mu * inv
    zhat = (xf - mu) * inv
    return zhat * w + b, zhat, inv, mu * inv


def _ln_bwd_rows(dz, zhat, inv, mu_inv, w, ln_type):
    """dx from dz for `_ln_fwd_rows` (f32).  BiasFree keeps the
    mean-centred variance, so dx = (dzh - m2 (zhat - mu inv)) inv with
    m2 = mean(dzh zhat)."""
    dzh = dz * w
    m2 = (dzh * zhat).mean(-1, keepdim=True)
    if ln_type == "BiasFree":
        return (dzh - m2 * (zhat - mu_inv)) * inv
    m1 = dzh.mean(-1, keepdim=True)
    return (dzh - m1 - zhat * m2) * inv


def _half_bwd_ref(part, x, dout, p, keys):
    """torch.autograd through one half: (dx, grads of `keys` found in p)."""
    names = [k for k in keys if k in p]
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        pr = {k: (v.detach().requires_grad_(True) if k in names
                  else v.detach()) for k, v in p.items()}
        out = part(xr, pr)
        got = torch.autograd.grad(out, [xr] + [pr[k] for k in names], dout)
    return got[0], dict(zip(names, got[1:]))


def gdfn_half_bwd_ref(x1, dout, p, ln_type):
    """Plain version: torch.autograd through `_tblock_gdfn_part`."""
    return _half_bwd_ref(lambda a, q: _tblock_gdfn_part(a, q, ln_type), x1,
                         dout, p, _GDFN_KEYS)


def _check_bf16_width(x, heads, what):
    """The bf16 kernels read pixel rows and heads through TMA, whose rows
    are multiples of 16 bytes: C and C / heads multiples of 8."""
    c = x.shape[-1]
    if x.dtype == torch.bfloat16 and (c % 8 or (c // heads) % 8):
        raise ValueError(f"{what}: the bf16 kernels need C and C / heads "
                         f"multiples of 8 (TMA rows of 16-byte multiples), "
                         f"got C={c}, heads={heads}")


def _nsplit(b, ntiles, sms):
    """CTAs per image of a persistent pass: about two per SM in all."""
    return max(1, min(ntiles, -(-2 * sms // b)))


def _wgrad_nsplit(lib, dtype, npix, m, n, batches, sms):
    """Parts of the pixel axis of csrc/wgrad.cu's product (see `_wgrad`)."""
    cap = max(1, _WGRAD_PARTIAL_BYTES // (4 * m * n * batches))
    if dtype == torch.bfloat16:
        tiles = lib.tblock_wgrad_tiles(m, n) * batches
        slots = lib.tblock_wgrad_ctas_per_sm(m, n) * sms
        return max(1, min(slots // tiles, -(-npix // 256), cap))
    tiles = -(-m // 64) * -(-n // 64) * batches
    return max(1, min(-(-4 * sms // tiles), -(-npix // 32), cap))


def _wgrad(lib, a, lda, sa, b, ldb, sb, npix, m, n, nb, sms, stream):
    """sum over npix pixels of a[p][m] b[p][n] (csrc/wgrad.cu), batched over
    nb = (nb1, nb2) with element strides sa, sb.  Returns
    (nb1, nb2, m, n) f32.  The pixel axis is split into parts, within
    _WGRAD_PARTIAL_BYTES of partials, which are then added in a fixed
    order: in bf16 (the TMA + wgmma kernel) as many as fill the card's CTA
    slots in one wave, each at least 4 steps of 64 pixels; in float32 about
    four CTAs an SM."""
    nsplit = _wgrad_nsplit(lib, a.dtype, npix, m, n, nb[0] * nb[1], sms)
    out = torch.empty((nsplit, nb[0], nb[1], m, n), dtype=torch.float32,
                      device=a.device)
    _check(lib.tblock_wgrad(
        _ptr(a), lda, sa[0], sa[1], _ptr(b), ldb, sb[0], sb[1], _ptr(out),
        npix, m, n, nb[0], nb[1], nsplit, int(a.dtype == torch.bfloat16),
        stream), lib, "tblock_wgrad")
    return out.sum(0)


def _stencil_nsplit(lib, b, hgt, wdt, nbox, per_sm, sms):
    """CTAs per image of a bwd_stencil.cu pass over `nbox` column boxes per
    tile, `per_sm` of whose CTAs fit an SM: at most two full waves in all
    (never a wave with a few CTAs left over: the CTAs walk equal shares of
    the items, so such a wave costs as much as a full one), at most one per
    (tile, box) item."""
    items = (-(-hgt // lib.bwd_stencil_tile(0))
             * -(-wdt // lib.bwd_stencil_tile(1)) * nbox)
    return max(1, min(items, 2 * per_sm * sms // b))


def _ln_rows(lib, x, w, bias, bias_free, stream, eps=_EPS, y=None):
    """LN of every pixel of x (bf16, csrc/bwd_stencil.cu) with epsilon eps
    (Restormer's 1e-5 unless given): (y (npix, C), mu (npix,),
    1 / sqrt(var + eps) (npix,)); y written into `y` where given."""
    c = x.shape[-1]
    npix = x.numel() // c
    if y is None:
        y = torch.empty((npix, c), dtype=x.dtype, device=x.device)
    mu, inv = (torch.empty(npix, dtype=torch.float32, device=x.device)
               for _ in range(2))
    _check(lib.bwd_ln_rows(_ptr(x), _ptr(w), _ptr(bias), bias_free, eps,
                           _ptr(y), _ptr(mu), _ptr(inv), npix, c, stream),
           lib, "bwd_ln_rows")
    return y, mu, inv


def _ln_rows_bwd(lib, x, dz, w, mu, inv, bias_free, base, sms, stream):
    """base + LN-backward(dz) in x's shape and dtype, and the LN parameter
    gradients (2, C) f32: per-CTA partials over consecutive pixels, added
    in a fixed order."""
    c = x.shape[-1]
    npix = mu.shape[0]
    nct = max(1, min(4 * sms, npix))
    dst = torch.empty_like(x)
    part = torch.empty((nct, 2, c), dtype=torch.float32, device=x.device)
    _check(lib.bwd_ln_rows_bwd(_ptr(x), _ptr(dz), _ptr(w), _ptr(mu),
                               _ptr(inv), bias_free, _ptr(base), _ptr(dst),
                               _ptr(part), npix, c, nct, stream), lib,
           "bwd_ln_rows_bwd")
    return dst, part.sum(0)


def _gemm(lib, a, b, dtype, stream, out=None):
    """a (M, K) . b^T with b (N, K), both bf16 (csrc/bwd_gemm.cu): (M, N)
    in `dtype` (float32, or bfloat16 rounded once), written into `out`
    where given."""
    if out is None:
        out = torch.empty((a.shape[0], b.shape[0]), dtype=dtype,
                          device=a.device)
    _check(lib.bwd_gemm(_ptr(a), _ptr(b), _ptr(out), a.shape[0], b.shape[0],
                        a.shape[1], int(dtype == torch.bfloat16), stream),
           lib, "bwd_gemm")
    return out


def _dgrad(lib, a, w, stream):
    """The input gradient a (M, K) . w with w (K, N), the forward's bf16
    weight (csrc/bwd_gemm.cu): (M, N) f32."""
    out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32,
                      device=a.device)
    _check(lib.bwd_dgrad(_ptr(a), _ptr(w), _ptr(out), a.shape[0], w.shape[1],
                         a.shape[1], stream), lib, "bwd_dgrad")
    return out


def _launch_gdfn_bwd_bf16(lib, x1, dout, kw, ln_type, sms, stream):
    """The bf16 GDFN-half backward (csrc/bwd_stencil.cu, csrc/bwd_gemm.cu)
    up to its weight-gradient operands: (dx1, dln (2, C), zs, gates, dhids,
    dtap (18, hpad)); dhids in w1's interleaved chunk order."""
    b, hgt, wdt, c = x1.shape
    hpad = kw["hpad"]
    npix = b * hgt * wdt
    dev, bf, f32 = x1.device, torch.bfloat16, torch.float32
    bias_free = int(ln_type == "BiasFree")
    zs, mu, inv = _ln_rows(lib, x1, kw["ln2w"], kw["ln2b"], bias_free, stream,
                           _EPS)
    hids = _gemm(lib, zs, kw["w1"], bf, stream)
    dgates = _gemm(lib, dout.view(npix, c), kw["w2t"], f32, stream)
    # one 174 KB CTA per SM
    nsplit = _stencil_nsplit(lib, b, hgt, wdt, hpad // HIDDEN_CHUNK, 1, sms)
    gates = torch.empty((npix, hpad), dtype=bf, device=dev)
    dhids = torch.empty((npix, 2 * hpad), dtype=bf, device=dev)
    dtap_part = torch.empty((b * nsplit, 18, hpad), dtype=f32, device=dev)
    _check(lib.bwd_gdfn_stencil(
        _ptr(hids), _ptr(dgates), _ptr(kw["dwg"]), _ptr(gates), _ptr(dhids),
        _ptr(dtap_part), b, hgt, wdt, hpad, nsplit, stream), lib,
        "bwd_gdfn_stencil")
    del hids, dgates
    dz = _dgrad(lib, dhids, kw["w1"], stream)
    dx1, dln = _ln_rows_bwd(lib, x1, dz, kw["ln2w"], mu, inv, bias_free,
                            dout, sms, stream)
    return dx1, dln, zs, gates, dhids, dtap_part.sum(0)


def _launch_gdfn_bwd(lib, x1, dout, kw, ln_type, tile, nsplit, sms, stream):
    """The GDFN-half backward kernels and their weight-gradient products on
    validated inputs; `tile` and `nsplit` are the float32 kernel's.
    Returns (dx1, dw1 (C, 2 hpad), dtap (18, hpad), dw2 (hpad, C),
    dln (2, C)), the padded f32 gradients."""
    b, hgt, wdt, c = x1.shape
    hpad = kw["hpad"]
    npix = b * hgt * wdt
    dev, dt, f32 = x1.device, x1.dtype, torch.float32
    if dt == torch.bfloat16:
        dx1, dln, zs, gates, dhids, dtap = _launch_gdfn_bwd_bf16(
            lib, x1, dout, kw, ln_type, sms, stream)
    else:
        dx1 = torch.empty_like(x1)
        zs = torch.empty((npix, c), dtype=dt, device=dev)
        gates = torch.empty((npix, hpad), dtype=dt, device=dev)
        dhids = torch.empty((npix, 2 * hpad), dtype=dt, device=dev)
        dtap_part = torch.empty((b * nsplit, 18, hpad), dtype=f32, device=dev)
        dln_part = torch.empty((b * nsplit, 2, c), dtype=f32, device=dev)
        _check(lib.tblock_gdfn_bwd(
            _ptr(x1), _ptr(dout), _ptr(kw["ln2w"]), _ptr(kw["ln2b"]),
            _ptr(kw["w1"]), _ptr(kw["w1t"]), _ptr(kw["dwg"]), _ptr(kw["w2t"]),
            _ptr(dx1), _ptr(zs), _ptr(gates), _ptr(dhids), _ptr(dtap_part),
            _ptr(dln_part), b, hgt, wdt, c, hpad, int(ln_type == "BiasFree"),
            tile[0], tile[1], nsplit, stream), lib, "tblock_gdfn_bwd")
        dtap, dln = dtap_part.sum(0), dln_part.sum(0)
    dw1 = _wgrad(lib, zs, c, (0, 0), dhids, 2 * hpad, (0, 0), npix, c,
                 2 * hpad, (1, 1), sms, stream)[0, 0]
    dw2 = _wgrad(lib, gates, hpad, (0, 0), dout, c, (0, 0), npix, hpad, c,
                 (1, 1), sms, stream)[0, 0]
    if dt == torch.bfloat16:
        # each chunk's h1 then h2 columns -> all h1 columns, then all h2
        dw1 = (dw1.view(c, hpad // HIDDEN_CHUNK, 2, HIDDEN_CHUNK)
               .transpose(1, 2).reshape(c, 2 * hpad))
    return dx1, dw1, dtap, dw2, dln


def _natural_gdfn_grads(p, dw1, dtap, dw2, dln, ln_type):
    """Padded kernel-layout gradients -> the natural shapes of p."""
    h2 = p["gd_in"].shape[-1]
    hidden, hpad = h2 // 2, dtap.shape[1]
    grads = {
        "gd_in": torch.cat([dw1[:, :hidden], dw1[:, hpad:hpad + hidden]], 1),
        "gd_dw": torch.cat([dtap[:9, :hidden], dtap[9:, :hidden]], 1),
        "gd_out": dw2[:hidden],
        "norm2_w": dln[0],
    }
    if ln_type != "BiasFree":
        grads["norm2_b"] = dln[1]
    return {k: v.reshape(p[k].shape).to(p[k].dtype) for k, v in grads.items()}


def gdfn_half_bwd(x1, dout, p, ln_type, kw=None):
    """Backward of the GDFN half.  x1, dout: (B, H, W, C); p: natural-shape
    parameter dict (tblock_ref keys); kw: the block's
    `prepare_tblock_weights` output, required on CUDA.
    Returns (dx1 in x1's dtype, grads in natural shapes and p's dtypes)."""
    if x1.device.type == "cpu":
        return gdfn_half_bwd_ref(x1, dout, p, ln_type)
    _validate(x1, 1, ln_type, "gdfn_half_bwd")
    if dout.shape != x1.shape or dout.dtype != x1.dtype \
            or not dout.is_contiguous():
        raise ValueError("gdfn_half_bwd: dout must match x1 (contiguous)")
    _check_weights(kw, x1, "gdfn_half_bwd")

    from textualdegremoval_tpu_torch.ops._build import load_library

    b, hgt, wdt, c = x1.shape
    _check_bf16_width(x1, 1, "gdfn_half_bwd")

    lib = load_library()
    if lib.tblock_hidden_chunk() != HIDDEN_CHUNK:
        raise RuntimeError("gdfn_half_bwd: hidden chunk differs from the "
                           "kernel")
    sms = torch.cuda.get_device_properties(x1.device).multi_processor_count
    tile, nsplit = None, None
    if x1.dtype == torch.float32:
        tile = _first_fit(_BWD_TILES, lambda t: (
            lib.tblock_gdfn_bwd_smem_bytes(c, t[0], t[1], 4)),
            "gdfn_half_bwd")
        nsplit = _nsplit(b, -(-hgt // tile[0]) * -(-wdt // tile[1]), sms)
    dx1, dw1, dtap, dw2, dln = _launch_gdfn_bwd(
        lib, x1, dout, kw, ln_type, tile, nsplit, sms,
        torch.cuda.current_stream(x1.device).cuda_stream)
    gdfn_half_bwd.launches += 1
    return dx1, _natural_gdfn_grads(p, dw1, dtap, dw2, dln, ln_type)


gdfn_half_bwd.launches = 0
