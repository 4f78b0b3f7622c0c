"""Probes of the whole-block kernel's linear + depthwise stage: plain
PyTorch versions and CUDA kernels.

Counterparts of the TPU probe kernels in tools/bench_qkv_form.py
(`_run_pallas` with `_kernel_current` / `_kernel_composed`) and
tools/bench_stencil.py (`make_kernel`).  They ask, for the card, what the
TPU tools asked for the TPU about the whole-block kernel's 1x1 product
followed by a depthwise 3x3 stencil:

* `qkv_current` / `qkv_composed` (csrc/probe_qkv_form.cu): y =
  dw3x3(x . W) as a K = C product then the stencil on the CUDA cores (the
  whole-block kernel's own path), or as one K = 9C product X9 . W9 on the
  tensor cores;
* `stencil_loop` (csrc/probe_stencil.cu): the row-tile stencil iterated in
  the kernel, in the variants `VARIANTS`.

The plain versions round where the TPU kernels round: `qkv_current_ref`,
`qkv_composed_ref`, `stencil_ref`; `qkv_form_oracle` is the f32 oracle of
the qkv tool.  The probes are tools, not a route of the model: the kernel
wrappers take CUDA tensors only and raise on any other, with no fallback
(the tools call the plain versions when asked to run on the CPU).  Each
wrapper's `launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.ops.pallas.gdfn import kernel_matrix

# the stencil probe's variants, in the order the TPU tool runs them; the
# kernel's variant codes are the indices
VARIANTS = ("concat", "bf16acc", "mulonly", "mulonly_bf16")
# variants whose accumulator is bf16 (packed bf16 arithmetic); every
# variant takes a bf16 slab, as the TPU tool gives it
BF16_VARIANTS = ("bf16acc", "mulonly_bf16")

# Tiles (rows, cols) in order of preference; the first whose shared memory
# fits one block is taken.  current: x and one 64-channel lin chunk on the
# tile and its halo (the ring's recompute 1.27x at 16 x 16); composed: X9
# (9C per pixel) on the tile.
_CURRENT_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (1, 4),
                  (1, 2), (1, 1))
_COMPOSED_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (1, 4), (1, 2), (1, 1))
_FORMS = {"current": (0, _CURRENT_TILES), "composed": (1, _COMPOSED_TILES)}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def qkv_form_oracle(x, w, dw):
    """The stage in f32 (JAX `bench_qkv_form.oracle`): the 1x1 product,
    then the depthwise 3x3 with zero padding.  x: (B, H, W, C); w: (C,
    co); dw: (9, co), taps in (dy, dx) order.  Returns (B, H, W, co)
    f32."""
    co = w.shape[1]
    lin = x.float() @ w.float()
    k = dw.float().reshape(3, 3, co).permute(2, 0, 1)[:, None]
    y = F.conv2d(lin.permute(0, 3, 1, 2), k, padding=1, groups=co)
    return y.permute(0, 2, 3, 1)


def compose_w9(w, dw):
    """W9[(tap, ci), co] = W[ci, co] dw[tap, co], rows in (tap, ci) order
    (the TPU tool's construction, tools/bench_qkv_form.py:171-172), f32.
    w: (C, co); dw: (9, co).  Returns (9C, co)."""
    c = w.shape[0]
    return dw.float().repeat_interleave(c, dim=0) * w.float().repeat(9, 1)


def _pad_hw(x):
    """x (B, H, W, C) with one zero pixel on every side of the image."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def qkv_current_ref(x, w, dw):
    """The current form as the TPU kernel rounds it: lin = x . W with f32
    sums, rounded to x's dtype (W taken in x's dtype); zero outside the
    image; the stencil summed in f32 in (dy, dx) order; the output in x's
    dtype.  x: (B, H, W, C); w: (C, co); dw: (9, co) f32."""
    h, wd = x.shape[1:3]
    lin = _pad_hw((x.float() @ w.to(x.dtype).float()).to(x.dtype))
    out = torch.zeros(lin.shape[0], h, wd, lin.shape[-1],
                      dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            out = out + (lin[:, dy:dy + h, dx:dx + wd].float()
                         * dw[dy * 3 + dx].float())
    return out.to(x.dtype)


def qkv_composed_ref(x, w9):
    """The composed form as the TPU kernel rounds it: one product X9 . W9
    with f32 sums (W9 taken in x's dtype), rounded once to x's dtype; X9
    is the nine shifted copies of x side by side in (dy, dx) order, zero
    outside the image.  x: (B, H, W, C); w9: (9C, co) from
    `compose_w9`."""
    h, wd = x.shape[1:3]
    xp = _pad_hw(x)
    x9 = torch.cat([xp[:, dy:dy + h, dx:dx + wd]
                    for dy in range(3) for dx in range(3)], dim=-1)
    return (x9.float() @ w9.to(x.dtype).float()).to(x.dtype)


def _check_variant(variant: str, dtype: torch.dtype):
    if variant not in VARIANTS:
        raise ValueError(f"stencil: unknown variant {variant!r}; one of "
                         f"{VARIANTS}")
    if dtype != torch.bfloat16:
        raise ValueError(f"stencil: {variant} takes a bfloat16 slab, got "
                         f"{dtype}")


def stencil_ref(x, taps, variant: str, iters: int):
    """The TPU probe's iterated stencil (`make_kernel`): `iters` times, out
    = the 3x3 stencil of hid over (t + 2, W, ch) -> (t, W, ch), zero past
    the row ends, then hid = concat(hid[:2], out in hid's dtype); returns
    hid[2:].  concat and mulonly sum f32 products of hid and the f32 taps;
    bf16acc and mulonly_bf16 round every product and every sum to bf16
    with bf16 taps; the mulonly variants apply no x-shift.  x: (t + 2, W,
    ch) bfloat16; taps: (9, ch) f32."""
    _check_variant(variant, x.dtype)
    t = x.shape[0] - 2
    bf16_acc = variant in BF16_VARIANTS
    shifted = variant in ("concat", "bf16acc")
    acc = torch.bfloat16 if bf16_acc else torch.float32
    tv = taps.to(acc)
    hid = x
    for _ in range(iters):
        z = torch.zeros_like(hid[:, :1])
        hs = (torch.cat([z, hid[:, :-1]], dim=1), hid,
              torch.cat([hid[:, 1:], z], dim=1))
        out = torch.zeros(t, *hid.shape[1:], device=hid.device, dtype=acc)
        for dy in range(3):
            for dx in range(3):
                src = (hs[dx] if shifted else hid)[dy:dy + t]
                out = out + src.to(acc) * tv[dy * 3 + dx]
        hid = torch.cat([hid[:2], out.to(hid.dtype)], dim=0)
    return hid[2:]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def prepare_qkv_weights(w, dw, dtype: torch.dtype) -> dict:
    """The kernels' weights for x of `dtype`: W (current form) and W9
    (`compose_w9`, composed form) in `dtype` in the `kernel_matrix`
    layout, the taps (9, co) f32.  w: (C, co); dw: (9, co)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv probe: unsupported dtype {dtype}")
    c, co = w.shape
    if dw.shape != (9, co):
        raise ValueError(f"qkv probe: dw must be (9, {co}), got "
                         f"{tuple(dw.shape)}")
    return dict(w=kernel_matrix(w.float(), dtype),
                w9=kernel_matrix(compose_w9(w, dw), dtype),
                dw=dw.float().contiguous(), c=c, co=co, dtype=dtype)


def _require_cuda(what: str, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors "
                             f"only (got {t.device}); the plain version "
                             "runs anywhere")


@functools.cache
def pick_tile(lib, form: str, c: int, co: int, elem_bytes: int):
    """The first tile of the form's list whose shared memory fits one
    block (asked of the library once per form and widths)."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _first_fit

    code, tiles = _FORMS[form]
    return _first_fit(tiles, lambda t: lib.probe_qkv_smem(
        code, c, co, t[0], t[1], elem_bytes), f"qkv_{form}")


def _launch_qkv(lib, form: str, x, kw, tile, stream):
    """One qkv-form kernel on validated inputs; the output is allocated on
    x's device.  `stream` is a cudaStream_t as an int (0 for the default
    stream)."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _check, _ptr

    b, h, wd, c = x.shape
    out = torch.empty((b, h, wd, kw["co"]), dtype=x.dtype, device=x.device)
    dims = (b, h, wd, c, kw["co"], int(x.dtype == torch.bfloat16), *tile,
            ctypes.c_void_p(stream))
    if form == "current":
        rc = lib.probe_qkv_current(_ptr(x), _ptr(kw["w"]), _ptr(kw["dw"]),
                                   _ptr(out), *dims)
    else:
        rc = lib.probe_qkv_composed(_ptr(x), _ptr(kw["w9"]), _ptr(out),
                                    *dims)
    _check(rc, lib, f"qkv_{form}")
    return out


def _qkv_kernel(form: str, x, kw):
    from textualdegremoval_tpu_torch.ops._build import load_library

    what = f"qkv_{form}"
    _require_cuda(what, x, kw["dw"])
    if x.dim() != 4 or x.shape[-1] != kw["c"]:
        raise ValueError(f"{what}: x must be (B, H, W, {kw['c']}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != kw["dtype"]:
        raise ValueError(f"{what}: x is {x.dtype}, the weights were "
                         f"prepared for {kw['dtype']}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (NHWC)")
    lib = load_library()
    tile = pick_tile(lib, form, kw["c"], kw["co"], x.element_size())
    return _launch_qkv(lib, form, x, kw, tile,
                       torch.cuda.current_stream(x.device).cuda_stream)


def qkv_current(x: torch.Tensor, kw: dict) -> torch.Tensor:
    """The current form (csrc/probe_qkv_form.cu): x (B, H, W, C) float32 or
    bfloat16 on the card, kw from `prepare_qkv_weights` for x's dtype.
    Returns (B, H, W, co) in x's dtype, as `qkv_current_ref` rounds it."""
    out = _qkv_kernel("current", x, kw)
    qkv_current.launches += 1
    return out


def qkv_composed(x: torch.Tensor, kw: dict) -> torch.Tensor:
    """The composed form (csrc/probe_qkv_form.cu): as `qkv_current`, one
    K = 9C product; `qkv_composed_ref` rounds as it does."""
    out = _qkv_kernel("composed", x, kw)
    qkv_composed.launches += 1
    return out


qkv_current.launches = 0
qkv_composed.launches = 0


def _launch_stencil(lib, x, taps, variant: str, iters: int, stream):
    """The stencil kernel on validated inputs; the output is allocated on
    x's device."""
    from textualdegremoval_tpu_torch.ops.pallas.tblock import _check, _ptr

    rows, wd, ch = x.shape
    out = torch.empty((rows - 2, wd, ch), dtype=x.dtype, device=x.device)
    _check(lib.probe_stencil(
        _ptr(x), _ptr(taps), _ptr(out), rows - 2, wd, ch,
        VARIANTS.index(variant), int(x.dtype == torch.bfloat16), iters,
        ctypes.c_void_p(stream)), lib, f"stencil_loop ({variant})")
    return out


def stencil_loop(x: torch.Tensor, taps: torch.Tensor, variant: str,
                 iters: int) -> torch.Tensor:
    """`stencil_ref` as one launch of csrc/probe_stencil.cu, one CTA per
    channel.  x: (t + 2, W, ch) bfloat16 on the card, contiguous; taps:
    (9, ch) f32 contiguous."""
    from textualdegremoval_tpu_torch.ops._build import load_library

    _require_cuda("stencil_loop", x, taps)
    _check_variant(variant, x.dtype)
    if x.dim() != 3 or x.shape[0] < 3 or taps.shape != (9, x.shape[2]) \
            or taps.dtype != torch.float32:
        raise ValueError("stencil_loop: x must be (t + 2, W, ch) with "
                         "t >= 1 and taps (9, ch) float32, got "
                         f"{tuple(x.shape)} and {tuple(taps.shape)} "
                         f"{taps.dtype}")
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise ValueError("stencil_loop: x and taps must be contiguous")
    if iters < 0:
        raise ValueError(f"stencil_loop: iters must be >= 0, got {iters}")
    out = _launch_stencil(load_library(), x, taps, variant, iters,
                          torch.cuda.current_stream(x.device).cuda_stream)
    stencil_loop.launches += 1
    return out


stencil_loop.launches = 0
