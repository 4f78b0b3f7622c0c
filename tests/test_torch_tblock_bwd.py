"""PyTorch port vs JAX package: the TransformerBlock backward.

Chain of custody on the CPU, f32 unless noted:
* the port's plain half-backwards (`gdfn_half_bwd_ref`, `attn_half_bwd_ref`:
  torch.autograd through the plain halves) against the JAX streaming
  kernels `gdfn_half_bwd` / `attn_half_bwd` run in Pallas interpret mode,
  at the shapes and tolerances of tests/test_pallas_tblock_bwd.py and
  tests/test_pallas_tblock_attn_bwd.py (rtol 2e-4, atol 2e-5 for dx; 2e-4
  for the parameter gradients);
* the port's glue `_attn_bwd_glue` (per-head statistics) against the JAX
  glue (full C x C statistics);
* the CUDA sources csrc/tblock_bwd.cu, csrc/tblock_attn_bwd.cu (f32),
  csrc/bwd_stencil.cu, csrc/bwd_gemm.cu (bf16) and csrc/wgrad.cu compiled
  for the host with tests/cuda_host_shim.h, through the launch code the
  CUDA path uses, against the plain version, in f32 and bf16; and the bf16
  path's parts alone: its GEMM against torch.matmul, its LayerNorm passes
  against `_ln_fwd_rows` / `_ln_bwd_rows`, and a TMA halo box against a
  zero-padded slice;
* the bf16 attention half with its pass 1 made of the shared passes
  (csrc/bwd_stencil.cu's LN rows, the lin product, csrc/fwd_stencil.cu's
  q | k | v stencil with its square sums off, o per head and do) against
  JAX `attn_half_bwd` run op by op in bf16 (dA's block diagonal, dWproj,
  dx, every gradient), at 176 channels per head against plain autograd
  (float32 refuses it), and the pass-1 stencil bitwise against the plain
  stencil summed in the kernel's order;
* the autograd Function of `tblock_fused` driven by the host build: both
  bwd_modes against autograd of the plain block, and 'remat' against
  'save';
* a differentiable input always gives an output with a grad_fn.
The on-card checks are in tests/test_torch_tblock_bwd_cuda.py.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import textualdegremoval_tpu.ops.pallas.tblock as jtb
from textualdegremoval_tpu.ops.pallas.tblock_attn_bwd import (
    _attn_bwd_glue as j_glue, attn_half_bwd as j_attn_half_bwd,
)
from textualdegremoval_tpu.ops.pallas.tblock_bwd import (
    gdfn_half_bwd as j_gdfn_half_bwd,
)

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
import textualdegremoval_tpu_torch.ops.pallas.tblock_attn_bwd as ab
import textualdegremoval_tpu_torch.ops.pallas.tblock_bwd as gb
from textualdegremoval_tpu_torch.models.layers import TransformerBlock

from test_torch_tblock import _params, _torch_params
from torch_port_util import randn, t, assert_close, build_host_library

# bf16 host kernel vs the plain bf16 autograd: both round to bf16 at their
# own points (the kernel where the TPU kernel does, the plain version after
# every op), so they differ by a few bf16 ulps (2^-7 relative); bounded in
# L2 relative to the plain gradient's norm
BF16_REL_L2 = 3e-2
BF = torch.bfloat16


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _jax_stats(x, p, heads, ln_type):
    """The forward's pass-A statistics as the JAX kernels take them: full
    (B, C, C) gram of q and k, (B, 1, C) square sums."""
    c = x.shape[-1]
    pt = _torch_params(p)
    y = tb._ln(t(x), pt["norm1_w"], pt.get("norm1_b"), ln_type)
    qkv = y @ pt["qkv"].reshape(c, 3 * c)
    qkv = tb.dwconv(qkv, pt["qkv_dw"])
    q, k = qkv[..., :c].reshape(x.shape[0], -1, c), \
        qkv[..., c:2 * c].reshape(x.shape[0], -1, c)
    gram = torch.einsum("bpc,bpd->bcd", q, k)
    return (gram.numpy(), (q * q).sum(1)[:, None].numpy(),
            (k * k).sum(1)[:, None].numpy())


@pytest.mark.parametrize("shape,tile", [
    ((1, 8, 16, 8), 8),    # single tile: both edge masks in one step
    ((1, 16, 16, 8), 8),   # two tiles
    ((2, 24, 16, 16), 4),  # batch 2, middle tiles
])
@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_gdfn_half_bwd_ref_matches_jax_kernel(shape, tile, ln_type,
                                              monkeypatch):
    monkeypatch.setattr(jtb, "_INTERPRET", True)
    rng = np.random.default_rng(shape[1])
    p = _params(shape[-1], 1, ln_type, seed=shape[1])
    x1 = randn(rng, *shape)
    dout = randn(rng, *shape)
    want_dx1, want = j_gdfn_half_bwd(jnp.asarray(x1), jnp.asarray(dout), p,
                                     ln_type, tile)
    got_dx1, got = gb.gdfn_half_bwd(t(x1), t(dout), _torch_params(p), ln_type)
    assert_close(got_dx1, want_dx1, rtol=2e-4, atol=2e-5)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,tile,heads", [
    ((1, 8, 16, 8), 8, 2),    # single tile: both edge masks in one step
    ((1, 16, 16, 8), 8, 1),   # two tiles, single head
    ((2, 24, 16, 16), 4, 4),  # batch 2, middle tiles, 4 heads
])
@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_attn_half_bwd_ref_matches_jax_kernel(shape, tile, heads, ln_type,
                                              monkeypatch):
    monkeypatch.setattr(jtb, "_INTERPRET", True)
    rng = np.random.default_rng(shape[1] + heads)
    p = _params(shape[-1], heads, ln_type, seed=shape[1] + heads)
    x = randn(rng, *shape)
    dx1 = randn(rng, *shape)
    stats = tuple(jnp.asarray(s) for s in _jax_stats(x, p, heads, ln_type))
    want_dx, want = j_attn_half_bwd(jnp.asarray(x), jnp.asarray(dx1), p,
                                    heads, ln_type, stats, tile)
    got_dx, got = ab.attn_half_bwd(t(x), t(dx1), _torch_params(p), heads,
                                   ln_type)
    assert_close(got_dx, want_dx, rtol=2e-4, atol=2e-5)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_attn_bwd_glue_matches_jax(heads):
    rng = np.random.default_rng(heads)
    b, c = 2, 16
    cph = c // heads
    gram = randn(rng, b, c, c, scale=5.0)
    da = randn(rng, b, c, c)
    qs = rng.random((b, 1, c)).astype(np.float32) * 50
    ks = rng.random((b, 1, c)).astype(np.float32) * 50
    qs[0, 0, 0] = 0.0  # a channel at the clamp floor: no norm gradient
    temp = (1 + 0.3 * np.arange(heads, dtype=np.float32)).reshape(heads, 1, 1)
    wm, wdq, wdk, wdt = j_glue(da, gram, qs, ks, temp, heads)

    def diag(a):
        return t(np.stack([a[:, h * cph:(h + 1) * cph, h * cph:(h + 1) * cph]
                           for h in range(heads)], axis=1))

    m, dqd, dkd, dtemp = ab._attn_bwd_glue(diag(da), diag(gram),
                                           t(qs[:, 0]), t(ks[:, 0]), t(temp),
                                           heads)
    for h in range(heads):
        sl = slice(h * cph, (h + 1) * cph)
        assert_close(m[:, h], np.asarray(wm)[:, sl, sl], rtol=1e-4, atol=1e-6)
    assert_close(dqd, np.asarray(wdq)[:, 0], rtol=1e-4, atol=1e-6)
    assert_close(dkd, np.asarray(wdk)[:, 0], rtol=1e-4, atol=1e-6)
    assert_close(dtemp, wdt, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/*.cu compiled for the CPU against tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_bwd"))


def _inputs(shape, heads, ln_type, dtype, seed):
    rng = np.random.default_rng(seed)
    p = _torch_params(_params(shape[-1], heads, ln_type, seed=seed))
    x = t(randn(rng, *shape)).to(dtype)
    g = t(randn(rng, *shape)).to(dtype)
    return p, x, g


_HOST_CASES = [  # shape, heads, tile, nsplit
    ((1, 8, 16, 8), 2, (8, 16), 1),   # one tile holds every edge
    ((2, 11, 13, 16), 2, (4, 8), 3),  # ragged tiles, batch 2
    ((1, 7, 9, 12), 1, (4, 4), 4),    # odd hidden width (31), ragged
]


@pytest.mark.parametrize("shape,heads,tile,nsplit,ln_type,dtype", [
    *[(*case, ln, torch.float32) for case, ln in
      zip(_HOST_CASES, ("WithBias", "BiasFree", "WithBias"))],
    # widths where every bf16 product runs on the tensor-core path
    ((1, 9, 10, 32), 2, (4, 4), 2, "BiasFree", torch.bfloat16),
    ((2, 6, 7, 16), 1, (4, 4), 3, "WithBias", torch.bfloat16),
])
def test_cuda_bwd_sources_on_host_match_ref(host_lib, shape, heads, tile,
                                            nsplit, ln_type, dtype):
    p, x, g = _inputs(shape, heads, ln_type, dtype, seed=shape[2])
    kw = tb.prepare_tblock_weights(p, dtype, ln_type)
    _, x1, stats = tb._launch(host_lib, x, kw, heads, ln_type, tile, tile,
                              nsplit, 0, want_x1=True)
    dx1, dw1, dtap, dw2, dln = gb._launch_gdfn_bwd(
        host_lib, x1, g, kw, ln_type, tile, nsplit, 2, 0)
    gg = gb._natural_gdfn_grads(p, dw1, dtap, dw2, dln, ln_type)
    want_dx1, want_gg = gb.gdfn_half_bwd_ref(x1, g, p, ln_type)
    r = ab._launch_attn_bwd(host_lib, x, want_dx1, kw, heads, ln_type, stats,
                            tile, tile, nsplit, 2, 0)
    ga = ab._natural_attn_grads(p, *r[1:], ln_type)
    want_dx, want_ga = ab.attn_half_bwd_ref(x, want_dx1, p, heads, ln_type)
    got = {"dx1": dx1, "dx": r[0], **gg, **ga}
    want = {"dx1": want_dx1, "dx": want_dx, **want_gg, **want_ga}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if dtype == torch.float32:
            assert_close(got[k], want[k], rtol=2e-4, atol=2e-5)
        else:
            assert _rel_l2(got[k], want[k]) < BF16_REL_L2, k


@pytest.mark.parametrize("shape,heads,tile,nsplit,ln_type", [
    ((1, 5, 6, 176), 1, (4, 4), 2, "WithBias"),   # PromptIR's 176 a head
    ((1, 6, 5, 352), 2, (4, 4), 3, "BiasFree"),   # two heads of 176
    ((2, 7, 9, 96), 2, (4, 8), 2, "WithBias"),    # a Restormer width
])
def test_f32_attn_bwd_on_host_takes_wide_heads(host_lib, shape, heads, tile,
                                               nsplit, ln_type):
    """The float32 attention half (csrc/tblock_attn_bwd.cu) at up to 176
    channels a head against plain autograd, as the Restormer widths are
    held above."""
    p, x, _ = _inputs(shape, heads, ln_type, torch.float32, seed=shape[3])
    dx1 = t(randn(np.random.default_rng(shape[1]), *shape))
    kw = tb.prepare_tblock_weights(p, torch.float32, ln_type)
    fwd = [tb._first_fit(tiles, lambda tl: host_lib.tblock_smem_bytes(
        i, shape[3], heads, tl[0], tl[1], 4), "tblock_fused")
        for i, tiles in enumerate((tb._STATS_TILES, tb._APPLY_TILES))]
    _, _, stats = tb._launch(host_lib, x, kw, heads, ln_type, *fwd, nsplit, 0,
                             want_x1=True)
    r = ab._launch_attn_bwd(host_lib, x, dx1, kw, heads, ln_type, stats,
                            tile, tile, nsplit, 2, 0)
    got = {"dx": r[0], **ab._natural_attn_grads(p, *r[1:], ln_type)}
    want_dx, want = ab.attn_half_bwd_ref(x, dx1, p, heads, ln_type)
    want = {"dx": want_dx, **want}
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], rtol=2e-4, atol=2e-5)


def test_f32_attn_bwd_tiles_fit_promptir_widths(host_lib):
    """Both float32 passes fit a 4 x 4 tile at C = 704 with 176 channels a
    head, and the Restormer and narrower PromptIR widths keep 4 x 8."""
    def tile(pass_id, c, heads):
        return tb._first_fit(gb._BWD_TILES, lambda tl: (
            host_lib.tblock_attn_bwd_smem_bytes(pass_id, c, heads, tl[0],
                                                tl[1], 4)), "attn_half_bwd")

    assert host_lib.tblock_attn_bwd_max_cph() == 192
    for pass_id in (0, 1):
        assert tile(pass_id, 704, 4) == (4, 4)
        for c, heads in ((48, 1), (96, 2), (192, 4), (384, 8), (320, 4),
                         (160, 4)):
            assert tile(pass_id, c, heads) == (4, 8), (pass_id, c)


def test_wgrad_on_host_matches_matmul(host_lib):
    """The split-K product over pixels, batched per (image, head) with
    strided operands, f32 and bf16, partials summed in split order."""
    rng = np.random.default_rng(0)
    a, b = t(randn(rng, 2, 70, 24)), t(randn(rng, 2, 70, 24))
    want = torch.einsum("zpm,zpn->zmn", a[..., 8:16], b[..., 16:24])
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        got = gb._wgrad(host_lib, a.to(dtype)[..., 8:], 24, (70 * 24, 0),
                        b.to(dtype)[..., 16:], 24, (70 * 24, 0), 70, 8, 8,
                        (2, 1), 3, 0)[:, 0]
        want_d = torch.einsum("zpm,zpn->zmn", a.to(dtype).float()[..., 8:16],
                              b.to(dtype).float()[..., 16:24])
        assert_close(got, want_d, atol=tol, rtol=tol)
        assert_close(want_d, want, atol=0.2, rtol=0.05)
    assert host_lib.tblock_wgrad(None, 1, 0, 0, None, 1, 0, 0, None, 0, 8, 8,
                                 1, 1, 1, 0, None) != 0  # no pixels


@pytest.mark.parametrize("m,n,k", [
    (150, 48, 72),    # K past one 64-wide box, N below one
    (64, 136, 40),    # K below one box, N past 128 (two column tiles)
])
def test_bwd_gemm_on_host_matches_matmul(host_lib, m, n, k):
    """csrc/bwd_gemm.cu: the forward-direction product (B K-major, f32 and
    bf16 out), the input gradient (B MN-major) and the per-head products
    with their diagonal terms, against torch.matmul on the same bf16
    operands (exact products in f32: only the sum order differs)."""
    rng = np.random.default_rng(k)
    bf = torch.bfloat16
    a, b = t(randn(rng, m, k)).to(bf), t(randn(rng, n, k)).to(bf)
    want = a.float() @ b.float().T
    assert_close(gb._gemm(host_lib, a, b, torch.float32, 0), want, 1e-4, 1e-5)
    assert torch.equal(gb._gemm(host_lib, a, b, bf, 0), want.to(bf))
    w = b.T.contiguous()
    assert_close(gb._dgrad(host_lib, a, w, 0), a.float() @ w.float(), 1e-4,
                 1e-5)

    bsz, hw, heads, cph = 2, m, 2, 16
    c = heads * cph
    qkv = t(randn(rng, bsz * hw, 3 * c)).to(bf)  # pass 1's q | k | v
    dos = t(randn(rng, bsz * hw, c)).to(bf)
    mm, attn = (t(randn(rng, bsz, heads, cph, cph)).to(bf) for _ in range(2))
    dqd, dkd = t(randn(rng, bsz, c)), t(randn(rng, bsz, c))
    dth = torch.empty(bsz * hw, 3 * c)
    assert host_lib.bwd_head_products(
        gb._ptr(qkv), gb._ptr(dos), gb._ptr(mm), gb._ptr(attn), gb._ptr(dqd),
        gb._ptr(dkd), gb._ptr(dth), bsz, hw, c, heads, None) == 0

    def heads_of(x):  # (B HW, C) -> (B, heads, HW, cph)
        return x.float().reshape(bsz, hw, heads, cph).transpose(1, 2)

    q, kk, do = (heads_of(qkv[:, :c]), heads_of(qkv[:, c:2 * c]),
                 heads_of(dos))
    diag = lambda v: v.reshape(bsz, heads, 1, cph)  # noqa: E731
    want = torch.cat([
        kk @ mm.float().transpose(-1, -2) + q * diag(dqd),
        q @ mm.float() + kk * diag(dkd),
        do @ attn.float()], -1)  # (B, heads, HW, 3 cph), thirds outermost
    got = dth.reshape(bsz, hw, 3, heads, cph).permute(0, 3, 1, 2, 4)
    assert_close(got.reshape(bsz, heads, hw, 3 * cph),
                 want.reshape(bsz, heads, hw, 3, cph).reshape(
                     bsz, heads, hw, 3 * cph), 1e-4, 1e-5)


@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_bwd_ln_rows_on_host_match_reference(host_lib, ln_type):
    """csrc/bwd_stencil.cu's LayerNorm passes against the TPU kernel's row
    helpers `_ln_fwd_rows` and `_ln_bwd_rows` (f32 on the same bf16
    input): y rounded once, dx added to the residual and rounded once, the
    LN parameter partials summed over pixels."""
    rng = np.random.default_rng(5)
    c, npix, bias_free = 40, 37, int(ln_type == "BiasFree")
    x = t(randn(rng, 1, 1, npix, c, scale=2.0) + 0.5).to(torch.bfloat16)
    w, bvec = t(1 + randn(rng, c, scale=0.2)), t(randn(rng, c, scale=0.2))
    bias = bvec if not bias_free else torch.zeros(c)
    y, mu, inv = gb._ln_rows(host_lib, x, w, bias, bias_free, 0)
    z, zhat, winv, mu_inv = gb._ln_fwd_rows(x.float().reshape(npix, c), w,
                                            bvec, ln_type)
    # one bf16 rounding of f32 values that differ in their last bits
    assert_close(y.float(), z.to(torch.bfloat16).float(), 1e-6, 8e-3)
    assert_close(inv, winv[:, 0], 1e-6, 1e-6)
    assert_close(mu * inv, mu_inv[:, 0], 1e-6, 1e-6)

    dz = t(randn(rng, npix, c))
    base = t(randn(rng, 1, 1, npix, c)).to(torch.bfloat16)
    dx, dln = gb._ln_rows_bwd(host_lib, x, dz, w, mu, inv, bias_free, base,
                              2, 0)
    want = base.float().reshape(npix, c) + gb._ln_bwd_rows(
        dz, zhat, winv, mu_inv, w, ln_type)
    assert_close(dx.float().reshape(npix, c), want, 1e-2, 1e-2)
    assert_close(dln[0], (dz * zhat).sum(0), 1e-4, 1e-5)
    assert_close(dln[1], dz.sum(0), 1e-4, 1e-5)


@pytest.mark.parametrize("tap", [0, 2, 4, 6, 8])
def test_tma_halo_box_on_host_is_zero_padded_slice(host_lib, tap):
    """A halo tile of the stencils arrives as one TMA box with zeros
    outside the image: pass 1's q | k | v stencil (fwd_stencil.cu with its
    square sums off) with one tap set to 1 is the input shifted by that
    tap's offset, zero-padded (C = 48: a 64-wide column box spans two
    thirds; ragged 8 x 16 tiles in both directions)."""
    rng = np.random.default_rng(tap)
    bsz, hgt, wdt, c = 2, 11, 21, 48
    lins = t(randn(rng, bsz, hgt, wdt, 3 * c)).to(torch.bfloat16)
    dwall = torch.zeros(27, c)
    dwall[tap] = 1.0           # the q third's tap
    dwall[9 + 8 - tap] = 1.0   # the k third's, mirrored
    dwall[18 + (tap + 1) % 9] = 1.0  # the v third's, one on
    qkv = torch.empty(bsz, hgt, wdt, 3 * c, dtype=torch.bfloat16)
    assert host_lib.fwd_qkv_stencil(gb._ptr(lins), gb._ptr(dwall),
                                    gb._ptr(qkv), None, bsz, hgt, wdt, c, 3,
                                    None) == 0
    pad = torch.nn.functional.pad(lins, (0, 0, 1, 1, 1, 1))

    def shifted(tp, sl):
        dy, dx = divmod(tp, 3)
        return pad[:, dy:dy + hgt, dx:dx + wdt, sl]

    assert torch.equal(qkv[..., :c], shifted(tap, slice(0, c)))
    assert torch.equal(qkv[..., c:2 * c], shifted(8 - tap, slice(c, 2 * c)))
    assert torch.equal(qkv[..., 2 * c:],
                       shifted((tap + 1) % 9, slice(2 * c, 3 * c)))


def _host_function(monkeypatch, lib, tile, nsplit):
    """Route `_TBlockFunction` through the host build (CPU tensors)."""
    monkeypatch.setattr(tb, "_forward_kernel", lambda x, kw, heads, ln,
                        want_x1=False: tb._launch(lib, x, kw, heads, ln, tile,
                                                  tile, nsplit, 0, want_x1))

    def gdfn(x1, dout, p, ln, kw):
        dx1, *r = gb._launch_gdfn_bwd(lib, x1, dout, kw, ln, tile, nsplit, 2,
                                      0)
        return dx1, gb._natural_gdfn_grads(p, *r, ln)

    def attn(x, dx1, p, heads, ln, stats, kw):
        dx, *r = ab._launch_attn_bwd(lib, x, dx1, kw, heads, ln, stats, tile,
                                     tile, nsplit, 2, 0)
        return dx, ab._natural_attn_grads(p, *r, ln)

    monkeypatch.setattr(gb, "gdfn_half_bwd", gdfn)
    monkeypatch.setattr(ab, "attn_half_bwd", attn)


def test_function_save_and_remat_match_autograd(host_lib, monkeypatch):
    ln_type = "BiasFree"
    _host_function(monkeypatch, host_lib, (4, 8), 2)
    blk = TransformerBlock(16, 2, ln_type=ln_type)
    p0, x0, g = _inputs((1, 7, 10, 16), 2, ln_type, torch.float32, seed=3)
    with torch.no_grad():
        for k, v in blk.block_params().items():
            v.copy_(p0[k])

    def grads(run):
        x = x0.clone().requires_grad_(True)
        blk.zero_grad()
        (run(x) * g).sum().backward()
        return {"x": x.grad, **{n: q.grad.clone()
                                for n, q in blk.named_parameters()}}

    want = grads(lambda x: tb.tblock_ref(x, blk.block_params(), 2, ln_type))
    got = {}
    for mode in ("save", "remat"):
        kw = tb.prepare_tblock_weights(blk.block_params(), torch.float32,
                                       ln_type)
        got[mode] = grads(lambda x: tb._TBlockFunction.apply(
            x, kw, 2, ln_type, mode, tuple(blk.block_params()),
            *blk.block_params().values()))
        for k in want:
            assert_close(got[mode][k], want[k], rtol=2e-4, atol=2e-5)
    for k in want:
        assert_close(got["remat"][k], got["save"][k], rtol=1e-6, atol=1e-7)


def test_output_has_grad_fn_when_an_input_requires_grad():
    blk = TransformerBlock(8, 2)
    x = t(randn(np.random.default_rng(4), 1, 6, 5, 8))
    p = blk.block_params()
    assert tb.tblock_fused(x, p, 2).grad_fn is not None  # parameters
    assert blk(x).grad_fn is not None
    xr = x.clone().requires_grad_(True)
    frozen = {k: v.detach() for k, v in p.items()}
    assert tb.tblock_fused(xr, frozen, 2).grad_fn is not None  # the input
    with torch.no_grad():
        assert tb.tblock_fused(xr, p, 2).grad_fn is None
    assert tb.tblock_fused(x, frozen, 2).grad_fn is None


def test_cuda_backward_refuses_what_it_cannot_take():
    p = _torch_params(_params(8, 2, "WithBias", seed=1))
    x = t(randn(np.random.default_rng(2), 1, 4, 4, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        gb.gdfn_half_bwd(x.to("meta"), x.to("meta"), p, "WithBias", None)
    with pytest.raises(ValueError, match="unsupported device"):
        ab.attn_half_bwd(x.to("meta"), x.to("meta"), p, 2, "WithBias")


# ---------------------------------------------------------------------------
# bf16 pass 1 (the passes laid out at the top of csrc/bwd_stencil.cu)
# ---------------------------------------------------------------------------

# the bf16 attention half on the host build against the JAX kernels run op
# by op in bf16: both round at JAX pass 1's points (y, lin, v, o, do) and
# pass 2's, and differ only in the order of f32 sums, so a bf16 value may
# flip by one ulp; L2 against each gradient's norm (measured at most
# 9.8e-5, dx at the BiasFree shape; every other reading below 7e-7)
JAX_BF16_REL_L2 = 1e-3


def _pass1_capture(monkeypatch, module):
    """Record the dA that `module`'s attention backward hands its glue."""
    seen = []
    real = module._attn_bwd_glue

    def glue(da, *rest):
        seen.append(da)
        return real(da, *rest)

    monkeypatch.setattr(module, "_attn_bwd_glue", glue)
    return seen


def _per_head_stats(stats, heads):
    """JAX's (B, C, C) gram and (B, 1, C) square sums -> the port's
    (B, heads, cph, cph) diagonal blocks and (B, C) sums."""
    gram, qs, ks = (t(np.asarray(s)) for s in stats)
    b, c = gram.shape[0], gram.shape[1]
    cph = c // heads
    diag = torch.stack([gram[:, h * cph:(h + 1) * cph, h * cph:(h + 1) * cph]
                        for h in range(heads)], 1)
    return diag.contiguous(), qs[:, 0].contiguous(), ks[:, 0].contiguous()


@pytest.mark.parametrize("shape,heads,tile,ln_type", [
    ((1, 8, 16, 16), 2, 4, "WithBias"),
    ((2, 6, 8, 16), 1, 3, "BiasFree"),
])
def test_bf16_attn_bwd_on_host_matches_jax_kernels(host_lib, monkeypatch,
                                                   shape, heads, tile,
                                                   ln_type):
    """The bf16 attention half (pass 1 as LN rows, the lin product, the
    q | k | v stencil, o per head and do; pass 2 on what pass 1 kept)
    against JAX `attn_half_bwd` with its two Pallas kernels run op by op
    in bf16: the block diagonal of JAX's (B, C, C) dA against the port's
    per-head dA, dWproj, dx and every parameter gradient."""
    from test_torch_tblock_fwd import _eager_pallas_call
    import textualdegremoval_tpu.ops.pallas.tblock_attn_bwd as jab

    rng = np.random.default_rng(shape[1] + heads)
    p = _params(shape[-1], heads, ln_type, seed=shape[1] + heads)
    x = randn(rng, *shape)
    dx1 = randn(rng, *shape)
    stats = _jax_stats(x, p, heads, ln_type)
    j_da = _pass1_capture(monkeypatch, jab)
    with mock.patch.object(jtb.pl, "pallas_call", _eager_pallas_call):
        want_dx, want = jab.attn_half_bwd(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(dx1, jnp.bfloat16), p,
            heads, ln_type, tuple(jnp.asarray(s) for s in stats), tile)
    pt = _torch_params(p)
    kw = tb.prepare_tblock_weights(pt, BF, ln_type)
    p_da = _pass1_capture(monkeypatch, ab)
    got_dx, *r = ab._launch_attn_bwd(
        host_lib, t(x).to(BF), t(dx1).to(BF), kw, heads, ln_type,
        _per_head_stats(stats, heads), None, None, None, 2, 0)
    got = ab._natural_attn_grads(pt, *r, ln_type)

    b, c = shape[0], shape[-1]
    cph = c // heads
    jda = t(np.asarray(j_da[0], np.float32))
    want_da = torch.stack([jda[:, h * cph:(h + 1) * cph,
                               h * cph:(h + 1) * cph]
                           for h in range(heads)], 1)
    assert _rel_l2(p_da[0], want_da) < JAX_BF16_REL_L2
    assert _rel_l2(got_dx, t(np.asarray(want_dx, np.float32))) \
        < JAX_BF16_REL_L2
    assert set(got) == set(want)
    for k in want:  # proj (dWproj) among them
        assert _rel_l2(got[k], t(np.asarray(want[k], np.float32))) \
            < JAX_BF16_REL_L2, k


def test_bf16_attn_bwd_on_host_takes_176_channels_per_head(host_lib,
                                                           monkeypatch):
    """PromptIR's noise blocks have 176 channels per head: the bf16 half
    (forward statistics from the pipeline) runs there and matches plain
    autograd (float32 there: test_f32_attn_bwd_on_host_takes_wide_heads);
    above the kernels' 192 channels per head float32 refuses."""
    shape, heads, ln_type = (1, 8, 8, 176), 1, "WithBias"
    p, x, g = _inputs(shape, heads, ln_type, BF, seed=9)
    kw = tb.prepare_tblock_weights(p, BF, ln_type)
    _, x1, stats = tb.tblock_pipeline(host_lib, x, kw, heads, ln_type, 2, 0,
                                      want_x1=True)
    dx, *r = ab._launch_attn_bwd(host_lib, x, x1, kw, heads, ln_type, stats,
                                 None, None, None, 2, 0)
    got = {"dx": dx, **ab._natural_attn_grads(p, *r, ln_type)}
    want_dx, want_g = ab.attn_half_bwd_ref(x, x1, p, heads, ln_type)
    want = {"dx": want_dx, **want_g}
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) < BF16_REL_L2, k

    import textualdegremoval_tpu_torch.ops._build as build
    # not a CPU tensor: the kernels' route
    x32 = torch.empty((1, 8, 8, 200), device="meta")
    kw32 = tb.prepare_tblock_weights(p, torch.float32, ln_type)
    monkeypatch.setattr(ab, "_validate", lambda *a: None)
    monkeypatch.setattr(ab, "_check_weights", lambda *a: None)
    monkeypatch.setattr(build, "load_library", lambda: host_lib)
    with pytest.raises(ValueError, match="200 channels per head exceeds 192"):
        ab.attn_half_bwd(x32, x32, p, heads, ln_type, stats, kw32)


@pytest.mark.parametrize("shape", [(2, 11, 21, 48), (1, 9, 17, 96)])
def test_pass1_stencil_on_host_is_the_plain_stencil_bitwise(host_lib, shape):
    """Pass 1's q | k | v (fwd_stencil.cu with its square sums off) is
    bitwise the forward's (square sums on), and each value is the f32 sum
    of the nine taps in the kernel's order (rows, then columns) over the
    zero-padded bf16 lin, rounded once: the q and k that pass 2 read
    from it are bit for bit those its own stencil computed before."""
    rng = np.random.default_rng(shape[-1])
    bsz, hgt, wdt, c = shape
    lins = t(randn(rng, bsz, hgt, wdt, 3 * c)).to(BF)
    dwall = t(randn(rng, 27, c, scale=1 / 3))
    qkv, fwd = (torch.empty(bsz, hgt, wdt, 3 * c, dtype=BF) for _ in range(2))
    part = torch.empty(bsz, 3, 2 * c)
    assert host_lib.fwd_qkv_stencil(gb._ptr(lins), gb._ptr(dwall),
                                    gb._ptr(qkv), None, bsz, hgt, wdt, c, 3,
                                    None) == 0
    assert host_lib.fwd_qkv_stencil(gb._ptr(lins), gb._ptr(dwall),
                                    gb._ptr(fwd), gb._ptr(part), bsz, hgt,
                                    wdt, c, 3, None) == 0
    assert torch.equal(qkv, fwd)
    pad = torch.nn.functional.pad(lins.float(), (0, 0, 1, 1, 1, 1))
    taps = torch.cat([dwall[0:9], dwall[9:18], dwall[18:27]], 1)  # (9, 3C)
    acc = torch.zeros(bsz, hgt, wdt, 3 * c)
    for r in range(3):
        for col in range(3):
            acc = acc + pad[:, r:r + hgt, col:col + wdt] * taps[3 * r + col]
    assert torch.equal(qkv, acc.to(BF))
