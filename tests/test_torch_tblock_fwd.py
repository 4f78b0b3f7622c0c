"""PyTorch port vs JAX package: the bf16 whole-block forward pipeline.

`tblock_fused` runs a bfloat16 block whose C and C / heads are multiples of
8 as `tblock_pipeline` (csrc/fwd_stencil.cu with csrc/bwd_gemm.cu,
csrc/bwd_stencil.cu's LayerNorm rows and csrc/wgrad.cu's gram).  On the
CPU, those sources compiled for the host with tests/cuda_host_shim.h
(TMA boxes and wgmma descriptors emulated), through the launch code the
CUDA path uses:
* the whole pipeline in bf16 against the JAX Pallas kernels of
  `_tblock_impl`, run op by op (`_eager_pallas_call`: every rounding point
  of their bodies kept) and in interpret mode (`interpret=True`, compiled
  by XLA, which may keep f32 where the bodies round), against the port's
  `tblock_ref` and against csrc/tblock.cu's pair, WithBias and BiasFree,
  ragged tiles, 40 channels per head at small C;
* each new part alone: the residual product, the chain's epilogue (the
  residual product and the next block's LN rows in one launch, at every
  width that its whole-row CTAs take), the attention output
  (o = v . A^T, x1 = x + rnd(o . Wproj)), the q | k | v stencil with its
  square sums and the gram over its output, the glue against
  `_attn_matrix`, and the gate stencil against `gdfn_ref`'s gate;
* the pipeline's saved gram (csrc/wgrad.cu's TMA + wgmma product, several
  pixel splits, 32 and 176 channels per head) against the gram of q and k
  formed in torch at the pipeline's rounding points;
* `_TBlockFunction` ('save' and 'remat') in bf16 with the new forward and
  the bf16 backward, against plain autograd;
* the route rule of `_forward_kernel`.
The on-card checks are in tests/test_torch_tblock_cuda.py.
"""

import itertools
from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.ops.pallas import tblock as jtb

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
import textualdegremoval_tpu_torch.ops.pallas.tblock_attn_bwd as ab
import textualdegremoval_tpu_torch.ops.pallas.tblock_bwd as gb
from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.pallas.gdfn import (
    HIDDEN_CHUNK, gelu_exact,
)

from test_torch_tblock import _params, _torch_params
from torch_port_util import randn, t, assert_close, build_host_library

BF = torch.bfloat16
# the pipeline against the JAX kernels run op by op in bf16: both round at
# the same points and differ only in the order of f32 sums, so a value's
# rounding flips by one bf16 ulp here and there; L2 over what the block
# adds to x (a fault in either half shows; measured 2.6e-4) and
# elementwise at two ulps of the output's scale
JAX_BRANCH, JAX_ATOL, JAX_RTOL = 2e-3, 3e-2, 1.6e-2
# against the same kernels in interpret mode: XLA's CPU compiler keeps f32
# inside its fusions where the bodies round to bf16 (it is allowed excess
# precision), which moves one output in three by an ulp in the GDFN half:
# 6.1e-3 to 7.5e-3 of what the block adds at these shapes, as far as the
# plain bf16 path is from either (x1 agrees bitwise)
INTERPRET_BRANCH = 1.5e-2
# the saved statistics (f32 sums of products of the same bf16 q and k, in
# another order; a flipped q or k moves them by one ulp in a few terms)
STATS_RTOL = 2e-3
# against the plain bf16 version, which rounds after every op: the bounds
# of phase 3 of chip_smoke.py (TOL, BRANCH_TOL in bf16)
REF_ATOL, REF_RTOL, REF_BRANCH = 1e-1, 5e-2, 2e-2


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The pipeline's sources, csrc/tblock.cu (the pair) and the bf16
    backward's pass 1 (csrc/tblock_attn_bwd.cu) compiled for the CPU
    against tests/cuda_host_shim.h."""
    return build_host_library(
        tmp_path_factory.mktemp("host_fwd"),
        ("fwd_stencil.cu", "bwd_gemm.cu", "bwd_stencil.cu", "wgrad.cu",
         "tblock.cu", "tblock_attn_bwd.cu"))


def _block(shape, heads, ln_type, seed):
    """numpy parameters (JAX layout), their torch tensors, the bf16 kernel
    weights and a bf16 input, from a seed."""
    pn = _params(shape[-1], heads, ln_type, seed=seed)
    p = _torch_params(pn)
    x = t(randn(np.random.default_rng(seed + 1), *shape)).to(BF)
    return pn, p, tb.prepare_tblock_weights(p, BF, ln_type), x


def _branch(got, want, x):
    """||got - want|| over what the block adds to x."""
    return float((got.float() - want.float()).norm()
                 / (want.float() - x.float()).norm())


def _j(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


class _Ref:
    """A Pallas ref as a JAX array that the kernel body reads and writes."""

    def __init__(self, a):
        self.a = jnp.asarray(a)

    dtype = property(lambda self: self.a.dtype)
    shape = property(lambda self: self.a.shape)

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = self.a.at[i].set(v)

    def __jax_array__(self):
        return self.a


def _eager_pallas_call(kernel, *, grid, in_specs, out_specs, out_shape,
                       scratch_shapes=(), **_):
    """`pl.pallas_call` run op by op on the host: the grid in order, each
    block cut from its operand by its BlockSpec's index map, the body
    called on `_Ref`s, so that every `astype` of the body rounds where it
    is written (no compiler between)."""
    multi = isinstance(out_shape, (list, tuple))
    shapes = list(out_shape) if multi else [out_shape]
    ospecs = list(out_specs) if multi else [out_specs]

    def blocks(spec, gidx):
        if spec.block_shape is None:
            return (Ellipsis,)
        idx = spec.index_map(*gidx)
        return tuple(slice(int(b) * n, (int(b) + 1) * n)
                     for b, n in zip(idx, spec.block_shape))

    def run(*args):
        outs = [jnp.zeros(o.shape, o.dtype) for o in shapes]
        scratch = [_Ref(jnp.zeros(s.shape, s.dtype)) for s in scratch_shapes]
        for gidx in itertools.product(*map(range, grid)):
            ins = [_Ref(a[blocks(sp, gidx)]) for a, sp in zip(args, in_specs)]
            orefs = [_Ref(o[blocks(sp, gidx)]) for o, sp in zip(outs, ospecs)]
            with mock.patch.object(jtb.pl, "program_id",
                                   lambda d: gidx[d]), \
                    mock.patch.object(jtb.pl, "num_programs",
                                      lambda d: grid[d]):
                kernel(*ins, *orefs, *scratch)
            outs = [o.at[blocks(sp, gidx)].set(r.a)
                    for o, r, sp in zip(outs, orefs, ospecs)]
        return outs if multi else outs[0]
    return run


def _tblock_impl_eager(x, p, heads, ln_type):
    """JAX `_tblock_impl` with its two Pallas kernels run op by op:
    (out, x1, (gram, qssq, kssq))."""
    with mock.patch.object(jtb.pl, "pallas_call", _eager_pallas_call):
        return jtb._tblock_impl(x, p, heads, ln_type, want_x1=True,
                                want_stats=True)


@pytest.mark.parametrize("shape,heads,ln_type", [
    ((1, 8, 16, 16), 2, "WithBias"),   # one tile holds every edge
    ((2, 8, 13, 16), 1, "BiasFree"),   # W ragged against 16, batch 2
    ((1, 8, 10, 80), 2, "BiasFree"),   # 40 channels per head, hpad 224
    ((1, 16, 24, 48), 2, "WithBias"),  # two row tiles, a ragged column
])
def test_pipeline_on_host_matches_jax_kernel(host_lib, shape, heads,
                                             ln_type):
    pn, _, kw, x = _block(shape, heads, ln_type, seed=shape[2])
    out, x1, (gram, qssq, kssq) = tb.tblock_pipeline(
        host_lib, x, kw, heads, ln_type, 2, 0, want_x1=True)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jout, jx1, (jgram, jqs, jks) = _tblock_impl_eager(jx, pn, heads, ln_type)
    for got, want in ((out, jout), (x1, jx1)):
        want = t(_j(want))
        assert _branch(got, want, x) <= JAX_BRANCH
        assert_close(got.float(), want, atol=JAX_ATOL, rtol=JAX_RTOL)
    iout, ix1 = jtb._tblock_impl(jx, pn, heads, ln_type, interpret=True,
                                 want_x1=True)
    assert _branch(out, t(_j(iout)), x) <= INTERPRET_BRANCH
    assert torch.equal(x1.float(), t(_j(ix1)))
    cph = shape[-1] // heads
    jg = _j(jgram)
    for h in range(heads):
        sl = slice(h * cph, (h + 1) * cph)
        assert_close(gram[:, h], jg[:, sl, sl],
                     atol=STATS_RTOL * np.abs(jg).max(), rtol=STATS_RTOL)
    assert_close(qssq, _j(jqs)[:, 0], atol=0, rtol=STATS_RTOL)
    assert_close(kssq, _j(jks)[:, 0], atol=0, rtol=STATS_RTOL)


@pytest.mark.parametrize("shape,heads,ln_type", [
    ((2, 11, 19, 48), 2, "WithBias"),  # H and W ragged, batch 2
    ((1, 9, 17, 80), 2, "BiasFree"),   # 40 channels per head, ragged
    ((1, 5, 6, 32), 4, "WithBias"),    # image smaller than one tile
])
def test_pipeline_on_host_matches_ref_and_pair(host_lib, shape, heads,
                                               ln_type):
    """Against the port's plain version (phase 3's bf16 bounds) and the f32
    plain version, and bitwise-equal or near the pair of csrc/tblock.cu,
    which rounds at the same points (the JAX kernel falls back to its plain
    path at these heights)."""
    _, p, kw, x = _block(shape, heads, ln_type, seed=shape[1])
    out, x1, _ = tb.tblock_pipeline(host_lib, x, kw, heads, ln_type, 3, 0,
                                    want_x1=True)
    for got, want in ((out, tb.tblock_ref(x, p, heads, ln_type)),
                      (x1, tb._tblock_attn_part(x, p, heads, ln_type))):
        assert _branch(got, want, x) <= REF_BRANCH
        assert_close(got.float(), want.float(), atol=REF_ATOL,
                     rtol=REF_RTOL)
    assert _branch(out, tb.tblock_ref(x.float(), p, heads, ln_type),
                   x) <= REF_BRANCH
    pair = tb._launch(host_lib, x, kw, heads, ln_type, (4, 8), (4, 4), 2, 0)
    assert _branch(out, pair, x) <= JAX_BRANCH
    # a repeated call is bitwise equal; the counter counts block calls
    before = tb.tblock_pipeline.launches
    assert torch.equal(tb.tblock_pipeline(host_lib, x, kw, heads, ln_type,
                                          3, 0), out)
    assert tb.tblock_pipeline.launches == before + 1


def _ulp_close(got, want, scale=None):
    """bf16 results of f32 sums taken in another order: equal but for a
    rare flip of the last bit, one ulp (at most 2^-7 relative) of `scale`
    (default |want|; the terms' magnitudes where a rounded product is
    added to a residual)."""
    scale = want.float().abs() if scale is None else scale
    diff = (got.float() - want.float()).abs()
    assert (diff <= 2 ** -7 * scale + 1e-6).all(), diff.max().item()
    assert (got == want).float().mean() > 0.95


def test_residual_product_on_host_matches_torch(host_lib):
    """csrc/bwd_gemm.cu `fwd_gemm_residual`: out = res + rnd(a . b^T), the
    product rounded to bf16, the residual added in f32, the sum rounded
    (K = 224 past three 64-wide boxes, N = 80 below two column tiles)."""
    rng = np.random.default_rng(1)
    m, n, k = 150, 80, 224
    a, b = (t(randn(rng, r, k, scale=k ** -0.25)).to(BF) for r in (m, n))
    res = t(randn(rng, m, n)).to(BF)
    out = torch.empty(m, n, dtype=BF)
    assert host_lib.fwd_gemm_residual(
        tb._ptr(a), tb._ptr(b), tb._ptr(res), tb._ptr(out), m, n, k,
        None) == 0
    prod = (a.float() @ b.float().T).to(BF).float()
    want = (res.float() + prod).to(BF)
    _ulp_close(out, want, res.float().abs() + prod.abs())


@pytest.mark.parametrize("m,n,k,ln_type", [
    (150, 48, 256, "WithBias"),   # BN 64, 16 columns past N
    (70, 96, 128, "BiasFree"),    # BN 128
    (130, 192, 512, "WithBias"),  # BN 192: one warpgroup holds a row
    (90, 384, 1024, "BiasFree"),  # the latent's width: two warpgroups of
                                  # 192 columns trade a row's moments
    (33, 376, 96, "WithBias"),    # the split ragged in N, K past one box
    (257, 160, 64, "BiasFree"),   # ragged M, a row tile and one row
])
def test_chain_epilogue_on_host_matches_residual_and_ln_rows(host_lib, m, n,
                                                             k, ln_type):
    """`fwd_gemm_residual_ln`: out bitwise what `fwd_gemm_residual` writes,
    and y within one bf16 ulp of `bwd_ln_rows` on that out (the one-pass
    moments of the rounded out values, summed in another order), both
    LayerNorm types, out at a residual stream's scale with a mean per row
    (a missing mean subtraction shows)."""
    rng = np.random.default_rng(n + m)
    a, b = (t(randn(rng, r, k, scale=k ** -0.25)).to(BF) for r in (m, n))
    res = (t(randn(rng, m, n)) + t(randn(rng, m, 1))).to(BF)
    w = t(1 + 0.3 * randn(rng, n))
    bias = t(0.2 * randn(rng, n))
    bias_free = int(ln_type == "BiasFree")
    out, y, want_out = (torch.empty(m, n, dtype=BF) for _ in range(3))
    assert host_lib.fwd_gemm_residual_ln(
        tb._ptr(a), tb._ptr(b), tb._ptr(res), tb._ptr(w), tb._ptr(bias),
        bias_free, gb._EPS, tb._ptr(out), tb._ptr(y), m, n, k, None) == 0
    assert host_lib.fwd_gemm_residual(
        tb._ptr(a), tb._ptr(b), tb._ptr(res), tb._ptr(want_out), m, n, k,
        None) == 0
    assert torch.equal(out, want_out)
    want_y = gb._ln_rows(host_lib, want_out, w, bias, bias_free, None)[0]
    _ulp_close(y, want_y)
    # and the f32 LayerNorm of the same rounded out, rounded once
    _ulp_close(y, tb._ln(out.float(), w, bias, ln_type).to(BF))


def test_chain_epilogue_refuses_what_its_ctas_cannot_hold(host_lib):
    """Rows wider than the two warpgroups' 384 columns, or not a multiple
    of 8 columns, are refused (the chain then runs the boundary unfused)."""
    for n in (392, 44):
        assert host_lib.fwd_gemm_residual_ln(
            *([None] * 5), 0, 1e-5, None, None, 8, n, 64, None) != 0
    assert tb._chain_fuses(384) and not tb._chain_fuses(392)


@pytest.mark.parametrize("c,heads", [(32, 2), (80, 2), (96, 1)])
def test_attn_out_on_host_matches_torch(host_lib, c, heads):
    """`fwd_attn_out`: o = v . A_h^T per (image, head) rounded to bf16
    (A, not A^T: the softmax rows are the output channels), then
    x1 = x + rnd(o . Wproj)."""
    rng = np.random.default_rng(c)
    bsz, hw, cph = 2, 70, c // heads
    qkv = t(randn(rng, bsz * hw, 3 * c)).to(BF)
    attn = torch.softmax(t(randn(rng, bsz, heads, cph, cph, scale=3.0)),
                         -1).to(BF)
    wproj = t(randn(rng, c, c, scale=c ** -0.5))  # (inputs, outputs)
    x = t(randn(rng, bsz * hw, c)).to(BF)
    o, x1 = torch.empty_like(x), torch.empty_like(x)
    assert host_lib.fwd_attn_out(
        tb._ptr(qkv), tb._ptr(attn), tb._ptr(wproj.T.contiguous().to(BF)),
        tb._ptr(x), tb._ptr(o), tb._ptr(x1), bsz, hw, c, heads, None) == 0
    v = qkv[:, 2 * c:].float().reshape(bsz, hw, heads, cph).transpose(1, 2)
    want_o = (v @ attn.float().transpose(-1, -2)).transpose(1, 2).reshape(
        bsz * hw, c).to(BF)
    _ulp_close(o, want_o)
    proj = (o.float() @ wproj.to(BF).float()).to(BF).float()
    _ulp_close(x1, (x.float() + proj).to(BF), x.float().abs() + proj.abs())


@pytest.mark.parametrize("shape", [(2, 11, 21, 48), (1, 8, 16, 40)])
def test_qkv_stencil_on_host_matches_torch(host_lib, shape):
    """`fwd_qkv_stencil`: q | k | v = dw3x3(lin) with zero padding, each
    rounded once, and the per-CTA square sums of the rounded q and k; the
    gram of its output (`_wgrad`, per (image, head)) against torch."""
    rng = np.random.default_rng(shape[2])
    bsz, hgt, wdt, c = shape
    # the bf16 gram reads each head through TMA, at 16-byte strides: cph a
    # multiple of 8, as the pipeline admits (24 and 8 channels per head)
    heads, nsplit = {48: 2, 40: 5}[c], 3
    lins = t(randn(rng, bsz, hgt, wdt, 3 * c)).to(BF)
    taps = t(randn(rng, 3, 3, 1, 3 * c, scale=1 / 3))
    dwall = taps.reshape(9, 3 * c)
    dwall = torch.cat([dwall[:, :c], dwall[:, c:2 * c], dwall[:, 2 * c:]])
    qkv = torch.empty(bsz, hgt, wdt, 3 * c, dtype=BF)
    part = torch.empty(bsz, nsplit, 2 * c)
    assert host_lib.fwd_qkv_stencil(
        tb._ptr(lins), tb._ptr(dwall.contiguous()), tb._ptr(qkv),
        tb._ptr(part), bsz, hgt, wdt, c, nsplit, None) == 0
    want = dwconv(lins.float(), taps).to(BF)
    _ulp_close(qkv, want)
    sq = qkv[..., :2 * c].float().reshape(bsz, -1, 2 * c)
    assert_close(part.sum(1), (sq * sq).sum(1), atol=0, rtol=1e-5)
    hw, cph = hgt * wdt, c // heads
    gram = gb._wgrad(host_lib, qkv, 3 * c, (hw * 3 * c, cph), qkv[..., c:],
                     3 * c, (hw * 3 * c, cph), hw, cph, cph, (bsz, heads), 2,
                     0)
    q = sq[..., :c].reshape(bsz, hw, heads, cph).transpose(1, 2)
    k = sq[..., c:].reshape(bsz, hw, heads, cph).transpose(1, 2)
    assert_close(gram, q.transpose(-1, -2) @ k, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape,heads,sms", [
    ((2, 20, 24, 64), 2, 8),    # 32 channels a head, several pixel splits
    ((1, 12, 10, 176), 1, 2),   # PromptIR's 176: two row tiles of the gram
])
def test_pipeline_gram_on_host_matches_plain_gram(host_lib, monkeypatch,
                                                  shape, heads, sms):
    """`tblock_pipeline`'s saved gram, from csrc/wgrad.cu's TMA + wgmma
    product per (image, head), against the float64 gram of q and k formed
    in torch at the pipeline's rounding points (y, lin, q, k in bf16),
    within STATS_RTOL; and against the float64 product of the very
    operands the kernel was handed, within the f32 sum order."""
    pn, p, kw, x = _block(shape, heads, "WithBias", seed=shape[-1])
    seen = []
    real = gb._wgrad

    def wgrad(lib, a, lda, sa, b, ldb, sb, npix, m, n, nb, *rest):
        seen.append([torch.as_strided(v, (nb[0], nb[1], npix, w),
                                      (s_[0], s_[1], ld, 1),
                                      v.storage_offset()).double().clone()
                     for v, ld, s_, w in ((a, lda, sa, m), (b, ldb, sb, n))])
        return real(lib, a, lda, sa, b, ldb, sb, npix, m, n, nb, *rest)

    monkeypatch.setattr(gb, "_wgrad", wgrad)
    _, _, (gram, _, _) = tb.tblock_pipeline(host_lib, x, kw, heads,
                                            "WithBias", sms, 0, want_x1=True)
    (qa, kb), = seen
    assert_close(gram, (qa.transpose(-1, -2) @ kb).float(), atol=1e-4,
                 rtol=1e-5)

    bsz, hgt, wdt, c = shape
    cph = c // heads
    y = tb._ln(x.float(), p["norm1_w"], p.get("norm1_b"), "WithBias").to(BF)
    lin = (y.float() @ p["qkv"].reshape(c, 3 * c).to(BF).float()).to(BF)
    qkv = dwconv(lin.float(), p["qkv_dw"]).to(BF).double()

    def heads_of(v):  # (B, H, W, C) -> (B, heads, HW, cph)
        return v.reshape(bsz, hgt * wdt, heads, cph).transpose(1, 2)

    want = heads_of(qkv[..., :c]).transpose(-1, -2) @ heads_of(
        qkv[..., c:2 * c])
    assert_close(gram, want.float(), atol=STATS_RTOL * want.abs().max(),
                 rtol=STATS_RTOL)


@pytest.mark.parametrize("c,heads", [(80, 2), (96, 1), (704, 4)])
def test_attn_glue_on_host_matches_attn_matrix(host_lib, c, heads):
    """`fwd_attn_glue`: the attention of `_attn_matrix` (f32, one bf16
    rounding; a q channel at the clamp floor) and the square sums split
    into q's and k's; 40, 96 and 176 channels per head."""
    rng = np.random.default_rng(c)
    bsz, cph = 2, c // heads
    gram = t(randn(rng, bsz, heads, cph, cph, scale=20.0))
    ssq = t(rng.random((bsz, 2 * c)).astype(np.float32) * 80)
    ssq[:, 3] = 0.0
    temp = t((1 + 0.5 * np.arange(heads)).astype(np.float32) * 3)
    qssq, kssq = torch.empty(bsz, c), torch.empty(bsz, c)
    attn = torch.empty(bsz, heads, cph, cph, dtype=BF)
    assert host_lib.fwd_attn_glue(
        tb._ptr(gram), tb._ptr(ssq), tb._ptr(temp), tb._ptr(qssq),
        tb._ptr(kssq), tb._ptr(attn), bsz, c, heads, None) == 0
    assert torch.equal(qssq, ssq[:, :c]) and torch.equal(kssq, ssq[:, c:])
    _ulp_close(attn, tb._attn_matrix(gram, qssq, kssq, temp, heads, BF))


@pytest.mark.parametrize("shape,hidden", [((2, 11, 21), 40), ((1, 8, 16), 64)])
def test_gate_stencil_on_host_matches_gdfn_gate(host_lib, shape, hidden):
    """`fwd_gate_stencil`: gelu(dw3x3(h1)) dw3x3(h2) of hid in W1's
    interleaved chunk order, rounded once, against the gate of `gdfn_ref`
    (its stencil and gelu, in f32 on the same bf16 hid); the padded hidden
    channels have zero taps."""
    rng = np.random.default_rng(hidden)
    bsz, hgt, wdt = shape
    hpad = -(-hidden // HIDDEN_CHUNK) * HIDDEN_CHUNK
    h1, h2 = (t(randn(rng, bsz, hgt, wdt, hidden)).to(BF) for _ in range(2))
    dwk = t(randn(rng, 3, 3, 2 * hidden, scale=1 / 3))
    pad = torch.zeros(bsz, hgt, wdt, hpad - hidden, dtype=BF)
    nat = torch.cat([h1, pad, h2, pad], -1)  # all h1, then all h2
    hids = (nat.reshape(-1, 2, hpad // HIDDEN_CHUNK, HIDDEN_CHUNK)
            .transpose(1, 2).reshape(bsz, hgt, wdt, 2 * hpad).contiguous())
    dwg = torch.zeros(18, hpad)
    dwg[:9, :hidden] = dwk.reshape(9, -1)[:, :hidden]
    dwg[9:, :hidden] = dwk.reshape(9, -1)[:, hidden:]
    gates = torch.empty(bsz, hgt, wdt, hpad, dtype=BF)
    assert host_lib.fwd_gate_stencil(
        tb._ptr(hids), tb._ptr(dwg), tb._ptr(gates), bsz, hgt, wdt, hpad, 4,
        None) == 0
    # gdfn_ref's gate: its dwconv and gelu on the f32 hid
    y = dwconv(torch.cat([h1, h2], -1).float(), dwk[:, :, None, :])
    want = (gelu_exact(y[..., :hidden]) * y[..., hidden:]).to(BF)
    _ulp_close(gates[..., :hidden], want)
    assert not gates[..., hidden:].float().any()


def _host_route(monkeypatch, lib):
    """Run `_forward_kernel` and the bf16 backward on CPU tensors through
    the host build: the device checks and the card query taken out."""
    monkeypatch.setattr(tb, "_validate", lambda *a: None)
    monkeypatch.setattr(tb, "_kernel_library", lambda cph, what: lib)
    monkeypatch.setattr(tb, "_card", lambda device: (0, 2))

    def gdfn(x1, dout, p, ln, kw):
        dx1, *r = gb._launch_gdfn_bwd(lib, x1, dout, kw, ln, None, None, 2,
                                      0)
        return dx1, gb._natural_gdfn_grads(p, *r, ln)

    def attn(x, dx1, p, heads, ln, stats, kw):
        dx, *r = ab._launch_attn_bwd(lib, x, dx1, kw, heads, ln, stats,
                                     (4, 8), None, None, 2, 0)
        return dx, ab._natural_attn_grads(p, *r, ln)

    monkeypatch.setattr(gb, "gdfn_half_bwd", gdfn)
    monkeypatch.setattr(ab, "attn_half_bwd", attn)


@pytest.mark.parametrize("c,heads,dtype,pipeline", [
    (16, 2, BF, True),               # C and C / heads multiples of 8
    (80, 2, BF, True),               # 40 channels per head
    (12, 1, BF, False),              # C % 8 != 0: the pair
    (32, 8, BF, False),              # C / heads = 4: the pair
    (16, 2, torch.float32, False),   # float32: the pair
])
def test_forward_route_rule(host_lib, monkeypatch, c, heads, dtype,
                            pipeline):
    _host_route(monkeypatch, host_lib)
    assert tb._takes_pipeline(torch.empty(1, 1, 1, c, dtype=dtype),
                              heads) is pipeline
    _, p, _, x = _block((1, 7, 9, c), heads, "WithBias", seed=c)
    x = x.to(dtype)
    kw = tb.prepare_tblock_weights(p, dtype, "WithBias")
    before = (tb.tblock_fused.launches, tb.tblock_pipeline.launches)
    got = tb._forward_kernel(x, kw, heads, "WithBias")
    assert (tb.tblock_fused.launches - before[0],
            tb.tblock_pipeline.launches - before[1]) == (1, int(pipeline))
    want = tb.tblock_ref(x, p, heads, "WithBias")
    if dtype == BF:
        assert _branch(got, want, x) <= REF_BRANCH
    else:
        assert_close(got, want)


def test_function_save_and_remat_with_pipeline(host_lib, monkeypatch):
    """`_TBlockFunction` in bf16 with the pipeline forward and the bf16
    backward: both modes against plain bf16 autograd (the backward's CPU
    bound, tests/test_torch_tblock_bwd.py BF16_REL_L2), 'remat' bitwise
    equal to 'save' with one more pipeline call."""
    from test_torch_tblock_bwd import BF16_REL_L2, _rel_l2

    _host_route(monkeypatch, host_lib)
    ln_type, heads = "BiasFree", 2
    _, p0, _, x0 = _block((1, 9, 18, 32), heads, ln_type, seed=7)
    g = t(randn(np.random.default_rng(8), 1, 9, 18, 32)).to(BF)
    p = p0

    def grads(run):
        x = x0.clone().requires_grad_(True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        out = run(x, leaves)
        got = torch.autograd.grad(out, [x, *leaves.values()], g)
        return dict(zip(["x", *leaves], got))

    want = grads(lambda x, q: tb.tblock_ref(x, q, heads, ln_type))
    got = {}
    for mode, calls in (("save", 1), ("remat", 2)):
        kw = tb.prepare_tblock_weights(p, BF, ln_type)
        before = tb.tblock_pipeline.launches
        got[mode] = grads(lambda x, q: tb._TBlockFunction.apply(
            x, kw, heads, ln_type, mode, tuple(q), *q.values()))
        assert tb.tblock_pipeline.launches - before == calls
        for k in want:
            assert _rel_l2(got[mode][k], want[k]) < BF16_REL_L2, (mode, k)
    for k in want:
        assert torch.equal(got["remat"][k], got["save"][k]), k
