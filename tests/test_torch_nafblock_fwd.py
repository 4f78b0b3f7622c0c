"""PyTorch port vs JAX package: the bf16 whole-NAFBlock forward pipeline.

`nafblock_fused` runs a bfloat16 block whose C is a multiple of 8 as
`naf_pipeline` (csrc/naf_stencil.cu with csrc/bwd_gemm.cu's NAFBlock
epilogues and csrc/bwd_stencil.cu's LayerNorm rows).  On the CPU, those
sources compiled for the host with tests/cuda_host_shim.h (TMA boxes and
wgmma descriptors emulated), through the launch code the CUDA path uses:
* the whole pipeline in bf16 against the JAX Pallas kernels of
  `_nafblock_impl`, run op by op (`_eager_pallas_call`: every rounding
  point of their bodies kept; the SCA sums of pass A too) and in interpret
  mode (compiled by XLA, which may keep f32 where the bodies round),
  against the port's `nafblock_ref` and against csrc/nafblock.cu's pair;
  batch 2, C = 64, 96 and 40 (24 padded gate channels), ragged tiles;
* each new part alone: the gate stencil's SUM partials and its APPLY
  output, the SCA glue, the three product epilogues (bias,
  bias-scale-residual, bias-gate), and the LayerNorm rows at NAFNet's
  epsilon 1e-6;
* the route rule of `_forward_kernel` (C = 36, not a multiple of 8, and
  float32 go to the pair), and `_NAFBlockFunction`'s gradients with the
  pipeline forward against plain autograd.
Weights are at the scales of chip_smoke.py's `randomize_nafblock`, drawn
with numpy.  The on-card checks are in tests/test_torch_nafblock_cuda.py.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.ops.pallas import nafblock as jnb

import textualdegremoval_tpu_torch.ops.pallas.nafblock as nb
from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.norm import layer_norm_2d
from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import _ln_rows

from test_torch_tblock_fwd import _eager_pallas_call
from torch_port_util import randn, t, assert_close, build_host_library

BF = torch.bfloat16
GC = nb.GATE_CHUNK
# the pipeline against the JAX kernels run op by op in bf16: both round at
# the same points and differ only in the order of f32 sums, so a value's
# rounding flips by one bf16 ulp here and there and goes on through LN2
# and the FFN; L2 over what the block adds to x (measured at most 4.7e-4)
# and elementwise at two ulps of the output's scale (at most 0.031 where
# |out| reaches 4-8)
JAX_BRANCH, JAX_ATOL, JAX_RTOL = 2e-3, 3e-2, 1.6e-2
# against the same kernels in interpret mode: XLA's CPU compiler keeps f32
# inside its fusions where the bodies round to bf16 (excess precision):
# measured 5.1e-3 to 6.0e-3 of what the block adds, as far as the op-by-op
# run is from it
INTERPRET_BRANCH = 1.5e-2
# the SCA sums: f32 sums of the same rounded gate values in another order
SUM_RTOL = 1e-5
# against the plain bf16 version, which rounds the depthwise conv and its
# bias apart and casts the taps: chip_smoke.py's bf16 bounds (NAF_TOL,
# BRANCH_TOL)
REF_ATOL, REF_RTOL, REF_BRANCH = 5e-2, 5e-2, 2e-2


@pytest.fixture(autouse=True)
def _counters_kept():
    """The launch counters as they were before each test: another test
    file in the same process holds them to 0 after CPU-only calls."""
    before = (nb.nafblock_fused.launches, nb.naf_pipeline.launches)
    yield
    nb.nafblock_fused.launches, nb.naf_pipeline.launches = before


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The pipeline's sources and csrc/nafblock.cu (the pair) compiled for
    the CPU against tests/cuda_host_shim.h."""
    return build_host_library(
        tmp_path_factory.mktemp("host_naf"),
        ("naf_stencil.cu", "bwd_gemm.cu", "bwd_stencil.cu", "nafblock.cu"))


def _naf_params(c, seed):
    """Natural-shape (JAX layout) block parameters as numpy arrays at the
    scales of chip_smoke.py's `randomize_nafblock`: conv weights N(0,
    1/fan_in), LN weights near 1 and biases near 0, conv biases N(0, 0.5^2)
    (a lost zero padding of conv1's output shows), the SCA bias, beta and
    gamma U(0.5, 1.5) (the SCA scale is O(1) and away from 1, neither
    residual branch vanishes)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: randn(rng, *s, scale=s[-2] ** -0.5)  # noqa: E731
    u = lambda *s: (0.5 + rng.random(s)).astype(np.float32)  # noqa: E731
    return dict(
        norm1_w=1 + randn(rng, c, scale=0.1), norm1_b=randn(rng, c, scale=0.1),
        w1=w(1, 1, c, 2 * c), b1=randn(rng, 2 * c, scale=0.5),
        dw=randn(rng, 3, 3, 1, 2 * c, scale=1 / 3),
        dwb=randn(rng, 2 * c, scale=0.5), sca_w=w(1, 1, c, c), sca_b=u(c),
        w3=w(1, 1, c, c), b3=randn(rng, c, scale=0.5), beta=u(1, 1, 1, c),
        norm2_w=1 + randn(rng, c, scale=0.1), norm2_b=randn(rng, c, scale=0.1),
        w4=w(1, 1, c, 2 * c), b4=randn(rng, 2 * c, scale=0.5),
        w5=w(1, 1, c, c), b5=randn(rng, c, scale=0.5), gamma=u(1, 1, 1, c))


def _block(shape, seed, dtype=BF):
    """numpy parameters, their torch tensors, the kernel weights and an
    input, from a seed."""
    pn = _naf_params(shape[-1], seed)
    p = {k: t(v) for k, v in pn.items()}
    x = t(randn(np.random.default_rng(seed + 1), *shape)).to(dtype)
    return pn, p, nb.prepare_nafblock_weights(p, dtype), x


def _branch(got, want, x):
    """||got - want|| over what the block adds to x."""
    return float((got.float() - want.float()).norm()
                 / (want.float() - x.float()).norm())


def _j(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp_close(got, want, scale=None):
    """bf16 results of f32 sums taken in another order: equal but for a
    rare flip of the last bit, one ulp (at most 2^-7 relative) of `scale`
    (default |want|)."""
    scale = want.float().abs() if scale is None else scale
    diff = (got.float() - want.float()).abs()
    assert (diff <= 2 ** -7 * scale + 1e-6).all(), diff.max().item()
    assert (got == want).float().mean() > 0.95


def _nafblock_impl_eager(x, p):
    """JAX `_nafblock_impl` with its two Pallas kernels run op by op:
    (out, pass A's per-channel sums (B, C))."""
    calls = []

    def recorded(kernel, **kw):
        run = _eager_pallas_call(kernel, **kw)

        def call(*args):
            calls.append(run(*args))
            return calls[-1]
        return call

    with mock.patch.object(jnb.pl, "pallas_call", recorded):
        out = jnb._nafblock_impl(x, p, interpret=True)
    return out, calls[0][:, 0]


@pytest.mark.parametrize("shape", [
    (2, 8, 13, 64),   # batch 2, W ragged against the 16-pixel tile
    (1, 12, 21, 96),  # H and W ragged, three gate chunks
    (1, 8, 16, 40),   # C = 40: cpad 64, 24 padded gate channels
])
def test_pipeline_on_host_matches_jax_kernel(host_lib, shape):
    pn, _, kw, x = _block(shape, seed=shape[2])
    b, hgt, wdt, c = shape
    nsplit = nb._naf_nsplit(host_lib, b, hgt, wdt, kw["cpad"] // GC, 2)
    out = nb.naf_pipeline(host_lib, x, kw, 2, 0)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jout, jsum = _nafblock_impl_eager(jx, pn)
    want = t(_j(jout))
    assert _branch(out, want, x) <= JAX_BRANCH
    assert_close(out.float(), want, atol=JAX_ATOL, rtol=JAX_RTOL)
    iout = t(_j(jnb._nafblock_impl(jx, pn, interpret=True)))
    assert _branch(out, iout, x) <= INTERPRET_BRANCH
    # pass A's sums: the SUM stencil's partials summed over the splits
    hids = torch.empty(b * hgt * wdt, 2 * kw["cpad"], dtype=BF)
    ys = _ln_rows(host_lib, x, kw["ln1w"], kw["ln1b"], 0, 0, nb._EPS)[0]
    assert host_lib.naf_gemm_bias(
        nb._ptr(ys), nb._ptr(kw["w1"]), nb._ptr(kw["b1i"]), None, None,
        nb._ptr(hids), b * hgt * wdt, 2 * kw["cpad"], c, None) == 0
    part = torch.empty(b, nsplit, kw["cpad"])
    assert host_lib.naf_gate_stencil(
        nb._ptr(hids), nb._ptr(kw["taps"]), nb._ptr(kw["dwb"]), None, None,
        nb._ptr(part), b, hgt, wdt, kw["cpad"], nsplit, 0, None) == 0
    js = _j(jsum)
    assert_close(part.sum(1)[:, :c], js, atol=SUM_RTOL * np.abs(js).max(),
                 rtol=SUM_RTOL)
    assert not part[..., c:].any()


@pytest.mark.parametrize("shape", [
    (2, 11, 19, 64),  # H and W ragged, batch 2 (JAX's plain path: odd H)
    (1, 9, 17, 96),
    (1, 5, 6, 40),    # an image smaller than one tile
])
def test_pipeline_on_host_matches_ref_and_pair(host_lib, shape):
    """Against the port's plain version (chip_smoke.py's bf16 bounds) and
    the f32 plain version, and bitwise equal to the pair of
    csrc/nafblock.cu, which rounds at the same points."""
    _, p, kw, x = _block(shape, seed=shape[1])
    out = nb.naf_pipeline(host_lib, x, kw, 3, 0)
    want = nb.nafblock_ref(x, p)
    assert _branch(out, want, x) <= REF_BRANCH
    diff = (out.float() - want.float()).abs()
    assert (diff <= REF_ATOL * want.float().abs().max()
            + REF_RTOL * want.float().abs()).all()
    assert _branch(out, nb.nafblock_ref(x.float(), p), x) <= REF_BRANCH
    pair = nb._launch(host_lib, x, kw, (4, 8), (4, 4), 2, 0)
    assert torch.equal(out, pair)
    # a repeated call is bitwise equal; the counter counts block calls
    before = nb.naf_pipeline.launches
    assert torch.equal(nb.naf_pipeline(host_lib, x, kw, 3, 0), out)
    assert nb.naf_pipeline.launches == before + 1


def _gate_ref(hids, taps, dwb, cpad):
    """The gate rnd(rnd(dw(h_a) + dwb_a) rnd(dw(h_b) + dwb_b)) of hids
    (B, H, W, 2 cpad) in W1's interleaved chunk order, in f32 on the same
    bf16 values (zero padding)."""
    b, hgt, wdt, _ = hids.shape
    nat = (hids.float().reshape(b, hgt, wdt, cpad // GC, 2, GC)
           .transpose(3, 4).reshape(b, hgt, wdt, 2 * cpad))
    k = torch.cat([taps[:9], taps[9:]], 1).reshape(3, 3, 1, 2 * cpad)
    d = dwconv(nat, k) + torch.cat([dwb[0], dwb[1]])
    d = d.to(BF).float()
    return (d[..., :cpad] * d[..., cpad:]).to(BF)


@pytest.mark.parametrize("shape,cpad,nsplit", [
    ((2, 11, 21), 64, 3),  # ragged, two chunks, fewer splits than tiles
    ((1, 8, 16), 32, 1),   # one tile, one chunk
    ((1, 19, 40), 96, 7),  # seven splits of six tiles: one split idle
])
def test_gate_stencil_on_host_matches_torch(host_lib, shape, cpad, nsplit):
    """`naf_gate_stencil`: SUM's partials sum the rounded gate over image
    pixels only (neither the halo nor the pixels past H and W of a ragged
    tile enter), per image; APPLY writes rnd(g s[image])."""
    rng = np.random.default_rng(cpad + nsplit)
    b, hgt, wdt = shape
    hids = t(randn(rng, b, hgt, wdt, 2 * cpad)).to(BF)
    taps = t(randn(rng, 18, cpad, scale=1 / 3))
    dwb = t(randn(rng, 2, cpad, scale=0.5)).to(BF).float()
    part = torch.full((b, nsplit, cpad), float("nan"))
    assert host_lib.naf_gate_stencil(
        nb._ptr(hids), nb._ptr(taps), nb._ptr(dwb), None, None,
        nb._ptr(part), b, hgt, wdt, cpad, nsplit, 0, None) == 0
    g = _gate_ref(hids, taps, dwb, cpad)
    want = g.float().sum((1, 2))
    assert_close(part.sum(1), want, atol=SUM_RTOL * want.abs().max(),
                 rtol=SUM_RTOL)
    s = t(0.5 + rng.random((b, cpad)).astype(np.float32)).to(BF).float()
    gs = torch.empty(b, hgt, wdt, cpad, dtype=BF)
    assert host_lib.naf_gate_stencil(
        nb._ptr(hids), nb._ptr(taps), nb._ptr(dwb), nb._ptr(s), nb._ptr(gs),
        None, b, hgt, wdt, cpad, nsplit, 1, None) == 0
    # torch's f32 stencil sums in another order: a flipped d_a or d_b moves
    # g by an ulp, and rnd(g s) may round the other way: two ulps of |g s|
    want = (g.float() * s[:, None, None]).to(BF)
    _ulp_close(gs, want, 2 * want.float().abs())


@pytest.mark.parametrize("c,cpad,nsplit", [
    (64, 64, 5), (40, 64, 1), (96, 96, 40),
    (1048, 1056, 3),  # more than 256 quads of channels, a ragged last one
])
def test_sca_glue_on_host_matches_torch(host_lib, c, cpad, nsplit):
    """`naf_sca_glue`: the partials summed over the splits, pooled =
    rnd(sum / HW), s = rnd(rnd(pooled . Wsca) + bsca) per image, as the
    pair's torch glue computes it; 0 past C."""
    rng = np.random.default_rng(c + nsplit)
    b, hw = 2, 37 * 53
    part = t(randn(rng, b, nsplit, cpad, scale=30.0))
    wsca = t(randn(rng, c, c, scale=c ** -0.5)).to(BF)
    bsca = t(0.5 + rng.random(c).astype(np.float32)).to(BF)
    s = torch.full((b, cpad), float("nan"))
    assert host_lib.naf_sca_glue(nb._ptr(part), nb._ptr(wsca), nb._ptr(bsca),
                                 nb._ptr(s), b, hw, c, cpad, nsplit,
                                 None) == 0
    pooled = (part.sum(1)[:, :c] / hw).to(BF)
    want = pooled @ wsca + bsca
    _ulp_close(s[:, :c].to(BF), want)
    assert not s[:, c:].any()


def _product(rng, m, n, k):
    a = t(randn(rng, m, k, scale=k ** -0.25)).to(BF)
    w = t(randn(rng, n, k, scale=k ** -0.25)).to(BF)
    return a, w, (a.float() @ w.float().T).to(BF).float()


@pytest.mark.parametrize("m,n,k", [(150, 128, 64), (70, 40, 96),
                                   (200, 256, 224)])
def test_bias_epilogues_on_host_match_torch(host_lib, m, n, k):
    """`naf_gemm_bias`: conv1's rnd(rnd(a . w^T) + bias), and with scale
    and residual y1 = rnd(res + rnd(rnd(rnd(a . w^T) + bias) scale))
    (N = 40 below one column tile, K = 224 past three boxes)."""
    rng = np.random.default_rng(n + k)
    a, w, prod = _product(rng, m, n, k)
    bias = t(randn(rng, n, scale=0.5)).to(BF).float()
    scale = t(0.5 + rng.random(n).astype(np.float32)).to(BF).float()
    res = t(randn(rng, m, n)).to(BF)
    out = torch.empty(m, n, dtype=BF)
    assert host_lib.naf_gemm_bias(nb._ptr(a), nb._ptr(w), nb._ptr(bias),
                                  None, None, nb._ptr(out), m, n, k,
                                  None) == 0
    biased = (prod + bias).to(BF)
    _ulp_close(out, biased, prod.abs() + bias.abs())
    assert host_lib.naf_gemm_bias(nb._ptr(a), nb._ptr(w), nb._ptr(bias),
                                  nb._ptr(scale), nb._ptr(res), nb._ptr(out),
                                  m, n, k, None) == 0
    scaled = (biased.float() * scale).to(BF).float()
    _ulp_close(out, (res.float() + scaled).to(BF),
               res.float().abs() + 2 * scaled.abs())


@pytest.mark.parametrize("m,cpad,k", [(150, 64, 64), (90, 96, 40),
                                      (130, 32, 48)])
def test_gate_epilogue_on_host_matches_torch(host_lib, m, cpad, k):
    """`naf_gemm_gate`: with w and bias in the interleaved chunk order of
    `prepare_nafblock_weights` (each 32-channel chunk's first half, then
    its second), g2 = rnd(h_a h_b) with h_* = rnd(rnd(a . w_*^T) + b_*),
    cpad wide; a pairing off by one chunk would multiply other channels."""
    rng = np.random.default_rng(cpad + k)
    n = 2 * cpad
    a, w, prod = _product(rng, m, n, k)
    bias = t(randn(rng, n, scale=0.5)).to(BF).float()
    out = torch.empty(m, cpad, dtype=BF)
    assert host_lib.naf_gemm_gate(nb._ptr(a), nb._ptr(w), nb._ptr(bias),
                                  nb._ptr(out), m, n, k, None) == 0
    h = (prod + bias).to(BF).float().reshape(m, cpad // GC, 2, GC)
    want = (h[:, :, 0] * h[:, :, 1]).reshape(m, cpad).to(BF)
    # a flipped rounding of one half moves the gate by an ulp of it
    _ulp_close(out, want, 2 * (h[:, :, 0] * h[:, :, 1]).abs().reshape(
        m, cpad))
    assert host_lib.naf_gemm_gate(nb._ptr(a), nb._ptr(w), nb._ptr(bias),
                                  nb._ptr(out), m, n - 32, k, None) != 0


def test_ln_rows_at_nafnet_eps_on_host(host_lib):
    """`bwd_ln_rows` with epsilon 1e-6 against NAFNet's `layer_norm_2d`,
    on rows whose variance is near the epsilon (where 1e-5 in its place
    shrinks y - b by a factor of about sqrt(11 / 2))."""
    rng = np.random.default_rng(6)
    c, npix = 64, 41
    x = randn(rng, 1, 1, npix, c)
    x[..., :20, :] = 1e-3 * randn(rng, 20, c)
    x = t(x).to(BF)
    w, bvec = t(1 + randn(rng, c, scale=0.1)), t(randn(rng, c, scale=0.1))
    y = _ln_rows(host_lib, x, w, bvec, 0, 0, nb._EPS)[0]
    want = layer_norm_2d(x.float(), w, bvec).reshape(npix, c)
    assert_close(y.float(), want.to(BF).float(), 1e-6, 8e-3)
    y5 = _ln_rows(host_lib, x, w, bvec, 0, 0, 1e-5)[0]
    assert (y5.float() - want).abs().max() > 0.1


def test_host_kernels_report_bad_shapes(host_lib):
    assert host_lib.naf_gate_stencil(None, None, None, None, None, None, 1,
                                     4, 4, 48, 1, 0, None) != 0  # cpad % 32
    assert host_lib.naf_gate_stencil(None, None, None, None, None, None, 1,
                                     4, 4, 32, 1, 1, None) != 0  # no s, gs
    assert host_lib.naf_sca_glue(None, None, None, None, 1, 16, 40, 32, 1,
                                 None) != 0  # cpad < C


def _host_route(monkeypatch, lib):
    """Run `_forward_kernel` on CPU tensors through the host build: the
    device checks and the card query taken out."""
    monkeypatch.setattr(nb, "_validate", lambda x, kw: None)
    monkeypatch.setattr(nb, "_kernel_library", lambda: lib)
    monkeypatch.setattr(nb, "_card", lambda device: (0, 2))


@pytest.mark.parametrize("c,dtype,pipeline", [
    (64, BF, True),
    (40, BF, True),               # a multiple of 8, padded gate chunks
    (36, BF, False),              # C % 8 != 0: the pair
    (16, torch.float32, False),   # float32: the pair
])
def test_forward_route_rule(host_lib, monkeypatch, c, dtype, pipeline):
    _host_route(monkeypatch, host_lib)
    assert nb._takes_naf_pipeline(torch.empty(1, 1, 1, c,
                                              dtype=dtype)) is pipeline
    _, p, kw, x = _block((2, 7, 9, c), seed=c, dtype=dtype)
    before = (nb.nafblock_fused.launches, nb.naf_pipeline.launches)
    got = nb._forward_kernel(x, kw)
    assert (nb.nafblock_fused.launches - before[0],
            nb.naf_pipeline.launches - before[1]) == (1, int(pipeline))
    want = nb.nafblock_ref(x, p)
    if dtype == BF:
        assert _branch(got, want, x) <= REF_BRANCH
    else:
        assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_function_gradients_with_pipeline(host_lib, monkeypatch):
    """`_NAFBlockFunction` in bf16 with the pipeline forward: its backward
    recomputes through the plain version one half at a time, so every
    gradient equals plain autograd's (the same bf16 ops in the same order);
    the output is the pipeline's."""
    _host_route(monkeypatch, host_lib)
    _, p0, _, x0 = _block((2, 9, 11, 64), seed=8)
    g = t(randn(np.random.default_rng(9), 2, 9, 11, 64)).to(BF)
    outs, grads = [], []
    for fused in (True, False):
        x = x0.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        if fused:
            keys = tuple(p)
            before = nb.naf_pipeline.launches
            out = nb._NAFBlockFunction.apply(
                x, nb.prepare_nafblock_weights(p, BF), keys,
                *(p[k] for k in keys))
            assert nb.naf_pipeline.launches == before + 1
        else:
            out = nb.nafblock_ref(x, p)
        out.backward(g)
        outs.append(out.detach())
        grads.append({"x": x.grad, **{k: v.grad for k, v in p.items()}})
    assert _branch(outs[0], outs[1], x0) <= REF_BRANCH
    for k, want in grads[1].items():
        assert torch.equal(grads[0][k], want), k
