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
* the CUDA sources csrc/tblock_bwd.cu, csrc/tblock_attn_bwd.cu and
  csrc/wgrad.cu compiled for the host with tests/cuda_host_shim.h, through
  the launch code the CUDA path uses, against the plain version, in f32
  and bf16;
* the autograd Function of `tblock_fused` driven by the host build: both
  bwd_modes against autograd of the plain block, and 'remat' against
  'save';
* a differentiable input always gives an output with a grad_fn.
The on-card checks are in tests/test_torch_tblock_bwd_cuda.py.
"""

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
