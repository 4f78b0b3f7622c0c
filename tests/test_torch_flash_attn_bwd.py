"""PyTorch port vs JAX package: the flash self-attention backward (B4's
backward, csrc/flash_attn_bwd.cu) and the forward's log-sum-exp output.

On the CPU:
* `attention_bwd_ref` (the plain version of the backward kernels: P
  recomputed from the forward's lse) and autograd through `attention_ref`
  against `jax.vjp` of the JAX `self_attention(use_flash=False)` and the
  stock kernel's own plain backward `mha_reference_bwd` (its `l`, `m`
  residuals as lse = m + log l): float32 to 1e-5, bfloat16 to the bound
  stated below;
* `lse_ref` against the stock `mha_reference_no_custom_vjp` residuals;
* the CUDA sources themselves, compiled for the host with
  tests/cuda_host_shim.h: the forward's lse against `torch.logsumexp`, and
  the dkv and dq kernels against `attention_bwd_ref` through the launch
  code the CUDA path uses, at ragged N, head_dim 64 and 128, float32 and
  bfloat16; q, k, v read in place from a fused projection; bitwise repeat;
  the C entry points' validation.
The on-card checks are in tests/test_torch_flash_attn_cuda.py and
chip_smoke.py phase 14.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as stock

from textualdegremoval_tpu.ops import flash_attn as jfa

import textualdegremoval_tpu_torch.ops.flash_attn as fa

from torch_port_util import (  # noqa: F401  (a fixture)
    randn, t, assert_close, build_host_library, torch_share_of_cores,
)


def _inputs(shape, seed, peak=3.0):
    """q, k, v, do of `shape` (B, N, H, D); q and k scaled so that the
    logits q.k / sqrt(D) have a standard deviation of about `peak`."""
    rng = np.random.default_rng(seed)
    s = peak ** 0.5
    return (randn(rng, *shape, scale=s), randn(rng, *shape, scale=s),
            randn(rng, *shape), randn(rng, *shape))


def _bhnd(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


def _stock_bwd(q, k, v, do):
    """The stock Pallas kernel's plain forward and backward (BHND, sm_scale
    1, so q is scaled first): (o, lse (B, H, N), dq, dk, dv), BNHD."""
    scale = q.shape[-1] ** -0.5
    qs, kb, vb, dob = (_bhnd(a) for a in (q * scale, k, v, do))
    o, l, m = stock.mha_reference_no_custom_vjp(qs, kb, vb,
                                                save_residuals=True)
    dqs, dk, dv, _ = stock.mha_reference_bwd(qs, kb, vb, None, None, o, l, m,
                                             dob)
    back = (lambda a: np.asarray(a).transpose(0, 2, 1, 3))
    return (back(o), np.asarray(m + jnp.log(l)), back(dqs) * scale, back(dk),
            back(dv))


@pytest.mark.parametrize("shape", [(1, 64, 2, 64), (2, 80, 1, 128),
                                   (1, 33, 3, 16)])
def test_attention_bwd_ref_matches_jax_vjp(shape):
    q, k, v, do = _inputs(shape, seed=shape[1])
    _, vjp = jax.vjp(lambda a, b, c: jfa.self_attention(a, b, c,
                                                        use_flash=False),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, lse, *stock_grads = _stock_bwd(q, k, v, do)
    tq, tk, tv, tdo = (t(a) for a in (q, k, v, do))
    got = fa.attention_bwd_ref(tq, tk, tv, fa.attention_ref(tq, tk, tv),
                               fa.lse_ref(tq, tk), tdo)
    for g, w, s in zip(got, want, stock_grads):
        assert_close(g, w, atol=1e-5, rtol=1e-5)
        assert_close(g, s, atol=1e-5, rtol=1e-5)
    # the plain version reads lse and o as given: the stock residuals too
    again = fa.attention_bwd_ref(tq, tk, tv, t(o), t(lse), tdo)
    for g, s in zip(again, stock_grads):
        assert_close(g, s, atol=1e-5, rtol=1e-5)


def test_autograd_through_attention_ref_matches_jax_vjp():
    q, k, v, do = _inputs((2, 48, 2, 32), seed=1)
    _, vjp = jax.vjp(lambda a, b, c: jfa.self_attention(a, b, c,
                                                        use_flash=False),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(fa.attention_ref(*leaves), leaves, t(do))
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_lse_ref_matches_stock_residuals():
    q, k, v, do = _inputs((2, 70, 2, 64), seed=2, peak=6.0)
    _, lse, *_ = _stock_bwd(q, k, v, do)
    assert_close(fa.lse_ref(t(q), t(k)), lse, atol=1e-5, rtol=1e-6)


# bf16 inputs, the plain backward vs jax.vjp of the JAX function in bf16:
# both compute in f32 from bf16 operands and round each gradient to bf16
# once, JAX (dot_product_attention's own VJP) also rounds the probabilities
# and dP to bf16 inside, so they differ by about one bf16 ulp (2^-8
# relative) per element: bounded at 2e-2 max|p| + 2e-2 |p| and 1e-2 in L2.
def test_attention_bwd_ref_bf16_matches_jax_bf16():
    q, k, v, do = _inputs((1, 64, 2, 64), seed=3)
    _, vjp = jax.vjp(lambda a, b, c: jfa.self_attention(a, b, c,
                                                        use_flash=False),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv, tdo = (t(a).bfloat16() for a in (q, k, v, do))
    got = fa.attention_bwd_ref(tq, tk, tv, fa.attention_ref(tq, tk, tv),
                               fa.lse_ref(tq, tk), tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _check(g, torch.from_numpy(np.asarray(w.astype(jnp.float32))),
               BF16_TOL)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/flash_attn.cu and csrc/flash_attn_bwd.cu compiled for the CPU
    against tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_flash_bwd"),
                              ("flash_attn.cu", "flash_attn_bwd.cu"))


# kernel vs attention_bwd_ref: |k - p| <= a max|p| + r |p| at every element
# and ||k - p|| <= l2 ||p||, (a, r, l2) below.  float32: the same f32 math
# in other orders (exp2 of prescaled logits).  bfloat16: the kernel rounds P
# and dS to bf16 as product operands and sums in f32, the plain version
# keeps them in f32; both round each gradient to bf16 once, so they differ
# by about one bf16 ulp (2^-8 relative): measured L2 2.6-2.8e-3 here.
F32_TOL = (1e-5, 1e-4, 1e-5)
BF16_TOL = (2e-2, 2e-2, 1e-2)


def _check(got, want, tol):
    a, r, l2 = tol
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    diff = (g - w).abs()
    use = (diff / (a * w.abs().max() + r * w.abs())).max().item()
    assert use <= 1.0, (use, diff.max().item())
    assert (diff.norm() / w.norm()).item() <= l2


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("shape", [
    (1, 80, 2, 64),    # ragged: a second tile of 16 rows and keys
    (2, 70, 1, 128),   # head_dim 128: the walked tile in halves of 32
    (1, 5, 2, 64),     # N below one tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_source_on_host_matches_ref(host_lib, shape, dtype):
    q, k, v, do = (t(a).to(dtype) for a in _inputs(shape, seed=shape[1]))
    o, lse = fa._launch(host_lib, q, k, v, 0, want_lse=True)
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert_close(lse, fa.lse_ref(q, k), atol=1e-5, rtol=1e-6)
    got = fa._launch_bwd(host_lib, q, k, v, o, lse, do, 0)
    want = fa.attention_bwd_ref(q, k, v, o, lse, do)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and g.is_contiguous()
        _check(g, w, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("n", [64, 65, 200])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_backward_on_host_at_tile_edges(host_lib, n, d):
    """The bf16 dkv and dq kernels at their tile edges (one 64-row box, one
    row past it, a ragged 200; D = 128 reads two boxes a row, and dkv walks
    32-query tiles there): the forward's lse, then dq, dk, dv against the
    plain backward."""
    q, k, v, do = (t(a).bfloat16() for a in _inputs((1, n, 2, d),
                                                    seed=n + d))
    o, lse = fa._launch(host_lib, q, k, v, 0, want_lse=True)
    assert_close(lse, fa.lse_ref(q, k), atol=1e-5, rtol=1e-6)
    got = fa._launch_bwd(host_lib, q, k, v, o, lse, do, 0)
    for g, w in zip(got, fa.attention_bwd_ref(q, k, v, o, lse, do)):
        _check(g, w, BF16_TOL)


@pytest.mark.usefixtures("torch_share_of_cores")
def test_bf16_kernels_on_host_at_the_ragged_shape(host_lib):
    """(2, 1000, 3, 64), the ragged shape of chip_smoke.py phases 11 and 14
    (no tile divides N): the bf16 forward and backward of the host build
    against the stock Pallas kernel's plain forward and backward (JAX, f32
    on the same bf16-rounded inputs)."""
    q, k, v, do = (t(a).bfloat16() for a in _inputs((2, 1000, 3, 64),
                                                    seed=1000))
    o, lse = fa._launch(host_lib, q, k, v, 0, want_lse=True)
    ref_o, ref_lse, *ref_grads = _stock_bwd(
        *(x.float().numpy() for x in (q, k, v, do)))
    _check(o, t(ref_o), BF16_TOL)
    assert_close(lse, ref_lse, atol=1e-5, rtol=1e-6)
    got = fa._launch_bwd(host_lib, q, k, v, o, lse, do, 0)
    for g, w in zip(got, ref_grads):
        _check(g, t(w), BF16_TOL)


@pytest.mark.usefixtures("torch_share_of_cores")
def test_host_lse_matches_logsumexp_on_peaked_rows(host_lib):
    q, k, _, _ = (t(a) for a in _inputs((1, 130, 2, 64), seed=4, peak=8.0))
    _, lse = fa._launch(host_lib, q, k, k, 0, want_lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(64)
    assert_close(lse, torch.logsumexp(logits, -1), atol=1e-5, rtol=1e-6)


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_backward_reads_projection_layout_in_place(host_lib, dtype):
    """q, k, v (and do) as views of fused (B, N, 3, H, D) tensors: the
    kernels read them through their strides and equal the contiguous
    call."""
    rng = np.random.default_rng(5)
    b, n, h, d = 1, 70, 2, 64
    qkv = t(randn(rng, b, n, 3, h, d)).to(dtype)
    q, k, v = qkv.unbind(2)
    do = t(randn(rng, b, n, 2, h, d)).to(dtype)[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = fa._launch(host_lib, q, k, v, 0, want_lse=True)
    got = fa._launch_bwd(host_lib, q, k, v, o, lse, do, 0)
    want = fa._launch_bwd(host_lib, *(a.contiguous() for a in (q, k, v)), o,
                          lse, do.contiguous(), 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.usefixtures("torch_share_of_cores")
def test_host_backward_is_bitwise_repeatable(host_lib):
    q, k, v, do = (t(a).bfloat16() for a in _inputs((1, 100, 2, 64), 6))
    o, lse = fa._launch(host_lib, q, k, v, 0, want_lse=True)
    first = fa._launch_bwd(host_lib, q, k, v, o, lse, do, 0)
    again = fa._launch_bwd(host_lib, q, k, v, o, lse, do, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("entry", ["flash_attn_bwd_dkv", "flash_attn_bwd_dq"])
@pytest.mark.parametrize("bhd", [(1, 1, 32), (0, 1, 64), (1, 0, 64)])
def test_host_backward_rejects_what_it_does_not_take(host_lib, entry, bhd):
    b, h, d = bhd
    n_ptrs = 8 if entry.endswith("dkv") else 7
    rc = getattr(host_lib, entry)(*([None] * n_ptrs), b, 64, h, d,
                                  *([0] * 12), 0.125, 1, None)
    assert rc != 0


def test_backward_copies_only_an_unreadable_gradient(monkeypatch):
    """do is passed as it is where the kernels can read it in place, and
    made contiguous where its rows are not."""
    seen = []
    monkeypatch.setattr(fa, "_launch_bwd",
                        lambda lib, q, k, v, o, lse, do, s: seen.append(do))
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    import textualdegremoval_tpu_torch.ops._build as build

    monkeypatch.setattr(build, "load_library", lambda: None)
    x = torch.zeros(1, 8, 2, 64)
    view = torch.zeros(1, 8, 3, 2, 64)[:, :, 1]
    strided = torch.zeros(1, 8, 64, 2).transpose(2, 3)
    for do in (x, view, strided):
        fa._backward_kernel(x, x, x, x, None, do)
    assert seen[0] is x and seen[1] is view
    assert seen[2].is_contiguous() and torch.equal(seen[2], strided)
