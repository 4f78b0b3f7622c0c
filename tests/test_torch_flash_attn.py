"""PyTorch port vs JAX package: the self-attention routing and the flash
kernel (B4).

On the CPU, f32 unless stated:
* `flash_applies` equals the JAX predicate over a grid of shapes;
* `attention_ref` and `self_attention` equal JAX `self_attention` with
  use_flash=False (`jax.nn.dot_product_attention`), at a flash-shaped input
  and at others, causal too (the CLIP text tower's);
* the CUDA source csrc/flash_attn.cu itself, compiled for the host with
  tests/cuda_host_shim.h, against `attention_ref` through the launch code
  the CUDA path uses: head_dim 64 and 128, ragged N, peaked logits, bf16
  and f32, strided projection layouts, bitwise repeatability;
* `_FlashAttention` with the host build standing in for the card: the
  gradients of q, k and v through the forward and backward kernels equal
  autograd's through `attention_ref`.
The backward's own checks are in tests/test_torch_flash_attn_bwd.py, the
on-card checks in tests/test_torch_flash_attn_cuda.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.ops import flash_attn as jfa

import textualdegremoval_tpu_torch.ops.flash_attn as fa

from torch_port_util import (  # noqa: F401  (a fixture)
    randn, t, assert_close, build_host_library, torch_share_of_cores,
)


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256])
def test_flash_applies_matches_jax(head_dim):
    for q_seq, kv_seq in itertools.product(
            (77, 1024, 1536, 2048, 2560, 3000, 4096), (77, 2048, 4096)):
        assert fa.flash_applies(q_seq, kv_seq, head_dim) == \
            jfa.flash_applies(q_seq, kv_seq, head_dim), (q_seq, kv_seq)


def _qkv(shape, seed, peak=1.0):
    """q, k, v of `shape` (B, N, H, D); q and k scaled so that the logits
    q.k / sqrt(D) have a standard deviation of about `peak`."""
    rng = np.random.default_rng(seed)
    s = peak ** 0.5
    return (randn(rng, *shape, scale=s), randn(rng, *shape, scale=s),
            randn(rng, *shape))


# (1, 2048, 1, 64) passes flash_applies; the others do not
@pytest.mark.parametrize("shape", [(1, 2048, 1, 64), (2, 77, 4, 16),
                                   (1, 100, 2, 32), (2, 64, 5, 64)])
@pytest.mark.parametrize("use_flash", [False, True])
def test_self_attention_matches_jax(shape, use_flash):
    q, k, v = _qkv(shape, seed=shape[1], peak=3.0)
    got = fa.self_attention(t(q), t(k), t(v), use_flash=use_flash)
    want = jfa.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              use_flash=False)
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_attention_ref_causal_matches_jax():
    q, k, v = _qkv((2, 16, 4, 16), seed=1, peak=3.0)
    got = fa.attention_ref(t(q), t(k), t(v), causal=True)
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), is_causal=True)
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_attention_ref_bf16_matches_jax_bf16():
    """bf16 q, k, v on both sides: f32 logits and softmax, probabilities
    rounded to bf16, the PV product in bf16; outputs of magnitude <= 3 may
    differ by one bf16 ulp (2^-6 there) from other sum orders."""
    q, k, v = _qkv((1, 64, 2, 64), seed=2, peak=3.0)
    got = fa.attention_ref(*(t(a).bfloat16() for a in (q, k, v)))
    want = jax.nn.dot_product_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -6, rtol=0)


def test_cpu_tensor_takes_plain_path_without_launching():
    q, k, v = (t(a) for a in _qkv((1, 2048, 1, 64), seed=3))
    before = fa.flash_attention.launches
    got = fa.self_attention(q, k, v, use_flash=True)
    assert fa.flash_attention.launches == before == 0
    assert torch.equal(got, fa.attention_ref(q, k, v))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/flash_attn.cu and csrc/flash_attn_bwd.cu compiled for the CPU
    against tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_flash"),
                              ("flash_attn.cu", "flash_attn_bwd.cu"))


# bf16 kernel vs plain: the kernel rounds the unnormalised probabilities
# to bf16 for the PV product and divides by the f32 row sum at the end;
# the plain path rounds the normalised probabilities and the output.  Both
# are within about one bf16 ulp of the f32 result (outputs |o| <= 3 here):
# 2^-6 absolute plus 2^-7 relative.
BF16_ATOL, BF16_RTOL = 2 ** -6, 2 ** -7


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("shape,peak", [
    ((1, 64, 1, 64), 1.0),     # one tile
    ((1, 70, 2, 64), 3.0),     # ragged N: a second tile of 6 keys and rows
    ((2, 130, 1, 128), 3.0),   # head_dim 128, three tiles
    ((1, 200, 3, 64), 6.0),    # peaked rows: the running max moves
    ((2, 5, 2, 128), 3.0),     # N below one tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_source_on_host_matches_ref(host_lib, shape, peak, dtype):
    q, k, v = (t(a).to(dtype) for a in _qkv(shape, seed=shape[1], peak=peak))
    got = fa._launch(host_lib, q, k, v, 0)
    want = fa.attention_ref(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert_close(got.float(), want.float(), atol=BF16_ATOL,
                     rtol=BF16_RTOL)


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_kernel_reads_projection_layout_in_place(host_lib, dtype):
    """q, k, v as views of one fused (B, N, 3, H, D) projection: the kernel
    reads them through their strides and equals the contiguous call."""
    b, n, h, d = 2, 90, 2, 64
    qkv = t(randn(np.random.default_rng(7), b, n, 3, h, d)).to(dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = fa._launch(host_lib, q, k, v, 0)
    want = fa._launch(host_lib, *(a.contiguous() for a in (q, k, v)), 0)
    assert torch.equal(got, want)


@pytest.mark.usefixtures("torch_share_of_cores")
def test_host_kernel_is_bitwise_repeatable(host_lib):
    q, k, v = (t(a).bfloat16() for a in _qkv((1, 100, 2, 64), seed=8,
                                              peak=3.0))
    assert torch.equal(fa._launch(host_lib, q, k, v, 0),
                       fa._launch(host_lib, q, k, v, 0))


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("n", [64, 65, 200])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_kernel_on_host_at_tile_edges(host_lib, n, d):
    """The bf16 kernel at its tile edges: N of one 64-row box, one row
    past it, and a ragged third 64-row box of the second 128-key tile (the
    TMA loads' zero fill, the last tile's key mask, query rows not
    written); D = 128 reads two boxes a row."""
    q, k, v = (t(a).bfloat16() for a in _qkv((1, n, 2, d), seed=n + d,
                                              peak=3.0))
    got = fa._launch(host_lib, q, k, v, 0)
    assert_close(got.float(), fa.attention_ref(q, k, v).float(),
                 atol=BF16_ATOL, rtol=BF16_RTOL)


def test_host_kernel_rejects_bad_head_dim(host_lib):
    rc = host_lib.flash_attn_fwd(*([None] * 5), 1, 64, 1, 32, *([0] * 9),
                                 0.125, 1, None)
    assert rc != 0


def test_validate_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa._validate(q, q, q)
    with pytest.raises(ValueError, match="shape"):
        fa._validate(q, torch.zeros(1, 9, 1, 32), q)
    q64 = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="device"):
        fa._validate(q64, q64, q64)


@pytest.mark.usefixtures("torch_share_of_cores")
def test_gradient_through_host_kernels_matches_attention_ref(host_lib,
                                                             monkeypatch):
    """The autograd.Function of the CUDA path, with the host build of both
    sources standing in for the card: the forward saves o and lse, the
    backward launches dkv and dq on the incoming gradient, and q, k, v get
    autograd's gradients through `attention_ref`."""
    import textualdegremoval_tpu_torch.ops._build as build

    monkeypatch.setattr(build, "load_library", lambda: host_lib)
    monkeypatch.setattr(fa, "_validate", lambda q, k, v: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    q, k, v = (t(a) for a in _qkv((1, 70, 2, 64), 9, peak=3.0))
    w = t(randn(np.random.default_rng(10), 1, 70, 2, 64))
    qa, ka, va = (a.clone().requires_grad_(True) for a in (q, k, v))
    before = fa.flash_attention.launches_bwd
    out = fa._FlashAttention.apply(qa, ka, va)
    (out * w).sum().backward()
    assert fa.flash_attention.launches_bwd == before + 1
    qr, kr, vr = (a.clone().requires_grad_(True) for a in (q, k, v))
    (fa.attention_ref(qr, kr, vr) * w).sum().backward()
    assert_close(out.detach(), fa.attention_ref(q, k, v))
    for got, want in ((qa, qr), (ka, kr), (va, vr)):
        assert_close(got.grad, want.grad, atol=1e-5, rtol=1e-4)



def test_bench_flash_compares_ptxas_reports_without_paths_or_times():
    """The B4 tool's ptxas comparison: two builds of the same source from
    other directories differ only in the anonymous namespace's path hash
    and the compile time, and compare equal; a changed register count
    does not."""
    from textualdegremoval_tpu_torch.tools.bench_flash import ptxas_reports

    def log(ns, ms, regs):
        return (f"== tblock.cu\nptxas info    : Compiling entry function "
                f"'_ZN46_GLOBAL__N__{ns}_9_tblock_cu_{ns}12tblock_applyEv' "
                f"for 'sm_90a'\nptxas info    : Used {regs} registers\n"
                f"ptxas info    : Compile time = {ms} ms\n")

    a = ptxas_reports(log("98bedfd3", "12.5", 128))
    assert a == ptxas_reports(log("0449ce15", "40.1", 128))
    assert "12tblock_apply" in a["tblock.cu"]
    assert a != ptxas_reports(log("0449ce15", "40.1", 136))
