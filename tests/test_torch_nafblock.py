"""PyTorch port vs JAX package: the whole-NAFBlock kernel family.

Chain of custody on the CPU, f32 unless stated:
* the port's plain `nafblock_ref` against JAX `nafblock_ref` and against
  the JAX Pallas kernel `_nafblock_impl(..., interpret=True)` (which sends
  an odd height to its plain function);
* the CUDA source csrc/nafblock.cu itself, compiled for the host with
  tests/cuda_host_shim.h, against the port's `nafblock_ref`, through the
  same launch code the CUDA path uses, ragged tiles included;
* `_NAFBlockFunction` (the kernel pair forward, the half-by-half plain
  recompute backward) against plain autograd, with the host build standing
  in for the card.
The on-card checks are in tests/test_torch_nafblock_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.ops.pallas import nafblock as jnb

import textualdegremoval_tpu_torch.ops.pallas.nafblock as nb

from torch_port_util import (  # noqa: F401  (a fixture)
    randn, t, assert_close, build_host_library, torch_share_of_cores,
)

# bf16 kernel vs plain: the kernel rounds the dwconv once (f32 taps, bias
# added in f32), the plain path casts the taps and rounds the conv and the
# bias add; the two differ by a few bf16 ulps (2^-7 relative) of values
# that reach |out| <= 8.
BF16_ATOL, BF16_RTOL = 1e-1, 5e-2


def _params(c, seed):
    """Natural-shape (JAX layout) block parameters as numpy arrays at a
    trained block's scale: activations O(1), the SCA scale between about
    0.5 and 1.5, beta and gamma non-zero (at their zero init both residual
    branches vanish)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: randn(rng, *s, scale=s[-2] ** -0.5)  # noqa: E731
    return dict(
        norm1_w=1 + randn(rng, c, scale=0.1), norm1_b=randn(rng, c, scale=0.1),
        w1=w(1, 1, c, 2 * c), b1=randn(rng, 2 * c, scale=0.1),
        dw=randn(rng, 3, 3, 1, 2 * c, scale=1 / 3),
        dwb=randn(rng, 2 * c, scale=0.1),
        sca_w=w(1, 1, c, c), sca_b=1 + randn(rng, c, scale=0.3),
        w3=w(1, 1, c, c), b3=randn(rng, c, scale=0.1),
        beta=randn(rng, 1, 1, 1, c, scale=0.7),
        norm2_w=1 + randn(rng, c, scale=0.1), norm2_b=randn(rng, c, scale=0.1),
        w4=w(1, 1, c, 2 * c), b4=randn(rng, 2 * c, scale=0.1),
        w5=w(1, 1, c, c), b5=randn(rng, c, scale=0.1),
        gamma=randn(rng, 1, 1, 1, c, scale=0.7))


def _torch_params(p):
    return {k: t(v) for k, v in p.items()}


# tests/test_pallas_nafblock.py's shapes, plus an odd height
_SHAPES = [(1, 8, 16, 8), (1, 16, 16, 8), (2, 24, 16, 16), (1, 12, 16, 8),
           (1, 7, 16, 8)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_nafblock_ref_matches_jax_ref(shape):
    p = _params(shape[-1], seed=shape[1])
    x = randn(np.random.default_rng(shape[2]), *shape)
    got = nb.nafblock_ref(t(x), _torch_params(p))
    assert_close(got, jnb.nafblock_ref(jnp.asarray(x), p))


@pytest.mark.parametrize("shape", _SHAPES)
def test_nafblock_ref_matches_jax_pallas_interpret(shape):
    p = _params(shape[-1], seed=shape[1] + 1)
    x = randn(np.random.default_rng(shape[1] + 2), *shape)
    got = nb.nafblock_ref(t(x), _torch_params(p))
    want = jnb._nafblock_impl(jnp.asarray(x), p, interpret=True)
    # the interpreted kernel sums the SCA pool and the products in row
    # tiles; its own test holds it to nafblock_ref at 3e-5
    assert_close(got, want, atol=3e-5, rtol=3e-5)


def test_nafblock_ref_bf16_matches_jax_bf16():
    """bf16 activations over f32 parameters on both sides, each weight cast
    at use: the two frameworks round the same ops, in other sum orders, so
    an output of magnitude <= 8 may differ by about one bf16 ulp there
    (2^-5): bound 0.05 absolute and 5e-3 relative in L2."""
    p = _params(16, seed=3)
    x = randn(np.random.default_rng(4), 2, 12, 16, 16)
    got = nb.nafblock_ref(t(x).bfloat16(), _torch_params(p)).float().numpy()
    want = np.asarray(jnb.nafblock_ref(jnp.asarray(x, jnp.bfloat16), p)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
    assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)


def test_cpu_tensor_takes_plain_path_without_launching():
    p = _torch_params(_params(8, seed=5))
    x = t(randn(np.random.default_rng(6), 1, 6, 5, 8))
    before = nb.nafblock_fused.launches
    got = nb.nafblock_fused(x, p)
    assert nb.nafblock_fused.launches == before == 0
    assert torch.equal(got, nb.nafblock_ref(x, p))


@pytest.fixture(scope="module")
def host_kernel_lib(tmp_path_factory):
    """csrc/nafblock.cu compiled for the CPU against tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_nafblock"),
                              ("nafblock.cu",))


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("shape,sum_tile,apply_tile,nsplit,dtype", [
    ((1, 8, 16, 8), (8, 16), (8, 16), 1, torch.float32),  # every edge
    ((2, 11, 13, 16), (4, 8), (4, 4), 3, torch.float32),  # ragged, batch 2
    ((1, 7, 9, 12), (2, 2), (1, 2), 4, torch.float32),    # C not a chunk
    ((1, 5, 6, 40), (8, 8), (8, 16), 2, torch.float32),   # tile > image
    ((2, 11, 13, 16), (4, 8), (4, 4), 3, torch.bfloat16),
    ((1, 7, 9, 12), (2, 2), (1, 2), 4, torch.bfloat16),   # FMA products
    # widths where every bf16 product runs on the tensor-core path, one
    # of them over two gate chunks
    ((1, 9, 10, 32), (2, 4), (4, 4), 2, torch.bfloat16),
    ((1, 6, 7, 48), (4, 8), (2, 4), 1, torch.bfloat16),
])
def test_cuda_source_on_host_matches_ref(host_kernel_lib, shape, sum_tile,
                                         apply_tile, nsplit, dtype):
    p = _torch_params(_params(shape[-1], seed=shape[2]))
    x = t(randn(np.random.default_rng(shape[1]), *shape)).to(dtype)
    kw = nb.prepare_nafblock_weights(p, dtype)
    got = nb._launch(host_kernel_lib, x, kw, sum_tile, apply_tile, nsplit, 0)
    want = nb.nafblock_ref(x, p)
    if dtype == torch.float32:
        assert_close(got, want)
    else:
        assert_close(got.float(), want.float(), atol=BF16_ATOL,
                     rtol=BF16_RTOL)
        # the bound chip_smoke.py puts on the error against what the block
        # adds to its input
        err = (got.float() - want.float()).norm()
        assert err <= 2e-2 * (want.float() - x.float()).norm()


def test_host_kernel_reports_bad_shapes(host_kernel_lib):
    def apply(c, cpad):
        return host_kernel_lib.nafblock_apply(*([None] * 16), 1, 4, 4, c,
                                              cpad, 0, 2, 2, None)
    assert apply(40, 40) != 0   # the gate not padded to the chunk
    assert apply(40, 32) != 0   # padded below C
    assert host_kernel_lib.nafblock_sum(*([None] * 8), 1, 4, 4, 8, 32, 0, 2,
                                        2, 0, None) != 0  # no split


@pytest.mark.usefixtures("torch_share_of_cores")
@pytest.mark.parametrize("c", [8, 16])
def test_autograd_function_matches_plain_autograd(host_kernel_lib,
                                                  monkeypatch, c):
    """`_NAFBlockFunction`, with the host build of the kernel as its
    forward: a graph whose backward recomputes through the plain version
    one half at a time gives plain autograd's gradients (the same f32 ops
    in the same order, so to 1e-5), for the input and every parameter,
    through the natural-shape views onto module-shaped parameters."""
    monkeypatch.setattr(nb, "_forward_kernel", lambda x, kw: nb._launch(
        host_kernel_lib, x, kw, (4, 4), (2, 4), 2, 0))
    p0 = _torch_params(_params(c, seed=7))
    x0 = t(randn(np.random.default_rng(8), 2, 9, 11, c))
    g = t(randn(np.random.default_rng(9), 2, 9, 11, c))
    grads = []
    for fused in (True, False):
        x = x0.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        if fused:
            keys = tuple(p)
            out = nb._NAFBlockFunction.apply(
                x, nb.prepare_nafblock_weights(p, x.dtype), keys,
                *(p[k] for k in keys))
            assert out.grad_fn is not None
        else:
            out = nb.nafblock_ref(x, p)
        out.backward(g)
        grads.append({"x": x.grad, **{k: v.grad for k, v in p.items()}})
    for k, want in grads[1].items():
        assert grads[0][k] is not None, k
        assert_close(grads[0][k], want, atol=1e-5, rtol=1e-5)
