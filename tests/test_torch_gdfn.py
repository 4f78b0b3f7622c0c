"""PyTorch port vs JAX package: the standalone GDFN kernel (B6).

Chain of custody on the CPU, f32 unless stated:
* the port's plain `gdfn_ref` against JAX `gdfn_ref` and against the JAX
  Pallas kernel `_gdfn_fused_impl(..., interpret=True)`, as
  tests/test_pallas_gdfn.py runs it;
* the CUDA source csrc/gdfn.cu itself, compiled for the host with
  tests/cuda_host_shim.h, against the port's `gdfn_ref`, through the same
  launch code the CUDA path uses, and its gradient route
  (`_GdfnFunction`: the kernel forward, the backward through `gdfn_ref`)
  against autograd through `gdfn_ref`;
* the GDFN module with fused=True against the JAX module.
The on-card checks are in tests/test_torch_gdfn_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.models.layers import GDFN as JGDFN
from textualdegremoval_tpu.ops.pallas import gdfn as jgd

import textualdegremoval_tpu_torch.ops.pallas.gdfn as gd
from textualdegremoval_tpu_torch.models.layers import GDFN

from torch_port_util import (
    randn, t, randomize, jax_tree, assert_close, build_host_library,
)

# bf16 kernel vs plain: the kernel keeps the depthwise sums and the gate
# in f32 and rounds where the JAX kernel does, the plain version after
# every op, so the two differ by a few bf16 ulps of the output (2^-8
# relative); on the host build at these shapes at most 0.6% of max|p|.
BF16_ATOL, BF16_RTOL = 3e-2, 3e-2


def _weights(c, seed):
    """(w1 (C, 2h), dwk (3, 3, 2h), w2 (h, C)) at a trained block's scale,
    as numpy arrays."""
    rng = np.random.default_rng(seed)
    h = int(c * 2.66)
    return (randn(rng, c, 2 * h, scale=c ** -0.5),
            randn(rng, 3, 3, 2 * h, scale=1 / 3),
            randn(rng, h, c, scale=h ** -0.5))


@pytest.mark.parametrize("shape", [(1, 7, 9, 8), (2, 6, 5, 16)])
def test_gdfn_ref_matches_jax_ref(shape):
    ws = _weights(shape[-1], seed=shape[1])
    x = randn(np.random.default_rng(shape[2]), *shape)
    got = gd.gdfn_ref(t(x), *map(t, ws))
    assert_close(got, jgd.gdfn_ref(jnp.asarray(x), *map(jnp.asarray, ws)))


@pytest.mark.parametrize("shape", [
    (1, 8, 16, 8),    # one row tile of 8
    (2, 12, 8, 16),   # batch 2, H forces 4-row tiles
    (1, 7, 6, 12),    # odd H: 1-row tiles; hidden 31, padded
])
def test_gdfn_ref_matches_jax_pallas_interpret(shape):
    ws = _weights(shape[-1], seed=shape[1] + 1)
    x = randn(np.random.default_rng(shape[1] + 2), *shape)
    got = gd.gdfn_ref(t(x), *map(t, ws))
    want = jgd._gdfn_fused_impl(jnp.asarray(x), *map(jnp.asarray, ws),
                                interpret=True)
    # f32, sums in other orders (row tiles, 128-wide hidden chunks)
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_plain_path_without_launching():
    ws = [t(w) for w in _weights(8, seed=3)]
    x = t(randn(np.random.default_rng(4), 1, 6, 5, 8))
    before = gd.gdfn_fused.launches
    got = gd.gdfn_fused(x, *ws)
    assert gd.gdfn_fused.launches == before == 0
    assert torch.equal(got, gd.gdfn_ref(x, *ws))


def test_prepared_weights_pad_the_hidden_with_zeros():
    """h = 127 (C = 48) pads to 128: the padded w1 columns, taps and w2
    rows are zero, so the padded channel adds gelu(0) * 0 = 0."""
    w1, dwk, w2 = map(t, _weights(48, seed=5))
    w1s, dwg, w2s, hpad = gd.pad_gdfn_weights(w1, dwk, w2)
    assert hpad == 128 and w1s.shape == (48, 256) and w2s.shape == (128, 48)
    assert not w2s[127].any() and not dwg[:, 127].any()
    # the last chunk's h1 column 31 and h2 column 31 are the padding
    assert not w1s[:, 3 * 64 + 31].any() and not w1s[:, 3 * 64 + 63].any()
    assert torch.equal(w1s[:, 64 + 32:64 + 64], w1[:, 127 + 32:127 + 64])


@pytest.fixture(scope="module")
def host_gdfn_lib(tmp_path_factory):
    """csrc/gdfn.cu compiled for the CPU against tests/cuda_host_shim.h
    (tblock.cu too, for the error strings)."""
    return build_host_library(tmp_path_factory.mktemp("host_gdfn"),
                              ("gdfn.cu", "tblock.cu"))


@pytest.mark.parametrize("shape,tile,dtype", [
    ((1, 7, 9, 8), (4, 4), torch.float32),     # ragged tiles, hidden 21
    ((2, 5, 11, 48), (8, 8), torch.float32),   # hidden 127, tile > image
    ((1, 9, 10, 12), (2, 4), torch.float32),   # hidden 31
    ((1, 3, 5, 16), (1, 2), torch.float32),    # smallest tiles
    ((1, 6, 7, 48), (4, 8), torch.bfloat16),   # bf16 on the tensor cores
    ((2, 5, 9, 16), (4, 4), torch.bfloat16),
])
def test_cuda_source_on_host_matches_ref(host_gdfn_lib, shape, tile, dtype):
    ws = [t(w) for w in _weights(shape[-1], seed=shape[2])]
    x = t(randn(np.random.default_rng(shape[1]), *shape)).to(dtype)
    kw = gd.prepare_gdfn_weights(*ws, dtype)
    got = gd._launch(host_gdfn_lib, x, kw, tile, 0)
    want = gd.gdfn_ref(x, *ws)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert_close(got, want)
    else:
        assert_close(got.float(), want.float(),
                     atol=BF16_ATOL * want.float().abs().max().item(),
                     rtol=BF16_RTOL)


def test_host_kernel_reports_bad_shapes(host_gdfn_lib):
    # the hidden not padded to the chunk
    assert host_gdfn_lib.gdfn_fwd(*([None] * 5), 1, 4, 4, 8, 30, 0, 2, 2,
                                  None) != 0
    # an empty tile
    assert host_gdfn_lib.gdfn_fwd(*([None] * 5), 1, 4, 4, 8, 32, 0, 0, 2,
                                  None) != 0


def test_gradient_route_on_host_matches_autograd(host_gdfn_lib,
                                                 monkeypatch):
    """`_GdfnFunction` with the host build as its forward: the output is
    the kernel's, the gradients those of autograd through `gdfn_ref` (the
    backward recomputes through it, as JAX's `_bwd` does)."""
    monkeypatch.setattr(gd, "_forward_kernel", lambda x, kw: gd._launch(
        host_gdfn_lib, x, kw, (4, 4), 0))
    ws = [t(w).requires_grad_(True) for w in _weights(16, seed=6)]
    x = t(randn(np.random.default_rng(7), 2, 6, 7, 16)).requires_grad_(True)
    g = t(randn(np.random.default_rng(8), 2, 6, 7, 16))
    kw = gd.prepare_gdfn_weights(*[w.detach() for w in ws], torch.float32)
    y = gd._GdfnFunction.apply(x, kw, *ws)
    got = torch.autograd.grad(y, [x, *ws], g)
    want = torch.autograd.grad(gd.gdfn_ref(x, *ws), [x, *ws], g)
    assert_close(y.detach(), gd.gdfn_ref(x, *ws).detach())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c", [12, 16])
def test_fused_module_matches_jax(c):
    m = randomize(GDFN(c, fused=True), seed=9, scale=0.3)
    x = randn(np.random.default_rng(10), 2, 6, 8, c)
    # JAX GDFN(fused=True) takes gdfn_ref off the TPU; same parameters
    want = JGDFN(c, fused=True).apply({"params": jax_tree(m, "ffn")},
                                      jnp.asarray(x))
    assert_close(m(t(x)), want)
    # and the op-by-op module path of the same weights
    m.fused = False
    assert_close(m(t(x)), want)


def test_fused_module_refuses_biases():
    with pytest.raises(ValueError, match="biases"):
        GDFN(8, bias=True, fused=True)
    with pytest.raises(ValueError, match="bool"):
        GDFN(8, fused="on")
