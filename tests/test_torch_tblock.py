"""PyTorch port vs JAX package: the whole-TransformerBlock kernel family.

Chain of custody on the CPU, f32:
* the port's plain `tblock_ref` against JAX `tblock_ref` and against the
  JAX Pallas kernel `_tblock_impl(..., interpret=True)`;
* the port's glue `_attn_matrix` against the JAX glue;
* the CUDA source csrc/tblock.cu itself, compiled for the host with
  tests/cuda_host_shim.h (one std::thread per CUDA thread), against the
  port's `tblock_ref`, through the same launch code the CUDA path uses;
* TransformerBlock / TransformerResFusionBlock modules against the JAX
  modules.
The on-card checks are in tests/test_torch_tblock_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.models.layers import (
    TransformerBlock as JTransformerBlock,
    TransformerResFusionBlock as JTransformerResFusionBlock,
)
from textualdegremoval_tpu.ops.pallas import tblock as jtb

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
from textualdegremoval_tpu_torch.models.layers import (
    TransformerBlock, TransformerResFusionBlock,
)

from torch_port_util import (
    randn, t, randomize, jax_tree, assert_close, build_host_library,
)

# bf16 kernel vs plain: the kernel rounds the GDFN gate once in f32, the
# plain path rounds the dwconv output and the gelu product in bf16, so the
# two differ by a few bf16 ulps of the output (ulp 2^-7 relative).
BF16_ATOL, BF16_RTOL = 1e-1, 5e-2


def _params(c, heads, ln_type, seed):
    """Natural-shape (JAX layout) block parameters as numpy arrays, scaled
    like a trained block so activations stay O(1)."""
    rng = np.random.default_rng(seed)
    h = int(c * 2.66)
    p = dict(
        norm1_w=1 + randn(rng, c, scale=0.1), norm2_w=1 + randn(rng, c, scale=0.1),
        qkv=randn(rng, 1, 1, c, 3 * c, scale=c ** -0.5),
        qkv_dw=randn(rng, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=(1 + 0.3 * np.arange(heads, dtype=np.float32)).reshape(
            heads, 1, 1),
        proj=randn(rng, 1, 1, c, c, scale=c ** -0.5),
        gd_in=randn(rng, 1, 1, c, 2 * h, scale=c ** -0.5),
        gd_dw=randn(rng, 3, 3, 1, 2 * h, scale=1 / 3),
        gd_out=randn(rng, 1, 1, h, c, scale=h ** -0.5))
    if ln_type == "WithBias":
        p["norm1_b"] = randn(rng, c, scale=0.1)
        p["norm2_b"] = randn(rng, c, scale=0.1)
    return p


def _torch_params(p):
    return {k: t(v) for k, v in p.items()}


@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
@pytest.mark.parametrize("shape,heads", [
    ((1, 7, 9, 8), 1),     # H and W odd: no tile divides them
    ((2, 11, 13, 16), 2),  # batch 2, two heads, ragged
])
def test_tblock_ref_matches_jax_ref(shape, heads, ln_type):
    p = _params(shape[-1], heads, ln_type, seed=shape[1])
    x = randn(np.random.default_rng(shape[2]), *shape)
    got = tb.tblock_ref(t(x), _torch_params(p), heads, ln_type)
    assert_close(got, jtb.tblock_ref(jnp.asarray(x), p, heads, ln_type))


@pytest.mark.parametrize("shape,heads,ln_type", [
    ((1, 8, 16, 8), 2, "WithBias"),    # one row tile: both edge masks
    ((2, 16, 16, 16), 2, "BiasFree"),  # batch 2, two row tiles
    ((1, 12, 16, 8), 1, "WithBias"),   # H forces the TPU tile to 4 rows
])
def test_tblock_ref_matches_jax_pallas_interpret(shape, heads, ln_type):
    p = _params(shape[-1], heads, ln_type, seed=shape[1] + 1)
    x = randn(np.random.default_rng(shape[1] + 2), *shape)
    got = tb.tblock_ref(t(x), _torch_params(p), heads, ln_type)
    want = jtb._tblock_impl(jnp.asarray(x), p, heads, ln_type, interpret=True)
    # the interpreted kernel sums the gram and the GDFN in row tiles; its
    # own test holds it to tblock_ref at 3e-5
    assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_attn_matrix_matches_jax(heads):
    rng = np.random.default_rng(heads)
    b, c = 2, 16
    cph = c // heads
    gram = randn(rng, b, c, c, scale=5.0)
    qs = rng.random((b, 1, c)).astype(np.float32) * 50
    ks = rng.random((b, 1, c)).astype(np.float32) * 50
    temp = (1 + 0.3 * np.arange(heads, dtype=np.float32)).reshape(heads, 1, 1)
    want = np.asarray(jtb._attn_matrix(gram, qs, ks, temp, heads,
                                       jnp.float32))
    diag = np.stack([gram[:, h * cph:(h + 1) * cph, h * cph:(h + 1) * cph]
                     for h in range(heads)], axis=1)
    got = tb._attn_matrix(t(diag), t(qs[:, 0]), t(ks[:, 0]),
                          t(temp.reshape(-1)), heads, torch.float32)
    for h in range(heads):
        sl = slice(h * cph, (h + 1) * cph)
        assert_close(got[:, h], want[:, sl, sl])


def test_cpu_tensor_takes_plain_path_without_launching():
    p = _torch_params(_params(8, 2, "WithBias", seed=3))
    x = t(randn(np.random.default_rng(4), 1, 6, 5, 8))
    before = tb.tblock_fused.launches
    got = tb.tblock_fused(x, p, 2, "WithBias")
    assert tb.tblock_fused.launches == before == 0
    assert torch.equal(got, tb.tblock_ref(x, p, 2, "WithBias"))


@pytest.fixture(scope="module")
def host_kernel_lib(tmp_path_factory):
    """csrc/tblock.cu compiled for the CPU against tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_kernel"),
                              ("tblock.cu",))


_HOST_CASES = [
    ((1, 8, 16, 8), 2, (8, 16), (8, 16), 1),   # one tile holds every edge
    ((2, 11, 13, 16), 2, (4, 8), (4, 4), 3),   # ragged tiles, batch 2
    ((1, 7, 9, 12), 1, (2, 2), (1, 2), 4),     # odd hidden width (31)
    ((1, 5, 6, 32), 4, (8, 32), (8, 16), 2),   # tile larger than the image
]


@pytest.mark.parametrize("shape,heads,stats_tile,apply_tile,nsplit,ln_type,"
                         "dtype", [
    *[(*case, ln, torch.float32) for case in _HOST_CASES
      for ln in ("WithBias", "BiasFree")],
    *[(*case, "WithBias", torch.bfloat16) for case in _HOST_CASES[:2]],
    # widths where every bf16 product runs on the tensor-core path
    ((1, 9, 10, 32), 2, (4, 4), (2, 4), 2, "BiasFree", torch.bfloat16),
    ((1, 6, 7, 16), 1, (8, 16), (8, 8), 1, "WithBias", torch.bfloat16),
])
def test_cuda_source_on_host_matches_ref(host_kernel_lib, shape, heads,
                                         stats_tile, apply_tile, nsplit,
                                         ln_type, dtype):
    p = _torch_params(_params(shape[-1], heads, ln_type, seed=shape[2]))
    x = t(randn(np.random.default_rng(shape[1]), *shape)).to(dtype)
    kw = tb.prepare_tblock_weights(p, dtype, ln_type)
    got, x1, stats = tb._launch(host_kernel_lib, x, kw, heads, ln_type,
                                stats_tile, apply_tile, nsplit, 0,
                                want_x1=True)
    want = tb.tblock_ref(x, p, heads, ln_type)
    want_x1 = tb._tblock_attn_part(x, p, heads, ln_type)
    if dtype == torch.float32:
        assert_close(got, want)
        assert_close(x1, want_x1)
    else:
        assert_close(got.float(), want.float(), atol=BF16_ATOL,
                     rtol=BF16_RTOL)
        assert_close(x1.float(), want_x1.float(), atol=BF16_ATOL,
                     rtol=BF16_RTOL)
    # the saved statistics: per-head gram and q/k square sums, f32
    assert stats[0].shape == (shape[0], heads, shape[-1] // heads,
                              shape[-1] // heads)
    assert stats[1].shape == stats[2].shape == (shape[0], shape[-1])


def test_host_kernel_reports_bad_shapes(host_kernel_lib):
    rc = host_kernel_lib.tblock_apply(*([None] * 14), 1, 4, 4, 8, 3, 32, 0, 0,
                                      2, 2, None)
    assert rc != 0  # C not divisible by heads
    rc = host_kernel_lib.tblock_apply(*([None] * 14), 1, 4, 4, 8, 2, 30, 0, 0,
                                      2, 2, None)
    assert rc != 0  # hidden not padded to the chunk


@pytest.mark.parametrize("fusion", [False, True])
@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_block_modules_match_jax(fusion, ln_type):
    cls, jcls = ((TransformerResFusionBlock, JTransformerResFusionBlock)
                 if fusion else (TransformerBlock, JTransformerBlock))
    blk = randomize(cls(16, 2, ln_type=ln_type), seed=5, scale=0.2)
    if fusion:  # zero-initialised in a fresh block; make the gate count
        with torch.no_grad():
            blk.alpha.fill_(0.7)
    x = randn(np.random.default_rng(6), 2, 6, 7, 16)
    want = jcls(16, 2, ln_type=ln_type, fused=False).apply(
        {"params": jax_tree(blk, "blk")}, jnp.asarray(x))
    assert_close(blk(t(x)), want)
    assert_close(blk.module_forward(t(x)), want)
