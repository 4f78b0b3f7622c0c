"""PyTorch port vs JAX package: the bf16 cross-block chain on the block
pipeline, the chain's gradients, and the whole-block kernel at PromptIR's
widths (the rest of tests/test_torch_tblock_chain.py, whose helpers and
host build this file shares).

On the CPU:
* csrc/tblock.cu at 40, 80 and 176 channels per head, compiled for the
  host with tests/cuda_host_shim.h, against the plain block, with the
  tiles that the CUDA path picks;
* the bf16 chain on the pipeline (`chain_pipeline`: the block pipeline's
  kernels with csrc/bwd_gemm.cu's chain epilogue at each boundary), host
  build, against the plain chain within phase 3's bounds times sqrt(n),
  against `tblock_pipeline` run block by block, bitwise repeatable, and
  against JAX's `_tblock_chain_impl` run op by op in bf16; the route rule
  of `_chain_kernel`;
* `_TBlockChainFunction`'s gradients (forward through the host build,
  backward through the plain chain) against JAX `tblock_chain_fused`'s.
The on-card checks are in tests/test_torch_tblock_chain_cuda.py.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import textualdegremoval_tpu.ops.pallas.tblock as jtb

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb

from test_torch_tblock import _params, _torch_params
from test_torch_tblock_chain import (  # noqa: F401 (host_lib: a fixture)
    _chain_inputs, _close, host_lib,
)
from test_torch_tblock_fwd import (
    JAX_ATOL, JAX_BRANCH, JAX_RTOL, REF_ATOL, REF_BRANCH, REF_RTOL, _branch,
    _eager_pallas_call, _j,
)
from torch_port_util import assert_close, randn, t

BF = torch.bfloat16


@pytest.mark.parametrize("c,dtype", [
    (160, torch.float32),    # cph 40: o = v A^T on the FMA loops
    (160, torch.bfloat16),
    (320, torch.bfloat16),   # cph 80
    (704, torch.bfloat16),   # cph 176, PromptIR's noise_level3
    (704, torch.float32),
])
def test_block_source_on_host_at_promptir_widths(host_lib, c, dtype):
    """The whole-block kernel at PromptIR's noise-block widths (4 heads),
    with the tiles that the CUDA path picks from shared memory."""
    heads = 4
    p = _torch_params(_params(c, heads, "WithBias", seed=c))
    x = t(randn(np.random.default_rng(c), 1, 3, 5, c)).to(dtype)
    kw = tb.prepare_tblock_weights(p, dtype, "WithBias")
    eb = x.element_size()

    def pick(tiles, pass_id):
        return tb._first_fit(tiles, lambda tt: host_lib.tblock_smem_bytes(
            pass_id, c, heads, tt[0], tt[1], eb), "test")

    got = tb._launch(host_lib, x, kw, heads, "WithBias",
                     pick(tb._STATS_TILES, 0), pick(tb._APPLY_TILES, 1), 2, 0)
    _close(got, tb.tblock_ref(x, p, heads, "WithBias"), dtype)


def test_tiles_at_promptir_widths(host_lib):
    """With the cap lifted to 192 channels per head, the f32 gram of one
    head at cph 176 (124 KB) leaves pass A the 4 x 4 tile in bf16 and the
    2 x 2 in f32; the chain kernel finds a tile at every stage width."""
    assert host_lib.tblock_max_cph() == 192

    def stats_tile(c, eb):
        return tb._first_fit(tb._STATS_TILES, lambda tt: (
            host_lib.tblock_smem_bytes(0, c, 4, tt[0], tt[1], eb)), "test")

    assert stats_tile(704, 2) == (4, 4) and stats_tile(704, 4) == (2, 2)
    for c in (320, 160):
        for eb in (2, 4):
            stats_tile(c, eb)
    for c, heads in ((48, 1), (96, 1), (96, 2), (192, 4), (384, 8)):
        for eb in (2, 4):
            tb._chain_tile(host_lib, c, heads, eb)


def test_chain_function_gradients_match_jax(host_lib, monkeypatch):
    """`_TBlockChainFunction` with its forward through the host build of
    the kernels: the output and every gradient against JAX
    `tblock_chain_fused` (interpreted), whose backward also recomputes
    through the plain chain."""
    monkeypatch.setattr(jtb, "_INTERPRET", True)
    x, ps = _chain_inputs((1, 8, 16, 8), 3, 2, "WithBias", seed=4)

    def host_forward(xx, pps, heads, ln_type, kws):
        kws = [tb.prepare_tblock_weights(p, xx.dtype, ln_type) for p in pps]
        return tb._chain_launch(host_lib, xx, kws, heads, ln_type, (4, 4),
                                (2, 4), 2, (4, 8), 1, 2, 0)

    monkeypatch.setattr(tb, "_chain_forward", host_forward)
    tx = t(x).requires_grad_(True)
    tps = [{k: v.requires_grad_(True) for k, v in _torch_params(p).items()}
           for p in ps]
    keys = tuple(tuple(p) for p in tps)
    y = tb._TBlockChainFunction.apply(tx, None, 2, "WithBias", keys,
                                      *(p[k] for p in tps for k in p))
    (y * y).sum().backward()

    def loss(xx, pps):
        return jnp.sum(jnp.square(jtb.tblock_chain_fused(xx, pps, 2)))

    jy = jtb.tblock_chain_fused(jnp.asarray(x), tuple(ps), 2)
    gx, gps = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), tuple(ps))
    assert_close(y, jy, atol=4e-5, rtol=4e-5)
    assert_close(tx.grad, gx, atol=2e-4, rtol=2e-4)
    for i, p in enumerate(tps):
        for k, v in p.items():
            assert_close(v.grad, gps[i][k], atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# The bf16 chain on the pipeline
# ---------------------------------------------------------------------------


def _bf16_chain(shape, n, heads, ln_type, seed):
    """bf16 x, the blocks' torch parameters and their bf16 kernel
    weights."""
    x, ps = _chain_inputs(shape, n, heads, ln_type, seed)
    ps = [_torch_params(p) for p in ps]
    return (t(x).to(BF), ps,
            [tb.prepare_tblock_weights(p, BF, ln_type) for p in ps])


def _ref_close(got, want, x, n):
    """Phase 3's bf16 bounds times sqrt(n) (chip_smoke.py phase 17)."""
    scale = n ** 0.5
    assert _branch(got, want, x) <= scale * REF_BRANCH
    assert_close(got.float(), want.float(), atol=scale * REF_ATOL,
                 rtol=scale * REF_RTOL)


@pytest.mark.parametrize("shape,n,heads,ln_type", [
    ((1, 8, 16, 16), 2, 2, "WithBias"),   # one tile of the stencils
    ((2, 11, 13, 48), 3, 2, "BiasFree"),  # ragged, batch 2, hidden 127
    ((1, 9, 10, 80), 2, 2, "WithBias"),   # 40 channels per head
    ((1, 5, 7, 32), 4, 4, "BiasFree"),    # image smaller than one tile
])
def test_chain_pipeline_on_host_matches_plain_chain(host_lib, shape, n,
                                                    heads, ln_type):
    x, ps, kws = _bf16_chain(shape, n, heads, ln_type, seed=shape[2] + n)
    before = (tb.tblock_chain_fused.launches, tb.chain_pipeline.launches,
              tb.tblock_pipeline.launches, tb.tblock_fused.launches)
    got = tb.chain_pipeline(host_lib, x, kws, heads, ln_type, 2, 0)
    # one chain epilogue per block boundary; no block counts as a block
    # call
    assert (tb.tblock_chain_fused.launches, tb.chain_pipeline.launches,
            tb.tblock_pipeline.launches, tb.tblock_fused.launches) == (
        before[0] + n - 1, before[1] + n - 1, before[2], before[3])
    _ref_close(got, tb.tblock_chain_ref(x, ps, heads, ln_type), x, n)
    _ref_close(got, tb.tblock_chain_ref(x.float(), ps, heads, ln_type), x, n)
    # no atomics, partials summed in a fixed order: bitwise repeatable
    assert torch.equal(tb.chain_pipeline(host_lib, x, kws, heads, ln_type,
                                         2, 0), got)


@pytest.mark.parametrize("n", [2, 3])
def test_chain_pipeline_matches_pipeline_block_by_block(host_lib, n):
    """The chain against `tblock_pipeline` block by block on the same
    weights: the same kernels but at the boundary, where the epilogue's
    out is fwd_gemm_residual's and its LN rows are bwd_ln_rows' but for
    the order of the moments' sums (a rare flip of y's last bit)."""
    x, _, kws = _bf16_chain((2, 9, 18, 48), n, 2, "WithBias", seed=n)
    got = tb.chain_pipeline(host_lib, x, kws, 2, "WithBias", 3, 0)
    want = x
    for kw in kws:
        want = tb.tblock_pipeline(host_lib, want, kw, 2, "WithBias", 3, 0)
    assert _branch(got, want, x) <= n ** 0.5 * JAX_BRANCH
    assert (got == want).float().mean() > 0.95


def test_chain_pipeline_unfused_boundary_matches_fused(host_lib,
                                                       monkeypatch):
    """A width that `_chain_fuses` refuses runs each boundary as block i's
    residual product and block i+1's LN rows: the same chain but for the
    order of the moments' sums."""
    x, _, kws = _bf16_chain((1, 8, 16, 32), 3, 2, "BiasFree", seed=11)
    got = tb.chain_pipeline(host_lib, x, kws, 2, "BiasFree", 2, 0)
    monkeypatch.setattr(tb, "_chain_fuses", lambda c: False)
    before = tb.chain_pipeline.launches
    want = tb.chain_pipeline(host_lib, x, kws, 2, "BiasFree", 2, 0)
    assert tb.chain_pipeline.launches == before + 2
    assert _branch(got, want, x) <= 3 ** 0.5 * JAX_BRANCH


def _tblock_chain_impl_eager(x, ps, heads, ln_type):
    """JAX `_tblock_chain_impl` with its Pallas kernels run op by op."""
    with mock.patch.object(jtb.pl, "pallas_call", _eager_pallas_call):
        return jtb._tblock_chain_impl(x, tuple(ps), heads, ln_type,
                                      interpret=True)


@pytest.mark.parametrize("shape,n,ln_type", [
    ((1, 8, 16, 16), 2, "WithBias"),
    ((1, 8, 12, 16), 3, "BiasFree"),
])
def test_chain_pipeline_on_host_matches_jax_chain_op_by_op(host_lib, shape,
                                                           n, ln_type):
    """Against the JAX chain of the TPU kernels (`_make_stats_kernel`,
    `_make_apply_stats_kernel` per boundary, `_make_apply_kernel`) run op
    by op in bf16, every rounding point of their bodies kept: the bounds
    of the block against JAX's kernel (tests/test_torch_tblock_fwd.py)
    times sqrt(n)."""
    xn, pns = _chain_inputs(shape, n, 2, ln_type, seed=shape[2] + 5 * n)
    ps = [_torch_params(p) for p in pns]
    x = t(xn).to(BF)
    kws = [tb.prepare_tblock_weights(p, BF, ln_type) for p in ps]
    got = tb.chain_pipeline(host_lib, x, kws, 2, ln_type, 2, 0)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = t(_j(_tblock_chain_impl_eager(jx, pns, 2, ln_type)))
    scale = n ** 0.5
    assert _branch(got, want, x) <= scale * JAX_BRANCH
    assert_close(got.float(), want, atol=scale * JAX_ATOL,
                 rtol=scale * JAX_RTOL)


@pytest.mark.parametrize("c,heads,dtype,pipeline", [
    (16, 2, BF, True),               # C and C / heads multiples of 8
    (12, 1, BF, False),              # C % 8 != 0: csrc/tblock_chain.cu
    (32, 8, BF, False),              # C / heads = 4: csrc/tblock_chain.cu
    (16, 2, torch.float32, False),   # float32: csrc/tblock_chain.cu
])
def test_chain_route_rule(host_lib, monkeypatch, c, heads, dtype, pipeline):
    """`_chain_kernel` with the device checks and the card query taken out:
    the pipeline at bf16 widths whose TMA rows it can read, and
    csrc/tblock_chain.cu's route otherwise; each counts n - 1 launches."""
    monkeypatch.setattr(tb, "_validate", lambda *a: None)
    monkeypatch.setattr(tb, "_kernel_library", lambda cph, what: host_lib)
    monkeypatch.setattr(tb, "_card", lambda device: (0, 2))
    x, ps = _chain_inputs((1, 7, 9, c), 3, heads, "WithBias", seed=c)
    ps = [_torch_params(p) for p in ps]
    x = t(x).to(dtype)
    kws = [tb.prepare_tblock_weights(p, dtype, "WithBias") for p in ps]
    before = (tb.tblock_chain_fused.calls, tb.tblock_chain_fused.launches,
              tb.chain_pipeline.launches)
    got = tb._chain_kernel(x, kws, heads, "WithBias")
    assert (tb.tblock_chain_fused.calls - before[0],
            tb.tblock_chain_fused.launches - before[1],
            tb.chain_pipeline.launches - before[2]) == (1, 2,
                                                        2 * pipeline)
    _close(got, tb.tblock_chain_ref(x, ps, heads, "WithBias"), dtype)
