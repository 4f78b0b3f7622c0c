"""PyTorch port vs JAX package: the cross-block chain of TransformerBlocks
(`tblock_chain_fused`) and the whole-block kernel at PromptIR's widths.

On the CPU, f32 unless stated:
* the port's plain chain `tblock_chain_ref` against the JAX Pallas chain
  `_tblock_chain_impl(..., interpret=True)` at the shapes of JAX's own
  tests/test_pallas_tblock_chain.py, at its 4e-5, both LayerNorm types, no
  block and one block included;
* the CUDA sources csrc/tblock_chain.cu (with csrc/tblock.cu's first pass
  A and last pass B) and csrc/tblock.cu at 40, 80 and 176 channels per
  head, compiled for the host with tests/cuda_host_shim.h, against the
  plain versions, through the launch code of the CUDA path;
* `_TBlockChainFunction`'s gradients (forward through the host build,
  backward through the plain chain) against JAX `tblock_chain_fused`'s;
* the stage module: the same state-dict keys and CPU output with chain on
  and off, and `chain` validated.
The on-card checks are in tests/test_torch_tblock_chain_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import textualdegremoval_tpu.ops.pallas.tblock as jtb

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.layers import TBlockStage
from textualdegremoval_tpu_torch.models.restormer import Restormer

from test_torch_tblock import BF16_ATOL, BF16_RTOL, _params, _torch_params
from torch_port_util import (
    assert_close, build_host_library, randn, randomize, t,
)


def _chain_inputs(shape, n, heads, ln_type, seed):
    """x and n blocks' natural-shape parameters as numpy arrays."""
    ps = [_params(shape[-1], heads, ln_type, seed=seed + 7 * i)
          for i in range(n)]
    return randn(np.random.default_rng(seed), *shape), ps


@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
@pytest.mark.parametrize("shape,n", [
    ((1, 8, 16, 8), 2),    # single tile: both edge masks in one step
    ((1, 16, 16, 8), 3),   # two tiles, 3 blocks
    ((2, 24, 16, 16), 2),  # batch 2, middle tiles
    ((1, 12, 16, 8), 4),   # H forces the TPU tile down
    ((1, 8, 16, 8), 1),    # one block: the whole-block kernel
    ((1, 8, 16, 8), 0),    # no block: the identity
])
def test_chain_ref_matches_jax_interpreted_chain(shape, n, ln_type):
    x, ps = _chain_inputs(shape, n, 2, ln_type, seed=shape[1] + n)
    got = tb.tblock_chain_ref(t(x), [_torch_params(p) for p in ps], 2,
                              ln_type)
    want = jtb._tblock_chain_impl(jnp.asarray(x), tuple(ps), 2, ln_type,
                                  interpret=True)
    assert_close(got, want, atol=4e-5, rtol=4e-5)


def test_cpu_tensor_takes_plain_chain_without_launching():
    x, ps = _chain_inputs((1, 6, 5, 8), 3, 2, "WithBias", seed=1)
    ps = [_torch_params(p) for p in ps]
    before = (tb.tblock_chain_fused.calls, tb.tblock_chain_fused.launches,
              tb.tblock_fused.launches)
    got = tb.tblock_chain_fused(t(x), ps, 2, "WithBias")
    assert (tb.tblock_chain_fused.calls, tb.tblock_chain_fused.launches,
            tb.tblock_fused.launches) == before
    assert torch.equal(got, tb.tblock_chain_ref(t(x), ps, 2, "WithBias"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/tblock.cu and csrc/tblock_chain.cu compiled for the CPU against
    tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_chain"),
                              ("tblock.cu", "tblock_chain.cu"))


def _close(got, want, dtype):
    if dtype == torch.float32:
        assert_close(got, want)
    else:
        assert_close(got.float(), want.float(), atol=BF16_ATOL,
                     rtol=BF16_RTOL)


# (shape, blocks, heads, chain tile, gram accumulators in shared memory,
# CTAs per image); pass A's tile (4, 4), pass B's (2, 4), 2 pass-A CTAs
_HOST_CHAIN_CASES = [
    ((1, 8, 16, 8), 2, 2, (8, 8), 1, 1),      # one CTA walks every tile
    ((2, 11, 13, 16), 3, 2, (4, 4), 0, 3),    # ragged, batch 2, gram in
                                              # device memory
    ((1, 9, 10, 32), 2, 2, (2, 4), 1, 2),     # K % 16 == 0: bf16 on mma
    ((1, 5, 7, 12), 2, 1, (1, 2), 1, 4),      # odd hidden width (31)
]


@pytest.mark.parametrize("case,ln_type,dtype", [
    *[(c, ln, torch.float32) for c in _HOST_CHAIN_CASES
      for ln in ("WithBias", "BiasFree")],
    *[(c, "WithBias", torch.bfloat16) for c in _HOST_CHAIN_CASES[1:3]],
])
def test_chain_source_on_host_matches_plain_chain(host_lib, case, ln_type,
                                                  dtype):
    shape, n, heads, tile, in_smem, nsplit = case
    x, ps = _chain_inputs(shape, n, heads, ln_type, seed=shape[2])
    ps = [_torch_params(p) for p in ps]
    x = t(x).to(dtype)
    kws = [tb.prepare_tblock_weights(p, dtype, ln_type) for p in ps]
    before = tb.tblock_chain_fused.launches
    got = tb._chain_launch(host_lib, x, kws, heads, ln_type, (4, 4), (2, 4),
                           2, tile, in_smem, nsplit, 0)
    assert tb.tblock_chain_fused.launches == before + n - 1
    _close(got, tb.tblock_chain_ref(x, ps, heads, ln_type), dtype)
    # the partial sums are added in a fixed order: bitwise repeatable
    again = tb._chain_launch(host_lib, x, kws, heads, ln_type, (4, 4),
                             (2, 4), 2, tile, in_smem, nsplit, 0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_matches_block_kernel_block_by_block(host_lib, dtype):
    """The chain against the whole-block kernel run block by block on the
    same weights: block i's output is the same arithmetic as pass B's, and
    the statistics differ only in how their partial sums are grouped."""
    x, ps = _chain_inputs((1, 9, 10, 32), 3, 2, "WithBias", seed=3)
    ps = [_torch_params(p) for p in ps]
    x = t(x).to(dtype)
    kws = [tb.prepare_tblock_weights(p, dtype, "WithBias") for p in ps]
    got = tb._chain_launch(host_lib, x, kws, 2, "WithBias", (4, 4), (2, 4),
                           1, (2, 4), 1, 2, 0)
    want = x
    for kw in kws:
        want = tb._launch(host_lib, want, kw, 2, "WithBias", (4, 4), (2, 4),
                          2, 0)
    _close(got, want, dtype)


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


def test_chain_stage_keys_and_cpu_output_match_per_block():
    kw = dict(dim=8, num_blocks=(2, 3, 1, 2), num_refinement_blocks=2,
              heads=(1, 1, 2, 2))
    plain = randomize(Restormer(**kw), seed=5).eval()
    chained = Restormer(**kw, chain=True).eval()
    assert list(chained.state_dict()) == list(plain.state_dict())
    chained.load_state_dict(plain.state_dict(), strict=True)
    assert isinstance(chained.encoder_level2, TBlockStage)
    assert chained.encoder_level2.chain and not plain.encoder_level2.chain
    x = t(randn(np.random.default_rng(6), 1, 16, 24, 3))
    with torch.no_grad():
        want = plain(x)
        got = chained(x)
    assert_close(got, want)


@pytest.mark.parametrize("chain", ["yes", 1, None, 1.0])
def test_chain_must_be_a_bool(chain):
    with pytest.raises(ValueError, match="chain must be a bool"):
        TBlockStage(8, 1, 2, chain=chain)
    with pytest.raises(ValueError, match="chain must be a bool"):
        define_network({"type": "Restormer", "dim": 8,
                        "num_blocks": [1, 1, 1, 1], "chain": chain})


def test_define_network_takes_chain():
    m = define_network({"type": "RestormerRefFusion", "dim": 8, "nf": 8,
                        "num_blocks": [2, 1, 1, 1], "chain": True})
    assert m.encoder_level1.chain and m.refinement.chain
