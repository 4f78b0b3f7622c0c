"""PyTorch port vs JAX package: MASA search and transfer, stage by stage,
and the MASA encoder.  f32 on CPU; integer indices must match exactly,
features to atol/rtol 1e-5."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import textualdegremoval_tpu.ops.masa as jm
from textualdegremoval_tpu.models.layers import (
    MASAEncoder as JMASAEncoder, masa_encode_pair as j_encode_pair,
)

import textualdegremoval_tpu_torch.ops.masa as pm
from textualdegremoval_tpu_torch.models.layers import (
    MASAEncoder, masa_encode_pair,
)

from torch_port_util import randn, t, randomize, jax_tree, assert_close


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kyh,dilations", [(6, (1, 2, 3)), (4, (1, 2, 3)),
                                           (6, (1,))])
def test_coarse_search(kyh, dilations):
    rng = np.random.default_rng(0)
    blocks = randn(rng, 2, 4, kyh, kyh, 8)
    ref = randn(rng, 2, 9, 10, 8)
    got = pm.masa_coarse_search(t(blocks), t(ref), dilations)
    assert got.dtype == torch.int32
    _exact(got, jm.masa_coarse_search(blocks, ref, dilations))


def test_window_corners():
    idx = np.array([[0, 5, 17, 89], [44, 60, 71, 3]], np.int32)
    got = pm.masa_window_corners(t(idx), 9, 10, 5, 3)
    want = jm.masa_window_corners(jnp.asarray(idx), 9, 10, 5, 3)
    for g, w in zip(got, want):
        _exact(g, w)


@pytest.mark.parametrize("scale", [1, 2])
def test_gather_windows(scale):
    rng = np.random.default_rng(1)
    feat = randn(rng, 2, 9 * scale, 10 * scale, 3)
    y1 = np.array([[0, 2, 3], [1, 0, 3]], np.int32)
    x1 = np.array([[0, 5, 2], [4, 1, 5]], np.int32)
    got = pm.masa_gather_windows(t(feat), t(y1), t(x1), 6, 5, scale)
    _exact(got, jm.masa_gather_windows(feat, jnp.asarray(y1),
                                       jnp.asarray(x1), 6, 5, scale))


def test_fine_search():
    rng = np.random.default_rng(2)
    blocks = randn(rng, 6, 6, 6, 8)
    wins = randn(rng, 6, 9, 8, 8)
    gi, gs = pm.masa_fine_search(t(blocks), t(wins), 3)
    wi, ws = jm.masa_fine_search(blocks, wins, 3)
    assert gi.dtype == torch.int32
    _exact(gi, wi)
    assert_close(gs, ws)


def test_transfer_weights():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 7 * 6, size=(3, 4, 5)).astype(np.int32)
    gw, gc = pm._transfer_weights(t(idx), 3, 9, 8)
    ww, wc = jm._transfer_weights(jnp.asarray(idx), 3, 9, 8)
    _exact(gw, ww)
    _exact(gc, wc)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_transfer(scale):
    rng = np.random.default_rng(4 + scale)
    win = randn(rng, 3, 9 * scale, 8 * scale, 4)
    idx = rng.integers(0, 7 * 6, size=(3, 4, 5)).astype(np.int32)
    soft = rng.random((3, 4, 5)).astype(np.float32)
    got = pm.masa_transfer(t(win), t(idx), t(soft), 3, scale)
    assert_close(got, jm.masa_transfer(win, jnp.asarray(idx), soft, 3, scale))


def test_blocks_to_image():
    x = randn(np.random.default_rng(5), 2 * 2 * 3, 4, 5, 3)
    _exact(pm._blocks_to_image(t(x), 2, 2, 3),
           jm._blocks_to_image(jnp.asarray(x), 2, 2, 3))


@pytest.mark.parametrize("ref_hw", [(8, 8), (8, 12)])
def test_match_and_warp(ref_hw):
    rng = np.random.default_rng(6)
    deep = randn(rng, 2, 8, 8, 16)
    hr, wr = ref_hw
    pyr = [randn(rng, 2, hr * 2 ** (3 - lv), wr * 2 ** (3 - lv), 2 * 2 ** lv)
           for lv in range(3)] + [randn(rng, 2, hr, wr, 16)]
    got = pm.masa_match_and_warp(t(deep), [t(p) for p in pyr], 4)
    # jitted: one compile is faster on the CPU than eager op-by-op dispatch
    want = jax.jit(functools.partial(jm.masa_match_and_warp,
                                     lr_block_size=4))(deep, pyr)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert_close(g, w)


def _encoder(seed):
    enc = randomize(MASAEncoder(3, 4, (1, 2, 1, 1), 4), seed)
    jenc = JMASAEncoder(4, (1, 2, 1, 1), 4)
    return enc, jenc, {"params": jax_tree(enc, "masa_enc")}


def test_masa_encoder():
    enc, jenc, params = _encoder(7)
    x = randn(np.random.default_rng(8), 2, 16, 24, 3)
    got = enc(t(x))
    want = jenc.apply(params, jnp.asarray(x))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("ref_hw", [(16, 16), (24, 32)])
def test_masa_encode_pair_both_branches(ref_hw):
    enc, jenc, params = _encoder(9)
    rng = np.random.default_rng(10)
    inp = randn(rng, 1, 16, 16, 3)
    ref = randn(rng, 1, *ref_hw, 3)
    got_lq, got_ref = masa_encode_pair(enc, t(inp), t(ref))
    want_lq, want_ref = jenc.apply(
        params, jnp.asarray(inp), jnp.asarray(ref),
        method=lambda m, a, b: j_encode_pair(m, a, b))
    for g, w in zip(got_lq + got_ref, list(want_lq) + list(want_ref)):
        assert_close(g, w)
