"""PyTorch port vs JAX package: the MDTA statistics kernel (B7).

Chain of custody on the CPU, f32 unless stated:
* the port's plain `mdta_stats_ref` and `mdta_attention` against JAX
  `mdta_stats_pallas` and `mdta_attention_pallas`, which interpret their
  Pallas kernel on the CPU by themselves;
* the CUDA source csrc/mdta.cu itself, compiled for the host with
  tests/cuda_host_shim.h, against `mdta_stats_ref`, on q and k passed as
  strided chunks of one qkv tensor, through the same launch code the CUDA
  path uses;
* the MDTAAttention module with use_pallas=True against the JAX module,
  and the refusal of a call that needs a gradient.
The on-card checks are in tests/test_torch_mdta_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.models.layers import MDTAAttention as JMDTA
from textualdegremoval_tpu.ops.pallas import mdta as jmd

import textualdegremoval_tpu_torch.ops.pallas.mdta as md
from textualdegremoval_tpu_torch.models.layers import MDTAAttention
from textualdegremoval_tpu_torch.ops.attention import mdta_attention_nhwc

from torch_port_util import (
    randn, t, randomize, jax_tree, assert_close, build_host_library,
)


def _qkv(b, h, w, c, seed):
    """q, k, v of one qkv = x . W with correlated channels, and
    temperatures that make the softmax rows far from uniform."""
    rng = np.random.default_rng(seed)
    x = randn(rng, b, h, w, c)
    qkv = x @ randn(rng, c, 3 * c, scale=c ** -0.5)
    return np.split(qkv.astype(np.float32), 3, axis=-1)


def _temperature(heads, c):
    return (c ** 0.5 * (0.5 + np.arange(heads, dtype=np.float32) / heads)
            ).reshape(heads, 1, 1)


@pytest.mark.parametrize("b,h,w,c,heads", [
    (1, 8, 8, 8, 1),
    (2, 6, 7, 16, 2),    # L = 42: JAX pads it to a 512-row tile
    (1, 9, 11, 16, 4),   # ragged L, four heads
])
def test_stats_ref_matches_jax_kernel(b, h, w, c, heads):
    q, k, _ = _qkv(b, h, w, c, seed=h)
    temp = _temperature(heads, c)
    got = md.mdta_stats_ref(t(q).reshape(b, -1, c), t(k).reshape(b, -1, c),
                            t(temp), heads)
    want = jmd.mdta_stats_pallas(jnp.asarray(q.reshape(b, -1, c)),
                                 jnp.asarray(k.reshape(b, -1, c)),
                                 jnp.asarray(temp.reshape(heads)), heads)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_close(got, want)
    # the (B, H, W, C) form takes the same path
    assert torch.equal(md.mdta_stats_ref(t(q), t(k), t(temp), heads), got)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_attention_matches_jax_kernel(heads):
    q, k, v = _qkv(2, 5, 9, 16, seed=heads)
    temp = _temperature(heads, 16)
    got = md.mdta_attention(t(q), t(k), t(v), t(temp), heads)
    want = jmd.mdta_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(temp),
                                     heads)
    assert_close(got, want)
    # and the module path's attention
    assert_close(got, mdta_attention_nhwc(t(q), t(k), t(v), t(temp), heads))


def test_cpu_tensor_takes_plain_path_without_launching():
    q, k, _ = map(t, _qkv(1, 4, 5, 8, seed=1))
    before = md.mdta_stats.launches
    got = md.mdta_stats(q, k, torch.ones(2), 2)
    assert md.mdta_stats.launches == before == 0
    assert torch.equal(got, md.mdta_stats_ref(q, k, torch.ones(2), 2))


def test_refuses_a_call_that_needs_a_gradient():
    q, k, v = map(t, _qkv(1, 4, 5, 8, seed=2))
    temp = torch.ones(2, 1, 1, requires_grad=True)
    with pytest.raises(RuntimeError, match="JAX"):
        md.mdta_attention(q, k, v, temp, 2)
    with pytest.raises(RuntimeError, match="forward only"):
        md.mdta_stats(q.requires_grad_(True), k, temp.detach(), 2)
    with torch.no_grad():
        md.mdta_attention(q, k, v, temp, 2)


@pytest.fixture(scope="module")
def host_mdta_lib(tmp_path_factory):
    """csrc/mdta.cu compiled for the CPU against tests/cuda_host_shim.h
    (tblock.cu too, for the error strings)."""
    return build_host_library(tmp_path_factory.mktemp("host_mdta"),
                              ("mdta.cu", "tblock.cu"))


@pytest.mark.parametrize("b,h,w,c,heads,tl,nsplit,dtype", [
    (1, 5, 7, 16, 2, 16, 2, torch.float32),    # L = 35: a masked tail
    (2, 9, 13, 48, 1, 32, 3, torch.float32),   # batch 2, strided splits
    (1, 4, 5, 40, 1, 16, 1, torch.float32),    # cph 40 (PromptIR's)
    (1, 6, 11, 32, 2, 16, 4, torch.bfloat16),  # bf16 gram on mma
    (2, 3, 7, 48, 4, 64, 1, torch.bfloat16),   # one chunk longer than L
    (1, 4, 5, 40, 1, 16, 2, torch.bfloat16),   # cph 40: N not a multiple
])
def test_cuda_source_on_host_matches_ref(host_mdta_lib, b, h, w, c, heads,
                                         tl, nsplit, dtype):
    qkv = t(np.concatenate(_qkv(b, h, w, c, seed=c), axis=-1)).to(dtype)
    q, k, _ = torch.chunk(qkv, 3, dim=-1)  # strided views, stride 3C
    assert q.stride(2) == 3 * c and not q.is_contiguous()
    temp = t(_temperature(heads, c))
    want = md.mdta_stats_ref(q, k, temp, heads)
    got = md._launch(host_mdta_lib, q, k, temp, heads, tl, nsplit, 0)
    # both sum the same f32 values in other orders; entries lie in [0, 1]
    assert_close(got, want, atol=1e-6, rtol=1e-5)
    # the (B, L, C) view of the same memory gives the same sums
    got3 = md._launch(host_mdta_lib, q.reshape(b, h * w, c),
                      k.reshape(b, h * w, c), temp, heads, tl, nsplit, 0)
    assert torch.equal(got3, got)


def test_host_kernel_reports_bad_shapes(host_mdta_lib):
    args = [None] * 5
    # 193 channels per head exceeds the limit of 192
    assert host_mdta_lib.mdta_stats(*args, 1, 4, 4, 193, 1, 0, 0, 0, 0, 16,
                                    1, None) != 0
    # a chunk length that is not a multiple of 16
    assert host_mdta_lib.mdta_stats(*args, 1, 4, 4, 16, 2, 0, 0, 0, 0, 24,
                                    1, None) != 0
    assert host_mdta_lib.mdta_finish(*args, 1, 16, 3, 1, None) != 0


@pytest.mark.parametrize("heads", [1, 2])
def test_module_matches_jax(heads):
    m = randomize(MDTAAttention(16, heads, use_pallas=True), seed=3,
                  scale=0.3)
    x = randn(np.random.default_rng(4), 2, 6, 7, 16)
    want = JMDTA(16, heads, use_pallas=True).apply(
        {"params": jax_tree(m, "attn")}, jnp.asarray(x))
    with torch.no_grad():
        got = m(t(x))
        m.use_pallas = False
        plain = m(t(x))
    assert_close(got, want)
    assert_close(plain, want)
