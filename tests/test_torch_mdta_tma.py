"""PyTorch port vs JAX package: the bf16 route of the MDTA statistics (B7),
csrc/wgrad.cu's gram with its square-sum word and csrc/mdta_gram.cu's
finish.

The CUDA sources are compiled for the host with tests/cuda_host_shim.h
(TMA boxes, the 128-byte swizzle and wgmma emulated) and driven through
the wrapper's own launch code (`mdta_gram`):
* against `mdta_stats_ref` and against JAX `mdta_stats_pallas` (which
  interprets its Pallas kernel on the CPU), on q and k passed as strided
  chunks of one bf16 qkv tensor, at cph 8, 16, 48, 96 (two consumer
  warpgroups), 176 (two row tiles), heads 1-4, pixel counts that are not a
  multiple of the kernel's 64-pixel step, one and several splits; both
  sides sum the same f32 products of bf16 values in other orders, and the
  entries lie in [0, 1]: atol 1e-6, rtol 1e-5 against the plain version,
  1e-5 / 1e-5 against JAX (its own f32 sums);
* the square-sum partials of `tblock_wgrad_ssq` split by split, at
  products whose B boxes reach more than one consumer warpgroup: each
  column summed exactly once per split;
* the route rule `_takes_gram` and the wrapper's dispatch (the device
  check's CUDA branch, with the library and the card patched).
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from textualdegremoval_tpu.ops.pallas import mdta as jmd

import textualdegremoval_tpu_torch.ops.pallas.mdta as md
from textualdegremoval_tpu_torch.ops.pallas.tblock import _ptr

from torch_port_util import randn, t, assert_close, build_host_library

BF = torch.bfloat16


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/wgrad.cu, csrc/mdta_gram.cu and csrc/mdta.cu compiled for the
    CPU against tests/cuda_host_shim.h (tblock.cu too, for the error
    strings)."""
    return build_host_library(tmp_path_factory.mktemp("host_mdta_tma"),
                              ("wgrad.cu", "mdta_gram.cu", "mdta.cu",
                               "tblock.cu"))


@pytest.fixture(autouse=True)
def _launch_counts_kept():
    """The wrappers' launch counts as they were before each test: other
    test files in the process count from them."""
    kept = md.mdta_stats.launches, md.mdta_gram.launches
    yield
    md.mdta_stats.launches, md.mdta_gram.launches = kept


def _qkv(b, h, w, c, seed, dtype=BF):
    """One (B, H, W, 3C) qkv = x . W with correlated channels, in dtype;
    q, k, v its strided chunks (pixel stride 3C)."""
    rng = np.random.default_rng(seed)
    x = randn(rng, b, h, w, c)
    qkv = t(x @ randn(rng, c, 3 * c, scale=c ** -0.5)).to(dtype)
    return torch.chunk(qkv, 3, dim=-1)


def _temperature(heads, c):
    return t((c ** 0.5 * (0.5 + np.arange(heads, dtype=np.float32) / heads)
              ).reshape(heads, 1, 1))


@pytest.mark.parametrize("b,h,w,c,heads,sms", [
    (1, 5, 13, 8, 1, 1),      # cph 8, L = 65: one pixel past a step
    (2, 6, 7, 32, 2, 3),      # cph 16, batch 2, L = 42
    (1, 9, 11, 48, 1, 4),     # cph 48, L = 99, several splits
    (1, 4, 17, 192, 4, 2),    # cph 48, four heads
    (1, 5, 9, 144, 3, 1),     # cph 48, three heads
    (1, 7, 10, 96, 1, 3),     # cph 96: two consumer warpgroups
    (1, 3, 25, 176, 1, 1),    # cph 176: two row tiles, BN 192
])
def test_gram_route_on_host_matches_ref_and_jax(host_lib, b, h, w, c, heads,
                                                sms):
    q, k, _ = _qkv(b, h, w, c, seed=c + h)
    assert q.stride(2) == 3 * c and not q.is_contiguous()
    assert md._takes_gram(q, k, heads)
    temp = _temperature(heads, c)
    before = md.mdta_gram.launches
    got = md.mdta_gram(host_lib, q, k, temp, heads, sms, 0)
    assert md.mdta_gram.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, heads, c // heads,
                                                        c // heads)
    want = md.mdta_stats_ref(q, k, temp, heads)
    assert_close(got, want, atol=1e-6, rtol=1e-5)
    jax_want = jmd.mdta_stats_pallas(
        jnp.asarray(q.float().reshape(b, -1, c).numpy()),
        jnp.asarray(k.float().reshape(b, -1, c).numpy()),
        jnp.asarray(temp.reshape(heads).numpy()), heads)
    assert_close(got, np.asarray(jax_want), atol=1e-5, rtol=1e-5)
    # a repeated call is bitwise equal; the (B, L, C) view of the same
    # memory gives the same sums
    assert torch.equal(md.mdta_gram(host_lib, q, k, temp, heads, sms, 0), got)
    got3 = md.mdta_gram(host_lib, q.reshape(b, h * w, c),
                        k.reshape(b, h * w, c), temp, heads, sms, 0)
    assert torch.equal(got3, got)


# (M, N, pixels, nsplit): B's boxes over one warpgroup (48 x 128), over
# two (96 x 256: two boxes each), two row tiles (176 x 176)
@pytest.mark.parametrize("m,n,npix,nsplit", [
    (48, 128, 130, 2), (96, 256, 200, 3), (176, 176, 70, 1)])
def test_wgrad_square_sums_split_by_split(host_lib, m, n, npix, nsplit):
    """`tblock_wgrad_ssq`: the product as `tblock_wgrad` gives it, and each
    split's square sums of A's and B's columns over exactly its own
    pixels (64-pixel steps, ceil(steps / nsplit) a split)."""
    rng = np.random.default_rng(m + n)
    a = t(randn(rng, npix, m)).to(BF)
    bm = t(randn(rng, npix, n)).to(BF)
    out = torch.empty((nsplit, m, n))
    sa, sb = torch.empty((nsplit, m)), torch.empty((nsplit, n))
    assert host_lib.tblock_wgrad_ssq(
        _ptr(a), m, 0, 0, _ptr(bm), n, 0, 0, _ptr(out), _ptr(sa), _ptr(sb),
        npix, m, n, 1, 1, nsplit, None) == 0
    plain = torch.empty((nsplit, m, n))
    assert host_lib.tblock_wgrad(
        _ptr(a), m, 0, 0, _ptr(bm), n, 0, 0, _ptr(plain), npix, m, n, 1, 1,
        nsplit, 1, None) == 0
    assert torch.equal(out, plain)
    per = -(-(-(-npix // 64)) // nsplit) * 64
    for s in range(nsplit):
        rows = slice(s * per, min((s + 1) * per, npix))
        assert_close(sa[s], (a[rows].double() ** 2).sum(0).float(),
                     atol=1e-4, rtol=1e-5)
        assert_close(sb[s], (bm[rows].double() ** 2).sum(0).float(),
                     atol=1e-4, rtol=1e-5)


def test_host_entries_refuse_what_they_do_not_take(host_lib):
    args = [None] * 5
    # cph 12 is not a multiple of 8; C = 20 is not either
    assert host_lib.mdta_stats_gram(*args, 1, 64, 24, 2, 72, 0, 1,
                                    None) != 0
    assert host_lib.mdta_stats_gram(*args, 1, 64, 20, 1, 60, 0, 1,
                                    None) != 0
    # 200 channels per head exceeds the limit of 192
    assert host_lib.mdta_stats_gram(*args, 1, 64, 200, 1, 600, 0, 1,
                                    None) != 0
    # no square sums asked for; M not a multiple of 8
    assert host_lib.tblock_wgrad_ssq(None, 8, 0, 0, None, 8, 0, 0, None,
                                     None, None, 64, 8, 8, 1, 1, 1,
                                     None) != 0
    assert host_lib.tblock_wgrad_ssq(*([None, 12, 0, 0] * 2), None, None,
                                     None, 64, 12, 8, 1, 1, 1, None) != 0


def test_route_rule_reads_dtype_widths_and_strides():
    """bf16 chunks of one qkv at C, cph multiples of 8 take the gram route;
    float32, cph % 8 != 0, C % 8 != 0, a pixel stride that is not uniform
    over the image and a base that is not 16-byte aligned take
    csrc/mdta.cu."""
    q, k, _ = _qkv(1, 4, 6, 48, seed=0)
    assert md._takes_gram(q, k, 1) and md._takes_gram(q, k, 2)
    q32, k32, _ = _qkv(1, 4, 6, 48, seed=0, dtype=torch.float32)
    assert not md._takes_gram(q32, k32, 1)
    assert not md._takes_gram(q, k, 4)         # cph 12
    q40, k40, _ = _qkv(1, 4, 6, 40, seed=0)
    assert md._takes_gram(q40, k40, 1) and not md._takes_gram(q40, k40, 8)
    q20, k20, _ = _qkv(1, 4, 6, 20, seed=0)
    assert not md._takes_gram(q20, k20, 1)     # C % 8
    # the columns of a wider image: rows W + 1 pixels apart
    wide = torch.zeros(1, 4, 7, 3 * 48, dtype=BF)
    qw, kw, _ = torch.chunk(wide[:, :, :6], 3, dim=-1)
    assert not md._takes_gram(qw, kw, 1)
    # a base 2 bytes off 16-byte alignment
    flat = torch.zeros(1 + 4 * 6 * 3 * 48, dtype=BF)[1:]
    qo, ko, _ = torch.chunk(flat.reshape(1, 4, 6, 3 * 48), 3, dim=-1)
    assert not md._takes_gram(qo, ko, 1)


@pytest.mark.parametrize("dtype,c,heads,gram", [
    (BF, 48, 2, True), (torch.float32, 48, 2, False), (BF, 40, 4, False)])
def test_wrapper_dispatch_follows_the_rule(host_lib, dtype, c, heads, gram):
    """`mdta_stats`'s card branch (`_stats_kernel`) through its own code on
    the host build: the gram route where `_takes_gram`, csrc/mdta.cu
    elsewhere, both counted in `mdta_stats.launches`."""
    q, k, _ = _qkv(1, 5, 7, c, seed=c, dtype=dtype)
    temp = _temperature(heads, c)
    before = (md.mdta_stats.launches, md.mdta_gram.launches)
    with mock.patch("textualdegremoval_tpu_torch.ops._build.load_library",
                    return_value=host_lib), \
            mock.patch("textualdegremoval_tpu_torch.ops.pallas.tblock._card",
                       return_value=(0, 2)):
        got = md._stats_kernel(q, k, temp, heads)
    assert (md.mdta_stats.launches, md.mdta_gram.launches) == (
        before[0] + 1, before[1] + int(gram))
    assert_close(got, md.mdta_stats_ref(q, k, temp, heads), atol=1e-6,
                 rtol=1e-5)
