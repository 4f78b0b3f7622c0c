"""The SCA sums' row window of B5's kernels, on the CPU: csrc/nafblock.cu's
`nafblock_sum_rows` (the pair's pass A: float32 and bf16 widths the
pipeline does not take) and csrc/naf_stencil.cu's `naf_gate_stencil_rows`
(the bf16 pipeline's SUM pass), compiled for the host against
tests/cuda_host_shim.h and run through the launch code the CUDA path
uses.  With a window each equals the plain sums over exactly those rows;
without one (the entries `nafblock_sum` and `naf_gate_stencil`, the whole
tensor), each output is bit-equal to the windowed entry's over every row,
which is what the unsharded routes run.  Then both routes' whole block
with a window and a reduction (`_forward_kernel` with rows, reduce and
pixels, as a row-sharded NAFBlock calls it: ops/pallas/nafblock.py) against
the plain version with the same window and reduction, the reduction that
of two ranks holding the same slab (the sums doubled over twice the
pixels), so that the SCA mean is the window's own."""

import numpy as np
import pytest
import torch

from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.norm import layer_norm_2d
from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb
from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import _ln_rows

from test_torch_nafblock_fwd import (
    REF_ATOL, REF_BRANCH, REF_RTOL, _block, _branch,
)
from torch_port_util import assert_close, build_host_library

BF = torch.bfloat16
WINDOWS = [(2, 9), (0, 11), (4, 4), (0, 3), (7, 11)]
SHAPE = (2, 11, 10, 32)  # H ragged against both routes' tiles


@pytest.fixture(autouse=True)
def _counters_kept():
    """The launch counters as they were before each test."""
    before = (nb.nafblock_fused.launches, nb.naf_pipeline.launches)
    yield
    nb.nafblock_fused.launches, nb.naf_pipeline.launches = before


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_library(
        tmp_path_factory.mktemp("host_naf_window"),
        ("naf_stencil.cu", "bwd_gemm.cu", "bwd_stencil.cu", "nafblock.cu"))


def _plain_gate(x, p):
    """The gate of the block's conv half in float32: LN1, conv1, the
    depthwise conv with zero padding plus its bias, the product of the
    halves."""
    c = x.shape[-1]
    y = layer_norm_2d(x.float(), p["norm1_w"], p["norm1_b"])
    h = y @ p["w1"].reshape(c, 2 * c) + p["b1"]
    h = dwconv(h, p["dw"]) + p["dwb"]
    return h[..., :c] * h[..., c:]


def _pair_sums(lib, x, kw, rows=None, nsplit=3):
    b, hgt, wdt, c = x.shape
    part = torch.empty(b, nsplit, kw["cpad"])
    args = (nb._ptr(x), nb._ptr(kw["ln1w"]), nb._ptr(kw["ln1b"]),
            nb._ptr(kw["w1"]), nb._ptr(kw["b1"]), nb._ptr(kw["taps"]),
            nb._ptr(kw["dwb"]), nb._ptr(part), b, hgt, wdt, c, kw["cpad"],
            int(x.dtype == BF), 2, 4, nsplit)
    rc = (lib.nafblock_sum(*args, None) if rows is None
          else lib.nafblock_sum_rows(*args, *rows, None))
    assert rc == 0
    return part


@pytest.mark.parametrize("rows", WINDOWS)
def test_nafblock_sum_window_equals_plain_sums(host_lib, rows):
    _, p, kw, x = _block(SHAPE, seed=1, dtype=torch.float32)
    got = _pair_sums(host_lib, x, kw, rows).sum(1)[:, : SHAPE[-1]]
    want = _plain_gate(x, p)[:, rows[0]: rows[1]].sum((1, 2))
    assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_nafblock_sum_without_window_is_the_whole_tensor(host_lib):
    """`nafblock_sum` (what every unsharded call runs) bit-equal to the
    windowed entry over every row, in both dtypes; a window past the
    tensor is refused."""
    for dtype in (torch.float32, BF):
        _, _, kw, x = _block(SHAPE, seed=2, dtype=dtype)
        assert torch.equal(_pair_sums(host_lib, x, kw),
                           _pair_sums(host_lib, x, kw, (0, SHAPE[1])))
    b, hgt, wdt, c = SHAPE
    assert host_lib.nafblock_sum_rows(
        *[None] * 8, b, hgt, wdt, c, 32, 0, 2, 4, 3, 3, hgt + 1, None) != 0


def _hids(lib, x, kw):
    """conv1's output with its bias, W1's interleaved chunks (bf16), as
    the pipeline's first product makes it."""
    b, hgt, wdt, c = x.shape
    npix = b * hgt * wdt
    ys = _ln_rows(lib, x, kw["ln1w"], kw["ln1b"], 0, 0, nb._EPS)[0]
    hids = torch.empty(npix, 2 * kw["cpad"], dtype=BF)
    assert lib.naf_gemm_bias(
        nb._ptr(ys), nb._ptr(kw["w1"]), nb._ptr(kw["b1i"]), None, None,
        nb._ptr(hids), npix, 2 * kw["cpad"], c, None) == 0
    return hids


def _gate_sums(lib, hids, kw, shape, rows=None, nsplit=3):
    b, hgt, wdt, _ = shape
    part = torch.empty(b, nsplit, kw["cpad"])
    args = (nb._ptr(hids), nb._ptr(kw["taps"]), nb._ptr(kw["dwb"]), None,
            None, nb._ptr(part), b, hgt, wdt, kw["cpad"], nsplit, 0)
    rc = (lib.naf_gate_stencil(*args, None) if rows is None
          else lib.naf_gate_stencil_rows(*args, *rows, None))
    assert rc == 0
    return part


@pytest.mark.parametrize("rows", WINDOWS)
def test_gate_stencil_window_equals_plain_sums(host_lib, rows):
    """The SUM pass's sums over the window against the float32 sums of the
    same rounded gate values, which the APPLY pass writes with a scale of
    1."""
    _, _, kw, x = _block(SHAPE, seed=3)
    b, hgt, wdt, c = SHAPE
    hids = _hids(host_lib, x, kw)
    got = _gate_sums(host_lib, hids, kw, SHAPE, rows).sum(1)
    gs = torch.empty(b * hgt * wdt, kw["cpad"], dtype=BF)
    assert host_lib.naf_gate_stencil(
        nb._ptr(hids), nb._ptr(kw["taps"]), nb._ptr(kw["dwb"]),
        nb._ptr(torch.ones(b, kw["cpad"])), nb._ptr(gs), None, b, hgt, wdt,
        kw["cpad"], 3, 1, None) == 0
    gate = gs.float().reshape(b, hgt, wdt, -1)
    want = gate[:, rows[0]: rows[1]].sum((1, 2))
    assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert not got[:, c:].any()


def test_gate_stencil_without_window_is_the_whole_tensor(host_lib):
    _, _, kw, x = _block(SHAPE, seed=4)
    hids = _hids(host_lib, x, kw)
    assert torch.equal(_gate_sums(host_lib, hids, kw, SHAPE),
                       _gate_sums(host_lib, hids, kw, SHAPE, (0, SHAPE[1])))
    b, hgt, wdt, _ = SHAPE
    assert host_lib.naf_gate_stencil_rows(
        *[None] * 6, b, hgt, wdt, 32, 3, 0, 5, 4, None) != 0


def _two_ranks(t):
    """The sum over two ranks that hold the same slab."""
    t.mul_(2.0)


@pytest.mark.parametrize("dtype,c", [(BF, 64), (BF, 36), (torch.float32,
                                                           32)])
@pytest.mark.parametrize("rows", [(1, 9), (0, 11)])
def test_forward_with_window_and_reduce_equals_plain(host_lib, monkeypatch,
                                                    dtype, c, rows):
    """`_forward_kernel` with a window, a reduction and the whole image's
    pixel count (bf16 at C % 8 == 0: the pipeline, whose glue takes the
    reduced sums as one partial; C = 36 and float32: the pair) against the
    plain version with the same window and reduction; the pipeline and
    the pair bit-equal where both take the shape."""
    monkeypatch.setattr(nb, "_validate", lambda x, kw: None)
    monkeypatch.setattr(nb, "_kernel_library", lambda: host_lib)
    monkeypatch.setattr(nb, "_card", lambda device: (0, 2))
    _, p, kw, x = _block((1, 11, 10, c), seed=c + rows[0], dtype=dtype)
    pixels = 2 * (rows[1] - rows[0]) * x.shape[2]
    seen = []

    def reduce(t):
        seen.append(t.shape)
        _two_ranks(t)

    got = nb._forward_kernel(x, kw, rows, reduce, pixels)
    assert len(seen) == 1
    want = nb._nafblock_ffn_part(
        nb._nafblock_conv_part(x, p, rows, _two_ranks, pixels), p)
    if dtype == torch.float32:
        assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert _branch(got, want, x) <= REF_BRANCH
        diff = (got.float() - want.float()).abs()
        assert (diff <= REF_ATOL * want.float().abs().max()
                + REF_RTOL * want.float().abs()).all()
    if dtype == BF and c % 8 == 0:
        sum_tile, apply_tile = nb.pick_tiles(host_lib, c, 2)
        pair = nb._launch(host_lib, x, kw, sum_tile, apply_tile, 2, 0, rows,
                          _two_ranks, pixels)
        assert torch.equal(pair, got)
    # a window that is the whole slab, reduced over one rank: the
    # unsharded block
    if rows == (0, 11):
        whole = nb._forward_kernel(x, kw)
        one = nb._forward_kernel(x, kw, rows, lambda t: None,
                                 11 * x.shape[2])
        assert torch.equal(one, whole)
