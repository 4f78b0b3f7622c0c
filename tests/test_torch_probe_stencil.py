"""PyTorch port vs JAX package: the stencil probe's kernel
(csrc/probe_stencil.cu: the rows in registers, x-neighbours by warp
shuffles, the pixels at a warp's ends through shared memory), compiled for
the host with tests/cuda_host_shim.h and run through the wrapper's launch
code, against the plain `stencil_ref` and against the TPU tool's
`make_kernel` (tools/bench_stencil.py) interpreted.

Shapes with more than one warp a channel (W > 128: 4 pixels a lane), W odd
and not a multiple of 32, t past the 8 rows of the smaller register set,
and one or two channels; every variant after 1-4 iterations.  The bf16
variants round every packed product and sum as torch's bf16 ops do (the
shim rounds each half so): bitwise equal to the plain version.  The f32
variants sum the same products in the same (dy, dx) order, rounded to bf16
once a step: within one bf16 ulp of the value (`_assert_bf16_close`), as
in tests/test_torch_probes.py.
"""

import numpy as np
import pytest
import torch

import textualdegremoval_tpu_torch.ops.probes as pr
from textualdegremoval_tpu_torch.ops.pallas.tblock import _ptr

from torch_port_util import randn, t, build_host_library
from test_torch_probes import _assert_bf16_close, _jax_stencil, _load_jax_tool


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/probe_stencil.cu compiled for the CPU (tblock.cu too, for the
    error strings)."""
    return build_host_library(tmp_path_factory.mktemp("host_stencil"),
                              ("probe_stencil.cu", "tblock.cu"))


@pytest.fixture(scope="module")
def jtool():
    return _load_jax_tool("bench_stencil")


def _inputs(rows, wd, ch, seed):
    rng = np.random.default_rng(seed)
    return t(randn(rng, rows, wd, ch)).bfloat16(), t(randn(rng, 9, ch))


def _check(got, want, variant):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if variant in pr.BF16_VARIANTS:
        assert torch.equal(got, want)
    else:
        _assert_bf16_close(got.float(), want.float())


# (t, W, ch): two warps and an odd W (the warp edge at 127 | 128); W not a
# multiple of 32 at t = 8, two warps; t = 10 (the 16-row register set),
# three warps, one channel
@pytest.mark.parametrize("tt,wd,ch", [(3, 137, 2), (8, 200, 2),
                                      (10, 300, 1)])
@pytest.mark.parametrize("variant", pr.VARIANTS)
def test_kernel_on_host_matches_ref(host_lib, variant, tt, wd, ch):
    x, taps = _inputs(tt + 2, wd, ch, seed=wd)
    for iters in (1, 2, 3, 4):
        got = pr._launch_stencil(host_lib, x, taps, variant, iters, 0)
        _check(got, pr.stencil_ref(x, taps, variant, iters), variant)


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("variant", pr.VARIANTS)
def test_kernel_on_host_matches_jax_pallas_interpret(host_lib, jtool,
                                                     variant, iters):
    """Against the TPU tool's own kernel, interpreted: two warps a channel,
    W = 133 (odd), two channels."""
    x, taps = _inputs(6, 133, 2, seed=iters)
    got = pr._launch_stencil(host_lib, x, taps, variant, iters, 0)
    want = _jax_stencil(jtool, variant, x.float().numpy(), taps.numpy(),
                        iters)
    _assert_bf16_close(got.float(), want)


def test_kernel_limits(host_lib):
    """t <= 16 rows in registers; W up to 2048 pixels at t <= 8, 1024 at
    t <= 16; the entry refuses wider rows and more rows."""
    assert [host_lib.probe_stencil_max_width(n) for n in (1, 8, 9, 16, 17)] \
        == [2048, 2048, 1024, 1024, 0]
    x, taps = _inputs(3, 8, 1, seed=0)
    out = torch.empty(1, 8, 1, dtype=torch.bfloat16)
    args = (_ptr(x), _ptr(taps), _ptr(out))
    assert host_lib.probe_stencil(*args, 1, 8, 1, 0, 1, 1, None) == 0
    assert host_lib.probe_stencil(*args, 17, 8, 1, 0, 1, 1, None) != 0
    assert host_lib.probe_stencil(*args, 9, 1025, 1, 0, 1, 1, None) != 0
