"""PyTorch port vs JAX package: the probes of the whole-block kernel's
linear + depthwise stage (B9).

Chain of custody on the CPU:
* the port's plain versions (`qkv_current_ref`, `qkv_composed_ref`,
  `stencil_ref`, `qkv_form_oracle`, `compose_w9`) against the JAX tools'
  own Pallas kernels, tools/bench_qkv_form.py `_run_pallas` with
  `_kernel_current` / `_kernel_composed` and tools/bench_stencil.py
  `make_kernel`, interpreted (`force_tpu_interpret_mode`).  The tools are
  loaded from their files as they are, inside a patched environment, since
  both set defaults in `os.environ` at import;
* the CUDA sources csrc/probe_qkv_form.cu and csrc/probe_stencil.cu
  themselves, compiled for the host with tests/cuda_host_shim.h, against
  the plain versions, through the launch code the CUDA path uses;
* the wrappers' refusal of CPU tensors, and the two port tools on the CPU.
The on-card checks are in tests/test_torch_probes_cuda.py.
"""

import importlib.util
import json
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import textualdegremoval_tpu_torch.ops.probes as pr
from textualdegremoval_tpu_torch.tools import bench_qkv_form, bench_stencil

from torch_port_util import randn, t, assert_close, build_host_library

TOOLS = Path(__file__).resolve().parents[1] / "tools"

# bf16, plain version vs the interpreted JAX kernel: both take the same
# bf16 inputs and round at the same points; the f32 sums between them may
# run in another order and flip a rounding by one bf16 ulp (2^-8 of the
# value).  Measured here: bitwise equal at every shape below.
BF16_ULP = 2.0 ** -8


def _load_jax_tool(name: str):
    """tools/<name>.py as a module, its import-time environment defaults
    kept out of this process's environment."""
    with mock.patch.dict(os.environ):
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jqkv():
    return _load_jax_tool("bench_qkv_form")


@pytest.fixture(scope="module")
def jstencil():
    return _load_jax_tool("bench_stencil")


def _qkv_inputs(c, co, shape, seed):
    """x (B, H, W, C), w (C, co), dw (9, co) at the tool's scales."""
    rng = np.random.default_rng(seed)
    return (randn(rng, *shape, c), randn(rng, c, co, scale=c ** -0.5),
            randn(rng, 9, co, scale=1 / 3))


def _assert_bf16_close(got, want):
    """Within one bf16 ulp of the value, elementwise (BF16_ULP)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert_close(got, want, atol=BF16_ULP * np.abs(want).max(),
                 rtol=BF16_ULP)


def test_compose_w9_matches_jax_construction():
    x, w, dw = _qkv_inputs(12, 20, (1, 2, 2), seed=1)
    c = w.shape[0]
    want = jnp.repeat(dw, c, axis=0).reshape(9 * c, 20) * jnp.tile(w, (9, 1))
    assert np.array_equal(pr.compose_w9(t(w), t(dw)).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("shape", [(1, 9, 11), (2, 6, 5)])
def test_oracle_matches_jax_oracle(jqkv, shape):
    x, w, dw = _qkv_inputs(8, 12, shape, seed=shape[1])
    got = pr.qkv_form_oracle(t(x), t(w), t(dw))
    assert_close(got, jqkv.oracle(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(dw)))


def _jax_qkv(jqkv, form, x, w, dw, tile, dtype):
    """The TPU tool's kernel of `form`, interpreted, on x in `dtype` (W in
    `dtype` and the taps f32 for current, W9 in `dtype` for composed)."""
    b, h, wd, c = x.shape
    co = w.shape[1]
    xj = jnp.asarray(x).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        if form == "current":
            kern = jqkv._kernel_current(tile, wd, c, co)
            ws = [jnp.asarray(w).astype(dtype), jnp.asarray(dw)]
        else:
            kern = jqkv._kernel_composed(tile, wd, c, co)
            w9 = (jnp.repeat(jnp.asarray(dw), c, axis=0).reshape(9 * c, co)
                  * jnp.tile(jnp.asarray(w), (9, 1)))
            ws = [w9.astype(dtype)]
        y = jqkv._run_pallas(kern, xj, ws, tile, co)
    return np.asarray(y.astype(jnp.float32))


def _port_qkv(form, x, w, dw, dtype):
    xt = t(x).to(dtype)
    if form == "current":
        return pr.qkv_current_ref(xt, t(w), t(dw))
    return pr.qkv_composed_ref(xt, pr.compose_w9(t(w), t(dw)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["current", "composed"])
@pytest.mark.parametrize("shape,c,co,tile", [
    ((1, 16, 16), 8, 16, 4),    # the row tiles of the TPU kernel: 4
    ((2, 8, 12), 16, 24, 4),    # batch 2, co not a multiple of 8
])
def test_qkv_ref_matches_jax_pallas_interpret(jqkv, form, dtype, shape, c,
                                              co, tile):
    x, w, dw = _qkv_inputs(c, co, shape, seed=c + co)
    want = _jax_qkv(jqkv, form, x, w, dw, tile, getattr(jnp, dtype))
    got = _port_qkv(form, x, w, dw, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        # f32, the sums in other orders (row tiles, one K = 9C dot)
        assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _assert_bf16_close(got.float(), want)


def test_qkv_forms_agree_with_oracle():
    """In f32 both forms compute the oracle's function (sums in other
    orders); in bf16 they differ from it by their roundings: lin (current)
    and W9 (composed) in bf16, then the output."""
    x, w, dw = _qkv_inputs(16, 24, (1, 10, 9), seed=3)
    want = pr.qkv_form_oracle(t(x), t(w), t(dw))
    for form in ("current", "composed"):
        assert_close(_port_qkv(form, x, w, dw, torch.float32), want.numpy(),
                     atol=1e-5, rtol=1e-5)
        got = _port_qkv(form, x, w, dw, torch.bfloat16).float()
        rel = (got - want).abs().max() / want.abs().max()
        assert rel < 2e-2, (form, rel.item())


def _jax_stencil(jstencil, variant, x, taps, iters):
    """The TPU tool's `make_kernel` with ITERS = iters, interpreted, as
    its `run` calls it (without the sum)."""
    rows, wd, ch = x.shape
    with mock.patch.object(jstencil, "ITERS", iters), \
            pltpu.force_tpu_interpret_mode():
        y = pl.pallas_call(
            jstencil.make_kernel(variant, rows - 2, wd, ch),
            out_shape=jax.ShapeDtypeStruct((rows - 2, wd, ch), jnp.bfloat16),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(taps))
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("variant", pr.VARIANTS)
def test_stencil_ref_matches_jax_pallas_interpret(jstencil, variant, iters):
    rng = np.random.default_rng(iters)
    x = randn(rng, 6, 12, 8)
    taps = randn(rng, 9, 8)
    want = _jax_stencil(jstencil, variant, x, taps, iters)
    got = pr.stencil_ref(t(x).bfloat16(), t(taps), variant, iters)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 12, 8)
    _assert_bf16_close(got.float(), want)


def test_stencil_ref_f32_concat_is_the_depthwise_conv():
    """One concat step (f32 sums of a bf16 slab) is the 3x3 depthwise conv
    of the slab in f32, no padding in y and zero padding in x, rounded to
    bf16 (within one ulp: the sums run in other orders)."""
    rng = np.random.default_rng(4)
    x, taps = t(randn(rng, 7, 9, 5)).bfloat16(), t(randn(rng, 9, 5))
    got = pr.stencil_ref(x, taps, "concat", 1)
    k = taps.reshape(3, 3, 5).permute(2, 0, 1)[:, None]
    want = torch.nn.functional.conv2d(x.float().permute(2, 0, 1)[None], k,
                                      padding=(0, 1), groups=5)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float(), want[0].permute(1, 2, 0))


def test_stencil_ref_refuses_f32_for_bf16_variants():
    """Every variant takes a bf16 slab, as the TPU tool gives it."""
    x, taps = torch.zeros(4, 5, 2), torch.zeros(9, 2)
    for variant in pr.VARIANTS:
        with pytest.raises(ValueError, match="bfloat16"):
            pr.stencil_ref(x, taps, variant, 1)
    with pytest.raises(ValueError, match="unknown variant"):
        pr.stencil_ref(x.bfloat16(), taps, "roll", 1)


def test_wrappers_refuse_cpu_tensors():
    x, w, dw = (t(a) for a in _qkv_inputs(8, 8, (1, 4, 4), seed=5))
    kw = pr.prepare_qkv_weights(w, dw, torch.float32)
    before = (pr.qkv_current.launches, pr.qkv_composed.launches,
              pr.stencil_loop.launches)
    with pytest.raises(ValueError, match="CUDA"):
        pr.qkv_current(x, kw)
    with pytest.raises(ValueError, match="CUDA"):
        pr.qkv_composed(x, kw)
    with pytest.raises(ValueError, match="CUDA"):
        pr.stencil_loop(torch.zeros(4, 5, 2, dtype=torch.bfloat16),
                        torch.zeros(9, 2), "concat", 1)
    assert (pr.qkv_current.launches, pr.qkv_composed.launches,
            pr.stencil_loop.launches) == before


@pytest.fixture(scope="module")
def host_probe_lib(tmp_path_factory):
    """csrc/probe_qkv_form.cu and csrc/probe_stencil.cu compiled for the
    CPU against tests/cuda_host_shim.h (tblock.cu too, for the error
    strings)."""
    return build_host_library(tmp_path_factory.mktemp("host_probes"),
                              ("probe_qkv_form.cu", "probe_stencil.cu",
                               "tblock.cu"))


@pytest.mark.parametrize("form", ["current", "composed"])
@pytest.mark.parametrize("shape,c,co,tile,dtype", [
    ((1, 7, 9), 8, 12, (4, 4), torch.float32),      # ragged edge tiles
    ((2, 5, 6), 12, 20, (8, 8), torch.float32),     # tile > image
    ((1, 6, 5), 6, 70, (2, 4), torch.float32),      # two lin chunks; odd K
    ((1, 9, 10), 16, 24, (4, 8), torch.bfloat16),   # tensor cores, 16B rows
    ((1, 5, 7), 32, 72, (2, 2), torch.bfloat16),    # two lin chunks
    ((2, 4, 5), 6, 8, (1, 4), torch.bfloat16),      # K % 16: FMA loops
])
def test_qkv_cuda_source_on_host_matches_ref(host_probe_lib, form, shape, c,
                                             co, tile, dtype):
    x, w, dw = (t(a) for a in _qkv_inputs(c, co, shape, seed=c * co))
    x = x.to(dtype)
    kw = pr.prepare_qkv_weights(w, dw, dtype)
    got = pr._launch_qkv(host_probe_lib, form, x, kw, tile, 0)
    want = _port_qkv(form, x.float().numpy(), w.numpy(), dw.numpy(), dtype)
    assert got.dtype == dtype and got.shape == (*shape, co)
    if dtype == torch.float32:
        assert_close(got, want.numpy(), atol=1e-5, rtol=1e-5)
    else:
        # the kernel's f32 sums run in another order than the plain
        # product's: lin (current) or the output may round the other way
        # by one bf16 ulp, and a flipped lin moves the output by a tap
        # times an ulp of lin
        _assert_bf16_close(got.float(), want.float())


@pytest.mark.parametrize("variant,iters,wd", [
    ("concat", 3, 13),                      # odd W
    ("concat", 2, 12),
    ("bf16acc", 3, 12),
    ("bf16acc", 2, 9),                      # odd W: a half pair
    ("mulonly", 2, 10),
    ("mulonly", 1, 7),
    ("mulonly_bf16", 3, 11),
    ("concat", 0, 6),                       # no iteration: x[2:]
])
def test_stencil_cuda_source_on_host_matches_ref(host_probe_lib, variant,
                                                 iters, wd):
    rng = np.random.default_rng(wd + iters)
    x, taps = t(randn(rng, 5, wd, 3)).bfloat16(), t(randn(rng, 9, 3))
    got = pr._launch_stencil(host_probe_lib, x, taps, variant, iters, 0)
    want = pr.stencil_ref(x, taps, variant, iters)
    assert got.dtype == torch.bfloat16 and got.shape == (3, wd, 3)
    if variant in pr.BF16_VARIANTS:
        # the shim rounds each packed product and sum as torch's bf16 ops
        assert torch.equal(got, want)
    else:
        # f32 sums in the same order; a flipped bf16 rounding of one step
        # feeds the next
        _assert_bf16_close(got.float(), want.float())


def test_stencil_kernel_refuses_f32_for_bf16_variants(host_probe_lib):
    """The kernel takes a bf16 slab only, in every variant."""
    x, taps = torch.zeros(4, 6, 2), torch.zeros(9, 2)
    for variant in pr.VARIANTS:
        with pytest.raises(RuntimeError, match="stencil_loop"):
            pr._launch_stencil(host_probe_lib, x, taps, variant, 1, 0)


def test_qkv_tool_runs_on_cpu(capsys):
    with mock.patch.multiple(bench_qkv_form, PX=16, ITERS=1, REPEATS=1):
        rows = bench_qkv_form.main(["--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["case"] for r in rows] == [
        f"16px {c}->{co}" for c, co in bench_qkv_form.CASES]
    for r in rows:
        assert r["device"] == "cpu" and r["rel_err_current"] < 2e-2 \
            and r["rel_err_composed"] < 2e-2
    assert len(lines) == len(rows) + 2   # the space-to-depth lines


def test_stencil_tool_runs_on_cpu(capsys):
    res = bench_stencil.main(["16", "4", "2", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["variant"] for r in res["rows"]] == list(pr.VARIANTS)
    assert all(r["us_per_stencil"] > 0 and r["device"] == "cpu"
               for r in res["rows"])
    assert res["cudnn_us"] > 0 and res["peak_tflops"] is None
    assert out.count("us/stencil") == 4


def test_tools_default_to_the_card():
    for tool in (bench_qkv_form, bench_stencil):
        assert tool.parse_args([]).device == "cuda"
