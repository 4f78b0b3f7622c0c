"""PyTorch port vs JAX package: the utilities (MATLAB colour conversions,
imresize and crop_border, flow warping, tiled inference, profiling).

`utils/matlab.py`, `utils/imresize.py` and `crop_border` are the same
numpy in both packages: equal bit for bit.  `flow_warp` gathers the four
corners as JAX does: nearest equal bit for bit, bilinear within 1e-6.
`resize_flow` is jax.image.resize through the port's `image_resize`
(float32 weights in both; within 1e-5).  `infer_tiled` blends on the
LQ's device in float32 in JAX's order: equal bit for bit to JAX's with
the identity, and within the network's bound (2e-4, as
tests/test_torch_restormer.py holds whole models) through a tiny
RestormerRefFusion on weights converted from the port's.  C13: JAX's
`infer_tiled` raises where one side of the image fits the tile and the
other does not; the port tiles that shape.
"""

import glob
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp
from jax import lax

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.models.restormer import (
    Restormer as JRestormer, RestormerRefFusion as JRestormerRefFusion)
from textualdegremoval_tpu.ops import flow as jflow
from textualdegremoval_tpu.utils import imresize as jimresize
from textualdegremoval_tpu.utils import matlab as jmatlab
from textualdegremoval_tpu.utils import profiling as jprof
from textualdegremoval_tpu.utils import tiled as jtiled
from textualdegremoval_tpu.utils.image import crop_border as jcrop_border

from textualdegremoval_tpu_torch.models.restormer import (
    Restormer, RestormerRefFusion)
from textualdegremoval_tpu_torch.ops import flow
from textualdegremoval_tpu_torch.utils import imresize, matlab, profiling
from textualdegremoval_tpu_torch.utils.image import crop_border
from textualdegremoval_tpu_torch.utils.tiled import infer_tiled

from test_torch_restormer import TINY, TINY_REF
from torch_port_util import randomize, randn, t, torch_share


def _image(shape, seed, uint8=False):
    img = np.random.default_rng(seed).random(shape)
    return (img * 255).round().astype(np.uint8) if uint8 \
        else img.astype(np.float32)


@pytest.mark.parametrize("fn,kw", [
    ("rgb2ycbcr", {}), ("rgb2ycbcr", {"y_only": True}),
    ("bgr2ycbcr", {}), ("bgr2ycbcr", {"y_only": True}),
    ("ycbcr2rgb", {}), ("to_y_channel", {}),
])
@pytest.mark.parametrize("uint8", [False, True])
def test_matlab_colour_matches_jax(fn, kw, uint8):
    img = _image((9, 11, 3), seed=1, uint8=uint8)
    if fn == "to_y_channel":
        img = img.astype(np.float64) * (1 if uint8 else 255)
    want = getattr(jmatlab, fn)(img, **kw)
    got = getattr(matlab, fn)(img, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(33, 41), (33, 41, 3)])
@pytest.mark.parametrize("kw", [{"scale": 1 / 4}, {"scale": 1 / 3},
                                {"scale": 2}, {"out_shape": (20, 17)}])
def test_imresize_matches_jax(shape, kw):
    img = _image(shape, seed=2).astype(np.float64)
    want = jimresize.imresize(img, **kw)
    got = imresize.imresize(img, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("border", [0, 3])
def test_crop_border_matches_jax(border):
    img = _image((12, 10, 3), seed=3)
    np.testing.assert_array_equal(crop_border(img, border),
                                  jcrop_border(img, border))


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp_matches_jax(mode, padding):
    """Odd H x W; flows up to 5 px, so samples leave the image, plus exact
    half-pixel offsets where nearest rounds half to even."""
    rng = np.random.default_rng(4)
    x = randn(rng, 2, 13, 11, 3)
    fl = randn(rng, 2, 13, 11, 2, scale=5.0)
    fl[0, :4] = np.round(fl[0, :4]) + 0.5
    want = np.asarray(jflow.flow_warp(jnp.asarray(x), jnp.asarray(fl),
                                      mode, padding))
    got = flow.flow_warp(t(x), t(fl), mode, padding).numpy()
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("size_type,sizes", [
    ("ratio", (0.5, 0.25)), ("ratio", (2, 3)),
    ("shape", (7, 19)), ("shape", (30, 10))])
def test_resize_flow_matches_jax(size_type, sizes, mode):
    fl = randn(np.random.default_rng(5), 2, 16, 12, 2, scale=3.0)
    want = np.asarray(jflow.resize_flow(jnp.asarray(fl), size_type, sizes,
                                        mode))
    got = flow.resize_flow(t(fl), size_type, sizes, mode).numpy()
    assert got.shape == want.shape
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tiled_identity_matches_jax():
    img = _image((1, 70, 90, 3), seed=6)
    want = jtiled.infer_tiled(lambda a: a, jnp.asarray(img), tile=32,
                              overlap=8)
    got = infer_tiled(lambda a: a, t(img), tile=32, overlap=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, img, atol=1e-6, rtol=0)


def test_tiled_small_image_passthrough():
    got = infer_tiled(lambda a: [a, 2 * a], torch.ones(1, 16, 16, 3),
                      tile=32)
    np.testing.assert_array_equal(got, np.full((1, 16, 16, 3), 2.0))


def test_tiled_conv_matches_jax():
    """A 3x3 conv per tile: each tile's border sees zero padding, which the
    overlap ramps blend away as in JAX."""
    rng = np.random.default_rng(7)
    img = _image((1, 70, 90, 3), seed=8)
    w = randn(rng, 3, 3, 3, 3, scale=0.3)  # HWIO, C in = C out as JAX needs
    jfwd = jax.jit(lambda a: lax.conv_general_dilated(
        a, jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    wt = t(w).permute(3, 2, 0, 1)

    def fwd(a):
        return F.conv2d(a.permute(0, 3, 1, 2), wt, padding=1).permute(
            0, 2, 3, 1)
    want = jtiled.infer_tiled(jfwd, jnp.asarray(img), tile=32, overlap=8)
    got = infer_tiled(fwd, t(img), tile=32, overlap=8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tiled_ref_fusion_matches_jax():
    """The config of tests/test_tiled.py: 96 x 96 at tile 64, overlap 16
    (four tiles), the 64 x 64 reference whole to each."""
    m = randomize(RestormerRefFusion(**TINY_REF), seed=9).eval()
    rng = np.random.default_rng(10)
    lq, ref = randn(rng, 1, 96, 96, 3), randn(rng, 1, 64, 64, 3)
    params = {"params": convert_state_dict(m.state_dict())}
    jfwd = jax.jit(lambda a, b: JRestormerRefFusion(**TINY_REF).apply(
        params, a, b))
    want = jtiled.infer_tiled(jfwd, jnp.asarray(lq), jnp.asarray(ref),
                              tile=64, overlap=16)
    with torch_share(), torch.no_grad():
        got = infer_tiled(m, t(lq), t(ref), tile=64, overlap=16)
    assert got.shape == want.shape == (1, 96, 96, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_c13_jax_infer_tiled_fails_where_one_side_fits_the_tile():
    """C13: on (1, 20, 70, 3) at tile 32, JAX's single row of tiles is 20
    rows tall while its blend weight stays 32 x 32, so JAX raises; the
    port covers the 20 rows with one tile whose ramp is cut to 20, and the
    identity comes back to f32 rounding."""
    img = _image((1, 20, 70, 3), seed=11)
    with pytest.raises(ValueError, match="could not be broadcast"):
        jtiled.infer_tiled(lambda a: a, jnp.asarray(img), tile=32,
                           overlap=8)
    got = infer_tiled(lambda a: a, t(img), tile=32, overlap=8)
    np.testing.assert_allclose(got, img, atol=1e-6, rtol=0)
    tiles = []
    infer_tiled(lambda a: tiles.append(a.shape) or a, t(img), tile=32,
                overlap=8)
    assert tiles == [(1, 20, 32, 3)] * 3


def test_count_params_and_matmul_flops_match_jax():
    w = torch.ones(64, 32)
    x = torch.ones(8, 64)
    assert profiling.count_params([w]) == jprof.count_params(
        {"w": jnp.ones((64, 32))}) == 64 * 32
    want = jprof.model_complexity(lambda p, a: a @ p["w"],
                                  {"w": jnp.ones((64, 32))},
                                  jnp.ones((8, 64)))
    got = profiling.model_complexity(lambda a, b: a @ b, x,
                                     torch.nn.Parameter(w))
    assert got == want == {"params": 64 * 32, "flops": 2 * 8 * 64 * 32,
                           "macs": 8 * 64 * 32}


class _ProductLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums 2 x (multiply-adds) of every convolution and matrix product
    the forward dispatches, from their shapes."""

    flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        if func is aten.convolution.default:
            w = args[1]
            self.flops += 2 * out.numel() * w[0].numel()
        elif func in (aten.mm.default, aten.addmm.default,
                      aten.bmm.default, aten.baddbmm.default):
            self.flops += 2 * out.numel() * args[-2].shape[-1]
        return out


def test_tiny_restormer_params_and_flops(capsys):
    """count_params equals JAX's on the converted tiny Restormer; the
    port's flops are the sum of its convolutions' and products' 2 x MACs,
    counted from shapes on the plain route (XLA's cost analysis, which
    also counts elementwise work, is logged beside)."""
    m = randomize(Restormer(**TINY), seed=12).eval()
    x = t(randn(np.random.default_rng(13), 1, 32, 32, 3))
    params = convert_state_dict(m.state_dict())
    assert profiling.count_params(m) == jprof.count_params(params) > 1000
    log = _ProductLog()
    with torch_share():
        got = profiling.model_complexity(m, x)
        with log, torch.no_grad():
            m(x)
    assert got["params"] == profiling.count_params(m)
    assert got["flops"] == log.flops > 1e6
    want = jprof.model_complexity(
        lambda p, a: JRestormer(**TINY).apply({"params": p}, a), params,
        jnp.asarray(x.numpy()))
    with capsys.disabled():
        print(f"\ntiny Restormer 32 x 32: port flops {got['flops']:.0f} "
              f"(ATen products), JAX {want['flops']:.0f} (XLA)")
    assert want["params"] == got["params"]


def test_model_complexity_refuses_cuda_arguments():
    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.ones(2, 2).as_subclass(CudaLike)
    with pytest.raises(ValueError, match="plain route"):
        profiling.model_complexity(lambda a: a, x)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    assert "aten::matmul" in open(files[0]).read()


def test_measure_inference_speed_is_positive():
    x = torch.ones(3, 8, 8, 4)
    rate = profiling.measure_inference_speed(lambda a: (a * 2, a), (x,),
                                             max_iter=4, warmup_iter=1)
    assert np.isfinite(rate) and rate > 0
