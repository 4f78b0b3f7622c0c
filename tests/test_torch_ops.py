"""PyTorch port vs JAX package: plain ops, metrics, data helpers, and the
port's independence from JAX.  f32 on CPU, atol/rtol 1e-5 unless noted."""

import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import textualdegremoval_tpu.ops.norm as jnorm
import textualdegremoval_tpu.ops.resize as jresize
from textualdegremoval_tpu.ops.attention import mdta_attention_nhwc as j_mdta
from textualdegremoval_tpu.ops.dwconv import dwconv_shift as j_dwconv
from textualdegremoval_tpu.ops.pallas.gdfn import gdfn_ref as j_gdfn_ref

from textualdegremoval_tpu_torch.ops import (
    bias_free_layer_norm, with_bias_layer_norm, pixel_shuffle,
    pixel_unshuffle, pad_to_multiple, mdta_attention_nhwc, dwconv,
)
from textualdegremoval_tpu_torch.ops.pallas.gdfn import gdfn_ref, gelu_exact

from torch_port_util import randn, t, assert_close


@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_layer_norm(ln_type):
    rng = np.random.default_rng(0)
    x = randn(rng, 2, 5, 7, 12) + 0.5
    w, b = randn(rng, 12), randn(rng, 12)
    if ln_type == "WithBias":
        got = with_bias_layer_norm(t(x), t(w), t(b))
        want = jnorm.with_bias_layer_norm(x, w, b)
    else:
        got = bias_free_layer_norm(t(x), t(w))
        want = jnorm.bias_free_layer_norm(x, w)
    assert_close(got, want)


def test_pixel_shuffle_orders_channels_as_jax():
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 4, 6, 12)
    assert_close(pixel_unshuffle(t(x), 2), jresize.pixel_unshuffle(x, 2),
                 atol=0, rtol=0)
    assert_close(pixel_shuffle(t(x), 2), jresize.pixel_shuffle(x, 2),
                 atol=0, rtol=0)
    assert_close(pixel_shuffle(pixel_unshuffle(t(x), 2), 2), x, atol=0, rtol=0)


@pytest.mark.parametrize("hw", [(5, 7), (8, 16)])
def test_pad_to_multiple(hw):
    x = randn(np.random.default_rng(2), 1, *hw, 3)
    got = pad_to_multiple(t(x), 8)
    assert_close(got, jresize.pad_to_multiple(x, 8), atol=0, rtol=0)


@pytest.mark.parametrize("heads", [1, 2])
def test_mdta_attention_nhwc(heads):
    rng = np.random.default_rng(3)
    q, k, v = (randn(rng, 2, 5, 6, 8) for _ in range(3))
    temp = (1 + 0.3 * np.arange(heads, dtype=np.float32)).reshape(heads, 1, 1)
    got = mdta_attention_nhwc(t(q), t(k), t(v), t(temp), heads)
    assert_close(got, j_mdta(q, k, v, temp, heads))


def test_dwconv():
    rng = np.random.default_rng(4)
    x = randn(rng, 2, 6, 7, 5)
    k = randn(rng, 3, 3, 1, 5)
    assert_close(dwconv(t(x), t(k)), j_dwconv(x, k))


def test_gelu_exact_and_gdfn_ref():
    rng = np.random.default_rng(5)
    z = randn(rng, 64, scale=3.0)
    assert_close(gelu_exact(t(z)), jax.nn.gelu(z, approximate=False))
    c, h = 8, 21
    x = randn(rng, 1, 5, 6, c)
    w1 = randn(rng, c, 2 * h, scale=0.3)
    dwk = randn(rng, 3, 3, 2 * h, scale=0.3)
    w2 = randn(rng, h, c, scale=0.3)
    assert_close(gdfn_ref(t(x), t(w1), t(dwk), t(w2)),
                 j_gdfn_ref(jnp.asarray(x), w1, dwk, w2))


def test_psnr_ssim_match_jax():
    from textualdegremoval_tpu.metrics.psnr_ssim import (
        calculate_psnr as j_psnr, calculate_ssim as j_ssim)
    from textualdegremoval_tpu_torch.metrics import (
        calculate_psnr, calculate_ssim)

    rng = np.random.default_rng(6)
    a = rng.random((24, 20, 3)) * 255
    b = np.clip(a + rng.standard_normal(a.shape) * 10, 0, 255)
    assert abs(calculate_psnr(a, b) - j_psnr(a, b)) < 1e-9
    # the JAX SSIM filters in f32, the port in f64
    assert abs(calculate_ssim(a, b) - j_ssim(a, b)) < 1e-5
    assert calculate_psnr(a, a) == float("inf")


def test_scan_images_and_imread(tmp_path):
    import cv2
    from textualdegremoval_tpu.data.pairing import scan_images as j_scan
    from textualdegremoval_tpu.data.datasets import imread_f32 as j_imread
    from textualdegremoval_tpu_torch.data import imread_f32, scan_images

    rng = np.random.default_rng(7)
    (tmp_path / "sub").mkdir()
    cv2.imwrite(str(tmp_path / "b.png"),
                (rng.random((5, 6, 3)) * 255).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "sub" / "a.png"),
                (rng.random((5, 6, 3)) * 65535).astype(np.uint16))
    (tmp_path / "notes.txt").write_text("x")
    paths = scan_images(str(tmp_path))
    assert paths == j_scan(str(tmp_path)) and len(paths) == 2
    assert_close(imread_f32(paths[0]), j_imread(paths[0]), atol=0, rtol=0)
    assert_close(imread_f32(paths[1], bit16=True),
                 j_imread(paths[1], bit16=True), atol=0, rtol=0)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import textualdegremoval_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'textualdegremoval_tpu')]\n"
        "assert not bad, bad\n"
        "# the card's machine may lack them: imported where used only\n"
        "late = [m for m in ('cv2', 'yaml') if m in sys.modules]\n"
        "assert not late, late\n"
        "print('ok', len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
