"""The port's DINOv2 tower, its JAX-style resize and the reference-crop
matcher against the JAX package.

Weights: a seeded `tests/torch_oracles.py` ODino (the reference layout) at
toy widths; the JAX side gets them through tower_maps' `convert_dino`, the
port loads the same state dict (plus DINOv2's unused mask_token) with
strict=True.  Bounds: the towers within atol 1e-4 (as
tests/test_tower_convert.py holds JAX's DINO against the oracle); the
resize within 1e-6 of jax.image.resize, and where XLA's float32 einsum on
the CPU strays further, within 1e-6 of JAX's weights applied in float64;
the matcher's crop exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.convert.tower_maps import convert_dino
from textualdegremoval_tpu.convert.torch_to_jax import load_torch_checkpoint
from textualdegremoval_tpu.models import dino as jdino
from textualdegremoval_tpu_torch.convert import load_jax_dino_params
from textualdegremoval_tpu_torch.models import dino as tdino
from textualdegremoval_tpu_torch.ops.resize import (
    _KERNELS, _resize_weights, image_resize,
)

from torch_oracles import ODino
from torch_port_util import randomize

TINY = {"img_size": 42, "patch_size": 14, "embed_dim": 32, "depth": 2,
        "num_heads": 2}


def _tiny(ffn="mlp", seed=0):
    """(port module, JAX module, JAX params, reference state dict)."""
    oracle = randomize(ODino(img_size=TINY["img_size"], patch=14,
                             dim=TINY["embed_dim"], depth=TINY["depth"],
                             heads=TINY["num_heads"], ffn=ffn), seed)
    sd = {k: v.detach().clone() for k, v in oracle.state_dict().items()}
    sd["mask_token"] = torch.zeros(1, TINY["embed_dim"])
    port = tdino.DinoVisionTransformer(**TINY, ffn_layer=ffn)
    port.load_state_dict(sd, strict=True)
    jmod = jdino.DinoVisionTransformer(**TINY, ffn_layer=ffn)
    return port.eval(), jmod, convert_dino(oracle.state_dict()), sd


@pytest.mark.parametrize("ffn", ["mlp", "swiglufused"])
@pytest.mark.parametrize("hw", [(42, 42), (28, 28), (56, 70)])
def test_dino_matches_jax(ffn, hw):
    """Grids equal to, smaller and larger than img_size // 14: the
    position embedding unchanged, or resized with JAX's bicubic."""
    port, jmod, params, _ = _tiny(ffn)
    x = np.random.default_rng(hw[0]).random((2, *hw, 3), np.float32)
    want = np.asarray(jax.jit(jmod.apply)({"params": params},
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] * hw[1] // 196, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_jax_dino_tree_loads_into_the_port():
    port, _, params, sd = _tiny("swiglufused", seed=3)
    other = tdino.DinoVisionTransformer(**TINY, ffn_layer="swiglufused")
    load_jax_dino_params(other, jax.tree.map(np.asarray, params))
    for k, v in other.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [
    ((1, 37, 37, 16), (1, 28, 28, 16)),   # vit_base's pos grid at 384 px
    ((1, 37, 37, 16), (1, 40, 33, 16)),
    ((2, 20, 30, 3), (2, 28, 42, 3)),     # an upscale of crops
    ((2, 28, 28, 3), (2, 28, 28, 3)),     # no change
])
def test_resize_matches_jax(method, src, dst):
    x = np.random.default_rng(src[1]).random(src, np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
    got = image_resize(torch.from_numpy(x), dst, method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [((2, 384, 384, 3), (2, 392, 392, 3)),
                                     ((1, 96, 120, 3), (1, 60, 50, 3))])
def test_resize_matches_jax_weights_in_float64(method, src, dst):
    """At the matcher's 384 -> 392, jax.image.resize's float32 einsum on
    the CPU strays some 2e-5 from exact sums.  The port's weight matrices
    are JAX's own (`compute_weight_mat`) within 2e-7 (the kernel and its
    normalising sum rounded in another order), and its products stay
    within 1e-6 of JAX's weights applied in float64."""
    from jax._src.image import scale as jscale

    kernel = {"bilinear": jscale._fill_triangle_kernel,
              "bicubic": jscale._fill_keys_cubic_kernel}[method]
    x = np.random.default_rng(src[2]).random(src, np.float32)
    want = x.astype(np.float64)
    for d in (1, 2):
        if src[d] == dst[d]:
            continue
        w = np.asarray(jscale.compute_weight_mat(
            src[d], dst[d], dst[d] / src[d], 0.0, kernel, True))
        got_w = _resize_weights(src[d], dst[d], _KERNELS[method], "cpu")
        np.testing.assert_allclose(got_w.numpy(), w, rtol=0, atol=2e-7)
        want = np.moveaxis(np.tensordot(want, w.astype(np.float64),
                                        axes=([d], [0])), -1, d)
    got = image_resize(torch.from_numpy(x), dst, method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _matcher_inputs(th, seed):
    """lq near one window of its ref (so the top-1 is clear) and near
    another one in the second image's, refs of 2 x 3 windows and more."""
    rng = np.random.default_rng(seed)
    ref = rng.random((2, th + th // 2, th + 3 * (th // 4) + 1, 3), np.float32)
    s = th // 4
    lq = np.stack([ref[0, s:s + th, 2 * s:2 * s + th],
                   ref[1, 0:th, s:s + th]])
    lq = lq + 0.05 * rng.standard_normal(lq.shape).astype(np.float32)
    return lq.astype(np.float32), ref


@pytest.mark.parametrize("th", [28, 32])
def test_select_ref_crop_matches_jax(th):
    port, jmod, params, _ = _tiny()
    lq, ref = _matcher_inputs(th, th)
    want = np.asarray(jax.jit(lambda a, b: jdino.select_ref_crop(
        jmod.apply, {"params": params}, a, b))(jnp.asarray(lq),
                                              jnp.asarray(ref)))
    windows = tdino.extract_ref_windows(torch.from_numpy(ref), th, th // 4)
    jwin = np.asarray(jdino.extract_ref_windows(jnp.asarray(ref), th,
                                                th // 4))
    assert np.array_equal(windows.numpy(), jwin)
    for chunk in (1, 32):
        got = tdino.select_ref_crop(port, torch.from_numpy(lq),
                                    torch.from_numpy(ref), chunk=chunk)
        assert np.array_equal(got.numpy(), want)
    # the same top-1 index: the crop is one window, and no other equals it
    idx = [[i for i in range(jwin.shape[1]) if np.array_equal(jwin[b, i],
                                                               want[b])]
           for b in range(2)]
    assert idx == [[6], [1]]


@pytest.mark.parametrize("channels", [1, 6])
def test_matcher_refuses_other_channel_counts(channels):
    """The gray (1-channel lq) and dual-pixel (6-channel lq) inputs: JAX's
    3-channel patch_embed fails on them; the port refuses with a message
    that names the count."""
    port, jmod, params, _ = _tiny()
    rng = np.random.default_rng(channels)
    lq = rng.random((1, 28, 28, channels), np.float32)
    ref = rng.random((1, 42, 42, channels), np.float32)
    with pytest.raises(Exception):
        jdino.select_ref_crop(jmod.apply, {"params": params},
                              jnp.asarray(lq), jnp.asarray(ref))
    with pytest.raises(ValueError, match=f"{channels} channels"):
        tdino.select_ref_crop(port, torch.from_numpy(lq),
                              torch.from_numpy(ref))


def test_dino_file_loads_with_reference_keys_not_the_generic_converter(
        tmp_path):
    """A DINOv2 file in the reference layout: the port's `load_dino` takes
    it with strict=True and matches JAX fed convert_dino's tree.  The JAX
    CLI's generic restoration converter (`load_torch_checkpoint(path,
    key=None)`) leaves the reference names (patch_embed/proj/kernel,
    blocks_i/ls1/gamma, blocks_i/norm1/weight), which JAX's DINO module
    does not find."""
    port, jmod, params, sd = _tiny()
    path = tmp_path / "dino.pth"
    torch.save(sd, path)
    loaded = tdino.load_dino(str(path),
                             tdino.DinoVisionTransformer(**TINY))
    assert not loaded.training and not any(
        p.requires_grad for p in loaded.parameters())
    x = np.random.default_rng(5).random((1, 42, 42, 3), np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(), want,
                                   rtol=0, atol=1e-4)

    generic = load_torch_checkpoint(str(path), key=None)
    assert "proj" in generic["patch_embed"] and "kernel" not in \
        generic["patch_embed"]
    assert "gamma" in generic["blocks_0"]["ls1"]
    assert "weight" in generic["blocks_0"]["norm1"]
    with pytest.raises(Exception, match="patch_embed"):
        jmod.apply({"params": generic}, jnp.asarray(x))
