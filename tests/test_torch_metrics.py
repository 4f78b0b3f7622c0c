"""PyTorch port vs JAX package: the metrics (PSNR / SSIM with JAX's
arguments, NIQE, FID's statistics, InceptionV3 and its feature
extraction).

The same seeded numpy inputs (or the same torch tensors, which JAX's
metrics also take) go to both packages.  PSNR is the same float64 numpy
in both: equal to 1e-12 relative.  SSIM: JAX filters in float32 (XLA),
the port in float64; the largest difference read here was 3.6e-7 (bound
1e-5 absolute).  NIQE and the Frechet distance are the same numpy and
scipy in both: equal.  InceptionV3: the port loads a randomised
`tests/torch_inception_oracle.py` state dict strictly, JAX takes it
through its own `convert_state_dict` + `split_batch_stats`; pool3
features within 1e-4 of max|JAX| (read: 6.5e-7 of it, 4.7e-7 through
`extract_features`).  The whole
`calculate_fid_from_images` is left to the card (`chip_smoke.py` phase
37): its 2048-d `sqrtm` takes some 17 s a call on the CPU.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from textualdegremoval_tpu.convert.torch_to_jax import (
    convert_state_dict, split_batch_stats)
from textualdegremoval_tpu.metrics import fid as jfid
from textualdegremoval_tpu.metrics import inception as jinc
from textualdegremoval_tpu.metrics import niqe as jniqe
from textualdegremoval_tpu.metrics import psnr_ssim as jps

from textualdegremoval_tpu_torch.metrics import fid, inception, niqe
from textualdegremoval_tpu_torch.metrics import (
    calculate_psnr, calculate_ssim)

from torch_inception_oracle import OInceptionV3
from torch_port_util import torch_share


def _pair(peak: float, seed: int = 0):
    """Two HWC images of 40 x 48 x 3 in [0, peak]: a smooth one and a
    noisy copy."""
    rng = np.random.default_rng(seed)
    low = rng.random((5, 6, 3))
    a = np.kron(low, np.ones((8, 8, 1)))
    b = np.clip(a + 0.08 * rng.standard_normal(a.shape), 0, 1)
    return (a * peak).astype(np.float32), (b * peak).astype(np.float32)


def _as_input(img: np.ndarray, kind: str):
    """img (HWC) in the form `kind` and the input_order it needs."""
    chw = np.ascontiguousarray(img.transpose(2, 0, 1))
    return {"hwc": (img, "HWC"), "chw_numpy": (chw, "CHW"),
            "chw_tensor": (torch.from_numpy(chw), "HWC"),
            "nchw_tensor": (torch.from_numpy(chw)[None], "HWC")}[kind]


KINDS = ["hwc", "chw_numpy", "chw_tensor", "nchw_tensor"]


@pytest.mark.parametrize("peak", [1.0, 255.0])
@pytest.mark.parametrize("y", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_psnr_matches_jax(kind, y, peak):
    a, b = _pair(peak)
    (a, order), (b, _) = _as_input(a, kind), _as_input(b, kind)
    kw = dict(crop_border=4, input_order=order, test_y_channel=y)
    want = jps.calculate_psnr(a, b, **kw)
    got = calculate_psnr(a, b, **kw)
    assert isinstance(got, float) and np.isfinite(got)
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("peak", [1.0, 255.0])
@pytest.mark.parametrize("y", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_ssim_matches_jax(kind, y, peak):
    a, b = _pair(peak, seed=1)
    (a, order), (b, _) = _as_input(a, kind), _as_input(b, kind)
    kw = dict(crop_border=4, input_order=order, test_y_channel=y)
    want = jps.calculate_ssim(a, b, **kw)
    got = calculate_ssim(a, b, **kw)
    assert abs(got - want) <= 1e-5, (got, want)
    assert 0.0 < got < 1.0


def test_psnr_ssim_defaults_keep_the_port_callers_results():
    """The evaluation and training CLIs call the metrics with HWC numpy at
    [0, 255] and no other argument: the whole image, three channels."""
    a, b = _pair(255.0, seed=2)
    assert calculate_psnr(a, b) == calculate_psnr(a, b, crop_border=0)
    assert calculate_ssim(a, b) == calculate_ssim(a, b, 0, "HWC", False)
    assert calculate_psnr(a, a) == float("inf")
    assert abs(calculate_ssim(a, a) - 1.0) < 1e-12


def _niqe_image(h, w, seed):
    rng = np.random.default_rng(seed)
    low = rng.random((h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(low, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1) * 255


@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("hw", [(256, 256), (300, 200)])
def test_niqe_matches_jax(hw, crop):
    img = _niqe_image(*hw, seed=hw[0] + crop)
    want = jniqe.calculate_niqe(img, crop_border=crop)
    got = niqe.calculate_niqe(img, crop_border=crop)
    assert np.isfinite(got) and got == want


def test_niqe_takes_a_chw_tensor():
    img = _niqe_image(256, 256, seed=3)
    chw = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
    assert niqe.calculate_niqe(chw[None]) == niqe.calculate_niqe(img)


def test_niqe_missing_params_raise(tmp_path, monkeypatch):
    missing = str(tmp_path / "none.npz")
    img = _niqe_image(96, 96, seed=4)
    with pytest.raises(FileNotFoundError) as want:
        jniqe.calculate_niqe(img, params_path=missing)
    with pytest.raises(FileNotFoundError) as got:
        niqe.calculate_niqe(img, params_path=missing)
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("TDR_NIQE_PARAMS", missing)
    with pytest.raises(FileNotFoundError, match="TDR_NIQE_PARAMS"):
        niqe.calculate_niqe(img)


def test_frechet_distance_and_fid_match_jax():
    rng = np.random.default_rng(5)
    fa = rng.standard_normal((300, 64)).astype(np.float32)
    fb = (0.8 * rng.standard_normal((250, 64)) + 0.3).astype(np.float32)
    mu1, s1 = fid.compute_statistics(fa)
    mu2, s2 = fid.compute_statistics(fb)
    jmu1, js1 = jfid.compute_statistics(fa)
    np.testing.assert_array_equal(mu1, jmu1)
    np.testing.assert_array_equal(s1, js1)
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    assert fid.frechet_distance(mu1, s1, mu2, s2) == want
    assert fid.calculate_fid(fa, fb) == jfid.calculate_fid(fa, fb)
    assert abs(fid.calculate_fid(fa, fa)) < 1e-6
    assert want > 0


@pytest.fixture(scope="module")
def inception_pair():
    """A randomised oracle's state dict loaded into the port's InceptionV3
    (strict) and converted to JAX's tree, and JAX's jitted apply."""
    with torch_share():
        oracle = inception.seeded_init(OInceptionV3(), seed=0).eval()
        sd = oracle.state_dict()
        model = inception.InceptionV3()
        model.load_state_dict(sd, strict=True)
    tree = split_batch_stats(convert_state_dict(sd))
    return model.eval(), tree, jax.jit(jinc.InceptionV3().apply)


def test_inception_matches_jax(inception_pair):
    model, tree, apply = inception_pair
    x = np.random.default_rng(6).random((2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(apply(tree, jnp.asarray(x * 2 - 1)))
    with torch_share(), torch.no_grad():
        got = model(torch.from_numpy(x * 2 - 1)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_extract_features_matches_jax(inception_pair):
    """Both resize 128 -> 299 with jax.image.resize's antialiased bilinear
    (the port's `image_resize`), map to [-1, 1] and run in batches."""
    model, tree, _ = inception_pair
    x = np.random.default_rng(7).random((2, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jinc.extract_features(tree, jnp.asarray(x),
                                            batch_size=1))
    with torch_share():
        got = inception.extract_features(model, torch.from_numpy(x),
                                         batch_size=1).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_load_torch_inception_drops_aux_and_fc(tmp_path):
    """A torchvision-named state dict with AuxLogits and fc, wrapped in
    "state_dict" and without BatchNorm's num_batches_tracked (as
    pytorch-fid's file), loads strictly; anything else unknown raises."""
    src = inception.InceptionV3()
    sd = {k: v for k, v in src.state_dict().items()
          if "num_batches" not in k}
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pth")
    with torch_share():
        got = inception.load_torch_inception(str(tmp_path / "wrapped.pth"))
    loaded = got.state_dict()
    assert loaded.keys() == src.state_dict().keys()
    for k, v in src.state_dict().items():
        assert torch.equal(loaded[k], v), k
    sd["Mixed_8a.conv.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="Mixed_8a"):
        inception.load_torch_inception(str(tmp_path / "extra.pth"))
