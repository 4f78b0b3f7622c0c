"""PSNR and SSIM with the JAX package's arguments (counterpart of
textualdegremoval_tpu/metrics/psnr_ssim.py).

Inputs are HWC numpy images, or tensors on any device, CHW or NCHW (the
first image), as JAX's `_as_hwc` takes them; `input_order="CHW"` reads
numpy images as CHW.  PSNR comes from a float64 MSE with the peak
inferred as 1 or 255.  SSIM uses the reference's 3-D Gaussian window (11 x
11 x 11, sigma 1.5, replicate padding) over (H, W, C); with
`test_y_channel` it is the 2-D replicate-border SSIM of the Y channel at
range 255 (JAX `_ssim_2d_device`).  Both filters run as separable 1-D
passes in float64 (JAX runs them in float32).
"""

from __future__ import annotations

import numpy as np
import torch

from textualdegremoval_tpu_torch.utils.matlab import to_y_channel


def _as_hwc(img) -> np.ndarray:
    """A tensor (CHW, or NCHW taking [0]) as an HWC numpy array; numpy as
    it is."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu()
        if img.dtype in (torch.bfloat16, torch.float16):
            img = img.float()
        img = img.numpy()
        if img.ndim == 4:
            img = img[0]
        img = img.transpose(1, 2, 0)
    return np.asarray(img)


def _prepare(img1, img2, crop_border: int, input_order: str):
    img1, img2 = _as_hwc(img1), _as_hwc(img2)
    if input_order == "CHW":
        img1, img2 = img1.transpose(1, 2, 0), img2.transpose(1, 2, 0)
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    return img1, img2


def calculate_psnr(img1, img2, crop_border: int = 0, input_order: str = "HWC",
                   test_y_channel: bool = False) -> float:
    img1, img2 = _prepare(img1, img2, crop_border, input_order)
    if test_y_channel:
        img1, img2 = to_y_channel(img1), to_y_channel(img2)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return float(20.0 * np.log10(max_value / np.sqrt(mse)))


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable correlation over every axis of x with replicate padding,
    'same' size."""
    r = len(k) // 2
    for axis in range(x.ndim):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="edge")
        n = x.shape[axis]
        lead = (slice(None),) * axis
        x = sum(k[i] * xp[lead + (slice(i, i + n),)] for i in range(len(k)))
    return x


def _ssim(img1: np.ndarray, img2: np.ndarray, max_value: float) -> float:
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    k = _gaussian_kernel_1d()
    mu1, mu2 = _filter(img1, k), _filter(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter(img1 * img1, k) - mu1_sq
    s2 = _filter(img2 * img2, k) - mu2_sq
    s12 = _filter(img1 * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1, img2, crop_border: int = 0, input_order: str = "HWC",
                   test_y_channel: bool = False) -> float:
    img1, img2 = _prepare(img1, img2, crop_border, input_order)
    if test_y_channel:
        return _ssim(to_y_channel(img1)[..., 0].astype(np.float64),
                     to_y_channel(img2)[..., 0].astype(np.float64), 255.0)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return _ssim(img1, img2, max_value)
