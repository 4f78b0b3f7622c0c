"""PSNR and SSIM on HWC numpy images, at the JAX package's defaults.

Counterpart of textualdegremoval_tpu/metrics/psnr_ssim.py with
crop_border=0 and no Y channel: PSNR from a float64 MSE with the peak
inferred as 1 or 255, and SSIM with the reference's 3-D Gaussian window
(11 x 11 x 11, sigma 1.5, replicate padding) over (H, W, C), computed as
three separable 1-D passes in float64.
"""

from __future__ import annotations

import numpy as np


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return float(20.0 * np.log10(max_value / np.sqrt(mse)))


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter_3d(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 3-D correlation with replicate padding, 'same' size."""
    r = len(k) // 2
    for axis in range(3):
        pad = [(0, 0)] * 3
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="edge")
        n = x.shape[axis]
        lead = (slice(None),) * axis
        x = sum(k[i] * xp[lead + (slice(i, i + n),)] for i in range(len(k)))
    return x


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    max_value = 1.0 if img1.max() <= 1 else 255.0
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    k = _gaussian_kernel_1d()
    mu1, mu2 = _filter_3d(img1, k), _filter_3d(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter_3d(img1 * img1, k) - mu1_sq
    s2 = _filter_3d(img2 * img2, k) - mu2_sq
    s12 = _filter_3d(img1 * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())
