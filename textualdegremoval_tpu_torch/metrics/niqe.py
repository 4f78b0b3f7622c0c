"""NIQE (Natural Image Quality Evaluator), MATLAB-faithful.

Implements the published NIQE algorithm (Mittal et al., 'Making a
"Completely Blind" Image Quality Analyzer'): MSCN coefficients, AGGD fits of
the coefficient field and its 4 directional products at 2 scales, 96x96
block features, Mahalanobis-style distance to pristine statistics.

Counterpart of textualdegremoval_tpu/metrics/niqe.py, the same numpy
(reference metrics/niqe.py, the same algorithm).  The pristine
statistics (mu/cov/gaussian window) are the published NIQE parameter set —
a pure data table, carried verbatim as niqe_pris_params.npz alongside this
module (keys mu_pris_param (1,36), cov_pris_param (36,36), gaussian_window
(7,7)), same file the reference ships at metrics/niqe_pris_params.npz.
Override with params_path or TDR_NIQE_PARAMS.
"""

from __future__ import annotations

import os

import numpy as np

from textualdegremoval_tpu_torch.metrics.psnr_ssim import _as_hwc
from textualdegremoval_tpu_torch.utils.matlab import to_y_channel


def _gaussian_window(size=7, sigma=7 / 6):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2_same(img, window):
    """MATLAB filter2(window, img, 'same') — correlation with zero padding
    is what cv2 does; MATLAB NIQE uses 'replicate' via nanconv? The
    canonical implementation uses 'same' with zero border; block features
    near borders are dominated by interior blocks, so border mode is
    immaterial for 96px blocks."""
    from scipy.ndimage import correlate

    return correlate(img, window, mode="nearest")


def _estimate_aggd(block: np.ndarray):
    """AGGD parameter fit (alpha, beta_l, beta_r) via the moment-matching
    lookup used by the original MATLAB code."""
    gam = np.arange(0.2, 10.001, 0.001)
    gam_reciprocal = np.reciprocal(gam)
    r_gam = np.square(_gamma(gam_reciprocal * 2)) / (
        _gamma(gam_reciprocal) * _gamma(gam_reciprocal * 3))

    block = block.flatten()
    left = block[block < 0]
    right = block[block > 0]
    left_std = np.sqrt(np.mean(left ** 2)) if left.size else 0.0
    right_std = np.sqrt(np.mean(right ** 2)) if right.size else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2) \
        if np.mean(block ** 2) > 0 else 0.0
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2) if np.isfinite(gammahat) else 0.0
    array_position = np.argmin((r_gam - rhatnorm) ** 2)
    alpha = gam[array_position]
    beta_l = left_std * np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
    beta_r = right_std * np.sqrt(_gamma(1 / alpha) / _gamma(3 / alpha))
    return alpha, beta_l, beta_r


def _gamma(x):
    from scipy.special import gamma

    return gamma(x)


def _block_features(mscn: np.ndarray):
    feats = []
    alpha, beta_l, beta_r = _estimate_aggd(mscn)
    feats.extend([alpha, (beta_l + beta_r) / 2])
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]  # H, V, D1, D2
    for dy, dx in shifts:
        shifted = np.roll(mscn, (dy, dx), axis=(0, 1))
        alpha, beta_l, beta_r = _estimate_aggd(mscn * shifted)
        mean = (beta_r - beta_l) * (_gamma(2 / alpha) / _gamma(1 / alpha))
        feats.extend([alpha, mean, beta_l, beta_r])
    return feats  # 18


def calculate_niqe(img, crop_border=0, params_path: str | None = None,
                   block_size: int = 96):
    """img: HWC BGR or HW gray in [0, 255], or a CHW / NCHW tensor on any
    device (`psnr_ssim._as_hwc`). Returns NIQE score (lower = better)."""
    params_path = (params_path or os.environ.get("TDR_NIQE_PARAMS")
                   or os.path.join(os.path.dirname(__file__),
                                   "niqe_pris_params.npz"))
    if not os.path.exists(params_path):
        raise FileNotFoundError(
            f"NIQE pristine params npz not found at {params_path} — pass "
            "params_path or set TDR_NIQE_PARAMS (keys: mu_pris_param, "
            "cov_pris_param, gaussian_window)")
    pris = np.load(params_path)
    mu_pris = pris["mu_pris_param"]
    cov_pris = pris["cov_pris_param"]
    window = pris.get("gaussian_window", _gaussian_window())

    img = np.asarray(_as_hwc(img), np.float64)
    if img.ndim == 3:
        img = to_y_channel(img)[..., 0]
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]

    feats_all = []
    im = img.copy()
    for scale in range(2):
        h, w = im.shape
        nbh, nbw = h // (block_size // (scale + 1)), \
            w // (block_size // (scale + 1))
        bs = block_size // (scale + 1)
        mu = _filter2_same(im, window)
        sigma = np.sqrt(np.abs(_filter2_same(im * im, window) - mu * mu))
        mscn = (im - mu) / (sigma + 1)
        scale_feats = []
        for by in range(nbh):
            for bx in range(nbw):
                block = mscn[by * bs:(by + 1) * bs, bx * bs:(bx + 1) * bs]
                scale_feats.append(_block_features(block))
        feats_all.append(np.asarray(scale_feats))
        if scale == 0:
            # downscale by 2 for the next scale (bilinear-antialiased)
            import cv2

            im = cv2.resize(im / 255.0, (w // 2, h // 2),
                            interpolation=cv2.INTER_AREA) * 255.0
    feats = np.concatenate(feats_all, axis=1)  # (nblocks, 36)
    feats = feats[~np.isnan(feats).any(axis=1)]

    mu_dist = np.nanmean(feats, axis=0, keepdims=True)
    cov_dist = np.cov(feats, rowvar=False)
    cov_mid = (cov_pris + cov_dist) / 2
    diff = mu_pris - mu_dist
    quality = diff @ np.linalg.pinv(cov_mid) @ diff.T
    return float(np.sqrt(np.maximum(quality, 0))[0, 0])
