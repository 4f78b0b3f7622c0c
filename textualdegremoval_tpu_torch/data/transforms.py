"""Paired crops and geometric augmentations (host-side numpy, HWC).

Counterpart of textualdegremoval_tpu/data/transforms.py (reference
data/transforms.py:5-275): reflect padding to the crop size, the paired
random crop, hflip/vflip/rot90, the 8 dihedral modes of
random_augmentation, the DUF protocol's blur and downsample, and the
affine rotation `img_rotate` (cv2, imported at the call).  `rng`
is a `random.Random` (the module's when None).
"""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def reflect_pad_to(img: np.ndarray, size: int) -> np.ndarray:
    """Reflect-pad bottom/right so both dims are >= size (reference
    utils_image.padding)."""
    h, w = img.shape[:2]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return img
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale=1, rng=None):
    """Random crop of lq (patch // scale) and the matching gt patch.
    Takes single arrays or lists and returns the same structure."""
    rng = rng or random
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    gts = [img_gts] if single_gt else img_gts
    lqs = [img_lqs] if single_lq else img_lqs

    lq_patch = gt_patch_size // scale
    h_lq, w_lq = lqs[0].shape[:2]
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(
            f"LQ ({h_lq}x{w_lq}) smaller than patch {lq_patch}; pad first")
    top = rng.randint(0, h_lq - lq_patch)
    left = rng.randint(0, w_lq - lq_patch)
    lqs = [v[top: top + lq_patch, left: left + lq_patch, ...] for v in lqs]
    top_gt, left_gt = top * scale, left * scale
    gts = [v[top_gt: top_gt + gt_patch_size,
             left_gt: left_gt + gt_patch_size, ...] for v in gts]
    return (gts[0] if single_gt else gts), (lqs[0] if single_lq else lqs)


def augment(imgs, hflip=True, rotation=True, rng=None):
    """Random hflip/vflip/rot90 applied consistently to all images."""
    rng = rng or random
    do_h = hflip and rng.random() < 0.5
    do_v = rotation and rng.random() < 0.5
    do_r = rotation and rng.random() < 0.5

    def _aug(img):
        if do_h:
            img = img[:, ::-1, ...]
        if do_v:
            img = img[::-1, :, ...]
        if do_r:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    single = not isinstance(imgs, list)
    out = [_aug(v) for v in ([imgs] if single else imgs)]
    return out[0] if single else out


def _aug_mode(img: np.ndarray, mode: int) -> np.ndarray:
    """The 8 dihedral modes of reference random_augmentation."""
    if mode not in range(8):
        raise ValueError(mode)
    out = np.rot90(img, k=mode // 2) if mode >= 2 else img
    if mode % 2:
        out = np.flipud(out)
    return np.ascontiguousarray(out)


def random_augmentation(*imgs, rng=None):
    rng = rng or random
    mode = rng.randint(0, 7)
    return [_aug_mode(img, mode) for img in imgs]


def generate_gaussian_kernel(kernel_size: int = 13,
                             sigma: float = 1.6) -> np.ndarray:
    """2-D Gaussian kernel: a centred impulse through scipy's
    gaussian_filter (reference data/utils_data.py:444-462)."""
    from scipy.ndimage import gaussian_filter

    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x: np.ndarray, kernel_size: int = 13,
                   scale: int = 4) -> np.ndarray:
    """Gaussian blur and strided downsample of the DUF protocol (reference
    data/utils_data.py:465-497, JAX `duf_downsample`): reflect padding of
    k // 2 + 2 scale, the depthwise Gaussian (sigma 0.4 scale) at stride
    `scale`, then 2 border pixels cropped.  x: (..., H, W, C); returns
    (..., H // scale, W // scale, C)."""
    from scipy.ndimage import convolve

    if scale not in (2, 3, 4):
        raise ValueError(f"scale {scale}: only 2, 3 and 4 are supported")
    kernel = generate_gaussian_kernel(kernel_size, 0.4 * scale)
    k2 = kernel_size // 2
    pad = k2 + scale * 2
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    outs = []
    for img in x.reshape((-1, h, w, c)):
        p = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
        blur = np.stack([convolve(p[:, :, ch], kernel, mode="constant")
                         for ch in range(c)], axis=-1)
        # the valid part of the padded image, sampled at stride `scale`
        sub = blur[k2: p.shape[0] - k2, k2: p.shape[1] - k2][::scale, ::scale]
        outs.append(sub[2: 2 + h // scale, 2: 2 + w // scale])
    return np.stack(outs).reshape(lead + outs[0].shape)


def img_rotate(img: np.ndarray, angle: float, center=None,
               scale: float = 1.0) -> np.ndarray:
    """Rotate by `angle` degrees (counter-clockwise) about `center`
    (default the pixel (w // 2, h // 2)) with isotropic `scale` (JAX
    `img_rotate`, reference data/transforms.py:203-221): cv2's rotation
    matrix and bilinear warpAffine, zero outside."""
    import cv2

    h, w = img.shape[:2]
    if center is None:
        center = (w // 2, h // 2)
    matrix = cv2.getRotationMatrix2D(center, angle, scale)
    return cv2.warpAffine(img, matrix, (w, h))
