"""MATLAB-faithful imresize (antialiased bicubic), the same numpy as
textualdegremoval_tpu/utils/imresize.py.

Parity target: reference utils/matlab_functions.py:6-150 — the MATLAB
`imresize` convention: cubic kernel (a=-0.5), kernel width scaled by the
downsampling factor (antialiasing), symmetric boundary handling via index
reflection, separable passes with precomputed weights/indices.
"""

from __future__ import annotations

import numpy as np


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    f = (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
    f = f + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2))
    return f


def _weights_indices(in_len, out_len, scale, kernel_width=4.0,
                     antialiasing=True):
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based
    dist = u[:, None] - (indices + 1)
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # trim zero columns
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    weights = weights[:, nz]
    indices = indices[:, nz].astype(np.int64)
    # symmetric boundary reflection
    indices = np.where(indices < 0, -indices - 1, indices)
    indices = np.where(indices >= in_len, 2 * in_len - indices - 1, indices)
    indices = np.clip(indices, 0, in_len - 1)
    return weights, indices


def imresize(img: np.ndarray, scale: float = None, out_shape=None,
             antialiasing: bool = True) -> np.ndarray:
    """img: HW or HWC float; returns resized array (float64 math)."""
    img = np.asarray(img, np.float64)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    in_h, in_w = img.shape[:2]
    if out_shape is not None:
        out_h, out_w = out_shape
        scale_h, scale_w = out_h / in_h, out_w / in_w
    else:
        scale_h = scale_w = scale
        out_h, out_w = int(np.ceil(in_h * scale)), int(np.ceil(in_w * scale))

    wh, ih = _weights_indices(in_h, out_h, scale_h,
                              antialiasing=antialiasing)
    ww, iw = _weights_indices(in_w, out_w, scale_w,
                              antialiasing=antialiasing)
    # vertical pass: (out_h, P) gather over rows
    tmp = np.einsum("op,opwc->owc", wh, img[ih])  # ih: (out_h, P)
    out = np.einsum("op,hopc->hoc", ww, tmp[:, iw])
    out = out if not squeeze else out[..., 0]
    return out
