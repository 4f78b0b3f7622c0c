"""MATLAB-faithful color conversions (counterpart of
textualdegremoval_tpu/utils/matlab.py, the same numpy; reference
utils/matlab_functions.py).

Coefficients are ITU-R BT.601 in the MATLAB convention: inputs in [0, 1]
float or [0, 255] uint8; outputs YCbCr with Y in [16, 235]."""

from __future__ import annotations

import numpy as np


def _convert_input_type_range(img):
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.0
    return img, img_type


def _convert_output_type_range(img, dst_type):
    if dst_type == np.uint8:
        return img.round().astype(np.uint8)
    return (img / 255.0).astype(np.float32)


def rgb2ycbcr(img, y_only: bool = False):
    """RGB HWC -> YCbCr (or Y only)."""
    img, img_type = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, [65.481, 128.553, 24.966]) + 16.0
    else:
        out = np.matmul(
            img,
            np.asarray(
                [[65.481, -37.797, 112.0],
                 [128.553, -74.203, -93.786],
                 [24.966, 112.0, -18.214]]
            ),
        ) + [16, 128, 128]
    return _convert_output_type_range(out, img_type)


def bgr2ycbcr(img, y_only: bool = False):
    """BGR HWC -> YCbCr (or Y only)."""
    img, img_type = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, [24.966, 128.553, 65.481]) + 16.0
    else:
        out = np.matmul(
            img,
            np.asarray(
                [[24.966, 112.0, -18.214],
                 [128.553, -74.203, -93.786],
                 [65.481, -37.797, 112.0]]
            ),
        ) + [16, 128, 128]
    return _convert_output_type_range(out, img_type)


def ycbcr2rgb(img):
    img, img_type = _convert_input_type_range(img)
    img = img * 255.0
    out = np.matmul(
        img,
        np.asarray(
            [[0.00456621, 0.00456621, 0.00456621],
             [0, -0.00153632, 0.00791071],
             [0.00625893, -0.00318811, 0]]
        ),
    ) * 255.0 + [-222.921, 135.576, -276.836]
    return _convert_output_type_range(out, img_type)


def to_y_channel(img):
    """[0,255] HWC BGR -> [0,255] single-channel Y (reference
    metrics/metric_util.py semantics)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0
