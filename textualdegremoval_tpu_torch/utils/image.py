"""Image conversion and writing (counterpart of
textualdegremoval_tpu/utils/image.py).

`tensor2img` flips RGB to BGR with numpy, and `imwrite` imports cv2 when
called, so that machines that only run the model need no cv2.
"""

from __future__ import annotations

import os

import numpy as np


def tensor2img(t, rgb2bgr: bool = True, min_max=(0, 1)) -> np.ndarray:
    """(B?, H, W, C) float array or tensor -> HWC uint8: clamp to min_max,
    scale to 255, round (the reference's tensor2img contract); the first
    image of a batch."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    arr = np.asarray(t)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip((arr - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    arr = (arr * 255.0).round().astype(np.uint8)
    if rgb2bgr and arr.ndim == 3 and arr.shape[2] == 3:
        arr = np.ascontiguousarray(arr[..., ::-1])
    return arr


def imwrite(img: np.ndarray, path: str, auto_mkdir: bool = True) -> bool:
    import cv2

    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return cv2.imwrite(path, img)
