"""Image conversion and writing (counterpart of
textualdegremoval_tpu/utils/image.py).

`tensor2img` flips RGB to BGR with numpy, and `imwrite` imports cv2 when
called, so that machines that only run the model need no cv2; where cv2
is missing, `imwrite` writes PNG files with numpy (data/png.py).
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
    """Write a BGR (or gray) uint8/uint16 image, as cv2.imwrite does."""
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import cv2
    except ImportError:
        from textualdegremoval_tpu_torch.data.png import write_png

        if not path.lower().endswith(".png"):
            raise NotImplementedError(f"{path}: without cv2 only PNG files "
                                      "are written")
        if img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        write_png(path, img)
        return True
    return cv2.imwrite(path, img)
