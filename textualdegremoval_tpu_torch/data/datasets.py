"""Image reading (counterpart of `imread_f32` in
textualdegremoval_tpu/data/datasets.py)."""

from __future__ import annotations

import numpy as np


def imread_f32(path: str, bit16: bool = False) -> np.ndarray:
    """Read an image as HWC RGB float32 in [0, 1].  16-bit files keep their
    depth when `bit16` is set.  cv2 is imported here, not at module import,
    since machines that only run the model may lack it."""
    import cv2

    flag = cv2.IMREAD_UNCHANGED if bit16 else cv2.IMREAD_COLOR
    img = cv2.imread(path, flag)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=2)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    # x * (1/255) in f32, as the JAX package's native 8-bit decoder scales
    return img.astype(np.float32) * np.float32(1.0 / 255.0)
