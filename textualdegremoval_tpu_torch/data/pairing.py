"""Image listing (counterpart of `scan_images` in
textualdegremoval_tpu/data/pairing.py)."""

from __future__ import annotations

import os
import os.path as osp

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp", ".PNG",
            ".JPG", ".JPEG")


def scan_images(folder: str) -> list[str]:
    """Every image file under `folder`, recursively, sorted."""
    out = []
    for root, _, files in os.walk(folder):
        for f in files:
            if f.endswith(IMG_EXTS):
                out.append(osp.join(root, f))
    return sorted(out)
