"""Image listing and lq/gt/ref pairing (counterpart of `scan_images` and
`tri_paths_from_folder` in textualdegremoval_tpu/data/pairing.py)."""

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


def tri_paths_from_folder(folders, keys, filename_tmpl="{}"):
    """[(lq, gt, ref)] path dicts: paired by basename when the first gt
    files have namesakes in both other folders, else by index of the
    sorted listings (JAX `tri_paths_from_folder`)."""
    lq_folder, gt_folder, ref_folder = folders
    lq_key, gt_key, ref_key = keys
    gt_paths = scan_images(gt_folder)
    by_name = len(gt_paths) > 0 and all(
        osp.exists(osp.join(lq_folder, osp.basename(p)))
        and osp.exists(osp.join(ref_folder, osp.basename(p)))
        for p in gt_paths[:4])
    if by_name:
        return [{f"{lq_key}_path": osp.join(lq_folder, osp.basename(g)),
                 f"{gt_key}_path": g,
                 f"{ref_key}_path": osp.join(ref_folder, osp.basename(g))}
                for g in gt_paths]
    lq_paths, ref_paths = scan_images(lq_folder), scan_images(ref_folder)
    if not len(lq_paths) == len(gt_paths) == len(ref_paths):
        raise ValueError(f"counts differ: {len(lq_paths)}, {len(gt_paths)}, "
                         f"{len(ref_paths)}")
    return [{f"{lq_key}_path": l, f"{gt_key}_path": g, f"{ref_key}_path": r}
            for l, g, r in zip(lq_paths, gt_paths, ref_paths)]
