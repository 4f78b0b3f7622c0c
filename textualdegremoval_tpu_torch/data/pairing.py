"""Image listing and lq/gt(/ref) pairing (counterpart of `scan_images`,
`paired_paths_from_folder`, `tri_paths_from_folder`,
`paths_from_meta_info` and `paired_paths_from_lmdb` in
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


def paired_paths_from_folder(folders, keys, filename_tmpl="{}"):
    """[(lq, gt)] path dicts: each gt file with its lq namesake under
    `filename_tmpl`; when none has one, by index of the sorted listings
    (JAX `paired_paths_from_folder`)."""
    in_folder, gt_folder = folders
    in_key, gt_key = keys
    gt_paths = scan_images(gt_folder)
    paths = []
    for gt_path in gt_paths:
        base, ext = osp.splitext(osp.basename(gt_path))
        in_path = osp.join(in_folder, filename_tmpl.format(base) + ext)
        if osp.exists(in_path):
            paths.append({f"{in_key}_path": in_path,
                          f"{gt_key}_path": gt_path})
    if paths:
        return paths
    in_paths = scan_images(in_folder)
    if len(in_paths) != len(gt_paths):
        raise ValueError(f"{in_key} and {gt_key} counts differ: "
                         f"{len(in_paths)} vs {len(gt_paths)}")
    return [{f"{in_key}_path": i, f"{gt_key}_path": g}
            for i, g in zip(in_paths, gt_paths)]


def paths_from_meta_info(meta_file: str, folders, keys):
    """[(lq, gt, ref)] from a meta_info file of 'lq_name [gt_name]' lines;
    the ref is the lq's namesake (JAX `paths_from_meta_info`)."""
    lq_folder, gt_folder, ref_folder = folders
    lq_key, gt_key, ref_key = keys
    paths = []
    with open(meta_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            gt_name = parts[1] if len(parts) > 1 else parts[0]
            paths.append({f"{lq_key}_path": osp.join(lq_folder, parts[0]),
                          f"{gt_key}_path": osp.join(gt_folder, gt_name),
                          f"{ref_key}_path": osp.join(ref_folder, parts[0])})
    return paths


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


def _lmdb_keys(folder: str) -> list[str]:
    """Keys of a BasicSR-style lmdb folder: from meta_info.txt lines
    'name.ext (h,w,c) level', the name without its extension (reference
    data/utils_data.py:116-156), else a B-tree scan (data/lmdb_reader.py)."""
    meta = osp.join(folder, "meta_info.txt")
    if osp.exists(meta):
        with open(meta) as f:
            return [line.split(".")[0] for line in f if line.strip()]
    from textualdegremoval_tpu_torch.data.lmdb_reader import PurePythonLmdb

    return PurePythonLmdb(folder).keys()


def paired_paths_from_lmdb(folders, keys):
    """[(lq, gt)] pairs of identical lmdb keys (reference
    data/utils_data.py:94-160, JAX `paired_paths_from_lmdb`); the
    '{key}_path' entries are lmdb keys, which the lmdb FileClient backend
    resolves.  Both folders must be `.lmdb` and hold the same keys."""
    in_folder, gt_folder = folders
    in_key, gt_key = keys
    if not (in_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError(
            f"{in_key} and {gt_key} folders should both be .lmdb: "
            f"{in_folder}, {gt_folder}")
    in_keys, gt_keys = set(_lmdb_keys(in_folder)), set(_lmdb_keys(gt_folder))
    if in_keys != gt_keys:
        raise ValueError(
            f"keys in {in_key} and {gt_key} lmdbs differ "
            f"(e.g. {sorted(in_keys ^ gt_keys)[:3]})")
    return [{f"{in_key}_path": k, f"{gt_key}_path": k}
            for k in sorted(in_keys)]


def tri_paths_from_lmdb(folders, keys):
    """[(lq, gt, ref)] triples of identical lmdb keys (JAX
    `tri_paths_from_lmdb`, the WithRef extension of the reference's
    paired_paths_from_lmdb); every folder must hold the same keys."""
    sets = {key: set(_lmdb_keys(folder))
            for folder, key in zip(folders, keys)}
    base = sets[keys[0]]
    for k, s in sets.items():
        if s != base:
            raise ValueError(
                f"keys in {keys[0]} and {k} lmdbs differ "
                f"(e.g. {sorted(base ^ s)[:3]})")
    return [{f"{k}_path": key for k in keys} for key in sorted(base)]
