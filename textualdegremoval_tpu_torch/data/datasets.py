"""Image reading and the training dataset (counterparts of `imread_f32`
and `PairedImageWithRefDataset` in textualdegremoval_tpu/data/datasets.py).
"""

from __future__ import annotations

import random

import numpy as np

from textualdegremoval_tpu_torch.data.pairing import tri_paths_from_folder
from textualdegremoval_tpu_torch.data.transforms import (
    paired_random_crop, random_augmentation, reflect_pad_to,
)


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


class PairedImageWithRefDataset:
    """lq/gt pairs cropped and augmented, the reference passed whole
    (reference Dataset_PairedImageWithRef :161-254, YAML type
    `Dataset_PairedImageWithRef`): the trainer picks the reference crop.
    Items are HWC float32 RGB in [0, 1].  The disk backend only: the lmdb
    and packed (tfrecord) archives and the native decoder of the JAX
    package are not ported yet (ROADMAP A8)."""

    def __init__(self, opt: dict):
        self.opt = opt
        io = (opt.get("io_backend") or {"type": "disk"}).get("type", "disk")
        if io != "disk":
            raise NotImplementedError(
                f"io_backend {io!r} is not ported yet: the PyTorch port reads "
                "image folders (io_backend disk); lmdb, packed archives and "
                "the native decoder follow with item A8 of ROADMAP.md")
        self.paths = tri_paths_from_folder(
            (opt["lqroot"], opt["hqroot"], opt["refroot"]),
            ("lq", "gt", "ref"), opt.get("filename_tmpl", "{}"))
        self.is_train = opt.get("phase", "train") == "train"
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        rec = self.paths[idx % len(self.paths)]
        lq = imread_f32(rec["lq_path"])
        gt = imread_f32(rec["gt_path"])
        ref = imread_f32(rec["ref_path"])
        if self.is_train:
            gs = self.opt.get("gt_size", 128)
            lq, gt = reflect_pad_to(lq, gs), reflect_pad_to(gt, gs)
            gt, lq = paired_random_crop(gt, lq, gs, self.opt.get("scale", 1),
                                        self.rng)
            if self.opt.get("geometric_augs", False):
                lq, gt = random_augmentation(lq, gt, rng=self.rng)
        return {"lq": lq, "gt": gt, "ref": ref, **rec}
