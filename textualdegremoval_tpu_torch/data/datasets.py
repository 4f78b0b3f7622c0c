"""Image reading and the restoration datasets (counterparts of
`imread_f32` and the six dataset classes of
textualdegremoval_tpu/data/datasets.py, reference
data/restoration_dataset.py:45-793).

Items are HWC float32 RGB in [0, 1].  Images come from folders (io_backend
disk) or, for the WithRef and dehaze datasets as in JAX, from keyed
archives (io_backend lmdb: reference `*.lmdb` folders, data/lmdb_reader.py;
tfrecord: packed archives, data/packed.py), whose items equal the folder's
bit for bit.  8-bit PNG and JPEG files decode through the native decoder
where it builds (data/native.py), else cv2, else data/png.py.  Crops and augmentations draw from each
dataset's `rng` (a `random.Random` seeded from the options); the
synthetic training noise of the denoising datasets from numpy's global
generator, after the crop and the augmentation, as the JAX package draws
it, so that both packages give the same items under the same
`np.random.seed`.
"""

from __future__ import annotations

import random

import numpy as np

from textualdegremoval_tpu_torch.data.pairing import (
    paired_paths_from_folder, paths_from_meta_info, scan_images,
    tri_paths_from_folder,
)
from textualdegremoval_tpu_torch.data import native
from textualdegremoval_tpu_torch.data.png import PNG_SIGNATURE, decode_png
from textualdegremoval_tpu_torch.data.transforms import (
    paired_random_crop, random_augmentation, reflect_pad_to,
)


def _cv2():
    """cv2, or None where it is not installed.  Imported when called, not
    at module import, since machines that only run the model may lack it."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _to_f32(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    # x * (1/255) as a float32 product, as native/tdr_dataio.cc's u8_to_f32
    return img.astype(np.float32) * np.float32(1.0 / 255.0)


def imdecode_f32(data: bytes, bit16: bool = False,
                 name: str = "image bytes") -> np.ndarray:
    """Decode an encoded image to HWC RGB float32 in [0, 1] (JAX
    packed.py's `imdecode_f32`): cv2, or without it PNG alone
    (data/png.py).  16-bit images keep their depth when `bit16` is set,
    else they are cut to 8 bits."""
    cv2 = _cv2()
    if cv2 is None:
        if not data.startswith(PNG_SIGNATURE):
            raise NotImplementedError(f"{name}: without cv2 only PNG files "
                                      "are read")
        img = decode_png(data, name)
        img = img[..., None] if img.ndim == 2 else img
        img = img[..., :1].repeat(3, axis=2) if img.shape[2] < 3 \
            else img[..., :3]
        if not bit16 and img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
    else:
        flag = cv2.IMREAD_UNCHANGED if bit16 else cv2.IMREAD_COLOR
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if img is None:
            raise IOError(f"cannot decode {name}")
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=2)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return _to_f32(img)


def imread_f32(path: str, bit16: bool = False) -> np.ndarray:
    """Read an image file as HWC RGB float32 in [0, 1]: an 8-bit read of a
    PNG or JPEG through the native decoder where it builds (as JAX's
    `imread_f32`), the rest through `imdecode_f32`."""
    if not bit16 and path.lower().endswith((".png", ".jpg", ".jpeg")) \
            and native.decode_available():
        try:
            return _to_f32(native.decode_rgb(path))
        except IOError:
            pass  # the decoder could not read it: the other paths try
    with open(path, "rb") as f:
        return imdecode_f32(f.read(), bit16, path)


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """HWC float32 RGB -> HW1 luma (cv2.COLOR_RGB2GRAY's weights; without
    cv2 the same weights in numpy, within an ulp of cv2's sums)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None]
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return (img @ w)[..., None].astype(np.float32)


def _io_type(opt: dict) -> str:
    return (opt.get("io_backend") or {"type": "disk"}).get("type", "disk")


def _check_disk(opt: dict) -> None:
    """Datasets that read image folders only (as in JAX) refuse an
    archive."""
    io = _io_type(opt)
    if io != "disk":
        raise NotImplementedError(
            f"io_backend {io!r}: this dataset reads image folders (io_backend "
            "disk); the keyed archives (lmdb, tfrecord) serve "
            "Dataset_PairedImageWithRef and Dataset_PairedDehazeWithRef")


def _open_archives(opt: dict):
    """The lq / gt / ref archives of a WithRef dataset whose io_backend is
    lmdb (reference `*.lmdb` folders) or tfrecord (packed archive
    prefixes), and the path records of their common keys; None for the
    disk backend.  Archives that disagree on their keys were built from
    unmatched folders: that raises (JAX `_init_packed_io`)."""
    io = _io_type(opt)
    if io == "disk":
        return None
    if io == "lmdb":
        from textualdegremoval_tpu_torch.data.lmdb_reader import (
            LmdbKeyedReader as open_archive,
        )
    elif io == "tfrecord":
        from textualdegremoval_tpu_torch.data.packed import (
            open_packed as open_archive,
        )
    else:
        raise ValueError(f"io_backend {io!r}: disk, lmdb or tfrecord")
    readers = {k: open_archive(opt[root]) for k, root in
               (("lq", "lqroot"), ("gt", "hqroot"), ("ref", "refroot"))}
    sets = {k: set(r.keys()) for k, r in readers.items()}
    common = sets["lq"] & sets["gt"] & sets["ref"]
    dropped = {k: sorted(s - common) for k, s in sets.items() if s - common}
    if dropped:
        detail = "; ".join(f"{k}: {len(v)} unmatched (e.g. {v[:3]})"
                           for k, v in dropped.items())
        raise ValueError(f"packed archives disagree on keys — {detail}. "
                         "Rebuild the archives from matched folders.")
    return readers, [{"lq_path": k, "gt_path": k, "ref_path": k}
                     for k in sorted(common)]


def _crop_pair(opt, rng, lq, gt, augs_default: bool):
    """The training crop of an (lq, gt) pair: reflect padding to gt_size,
    the paired random crop, and the dihedral augmentation where
    geometric_augs (default `augs_default`) asks for it."""
    gs = opt.get("gt_size", 128)
    lq, gt = reflect_pad_to(lq, gs), reflect_pad_to(gt, gs)
    gt, lq = paired_random_crop(gt, lq, gs, opt.get("scale", 1), rng)
    if opt.get("geometric_augs", augs_default):
        lq, gt = random_augmentation(lq, gt, rng=rng)
    return lq, gt


class PairedImageDataset:
    """lq/gt pairs, cropped and augmented in training (reference
    Dataset_PairedImage :45-157, YAML type `Dataset_PairedImage`)."""

    def __init__(self, opt: dict):
        _check_disk(opt)
        self.opt = opt
        self.paths = paired_paths_from_folder(
            (opt["lqroot"], opt["hqroot"]), ("lq", "gt"),
            opt.get("filename_tmpl", "{}"))
        self.is_train = opt.get("phase", "train") == "train"
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        rec = self.paths[idx % len(self.paths)]
        lq = imread_f32(rec["lq_path"])
        gt = imread_f32(rec["gt_path"])
        if self.is_train:
            lq, gt = _crop_pair(self.opt, self.rng, lq, gt, False)
        return {"lq": lq, "gt": gt, **rec}


class PairedImageWithRefDataset:
    """lq/gt pairs cropped and augmented, the reference passed whole
    (reference Dataset_PairedImageWithRef :161-254, YAML type
    `Dataset_PairedImageWithRef`): the trainer picks the reference crop."""

    def __init__(self, opt: dict):
        self.opt = opt
        self._open(opt, lambda: tri_paths_from_folder(
            (opt["lqroot"], opt["hqroot"], opt["refroot"]),
            ("lq", "gt", "ref"), opt.get("filename_tmpl", "{}")))
        self.is_train = opt.get("phase", "train") == "train"
        self.rng = random.Random(opt.get("seed"))

    def _open(self, opt, folder_paths):
        """self.paths from the keyed archives (self.readers) where
        io_backend names them, else from `folder_paths()`."""
        archives = _open_archives(opt)
        if archives is None:
            self.readers, self.paths = None, folder_paths()
        else:
            self.readers, self.paths = archives

    def _read(self, kind: str, rec_path: str) -> np.ndarray:
        if self.readers is None:
            return imread_f32(rec_path)
        return imdecode_f32(self.readers[kind].get(rec_path), name=rec_path)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        rec = self.paths[idx % len(self.paths)]
        lq = self._read("lq", rec["lq_path"])
        gt = self._read("gt", rec["gt_path"])
        ref = self._read("ref", rec["ref_path"])
        if self.is_train:
            lq, gt = _crop_pair(self.opt, self.rng, lq, gt, False)
        return {"lq": lq, "gt": gt, "ref": ref, **rec}


class PairedDehazeWithRefDataset(PairedImageWithRefDataset):
    """Dehaze pairs through a meta_info file of 'haze_name gt_name' lines,
    or by folder where it has none (reference Dataset_PairedDehazeWithRef
    :505-621, YAML type `Dataset_PairedDehazeWithRef`)."""

    def __init__(self, opt: dict):
        self.opt = opt
        folders = (opt["lqroot"], opt["hqroot"], opt["refroot"])
        meta = opt.get("meta_info_file")
        self._open(opt, lambda: (
            paths_from_meta_info(meta, folders, ("lq", "gt", "ref")) if meta
            else tri_paths_from_folder(folders, ("lq", "gt", "ref"))))
        self.is_train = opt.get("phase", "train") == "train"
        self.rng = random.Random(opt.get("seed"))


class GaussianDenoisingWithRefDataset:
    """Synthetic Gaussian noise on clean images, with a reference
    (reference Dataset_GaussianDenoisingWithRef :368-501, YAML type
    `Dataset_GaussianDenoisingWithRef`).  Training: sigma `constant`
    (sigma_range itself), `random` (uniform in sigma_range) or `choice`
    (one of sigma_range), the noise drawn from numpy's global generator;
    evaluation: sigma_test, the noise of `np.random.RandomState(0)` for
    every item.  in_ch 1 turns gt and ref to luma."""

    def __init__(self, opt: dict):
        _check_disk(opt)
        self.opt = opt
        self.paths = tri_paths_from_folder(
            (opt["hqroot"], opt["hqroot"], opt["refroot"]),
            ("lq", "gt", "ref"))
        self.is_train = opt.get("phase", "train") == "train"
        self.sigma_type = opt.get("sigma_type", "constant")
        if self.sigma_type not in ("constant", "random", "choice"):
            raise ValueError(f"sigma_type {self.sigma_type!r}: constant, "
                             "random or choice")
        self.sigma_range = opt.get("sigma_range", 15)
        self.sigma_test = opt.get("sigma_test", 15)
        self.in_ch = opt.get("in_ch", 3)
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.paths)

    def _train_sigma(self):
        if self.sigma_type == "constant":
            return self.sigma_range
        if self.sigma_type == "random":
            return self.rng.uniform(*self.sigma_range)
        return self.rng.choice(self.sigma_range)

    def __getitem__(self, idx):
        rec = self.paths[idx % len(self.paths)]
        gt = imread_f32(rec["gt_path"])
        ref = imread_f32(rec["ref_path"])
        if self.in_ch == 1:
            gt, ref = rgb2gray(gt), rgb2gray(ref)
        if self.is_train:
            gs = self.opt.get("gt_size", 128)
            gt = reflect_pad_to(gt, gs)
            gt, _ = paired_random_crop(gt, gt, gs, 1, self.rng)
            if self.opt.get("geometric_augs", True):
                (gt,) = random_augmentation(gt, rng=self.rng)
            sigma = self._train_sigma()
            lq = gt + np.float32(np.random.randn(*gt.shape)) * sigma / 255.0
        else:
            noise = np.random.RandomState(0).randn(*gt.shape)
            lq = gt + noise.astype(np.float32) * self.sigma_test / 255.0
        return {"lq": lq.astype(np.float32), "gt": gt, "ref": ref,
                "lq_path": rec["gt_path"], "gt_path": rec["gt_path"],
                "ref_path": rec["ref_path"]}


class PairedUnifiedWithRefDataset:
    """All-in-one training (reference Dataset_PairedUnifiedWithRef
    :625-793 with its ref-read bug fixed, YAML type
    `Dataset_PairedUnifiedWithRef`): each item picks one task of
    {denoise at sigma 15 / 25 / 50, derain, dehaze} among those with
    folders, with `rng`; the denoise noise comes from numpy's global
    generator.  Every phase crops and augments (geometric_augs default
    on); the reference is passed whole, and `task` names the pick."""

    TASKS = ("denoise_15", "denoise_25", "denoise_50", "derain", "dehaze")

    def __init__(self, opt: dict):
        _check_disk(opt)
        self.opt = opt
        self.rng = random.Random(opt.get("seed"))
        self.is_train = opt.get("phase", "train") == "train"
        self.task_paths = {}
        for task in ("denoise", "derain", "dehaze"):
            sub = opt.get(task)
            if not sub:
                continue
            lq = sub["hqroot"] if task == "denoise" else sub["lqroot"]
            self.task_paths[task] = tri_paths_from_folder(
                (lq, sub["hqroot"], sub["refroot"]), ("lq", "gt", "ref"))
        if not self.task_paths:
            raise ValueError("Dataset_PairedUnifiedWithRef: none of denoise, "
                             "derain, dehaze is given")

    def __len__(self):
        return max(len(v) for v in self.task_paths.values())

    def __getitem__(self, idx):
        avail = [t for t in self.TASKS if t.split("_")[0] in self.task_paths]
        task = self.rng.choice(avail)
        base = task.split("_")[0]
        paths = self.task_paths[base]
        rec = paths[idx % len(paths)]
        gt = imread_f32(rec["gt_path"])
        ref = imread_f32(rec["ref_path"])
        gs = self.opt.get("gt_size", 128)
        if base == "denoise":
            sigma = float(task.split("_")[1])
            gt = reflect_pad_to(gt, gs)
            gt, _ = paired_random_crop(gt, gt, gs, 1, self.rng)
            lq = gt + np.float32(np.random.randn(*gt.shape)) * sigma / 255.0
        else:
            lq = reflect_pad_to(imread_f32(rec["lq_path"]), gs)
            gt, lq = paired_random_crop(reflect_pad_to(gt, gs), lq, gs, 1,
                                        self.rng)
        if self.opt.get("geometric_augs", True):
            lq, gt = random_augmentation(lq, gt, rng=self.rng)
        return {"lq": lq.astype(np.float32), "gt": gt, "ref": ref,
                "task": task}


class PairedImageDPWithRefDataset:
    """Dual-pixel defocus in 16 bits (reference
    Dataset_PairedImageWithRef_DualPixel_16bit :258-364, YAML type
    `Dataset_PairedImageWithRef_DualPixel_16bit`): the left and right
    views lqL, lqR concatenated to a 6-channel lq, a 16-bit gt and an 8-bit
    reference, paired by index of the sorted listings."""

    def __init__(self, opt: dict):
        _check_disk(opt)
        self.opt = opt
        self.rng = random.Random(opt.get("seed"))
        self.is_train = opt.get("phase", "train") == "train"
        lists = [scan_images(opt[k]) for k in ("hqroot", "lqlroot",
                                                "lqrroot", "refroot")]
        if len({len(v) for v in lists}) != 1:
            raise ValueError(f"gt, lqL, lqR and ref counts differ: "
                             f"{[len(v) for v in lists]}")
        self.paths = [{"gt_path": g, "lql_path": l, "lqr_path": r,
                       "ref_path": f} for g, l, r, f in zip(*lists)]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        rec = self.paths[idx % len(self.paths)]
        gt = imread_f32(rec["gt_path"], bit16=True)
        lq = np.concatenate([imread_f32(rec["lql_path"], bit16=True),
                             imread_f32(rec["lqr_path"], bit16=True)], -1)
        ref = imread_f32(rec["ref_path"])
        if self.is_train:
            lq, gt = _crop_pair(self.opt, self.rng, lq, gt, False)
        return {"lq": lq, "gt": gt, "ref": ref}
