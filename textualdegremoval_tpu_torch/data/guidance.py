"""Pipeline A datasets (counterpart of textualdegremoval_tpu/data/guidance.py;
reference data/guidance_generation_dataset.py).

* UnpairedLQHQDataset (:86-265): the I2T stage; any images, a random
  square crop -> the SD view in [-1, 1] at `size` and the CLIP-normalised
  view; the prompt's placeholder index.
* PairedLQHQDataset (:269-552): the TR stage; task-aware LQ/HQ pairs, the
  CLIP view from the degraded image, the SD target from the clean one; the
  denoise task synthesises its noise (seeded).  Tasks are drawn uniformly
  (the reference's task choice always yields a bool; the JAX package's
  SURVEY note).
* ReferenceGenerationDataset (:556-686): inference; a centre crop -> both
  views.

Items are HWC float32 numpy arrays, the crops drawn from the dataset's own
`random.Random(seed)` in the JAX classes' order, so the same seed gives the
same items.  Resizes are `resize_bilinear`, cv2.resize's INTER_LINEAR
arithmetic in torch: the machine with the card has no cv2.
"""

from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.data.datasets import imread_f32
from textualdegremoval_tpu_torch.data.pairing import scan_images

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def resize_bilinear(img: torch.Tensor, size) -> torch.Tensor:
    """HWC float32 -> (h, w, C) for size (h, w), or (size, size, C) for an
    int: bilinear with half-pixel centres and no antialiasing, the
    arithmetic of cv2.resize's INTER_LINEAR (the JAX package's resize), on
    img's device."""
    hw = (size, size) if isinstance(size, int) else tuple(size)
    x = img.float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                      antialias=False)
    return x[0].permute(1, 2, 0)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(img)),
                           (h, w)).numpy()


def clip_view(img: np.ndarray, size: int = 224) -> np.ndarray:
    """HWC float32 in [0, 1] -> (size, size, 3), CLIP-normalised."""
    return (_resize(img, size, size) - CLIP_MEAN) / CLIP_STD


def _cover(img: np.ndarray, size: int) -> np.ndarray:
    """Resized so that its shorter side is at least `size` (aspect kept)."""
    h, w = img.shape[:2]
    if min(h, w) >= size:
        return img
    s = size / min(h, w)
    return _resize(img, int(np.ceil(h * s)), int(np.ceil(w * s)))


def _random_square_crop(img, size, rng):
    img = _cover(img, size)
    h, w = img.shape[:2]
    top = rng.randint(0, h - size)
    left = rng.randint(0, w - size)
    return img[top: top + size, left: left + size]


class UnpairedLQHQDataset:
    def __init__(self, data_root: str, size: int = 512,
                 placeholder_index: int = 5, seed=None,
                 clip_size: int = 224):
        self.paths = scan_images(data_root)
        self.size = size
        self.clip_size = clip_size
        self.placeholder_index = placeholder_index
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        img = imread_f32(self.paths[idx % len(self.paths)])
        crop = _random_square_crop(img, self.size, self.rng)
        return {
            "pixel_values": crop * 2.0 - 1.0,
            "pixel_values_clip": clip_view(crop, self.clip_size),
            "index": self.placeholder_index,
        }


class PairedLQHQDataset:
    """TR stage.  task_roots: task -> (lq_root, hq_root); a task without an
    lq_root ('denoise') synthesises Gaussian noise of sigma in
    sigma_range / 255 from its clean images."""

    def __init__(self, task_roots: dict[str, tuple[str | None, str]],
                 size: int = 512, placeholder_index: int = 5,
                 sigma_range=(5, 50), seed=None, clip_size: int = 224):
        self.tasks = sorted(task_roots)
        self.roots = {
            t: (scan_images(lq) if lq else None, scan_images(hq))
            for t, (lq, hq) in task_roots.items()
        }
        self.size = size
        self.placeholder_index = placeholder_index
        self.sigma_range = sigma_range
        self.clip_size = clip_size
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def __len__(self):
        return max(len(hq) for _, hq in self.roots.values())

    def __getitem__(self, idx):
        task = self.rng.choice(self.tasks)
        lq_paths, hq_paths = self.roots[task]
        hq = imread_f32(hq_paths[idx % len(hq_paths)])
        if lq_paths is None:  # denoise: synthesise
            crop_hq = _random_square_crop(hq, self.size, self.rng)
            sigma = self.rng.uniform(*self.sigma_range)
            crop_lq = crop_hq + self.np_rng.standard_normal(
                crop_hq.shape, np.float32) * np.float32(sigma / 255.0)
        else:  # one crop for the aligned pair
            lq = imread_f32(lq_paths[idx % len(lq_paths)])
            if min(hq.shape[:2]) < self.size:
                hq = _cover(hq, self.size)
                lq = _resize(lq, *hq.shape[:2])
            h, w = hq.shape[:2]
            top = self.rng.randint(0, h - self.size)
            left = self.rng.randint(0, w - self.size)
            crop_hq = hq[top: top + self.size, left: left + self.size]
            crop_lq = lq[top: top + self.size, left: left + self.size]
        return {
            "pixel_values": crop_hq * 2.0 - 1.0,  # the clean SD target
            "pixel_values_clip": clip_view(crop_lq, self.clip_size),
            "index": self.placeholder_index,
            "task": task,
        }


class ReferenceGenerationDataset:
    def __init__(self, data_root: str, size: int = 512,
                 placeholder_index: int = 5):
        self.paths = scan_images(data_root)
        self.size = size
        self.placeholder_index = placeholder_index

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        img = imread_f32(self.paths[idx])
        h, w = img.shape[:2]
        s = min(h, w)
        img = img[(h - s) // 2: (h - s) // 2 + s,
                  (w - s) // 2: (w - s) // 2 + s]
        img = _resize(img, self.size, self.size)
        return {
            "pixel_values": img * 2.0 - 1.0,
            "pixel_values_clip": clip_view(img),
            "index": self.placeholder_index,
            "path": self.paths[idx],
        }

