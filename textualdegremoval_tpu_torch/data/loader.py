"""Dataset and loader factories (counterpart of create_dataset /
create_dataloader in textualdegremoval_tpu/data/__init__.py), on
torch.utils.data.DataLoader: worker processes decode and augment, batches
come as CPU tensors, pinned when the training device is CUDA so that the
copy to the card can overlap.  Workers are spawned, not forked (the
training process runs threads), live for the whole run, and each reseeds
its copy of the dataset's augmentation RNG, so that workers do not repeat
each other's crops."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader

from textualdegremoval_tpu_torch.data.datasets import (
    PairedImageWithRefDataset,
)
from textualdegremoval_tpu_torch.data.sampler import EnlargedSampler

# YAML dataset types ported so far; the JAX registry's others follow with
# the slices that need them
_DATASETS = {"Dataset_PairedImageWithRef": PairedImageWithRefDataset}


def create_dataset(opt: dict):
    name = opt["type"]
    if name not in _DATASETS:
        raise NotImplementedError(
            f"dataset type {name!r} is not ported yet (ported: "
            f"{sorted(_DATASETS)})")
    return _DATASETS[name](opt)


def collate(samples: list[dict]) -> dict:
    """Stack arrays into (B, H, W, C) tensors; keep metadata as lists."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = (torch.from_numpy(np.stack(vals))
                  if isinstance(vals[0], np.ndarray) else vals)
    return out


def seed_worker(worker_id: int) -> None:
    """DataLoader worker_init_fn: each worker reseeds its copy of the
    dataset's generators (`rng`, and `np_rng` where it has one), so that
    workers do not repeat each other's crops and noise."""
    info = torch.utils.data.get_worker_info()
    info.dataset.rng.seed(info.seed)
    if hasattr(info.dataset, "np_rng"):
        info.dataset.np_rng = np.random.default_rng(info.seed)


def create_dataloader(dataset, opt: dict, num_replicas: int = 1,
                      rank: int = 0, device: str | torch.device = "cpu"):
    """Training phase: batch_size_per_gpu items per batch from an
    EnlargedSampler (enlarged so that every rank gets at least one full
    batch per epoch), num_worker_per_gpu worker processes, incomplete
    batches dropped.  Other phases: one item per batch, in order."""
    pin = torch.device(device).type == "cuda"
    if opt.get("phase", "train") != "train":
        return DataLoader(dataset, batch_size=1, shuffle=False,
                          num_workers=0, collate_fn=collate, pin_memory=pin)
    batch = opt.get("batch_size_per_gpu", 1)
    min_ratio = -(-batch * num_replicas // max(len(dataset), 1))
    ratio = max(opt.get("dataset_enlarge_ratio", 1), min_ratio)
    sampler = EnlargedSampler(len(dataset), num_replicas, rank, ratio)
    workers = opt.get("num_worker_per_gpu", 4)
    return DataLoader(dataset, batch_size=batch, sampler=sampler,
                      num_workers=workers, collate_fn=collate,
                      drop_last=True, pin_memory=pin,
                      worker_init_fn=seed_worker,
                      multiprocessing_context="spawn" if workers else None,
                      persistent_workers=workers > 0)
