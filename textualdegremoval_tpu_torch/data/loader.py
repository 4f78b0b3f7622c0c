"""Dataset and loader factories (counterpart of create_dataset /
create_dataloader in textualdegremoval_tpu/data/__init__.py), on
torch.utils.data.DataLoader: worker processes decode and augment, batches
come as CPU tensors, pinned when the training device is CUDA so that the
copy to the card can overlap (`DevicePrefetcher`, the counterpart of JAX
data/loader.py's).  Workers are spawned, not forked (the
training process runs threads), live for the whole run, and each reseeds
its copy of the dataset's augmentation RNG, so that workers do not repeat
each other's crops."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader

from textualdegremoval_tpu_torch.data.datasets import (
    GaussianDenoisingWithRefDataset, PairedDehazeWithRefDataset,
    PairedImageDataset, PairedImageDPWithRefDataset,
    PairedImageWithRefDataset, PairedUnifiedWithRefDataset,
)
from textualdegremoval_tpu_torch.data.sampler import EnlargedSampler

# the YAML dataset types (the JAX registry's names)
_DATASETS = {
    "Dataset_PairedImage": PairedImageDataset,
    "Dataset_PairedImageWithRef": PairedImageWithRefDataset,
    "Dataset_GaussianDenoisingWithRef": GaussianDenoisingWithRefDataset,
    "Dataset_PairedDehazeWithRef": PairedDehazeWithRefDataset,
    "Dataset_PairedUnifiedWithRef": PairedUnifiedWithRefDataset,
    "Dataset_PairedImageWithRef_DualPixel_16bit": PairedImageDPWithRefDataset,
}


def create_dataset(opt: dict):
    name = opt["type"]
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset type {name!r} (known: "
                         f"{sorted(_DATASETS)})")
    return _DATASETS[name](opt)


def collate(samples: list[dict]) -> dict:
    """Stack arrays into (B, H, W, C) tensors; keep metadata as lists.
    Arrays of different shapes in one batch raise, as the JAX package's
    np.stack does (the all-in-one dataset passes whole references, so its
    folders must hold references of one size)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if not isinstance(vals[0], np.ndarray):
            out[k] = vals
            continue
        shapes = sorted({v.shape for v in vals})
        if len(shapes) > 1:
            raise ValueError(f"collate: {k!r} arrays of shapes {shapes} in "
                             "one batch cannot be stacked")
        out[k] = torch.from_numpy(np.stack(vals))
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


class DevicePrefetcher:
    """Batches of `loader` on `device`, the next one's copy in flight while
    the current one is used (JAX `DevicePrefetcher`, the reference's
    CUDAPrefetcher).  On CUDA each batch's tensors are copied on a side
    stream (from pinned memory the copy runs asynchronously); before a
    batch is handed out the consumer's stream waits for that stream and
    every tensor records the consumer's stream, so the allocator cannot
    reuse its memory while queued work still reads it.  Elsewhere each
    batch is moved as it comes.  Batches keep their order, none is
    dropped; values that are not tensors pass as they are."""

    def __init__(self, loader, device: str | torch.device):
        self.loader = loader
        self.device = torch.device(device)

    def _move(self, batch: dict) -> dict:
        return {k: v.to(self.device, non_blocking=True)
                if isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}

    def __iter__(self):
        it = iter(self.loader)
        if self.device.type != "cuda":
            for batch in it:
                yield self._move(batch)
            return
        side = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)

        def put(batch):
            with torch.cuda.stream(side):
                return self._move(batch)

        def ready(batch):
            consumer.wait_stream(side)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
            return batch

        try:
            nxt = put(next(it))
        except StopIteration:
            return
        for batch in it:
            cur = ready(nxt)
            nxt = put(batch)
            yield cur
        yield ready(nxt)
