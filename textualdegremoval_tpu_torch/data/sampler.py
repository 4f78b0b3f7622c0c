"""Enlarged sampler (reference data/data_sampler.py:6-49; JAX
textualdegremoval_tpu/data/sampler.py): an epoch-seeded permutation over
dataset * ratio, strided by rank, so that iteration-based training never
runs out of an epoch and each process reads its own shard."""

from __future__ import annotations

import numpy as np


class EnlargedSampler:
    def __init__(self, num_samples: int, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 1):
        self.num_samples_raw = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.total_size = int(
            np.ceil(num_samples * ratio / num_replicas)) * num_replicas
        self.per_rank = self.total_size // num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.per_rank

    def __iter__(self):
        indices = np.random.RandomState(self.epoch).permutation(
            self.total_size) % self.num_samples_raw
        return iter(indices[self.rank:: self.num_replicas].tolist())
