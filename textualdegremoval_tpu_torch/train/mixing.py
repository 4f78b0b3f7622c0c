"""Mixup augmentation (reference Mixing_Augment,
models/image_restoration_ref_model.py; JAX textualdegremoval_tpu/train/
mixing.py): lam ~ Beta(beta, beta) convex mix of shuffled pairs, with an
optional identity arm.  Random numbers come from an explicit
torch.Generator; they differ from jax.random's for the same seed."""

from __future__ import annotations

import math

import torch


def _gamma(a: float, gen: torch.Generator) -> float:
    """One Gamma(a, 1) draw, a >= 1 (Marsaglia and Tsang)."""
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen))
        v = (1.0 + c * x) ** 3
        if v <= 0:
            continue
        u = float(torch.rand((), generator=gen))
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def sample_beta(a: float, gen: torch.Generator) -> float:
    """One Beta(a, a) draw as X / (X + Y), X, Y ~ Gamma(a); a < 1 uses the
    boost Gamma(a) = Gamma(a + 1) U^(1/a)."""
    def g():
        if a >= 1:
            return _gamma(a, gen)
        u = float(torch.rand((), generator=gen))
        return _gamma(a + 1, gen) * u ** (1.0 / a)

    x, y = g(), g()
    return x / (x + y)


def mixing_augment(gen: torch.Generator, target, input_,
                   mixup_beta: float = 1.2, use_identity: bool = True):
    """Returns (target', input'), batch-first tensors."""
    lam = sample_beta(mixup_beta, gen)
    perm = torch.randperm(target.shape[0], generator=gen).to(target.device)
    if use_identity and int(torch.randint(0, 2, (), generator=gen)) == 0:
        # one extra arm: with probability 1/2 keep the originals
        return target, input_
    return (lam * target + (1 - lam) * target[perm],
            lam * input_ + (1 - lam) * input_[perm])
