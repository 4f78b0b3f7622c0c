"""Learning-rate schedules as functions of the optimizer's update count.

Counterpart of textualdegremoval_tpu/train/schedules.py (reference
models/lr_scheduler.py:7-232).  Each schedule maps a step (an int, counted
from 0 as optax counts) to a float learning rate; the optimizer reads it
on the host before each update.
"""

from __future__ import annotations

import math

import numpy as np


def multi_step_restart_lr(base_lr, milestones, gamma=0.1, restarts=(0,),
                          restart_weights=(1,)):
    milestones = sorted(milestones)

    def schedule(step):
        lr = base_lr
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                lr = base_lr * w
        n_decays = sum(1 for m in milestones if m <= step)
        return lr * gamma ** n_decays

    return schedule


def linear_lr(base_lr, total_iter):
    def schedule(step):
        return base_lr * (1.0 - step / total_iter)

    return schedule


def vibrate_lr(base_lr, total_iter):
    """Sawtooth schedule (reference VibrateLR, lr_scheduler.py:72-112)."""
    period = max(total_iter // 80, 2)
    half = max(period // 2, 1)

    def schedule(step):
        process = step / total_iter
        f = (1 - process * 8 / 3 if process < 3 / 8
             else 0.2 if process < 5 / 8 else 0.1)
        t = step % period
        f2 = 2 - t / half if t >= half else t / half
        weight = f * f2
        if step < half:
            weight = max(weight, 0.1)
        return base_lr * weight

    return schedule


def cosine_annealing_restart_lr(base_lr, periods, restart_weights=(1,),
                                eta_min=0.0):
    return cosine_annealing_restart_cyclic_lr(
        base_lr, periods, restart_weights, [eta_min] * len(periods))


def cosine_annealing_restart_cyclic_lr(base_lr, periods, restart_weights=(1,),
                                       eta_mins=(0.0,)):
    """Per-period eta_min cosine restarts (the schedule of every reference
    restoration config, lr_scheduler.py:186-232)."""
    cumulative = np.cumsum(periods)
    starts = np.concatenate([[0], cumulative[:-1]])

    def schedule(step):
        idx = min(int(np.sum(step > cumulative)), len(periods) - 1)
        emin = eta_mins[idx]
        cos = math.cos(math.pi * (step - starts[idx]) / periods[idx])
        return emin + restart_weights[idx] * 0.5 * (base_lr - emin) * (1 + cos)

    return schedule


_SCHEDULES = {
    "MultiStepRestartLR": multi_step_restart_lr,
    "LinearLR": linear_lr,
    "VibrateLR": vibrate_lr,
    "CosineAnnealingRestartLR": cosine_annealing_restart_lr,
    "CosineAnnealingRestartCyclicLR": cosine_annealing_restart_cyclic_lr,
    # names the reference wires in base_model.py:101-120 but never
    # implemented; the JAX package maps them to the cyclic variant
    "CosineAnnealingWarmupRestarts": cosine_annealing_restart_cyclic_lr,
    "CosineAnnealingLRWithRestart": cosine_annealing_restart_cyclic_lr,
}


def build_schedule(base_lr: float, opt: dict):
    """Resolve a reference YAML scheduler config into step -> lr."""
    opt = dict(opt)
    return _SCHEDULES[opt.pop("type")](base_lr, **opt)


def warmup_wrap(schedule, warmup_iter: int, base_lr: float):
    """Linear warm-up over warmup_iter steps, then the schedule (reference
    base_model.py:183-205)."""
    if warmup_iter <= 0:
        return schedule

    def warmed(step):
        if step < warmup_iter:
            return base_lr * step / warmup_iter
        return schedule(step)

    return warmed
