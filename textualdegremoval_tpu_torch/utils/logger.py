"""Logging of the training loops: the root logger, a scalar sink and the
iteration line.

Counterpart of textualdegremoval_tpu/utils/logger.py (reference
utils/logger.py): `get_root_logger` with a file handler on rank 0,
`MessageLogger`'s epoch / iter / lr / eta / loss line in JAX's format,
and `ScalarWriter`, which appends each logged step's scalars to
`<log_dir>/scalars.jsonl` and mirrors them to TensorBoard when asked
(`tensorboard=True`, the reference's `logger.use_tb_logger`) and to wandb
when a project is given, each only where its package imports.  A run
needs neither package.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time

import torch

_FORMAT = ("%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S")


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def get_root_logger(name: str = "tdr", log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The named logger with a stream handler and, on rank 0 where
    `log_file` is given, a file handler; other ranks log errors only.  A
    second call replaces the handlers the first one added, so a second run
    in one process logs to its own file."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(*_FORMAT)
    handlers = [logging.StreamHandler()]
    if log_file and _rank() == 0:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.setLevel(log_level if _rank() == 0 else logging.ERROR)
    logger.propagate = False
    return logger


class ScalarWriter:
    """Scalars of a logged step: one JSON line {"step": ..., name: value}
    in <log_dir>/scalars.jsonl (rank 0 only), mirrored to TensorBoard and
    wandb where asked for and importable."""

    def __init__(self, log_dir: str, wandb_opt: dict | None = None,
                 tensorboard: bool = False):
        self._jsonl = self._tb = self._wandb = None
        if _rank() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)
        if wandb_opt and wandb_opt.get("project"):
            try:
                import wandb
            except ImportError:
                pass
            else:
                wandb.init(project=wandb_opt["project"],
                           resume="allow" if wandb_opt.get("resume_id")
                           else None, id=wandb_opt.get("resume_id"))
                self._wandb = wandb

    def write(self, step: int, scalars: dict) -> None:
        values = {k: float(v) for k, v in scalars.items()}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **values}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(values, step=step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class MessageLogger:
    """The epoch / iter / lr / eta / loss line of a logged iteration
    (reference utils/logger.py:33-77), its scalars to `writer`."""

    def __init__(self, total_iters: int, start_iter: int = 0, writer=None,
                 logger: logging.Logger | None = None):
        self.total_iters = total_iters
        self.start_iter = start_iter
        self.writer = writer
        self.logger = logger or get_root_logger()
        self.start_time = time.time()

    def __call__(self, epoch: int, itr: int, lrs, losses: dict,
                 iter_time: float = 0.0, data_time: float = 0.0) -> None:
        elapsed = time.time() - self.start_time
        done = max(itr - self.start_iter, 1)
        eta = elapsed / done * (self.total_iters - itr)
        eta_str = str(datetime.timedelta(seconds=int(eta)))
        lr_str = ", ".join(f"{lr:.3e}" for lr in (
            lrs if isinstance(lrs, (list, tuple)) else [lrs]))
        loss_str = " ".join(f"{k}: {float(v):.4e}" for k, v in losses.items())
        self.logger.info(
            f"[epoch:{epoch:3d}, iter:{itr:8,d}, lr:({lr_str})] "
            f"[eta: {eta_str}, time (data): {iter_time:.3f} "
            f"({data_time:.3f})] {loss_str}")
        if self.writer is not None:
            self.writer.write(itr, losses)
