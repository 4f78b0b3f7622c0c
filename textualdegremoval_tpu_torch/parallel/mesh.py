"""Data parallelism over torch.distributed: what JAX's dp mesh does for a
torch process.

Counterpart of textualdegremoval_tpu/parallel/mesh.py.  There the batch
is sharded over a 1-D `dp` mesh axis, the parameters are replicated, and
XLA inserts the gradient all-reduce into the jitted step (the loss is a
global mean).  Here each rank is one process on one device:

* the batch is sharded by construction: each rank's loader yields its own
  `batch_size_per_gpu` items (the reference's meaning; JAX's per-device
  batch with one device a process), so the global batch is world times
  that;
* `replicate` broadcasts rank 0's training state (after build, load or
  auto-resume), so every rank starts from the same one, and has the
  model's BatchNorms take the global batch's moments;
* `all_reduce_mean` averages the gradients, in flat buckets of
  `BUCKET_BYTES` in the order given, the same on every rank, so that one
  collective is not made per parameter.

The step takes its gradients with `torch.autograd.grad`, which
DistributedDataParallel does not support, so the train steps call
`all_reduce_mean` themselves (train/trainer.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from textualdegremoval_tpu_torch.parallel.bootstrap import world

BUCKET_BYTES = 64 << 20


def buckets(tensors, bucket_bytes: int = BUCKET_BYTES):
    """Index lists of `tensors` grouped by dtype and device (in order of
    first appearance) and cut where a group passes `bucket_bytes`; the
    same on every rank for the same list of shapes."""
    kinds: dict = {}
    for i, t in enumerate(tensors):
        kinds.setdefault((t.dtype, t.device), []).append(i)
    for idx in kinds.values():
        cur, size = [], 0
        for i in idx:
            cur.append(i)
            size += tensors[i].numel() * tensors[i].element_size()
            if size >= bucket_bytes:
                yield cur
                cur, size = [], 0
        if cur:
            yield cur


def all_reduce_mean(tensors) -> list:
    """The mean over the ranks of each tensor: a list of tensors shaped as
    `tensors` (views of the reduced buckets), or `tensors` itself with one
    rank."""
    tensors = list(tensors)
    n = world()
    if n == 1:
        return tensors
    out = [None] * len(tensors)
    for idx in buckets(tensors):
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat.div_(n)
        off = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = flat[off: off + k].view(tensors[i].shape)
            off += k
    return out


@torch.no_grad()
def broadcast_(tensors) -> None:
    """Overwrite each tensor in place with rank 0's."""
    tensors = list(tensors)
    if world() == 1:
        return
    for idx in buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.broadcast(flat, 0)
        off = 0
        for i in idx:
            k = tensors[i].numel()
            tensors[i].copy_(flat[off: off + k].view(tensors[i].shape))
            off += k


def global_batch_moments(model: torch.nn.Module) -> None:
    """Have the model's BatchNorms (models.sfnet.BatchNorm) normalise in
    train mode by the moments of the global batch, averaged over the
    ranks, as JAX's mean over a dp-sharded batch is global.  A no-op with
    one rank."""
    from textualdegremoval_tpu_torch.models.sfnet import BatchNorm

    if world() == 1:
        return
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.across_ranks = True


def replicate(state):
    """Broadcast rank 0's training state (train.trainer.TrainState) to
    every rank: parameters, buffers (BatchNorm statistics), both Adam
    moments, the update count, the step and the EMA; and turn on the
    model's `global_batch_moments`.  Returns `state`."""
    if world() == 1:
        return state
    global_batch_moments(state.model)
    opt = state.opt
    broadcast_([*state.model.parameters(), *state.model.buffers(),
                *opt.mu, *opt.nu, *(state.ema or [])])
    device = opt.params[0].device if opt.params else torch.device("cpu")
    counts = torch.tensor([state.step, opt.count], dtype=torch.int64,
                          device=device)
    broadcast_([counts])
    state.step, opt.count = (int(v) for v in counts.tolist())
    return state
