"""Fully sharded data parallelism (ZeRO-3) over the ranks.

Counterpart of textualdegremoval_tpu/parallel/fsdp.py, which shards every
parameter leaf along its largest dimension that the dp axis divides and
lets GSPMD insert the all-gathers (forward and backward) and the
reduce-scatters (gradients), the optimizer state sharded like the
parameters.  Here the same layout is kept by hand:

* `fsdp_spec(shape, world)`: the dimension JAX's rule shards, or None
  (replicated) for scalars and leaves that no dimension fits;
* `shard_train_state`: each rank keeps its slice of every sharded
  parameter, of both Adam moments and of the EMA; the module's full
  parameters are freed between steps;
* the step is `train.trainer.make_train_step`'s, which calls the sharded
  state's hooks: all-gather the full parameters into the module
  (`gather`), forward, `torch.autograd.grad`, free the full parameters
  (`release`), reduce-scatter the gradients as a mean along each leaf's
  dimension, replicated leaves and the loss all-reduced
  (`reduce_gradients`), clip by the global norm (`global_norm`: the
  shards' squares summed across the ranks, replicated leaves counted
  once), update the own slices, EMA of the own slices.

torch's own FSDP does not fit this trainer: FSDP2's `fully_shard` shards
dimension 0 only (not JAX's layout), and both FSDP versions reduce the
gradients from hooks on `.grad`, which `torch.autograd.grad` never fills.

Collectives on gloo take CUDA tensors (all-gather, reduce-scatter,
all-reduce; checked on the card by chip_smoke.py phase 38), so one code
path serves every backend.  The collectives are bucketed as
`parallel.mesh`'s, the same on every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
import torch
import torch.distributed as dist
from torch.autograd.graph import increment_version

from textualdegremoval_tpu_torch.parallel.bootstrap import rank, world
from textualdegremoval_tpu_torch.parallel.mesh import (
    BUCKET_BYTES, all_reduce_mean, buckets, global_batch_moments,
)
from textualdegremoval_tpu_torch.train.trainer import AdamW, TrainState


def fsdp_spec(shape, world_size: int) -> int | None:
    """The dimension to shard: the largest that `world_size` divides (the
    last of equal ones, as JAX's max over (size, index)), or None."""
    candidates = [(d, i) for i, d in enumerate(shape) if d % world_size == 0]
    if not shape or not candidates:
        return None
    return max(candidates)[1]


@dataclass
class _Leaf:
    name: str
    param: torch.nn.Parameter
    shape: torch.Size
    dim: int | None  # None: replicated


def _slice(t: torch.Tensor, dim: int, r: int, n: int) -> torch.Tensor:
    k = t.shape[dim] // n
    return t.detach().narrow(dim, r * k, k).contiguous()


def _rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """(n, numel / n): row r is the flattened slice r along `dim` (the
    sharded dimension moved first)."""
    return t.movedim(dim, 0).reshape(n, -1)


def _square_sum(tensors, device) -> torch.Tensor:
    """The sum of squares of every element, f32 (0 for none)."""
    if not tensors:
        return torch.zeros((), device=device)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum()


def _from_row(row: torch.Tensor, shard_shape, dim: int) -> torch.Tensor:
    """A flattened slice (as `_rows` lays it out) in the slice's shape."""
    moved = [shard_shape[dim]] + [s for i, s in enumerate(shard_shape)
                                  if i != dim]
    return row.reshape(moved).movedim(0, dim).contiguous()


class ShardedTrainState:
    """A TrainState sharded over the ranks: `opt` is an AdamW over each
    leaf's own slice (replicated leaves whole: the module's parameter
    itself), `ema` the slices' EMA.  `seconds` sums the host seconds of the
    gathers and the gradient reduces."""

    def __init__(self, state: TrainState):
        n, r = world(), rank()
        self.world, self.rank = n, r
        self.step = state.step
        self.model = state.model
        src = state.opt
        self.leaves = [_Leaf(name, p, p.shape, fsdp_spec(tuple(p.shape), n))
                       for name, p in zip(src.names, src.params)]
        own = [p if lf.dim is None else _slice(p, lf.dim, r, n)
               for lf, p in zip(self.leaves, src.params)]
        opt = AdamW(zip(src.names, own), src.schedules[False],
                    src.schedules[True], src.weight_decay, src.betas,
                    src.grad_clip, src.fix, src.eps)
        opt.count = src.count
        opt.norm_fn = self.global_norm
        with torch.no_grad():
            for i, lf in enumerate(self.leaves):
                if lf.dim is not None:
                    opt.mu[i].copy_(_slice(src.mu[i], lf.dim, r, n))
                    opt.nu[i].copy_(_slice(src.nu[i], lf.dim, r, n))
                else:
                    opt.mu[i].copy_(src.mu[i])
                    opt.nu[i].copy_(src.nu[i])
        self.opt = opt
        self.ema = None if state.ema is None else [
            e.detach().clone() if lf.dim is None
            else _slice(e, lf.dim, r, n)
            for lf, e in zip(self.leaves, state.ema)]
        # index lists of the sharded leaves, cut where their own slices
        # pass BUCKET_BYTES / world (a bucket's full tensors: BUCKET_BYTES)
        sharded = [i for i, lf in enumerate(self.leaves) if lf.dim is not None]
        self._buckets = [[sharded[j] for j in b] for b in buckets(
            [own[i] for i in sharded], BUCKET_BYTES // n)]
        self.seconds = {"gather": 0.0, "reduce": 0.0}
        global_batch_moments(self.model)
        self.release()

    @property
    def module_params(self) -> list:
        """The module's parameters (full between `gather` and `release`,
        empty otherwise), aligned with opt.params."""
        return [lf.param for lf in self.leaves]

    @property
    def sharded(self) -> list[bool]:
        return [lf.dim is not None for lf in self.leaves]

    def _gather(self, shards) -> list:
        """Full tensors from each leaf's slices (replicated leaves as
        given)."""
        out = list(shards)
        n = self.world
        for idx in self._buckets:
            own = torch.cat([_rows(shards[i], self.leaves[i].dim, 1)[0]
                             for i in idx])
            buf = torch.empty(n * own.numel(), dtype=own.dtype,
                              device=own.device)
            if n == 1:
                buf.copy_(own)
            else:
                dist.all_gather_into_tensor(buf, own)
            buf = buf.view(n, -1)
            off = 0
            for i in idx:
                lf, k = self.leaves[i], shards[i].numel()
                moved = (lf.shape[lf.dim],) + tuple(
                    s for j, s in enumerate(lf.shape) if j != lf.dim)
                out[i] = buf[:, off: off + k].reshape(moved).movedim(
                    0, lf.dim).contiguous()
                off += k
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """The full parameters into the module (all-gathers)."""
        t0 = time.perf_counter()
        full = self._gather(self.opt.params)
        for lf, t in zip(self.leaves, full):
            if lf.dim is not None:
                lf.param.data = t
                increment_version(lf.param)  # kernel-weight caches rebuild
        self.seconds["gather"] += time.perf_counter() - t0

    def release(self) -> None:
        """Free the module's full copies of the sharded parameters."""
        for lf in self.leaves:
            if lf.dim is not None:
                lf.param.data = torch.empty(0, dtype=lf.param.dtype,
                                            device=lf.param.device)

    @torch.no_grad()
    def reduce_gradients(self, grads: list, loss: torch.Tensor):
        """Full per-rank gradients (None: zeros) -> (the mean gradient of
        each leaf's own slice, the mean loss): reduce-scatters of the
        sharded leaves, one all-reduce of the replicated leaves and the
        loss.  Entries of `grads` are dropped as their bucket is done."""
        t0 = time.perf_counter()
        n, out = self.world, [None] * len(grads)
        rep = [i for i, lf in enumerate(self.leaves)
               if lf.dim is None and grads[i] is not None]
        *got, loss = all_reduce_mean([*(grads[i] for i in rep), loss])
        for i, g in zip(rep, got):
            out[i] = g
        for idx in self._buckets:
            rows = torch.cat([_rows(
                torch.zeros(self.leaves[i].shape, device=loss.device)
                if grads[i] is None else grads[i].float(),
                self.leaves[i].dim, n) for i in idx], dim=1)
            for i in idx:
                grads[i] = None
            mine = torch.empty(rows.shape[1], dtype=rows.dtype,
                               device=rows.device)
            if n == 1:
                mine.copy_(rows[0])
            else:
                dist.reduce_scatter_tensor(mine, rows.reshape(-1))
                mine.div_(n)
            off = 0
            for i in idx:
                shard = self.opt.params[i]
                k = shard.numel()
                out[i] = _from_row(mine[off: off + k], shard.shape,
                                   self.leaves[i].dim)
                off += k
        self.seconds["reduce"] += time.perf_counter() - t0
        return out, loss

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient from the own slices (None:
        zeros): the sharded leaves' squares summed across the ranks, the
        replicated leaves' (equal on every rank) once."""
        device = self.opt.params[0].device
        sq = [_square_sum([g for g, s in zip(grads, self.sharded)
                           if s == want and g is not None], device)
              for want in (True, False)]
        if self.world > 1:
            dist.all_reduce(sq[0])
        return (sq[0] + sq[1]).sqrt()

    # -- checkpoints: full tensors in the replicated state's layout -------

    @torch.no_grad()
    def host_state(self, moments: bool = True) -> dict | None:
        """The state as a replicated TrainState's checkpoint holds it, on
        the host of rank 0 (without the Adam moments unless `moments`);
        None on the other ranks.  Collective: every rank joins the
        gathers, rank 0 alone copies to the host."""
        main = self.rank == 0

        def full(shards):
            out = self._gather(shards)
            return (dict(zip(self.opt.names, (t.cpu() for t in out)))
                    if main else None)

        params = full(self.opt.params)
        mu, nu = (full(self.opt.mu), full(self.opt.nu)) if moments else (
            None, None)
        ema = None if self.ema is None else full(self.ema)
        if not main:
            return None
        sd = {k: params.get(k, v.detach().cpu())
              for k, v in self.model.state_dict().items()}
        return {"step": self.step, "params": sd,
                "opt": {"count": self.opt.count,
                        **({"mu": mu, "nu": nu} if moments else {})},
                "ema": ema}

    @torch.no_grad()
    def load_host_state(self, ck: dict) -> None:
        """Load a checkpoint of either layout: each rank takes its slices;
        buffers go into the module."""
        n, r = self.world, self.rank
        names = set(self.opt.names)
        for k, v in self.model.state_dict().items():
            if k not in names:
                v.copy_(ck["params"][k])
        for i, lf in enumerate(self.leaves):
            for dst, full in ((self.opt.params[i], ck["params"][lf.name]),
                              (self.opt.mu[i], ck["opt"]["mu"][lf.name]),
                              (self.opt.nu[i], ck["opt"]["nu"][lf.name])):
                dst.copy_(full if lf.dim is None
                          else _slice(full, lf.dim, r, n))
            if self.ema is not None and ck["ema"] is not None:
                full = ck["ema"][lf.name]
                self.ema[i].copy_(full if lf.dim is None
                                  else _slice(full, lf.dim, r, n))
        self.opt.count = int(ck["opt"]["count"])
        self.step = int(ck["step"])

    def held_bytes(self) -> dict:
        """Bytes of parameters, moments and EMA this rank holds."""
        size = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in ts)
        return {"params": size(self.opt.params),
                "moments": size(self.opt.mu) + size(self.opt.nu),
                "ema": size(self.ema or [])}


def shard_train_state(state: TrainState) -> ShardedTrainState:
    """Shard `state` (every rank holding the same one, as after
    `parallel.mesh.replicate`) over the ranks; the module's full
    parameters are freed until the next gather."""
    return ShardedTrainState(state)
