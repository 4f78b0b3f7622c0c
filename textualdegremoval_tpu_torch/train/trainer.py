"""The training step for guided restoration.

Counterpart of textualdegremoval_tpu/train/trainer.py, which re-expresses
the reference (models/image_restoration_ref_model.py, base_model.py):

* two AdamW groups split on 'masa' in the parameter name, each with its
  own learning-rate schedule (lr and ref_lr);
* the masa group frozen for the first `param_fix_iterations` updates;
* a global-norm gradient clip of 0.01;
* an EMA of the parameters (`ema_decay <= 0`: the EMA is the parameters).

`AdamW` is the JAX package's optax chain step for step, not
`torch.optim.AdamW`:

    [mask masa while count < fix] -> clip_by_global_norm -> per group
    adamw(schedule) -> [mask masa while count < fix]

Every update advances one count that the schedules, Adam's bias
correction and the freeze all read, masa group included: during the
freeze its moments stay zero but its count keeps going, so its first
update after a 5-step freeze is 0.52212 lr, not lr (optax; a
torch.optim.AdamW with requires_grad_(False) during the freeze would
start that group at step 1).  The schedule is read at the count before
the update, from 0.  The clip is optax's: g / norm * max_norm when
norm >= max_norm (no epsilon).  The second mask zeroes the masa update,
weight decay included.

The step runs eagerly: forward, torch.autograd.grad (every block's
backward is the hand-written kernel pair on CUDA), the optimizer update
with torch._foreach ops in place, the EMA.  Parameters are updated in
place, which bumps their version counters, so every block rebuilds its
cached kernel weights at the next forward.

A network of several outputs (SFNet's three scales) is scored as the sum
of the loss over them, gt resized to each output's size by
`ops.resize.image_resize(..., 'bilinear')` (jax.image.resize's
antialiased bilinear, as JAX's step).  The step runs the network in train
mode, so SFNet's BatchNorm normalises by the batch and updates its running
statistics, as JAX's step does with `model_state={'batch_stats': ...}`;
the EMA covers the parameters only, and the eval step runs in eval mode
(the running statistics).

Under several ranks (parallel/bootstrap.py) each rank steps on its own
share of the global batch, and the step averages the gradients and the
loss over the ranks (`TrainState.reduce_gradients`, through
`parallel.mesh.all_reduce_mean`) after torch.autograd.grad and before the
norm and the update: the global-mean loss of JAX's jitted step over a
dp-sharded batch.  DistributedDataParallel cannot serve here, since it
does not support torch.autograd.grad.  With one rank the step does no
collective.  The same step runs a sharded state (parallel/fsdp.py)
through the state's own hooks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from textualdegremoval_tpu_torch.ops.resize import image_resize
from textualdegremoval_tpu_torch.parallel.bootstrap import (
    is_main_process, world,
)
from textualdegremoval_tpu_torch.parallel.mesh import all_reduce_mean


def _masa_mask(names) -> list[bool]:
    """True where the parameter belongs to the MASA matcher: its name
    contains 'masa' (the reference's substring rule), which takes in the
    encoder (masa_enc.*) and the fusion blocks (masa_blk_enc_level*)."""
    return ["masa" in n.lower() for n in names]


class AdamW:
    """The optax chain of the JAX `build_optimizer` over named parameters.

    lr_schedule / ref_lr_schedule: step -> lr for the trunk and the masa
    group; grad_clip: None for no clip."""

    def __init__(self, named_params, lr_schedule: Callable,
                 ref_lr_schedule: Callable | None = None,
                 weight_decay: float = 1e-4,
                 betas: tuple[float, float] = (0.9, 0.999),
                 grad_clip: float | None = 0.01,
                 param_fix_iterations: int = 0, eps: float = 1e-8):
        named_params = list(named_params)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.masa = _masa_mask(self.names)
        self.schedules = {False: lr_schedule,
                          True: ref_lr_schedule or lr_schedule}
        self.weight_decay = weight_decay
        self.betas = betas
        self.grad_clip = grad_clip
        self.fix = int(param_fix_iterations or 0)
        self.eps = eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # the clip's global norm of the (masked) gradients; a sharded
        # state (parallel/fsdp.py) sums its slices across the ranks
        self.norm_fn = global_norm

    def lrs(self, step: int) -> tuple[float, float]:
        """(trunk lr, masa lr) at `step`."""
        return self.schedules[False](step), self.schedules[True](step)

    @torch.no_grad()
    def step(self, grads) -> None:
        """One update from `grads` (aligned with the parameters; None reads
        as zeros, as a stop_gradient does in JAX)."""
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for p, g in zip(self.params, grads)]
        frozen = self.count < self.fix
        if frozen:
            grads = [torch.zeros_like(g) if m else g
                     for g, m in zip(grads, self.masa)]
        if self.grad_clip:
            norm = self.norm_fn(grads)
            if float(norm) >= self.grad_clip:
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, self.grad_clip)
        b1, b2 = self.betas
        t = self.count + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        for is_masa in (False, True):
            idx = [i for i, m in enumerate(self.masa) if m == is_masa]
            if not idx or (is_masa and frozen):
                continue
            params = [self.params[i] for i in idx]
            den = torch._foreach_div([self.nu[i] for i in idx], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div([self.mu[i] for i in idx], bc1)
            torch._foreach_div_(upd, den)
            if self.weight_decay:
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
            torch._foreach_add_(params, upd,
                                alpha=-self.schedules[is_masa](self.count))
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for i, n in enumerate(self.names):
            self.mu[i].copy_(sd["mu"][n])
            self.nu[i].copy_(sd["nu"][n])


class MultiSteps:
    """optax.MultiSteps(opt, k) (use_grad_mean): each call folds its
    gradients into a running mean, acc + (g - acc) / (n + 1), and every
    k-th call hands the mean to the inner optimizer and starts again, so
    the parameters change only then.  Under several ranks the mean is
    averaged over them at that boundary, once per update (as the
    reference's accelerate syncs at the end of an accumulation)."""

    def __init__(self, opt: AdamW, k: int):
        self.opt = opt
        self.k = int(k)
        self.names = opt.names
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in opt.params]

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Fold in one micro-step's gradients (aligned with the inner
        optimizer's parameters); True where the inner optimizer stepped."""
        for a, g in zip(self.acc, grads):
            a.add_((g.to(a.dtype) - a) / (self.mini_step + 1))
        emit = self.mini_step == self.k - 1
        if emit:
            self.opt.step(all_reduce_mean(self.acc) if world() > 1
                          else self.acc)
            self.acc = [torch.zeros_like(a) for a in self.acc]
        self.mini_step = (self.mini_step + 1) % self.k
        return emit


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32 (optax
    global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def build_optimizer(model: torch.nn.Module, lr_schedule, ref_lr_schedule=None,
                    weight_decay: float = 1e-4, betas=(0.9, 0.999),
                    grad_clip: float | None = 0.01,
                    param_fix_iterations: int = 0) -> AdamW:
    """AdamW over every parameter of `model` (JAX `build_optimizer`)."""
    return AdamW(model.named_parameters(), lr_schedule, ref_lr_schedule,
                 weight_decay, tuple(betas), grad_clip, param_fix_iterations)


@dataclass
class TrainState:
    """step: updates done; model: holds the f32 parameters; opt: the
    optimizer state; ema: the EMA parameters aligned with opt.params, or
    None when EMA is off (the EMA then is the parameters).

    The hooks that `make_train_step` calls (gather, release,
    reduce_gradients, global_norm) and the checkpoint's (host_state,
    load_host_state) are those of a replicated state; a sharded one
    (parallel/fsdp.py) has its own."""
    step: int
    model: torch.nn.Module
    opt: AdamW
    ema: list[torch.Tensor] | None = None

    @property
    def module_params(self) -> list:
        """The module's parameters, aligned with opt.params."""
        return self.opt.params

    def gather(self) -> None:
        """Nothing to gather: the module holds its parameters."""

    def release(self) -> None:
        """Nothing to free."""

    def reduce_gradients(self, grads: list, loss: torch.Tensor):
        """(grads, loss) averaged over the ranks in one reduce (entries
        None stay None); as given with one rank."""
        if world() == 1:
            return grads, loss
        live = [i for i, g in enumerate(grads) if g is not None]
        *got, loss = all_reduce_mean([*(grads[i] for i in live), loss])
        grads = list(grads)
        for i, g in zip(live, got):
            grads[i] = g
        return grads, loss

    def global_norm(self, grads) -> torch.Tensor:
        """The global norm of `grads` (None: zeros)."""
        return global_norm([g for g in grads if g is not None])

    def ema_state_dict(self) -> dict:
        """The EMA network as a state dict in the reference key format."""
        sd = self.model.state_dict()
        if self.ema is None:
            return sd
        by_name = dict(zip(self.opt.names, self.ema))
        return {k: by_name.get(k, v) for k, v in sd.items()}

    @torch.no_grad()
    def host_state(self, moments: bool = True) -> dict | None:
        """The state as a checkpoint holds it, on the host (without the
        Adam moments unless `moments`), on rank 0; None on the others,
        which write nothing."""
        if not is_main_process():
            return None
        cpu = lambda sd: {k: v.detach().cpu()  # noqa: E731
                          for k, v in sd.items()}
        opt = self.opt.state_dict()
        return {"step": self.step, "params": cpu(self.model.state_dict()),
                "opt": {"count": opt["count"],
                        **({"mu": cpu(opt["mu"]), "nu": cpu(opt["nu"])}
                           if moments else {})},
                "ema": (None if self.ema is None else
                        cpu(dict(zip(self.opt.names, self.ema))))}

    @torch.no_grad()
    def load_host_state(self, ck: dict) -> None:
        """Load a checkpoint (`host_state`'s layout) in place."""
        self.model.load_state_dict(ck["params"], strict=True)
        self.opt.load_state_dict(ck["opt"])
        if self.ema is not None and ck["ema"] is not None:
            for e, n in zip(self.ema, self.opt.names):
                e.copy_(ck["ema"][n])
        self.step = int(ck["step"])


def create_train_state(model, opt: AdamW, ema_decay: float = 0.0,
                       ema_params=None) -> TrainState:
    """ema_params: a pre-loaded EMA (a checkpoint's params_ema), else a copy
    of the parameters (the reference's model_ema(0)); none when
    ema_decay <= 0."""
    ema = None
    if ema_decay > 0:
        ema = [p.detach().clone() for p in opt.params]
        if ema_params is not None:
            with torch.no_grad():
                for e, n in zip(ema, opt.names):
                    e.copy_(ema_params[n])
    return TrainState(0, model, opt, ema)


def multiscale_loss(loss_fn: Callable, preds, gt: torch.Tensor):
    """loss_fn over a prediction, or summed over a list of them with gt
    resized to each one's size (JAX `make_train_step`'s compute_loss)."""
    if not isinstance(preds, (list, tuple)):
        return loss_fn(preds, gt)
    total = 0.0
    for p in preds:
        g = gt if p.shape[1] == gt.shape[1] else image_resize(
            gt, p.shape, "bilinear")
        total = total + loss_fn(p, g)
    return total


def make_train_step(loss_fn: Callable, ema_decay: float = 0.0,
                    masa_frozen: bool = False):
    """Build (state, batch) -> (state, metrics); batch holds 'lq', 'gt' and
    'ref' tensors on the model's device.  The loss is `multiscale_loss`.
    The state is a TrainState or a parallel.fsdp.ShardedTrainState: the
    step calls its hooks to gather the parameters before the forward,
    free them after the backward, average the gradients and the loss over
    the ranks and take the norm of the whole gradient.

    masa_frozen: the
    reference's freeze phase done structurally: the masa parameters get
    requires_grad_(False), so autograd prunes their backward; the
    optimizer's freeze masks them either way, and the trunk updates match
    the masking step.  metrics: l_pix (the loss) and grad_norm (the global
    norm of the raw gradients, zeros for frozen parameters), as tensors."""

    def step(state, batch):
        model, opt = state.model, state.opt
        params = state.module_params
        for p, m in zip(params, opt.masa):
            p.requires_grad_(not (masa_frozen and m))
        state.gather()
        model.train()
        loss = multiscale_loss(loss_fn, model(batch["lq"], batch["ref"]),
                               batch["gt"])
        live = [i for i, p in enumerate(params) if p.requires_grad]
        got = torch.autograd.grad(loss, [params[i] for i in live])
        state.release()
        grads = [None] * len(params)
        for i, g in zip(live, got):
            grads[i] = g
        del got
        grads, loss = state.reduce_gradients(grads, loss.detach())
        gnorm = state.global_norm(grads)
        opt.step(grads)
        if state.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(state.ema, ema_decay)
                torch._foreach_add_(state.ema, opt.params,
                                    alpha=1.0 - ema_decay)
        for p in params:
            p.requires_grad_(True)
        state.step += 1
        return state, {"l_pix": loss, "grad_norm": gnorm}

    return step


def make_eval_step(use_ema: bool = True):
    """(state, batch) -> prediction (a list for a network of several
    outputs), in eval mode, with the EMA parameters when use_ema and EMA
    is on (swapped in for the call, then swapped back)."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        model = state.model
        model.eval()
        args = (batch["lq"], batch["ref"])
        if not use_ema or state.ema is None:
            return model(*args)
        live = [p.detach().clone() for p in state.opt.params]
        torch._foreach_copy_(state.opt.params, state.ema)
        try:
            return model(*args)
        finally:
            torch._foreach_copy_(state.opt.params, live)

    return step
