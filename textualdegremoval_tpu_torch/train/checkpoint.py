"""Checkpoints and auto-resume.

Counterpart of textualdegremoval_tpu/train/checkpoint.py (reference
base_model.py:213-351, train CLI :137-186), with torch.save files in place
of Orbax directories:

* `net_g_<iter>.pth` under the experiment's models/ directory: the network
  as `{'params': state_dict, 'params_ema': state_dict}` in the reference
  key format, so `convert.load_reference_checkpoint` loads it with
  strict=True (and the reference can too);
* `state_<iter>.pth` under training_states/: step, parameters, optimizer
  state (count and both moments) and EMA;
* auto-resume: the highest-numbered state.

Under several ranks every rank calls `save_state` and `save_network`:
the state's `host_state` makes the host copy on rank 0 only (a sharded
state's ranks all join its gathers first), rank 0 writes and a barrier
follows; `restore_state` waits at a barrier, then every rank reads the
same latest file into the state's `load_host_state` (the caller then
`parallel.mesh.replicate`s a replicated state).  A sharded state
(parallel/fsdp.py) is written in the replicated layout, so a checkpoint
does not depend on the world size.
"""

from __future__ import annotations

import os
import os.path as osp
import re

import torch

from textualdegremoval_tpu_torch.parallel.bootstrap import (
    barrier, is_main_process,
)


def _save(obj, path: str) -> None:
    """Write through a temporary file, so that a cut run leaves no torn
    checkpoint for auto-resume to pick up."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, states_dir: str, models_dir: str | None = None):
        self.directory = osp.abspath(states_dir)
        self.models_dir = osp.abspath(models_dir or states_dir)
        os.makedirs(self.directory, exist_ok=True)
        os.makedirs(self.models_dir, exist_ok=True)

    def save_state(self, state, step: int) -> str:
        """state_<step>.pth of a TrainState or a ShardedTrainState; called
        by every rank."""
        path = osp.join(self.directory, f"state_{step}.pth")
        _write(state.host_state(), path)
        return path

    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for f in os.listdir(self.directory)
                 if (m := re.fullmatch(r"state_(\d+)\.pth", f))]
        return max(steps) if steps else None

    @torch.no_grad()
    def restore_state(self, state):
        """Load the latest state into `state` in place; None when there is
        none.  Every rank reads the same file, after a barrier."""
        barrier()
        step = self.latest_step()
        if step is None:
            return None
        ck = torch.load(osp.join(self.directory, f"state_{step}.pth"),
                        map_location="cpu", weights_only=True)
        state.load_host_state(ck)
        return state

    def save_network(self, state, step: int) -> str:
        """net_g_<iter>.pth: {'params': ..., 'params_ema': ...}; called by
        every rank."""
        path = osp.join(self.models_dir, f"net_g_{step}.pth")
        host = state.host_state(moments=False)
        if host is not None:
            ema = host["ema"] or {}
            host = {"params": host["params"],
                    "params_ema": {k: ema.get(k, v)
                                   for k, v in host["params"].items()}}
        _write(host, path)
        return path


def _write(obj, path: str) -> None:
    """Rank 0 writes `obj` (None on the other ranks); every rank waits
    for it."""
    if is_main_process():
        _save(obj, path)
    barrier()
