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
"""

from __future__ import annotations

import os
import os.path as osp
import re

import torch

from textualdegremoval_tpu_torch.train.trainer import TrainState


def _save(obj, path: str) -> None:
    """Write through a temporary file, so that a cut run leaves no torn
    checkpoint for auto-resume to pick up."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


class CheckpointManager:
    def __init__(self, states_dir: str, models_dir: str | None = None):
        self.directory = osp.abspath(states_dir)
        self.models_dir = osp.abspath(models_dir or states_dir)
        os.makedirs(self.directory, exist_ok=True)
        os.makedirs(self.models_dir, exist_ok=True)

    def save_state(self, state: TrainState, step: int) -> str:
        path = osp.join(self.directory, f"state_{step}.pth")
        opt = state.opt.state_dict()
        _save({
            "step": state.step,
            "params": _cpu(state.model.state_dict()),
            "opt": {"count": opt["count"], "mu": _cpu(opt["mu"]),
                    "nu": _cpu(opt["nu"])},
            "ema": (None if state.ema is None else
                    _cpu(dict(zip(state.opt.names, state.ema)))),
        }, path)
        return path

    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for f in os.listdir(self.directory)
                 if (m := re.fullmatch(r"state_(\d+)\.pth", f))]
        return max(steps) if steps else None

    @torch.no_grad()
    def restore_state(self, state: TrainState) -> TrainState | None:
        """Load the latest state into `state` in place; None when there is
        none."""
        step = self.latest_step()
        if step is None:
            return None
        ck = torch.load(osp.join(self.directory, f"state_{step}.pth"),
                        map_location="cpu", weights_only=True)
        state.model.load_state_dict(ck["params"], strict=True)
        state.opt.load_state_dict(ck["opt"])
        if state.ema is not None and ck["ema"] is not None:
            for e, n in zip(state.ema, state.opt.names):
                e.copy_(ck["ema"][n])
        state.step = int(ck["step"])
        return state

    def save_network(self, state: TrainState, step: int) -> str:
        """net_g_<iter>.pth: {'params': ..., 'params_ema': ...}."""
        path = osp.join(self.models_dir, f"net_g_{step}.pth")
        _save({"params": _cpu(state.model.state_dict()),
               "params_ema": _cpu(state.ema_state_dict())}, path)
        return path
