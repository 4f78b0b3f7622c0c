"""YAML option parsing, preserving the reference config surface.

Counterpart of textualdegremoval_tpu/utils/options.py (reference
utils/utils_options.py:31-89): dataset phase tagging, the experiment
directory layout derived from `name` (experiments/<name>/models,
training_states, visualization, log), and any name containing 'debug'
rewiring the val/log/save frequencies to 8 iterations.  PyYAML is imported
inside `parse`, and a `.json` file (JSON is YAML too) is read without it:
machines that only run the model may lack it.
"""

from __future__ import annotations

import os
import os.path as osp


def parse(opt_path: str, is_train: bool = True,
          root: str | None = None) -> dict:
    with open(opt_path) as f:
        if opt_path.endswith(".json"):
            import json

            opt = json.load(f)
        else:
            import yaml

            opt = yaml.safe_load(f)
    opt["is_train"] = is_train

    scale = opt.get("scale", 1)
    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = scale

    root = root or os.getcwd()
    name = opt.get("name", "exp")
    opt.setdefault("path", {})
    if is_train:
        exp_root = osp.join(root, "experiments", name)
        opt["path"].update({
            "experiments_root": exp_root,
            "models": osp.join(exp_root, "models"),
            "training_states": osp.join(exp_root, "training_states"),
            "log": exp_root,
            "visualization": osp.join(exp_root, "visualization"),
        })
        if "debug" in name:
            if "val" in opt:
                opt["val"]["val_freq"] = 8
            if "logger" in opt:
                opt["logger"]["print_freq"] = 1
                opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(root, "results", name)
        opt["path"].update({
            "results_root": results_root,
            "log": results_root,
            "visualization": osp.join(results_root, "visualization"),
        })
    return opt


def dict2str(opt: dict, indent: int = 1) -> str:
    """The options as indented `key: value` lines, nested dicts two spaces
    deeper (JAX `dict2str`, the training log's header)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent * 2) + f"{k}:\n" + dict2str(v, indent + 1)
        else:
            msg += " " * (indent * 2) + f"{k}: {v}\n"
    return msg
