"""The training flows by model type (reference models/__init__.py:22-43,
JAX train/model_registry.py): `create_model(opt)` resolves
opt['model_type'] to a runner of its training CLI.

RefGuidedImageCleanModel runs cli.train_restoration, and
DiffIRRefGuidedImageCleanModel cli.train_diffir.  A runner writes the
options to a temporary JSON file (JSON is YAML, and `utils.options.parse`
reads it without PyYAML) and calls the CLI's `main` on it:
`run(max_iters=None, device=None)`, the CLI's own default device when
`device` is None.
"""

from __future__ import annotations

import json
import os
import tempfile

_MODEL_TYPES = {}


def register_model(name: str):
    def deco(fn):
        _MODEL_TYPES[name] = fn
        return fn
    return deco


def create_model(opt: dict):
    """The runner of opt['model_type']'s training flow."""
    name = opt["model_type"]
    if name not in _MODEL_TYPES:
        raise KeyError(
            f"unknown model_type {name}; available: {sorted(_MODEL_TYPES)}")
    return _MODEL_TYPES[name](opt)


def _runner(opt: dict, main):
    def run(max_iters: int | None = None, device: str | None = None):
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(opt, f)
            path = f.name
        try:
            args = ["--opt", path]
            if max_iters:
                args += ["--max_iters", str(max_iters)]
            if device is not None:
                args += ["--device", device]
            return main(args)
        finally:
            os.unlink(path)

    return run


@register_model("RefGuidedImageCleanModel")
def _ref_guided(opt):
    from textualdegremoval_tpu_torch.cli import train_restoration

    return _runner(opt, train_restoration.main)


@register_model("DiffIRRefGuidedImageCleanModel")
def _diffir(opt):
    from textualdegremoval_tpu_torch.cli import train_diffir

    return _runner(opt, train_diffir.main)
