"""Weights carried across between the JAX package and the port.

The port's state-dict keys are the reference's torch keys, so a reference
checkpoint (`{'params': state_dict}`) loads into a port model with
`strict=True` (`load_reference_checkpoint`), and the JAX package's own
`convert_state_dict` maps a port `state_dict()` onto a JAX parameter tree.

`load_jax_params` goes the other way: it takes the JAX package's parameter
tree as nested dicts of numpy arrays and loads it into a port model.  The
key rewrite is textualdegremoval_tpu/convert/torch_to_jax.py's, restricted
to the keys of the ported modules (`norm*.body.` flattening, the
Down/Upsample `body.0` conv, NAFNet's `sca.1.` -> `sca.conv.` and
`ups.N.0.` -> `ups_N`, the merge of sequential indices into the preceding
name), 4-D conv weights move between HWIO and OIHW, and NAFNet's beta and
gamma between (1,1,1,C) and (1,C,1,1).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_REWRITES = [
    (re.compile(r"^module\."), ""),
    (re.compile(r"\.body\.0\.(weight|bias)$"), r".conv.\1"),  # Down/Upsample
    (re.compile(r"(norm\d?)\.body\."), r"\1."),  # Restormer LN wrapper
    (re.compile(r"\.sca\.1\."), ".sca.conv."),  # NAFNet SCA sequential
    (re.compile(r"(^|\.)ups\.(\d+)\.0\."), r"\1ups.\2."),  # NAFNet up conv
]


def torch_key_to_jax_path(key: str, ndim: int) -> tuple[str, ...]:
    """Reference torch key (and its tensor's rank) -> JAX parameter path."""
    for pat, rep in _REWRITES:
        key = pat.sub(rep, key)
    path: list[str] = []
    for seg in key.split("."):
        if seg.isdigit() and path:
            path[-1] = f"{path[-1]}_{seg}"
        else:
            path.append(seg)
    if path[-1] == "weight" and ndim == 4:
        path[-1] = "kernel"
    return tuple(path)


def _flat_paths(tree: Mapping[str, Any], prefix=()) -> set[tuple[str, ...]]:
    out = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _flat_paths(v, prefix + (k,))
        else:
            out.add(prefix + (k,))
    return out


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, Any]) -> torch.nn.Module:
    """Load a JAX parameter tree (`jax.tree.map(np.asarray,
    variables['params'])`) into `model` with strict key matching, keeping
    the dtypes of `model`'s tensors.  Raises on a missing, surplus or
    mis-shaped leaf."""
    sd = {}
    used = set()
    for key, t in model.state_dict().items():
        path = torch_key_to_jax_path(key, t.ndim)
        node = params
        for seg in path:
            if not isinstance(node, Mapping) or seg not in node:
                raise KeyError(f"no JAX leaf for {key} "
                               f"(-> {'/'.join(path)})")
            node = node[seg]
        arr = np.asarray(node)
        if path[-1] in ("beta", "gamma") and t.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)  # (1,1,1,C) -> (1,C,1,1)
        elif t.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if arr.shape != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: JAX {arr.shape} vs "
                             f"port {tuple(t.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype)
        used.add(path)
    unused = _flat_paths(params) - used
    if unused:
        raise KeyError("JAX leaves with no port parameter: " + ", ".join(
            sorted("/".join(p) for p in unused)))
    model.load_state_dict(sd, strict=True)
    return model


def load_reference_checkpoint(model: torch.nn.Module, path: str,
                              key: str = "params") -> torch.nn.Module:
    """Load a reference `.pth` (`{'params': state_dict}`, an optional
    `module.` prefix, or a bare state dict) with strict key matching."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    sd = {re.sub(r"^module\.", "", k): v for k, v in ckpt.items()}
    model.load_state_dict(sd, strict=True)
    return model
