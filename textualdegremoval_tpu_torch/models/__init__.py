"""Network registry of the port.

`define_network(opt)` mirrors textualdegremoval_tpu/models/__init__.py:
`opt['type']` selects the class and the remaining keys that name
constructor arguments become its arguments, so the reference's network_g
option dicts port as they are (with the routing keys of the Restormer and
PromptIR trunks: `chain`, the cross-block chain; `fused`, false for the
module path, as in JAX; and on that path `gdfn_fused` and `mdta_pallas`,
its GDFN and MDTA kernels).  This port covers the Restormer, NAFNet,
PromptIR, DRSformer and SFNet families and the DiffIR net
NAFNetDynamicFusion.
"""

from __future__ import annotations

import inspect

import torch

from textualdegremoval_tpu_torch.models.drsformer import (
    DRSformer, DRSformerRefFusion,
)
from textualdegremoval_tpu_torch.models.nafnet import NAFNet, NAFNetRefFusion
from textualdegremoval_tpu_torch.models.nafnet_dynamic import (
    NAFNetDynamicFusion,
)
from textualdegremoval_tpu_torch.models.promptir import (
    PromptIR, PromptIRRefFusion,
)
from textualdegremoval_tpu_torch.models.restormer import (
    Restormer, RestormerRefFusion,
)
from textualdegremoval_tpu_torch.models.sfnet import SFNet, SFNetRefFusion

_REGISTRY = {"Restormer": Restormer, "RestormerRefFusion": RestormerRefFusion,
             "NAFNet": NAFNet, "NAFNetRefFusion": NAFNetRefFusion,
             "PromptIR": PromptIR, "PromptIRRefFusion": PromptIRRefFusion,
             "DRSformer": DRSformer, "DRSformerRefFusion": DRSformerRefFusion,
             # the reference's 200L/SPA file: DRSformer without the MEFCs
             "DRSformer200L_SPA_RefFusion": DRSformerRefFusion,
             "SFNet": SFNet, "SFNetRefFusion": SFNetRefFusion,
             "NAFNetDynamicFusion": NAFNetDynamicFusion,
             # the reference's Local (TLC) variants: the same modules with
             # tlc_train_size taken from the option dict's train_size;
             # NAFNetLocalDynamic is NAFNetDynamicFusion itself, which has
             # no TLC pooling (as in JAX)
             "NAFNetLocal": NAFNet, "NAFNetLocal_RefFusion": NAFNetRefFusion,
             "NAFNetLocalDynamic": NAFNetDynamicFusion}

# The families whose blocks are TransformerBlocks, and so take the routing
# keys `chain`, `fused`, `gdfn_fused` and `mdta_pallas`.
TBLOCK_NETWORKS = ("Restormer", "RestormerRefFusion", "PromptIR",
                   "PromptIRRefFusion")

_KEY_ALIASES = {"LayerNorm_type": "ln_type"}


def register_network(cls, name: str | None = None):
    """Register a network class under `name` (default its class name) for
    `define_network`'s `type`; returns the class, so it serves as a
    decorator (JAX `register_network`)."""
    _REGISTRY[name or cls.__name__] = cls
    return cls


def network_names() -> list[str]:
    return sorted(_REGISTRY)


def define_network(opt: dict,
                   dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """Instantiate a network from a reference-style network_g dict, in eval
    mode, with float32 parameters and `dtype` as its compute dtype (JAX
    `define_network(opt, dtype)`); `bwd_mode` and the routing keys may come
    with the dict, and NAFNetDynamicFusion's `num_words`."""
    opt = dict(opt)
    name = opt.pop("type")
    if name not in _REGISTRY:
        raise KeyError(f"unknown network type {name!r}")
    cls = _REGISTRY[name]
    params = inspect.signature(cls.__init__).parameters
    kwargs = {}
    for k, v in opt.items():
        k = _KEY_ALIASES.get(k, k)
        if k in params:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    kwargs["dtype"] = dtype
    if name.startswith("NAFNetLocal") and "tlc_train_size" in params:
        ts = opt.get("train_size", (1, 3, 256, 256))
        kwargs.setdefault("tlc_train_size", (ts[-2], ts[-1]))
    return cls(**kwargs).eval()
