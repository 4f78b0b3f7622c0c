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

Pipeline A's towers (text, vision, UNet, VAE, both mappers) have their own
key tables here (the JAX package's are in convert/tower_maps.py, which
imports flax): `load_jax_tower_params` loads a JAX tower tree, the inverse
of tower_maps' `convert_*`; `load_reference_tower` loads the reference's
own formats (HF CLIP, diffusers UNet and VAE, the per-word mapper
artifact) with `strict=True`, and `load_reference_towers` a directory of
them; `save_trained_towers` writes what a training stage trained (the I2T
artifact with the UNet's global K/V, or the clean mapper) in those
formats.
"""

from __future__ import annotations

import os
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


def _load_tree(model: torch.nn.Module, params: Mapping[str, Any],
               locate) -> torch.nn.Module:
    """Load a JAX parameter tree into `model` with strict key matching,
    keeping the dtypes of `model`'s tensors.  locate(key, tensor) gives the
    JAX path of a state-dict entry and the function that turns its JAX
    array into the port's layout.  Raises on a missing, surplus or
    mis-shaped leaf."""
    sd = {}
    used = set()
    for key, t in model.state_dict().items():
        path, to_port = locate(key, t)
        node = params
        for seg in path:
            if not isinstance(node, Mapping) or seg not in node:
                raise KeyError(f"no JAX leaf for {key} "
                               f"(-> {'/'.join(path)})")
            node = node[seg]
        arr = to_port(np.asarray(node))
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


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, Any]) -> torch.nn.Module:
    """Load a JAX parameter tree of a restoration network
    (`jax.tree.map(np.asarray, variables['params'])`) into `model`."""

    def locate(key, t):
        path = torch_key_to_jax_path(key, t.ndim)
        if path[-1] in ("beta", "gamma") and t.ndim == 4:
            return path, lambda a: a.transpose(0, 3, 1, 2)  # (1,1,1,C)
        if t.ndim == 4:
            return path, lambda a: a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return path, lambda a: a

    return _load_tree(model, params, locate)


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


# ---------------------------------------------------------------------------
# Pipeline A towers
# ---------------------------------------------------------------------------

# port (reference) state-dict key -> JAX path, as dotted rewrites; a final
# `weight` then becomes `kernel` (2-D and 4-D) or `scale` (1-D norms)
_TOWER_RULES = {
    "text_encoder": [
        (r"^text_model\.", ""),
        (r"^embeddings\.token_embedding\.weight$",
         "token_embedding.embedding"),
        (r"^embeddings\.position_embedding\.weight$", "position_embedding"),
        (r"^encoder\.layers\.(\d+)\.", r"layers_\1."),
    ],
    "image_encoder": [
        (r"^vision_model\.", ""),
        (r"^embeddings\.patch_embedding\.", "patch_embedding."),
        (r"^embeddings\.class_embedding$", "class_embedding"),
        (r"^embeddings\.position_embedding\.weight$", "position_embedding"),
        (r"^encoder\.layers\.(\d+)\.", r"layers_\1."),
    ],
    "unet": [
        (r"^time_embedding\.linear_(\d)\.", r"time_emb_\1."),
        (r"^(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.", r"\1_\2_resnet_\3."),
        (r"^(down|up)_blocks\.(\d+)\.attentions\.(\d+)\.", r"\1_\2_attn_\3."),
        (r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
         r"down_\1_downsample."),
        (r"^up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r"up_\1_upsample."),
        (r"^mid_block\.resnets\.(\d)\.", r"mid_resnet_\1."),
        (r"^mid_block\.attentions\.0\.", "mid_attn."),
        (r"\.transformer_blocks\.0\.", ".blocks_0."),
        (r"\.to_out\.0\.", ".to_out."),
        (r"\.ff\.net\.0\.proj\.", ".ff_geglu.proj."),
        (r"\.ff\.net\.2\.", ".ff_out."),
    ],
    "vae": [
        (r"^quant_conv\.", "encoder.quant_conv."),
        (r"^post_quant_conv\.", "decoder.post_quant_conv."),
        (r"\.(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.", r".\1_\2_resnet_\3."),
        (r"\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
         r".down_\1_downsample."),
        (r"\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r".up_\1_upsample."),
        (r"\.mid_block\.resnets\.(\d)\.", r".mid_resnet_\1."),
        (r"\.mid_block\.attentions\.0\.", ".mid_attn."),
        (r"\.to_out\.0\.", ".to_out."),
    ],
    # the stacked WordMLPs keys are the JAX names
    "mapper": [],
    "clean_mapper": [],
}


def _tower(tower: str) -> str:
    if tower not in _TOWER_RULES:
        raise KeyError(f"unknown tower {tower!r}; one of "
                       f"{sorted(_TOWER_RULES)}")
    return tower


def tower_key_to_jax_path(key: str, ndim: int, tower: str) -> tuple:
    """A tower's state-dict key (and its tensor's rank) -> JAX path."""
    for pat, rep in _TOWER_RULES[_tower(tower)]:
        key = re.sub(pat, rep, key)
    path = key.split(".")
    if path[-1] == "weight":
        path[-1] = "kernel" if ndim >= 2 else "scale"
    return tuple(path)


def load_jax_tower_params(module: torch.nn.Module, params: Mapping[str, Any],
                          tower: str) -> torch.nn.Module:
    """Load the JAX parameter tree of a pipeline A tower (text_encoder,
    image_encoder, unet, vae, mapper or clean_mapper) into
    the port's module: the inverse of tower_maps' convert_clip_text,
    convert_clip_vision, convert_unet, convert_vae and convert_mapper.
    Raises on a missing, surplus or mis-shaped leaf."""
    tower = _tower(tower)

    def locate(key, t):
        path = tower_key_to_jax_path(key, t.ndim, tower)
        if path[-1] == "kernel" and t.ndim == 4:
            return path, lambda a: a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if path[-1] == "kernel" and t.ndim == 2:
            return path, lambda a: a.T  # (in, out) -> (out, in)
        return path, lambda a: a

    return _load_tree(module, params, locate)


# the reference mapper's per-word Sequential: index -> (stacked name, linear)
_MAPPER_SEQ = {0: ("linear0", True), 1: ("ln0", False), 3: ("linear1", True),
               4: ("ln1", False), 6: ("linear2", True), 7: ("ln2", False),
               9: ("linear3", True)}
_GLOBAL_KV = re.compile(r"(.+)_to_([kv])\.weight$")


def _fold_mapper(sd: Mapping[str, torch.Tensor], branches) -> dict:
    """Reference per-word `mapping_{i}.{0,1,3,4,6,7,9}` keys -> the stacked
    WordMLPs keys.  The global K/V keys of the I2T artifact are skipped;
    any other key raises."""
    out, used = {}, set()
    for branch in branches:
        nw = 0
        while f"{branch}_{nw}.0.weight" in sd:
            nw += 1
        if nw == 0:
            raise KeyError(f"no {branch}_<i>.* keys in the mapper state dict")
        for seq, (name, is_linear) in _MAPPER_SEQ.items():
            for leaf in ("weight", "bias"):
                keys = [f"{branch}_{i}.{seq}.{leaf}" for i in range(nw)]
                vals = [torch.as_tensor(sd[k]) for k in keys]
                if is_linear and leaf == "weight":
                    dst, vals = f"{name}_kernel", [v.T for v in vals]
                elif is_linear:
                    dst = f"{name}_bias"
                else:
                    dst = f"{name}_{leaf}"
                out[f"{branch}.{dst}"] = torch.stack(vals)
                used.update(keys)
    surplus = [k for k in sd if k not in used and not _GLOBAL_KV.match(k)]
    if surplus:
        raise KeyError(f"mapper keys with no port parameter: {surplus[:5]}")
    return out


def mapper_reference_state_dict(module: torch.nn.Module) -> dict:
    """The reference's per-word state dict of a port I2TMapper or
    CleanMapper (the inverse of the fold)."""
    out = {}
    for branch in ("mapping", "mapping_patch"):
        mlps = getattr(module, branch, None)
        if mlps is None:
            continue
        for seq, (name, is_linear) in _MAPPER_SEQ.items():
            w = getattr(mlps, f"{name}_kernel" if is_linear
                        else f"{name}_weight").detach()
            b = getattr(mlps, f"{name}_bias").detach()
            for i in range(mlps.num_words):
                out[f"{branch}_{i}.{seq}.weight"] = w[i].T if is_linear \
                    else w[i]
                out[f"{branch}_{i}.{seq}.bias"] = b[i]
    return out


def save_trained_towers(mods, stage: str, directory: str) -> str:
    """Write what a pipeline A training stage trains, in the reference
    format that `load_reference_towers` reads, as a bare float32 state
    dict: `<directory>/mapper.pt` for 'i2t' (the mapper's per-word keys
    plus each UNet attn2's global K/V as `<attn2 path>_to_k.weight` /
    `_to_v.weight`), `<directory>/clean_mapper.pt` for 'tr'.  Copied into
    a towers directory it replaces the stage's trained part for the
    generation CLI.  Returns the path."""
    name = "clean_mapper" if stage == "tr" else "mapper"
    sd = mapper_reference_state_dict(getattr(mods, name))
    if stage != "tr":
        for key, v in mods.unet.state_dict().items():
            m = re.match(r"(.+)\.to_([kv])_global\.weight$", key)
            if m:
                sd[f"{m.group(1)}_to_{m.group(2)}.weight"] = v
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name + ".pt")
    torch.save({k: v.float().cpu().clone() for k, v in sd.items()}, path)
    return path


def reference_tower_state_dict(module: torch.nn.Module,
                               sd: Mapping[str, torch.Tensor], tower: str,
                               global_kv: Mapping[str, torch.Tensor] | None
                               = None) -> dict:
    """A reference-format state dict of one tower -> the port module's keys.

    text_encoder / image_encoder: HF CLIPTextModel / CLIPVisionModel keys,
    with or without the `text_model.` / `vision_model.` prefix; the vision
    tower's post_layernorm and projection (after the hidden states the
    tower returns) and `position_ids` buffers are dropped.  vae: diffusers
    keys, the mid-block attention under either naming.  unet: diffusers
    keys; each attn2's to_k_global / to_v_global come from `global_kv` (the
    I2T mapper artifact's `<attn2 path>_to_k.weight` keys) where it has
    them, else as copies of to_k / to_v (the reference's clone at wiring).
    mapper / clean_mapper: the reference's per-word keys, folded."""
    tower = _tower(tower)
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()
          if not k.endswith("position_ids")}
    if tower in ("text_encoder", "image_encoder"):
        prefix = "text_model." if tower == "text_encoder" else \
            "vision_model."
        sd = {(k if k.startswith(prefix) else prefix + k): v
              for k, v in sd.items()
              if not re.match(r"^(vision_model\.)?(post_layernorm|"
                              r"visual_projection)\.", k)}
    elif tower == "vae":
        names = {"query": "to_q", "key": "to_k", "value": "to_v",
                 "proj_attn": "to_out.0"}
        sd = {re.sub(r"(\.attentions\.0\.)(query|key|value|proj_attn)\.",
                     lambda m: m.group(1) + names[m.group(2)] + ".", k): v
              for k, v in sd.items()}
    elif tower == "unet":
        extra = {}
        for k, v in (global_kv or {}).items():
            m = _GLOBAL_KV.match(k)
            if m:
                extra[f"{m.group(1)}.to_{m.group(2)}_global.weight"] = v
        sd = dict(sd)
        for key in module.state_dict():
            if key.endswith(("to_k_global.weight", "to_v_global.weight")):
                sd[key] = extra.pop(key) if key in extra else \
                    sd[key.replace("_global", "")].clone()
        if extra:
            raise KeyError(f"global K/V for layers the UNet does not have: "
                           f"{sorted(extra)[:3]}")
    else:
        sd = _fold_mapper(sd, ("mapping", "mapping_patch")
                          if tower == "mapper" else ("mapping",))
    return sd


def load_reference_tower(module: torch.nn.Module,
                         sd: Mapping[str, torch.Tensor], tower: str,
                         global_kv: Mapping[str, torch.Tensor] | None = None
                         ) -> torch.nn.Module:
    """Load a reference-format state dict into a tower with strict key
    matching (`reference_tower_state_dict` says which formats)."""
    module.load_state_dict(
        reference_tower_state_dict(module, sd, tower, global_kv), strict=True)
    return module


def load_reference_towers(mods, directory: str):
    """Load `<directory>/<tower>.pt` for every tower of a GuidanceModules:
    text_encoder, image_encoder, unet, vae, mapper (the I2T artifact, which
    may carry the UNet's global K/V) and clean_mapper.  Each file holds a
    bare state dict."""

    def read(name):
        return torch.load(os.path.join(directory, name + ".pt"),
                          map_location="cpu", weights_only=True)

    towers = mods.towers()
    mapper_sd = read("mapper")
    for name, module in towers.items():
        sd = mapper_sd if name == "mapper" else read(name)
        load_reference_tower(module, sd, name,
                             mapper_sd if name == "unet" else None)
    return mods
