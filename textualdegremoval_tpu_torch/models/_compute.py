"""Mixed-precision building blocks of the diffusion towers.

The JAX towers keep float32 parameters and compute in their `dtype`
(flax's `param_dtype=float32, dtype=...`): a dense or conv layer casts its
input, kernel and bias to the compute dtype, and a LayerNorm or GroupNorm
takes its statistics in float32 and returns the compute dtype.  These
helpers do the same for torch modules that hold float32 weights: the
compute dtype is that of the activations, which each tower casts its
inputs to.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, mod: nn.Linear) -> torch.Tensor:
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), bias)


def conv(x: torch.Tensor, mod: nn.Conv2d) -> torch.Tensor:
    """NCHW conv with the module's weight and bias cast to x's dtype."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.conv2d(x, mod.weight.to(x.dtype), bias, mod.stride, mod.padding)


def layer_norm(x: torch.Tensor, mod: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight,
                        mod.bias, mod.eps).to(x.dtype)


def group_norm(x: torch.Tensor, mod: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm of an NCHW tensor, statistics in float32."""
    return F.group_norm(x.float(), mod.num_groups, mod.weight, mod.bias,
                        mod.eps).to(x.dtype)


def gn(ch: int, eps: float, groups: int = 32) -> nn.GroupNorm:
    """GroupNorm over ch channels with gcd(groups, ch) groups: real SD widths
    are multiples of 32; tiny test widths fall back to the gcd (JAX `_gn`)."""
    return nn.GroupNorm(math.gcd(groups, ch), ch, eps=eps)
