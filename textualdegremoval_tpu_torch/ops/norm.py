"""Channel layer-norm variants on NHWC tensors (normalise the last axis).

Counterpart of textualdegremoval_tpu/ops/norm.py: f32 computation whatever
the input dtype, and the one-pass E[x^2] - E[x]^2 moments with a max(., 0)
clamp (not torch's two-pass `var`), so the port rounds where the JAX
package does.
"""

import torch


def _moments(xf: torch.Tensor):
    mu = xf.mean(dim=-1, keepdim=True)
    sq = (xf * xf).mean(dim=-1, keepdim=True)
    return mu, torch.clamp_min(sq - mu * mu, 0.0)


def bias_free_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """x / sqrt(var(x) + eps) * weight; the mean enters only the variance."""
    xf = x.float()
    _, var = _moments(xf)
    y = xf / torch.sqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def with_bias_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu, var = _moments(xf)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """NAFNet's LayerNorm2d: plain LN over the channel axis, eps 1e-6."""
    return with_bias_layer_norm(x, weight, bias, eps=eps)
