"""Restoration losses on NHWC tensors.

Counterpart of textualdegremoval_tpu/losses/losses.py (reference
losses/losses.py:11-122): L1, MSE, PSNR (with the BT.601 `toY` path) and
Charbonnier, and `build_loss` for the YAML `pixel_opt: {type, loss_weight,
reduction}` surface.  A bf16 prediction meets an f32 target and the loss is
computed in f32, as under JAX's type promotion.
"""

from __future__ import annotations

import functools
import math

import torch

# BT.601 RGB -> Y coefficients (reference PSNRLoss toY path, losses.py:94)
_Y_COEF = (65.481, 128.553, 24.966)


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def l1_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    loss = (pred - target).abs()
    if weight is not None:
        loss = loss * weight
    return loss_weight * _reduce(loss, reduction)


def mse_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    loss = (pred - target).square()
    if weight is not None:
        loss = loss * weight
    return loss_weight * _reduce(loss, reduction)


def psnr_loss(pred, target, loss_weight=1.0, to_y=False, reduction="mean"):
    """10/ln(10) * mean_b[log(mse_b + 1e-8)]; minimising it maximises PSNR.
    pred, target in [0, 1], NHWC."""
    if reduction != "mean":
        raise ValueError("psnr_loss supports reduction='mean' only")
    if to_y:
        coef = torch.tensor(_Y_COEF, dtype=pred.dtype, device=pred.device)
        pred = (pred * coef).sum(-1, keepdim=True) + 16.0
        target = (target * coef.to(target.dtype)).sum(-1, keepdim=True) + 16.0
        pred, target = pred / 255.0, target / 255.0
    scale = 10.0 / math.log(10.0)
    per_img = torch.log((pred - target).square().mean(dim=(1, 2, 3)) + 1e-8)
    return loss_weight * scale * per_img.mean()


def charbonnier_loss(pred, target, loss_weight=1.0, eps=1e-3,
                     reduction="mean"):
    diff = pred - target
    return loss_weight * torch.sqrt(diff * diff + eps * eps).mean()


_LOSSES = {
    "L1Loss": l1_loss,
    "MSELoss": mse_loss,
    "PSNRLoss": psnr_loss,
    "CharbonnierLoss": charbonnier_loss,
}


def build_loss(opt: dict):
    """Resolve a reference-style loss config dict into a callable."""
    opt = dict(opt)
    name = opt.pop("type")
    if name == "PSNRLoss" and "toY" in opt:
        opt["to_y"] = opt.pop("toY")
    return functools.partial(_LOSSES[name], **opt)
