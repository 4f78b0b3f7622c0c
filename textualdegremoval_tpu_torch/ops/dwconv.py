"""Depthwise KxK convolution, stride 1, zero padding, on NHWC tensors.

Counterpart of the forward of textualdegremoval_tpu/ops/dwconv.py.  The
JAX package's shift-form and custom-vjp variants work around XLA lowering
and have no role under PyTorch; the forward is `F.conv2d(groups=C)` on a
channels_last view.
"""

import torch
import torch.nn.functional as F


def dwconv(x: torch.Tensor, kernel: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """x: (N, H, W, C); kernel: (K, K, 1, C) HWIO, the JAX package's layout.
    Returns (N, H, W, C) in x.dtype."""
    c = x.shape[-1]
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)  # -> (C, 1, K, K)
    y = F.conv2d(x.permute(0, 3, 1, 2), w,
                 None if bias is None else bias.to(x.dtype),
                 padding=kernel.shape[0] // 2, groups=c)
    return y.permute(0, 2, 3, 1)
