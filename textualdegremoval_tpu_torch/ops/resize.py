"""Pixel (un)shuffle, padding and bilinear resizing on NHWC tensors.

Counterpart of textualdegremoval_tpu/ops/resize.py.  Channel packing is
PyTorch's (c, i, j): channel index c*r*r + i*r + j, with (i, j) the offset
inside the r x r block.
"""

import torch
import torch.nn.functional as F


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, C*r*r)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad H and W at the bottom/right to the next multiple."""
    _, h, w, _ = x.shape
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph))


def bilinear_resize_torch(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, oh, ow, C): bilinear, align_corners=False, no
    antialiasing, for up- and down-scaling alike (JAX
    `bilinear_resize_torch`, which reproduces this very call).  Runs
    F.interpolate on the channels-last NCHW view."""
    if x.shape[1:3] == (oh, ow):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
