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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 (torch's bicubic takes -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


_KERNELS = {"bilinear": _triangle, "linear": _triangle,
            "bicubic": _keys_cubic, "cubic": _keys_cubic}


def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis, as jax.image.resize's
    `compute_weight_mat` makes them: half-pixel centres, the kernel widened
    by in/out on a downscale (antialiasing), each column renormalised over
    the inputs that exist, zero where the sample lies outside the input."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=f32, device=device)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv \
        - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[
        :, None]).abs() / torch.clamp_min(inv, 1.0)
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """jax.image.resize(x, shape, method) for method bilinear or bicubic
    (JAX's antialiased scale-and-translate): each axis whose size changes
    is one product with a weight matrix, the others are left alone.  Not
    F.interpolate: that samples a = -0.75 bicubic and does not widen its
    kernel on a downscale."""
    kernel = _KERNELS[method]
    if len(shape) != x.ndim:
        raise ValueError(f"image_resize: shape {tuple(shape)} for a "
                         f"{x.ndim}-d input")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
