"""Optical-flow warping (counterpart of textualdegremoval_tpu/ops/flow.py;
reference models/archs/nafnet_arch_utils.py:125-190 flow_warp /
resize_flow).

`flow_warp` gathers the four corners itself, as JAX does, rather than
calling F.grid_sample: grid_sample's normalise / unnormalise round trip
moves a coordinate by an ulp, and it divides by zero at a side of 1.
"""

from __future__ import annotations

import torch

from textualdegremoval_tpu_torch.ops.resize import image_resize


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = "bilinear",
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp an NHWC image by a per-pixel flow (B, H, W, 2) in (x, y) order,
    as grid_sample(align_corners=True) on grid + flow: bilinear, or
    nearest rounding half to even.  padding_mode 'zeros' reads zeros
    outside the image; any other mode clamps to its border."""
    b, h, w, _ = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    vx = gx[None] + flow[..., 0]
    vy = gy[None] + flow[..., 1]
    batch = torch.arange(b, device=x.device)[:, None, None]

    def g(yi, xi):
        """x at the (integer-valued) coordinates, zero or clamped outside."""
        v = x[batch, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        if padding_mode == "zeros":
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = v * valid[..., None].to(v.dtype)
        return v

    if interp_mode == "nearest":
        return g(torch.round(vy), torch.round(vx))
    y0 = torch.floor(vy)
    x0 = torch.floor(vx)
    wy = (vy - y0)[..., None]
    wx = (vx - x0)[..., None]
    return ((1 - wy) * (1 - wx) * g(y0, x0)
            + (1 - wy) * wx * g(y0, x0 + 1)
            + wy * (1 - wx) * g(y0 + 1, x0)
            + wy * wx * g(y0 + 1, x0 + 1))


def resize_flow(flow: torch.Tensor, size_type: str, sizes,
                interp_mode: str = "bilinear") -> torch.Tensor:
    """Resize a (B, H, W, 2) flow field to a ratio ('ratio': sizes (rh, rw))
    or a shape ('shape': sizes (H', W')) and scale its values to match,
    with jax.image.resize's semantics (`image_resize`)."""
    b, h, w, _ = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    else:  # 'shape'
        out_h, out_w = sizes
    scaled = flow * torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                                 device=flow.device)
    return image_resize(scaled, (b, out_h, out_w, 2), interp_mode)
