"""Tiled whole-image inference with overlap blending (counterpart of
textualdegremoval_tpu/utils/tiled.py).

For test images too large for one forward pass: split the LQ into
overlapping tiles, run the network per tile, and blend with linear ramps
in the overlap bands, at the memory of one tile plus the blend's two
float32 images.  The blend runs on the LQ's device.

Unlike JAX's, an image with one side no longer than the tile and the
other longer is tiled too: on that side one tile covers the whole length,
its weight ramp cut to it (JAX's blend weight stays tile x tile there and
fails to broadcast).  Where both sides exceed the tile the result is
JAX's.
"""

from __future__ import annotations

import numpy as np
import torch


def _ramp_weights(tile: int, overlap: int) -> np.ndarray:
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1]
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def _starts(n: int, tile: int, stride: int) -> list:
    """Tile origins along one side of length n (one tile at 0 when n <=
    tile), the last one flush with the far edge."""
    starts = list(range(0, max(n - tile, 0) + 1, stride))
    if starts[-1] + tile < n:
        starts.append(n - tile)
    return starts


def _last(out):
    return out[-1] if isinstance(out, (list, tuple)) else out


def infer_tiled(fwd, lq: torch.Tensor, ref=None, tile: int = 512,
                overlap: int = 64) -> np.ndarray:
    """fwd: (lq_tile[, ref]) -> pred tile of the same H and W (or a list
    of outputs, the last taken).  lq: (1, H, W, C) tensor.  ref (optional)
    goes whole to every tile (the MASA search sees the full reference
    whichever LQ tile is restored).  Returns the (1, H, W, C) float32
    numpy prediction."""
    _, h, w, c = lq.shape
    if h <= tile and w <= tile:
        out = _last(fwd(lq, ref) if ref is not None else fwd(lq))
        return out.float().cpu().numpy()

    stride = tile - overlap
    th, tw = min(h, tile), min(w, tile)
    ramp = torch.from_numpy(_ramp_weights(tile, overlap)).to(lq.device)
    w2d = (ramp[:th, None] * ramp[None, :tw])[..., None]
    acc = torch.zeros((h, w, c), dtype=torch.float32, device=lq.device)
    norm = torch.zeros((h, w, 1), dtype=torch.float32, device=lq.device)
    for y in _starts(h, tile, stride):
        for x in _starts(w, tile, stride):
            tile_lq = lq[:, y:y + th, x:x + tw].contiguous()
            out = _last(fwd(tile_lq, ref) if ref is not None
                        else fwd(tile_lq))
            acc[y:y + th, x:x + tw] += out[0].float() * w2d
            norm[y:y + th, x:x + tw] += w2d
    return (acc / torch.clamp_min(norm, 1e-8))[None].cpu().numpy()
