"""Plain GDFN (gated-dconv FFN) and exact-erf GELU.

Counterpart of `gdfn_ref` and `_gelu_exact` in
textualdegremoval_tpu/ops/pallas/gdfn.py.  The fused GDFN kernel itself is
not on this port's path; the whole-block kernel (ops/pallas/tblock.py)
carries its own GDFN.
"""

import math

import torch

from textualdegremoval_tpu_torch.ops.dwconv import dwconv


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """x * Phi(x) with the exact erf (jax.nn.gelu(approximate=False))."""
    return x * 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def gdfn_ref(x, w1, dwk, w2):
    """x: (B, H, W, C); w1: (C, 2h); dwk: (3, 3, 2h); w2: (h, C)."""
    hidden = w1.shape[1] // 2
    y = x @ w1.to(x.dtype)
    y = dwconv(y, dwk[:, :, None, :])
    g = gelu_exact(y[..., :hidden]) * y[..., hidden:]
    return g @ w2.to(x.dtype)
