"""MDTA transposed (channel) attention on NHWC tensors.

Counterpart of textualdegremoval_tpu/ops/attention.py `mdta_attention_nhwc`:
per-head C x C gram of q and k over all pixels, L2 norms as
rsqrt(max(sum of squares, 1e-24)), f32 gram and f32 softmax, and the
attention-value product in the input dtype.  The statistics are the plain
version of the MDTA statistics kernel (ops/pallas/mdta.py
`mdta_stats_ref`), the product its `apply_attention`.
"""

import torch

from textualdegremoval_tpu_torch.ops.pallas.mdta import (
    apply_attention, mdta_stats_ref,
)


def mdta_attention_nhwc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        temperature: torch.Tensor, heads: int) -> torch.Tensor:
    """q, k, v: (B, H, W, C); temperature: (heads, 1, 1).  Returns (B, H, W, C)."""
    return apply_attention(mdta_stats_ref(q, k, temperature, heads), v)
