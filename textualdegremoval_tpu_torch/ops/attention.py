"""Transposed (channel) attention: MDTA on NHWC tensors and DRSformer's
top-k sparse TKSA.

Counterpart of textualdegremoval_tpu/ops/attention.py `mdta_attention_nhwc`:
per-head C x C gram of q and k over all pixels, L2 norms as
rsqrt(max(sum of squares, 1e-24)), f32 gram and f32 softmax, and the
attention-value product in the input dtype.  The statistics are the plain
version of the MDTA statistics kernel (ops/pallas/mdta.py
`mdta_stats_ref`), the product its `apply_attention`.  And of its
`tksa_attention`, which no kernel serves (plain torch in both packages).
"""

import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.ops.pallas.mdta import (
    apply_attention, mdta_finish_ref, mdta_stats_ref, mdta_sums_ref,
)


def mdta_attention_nhwc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        temperature: torch.Tensor, heads: int, rows=None,
                        reduce=None) -> torch.Tensor:
    """q, k, v: (B, H, W, C); temperature: (heads, 1, 1).  Returns (B, H, W, C).

    A slab of a row-sharded image passes rows = (lo, hi), its own rows
    (the statistics leave its halo out), and reduce(gram, qssq, kssq),
    which sums the statistics over the ranks in place before the finish
    (parallel.spatial.reduce_stats)."""
    if rows is None and reduce is None:
        return apply_attention(mdta_stats_ref(q, k, temperature, heads), v)
    sums = mdta_sums_ref(q, k, heads, rows)
    if reduce is not None:
        reduce(*sums)
    return apply_attention(mdta_finish_ref(*sums, temperature, heads), v)


def tksa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   temperature: torch.Tensor,
                   blend: torch.Tensor) -> torch.Tensor:
    """Top-k sparse channel attention with 4 sparsity levels (JAX
    `tksa_attention`).

    q, k, v: (B, heads, c, L); temperature: broadcastable per-head scale;
    blend: (4,), the reference's attn1..attn4.  q and k are L2-normalised
    along L in float32 (F.normalize, eps 1e-12); the float32 gram times
    the temperature keeps, for each level k_i of int(c/2), int(c*2/3),
    int(c*3/4), int(c*4/5), the entries at or above the row's k_i-th
    largest (ties kept, as in JAX; the reference scatters exactly k_i).
    The four float32 softmaxes are blended first, then one product with v
    in the input dtype.  Returns (B, heads, c, L)."""
    dt = q.dtype
    qf = F.normalize(q.float(), dim=-1, eps=1e-12)
    kf = F.normalize(k.float(), dim=-1, eps=1e-12)
    attn = torch.matmul(qf, kf.transpose(-2, -1)) * temperature.float()
    c = attn.shape[-1]
    ks = [int(c / 2), int(c * 2 / 3), int(c * 3 / 4), int(c * 4 / 5)]
    top_vals = torch.topk(attn, max(ks), dim=-1).values  # sorted, largest
    neg_inf = attn.new_tensor(float("-inf"))
    blended = torch.zeros_like(attn)
    for i, kk in enumerate(ks):
        masked = torch.where(attn >= top_vals[..., kk - 1: kk], attn, neg_inf)
        blended = blended + blend[i].float() * torch.softmax(masked, dim=-1)
    return torch.matmul(blended.to(dt), v)
