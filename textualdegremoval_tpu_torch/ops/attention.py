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


def tksa_sums(q: torch.Tensor, k: torch.Tensor):
    """TKSA's statistics of q and k (B, heads, c, L): the float32 gram of
    the raw q and k and their float32 square sums, (B, heads, c, c),
    (B, heads, c, 1), (B, heads, c, 1): sums over L, which the ranks of a
    row-sharded image add up."""
    qf, kf = q.float(), k.float()
    return (torch.matmul(qf, kf.transpose(-2, -1)),
            qf.square().sum(-1, keepdim=True),
            kf.square().sum(-1, keepdim=True))


def tksa_finish(gram, qssq, kssq, temperature) -> torch.Tensor:
    """The scaled cosine gram from `tksa_sums`: each side divided by
    max(norm, 1e-12) as F.normalize divides, times the temperature."""
    qn = qssq.sqrt().clamp_min(1e-12)
    kn = kssq.sqrt().clamp_min(1e-12)
    return gram / (qn * kn.transpose(-2, -1)) * temperature.float()


def tksa_masks(attn: torch.Tensor) -> list:
    """The four top-k masks of a float32 (.., c, c) gram: for k_i of
    int(c/2), int(c*2/3), int(c*3/4), int(c*4/5), the entries at or above
    their row's k_i-th largest (ties kept, as in JAX; the reference
    scatters exactly k_i)."""
    c = attn.shape[-1]
    ks = [int(c / 2), int(c * 2 / 3), int(c * 3 / 4), int(c * 4 / 5)]
    top_vals = torch.topk(attn, max(ks), dim=-1).values  # sorted, largest
    return [attn >= top_vals[..., kk - 1: kk] for kk in ks]


def tksa_blend(attn: torch.Tensor, blend: torch.Tensor,
               masks=None) -> torch.Tensor:
    """The four float32 softmaxes of attn under its masks (`tksa_masks`
    unless given), blended by blend (4,)."""
    masks = tksa_masks(attn) if masks is None else masks
    neg_inf = attn.new_tensor(float("-inf"))
    blended = torch.zeros_like(attn)
    for i, mask in enumerate(masks):
        masked = torch.where(mask, attn, neg_inf)
        blended = blended + blend[i].float() * torch.softmax(masked, dim=-1)
    return blended


def tksa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   temperature: torch.Tensor, blend: torch.Tensor,
                   own=None, reduce=None) -> torch.Tensor:
    """Top-k sparse channel attention with 4 sparsity levels (JAX
    `tksa_attention`).

    q, k, v: (B, heads, c, L); temperature: broadcastable per-head scale;
    blend: (4,), the reference's attn1..attn4.  q and k are L2-normalised
    along L in float32 (F.normalize, eps 1e-12); the float32 gram times
    the temperature is masked at four sparsity levels (`tksa_masks`).  The
    four float32 softmaxes are blended first, then one product with v in
    the input dtype.  Returns (B, heads, c, L).

    A slab of a row-sharded image passes own = (q, k) at its own pixels
    and reduce(gram, qssq, kssq), which sums the raw statistics over the
    ranks in place (parallel.spatial.reduce_stats); the normalisation,
    the masks and the softmaxes then run on the summed gram, the same on
    every rank, and only the product with v on the slab's pixels."""
    dt = q.dtype
    if own is None:
        qf = F.normalize(q.float(), dim=-1, eps=1e-12)
        kf = F.normalize(k.float(), dim=-1, eps=1e-12)
        attn = torch.matmul(qf, kf.transpose(-2, -1)) * temperature.float()
    else:
        sums = tksa_sums(*own)
        reduce(*sums)
        attn = tksa_finish(*sums, temperature)
    return torch.matmul(tksa_blend(attn, blend).to(dt), v)
