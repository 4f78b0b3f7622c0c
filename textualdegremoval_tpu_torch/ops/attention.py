"""MDTA transposed (channel) attention on NHWC tensors.

Counterpart of textualdegremoval_tpu/ops/attention.py `mdta_attention_nhwc`:
per-head C x C gram of q and k over all pixels, L2 norms as
rsqrt(max(sum of squares, 1e-24)), f32 gram and f32 softmax, and the
attention-value product in the input dtype.
"""

import torch


def mdta_attention_nhwc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        temperature: torch.Tensor, heads: int) -> torch.Tensor:
    """q, k, v: (B, H, W, C); temperature: (heads, 1, 1).  Returns (B, H, W, C)."""
    b, h, w, c = q.shape
    cph = c // heads
    dt = q.dtype
    qh = q.reshape(b, h * w, heads, cph).float()
    kh = k.reshape(b, h * w, heads, cph).float()
    vh = v.reshape(b, h * w, heads, cph)
    qn = torch.rsqrt(torch.clamp_min((qh * qh).sum(dim=1, keepdim=True), 1e-24))
    kn = torch.rsqrt(torch.clamp_min((kh * kh).sum(dim=1, keepdim=True), 1e-24))
    attn = torch.einsum("bnhc,bnhd->bhcd", qh, kh)
    attn = attn * (qn.permute(0, 2, 3, 1) * kn.permute(0, 2, 1, 3))
    attn = torch.softmax(attn * temperature.float(), dim=-1)
    out = torch.einsum("bhcd,bnhd->bnhc", attn.to(dt), vh)
    return out.reshape(b, h, w, c)
