"""SD 2.1 UNet (UNet2DConditionModel) with the reference's global K/V
cross-attention projections.

Counterpart of textualdegremoval_tpu/models/unet.py (blocks 320/640/1280/
1280, 2 layers per block, head_dim 64, context 1024, linear transformer
projections).  Every attn2 owns `to_k_global` / `to_v_global`, used when
conditioning on injected pseudo-word states (`use_global_kv=True`).

The public forward takes and returns NHWC latents, as the JAX module does;
inside, activations are NCHW for the convolutions.  Parameter names are
diffusers' (plus the two global projections), so a diffusers state dict
loads through `convert.load_reference_tower`.

Self-attention goes through `ops.flash_attn.self_attention`.
`attn_impl=None` or `'flash'` sends the shapes that pass `flash_applies`
(the 64 x 64 latent of a 512 px image: five per forward) to the CUDA flash
kernel on a CUDA tensor (a CPU tensor takes the plain version inside the
wrapper); `'plain'` sends every attention to `attention_ref`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models._compute import (
    conv, gn, group_norm, layer_norm, linear,
)
from textualdegremoval_tpu_torch.ops.flash_attn import self_attention

ATTN_IMPLS = (None, "flash", "plain")


def _check_attn_impl(attn_impl):
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    return attn_impl


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """diffusers Timesteps embedding: half sin / half cos, flipped to
    (cos, sin); float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int):
        super().__init__()
        self.norm1 = gn(in_ch, 1e-5)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = gn(out_ch, 1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb):
        h = conv(F.silu(group_norm(x, self.norm1)), self.conv1)
        h = h + linear(F.silu(temb), self.time_emb_proj)[:, :, None, None]
        h = conv(F.silu(group_norm(h, self.norm2)), self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = conv(x, self.conv_shortcut)
        return x + h


class CrossAttention(nn.Module):
    """Attention with optional global K/V projections for injected context.
    context_dim None: self-attention."""

    def __init__(self, dim: int, context_dim: int | None = None,
                 head_dim: int = 64, with_global_kv: bool = False,
                 attn_impl: str | None = None):
        super().__init__()
        self.head_dim = head_dim
        self.with_global_kv = with_global_kv
        self.use_flash = _check_attn_impl(attn_impl) != "plain"
        cdim = dim if context_dim is None else context_dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(cdim, dim, bias=False)
        self.to_v = nn.Linear(cdim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        if with_global_kv:
            self.to_k_global = nn.Linear(cdim, dim, bias=False)
            self.to_v_global = nn.Linear(cdim, dim, bias=False)

    def forward(self, x, context=None, use_global_kv: bool = False):
        b, n, d = x.shape
        heads = d // self.head_dim
        ctx = x if context is None else context
        q = linear(x, self.to_q)
        if use_global_kv and self.with_global_kv:
            k, v = linear(ctx, self.to_k_global), linear(ctx, self.to_v_global)
        else:
            k, v = linear(ctx, self.to_k), linear(ctx, self.to_v)
        out = self_attention(q.view(b, n, heads, self.head_dim),
                             k.view(b, -1, heads, self.head_dim),
                             v.view(b, -1, heads, self.head_dim),
                             use_flash=self.use_flash)
        return linear(out.reshape(b, n, d), self.to_out[0])


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, hidden * 2)

    def forward(self, x):
        a, g = linear(x, self.proj).chunk(2, dim=-1)
        return a * F.gelu(g)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int = 1024, head_dim: int = 64,
                 attn_impl: str | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, None, head_dim, False, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, head_dim, True,
                                    attn_impl)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                     nn.Linear(dim * 4, dim)])

    def forward(self, x, context, use_global_kv: bool = False):
        x = x + self.attn1(layer_norm(x, self.norm1))
        x = x + self.attn2(layer_norm(x, self.norm2), context, use_global_kv)
        y = self.ff.net[0](layer_norm(x, self.norm3))
        return x + linear(y, self.ff.net[2])


class Transformer2D(nn.Module):
    def __init__(self, dim: int, context_dim: int = 1024, head_dim: int = 64,
                 attn_impl: str | None = None):
        super().__init__()
        self.norm = gn(dim, 1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            dim, context_dim, head_dim, attn_impl)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, context, use_global_kv: bool = False):
        b, c, h, w = x.shape
        y = group_norm(x, self.norm).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = linear(y, self.proj_in)
        for blk in self.transformer_blocks:
            y = blk(y, context, use_global_kv)
        y = linear(y, self.proj_out)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def _sampler(conv_mod: nn.Conv2d) -> nn.Module:
    m = nn.Module()
    m.conv = conv_mod
    return m


class UNet2DCondition(nn.Module):
    """SD 2.x UNet; forward(latents NHWC, timesteps (B,), context (B, S, D),
    use_global_kv) -> NHWC, in the UNet's dtype."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, context_dim: int = 1024,
                 head_dim: int = 64, dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None):
        super().__init__()
        _check_attn_impl(attn_impl)
        ch = tuple(block_out_channels)
        self.in_channels = in_channels
        self.dtype = dtype
        temb_dim = ch[0] * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch[0], temb_dim)
        self.time_embedding.linear_2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)

        def tr(c):
            return Transformer2D(c, context_dim, head_dim, attn_impl)

        # down blocks: cross-attention at every level but the last
        self.down_blocks = nn.ModuleList()
        skip_chs = [ch[0]]
        cin = ch[0]
        for bi, c in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                ResnetBlock(cin if li == 0 else c, c, temb_dim)
                for li in range(layers_per_block))
            if bi < len(ch) - 1:
                blk.attentions = nn.ModuleList(
                    tr(c) for _ in range(layers_per_block))
                blk.downsamplers = nn.ModuleList([_sampler(
                    nn.Conv2d(c, c, 3, stride=2, padding=1))])
            skip_chs += [c] * (layers_per_block + (bi < len(ch) - 1))
            self.down_blocks.append(blk)
            cin = c

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            ResnetBlock(ch[-1], ch[-1], temb_dim) for _ in range(2))
        self.mid_block.attentions = nn.ModuleList([tr(ch[-1])])

        # up blocks (reversed widths): cross-attention at every level but
        # the first; each resnet takes one skip
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        cin = rev[0]
        for bi, c in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(layers_per_block + 1):
                blk.resnets.append(ResnetBlock(cin + skip_chs.pop(), c,
                                               temb_dim))
                cin = c
            if bi > 0:
                blk.attentions = nn.ModuleList(
                    tr(c) for _ in range(layers_per_block + 1))
            if bi < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([_sampler(
                    nn.Conv2d(c, c, 3, padding=1))])
            self.up_blocks.append(blk)

        self.conv_norm_out = gn(ch[0], 1e-5)
        self.conv_out = nn.Conv2d(ch[0], out_channels, 3, padding=1)

    def forward(self, x, t, context, use_global_kv: bool = False):
        dt = self.dtype
        context = context.to(dt)
        te = self.time_embedding
        temb = timestep_embedding(t, te.linear_1.in_features).to(dt)
        temb = linear(F.silu(linear(temb, te.linear_1)), te.linear_2)

        x = conv(x.to(dt).permute(0, 3, 1, 2), self.conv_in)
        skips = [x]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for li, res in enumerate(blk.resnets):
                x = res(x, temb)
                if attns is not None:
                    x = attns[li](x, context, use_global_kv)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = conv(x, blk.downsamplers[0].conv)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x, context, use_global_kv)
        x = mid.resnets[1](x, temb)

        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for li, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if attns is not None:
                    x = attns[li](x, context, use_global_kv)
            if hasattr(blk, "upsamplers"):
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = conv(x, blk.upsamplers[0].conv)

        x = F.silu(group_norm(x, self.conv_norm_out))
        return conv(x, self.conv_out).permute(0, 2, 3, 1)
