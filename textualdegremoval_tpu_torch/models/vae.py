"""Stable Diffusion AutoencoderKL (VAE).

Counterpart of textualdegremoval_tpu/models/vae.py (SD 2.x: blocks 128/
256/512/512, 2 layers per block, 4 latent channels, GroupNorm(32, eps
1e-6), silu).  Public methods take and return NHWC tensors; inside,
activations are NCHW.  Parameter names are diffusers' (the mid-block
attention as to_q/to_k/to_v/to_out.0; the older query/key/value/proj_attn
names are renamed by `convert.load_reference_tower`).  The encoder is
ported with the decoder so that a diffusers VAE state dict loads whole.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models._compute import (
    conv, gn, group_norm, linear,
)

SCALING_FACTOR = 0.18215


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = gn(in_ch, 1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = gn(out_ch, 1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = conv(F.silu(group_norm(x, self.norm1)), self.conv1)
        h = conv(F.silu(group_norm(h, self.norm2)), self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = conv(x, self.conv_shortcut)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over H*W (the VAE mid block), in the
    compute dtype throughout, as the JAX module computes it."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = gn(ch, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = group_norm(x, self.group_norm).permute(0, 2, 3, 1).reshape(
            b, h * w, c)
        q, k, v = linear(y, self.to_q), linear(y, self.to_k), \
            linear(y, self.to_v)
        # sqrt(c) in float32, then rounded to the compute dtype (JAX)
        den = torch.tensor(math.sqrt(c), dtype=torch.float32,
                           device=q.device).to(q.dtype)
        attn = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k) / den, dim=-1)
        out = linear(torch.einsum("bqk,bkc->bqc", attn, v), self.to_out[0])
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _mid(ch: int) -> nn.Module:
    m = nn.Module()
    m.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
    m.attentions = nn.ModuleList([AttnBlock(ch)])
    return m


def _mid_forward(m: nn.Module, x):
    return m.resnets[1](m.attentions[0](m.resnets[0](x)))


def _sampler(conv_mod: nn.Conv2d) -> nn.ModuleList:
    m = nn.Module()
    m.conv = conv_mod
    return nn.ModuleList([m])


class VAEEncoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        ch = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for bi, c in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                ResnetBlock(cin if li == 0 else c, c)
                for li in range(layers_per_block))
            if bi < len(ch) - 1:
                blk.downsamplers = _sampler(nn.Conv2d(c, c, 3, stride=2))
            self.down_blocks.append(blk)
            cin = c
        self.mid_block = _mid(ch[-1])
        self.conv_norm_out = gn(ch[-1], 1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        """NCHW image -> NCHW moments before quant_conv."""
        x = conv(x, self.conv_in)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                # asymmetric (0, 1) pad, like diffusers Downsample2D
                x = conv(F.pad(x, (0, 1, 0, 1)), blk.downsamplers[0].conv)
        x = _mid_forward(self.mid_block, x)
        return conv(F.silu(group_norm(x, self.conv_norm_out)), self.conv_out)


class VAEDecoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        ch = tuple(block_out_channels)
        rev = list(reversed(ch))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0])
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for bi, c in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                ResnetBlock(cin if li == 0 else c, c)
                for li in range(layers_per_block + 1))
            if bi < len(rev) - 1:
                blk.upsamplers = _sampler(nn.Conv2d(c, c, 3, padding=1))
            self.up_blocks.append(blk)
            cin = c
        self.conv_norm_out = gn(rev[-1], 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        """NCHW latents after post_quant_conv -> NCHW image."""
        x = _mid_forward(self.mid_block, conv(z, self.conv_in))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = conv(x, blk.upsamplers[0].conv)
        return conv(F.silu(group_norm(x, self.conv_norm_out)), self.conv_out)


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = VAEEncoder(block_out_channels, layers_per_block,
                                  latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                    1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.decoder = VAEDecoder(block_out_channels, layers_per_block,
                                  latent_channels)

    def encode_moments(self, x):
        """(B, H, W, 3) -> (mean, logvar), each (B, H/8, W/8, 4); logvar
        clipped to [-30, 20]."""
        m = conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)),
                 self.quant_conv).permute(0, 2, 3, 1)
        mean, logvar = m.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_sample(self, x, generator: torch.Generator | None = None):
        mean, logvar = self.encode_moments(x)
        std = torch.exp(0.5 * logvar)
        return mean + std * torch.randn(mean.shape, generator=generator,
                                        device=mean.device, dtype=mean.dtype)

    def decode(self, z):
        """(B, h, w, 4) latents -> (B, 8h, 8w, 3)."""
        z = conv(z.to(self.dtype).permute(0, 3, 1, 2), self.post_quant_conv)
        return self.decoder(z).permute(0, 2, 3, 1)
