"""NAFNetDynamicFusion, the DiffIR-style text-conditioned NAFNet, as torch
modules on NHWC tensors.

Counterpart of textualdegremoval_tpu/models/nafnet_dynamic.py (reference
models/archs/network_nafnet_guided_diffir_arch.py: SimpleGate_DynamicFusion
:244-273, NAFBlock_DynamicFusion :336-421, NAFNetDynamicFusion :441-543).
A (B, num_words, 1024) pseudo-word embedding is flattened and mapped by a
bias-free Linear to per-channel (scale, shift) pairs, applied at block
entry and inside both simple gates.  Module names are the reference's
(`kernel.0`, `sg1.kernel.0`, `sg2.kernel.0`, the `layers` level of each
stage, `ups.i.0`), so a reference checkpoint loads with `strict=True`.

`num_words` is a constructor argument (default 10, what the reference's
shipped `Linear(10 * 1024, ...)` takes).  JAX's Dense infers its input
width from the embedding at init; a torch Linear cannot, so an embedding
of another word count raises, naming both counts, and is never reshaped
to fit (the reference fed 20 words to a 10-word Linear, SURVEY §2.5.10).

No kernel of the port serves this network: its blocks are not the
NAFBlock of `nafblock_fused` (they have the three affine modulations),
so every op is plain torch, the convs through `layers.conv_form`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models.layers import (
    SCA, LayerNorm2d, conv_form,
)
from textualdegremoval_tpu_torch.ops import pad_to_multiple, pixel_shuffle

EMBED_DIM = 1024  # the width of a pseudo-word (SD 2.1's text width)


def _flat_embedding(k_v: torch.Tensor, num_words: int) -> torch.Tensor:
    """(B, num_words, 1024) -> (B, num_words * 1024); raises where the
    embedding's shape is not the one the affine heads take."""
    if k_v.ndim != 3 or tuple(k_v.shape[1:]) != (num_words, EMBED_DIM):
        raise ValueError(
            f"the embedding is {tuple(k_v.shape)}, and this network's affine "
            f"heads take (B, {num_words}, {EMBED_DIM}) (num_words "
            f"{num_words}): build it with num_words={k_v.shape[1]}"
            if k_v.ndim == 3 else
            f"the embedding must be (B, num_words, {EMBED_DIM}), got "
            f"{tuple(k_v.shape)}")
    return k_v.reshape(k_v.shape[0], -1)


def _affine(head: nn.Sequential, flat: torch.Tensor, dtype: torch.dtype):
    """(scale, shift), each (B, 1, 1, dim), from a Sequential(Linear) head:
    the first half of its output is the scale (JAX's jnp.split, the
    reference's chunk(2, dim=1))."""
    out = F.linear(flat.to(dtype), head[0].weight.to(dtype))
    return out[:, None, None].chunk(2, dim=-1)


class _KVAffine(nn.Module):
    """A simple gate's conditioning head (the reference's
    SimpleGate_DynamicFusion): Linear(num_words * 1024 -> 2 * dim, no bias)
    as `kernel.0`."""

    def __init__(self, dim: int, num_words: int):
        super().__init__()
        self.kernel = nn.Sequential(
            nn.Linear(num_words * EMBED_DIM, 2 * dim, bias=False))


class NAFBlockDynamicFusion(nn.Module):
    """x * k1 + k2 at entry, then NAFNet's block with each simple gate's
    input modulated by its own (scale, shift) before the halves multiply:

        y = inp + conv3(SCA(gate(sg1(dw(conv1(LN1(inp * k1 + k2))))))) * beta
        out = y + conv5(gate(sg2(conv4(LN2(y))))) * gamma
    """

    def __init__(self, c: int, num_words: int = 10, dw_expand: int = 2,
                 ffn_expand: int = 2):
        super().__init__()
        dw = c * dw_expand
        self.num_words = num_words
        self.kernel = nn.Sequential(
            nn.Linear(num_words * EMBED_DIM, 2 * c, bias=False))
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = SCA(dw // 2)
        self.sg1 = _KVAffine(dw, num_words)
        self.sg2 = _KVAffine(ffn_expand * c, num_words)
        self.conv4 = nn.Conv2d(c, ffn_expand * c, 1)
        self.conv5 = nn.Conv2d(ffn_expand * c // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, inp: torch.Tensor, k_v: torch.Tensor) -> torch.Tensor:
        """inp: (B, H, W, C); k_v: (B, num_words, 1024)."""
        flat = _flat_embedding(k_v, self.num_words)
        dt = inp.dtype
        k1, k2 = _affine(self.kernel, flat, dt)
        x = conv_form(self.conv2, conv_form(self.conv1,
                                            self.norm1(inp * k1 + k2)))
        g1, g2 = _affine(self.sg1.kernel, flat, dt)
        x1, x2 = (x * g1 + g2).chunk(2, dim=-1)
        x = conv_form(self.conv3, self.sca(x1 * x2))
        y = inp + x * self.beta.permute(0, 2, 3, 1).to(dt)
        x = conv_form(self.conv4, self.norm2(y))
        g1, g2 = _affine(self.sg2.kernel, flat, dt)
        x1, x2 = (x * g1 + g2).chunk(2, dim=-1)
        x = conv_form(self.conv5, x1 * x2)
        return y + x * self.gamma.permute(0, 2, 3, 1).to(dt)


class _DynamicLayer(nn.Module):
    """The reference's DynamicBasicLayer: a stage's blocks as `layers`,
    each called with the embedding."""

    def __init__(self, c: int, n: int, num_words: int):
        super().__init__()
        self.layers = nn.ModuleList(
            NAFBlockDynamicFusion(c, num_words) for _ in range(n))

    def forward(self, x, k_v):
        for blk in self.layers:
            x = blk(x, k_v)
        return x


class NAFNetDynamicFusion(nn.Module):
    """NAFNet U-Net whose every block is conditioned on the embedding.
    `dtype` is the compute dtype: the input and the embedding are cast to
    it, every weight at use; the parameters stay float32."""

    def __init__(self, img_channel: int = 3, width: int = 64,
                 middle_blk_num: int = 1,
                 enc_blk_nums: Sequence[int] = (1, 1, 1, 28),
                 dec_blk_nums: Sequence[int] = (1, 1, 1, 1),
                 num_words: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_words = num_words
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)
        self.encoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        self.decoders = nn.ModuleList()
        self.ups = nn.ModuleList()
        chan = width
        for n in enc_blk_nums:
            self.encoders.append(_DynamicLayer(chan, n, num_words))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = _DynamicLayer(chan, middle_blk_num, num_words)
        for n in dec_blk_nums:
            self.ups.append(nn.Sequential(
                nn.Conv2d(chan, chan * 2, 1, bias=False)))
            chan //= 2
            self.decoders.append(_DynamicLayer(chan, n, num_words))

    def forward(self, inp: torch.Tensor, k_v: torch.Tensor) -> torch.Tensor:
        """inp: (B, H, W, C); k_v: (B, num_words, 1024).  Returns
        (B, H, W, C); H and W are padded to a multiple of 2 ** levels and
        the output cropped back."""
        _, h0, w0, _ = inp.shape
        x_in = pad_to_multiple(inp.to(self.dtype), 2 ** len(self.encoders))
        k_v = k_v.to(self.dtype)
        x = conv_form(self.intro, x_in)
        encs = []
        for enc, down in zip(self.encoders, self.downs):
            x = enc(x, k_v)
            encs.append(x)
            x = conv_form(down, x)
        x = self.middle_blks(x, k_v)
        for up, dec, skip in zip(self.ups, self.decoders, encs[::-1]):
            x = dec(pixel_shuffle(conv_form(up[0], x), 2) + skip, k_v)
        x = conv_form(self.ending, x) + x_in
        return x[:, :h0, :w0]
