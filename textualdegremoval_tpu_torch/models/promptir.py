"""PromptIR and PromptIRRefFusion as torch modules (NHWC in and out).

Counterpart of textualdegremoval_tpu/models/promptir.py.  The trunk is
Restormer's (its stages are TBlockStages: the whole-block kernel per
block, or with `chain` the cross-block chain) plus three decoder prompt
stages: a PromptGenBlock, a TransformerBlock over the features and the
prompt concatenated (`noise_level{3,2,1}`, C = 8d + 320, 4d + 128,
2d + 64 with heads[2] heads) and a 1x1 reduction.  The prompt dims and
sizes (320/128/64 at 16/32/64) are the reference's hardcoded values,
shape-consistent with its own layout only at dim=48; they are kept
verbatim, as in the JAX package, so that checkpoints convert.  Module and
parameter names are the reference's torch names (tests/torch_oracles.py
OPromptGen, OPromptIR).  `dtype` is the compute dtype, and `fused`,
`gdfn_fused` and `mdta_pallas` pick every block's route, as in
models/restormer.py.

PromptIRRefFusion's forward also runs on one rank's slab of an image split
by rows over torch.distributed ranks (`shard`, a parallel.spatial.RowShard;
the evaluate CLI's --spatial_shard), as RestormerRefFusion's does; each
PromptGenBlock's mean is then its slab's float32 sums summed over the
ranks over the whole image's pixels, and its prompt is resized to the
whole image's height before the slab's rows are cut from it.  It needs the
whole-block route (fused=True, chain=False).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models.layers import (
    Downsample,
    MASAEncoder,
    OverlapPatchEmbed,
    TBlockStage,
    TransformerBlock,
    TransformerResFusionBlock,
    Upsample,
    conv_nhwc,
    conv_rows,
    masa_encode_pair,
)
from textualdegremoval_tpu_torch.ops import (
    bilinear_resize_torch,
    masa_match_and_warp,
    pad_to_multiple,
)
from textualdegremoval_tpu_torch.parallel.spatial import reduce_stats


def prompt_rows(prompt, shard, w: int) -> torch.Tensor:
    """The slab's rows of a (B, S, S, D) prompt bank resized bilinearly to
    the whole image (shard.height rows, w columns), with one row of each
    neighbour's above and below and zero rows past the image's true edges
    (the 3x3 conv's zero padding): (B, shard.local + 2, w, D).  A rank
    without rows gets zeros, which nobody reads."""
    if not shard.rows:
        return prompt.new_zeros((prompt.shape[0], shard.local + 2, w,
                                 prompt.shape[-1]))
    full = F.pad(bilinear_resize_torch(prompt, shard.height, w),
                 (0, 0, 0, 0, 1, 1))
    return full[:, shard.start: shard.start + shard.rows + 2]


class PromptGenBlock(nn.Module):
    """A learned prompt bank combined by softmax weights of the features'
    global average, resized bilinearly to the features' size and mixed by
    a 3x3 conv.  prompt_param keeps the reference's (1, L, D, S, S)
    layout."""

    def __init__(self, prompt_dim: int = 128, prompt_len: int = 5,
                 prompt_size: int = 96, lin_dim: int = 192):
        super().__init__()
        self.prompt_param = nn.Parameter(torch.rand(
            1, prompt_len, prompt_dim, prompt_size, prompt_size))
        self.linear_layer = nn.Linear(lin_dim, prompt_len)
        self.conv3x3 = nn.Conv2d(prompt_dim, prompt_dim, 3, padding=1,
                                 bias=False)

    def forward(self, x, shard=None):
        """x: (B, H, W, lin_dim).  Returns (B, H, W, prompt_dim).

        shard: a parallel.spatial.RowShard where x is one rank's slab of a
        row-sharded image: the mean is the float32 sums of its own rows,
        summed over the ranks, over the whole image's pixels, and the
        prompt is resized to the whole image before the conv reads the
        slab's rows of it (`prompt_rows`)."""
        _, h, w, _ = x.shape
        lin = self.linear_layer
        if shard is None:
            mean = x.mean(dim=(1, 2))
        else:
            sums = x[:, : shard.rows].float().sum((1, 2))
            reduce_stats(sums, shard=shard)
            mean = (sums / (shard.height * w)).to(x.dtype)
        weights = torch.softmax(F.linear(mean, lin.weight.to(x.dtype),
                                         lin.bias.to(x.dtype)), dim=1)
        bank = self.prompt_param.permute(0, 1, 3, 4, 2).to(x.dtype)
        prompt = (weights[:, :, None, None, None] * bank).sum(dim=1)
        if shard is None:
            return conv_nhwc(self.conv3x3,
                             bilinear_resize_torch(prompt, h, w))
        y = F.conv2d(prompt_rows(prompt, shard, w).permute(0, 3, 1, 2),
                     self.conv3x3.weight.to(x.dtype), None, 1, (0, 1))
        return y.permute(0, 2, 3, 1)


class _PromptIRTrunk(nn.Module):
    """The encoder/decoder of PromptIR (JAX `_promptir_trunk`), with the
    MASA fusion blocks of PromptIRRefFusion when `ref_fusion` is set."""

    def __init__(self, inp_channels, out_channels, dim, num_blocks,
                 num_refinement_blocks, heads, ffn_expansion_factor, bias,
                 ln_type, decoder, dtype, bwd_mode, chain, route,
                 reffusion_n_blocks=None):
        super().__init__()
        d = dim
        self.decoder = decoder
        self.dtype = dtype
        blk = dict(ffn_expansion_factor=ffn_expansion_factor, bias=bias,
                   ln_type=ln_type, bwd_mode=bwd_mode, **route)

        def stage(ch, h, n):
            return TBlockStage(ch, h, n, **blk, chain=chain)

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, bias)
        self.encoder_level1 = stage(d, heads[0], num_blocks[0])
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stage(d * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(d * 2)
        self.encoder_level3 = stage(d * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(d * 4)
        self.latent = stage(d * 8, heads[3], num_blocks[3])
        if decoder:
            for level, (pdim, size, cin) in zip(
                    (3, 2, 1), ((320, 16, d * 8), (128, 32, d * 4),
                                (64, 64, d * 2))):
                setattr(self, f"prompt{level}",
                        PromptGenBlock(pdim, 5, size, cin))
                setattr(self, f"noise_level{level}",
                        TransformerBlock(cin + pdim, heads[2], **blk))
                setattr(self, f"reduce_noise_level{level}",
                        nn.Conv2d(cin + pdim, d * 4 if level > 1 else d * 2,
                                  1, bias=bias))
        self.up4_3 = Upsample(d * 4)
        if not decoder:  # the latent reaches up4_3 at 8d channels
            self.up4_3.body[0] = nn.Conv2d(d * 8, d * 8, 3, padding=1,
                                           bias=False)
        self.reduce_chan_level3 = nn.Conv2d(d * 6, d * 4, 1, bias=bias)
        self.decoder_level3 = stage(d * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(d * 4)
        self.reduce_chan_level2 = nn.Conv2d(d * 4, d * 2, 1, bias=bias)
        self.decoder_level2 = stage(d * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(d * 2)
        self.decoder_level1 = stage(d * 2, heads[0], num_blocks[0])
        self.refinement = stage(d * 2, heads[0], num_refinement_blocks)
        self.output = nn.Conv2d(d * 2, out_channels, 3, padding=1, bias=bias)
        if reffusion_n_blocks is not None:
            for level in range(4):
                ch = d * 2 ** (level + 1)
                setattr(self, f"masa_blk_enc_level{level + 1}",
                        nn.Sequential(*[
                            TransformerResFusionBlock(ch, heads[level], **blk)
                            for _ in range(reffusion_n_blocks[level])]))

    def _prompt(self, x, level, shard=None):
        """The decoder prompt stage of `level` (3, 2, 1); shard: the row
        layout at its resolution on a slab of a row-sharded image."""
        if not self.decoder:
            return x
        x = torch.cat([x, getattr(self, f"prompt{level}")(x, shard)], dim=-1)
        x = getattr(self, f"noise_level{level}")(x, shard)
        return conv_nhwc(getattr(self, f"reduce_noise_level{level}"), x)

    def trunk(self, inp, warp=None, shards=(None,) * 4):
        """inp: (B, H, W, C_in) in the compute dtype, padded; warp: the
        MASA warp pyramid, fused in at every encoder level when given;
        shards: the row layout at each level (full resolution first) on a
        slab of a row-sharded image, else None."""
        s0, s1, s2, s3 = shards

        def fuse(x, level, shard):
            if warp is None:
                return x
            y = torch.cat([x, warp[level - 1].to(x.dtype)], dim=-1)
            for blk in getattr(self, f"masa_blk_enc_level{level}"):
                y = blk(y, shard)
            return y[..., : y.shape[-1] // 2]

        e1 = self.encoder_level1(fuse(self.patch_embed(inp, s0), 1, s0), s0)
        e2 = self.encoder_level2(fuse(self.down1_2(e1, s0), 2, s1), s1)
        e3 = self.encoder_level3(fuse(self.down2_3(e2, s1), 3, s2), s2)
        latent = self._prompt(self.latent(fuse(self.down3_4(e3, s2), 4, s3),
                                          s3), 3, s3)
        y = conv_nhwc(self.reduce_chan_level3,
                      torch.cat([self.up4_3(latent, s3), e3], dim=-1))
        y = self._prompt(self.decoder_level3(y, s2), 2, s2)
        y = conv_nhwc(self.reduce_chan_level2,
                      torch.cat([self.up3_2(y, s2), e2], dim=-1))
        y = self._prompt(self.decoder_level2(y, s1), 1, s1)
        y = torch.cat([self.up2_1(y, s1), e1], dim=-1)
        y = self.refinement(self.decoder_level1(y, s0), s0)
        return conv_rows(self.output, y, s0) + inp


class PromptIR(_PromptIRTrunk):
    """Restormer trunk with decoder-side prompt blocks."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", decoder: bool = True,
                 dtype: torch.dtype = torch.float32, bwd_mode: str = "save",
                 chain: bool = False, fused: bool = True,
                 gdfn_fused: bool = False, mdta_pallas: bool = False):
        super().__init__(inp_channels, out_channels, dim, num_blocks,
                         num_refinement_blocks, heads, ffn_expansion_factor,
                         bias, ln_type, decoder, dtype, bwd_mode, chain,
                         dict(fused=fused, gdfn_fused=gdfn_fused,
                              mdta_pallas=mdta_pallas))

    def forward(self, inp_img):
        """inp_img: (B, H, W, C_in).  Returns (B, H, W, C_out)."""
        _, h0, w0, _ = inp_img.shape
        out = self.trunk(pad_to_multiple(inp_img.to(self.dtype), 8))
        return out[:, :h0, :w0]


class PromptIRRefFusion(_PromptIRTrunk):
    """PromptIR with the MASA warp pyramid fused in at every encoder level
    through TransformerResFusionBlocks."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", decoder: bool = True,
                 nf: int = 48, ext_n_blocks: Sequence[int] = (4, 4, 4, 4),
                 reffusion_n_blocks: Sequence[int] = (2, 2, 2, 2),
                 reffusion_n_blocks_middle: int = 1, num_nbr: int = 1,
                 psize: int = 3, lr_block_size: int = 8,
                 ref_down_block_size: float = 1.5,
                 dilations: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32, bwd_mode: str = "save",
                 chain: bool = False, fused: bool = True,
                 gdfn_fused: bool = False, mdta_pallas: bool = False):
        super().__init__(inp_channels, out_channels, dim, num_blocks,
                         num_refinement_blocks, heads, ffn_expansion_factor,
                         bias, ln_type, decoder, dtype, bwd_mode, chain,
                         dict(fused=fused, gdfn_fused=gdfn_fused,
                              mdta_pallas=mdta_pallas), reffusion_n_blocks)
        self.lr_block_size = lr_block_size
        self.ref_down_block_size = ref_down_block_size
        self.psize = psize
        self.dilations = tuple(dilations)
        self.masa_enc = MASAEncoder(inp_channels, nf, ext_n_blocks, 4)

    @property
    def row_unit(self) -> int:
        """The rows of one unit of a row-sharded image: the network's
        padding multiple, 8 lr_block_size (one block row of MASA's grid at
        the deepest level, which all three 2x downsamplings divide)."""
        return 8 * self.lr_block_size

    def forward(self, inp_img, ref_img, shard=None):
        """inp_img: (B, H, W, C_in); ref_img: (B, Hr, Wr, 3 or C_in).
        Returns (B, H, W, C_out).

        shard: a parallel.spatial.RowShard of unit `row_unit` where inp_img
        is one rank's slab (`shard.slab`) of an image zero-padded at the
        bottom to shard.height rows; every rank passes the whole reference.
        Returns the slab's rows of the output (B, shard.local, W, C_out),
        which `parallel.spatial.gather_rows` puts together."""
        _, h0, w0, _ = inp_img.shape
        pad = self.row_unit
        if shard is not None and (shard.unit != pad or h0 != shard.local):
            raise ValueError(f"PromptIRRefFusion: a slab of {h0} rows in "
                             f"units of {shard.unit}; the layout needs "
                             f"{shard.local} in units of {pad}")
        s = ([None] * 4 if shard is None
             else [shard.scaled(2 ** i) for i in range(4)])
        inp = pad_to_multiple(inp_img.to(self.dtype), pad)
        ref = pad_to_multiple(ref_img.to(self.dtype), pad)
        feat_lq, feat_ref = masa_encode_pair(self.masa_enc, inp, ref, s[0])
        warp = masa_match_and_warp(
            feat_lq[-1], feat_ref, lr_block_size=self.lr_block_size,
            ref_down_block_size=self.ref_down_block_size, psize=self.psize,
            dilations=self.dilations, shard=s[3])
        return self.trunk(inp, warp, s)[:, :h0, :w0]
