"""Restormer and RestormerRefFusion as torch modules (NHWC in and out).

Counterpart of textualdegremoval_tpu/models/restormer.py, with the same
fixed MASA pyramid (4 levels, deepest stride 8, warp scales x1..x8 taken
from pyramid positions).  Every TransformerBlock and
TransformerResFusionBlock runs through `tblock_fused`.  `dtype` is the
compute dtype (the JAX modules' `dtype`): the input is cast to it and every
weight at use, while the parameters stay float32.  `bwd_mode` is threaded
to every block (JAX `bwd_mode`); `chain` (a bool) runs every stage of two
or more blocks as the cross-block chain (JAX `chain`, see TBlockStage).
`fused=False` (JAX `fused`) runs every block on the module path instead,
with `gdfn_fused` and `mdta_pallas` picking its GDFN and MDTA kernels
(see TransformerBlock).

RestormerRefFusion's forward also runs on one rank's slab of an image
split by rows over torch.distributed ranks (`shard`, a
parallel.spatial.RowShard; the evaluate CLI's --spatial_shard): every
conv, block, downsampling, upsampling and MASA's search on the slab, with
the neighbours' rows and the blocks' statistics exchanged as each needs
them.  It needs the whole-block route (fused=True, chain=False).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from textualdegremoval_tpu_torch.models.layers import (
    Downsample,
    MASAEncoder,
    OverlapPatchEmbed,
    TransformerResFusionBlock,
    Upsample,
    conv_nhwc,
    masa_encode_pair,
    TBlockStage,
    conv_rows,
)
from textualdegremoval_tpu_torch.ops import masa_match_and_warp, pad_to_multiple


class _RestormerTrunk(nn.Module):
    """Encoder/decoder stages shared by Restormer and RestormerRefFusion."""

    def __init__(self, inp_channels, out_channels, dim, num_blocks,
                 num_refinement_blocks, heads, ffn_expansion_factor, bias,
                 ln_type, dual_pixel_task, dtype, bwd_mode, chain, route):
        super().__init__()
        d = dim
        self.dual_pixel_task = dual_pixel_task
        self.dtype = dtype

        def stage(ch, h, n):
            return TBlockStage(ch, h, n, ffn_expansion_factor, bias, ln_type,
                               bwd_mode, chain, **route)

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, bias)
        self.encoder_level1 = stage(d, heads[0], num_blocks[0])
        self.down1_2 = Downsample(d)
        self.encoder_level2 = stage(d * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(d * 2)
        self.encoder_level3 = stage(d * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(d * 4)
        self.latent = stage(d * 8, heads[3], num_blocks[3])
        self.up4_3 = Upsample(d * 8)
        self.reduce_chan_level3 = nn.Conv2d(d * 8, d * 4, 1, bias=bias)
        self.decoder_level3 = stage(d * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(d * 4)
        self.reduce_chan_level2 = nn.Conv2d(d * 4, d * 2, 1, bias=bias)
        self.decoder_level2 = stage(d * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(d * 2)
        self.decoder_level1 = stage(d * 2, heads[0], num_blocks[0])
        self.refinement = stage(d * 2, heads[0], num_refinement_blocks)
        if dual_pixel_task:
            self.skip_conv = nn.Conv2d(d, d * 2, 1, bias=bias)
        self.output = nn.Conv2d(d * 2, out_channels, 3, padding=1, bias=bias)

    def _decode(self, latent, out_enc1, out_enc2, out_enc3, inp_enc1,
                shards=(None,) * 4):
        """The decoder; shards: the row layout at each level (full
        resolution first) on a slab of a row-sharded image, else None."""
        s0, s1, s2, s3 = shards
        x = conv_nhwc(self.reduce_chan_level3, torch.cat(
            [self.up4_3(latent, s3), out_enc3], dim=-1))
        x = self.decoder_level3(x, s2)
        x = conv_nhwc(self.reduce_chan_level2, torch.cat(
            [self.up3_2(x, s2), out_enc2], dim=-1))
        x = self.decoder_level2(x, s1)
        x = torch.cat([self.up2_1(x, s1), out_enc1], dim=-1)
        x = self.refinement(self.decoder_level1(x, s0), s0)
        if self.dual_pixel_task:
            x = x + conv_nhwc(self.skip_conv, inp_enc1)
        return conv_rows(self.output, x, s0)


class Restormer(_RestormerTrunk):
    """4-level U-shaped transformer with MDTA + GDFN blocks."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", dual_pixel_task: bool = False,
                 dtype: torch.dtype = torch.float32, bwd_mode: str = "save",
                 chain: bool = False, fused: bool = True,
                 gdfn_fused: bool = False, mdta_pallas: bool = False):
        super().__init__(inp_channels, out_channels, dim, num_blocks,
                         num_refinement_blocks, heads, ffn_expansion_factor,
                         bias, ln_type, dual_pixel_task, dtype, bwd_mode,
                         chain, dict(fused=fused, gdfn_fused=gdfn_fused,
                                     mdta_pallas=mdta_pallas))

    def forward(self, inp_img):
        """inp_img: (B, H, W, C_in).  Returns (B, H, W, C_out)."""
        _, h0, w0, _ = inp_img.shape
        x = pad_to_multiple(inp_img.to(self.dtype), 8)
        inp_enc1 = self.patch_embed(x)
        out_enc1 = self.encoder_level1(inp_enc1)
        out_enc2 = self.encoder_level2(self.down1_2(out_enc1))
        out_enc3 = self.encoder_level3(self.down2_3(out_enc2))
        latent = self.latent(self.down3_4(out_enc3))
        out = self._decode(latent, out_enc1, out_enc2, out_enc3, inp_enc1)
        if not self.dual_pixel_task:
            out = out + x
        return out[:, :h0, :w0]


class RestormerRefFusion(_RestormerTrunk):
    """Restormer trunk with the MASA warp pyramid fused in at every encoder
    level through TransformerResFusionBlocks."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", dual_pixel_task: bool = False,
                 nf: int = 48, ext_n_blocks: Sequence[int] = (4, 4, 4, 4),
                 reffusion_n_blocks: Sequence[int] = (2, 2, 2, 2),
                 reffusion_n_blocks_middle: int = 1, num_nbr: int = 1,
                 psize: int = 3, lr_block_size: int = 8,
                 ref_down_block_size: float = 1.5,
                 dilations: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32, bwd_mode: str = "save",
                 chain: bool = False, fused: bool = True,
                 gdfn_fused: bool = False, mdta_pallas: bool = False):
        route = dict(fused=fused, gdfn_fused=gdfn_fused,
                     mdta_pallas=mdta_pallas)
        super().__init__(inp_channels, out_channels, dim, num_blocks,
                         num_refinement_blocks, heads, ffn_expansion_factor,
                         bias, ln_type, dual_pixel_task, dtype, bwd_mode,
                         chain, route)
        self.lr_block_size = lr_block_size
        self.ref_down_block_size = ref_down_block_size
        self.psize = psize
        self.dilations = tuple(dilations)
        self.masa_enc = MASAEncoder(inp_channels, nf, ext_n_blocks, 4)
        for level in range(4):
            ch = dim * 2 ** (level + 1)
            setattr(self, f"masa_blk_enc_level{level + 1}", nn.Sequential(*[
                TransformerResFusionBlock(ch, heads[level],
                                          ffn_expansion_factor, bias, ln_type,
                                          bwd_mode, **route)
                for _ in range(reffusion_n_blocks[level])]))

    @property
    def row_unit(self) -> int:
        """The rows of one unit of a row-sharded image: the network's
        padding multiple, 8 lr_block_size (one block row of MASA's grid
        at the deepest level, which all three 2x downsamplings divide)."""
        return 8 * self.lr_block_size

    @staticmethod
    def _fuse(x, warp_l, blocks, shard=None):
        y = torch.cat([x, warp_l.to(x.dtype)], dim=-1)
        for blk in blocks:
            y = blk(y, shard)
        return y[..., : y.shape[-1] // 2]

    def forward(self, inp_img, ref_img, shard=None):
        """inp_img: (B, H, W, C_in); ref_img: (B, Hr, Wr, 3 or C_in).
        Returns (B, H, W, C_out).

        shard: a parallel.spatial.RowShard of unit `row_unit` where inp_img
        is one rank's slab (`shard.slab`) of an image zero-padded at the
        bottom to shard.height rows; every rank passes the whole reference.
        Returns the slab's rows of the output (B, shard.local, W, C_out),
        which `parallel.spatial.gather_rows` puts together."""
        _, h0, w0, _ = inp_img.shape
        dt = self.dtype
        pad = self.row_unit
        if shard is not None and (shard.unit != pad or h0 != shard.local):
            raise ValueError(f"RestormerRefFusion: a slab of {h0} rows in "
                             f"units of {shard.unit}; the layout needs "
                             f"{shard.local} in units of {pad}")
        s = [None] * 4 if shard is None else [shard.scaled(2 ** i)
                                              for i in range(4)]
        inp = pad_to_multiple(inp_img.to(dt), pad)
        ref = pad_to_multiple(ref_img.to(dt), pad)

        feat_lq, feat_ref = masa_encode_pair(self.masa_enc, inp, ref, s[0])
        warp = masa_match_and_warp(
            feat_lq[-1], feat_ref, lr_block_size=self.lr_block_size,
            ref_down_block_size=self.ref_down_block_size, psize=self.psize,
            dilations=self.dilations, shard=s[3])

        x = self._fuse(self.patch_embed(inp, s[0]), warp[0],
                       self.masa_blk_enc_level1, s[0])
        inp_enc1 = x
        out_enc1 = self.encoder_level1(x, s[0])
        x = self._fuse(self.down1_2(out_enc1, s[0]), warp[1],
                       self.masa_blk_enc_level2, s[1])
        out_enc2 = self.encoder_level2(x, s[1])
        x = self._fuse(self.down2_3(out_enc2, s[1]), warp[2],
                       self.masa_blk_enc_level3, s[2])
        out_enc3 = self.encoder_level3(x, s[2])
        x = self._fuse(self.down3_4(out_enc3, s[2]), warp[3],
                       self.masa_blk_enc_level4, s[3])
        latent = self.latent(x, s[3])
        out = self._decode(latent, out_enc1, out_enc2, out_enc3, inp_enc1, s)
        if not self.dual_pixel_task:
            out = out + inp
        return out[:, :h0, :w0]
