"""NAFNet and NAFNetRefFusion as torch modules (NHWC in and out).

Counterpart of textualdegremoval_tpu/models/nafnet.py, with the reference's
module names (encoders, downs, middle_blks, ups, decoders, masa_blk_enc,
masa_blk_middle), so a reference checkpoint loads with `strict=True`.  The
Local (TLC) variants are the constructor argument `tlc_train_size`: every
SCA global pool becomes a box-filtered local pool whose kernel is 1.5 times
the train size, scaled by the test/train ratio.  `dtype` is the compute
dtype (the JAX modules' `dtype`): the input is cast to it and every weight
at use, while the parameters stay float32.

NAFNetRefFusion's forward also runs on one rank's slab of an image split
by rows over torch.distributed ranks (`shard`, a parallel.spatial.RowShard;
the evaluate CLI's --spatial_shard): the 3x3 convs and MASA's encoder and
search on the slab with their neighbours' rows, every NAFBlock on a 1-row
halo with its SCA mean summed over the ranks (`nafblock_fused`), and the
2x2 stride-2 downsamplings and the 1x1 + pixel-shuffle upsamplings on the
slab alone, whose rows are whole units of every level.  It needs the
whole-block route (no TLC local pool, expansions 2).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from textualdegremoval_tpu_torch.models.layers import (
    MASAEncoder,
    NAFBlock,
    conv_nhwc,
    conv_rows,
    masa_encode_pair,
)
from textualdegremoval_tpu_torch.ops import (
    masa_match_and_warp, pad_to_multiple, pixel_shuffle,
)
from textualdegremoval_tpu_torch.ops.tlc import tlc_kernel_size


def _tlc_kernel(tlc_train_size, level_scale, x_shape):
    """The SCA local-pool kernel at a pyramid level, or None for the global
    pool (training, and the non-Local variants)."""
    if tlc_train_size is None:
        return None
    th, tw = tlc_train_size
    base = (int(th * 1.5) // level_scale, int(tw * 1.5) // level_scale)
    train = (th // level_scale, tw // level_scale)
    return tlc_kernel_size(base, train, (x_shape[1], x_shape[2]))


def _blocks(c: int, n: int) -> nn.Sequential:
    return nn.Sequential(*[NAFBlock(c) for _ in range(n)])


class NAFNet(nn.Module):
    """Plain NAFNet U-Net."""

    def __init__(self, img_channel: int = 3, width: int = 16,
                 middle_blk_num: int = 1, enc_blk_nums: Sequence[int] = (),
                 dec_blk_nums: Sequence[int] = (),
                 tlc_train_size: tuple[int, int] | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tlc_train_size = tlc_train_size
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)
        self.encoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        self.decoders = nn.ModuleList()
        self.ups = nn.ModuleList()
        chan = width
        for n in enc_blk_nums:
            self.encoders.append(_blocks(chan, n))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = _blocks(chan, middle_blk_num)
        for n in dec_blk_nums:
            self.ups.append(nn.Sequential(
                nn.Conv2d(chan, chan * 2, 1, bias=False)))
            chan //= 2
            self.decoders.append(_blocks(chan, n))

    def _stage(self, blocks, x, scale, shard=None):
        """The blocks of a level, with its TLC kernel from x's size; on a
        slab of a row-sharded image, shard: the layout at that level."""
        tk = _tlc_kernel(self.tlc_train_size, scale, x.shape)
        for blk in blocks:
            x = blk(x, tk, shard)
        return x

    def _decode(self, x, encs, scale, shards=None):
        """The decoder; shards: the row layout at each level (full
        resolution first) on a slab of a row-sharded image, else None."""
        level = len(encs)
        for up, dec, skip in zip(self.ups, self.decoders, encs[::-1]):
            x = pixel_shuffle(conv_nhwc(up[0], x), 2) + skip
            scale //= 2
            level -= 1
            x = self._stage(dec, x, scale,
                            None if shards is None else shards[level])
        return x

    def forward(self, inp):
        """inp: (B, H, W, C).  Returns (B, H, W, C)."""
        _, h0, w0, _ = inp.shape
        x_in = pad_to_multiple(inp.to(self.dtype), 2 ** len(self.encoders))
        x = conv_nhwc(self.intro, x_in)
        encs, scale = [], 1
        for enc, down in zip(self.encoders, self.downs):
            x = self._stage(enc, x, scale)
            encs.append(x)
            x = conv_nhwc(down, x)
            scale *= 2
        x = self._stage(self.middle_blks, x, scale)
        x = self._decode(x, encs, scale)
        x = conv_nhwc(self.ending, x) + x_in
        return x[:, :h0, :w0]


class NAFNetRefFusion(NAFNet):
    """NAFNet trunk and a 5-level MASA warp pyramid, fused at every encoder
    level and at the middle by NAFBlocks on cat([x, warp]) whose output's
    first half goes on."""

    def __init__(self, img_channel: int = 3, width: int = 64,
                 middle_blk_num: int = 1,
                 enc_blk_nums: Sequence[int] = (1, 1, 1, 28),
                 dec_blk_nums: Sequence[int] = (1, 1, 1, 1), nf: int = 64,
                 ext_n_blocks: Sequence[int] = (4, 4, 4, 4),
                 reffusion_n_blocks: Sequence[int] = (1, 1, 1, 1, 1),
                 reffusion_n_blocks_middle: int = 1, num_nbr: int = 1,
                 psize: int = 3, lr_block_size: int = 8,
                 ref_down_block_size: float = 1.5,
                 dilations: Sequence[int] = (1, 2, 3),
                 tlc_train_size: tuple[int, int] | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(img_channel, width, middle_blk_num, enc_blk_nums,
                         dec_blk_nums, tlc_train_size, dtype)
        self.lr_block_size = lr_block_size
        self.ref_down_block_size = ref_down_block_size
        self.psize = psize
        self.dilations = tuple(dilations)
        n_levels = len(enc_blk_nums)
        # 5-level pyramid: the deepest stride, 16, is the trunk's padder
        self.masa_enc = MASAEncoder(img_channel, nf, ext_n_blocks,
                                    n_levels + 1)
        self.masa_blk_enc = nn.ModuleList(
            _blocks(width * 2 ** (li + 1), reffusion_n_blocks[li])
            for li in range(n_levels))
        # the reference indexes reffusion_n_blocks[n_levels] here, out of
        # range for every shipped config; the middle fuse has its own knob
        self.masa_blk_middle = nn.ModuleList([
            _blocks(width * 2 ** (n_levels + 1), reffusion_n_blocks_middle)])

    @property
    def row_unit(self) -> int:
        """The rows of one unit of a row-sharded image: the network's
        padding multiple, 2^levels lr_block_size (one block row of MASA's
        grid at the deepest level, which every 2x downsampling divides)."""
        return 2 ** len(self.encoders) * self.lr_block_size

    def _fuse(self, x, warp_l, blocks, scale, shard=None):
        cat = torch.cat([x, warp_l.to(x.dtype)], dim=-1)
        return self._stage(blocks, cat, scale, shard)[
            ..., : cat.shape[-1] // 2]

    def forward(self, inp, ref, shard=None):
        """inp: (B, H, W, C); ref: (B, Hr, Wr, C).  Returns (B, H, W, C).

        shard: a parallel.spatial.RowShard of unit `row_unit` where inp is
        one rank's slab (`shard.slab`) of an image zero-padded at the
        bottom to shard.height rows; every rank passes the whole reference.
        Returns the slab's rows of the output (B, shard.local, W, C), which
        `parallel.spatial.gather_rows` puts together."""
        _, h0, w0, _ = inp.shape
        pad = self.row_unit
        n_levels = len(self.encoders)
        if shard is not None and (shard.unit != pad or h0 != shard.local):
            raise ValueError(f"{type(self).__name__}: a slab of {h0} rows in "
                             f"units of {shard.unit}; the layout needs "
                             f"{shard.local} in units of {pad}")
        s = ([None] * (n_levels + 1) if shard is None
             else [shard.scaled(2 ** i) for i in range(n_levels + 1)])
        x_in = pad_to_multiple(inp.to(self.dtype), pad)
        ref_in = pad_to_multiple(ref.to(self.dtype), pad)

        feat_lq, feat_ref = masa_encode_pair(self.masa_enc, x_in, ref_in,
                                             s[0])
        warp = masa_match_and_warp(
            feat_lq[-1], feat_ref, lr_block_size=self.lr_block_size,
            ref_down_block_size=self.ref_down_block_size, psize=self.psize,
            dilations=self.dilations, shard=s[-1])

        x = conv_rows(self.intro, x_in, s[0])
        encs, scale = [], 1
        for li, (enc, down) in enumerate(zip(self.encoders, self.downs)):
            x = self._fuse(x, warp[li], self.masa_blk_enc[li], scale, s[li])
            x = self._stage(enc, x, scale, s[li])
            encs.append(x)
            x = conv_nhwc(down, x)  # 2x2 stride 2: within a slab's rows
            scale *= 2
        x = self._fuse(x, warp[-1], self.masa_blk_middle[0], scale, s[-1])
        x = self._stage(self.middle_blks, x, scale, s[-1])
        x = self._decode(x, encs, scale, None if shard is None else s)
        x = conv_rows(self.ending, x, s[0]) + x_in
        return x[:, :h0, :w0]
