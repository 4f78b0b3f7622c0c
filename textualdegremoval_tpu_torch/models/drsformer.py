"""DRSformer and DRSformerRefFusion as torch modules (NHWC in and out).

Counterpart of textualdegremoval_tpu/models/drsformer.py, with the
reference's module names (network_drsformer_guided_arch.py: TKSA Attention,
MSFN, the MEFC `subnet` with its OALayer and GroupOLs), so a reference
checkpoint loads with `strict=True` and the JAX package's
`convert_state_dict` maps a state dict of this package onto the JAX tree.
The 200L/SPA variant is `use_mefc=False`.  No kernel serves this family:
every op is plain torch (`layers.conv_form`: 1x1 convs as cuBLAS GEMMs,
the others cuDNN's or torch's depthwise kernels).  `dtype` is the compute
dtype (the JAX modules' `dtype`): the input is cast to it and every weight
at use, while the parameters stay float32.

DRSformerRefFusion's forward also runs on one rank's slab of an image
split by rows over torch.distributed ranks (`shard`, a
parallel.spatial.RowShard; the evaluate CLI's --spatial_shard).  Each
stencil chain reads its neighbours' rows once (`halo_rows`, none past the
image's true edges, so that each conv zero-pads as it does unsharded) and
crops its reach off: TKSA's 3x3 on a 1-row halo, MSFN's two 5x5 stages on
MSFN_HALO rows of the block's input, each MEFC step on MEFC_HALO rows
(its 7x7 separable and dilated convs).  TKSA's raw gram and square sums
and MEFC's pooled sums take the slab's own rows, summed over the ranks,
and the top-k masks run on the summed gram, the same on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models.layers import (
    ChannelLayerNorm,
    Downsample,
    MASAEncoder,
    OverlapPatchEmbed,
    Upsample,
    conv_form,
    conv_rows,
    masa_encode_pair,
    run_blocks,
)
from textualdegremoval_tpu_torch.ops import (
    masa_match_and_warp, pad_to_multiple, tksa_attention,
)
from textualdegremoval_tpu_torch.parallel.spatial import (
    check_halo, halo_rows, image_mean, reduce_stats,
)

# the rows a sharded stencil chain reads of each neighbour: MSFN's 5x5
# then its grouped 5x5 (2 + 2); an MEFC step's 7x7 separable conv (3 + 3)
# and its 7x7 conv at dilation 2 (6)
MSFN_HALO = 4
MEFC_HALO = 6


def _pair_grouped_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv`, a grouped conv of two input channels a group (MSFN's
    second stage), on NHWC x, as one depthwise conv over the input's
    channels (output 2g + i: tap i of group g's weight on input 2g + i)
    and the sum of each pair: the same sums, where cuDNN's kernel for
    two channels a group ran 2.2-4.6x slower in bf16."""
    w = conv.weight
    y = conv_form(conv, x, w.reshape(-1, 1, *w.shape[2:]))
    y = y.unflatten(-1, (w.shape[0], 2)).sum(dim=-1)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


class TKSAAttention(nn.Module):
    """Top-k sparse channel attention (reference Attention :260-330)."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)
        for i in range(1, 5):
            setattr(self, f"attn{i}", nn.Parameter(torch.full((1,), 0.2)))

    def forward(self, x, shard=None, top=0):
        """x: (B, H, W, C).  On a slab of a row-sharded image (shard), x is
        the normed slab with `top` rows of the neighbour above and those
        of the one below (`halo_rows`, 1 row); the gram's statistics take
        its own rows, summed over the ranks.  Returns the slab's rows."""
        heads = self.num_heads
        qkv = conv_form(self.qkv_dwconv, conv_form(self.qkv, x))
        if shard is not None:
            qkv = qkv[:, top: top + shard.local]
        b, h, w, c3 = qkv.shape

        def to_heads(t):  # (B, H, W, C) -> (B, heads, c, L)
            return t.reshape(b, -1, heads, c3 // 3 // heads).permute(
                0, 2, 3, 1)

        q, k, v = (to_heads(t) for t in torch.chunk(qkv, 3, dim=-1))
        blend = torch.cat([self.attn1, self.attn2, self.attn3, self.attn4])
        if shard is None:
            out = tksa_attention(q, k, v, self.temperature, blend)
        else:
            own = [to_heads(t) for t in torch.chunk(shard.own(qkv), 3, -1)]
            out = tksa_attention(q, k, v, self.temperature, blend, own[:2],
                                 lambda *t: reduce_stats(*t, shard=shard))
        out = out.permute(0, 3, 1, 2).reshape(b, h, w, c3 // 3)
        return conv_form(self.project_out, out)


class MSFN(nn.Module):
    """Mixed-scale (3x3 and 5x5) gated FFN (reference :216-256)."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66,
                 bias: bool = False):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        h2 = hidden * 2
        self.project_in = nn.Conv2d(dim, h2, 1, bias=bias)
        self.dwconv3x3 = nn.Conv2d(h2, h2, 3, padding=1, groups=h2,
                                   bias=bias)
        self.dwconv5x5 = nn.Conv2d(h2, h2, 5, padding=2, groups=h2,
                                   bias=bias)
        self.dwconv3x3_1 = nn.Conv2d(h2, hidden, 3, padding=1, groups=hidden,
                                     bias=bias)
        self.dwconv5x5_1 = nn.Conv2d(h2, hidden, 5, padding=2, groups=hidden,
                                     bias=bias)
        self.project_out = nn.Conv2d(h2, dim, 1, bias=bias)

    def forward(self, x):
        x = conv_form(self.project_in, x)
        x1_3, x2_3 = torch.chunk(F.relu(conv_form(self.dwconv3x3, x)), 2, -1)
        x1_5, x2_5 = torch.chunk(F.relu(conv_form(self.dwconv5x5, x)), 2, -1)
        x1 = F.relu(_pair_grouped_conv(self.dwconv3x3_1,
                                       torch.cat([x1_3, x1_5], -1)))
        x2 = F.relu(_pair_grouped_conv(self.dwconv5x5_1,
                                       torch.cat([x2_3, x2_5], -1)))
        return conv_form(self.project_out, torch.cat([x1, x2], -1))


class SparseTransformerBlock(nn.Module):
    """x + TKSA(LN1(x)), then + MSFN(LN2(.)); with fusion (the RefFusion
    blocks) out * alpha + x, alpha zero-initialised."""

    def __init__(self, dim: int, num_heads: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", fusion: bool = False):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, ln_type)
        self.attn = TKSAAttention(dim, num_heads, bias)
        self.norm2 = ChannelLayerNorm(dim, ln_type)
        self.ffn = MSFN(dim, ffn_expansion_factor, bias)
        if fusion:
            self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x, shard=None):
        """On a slab of a row-sharded image (shard): the attention on a
        1-row halo of x, MSFN on MSFN_HALO rows of the attention's
        output, each cropped back to the slab."""
        shortcut = x
        if shard is None:
            x = x + self.attn(self.norm1(x))
            x = x + self.ffn(self.norm2(x))
        else:
            check_halo(MSFN_HALO, shard, "SparseTransformerBlock's MSFN")
            ext, top = halo_rows(x, 1, shard)
            x = x + self.attn(self.norm1(ext), shard, top)
            ext, top = halo_rows(x, MSFN_HALO, shard)
            x = x + self.ffn(self.norm2(ext))[:, top: top + shard.local]
        if hasattr(self, "alpha"):
            return x * self.alpha.to(x.dtype) + shortcut
        return x


# ---------------------------------------------------------------------------
# MEFC: the DARTS-style mixture of 8 ops (reference :371-547)
# ---------------------------------------------------------------------------


class _AvgPool3x3(nn.Module):
    """AvgPool2d(3, stride 1, pad 1, count_include_pad=False) on NHWC, run
    on the NCHW-contiguous copy: on a channels_last input torch 2.11's CUDA
    backward of this pool is wrong (gradients off by O(1) in float64 on an
    H100, where the NCHW kernel and the CPU agree exactly)."""

    def forward(self, x):
        y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 1, 1,
                         count_include_pad=False)
        return y.permute(0, 2, 3, 1)


def _dw(dim: int, k: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(dim, dim, k, padding=(k - 1) * dilation // 2,
                     dilation=dilation, groups=dim, bias=False)


def _pw(dim_in: int, dim_out: int) -> nn.Conv2d:
    return nn.Conv2d(dim_in, dim_out, 1, bias=False)


class SepConvOp(nn.Module):
    """op: dw k, pw, ReLU, dw k, pw (indices 0, 1, 3, 4)."""

    def __init__(self, dim: int, k: int):
        super().__init__()
        self.op = nn.Sequential(_dw(dim, k), _pw(dim, dim), nn.ReLU(),
                                _dw(dim, k), _pw(dim, dim))

    def forward(self, x):
        x = conv_form(self.op[1], conv_form(self.op[0], x))
        return conv_form(self.op[4], conv_form(self.op[3], F.relu(x)))


class DilConvOp(nn.Module):
    """op: dw k at dilation 2, pw."""

    def __init__(self, dim: int, k: int, dilation: int = 2):
        super().__init__()
        self.op = nn.Sequential(_dw(dim, k, dilation), _pw(dim, dim))

    def forward(self, x):
        return conv_form(self.op[1], conv_form(self.op[0], x))


class OperationLayer(nn.Module):
    """The 8 candidate ops (sep 1/3/5/7, dil 3/5/7, the 3x3 average pool),
    each scaled by its weight, concatenated and mixed by a 1x1 and a
    ReLU."""

    def __init__(self, dim: int):
        super().__init__()
        self._ops = nn.ModuleList(
            [SepConvOp(dim, k) for k in (1, 3, 5, 7)]
            + [DilConvOp(dim, k) for k in (3, 5, 7)] + [_AvgPool3x3()])
        self._out = nn.Sequential(_pw(dim * len(self._ops), dim), nn.ReLU())

    def forward(self, x, weights):
        """weights: (B, 8)."""
        out = torch.cat([op(x) * weights[:, i, None, None, None].to(x.dtype)
                         for i, op in enumerate(self._ops)], dim=-1)
        return F.relu(conv_form(self._out[0], out))


class _OALayer(nn.Module):
    """The routing MLP: GAP -> Linear -> ReLU -> Linear."""

    def __init__(self, dim: int, steps: int, num_ops: int):
        super().__init__()
        self.ca_fc = nn.Sequential(
            nn.Linear(dim, steps * num_ops * 2), nn.ReLU(),
            nn.Linear(steps * num_ops * 2, steps * num_ops))


class _ReLUConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.op = nn.Sequential(_pw(dim, dim), nn.ReLU())


class _GroupOLs(nn.Module):
    def __init__(self, dim: int, steps: int):
        super().__init__()
        self.preprocess = _ReLUConv(dim)
        self._ops = nn.ModuleList(OperationLayer(dim) for _ in range(steps))


class MEFC(nn.Module):
    """The reference's `subnet` with layer_num 1: layers.0 the OALayer
    (per-step softmax weights over the ops from the pooled input), layers.1
    the GroupOLs (a bias-free 1x1 and ReLU, then `steps` OperationLayers,
    each with a residual ReLU)."""

    def __init__(self, dim: int, steps: int = 4, num_ops: int = 8):
        super().__init__()
        self.steps, self.num_ops = steps, num_ops
        self.layers = nn.ModuleList([_OALayer(dim, steps, num_ops),
                                     _GroupOLs(dim, steps)])

    def forward(self, x, shard=None):
        """On a slab of a row-sharded image (shard): the routing mean over
        the whole image (`image_mean`), each step on MEFC_HALO rows of its
        input cropped back to the slab."""
        dt = x.dtype
        fc1, fc2 = self.layers[0].ca_fc[0], self.layers[0].ca_fc[2]
        y = F.relu(F.linear(image_mean(x, shard)[:, 0, 0],
                            fc1.weight.to(dt), fc1.bias.to(dt)))
        y = F.linear(y, fc2.weight.to(dt), fc2.bias.to(dt))
        weights = torch.softmax(y.reshape(-1, self.steps, self.num_ops), -1)
        group = self.layers[1]
        x = F.relu(conv_form(group.preprocess.op[0], x))
        if shard is not None:
            check_halo(MEFC_HALO, shard, "MEFC")
        for i, layer in enumerate(group._ops):
            if shard is None:
                y = layer(x, weights[:, i])
            else:
                ext, top = halo_rows(x, MEFC_HALO, shard)
                y = layer(ext, weights[:, i])[:, top: top + shard.local]
            x = F.relu(y + x)
        return x


def _stage(dim, heads, n, ffn_expansion_factor, bias, ln_type,
           fusion=False) -> nn.Sequential:
    return nn.Sequential(*[
        SparseTransformerBlock(dim, heads, ffn_expansion_factor, bias,
                               ln_type, fusion) for _ in range(n)])


class _DRSformerTrunk(nn.Module):
    """The encoder/decoder shared by DRSformer and DRSformerRefFusion."""

    def __init__(self, inp_channels, out_channels, dim, num_blocks, heads,
                 ffn_expansion_factor, bias, ln_type, use_mefc, dtype):
        super().__init__()
        d = dim
        self.dtype = dtype
        self.use_mefc = use_mefc

        def stage(ch, h, n):
            return _stage(ch, h, n, ffn_expansion_factor, bias, ln_type)

        self.patch_embed = OverlapPatchEmbed(inp_channels, d, bias)
        if use_mefc:
            self.encoder_level0 = MEFC(d)
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
        if use_mefc:
            self.refinement = MEFC(d * 2)
        self.output = nn.Conv2d(d * 2, out_channels, 3, padding=1, bias=bias)

    def _decode(self, latent, e1, e2, e3, x_in, shards=(None,) * 4):
        """The decoder; shards: the row layout at each level (full
        resolution first) on a slab of a row-sharded image, else None."""
        s0, s1, s2, s3 = shards
        y = conv_form(self.reduce_chan_level3,
                      torch.cat([self.up4_3(latent, s3), e3], dim=-1))
        y = run_blocks(self.decoder_level3, y, s2)
        y = conv_form(self.reduce_chan_level2,
                      torch.cat([self.up3_2(y, s2), e2], dim=-1))
        y = run_blocks(self.decoder_level2, y, s1)
        y = run_blocks(self.decoder_level1,
                 torch.cat([self.up2_1(y, s1), e1], dim=-1), s0)
        if self.use_mefc:
            y = self.refinement(y, s0)
        return conv_rows(self.output, y, s0) + x_in


class DRSformer(_DRSformerTrunk):
    """4-level U-shaped transformer of sparse (TKSA + MSFN) blocks, with an
    MEFC after the embedding and before the output unless use_mefc is
    False."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", use_mefc: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(inp_channels, out_channels, dim, num_blocks, heads,
                         ffn_expansion_factor, bias, ln_type, use_mefc, dtype)

    def forward(self, inp_img):
        """inp_img: (B, H, W, C_in).  Returns (B, H, W, C_out)."""
        _, h0, w0, _ = inp_img.shape
        x = pad_to_multiple(inp_img.to(self.dtype), 8)
        e1 = self.patch_embed(x)
        if self.use_mefc:
            e1 = self.encoder_level0(e1)
        e1 = self.encoder_level1(e1)
        e2 = self.encoder_level2(self.down1_2(e1))
        e3 = self.encoder_level3(self.down2_3(e2))
        lat = self.latent(self.down3_4(e3))
        return self._decode(lat, e1, e2, e3, x)[:, :h0, :w0]


class DRSformerRefFusion(_DRSformerTrunk):
    """DRSformer trunk with a 4-level MASA warp pyramid, fused in at every
    encoder level by sparse blocks (fusion gates) on cat([x, warp]), at
    twice the width with the same heads, whose output's first half goes
    on."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", use_mefc: bool = True,
                 nf: int = 48, ext_n_blocks: Sequence[int] = (4, 4, 4, 4),
                 reffusion_n_blocks: Sequence[int] = (2, 2, 2, 2),
                 reffusion_n_blocks_middle: int = 1, num_nbr: int = 1,
                 psize: int = 3, lr_block_size: int = 8,
                 ref_down_block_size: float = 1.5,
                 dilations: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__(inp_channels, out_channels, dim, num_blocks, heads,
                         ffn_expansion_factor, bias, ln_type, use_mefc, dtype)
        self.lr_block_size = lr_block_size
        self.ref_down_block_size = ref_down_block_size
        self.psize = psize
        self.dilations = tuple(dilations)
        self.masa_enc = MASAEncoder(inp_channels, nf, ext_n_blocks, 4)
        for level in range(4):
            setattr(self, f"masa_blk_enc_level{level + 1}", _stage(
                dim * 2 ** (level + 1), heads[level],
                reffusion_n_blocks[level], ffn_expansion_factor, bias,
                ln_type, fusion=True))

    @property
    def row_unit(self) -> int:
        """The rows of one unit of a row-sharded image: the network's
        padding multiple, 8 lr_block_size (one block row of MASA's grid
        at the deepest level, which all three 2x downsamplings divide)."""
        return 8 * self.lr_block_size

    @staticmethod
    def _fuse(x, warp_l, blocks, shard=None):
        cat = torch.cat([x, warp_l.to(x.dtype)], dim=-1)
        return run_blocks(blocks, cat, shard)[..., : cat.shape[-1] // 2]

    def forward(self, inp_img, ref_img, shard=None):
        """inp_img: (B, H, W, C_in); ref_img: (B, Hr, Wr, C_in).  Returns
        (B, H, W, C_out).

        shard: a parallel.spatial.RowShard of unit `row_unit` where inp_img
        is one rank's slab (`shard.slab`) of an image zero-padded at the
        bottom to shard.height rows; every rank passes the whole reference.
        Returns the slab's rows of the output (B, shard.local, W, C_out),
        which `parallel.spatial.gather_rows` puts together."""
        _, h0, w0, _ = inp_img.shape
        dt = self.dtype
        pad = self.row_unit
        if shard is not None and (shard.unit != pad or h0 != shard.local):
            raise ValueError(f"{type(self).__name__}: a slab of {h0} rows "
                             f"in units of {shard.unit}; the layout needs "
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
        if self.use_mefc:
            x = self.encoder_level0(x, s[0])
        e1 = run_blocks(self.encoder_level1, x, s[0])
        x = self._fuse(self.down1_2(e1, s[0]), warp[1],
                       self.masa_blk_enc_level2, s[1])
        e2 = run_blocks(self.encoder_level2, x, s[1])
        x = self._fuse(self.down2_3(e2, s[1]), warp[2],
                       self.masa_blk_enc_level3, s[2])
        e3 = run_blocks(self.encoder_level3, x, s[2])
        x = self._fuse(self.down3_4(e3, s[2]), warp[3],
                       self.masa_blk_enc_level4, s[3])
        lat = run_blocks(self.latent, x, s[3])
        return self._decode(lat, e1, e2, e3, inp, s)[:, :h0, :w0]
