"""SFNet and SFNetRefFusion as torch modules (NHWC in and out).

Counterpart of textualdegremoval_tpu/models/sfnet.py (the reference's
network_sfnet_guided_arch.py and sfnet_arch_utils.py, with the JAX
package's repairs of its shipped defects: a 3-level MASA pyramid widening
per level, EBlockResFusion calling its layers, each fusion block at its own
level, and a list of three outputs, coarse to fine).  Module names are the
reference's (`main.0` convs, `Encoder.i.layers.j`, `FAM*.merge`, the SCM's
InstanceNorm as `main.4`), so a reference checkpoint loads with
`strict=True` once its dead `lamb_l` / `lamb_h` are dropped.

The dynamic filters' BatchNorm is computed as flax's `BatchNorm` at its
defaults, on the module's buffers (`running_mean`, `running_var`,
`num_batches_tracked`): in train mode it normalises by the batch's mean
and biased variance (E[x^2] - E[x]^2, in float32, even at batch 1, where
torch.nn.BatchNorm2d refuses) and updates the running statistics with
momentum 0.99 and the biased variance; in eval mode it reads them.  The
SCM's InstanceNorm is flax's GroupNorm with one channel a group, computed
the same way from moments accumulated in float64.

`tlc_base` (246 indoor, 210 outdoor; None in training) turns the pools of
Gap, PatchAP and SFconv into TLC local box pools of kernel
extent * tlc_base // 256.  No kernel serves this family: every op is plain
torch, the convolutions cuDNN's.  `dtype` is the compute dtype: the input
is cast to it and every weight at use, while the parameters stay float32.

SFNetRefFusion's forward also runs on one rank's slab of an image split by
rows over torch.distributed ranks (`shard`, a parallel.spatial.RowShard;
the evaluate CLI's --spatial_shard), in eval mode: the 3x3 convs read a
row of each neighbour (`conv_rows`), the 4x4 stride-2 transposed convs
one row of their input's; the TLC box pools are the whole image's at the
slab's rows, their kernels from the image's height at that level
(`box_mean_rows`); PatchAP pools each quadrant of the image on its own,
as its 2 x 2 patch-strided view does; the dynamic filters' means and the
SCM InstanceNorm's moments are the slab's own rows' sums (float32 and
float64), summed over the ranks over the whole image's pixels; the
filters' taps read a
reflected halo (`reflect_rows`).  It returns each scale's rows of the
slab.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models.layers import (
    MASAEncoder,
    conv_nhwc,
    conv_rows,
    masa_encode_pair,
    run_blocks,
)
from textualdegremoval_tpu_torch.ops import (
    masa_match_and_warp, pad_to_multiple, unfold_nhwc,
)
from textualdegremoval_tpu_torch.ops.tlc import local_avg_pool
from textualdegremoval_tpu_torch.parallel.spatial import (
    box_finish, box_kernel, box_mean_rows, box_partial, check_halo,
    exchange_rows, image_mean, reduce_stats, reflect_rows,
)

TRAIN_SIZE = 256  # sfnet_arch_utils.py:8


def _tlc_kernel(h: int, w: int, tlc_base: int | None) -> tuple[int, int]:
    """The pool's kernel on an h x w feature: the whole of it in training
    (the global mean), at test extent * tlc_base // TRAIN_SIZE."""
    if tlc_base is None:
        return h, w
    return h * tlc_base // TRAIN_SIZE, w * tlc_base // TRAIN_SIZE


def _pool(x: torch.Tensor, tlc_base: int | None,
          shard=None) -> torch.Tensor:
    """The global mean in training; at test the TLC local box pool.  On a
    slab of a row-sharded image (shard), the whole image's pool at the
    slab's rows, the kernel from the image's height at that level."""
    if shard is not None:
        return box_mean_rows(x, _tlc_kernel(shard.height, x.shape[2],
                                            tlc_base), shard)
    if tlc_base is None:
        return x.mean(dim=(1, 2), keepdim=True)
    return local_avg_pool(x, _tlc_kernel(x.shape[1], x.shape[2], tlc_base))


def patch_pool(x: torch.Tensor, p: int, tlc_base: int | None,
               shard) -> torch.Tensor:
    """PatchAP's pool of its 'b c (p1 w1) (p2 w2) -> b (c p1 p2) w1 w2'
    view, in image space at a slab's rows: each of the p x p blocks of the
    image (rows p1 H/p onwards, columns p2 W/p onwards) pooled on its own
    with the view's kernel, one reduction for all.  x (B, local, W, C),
    one rank's slab of an image of shard.height rows; a slab may straddle
    the blocks' boundaries.  Returns (B, local, W, C)."""
    b, n, ww, c = x.shape
    hq, wq = shard.height // p, ww // p
    kernel = box_kernel(_tlc_kernel(hq, wq, tlc_base), hq, wq)
    # the p2 blocks side by side as channels: (B, n, W/p, C p)
    xv = x.reshape(b, n, p, wq, c).permute(0, 1, 3, 4, 2).reshape(
        b, n, wq, c * p)
    bands, start = [], shard.start
    for p1 in range(p):
        lo = min(max(p1 * hq - start, 0), n)
        hi = min(max((p1 + 1) * hq - start, 0), n)
        first = start + lo - p1 * hq
        bands.append((lo, hi, first, box_partial(
            xv[:, lo:hi], kernel, hq, first, max(min(hi, shard.rows) - lo,
                                                 0))))
    sums = reduce_stats(*[band[-1] for band in bands], shard=shard)
    if not shard.rows:
        return torch.zeros_like(x)
    low = torch.cat([
        box_finish(s, kernel, hq, wq, first, hi - lo, x.dtype).expand(
            b, hi - lo, wq, c * p)
        for (lo, hi, first, _), s in zip(bands, sums)], dim=1)
    return low.reshape(b, n, wq, c, p).permute(0, 1, 4, 2, 3).reshape(
        b, n, ww, c)


def _flax_norm(x, axes, mean, var, weight, bias, eps: float = 1e-5,
               across_ranks: bool = False):
    """flax's normalisation: (x - mean) * (rsqrt(var + eps) * weight) +
    bias in float32, then the input's dtype; with mean None, the batch
    statistics over `axes`, var = max(E[x^2] - E[x]^2, 0) (flax's fast
    variance).  across_ranks: E[x] and E[x^2] averaged over the ranks of a
    data-parallel run (equal shares of the global batch), through an
    all-reduce that carries their gradient, as JAX's mean over a
    dp-sharded batch is global.  Returns (y, mean, var)."""
    xf = x.float()
    if mean is None:
        mean = xf.mean(dim=axes, keepdim=True)
        sq = xf.square().mean(dim=axes, keepdim=True)
        if across_ranks:
            both = (dist_fn.all_reduce(torch.cat([mean, sq]))
                    / dist.get_world_size())
            mean, sq = both[:1], both[1:]
        var = (sq - mean.square()).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(x.dtype), mean, var


class BatchNorm(nn.Module):
    """flax nn.BatchNorm (momentum 0.99, eps 1e-5) over the channels of an
    NHWC tensor, with torch.nn.BatchNorm2d's parameter and buffer names.
    across_ranks: train mode takes the global batch's moments over the
    ranks (set by parallel.mesh.global_batch_moments)."""

    across_ranks = False

    def __init__(self, c: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if not self.training:
            y, _, _ = _flax_norm(x, None, self.running_mean,
                                 self.running_var, self.weight, self.bias,
                                 self.eps)
            return y
        y, mean, var = _flax_norm(x, (0, 1, 2), None, None, self.weight,
                                  self.bias, self.eps, self.across_ranks)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.reshape(-1))
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.reshape(-1))
            self.num_batches_tracked.add_(1)
        return y


class InstanceNorm(nn.Module):
    """flax nn.GroupNorm(num_groups=C, eps 1e-5): each channel normalised
    over H and W, with an affine weight and bias (the reference's
    GroupNorm in place of InstanceNorm).  flax's one-pass moments, var =
    E[x^2] - E[x]^2, with E[x] and E[x^2] accumulated in float64: the
    SCM's channels can have a mean that dwarfs their spread, where in
    float32 the variance keeps only a few digits, which the sums' order
    decides (a row-sharded forward's and one process's differ by as much
    as either differs from float64; flax's float32 sums are no closer)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, shard=None):
        """On a slab of a row-sharded image (shard): the moments of the
        whole image, from the sums and square sums of the slab's own rows
        summed over the ranks (one reduction)."""
        xd = (x if shard is None else shard.own(x)).double()
        sums = torch.cat([xd.sum(dim=(1, 2), keepdim=True),
                          xd.square().sum(dim=(1, 2), keepdim=True)])
        height = x.shape[1]
        if shard is not None:
            reduce_stats(sums, shard=shard)
            height = shard.height
        mean, sq = torch.chunk(sums / float(height * x.shape[2]), 2)
        y, _, _ = _flax_norm(x, None, mean.float(),
                             (sq - mean.square()).clamp_min(0.0).float(),
                             self.weight, self.bias, self.eps)
        return y


class BasicConv(nn.Module):
    """main: the conv (or a k 4, stride 2, padding 1 transposed conv),
    then an exact GELU where relu is set."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = True, transpose: bool = False):
        super().__init__()
        k = kernel_size
        conv = (nn.ConvTranspose2d(cin, cout, k, stride, k // 2 - 1)
                if transpose else nn.Conv2d(cin, cout, k, stride, k // 2))
        self.relu = relu
        self.main = nn.Sequential(conv, *([nn.GELU()] if relu else []))

    def forward(self, x, shard=None):
        """On a slab of a row-sharded image (shard): a 3x3 conv through
        `conv_rows`, the transposed conv on one row of each neighbour's
        input (zeros past the image's edges) cropped to the slab's 2 local
        output rows, a 1x1 conv on the slab alone."""
        conv = self.main[0]
        if isinstance(conv, nn.ConvTranspose2d):
            ext = x
            if shard is not None:
                if conv.kernel_size != (4, 4) or conv.stride != (2, 2) \
                        or conv.padding != (1, 1):
                    raise ValueError(f"BasicConv: no row-sharded form of "
                                     f"{conv}")
                ext = exchange_rows(x, 1, shard)
            y = F.conv_transpose2d(ext.permute(0, 3, 1, 2),
                                   conv.weight.to(x.dtype),
                                   conv.bias.to(x.dtype), conv.stride,
                                   conv.padding).permute(0, 2, 3, 1)
            if shard is not None:  # input row -1 gives output rows -3..0
                y = y[:, 2: 2 + 2 * shard.local]
        elif shard is None or conv.kernel_size == (1, 1):
            y = conv_nhwc(conv, x)
        else:
            y = conv_rows(conv, x, shard)
        return F.gelu(y) if self.relu else y


class Gap(nn.Module):
    """Low / high frequency re-weighting about the (TLC) mean
    (sfnet_arch_utils.py:100-118)."""

    def __init__(self, dim: int, tlc_base: int | None = None):
        super().__init__()
        self.tlc_base = tlc_base
        self.fscale_d = nn.Parameter(torch.zeros(dim))
        self.fscale_h = nn.Parameter(torch.zeros(dim))

    def forward(self, x, shard=None):
        x_d = _pool(x, self.tlc_base, shard)
        x_h = (x - x_d) * (self.fscale_h.to(x.dtype) + 1.0)
        return x_d * self.fscale_d.to(x.dtype) + x_h


class PatchAP(nn.Module):
    """The same on 2 x 2 patch-strided views, 'b c (p1 w1) (p2 w2) -> b (c
    p1 p2) w1 w2' (sfnet_arch_utils.py:239-264)."""

    def __init__(self, dim: int, patch_size: int = 2,
                 tlc_base: int | None = None):
        super().__init__()
        self.patch_size, self.tlc_base = patch_size, tlc_base
        ch = dim * patch_size * patch_size
        self.h = nn.Parameter(torch.zeros(ch))
        self.l = nn.Parameter(torch.zeros(ch))

    def forward(self, x, shard=None):
        """On a slab of a row-sharded image (shard): the view's pool in
        image space (`patch_pool`), and h and l by each pixel's block."""
        b, hh, ww, c = x.shape
        p = self.patch_size
        if shard is not None:
            low = patch_pool(x, p, self.tlc_base, shard)
            # each row's block p1 and each column's p2 pick h, l (c p1 p2)
            band = ((torch.arange(hh, device=x.device) + shard.start)
                    // (shard.height // p)).clamp(0, p - 1)

            def by_block(t):
                t = t.to(x.dtype).reshape(c, p, p).permute(1, 2, 0)[band]
                return t[:, :, None].expand(hh, p, ww // p, c).reshape(
                    hh, ww, c)
            return (x - low) * by_block(self.h) + low * by_block(self.l)
        w1, w2 = hh // p, ww // p
        px = x.reshape(b, p, w1, p, w2, c).permute(0, 2, 4, 5, 1, 3)
        px = px.reshape(b, w1, w2, c * p * p)
        low = _pool(px, self.tlc_base)
        out = (px - low) * self.h.to(x.dtype) + low * self.l.to(x.dtype)
        out = out.reshape(b, w1, w2, c, p, p).permute(0, 4, 1, 5, 2, 3)
        return out.reshape(b, hh, ww, c)


class SFconv(nn.Module):
    """Frequency selection (sfnet_arch_utils.py:194-236); the softmax runs
    over the whole concatenated 2C axis, as the reference's does."""

    def __init__(self, dim: int, tlc_base: int | None = None):
        super().__init__()
        d = max(dim // 2, 32)
        self.tlc_base = tlc_base
        self.fc = nn.Conv2d(dim, d, 1)
        self.fcs = nn.ModuleList([nn.Conv2d(d, dim, 1), nn.Conv2d(d, dim, 1)])
        self.out = nn.Conv2d(dim, dim, 1)

    def forward(self, low, high, shard=None):
        z = conv_nhwc(self.fc, _pool(low + high, self.tlc_base, shard))
        att = torch.softmax(torch.cat([conv_nhwc(self.fcs[0], z),
                                       conv_nhwc(self.fcs[1], z)], -1),
                            dim=-1)
        high_att, low_att = torch.chunk(att, 2, dim=-1)
        return conv_nhwc(self.out, high * high_att + low * low_att)


class DynamicFilter(nn.Module):
    """A predicted low-pass filter and the high-pass residual, re-weighted
    (sfnet_arch_utils.py:152-191): GAP, a bias-free 1x1 to group * ks^2
    taps, BatchNorm, a softmax over the taps; each of min(group, C)
    channel groups filtered with its taps over the reflect-padded input."""

    def __init__(self, dim: int, kernel_size: int = 3, group: int = 8,
                 tlc_base: int | None = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.group = min(group, dim)
        taps = self.group * kernel_size ** 2
        self.conv = nn.Conv2d(dim, taps, 1, bias=False)
        self.bn = BatchNorm(taps)
        self.modulate = SFconv(dim, tlc_base)

    def forward(self, x, shard=None):
        """On a slab of a row-sharded image (shard): the whole image's mean
        (`image_mean`), the taps on the slab's reflect halo
        (`reflect_rows`)."""
        n, h, w, c = x.shape
        ks, g = self.kernel_size, self.group
        filt = self.bn(conv_nhwc(self.conv, image_mean(x, shard)))
        filt = torch.softmax(filt.reshape(n, 1, 1, g, 1, ks * ks), dim=-1)
        p = ks // 2
        if shard is None:
            xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
        else:
            check_halo(p, shard, "DynamicFilter")
            xp = F.pad(reflect_rows(x, p, shard).permute(0, 3, 1, 2),
                       (p, p, 0, 0), mode="reflect")
        patches = unfold_nhwc(xp.permute(0, 2, 3, 1), ks)
        patches = patches.reshape(n, h, w, g, c // g, ks * ks)
        low = (patches * filt.to(x.dtype)).sum(dim=-1).reshape(n, h, w, c)
        return self.modulate(low, x - low, shard)


class SFResBlock(nn.Module):
    """conv1 (GELU), [the two dynamic filters on the halves], Gap on the
    first half and PatchAP on the second, conv2, plus x
    (sfnet_arch_utils.py:121-149)."""

    def __init__(self, dim: int, use_filter: bool = False,
                 tlc_base: int | None = None):
        super().__init__()
        half = dim // 2
        self.conv1 = BasicConv(dim, dim, 3, relu=True)
        self.conv2 = BasicConv(dim, dim, 3, relu=False)
        self.use_filter = use_filter
        if use_filter:
            self.dyna = DynamicFilter(half, 3, tlc_base=tlc_base)
            self.dyna_2 = DynamicFilter(half, 5, tlc_base=tlc_base)
        self.localap = PatchAP(half, 2, tlc_base)
        self.global_ap = Gap(half, tlc_base)

    def forward(self, x, shard=None):
        out = self.conv1(x, shard)
        if self.use_filter:
            k3, k5 = torch.chunk(out, 2, dim=-1)
            out = torch.cat([self.dyna(k3, shard), self.dyna_2(k5, shard)],
                            dim=-1)
        non_local, local = torch.chunk(out, 2, dim=-1)
        out = torch.cat([self.global_ap(non_local, shard),
                         self.localap(local, shard)], -1)
        return self.conv2(out, shard) + x


def _res_blocks(dim, n, tlc_base) -> nn.Sequential:
    """n SFResBlocks, the last with the dynamic filters."""
    return nn.Sequential(*[SFResBlock(dim, i == n - 1, tlc_base)
                           for i in range(n)])


class EBlock(nn.Module):
    def __init__(self, dim: int, num_res: int, tlc_base: int | None = None):
        super().__init__()
        self.layers = _res_blocks(dim, num_res, tlc_base)

    def forward(self, x, shard=None):
        return run_blocks(self.layers, x, shard)


class EBlockResFusion(nn.Module):
    """The fusion stage: the blocks over cat([x, warp]), gated by a
    zero-initialised alpha: out * alpha + cat."""

    def __init__(self, dim: int, num_res: int, tlc_base: int | None = None):
        super().__init__()
        self.layers = _res_blocks(dim, max(num_res, 1), tlc_base)
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, cat, shard=None):
        y = run_blocks(self.layers, cat, shard)
        return y * self.alpha.to(cat.dtype) + cat


class SCM(nn.Module):
    """The shallow conv module of a half-scale input, then InstanceNorm
    (reference :200-214)."""

    def __init__(self, out_plane: int, in_chl: int = 3):
        super().__init__()
        p = out_plane
        self.main = nn.Sequential(
            BasicConv(in_chl, p // 4, 3, relu=True),
            BasicConv(p // 4, p // 2, 1, relu=True),
            BasicConv(p // 2, p // 2, 3, relu=True),
            BasicConv(p // 2, p, 1, relu=False),
            InstanceNorm(p))

    def forward(self, x, shard=None):
        return run_blocks(self.main, x, shard)


class FAM(nn.Module):
    def __init__(self, channel: int):
        super().__init__()
        self.merge = BasicConv(channel * 2, channel, 3, relu=False)

    def forward(self, x1, x2, shard=None):
        return self.merge(torch.cat([x1, x2], dim=-1), shard)


class SFNet(nn.Module):
    """The 3-scale MIMO U-Net; returns [x/4, x/2, x] restorations."""

    def __init__(self, num_res: int = 16, base_channel: int = 32,
                 tlc_base: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bc = base_channel
        self.dtype = dtype
        self.tlc_base = tlc_base
        self.Encoder = nn.ModuleList([EBlock(bc * m, num_res, tlc_base)
                                      for m in (1, 2, 4)])
        self.feat_extract = nn.ModuleList([
            BasicConv(3, bc, 3, relu=True),
            BasicConv(bc, bc * 2, 3, stride=2, relu=True),
            BasicConv(bc * 2, bc * 4, 3, stride=2, relu=True),
            BasicConv(bc * 4, bc * 2, 4, stride=2, relu=True, transpose=True),
            BasicConv(bc * 2, bc, 4, stride=2, relu=True, transpose=True),
            BasicConv(bc, 3, 3, relu=False)])
        self.Decoder = nn.ModuleList([EBlock(bc * m, num_res, tlc_base)
                                      for m in (4, 2, 1)])
        self.Convs = nn.ModuleList([BasicConv(bc * 4, bc * 2, 1, relu=True),
                                    BasicConv(bc * 2, bc, 1, relu=True)])
        self.ConvsOut = nn.ModuleList([BasicConv(bc * 4, 3, 3, relu=False),
                                       BasicConv(bc * 2, 3, 3, relu=False)])
        self.FAM1 = FAM(bc * 4)
        self.SCM1 = SCM(bc * 4)
        self.FAM2 = FAM(bc * 2)
        self.SCM2 = SCM(bc * 2)

    def _fuse(self, z, warp, level, shard=None):
        """The RefFusion injection at `level` (a no-op without a warp)."""
        if warp is None:
            return z
        cat = torch.cat([z, warp[level].to(z.dtype)], dim=-1)
        blocks = getattr(self, f"masa_blk_enc_level{level + 1}")
        return blocks(cat, shard)[..., : cat.shape[-1] // 2]

    def _body(self, x, warp=None, shards=(None,) * 3):
        """The shared trunk (JAX `_sfnet_body`); the half-scale inputs are
        x[::2, ::2] (F.interpolate's nearest at 0.5).  shards: the row
        layout at each scale (full first) on a slab of a row-sharded image,
        whose first row is even at every scale, else None."""
        s0, s1, s2 = shards
        x_2 = x[:, ::2, ::2]
        x_4 = x_2[:, ::2, ::2]
        z2 = self.SCM2(x_2, s1)
        z4 = self.SCM1(x_4, s2)
        fe = self.feat_extract
        res1 = self.Encoder[0](self._fuse(fe[0](x, s0), warp, 0, s0), s0)
        z = self._fuse(fe[1](res1, s0), warp, 1, s1)
        res2 = self.Encoder[1](self.FAM2(z, z2, s1), s1)
        z = self._fuse(fe[2](res2, s1), warp, 2, s2)
        z = self.Decoder[0](self.Encoder[2](self.FAM1(z, z4, s2), s2), s2)
        out4 = self.ConvsOut[0](z, s2) + x_4
        z = self.Convs[0](torch.cat([fe[3](z, s2), res2], dim=-1))
        z = self.Decoder[1](z, s1)
        out2 = self.ConvsOut[1](z, s1) + x_2
        z = self.Convs[1](torch.cat([fe[4](z, s1), res1], dim=-1))
        z = fe[5](self.Decoder[2](z, s0), s0)
        return [out4, out2, z + x]

    @staticmethod
    def _crop(outs, h0, w0):
        return [outs[0][:, : h0 // 4, : w0 // 4],
                outs[1][:, : h0 // 2, : w0 // 2], outs[2][:, :h0, :w0]]

    def forward(self, x):
        """x: (B, H, W, 3).  Returns [(B, H/4, W/4, 3), (B, H/2, W/2, 3),
        (B, H, W, 3)]."""
        _, h0, w0, _ = x.shape
        return self._crop(self._body(pad_to_multiple(x.to(self.dtype), 4)),
                          h0, w0)


class SFNetRefFusion(SFNet):
    """SFNet with a 3-level MASA warp pyramid (deepest stride 4, the trunk's
    padder), fused in after each of the first three feature extractors by
    an EBlockResFusion on cat([z, warp]) whose output's first half goes
    on."""

    def __init__(self, num_res: int = 16, base_channel: int = 32,
                 tlc_base: int | None = None, nf: int = 32,
                 ext_n_blocks: Sequence[int] = (4, 4, 4),
                 reffusion_n_blocks: Sequence[int] = (1, 1, 1),
                 reffusion_n_blocks_middle: int = 1, num_nbr: int = 1,
                 psize: int = 3, lr_block_size: int = 8,
                 ref_down_block_size: float = 1.5,
                 dilations: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_res, base_channel, tlc_base, dtype)
        self.lr_block_size = lr_block_size
        self.ref_down_block_size = ref_down_block_size
        self.psize = psize
        self.dilations = tuple(dilations)
        self.masa_enc = MASAEncoder(3, nf, ext_n_blocks, 3)
        for level in range(3):
            setattr(self, f"masa_blk_enc_level{level + 1}", EBlockResFusion(
                base_channel * 2 ** (level + 1), reffusion_n_blocks[level],
                tlc_base))

    @property
    def row_unit(self) -> int:
        """The rows of one unit of a row-sharded image: the network's
        padding multiple, 4 lr_block_size (one block row of MASA's grid at
        the deepest level, which both 2x downsamplings divide)."""
        return 4 * self.lr_block_size

    def forward(self, inp_img, ref_img, shard=None):
        """inp_img: (B, H, W, 3); ref_img: (B, Hr, Wr, 3).  Returns the
        three scales, as SFNet.

        shard: a parallel.spatial.RowShard of unit `row_unit` where inp_img
        is one rank's slab (`shard.slab`) of an image zero-padded at the
        bottom to shard.height rows; every rank passes the whole reference.
        Returns each scale's rows of the slab, [(B, local / 4, W / 4, 3),
        (B, local / 2, W / 2, 3), (B, local, W, 3)], which
        `parallel.spatial.gather_rows` puts together at the layouts
        shard.scaled(4), shard.scaled(2) and shard."""
        _, h0, w0, _ = inp_img.shape
        pad = self.row_unit
        if shard is not None:
            if self.training:
                raise ValueError("SFNetRefFusion: the row-sharded forward "
                                 "runs in eval mode (BatchNorm's buffers)")
            if shard.unit != pad or h0 != shard.local:
                raise ValueError(f"SFNetRefFusion: a slab of {h0} rows in "
                                 f"units of {shard.unit}; the layout needs "
                                 f"{shard.local} in units of {pad}")
        s = [None] * 3 if shard is None else [shard.scaled(2 ** i)
                                              for i in range(3)]
        inp = pad_to_multiple(inp_img.to(self.dtype), pad)
        ref = pad_to_multiple(ref_img.to(self.dtype), pad)
        feat_lq, feat_ref = masa_encode_pair(self.masa_enc, inp, ref, s[0])
        warp = masa_match_and_warp(
            feat_lq[-1], feat_ref, lr_block_size=self.lr_block_size,
            ref_down_block_size=self.ref_down_block_size, psize=self.psize,
            dilations=self.dilations, shard=s[2])
        return self._crop(self._body(inp, warp, s), h0, w0)
