"""Shared layers of the Restormer and NAFNet families, as torch modules on
NHWC tensors.

Counterpart of the slice of textualdegremoval_tpu/models/layers.py that the
Restormer and NAFNet models use.  Module and parameter names are the
reference's torch names (as in tests/torch_oracles.py), so a reference
checkpoint loads with `strict=True` and the JAX package's
`convert_state_dict` maps a state dict of this package onto the JAX
parameter tree.

Modules take and return (B, H, W, C) tensors; convolutions run on the
NCHW channels_last view of the same memory.  The modules of
RestormerRefFusion, NAFNetRefFusion and PromptIRRefFusion also take
`shard`, a parallel.spatial.RowShard, where the tensor is one rank's slab
of a row-sharded image: each 3x3 conv then reads one row of each
neighbour (`conv_rows`), and each block its halo and the statistics summed
over the ranks (`tblock_fused`, `nafblock_fused`).  Parameters stay
float32, as in the JAX package (`param_dtype=jnp.float32`); the compute dtype is that of
the activations, which the model casts its input to (`define_network(opt,
dtype=...)`), and every weight is cast to it at use (convs, the block
kernels' prepared weights, MASA).  LayerNorm affine, temperatures and the
fusion gates enter the block kernels in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.ops import (
    bias_free_layer_norm,
    dwconv,
    layer_norm_2d,
    with_bias_layer_norm,
    mdta_attention_nhwc,
    pixel_shuffle,
    pixel_unshuffle,
    simple_gate,
)
from textualdegremoval_tpu_torch.ops.pallas.gdfn import (
    gdfn_fused,
    prepare_gdfn_weights,
)
from textualdegremoval_tpu_torch.ops.pallas.mdta import mdta_attention
from textualdegremoval_tpu_torch.ops.pallas.nafblock import (
    nafblock_fused,
    prepare_nafblock_weights,
)
from textualdegremoval_tpu_torch.ops.pallas.tblock import (
    prepare_tblock_weights,
    tblock_chain_fused,
    tblock_fused,
)
from textualdegremoval_tpu_torch.ops.tlc import local_avg_pool
from textualdegremoval_tpu_torch.parallel.spatial import exchange_rows


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to an NHWC tensor, returning NHWC, with
    the conv's weight and bias cast to x's dtype at use."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias,
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def run_blocks(blocks, x: torch.Tensor, shard=None) -> torch.Tensor:
    """Modules in turn, each given the row layout (None unsharded)."""
    for blk in blocks:
        x = blk(x, shard)
    return x


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, shard=None) -> torch.Tensor:
    """`conv_nhwc`, or on one rank's slab of a row-sharded image (shard, a
    parallel.spatial.RowShard) the same 3x3 conv (padding 1, stride 1 or
    2) on the slab with one row of each neighbour above and below (zero
    rows past the image's true edges: the conv's own zero padding) and no
    padding of its own along H.  At stride 2 the slab starts on an even
    row and holds an even number, so its outputs are the image's output
    rows start / 2 onwards, rows / 2 of them."""
    if shard is None:
        return conv_nhwc(conv, x)
    if conv.kernel_size != (3, 3) or conv.padding != (1, 1) \
            or conv.dilation != (1, 1):
        raise ValueError(f"conv_rows: a row-sharded conv must be 3x3 with "
                         f"padding 1, got {conv}")
    ext = exchange_rows(x, 1, shard)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(ext.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias,
                 conv.stride, (0, 1), 1, conv.groups)
    return y.permute(0, 2, 3, 1)


def nchw_first(dtype: torch.dtype, channels: int, k: int,
                dilation: int) -> bool:
    """Whether a depthwise conv runs on the NCHW-contiguous copy of its
    input rather than the channels_last view: where cuDNN's channels_last
    kernels ran 1.3-6.7x slower, forward and backward, on an H100
    (`tools/bench_family_ops.py`): the dilated ones (MEFC's dil_conv),
    and in float32 those of kernel 7 or of a width not a multiple of 8
    (MSFN's 254-wide convs).  NAFNetDynamicFusion's float32 3x3 convs at
    1024 and 2048 channels read faster alone on the NCHW copy (0.19
    against 0.59 ms), but its 256 px batch-8 step ran 7.5% slower with
    them there (the copy, and the strided view the ops after them read),
    so they stay channels_last."""
    return dilation > 1 or (dtype == torch.float32
                            and (k >= 7 or channels % 8 != 0))


def conv_form(conv: nn.Conv2d, x: torch.Tensor,
              pair_weight: torch.Tensor | None = None) -> torch.Tensor:
    """`conv` on NHWC x, NHWC out: a 1x1 conv as one GEMM on the NHWC
    tensor (F.linear: in float32 1.9-2.6x faster than cuDNN's 1x1 conv at
    a 512 px forward's widths), a depthwise one on the layout `nchw_first`
    picks, the rest through cuDNN on the channels_last view.
    pair_weight: a depthwise weight over x's channels in place of conv's,
    without its bias (DRSformer's `_pair_grouped_conv`)."""
    if pair_weight is None and conv.kernel_size == (1, 1) \
            and conv.groups == 1:
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        return F.linear(x, conv.weight.to(x.dtype).flatten(1), bias)
    if pair_weight is None:
        w, bias, groups = conv.weight, conv.bias, conv.groups
    else:
        w, bias, groups = pair_weight, None, x.shape[-1]
    if groups == 1 or groups != x.shape[-1]:
        return conv_nhwc(conv, x)
    xc = x.permute(0, 3, 1, 2)
    if nchw_first(x.dtype, groups, conv.kernel_size[0], conv.dilation[0]):
        xc = xc.contiguous()
    y = F.conv2d(xc, w.to(x.dtype), None if bias is None else bias.to(
        x.dtype), conv.stride, conv.padding, conv.dilation, groups)
    return y.permute(0, 2, 3, 1)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW conv weight -> the JAX package's HWIO layout (a view)."""
    return w.permute(2, 3, 1, 0)


def _cached_kernel_weights(block: nn.Module, p: dict, x: torch.Tensor,
                           prepare):
    """A block's kernel-layout weights (`prepare()`), rebuilt only when a
    parameter, the dtype or the device changes: an optimizer's in-place
    update bumps `_version`, so the cache is rebuilt after every step.
    None off CUDA, where the blocks take their plain versions."""
    if x.device.type != "cuda":
        return None
    key = (x.dtype, x.device,
           tuple((t.data_ptr(), t._version) for t in p.values()))
    if key != block._kw_key:
        with torch.no_grad():
            block._kw = prepare()
        block._kw_key = key
    return block._kw


class _LNBody(nn.Module):
    def __init__(self, dim: int, ln_type: str):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        if ln_type != "BiasFree":
            self.bias = nn.Parameter(torch.zeros(dim))


class ChannelLayerNorm(nn.Module):
    """Restormer LayerNorm over the channel axis (WithBias or BiasFree)."""

    def __init__(self, dim: int, ln_type: str = "WithBias"):
        super().__init__()
        if ln_type not in ("WithBias", "BiasFree"):
            raise ValueError(f"unknown LayerNorm type {ln_type!r}")
        self.ln_type = ln_type
        self.body = _LNBody(dim, ln_type)

    def forward(self, x):
        if self.ln_type == "BiasFree":
            return bias_free_layer_norm(x, self.body.weight)
        return with_bias_layer_norm(x, self.body.weight, self.body.bias)


def _flag(value, name: str, owner: str) -> bool:
    """A routing option, which must be a bool: a string such as 'off'
    would be truthy and silently pick the other route."""
    if not isinstance(value, bool):
        raise ValueError(f"{owner}: {name} must be a bool, got {value!r}")
    return value


class MDTAAttention(nn.Module):
    """MDTA transposed channel attention (module path).  use_pallas (JAX
    `MDTAAttention.use_pallas`): the gram / norm / softmax core through
    the statistics kernel (`mdta_attention`: csrc/mdta.cu on CUDA
    tensors, its plain version on CPU tensors; forward only, as in JAX);
    otherwise `mdta_attention_nhwc`."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_pallas = _flag(use_pallas, "use_pallas", "MDTAAttention")
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x):
        qkv = conv_nhwc(self.qkv_dwconv, conv_nhwc(self.qkv, x))
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        attend = mdta_attention if self.use_pallas else mdta_attention_nhwc
        out = attend(q, k, v, self.temperature, self.num_heads)
        return conv_nhwc(self.project_out, out)


class GDFN(nn.Module):
    """Gated-dconv FFN (module path).  fused (JAX `GDFN.fused`): the whole
    FFN as `gdfn_fused` (csrc/gdfn.cu on CUDA tensors, with its
    recomputing backward; `gdfn_ref` on CPU tensors), bias-free only;
    otherwise the convs op by op."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66,
                 bias: bool = False, fused: bool = False):
        super().__init__()
        self.fused = _flag(fused, "fused", "GDFN")
        if fused and bias:
            raise ValueError("GDFN: the fused kernel takes no conv biases")
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=bias)
        self._kw = None
        self._kw_key = None

    def forward(self, x):
        if self.fused:
            c, h2 = x.shape[-1], self.project_in.weight.shape[0]
            w1 = _hwio(self.project_in.weight).reshape(c, h2)
            dwk = _hwio(self.dwconv.weight).reshape(3, 3, h2)
            w2 = _hwio(self.project_out.weight).reshape(h2 // 2, c)
            kw = _cached_kernel_weights(
                self, dict(w1=w1, dwk=dwk, w2=w2), x,
                lambda: prepare_gdfn_weights(w1, dwk, w2, x.dtype))
            return gdfn_fused(x.contiguous(), w1, dwk, w2, kw)
        x = conv_nhwc(self.dwconv, conv_nhwc(self.project_in, x))
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return conv_nhwc(self.project_out, F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """Restormer block: x + MDTA(LN1(x)), then + GDFN(LN2(.)).

    fused (JAX TransformerBlock.fused, default True): the forward runs as
    `tblock_fused` (the whole-block CUDA kernel for CUDA tensors, with its
    hand-written backward; its plain version `tblock_ref` for CPU
    tensors), in the dtype of its input; bwd_mode ('save' | 'remat', JAX
    TransformerBlock.bwd_mode) picks what the kernel's backward keeps
    from the forward.  With fused=False the forward is the module path,
    `module_forward`: the `attn`/`ffn` submodules op by op (cuDNN convs),
    with the standalone kernels where asked: gdfn_fused (JAX GDFN.fused,
    csrc/gdfn.cu) and mdta_pallas (JAX MDTAAttention.use_pallas,
    csrc/mdta.cu, forward only).  The three options are bools; the two
    kernels of the module path with fused=True, and conv biases with
    fused=True or gdfn_fused=True, raise.  The submodules hold the
    parameters in the reference layout on every route."""

    def __init__(self, dim: int, num_heads: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", bwd_mode: str = "save",
                 fused: bool = True, gdfn_fused: bool = False,
                 mdta_pallas: bool = False):
        super().__init__()
        owner = type(self).__name__
        self.fused = _flag(fused, "fused", owner)
        _flag(gdfn_fused, "gdfn_fused", owner)
        _flag(mdta_pallas, "mdta_pallas", owner)
        if fused and (gdfn_fused or mdta_pallas):
            raise ValueError(f"{owner}: gdfn_fused and mdta_pallas pick "
                             "kernels of the module path; they need "
                             "fused=False")
        if bias and fused:
            raise ValueError(f"{owner}: conv biases are not supported by "
                             "the whole-block kernel")
        if bwd_mode not in ("save", "remat"):
            raise ValueError(f"{owner}: unknown bwd_mode {bwd_mode!r}")
        self.num_heads = num_heads
        self.ln_type = ln_type
        self.bwd_mode = bwd_mode
        self.norm1 = ChannelLayerNorm(dim, ln_type)
        self.attn = MDTAAttention(dim, num_heads, bias, mdta_pallas)
        self.norm2 = ChannelLayerNorm(dim, ln_type)
        self.ffn = GDFN(dim, ffn_expansion_factor, bias, gdfn_fused)
        self._kw = None
        self._kw_key = None

    def block_params(self) -> dict:
        """The natural-shape parameter dict of `tblock_ref` (views)."""
        p = dict(
            norm1_w=self.norm1.body.weight, norm2_w=self.norm2.body.weight,
            qkv=_hwio(self.attn.qkv.weight),
            qkv_dw=_hwio(self.attn.qkv_dwconv.weight),
            temperature=self.attn.temperature,
            proj=_hwio(self.attn.project_out.weight),
            gd_in=_hwio(self.ffn.project_in.weight),
            gd_dw=_hwio(self.ffn.dwconv.weight),
            gd_out=_hwio(self.ffn.project_out.weight),
        )
        if self.ln_type != "BiasFree":
            p["norm1_b"] = self.norm1.body.bias
            p["norm2_b"] = self.norm2.body.bias
        return p

    def _kernel_weights(self, p: dict, x: torch.Tensor):
        return _cached_kernel_weights(
            self, p, x, lambda: prepare_tblock_weights(p, x.dtype,
                                                       self.ln_type))

    def _block(self, x, shard=None):
        """The block without a fusion gate, on the route its options
        pick; on a slab of a row-sharded image (shard) the whole-block
        route's sharded forward."""
        if not self.fused:  # the module path without the fusion gate
            if shard is not None:
                raise ValueError(f"{type(self).__name__}: the module path "
                                 "(fused=False) has no row-sharded forward")
            return TransformerBlock.module_forward(self, x)
        # the kernel takes dense NHWC; channel slices (fusion outputs) and
        # permuted conv outputs are copied here
        x = x.contiguous()
        p = self.block_params()
        kw = self._kernel_weights(p, x)
        if shard is None:
            return tblock_fused(x, p, self.num_heads, self.ln_type, kw,
                                self.bwd_mode)
        return tblock_fused(x, p, self.num_heads, self.ln_type, kw,
                            self.bwd_mode, shard=shard)

    def forward(self, x, shard=None):
        return self._block(x, shard)

    def module_forward(self, x):
        """The module path, whatever `fused` says (also the parity target
        of the whole-block kernel)."""
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class TransformerResFusionBlock(TransformerBlock):
    """Fusion block with a zero-initialised scalar gate:
    out = block(x) * alpha + x."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x, shard=None):
        y = self._block(x, shard)
        return y * self.alpha.to(y.dtype) + x.to(y.dtype)

    def module_forward(self, x):
        return super().module_forward(x) * self.alpha + x


class TBlockStage(nn.Sequential):
    """n TransformerBlocks run one after the other, with the state-dict
    keys of a plain sequence (`{stage}.{i}.`), so that reference
    checkpoints load with strict=True whatever the route (JAX
    `tblock_stage`).

    chain (a bool, validated): with chain=True a stage of two or more
    blocks runs as `tblock_chain_fused`: on CUDA the cross-block chain
    kernel (csrc/tblock_chain.cu: block i applied and block i+1's
    attention statistics taken in one pass), on the CPU the plain chain.
    Its backward recomputes through the plain chain, as JAX's does, so
    the blocks' bwd_mode does not apply to it.  A stage of one block, and
    every stage with chain=False, runs its blocks' own forwards (the
    whole-block kernel on CUDA).  fused, gdfn_fused and mdta_pallas are
    the blocks' options (TransformerBlock); the chain is a route of fused
    blocks, so chain=True with fused=False raises."""

    def __init__(self, dim: int, num_heads: int, n: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", bwd_mode: str = "save",
                 chain: bool = False, fused: bool = True,
                 gdfn_fused: bool = False, mdta_pallas: bool = False):
        if _flag(chain, "chain", "TBlockStage") \
                and not _flag(fused, "fused", "TBlockStage"):
            raise ValueError("TBlockStage: chain=True runs the whole-block "
                             "kernels; it needs fused=True")
        super().__init__(*[
            TransformerBlock(dim, num_heads, ffn_expansion_factor, bias,
                             ln_type, bwd_mode, fused, gdfn_fused,
                             mdta_pallas)
            for _ in range(n)])
        self.num_heads, self.ln_type, self.chain = num_heads, ln_type, chain

    def forward(self, x, shard=None):
        """The stage; on a slab of a row-sharded image (shard) block by
        block, each block's statistics summed over the ranks before its
        softmax, so the chain, whose walk takes block i+1's statistics in
        block i's pass, refuses a shard."""
        if shard is not None:
            if self.chain and len(self) >= 2:
                raise ValueError("TBlockStage: the chain has no row-sharded "
                                 "forward; it needs chain=False")
            for blk in self:
                x = blk(x, shard)
            return x
        if not self.chain or len(self) < 2:
            return super().forward(x)
        x = x.contiguous()
        ps = [blk.block_params() for blk in self]
        kws = [blk._kernel_weights(p, x) for blk, p in zip(self, ps)]
        return tblock_chain_fused(x, ps, self.num_heads, self.ln_type, kws)


class OverlapPatchEmbed(nn.Module):
    """3x3 conv embedding."""

    def __init__(self, in_c: int = 3, embed_dim: int = 48, bias: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=bias)

    def forward(self, x, shard=None):
        return conv_rows(self.proj, x, shard)


class Downsample(nn.Module):
    """conv C -> C/2, then pixel-unshuffle(2): 2C at half resolution."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False))

    def forward(self, x, shard=None):
        return pixel_unshuffle(conv_rows(self.body[0], x, shard), 2)


class Upsample(nn.Module):
    """conv C -> 2C, then pixel-shuffle(2): C/2 at double resolution."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False))

    def forward(self, x, shard=None):
        return pixel_shuffle(conv_rows(self.body[0], x, shard), 2)


def Conv3x3(in_c: int, out_c: int, stride: int = 1,
            bias: bool = True) -> nn.Conv2d:
    """3x3 conv, padding 1 (the JAX Conv3x3 without its XLA `impl` knob)."""
    return nn.Conv2d(in_c, out_c, 3, stride, 1, bias=bias)


class ResidualBlock(nn.Module):
    """conv-relu-conv + x."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv1 = Conv3x3(nf, nf)
        self.conv2 = Conv3x3(nf, nf)

    def forward(self, x, shard=None):
        out = conv_rows(self.conv2, F.relu(conv_rows(self.conv1, x, shard)),
                        shard)
        return out + x


class MASAEncoder(nn.Module):
    """Multi-scale ResidualBlock feature extractor; returns features shallow
    -> deep with nf * 2**level channels (level 0 at full resolution)."""

    def __init__(self, in_chl: int, nf: int,
                 n_blocks: Sequence[int] = (4, 4, 4, 4), num_levels: int = 4):
        super().__init__()
        self.num_levels = num_levels
        for level in range(num_levels):
            ch = nf * 2 ** level
            in_c = in_chl if level == 0 else nf * 2 ** (level - 1)
            setattr(self, f"conv_L{level + 1}",
                    Conv3x3(in_c, ch, stride=1 if level == 0 else 2))
            nblk = n_blocks[min(level, len(n_blocks) - 1)]
            setattr(self, f"blk_L{level + 1}",
                    nn.Sequential(*[ResidualBlock(ch) for _ in range(nblk)]))

    def forward(self, x, shard=None):
        """The pyramid; on a slab of a row-sharded image (shard) each
        level on its slab, the layout halved after each stride-2 conv."""
        feats = []
        for level in range(self.num_levels):
            conv = getattr(self, f"conv_L{level + 1}")
            x = F.relu(conv_rows(conv, x, shard))
            if shard is not None and conv.stride[0] == 2:
                shard = shard.scaled(2)
            for blk in getattr(self, f"blk_L{level + 1}"):
                x = blk(x, shard)
            feats.append(x)
        return feats


def masa_encode_pair(enc: MASAEncoder, inp: torch.Tensor, ref: torch.Tensor,
                     shard=None):
    """Run the shared MASA encoder over lq and ref.

    Same-shape inputs run as one batched pass; different shapes (whole-image
    eval with a full-size reference) run two passes sharing the weights.  A
    3-channel reference meeting a 6-channel dual-pixel input is viewed as
    identical left/right views.  Where inp is one rank's slab of a
    row-sharded image (shard), lq runs sharded and ref whole, in two
    passes.  Returns (lq pyramid, ref pyramid)."""
    if ref.shape[-1] * 2 == inp.shape[-1]:
        ref = torch.cat([ref, ref], dim=-1)
    if shard is not None:
        return enc(inp, shard), enc(ref)
    if inp.shape == ref.shape:
        feats = enc(torch.cat([inp, ref], dim=0))
        b = inp.shape[0]
        return [f[:b] for f in feats], [f[b:] for f in feats]
    return enc(inp), enc(ref)


# ---------------------------------------------------------------------------
# NAFNet blocks
# ---------------------------------------------------------------------------


class LayerNorm2d(nn.Module):
    """NAFNet LayerNorm2d over the channel axis, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm_2d(x, self.weight, self.bias)


class _AvgPool(nn.Module):
    """The SCA pool: the global mean, or with a TLC kernel the local box
    average."""

    def forward(self, x, tlc_kernel=None):
        if tlc_kernel is None:
            return x.mean(dim=(1, 2), keepdim=True)
        return local_avg_pool(x, tlc_kernel)


class SCA(nn.Sequential):
    """Simplified channel attention, x * conv1x1(pool(x)); index 0 is the
    pool and index 1 the conv, as in the reference's Sequential."""

    def __init__(self, dim: int):
        super().__init__(_AvgPool(), nn.Conv2d(dim, dim, 1))

    def forward(self, x, tlc_kernel=None):
        return x * conv_nhwc(self[1], self[0](x, tlc_kernel))


class NAFBlock(nn.Module):
    """NAFNet block: y = x + conv3(SCA(gate(dw(conv1(LN1(x)))))) * beta,
    then y + conv5(gate(conv4(LN2(y)))) * gamma.

    With the global-pool SCA and both expansions 2 (JAX's routing), the
    forward runs as `nafblock_fused` (the whole-block CUDA kernel pair for
    CUDA tensors, whose backward recomputes through the plain version; the
    plain `nafblock_ref` for CPU tensors), in the dtype of its input.  A
    TLC local pool or another expansion runs `module_forward`, op by op.
    The TLC kernel is the constructor's, or the call's: the Local networks
    derive it from the input's size at each call.  On one rank's slab of a
    row-sharded image (`shard`) the whole-block route runs its sharded
    forward; the module path has none and refuses a shard."""

    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2,
                 tlc_kernel: tuple[int, int] | None = None):
        super().__init__()
        dw = c * dw_expand
        self.dw_expand, self.ffn_expand = dw_expand, ffn_expand
        self.tlc_kernel = tlc_kernel
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = SCA(dw // 2)
        self.conv4 = nn.Conv2d(c, ffn_expand * c, 1)
        self.conv5 = nn.Conv2d(ffn_expand * c // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))
        self._kw = None
        self._kw_key = None

    def block_params(self) -> dict:
        """The natural-shape parameter dict of `nafblock_ref` (views)."""
        return dict(
            norm1_w=self.norm1.weight, norm1_b=self.norm1.bias,
            w1=_hwio(self.conv1.weight), b1=self.conv1.bias,
            dw=_hwio(self.conv2.weight), dwb=self.conv2.bias,
            sca_w=_hwio(self.sca[1].weight), sca_b=self.sca[1].bias,
            w3=_hwio(self.conv3.weight), b3=self.conv3.bias,
            beta=self.beta.permute(0, 2, 3, 1),
            norm2_w=self.norm2.weight, norm2_b=self.norm2.bias,
            w4=_hwio(self.conv4.weight), b4=self.conv4.bias,
            w5=_hwio(self.conv5.weight), b5=self.conv5.bias,
            gamma=self.gamma.permute(0, 2, 3, 1))

    def forward(self, x, tlc_kernel=None, shard=None):
        tk = self.tlc_kernel if tlc_kernel is None else tlc_kernel
        if tk is not None or self.dw_expand != 2 or self.ffn_expand != 2:
            if shard is not None:
                raise ValueError(f"{type(self).__name__}: the module path (a "
                                 "TLC local pool or expansions other than "
                                 "2) has no row-sharded forward")
            return self.module_forward(x, tk)
        # the kernel takes dense NHWC; the fusion blocks' cat is dense
        x = x.contiguous()
        p = self.block_params()
        return nafblock_fused(x, p, _cached_kernel_weights(
            self, p, x, lambda: prepare_nafblock_weights(p, x.dtype)),
            shard=shard)

    def module_forward(self, inp, tlc_kernel=None):
        x = conv_nhwc(self.conv1, self.norm1(inp))
        x = dwconv(x, _hwio(self.conv2.weight)) + self.conv2.bias.to(x.dtype)
        x = conv_nhwc(self.conv3, self.sca(simple_gate(x), tlc_kernel))
        y = inp + x * self.beta.permute(0, 2, 3, 1).to(x.dtype)
        x = conv_nhwc(self.conv4, self.norm2(y))
        x = conv_nhwc(self.conv5, simple_gate(x))
        return y + x * self.gamma.permute(0, 2, 3, 1).to(x.dtype)
