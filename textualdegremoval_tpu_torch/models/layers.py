"""Shared layers of the Restormer family, as torch modules on NHWC tensors.

Counterpart of the slice of textualdegremoval_tpu/models/layers.py that the
Restormer models use.  Module and parameter names are the reference's torch
names (as in tests/torch_oracles.py), so a reference checkpoint loads with
`strict=True` and the JAX package's `convert_state_dict` maps a state dict
of this package onto the JAX parameter tree.

Modules take and return (B, H, W, C) tensors; convolutions run on the
NCHW channels_last view of the same memory.  Parameters stay float32, as in
the JAX package (`param_dtype=jnp.float32`); the compute dtype is that of
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
    with_bias_layer_norm,
    mdta_attention_nhwc,
    pixel_shuffle,
    pixel_unshuffle,
)
from textualdegremoval_tpu_torch.ops.pallas.tblock import (
    prepare_tblock_weights,
    tblock_fused,
)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to an NHWC tensor, returning NHWC, with
    the conv's weight and bias cast to x's dtype at use."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias,
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW conv weight -> the JAX package's HWIO layout (a view)."""
    return w.permute(2, 3, 1, 0)


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


class MDTAAttention(nn.Module):
    """MDTA transposed channel attention (module path)."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x):
        qkv = conv_nhwc(self.qkv_dwconv, conv_nhwc(self.qkv, x))
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        out = mdta_attention_nhwc(q, k, v, self.temperature, self.num_heads)
        return conv_nhwc(self.project_out, out)


class GDFN(nn.Module):
    """Gated-dconv FFN (module path)."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66,
                 bias: bool = False):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=bias)

    def forward(self, x):
        x = conv_nhwc(self.dwconv, conv_nhwc(self.project_in, x))
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return conv_nhwc(self.project_out, F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """Restormer block: x + MDTA(LN1(x)), then + GDFN(LN2(.)).

    The forward always runs as `tblock_fused` (the whole-block CUDA kernel
    for CUDA tensors, with its hand-written backward; its plain version
    `tblock_ref` for CPU tensors), in the dtype of its input.  bwd_mode
    ('save' | 'remat', JAX TransformerBlock.bwd_mode) picks what the
    kernel's backward keeps from the forward.  The `attn`/`ffn` submodules
    hold the parameters in the reference layout; `module_forward` runs them
    op by op and serves as a parity target."""

    def __init__(self, dim: int, num_heads: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias", bwd_mode: str = "save"):
        super().__init__()
        if bias:
            raise ValueError("TransformerBlock: conv biases are not supported "
                             "by the whole-block kernel")
        if bwd_mode not in ("save", "remat"):
            raise ValueError(f"TransformerBlock: unknown bwd_mode {bwd_mode!r}")
        self.num_heads = num_heads
        self.ln_type = ln_type
        self.bwd_mode = bwd_mode
        self.norm1 = ChannelLayerNorm(dim, ln_type)
        self.attn = MDTAAttention(dim, num_heads, bias)
        self.norm2 = ChannelLayerNorm(dim, ln_type)
        self.ffn = GDFN(dim, ffn_expansion_factor, bias)
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
        """Kernel-layout weights, rebuilt only when a parameter, the dtype
        or the device changes: an optimizer's in-place update bumps
        `_version`, so the cache is rebuilt after every step."""
        if x.device.type != "cuda":
            return None
        key = (x.dtype, x.device,
               tuple((t.data_ptr(), t._version) for t in p.values()))
        if key != self._kw_key:
            with torch.no_grad():
                self._kw = prepare_tblock_weights(p, x.dtype, self.ln_type)
            self._kw_key = key
        return self._kw

    def forward(self, x):
        # the kernel takes dense NHWC; channel slices (fusion outputs) and
        # permuted conv outputs are copied here
        x = x.contiguous()
        p = self.block_params()
        return tblock_fused(x, p, self.num_heads, self.ln_type,
                            self._kernel_weights(p, x), self.bwd_mode)

    def module_forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class TransformerResFusionBlock(TransformerBlock):
    """Fusion block with a zero-initialised scalar gate:
    out = block(x) * alpha + x."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        y = super().forward(x)
        return y * self.alpha.to(y.dtype) + x.to(y.dtype)

    def module_forward(self, x):
        return super().module_forward(x) * self.alpha + x


def tblock_stage(dim: int, num_heads: int, n: int,
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 ln_type: str = "WithBias",
                 bwd_mode: str = "save") -> nn.Sequential:
    """n TransformerBlocks run one after the other (keys `{stage}.{i}.`)."""
    return nn.Sequential(*[
        TransformerBlock(dim, num_heads, ffn_expansion_factor, bias, ln_type,
                         bwd_mode)
        for _ in range(n)])


class OverlapPatchEmbed(nn.Module):
    """3x3 conv embedding."""

    def __init__(self, in_c: int = 3, embed_dim: int = 48, bias: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=bias)

    def forward(self, x):
        return conv_nhwc(self.proj, x)


class Downsample(nn.Module):
    """conv C -> C/2, then pixel-unshuffle(2): 2C at half resolution."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False))

    def forward(self, x):
        return pixel_unshuffle(conv_nhwc(self.body[0], x), 2)


class Upsample(nn.Module):
    """conv C -> 2C, then pixel-shuffle(2): C/2 at double resolution."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False))

    def forward(self, x):
        return pixel_shuffle(conv_nhwc(self.body[0], x), 2)


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

    def forward(self, x):
        out = conv_nhwc(self.conv2, F.relu(conv_nhwc(self.conv1, x)))
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

    def forward(self, x):
        feats = []
        for level in range(self.num_levels):
            x = F.relu(conv_nhwc(getattr(self, f"conv_L{level + 1}"), x))
            x = getattr(self, f"blk_L{level + 1}")(x)
            feats.append(x)
        return feats


def masa_encode_pair(enc: MASAEncoder, inp: torch.Tensor, ref: torch.Tensor):
    """Run the shared MASA encoder over lq and ref.

    Same-shape inputs run as one batched pass; different shapes (whole-image
    eval with a full-size reference) run two passes sharing the weights.  A
    3-channel reference meeting a 6-channel dual-pixel input is viewed as
    identical left/right views.  Returns (lq pyramid, ref pyramid)."""
    if ref.shape[-1] * 2 == inp.shape[-1]:
        ref = torch.cat([ref, ref], dim=-1)
    if inp.shape == ref.shape:
        feats = enc(torch.cat([inp, ref], dim=0))
        b = inp.shape[0]
        return [f[:b] for f in feats], [f[b:] for f in feats]
    return enc(inp), enc(ref)
