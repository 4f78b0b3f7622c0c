"""DINOv2 vision transformer and the reference-crop matcher of training.

Counterpart of textualdegremoval_tpu/models/dino.py (reference
models/dino/, vision_transformers.py:179-207, 320-393, and the trainer's
window matching, image_restoration_ref_model.py:219-247).  The modules'
state-dict keys are the reference's (`patch_embed.proj.*`,
`blocks.i.ls1.gamma`, `blocks.i.mlp.fc1.*` or `blocks.i.mlp.w12.*` for
the SwiGLU of giant2, `mask_token`, declared and unused), so that a
DINOv2 checkpoint loads with `strict=True` (`load_dino`).

The forward takes NHWC images and returns the normalised patch tokens
(B, N, D), as JAX's does.  The position embedding is resized with JAX's
bicubic (`ops.resize.image_resize`, Keys a = -0.5, antialiased) when the
patch grid is not img_size // patch_size.  Attention is the port's plain
`attention_ref` (JAX has no Pallas kernel for it either: 785 tokens at
392 px).  The matcher runs frozen in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.ops.flash_attn import attention_ref
from textualdegremoval_tpu_torch.ops.resize import image_resize


class _Holder(nn.Module):
    """A bare namespace module, for the reference's nested key names."""


class DinoMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DinoSwiGLU(nn.Module):
    """SwiGLU FFN (reference swiglu_ffn.py:14-34): one fused w12 projection
    to 2 * hidden, silu(x1) * x2, w3 out."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class DinoAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d // self.num_heads)
        o = attention_ref(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(o.reshape(b, n, d))


class DinoBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1.0, ffn_layer: str = "mlp"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, num_heads)
        self.ls1 = _Holder()
        self.ls1.gamma = nn.Parameter(torch.full((dim,), init_values))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if ffn_layer == "swiglufused":
            hidden = (int(dim * mlp_ratio * 2 / 3) + 7) // 8 * 8
            self.mlp = DinoSwiGLU(dim, hidden)
        elif ffn_layer == "mlp":
            self.mlp = DinoMlp(dim, int(dim * mlp_ratio))
        else:
            raise ValueError(f"ffn_layer {ffn_layer!r}: mlp or swiglufused")
        self.ls2 = _Holder()
        self.ls2.gamma = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1.gamma
        return x + self.mlp(self.norm2(x)) * self.ls2.gamma


class DinoVisionTransformer(nn.Module):
    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, init_values: float = 1.0,
                 ffn_layer: str = "mlp", in_chans: int = 3):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        self.embed_dim, self.in_chans = embed_dim, in_chans
        self.patch_embed = _Holder()
        self.patch_embed.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                                          patch_size)
        n0 = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n0 + 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList([
            DinoBlock(embed_dim, num_heads, mlp_ratio, init_values,
                      ffn_layer) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        """x: (B, H, W, C), H and W multiples of patch_size.  Returns the
        normalised patch tokens (B, H W / patch_size^2, D)."""
        b, hgt, wdt, c = x.shape
        if c != self.in_chans:
            raise ValueError(f"DINO embeds {self.in_chans}-channel images, "
                             f"not {c}-channel ones")
        p, d = self.patch_size, self.embed_dim
        gh, gw, g0 = hgt // p, wdt // p, self.img_size // p
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed[:, 1:]
        if (gh, gw) != (g0, g0):
            pos = image_resize(pos.reshape(1, g0, g0, d), (1, gh, gw, d),
                               "bicubic").reshape(1, gh * gw, d)
        x = torch.cat([self.cls_token.expand(b, 1, d), x], 1)
        x = x + torch.cat([self.pos_embed[:, :1], pos], 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1:]


def vit_small(**kw) -> DinoVisionTransformer:
    return DinoVisionTransformer(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> DinoVisionTransformer:
    return DinoVisionTransformer(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large(**kw) -> DinoVisionTransformer:
    return DinoVisionTransformer(embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_giant2(**kw) -> DinoVisionTransformer:
    """DINOv2 ViT-g/14: embed 1536, depth 40, 24 heads, SwiGLU FFN."""
    kw.setdefault("ffn_layer", "swiglufused")
    return DinoVisionTransformer(embed_dim=1536, depth=40, num_heads=24, **kw)


def dino_for_state_dict(sd) -> DinoVisionTransformer:
    """The DinoVisionTransformer whose parameters `sd` holds: width, depth,
    patch and img_size read from its shapes, SwiGLU where it has w12, and
    DINOv2's 64 channels a head (vit_base for dinov2_vitb14.pth)."""
    d = sd["cls_token"].shape[-1]
    p = sd["patch_embed.proj.weight"].shape[-1]
    g0 = math.isqrt(sd["pos_embed"].shape[1] - 1)
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("blocks."))
    ffn = "swiglufused" if "blocks.0.mlp.w12.weight" in sd else "mlp"
    return DinoVisionTransformer(
        img_size=g0 * p, patch_size=p, embed_dim=d, depth=depth,
        num_heads=max(1, d // 64), ffn_layer=ffn,
        in_chans=sd["patch_embed.proj.weight"].shape[1])


def load_dino(path: str, model: DinoVisionTransformer | None = None,
              device="cpu") -> DinoVisionTransformer:
    """A DINOv2 checkpoint in the reference layout (a raw state dict, or one
    under 'model' / 'state_dict') into `model` (by default the one its
    shapes describe, `dino_for_state_dict`) with strict=True, frozen in
    eval mode on `device`.  The keys are the reference's as they stand: the
    JAX CLI's generic restoration converter would rename them into paths
    its DINO module does not have."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    model = model or dino_for_state_dict(sd)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval().requires_grad_(False)


def extract_ref_windows(ref: torch.Tensor, patch: int, stride: int):
    """(B, Hr, Wr, C) -> (B, N, patch, patch, C): the patch x patch windows
    at `stride`, row by row."""
    win = ref.unfold(1, patch, stride).unfold(2, patch, stride)
    b, ny, nx, c = win.shape[:4]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b, ny * nx, patch, patch, c)


@torch.no_grad()
def ref_scores(dino: DinoVisionTransformer, lq: torch.Tensor,
               ref: torch.Tensor, chunk: int = 32):
    """The matcher's similarities (JAX `select_ref_crop` up to its
    argmax): ref's th x th windows at stride th // 4, lq and each window
    resized bilinearly (JAX's) to the next multiple of 14, and the cosine
    of their flattened DINO tokens.  The crops go through DINO `chunk` at a
    time, which bounds the memory and not the result.  lq: (B, th, th, C),
    ref: (B, Hr, Wr, C), Hr and Wr >= th.  Returns (windows (B, N, th, th,
    C), scores (B, N), lq's tokens (B, T, D))."""
    b, th, tw, c = lq.shape
    if th != tw:
        raise ValueError(f"select_ref_crop: square crops only, not {th}x{tw}")
    if c != dino.in_chans:
        raise ValueError(f"select_ref_crop: the DINO matcher embeds "
                         f"{dino.in_chans}-channel crops; lq has {c} "
                         "channels")
    windows = extract_ref_windows(ref, th, th // 4)
    n = windows.shape[1]
    side = math.ceil(th / 14) * 14

    def tokens(x):
        return torch.cat([
            dino(image_resize(x[i:i + chunk], (len(x[i:i + chunk]), side,
                                                side, c), "bilinear"))
            for i in range(0, len(x), chunk)])

    tok_l = tokens(lq)
    feat_l = F.normalize(tok_l.flatten(1), dim=-1, eps=1e-12)
    feat_r = F.normalize(tokens(windows.reshape(b * n, th, th, c)).flatten(1),
                         dim=-1, eps=1e-12).reshape(b, n, -1)
    return windows, torch.einsum("bd,bnd->bn", feat_l, feat_r), tok_l


def select_ref_crop(dino: DinoVisionTransformer, lq: torch.Tensor,
                    ref: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """The reference window most like lq under DINO features (JAX
    `select_ref_crop`): `ref_scores`' top-1 window of each image (the first
    on a tie), (B, th, th, C)."""
    windows, scores, _ = ref_scores(dino, lq, ref, chunk)
    return windows[torch.arange(len(windows), device=windows.device),
                   scores.argmax(-1)]
