"""CLIP text and vision towers with pseudo-word injection.

Counterpart of textualdegremoval_tpu/models/clip.py:
* `CLIPTextEncoder`: the SD 2.1 text tower (OpenCLIP ViT-H text: width
  1024, 23 layers, 16 heads, exact gelu, causal attention), with the
  reference's embedding splice (`splice_pseudo_words`); returns
  (last_hidden_state, pooled), pooled at the argmax of the ids.
* `CLIPVisionEncoder`: ViT-H/14 (width 1280, 32 layers, 16 heads, patch
  14, 224 px) on NHWC pixels; returns last_hidden_state (B, 257, 1280),
  before the post-LayerNorm, as HF does.

Parameter names are HF transformers' (`text_model.…`, `vision_model.…`,
`pre_layrnorm`), so a CLIPTextModel / CLIPVisionModel state dict loads with
`strict=True` through `convert.load_reference_tower`.  Every attention here
is `attention_ref`, as the JAX towers use the XLA path.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models._compute import (
    conv, layer_norm, linear,
)
from textualdegremoval_tpu_torch.ops.flash_attn import attention_ref


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str = "gelu"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        x = linear(x, self.fc1)
        x = quick_gelu(x) if self.act == "quick_gelu" else F.gelu(x)
        return linear(x, self.fc2)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(dim, dim))

    def forward(self, x, causal: bool = False):
        b, n, d = x.shape
        h = self.num_heads
        q, k, v = (linear(x, p).view(b, n, h, d // h)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = attention_ref(q, k, v, causal=causal).reshape(b, n, d)
        return linear(out, self.out_proj)


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 act: str = "gelu"):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim, int(dim * mlp_ratio), act)

    def forward(self, x, causal: bool = False):
        x = x + self.self_attn(layer_norm(x, self.layer_norm1), causal)
        return x + self.mlp(layer_norm(x, self.layer_norm2))


def _encoder(width, layers, heads, act) -> nn.Module:
    enc = nn.Module()
    enc.layers = nn.ModuleList(CLIPLayer(width, heads, 4.0, act)
                               for _ in range(layers))
    return enc


def splice_pseudo_words(token_embeds: torch.Tensor,
                        inj_embedding: torch.Tensor,
                        inj_index: torch.Tensor) -> torch.Tensor:
    """Splice pseudo-word embeddings into token embeddings at inj_index
    (reference inj_forward_text): new[b, idx:idx+L] = inj[b];
    new[b, idx+L:] = old[b, idx+1:]; the sequence length stays fixed, so
    what is shifted past the end is dropped.

    token_embeds (B, S, D), inj_embedding (B, L, D), inj_index (B,) ints.
    Returns (B, S, D)."""
    b, s, d = token_embeds.shape
    L = inj_embedding.shape[1]
    dev = token_embeds.device
    pos = torch.arange(s, device=dev)[None, :]
    idx = inj_index.to(device=dev, dtype=torch.long)[:, None]
    src_pos = (pos - L + 1).clamp(0, s - 1).expand(b, s)
    shifted = token_embeds.gather(1, src_pos[..., None].expand(b, s, d))
    inj_pos = (pos - idx).clamp(0, L - 1)
    inj_at = inj_embedding.gather(1, inj_pos[..., None].expand(b, s, d))
    in_inj = (pos >= idx) & (pos < idx + L)
    after = pos >= idx + L
    out = torch.where(in_inj[..., None], inj_at, token_embeds)
    return torch.where(after[..., None], shifted, out)


class CLIPTextEncoder(nn.Module):
    """SD 2.1 text tower with optional pseudo-word injection."""

    def __init__(self, vocab_size: int = 49408, max_positions: int = 77,
                 width: int = 1024, layers: int = 23, heads: int = 16,
                 act: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(vocab_size, width)
        tm.embeddings.position_embedding = nn.Embedding(max_positions, width)
        tm.encoder = _encoder(width, layers, heads, act)
        tm.final_layer_norm = nn.LayerNorm(width, eps=1e-5)
        self.text_model = tm

    def forward(self, input_ids: torch.Tensor,
                inj_embedding: torch.Tensor | None = None,
                inj_index: torch.Tensor | None = None):
        """input_ids (B, S) -> (last_hidden_state (B, S, width), pooled
        (B, width)), in the tower's dtype."""
        tm = self.text_model
        b, s = input_ids.shape
        input_ids = input_ids.long()
        tok = F.embedding(input_ids, tm.embeddings.token_embedding.weight)
        tok = tok.to(self.dtype)
        if inj_embedding is not None:
            if inj_index is None:
                inj_index = torch.zeros((b,), dtype=torch.long)
            tok = splice_pseudo_words(tok, inj_embedding.to(tok.dtype),
                                      inj_index)
        x = tok + tm.embeddings.position_embedding.weight[:s].to(tok.dtype)
        for layer in tm.encoder.layers:
            x = layer(x, causal=True)
        x = layer_norm(x, tm.final_layer_norm)
        pooled = x[torch.arange(b, device=x.device), input_ids.argmax(-1)]
        return x, pooled


class CLIPVisionEncoder(nn.Module):
    """CLIP ViT-H/14 vision tower -> last_hidden_state (B, 1 + N, width)."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 width: int = 1280, layers: int = 32, heads: int = 16,
                 act: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.image_size = image_size
        n = (image_size // patch_size) ** 2
        vm = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(width))
        vm.embeddings.patch_embedding = nn.Conv2d(
            3, width, patch_size, stride=patch_size, bias=False)
        vm.embeddings.position_embedding = nn.Embedding(n + 1, width)
        # HF's layer is literally named 'pre_layrnorm'
        vm.pre_layrnorm = nn.LayerNorm(width, eps=1e-5)
        vm.encoder = _encoder(width, layers, heads, act)
        self.vision_model = vm

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, H, W, 3), CLIP-normalised."""
        vm = self.vision_model
        emb = vm.embeddings
        x = conv(pixel_values.to(self.dtype).permute(0, 3, 1, 2),
                 emb.patch_embedding)
        b, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, width)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight.to(x.dtype)[None]
        x = layer_norm(x, vm.pre_layrnorm)
        for layer in vm.encoder.layers:
            x = layer(x, causal=False)
        return x
