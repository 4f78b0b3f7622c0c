"""I2T Mapper and TR CleanMapper.

Counterpart of textualdegremoval_tpu/models/mappers.py.  The per-word MLPs
keep the JAX package's stacked layout: each layer's weights of all words
form one (num_words, in, out) tensor, applied with one batched product
instead of 2 * num_words small Linears.  `convert.load_reference_tower`
folds the reference's per-word `mapping_{i}.{0,1,3,4,6,7,9}` keys into it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class WordMLPs(nn.Module):
    """num_words parallel 4-layer MLPs: in -> hidden (LN, LeakyReLU) x3 ->
    out.  Parameters linear{0..3}_kernel (W, in, out), linear{0..3}_bias
    (W, out), ln{0..2}_weight / ln{0..2}_bias (W, hidden)."""

    def __init__(self, num_words: int, input_dim: int,
                 hidden_dim: int = 1280, output_dim: int = 1024,
                 diagonal: bool = False):
        super().__init__()
        self.num_words = num_words
        self.diagonal = diagonal
        dims = [input_dim, hidden_dim, hidden_dim, hidden_dim, output_dim]
        for li in range(4):
            setattr(self, f"linear{li}_kernel", nn.Parameter(
                torch.zeros(num_words, dims[li], dims[li + 1])))
            setattr(self, f"linear{li}_bias", nn.Parameter(
                torch.zeros(num_words, dims[li + 1])))
            if li < 3:
                setattr(self, f"ln{li}_weight", nn.Parameter(
                    torch.ones(num_words, dims[li + 1])))
                setattr(self, f"ln{li}_bias", nn.Parameter(
                    torch.zeros(num_words, dims[li + 1])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, input_dim).  diagonal=False: every word-MLP on every
        token -> (B, T, num_words, out); diagonal=True: T == num_words and
        word-MLP i runs on token i -> (B, num_words, out)."""
        h = x.float()
        if self.diagonal:
            eq = "bwi,wio->bwo"
        else:
            h = h[:, :, None, :].expand(-1, -1, self.num_words, -1)
            eq = "btwi,wio->btwo"
        def p(name):  # float32 even where stored bf16 (a frozen mapper)
            return getattr(self, name).float()

        for li in range(4):
            h = torch.einsum(eq, h, p(f"linear{li}_kernel")) \
                + p(f"linear{li}_bias")
            if li < 3:
                mu = h.mean(dim=-1, keepdim=True)
                var = h.var(dim=-1, unbiased=False, keepdim=True)
                h = (h - mu) / torch.sqrt(var + 1e-5)
                h = h * p(f"ln{li}_weight") + p(f"ln{li}_bias")
                h = F.leaky_relu(h, negative_slope=0.01)
        return h


class I2TMapper(nn.Module):
    """CLIP image embedding (B, 257, 1280) -> (B, num_words, output_dim)."""

    def __init__(self, num_words: int = 20, input_dim: int = 1280,
                 output_dim: int = 1024):
        super().__init__()
        self.num_words = num_words
        self.mapping = WordMLPs(num_words, input_dim, output_dim=output_dim)
        self.mapping_patch = WordMLPs(num_words, input_dim,
                                      output_dim=output_dim)

    def forward(self, image_embs: torch.Tensor) -> torch.Tensor:
        # reference semantics: the patch MLP runs on every patch token and
        # its outputs are averaged (pool after, not before: it is nonlinear)
        h_cls = self.mapping(image_embs[:, :1])[:, 0]
        h_patch = self.mapping_patch(image_embs[:, 1:]).mean(dim=1)
        return h_cls + h_patch


class CleanMapper(nn.Module):
    """Degraded word embeddings -> clean word embeddings, word i -> word i."""

    def __init__(self, num_words: int = 20, dim: int = 1024):
        super().__init__()
        self.num_words = num_words
        self.mapping = WordMLPs(num_words, dim, output_dim=dim, diagonal=True)

    def forward(self, word_embs: torch.Tensor) -> torch.Tensor:
        """word_embs: (B, num_words, dim)."""
        return self.mapping(word_embs)
