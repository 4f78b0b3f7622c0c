"""DiffIR-style text-embedding-conditioned restoration training.

Counterpart of textualdegremoval_tpu/train/diffir_trainer.py (reference
DiffIRRefGuidedImageCleanModel, models/image_restoration_text_embed_diffir
_model.py:105-533): a frozen CLIP vision tower and a frozen pretrained I2T
mapper turn each batch into the pseudo-word embedding (feed_train_data
:251-270), and net_g = NAFNetDynamicFusion(lq, embed) trains on the pixel
loss.  The embedding is computed apart, without autograd, and the step is
the port's generic `make_train_step` with the embedding in the `ref` slot.
"""

from __future__ import annotations

from typing import Callable

import torch

from textualdegremoval_tpu_torch.train.trainer import make_train_step


def make_embed_fn(image_encoder: torch.nn.Module,
                  mapper: torch.nn.Module) -> Callable:
    """(CLIP-normalised view, NHWC) -> (B, num_words, D) embedding of the
    frozen towers: both are put in eval mode with requires_grad off, and
    the call runs without autograd, so no gradient can reach them."""
    for tower in (image_encoder, mapper):
        tower.eval().requires_grad_(False)

    @torch.no_grad()
    def embed(clip_view: torch.Tensor) -> torch.Tensor:
        return mapper(image_encoder(clip_view))

    return embed


def make_diffir_train_step(loss_fn: Callable, ema_decay: float = 0.0):
    """(state, batch) -> (state, metrics) for a batch of 'lq', 'gt' and
    'embed': the generic step with the embedding, detached, as `ref`."""
    base = make_train_step(loss_fn, ema_decay)

    def step(state, batch):
        return base(state, {"lq": batch["lq"], "gt": batch["gt"],
                            "ref": batch["embed"].detach()})

    return step
