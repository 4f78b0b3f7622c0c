"""Pipeline A: textual guidance generation (inference).

Counterpart of the generation half of
textualdegremoval_tpu/diffusion/pipeline.py: CLIP-encode the degraded
image, map it to (clean) pseudo-words, splice them into the text tower's
embeddings, run the 100-step DDIM CFG loop (guidance 5) over the UNet with
global K/V, decode with the VAE.  The JAX modules are stateless and get
their parameters from outside; here `GuidanceModules` holds the five
towers, which hold their weights, and the scheduler.

The training functions of the JAX module (the diffusion loss, the
trainable masks and the train step) come with pipeline A's training
(ROADMAP A7).
"""

from __future__ import annotations

import dataclasses

import torch

from textualdegremoval_tpu_torch.diffusion.ddim import (
    DDIMScheduler, cfg_sample,
)
from textualdegremoval_tpu_torch.models.clip import (
    CLIPTextEncoder, CLIPVisionEncoder,
)
from textualdegremoval_tpu_torch.models.mappers import CleanMapper, I2TMapper
from textualdegremoval_tpu_torch.models.unet import UNet2DCondition
from textualdegremoval_tpu_torch.models.vae import (
    SCALING_FACTOR, AutoencoderKL,
)

TOWERS = ("text_encoder", "image_encoder", "unet", "vae", "mapper",
          "clean_mapper")


@dataclasses.dataclass
class GuidanceModules:
    """The towers of pipeline A and the scheduler.  Built on the current
    default device (`with torch.device(...)`)."""

    text_encoder: CLIPTextEncoder
    image_encoder: CLIPVisionEncoder
    unet: UNet2DCondition
    vae: AutoencoderKL
    mapper: I2TMapper
    clean_mapper: CleanMapper | None = None
    scheduler: DDIMScheduler = dataclasses.field(default_factory=DDIMScheduler)

    @classmethod
    def small_test_config(cls, num_words: int = 4,
                          dtype: torch.dtype = torch.float32):
        """Tiny towers for tests: the same wiring at toy sizes."""
        return cls(
            text_encoder=CLIPTextEncoder(vocab_size=100, max_positions=16,
                                         width=64, layers=2, heads=4,
                                         dtype=dtype),
            image_encoder=CLIPVisionEncoder(image_size=28, patch_size=14,
                                            width=32, layers=2, heads=2,
                                            dtype=dtype),
            unet=UNet2DCondition(block_out_channels=(32, 64),
                                 layers_per_block=1, context_dim=64,
                                 head_dim=16, dtype=dtype),
            vae=AutoencoderKL(block_out_channels=(16, 32),
                              layers_per_block=1, dtype=dtype),
            mapper=I2TMapper(num_words=num_words, input_dim=32,
                             output_dim=64),
            clean_mapper=CleanMapper(num_words=num_words, dim=64),
        )

    @classmethod
    def sd21_config(cls, num_words: int = 20,
                    dtype: torch.dtype = torch.float32):
        """SD 2.1 widths.  dtype=torch.bfloat16 computes the towers in bf16
        over float32 parameters (the JAX API's `dtype`); the mappers stay
        float32, as in JAX."""
        return cls(
            text_encoder=CLIPTextEncoder(dtype=dtype),
            image_encoder=CLIPVisionEncoder(dtype=dtype),
            unet=UNet2DCondition(dtype=dtype),
            vae=AutoencoderKL(dtype=dtype),
            mapper=I2TMapper(num_words=num_words),
            clean_mapper=CleanMapper(num_words=num_words),
        )

    def towers(self) -> dict:
        return {name: getattr(self, name) for name in TOWERS
                if getattr(self, name) is not None}

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device


def encode_pseudo_words(mods: GuidanceModules, clip_view: torch.Tensor,
                        use_clean_mapper: bool = False) -> torch.Tensor:
    """CLIP view (B, 224, 224, 3) -> (clean) pseudo-word embeddings
    (B, num_words, D), float32."""
    words = mods.mapper(mods.image_encoder(clip_view))
    if use_clean_mapper:
        words = mods.clean_mapper(words)
    return words


def text_states_with_injection(mods: GuidanceModules, input_ids,
                               inj_embedding, inj_index) -> torch.Tensor:
    hidden, _ = mods.text_encoder(input_ids, inj_embedding=inj_embedding,
                                  inj_index=inj_index)
    return hidden


@torch.inference_mode()
def generate_reference(mods: GuidanceModules, clip_view: torch.Tensor,
                       input_ids: torch.Tensor, uncond_ids: torch.Tensor,
                       inj_index: torch.Tensor,
                       generator: torch.Generator | None = None,
                       latent_hw: tuple[int, int] = (64, 64),
                       num_inference_steps: int = 100,
                       guidance_scale: float = 5.0,
                       use_clean_mapper: bool = True,
                       token_index: int | None = None,
                       latents: torch.Tensor | None = None) -> torch.Tensor:
    """Degraded image -> clean reference image (B, 8h, 8w, 3), values in
    [-1, 1], in the VAE's dtype.

    The initial noise is drawn from `generator` (on the towers' device)
    unless `latents` (B, h, w, 4) are given.  token_index: inject only
    pseudo-word `token_index` instead of all (the reference validation's
    token_index flag)."""
    b = clip_view.shape[0]
    dev = mods.device
    words = encode_pseudo_words(mods, clip_view, use_clean_mapper)
    if token_index is not None:
        words = words[:, token_index: token_index + 1]
    cond = text_states_with_injection(mods, input_ids, words, inj_index)
    uncond, _ = mods.text_encoder(uncond_ids)
    if latents is None:
        latents = torch.randn(
            (b, latent_hw[0], latent_hw[1], mods.unet.in_channels),
            generator=generator, device=dev, dtype=torch.float32)

    def eps_fn(lat, t, ctx):
        return mods.unet(lat, t, ctx, use_global_kv=True)

    final = cfg_sample(eps_fn, mods.scheduler, latents.to(dev), cond, uncond,
                       num_inference_steps, guidance_scale)
    return mods.vae.decode(final / SCALING_FACTOR)
