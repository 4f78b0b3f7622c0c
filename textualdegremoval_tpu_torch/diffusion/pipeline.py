"""Pipeline A: textual guidance generation, training and inference.

Counterpart of textualdegremoval_tpu/diffusion/pipeline.py.  The JAX
modules are stateless and get their parameters from outside; here
`GuidanceModules` holds the five towers, which hold their weights, and the
scheduler.

* Training (the reference's main_train_i2t_mapping.py and
  main_train_tr_mapping.py): the eps-MSE `diffusion_loss` with pseudo-words
  of the CLIP view injected into the text tower and latents from the SD
  view; the I2T stage trains the mapper and every UNet `to_k_global` /
  `to_v_global`, the TR stage the CleanMapper stacked after the frozen
  mapper (`trainable_mask`).  Only the trainable parameters are
  differentiated: the VAE encode and the vision tower run without
  autograd, every frozen parameter has requires_grad False, and gradients
  reach the injected text states through the UNet's cross-attentions and
  every self-attention after them (at a 512 px image the flash kernel's
  backward).  The optimizer is JAX `make_guidance_optimizer`'s chain
  (global-norm clip 1.0, AdamW at a constant lr with weight decay 1e-2)
  over the trainable parameters only; frozen parameters are never touched.
* Generation (main_generate_reference.py): CLIP-encode the degraded image,
  map it to (clean) pseudo-words, splice them into the text tower's
  embeddings, run the 100-step DDIM CFG loop (guidance 5) over the UNet
  with global K/V, decode with the VAE.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

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
from textualdegremoval_tpu_torch.parallel.bootstrap import world
from textualdegremoval_tpu_torch.parallel.mesh import all_reduce_mean
from textualdegremoval_tpu_torch.train.trainer import AdamW, MultiSteps

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


def diffusion_loss(mods: GuidanceModules, batch: dict,
                   generator: torch.Generator | None = None, *,
                   noise: torch.Tensor | None = None,
                   t: torch.Tensor | None = None,
                   vae_eps: torch.Tensor | None = None,
                   use_clean_mapper: bool = False,
                   remat: bool = False) -> torch.Tensor:
    """The shared eps-MSE loss of the I2T and TR stages (JAX
    `diffusion_loss`), a float32 scalar.

    batch: pixel_values (B, H, W, 3) in [-1, 1] (the SD view of the
    target), pixel_values_clip (B, 224, 224, 3) (the CLIP view),
    input_ids (B, S), inj_index (B,), on the towers' device.  The VAE's
    posterior draw (`vae_eps`), the noise (in the latents' dtype) and the
    timesteps t ~ U{0..999} are drawn from `generator`, in that order,
    unless given.  remat: the UNet call under activation checkpointing
    (JAX's jax.checkpoint of the UNet): its activations are recomputed in
    the backward instead of saved."""
    dev = mods.device
    with torch.no_grad():
        latents = mods.vae.encode_sample(batch["pixel_values"], generator,
                                         eps=vae_eps) * SCALING_FACTOR
        image_embs = mods.image_encoder(batch["pixel_values_clip"])
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev,
                            dtype=latents.dtype)
    if t is None:
        t = torch.randint(0, mods.scheduler.num_train_timesteps,
                          (latents.shape[0],), generator=generator,
                          device=dev)
    noise, t = noise.to(dev, latents.dtype), t.to(dev)
    noisy = mods.scheduler.add_noise(latents, noise, t)

    words = mods.mapper(image_embs)
    if use_clean_mapper:
        words = mods.clean_mapper(words)
    hidden = text_states_with_injection(mods, batch["input_ids"], words,
                                        batch["inj_index"])

    def unet_fn(noisy, t, hidden):
        return mods.unet(noisy, t, hidden, use_global_kv=True)

    eps_pred = checkpoint(unet_fn, noisy, t, hidden, use_reentrant=False) \
        if remat else unet_fn(noisy, t, hidden)
    # reduced in f32 even under bf16 towers, as in JAX
    return torch.mean(torch.square(eps_pred.float() - noise.float()))


STAGES = ("i2t", "tr")


def trainable_mask(mods: GuidanceModules, stage: str) -> dict[str, bool]:
    """{'<tower>.<parameter>': trains} with the JAX rule: the I2T stage
    trains the mapper and every parameter whose name holds 'global' (the
    UNet's to_k_global / to_v_global), the TR stage the clean mapper."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    mask = {}
    for tower, mod in mods.towers().items():
        for name, _ in mod.named_parameters():
            full = f"{tower}.{name}"
            mask[full] = (full.startswith("mapper.") or "global" in full) \
                if stage == "i2t" else full.startswith("clean_mapper.")
    return mask


def partition(mods: GuidanceModules, stage: str):
    """([(name, parameter)] trainable, [(name, parameter)] frozen) by
    `trainable_mask`."""
    mask = trainable_mask(mods, stage)
    named = [(f"{tower}.{name}", p) for tower, mod in mods.towers().items()
             for name, p in mod.named_parameters()]
    return ([(n, p) for n, p in named if mask[n]],
            [(n, p) for n, p in named if not mask[n]])


def guidance_loss_and_grads(mods: GuidanceModules, batch: dict, stage: str,
                            generator: torch.Generator | None = None, *,
                            remat: bool = False, **draws):
    """(loss, {trainable name: gradient}) differentiating only the
    trainable parameters (JAX `guidance_loss_and_grads`, whose frozen
    entries are zeros).  draws: noise, t, vae_eps as `diffusion_loss`
    takes them."""
    train, frozen = partition(mods, stage)
    for _, p in frozen:
        p.requires_grad_(False)
    for _, p in train:
        p.requires_grad_(True)
    loss = diffusion_loss(mods, batch, generator,
                          use_clean_mapper=stage == "tr", remat=remat,
                          **draws)
    grads = torch.autograd.grad(loss, [p for _, p in train])
    return loss.detach(), {n: g for (n, _), g in zip(train, grads)}


def make_guidance_optimizer(mods: GuidanceModules, stage: str,
                            lr: float = 1e-6, grad_clip: float = 1.0,
                            accumulation_steps: int = 1):
    """JAX `make_guidance_optimizer`: clip_by_global_norm(grad_clip) ->
    AdamW(lr constant, b1 0.9, b2 0.999, weight decay 1e-2) over the
    trainable parameters; the frozen ones are not in it.  Wrapped in
    `MultiSteps` (optax.MultiSteps) when accumulation_steps > 1."""
    train, _ = partition(mods, stage)
    if any("masa" in n.lower() for n, _ in train):
        raise ValueError("a guidance parameter name holds 'masa', which "
                         "AdamW would put in its frozen-able group")
    opt = AdamW(train, lambda step: lr, weight_decay=1e-2,
                grad_clip=grad_clip)
    return MultiSteps(opt, accumulation_steps) if accumulation_steps > 1 \
        else opt


def make_guidance_train_step(mods: GuidanceModules, opt, stage: str,
                             remat: bool = False):
    """(batch, generator=None, **draws) -> loss: one micro-step, the
    gradients of the trainable parameters handed to `opt` (an AdamW, or a
    MultiSteps that updates every k-th call).  Under several ranks the
    gradients an update reads are averaged over them (a MultiSteps does so
    at its boundary, on the accumulated mean), so that the ranks' copies
    stay equal; the loss returned is this rank's."""

    def step(batch, generator=None, **draws):
        loss, grads = guidance_loss_and_grads(mods, batch, stage, generator,
                                              remat=remat, **draws)
        grads = [grads[n] for n in opt.names]
        if world() > 1 and not isinstance(opt, MultiSteps):
            grads = all_reduce_mean(grads)
        opt.step(grads)
        return loss

    return step


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
