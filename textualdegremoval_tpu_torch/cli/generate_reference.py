"""Reference-image generation CLI (pipeline A inference).

Counterpart of textualdegremoval_tpu/cli/generate_reference.py:

    python -m textualdegremoval_tpu_torch.cli.generate_reference \\
        --test_data_dir <degraded images> --output_dir <out> \\
        (--pretrained_params <dir> | --random_init) \\
        [--num_words 20 --guidance_scale 5 --steps 100 --size 512] \\
        [--device cuda]

For each input image: centre crop -> 224 px CLIP view -> I2T mapper -> TR
clean mapper -> pseudo-words spliced into the text tower -> 100-step DDIM
CFG over the SD 2.1 UNet -> VAE decode -> PNG.  The towers compute in
float32, the JAX CLI's default.  --pretrained_params names a directory of
reference-format state dicts (`convert.load_reference_towers`: HF CLIP,
diffusers UNet and VAE, the mapper artifacts) instead of the JAX CLI's
orbax directory.  --random_init draws seeded random towers
(`random_init`): outputs are noise, for exercising the whole path without
converted weights.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.nn as nn

from textualdegremoval_tpu_torch.convert import load_reference_towers
from textualdegremoval_tpu_torch.data import imread_f32, scan_images
from textualdegremoval_tpu_torch.data.guidance import (  # noqa: F401
    CLIP_MEAN, CLIP_STD, resize_bilinear,
)
from textualdegremoval_tpu_torch.diffusion.pipeline import (
    GuidanceModules, generate_reference,
)
from textualdegremoval_tpu_torch.diffusion.tokenizer import tokenize_template
from textualdegremoval_tpu_torch.models.mappers import WordMLPs
from textualdegremoval_tpu_torch.utils.image import imwrite, tensor2img

PROMPT_TEMPLATE = "a photo of a S"


def center_crop_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return img[top: top + s, left: left + s]


def clip_view(img: np.ndarray, size: int, device) -> torch.Tensor:
    """Centre-cropped HWC float32 image in [0, 1] -> (1, size, size, 3),
    CLIP-normalised, on `device` (size 224 for ViT-H/14)."""
    v = resize_bilinear(torch.from_numpy(np.ascontiguousarray(img)).to(
        device), size)
    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)
    return ((v - mean) / std)[None]


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's lecun_normal: a normal of variance 1/fan_in truncated at two
    standard deviations (the std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def random_init(mods: GuidanceModules, generator: torch.Generator):
    """Seeded random towers in place, the counterpart of the JAX modules'
    `init`: lecun-normal dense and conv kernels, normal(1/sqrt(width))
    token embeddings, zero biases, position and class embeddings, unit
    norm scales.  The stacked mapper kernels (W, in, out) take fan_in =
    in * W, as flax computes it for that shape."""
    for mod in mods.towers().values():
        for m in mod.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WordMLPs):
                for name, p in m.named_parameters():
                    if name.endswith("_kernel"):
                        _lecun_normal_(p, p.shape[0] * p.shape[1], generator)
                    elif name.startswith("ln") and name.endswith("_weight"):
                        p.fill_(1.0)
                    else:
                        p.zero_()
    for enc in (mods.text_encoder.text_model, mods.image_encoder.vision_model):
        emb = enc.embeddings
        emb.position_embedding.weight.zero_()
        if hasattr(emb, "token_embedding"):
            w = emb.token_embedding.weight
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        else:
            emb.class_embedding.zero_()
    return mods


def generate_one(mods: GuidanceModules, img: np.ndarray, ids: torch.Tensor,
                 uids: torch.Tensor, inj: torch.Tensor,
                 generator: torch.Generator, *, size: int = 512,
                 steps: int = 100, guidance_scale: float = 5.0,
                 latents: torch.Tensor | None = None) -> np.ndarray:
    """One degraded HWC float32 image in [0, 1] -> the generated reference
    as HWC uint8 (BGR, as imwrite takes it).  Raises if the decoded image
    is not finite (tensor2img would hide it)."""
    img = center_crop_square(img)
    out = generate_reference(
        mods, clip_view(img, mods.image_encoder.image_size, mods.device),
        ids, uids, inj, generator,
        latent_hw=(size // 8, size // 8), num_inference_steps=steps,
        guidance_scale=guidance_scale, latents=latents)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("generate_reference produced non-finite values")
    return tensor2img((out.float() + 1) / 2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--test_data_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--pretrained_params", default=None,
                    help="directory of reference-format tower state dicts: "
                         "{text_encoder,image_encoder,unet,vae,mapper,"
                         "clean_mapper}.pt")
    ap.add_argument("--tokenizer_path", default=None,
                    help="SD checkpoint tokenizer/ dir (vocab.json + "
                         "merges.txt); omitted -> documented known-id "
                         "fallback for the default template")
    ap.add_argument("--template", default=PROMPT_TEMPLATE)
    ap.add_argument("--placeholder_token", default="S")
    ap.add_argument("--num_words", type=int, default=20)
    ap.add_argument("--guidance_scale", type=float, default=5.0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--random_init", action="store_true",
                    help="seed-0 random tower weights: exercises the full "
                         "pipeline without converted checkpoints (outputs "
                         "are noise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a CUDA device")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if not (args.pretrained_params or args.random_init):
        raise SystemExit(
            "--pretrained_params is required (tower weights), or pass "
            "--random_init for a run on seeded random towers")

    with torch.device(device):
        mods = GuidanceModules.sd21_config(num_words=args.num_words)
    if args.pretrained_params:
        load_reference_towers(mods, args.pretrained_params)
    else:
        random_init(mods, torch.Generator(device).manual_seed(0))

    ids, uids, inj = tokenize_template(
        args.template, args.placeholder_token,
        tokenizer_path=args.tokenizer_path)
    ids = torch.from_numpy(ids).to(device)
    uids = torch.from_numpy(uids).to(device)
    inj = torch.tensor([inj], dtype=torch.int32, device=device)

    os.makedirs(args.output_dir, exist_ok=True)
    paths = scan_images(args.test_data_dir)
    gen = torch.Generator(device).manual_seed(args.seed)
    for i, path in enumerate(paths):
        out = generate_one(mods, imread_f32(path), ids, uids, inj, gen,
                           size=args.size, steps=args.steps,
                           guidance_scale=args.guidance_scale)
        name = os.path.splitext(os.path.basename(path))[0] + ".png"
        imwrite(out, os.path.join(args.output_dir, name))
        print(f"[{i + 1}/{len(paths)}] {name}")


if __name__ == "__main__":
    main()
