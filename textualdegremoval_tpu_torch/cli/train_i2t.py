"""I2T mapper training CLI (pipeline A, stage 1), and the loop both stages
share.

Counterpart of textualdegremoval_tpu/cli/train_i2t.py (the reference's
scripts/train/main_train_i2t_mapping.py): frozen CLIP/SD towers, the
trainable I2T mapper and the UNet's global K/V, the eps-MSE loss, gradient
accumulation (optax.MultiSteps' semantics), --scale_lr:

    python -m textualdegremoval_tpu_torch.cli.train_i2t \\
        --train_data_dir <images> --output_dir <out> \\
        (--pretrained_params <dir> | --random_init) \\
        [--mixed_precision bf16 --remat --num_words 20 --lr 1e-6 ...]

The device is CUDA unless --device asks otherwise (no fallback to the
CPU).  Under a multi-process launch (torchrun, slurm;
parallel/bootstrap.py) the ranks train data-parallel as the JAX CLI's
processes do: --scale_lr also multiplies by the world size, each rank's
dataset is seeded seed + rank and reads its shard of the sampler, the
trainables start as rank 0's, and the gradients are averaged over the
ranks at each update (at the accumulation boundary), so the ranks' copies
stay equal (JAX's guidance step has no collective and lets them drift
apart: ROADMAP C14).  Rank 0 alone logs and writes the trained parts and
the sample grids.

--pretrained_params names a directory of reference-format state
dicts (`convert.load_reference_towers`, as the generation CLI reads)
instead of the JAX CLI's orbax directory; --random_init draws the
generation CLI's seeded random towers.  --mixed_precision bf16 stores the
frozen towers in bf16 and keeps float32 trainables, as the JAX CLI does.
Every --save_steps micro-steps the trained parts are written in the
reference formats (`convert.save_trained_towers`: mapper.pt for I2T,
clean_mapper.pt for TR) under <output_dir>/<stage>_params_<step>/.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch.utils.data import DataLoader

from textualdegremoval_tpu_torch.cli.generate_reference import (
    PROMPT_TEMPLATE, random_init,
)
from textualdegremoval_tpu_torch.convert import (
    load_reference_towers, save_trained_towers,
)
from textualdegremoval_tpu_torch.data.guidance import (
    PairedLQHQDataset, UnpairedLQHQDataset, resize_bilinear,
)
from textualdegremoval_tpu_torch.data.loader import collate, seed_worker
from textualdegremoval_tpu_torch.data.sampler import EnlargedSampler
from textualdegremoval_tpu_torch.diffusion.pipeline import (
    GuidanceModules, generate_reference, make_guidance_optimizer,
    make_guidance_train_step, partition,
)
from textualdegremoval_tpu_torch.diffusion.tokenizer import tokenize_template
from textualdegremoval_tpu_torch.parallel import (
    barrier, broadcast_, init_distributed, is_main_process, world,
)
from textualdegremoval_tpu_torch.parallel.bootstrap import rank_device
from textualdegremoval_tpu_torch.utils.logger import get_root_logger


def parse_args(stage: str, argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog=f"textualdegremoval_tpu_torch.cli.train_{stage}",
        description=f"Pipeline A {stage.upper()} training: one process, "
                    "or data-parallel ranks under torchrun or slurm.")
    ap.add_argument("--train_data_dir", required=True)
    ap.add_argument("--train_data_dir_hq", default=None,
                    help="TR stage: clean targets paired with degraded "
                         "--train_data_dir inputs")
    ap.add_argument("--pretrained_params", default=None,
                    help="directory of reference-format tower state dicts: "
                         "{text_encoder,image_encoder,unet,vae,mapper,"
                         "clean_mapper}.pt")
    ap.add_argument("--random_init", action="store_true",
                    help="seed-0 random towers (the generation CLI's), for "
                         "exercising the path without converted weights")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_words", type=int, default=20)
    ap.add_argument("--learning_rate", type=float, default=1e-6)
    ap.add_argument("--scale_lr", action="store_true")
    ap.add_argument("--train_batch_size", type=int, default=4)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=4)
    ap.add_argument("--max_train_steps", type=int, default=200000)
    ap.add_argument("--save_steps", type=int, default=5000)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--tokenizer_path", default=None,
                    help="SD checkpoint tokenizer/ dir; omitted -> known-id "
                         "fallback for the default template")
    ap.add_argument("--template", default=PROMPT_TEMPLATE)
    ap.add_argument("--placeholder_token", default="S")
    ap.add_argument("--sigma_range", type=float, nargs=2, default=(5, 50),
                    help="TR denoise-synthesis sigma range (no HQ dir)")
    ap.add_argument("--mixed_precision", default="no",
                    choices=["no", "bf16"],
                    help="bf16: tower activations in bf16 and the frozen "
                         "towers' weights stored bf16, float32 trainables")
    ap.add_argument("--remat", action="store_true",
                    help="activation checkpointing of the UNet forward")
    ap.add_argument("--tiny_debug_towers", action="store_true",
                    help="GuidanceModules.small_test_config: infrastructure "
                         "smoke only (token ids folded into its vocabulary)")
    ap.add_argument("--validation_samples", action="store_true",
                    help="at each save, DDIM-sample a reference from the "
                         "first image of the batch and save input|sample")
    ap.add_argument("--validation_steps", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a CUDA device")
    args = ap.parse_args(argv)
    if not (args.pretrained_params or args.random_init):
        ap.error("--pretrained_params is required (tower weights), or pass "
                 "--random_init for a run on seeded random towers")
    return args


def build_towers(args, stage: str) -> GuidanceModules:
    """The towers on args.device with their weights; under bf16 mixed
    precision the frozen parameters are stored in bf16."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" \
        else torch.float32
    with torch.device(device):
        mods = (GuidanceModules.small_test_config(num_words=args.num_words)
                if args.tiny_debug_towers
                else GuidanceModules.sd21_config(num_words=args.num_words,
                                                 dtype=dtype))
    if args.pretrained_params:
        load_reference_towers(mods, args.pretrained_params)
    else:
        random_init(mods, torch.Generator(device).manual_seed(0))
    if dtype == torch.bfloat16:
        for _, p in partition(mods, stage)[1]:
            p.data = p.data.to(torch.bfloat16)
    return mods


def build_step(args, mods: GuidanceModules, stage: str):
    """(optimizer, step function, lr): JAX make_guidance_optimizer under
    MultiSteps(gradient_accumulation_steps), the reference's scale_lr."""
    lr = args.learning_rate
    if args.scale_lr:  # main_train_i2t_mapping.py:623-626
        lr *= args.gradient_accumulation_steps * args.train_batch_size \
            * world()
    opt = make_guidance_optimizer(
        mods, stage, lr=lr,
        accumulation_steps=args.gradient_accumulation_steps)
    return opt, make_guidance_train_step(mods, opt, stage,
                                         remat=args.remat), lr


def prompt_ids(args, mods: GuidanceModules):
    """(input_ids (1, S), uncond ids (1, S), placeholder index), folded
    into the tiny towers' vocabulary and positions where they are used."""
    ids, uids, inj = tokenize_template(args.template, args.placeholder_token,
                                       tokenizer_path=args.tokenizer_path)
    if args.tiny_debug_towers:
        emb = mods.text_encoder.text_model.embeddings
        vocab = emb.token_embedding.num_embeddings
        pos = emb.position_embedding.num_embeddings
        ids, uids = ((a[:, :pos] % vocab).astype(np.int32) for a in (ids,
                                                                       uids))
    return ids, uids, inj


def build_dataset(args, stage: str, inj_index: int, clip_size: int,
                  seed: int):
    if stage == "tr":
        task_roots = ({"paired": (args.train_data_dir, args.train_data_dir_hq)}
                      if args.train_data_dir_hq
                      else {"denoise": (None, args.train_data_dir)})
        return PairedLQHQDataset(task_roots, size=args.resolution,
                                 placeholder_index=inj_index,
                                 sigma_range=tuple(args.sigma_range),
                                 seed=seed, clip_size=clip_size)
    return UnpairedLQHQDataset(args.train_data_dir, size=args.resolution,
                               placeholder_index=inj_index, seed=seed,
                               clip_size=clip_size)


def device_batch(batch: dict, input_ids: np.ndarray, device) -> dict:
    """A collated batch of the guidance datasets -> the step's inputs on
    the device."""
    b = batch["pixel_values"].shape[0]
    return {
        "pixel_values": batch["pixel_values"].to(device),
        "pixel_values_clip": batch["pixel_values_clip"].to(device),
        "input_ids": torch.from_numpy(input_ids).to(device).repeat(b, 1),
        "inj_index": torch.tensor(batch["index"], dtype=torch.int32,
                                  device=device),
    }


def run(stage: str, argv=None) -> GuidanceModules:
    """Train `stage` ('i2t' or 'tr'); returns the trained towers."""
    args = parse_args(stage, argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    rank, n_ranks = init_distributed(args.device)
    args.device = str(rank_device(args.device, rank))
    logger = get_root_logger("textualdegremoval_tpu_torch.train_guidance")
    mods = build_towers(args, stage)
    device = mods.device
    broadcast_(p for _, p in partition(mods, stage)[0])  # rank 0's
    _, step_fn, lr = build_step(args, mods, stage)
    n_train = sum(p.numel() for _, p in partition(mods, stage)[0])
    logger.info(f"[{stage}] lr {lr:g}, {n_train} trainable parameters")

    input_ids, uncond_ids, inj_index = prompt_ids(args, mods)
    clip_size = mods.image_encoder.image_size
    dataset = build_dataset(args, stage, inj_index, clip_size,
                            args.seed + rank)
    sampler = EnlargedSampler(
        len(dataset), n_ranks, rank,
        max(1, -(-args.train_batch_size * n_ranks // max(len(dataset), 1))))
    loader = DataLoader(
        dataset, args.train_batch_size, sampler=sampler,
        num_workers=args.num_workers, collate_fn=collate, drop_last=True,
        pin_memory=device.type == "cuda", worker_init_fn=seed_worker,
        multiprocessing_context="spawn" if args.num_workers else None,
        persistent_workers=args.num_workers > 0)

    gen = torch.Generator(device).manual_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    step = epoch = 0
    while step < args.max_train_steps:
        sampler.set_epoch(epoch)
        for host_batch in loader:
            if step >= args.max_train_steps:
                break
            batch = device_batch(host_batch, input_ids, device)
            loss = step_fn(batch, gen)
            if step % 100 == 0:
                logger.info(f"[{stage}] step {step} loss {float(loss):.5f}")
            step += 1
            if step % args.save_steps == 0:
                barrier()
                if is_main_process():
                    out = os.path.join(args.output_dir,
                                       f"{stage}_params_{step}")
                    save_trained_towers(mods, stage, out)
                    if args.validation_samples:
                        save_sample_grid(mods, batch, uncond_ids, args,
                                         stage, step, gen)
                barrier()
        epoch += 1
    return mods


def save_sample_grid(mods, batch, uncond_ids, args, stage, step, gen):
    """Side-by-side (input | generated reference) JPG at save time (the
    reference's save_steps grids, main_train_i2t_mapping.py:763-774)."""
    from textualdegremoval_tpu_torch.utils.image import imwrite, tensor2img

    dev = mods.device
    img = generate_reference(
        mods, batch["pixel_values_clip"][:1], batch["input_ids"][:1],
        torch.from_numpy(uncond_ids).to(dev), batch["inj_index"][:1], gen,
        latent_hw=(args.resolution // 8, args.resolution // 8),
        num_inference_steps=args.validation_steps,
        use_clean_mapper=stage == "tr")
    inp = batch["pixel_values"][0].float()
    gen_img = img[0].float()
    if gen_img.shape != inp.shape:
        gen_img = resize_bilinear(gen_img, inp.shape[:2])
    grid = torch.cat([inp, gen_img], dim=1)
    imwrite(tensor2img((grid.cpu() + 1) / 2),
            os.path.join(args.output_dir, f"{stage}_sample_{step:06d}.jpg"))


def main(argv=None):
    return run("i2t", argv)


if __name__ == "__main__":
    main()
