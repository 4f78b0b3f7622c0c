"""DiffIR text-embedding-conditioned restoration training CLI of the
PyTorch port.

    python -m textualdegremoval_tpu_torch.cli.train_diffir --opt <yml>
        [--max_iters N] [--device cuda|cpu]

Counterpart of textualdegremoval_tpu/cli/train_diffir.py (reference
DiffIRRefGuidedImageCleanModel, models/image_restoration_text_embed_diffir
_model.py:105-533, through the standard train script).
Each batch's lq, resized to the CLIP tower's 224 px view by JAX's
antialiased bilinear (`jax.image.resize`, `ops.resize.image_resize`) and
CLIP-normalised, goes through the frozen CLIP vision tower
(`network_clip`) and the frozen I2T mapper (`network_mapper`) to the
pseudo-word embedding, and net_g = NAFNetDynamicFusion(lq, embedding)
trains on the pixel loss; the embedding is computed without autograd, so
no gradient reaches the towers.  The towers load from
`path.pretrain_clip_vision` (an HF CLIPVisionModel state dict) and
`path.pretrain_mapper` (the I2T mapper artifact) with strict key matching
(`convert.load_reference_tower`); without a file, a tower keeps seeded
random weights (infrastructure runs).  net_g's `num_words` is the
mapper's unless `network_g` gives it, and then the two must agree.

The loop is JAX's: the dataset and loader, batches through
`DevicePrefetcher`, AdamW with the YAML's schedule and warmup, the
global-norm clip of 0.01 with `use_grad_clip`, the EMA, a log line and a
scalars.jsonl line every `logger.print_freq` iterations, a checkpoint
every `logger.save_checkpoint_freq`, and auto-resume from the latest
training state.  The device is CUDA unless `--device cpu` is asked for.
Float32 throughout, as in JAX.

Under a multi-process launch (torchrun, slurm; parallel/bootstrap.py)
the ranks train data-parallel as `train_restoration`'s do: each reads
its shard of the sampler and embeds its own batch through the frozen
towers, the step averages the gradients, the state starts as rank 0's,
and rank 0 alone writes the log, the scalars and the checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from textualdegremoval_tpu_torch.convert import (
    load_reference_checkpoint, load_reference_tower,
)
from textualdegremoval_tpu_torch.data.guidance import CLIP_MEAN, CLIP_STD
from textualdegremoval_tpu_torch.data.loader import (
    DevicePrefetcher, create_dataloader, create_dataset,
)
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.clip import CLIPVisionEncoder
from textualdegremoval_tpu_torch.models.mappers import I2TMapper
from textualdegremoval_tpu_torch.ops.resize import image_resize
from textualdegremoval_tpu_torch.parallel import init_distributed, replicate
from textualdegremoval_tpu_torch.parallel.bootstrap import rank_device
from textualdegremoval_tpu_torch.train.checkpoint import CheckpointManager
from textualdegremoval_tpu_torch.train.diffir_trainer import (
    make_diffir_train_step, make_embed_fn,
)
from textualdegremoval_tpu_torch.train.schedules import (
    build_schedule, warmup_wrap,
)
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state,
)
from textualdegremoval_tpu_torch.utils.logger import (
    MessageLogger, ScalarWriter, get_root_logger,
)
from textualdegremoval_tpu_torch.utils.options import parse


def clip_view(lq: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> the (B, size, size, 3) CLIP input: JAX's
    `jax.image.resize(lq, ..., 'bilinear')` (antialiased on a downscale),
    then the CLIP mean and std (reference F.interpolate + get_tensor_clip,
    feed_train_data :264)."""
    v = image_resize(lq, (lq.shape[0], size, size, lq.shape[3]), "bilinear")
    mean = torch.as_tensor(CLIP_MEAN, dtype=v.dtype, device=v.device)
    std = torch.as_tensor(CLIP_STD, dtype=v.dtype, device=v.device)
    return (v - mean) / std


def make_device_embed_fn(enc: CLIPVisionEncoder, mapper: I2TMapper):
    """lq (B, H, W, 3) in [0, 1] on the towers' device -> the frozen
    (B, num_words, D) embedding (JAX `make_device_embed_fn`)."""
    embed = make_embed_fn(enc, mapper)
    return lambda lq: embed(clip_view(lq, enc.image_size))


def build_towers(opt: dict, device, logger=None):
    """The frozen CLIPVisionEncoder(**network_clip) and
    I2TMapper(**network_mapper), seeded from manual_seed, loaded from
    path.pretrain_clip_vision / path.pretrain_mapper where they name
    files, on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(opt.get("manual_seed", 0))
        enc = CLIPVisionEncoder(**dict(opt.get("network_clip") or {}))
        mapper = I2TMapper(**dict(opt.get("network_mapper") or {}))
    for module, key, tower in ((enc, "pretrain_clip_vision", "image_encoder"),
                               (mapper, "pretrain_mapper", "mapper")):
        path = opt["path"].get(key)
        if path and os.path.exists(str(path)):
            load_reference_tower(module, torch.load(
                path, map_location="cpu", weights_only=True), tower)
            if logger is not None:
                logger.info(f"loaded {tower} from {path}")
    return enc.to(device), mapper.to(device)


def build_net(opt: dict, num_words: int) -> torch.nn.Module:
    """net_g through define_network in float32, seeded, its num_words the
    mapper's unless network_g gives it (then the two must agree)."""
    net_opt = dict(opt["network_g"])
    given = net_opt.setdefault("num_words", num_words)
    if given != num_words:
        raise ValueError(f"network_g.num_words is {given} and the mapper "
                         f"gives {num_words} words: they must agree")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(opt.get("manual_seed", 0))
        return define_network(net_opt, dtype=torch.float32)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True)
    ap.add_argument("--max_iters", type=int, default=None,
                    help="override total_iter (smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a CUDA device, the "
                         "CPU runs only when asked for")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    rank, world = init_distributed(args.device)
    device = rank_device(args.device, rank)

    opt = parse(args.opt, is_train=True)
    logger = get_root_logger(
        log_file=os.path.join(opt["path"]["log"], "train.log"))
    ds_opt = dict(opt["datasets"]["train"])
    train_loader = create_dataloader(create_dataset(ds_opt), ds_opt,
                                     num_replicas=world, rank=rank,
                                     device=device)

    enc, mapper = build_towers(opt, device, logger)
    embed_fn = make_device_embed_fn(enc, mapper)
    model = build_net(opt, mapper.num_words)
    load_path = opt["path"].get("pretrain_network_g")
    if load_path and os.path.exists(str(load_path)):
        load_reference_checkpoint(model, load_path)
        logger.info(f"loaded pretrained net_g from {load_path}")
    model.to(device)

    topt = opt["train"]
    lr = topt["optim_g"]["lr"]
    ema_decay = float(topt.get("ema_decay", 0) or 0)
    sched = warmup_wrap(build_schedule(lr, topt["scheduler"]),
                        topt.get("warmup_iter", -1), lr)
    opt_g = build_optimizer(
        model, sched,
        weight_decay=topt["optim_g"].get("weight_decay", 1e-4),
        betas=tuple(topt["optim_g"].get("betas", (0.9, 0.999))),
        grad_clip=0.01 if topt.get("use_grad_clip", True) else None)
    state = create_train_state(model, opt_g, ema_decay)
    step_fn = make_diffir_train_step(build_loss(topt["pixel_opt"]), ema_decay)

    ckpt = CheckpointManager(opt["path"]["training_states"],
                             opt["path"]["models"])
    if ckpt.restore_state(state) is not None:
        logger.info(f"auto-resumed from iter {state.step}")
    replicate(state)  # rank 0's state, built, loaded or resumed
    start_iter = current_iter = state.step

    total_iters = args.max_iters or int(topt["total_iter"])
    log_opt = opt.get("logger", {}) or {}
    writer = ScalarWriter(opt["path"]["log"], log_opt.get("wandb"),
                          bool(log_opt.get("use_tb_logger", False)))
    msg = MessageLogger(total_iters, start_iter, writer, logger)
    log_freq = int(log_opt.get("print_freq", 100))
    save_freq = int(log_opt.get("save_checkpoint_freq", 10 ** 9))

    epoch = 0
    t_iter = t_data = time.time()
    try:
        while current_iter < total_iters:
            train_loader.sampler.set_epoch(epoch)
            for batch in DevicePrefetcher(train_loader, device):
                if current_iter >= total_iters:
                    break
                current_iter += 1
                data_time = time.time() - t_data
                state, metrics = step_fn(state, {
                    "lq": batch["lq"], "gt": batch["gt"],
                    "embed": embed_fn(batch["lq"])})
                if current_iter % log_freq == 0:
                    now = time.time()
                    msg(epoch, current_iter, [sched(current_iter)],
                        {k: float(v) for k, v in metrics.items()},
                        now - t_iter, data_time)
                    t_iter = now
                if current_iter % save_freq == 0:
                    ckpt.save_state(state, current_iter)
                    ckpt.save_network(state, current_iter)
                t_data = time.time()
            epoch += 1
    finally:
        writer.close()

    if current_iter > start_iter:
        ckpt.save_state(state, current_iter)
        ckpt.save_network(state, current_iter)
    logger.info("training done")
    return state


if __name__ == "__main__":
    main()
