"""Guided-restoration training CLI of the PyTorch port.

    python -m textualdegremoval_tpu_torch.cli.train_restoration --opt <yml>
        [--max_iters N] [--mixed_precision bf16] [--remat]
        [--fused auto|on|off [--gdfn_kernel]] [--device cuda|cpu]

Counterpart of textualdegremoval_tpu/cli/train_restoration.py (reference
scripts/train/main_train_restoration_with_ref_input.py).
The loop (reference :225-303): the progressive (gt_size, batch) schedule of
the YAML `iters` / `gt_sizes` / `mini_batch_sizes`, a random sub-batch and
sub-crop per step, the reference crop, optional mixup, one call of the
step function (`train.trainer.make_train_step`; a structurally frozen step
while the masa group is frozen), logging, the lq|gt|pred|ref strip every
`logger.check_freq` iterations, checkpoints, validation and auto-resume
from the latest state.

The reference crop: where `path.pretrain_dino` names a file, the DINOv2
matcher (`models.dino.select_ref_crop` on the frozen float32 ViT of that
file, loaded in the reference layout, on the training device) picks the
reference
window most like each lq crop; it embeds 3-channel crops, so a network of
other input channels (the gray denoise and dual-pixel YAMLs) is refused
before the first step.  Without the file, the centre crop, as in JAX.

The device is CUDA unless `--device cpu` is asked for.  On CUDA every
TransformerBlock runs as the hand-written whole-block kernels, forward and
backward, unless `--fused off` (or a YAML `train.fused_kernels: off`, or
`network_g.fused: false`, as in JAX) puts it on the module path: the
blocks op by op through autograd, cuDNN's convs, and with `--gdfn_kernel`
the GDFN as its kernel (csrc/gdfn.cu, whose backward recomputes through
the plain GDFN).  `--remat` sets only the whole-block kernels' memory-lean
backward (bwd_mode='remat'); module-path blocks save their activations
for autograd with or without it, as every block without a kernel
backward does.  `--mdta_kernel` is refused: the MDTA statistics kernel
is forward only, as is JAX's.

Several processes train one model data-parallel where the environment
describes a multi-process launch (`torchrun --nproc_per_node N -m
textualdegremoval_tpu_torch.cli.train_restoration --opt ...`, or slurm;
parallel/bootstrap.py): each rank reads its shard of the sampler, takes
`batch_size_per_gpu` items a step, starts from rank 0's state
(`parallel.mesh.replicate`) and averages its gradients with the others'
in the step; the crop and mixup generators keep the same seeds on every
rank, as in JAX.  Rank 0 alone writes train.log, the strips, the
checkpoints (every rank takes part in the call) and runs validation.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from textualdegremoval_tpu_torch.cli.evaluate import last_output
from textualdegremoval_tpu_torch.convert import load_reference_checkpoint
from textualdegremoval_tpu_torch.data.loader import (
    create_dataloader, create_dataset,
)
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.metrics import calculate_psnr, calculate_ssim
from textualdegremoval_tpu_torch.models import (
    TBLOCK_NETWORKS, define_network,
)
from textualdegremoval_tpu_torch.models.dino import (
    load_dino, select_ref_crop,
)
from textualdegremoval_tpu_torch.ops.resize import bilinear_resize_torch
from textualdegremoval_tpu_torch.parallel import (
    init_distributed, is_main_process, replicate,
)
from textualdegremoval_tpu_torch.parallel.bootstrap import rank_device
from textualdegremoval_tpu_torch.train.checkpoint import CheckpointManager
from textualdegremoval_tpu_torch.train.mixing import mixing_augment
from textualdegremoval_tpu_torch.train.schedules import (
    build_schedule, warmup_wrap,
)
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state, make_eval_step, make_train_step,
)
from textualdegremoval_tpu_torch.utils.image import imwrite, tensor2img
from textualdegremoval_tpu_torch.utils.logger import get_root_logger
from textualdegremoval_tpu_torch.utils.options import parse


def progressive_buckets(ds_opt):
    """(cumulative iters, gt_sizes, batches) of the YAML progressive
    schedule (reference :240-271)."""
    iters = ds_opt.get("iters", [10 ** 9])
    gt_sizes = ds_opt.get("gt_sizes", [ds_opt.get("gt_size", 128)])
    batches = ds_opt.get("mini_batch_sizes",
                         [ds_opt.get("batch_size_per_gpu", 1)])
    return np.cumsum(iters), gt_sizes, batches


def pick_bucket(current_iter, groups, gt_sizes, batches):
    j = min(int(np.searchsorted(groups, current_iter, side="left")),
            len(gt_sizes) - 1)
    return gt_sizes[j], batches[min(j, len(batches) - 1)]


def crop_batch(batch, gt_size, mini_batch, rng):
    """Random sub-batch and random sub-crop to the bucket's shape (numpy
    arrays or tensors, batch first)."""
    full = batch["lq"].shape[0]
    idx = rng.choice(full, size=min(mini_batch, full), replace=False)
    h, w = batch["lq"].shape[1:3]
    top = rng.integers(0, max(h - gt_size, 0) + 1)
    left = rng.integers(0, max(w - gt_size, 0) + 1)
    out = dict(batch)
    for k in ("lq", "gt"):
        out[k] = batch[k][idx, top: top + gt_size, left: left + gt_size]
    out["ref"] = batch["ref"][idx]
    return out


def center_crop_ref(ref, gt_size):
    """The JAX CLI's reference crop without the DINO matcher: the centre
    gt_size x gt_size window (:286-292)."""
    rh, rw = ref.shape[1:3]
    top, left = max((rh - gt_size) // 2, 0), max((rw - gt_size) // 2, 0)
    return ref[:, top: top + gt_size, left: left + gt_size]


def build_matcher(opt, device):
    """The frozen float32 DINOv2 of `path.pretrain_dino` on `device` (the
    ViT its shapes describe: vit_base for dinov2_vitb14.pth, as the JAX CLI
    builds), or None where the option names no file (the centre crop).
    Raises ValueError where the network's lq is not 3-channel: the matcher
    embeds lq crops with DINO's 3-channel patch embedding."""
    path = opt["path"].get("pretrain_dino")
    if not path or not os.path.exists(str(path)):
        return None
    net = opt["network_g"]
    in_ch = net.get("inp_channels", net.get("img_channel", 3))
    if in_ch != 3:
        raise ValueError(
            f"path.pretrain_dino: the DINO matcher embeds 3-channel crops, "
            f"and {net['type']} here takes {in_ch}-channel lq; unset "
            "path.pretrain_dino to train with the centre crop")
    return load_dino(str(path), device=device)


def dump_lher(state, batch, opt, current_iter):
    """The lq|gt|pred|ref strip of the step's first image (reference
    image_restoration_ref_model.py:258-266, JAX `_dump_lher`) into
    path.visualization/<iter>.png; a 6-channel dual-pixel lq shows its
    left view, a reference of another height is resized to lq's."""
    pred = last_output(make_eval_step(use_ema=False)(
        state, {"lq": batch["lq"][:1], "ref": batch["ref"][:1]}))
    lq = batch["lq"][:1]
    if lq.shape[-1] == 6:
        lq = lq[..., :3]
    ref = batch["ref"][:1].float()
    h = lq.shape[1]
    if ref.shape[1] != h:
        ref = bilinear_resize_torch(ref, h, int(ref.shape[2] * h /
                                                ref.shape[1]))
    strip = np.concatenate([tensor2img(v) for v in (
        lq, batch["gt"][:1], pred, ref)], axis=1)
    imwrite(strip, os.path.join(opt["path"]["visualization"],
                                f"{current_iter:06d}.png"))


def resolve_network(opt, mixed_precision=None, remat=None, fused=None,
                    gdfn_kernel=False):
    """Build the network with CLI flag > YAML `train:` key > default (JAX
    `resolve_network`): train.mixed_precision fp32|bf16 (compute dtype;
    parameters stay f32), train.remat (the whole-block kernels'
    memory-lean bwd_mode='remat': the backward recomputes x1 and the
    statistics with the forward kernel), train.fused_kernels auto|on|off
    (a bool too; off sets network_g.fused false: module-path blocks).
    gdfn_kernel: the module path's GDFN as its kernel, which needs the
    module path.  A network_g.mdta_pallas is refused: that kernel is
    forward only.  Returns (model, remat, dtype)."""
    topt = opt.get("train", {}) or {}
    mp = mixed_precision or topt.get("mixed_precision", "fp32")
    if remat is None:
        remat = bool(topt.get("remat", False))
    fused_cfg = fused if fused is not None else topt.get("fused_kernels",
                                                         "auto")
    dtype = torch.bfloat16 if str(mp) == "bf16" else torch.float32
    net_opt = dict(opt["network_g"])
    if isinstance(fused_cfg, bool):
        net_opt.setdefault("fused", fused_cfg)
    elif fused_cfg in ("on", "off"):
        net_opt.setdefault("fused", fused_cfg == "on")
    elif fused_cfg != "auto":
        raise ValueError(f"train.fused_kernels: unknown value {fused_cfg!r}")
    if net_opt.get("mdta_pallas"):
        raise ValueError("mdta_pallas: the MDTA statistics kernel is forward "
                         "only (as is JAX's); it cannot train")
    if gdfn_kernel:
        if net_opt.get("fused", True) or net_opt["type"] not in \
                TBLOCK_NETWORKS:
            raise ValueError("--gdfn_kernel picks the GDFN kernel of the "
                             "module path; it needs --fused off and a "
                             "network of TransformerBlocks")
        net_opt["gdfn_fused"] = True
    if remat:
        net_opt.setdefault("bwd_mode", "remat")
    return define_network(net_opt, dtype=dtype), remat, dtype


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True)
    ap.add_argument("--max_iters", type=int, default=None,
                    help="override total_iter (smoke runs)")
    ap.add_argument("--mixed_precision", choices=["fp32", "bf16"],
                    default=None, help="override train.mixed_precision")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=None, help="override train.remat")
    ap.add_argument("--fused", choices=["auto", "on", "off"], default=None,
                    help="whole-block kernels (on, auto) or module-path "
                         "blocks (off); override train.fused_kernels")
    ap.add_argument("--gdfn_kernel", action="store_true",
                    help="with --fused off: the GDFN as its kernel")
    ap.add_argument("--mdta_kernel", action="store_true",
                    help="refused: the MDTA statistics kernel is forward "
                         "only")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a CUDA device, the "
                         "CPU runs only when asked for")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.mdta_kernel:
        raise SystemExit("--mdta_kernel: the MDTA statistics kernel is "
                         "forward only (as is JAX's); it cannot train")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    rank, world = init_distributed(args.device)
    device = rank_device(args.device, rank)

    opt = parse(args.opt, is_train=True)
    logger = get_root_logger("textualdegremoval_tpu_torch.train",
                             log_file=os.path.join(opt["path"]["log"],
                                                   "train.log"))
    seed = opt.get("manual_seed", 0)
    ds_opt = dict(opt["datasets"]["train"])
    train_loader = create_dataloader(create_dataset(ds_opt), ds_opt,
                                     num_replicas=world, rank=rank,
                                     device=device)
    val_loader = None
    if "val" in opt.get("datasets", {}) and is_main_process():
        try:
            val_loader = create_dataloader(
                create_dataset(opt["datasets"]["val"]), opt["datasets"]["val"],
                device=device)
        except (FileNotFoundError, ValueError, KeyError) as e:
            logger.warning(f"no val data: {e}")  # optional in smoke runs

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, remat, dtype = resolve_network(
            opt, args.mixed_precision, args.remat, args.fused,
            args.gdfn_kernel)
    logger.info(f"device {device}, compute dtype {dtype}, remat {remat}, "
                f"rank {rank} of {world}")

    topt = opt["train"]
    ema_decay = float(topt.get("ema_decay", 0) or 0)
    ema_params = None
    load_path = opt["path"].get("pretrain_network_g")
    if load_path and os.path.exists(str(load_path)):
        load_reference_checkpoint(model, load_path)
        logger.info(f"loaded pretrained params from {load_path}")
        if ema_decay > 0:
            ck = torch.load(load_path, map_location="cpu", weights_only=True)
            ema_params = ck.get("params_ema") if isinstance(ck, dict) else None
    dino = build_matcher(opt, device)
    if dino is not None:
        logger.info(f"DINO matcher loaded from {opt['path']['pretrain_dino']}")
    model.to(device)

    lr = topt["optim_g"]["lr"]
    ref_lr = topt["optim_g"].get("ref_lr", lr)
    warm = topt.get("warmup_iter", -1)
    sched = warmup_wrap(build_schedule(lr, topt["scheduler"]), warm, lr)
    ref_sched = warmup_wrap(build_schedule(ref_lr, topt["scheduler"]), warm,
                            ref_lr)
    fix_iters = int(topt.get("param_fix_iterations", 0) or 0)
    opt_g = build_optimizer(
        model, sched, ref_sched,
        weight_decay=topt["optim_g"].get("weight_decay", 1e-4),
        betas=tuple(topt["optim_g"].get("betas", (0.9, 0.999))),
        grad_clip=0.01 if topt.get("use_grad_clip", True) else None,
        param_fix_iterations=fix_iters)
    state = create_train_state(model, opt_g, ema_decay, ema_params)
    loss_fn = build_loss(topt["pixel_opt"])
    step_fn = make_train_step(loss_fn, ema_decay)
    # while the masa group is frozen, a step that prunes its backward
    frozen_step_fn = (make_train_step(loss_fn, ema_decay, masa_frozen=True)
                      if fix_iters > 0 else None)

    ckpt = CheckpointManager(opt["path"]["training_states"],
                             opt["path"]["models"])
    if ckpt.restore_state(state) is not None:
        logger.info(f"auto-resumed from iter {state.step}")
    replicate(state)  # rank 0's state, built, loaded or resumed
    start_iter = current_iter = state.step

    total_iters = args.max_iters or int(topt["total_iter"])
    groups, gt_sizes, batches = progressive_buckets(ds_opt)
    rng = np.random.default_rng(seed)
    mix_gen = torch.Generator().manual_seed(seed + 1)
    mixing_cfg = topt.get("mixing_augs") or {}
    log_freq = int(opt.get("logger", {}).get("print_freq", 100))
    save_freq = int(opt.get("logger", {}).get("save_checkpoint_freq", 5000))
    val_freq = int(opt.get("val", {}).get("val_freq", 5000))
    check_freq = int(opt.get("logger", {}).get("check_freq", 0) or 0)

    epoch = 0
    t_data = t_iter = time.time()
    while current_iter < total_iters:
        train_loader.sampler.set_epoch(epoch)
        for batch in train_loader:
            if current_iter >= total_iters:
                break
            current_iter += 1
            gt_size, mini = pick_bucket(current_iter, groups, gt_sizes,
                                        batches)
            batch = crop_batch(batch, gt_size, mini, rng)
            gt, lq = batch["gt"], batch["lq"]
            if dino is not None:  # on the crop before mixup, as in JAX
                ref = select_ref_crop(dino, lq.to(device, non_blocking=True),
                                      batch["ref"].to(device,
                                                      non_blocking=True))
            else:
                ref = center_crop_ref(batch["ref"], gt_size).to(
                    device, non_blocking=True)
            if mixing_cfg.get("mixup"):
                gt, lq = mixing_augment(mix_gen, gt, lq,
                                        mixing_cfg.get("mixup_beta", 1.2),
                                        mixing_cfg.get("use_identity", True))
            step_batch = {"lq": lq.to(device, non_blocking=True),
                          "gt": gt.to(device, non_blocking=True), "ref": ref}
            data_time = time.time() - t_data
            fn = (frozen_step_fn if frozen_step_fn is not None
                  and current_iter < fix_iters else step_fn)
            state, metrics = fn(state, step_batch)
            if check_freq and current_iter % check_freq == 0 \
                    and is_main_process():
                dump_lher(state, step_batch, opt, current_iter)
            if current_iter % log_freq == 0:
                lrs = opt_g.lrs(current_iter)
                logger.info(
                    f"[epoch {epoch} iter {current_iter}] lr ({lrs[0]:.3e}, "
                    f"{lrs[1]:.3e}) " + " ".join(
                        f"{k} {float(v):.4e}" for k, v in metrics.items())
                    + f" time {time.time() - t_iter:.3f}s data "
                    f"{data_time:.3f}s")
            if current_iter % save_freq == 0:
                ckpt.save_state(state, current_iter)
                ckpt.save_network(state, current_iter)
            if val_loader is not None and current_iter % val_freq == 0:
                validate(state, val_loader, opt, logger, current_iter,
                         use_ema=ema_decay > 0, device=device)
            t_data = t_iter = time.time()
        epoch += 1

    if current_iter > start_iter:
        ckpt.save_state(state, current_iter)
        ckpt.save_network(state, current_iter)
    logger.info("training done")
    return state


def validate(state, val_loader, opt, logger, current_iter, use_ema=False,
             device="cuda"):
    """Whole-image validation (reference image_restoration_ref_model.py:
    286-298, 325-409): the whole val set unless val.max_minibatch caps it;
    with val.window_size, the pad test (lq reflect-padded right/bottom to a
    multiple of it, the output cropped back); the EMA network when EMA is
    on.  Returns (mean PSNR, mean SSIM) or None."""
    eval_step = make_eval_step(use_ema=use_ema)
    val_opt = opt.get("val", {}) or {}
    max_n = val_opt.get("max_minibatch")
    window = int(val_opt.get("window_size", 0) or 0)
    scale = int(opt.get("scale", 1))
    psnrs, ssims = [], []
    for i, batch in enumerate(val_loader):
        if max_n is not None and i >= int(max_n):
            break
        lq = batch["lq"].numpy()
        pad_h = pad_w = 0
        if window:
            pad_h, pad_w = -lq.shape[1] % window, -lq.shape[2] % window
            if pad_h or pad_w:
                lq = np.pad(lq, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                            "reflect")
        out = last_output(eval_step(state, {
            "lq": torch.from_numpy(lq).to(device),
            "ref": batch["ref"].to(device)}))
        out = out.float().cpu().numpy()
        out = out[:, : out.shape[1] - pad_h * scale,
                  : out.shape[2] - pad_w * scale]
        pred = np.clip(out[0], 0, 1)
        gt = batch["gt"][0].numpy()
        psnrs.append(calculate_psnr(pred * 255, gt * 255))
        ssims.append(calculate_ssim(pred * 255, gt * 255))
    if not psnrs:
        return None
    logger.info(f"val @ {current_iter}: psnr {np.mean(psnrs):.4f} ssim "
                f"{np.mean(ssims):.4f} ({len(psnrs)} images"
                f"{', ema' if use_ema else ''})")
    return float(np.mean(psnrs)), float(np.mean(ssims))


if __name__ == "__main__":
    main()
