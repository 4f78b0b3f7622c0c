"""Evaluation CLI of the port: per-task network table and PSNR/SSIM loop.

Counterpart of textualdegremoval_tpu/cli/evaluate.py for the Restormer,
NAFNet, PromptIR, DRSformer and SFNet families:

    python -m textualdegremoval_tpu_torch.cli.evaluate \\
        --task restormer_deblur --hqroot ... --refroot ... --lqroot ... \\
        --checkpoint_path net_g.pth [--dtype bfloat16] [--device cuda] \\
        [--chain | --module_blocks [--gdfn_kernel] [--mdta_kernel]]

    torchrun --nproc_per_node N -m textualdegremoval_tpu_torch.cli.evaluate \\
        --task restormer_deblur|nafnet_deblur|drsformer_derain|... ... \\
        --spatial_shard N

--spatial_shard N > 1 splits each image by rows over N torch.distributed
ranks (the JAX CLI's N-device `sp` mesh; 0 and 1 run unsharded), for a
whole image larger than one card holds: lq is reflect-padded on H to a
multiple of N, as in JAX, then zero-padded to the network's row unit and
cut into slabs of whole units, one a rank (`parallel.spatial.RowShard`);
every rank reads the same images and holds the weights and the whole
reference; the prediction is gathered on rank 0, cropped back to the
image's height and scored there (SFNet's finest scale), and rank 0 alone
prints.  Fewer or more ranks than N refuse.  It serves every network of
the table: the RestormerRefFusion, NAFNetRefFusion and PromptIRRefFusion
tasks on the whole-block route (B1 and B5 with their statistics summed
over the ranks), DRSformerRefFusion (TKSA's gram summed before its top-k
masks) and SFNetRefFusion (its TLC box pools, PatchAP and InstanceNorm
over the whole image, BatchNorm on its loaded buffers); --chain and
--module_blocks refuse it.

--chain runs every Restormer stage of two or more blocks as the
cross-block chain kernel (the JAX CLI's TDR_FUSED_TBLOCK_CHAIN=1); it is
off by default, as there.  --module_blocks runs every TransformerBlock on
the module path (the JAX CLI's TDR_FUSED_TBLOCK=0), op by op, and on that
path --gdfn_kernel takes the GDFN kernel (TDR_FUSED_GDFN=1) and
--mdta_kernel the MDTA statistics kernel (JAX
MDTAAttention(use_pallas=True)).  The route is picked by these options,
never by the environment.

Denoise tasks synthesise the noise with the JAX CLI's deterministic
protocol (np.random.RandomState(0), sigma/255 on HQ); paired tasks read lq
from --lqroot.  PSNR/SSIM with crop_border=0.  Without a checkpoint the
weights are the module initialisation under seed 0.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from textualdegremoval_tpu_torch.convert import load_reference_checkpoint
from textualdegremoval_tpu_torch.data import imread_f32, scan_images
from textualdegremoval_tpu_torch.metrics import calculate_psnr, calculate_ssim
from textualdegremoval_tpu_torch.models import (
    TBLOCK_NETWORKS, define_network,
)
from textualdegremoval_tpu_torch.parallel import (
    RowShard, gather_rows, init_distributed,
)

# the networks whose forward takes a row shard (--spatial_shard)
SHARDED_NETWORKS = ("RestormerRefFusion", "NAFNetRefFusion",
                    "PromptIRRefFusion", "DRSformerRefFusion",
                    "DRSformer200L_SPA_RefFusion", "SFNetRefFusion")

# The JAX CLI's table (same hparams).
TASK_TABLE = {
    # tiny config for CI smoke runs
    "tiny_smoke": {
        "type": "RestormerRefFusion", "dim": 8, "num_blocks": [1, 1, 1, 1],
        "num_refinement_blocks": 1, "heads": [1, 1, 2, 2], "bias": False,
        "LayerNorm_type": "WithBias", "nf": 8, "ext_n_blocks": [1, 1, 1, 1],
        "reffusion_n_blocks": [1, 1, 1, 1], "lr_block_size": 4,
    },
    "restormer_color_denoise": {
        "type": "RestormerRefFusion", "dim": 48, "num_blocks": [4, 6, 6, 8],
        "num_refinement_blocks": 4, "heads": [1, 2, 4, 8],
        "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "BiasFree", "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "lr_block_size": 8,
    },
    "restormer_gray_denoise": {
        "type": "RestormerRefFusion", "inp_channels": 1, "out_channels": 1,
        "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
        "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "BiasFree", "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "lr_block_size": 8,
    },
    "restormer_deblur": {
        "type": "RestormerRefFusion", "dim": 48, "num_blocks": [4, 6, 6, 8],
        "num_refinement_blocks": 4, "heads": [1, 2, 4, 8],
        "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "WithBias", "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "lr_block_size": 8,
    },
    "nafnet_deblur": {
        "type": "NAFNetRefFusion", "width": 64, "middle_blk_num": 1,
        "enc_blk_nums": [1, 1, 1, 28], "dec_blk_nums": [1, 1, 1, 1],
        "nf": 64, "ext_n_blocks": [4, 4, 4, 4],
        "reffusion_n_blocks": [2, 2, 2, 2], "lr_block_size": 8,
    },
    "drsformer_derain": {
        "type": "DRSformerRefFusion", "dim": 48, "num_blocks": [4, 6, 6, 8],
        "heads": [1, 2, 4, 8], "nf": 48, "ext_n_blocks": [4, 4, 4, 4],
        "reffusion_n_blocks": [2, 2, 2, 2], "lr_block_size": 8,
        "use_mefc": True,
    },
    "drsformer_derain_200l_spa": {
        "type": "DRSformer200L_SPA_RefFusion", "dim": 48,
        "num_blocks": [4, 6, 6, 8], "heads": [1, 2, 4, 8], "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "lr_block_size": 8, "use_mefc": False,
    },
    "sfnet_dehaze_indoor": {
        "type": "SFNetRefFusion", "num_res": 16, "nf": 32,
        "ext_n_blocks": [4, 4, 4], "reffusion_n_blocks": [1, 1, 1],
        "lr_block_size": 8, "tlc_base": 246,
    },
    "sfnet_dehaze_outdoor": {
        "type": "SFNetRefFusion", "num_res": 16, "nf": 32,
        "ext_n_blocks": [4, 4, 4], "reffusion_n_blocks": [1, 1, 1],
        "lr_block_size": 8, "tlc_base": 210,
    },
    "promptir_all_in_one": {
        "type": "PromptIRRefFusion", "dim": 48, "num_blocks": [4, 6, 6, 8],
        "num_refinement_blocks": 4, "heads": [1, 2, 4, 8], "decoder": True,
        "nf": 48, "ext_n_blocks": [4, 4, 4, 4],
        "reffusion_n_blocks": [2, 2, 2, 2], "lr_block_size": 8,
    },
    # dual-pixel defocus deblur: 6-channel lqL+lqR 16-bit input
    "restormer_dual_pixel_defocus": {
        "type": "RestormerRefFusion", "inp_channels": 6, "out_channels": 3,
        "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
        "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "WithBias", "dual_pixel_task": True, "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "lr_block_size": 8,
    },
}

# keys rewritten by --tiny_debug: same constructor path (TLC bases, MEFC
# flags, batch_stats) at toy widths
_SHRINK_SCALARS = {"dim": 8, "nf": 8, "width": 8, "num_res": 1,
                   "middle_blk_num": 1, "num_refinement_blocks": 1,
                   "lr_block_size": 4}
_SHRINK_LISTS = ("num_blocks", "enc_blk_nums", "dec_blk_nums",
                 "ext_n_blocks", "reffusion_n_blocks")


def shrink_for_smoke(opt: dict) -> dict:
    o = dict(opt)
    for k, v in _SHRINK_SCALARS.items():
        if k in o:
            o[k] = v
    for k in _SHRINK_LISTS:
        if k in o:
            o[k] = [1] * len(o[k])
    if "heads" in o:
        o["heads"] = [1, 1, 2, 2][: len(o["heads"])]
    if o["type"] == "SFNetRefFusion":
        o["base_channel"] = 8
    return o


def last_output(out):
    """The finest output of a network of several (SFNet's list, coarse to
    fine; JAX `_last`), or the output itself."""
    return out[-1] if isinstance(out, (list, tuple)) else out


def restore_and_score(model: torch.nn.Module, lq: np.ndarray, hq: np.ndarray,
                      ref: np.ndarray):
    """Restore one (lq, ref) pair of HWC float32 arrays in [0, 1] and score
    it against hq (a network of several outputs: `last_output`).  Returns
    (prediction clipped to [0, 1], PSNR, SSIM)."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.from_numpy(lq)[None].to(dev),
                    torch.from_numpy(ref)[None].to(dev))
    pred = np.clip(last_output(out)[0].float().cpu().numpy(), 0, 1)
    return (pred, calculate_psnr(pred * 255, hq * 255),
            calculate_ssim(pred * 255, hq * 255))


def restore_sharded(model: torch.nn.Module, lq: np.ndarray, ref: np.ndarray,
                    rank: int, world: int):
    """The prediction of one (lq, ref) pair of HWC float32 arrays by a
    forward split by rows over `world` ranks (this one `rank`): lq
    reflect-padded on H to a multiple of world (JAX's --spatial_shard pad),
    this rank's slab of it through the network, the rows gathered on rank
    0 (a network of several outputs: `last_output`) and cropped back to
    lq's height.  Rank 0: the float32 prediction clipped to [0, 1]; the
    other ranks: None."""
    dev = next(model.parameters()).device
    orig_h = lq.shape[0]
    pad_h = (-orig_h) % world
    if pad_h:
        lq = np.pad(lq, ((0, pad_h), (0, 0), (0, 0)), "reflect")
    shard = RowShard.split(lq.shape[0], model.row_unit, rank, world)
    with torch.inference_mode():
        slab = shard.slab(torch.from_numpy(lq)[None].to(dev))
        out = model(slab, torch.from_numpy(ref)[None].to(dev), shard=shard)
        whole = gather_rows(last_output(out), shard)
    if whole is None:
        return None
    return np.clip(whole[0, :orig_h].float().cpu().numpy(), 0, 1)


def shard_ranks(network: str, args) -> tuple[int, int]:
    """(rank, world) of a --spatial_shard N > 1 run, after joining the
    process group; raises SystemExit where the network, a route option or
    the number of ranks would not serve it (JAX's device check, devices
    read as ranks)."""
    n = args.spatial_shard
    if network not in SHARDED_NETWORKS:
        raise SystemExit(f"--spatial_shard {n}: {network} has no row-sharded "
                         f"forward (served: {', '.join(SHARDED_NETWORKS)})")
    asked = [f"--{k}" for k in ("chain", "module_blocks", "gdfn_kernel",
                                "mdta_kernel") if getattr(args, k)]
    if asked:
        raise SystemExit(f"--spatial_shard {n}: {network} runs its whole-"
                         f"block route block by block; it excludes "
                         f"{' '.join(asked)}")
    rank, world = init_distributed(args.device)
    if world != n:
        raise SystemExit(f"--spatial_shard {n} needs {n} ranks, have "
                         f"{world}")
    return rank, world


def route_options(network: str, args) -> dict:
    """The network_g routing keys that --chain, --module_blocks,
    --gdfn_kernel and --mdta_kernel ask for; raises SystemExit on a
    combination that would leave an option unused."""
    asked = [f"--{k}" for k in ("chain", "module_blocks", "gdfn_kernel",
                                "mdta_kernel") if getattr(args, k)]
    if not asked:
        return {}
    if network not in TBLOCK_NETWORKS:
        raise SystemExit(f"{' '.join(asked)}: {network} has no Restormer "
                         "stages")
    if args.chain and len(asked) > 1:
        raise SystemExit(f"--chain runs the whole-block kernels; it "
                         f"excludes {' '.join(asked[1:])}")
    if (args.gdfn_kernel or args.mdta_kernel) and not args.module_blocks:
        raise SystemExit("--gdfn_kernel and --mdta_kernel pick kernels of "
                         "the module path; they need --module_blocks")
    if args.chain:
        return {"chain": True}
    return {"fused": False, "gdfn_fused": args.gdfn_kernel,
            "mdta_pallas": args.mdta_kernel}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=sorted(TASK_TABLE))
    ap.add_argument("--hqroot", required=True)
    ap.add_argument("--refroot", required=True)
    ap.add_argument("--lqroot", default=None)
    ap.add_argument("--lqlroot", default=None,
                    help="dual-pixel tasks: left-view 16-bit inputs")
    ap.add_argument("--lqrroot", default=None,
                    help="dual-pixel tasks: right-view 16-bit inputs")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--sigma", type=float, default=15)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bfloat16 runs the kernel's tensor-core products; "
                         "float32 (the JAX CLI's default) runs its f32 FMA "
                         "loops, several times slower on CUDA")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a CUDA device")
    ap.add_argument("--tiny_debug", action="store_true",
                    help="shrink the task's network to toy widths")
    ap.add_argument("--chain", action="store_true",
                    help="run every Restormer stage of two or more blocks "
                         "as the cross-block chain kernel")
    ap.add_argument("--module_blocks", action="store_true",
                    help="run every TransformerBlock on the module path, "
                         "op by op, instead of the whole-block kernel")
    ap.add_argument("--gdfn_kernel", action="store_true",
                    help="with --module_blocks: the GDFN as its kernel")
    ap.add_argument("--mdta_kernel", action="store_true",
                    help="with --module_blocks: the MDTA statistics as "
                         "their kernel")
    ap.add_argument("--spatial_shard", type=int, default=0,
                    help="split each image by rows over N torch.distributed "
                         "ranks (a whole image larger than one card "
                         "holds); 0 or 1 = off")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    opt = dict(TASK_TABLE[args.task])
    if args.tiny_debug:
        opt = shrink_for_smoke(opt)
    rank, world = 0, 1
    if args.spatial_shard > 1:
        rank, world = shard_ranks(opt["type"], args)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    opt.update(route_options(opt["type"], args))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = define_network(opt, dtype=getattr(torch, args.dtype))
    if args.checkpoint_path and os.path.exists(args.checkpoint_path):
        load_reference_checkpoint(model, args.checkpoint_path)
    model = model.to(device)

    hq_paths = scan_images(args.hqroot)
    ref_paths = scan_images(args.refroot)
    lq_paths = (scan_images(args.lqroot) if args.lqroot
                else [None] * len(hq_paths))
    if args.max_images:
        hq_paths = hq_paths[: args.max_images]
    gray = opt.get("inp_channels", 3) == 1
    dual_pixel = bool(opt.get("dual_pixel_task"))
    lql_paths = scan_images(args.lqlroot) if args.lqlroot else None
    lqr_paths = scan_images(args.lqrroot) if args.lqrroot else None

    psnrs, ssims = [], []
    for i, hq_path in enumerate(hq_paths):
        hq = imread_f32(hq_path, bit16=dual_pixel)
        ref = imread_f32(ref_paths[min(i, len(ref_paths) - 1)])
        if gray:
            import cv2

            hq = cv2.cvtColor(hq, cv2.COLOR_RGB2GRAY)[..., None]
            ref = cv2.cvtColor(ref, cv2.COLOR_RGB2GRAY)[..., None]
        if dual_pixel:
            lq = np.concatenate([imread_f32(lql_paths[i], bit16=True),
                                 imread_f32(lqr_paths[i], bit16=True)],
                                axis=-1)
        elif lq_paths[i] is None:
            rng = np.random.RandomState(0)  # deterministic eval protocol
            lq = hq + rng.randn(*hq.shape).astype(np.float32) * (
                args.sigma / 255.0)
        else:
            lq = imread_f32(lq_paths[i])
        if world == 1:
            _, psnr, ssim = restore_and_score(model, lq, hq, ref)
        else:
            pred = restore_sharded(model, lq, ref, rank, world)
            if pred is None:
                continue
            psnr = calculate_psnr(pred * 255, hq * 255)
            ssim = calculate_ssim(pred * 255, hq * 255)
        psnrs.append(psnr)
        ssims.append(ssim)
        print(f"[{i + 1}/{len(hq_paths)}] psnr {psnr:.4f} ssim {ssim:.4f}")

    if rank != 0:
        return None
    print(f"mean PSNR: {np.mean(psnrs):.4f}  mean SSIM: {np.mean(ssims):.4f}")
    return float(np.mean(psnrs)), float(np.mean(ssims))


if __name__ == "__main__":
    main()
