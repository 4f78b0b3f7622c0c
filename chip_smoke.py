"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises on failure:
1. versions and the card (`nvidia-smi` name and power limit);
2. build of the CUDA kernels from textualdegremoval_tpu_torch/csrc;
3. the whole-block kernel `tblock_fused` against its plain PyTorch version
   `tblock_ref` at every block shape of a 512 px restormer_deblur forward
   plus one ragged shape, WithBias and BiasFree, float32 and bfloat16, with
   weights at a trained block's scale (both halves of the block add O(1)
   to the residual) and the median time of both (CUDA events);
4. the full-width restormer_deblur network (seeded random weights) on the
   card against the same network on the CPU, whose blocks take the plain
   path, on a small input in float32;
5. the evaluation path: `restore_and_score` of the evaluation CLI on
   synthetic 512 x 512 (lq, hq, ref) triples in bfloat16 (f32 parameters),
   one warm-up and two timed, counting kernel launches (52 blocks per
   forward);
6. the backward kernels `gdfn_half_bwd` and `attn_half_bwd` against plain
   autograd through the two halves of the block, on the same inputs, at
   every block shape of a 384 px, batch-8 training step plus the ragged
   shape, WithBias and BiasFree, float32 and bfloat16: dx and every
   parameter gradient, elementwise and in L2 against the plain gradient's
   norm, with both times; and bwd_mode 'remat' against 'save';
7. the training main path: the training CLI's step function with the
   options of options/train_restoration/restormer_motion_deblur.yml
   (AdamW 2e-4 / ref 1e-4, wd 1e-4, clip 0.01, cosine restarts, L1) and
   param_fix_iterations 2, on seeded synthetic 384 px batch-8 triples in
   bf16 with f32 parameters: a warm-up, two frozen and two released steps
   (each launching 52 forward blocks, 52 of each backward kernel), one
   step under bwd_mode 'remat' (52 more forward launches), the step timed
   against the same step through plain-autograd blocks in alternating
   turns, peak memory; and one f32 step at 128 px, batch 1, on the card
   against the same step on the CPU;
8. the whole-NAFBlock kernel `nafblock_fused` against its plain version
   `nafblock_ref` at every block shape of a 512 px nafnet_deblur forward,
   one ragged shape and the two largest shapes of a 384 px batch-8
   training step, float32 and bfloat16, with weights at a trained block's
   scale (beta, gamma and the SCA scale non-zero), the tiles and the CTAs
   per SM of each pass, and the median time of both (CUDA events);
9. the NAFNetRefFusion evaluation path: the full-width nafnet_deblur network
   on the card against the same network on the CPU in float32 on a small
   input, then `restore_and_score` on synthetic 512 x 512 triples in
   bfloat16, one warm-up and two timed, 45 kernel launches per forward,
   and a profiled forward;
10. the NAFNetRefFusion training path: the training CLI's step function
   with the options of options/train_restoration/nafnet_motion_deblur.yml
   (PSNR loss) and param_fix_iterations 2, on seeded synthetic 384 px
   batch-8 triples in bf16: a warm-up, two frozen and two released steps
   (45 launches each; after the first released step every parameter has a
   finite gradient), the kernel against plain at every training block
   shape in bf16, and the step timed against the same step through plain
   blocks in alternating turns, with the peak memory of each;
11. the flash self-attention kernel `flash_attention` against its plain
   version `attention_ref` at the 512 px UNet's flash shape (2, 4096, 5, 64),
   at head_dim 128, at the shortest routed sequence and at a ragged one,
   float32 and bfloat16, with q and k scaled so that the logits have a
   standard deviation of 3 (peaked rows move the running max): elementwise
   and L2 bounds, two calls bitwise equal, the median time of the kernel,
   the plain version and `F.scaled_dot_product_attention` (the library
   yardstick, never called by the port);
12. pipeline A's towers at full SD 2.1 width (seeded random weights,
   `random_init`), float32 with cuDNN's TF32 off: the UNet at the 512 px
   latent through the kernel (5 launches) against the same weights with
   attn_impl='plain' on the card; the text tower with injected words, the
   vision tower, both mappers, the VAE decoder and a UNet at a 32 x 64
   latent (N = 2048, so the kernel runs) on the card against the CPU on
   small inputs;
13. the generation path: the generation CLI's `generate_one` on synthetic
   images at 512 px, 100 DDIM steps, guidance 5, in bf16 (f32 parameters;
   one warm-up and two timed) and in f32 (one timed), 500 kernel launches
   per image, the output (512, 512, 3) uint8 from finite values; the time
   of one DDIM step, a profiled step, and peak memory;
14. the flash backward kernels (`_backward_kernel`: dkv, then dq) against
   the plain backward `attention_bwd_ref` and against autograd through
   `attention_ref`, on the forward kernel's own o and lse, at the training
   shape (4, 4096, 5, 64), the CFG shape, head_dim 128, the shortest
   routed sequence and a ragged one, float32 and bfloat16, logits of
   standard deviation 3: dq, dk, dv elementwise and in L2, the lse against
   logsumexp, two calls bitwise equal, and the median time of the kernel
   pair, of the plain autograd backward and of SDPA's backward (the
   yardstick);
15. pipeline A's training path: the I2T training CLI's step function
   (`train_i2t.build_towers` / `build_step`) at full SD 2.1 width on
   seeded random towers, 512 px numpy-made images, batch 4,
   --mixed_precision bf16, accumulation 4: a warm-up (every trainable
   parameter gets a finite non-zero gradient), 8 micro-steps with 5
   forward and 4 backward flash launches each (the first self-attention
   precedes every trainable parameter), the trainables moving only at
   micro-steps 4 and 8, the frozen towers bitwise unchanged; remat (10
   forward launches) bitwise equal to no remat; the micro-step timed
   against attn_impl='plain' in alternating turns (CUDA events) with the
   peak memory of each, and a profiled micro-step; one f32 micro-step at
   batch 1 through the kernels against plain (loss 1e-5 relative, each
   trainable gradient 1e-3 in L2); one TR-stage update, after which only
   the clean mapper has moved.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it is nvidia-smi's, and before that a JSON summary of each kernel.  Without
CUDA the script exits non-zero and prints no result.

    python3 chip_smoke.py --plant FAULT

builds a copy of the kernel sources with one fault planted, under a
temporary directory, runs the phase that should catch it in bfloat16 at a
few shapes and exits 0 only if its check catches the fault (the strength
of the phase's bound): dv_uses_a and dq_drops_diag (phase 6, the attention
backward), sca_skipped and halo_kept (phase 8, the NAFBlock forward),
no_rescale (phase 11, the flash kernel), no_di, dk_unscaled and lse_log2
(phase 14, the flash backward and the forward's lse).
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.cli.evaluate import (
    TASK_TABLE, restore_and_score,
)
from textualdegremoval_tpu_torch.cli.generate_reference import (
    PROMPT_TEMPLATE, generate_one, random_init,
)
from textualdegremoval_tpu_torch.cli import train_i2t as train_cli
from textualdegremoval_tpu_torch.data import guidance as guidance_data
from textualdegremoval_tpu_torch.diffusion import pipeline
from textualdegremoval_tpu_torch.diffusion.pipeline import GuidanceModules
from textualdegremoval_tpu_torch.diffusion.tokenizer import tokenize_template
from textualdegremoval_tpu_torch.cli.train_restoration import resolve_network
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models import layers
from textualdegremoval_tpu_torch.models.layers import (
    NAFBlock, TransformerBlock,
)
from textualdegremoval_tpu_torch.models.unet import UNet2DCondition
from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops import flash_attn as fa
from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
from textualdegremoval_tpu_torch.ops.pallas import tblock_attn_bwd as ab
from textualdegremoval_tpu_torch.ops.pallas import tblock_bwd as gb
from textualdegremoval_tpu_torch.train.schedules import (
    build_schedule, warmup_wrap,
)
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state, make_train_step,
)

# kernel vs plain: pass when |kernel - plain| <= atol + rtol * |plain| at
# every element and ||kernel - plain|| <= branch * ||plain - x|| (L2 over
# the output: the error against what the block adds to its input, so a
# fault in either half of the block cannot hide under the residual).
# float32: both sum in f32, in different orders.  bfloat16: the kernel
# rounds the GDFN gate once in f32 where the plain path rounds the dwconv
# output and the gelu product in bf16, a few bf16 ulps (2^-7 relative).
# On an H100 the shipped kernel's branch error was at most 1.5e-6 (f32)
# and 6.5e-3 (bf16); A^T in place of A in bf16 gave 5.5e-2 to 3.4e-1.
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-1, 5e-2)}
BRANCH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# whole network on the card (kernel) vs on the CPU (plain), float32
NET_ATOL = 2e-3

# (B, H, W, C, heads, blocks of that shape in one 512 px restormer_deblur
# forward)
SHAPES = [
    (1, 512, 512, 48, 1, 4),    # encoder level 1
    (1, 512, 512, 96, 1, 10),   # fusion level 1, decoder level 1, refinement
    (1, 256, 256, 96, 2, 12),   # encoder / decoder level 2
    (1, 256, 256, 192, 2, 2),   # fusion level 2
    (1, 128, 128, 192, 4, 12),  # encoder / decoder level 3
    (1, 128, 128, 384, 4, 2),   # fusion level 3
    (1, 64, 64, 384, 8, 8),     # latent
    (1, 64, 64, 768, 8, 2),     # fusion level 4
    (2, 37, 53, 96, 2, 0),      # ragged: no tile divides H or W
]
TASK = "restormer_deblur"


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def log_held(after: str):
    """The device memory still allocated after a phase (a tensor that
    outlives its phase inflates every later phase's peak)."""
    gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"held after {after}: {gib:.2f} GiB")


def median_ms(fn, reps=5) -> float:
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def randomize_block(blk: TransformerBlock, gen: torch.Generator):
    """Weights at the scale of a trained block, so that both halves add O(1)
    to the residual: every conv weight ~ N(0, 1/fan_in), LN weights near 1
    and biases near 0, and temperatures ~ sqrt(C), since at random weights
    the normalised q.k correlations are O(C^-1/2) and a unit temperature
    leaves the softmax nearly uniform (then A and A^T give nearly the same
    o)."""
    c = blk.norm1.body.weight.shape[0]
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("temperature"):
                p.copy_(c ** 0.5 * (0.5 + torch.rand(p.shape, generator=gen)))
            elif p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p[0].numel() ** -0.5)
            else:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * torch.randn(p.shape, generator=gen))


def kernel_vs_plain(gen: torch.Generator, timed: bool = True):
    """Phase 3.  Returns the bf16 WithBias rows at the main-path shapes as
    (blocks per forward, max_abs, kernel ms, plain ms); untimed, the ms are
    NaN."""
    log("kernel vs plain: |k-p| <= atol + rtol*|p| and ||k-p|| <= branch * "
        f"||p-x||; f32 atol/rtol/branch {TOL[torch.float32]}/"
        f"{BRANCH_TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}/"
        f"{BRANCH_TOL[torch.bfloat16]}")
    log(f"{'B,H,W,C,heads':>22} {'LN':>8} {'dtype':>8} {'max_abs':>10} "
        f"{'max_rel':>10} {'tol_use':>8} {'branch':>10} {'kernel_ms':>10} "
        f"{'plain_ms':>10}")
    main_rows = []
    failures = []
    for b, h, w, c, heads, nblk in SHAPES:
        for ln_type in ("WithBias", "BiasFree"):
            blk = TransformerBlock(c, heads, ln_type=ln_type)
            randomize_block(blk, gen)
            x32 = torch.randn(b, h, w, c, generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                blk_d = blk.to(device="cuda", dtype=dtype)
                x = x32.to(device="cuda", dtype=dtype)
                params = blk_d.block_params()
                with torch.inference_mode():
                    got = blk_d(x).float()
                    want = tb.tblock_ref(x, params, heads, ln_type).float()
                    torch.cuda.synchronize()
                    atol, rtol = TOL[dtype]
                    diff = (got - want).abs()
                    max_abs = diff.max().item()
                    max_rel = max_abs / max(want.abs().max().item(), 1e-30)
                    tol_use = (diff / (atol + rtol * want.abs())).max().item()
                    added = (want - x.float()).norm().clamp_min(1e-30)
                    branch = (diff.norm() / added).item()
                    finite = bool(torch.isfinite(got).all())
                    k_ms = p_ms = float("nan")
                    if timed:
                        k_ms = median_ms(lambda: blk_d(x))
                        p_ms = median_ms(
                            lambda: tb.tblock_ref(x, params, heads, ln_type))
                name = str(dtype).split(".")[-1]
                log(f"{f'{b},{h},{w},{c},{heads}':>22} {ln_type:>8} {name:>8} "
                    f"{max_abs:10.3e} {max_rel:10.3e} {tol_use:8.3f} "
                    f"{branch:10.3e} {k_ms:10.4f} {p_ms:10.4f}")
                if not finite or tol_use > 1.0 or branch > BRANCH_TOL[dtype]:
                    failures.append((b, h, w, c, heads, ln_type, name))
                if dtype == torch.bfloat16 and ln_type == "WithBias" and nblk:
                    main_rows.append((nblk, max_abs, k_ms, p_ms))
                del got, want
            blk.cpu().float()
    if failures:
        raise RuntimeError(f"kernel disagrees with plain at {failures}")
    return main_rows


def build_network(seed: int, dtype, device, task=TASK) -> torch.nn.Module:
    """A task's network at full width with seeded random weights; the
    zero-initialised fusion gates and residual scales and the unit
    temperatures are set to non-zero random values so every block's output
    reaches the result."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = define_network(TASK_TABLE[task], dtype=dtype)
    return gate_and_temperatures(model, seed).to(device)


def gate_and_temperatures(model, seed):
    """Non-zero fusion gates and NAFBlock residual scales (beta, gamma),
    and non-unit temperatures, drawn from a seed, so that every block's
    output reaches the result."""
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("alpha", "beta", "gamma")):
                p.copy_(0.25 + 0.5 * torch.rand(p.shape, generator=gen))
            elif name.endswith("temperature"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
    return model


def network_vs_cpu(seed: int, task=TASK, kernel=tb.tblock_fused,
                   blocks=52):
    """Phases 4 and 9: the task's network on the card (`blocks` launches of
    the forward kernel `kernel`) vs on the CPU (plain), float32."""
    model_cpu = build_network(seed, torch.float32, "cpu", task)
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(seed + 2)
    lq = rng.random((1, 128, 128, 3), dtype=np.float32)
    ref = rng.random((1, 128, 128, 3), dtype=np.float32)
    kernel.launches = 0
    with torch.inference_mode():
        want = model_cpu(torch.from_numpy(lq), torch.from_numpy(ref))
        got = model_gpu(torch.from_numpy(lq).cuda(),
                        torch.from_numpy(ref).cuda()).cpu()
    err = (got - want).abs().max().item()
    log(f"{task} f32 128x128, card ({kernel.launches} kernel launches) vs "
        f"CPU (plain): max_abs {err:.3e} (atol {NET_ATOL}), max|out| "
        f"{want.abs().max().item():.3f}")
    if not torch.isfinite(got).all() or err > NET_ATOL \
            or kernel.launches != blocks:
        raise RuntimeError(f"{task} on the card disagrees with the CPU: "
                           f"{err}, {kernel.launches} launches")


def synthetic_triple(rng, size=512):
    """A smooth image, its noisy version and a shifted reference, HWC f32."""
    low = rng.random((size // 16, size // 16, 3)).astype(np.float32)
    hq = np.kron(low, np.ones((16, 16, 1), np.float32))
    hq = np.clip(hq + 0.05 * rng.standard_normal(hq.shape), 0, 1).astype(
        np.float32)
    lq = np.clip(hq + rng.standard_normal(hq.shape) * 15 / 255, 0, 1).astype(
        np.float32)
    ref = np.ascontiguousarray(np.roll(hq, (7, -5), axis=(0, 1)))
    return lq, hq, ref


def main_path(seed: int, task=TASK, kernel=tb.tblock_fused, blocks=52):
    """Phases 5 and 9, the evaluation path of `task`, whose every forward
    launches its forward kernel `kernel` `blocks` times.  Returns (the
    launches, forward ms)."""
    model = build_network(seed, torch.bfloat16, "cuda", task)
    rng = np.random.default_rng(seed + 3)
    triples = [synthetic_triple(rng) for _ in range(2)]
    kernel.launches = 0
    forwards = 0
    _, psnr, ssim = restore_and_score(model, *triples[0])
    forwards += 1
    log(f"{task} warm-up psnr {psnr:.4f} ssim {ssim:.4f}")
    for i, (lq, hq, ref) in enumerate(triples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, psnr, ssim = restore_and_score(model, lq, hq, ref)
        ms = (time.perf_counter() - t0) * 1e3
        forwards += 1
        if pred.shape != hq.shape or not np.isfinite(pred).all() \
                or not np.isfinite(psnr) or not np.isfinite(ssim):
            raise RuntimeError(f"{task} image {i}: bad output {pred.shape}")
        log(f"{task} image {i}: {ms:.1f} ms (restore + score), psnr "
            f"{psnr:.4f} ssim {ssim:.4f}")
    launches = kernel.launches
    log(f"{task}: {kernel.__name__} launches {launches} over {forwards} "
        f"forwards")
    if launches != blocks * forwards:
        raise RuntimeError(f"expected {blocks * forwards} kernel launches, "
                           f"got {launches}")

    lq, _, ref = triples[0]
    args = [torch.from_numpy(a)[None].to("cuda", torch.bfloat16)
            for a in (lq, ref)]
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args), reps=3)
        log(f"{task} forward 512x512 bf16: {fwd_ms:.2f} ms "
            f"({1e3 / fwd_ms:.3f} images/s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_device(lambda: model(*args), f"{task} forward")
    del model
    torch.cuda.empty_cache()
    return launches, fwd_ms


# ---------------------------------------------------------------------------
# Phase 6: backward kernels against plain autograd
# ---------------------------------------------------------------------------

# (B, H, W, C, heads, blocks of that shape in one 384 px batch-8 step of
# restormer_motion_deblur)
TRAIN_SHAPES = [
    (8, 384, 384, 48, 1, 4),    # encoder level 1
    (8, 384, 384, 96, 1, 10),   # fusion level 1, decoder level 1, refinement
    (8, 192, 192, 96, 2, 12),   # encoder / decoder level 2
    (8, 192, 192, 192, 2, 2),   # fusion level 2
    (8, 96, 96, 192, 4, 12),    # encoder / decoder level 3
    (8, 96, 96, 384, 4, 2),     # fusion level 3
    (8, 48, 48, 384, 8, 8),     # latent
    (8, 48, 48, 768, 8, 2),     # fusion level 4
    (2, 37, 53, 96, 2, 0),      # ragged: no tile divides H or W
]
# gradient, kernel vs plain autograd on the same inputs: pass when
# ||k - p|| <= GRAD_L2 ||p|| and |k - p| <= a max|p| + r |p| elementwise.
# f32: sum order only (measured at most 8.5e-6, temperatures 8.5e-5).
# bf16: the kernel rounds where the TPU kernel does (hid, dd, dlin, the
# scratch operands), the plain path after every op; 2e-2 is about three
# times the largest reading of the shipped kernels at every training shape
# (6.9e-3) and below both planted faults' (0.098 and 0.33 at their
# weakest).  The temperature gradient is a sum of cph^2 terms dz * ghat
# that cancel (each softmax row of dz sums to zero), so the bf16 noise of
# dA shows in it magnified: its own bound, 1e-1 in bf16, about four times
# its largest reading (2.35e-2).
GRAD_L2 = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
GRAD_L2_TEMPERATURE = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
GRAD_ELEM = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-1, 1e-1)}
# fault -> (source, text, replacement, the phase that must catch it)
FAULTS = {
    # dv = do . A^T in place of do . A in pass 2 of the attention half
    "dv_uses_a": ("tblock_attn_bwd.cu", "MatB<T>{at + mo, 1, cph}",
                  "MatB<T>{at + mo, cph, 1}", 6),
    # the norm-backward diagonal term q Dq dropped from dq
    "dq_drops_diag": ("tblock_attn_bwd.cu",
                      "a + qv * dqd[(size_t)b * C + hd * cph + n]", "a", 6),
    # the gate not multiplied by the SCA scale s in pass B
    "sca_skipped": ("nafblock.cu",
                    "gate_at<T>(hab, rw, p / tw, p % tw, j, j0, taps, dwb, "
                    "cpad) * sv)",
                    "gate_at<T>(hab, rw, p / tw, p % tw, j, j0, taps, dwb, "
                    "cpad))", 8),
    # conv1's output (bias included) kept outside the image: the dwconv's
    # zero padding lost, in both passes
    "halo_kept": ("nafblock.cu", "from_f<T>(in ? rnd<T>(a) + bias : 0.f)",
                  "from_f<T>(rnd<T>(a) + bias)", 8),
    # the flash kernel's accumulator not rescaled by exp(m_old - m_new)
    # when a row's running max grows (bf16 path)
    "no_rescale": ("flash_attn.cu",
                   "acc[j][0] *= al0; acc[j][1] *= al0; acc[j][2] *= al1; "
                   "acc[j][3] *= al1;", "", 11),
    # the flash backward's dS = P (dP - di) without di (dkv kernel, bf16)
    "no_di": ("flash_attn_bwd.cu",
              "dpt[nt][i] = p * (dpt[nt][i] - dis[qi]);",
              "dpt[nt][i] = p * dpt[nt][i];", 14),
    # dK not multiplied by the softmax scale (bf16)
    "dk_unscaled": ("flash_attn_bwd.cu",
                    "store_rows<D>(dk + off, dka, r0, N, H, scale);",
                    "store_rows<D>(dk + off, dka, r0, N, H, 1.f);", 14),
    # the forward's lse left in log2 units (bf16): every recomputed P is
    # off by a factor
    "lse_log2": ("flash_attn.cu",
                 "if (r0 < N) lb[r0] = (m0 + log2f(l0)) * kLn2;",
                 "if (r0 < N) lb[r0] = m0 + log2f(l0);", 14),
}


def grad_l2_bound(name: str, dtype) -> float:
    return (GRAD_L2_TEMPERATURE if name == "temperature" else GRAD_L2)[dtype]


def _grad_row(name, got, want, dtype):
    """(max_abs, elementwise tolerance use, L2 error / ||plain||, ok)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    a, r = GRAD_ELEM[dtype]
    use = (diff / (a * w.abs().max() + r * w.abs()).clamp_min(1e-30)).max()
    l2 = diff.norm() / w.norm().clamp_min(1e-30)
    ok = bool(torch.isfinite(g).all()) and float(use) <= 1.0 \
        and float(l2) <= grad_l2_bound(name, dtype)
    return diff.max().item(), float(use), float(l2), ok


def backward_vs_plain(gen, shapes=TRAIN_SHAPES, dtypes=None, timed=True):
    """Phase 6.  Returns the bf16 WithBias rows at the training shapes as
    (blocks per step, max L2, gdfn max_abs, attn max_abs, gdfn ms, attn ms,
    gdfn plain ms, attn plain ms, shape), and raises after printing if any
    row fails."""
    dtypes = dtypes or (torch.float32, torch.bfloat16)
    log(f"backward kernels vs plain autograd: ||k-p|| <= l2 ||p|| and "
        f"|k-p| <= a max|p| + r |p|; f32 l2 {GRAD_L2[torch.float32]} a/r "
        f"{GRAD_ELEM[torch.float32]}, bf16 l2 {GRAD_L2[torch.bfloat16]} "
        f"(temperature {GRAD_L2_TEMPERATURE[torch.bfloat16]}) a/r "
        f"{GRAD_ELEM[torch.bfloat16]}; per gradient max_abs/use/l2")
    rows, failures = [], []
    for b, h, w, c, heads, nblk in shapes:
        for ln_type in ("WithBias", "BiasFree"):
            blk = TransformerBlock(c, heads, ln_type=ln_type)
            randomize_block(blk, gen)
            blk = blk.cuda()
            p = {k: v.detach() for k, v in blk.block_params().items()}
            x32 = torch.randn(b, h, w, c, generator=gen)
            g32 = torch.randn(b, h, w, c, generator=gen)
            for dtype in dtypes:
                x, g = x32.to("cuda", dtype), g32.to("cuda", dtype)
                kw = tb.prepare_tblock_weights(p, dtype, ln_type)
                with torch.no_grad():
                    _, x1, stats = tb._forward_kernel(x, kw, heads, ln_type,
                                                      want_x1=True)
                dx1, gg = gb.gdfn_half_bwd(x1, g, p, ln_type, kw)
                dx, ga = ab.attn_half_bwd(x, dx1, p, heads, ln_type, stats,
                                          kw)
                pdx1, pgg = gb.gdfn_half_bwd_ref(x1, g, p, ln_type)
                pdx, pga = ab.attn_half_bwd_ref(x, dx1, p, heads, ln_type)
                torch.cuda.synchronize()
                got = {"dx1": dx1, **gg, "dx": dx, **ga}
                want = {"dx1": pdx1, **pgg, "dx": pdx, **pga}
                stats_row = {k: _grad_row(k, got[k], want[k], dtype)
                             for k in want}
                del got, want, pdx1, pgg, pdx, pga
                t = [float("nan")] * 4
                if timed:
                    t = [median_ms(lambda: gb.gdfn_half_bwd(
                             x1, g, p, ln_type, kw), reps=3),
                         median_ms(lambda: ab.attn_half_bwd(
                             x, dx1, p, heads, ln_type, stats, kw), reps=3),
                         median_ms(lambda: gb.gdfn_half_bwd_ref(
                             x1, g, p, ln_type), reps=3),
                         median_ms(lambda: ab.attn_half_bwd_ref(
                             x, dx1, p, heads, ln_type), reps=3)]
                name = str(dtype).split(".")[-1]
                worst = max(v[2] for v in stats_row.values())
                log(f"{b},{h},{w},{c},{heads} {ln_type} {name}: max L2 "
                    f"{worst:.3e}; gdfn {t[0]:.3f} ms (plain {t[2]:.3f}), "
                    f"attn {t[1]:.3f} ms (plain {t[3]:.3f})")
                log("    " + " ".join(
                    f"{k}:{v[0]:.2e}/{v[1]:.3f}/{v[2]:.2e}"
                    for k, v in stats_row.items()))
                bad = [k for k, v in stats_row.items() if not v[3]]
                if bad:
                    failures.append((b, h, w, c, heads, ln_type, name, bad))
                if dtype == torch.bfloat16 and ln_type == "WithBias" \
                        and nblk:
                    half = {k: k == "dx1" or k.startswith(("gd_", "norm2"))
                            for k in stats_row}
                    rows.append((nblk, worst, *(
                        max(v[0] for k, v in stats_row.items()
                            if half[k] == gdfn) for gdfn in (True, False)),
                        *t, (b, h, w, c, heads)))
                del x, g, x1, dx1, dx, gg, ga, kw
                torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"backward kernels disagree with plain at "
                           f"{failures}")
    return rows


def remat_vs_save(gen):
    """Phase 6: bwd_mode 'remat' recomputes x1 and the statistics with the
    same kernel, so its gradients must equal 'save''s bit for bit."""
    for b, h, w, c, heads, _ in (TRAIN_SHAPES[4], TRAIN_SHAPES[-1]):
        blk = TransformerBlock(c, heads)
        randomize_block(blk, gen)
        blk = blk.cuda()
        x0 = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
        g = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
        grads = {}
        for mode in ("save", "remat"):
            blk.bwd_mode = mode
            blk.zero_grad()
            x = x0.clone().requires_grad_(True)
            before = tb.tblock_fused.launches
            blk(x).backward(g)
            launches = tb.tblock_fused.launches - before
            if launches != (2 if mode == "remat" else 1):
                raise RuntimeError(f"{mode}: {launches} forward launches")
            grads[mode] = [x.grad] + [q.grad.clone() for q in
                                      blk.parameters()]
        same = all(torch.equal(u, v) for u, v in zip(grads["save"],
                                                     grads["remat"]))
        log(f"remat vs save at {b},{h},{w},{c},{heads} bf16: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError("remat gradients differ from save")


def plant_fault(fault: str) -> None:
    """Point the build at a temporary copy of csrc/ with `fault` planted."""
    src, old, new, _ = FAULTS[fault]
    tmp = Path(tempfile.mkdtemp(prefix="planted_"))
    shutil.copytree(_build._CSRC, tmp / "csrc")
    path = tmp / "csrc" / src
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"fault {fault}: pattern not found once in {src}")
    path.write_text(text.replace(old, new))
    _build._CSRC, _build.BUILD_DIR = tmp / "csrc", tmp / "build"
    log(f"planted {fault} in a copy of {src} under {tmp}")


# ---------------------------------------------------------------------------
# Phase 7: the training main path
# ---------------------------------------------------------------------------

# options/train_restoration/restormer_motion_deblur.yml as a dict (no YAML
# on the card's machine), param_fix_iterations cut to 2
TRAIN_OPT = {
    "network_g": {
        "type": "RestormerRefFusion", "inp_channels": 3, "out_channels": 3,
        "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
        "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "WithBias", "dual_pixel_task": False, "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "reffusion_n_blocks_middle": 1, "num_nbr": 1, "psize": 3,
        "lr_block_size": 8, "ref_down_block_size": 1.5,
        "dilations": [1, 2, 3]},
    "train": {
        "total_iter": 1000000, "warmup_iter": -1, "use_grad_clip": True,
        "param_fix_iterations": 2,
        "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                      "periods": [306000, 694000], "restart_weights": [1, 1],
                      "eta_mins": [0.0003, 0.000001]},
        "optim_g": {"type": "AdamW", "lr": 2e-4, "ref_lr": 1e-4,
                    "weight_decay": 1e-4, "betas": [0.9, 0.999]},
        "pixel_opt": {"type": "L1Loss", "loss_weight": 1,
                      "reduction": "mean"}},
}


def _trainer(model, topt):
    """The optimizer, state and both step functions, as the CLI builds
    them."""
    lr, ref_lr = topt["optim_g"]["lr"], topt["optim_g"]["ref_lr"]
    sched = warmup_wrap(build_schedule(lr, topt["scheduler"]), -1, lr)
    ref_sched = warmup_wrap(build_schedule(ref_lr, topt["scheduler"]), -1,
                            ref_lr)
    opt = build_optimizer(
        model, sched, ref_sched, weight_decay=topt["optim_g"]["weight_decay"],
        betas=tuple(topt["optim_g"]["betas"]), grad_clip=0.01,
        param_fix_iterations=topt["param_fix_iterations"])
    loss_fn = build_loss(topt["pixel_opt"])
    return (create_train_state(model, opt), make_train_step(loss_fn),
            make_train_step(loss_fn, masa_frozen=True))


def _plain_blocks(x, p, heads, ln_type="WithBias", kw=None,
                  bwd_mode="save"):
    """The plain-autograd route of phase 7's comparison turns (never the
    main path): tblock_ref, checkpointed per block, since autograd's saved
    tensors of 52 plain blocks at 384 px batch 8 would not fit the card."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(tb.tblock_ref, x, p, heads, ln_type,
                      use_reentrant=False)


def train_main_path(seed: int, opt=TRAIN_OPT, kernels=None, per_step=None,
                    plain=("tblock_fused", _plain_blocks)):
    """Phases 7 and 10, the training path of `opt` in bf16 at 384 px batch
    8: every step launches each of `kernels` per_step times; the
    comparison turns put plain = (name in models.layers, plain route) in
    place of the kernel route.  Returns (launches of each kernel over the
    counted steps, kernel step ms, plain step ms, kernel peak GiB, plain
    peak GiB)."""
    kernels = kernels or (tb.tblock_fused, gb.gdfn_half_bwd,
                          ab.attn_half_bwd)
    per_step = per_step or (52, 52, 52)
    name = opt["network_g"]["type"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _, _ = resolve_network(opt, mixed_precision="bf16",
                                      device="cuda")
    model = gate_and_temperatures(model, seed).cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed + 4)
    trip = [synthetic_triple(rng, 384) for _ in range(8)]
    batch = {k: torch.from_numpy(np.stack([t[i] for t in trip])).cuda()
             for i, k in enumerate(("lq", "gt", "ref"))}

    def counted_step(fn):
        for k in kernels:
            k.launches = 0
        state_m = fn(state, batch)
        return state_m, tuple(k.launches for k in kernels)

    # warm-up: one frozen and one released step, then back to the start
    state, step_fn, frozen_fn = _trainer(model, opt["train"])
    state, _ = frozen_fn(state, batch)
    state, _ = step_fn(state, batch)
    model.load_state_dict(init)
    state, step_fn, frozen_fn = _trainer(model, opt["train"])
    torch.cuda.synchronize()

    totals = [0] * len(kernels)
    names = [n for n, _ in model.named_parameters()]
    for i in range(4):
        frozen = state.opt.count < state.opt.fix
        seen = {}
        if i == 2:  # the first released step: every gradient as handed on
            def capture(gs, update=state.opt.step, seen=seen):
                seen.update(zip(names, gs))
                update(gs)
            state.opt.step = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), counts = counted_step(frozen_fn if frozen else step_fn)
        loss = float(m["l_pix"])
        ms = (time.perf_counter() - t0) * 1e3
        # back to the class's step: an instance attribute holding a bound
        # method of its own object is a reference cycle, which would keep
        # the model and optimizer on the card until the next full collection
        state.opt.__dict__.pop("step", None)
        totals = [a + b for a, b in zip(totals, counts)]
        log(f"{name} train step {i + 1} "
            f"({'frozen' if frozen else 'released'}): {ms:.1f} ms, l_pix "
            f"{loss:.5f}, grad_norm {float(m['grad_norm']):.4e}, launches "
            f"{'/'.join(k.__name__ for k in kernels)} {counts}")
        if counts != per_step or not np.isfinite(loss):
            raise RuntimeError(f"step {i + 1}: launches {counts}, loss {loss}")
        if i == 1:
            sd = model.state_dict()
            moved = [n for n in names if "masa" in n
                     and not torch.equal(sd[n], init[n])]
            if moved:
                raise RuntimeError(f"masa parameters moved while frozen: "
                                   f"{moved[:3]}")
        if i == 2:
            bad = [n for n in names if seen.get(n) is None
                   or not torch.isfinite(seen[n]).all()]
            log(f"first released step: {len(names) - len(bad)} of "
                f"{len(names)} parameters have a finite gradient")
            if bad:
                raise RuntimeError(f"parameters without a finite gradient: "
                                   f"{bad[:5]}")
    sd = model.state_dict()
    still = [n for n in names if "masa" not in n
             and torch.equal(sd[n], init[n])]
    masa_moved = sum(not torch.equal(sd[n], init[n]) for n in names
                     if "masa" in n)
    log(f"after 2 frozen + 2 released steps: {len(still)} trunk parameters "
        f"unmoved, {masa_moved} masa parameters moved")
    if still:
        raise RuntimeError(f"trunk parameters did not move: {still[:3]}")

    # one step with the memory-lean backward of the TransformerBlocks: one
    # more forward launch per block
    blocks = [m for m in model.modules() if isinstance(m, TransformerBlock)]
    if blocks:
        for mod in blocks:
            mod.bwd_mode = "remat"
        (state, m), counts = counted_step(step_fn)
        log(f"remat step: launches {counts}, l_pix {float(m['l_pix']):.5f}")
        if counts != (2 * per_step[0],) + per_step[1:]:
            raise RuntimeError(f"remat step launches {counts}")
        for mod in blocks:
            mod.bwd_mode = "save"

    # the step through the kernels vs through plain-autograd blocks, in
    # alternating turns; peak memory of each
    turns = {"kernel": [], "plain": []}
    peak = {}
    route_name, plain_fn = plain
    kernel_fn = getattr(layers, route_name)
    for route in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        if route == "plain":
            setattr(layers, route_name, plain_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["l_pix"])
        torch.cuda.synchronize()
        turns[route].append((time.perf_counter() - t0) * 1e3)
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
        setattr(layers, route_name, kernel_fn)
    k_ms = statistics.median(turns["kernel"])
    p_ms = statistics.median(turns["plain"])
    profile_device(lambda: float(step_fn(state, batch)[1]["l_pix"]),
                   f"{name} step")
    log(f"{name} train step 384 px batch 8 bf16, alternating turns: kernel "
        f"{[round(v, 2) for v in turns['kernel']]} ms, plain blocks "
        f"{[round(v, 2) for v in turns['plain']]} ms; medians {k_ms:.2f} vs "
        f"{p_ms:.2f} ms; peak memory {peak['kernel']:.2f} vs "
        f"{peak['plain']:.2f} GiB")
    del state, model, batch
    torch.cuda.empty_cache()
    return totals, k_ms, p_ms, peak["kernel"], peak["plain"]


def _union_ms(spans) -> float:
    """Length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_device(fn, what: str):
    """Device time of one call of fn by kernel (torch.profiler), the share
    of the port's kernels, and the device's idle share of its wall time.
    Busy is the union of the device events' intervals, so events that
    overlap (another stream) are not counted twice; the per-kernel sums
    can exceed it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_type == cuda]
    summed = sum(t for _, t, _ in kernels)
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == cuda]
    busy = _union_ms(spans)
    if busy <= 0:
        log("profiler: no device time recorded")
        return
    ours = ("tblock_", "gdfn_bwd", "attn_bwd", "wgrad", "nafblock_",
            "flash_")
    mine = sum(t for k, t, _ in kernels if any(o in k for o in ours))
    log(f"profiled {what}: wall {wall:.1f} ms, {len(spans)} device events, "
        f"device busy {busy:.1f} ms (summed {summed:.1f} ms), idle share "
        f"{1 - busy / wall:.4f}; the port's kernels {mine:.1f} ms "
        f"({mine / summed:.3f} of the summed device time)")
    for k, t, n in sorted(kernels, key=lambda r: -r[1])[:14]:
        log(f"    {t:9.2f} ms {n:6d}x  {k[:90]}")


def train_step_vs_cpu(seed: int):
    """Phase 7: one f32 step at 128 px, batch 1, on the card (kernels)
    against the same step on the CPU (plain blocks).  Each parameter's
    gradient, as the step hands it to the optimizer, is held to
    ||g_card - g_cpu|| <= 1e-3 ||g_cpu||, so that one small tensor with a
    wrong gradient fails (the first Adam update, about lr * g / |g|, keeps
    only the sign of each element); and every element of the update to
    |d_card - d_cpu| <= 1e-2 lr."""
    topt = dict(TRAIN_OPT["train"], param_fix_iterations=0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model_cpu, _, _ = resolve_network(TRAIN_OPT, device="cpu")
    model_cpu = gate_and_temperatures(model_cpu, seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    init = {k: v.clone() for k, v in model_cpu.state_dict().items()}
    rng = np.random.default_rng(seed + 5)
    lq, gt, ref = synthetic_triple(rng, 128)
    batch = {k: torch.from_numpy(v)[None] for k, v in
             (("lq", lq), ("gt", gt), ("ref", ref))}
    losses, grads, after = [], [], []
    for model, dev in ((model_cpu, "cpu"), (model_gpu, "cuda")):
        state, step_fn, _ = _trainer(model, topt)
        seen = {}
        update = state.opt.step

        def capture(gs, update=update, seen=seen, names=state.opt.names):
            seen.update((n, g.detach().cpu()) for n, g in zip(names, gs))
            update(gs)

        state.opt.step = capture
        state, m = step_fn(state, {k: v.to(dev) for k, v in batch.items()})
        del state.opt.step  # no cycle through the capture's bound method
        losses.append(float(m["l_pix"]))
        grads.append(seen)
        after.append({k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    lr = TRAIN_OPT["train"]["optim_g"]["lr"]
    g_rel = sorted(
        (((grads[1][k] - g).norm() / g.norm().clamp_min(1e-30)).item(), k)
        for k, g in grads[0].items())
    worst = max(((after[1][k] - v) - (after[0][k] - v)).abs().max().item()
                for k, v in init.items())
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    log(f"f32 train step 128 px, card vs CPU: l_pix {losses[1]:.7f} vs "
        f"{losses[0]:.7f} (rel {rel:.2e}); gradient L2 error / norm over "
        f"{len(g_rel)} parameters: median {g_rel[len(g_rel) // 2][0]:.2e}, "
        f"largest " + ", ".join(f"{k} {v:.2e}" for v, k in g_rel[-3:])
        + f"; update difference max {worst:.3e} (lr {lr})")
    if not rel <= 1e-4 or not g_rel[-1][0] <= 1e-3 or worst > 1e-2 * lr:
        raise RuntimeError("the f32 step on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# Phase 8: the whole-NAFBlock kernel against its plain version
# ---------------------------------------------------------------------------

NAF_TASK = "nafnet_deblur"
NAF_BLOCKS = 45  # NAFBlocks of one nafnet_deblur forward, each one launch
# (B, H, W, C, blocks of that shape in one 512 px nafnet_deblur forward)
NAF_SHAPES = [
    (1, 512, 512, 128, 2),   # fusion, level 0
    (1, 512, 512, 64, 2),    # encoder 0, decoder 3
    (1, 256, 256, 256, 2),   # fusion, level 1
    (1, 256, 256, 128, 2),   # encoder 1, decoder 2
    (1, 128, 128, 512, 2),   # fusion, level 2
    (1, 128, 128, 256, 2),   # encoder 2, decoder 1
    (1, 64, 64, 1024, 2),    # fusion, level 3
    (1, 64, 64, 512, 29),    # encoder 3 (28), decoder 0
    (1, 32, 32, 2048, 1),    # middle fusion
    (1, 32, 32, 1024, 1),    # middle block
    (2, 37, 53, 96, 0),      # ragged: no tile divides H or W
]
# (B, H, W, C, blocks of that shape in one 384 px batch-8 step of
# nafnet_motion_deblur); the first two are the largest tensors
NAF_TRAIN_SHAPES = [
    (8, 384, 384, 128, 2), (8, 384, 384, 64, 2), (8, 192, 192, 256, 2),
    (8, 192, 192, 128, 2), (8, 96, 96, 512, 2), (8, 96, 96, 256, 2),
    (8, 48, 48, 1024, 2), (8, 48, 48, 512, 29), (8, 24, 24, 2048, 1),
    (8, 24, 24, 1024, 1),
]
# NAFBlock kernel vs plain: pass when |k - p| <= a max|p| + r |p| at every
# element and ||k - p|| <= branch ||p - x|| over the output.  float32: sums
# in other orders.  bfloat16: the kernel rounds the dwconv once with f32
# taps where the plain path casts the taps to bf16 and rounds the conv and
# its bias add; a differing ulp of the gate, then of y1, goes on through
# LN2 and the FFN, so an element may differ by several ulps of the block's
# larger intermediate values even where the output itself is near zero:
# hence an absolute term in units of max|p| (5e-2 is 6 to 13 bf16 ulps of
# it).  On an H100 the kernel's bf16 branch error read 8.4e-3 at every
# shape.  Both residual branches count: beta, gamma and the SCA scale are
# O(1), so a fault in either half shows in ||k - p|| against ||p - x||.
NAF_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}


def randomize_nafblock(blk: NAFBlock, gen: torch.Generator):
    """Weights at the scale of a trained block, so that both residual
    branches add O(1): conv weights ~ N(0, 1/fan_in), LayerNorm weights
    near 1 and biases near 0; conv biases ~ N(0, 0.5^2), so that conv1's
    bias outside the image (a lost zero padding of the dwconv) shows; the
    SCA conv's bias and beta and gamma ~ U(0.5, 1.5), so that the SCA scale
    is O(1) and away from 1 (a skipped scale shows) and neither branch
    vanishes (at their zero init beta and gamma hide both)."""
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name in ("beta", "gamma", "sca.1.bias"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            elif p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p[0].numel() ** -0.5)
            elif name.startswith("norm"):
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))


def nafblock_occupancy(c: int, dtype) -> str:
    """The tiles of both passes and how many CTAs of each one SM holds."""
    lib = _build.load_library()
    eb = torch.finfo(dtype).bits // 8
    is_bf16 = int(dtype == torch.bfloat16)
    tiles = nb.pick_tiles(lib, c, eb)
    return " ".join(
        f"{'AB'[i]} {t[0]}x{t[1]} "
        f"{lib.nafblock_smem_bytes(i, c, t[0], t[1], eb) / 1024:.0f}KB "
        f"{lib.nafblock_ctas_per_sm(i, c, t[0], t[1], is_bf16)}/SM"
        for i, t in enumerate(tiles))


def nafblock_vs_plain(gen, shapes, dtypes=(torch.float32, torch.bfloat16),
                      timed=True):
    """Phases 8 and 10.  Returns the bf16 rows as (blocks of that shape,
    max_abs, kernel ms, plain ms, shape); untimed, the ms are NaN.  Raises
    after printing if any row fails."""
    log("nafblock kernel vs plain: |k-p| <= a*max|p| + r*|p| and ||k-p|| <= "
        f"branch * ||p-x||; f32 a/r/branch {NAF_TOL[torch.float32]}/"
        f"{BRANCH_TOL[torch.float32]}, bf16 {NAF_TOL[torch.bfloat16]}/"
        f"{BRANCH_TOL[torch.bfloat16]}; tiles of pass A/B and CTAs per SM")
    log(f"{'B,H,W,C':>16} {'dtype':>8} {'max|p|':>8} {'max_abs':>10} "
        f"{'tol_use':>8} {'branch':>10} {'kernel_ms':>10} {'plain_ms':>10}  "
        f"occupancy")
    rows, failures = [], []
    for b, h, w, c, nblk in shapes:
        blk = NAFBlock(c)
        randomize_nafblock(blk, gen)
        blk = blk.cuda()
        x32 = torch.randn(b, h, w, c, generator=gen)
        for dtype in dtypes:
            x = x32.to("cuda", dtype)
            params = blk.block_params()
            with torch.inference_mode():
                got = blk(x).float()
                want = nb.nafblock_ref(x, params).float()
                torch.cuda.synchronize()
                a, r = NAF_TOL[dtype]
                diff = (got - want).abs()
                max_abs = diff.max().item()
                peak = want.abs().max().item()
                tol_use = (diff / (a * peak + r * want.abs())).max().item()
                branch = (diff.norm() / (want - x.float()).norm()
                          .clamp_min(1e-30)).item()
                finite = bool(torch.isfinite(got).all())
                del got, want, diff
                k_ms = p_ms = float("nan")
                if timed:
                    k_ms = median_ms(lambda: blk(x))
                    p_ms = median_ms(lambda: nb.nafblock_ref(x, params))
            name = str(dtype).split(".")[-1]
            log(f"{f'{b},{h},{w},{c}':>16} {name:>8} {peak:8.3f} "
                f"{max_abs:10.3e} {tol_use:8.3f} {branch:10.3e} "
                f"{k_ms:10.4f} {p_ms:10.4f}  {nafblock_occupancy(c, dtype)}")
            if not finite or tol_use > 1.0 or branch > BRANCH_TOL[dtype]:
                failures.append((b, h, w, c, name))
            if dtype == torch.bfloat16:
                rows.append((nblk, max_abs, k_ms, p_ms, (b, h, w, c)))
            del x
        del blk
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"nafblock kernel disagrees with plain at "
                           f"{failures}")
    return rows


# ---------------------------------------------------------------------------
# Phases 9 and 10: the NAFNetRefFusion evaluation and training paths, run
# by the functions of phases 4, 5 and 7
# ---------------------------------------------------------------------------

# options/train_restoration/nafnet_motion_deblur.yml as a dict (no YAML on
# the card's machine), param_fix_iterations cut to 2
NAF_TRAIN_OPT = {
    "network_g": {
        "type": "NAFNetRefFusion", "img_channel": 3, "width": 64,
        "middle_blk_num": 1, "enc_blk_nums": [1, 1, 1, 28],
        "dec_blk_nums": [1, 1, 1, 1], "nf": 64, "ext_n_blocks": [4, 4, 4, 4],
        "reffusion_n_blocks": [2, 2, 2, 2], "reffusion_n_blocks_middle": 1,
        "num_nbr": 1, "psize": 3, "lr_block_size": 8,
        "ref_down_block_size": 1.5, "dilations": [1, 2, 3]},
    "train": {**TRAIN_OPT["train"],
              "pixel_opt": {"type": "PSNRLoss", "loss_weight": 1,
                            "reduction": "mean"}},
}


def _plain_nafblocks(x, p, kw=None):
    """The plain-autograd route of phase 10's comparison turns (never the
    main path): nafblock_ref, with autograd keeping its intermediates (45
    plain blocks at 384 px batch 8 fit the card)."""
    return nb.nafblock_ref(x, p)


# ---------------------------------------------------------------------------
# Phase 11: the flash self-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (B, N, H, D, launches of that shape in one 512 px UNet forward)
FLASH_SHAPES = [
    (2, 4096, 5, 64, 5),   # the 64 x 64 latent under CFG: down_0, up_3
    (1, 4096, 5, 128, 0),  # head_dim 128
    (2, 2048, 10, 64, 0),  # the shortest sequence flash_applies routes
    (2, 1000, 3, 64, 0),   # ragged: no 64-row tile divides N
]
FLASH_PEAK = 3.0  # standard deviation of the logits q.k / sqrt(D)
# flash kernel vs attention_ref: pass when |k - p| <= a max|p| + r |p| at
# every element and ||k - p|| <= l2 ||p||, (a, r, l2) below.  float32: the
# same f32 math, sums in other orders and exp2 of prescaled logits.
# bfloat16: the kernel rounds the unnormalised probabilities to bf16 for
# the PV product and divides by the f32 row sum at the end, the plain
# version rounds the normalised probabilities; both round the output, so
# they differ by about one bf16 ulp (2^-8 relative) of the output.
FLASH_TOL = {torch.float32: (1e-5, 1e-4, 1e-5),
             torch.bfloat16: (1e-2, 1e-2, 1e-2)}


def flash_vs_plain(gen, shapes=FLASH_SHAPES,
                   dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 11.  Returns the bf16 rows as (launches of that shape per UNet
    forward, max_abs, kernel ms, plain ms, SDPA ms, shape); untimed, the ms
    are NaN.  Raises after printing if any row fails."""
    log("flash kernel vs attention_ref: |k-p| <= a*max|p| + r*|p| and "
        "||k-p|| <= l2*||p||; a/r/l2 f32 "
        f"{FLASH_TOL[torch.float32]}, bf16 {FLASH_TOL[torch.bfloat16]}; "
        f"logits std {FLASH_PEAK}; SDPA is the library yardstick only")
    log(f"{'B,N,H,D':>16} {'dtype':>8} {'max|p|':>7} {'max_abs':>10} "
        f"{'tol_use':>8} {'l2':>10} {'repeat':>7} {'kernel_ms':>10} "
        f"{'plain_ms':>10} {'sdpa_ms':>10} {'bound_ms':>9}")
    rows, failures = [], []
    s = FLASH_PEAK ** 0.5
    for b, n, h, d, per_fwd in shapes:
        q32, k32, v32 = (torch.randn(b, n, h, d, generator=gen) * sc
                         for sc in (s, s, 1.0))
        for dtype in dtypes:
            q, k, v = (x.to("cuda", dtype) for x in (q32, k32, v32))
            with torch.inference_mode():
                got = fa.flash_attention(q, k, v)
                again = fa.flash_attention(q, k, v)
                want = fa.attention_ref(q, k, v)
                torch.cuda.synchronize()
            same = torch.equal(got, again)
            g, w = got.float(), want.float()
            diff = (g - w).abs()
            a, r, l2_bound = FLASH_TOL[dtype]
            peak = w.abs().max().item()
            use = (diff / (a * peak + r * w.abs())).max().item()
            l2 = (diff.norm() / w.norm()).item()
            max_abs = diff.max().item()
            finite = bool(torch.isfinite(g).all())
            del got, again, want, g, w, diff
            k_ms = p_ms = l_ms = float("nan")
            if timed:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                with torch.inference_mode():
                    k_ms = median_ms(lambda: fa.flash_attention(q, k, v),
                                     reps=10)
                    p_ms = median_ms(lambda: fa.attention_ref(q, k, v))
                    l_ms = median_ms(
                        lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        reps=10)
            name = str(dtype).split(".")[-1]
            bound = flash_bound_ms(b, n, h, d, torch.finfo(dtype).bits // 8)
            log(f"{f'{b},{n},{h},{d}':>16} {name:>8} {peak:7.3f} "
                f"{max_abs:10.3e} {use:8.3f} {l2:10.3e} {str(same):>7} "
                f"{k_ms:10.4f} {p_ms:10.4f} {l_ms:10.4f} {bound[0]:9.4f}")
            if not finite or use > 1.0 or l2 > l2_bound or not same:
                failures.append((b, n, h, d, name))
            if dtype == torch.bfloat16:
                rows.append((per_fwd, max_abs, k_ms, p_ms, l_ms,
                             (b, n, h, d)))
            del q, k, v
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"flash kernel disagrees with plain at {failures}")
    return rows


# ---------------------------------------------------------------------------
# Phases 12 and 13: pipeline A's towers and the generation path
# ---------------------------------------------------------------------------

# per flash launch shape at 512 px under CFG: 5 per UNet forward, 100 steps
FLASH_PER_IMAGE = 500
# tower on the card vs on the CPU (or the UNet through the kernel vs with
# attn_impl='plain'), float32: |card - cpu| <= TOWER_TOL max|cpu| at every
# element; cuBLAS/cuDNN and the CPU's f32 products sum in other orders
# through up to 32 layers
TOWER_TOL = 1e-3


def build_guidance(seed: int, dtype) -> GuidanceModules:
    """sd21_config towers on the card with the generation CLI's seeded
    random weights (`random_init`)."""
    with torch.device("cuda"):
        mods = GuidanceModules.sd21_config(num_words=20, dtype=dtype)
    return random_init(mods, torch.Generator("cuda").manual_seed(seed))


def _compare(what: str, got: torch.Tensor, want: torch.Tensor, extra=""):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    l2 = ((got - want).norm() / want.norm()).item()
    log(f"{what}: max_abs {err:.3e} at max|ref| {peak:.3f} (bound "
        f"{TOWER_TOL:g} max|ref|), L2 {l2:.3e}{extra}")
    if not torch.isfinite(got).all() or err > TOWER_TOL * peak:
        raise RuntimeError(f"{what}: the card disagrees ({err})")


def towers_vs_reference(seed: int):
    """Phase 12."""
    log(f"phase 12 float32, torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    mods = build_guidance(seed, torch.float32)
    gen = torch.Generator("cuda").manual_seed(seed + 1)
    unet = mods.unet
    with torch.device("cuda"):
        plain = UNet2DCondition(attn_impl="plain")
    plain.load_state_dict(unet.state_dict())
    lat = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    ctx = torch.randn(2, 77, 1024, generator=gen, device="cuda")
    ts = torch.tensor([981, 981], device="cuda")
    with torch.inference_mode():
        fa.flash_attention.launches = 0
        got = unet(lat, ts, ctx, use_global_kv=True)
        n_kernel = fa.flash_attention.launches
        want = plain(lat, ts, ctx, use_global_kv=True)
        n_plain = fa.flash_attention.launches - n_kernel
    _compare("UNet f32 2x64x64 (512 px), kernel vs attn_impl='plain' on the "
             "card", got, want, f"; launches {n_kernel} vs {n_plain}")
    if n_kernel != 5 or n_plain != 0:
        raise RuntimeError(f"UNet launches {n_kernel} / {n_plain}")
    del plain, got, want
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 5)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    ids, _, inj = tokenize_template(PROMPT_TEMPLATE)
    ids = torch.from_numpy(ids)
    words = arr(1, 20, 1024, scale=1024 ** -0.5)
    inj = torch.tensor([inj])
    pixels = arr(1, 224, 224, 3)
    z = arr(1, 16, 16, 4)
    lat = arr(1, 32, 64, 4)
    ctx = arr(1, 77, 1024)
    ts = torch.tensor([501])
    with torch.inference_mode():
        for what, mod, args, kw in (
                ("text tower with 20 injected words", mods.text_encoder,
                 (ids,), dict(inj_embedding=words, inj_index=inj)),
                ("vision tower 224 px", mods.image_encoder, (pixels,), {}),
                ("VAE decoder 16x16 latent", mods.vae, (z,), {}),
                ("UNet 1x32x64 latent (N = 2048)", mods.unet,
                 (lat, ts, ctx), dict(use_global_kv=True))):
            cpu = copy.deepcopy(mod).cpu()
            fn = (lambda m: m.decode) if mod is mods.vae else (lambda m: m)
            t0 = time.perf_counter()
            want = fn(cpu)(*args, **kw)
            cpu_s = time.perf_counter() - t0
            fa.flash_attention.launches = 0
            got = fn(mod)(*(a.cuda() for a in args), **{
                k: v.cuda() if torch.is_tensor(v) else v
                for k, v in kw.items()})
            if isinstance(want, tuple):
                got, want = got[0], want[0]
            _compare(f"{what}, card vs CPU", got, want,
                     f"; flash launches {fa.flash_attention.launches}; CPU "
                     f"{cpu_s:.1f} s")
            if what.startswith("vision"):
                embs = want
            del cpu
        for what, mod in (("I2T mapper", mods.mapper),
                          ("clean mapper", mods.clean_mapper)):
            cpu = copy.deepcopy(mod).cpu()
            want = cpu(embs)
            got = mod(embs.cuda())
            _compare(f"{what}, card vs CPU", got, want)
            embs = want
            del cpu
    del mods
    torch.cuda.empty_cache()


def synthetic_image(rng, h=600, w=480):
    """A smooth HWC float32 image in [0, 1] (not square: the CLI crops)."""
    low = rng.random((h // 24 + 1, w // 24 + 1, 3)).astype(np.float32)
    img = np.kron(low, np.ones((24, 24, 1), np.float32))[:h, :w]
    return np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1).astype(
        np.float32)


def generation_path(seed: int):
    """Phase 13.  Returns {dtype name: (seconds per image, DDIM step ms,
    peak GiB, flash launches over the images)}."""
    log(f"phase 13, cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(seed + 6)
    images = [synthetic_image(rng) for _ in range(3)]
    ids, uids, inj = tokenize_template(PROMPT_TEMPLATE)
    ids = torch.from_numpy(ids).cuda()
    uids = torch.from_numpy(uids).cuda()
    inj = torch.tensor([inj], dtype=torch.int32, device="cuda")
    out = {}
    for dtype, n_images in ((torch.bfloat16, 3), (torch.float32, 1)):
        name = str(dtype).split(".")[-1]
        mods = build_guidance(seed, dtype)
        held = torch.cuda.memory_allocated() / 2 ** 30
        log(f"{name} towers built: {held:.2f} GiB allocated before the "
            f"first image")
        gen = torch.Generator("cuda").manual_seed(seed)
        secs, launches = [], 0
        for i in range(n_images):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            img = generate_one(mods, images[i], ids, uids, inj, gen)
            secs.append(time.perf_counter() - t0)
            n = fa.flash_attention.launches
            launches += n
            log(f"generate_one {name} image {i} "
                f"({'warm-up' if n_images > 1 and i == 0 else 'timed'}): "
                f"{secs[-1]:.3f} s, flash launches {n}, output {img.shape} "
                f"{img.dtype}, mean {img.mean():.2f}")
            if n != FLASH_PER_IMAGE or img.shape != (512, 512, 3) \
                    or img.dtype != np.uint8:
                raise RuntimeError(f"generation: {n} launches, {img.shape}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        # one DDIM step at 512 px: the batch-2 UNet call, the guidance and
        # the scheduler update
        with torch.inference_mode():
            cond, _ = mods.text_encoder(ids)
            uncond, _ = mods.text_encoder(uids)
            ctx = torch.cat([uncond, cond])
            lat = torch.randn(1, 64, 64, 4, device="cuda", generator=gen)
            ts = torch.full((2,), 981, dtype=torch.int32, device="cuda")

            def step():
                o = mods.unet(torch.cat([lat, lat]), ts, ctx,
                              use_global_kv=True)
                o_u, o_c = o.chunk(2)
                return mods.scheduler.step(o_u + 5.0 * (o_c - o_u), 981, 971,
                                           lat)

            step_ms = median_ms(step, reps=5)
            profile_device(step, f"DDIM step 512 px {name}")
        timed = secs[1:] if n_images > 1 else secs
        per_image = statistics.median(timed)
        log(f"generation {name} 512 px, 100 steps, CFG 5: "
            f"{[round(v, 3) for v in secs]} s per image (median of the timed "
            f"{per_image:.3f} s, {1 / per_image:.4f} images/s), DDIM step "
            f"{step_ms:.2f} ms, peak memory {peak:.2f} GiB")
        out[name] = (per_image, step_ms, peak, launches)
        del mods
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 14: the flash backward kernels against their plain versions
# ---------------------------------------------------------------------------

# (B, N, H, D, backward launches of that shape per I2T micro-step at 512
# px, batch 4: the five 64 x 64 self-attentions but the first, which comes
# before every trainable parameter and so gets no gradient)
FLASH_BWD_PER_STEP = 4
FLASH_BWD_SHAPES = [
    (4, 4096, 5, 64, FLASH_BWD_PER_STEP),  # the training micro-step
    (2, 4096, 5, 64, 0),    # the CFG shape of generation
    (1, 4096, 5, 128, 0),   # head_dim 128
    (2, 2048, 10, 64, 0),   # the shortest sequence flash_applies routes
    (2, 1000, 3, 64, 0),    # ragged: no 64-row tile divides N
]
# backward kernels vs attention_bwd_ref and vs autograd through
# attention_ref, per gradient: |k - p| <= a max|p| + r |p| and
# ||k - p|| <= l2 ||p||.  float32: the same f32 math in other orders; dS =
# P (dP - di) cancels where dP is near di, which raises the sums' relative
# error on the gradients (the host build: L2 7e-7).  bfloat16: the kernel
# rounds P and dS to bf16 as product operands, the plain backward keeps
# them f32 and plain autograd rounds P and dP to bf16; each rounds the
# gradient once: about one bf16 ulp apart (the host build: L2 2.8e-3 vs
# the plain backward, 3.3e-3 vs autograd), while no_di and dk_unscaled
# read L2 above 1.
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-3, 1e-4),
                 torch.bfloat16: (2e-2, 2e-2, 1e-2)}
LSE_ATOL = 1e-4  # the forward's lse vs logsumexp of the f32 logits


def _grad_err(got, want, tol):
    """(max abs error, use of the elementwise bound, L2 relative error,
    within the bounds)."""
    a, r, l2_bound = tol
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    use = (diff / (a * w.abs().max() + r * w.abs())).max().item()
    l2 = (diff.norm() / w.norm()).item()
    ok = bool(torch.isfinite(g).all()) and use <= 1.0 and l2 <= l2_bound
    return diff.max().item(), use, l2, ok


def flash_bwd_vs_plain(gen, shapes=FLASH_BWD_SHAPES,
                       dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 14.  Returns the bf16 rows as (backward launches of that shape
    per training micro-step, max_abs vs the plain backward, kernel-pair ms,
    plain autograd backward ms, SDPA backward ms, shape); untimed, the ms
    are NaN.  Raises after printing if any row fails."""
    log("flash backward kernels vs attention_bwd_ref and autograd through "
        "attention_ref, per gradient: |k-p| <= a*max|p| + r*|p| and "
        "||k-p|| <= l2*||p||; a/r/l2 f32 "
        f"{FLASH_BWD_TOL[torch.float32]}, bf16 "
        f"{FLASH_BWD_TOL[torch.bfloat16]}; lse vs logsumexp to {LSE_ATOL}; "
        f"logits std {FLASH_PEAK}; SDPA's backward is the yardstick only")
    log(f"{'B,N,H,D':>16} {'dtype':>8} {'grad':>4} {'max_abs':>10} "
        f"{'use':>6} {'l2':>10} {'ag_use':>6} {'ag_l2':>10}")
    from textualdegremoval_tpu_torch.ops._build import load_library

    lib = load_library()
    rows, failures = [], []
    s = FLASH_PEAK ** 0.5
    for b, n, h, d, per_step in shapes:
        q32, k32, v32, do32 = (torch.randn(b, n, h, d, generator=gen) * sc
                               for sc in (s, s, 1.0, 1.0))
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            q, k, v, do = (x.to("cuda", dtype) for x in (q32, k32, v32,
                                                          do32))
            o, lse = fa._forward_kernel(q, k, v, want_lse=True)
            got = fa._backward_kernel(q, k, v, o, lse, do)
            again = fa._backward_kernel(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            lse_err = (lse - fa.lse_ref(q, k)).abs().max().item()
            ok = same and lse_err <= LSE_ATOL
            plain = fa.attention_bwd_ref(q, k, v, o, lse, do)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            auto = torch.autograd.grad(fa.attention_ref(*leaves), leaves, do)
            errs = []
            for gname, x, p, ag in zip(("dq", "dk", "dv"), got, plain, auto):
                m_abs, use, l2, ok_p = _grad_err(x, p, FLASH_BWD_TOL[dtype])
                _, ag_use, ag_l2, ok_a = _grad_err(x, ag, FLASH_BWD_TOL[dtype])
                ok = ok and ok_p and ok_a
                errs.append(m_abs)
                log(f"{f'{b},{n},{h},{d}':>16} {name:>8} {gname:>4} "
                    f"{m_abs:10.3e} {use:6.3f} {l2:10.3e} {ag_use:6.3f} "
                    f"{ag_l2:10.3e}")
            del again, plain, auto, leaves
            k_ms = p_ms = l_ms = float("nan")
            if timed:
                stream = torch.cuda.current_stream().cuda_stream
                k_ms = median_ms(lambda: fa._launch_bwd(lib, q, k, v, o, lse,
                                                        do, stream), reps=10)
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out = fa.attention_ref(*leaves)
                p_ms = median_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
                del out
                tl = [x.transpose(1, 2).detach().clone().requires_grad_(True)
                      for x in (q, k, v)]
                out = F.scaled_dot_product_attention(*tl)
                dot = do.transpose(1, 2)
                l_ms = median_ms(lambda: torch.autograd.grad(
                    out, tl, dot, retain_graph=True), reps=10)
                del out, tl, leaves
            bound = flash_bwd_bound_ms(b, n, h, d,
                                       torch.finfo(dtype).bits // 8)
            log(f"{f'{b},{n},{h},{d}':>16} {name:>8} lse max_abs "
                f"{lse_err:.3e}, repeat {same}; kernel pair {k_ms:.4f} ms, "
                f"plain autograd backward {p_ms:.4f} ms, SDPA backward "
                f"{l_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            if not ok:
                failures.append((b, n, h, d, name))
            if dtype == torch.bfloat16:
                rows.append((per_step, max(errs), k_ms, p_ms, l_ms,
                             (b, n, h, d)))
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"flash backward disagrees with plain at "
                           f"{failures}")
    return rows


# ---------------------------------------------------------------------------
# Phase 15: pipeline A's training path
# ---------------------------------------------------------------------------

# training flash launches per micro-step: forward, forward under remat,
# backward
FLASH_FWD_PER_STEP, FLASH_FWD_PER_REMAT_STEP = 5, 10
I2T_ACCUM = 4  # the CLI's default gradient_accumulation_steps
STEP_LOSS_RTOL, STEP_GRAD_L2 = 1e-5, 1e-3  # f32, kernel vs plain


def _train_args(**kw):
    """The training CLI's options for a run on seeded random towers."""
    argv = ["--train_data_dir", "unused", "--output_dir", "unused",
            "--random_init"]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return train_cli.parse_args("i2t", argv)


def guidance_batch(args, mods, rng, b):
    """The CLI's device batch of b numpy-made images at args.resolution
    (SD view in [-1, 1], the CLIP view: 224 px for ViT-H/14)."""
    size = args.resolution
    imgs = [synthetic_image(rng, size + 40, size + 24)[:size, :size]
            for _ in range(b)]
    ids, _, inj = train_cli.prompt_ids(args, mods)
    host = {"pixel_values": torch.from_numpy(np.stack(imgs) * 2 - 1),
            "pixel_values_clip": torch.from_numpy(np.stack([
                guidance_data.clip_view(im, mods.image_encoder.image_size)
                for im in imgs])),
            "index": [inj] * b}
    return train_cli.device_batch(host, ids, mods.device)


def set_flash(mods, on: bool):
    """Route the UNet's self-attentions through the kernels (True) or
    attention_ref (attn_impl='plain')."""
    for m in mods.unet.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = on


def _draws(mods, batch, gen):
    """Fixed noise, t and VAE eps for a batch (one generator draw)."""
    with torch.no_grad():
        mean, _ = mods.vae.encode_moments(batch["pixel_values"])
    return {"vae_eps": torch.randn(mean.shape, generator=gen,
                                   device=mean.device, dtype=mean.dtype),
            "noise": torch.randn(mean.shape, generator=gen,
                                 device=mean.device, dtype=mean.dtype),
            "t": torch.randint(0, 1000, (mean.shape[0],), generator=gen,
                               device=mean.device)}


def _counts():
    return fa.flash_attention.launches, fa.flash_attention.launches_bwd


def _reset_counts():
    fa.flash_attention.launches = fa.flash_attention.launches_bwd = 0


def training_path(seed: int):
    """Phase 15.  Returns (backward launches over the counted micro-steps,
    kernel micro-step ms, plain micro-step ms, kernel peak GiB, plain peak
    GiB, backward launches per micro-step)."""
    args = _train_args(mixed_precision="bf16")
    log(f"phase 15: train_i2t at {args.resolution} px, batch "
        f"{args.train_batch_size}, --mixed_precision bf16, accumulation "
        f"{args.gradient_accumulation_steps}, seeded random towers")
    mods = train_cli.build_towers(args, "i2t")
    _, step_fn, lr = train_cli.build_step(args, mods, "i2t")
    train, frozen = pipeline.partition(mods, "i2t")
    if {p.dtype for _, p in frozen} != {torch.bfloat16} or \
            {p.dtype for _, p in train} != {torch.float32}:
        raise RuntimeError("mixed precision: frozen towers not bf16 or "
                           "trainables not f32")
    rng = np.random.default_rng(seed + 7)
    batch = guidance_batch(args, mods, rng, args.train_batch_size)
    gen = torch.Generator(mods.device).manual_seed(seed)

    # warm-up: the loss and gradients outside the optimizer; every
    # trainable parameter gets a finite, non-zero gradient
    loss, grads = pipeline.guidance_loss_and_grads(mods, batch, "i2t", gen)
    bad = [n for n, g in grads.items()
           if not torch.isfinite(g).all() or not g.abs().max() > 0]
    log(f"warm-up micro-step: loss {float(loss):.5f}; {len(grads) - len(bad)}"
        f" of {len(grads)} trainable parameters with a finite non-zero "
        f"gradient")
    if bad or not np.isfinite(float(loss)):
        raise RuntimeError(f"gradients missing or not finite: {bad[:4]}")
    del grads

    frozen_before = [p.detach().clone() for _, p in frozen]
    train_prev = [p.detach().clone() for _, p in train]
    _reset_counts()
    moved_at = []
    for i in range(2 * I2T_ACCUM):
        before = _counts()
        loss = float(step_fn(batch, gen))
        fwd, bwd = (a - b for a, b in zip(_counts(), before))
        moved = [not torch.equal(p, q) for (_, p), q in zip(train,
                                                             train_prev)]
        if any(moved):
            moved_at.append(i + 1)
            train_prev = [p.detach().clone() for _, p in train]
        log(f"micro-step {i + 1}: loss {loss:.5f}, flash launches forward "
            f"{fwd} backward {bwd}, trainables moved {sum(moved)} of "
            f"{len(moved)}")
        if (fwd, bwd) != (FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP) or \
                not np.isfinite(loss) or any(moved) != all(moved):
            raise RuntimeError(f"micro-step {i + 1}: launches {fwd}/{bwd}, "
                               f"loss {loss}, moved {sum(moved)}")
    launches_fwd, launches_bwd = _counts()
    still = sum(torch.equal(p, q) for (_, p), q in zip(frozen,
                                                        frozen_before))
    log(f"8 micro-steps: flash launches forward {launches_fwd} backward "
        f"{launches_bwd}; trainables moved at micro-steps {moved_at}; "
        f"{still} of {len(frozen)} frozen parameters bitwise unchanged")
    if moved_at != [I2T_ACCUM, 2 * I2T_ACCUM] or still != len(frozen):
        raise RuntimeError("the accumulation or the frozen towers are wrong")
    del frozen_before, train_prev

    # remat: 5 more forward launches, loss and gradients bitwise equal to
    # the no-remat call's, as a second no-remat call is (cuDNN's
    # deterministic algorithms for this comparison only)
    draws = _draws(mods, batch, gen)
    torch.backends.cudnn.deterministic = True
    out = []
    for remat in (False, False, True):
        before = _counts()
        loss, grads = pipeline.guidance_loss_and_grads(
            mods, batch, "i2t", remat=remat, **draws)
        out.append((loss, grads,
                    tuple(a - b for a, b in zip(_counts(), before))))
    torch.backends.cudnn.deterministic = False

    def equal(x, y):
        return torch.equal(x[0], y[0]) and all(
            torch.equal(g, y[1][n]) for n, g in x[1].items())

    repeat, same = equal(out[1], out[0]), equal(out[2], out[0])
    log(f"no remat twice: bitwise equal {repeat}, launches {out[0][2]}; "
        f"remat: loss {float(out[2][0]):.6f}, launches {out[2][2]}, bitwise "
        f"equal to no remat {same}")
    if not (repeat and same) or out[0][2] != (
            FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP) or out[2][2] != (
            FLASH_FWD_PER_REMAT_STEP, FLASH_BWD_PER_STEP):
        raise RuntimeError("remat: launches or gradients differ")
    del out, grads

    # the micro-step through the kernels vs through attention_ref
    # (attn_impl='plain'), in alternating turns (CUDA events); peak memory
    turns = {"kernel": [], "plain": []}
    peak = {}
    for route in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        set_flash(mods, route == "kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        step_fn(batch, gen)
        e.record()
        torch.cuda.synchronize()
        turns[route].append(s.elapsed_time(e))
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
    set_flash(mods, True)
    k_ms = statistics.median(turns["kernel"])
    p_ms = statistics.median(turns["plain"])
    log(f"I2T micro-step {args.resolution} px batch "
        f"{args.train_batch_size} bf16, alternating turns: kernels "
        f"{[round(v, 2) for v in turns['kernel']]} ms, plain "
        f"{[round(v, 2) for v in turns['plain']]} ms; medians {k_ms:.2f} vs "
        f"{p_ms:.2f} ms; peak memory {peak['kernel']:.2f} vs "
        f"{peak['plain']:.2f} GiB; lr {lr:g}")
    profile_device(lambda: step_fn(batch, gen),
                   f"I2T micro-step {args.resolution} px bf16")
    del mods, batch, step_fn, train, frozen
    torch.cuda.empty_cache()

    f32_step_vs_plain(seed)
    return launches_bwd, k_ms, p_ms, peak["kernel"], peak["plain"]


def f32_step_vs_plain(seed: int):
    """Phase 15: one f32 I2T micro-step at batch 1 through the kernels
    against attn_impl='plain' on the card (TF32 off), the same draws: loss
    to 1e-5 relative, each trainable gradient to 1e-3 in L2; then one
    TR-stage update, after which only the clean mapper has moved."""
    args = _train_args(train_batch_size=1)
    mods = train_cli.build_towers(args, "i2t")
    batch = guidance_batch(args, mods, np.random.default_rng(seed + 8), 1)
    draws = _draws(mods, batch,
                   torch.Generator(mods.device).manual_seed(seed))
    res = {}
    for on in (True, False):
        set_flash(mods, on)
        _reset_counts()
        res[on] = pipeline.guidance_loss_and_grads(mods, batch, "i2t",
                                                   **draws)
        res[on] += (_counts(),)
    set_flash(mods, True)
    (lk, gk, ck), (lp, gp, cp) = res[True], res[False]
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    l2 = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in gk}
    worst = max(l2, key=l2.get)
    log(f"f32 I2T micro-step batch 1, kernels vs plain: loss {float(lk):.7f} "
        f"vs {float(lp):.7f} (rel {rel:.2e}, bound {STEP_LOSS_RTOL:g}); "
        f"gradients L2 median {statistics.median(l2.values()):.2e}, largest "
        f"{l2[worst]:.2e} ({worst}; bound {STEP_GRAD_L2:g}); launches "
        f"{ck} vs {cp}")
    if rel > STEP_LOSS_RTOL or l2[worst] > STEP_GRAD_L2 or \
            ck != (FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP) or cp != (0, 0):
        raise RuntimeError("f32 micro-step: kernels disagree with plain")
    del res, gk, gp

    opt = pipeline.make_guidance_optimizer(mods, "tr", lr=1e-5)
    step = pipeline.make_guidance_train_step(mods, opt, "tr")
    named = pipeline.partition(mods, "tr")
    before = {n: p.detach().clone() for part in named for n, p in part}
    loss = float(step(batch, **draws))
    moved = {n for part in named for n, p in part
             if not torch.equal(p, before[n])}
    want = {n for n, _ in named[0]}
    log(f"TR update: loss {loss:.5f}; {len(moved)} parameters moved, "
        f"{len(want)} clean_mapper parameters")
    if moved != want or not all(n.startswith("clean_mapper.") for n in want):
        raise RuntimeError(f"TR update moved {sorted(moved ^ want)[:4]}")
    del mods, before
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM


def bound_ms(kernel: str, b, h, w, c, heads, eb=2):
    """(ms, 'bytes' or 'operations') for one call at a shape, in bf16.
    Operations: the products of the block or its backward per pixel (the
    stencils, LayerNorms and softmax are below 3% and left out); bytes:
    each activation input read once, each output written once, the
    function's own f32 weights read once (and their gradients written once
    in a backward).  Each product is counted once, however many passes of
    the kernel recompute it.  Forward: qkv 6C^2, proj 2C^2, GDFN in 4Ch,
    out 2Ch (h = int(2.66 C)), gram and o 4 C cph.  GDFN half backward
    (x1, dout in; dx1 out; W_in, W_out): hid 4Ch, dgate 2Ch, dz 4Ch, dW1
    4Ch, dW2 2Ch.  Attention half backward (x, dx1 in; dx out; W_qkv,
    W_proj): q, k, v 6C^2, do 2C^2, dy 6C^2, dWqkv 6C^2, dWproj 2C^2, and
    per head o, dA, dv, dq, dk 10 C cph.  NAFBlock forward (x in, out
    out; its 1x1s, SCA, taps, biases and scales, 7 C^2 + 33 C values): conv1
    4C^2, conv3 2C^2, conv4 4C^2, conv5 2C^2 (heads ignored)."""
    npix = b * h * w
    hid = int(c * 2.66)
    cph = c // heads
    attn_w, gdfn_w = 4 * c * c * 4, 3 * c * hid * 4
    if kernel == "tblock_fused":
        flops = npix * (8 * c * c + 6 * c * hid + 4 * c * cph)
        nbytes = 2 * npix * c * eb + attn_w + gdfn_w
    elif kernel == "gdfn_half_bwd":
        flops = npix * 16 * c * hid
        nbytes = 3 * npix * c * eb + 2 * gdfn_w
    elif kernel == "attn_half_bwd":
        flops = npix * (22 * c * c + 10 * c * cph)
        nbytes = 3 * npix * c * eb + 2 * attn_w
    else:
        flops = npix * 12 * c * c
        nbytes = 2 * npix * c * eb + (7 * c * c + 33 * c) * 4
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(b, n, h, d, eb=2):
    """(ms, 'bytes' or 'operations') of one call: 4 B H N^2 D operations
    (q k^T and P v) at the peak of the element type (bf16 tensor cores, or
    float32 outside them), q, k, v read and o written once."""
    t_ops = 4 * b * h * n * n * d / (PEAK_BF16 if eb == 2 else PEAK_F32)
    t_bytes = 4 * b * n * h * d * eb / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_bwd_bound_ms(b, n, h, d, eb=2):
    """(ms, 'bytes' or 'operations') of one backward (the dkv and dq pair):
    10 B H N^2 D operations (the recomputed S, dP, dV, dK and dQ, each
    counted once however many times the kernels recompute it) at the peak
    of the element type, q, k, v, o, do read and dq, dk, dv written once."""
    t_ops = 10 * b * h * n * n * d / (PEAK_BF16 if eb == 2 else PEAK_F32)
    t_bytes = 8 * b * n * h * d * eb / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plant", choices=sorted(FAULTS), default=None,
                    help="plant a fault in a copy of the sources and show "
                         "that its phase catches it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.plant:
        plant_fault(args.plant)
    so, secs = _build.build()
    _build.load_library()
    log(f"built {so.name} with {' '.join(_build.NVCC_FLAGS)} in {secs:.1f} s")
    log(so.with_suffix(".log").read_text().strip())

    gen = torch.Generator().manual_seed(args.seed)
    if args.plant:
        try:
            if FAULTS[args.plant][3] == 6:
                backward_vs_plain(gen, [TRAIN_SHAPES[i] for i in (0, 4, 7, 8)],
                                  dtypes=(torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 11:
                flash_vs_plain(gen, dtypes=(torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 14:
                flash_bwd_vs_plain(gen, [FLASH_BWD_SHAPES[i]
                                         for i in (1, 2, 4)],
                                   dtypes=(torch.bfloat16,), timed=False)
            else:
                nafblock_vs_plain(gen, [NAF_SHAPES[i] for i in (7, 8, 10)],
                                  dtypes=(torch.bfloat16,), timed=False)
        except RuntimeError as e:
            log(f"planted fault {args.plant} caught: {e}")
            return 0
        log(f"planted fault {args.plant} NOT caught")
        return 1

    t_start = time.perf_counter()
    rows = kernel_vs_plain(gen)
    network_vs_cpu(args.seed)
    eval_launches, _ = main_path(args.seed)
    bwd_rows = backward_vs_plain(gen)
    remat_vs_save(gen)
    launches, step_ms, plain_step_ms, peak, _ = train_main_path(args.seed)
    train_step_vs_cpu(args.seed)
    log(f"launches: evaluation path tblock_fused {eval_launches}; training "
        f"main path (4 steps) tblock_fused/gdfn_half_bwd/attn_half_bwd "
        f"{launches}")
    log_held("phases 3-7")

    naf_rows = nafblock_vs_plain(gen, NAF_SHAPES + NAF_TRAIN_SHAPES[:2])
    network_vs_cpu(args.seed, NAF_TASK, nb.nafblock_fused, NAF_BLOCKS)
    naf_launches, naf_fwd_ms = main_path(args.seed, NAF_TASK,
                                         nb.nafblock_fused, NAF_BLOCKS)
    naf_train_rows = nafblock_vs_plain(gen, NAF_TRAIN_SHAPES,
                                       dtypes=(torch.bfloat16,))
    (naf_train_launches, naf_step_ms, naf_plain_step_ms, naf_peak,
     naf_plain_peak) = train_main_path(
        args.seed, NAF_TRAIN_OPT, (nb.nafblock_fused,), (NAF_BLOCKS,),
        ("nafblock_fused", _plain_nafblocks))
    naf_main = [r for r in naf_rows if r[4][0] == 1 and r[0]]
    log(f"nafblock_fused per 512 px forward (bf16, per-shape medians times "
        f"blocks): kernel {sum(n * k for n, _, k, _, _ in naf_main):.3f} ms, "
        f"plain {sum(n * p for n, _, _, p, _ in naf_main):.3f} ms; per 384 px "
        f"batch-8 step: kernel "
        f"{sum(n * k for n, _, k, _, _ in naf_train_rows):.3f} ms, plain "
        f"{sum(n * p for n, _, _, p, _ in naf_train_rows):.3f} ms")
    log(f"launches: nafnet evaluation path nafblock_fused {naf_launches}; "
        f"training path (4 steps) {naf_train_launches}")
    log_held("phases 8-10")

    flash_rows = flash_vs_plain(gen)
    log_held("phase 11")
    towers_vs_reference(args.seed)
    log_held("phase 12")
    gen_out = generation_path(args.seed)
    flash_main = [r for r in flash_rows if r[0]]
    flash_launches = sum(v[3] for v in gen_out.values())
    log(f"launches: generation path flash_attention {flash_launches} "
        f"({', '.join(f'{k} {v[3]}' for k, v in gen_out.items())})")

    bwd_flash_rows = flash_bwd_vs_plain(gen)
    (bwd_launches, i2t_ms, i2t_plain_ms, i2t_peak,
     i2t_plain_peak) = training_path(args.seed)
    log(f"launches: training path flash_attention_bwd {bwd_launches} over "
        f"{2 * I2T_ACCUM} micro-steps")
    bwd_main = [r for r in bwd_flash_rows if r[0]]

    # per-step kernel time: each training shape's median time times the
    # number of blocks of that shape in one step (bf16, WithBias); the
    # forward's from phase 3 at the evaluation shapes, per forward
    def bounds(kernel, shapes):
        """Sum over one pass's blocks, and what bounds the largest term."""
        per = [(n, *bound_ms(kernel, b, h, w, c, heads))
               for b, h, w, c, heads, n in shapes if n]
        return (sum(n * ms for n, ms, _ in per),
                max(per, key=lambda r: r[0] * r[1])[2])

    fwd_bound, fwd_by = bounds("tblock_fused", SHAPES)
    naf_bound, naf_by = bounds("nafblock_fused",
                               [(b, h, w, c, 1, n) for b, h, w, c, n in
                                NAF_SHAPES])
    g_bound, g_by = bounds("gdfn_half_bwd", TRAIN_SHAPES)
    a_bound, a_by = bounds("attn_half_bwd", TRAIN_SHAPES)
    src = "textualdegremoval_tpu_torch/csrc/"
    summary = {"kernels": [
        {"name": "tblock_fused", "route": "cuda", "source": src + "tblock.cu",
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock.py:557",
         "launches": launches[0],
         "max_abs_err": max(r[1] for r in rows),
         "ms": sum(n * k for n, _, k, _ in rows),
         "plain_ms": sum(n * p for n, _, _, p in rows),
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None},
        {"name": "gdfn_half_bwd", "route": "cuda",
         "source": src + "tblock_bwd.cu",
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock_bwd.py:253",
         "launches": launches[1],
         "max_abs_err": max(r[2] for r in bwd_rows),
         "ms": sum(r[0] * r[4] for r in bwd_rows),
         "plain_ms": sum(r[0] * r[6] for r in bwd_rows),
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": None},
        {"name": "attn_half_bwd", "route": "cuda",
         "source": src + "tblock_attn_bwd.cu",
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock_attn_bwd.py:312",
         "launches": launches[2],
         "max_abs_err": max(r[3] for r in bwd_rows),
         "ms": sum(r[0] * r[5] for r in bwd_rows),
         "plain_ms": sum(r[0] * r[7] for r in bwd_rows),
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": None},
        {"name": "nafblock_fused", "route": "cuda",
         "source": src + "nafblock.cu",
         "replaces": "textualdegremoval_tpu/ops/pallas/nafblock.py:246",
         "launches": naf_launches,
         "max_abs_err": max(r[1] for r in naf_main),
         "ms": sum(n * k for n, _, k, _, _ in naf_main),
         "plain_ms": sum(n * p for n, _, _, p, _ in naf_main),
         "bound_ms": naf_bound, "bound_by": naf_by, "library_ms": None},
        # per 512 px UNet forward (5 launches at (2, 4096, 5, 64), bf16)
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attn.cu",
         "replaces": "textualdegremoval_tpu/ops/flash_attn.py:53",
         "launches": flash_launches,
         "max_abs_err": max(r[1] for r in flash_main),
         "ms": sum(r[0] * r[2] for r in flash_main),
         "plain_ms": sum(r[0] * r[3] for r in flash_main),
         "bound_ms": sum(r[0] * flash_bound_ms(*r[5])[0] for r in flash_main),
         "bound_by": flash_bound_ms(*flash_main[0][5])[1],
         "library_ms": sum(r[0] * r[4] for r in flash_main)},
        # per I2T micro-step at 512 px, batch 4 (4 pairs at (4, 4096, 5,
        # 64), bf16)
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "textualdegremoval_tpu/ops/flash_attn.py:59 (stock "
                     "_flash_attention_bwd: _flash_attention_bwd_dkv, "
                     "_flash_attention_bwd_dq)",
         "launches": bwd_launches,
         "max_abs_err": max(r[1] for r in bwd_flash_rows),
         "ms": sum(r[0] * r[2] for r in bwd_main),
         "plain_ms": sum(r[0] * r[3] for r in bwd_main),
         "bound_ms": sum(r[0] * flash_bwd_bound_ms(*r[5])[0]
                         for r in bwd_main),
         "bound_by": flash_bwd_bound_ms(*bwd_main[0][5])[1],
         "library_ms": sum(r[0] * r[4] for r in bwd_main)},
    ]}
    log(f"train step 384 px batch 8 bf16: {step_ms:.2f} ms through the "
        f"kernels vs {plain_step_ms:.2f} ms through plain blocks, peak "
        f"{peak:.2f} GiB")
    log(f"nafnet: forward 512 px bf16 {naf_fwd_ms:.2f} ms "
        f"({1e3 / naf_fwd_ms:.3f} images/s); train step 384 px batch 8 bf16 "
        f"{naf_step_ms:.2f} ms through the kernel vs {naf_plain_step_ms:.2f} "
        f"ms through plain blocks, peak {naf_peak:.2f} vs "
        f"{naf_plain_peak:.2f} GiB")
    for name, (per_image, step_ms, peak_gib, _) in gen_out.items():
        log(f"pipeline A {name}: {per_image:.3f} s per 512 px image "
            f"({1 / per_image:.4f} images/s), DDIM step {step_ms:.2f} ms, "
            f"peak {peak_gib:.2f} GiB")
    log(f"pipeline A training: I2T micro-step 512 px batch 4 bf16 "
        f"{i2t_ms:.2f} ms through the kernels vs {i2t_plain_ms:.2f} ms "
        f"through attention_ref, peak {i2t_peak:.2f} vs {i2t_plain_peak:.2f} "
        f"GiB")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s after "
        f"the build")
    log(json.dumps(summary))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
