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
   against the same step on the CPU.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it is nvidia-smi's, and before that a JSON summary of each kernel.  Without
CUDA the script exits non-zero and prints no result.

    python3 chip_smoke.py --plant dv_uses_a|dq_drops_diag

builds a copy of the kernel sources with one fault planted, under a
temporary directory, runs phase 6 in bfloat16 at a few shapes and exits
0 only if the check catches the fault (the strength of phase 6's bound).
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

from textualdegremoval_tpu_torch.cli.evaluate import (
    TASK_TABLE, restore_and_score,
)
from textualdegremoval_tpu_torch.cli.train_restoration import resolve_network
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models import layers
from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.ops import _build
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


def build_network(seed: int, dtype, device) -> torch.nn.Module:
    """restormer_deblur at full width with seeded random weights; the
    zero-initialised fusion gates and unit temperatures are set to non-zero
    random values so every block's output reaches the result."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = define_network(TASK_TABLE[TASK], dtype=dtype)
    return gate_and_temperatures(model, seed).to(device)


def gate_and_temperatures(model, seed):
    """Non-zero fusion gates and non-unit temperatures, drawn from a seed,
    so that every block's output reaches the result."""
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("alpha"):
                p.copy_(0.25 + 0.5 * torch.rand(p.shape, generator=gen))
            elif name.endswith("temperature"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
    return model


def network_vs_cpu(seed: int):
    """Phase 4: the network on the card (kernel) vs on the CPU (plain)."""
    model_cpu = build_network(seed, torch.float32, "cpu")
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(seed + 2)
    lq = rng.random((1, 128, 128, 3), dtype=np.float32)
    ref = rng.random((1, 128, 128, 3), dtype=np.float32)
    with torch.inference_mode():
        want = model_cpu(torch.from_numpy(lq), torch.from_numpy(ref))
        got = model_gpu(torch.from_numpy(lq).cuda(),
                        torch.from_numpy(ref).cuda()).cpu()
    err = (got - want).abs().max().item()
    log(f"network f32 128x128, card (kernel) vs CPU (plain): max_abs {err:.3e}"
        f" (atol {NET_ATOL}), max|out| {want.abs().max().item():.3f}")
    if not torch.isfinite(got).all() or err > NET_ATOL:
        raise RuntimeError(f"network on the card disagrees with the CPU: {err}")


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


def main_path(seed: int):
    """Phase 5, the evaluation path.  Returns its tblock_fused launches."""
    model = build_network(seed, torch.bfloat16, "cuda")
    rng = np.random.default_rng(seed + 3)
    triples = [synthetic_triple(rng) for _ in range(2)]
    tb.tblock_fused.launches = 0
    forwards = 0
    _, psnr, ssim = restore_and_score(model, *triples[0])
    forwards += 1
    log(f"warm-up psnr {psnr:.4f} ssim {ssim:.4f}")
    for i, (lq, hq, ref) in enumerate(triples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, psnr, ssim = restore_and_score(model, lq, hq, ref)
        ms = (time.perf_counter() - t0) * 1e3
        forwards += 1
        if pred.shape != hq.shape or not np.isfinite(pred).all() \
                or not np.isfinite(psnr) or not np.isfinite(ssim):
            raise RuntimeError(f"image {i}: bad output {pred.shape}")
        log(f"image {i}: {ms:.1f} ms (restore + score), psnr {psnr:.4f} "
            f"ssim {ssim:.4f}")
    launches = tb.tblock_fused.launches
    log(f"tblock_fused launches {launches} over {forwards} forwards")
    if launches != 52 * forwards:
        raise RuntimeError(f"expected {52 * forwards} kernel launches, "
                           f"got {launches}")

    lq, _, ref = triples[0]
    args = [torch.from_numpy(a)[None].to("cuda", torch.bfloat16)
            for a in (lq, ref)]
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args), reps=3)
    log(f"forward 512x512 bf16: {fwd_ms:.2f} ms ({1e3 / fwd_ms:.3f} images/s)"
        f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


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
FAULTS = {
    # dv = do . A^T in place of do . A in pass 2 of the attention half
    "dv_uses_a": ("tblock_attn_bwd.cu", "MatB<T>{at + mo, 1, cph}",
                  "MatB<T>{at + mo, cph, 1}"),
    # the norm-backward diagonal term q Dq dropped from dq
    "dq_drops_diag": ("tblock_attn_bwd.cu",
                      "a + qv * dqd[(size_t)b * C + hd * cph + n]", "a"),
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
    src, old, new = FAULTS[fault]
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


def _launch_counts():
    return (tb.tblock_fused.launches, gb.gdfn_half_bwd.launches,
            ab.attn_half_bwd.launches)


def _zero_counts():
    tb.tblock_fused.launches = 0
    gb.gdfn_half_bwd.launches = 0
    ab.attn_half_bwd.launches = 0


def _plain_blocks(x, p, heads, ln_type="WithBias", kw=None,
                  bwd_mode="save"):
    """The plain-autograd route of the comparison turns (never the main
    path): tblock_ref, checkpointed per block, since autograd's saved
    tensors of 52 plain blocks at 384 px batch 8 would not fit the card."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(tb.tblock_ref, x, p, heads, ln_type,
                      use_reentrant=False)


def train_main_path(seed: int):
    """Phase 7.  Returns ({kernel: launches over the counted steps},
    kernel step ms, plain step ms, peak GiB)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _, _ = resolve_network(TRAIN_OPT, mixed_precision="bf16",
                                      device="cuda")
    model = gate_and_temperatures(model, seed).cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed + 4)
    trip = [synthetic_triple(rng, 384) for _ in range(8)]
    batch = {k: torch.from_numpy(np.stack([t[i] for t in trip])).cuda()
             for i, k in enumerate(("lq", "gt", "ref"))}

    # warm-up: one frozen and one released step, then back to the start
    state, step_fn, frozen_fn = _trainer(model, TRAIN_OPT["train"])
    state, _ = frozen_fn(state, batch)
    state, _ = step_fn(state, batch)
    model.load_state_dict(init)
    state, step_fn, frozen_fn = _trainer(model, TRAIN_OPT["train"])
    torch.cuda.synchronize()

    totals = [0, 0, 0]
    names = [n for n, _ in model.named_parameters()]
    for i in range(4):
        frozen = state.opt.count < state.opt.fix
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = (frozen_fn if frozen else step_fn)(state, batch)
        loss = float(m["l_pix"])
        ms = (time.perf_counter() - t0) * 1e3
        counts = _launch_counts()
        totals = [a + b for a, b in zip(totals, counts)]
        log(f"train step {i + 1} ({'frozen' if frozen else 'released'}): "
            f"{ms:.1f} ms, l_pix {loss:.5f}, grad_norm "
            f"{float(m['grad_norm']):.4e}, launches fwd/gdfn_bwd/attn_bwd "
            f"{counts}")
        if counts != (52, 52, 52) or not np.isfinite(loss):
            raise RuntimeError(f"step {i + 1}: launches {counts}, loss {loss}")
        if i == 1:
            sd = model.state_dict()
            moved = [n for n in names if "masa" in n
                     and not torch.equal(sd[n], init[n])]
            if moved:
                raise RuntimeError(f"masa parameters moved while frozen: "
                                   f"{moved[:3]}")
    sd = model.state_dict()
    still = [n for n in names if "masa" not in n
             and torch.equal(sd[n], init[n])]
    masa_moved = sum(not torch.equal(sd[n], init[n]) for n in names
                     if "masa" in n)
    log(f"after 2 frozen + 2 released steps: {len(still)} trunk parameters "
        f"unmoved, {masa_moved} masa parameters moved")
    if still:
        raise RuntimeError(f"trunk parameters did not move: {still[:3]}")

    # one step with the memory-lean backward: 52 more forward launches
    for mod in model.modules():
        if isinstance(mod, TransformerBlock):
            mod.bwd_mode = "remat"
    _zero_counts()
    state, m = step_fn(state, batch)
    counts = _launch_counts()
    log(f"remat step: launches fwd/gdfn_bwd/attn_bwd {counts}, l_pix "
        f"{float(m['l_pix']):.5f}")
    if counts != (104, 52, 52):
        raise RuntimeError(f"remat step launches {counts}")
    for mod in model.modules():
        if isinstance(mod, TransformerBlock):
            mod.bwd_mode = "save"

    # the step through the kernels vs through plain-autograd blocks, in
    # alternating turns; peak memory of each
    turns = {"kernel": [], "plain": []}
    peak = {}
    for route in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        if route == "plain":
            layers.tblock_fused = _plain_blocks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["l_pix"])
        torch.cuda.synchronize()
        turns[route].append((time.perf_counter() - t0) * 1e3)
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
        layers.tblock_fused = tb.tblock_fused
    k_ms = statistics.median(turns["kernel"])
    p_ms = statistics.median(turns["plain"])
    profile_step(step_fn, state, batch)
    log(f"train step 384 px batch 8 bf16, alternating turns: kernel "
        f"{[round(v, 2) for v in turns['kernel']]} ms, plain blocks "
        f"{[round(v, 2) for v in turns['plain']]} ms; medians {k_ms:.2f} vs "
        f"{p_ms:.2f} ms; peak memory {peak['kernel']:.2f} vs "
        f"{peak['plain']:.2f} GiB")
    del state, model, batch
    torch.cuda.empty_cache()
    return totals, k_ms, p_ms, peak["kernel"]


def profile_step(step_fn, state, batch):
    """Device time of one kernel-path step by kernel (torch.profiler), the
    share of the block kernels, and the device's idle share of the step's
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["l_pix"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels)
    if busy <= 0:
        log("profiler: no device time recorded")
        return
    ours = ("tblock_", "gdfn_bwd", "attn_bwd", "wgrad")
    mine = sum(t for k, t, _ in kernels if any(o in k for o in ours))
    log(f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall:.4f}; the block kernels {mine:.1f} ms "
        f"({mine / busy:.3f} of device time)")
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
# Bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
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
    per head o, dA, dv, dq, dk 10 C cph."""
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
    else:
        flops = npix * (22 * c * c + 10 * c * cph)
        nbytes = 3 * npix * c * eb + 2 * attn_w
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plant", choices=sorted(FAULTS), default=None,
                    help="plant a fault in a copy of the sources and show "
                         "that phase 6 catches it")
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
            backward_vs_plain(gen, [TRAIN_SHAPES[i] for i in (0, 4, 7, 8)],
                              dtypes=(torch.bfloat16,), timed=False)
        except RuntimeError as e:
            log(f"planted fault {args.plant} caught: {e}")
            return 0
        log(f"planted fault {args.plant} NOT caught")
        return 1

    rows = kernel_vs_plain(gen)
    network_vs_cpu(args.seed)
    eval_launches = main_path(args.seed)
    bwd_rows = backward_vs_plain(gen)
    remat_vs_save(gen)
    launches, step_ms, plain_step_ms, peak = train_main_path(args.seed)
    train_step_vs_cpu(args.seed)
    log(f"launches: evaluation path tblock_fused {eval_launches}; training "
        f"main path (4 steps) tblock_fused/gdfn_half_bwd/attn_half_bwd "
        f"{launches}")

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
    ]}
    log(f"train step 384 px batch 8 bf16: {step_ms:.2f} ms through the "
        f"kernels vs {plain_step_ms:.2f} ms through plain blocks, peak "
        f"{peak:.2f} GiB")
    log(json.dumps(summary))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
