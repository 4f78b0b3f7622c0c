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
5. the main path: `restore_and_score` of the evaluation CLI on three
   synthetic 512 x 512 (lq, hq, ref) triples in bfloat16, one warm-up and
   three timed, counting kernel launches (52 blocks per forward).

The last line of stdout is {"ok": true, "device": {...}}; the line before
it is nvidia-smi's, and before that a JSON summary of each kernel.  Without
CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from textualdegremoval_tpu_torch.cli.evaluate import (
    TASK_TABLE, restore_and_score,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb

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
        model = define_network(TASK_TABLE[TASK])
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("alpha"):
                p.copy_(0.25 + 0.5 * torch.rand(p.shape, generator=gen))
            elif name.endswith("temperature"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
    return model.to(device=device, dtype=dtype)


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
    """Phase 5.  Returns (launches, forwards)."""
    model = build_network(seed, torch.bfloat16, "cuda")
    rng = np.random.default_rng(seed + 3)
    triples = [synthetic_triple(rng) for _ in range(3)]
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
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args), reps=3)
    log(f"forward 512x512 bf16: {fwd_ms:.2f} ms ({1e3 / fwd_ms:.3f} images/s)"
        f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
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

    so, secs = _build.build()
    _build.load_library()
    log(f"built {so.name} with {' '.join(_build.NVCC_FLAGS)} in {secs:.1f} s")
    log(so.with_suffix(".log").read_text().strip())

    gen = torch.Generator().manual_seed(args.seed)
    rows = kernel_vs_plain(gen)
    network_vs_cpu(args.seed)
    launches = main_path(args.seed)

    # per-forward kernel time: each main-path shape's median time times the
    # number of blocks of that shape in one forward (bf16, WithBias)
    summary = {"kernels": [{
        "name": "tblock_fused",
        "route": "cuda",
        "source": "textualdegremoval_tpu_torch/csrc/tblock.cu",
        "replaces": "textualdegremoval_tpu/ops/pallas/tblock.py:680",
        "launches": launches,
        "max_abs_err": max(r[1] for r in rows),
        "ms": sum(n * k for n, _, k, _ in rows),
        "plain_ms": sum(n * p for n, _, _, p in rows),
    }]}
    log(json.dumps(summary))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
