"""The bf16 Restormer block backward (`gdfn_half_bwd`, `attn_half_bwd`) at
every block shape of a 384 px batch-8 training step, this version against
another version of the port, on the card; or, with --reckon, this design's
reckoning of those shapes (no card).

    python -m textualdegremoval_tpu_torch.tools.bench_block_bwd \\
        [--other ROOT] [--reckon] [--split]

--other ROOT is the root of another checkout of the repository (a `git
archive` of the parent under build/, say).  Its csrc/ is built into a
library of its own, and its own ops/_build.py, ops/pallas/tblock_bwd.py and
ops/pallas/tblock_attn_bwd.py drive that library, so each version runs its
own launch code on the same inputs.  The tool prints, for each source of
the other version, whether ptxas's report is the same as this version's
(the anonymous namespaces' path hashes and the compile times taken out),
then per shape one JSON line per version, in turns other, this, this,
other:

  - gdfn_ms, attn_ms: `tools/_card.py` `time_ms` of one call of each
    half's launch code (validated inputs, its weight-gradient products and
    glue included; `attn_half_bwd` from pass 1 on), the median of runs of
    calls behind a spin of the stream;
  - gdfn_l2, attn_l2: the largest relative L2 error of the half's
    gradients against plain autograd (`*_half_bwd_ref`);

and last, per version, the sums over one step's blocks (the median of the
version's turns at each shape, times the blocks of that shape).  --reckon
prints, per shape and per kernel of this design, the model of PERF.md's
reckoning: shared memory and CTAs per SM, CTAs and waves, products as run
(GFLOP), CUDA-core instructions (G), bytes moved (GB) and the predicted
ms, and the predicted sums per step by group (the GDFN half, the
attention half's pass 1 and pass 2, the weight-gradient products with the
forward's gram) with the bounds of the last two.  --split times instead,
at each shape, each version's halves split by kernel group
(`device_groups`: pass 1 and wgrad among them; with --other in the turns
above), then this version's weight-gradient products one by one on the
operands a block call hands them (the forward's gram, dW1, dW2, dA,
dWproj, dWqkv: csrc/wgrad.cu through `_wgrad`, beside one torch.matmul
of A^T and B, and the product's bound) and its bf16 pass 1 pass by pass,
and prints their sums over one step.
"""

from __future__ import annotations

import argparse
import contextlib
import difflib
import importlib.util
import json
import statistics
import sys
from pathlib import Path
from unittest import mock

import torch

from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
from textualdegremoval_tpu_torch.ops.pallas import tblock_attn_bwd as ab
from textualdegremoval_tpu_torch.ops.pallas import tblock_bwd as gb
from textualdegremoval_tpu_torch.tools._card import device_line, time_ms
from textualdegremoval_tpu_torch.tools.bench_flash import ptxas_reports

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
ITERS = 3
REPEATS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="root of another checkout, built and timed beside "
                         "this one")
    ap.add_argument("--reckon", action="store_true",
                    help="print the design's reckoning and exit (no card)")
    ap.add_argument("--split", action="store_true",
                    help="time this version's weight-gradient products "
                         "(beside torch.matmul) and pass 1's passes one by "
                         "one at each shape, and exit")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# The reckoning: a model of this design's kernels, from their shapes
# ---------------------------------------------------------------------------

SMS, CLOCK_HZ = 132, 1.755e9  # H100 SXM
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
# what a first, simple version reaches of each peak: the products on a
# 3-stage ring that waits for each step's wgmma; the streams of a pass
# over device memory; CUDA-core instructions (4 schedulers x 32 lanes an
# SM a clock) at 16 resident warps or fewer
EFF_TC, EFF_BYTES, EFF_CORES = 0.4, 0.75, 0.5
CORE_RATE = SMS * 128 * CLOCK_HZ  # lane-instructions per second


def _up(a, m):
    return -(-a // m) * m


def _gemm(npix, k, n, a_bytes, out_bytes):
    """(GFLOP as run, GB, CTAs) of bwd_gemm.cu's kernel: K in steps of 64,
    N in tiles of 64 or 128, 128 rows a CTA."""
    bn = 64 if n <= 64 else 128
    flops = 2 * npix * _up(k, 64) * _up(n, bn)
    nbytes = npix * k * a_bytes + npix * n * out_bytes
    return flops / 1e9, nbytes / 1e9, -(-npix // 128) * -(-n // bn)


# what the bf16 weight-gradient ring reaches of the memory rate: a first
# version that waits for each stage's wgmma before it frees the stage
EFF_WGRAD = 0.6


def _wgrad(npix, m, n, batches=1):
    """(GFLOP as run, GB, CTAs, CTAs per SM, splits) of csrc/wgrad.cu's bf16
    kernel for out = A^T B over npix pixels a batch: tiles of 64 or 128
    rows by 64-256 columns, each operand read once per tile of the other
    side, 4-stage rings of 8 KB boxes, one wave of CTAs; the f32 partials
    written, then read and the sum written by torch."""
    bm = 64 if m <= 64 else 128
    bn = 64 if n <= 64 else 128 if n <= 128 else 192 if n <= 192 else 256
    mt, nt = -(-m // bm), -(-n // bn)
    per_sm = 233472 // (4 * (bm + bn) * 128 + 64 + 2048)
    tiles = mt * nt * batches
    cap = max(1, 256 * 2 ** 20 // (4 * m * n * batches))
    nsplit = max(1, min(per_sm * SMS // tiles, -(-npix // 256), cap))
    flops = 2 * _up(npix, 64) * bm * mt * bn * nt * batches
    nbytes = (2 * npix * batches * (m * nt + n * mt)
              + 4 * m * n * batches * (2 * nsplit + 1))
    return flops / 1e9, nbytes / 1e9, tiles * nsplit, per_sm, nsplit


def wgrad_products(b, h, w, c, heads):
    """{name: (pixels a batch, M, N, batches)} of the weight-gradient
    products of one block's backward, and the forward's gram."""
    hpad = _up(int(c * 2.66), 32)
    cph, hw = c // heads, h * w
    return {"dW1": (b * hw, c, 2 * hpad, 1), "dW2": (b * hw, hpad, c, 1),
            "dA": (hw, cph, cph, b * heads), "dWproj": (b * hw, c, c, 1),
            "dWqkv": (b * hw, c, 3 * c, 1),
            "gram (forward)": (hw, cph, cph, b * heads)}


def wgrad_bound_ms(npix, m, n, batches):
    """The least time of one product: its operands read once and its f32
    output written once, or its operations at the bf16 peak."""
    return max(2 * npix * m * n * batches / PEAK_BF16,
               (2 * npix * batches * (m + n) + 4 * m * n * batches)
               / PEAK_BYTES) * 1e3


def reckon(b, h, w, c, heads):
    """{kernel: (group, smem KB, CTAs per SM, CTAs, waves, GFLOP as run, G
    instructions, GB, predicted ms)} of this design's bf16 kernels at one
    shape; group is the GDFN half, the attention half's pass 1 or pass 2,
    or the weight-gradient products (the forward's gram among them)."""
    npix, cph = b * h * w, c // heads
    hpad = _up(int(c * 2.66), 32)
    tiles = -(-h // 8) * -(-w // 16) * b
    rows = {}

    def add(group, name, smem_kb, per_sm, ctas, gflop, ginstr, gb_,
            eff_bytes=EFF_BYTES):
        ms = max(gflop * 1e9 / (PEAK_BF16 * EFF_TC),
                 ginstr * 1e9 / (CORE_RATE * EFF_CORES),
                 gb_ * 1e9 / (PEAK_BYTES * eff_bytes)) * 1e3
        rows[name] = (group, smem_kb, per_sm, ctas, ctas / (per_sm * SMS),
                      gflop, ginstr, gb_, ms)

    gemm_kb = {64: 73, 128: 97}  # 3 stages of A 16 KB + B, two CTAs an SM

    def gemm(group, name, k, n, a_bytes, out_bytes, rows_=npix, batches=1):
        gf, gbytes, ctas = _gemm(rows_, k, n, a_bytes, out_bytes)
        add(group, name, gemm_kb[64 if n <= 64 else 128], 2, ctas * batches,
            gf * batches, 0.0, gbytes * batches)

    ln_bytes = npix * c * 4 / 1e9
    add("gdfn", "ln_rows (LN2)", 0, 8, -(-npix // 8), 0.0, 0.0, ln_bytes)
    gemm("gdfn", "gemm hid = z.W1", c, 2 * hpad, 2, 2)
    gemm("gdfn", "gemm dgate = dout.W2^T", c, hpad, 2, 4)
    # per (tile, 32-channel chunk): d1, d2 and gelu on the 180-pixel halo
    # (~80 instructions a value), tap sums and dhid on the 128-pixel body
    # (~45 a value and row step)
    items = tiles * (hpad // 32)
    add("gdfn", "gdfn_stencil", 170, 1, min(SMS, items), 0.0,
        items * (180 * 32 * 80 + 512 * 16 * 45) / 1e9,
        npix * hpad * (4 + 4 + 2 + 4) / 1e9)
    gemm("gdfn", "dgrad dz = dhid.W1^T", 2 * hpad, c, 2, 4)
    add("gdfn", "ln_rows_bwd (LN2)", 0, 8, 4 * SMS, 0.0, 0.0,
        npix * c * 16 / 1e9)
    # pass 1: what pass 2 recomputed before, kept, and o and do
    add("pass 1", "ln_rows (LN1)", 0, 8, -(-npix // 8), 0.0, 0.0, ln_bytes)
    gemm("pass 1", "gemm lin = y.Wqkv", c, 3 * c, 2, 2)
    # per item 256 threads x 2 rows x 16 px x ~22 instructions; lin read
    # once (its halo again from L2), q | k | v written once
    items = tiles * -(-3 * c // 64)
    add("pass 1", "qkv_stencil", 47, 4, min(4 * SMS, items), 0.0,
        items * 256 * 2 * 16 * 22 / 1e9, npix * 3 * c * 4 / 1e9)
    gemm("pass 1", "heads_o o = v.A^T", cph, cph, 2, 2, rows_=h * w,
         batches=b * heads)
    gemm("pass 1", "gemm do = dx1.Wproj^T", c, c, 2, 2)
    for third in ("dq", "dk", "dv"):
        gemm("pass 2", f"head product {third}", cph, cph,
             4 if third != "dv" else 2, 4, rows_=h * w, batches=b * heads)
    items = tiles * -(-3 * c // 32)
    add("pass 2", "dlin_stencil", 80, 2, min(2 * SMS, items), 0.0,
        items * 256 * 16 * 50 / 1e9, npix * 3 * c * 8 / 1e9)
    gemm("pass 2", "dgrad dy = dlin.Wqkv^T", 3 * c, c, 2, 4)
    add("pass 2", "ln_rows_bwd (LN1)", 0, 8, 4 * SMS, 0.0, 0.0,
        npix * c * 16 / 1e9)
    for name, (px, m, n, nb) in wgrad_products(b, h, w, c, heads).items():
        gf, gbytes, ctas, per_sm, _ = _wgrad(px, m, n, nb)
        bn = 64 if n <= 64 else 128 if n <= 128 else 192 if n <= 192 else 256
        add("wgrad", f"wgrad {name} {m}x{n}",
            round(4 * ((64 if m <= 64 else 128) + bn) * 128 / 1024), per_sm,
            ctas, gf, 0.0, gbytes, EFF_WGRAD)
    return rows


GROUPS = ("gdfn", "pass 1", "pass 2", "wgrad")


def print_reckoning():
    per_step = dict.fromkeys(GROUPS, 0.0)
    bound = dict.fromkeys(("wgrad", "pass 1"), 0.0)
    for b, h, w, c, heads, n in TRAIN_SHAPES:
        rows = reckon(b, h, w, c, heads)
        sums = dict.fromkeys(GROUPS, 0.0)
        for name, (group, kb, per_sm, ctas, waves, gf, gi, gbytes, ms) in \
                rows.items():
            sums[group] += ms
            print(json.dumps({
                "shape": [b, h, w, c, heads], "group": group, "kernel": name,
                "smem_kb": kb, "ctas_per_sm": per_sm, "ctas": ctas,
                "waves": round(waves, 2), "gflop_as_run": round(gf, 2),
                "g_instructions": round(gi, 2), "gb": round(gbytes, 3),
                "predicted_ms": round(ms, 3)}))
        for group in GROUPS:
            per_step[group] += n * sums[group]
        bound["wgrad"] += n * sum(
            wgrad_bound_ms(*v) for v in wgrad_products(
                b, h, w, c, heads).values())
        # pass 1's bytes: x and dx1 read, y, lin, q | k | v, o, do written
        bound["pass 1"] += n * b * h * w * c * 2 * 11 / PEAK_BYTES * 1e3
        print(json.dumps({"shape": [b, h, w, c, heads], "blocks": n,
                          **{f"predicted_{g}_ms": round(sums[g], 3)
                             for g in GROUPS}}))
    print(json.dumps({"per_step_predicted_ms": {
        g: round(v, 1) for g, v in per_step.items()},
        "per_step_bound_ms": {g: round(v, 1) for g, v in bound.items()}}))


# ---------------------------------------------------------------------------
# On the card: this version against another
# ---------------------------------------------------------------------------


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Version:
    """One version of the sources: its library and the launch code of the
    two halves that drives it."""

    def __init__(self, name, lib, gdfn_mod, attn_mod):
        self.name, self.lib = name, lib
        self.gdfn, self.attn = gdfn_mod, attn_mod

    @classmethod
    def other(cls, root: Path):
        pkg = root / "textualdegremoval_tpu_torch"
        build = _load(pkg / "ops" / "_build.py", "other_build")
        so, secs = build.build()
        print(f"built the other version's {so.name} in {secs:.1f} s",
              flush=True)
        gdfn = _load(pkg / "ops" / "pallas" / "tblock_bwd.py",
                     "other_tblock_bwd")
        # its attention half imports its own tblock_bwd's helpers (_wgrad,
        # _gemm, ...), which drive its library
        with mock.patch.dict(sys.modules, {
                "textualdegremoval_tpu_torch.ops.pallas.tblock_bwd": gdfn}):
            attn = _load(pkg / "ops" / "pallas" / "tblock_attn_bwd.py",
                         "other_tblock_attn_bwd")
        return cls("other", build.open_library(so), gdfn, attn), so

    def calls(self, p, x, x1, g, dx1, kw, heads, stats, sms, stream):
        """(gdfn call, attn call), each giving (dx, natural grads): the
        launch code on the tiles and splits that the parent's wrappers
        pick (its bf16 streaming kernels take them; this version's bf16
        passes pick their own and take only pass 1's tile)."""
        gm, am, lib = self.gdfn, self.attn, self.lib
        b, hgt, wdt, c = x.shape

        def pick(fn):
            return tb._first_fit(gm._BWD_TILES, fn, "bench_block_bwd")

        gtile = pick(lambda t: lib.tblock_gdfn_bwd_smem_bytes(c, *t, 2))
        atile = pick(lambda t: lib.tblock_attn_bwd_smem_bytes(1, c, heads,
                                                              *t, 2))
        stile = pick(lambda t: lib.tblock_attn_bwd_smem_bytes(0, c, heads,
                                                              *t, 2))

        def split(t):
            return gm._nsplit(b, -(-hgt // t[0]) * -(-wdt // t[1]), sms)

        def gdfn():
            dx, *r = gm._launch_gdfn_bwd(lib, x1, g, kw, "WithBias", gtile,
                                         split(gtile), sms, stream)
            return dx, gm._natural_gdfn_grads(p, *r, "WithBias")

        def attn():
            dx, *r = am._launch_attn_bwd(lib, x, dx1, kw, heads, "WithBias",
                                         stats, stile, atile, split(atile),
                                         sms, stream)
            return dx, am._natural_attn_grads(p, *r, "WithBias")

        return gdfn, attn


@contextlib.contextmanager
def captured_wgrad():
    """Records the weight-gradient products (`_wgrad` calls of
    ops/pallas/tblock_bwd.py, by both halves and the forward's pipeline)
    made inside the block, as [(lib, args)] in call order; the operands
    stay alive for timing."""
    calls = []
    real = gb._wgrad

    def record(lib, *args):
        calls.append((lib, args))
        return real(lib, *args)

    with mock.patch.object(gb, "_wgrad", record), \
            mock.patch.object(ab, "_wgrad", record):
        yield calls


def product_rows(calls, names, dev):
    """Per captured product: {name, m, n, batches, pixels, ms,
    library_ms, bound_ms}: the kernel's `time_ms` (csrc/wgrad.cu through
    `_wgrad`, the sum of partials included) beside one torch.matmul(A^T,
    B) on the same operands (the library's yardstick; the port never calls
    it) and the product's bound (`wgrad_bound_ms`)."""
    rows = []
    for name, (lib, args) in zip(names, calls):
        a, lda, sa, b, ldb, sb, npix, m, n, nb = args[:10]
        av, bv = (torch.as_strided(v, (nb[0], nb[1], npix, w),
                                   (st[0], st[1], ld, 1), v.storage_offset())
                  for v, ld, st, w in ((a, lda, sa, m), (b, ldb, sb, n)))
        if nb == (1, 1):  # one product: cuBLAS reads A^T in place
            av, bv = av[0, 0], bv[0, 0]
        rows.append({
            "product": name, "m": m, "n": n, "batches": nb[0] * nb[1],
            "pixels": npix,
            "ms": time_ms(lambda: gb._wgrad(lib, *args), dev, ITERS,
                          REPEATS),
            "library_ms": time_ms(lambda: torch.matmul(
                av.transpose(-1, -2), bv), dev, ITERS, REPEATS),
            "bound_ms": wgrad_bound_ms(npix, m, n, nb[0] * nb[1])})
    return rows


# the kernels of the block backward by group, as their device time is
# split: by name, and every kernel launched inside the bf16 pass 1's
# profiler range (`ab.PASS1_RANGE`: its LN rows, products and stencil
# share their kernels with pass 2) counted as pass 1; the rest of a call's
# device time is its glue (torch's sums of partials, the softmax backward,
# casts)
KERNEL_GROUPS = (
    ("LN passes", ("ln_rows_",)),
    ("stencils", ("_stencil_kernel",)),
    ("GEMM", ("bwd_gemm_kernel",)),
    ("pass 1", ("attn_bwd_stats",)),
    ("wgrad", ("wgrad_",)),
)


def device_groups(fn, reps=3, kernel_groups=KERNEL_GROUPS):
    """{group: device ms} of one call of fn (`torch.profiler`, CPU and
    CUDA activities, the mean of `reps` calls): kernels by the parts of
    their names in `kernel_groups`, the rest "glue"; where a "pass 1"
    group exists, every kernel that runs inside the device span of the
    range `ab.PASS1_RANGE` (the trace's annotation of it on the card)
    counts as pass 1 instead."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["glue"] = 0.0
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == ab.PASS1_RANGE] if "pass 1" in groups else []
    for e in events:
        if e.name == ab.PASS1_RANGE:
            continue
        t = e.time_range
        name = "pass 1" if any(a <= t.start and t.end <= b
                               for a, b in spans) else next(
            (n for n, keys in kernel_groups
             if any(k in e.name for k in keys)), "glue")
        groups[name] += t.elapsed_us() / 1e3 / reps
    return groups


def _block_inputs(shape, gen_seed):
    b, h, w, c, heads, _ = shape
    gen = torch.Generator().manual_seed(gen_seed)
    blk = TransformerBlock(c, heads)
    with torch.no_grad():
        for name, q in blk.named_parameters():
            if name.endswith("temperature"):
                q.fill_(c ** 0.5)
            elif q.dim() == 4:
                q.copy_(torch.randn(q.shape, generator=gen)
                        * q[0].numel() ** -0.5)
    p = {k: v.detach().cuda() for k, v in blk.block_params().items()}
    x = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    g = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    return p, x, g, tb.prepare_tblock_weights(p, torch.bfloat16, "WithBias")


def group_rows(versions, order, shape, sms):
    """[(version, {half group: device ms})] at a shape, in `order`: each
    version's `gdfn` and `attn` calls split by `device_groups`, with
    the keys "gdfn <group>" and "attn <group>"."""
    b, h, w, c, heads, _ = shape
    p, x, g, kw = _block_inputs(shape, c + h)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        _, x1, stats = tb._forward_kernel(x, kw, heads, "WithBias",
                                          want_x1=True)
        dx1 = gb.gdfn_half_bwd_ref(x1, g, p, "WithBias")[0].contiguous()
    out = []
    for name in order:
        gdfn, attn = versions[name].calls(p, x, x1, g, dx1, kw, heads, stats,
                                          sms, stream)
        with torch.no_grad():
            gdfn(), attn()  # warm-up
            row = {f"{half} {k}": v for half, fn in (("gdfn", gdfn),
                                                     ("attn", attn))
                   for k, v in device_groups(fn).items()}
        out.append((name, row))
    return out


def split(shape, dev, sms):
    """This version's weight-gradient products at a shape by product (the
    forward's gram, then the GDFN half's, then the attention half's) and
    its bf16 pass 1 pass by pass, each timed alone (`time_ms`)."""
    b, h, w, c, heads, _ = shape
    p, x, g, kw = _block_inputs(shape, c + h)
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    bf, npix = torch.bfloat16, b * h * w
    with torch.no_grad(), captured_wgrad() as calls:
        _, x1, stats = tb._forward_kernel(x, kw, heads, "WithBias",
                                          want_x1=True)
        dx1, _ = gb.gdfn_half_bwd(x1, g, p, "WithBias", kw)
        ab.attn_half_bwd(x, dx1, p, heads, "WithBias", stats, kw)
    rows = product_rows(calls, ("gram (forward)", "dW1", "dW2", "dA",
                                "dWproj", "dWqkv"), dev)
    attn = tb._attn_matrix(*stats, kw["temperature"], heads, bf)
    ys = gb._ln_rows(lib, x, kw["ln1w"], kw["ln1b"], 0, stream)[0]
    lins = gb._gemm(lib, ys, kw["wqkv"], bf, stream)
    qkv = torch.empty((npix, 3 * c), dtype=bf, device=x.device)
    os_ = torch.empty((npix, c), dtype=bf, device=x.device)
    nsplit = gb._stencil_nsplit(lib, b, h, w, -(-3 * c // 64), 4, sms)
    passes = {
        "ln_rows (LN1)": lambda: gb._ln_rows(lib, x, kw["ln1w"], kw["ln1b"],
                                             0, stream),
        "gemm lin = y.Wqkv": lambda: gb._gemm(lib, ys, kw["wqkv"], bf,
                                              stream),
        "qkv_stencil": lambda: lib.fwd_qkv_stencil(
            gb._ptr(lins), gb._ptr(kw["dwall"]), gb._ptr(qkv), None, b, h,
            w, c, nsplit, stream),
        "heads_o o = v.A^T": lambda: lib.attn_heads_o(
            gb._ptr(qkv), gb._ptr(attn), gb._ptr(os_), b, h * w, c, heads,
            stream),
        "gemm do = dx1.Wproj^T": lambda: gb._gemm(
            lib, dx1.view(npix, c), kw["wprojt"], bf, stream),
        "pass 1 (all)": lambda: ab._attn_pass1_bf16(
            lib, x, dx1, kw, "WithBias", attn, heads, sms, stream),
    }
    pass1 = {name: time_ms(fn, dev, ITERS, REPEATS)
             for name, fn in passes.items()}
    return rows, pass1


def _rel_l2(got, want):
    return max(((got[k].float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
               for k, w in want.items())


def shape_rows(versions, order, shape, dev, sms):
    b, h, w, c, heads, _ = shape
    p, x, g, kw = _block_inputs(shape, c + h)
    with torch.no_grad():
        _, x1, stats = tb._forward_kernel(x, kw, heads, "WithBias",
                                          want_x1=True)
        want_dx1, want_g = gb.gdfn_half_bwd_ref(x1, g, p, "WithBias")
        dx1 = want_dx1.contiguous()
        want_dx, want_a = ab.attn_half_bwd_ref(x, dx1, p, heads, "WithBias")
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for name in order:
        gdfn, attn = versions[name].calls(p, x, x1, g, dx1, kw, heads, stats,
                                          sms, stream)
        with torch.no_grad():
            gdx, gg = gdfn()
            adx, ga = attn()
            row = {"version": name, "shape": list(shape[:5]),
                   "gdfn_l2": _rel_l2({"dx1": gdx, **gg},
                                      {"dx1": want_dx1, **want_g}),
                   "attn_l2": _rel_l2({"dx": adx, **ga},
                                      {"dx": want_dx, **want_a}),
                   "gdfn_ms": time_ms(gdfn, dev, ITERS, REPEATS),
                   "attn_ms": time_ms(attn, dev, ITERS, REPEATS)}
        print(json.dumps(row), flush=True)
        out.append(row)
        del gdx, gg, adx, ga
    del x, g, x1, dx1, kw, stats, want_g, want_a, want_dx, want_dx1
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.reckon:
        print_reckoning()
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("bench_block_bwd: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device_line(dev), flush=True)
    so, secs = _build.build()
    lib = _build.load_library()
    print(f"built {so.name} in {secs:.1f} s", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    versions = {"this": Version("this", lib, gb, ab)}
    mine = ptxas_reports(so.with_suffix(".log").read_text())
    if args.other is not None:
        versions["other"], other_so = Version.other(args.other.resolve())
        theirs = ptxas_reports(other_so.with_suffix(".log").read_text())
        for name in sorted(set(mine) | set(theirs)):
            state = ("same" if mine.get(name) == theirs.get(name) else
                     "differs" if name in mine and name in theirs else
                     "only in this version" if name in mine else
                     "only in the other version")
            print(f"ptxas report of {name}: {state}", flush=True)
            if state == "differs":  # the other's lines, then this one's
                print("\n".join(list(difflib.unified_diff(
                    theirs[name].splitlines(), mine[name].splitlines(),
                    lineterm="", n=0))[:40]), flush=True)
    order = ["other", "this", "this", "other"] if "other" in versions \
        else ["this"]
    if args.split:
        steps = {}
        for shape in TRAIN_SHAPES:
            for name, row in group_rows(versions, order, shape, sms):
                print(json.dumps({"version": name, "shape": list(shape[:5]),
                                  **row}), flush=True)
                for key, ms in row.items():
                    k = f"{name} {key} ms"
                    steps[k] = steps.get(k, 0.0) + shape[5] * ms / \
                        order.count(name)
            rows, pass1 = split(shape, dev, sms)
            for r in rows:
                print(json.dumps({"shape": list(shape[:5]), **r}), flush=True)
                for key in ("ms", "library_ms", "bound_ms"):
                    k = f"wgrad {r['product']} {key}"
                    steps[k] = steps.get(k, 0.0) + shape[5] * r[key]
            print(json.dumps({"shape": list(shape[:5]), "pass_1_ms": pass1}),
                  flush=True)
            for name, ms in pass1.items():
                k = f"pass 1 {name} ms"
                steps[k] = steps.get(k, 0.0) + shape[5] * ms
            torch.cuda.empty_cache()
        print(json.dumps({"per_step": steps}), flush=True)
        return 0
    for name in ("bwd_gemm.cu", "bwd_stencil.cu", "wgrad.cu"):
        print(f"ptxas {name}:\n{mine.get(name)}", flush=True)
    sums = {name: {"gdfn_ms": 0.0, "attn_ms": 0.0} for name in versions}
    for shape in TRAIN_SHAPES:
        rows = shape_rows(versions, order, shape, dev, sms)
        for name in versions:
            for key in ("gdfn_ms", "attn_ms"):
                sums[name][key] += shape[5] * statistics.median(
                    r[key] for r in rows if r["version"] == name)
    for name, s in sums.items():
        print(json.dumps({"version": name, "per_step_ms": s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
