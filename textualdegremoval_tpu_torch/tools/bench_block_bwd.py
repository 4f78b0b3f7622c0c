"""The bf16 Restormer block backward (`gdfn_half_bwd`, `attn_half_bwd`) at
every block shape of a 384 px batch-8 training step, this version against
another version of the port, on the card; or, with --reckon, this design's
reckoning of those shapes (no card).

    python -m textualdegremoval_tpu_torch.tools.bench_block_bwd \\
        [--other ROOT] [--reckon]

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
ms, and the predicted sums per step.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

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


def reckon(b, h, w, c, heads):
    """{kernel: (smem KB, CTAs per SM, CTAs, waves, GFLOP as run, G
    instructions, GB, predicted ms)} of this design's bf16 kernels at one
    shape (the pass-2 kernels of the attention half; pass 1 and wgrad.cu
    are the parent's)."""
    npix, cph = b * h * w, c // heads
    hpad = _up(int(c * 2.66), 32)
    tiles = -(-h // 8) * -(-w // 16) * b
    rows = {}

    def add(name, smem_kb, per_sm, ctas, gflop, ginstr, gb_):
        ms = max(gflop * 1e9 / (PEAK_BF16 * EFF_TC),
                 ginstr * 1e9 / (CORE_RATE * EFF_CORES),
                 gb_ * 1e9 / (PEAK_BYTES * EFF_BYTES)) * 1e3
        rows[name] = (smem_kb, per_sm, ctas, ctas / (per_sm * SMS), gflop,
                      ginstr, gb_, ms)

    gemm_kb = {64: 73, 128: 97}  # 3 stages of A 16 KB + B, two CTAs an SM

    def gemm(name, k, n, a_bytes, out_bytes, rows_=npix, batches=1):
        gf, gbytes, ctas = _gemm(rows_, k, n, a_bytes, out_bytes)
        add(name, gemm_kb[64 if n <= 64 else 128], 2, ctas * batches,
            gf * batches, 0.0, gbytes * batches)

    ln_bytes = npix * c * 4 / 1e9
    add("ln_rows (LN2)", 0, 8, -(-npix // 8), 0.0, 0.0, ln_bytes)
    gemm("gemm hid = z.W1", c, 2 * hpad, 2, 2)
    gemm("gemm dgate = dout.W2^T", c, hpad, 2, 4)
    # per (tile, 32-channel chunk): d1, d2 and gelu on the 180-pixel halo
    # (~80 instructions a value), tap sums and dhid on the 128-pixel body
    # (~45 a value and row step)
    items = tiles * (hpad // 32)
    add("gdfn_stencil", 170, 1, min(SMS, items), 0.0,
        items * (180 * 32 * 80 + 512 * 16 * 45) / 1e9,
        npix * hpad * (4 + 4 + 2 + 4) / 1e9)
    gemm("dgrad dz = dhid.W1^T", 2 * hpad, c, 2, 4)
    add("ln_rows_bwd (LN2)", 0, 8, 4 * SMS, 0.0, 0.0, npix * c * 16 / 1e9)
    add("ln_rows (LN1)", 0, 8, -(-npix // 8), 0.0, 0.0, ln_bytes)
    gemm("gemm lin = y.Wqkv", c, 3 * c, 2, 2)
    items = tiles * -(-2 * c // 64)
    add("qk_stencil", 47, 4, min(4 * SMS, items), 0.0,
        items * 256 * 2 * 16 * 22 / 1e9, npix * c * 8 / 1e9)
    for third in ("dq", "dk", "dv"):
        gemm(f"head product {third}", cph, cph, 4 if third != "dv" else 2,
             4, rows_=h * w, batches=b * heads)
    items = tiles * -(-3 * c // 32)
    add("dlin_stencil", 80, 2, min(2 * SMS, items), 0.0,
        items * 256 * 16 * 50 / 1e9, npix * 3 * c * 8 / 1e9)
    gemm("dgrad dy = dlin.Wqkv^T", 3 * c, c, 2, 4)
    add("ln_rows_bwd (LN1)", 0, 8, 4 * SMS, 0.0, 0.0, npix * c * 16 / 1e9)
    return rows


GDFN_KERNELS = ("ln_rows (LN2)", "gemm hid", "gemm dgate", "gdfn_stencil",
                "dgrad dz", "ln_rows_bwd (LN2)")


def print_reckoning():
    per_step = {"gdfn": 0.0, "attn": 0.0}
    for b, h, w, c, heads, n in TRAIN_SHAPES:
        rows = reckon(b, h, w, c, heads)
        sums = {"gdfn": 0.0, "attn": 0.0}
        for name, (kb, per_sm, ctas, waves, gf, gi, gbytes, ms) in \
                rows.items():
            half = "gdfn" if name.startswith(GDFN_KERNELS) else "attn"
            sums[half] += ms
            print(json.dumps({
                "shape": [b, h, w, c, heads], "kernel": name,
                "smem_kb": kb, "ctas_per_sm": per_sm, "ctas": ctas,
                "waves": round(waves, 2), "gflop_as_run": round(gf, 2),
                "g_instructions": round(gi, 2), "gb": round(gbytes, 3),
                "predicted_ms": round(ms, 3)}))
        for half in sums:
            per_step[half] += n * sums[half]
        print(json.dumps({"shape": [b, h, w, c, heads], "blocks": n,
                          "predicted_gdfn_ms": round(sums["gdfn"], 3),
                          "predicted_attn_pass2_ms": round(sums["attn"], 3)}))
    print(json.dumps({"per_step_predicted_ms": {
        "gdfn new kernels": round(per_step["gdfn"], 1),
        "attn pass-2 new kernels": round(per_step["attn"], 1)}}))


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
        return cls("other", build.open_library(so),
                   _load(pkg / "ops" / "pallas" / "tblock_bwd.py",
                         "other_tblock_bwd"),
                   _load(pkg / "ops" / "pallas" / "tblock_attn_bwd.py",
                         "other_tblock_attn_bwd")), so

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


def _rel_l2(got, want):
    return max(((got[k].float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
               for k, w in want.items())


def shape_rows(versions, order, shape, dev, sms):
    b, h, w, c, heads, _ = shape
    gen = torch.Generator().manual_seed(c + h)
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
    kw = tb.prepare_tblock_weights(p, torch.bfloat16, "WithBias")
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
    versions = {"this": Version("this", lib, gb, ab)}
    mine = ptxas_reports(so.with_suffix(".log").read_text())
    for name in ("bwd_gemm.cu", "bwd_stencil.cu"):
        print(f"ptxas {name}:\n{mine.get(name)}", flush=True)
    if args.other is not None:
        versions["other"], other_so = Version.other(args.other.resolve())
        theirs = ptxas_reports(other_so.with_suffix(".log").read_text())
        for name in sorted(set(mine) | set(theirs)):
            state = ("same" if mine.get(name) == theirs.get(name) else
                     "differs" if name in mine and name in theirs else
                     "only in this version" if name in mine else
                     "only in the other version")
            print(f"ptxas report of {name}: {state}", flush=True)
    order = ["other", "this", "this", "other"] if "other" in versions \
        else ["this"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
