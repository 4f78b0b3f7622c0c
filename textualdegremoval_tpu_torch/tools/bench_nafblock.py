"""The bf16 NAFBlock forward (`nafblock_fused`) at every block shape of a
512 px nafnet_deblur forward and of a 384 px batch-8 nafnet_motion_deblur
training step, this version against another version of the port, on the
card; or, with --reckon, this design's reckoning of those shapes (no
card).

    python -m textualdegremoval_tpu_torch.tools.bench_nafblock \\
        [--other ROOT] [--reckon] [--split]

--other ROOT is the root of another checkout of the repository (a `git
archive` of the parent under build/, say).  Its csrc/ is built into a
library of its own, and its own ops/pallas/nafblock.py drives that library
(`_forward_kernel`, with `ops/_build.load_library` pointed at it for the
call), so each version runs its own launch code on the same inputs.  The
tool prints, for each source of the other version, whether ptxas's report
is the same as this version's (path hashes and compile times taken out),
then per shape one JSON line for the plain version (`nafblock_ref`) and
one per version in turns other, this, this, other:

  - ms: `tools/_card.py` `time_ms` of one block call (validated inputs,
    the glue included), the median of runs of calls behind a spin of the
    stream;
  - branch: ||version - plain|| over ||plain - x||, the bound of
    chip_smoke.py phase 8;
  - bitwise_as_first: whether the output equals, bit for bit, that of the
    first version in the turns (the other) on the same inputs;
  - enqueue_ms: the host's time to enqueue one call (`bench_flash.py`
    `enqueue_us`, the median of single calls, the card synchronised
    between them): where it exceeds ms, the device waits for the host;

then per version one row of the same call in float32 (csrc/nafblock.cu's
pair, the route float32 and bf16 widths the pipeline does not take run):
its branch and bitwise_as_first, untimed; and last, per version, the
sums over one forward's and one step's blocks
(the median of the version's turns at each shape, times the blocks of
that shape), device ms and enqueue ms.  --reckon prints, per shape and
per kernel of this design, the model that PERF.md's reckoning uses: CTAs,
products as run (GFLOP), CUDA-core instructions (G), bytes moved (GB) and
the predicted ms, and the predicted sums.  --split prints instead, at
64 x 64 x 512, 32 x 32 x 2048, 512 x 512 x 128, 512 x 512 x 64 (the
narrowest width: conv1 and conv4 take one K step of 64) and
8 x 384 x 384 x 128, this version's device ms of one block call kernel by
kernel in launch order (`torch.profiler`, the mean of 3 calls).
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path
from unittest import mock

import torch

from textualdegremoval_tpu_torch.models.layers import NAFBlock
from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb
from textualdegremoval_tpu_torch.tools._card import (
    device_line, device_split, time_ms,
)
from textualdegremoval_tpu_torch.tools.bench_block_bwd import (
    CORE_RATE, EFF_BYTES, EFF_CORES, EFF_TC, PEAK_BF16, PEAK_BYTES, SMS,
    _gemm, _load, _up,
)
from textualdegremoval_tpu_torch.tools.bench_flash import (
    enqueue_us, ptxas_reports,
)

# (B, H, W, C, blocks of that shape in one 512 px nafnet_deblur forward)
EVAL_SHAPES = [
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
TRAIN_SHAPES = [
    (8, 384, 384, 128, 2), (8, 384, 384, 64, 2), (8, 192, 192, 256, 2),
    (8, 192, 192, 128, 2), (8, 96, 96, 512, 2), (8, 96, 96, 256, 2),
    (8, 48, 48, 1024, 2), (8, 48, 48, 512, 29), (8, 24, 24, 2048, 1),
    (8, 24, 24, 1024, 1),
]
SPLIT_SHAPES = [EVAL_SHAPES[7], EVAL_SHAPES[8], EVAL_SHAPES[0],
                EVAL_SHAPES[1], TRAIN_SHAPES[0]]
ITERS = 3
REPEATS = 3
# the host's work per block call: 9 ctypes launches, the LN rows' and the
# scratch's allocations, ~20 us each
HOST_MS = 0.2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="root of another checkout, built and timed beside "
                         "this one")
    ap.add_argument("--reckon", action="store_true",
                    help="print the design's reckoning and exit (no card)")
    ap.add_argument("--split", action="store_true",
                    help="per shape, the device time of one call by kernel")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# The reckoning: a model of this design's kernels, from their shapes
# ---------------------------------------------------------------------------


def reckon(b, h, w, c):
    """{kernel: (CTAs, GFLOP as run, G instructions, GB, predicted ms)} of
    the pipeline's kernels at one shape: each the largest of its products
    at EFF_TC of the bf16 peak, its CUDA-core instructions at EFF_CORES of
    the lanes' rate and its bytes at EFF_BYTES of the memory rate, plus a
    launch floor of 4 us."""
    npix, cpad = b * h * w, _up(c, 32)
    tiles = -(-h // 8) * -(-w // 16) * b
    rows = {}

    def add(name, ctas, gflop, ginstr, gb_):
        ms = max(gflop * 1e9 / (PEAK_BF16 * EFF_TC),
                 ginstr * 1e9 / (CORE_RATE * EFF_CORES),
                 gb_ * 1e9 / (PEAK_BYTES * EFF_BYTES)) * 1e3 + 0.004
        rows[name] = (ctas, gflop, ginstr, gb_, ms)

    def gemm(name, k, n, out_n, extra_gb=0.0):
        gf, _, ctas = _gemm(npix, k, n, 2, 2)
        gbytes = (npix * (k + out_n) * 2 + n * k * 2) / 1e9 + extra_gb
        add(name, ctas, gf, 0.0, gbytes)

    ln_gb = npix * (4 * c + 8) / 1e9
    items = tiles * (cpad // 32)
    # per item 256 threads x 16 px x ~40 instructions (18 taps, 6 window
    # loads, the shifts, two roundings of the biased halves, the gate and
    # its sum or scale); h read once from device memory (its halo again
    # from L2)
    st_gi = items * 256 * 16 * 40 / 1e9
    add("ln_rows LN1", -(-npix // 8), 0.0, 0.0, ln_gb)
    gemm("gemm h = y.W1 + b1", c, 2 * cpad, 2 * cpad)
    add("gate_stencil SUM", items, 0.0, st_gi, npix * 4 * cpad / 1e9)
    add("sca_glue", -(-cpad // 64) * b, 0.0, 0.0,
        (b * min(items, 8 * SMS) * 32 + c * c / 2) * 4 / 1e9)
    add("gate_stencil APPLY", items, 0.0, st_gi, npix * 6 * cpad / 1e9)
    gemm("gemm y1 = x + (gs.W3 + b3) beta", cpad, c, c, npix * c * 2 / 1e9)
    add("ln_rows LN2", -(-npix // 8), 0.0, 0.0, ln_gb)
    gemm("gemm g2 = gate(z.W4 + b4)", c, 2 * cpad, cpad)
    gemm("gemm out = y1 + (g2.W5 + b5) gamma", cpad, c, c,
         npix * c * 2 / 1e9)
    return rows


def predicted_ms(rows) -> float:
    """A block call: its kernels' predicted device time, or the host's
    work where that is longer (the device then waits)."""
    return max(sum(r[-1] for r in rows.values()), HOST_MS)


def print_reckoning():
    sums = {}
    for what, shapes in (("forward", EVAL_SHAPES), ("step", TRAIN_SHAPES)):
        total = device = 0.0
        for b, h, w, c, n in shapes:
            rows = reckon(b, h, w, c)
            for name, (ctas, gf, gi, gbytes, ms) in rows.items():
                print(json.dumps({
                    "shape": [b, h, w, c], "kernel": name, "ctas": ctas,
                    "gflop_as_run": round(gf, 3),
                    "g_instructions": round(gi, 3), "gb": round(gbytes, 4),
                    "predicted_ms": round(ms, 4)}))
            block = predicted_ms(rows)
            print(json.dumps({"shape": [b, h, w, c], "blocks": n,
                              "predicted_device_ms": round(
                                  sum(r[-1] for r in rows.values()), 4),
                              "predicted_block_ms": round(block, 4)}))
            total += n * block
            device += n * sum(r[-1] for r in rows.values())
        sums[what] = (round(device, 2), round(total, 2))
    print(json.dumps({"predicted_ms (device, with the host floor)": {
        "per 512 px forward": sums["forward"],
        "per 384 px batch-8 step (45 forward calls)": sums["step"]}}))


# ---------------------------------------------------------------------------
# On the card: this version against another
# ---------------------------------------------------------------------------


class Version:
    """One version of the sources: its nafblock.py, and the library that
    its `_forward_kernel` loads (None: this version's own)."""

    def __init__(self, name, mod, lib=None):
        self.name, self.mod, self.lib = name, mod, lib

    @classmethod
    def other(cls, root):
        pkg = root / "textualdegremoval_tpu_torch"
        build = _load(pkg / "ops" / "_build.py", "other_build")
        so, secs = build.build()
        print(f"built the other version's {so.name} in {secs:.1f} s",
              flush=True)
        lib = build.open_library(so)
        mod = _load(pkg / "ops" / "pallas" / "nafblock.py", "other_nafblock")
        return cls("other", mod, lib), so

    def call(self, p, x):
        kw = self.mod.prepare_nafblock_weights(p, x.dtype)
        if self.lib is None:
            return lambda: self.mod._forward_kernel(x, kw)

        def run():
            with mock.patch.object(_build, "load_library", lambda: self.lib):
                return self.mod._forward_kernel(x, kw)
        return run


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


def block_params(c, gen):
    """The natural-shape parameters of a NAFBlock at a trained block's
    scale (`randomize_nafblock`), on the card."""
    blk = NAFBlock(c)
    randomize_nafblock(blk, gen)
    return {k: v.detach().cuda() for k, v in blk.block_params().items()}


def _branch(got, want, x):
    return ((got.float() - want.float()).norm()
            / (want.float() - x.float()).norm()).item()


def shape_rows(versions, order, shape, dev):
    b, h, w, c, _ = shape
    gen = torch.Generator().manual_seed(c + h)
    p = block_params(c, gen)
    x = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    out = []
    with torch.no_grad():
        want = nb.nafblock_ref(x, p)
        row = {"version": "plain", "shape": list(shape[:4]),
               "ms": time_ms(lambda: nb.nafblock_ref(x, p), dev, ITERS,
                             REPEATS)}
        print(json.dumps(row), flush=True)
        out.append(row)
        first = None
        for name in order:
            fn = versions[name].call(p, x)
            got = fn()
            first = got if first is None else first
            row = {"version": name, "shape": list(shape[:4]),
                   "branch": _branch(got, want, x),
                   "bitwise_as_first": bool(torch.equal(got, first)),
                   "ms": time_ms(fn, dev, ITERS, REPEATS),
                   "enqueue_ms": enqueue_us(fn, 20) / 1e3}
            print(json.dumps(row), flush=True)
            out.append(row)
        x32, first = x.float(), None
        want = nb.nafblock_ref(x32, p)
        for name in order:
            got = versions[name].call(p, x32)()
            first = got if first is None else first
            print(json.dumps({
                "version": name, "shape": list(shape[:4]),
                "dtype": "float32", "branch": _branch(got, want, x32),
                "bitwise_as_first": bool(torch.equal(got, first))}),
                flush=True)
    del x, x32, want, p
    torch.cuda.empty_cache()
    return out


def naf_split(shape, reps=3):
    """[(kernel, device ms)] of one block call of this version at a shape,
    in launch order (`_card.py` `device_split`)."""
    b, h, w, c, _ = shape
    p = block_params(c, torch.Generator().manual_seed(c))
    x = torch.randn(b, h, w, c, device="cuda", dtype=torch.bfloat16)
    kw = nb.prepare_nafblock_weights(p, x.dtype)
    return device_split(lambda: nb._forward_kernel(x, kw), reps)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.reckon:
        print_reckoning()
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("bench_nafblock: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device_line(dev), flush=True)
    so, secs = _build.build()
    _build.load_library()
    print(f"built {so.name} in {secs:.1f} s", flush=True)
    if args.split:
        for shape in SPLIT_SHAPES:
            with torch.no_grad():
                rows = naf_split(shape)
            print(json.dumps({"shape": list(shape[:4]), "device_ms": rows,
                              "total": round(sum(r[1] for r in rows), 4)}),
                  flush=True)
        return 0
    versions = {"this": Version("this", nb)}
    mine = ptxas_reports(so.with_suffix(".log").read_text())
    for name in ("naf_stencil.cu", "bwd_gemm.cu"):
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
    sums = {}
    for what, shapes in (("per_forward", EVAL_SHAPES),
                         ("per_step", TRAIN_SHAPES)):
        for shape in shapes:
            rows = shape_rows(versions, order, shape, dev)
            for name in ["plain", *versions]:
                mine_rows = [r for r in rows if r["version"] == name]
                s = sums.setdefault(name, {})
                for key in ("ms", "enqueue_ms"):
                    if key in mine_rows[0]:
                        ms = statistics.median(r[key] for r in mine_rows)
                        k = f"{what}_{key}"
                        s[k] = s.get(k, 0.0) + shape[4] * ms
    for name, s in sums.items():
        print(json.dumps({"version": name, **s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
