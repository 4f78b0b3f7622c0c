"""The bf16 Restormer block forward (`tblock_fused`) at every block shape of
a 512 px restormer_deblur forward, of a 384 px batch-8 training step and of
PromptIR's noise blocks, this version against another version of the
port, on the card; or, with --reckon, this design's reckoning of those
shapes (no card).  With --chain, the cross-block chain
(`tblock_chain_fused`) at every stage of a 512 px promptir_all_in_one
forward instead; with --gdfn, the standalone GDFN (`gdfn_fused`) at every
GDFN of a 512 px restormer_deblur forward on the module path; with
--mdta, the MDTA statistics (`mdta_stats`) at every attention of that
forward.

    python -m textualdegremoval_tpu_torch.tools.bench_block_fwd \\
        [--other ROOT] [--reckon] [--split] [--chain | --gdfn | --mdta]

--other ROOT is the root of another checkout of the repository (a `git
archive` of the parent under build/, say).  Its csrc/ is built into a
library of its own, and its own ops/pallas/tblock.py drives that library
(`_forward_kernel`, with its `_kernel_library` pointed at it), so each
version runs its own launch code on the same inputs.  The tool prints, for
each source of the other version, whether ptxas's report is the same as
this version's (path hashes and compile times taken out; where a
source's report differs, entry by entry: each kernel of the other version
same or not, and the kernels only this version has), then per shape
one JSON line for the plain version (`tblock_ref`) and one per version in
turns other, this, this, other:

  - ms: `tools/_card.py` `time_ms` of one block call (validated inputs,
    the glue included), the median of runs of calls behind a spin of the
    stream;
  - branch: ||version - plain|| over ||plain - x||, the bound of
    chip_smoke.py phase 3;
  - enqueue_ms: the host's time to enqueue one call (`bench_flash.py`
    `enqueue_us`, the median of single calls, the card synchronised
    between them): where it exceeds ms, the device waits for the host;

and last, per version, the sums over one forward's and one step's blocks
(the median of the version's turns at each shape, times the blocks of
that shape) and the noise blocks' ms per launch.  --reckon prints, per
shape and per kernel of this design, the model that PERF.md's reckoning
uses: CTAs and waves, products as run (GFLOP), CUDA-core instructions
(G), bytes moved (GB) and the predicted ms, and the predicted sums.
--split prints instead, per shape, this version's device ms of one block
call kernel by kernel in launch order (`torch.profiler`, the mean of 3
calls; torch's own kernels in a row, the glue and the sums of partials,
as one entry).

--chain, --gdfn and --mdta time one call per stage, GDFN or attention
shape the same way (plain: `tblock_chain_ref` / `gdfn_ref` /
`mdta_stats_ref`; each version through its own route rule, so a parent
without the bf16 pipeline runs csrc/tblock_chain.cu or csrc/gdfn.cu, and
one without the gram route csrc/mdta.cu; --mdta takes q and k as strided
chunks of one qkv = x . W, W ~ N(0, 1/C), temperatures ~ sqrt(C), as
chip_smoke.py's phase 20, and its branch is the L2 error over ||plain||);
--chain also times this version's
blocks one by one through `tblock_fused`'s route, "blocks", twice after
the turns), and add to each version's row
device_ms, its device time by kernel group (`bench_block_bwd.py`
`device_groups` with FWD_GROUPS, the mean of 3 calls); the sums are per
PromptIR forward (the stages' calls times their count) or per
module-path forward (52 GDFNs or attentions).  With --reckon they
print this design's prediction for those sums (--chain, --gdfn).
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
from textualdegremoval_tpu_torch.tools._card import (
    device_line, device_split, median_ms, time_ms,
)
from textualdegremoval_tpu_torch.tools.bench_block_bwd import (
    CORE_RATE, EFF_BYTES, EFF_CORES, EFF_TC, EFF_WGRAD, PEAK_BF16,
    PEAK_BYTES, SMS, TRAIN_SHAPES, _gemm, _load, _up, _wgrad,
)
from textualdegremoval_tpu_torch.tools.bench_flash import (
    enqueue_us, ptxas_reports,
)

# (B, H, W, C, heads, blocks of that shape in one 512 px restormer_deblur
# forward)
EVAL_SHAPES = [
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
# (B, H, W, C, heads, blocks of that shape in one forward): the noise
# blocks of a 512 px promptir_all_in_one forward, 4 heads each, and a
# ragged shape
NOISE_SHAPES = [
    (1, 64, 64, 704, 4, 1),     # noise_level3, 176 channels per head
    (1, 128, 128, 320, 4, 1),   # noise_level2, 80
    (1, 256, 256, 160, 4, 1),   # noise_level1, 40
    (1, 45, 61, 704, 4, 0),     # ragged: no tile divides H or W
]
# (B, H, W, C, heads, blocks in the stage, stages of that shape in one
# 512 px promptir_all_in_one forward)
CHAIN_SHAPES = [
    (1, 512, 512, 48, 1, 4, 1),    # encoder level 1
    (1, 256, 256, 96, 2, 6, 2),    # encoder / decoder level 2
    (1, 128, 128, 192, 4, 6, 2),   # encoder / decoder level 3
    (1, 64, 64, 384, 8, 8, 1),     # latent
    (1, 512, 512, 96, 1, 4, 2),    # decoder level 1, refinement
]
# the device time of the forward's kernels by group: the pipeline's
# (LN rows, stencils and glue, GEMMs, wgrad.cu's gram) and the pair's
# and the chain's and the GDFN's first kernels
FWD_GROUPS = (
    ("LN rows", ("ln_rows_",)),
    ("stencils", ("_stencil_kernel", "attn_glue")),
    ("GEMM", ("bwd_gemm_kernel",)),
    ("wgrad", ("wgrad_",)),
    ("tblock.cu", ("tblock_stats", "tblock_apply")),
    ("tblock_chain.cu", ("tblock_chain_kernel",)),
    ("gdfn.cu", ("gdfn_kernel",)),
    ("mdta.cu", ("mdta_stats_kernel", "mdta_finish_kernel")),
    ("mdta finish", ("mdta_gram_finish",)),
)
ITERS = 3
REPEATS = 3
# the host's work per block call: about 11 ctypes launches and 15 torch
# calls (allocations, the sums of partials, the glue), ~10 us each
HOST_MS = 0.25


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="root of another checkout, built and timed beside "
                         "this one")
    ap.add_argument("--reckon", action="store_true",
                    help="print the design's reckoning and exit (no card)")
    ap.add_argument("--split", action="store_true",
                    help="per shape, the device time of one call by kernel")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--chain", action="store_true",
                      help="the cross-block chain at PromptIR's stages")
    what.add_argument("--gdfn", action="store_true",
                      help="the standalone GDFN at the module path's GDFNs")
    what.add_argument("--mdta", action="store_true",
                      help="the MDTA statistics at the module path's "
                           "attentions")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# The reckoning: a model of this design's kernels, from their shapes
# ---------------------------------------------------------------------------


def reckon(b, h, w, c, heads):
    """{kernel: (CTAs, waves, GFLOP as run, G instructions, GB, predicted
    ms)} of the pipeline's kernels at one shape: each the largest of its
    products at EFF_TC of the bf16 peak, its CUDA-core instructions at
    EFF_CORES of the lanes' rate and its bytes at EFF_BYTES of the memory
    rate, plus a launch floor of 4 us."""
    npix, cph, hw = b * h * w, c // heads, h * w
    hpad = _up(int(c * 2.66), 32)
    tiles = -(-h // 8) * -(-w // 16) * b
    rows = {}

    def add(name, ctas, waves, gflop, ginstr, gb_):
        ms = max(gflop * 1e9 / (PEAK_BF16 * EFF_TC),
                 ginstr * 1e9 / (CORE_RATE * EFF_CORES),
                 gb_ * 1e9 / (PEAK_BYTES * EFF_BYTES)) * 1e3 + 0.004
        rows[name] = (ctas, waves, gflop, ginstr, gb_, ms)

    def gemm(name, k, n, extra_gb=0.0, rows_=npix, batches=1):
        gf, gbytes, ctas = _gemm(rows_, k, n, 2, 2)
        ctas *= batches
        add(name, ctas, ctas / (2 * SMS), gf * batches, 0.0,
            gbytes * batches + extra_gb)

    ln_gb = npix * (4 * c + 8) / 1e9
    add("ln_rows LN1", -(-npix // 8), 0.0, 0.0, 0.0, ln_gb)
    gemm("gemm lin = y.Wqkv", c, 3 * c)
    items = tiles * -(-3 * c // 64)
    ctas = min(items, 8 * SMS)
    # per item 256 threads x 2 rows x 16 px x ~22 instructions (9 taps, 3
    # window loads, the shift, the square sum); lin read once (its halo
    # again from L2), q | k | v written once
    add("qkv_stencil", ctas, ctas / (4 * SMS), 0.0,
        items * 256 * 2 * 16 * 22 / 1e9, npix * 3 * c * 4 / 1e9)
    # the gram on wgrad.cu's TMA ring and wgmma, per (image, head): q and
    # k read once, at the ring's share of the memory rate
    gf, gbytes, ctas, per_sm, _ = _wgrad(hw, cph, cph, b * heads)
    rows["wgrad gram"] = (ctas, ctas / (per_sm * SMS), gf, 0.0, gbytes,
                          max(gf * 1e9 / (PEAK_BF16 * EFF_TC),
                              gbytes * 1e9 / (PEAK_BYTES * EFF_WGRAD)) * 1e3
                          + 0.004)
    gemm("attn_out o = v.A^T", cph, cph, rows_=hw, batches=b * heads)
    gemm("attn_out x1 = x + o.Wproj", c, c, extra_gb=npix * c * 2 / 1e9)
    add("ln_rows LN2", -(-npix // 8), 0.0, 0.0, 0.0, ln_gb)
    gemm("gemm hid = z.W1", c, 2 * hpad)
    items = tiles * (hpad // 32)
    ctas = min(items, 8 * SMS)
    # per item 256 threads x 16 px x ~50 instructions (18 taps, 6 window
    # loads, the shifts, erf and the product); hid read once, gate written
    add("gate_stencil", ctas, ctas / (4 * SMS), 0.0,
        items * 256 * 16 * 50 / 1e9, npix * 3 * hpad * 2 / 1e9)
    gemm("gemm out = x1 + gate.W2", hpad, c, extra_gb=npix * c * 2 / 1e9)
    return rows


def predicted_ms(rows) -> float:
    """A block call: its kernels' predicted device time, or the host's
    work where that is longer (the device then waits)."""
    return max(sum(r[-1] for r in rows.values()), HOST_MS)


def reckon_chain(b, h, w, c, heads, n):
    """Predicted device ms of a bf16 chain of n blocks: n blocks of the
    pipeline, less the LN1 pass of each block after the first, plus the
    y that the chain epilogue writes beside out at each boundary."""
    rows = reckon(b, h, w, c, heads)
    epi = b * h * w * c * 2 / (PEAK_BYTES * EFF_BYTES) * 1e3
    return (n * sum(r[-1] for r in rows.values())
            - (n - 1) * (rows["ln_rows LN1"][-1] - epi))


def reckon_gdfn(b, h, w, c):
    """Predicted device ms of the bf16 GDFN pipeline: the block's hid
    product, gate stencil and out product, less the residual's read."""
    rows = reckon(b, h, w, c, 1)
    res = b * h * w * c * 2 / (PEAK_BYTES * EFF_BYTES) * 1e3
    return (rows["gemm hid = z.W1"][-1] + rows["gate_stencil"][-1]
            + rows["gemm out = x1 + gate.W2"][-1] - res)


def print_other_reckoning(chain: bool):
    total = 0.0
    if chain:
        for b, h, w, c, heads, n, stages in CHAIN_SHAPES:
            ms = max(reckon_chain(b, h, w, c, heads, n), n * HOST_MS)
            print(json.dumps({"shape": [b, h, w, c, heads, n],
                              "stages": stages,
                              "predicted_ms": round(ms, 4)}))
            total += stages * ms
        print(json.dumps({"predicted_ms": {
            "chain per 512 px PromptIR forward": round(total, 2)}}))
        return
    for b, h, w, c, _, n in EVAL_SHAPES:
        ms = reckon_gdfn(b, h, w, c)
        print(json.dumps({"shape": [b, h, w, c], "gdfns": n,
                          "predicted_ms": round(ms, 4)}))
        total += n * ms
    print(json.dumps({"predicted_ms": {
        "gdfn per 512 px module-path forward": round(total, 2)}}))


def print_reckoning():
    sums = {}
    for what, shapes in (("forward", EVAL_SHAPES), ("step", TRAIN_SHAPES),
                         ("noise", NOISE_SHAPES)):
        total = 0.0
        for b, h, w, c, heads, n in shapes:
            rows = reckon(b, h, w, c, heads)
            for name, (ctas, waves, gf, gi, gbytes, ms) in rows.items():
                print(json.dumps({
                    "shape": [b, h, w, c, heads], "kernel": name,
                    "ctas": ctas, "waves": round(waves, 2),
                    "gflop_as_run": round(gf, 3),
                    "g_instructions": round(gi, 3), "gb": round(gbytes, 4),
                    "predicted_ms": round(ms, 4)}))
            block = predicted_ms(rows)
            print(json.dumps({"shape": [b, h, w, c, heads], "blocks": n,
                              "predicted_block_ms": round(block, 4)}))
            total += n * block
        sums[what] = round(total, 2)
    print(json.dumps({"predicted_ms": {
        "per 512 px forward": sums["forward"],
        "per 384 px batch-8 step (52 forward calls)": sums["step"],
        "noise blocks per forward": sums["noise"]}}))


# ---------------------------------------------------------------------------
# On the card: this version against another
# ---------------------------------------------------------------------------


class Version:
    """One version of the sources: its tblock.py, which drives its
    library."""

    def __init__(self, name, mod):
        self.name, self.mod = name, mod

    @classmethod
    def other(cls, root):
        pkg = root / "textualdegremoval_tpu_torch"
        build = _load(pkg / "ops" / "_build.py", "other_build")
        so, secs = build.build()
        print(f"built the other version's {so.name} in {secs:.1f} s",
              flush=True)
        lib = build.open_library(so)
        mod = _load(pkg / "ops" / "pallas" / "tblock.py", "other_tblock")
        mod._kernel_library = lambda cph, what: lib
        version = cls("other", mod)
        version.gd = _load(pkg / "ops" / "pallas" / "gdfn.py", "other_gdfn")
        version.md = _load(pkg / "ops" / "pallas" / "mdta.py", "other_mdta")
        version.lib = lib
        return version, so

    def call(self, p, x, heads):
        kw = self.mod.prepare_tblock_weights(p, x.dtype, "WithBias")
        return lambda: self.mod._forward_kernel(x, kw, heads, "WithBias")

    def chain_call(self, ps, x, heads):
        kws = [self.mod.prepare_tblock_weights(p, x.dtype, "WithBias")
               for p in ps]
        return lambda: self.mod._chain_kernel(x, kws, heads, "WithBias")

    def blocks_call(self, ps, x, heads):
        """The stage's blocks one by one through the block forward."""
        kws = [self.mod.prepare_tblock_weights(p, x.dtype, "WithBias")
               for p in ps]

        def run():
            y = x
            for kw in kws:
                y = self.mod._forward_kernel(y, kw, heads, "WithBias")
            return y
        return run

    def gdfn_call(self, ws, x):
        """The version's route for x (its gdfn.py's rule, its library)."""
        mod, lib = self.gd, self.lib
        kw = mod.prepare_gdfn_weights(*ws, x.dtype)
        stream, sms = tb._card(x.device)
        if getattr(mod, "_takes_gdfn_pipeline", lambda _: False)(x):
            return lambda: mod.gdfn_pipeline(lib, x, kw, sms, stream)
        tile = mod.pick_tile(lib, x.shape[-1], x.element_size())
        return lambda: mod._launch(lib, x, kw, tile, stream)

    def mdta_call(self, q, k, temp, heads):
        """The version's route for q, k (its mdta.py's rule, its
        library)."""
        mod, lib = self.md, self.lib
        stream, sms = tb._card(q.device)
        if getattr(mod, "_takes_gram", lambda *_: False)(q, k, heads):
            return lambda: mod.mdta_gram(lib, q, k, temp, heads, sms, stream)
        tl, nsplit = mod.plan(lib, q, heads)
        return lambda: mod._launch(lib, q, k, temp, heads, tl, nsplit,
                                   stream)


def _branch(got, want, x):
    return ((got.float() - want.float()).norm()
            / (want.float() - x.float()).norm()).item()


def shape_rows(versions, order, shape, dev):
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
    out = []
    with torch.no_grad():
        want = tb.tblock_ref(x, p, heads, "WithBias")
        row = {"version": "plain", "shape": list(shape[:5]),
               "ms": median_ms(lambda: tb.tblock_ref(x, p, heads,
                                                     "WithBias"), reps=3)}
        print(json.dumps(row), flush=True)
        out.append(row)
        for name in order:
            fn = versions[name].call(p, x, heads)
            row = {"version": name, "shape": list(shape[:5]),
                   "branch": _branch(fn(), want, x),
                   "ms": time_ms(fn, dev, ITERS, REPEATS),
                   "enqueue_ms": enqueue_us(fn, 20) / 1e3}
            print(json.dumps(row), flush=True)
            out.append(row)
    del x, want, p
    torch.cuda.empty_cache()
    return out


def _stage_params(c, heads, n, seed):
    """n blocks' parameters on the card at a trained block's scale."""
    gen = torch.Generator().manual_seed(seed)
    ps = []
    for _ in range(n):
        blk = TransformerBlock(c, heads)
        with torch.no_grad():
            for name, q in blk.named_parameters():
                if name.endswith("temperature"):
                    q.fill_(c ** 0.5)
                elif q.dim() == 4:
                    q.copy_(torch.randn(q.shape, generator=gen)
                            * q[0].numel() ** -0.5)
        ps.append({k: v.detach().cuda()
                   for k, v in blk.block_params().items()})
    return ps, gen


def _version_row(name, shape, fn, want, x, dev):
    from textualdegremoval_tpu_torch.tools.bench_block_bwd import (
        device_groups)

    row = {"version": name, "shape": list(shape),
           "branch": _branch(fn(), want, x),
           "ms": time_ms(fn, dev, ITERS, REPEATS),
           "enqueue_ms": enqueue_us(fn, 20) / 1e3,
           "device_ms": {k: round(v, 4) for k, v in device_groups(
               fn, kernel_groups=FWD_GROUPS).items() if v}}
    print(json.dumps(row), flush=True)
    return row


def chain_rows(versions, order, shape, dev):
    """Rows of one PromptIR stage shape: the plain chain, then each
    version's chain in turns."""
    b, h, w, c, heads, n, _ = shape
    ps, gen = _stage_params(c, heads, n, c + n)
    x = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    out = []
    with torch.no_grad():
        want = tb.tblock_chain_ref(x, ps, heads, "WithBias")
        row = {"version": "plain", "shape": list(shape[:6]),
               "ms": median_ms(lambda: tb.tblock_chain_ref(
                   x, ps, heads, "WithBias"), reps=3)}
        print(json.dumps(row), flush=True)
        out.append(row)
        for name in order:
            out.append(_version_row(name, shape[:6],
                                    versions[name].chain_call(ps, x, heads),
                                    want, x, dev))
        # this version's blocks one by one, the chain's yardstick
        for _ in range(2):
            out.append(_version_row("blocks", shape[:6],
                                    versions["this"].blocks_call(ps, x,
                                                                 heads),
                                    want, x, dev))
    del x, want, ps
    torch.cuda.empty_cache()
    return out


def gdfn_rows(versions, order, shape, dev):
    """Rows of one module-path GDFN shape: `gdfn_ref`, then each version
    in turns."""
    from textualdegremoval_tpu_torch.ops.pallas import gdfn as gd

    b, h, w, c, _, _ = shape
    gen = torch.Generator().manual_seed(c + h)
    hid = int(c * 2.66)
    ws = [t.cuda() for t in (
        torch.randn(c, 2 * hid, generator=gen) * c ** -0.5,
        torch.randn(3, 3, 2 * hid, generator=gen) / 3,
        torch.randn(hid, c, generator=gen) * hid ** -0.5)]
    x = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    out = []
    with torch.no_grad():
        want = gd.gdfn_ref(x, *ws)
        row = {"version": "plain", "shape": [b, h, w, c],
               "ms": median_ms(lambda: gd.gdfn_ref(x, *ws), reps=3)}
        print(json.dumps(row), flush=True)
        out.append(row)
        zero = torch.zeros_like(x)
        for name in order:
            # branch: against ||plain||, as the GDFN adds all it computes
            out.append(_version_row(name, [b, h, w, c],
                                    versions[name].gdfn_call(ws, x), want,
                                    zero, dev))
    del x, want, ws
    torch.cuda.empty_cache()
    return out


def mdta_rows(versions, order, shape, dev):
    """Rows of one module-path attention shape: `mdta_stats_ref`, then each
    version in turns."""
    from textualdegremoval_tpu_torch.ops.pallas import mdta as md

    b, h, w, c, heads, _ = shape
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn(b, h, w, c, generator=gen)
    wqkv = torch.randn(c, 3 * c, generator=gen) * c ** -0.5
    temp = (c ** 0.5 * (0.5 + torch.rand(heads, 1, 1, generator=gen))).cuda()
    q, k, _ = torch.chunk((x @ wqkv).to("cuda", torch.bfloat16), 3, dim=-1)
    del x
    out = []
    with torch.no_grad():
        want = md.mdta_stats_ref(q, k, temp, heads)
        row = {"version": "plain", "shape": list(shape[:5]),
               "ms": median_ms(lambda: md.mdta_stats_ref(q, k, temp, heads),
                               reps=3)}
        print(json.dumps(row), flush=True)
        out.append(row)
        zero = torch.zeros_like(want)
        for name in order:
            out.append(_version_row(name, list(shape[:5]),
                                    versions[name].mdta_call(q, k, temp,
                                                             heads),
                                    want, zero, dev))
    del q, k, want
    torch.cuda.empty_cache()
    return out


def ptxas_entries(report: str) -> dict[str, str]:
    """Kernel name -> its lines of one source's ptxas report
    (`bench_flash.ptxas_reports`)."""
    out = {}
    for part in report.split("Compiling entry function '")[1:]:
        name, _, text = part.partition("'")
        out[name] = text.strip()
    return out


def split(shape, reps=3):
    """[(kernel, device ms)] of one block call of this version at a shape,
    in launch order (`_card.py` `device_split`)."""
    b, h, w, c, heads, _ = shape
    p = {k: v.detach().cuda()
         for k, v in TransformerBlock(c, heads).block_params().items()}
    x = torch.randn(b, h, w, c, device="cuda", dtype=torch.bfloat16)
    kw = tb.prepare_tblock_weights(p, x.dtype, "WithBias")
    with torch.no_grad():
        return device_split(
            lambda: tb._forward_kernel(x, kw, heads, "WithBias"), reps)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.reckon:
        if args.mdta:
            raise SystemExit("bench_block_fwd: --mdta has no reckoning; "
                             "PERF.md states its prediction")
        if args.chain or args.gdfn:
            print_other_reckoning(args.chain)
        else:
            print_reckoning()
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("bench_block_fwd: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device_line(dev), flush=True)
    so, secs = _build.build()
    _build.load_library()
    print(f"built {so.name} in {secs:.1f} s", flush=True)
    if args.split:
        for shape in EVAL_SHAPES + TRAIN_SHAPES + NOISE_SHAPES:
            rows = split(shape)
            print(json.dumps({"shape": list(shape[:5]), "device_ms": rows,
                              "total": round(sum(r[1] for r in rows), 4)}),
                  flush=True)
        return 0
    from textualdegremoval_tpu_torch.ops.pallas import gdfn as gd

    versions = {"this": Version("this", tb)}
    from textualdegremoval_tpu_torch.ops.pallas import mdta as md

    versions["this"].gd, versions["this"].lib = gd, _build.load_library()
    versions["this"].md = md
    mine = ptxas_reports(so.with_suffix(".log").read_text())
    for name in ("fwd_stencil.cu", "bwd_gemm.cu"):
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
            if state != "differs":
                continue
            ours = ptxas_entries(mine[name])
            for kernel, text in ptxas_entries(theirs[name]).items():
                if kernel not in ours:
                    print(f"  {kernel}: only in the other version",
                          flush=True)
                elif ours[kernel] == text:
                    print(f"  {kernel}: same", flush=True)
                else:
                    print(f"  {kernel}: differs\n    this: {ours[kernel]!r}"
                          f"\n    other: {text!r}", flush=True)
            for kernel in sorted(set(ours) - set(ptxas_entries(
                    theirs[name]))):
                print(f"  {kernel}: only in this version", flush=True)
    order = ["other", "this", "this", "other"] if "other" in versions \
        else ["this"]
    if args.chain or args.gdfn or args.mdta:
        return other_sums("chain" if args.chain else
                          "mdta" if args.mdta else "gdfn", versions, order,
                          dev)
    sums = {}
    for what, shapes in (("per_forward_ms", EVAL_SHAPES),
                         ("per_step_ms", TRAIN_SHAPES),
                         ("noise_per_launch_ms", NOISE_SHAPES)):
        for shape in shapes:
            rows = shape_rows(versions, order, shape, dev)
            for name in ["plain", *versions]:
                ms = statistics.median(r["ms"] for r in rows
                                       if r["version"] == name)
                s = sums.setdefault(name, {})
                if what == "noise_per_launch_ms":
                    if shape[5]:
                        s.setdefault(what, []).append(ms)
                else:
                    s[what] = s.get(what, 0.0) + shape[5] * ms
    for name, s in sums.items():
        print(json.dumps({"version": name, **s}), flush=True)
    return 0


def other_sums(kind, versions, order, dev) -> int:
    """--chain, --gdfn or --mdta (`kind`): the rows of every shape, then per
    version the sums over one forward (ms, enqueue_ms and device_ms by
    group, the median of the version's turns at each shape times its
    count)."""
    chain = kind == "chain"
    what = ("per_promptir_forward" if chain else
            "per_module_path_forward")
    shapes = CHAIN_SHAPES if chain else EVAL_SHAPES
    rows_of = {"chain": chain_rows, "gdfn": gdfn_rows, "mdta": mdta_rows}
    sums = {}
    for shape in shapes:
        rows = rows_of[kind](versions, order, shape, dev)
        count = shape[6] if chain else shape[5]
        for name in ["plain", *versions, *(["blocks"] if chain else [])]:
            mine = [r for r in rows if r["version"] == name]
            s = sums.setdefault(name, {"ms": 0.0})
            s["ms"] += count * statistics.median(r["ms"] for r in mine)
            if name == "plain":
                continue
            for key in ("enqueue_ms",):
                s[key] = s.get(key, 0.0) + count * statistics.median(
                    r[key] for r in mine)
            groups = s.setdefault("device_ms", {})
            for g in {k for r in mine for k in r["device_ms"]}:
                groups[g] = groups.get(g, 0.0) + count * statistics.median(
                    r["device_ms"].get(g, 0.0) for r in mine)
            s["device_total_ms"] = sum(groups.values())
    for name, s in sums.items():
        print(json.dumps({"version": name, what: s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
