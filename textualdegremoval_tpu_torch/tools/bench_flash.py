"""The bf16 flash-attention kernels (B4) at pipeline A's main shapes, this
version against another version of the port's sources, on the card.

Builds this package's kernels and, with --other, the csrc/ directory of
another version of the port (for example that of a `git archive` of the
parent commit) into a library of its own.  Prints, for each source of the
other version, whether ptxas's report (registers, shared memory, spills per
kernel) is the same as this version's once the anonymous namespaces' path
hashes and ptxas's compile times are taken out.  Then, at the forward's
main shape (2, 4096, 5, 64) (a UNet self-attention under CFG) and the
backward's (4, 4096, 5, 64) (an I2T micro-step), one JSON line per version
and shape in turns (other, this, this, other) and one for SDPA:

  - max_abs, l2: the error against the plain version (`attention_ref`;
    for the backward `attention_bwd_ref`, the largest over dq, dk, dv);
  - median_ms: `tools/_card.py` `median_ms`, single launches between CUDA
    events (the statistic of PERF.md's kernel table); device_ms:
    `time_ms`, runs of calls behind a spin of the stream, so the device's
    time and not the host's;
  - tflops: the operations as the bound counts them (4 B H N^2 D forward,
    10 B H N^2 D for the dkv + dq pair) over device_ms;
  - enqueue_us: the host's time to enqueue one call of the wrapper
    (validation, tensor maps, ctypes, the launch; the backward's di in
    torch), the median of single calls; c_enqueue_us: the C entries' own
    (tensor maps and launches), the mean of 200 calls back to back;
  - for the backward, dkv_device_ms and dq_device_ms: each kernel alone;
  - for SDPA, its backend kernel's name from `torch.profiler`.

    python -m textualdegremoval_tpu_torch.tools.bench_flash [--other DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops import flash_attn as fa
from textualdegremoval_tpu_torch.tools._card import (
    device_line, median_ms, time_ms,
)

FWD_SHAPE = (2, 4096, 5, 64)
BWD_SHAPE = (4, 4096, 5, 64)
ITERS = 20
REPEATS = 5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="csrc/ of another version of the port, built and "
                         "timed beside this one")
    return ap.parse_args(argv)


def ptxas_reports(log: str) -> dict[str, str]:
    """Source name -> its ptxas report with the anonymous namespaces' path
    hashes and the compile times taken out."""
    out = {}
    for part in log.split("== ")[1:]:
        name, _, text = part.partition("\n")
        text = re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_\w{8}",
                      "_GLOBAL__N_", text)
        text = re.sub(r"(?m)^.*Compile time.*\n?", "", text)
        out[name.strip()] = text.strip()
    return out


def enqueue_us(fn, reps=50) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def sdpa_backend(fn, window_s: float = 0.05) -> str:
    """The name of the device kernel that takes the longest while fn is
    called again and again for `window_s` of wall time (`torch.profiler`;
    in chip_smoke.py, which profiles earlier phases too, a window of one
    call came back without device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == cuda and e.self_device_time_total > 0]
    if not events:
        return "not measured (no device time in the trace)"
    return max(events, key=lambda e: e.self_device_time_total).key


def _err(got, want):
    g, w = got.float(), want.float()
    return (g - w).abs().max().item(), ((g - w).norm() / w.norm()).item()


def inputs(shape, gen):
    s = 3.0 ** 0.5  # logits of standard deviation 3, as chip_smoke.py
    b, n, h, d = shape
    xs = [torch.randn(b, n, h, d, generator=gen) * sc
          for sc in (s, s, 1.0, 1.0)]
    return [x.to("cuda", torch.bfloat16) for x in xs]


def forward_row(lib, version, q, k, v, dev):
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        fa._validate(q, k, v)
        return fa._launch(lib, q, k, v, stream)

    with torch.inference_mode():
        max_abs, l2 = _err(call(), fa.attention_ref(q, k, v))
        dev_ms = time_ms(call, dev, ITERS, REPEATS)
        b, n, h, d = q.shape
        out = torch.empty_like(q)
        args = (fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(out), None, b, n,
                h, d, *[s for t in (q, k, v) for s in t.stride()[:3]],
                d ** -0.5, 1, stream)
        return {"kernel": "forward", "version": version,
                "shape": list(q.shape), "max_abs": max_abs, "l2": l2,
                "median_ms": median_ms(call, 10), "device_ms": dev_ms,
                "tflops": 4 * b * h * n * n * d / dev_ms / 1e9,
                "enqueue_us": enqueue_us(call),
                "c_enqueue_us": host_us(lambda: lib.flash_attn_fwd(*args))}


def backward_row(lib, version, q, k, v, do, dev):
    stream = torch.cuda.current_stream().cuda_stream
    with torch.inference_mode():
        fa._validate(q, k, v)
        o, lse = fa._launch(lib, q, k, v, stream, want_lse=True)

        def call():
            return fa._launch_bwd(lib, q, k, v, o, lse, do, stream)

        errs = [_err(g, w) for g, w in
                zip(call(), fa.attention_bwd_ref(q, k, v, o, lse, do))]
        dev_ms = time_ms(call, dev, ITERS, REPEATS)
        b, n, h, d = q.shape
        return {"kernel": "backward (dkv + dq)", "version": version,
                "shape": list(q.shape),
                "max_abs": max(e[0] for e in errs),
                "l2": max(e[1] for e in errs),
                "median_ms": median_ms(call, 10), "device_ms": dev_ms,
                "tflops": 10 * b * h * n * n * d / dev_ms / 1e9,
                "enqueue_us": enqueue_us(call),
                **split_ms(lib, q, k, v, o, lse, do, dev)}


def host_us(fn, calls=200) -> float:
    """µs of host time a call of fn takes when `calls` of them are
    enqueued back to back (no synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def split_ms(lib, q, k, v, o, lse, do, dev):
    """Device ms of the dkv kernel and of the dq kernel alone, each through
    its C entry on buffers made once, and the host µs of one dkv + dq pair
    of C calls (tensor maps and launches, none of the wrapper's torch
    work)."""
    b, n, h, d = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ins = [fa._ptr(t) for t in (q, k, v, do, lse, di)]
    args = (b, n, h, d, *[s for t in (q, k, v, do) for s in t.stride()[:3]],
            d ** -0.5, 1, stream)

    def dkv():
        return lib.flash_attn_bwd_dkv(*ins, fa._ptr(dk), fa._ptr(dv), *args)

    def dq_():
        return lib.flash_attn_bwd_dq(*ins, fa._ptr(dq), *args)

    return {"dkv_device_ms": time_ms(dkv, dev, ITERS, REPEATS),
            "dq_device_ms": time_ms(dq_, dev, ITERS, REPEATS),
            "c_enqueue_us": host_us(lambda: (dkv(), dq_()))}


def sdpa_forward_row(q, k, v, dev):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt)

    with torch.inference_mode():
        b, n, h, d = q.shape
        dev_ms = time_ms(call, dev, ITERS, REPEATS)
        return {"kernel": "forward", "version": "sdpa", "shape": list(q.shape),
                "median_ms": median_ms(call, 10), "device_ms": dev_ms,
                "tflops": 4 * b * h * n * n * d / dev_ms / 1e9,
                "backend": sdpa_backend(call)}


def sdpa_backward_row(q, k, v, do, dev):
    leaves = [x.transpose(1, 2).detach().clone().requires_grad_(True)
              for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    dot = do.transpose(1, 2)

    def call():
        return torch.autograd.grad(out, leaves, dot, retain_graph=True)

    b, n, h, d = q.shape
    dev_ms = time_ms(call, dev, ITERS, REPEATS)
    return {"kernel": "backward", "version": "sdpa", "shape": list(q.shape),
            "median_ms": median_ms(call, 10), "device_ms": dev_ms,
            "tflops": 10 * b * h * n * n * d / dev_ms / 1e9,
            "backend": sdpa_backend(call)}


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: no CUDA device")
    dev = torch.device("cuda")
    print(device_line(dev), flush=True)
    so, secs = _build.build()
    libs = {"this": _build.open_library(so)}
    print(f"built {so.name} in {secs:.1f} s", flush=True)
    mine = ptxas_reports(so.with_suffix(".log").read_text())
    for name in sorted(mine):
        if name.startswith("flash_attn"):
            print(f"ptxas {name}:\n{mine[name]}", flush=True)
    if args.other is not None:
        other_so, secs = _build.build(args.other.resolve(),
                                      so.parent / "other")
        libs["other"] = _build.open_library(other_so)
        print(f"built the other version's {other_so.name} in {secs:.1f} s",
              flush=True)
        theirs = ptxas_reports(other_so.with_suffix(".log").read_text())
        for name in sorted(theirs):
            same = mine.get(name) == theirs[name]
            print(f"ptxas report of {name}: "
                  f"{'same' if same else 'differs'}", flush=True)
    order = ["other", "this", "this", "other"] if "other" in libs \
        else ["this"]
    gen = torch.Generator().manual_seed(0)
    q, k, v, _ = inputs(FWD_SHAPE, gen)
    for version in order:
        print(json.dumps(forward_row(libs[version], version, q, k, v, dev)),
              flush=True)
    print(json.dumps(sdpa_forward_row(q, k, v, dev)), flush=True)
    del q, k, v
    q, k, v, do = inputs(BWD_SHAPE, gen)
    for version in order:
        print(json.dumps(backward_row(libs[version], version, q, k, v, do,
                                      dev)), flush=True)
    print(json.dumps(sdpa_backward_row(q, k, v, do, dev)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
