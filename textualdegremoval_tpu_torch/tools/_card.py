"""What the probe tools read of the card, and their timer."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# cycles a second of the spin before a timed run; an H100's SM clock is at
# most 1.98 GHz, so the spin lasts at least as long as asked
_SPIN_HZ = 2e9


def nvidia_smi(query: str, device: torch.device) -> str:
    """One `nvidia-smi --query-gpu` field of the device, as printed."""
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "-i", str(device.index or 0)], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_line(device: torch.device) -> str:
    """The card's name and power limit (or "cpu"), printed before any
    number a tool measures."""
    if device.type != "cuda":
        return "device: cpu (plain versions; no device metric)"
    return f"device: {nvidia_smi('name,power.limit', device)}"


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def median_ms(fn, reps: int = 5) -> float:
    """ms of one call of fn on the card: after one warm-up call, the median
    of `reps` single calls, each between two CUDA events (what a caller
    that launches once sees, the launch's own gaps included)."""
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


def time_ms(fn, device: torch.device, iters: int, repeats: int) -> float:
    """ms per call of fn: after one warm-up call, the median of `repeats`
    runs of `iters` calls, each run's mean per call (`median_ms` takes the
    same statistic of single calls).  On the card,
    CUDA events time the device: the stream first spins
    (`torch.cuda._sleep`) for twice as long as the host takes to enqueue
    the run, so that the calls run back to back and a kernel shorter than
    its launch's host work is timed, not the host.  On the CPU, the host
    clock."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        spin = int(min(2 * enqueue_s * iters, 1.0) * _SPIN_HZ)
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            s.record()
            for _ in range(iters):
                fn()
            e.record()
            torch.cuda.synchronize(device)
            ms = s.elapsed_time(e)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        times.append(ms / iters)
    return statistics.median(times)


def device_split(fn, reps: int = 3):
    """[(kernel, device ms)] of one call of fn on the card, in launch order
    (`torch.profiler`, the mean over `reps` calls after a warm-up one): the
    port's kernels by name, torch's (glue, sums of partials) in a row as
    one "torch" entry."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    per = len(events) // reps
    rows = []
    for i in range(per):
        key = events[i].name.removeprefix("void ")
        name = (key.removeprefix("(anonymous namespace)::").split("(")[0]
                if key.startswith("(anonymous namespace)::") else "torch")
        ms = sum(events[i + r * per].time_range.elapsed_us()
                 for r in range(reps)) / reps / 1e3
        if rows and rows[-1][0] == name == "torch":
            rows[-1][1] += ms
        else:
            rows.append([name, ms])
    return [(n, round(ms, 4)) for n, ms in rows]
