"""Profiling helpers (counterpart of textualdegremoval_tpu/utils/profiling.py).

- count_params(): parameters of a module, or elements of a collection of
  tensors.
- model_complexity(): {'params', 'flops', 'macs'} by
  torch.utils.flop_counter.FlopCounterMode (macs = flops / 2, the
  ptflops convention the reference prints).
- trace(): torch.profiler around a block, writing a Chrome trace
  (`*.pt.trace.json`) into a directory.
- measure_inference_speed(): the reference's fps harness
  (nafnet_arch_utils.py:313-349), fetching a scalar per iteration as JAX
  does.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.nn as nn


def count_params(module_or_tensors) -> int:
    """Parameter count of an nn.Module, or element count of tensors (a
    state dict or any iterable of tensors)."""
    if isinstance(module_or_tensors, nn.Module):
        tensors = module_or_tensors.parameters()
    elif isinstance(module_or_tensors, dict):
        tensors = module_or_tensors.values()
    else:
        tensors = module_or_tensors
    return sum(t.numel() for t in tensors)


def _tensors(tree):
    """The tensors of a nest of lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


def model_complexity(fn, *args) -> dict:
    """{'params', 'flops', 'macs'} of fn(*args); params: those of fn when
    it is an nn.Module, and every nn.Parameter among args.

    The count is FlopCounterMode's: it reads ATen's convolutions and
    matrix products from their shapes and nothing else (no elementwise
    work, where XLA's cost analysis counts some).  It cannot see into a
    hand-written kernel, so the arguments must lie on the CPU, where the
    port's kernel wrappers run their plain PyTorch versions; a CUDA
    argument raises.  Under torch's FakeTensorMode the CPU tensors are
    shapes alone and the count costs no arithmetic (as `chip_smoke.py`
    counts a full-width network)."""
    from torch.utils.flop_counter import FlopCounterMode

    if any(t.is_cuda for t in _tensors(args)):
        raise ValueError("model_complexity counts the plain route: pass "
                         "CPU or meta tensors (a CUDA kernel's work is "
                         "invisible to FlopCounterMode)")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    flops = float(counter.get_total_flops())
    params = count_params(
        [a for a in _tensors(args) if isinstance(a, nn.Parameter)])
    if isinstance(fn, nn.Module):
        params += count_params(fn)
    return {"params": params, "flops": flops, "macs": flops / 2.0}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU activity, and the card's when
    CUDA is in use), its Chrome trace written into log_dir as
    `<worker>.<time>.pt.trace.json` by tensorboard_trace_handler (no
    TensorBoard needed to write or read it)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def measure_inference_speed(fn, args, max_iter: int = 200,
                            warmup_iter: int = 5) -> float:
    """Images per second of fn(*args) (the batch from args[0].shape[0]):
    each iteration fetches the sum of fn's first output to the host, so
    the clock waits for the device."""
    with torch.inference_mode():
        for _ in range(warmup_iter):
            float(_tensors(fn(*args))[0].sum())
        t0 = time.perf_counter()
        for _ in range(max_iter):
            float(_tensors(fn(*args))[0].sum())
        dt = time.perf_counter() - t0
    return args[0].shape[0] * max_iter / dt
