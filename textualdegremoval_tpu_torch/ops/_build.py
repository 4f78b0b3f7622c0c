"""Build the port's CUDA sources with nvcc and load them through ctypes.

At first use, every `csrc/*.cu` of this package is compiled by its own
nvcc process, all started together, and the objects are linked into one
shared library under `<repo>/build/torch_kernels/`, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  The library has a plain C interface: pointers and the
stream pass as `c_void_p`, ints as `c_int`, 64-bit strides as
`c_longlong`.  ptxas's report (registers, shared memory, spills) is kept
beside the library as `<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "tblock_smem_bytes": ([_I] * 6, _L),
    "tblock_hidden_chunk": ([], _I),
    "tblock_max_cph": ([], _I),
    "tblock_error_string": ([_I], ctypes.c_char_p),
    "tblock_stats": ([_P] * 9 + [_I] * 10 + [_P], _I),
    "tblock_apply": ([_P] * 14 + [_I] * 10 + [_P], _I),
    "tblock_gdfn_bwd_smem_bytes": ([_I] * 4, _L),
    "tblock_gdfn_bwd": ([_P] * 14 + [_I] * 10 + [_P], _I),
    "tblock_attn_bwd_smem_bytes": ([_I] * 6, _L),
    "tblock_attn_bwd_stats": ([_P] * 11 + [_I] * 9 + [_P], _I),
    "tblock_attn_bwd_apply": ([_P] * 22 + [_I] * 10 + [_P], _I),
    "tblock_wgrad": ([_P, _I, _L, _L, _P, _I, _L, _L, _P] + [_I] * 7 + [_P],
                     _I),
    "nafblock_smem_bytes": ([_I] * 5, _L),
    "nafblock_gate_chunk": ([], _I),
    "nafblock_ctas_per_sm": ([_I] * 5, _I),
    "nafblock_sum": ([_P] * 8 + [_I] * 9 + [_P], _I),
    "nafblock_apply": ([_P] * 16 + [_I] * 8 + [_P], _I),
    "flash_attn_error_string": ([_I], ctypes.c_char_p),
    "flash_attn_fwd": ([_P] * 5 + [_I] * 4 + [_L] * 9
                       + [ctypes.c_float, _I, _P], _I),
    "flash_attn_bwd_dkv": ([_P] * 8 + [_I] * 4 + [_L] * 12
                           + [ctypes.c_float, _I, _P], _I),
    "flash_attn_bwd_dq": ([_P] * 7 + [_I] * 4 + [_L] * 12
                          + [ctypes.c_float, _I, _P], _I),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtdr_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless a library of the same hash exists: one
    nvcc per source, all at once, then one link.  Returns (library path,
    seconds spent compiling and linking)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = so.with_name(f"{tag}.tmp.so")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *[str(obj) for _, obj, _ in jobs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    seconds = time.perf_counter() - t0
    for _, obj, _ in jobs:
        obj.unlink()
    so.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, so)
    return so, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
