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
    "tblock_chain_smem_bytes": ([_I] * 6, _L),
    "tblock_chain_ctas_per_sm": ([_I] * 6, _I),
    "tblock_chain": ([_P] * 21 + [_I] * 12 + [_P], _I),
    "tblock_gdfn_bwd_smem_bytes": ([_I] * 4, _L),
    "tblock_gdfn_bwd": ([_P] * 14 + [_I] * 9 + [_P], _I),
    "tblock_attn_bwd_max_cph": ([], _I),
    "tblock_attn_bwd_smem_bytes": ([_I] * 6, _L),
    "tblock_attn_bwd_stats": ([_P] * 11 + [_I] * 8 + [_P], _I),
    "tblock_attn_bwd_apply": ([_P] * 22 + [_I] * 9 + [_P], _I),
    "tblock_wgrad": ([_P, _I, _L, _L, _P, _I, _L, _L, _P] + [_I] * 7 + [_P],
                     _I),
    "tblock_wgrad_ssq": ([_P, _I, _L, _L, _P, _I, _L, _L] + [_P] * 3
                         + [_I] * 6 + [_P], _I),
    "tblock_wgrad_tiles": ([_I] * 2, _I),
    "tblock_wgrad_ctas_per_sm": ([_I] * 2, _I),
    "bwd_stencil_tile": ([_I], _I),
    "bwd_ln_rows": ([_P] * 3 + [_I, ctypes.c_float] + [_P] * 3 + [_I] * 2
                    + [_P], _I),
    "bwd_ln_rows_bwd": ([_P] * 5 + [_I] + [_P] * 3 + [_I] * 3 + [_P], _I),
    "bwd_gdfn_stencil": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "bwd_dlin_stencil": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "bwd_gemm": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "bwd_dgrad": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "bwd_head_products": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "fwd_qkv_stencil": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "fwd_gate_stencil": ([_P] * 3 + [_I] * 5 + [_P], _I),
    "fwd_gemm_residual": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "fwd_gemm_residual_ln": ([_P] * 5 + [_I, ctypes.c_float] + [_P] * 2
                             + [_I] * 3 + [_P], _I),
    "fwd_attn_out": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "attn_heads_o": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "fwd_attn_glue": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "naf_gemm_bias": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "naf_gemm_gate": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "naf_gate_chunk": ([], _I),
    "naf_gate_stencil": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "naf_sca_glue": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "nafblock_smem_bytes": ([_I] * 5, _L),
    "nafblock_gate_chunk": ([], _I),
    "nafblock_ctas_per_sm": ([_I] * 5, _I),
    "nafblock_sum": ([_P] * 8 + [_I] * 9 + [_P], _I),
    "nafblock_apply": ([_P] * 16 + [_I] * 8 + [_P], _I),
    "gdfn_smem": ([_I] * 4, _L),
    "gdfn_fwd": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "mdta_max_cph": ([], _I),
    "mdta_stats_smem": ([_I] * 3, _L),
    "mdta_stats": ([_P] * 5 + [_I] * 5 + [_L] * 3 + [_I] * 3 + [_P], _I),
    "mdta_finish": ([_P] * 5 + [_I] * 4 + [_P], _I),
    "mdta_gram_work": ([_I] * 4, _L),
    "mdta_stats_gram": ([_P] * 5 + [_I] * 4 + [_L] * 2 + [_I, _P], _I),
    "probe_qkv_smem": ([_I] * 6, _L),
    "probe_qkv_current": ([_P] * 4 + [_I] * 8 + [_P], _I),
    "probe_qkv_composed": ([_P] * 3 + [_I] * 8 + [_P], _I),
    "probe_qkv_tma_ctas_per_sm": ([_I] * 3, _I),
    "probe_qkv_tma_current": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "probe_qkv_tma_composed": ([_P] * 3 + [_I] * 6 + [_P], _I),
    "probe_stencil_max_width": ([_I], _I),
    "probe_stencil": ([_P] * 3 + [_I] * 6 + [_P], _I),
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


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path, build_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir / f"libtdr_torch_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path | None = None,
          build_dir: Path | None = None) -> tuple[Path, float]:
    """Compile the sources of `csrc` (default: this package's) into
    `build_dir` (default: BUILD_DIR) unless a library of the same hash
    exists there: one nvcc per source, all at once, then one link.
    Returns (library path, seconds spent compiling and linking)."""
    csrc, build_dir = csrc or _CSRC, build_dir or BUILD_DIR
    so = library_path(csrc, build_dir)
    if so.exists():
        return so, 0.0
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources(csrc):
        if src.suffix != ".cu":
            continue
        obj = build_dir / f"{tag}.{src.stem}.o"
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


def open_library(so: Path) -> ctypes.CDLL:
    """A built kernel library with its C signatures set."""
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    return open_library(build()[0])
