"""ctypes binding of the repository's native data-path sources
(native/tdr_dataio.cc's crc32c, native/tdr_decode.cc's libpng / libjpeg
decoder), the port's counterpart of textualdegremoval_tpu/data/native.py,
binding what the port calls.

The port builds each source itself with g++ at first use, into
`<repo>/build/native/`, named by a hash of the source and the flags, so an
edited source is rebuilt; the build runs under a file lock and lands by an
atomic rename, so concurrent processes neither race nor read a torn
library.  native/ itself is only read.  Where g++ or a library is missing
(the decoder needs libpng and libjpeg), or the build fails, that part is
unavailable and callers take their numpy paths: `imread_f32` decodes with
cv2 or data/png.py, `packed.crc32c` runs its table in Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from textualdegremoval_tpu_torch.utils.filelock import build_lock

_ROOT = Path(__file__).resolve().parents[2]
_SOURCES = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_LIBS = {"tdr_dataio": ("-lpthread",),
         "tdr_decode": ("-lpng", "-ljpeg", "-lpthread")}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "tdr_dataio": {
        "crc32c": ([_U8P, ctypes.c_int64], ctypes.c_uint32)},
    "tdr_decode": {
        "tdr_probe": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
        "tdr_decode": ([ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int],
                       ctypes.c_int)},
}


def _build(name: str) -> Path:
    """native/<name>.cc -> build/native/lib<name>-<hash>.so, built once
    under a lock.  Raises where the build fails."""
    src = _SOURCES / f"{name}.cc"
    flags = CXXFLAGS + _LIBS[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    with build_lock(BUILD_DIR):
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp), str(src),
                                *_LIBS[name]],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
    return so


@functools.cache
def _load(name: str) -> ctypes.CDLL | None:
    """The library of native/<name>.cc with its signatures set, or None
    where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build(name)))
    except (OSError, subprocess.SubprocessError):
        return None
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def dataio_available() -> bool:
    return _load("tdr_dataio") is not None


def decode_available() -> bool:
    return _load("tdr_decode") is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def crc32c(data: bytes) -> int:
    """crc32c (Castagnoli) of `data`, the native slice-by-8 loop."""
    buf = np.frombuffer(data, np.uint8)
    return int(_load("tdr_dataio").crc32c(_u8(buf), buf.size))


def decode_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG file -> (H, W, 3) uint8 RGB.  Raises IOError where
    the decoder cannot read it (a 16-bit PNG among them)."""
    lib = _load("tdr_decode")
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.tdr_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"native decoder cannot read {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.tdr_decode(path.encode(), _u8(out), h.value, w.value)
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out
