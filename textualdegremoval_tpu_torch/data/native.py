"""ctypes binding of the repository's native data-path sources
(native/tdr_dataio.cc's crc32c, native/tdr_decode.cc's libpng / libjpeg
decoder), the port's counterpart of textualdegremoval_tpu/data/native.py
with its functions: crc32c, the uint8 -> float32 conversion, the eight
flip / rotation modes, seeded Gaussian noise, the threaded crop-and-augment
of a batch, and the decoder, one file or a threaded batch.

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
_F32P = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "tdr_dataio": {
        "crc32c": ([_U8P, ctypes.c_int64], ctypes.c_uint32),
        "u8_to_f32": ([_U8P, _F32P, ctypes.c_int64], None),
        "augment_f32": ([_F32P, _F32P] + [ctypes.c_int] * 4, None),
        "add_gaussian_noise": ([_F32P, _F32P, ctypes.c_int64, ctypes.c_float,
                                ctypes.c_uint64], None),
        "batch_prepare": ([ctypes.POINTER(_U8P), ctypes.POINTER(_F32P), _IP,
                           ctypes.c_int, ctypes.c_int], None)},
    "tdr_decode": {
        "tdr_probe": ([ctypes.c_char_p, _IP, _IP], ctypes.c_int),
        "tdr_decode": ([ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int],
                       ctypes.c_int),
        "tdr_decode_batch": ([ctypes.POINTER(ctypes.c_char_p),
                              ctypes.POINTER(_U8P), _IP, ctypes.c_int,
                              ctypes.c_int], ctypes.c_int)},
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


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] (value / 255), any shape."""
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.empty(src.shape, np.float32)
    _load("tdr_dataio").u8_to_f32(_u8(src), _f32(dst), src.size)
    return dst


def augment_f32(src: np.ndarray, mode: int) -> np.ndarray:
    """One of the eight flip / rotation modes (data/transforms.py's
    `augment_img` order) of an (H, W, C) float32 image; modes 2, 3, 6 and 7
    transpose it to (W, H, C)."""
    src = np.ascontiguousarray(src, np.float32)
    h, w, c = src.shape
    dst = np.empty((w, h, c) if mode in (2, 3, 6, 7) else (h, w, c),
                   np.float32)
    _load("tdr_dataio").augment_f32(_f32(src), _f32(dst), h, w, c, mode)
    return dst


def add_gaussian_noise(src: np.ndarray, sigma: float, seed: int
                       ) -> np.ndarray:
    """src plus N(0, (sigma / 255)^2) noise (sigma on the 8-bit scale)
    from the library's generator under `seed` (float32, any shape)."""
    src = np.ascontiguousarray(src, np.float32)
    dst = np.empty_like(src)
    _load("tdr_dataio").add_gaussian_noise(_f32(src), _f32(dst), src.size,
                                           sigma, seed)
    return dst


def batch_prepare(images: list[np.ndarray], crops: list[tuple],
                  patch: int, modes: list[int], n_threads: int = 4
                  ) -> np.ndarray:
    """images: uint8 (H, W, C); crops: (top, left) each; modes: each
    image's `augment_f32` mode.  Returns the (N, patch, patch, C) float32
    crops after their modes, made on `n_threads` threads."""
    n, c = len(images), images[0].shape[2]
    srcs, dsts = (_U8P * n)(), (_F32P * n)()
    params = np.empty((n, 8), np.int32)
    keep = [np.ascontiguousarray(img, np.uint8) for img in images]
    outs = [np.empty((patch, patch, c), np.float32) for _ in range(n)]
    for i, (img, out) in enumerate(zip(keep, outs)):
        srcs[i], dsts[i] = _u8(img), _f32(out)
        h, w, _ = img.shape
        params[i] = (h, w, c, crops[i][0], crops[i][1], patch, patch,
                     modes[i])
    _load("tdr_dataio").batch_prepare(
        srcs, dsts, params.ctypes.data_as(_IP), n, n_threads)
    return np.stack(outs)


def decode_batch_rgb(paths: list[str], n_threads: int = 4
                     ) -> list[np.ndarray]:
    """PNG or JPEG files -> (H, W, 3) uint8 RGB each, decoded on
    `n_threads` threads.  Raises IOError where one cannot be read."""
    lib = _load("tdr_decode")
    n = len(paths)
    dims = np.empty((n, 2), np.int32)
    outs = []
    for i, path in enumerate(paths):
        h, w = ctypes.c_int(), ctypes.c_int()
        if lib.tdr_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)):
            raise IOError(f"native decoder cannot read {path}")
        dims[i] = (h.value, w.value)
        outs.append(np.empty((h.value, w.value, 3), np.uint8))
    cpaths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    dsts = (_U8P * n)(*[_u8(o) for o in outs])
    rc = lib.tdr_decode_batch(cpaths, dsts, dims.ctypes.data_as(_IP), n,
                              n_threads)
    if rc != 0:
        raise IOError(f"native batch decode failed ({rc})")
    return outs
