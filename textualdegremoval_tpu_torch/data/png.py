"""PNG files with numpy and zlib alone, for machines without cv2.

`read_png` decodes non-interlaced 8- and 16-bit gray, gray + alpha, RGB
and RGBA files (every filter type); `write_png` writes 8- or 16-bit gray,
RGB or RGBA with filter 0.  Arrays are (H, W) or (H, W, C) in the file's
channel order (RGB), uint8 or uint16.  `imread_f32` and `imwrite` take
this path only where cv2 cannot be imported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `raw` ((h, 1 + stride) bytes)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = row
        elif f == 1:  # Sub: a running sum along each byte lane
            lanes = np.pad(row, (0, -stride % bpp)).reshape(-1, bpp)
            cur = (np.cumsum(lanes, 0) & 255).reshape(-1)[:stride]
        elif f == 2:  # Up
            cur = (row + prev) & 255
        elif f in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (row[x:x + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG filter type {f} is not defined")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


def decode_png(data: bytes, name: str = "PNG bytes") -> np.ndarray:
    """The image of a PNG file's bytes (`name` for the errors)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    idat, hdr = [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{name}: colour type {ctype}, depth {depth}, interlace "
            f"{interlace}; without cv2 only non-interlaced 8/16-bit gray, "
            "RGB and their alpha forms are read")
    ch, nbytes = _CHANNELS[ctype], depth // 8
    stride = w * ch * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(h, 1 + stride), h, stride, ch * nbytes)
    if nbytes == 2:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
