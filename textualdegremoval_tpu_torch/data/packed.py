"""Packed image archives: TFRecord framing with a key index (the port's
copy of textualdegremoval_tpu/data/packed.py).

* standard TFRecord framing (uint64-LE length, its masked crc32c, the
  payload, the payload's masked crc32c), readable by any TFRecord tool;
* payloads `uint16-LE key length | key utf-8 | image bytes`, so an
  archive describes itself without its index;
* a JSON index `<prefix>.index.json` of key -> offset for random access
  (the sampler's permutations need it), rebuilt by a scan when lost;
* `pack_image_folder` builds an archive from an image folder, and
  `PackedImageReader` (`open_packed`) reads it by key.

`utils.file_client` serves it as the 'tfrecord' backend, and the WithRef
datasets with `io_backend: {type: tfrecord}`, whose roots then name
archive prefixes.
"""

from __future__ import annotations

import json
import os
import struct

from textualdegremoval_tpu_torch.data import native

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven; TFRecord's masked variant
# ---------------------------------------------------------------------------


def _crc_table() -> list[int]:
    poly = 0x82F63B78  # the reflected Castagnoli polynomial
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c_py(data: bytes) -> int:
    """crc32c in Python, a byte at a time (the reference the native loop is
    held to)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """crc32c of `data`: native/tdr_dataio.cc's slice-by-8 loop where it
    builds, else `crc32c_py` (about a second a megabyte)."""
    if native.dataio_available():
        return native.crc32c(data)
    return crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------


def _encode_payload(key: str, img_bytes: bytes) -> bytes:
    kb = key.encode("utf-8")
    return struct.pack("<H", len(kb)) + kb + img_bytes


def _decode_payload(payload: bytes) -> tuple[str, bytes]:
    (klen,) = struct.unpack_from("<H", payload, 0)
    return payload[2:2 + klen].decode("utf-8"), payload[2 + klen:]


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> tuple[int, int]:
        """Append one record; returns (offset, framed length)."""
        off = self._f.tell()
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", masked_crc32c(hdr)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))
        return off, 8 + 4 + len(payload) + 4

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _check(hdr: bytes, hcrc: int, payload: bytes, pcrc: int, offset: int):
    if masked_crc32c(hdr) != hcrc:
        raise IOError(f"TFRecord header crc mismatch at offset {offset}")
    if masked_crc32c(payload) != pcrc:
        raise IOError(f"TFRecord payload crc mismatch at offset {offset}")


def read_record_at(f, offset: int, verify: bool = False) -> bytes:
    """The payload of the record at `offset` of the open file `f`."""
    f.seek(offset)
    hdr = f.read(8)
    (length,) = struct.unpack("<Q", hdr)
    (hcrc,) = struct.unpack("<I", f.read(4))
    payload = f.read(length)
    (pcrc,) = struct.unpack("<I", f.read(4))
    if verify:
        _check(hdr, hcrc, payload, pcrc, offset)
    return payload


def iterate_records(path: str, verify: bool = False):
    """(offset, payload) of every record in order (the index-free scan)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        off = 0
        while off < size:
            payload = read_record_at(f, off, verify)
            yield off, payload
            off += 8 + 4 + len(payload) + 4


# ---------------------------------------------------------------------------
# image archives
# ---------------------------------------------------------------------------

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def pack_image_folder(src_dir: str, out_prefix: str) -> int:
    """Pack every image under src_dir (recursively) into
    <out_prefix>.tfrecord and <out_prefix>.index.json, keyed by the path
    relative to src_dir.  Returns the number of records."""
    keys = []
    for root, _, files in os.walk(src_dir):
        for name in sorted(files):
            if name.lower().endswith(IMAGE_EXTS):
                full = os.path.join(root, name)
                keys.append((os.path.relpath(full, src_dir), full))
    keys.sort()
    index = {}
    with TFRecordWriter(out_prefix + ".tfrecord") as w:
        for key, full in keys:
            with open(full, "rb") as f:
                data = f.read()
            index[key], _ = w.write(_encode_payload(key, data))
    with open(out_prefix + ".index.json", "w") as f:
        json.dump(index, f)
    return len(index)


def _pread_exact(fd: int, n: int, offset: int) -> bytes:
    """Exactly n bytes at offset (a loop over short reads)."""
    chunks = []
    while n > 0:
        b = os.pread(fd, n, offset)
        if not b:
            raise IOError(f"truncated archive: end of file at offset {offset}")
        chunks.append(b)
        offset += len(b)
        n -= len(b)
    return b"".join(chunks)


class PackedImageReader:
    """Keyed random access to a packed archive.  Reads are positioned
    (os.pread on one descriptor, opened at the first read, after any fork),
    so one reader serves concurrent threads."""

    def __init__(self, prefix: str, verify: bool = False):
        self._fd = None
        if prefix.endswith(".tfrecord"):
            prefix = prefix[:-len(".tfrecord")]
        self._path = prefix + ".tfrecord"
        self._verify = verify
        idx_path = prefix + ".index.json"
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                self._index = json.load(f)
        else:  # the index was lost: a scan rebuilds it
            self._index = {_decode_payload(payload)[0]: off
                           for off, payload in iterate_records(self._path,
                                                               verify)}

    def keys(self) -> list[str]:
        return sorted(self._index)

    def __len__(self):
        return len(self._index)

    def __contains__(self, key):
        return key in self._index

    def get(self, key: str) -> bytes:
        if self._fd is None:
            self._fd = os.open(self._path, os.O_RDONLY)
        offset = self._index[key]
        hdr = _pread_exact(self._fd, 12, offset)
        (length,) = struct.unpack_from("<Q", hdr, 0)
        rest = _pread_exact(self._fd, length + 4, offset + 12)
        payload = rest[:length]
        if self._verify:
            _check(hdr[:8], struct.unpack_from("<I", hdr, 8)[0], payload,
                   struct.unpack_from("<I", rest, length)[0], offset)
        got_key, data = _decode_payload(payload)
        if got_key != key:
            raise IOError(f"index and archive disagree: wanted {key!r}, "
                          f"found {got_key!r}")
        return data

    def __getstate__(self):
        # a descriptor is the process's own: a spawned worker opens its own
        return {**self.__dict__, "_fd": None}

    def close(self):
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)

    def __del__(self):
        self.close()


def open_packed(prefix: str) -> PackedImageReader:
    """A reader of the archive at `prefix` (`<prefix>.tfrecord`)."""
    return PackedImageReader(prefix)
