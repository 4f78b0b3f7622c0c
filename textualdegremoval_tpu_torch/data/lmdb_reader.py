"""Pure-Python read-only LMDB parser (the port's copy of
textualdegremoval_tpu/data/lmdb_reader.py).

The reference's production datasets are BasicSR-style LMDB archives read
through ``lmdb.open`` (reference utils/file_client.py:93-130,
data/utils_data.py:94-160).  Neither this package nor the machines that
run it need the ``lmdb`` C package: this module parses the LMDB on-disk
format directly, read-only, for `utils.file_client.LmdbBackend` and the
datasets' ``io_backend: lmdb``.

Format notes (from the published LMDB 0.9 on-disk layout, mdb.c):

* ``data.mdb`` is a sequence of fixed-size pages.  Pages 0 and 1 are meta
  pages (magic ``0xBEEFC0DE``, data-format version 1); the live one is the
  one with the larger transaction id.  The page size is recorded in the
  meta (``mm_psize``, aliased to ``mm_dbs[0].md_pad``).
* The main database is ``mm_dbs[1]``: a B+-tree of BRANCH pages (key ->
  child page number) over LEAF pages (key -> inline value, or key ->
  overflow-page number when the value doesn't fit).
* Every page starts with a 16-byte header: ``pgno u64, pad u16, flags u16,
  lower u16, upper u16`` (for OVERFLOW pages the lower/upper union is a
  ``u32`` page count).  Node pointers are an array of ``u16`` in-page
  offsets growing up from the header; node bodies grow down from the top.
* A node is ``lo u16, hi u16, flags u16, ksize u16, key[ksize], data``.
  Leaf data size is ``lo | hi<<16``; a branch child page number is
  ``lo | hi<<16 | flags<<32``.  Node flag ``F_BIGDATA`` (0x01) means the
  data area holds a ``u64`` overflow page number and the value is the
  ``lo|hi<<16`` bytes starting 16 bytes into that overflow page
  (contiguous across its pages).

Sub-databases, DUPSORT and LEAF2 (fixed-size dup) pages are rejected
loudly: image archives never use them.
"""

from __future__ import annotations

import mmap
import os
import os.path as osp
import struct

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
NODEHDRSZ = 8

_META = struct.Struct(
    "<II"  # mm_magic, mm_version
    "QQ"  # mm_address (ptr), mm_mapsize
    # mm_dbs[0] (FREE_DBI): pad(=psize) flags depth branch leaf ovf entries root
    "IHHQQQQQ"
    # mm_dbs[1] (MAIN_DBI)
    "IHHQQQQQ"
    "QQ"  # mm_last_pg, mm_txnid
)


class LmdbFormatError(IOError):
    pass


class PurePythonLmdb:
    """Read-only keyed access to an LMDB environment without the lmdb
    package.  ``path`` is the ``*.lmdb`` directory, a directory containing
    ``data.mdb``, or the ``data.mdb`` file itself."""

    def __init__(self, path: str):
        if osp.isdir(path):
            path = osp.join(path, "data.mdb")
        self._path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self.psize, self.depth, self.entries, self.root) = meta

    # -- meta ---------------------------------------------------------------

    def _parse_meta(self, off: int):
        buf = self._mm[off + PAGEHDRSZ : off + PAGEHDRSZ + _META.size]
        if len(buf) < _META.size:
            return None
        v = _META.unpack(buf)
        magic, version = v[0], v[1]
        if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
            return None
        psize = v[4]  # mm_dbs[0].md_pad aka mm_psize
        main = v[12:20]  # (pad, flags, depth, branch, leaf, ovf, entries, root)
        txnid = v[21]
        if main[1] & 0x04 or main[1] & 0x10:  # MDB_DUPSORT / MDB_DUPFIXED
            raise LmdbFormatError(
                "DUPSORT databases are not supported (image archives never "
                "use them)")
        return txnid, psize, main[2], main[6], main[7]

    def _pick_meta(self):
        m0 = self._parse_meta(0)
        # page 1 sits at psize; when meta 0 is torn, probe common sizes
        candidates = ([m0[1]] if m0 else [4096, 8192, 16384, 32768, 65536])
        m1 = None
        for ps in candidates:
            m1 = self._parse_meta(ps)
            if m1 is not None:
                break
        if m0 is None and m1 is None:
            raise LmdbFormatError(f"{self._path}: no valid LMDB meta page")
        best = max((m for m in (m0, m1) if m is not None),
                   key=lambda m: m[0])
        return best[1], best[2], best[3], best[4]

    # -- pages --------------------------------------------------------------

    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._mm):
            raise LmdbFormatError(f"page {pgno} beyond end of file")
        _, _, flags, lower, upper = struct.unpack_from("<QHHHH", self._mm, off)
        return off, flags, lower, upper

    def _nodes(self, off: int, lower: int):
        nkeys = (lower - PAGEHDRSZ) // 2
        return struct.unpack_from(f"<{nkeys}H", self._mm, off + PAGEHDRSZ)

    def _node(self, page_off: int, ptr: int):
        lo, hi, flags, ksize = struct.unpack_from(
            "<HHHH", self._mm, page_off + ptr)
        key_off = page_off + ptr + NODEHDRSZ
        key = bytes(self._mm[key_off : key_off + ksize])
        return lo, hi, flags, key, key_off + ksize

    def _leaf_value(self, lo, hi, flags, data_off) -> bytes:
        size = lo | hi << 16
        if flags & (F_SUBDATA | F_DUPDATA):
            raise LmdbFormatError("sub-database/dup nodes are not supported")
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._mm, data_off)
            ooff, oflags, _, _ = self._page(ovpg)
            if not oflags & P_OVERFLOW:
                raise LmdbFormatError(
                    f"page {ovpg} referenced as overflow is not P_OVERFLOW")
            start = ooff + PAGEHDRSZ
            return bytes(self._mm[start : start + size])
        return bytes(self._mm[data_off : data_off + size])

    # -- public API ---------------------------------------------------------

    def get(self, key) -> bytes:
        """Value for key; raises KeyError when absent."""
        if isinstance(key, str):
            key = key.encode("ascii")
        if self.root == P_INVALID:
            raise KeyError(key)
        pgno = self.root
        for _ in range(self.depth + 1):
            off, flags, lower, upper = self._page(pgno)
            if flags & P_LEAF2:
                raise LmdbFormatError("LEAF2 pages are not supported")
            ptrs = self._nodes(off, lower)
            if flags & P_BRANCH:
                # largest child whose separator key <= key (node 0's key is
                # an implicit -inf)
                child = None
                for i, p in enumerate(ptrs):
                    lo, hi, nflags, nkey, _ = self._node(off, p)
                    if i > 0 and nkey > key:
                        break
                    child = lo | hi << 16 | nflags << 32
                pgno = child
            elif flags & P_LEAF:
                for p in ptrs:
                    lo, hi, nflags, nkey, data_off = self._node(off, p)
                    if nkey == key:
                        return self._leaf_value(lo, hi, nflags, data_off)
                raise KeyError(key)
            else:
                raise LmdbFormatError(
                    f"page {pgno} has unexpected flags {flags:#x}")
        raise LmdbFormatError("B-tree deeper than recorded depth (corrupt?)")

    def items(self):
        """In-order (key, value) iteration over the whole database."""
        if self.root == P_INVALID:
            return
        stack = [self.root]
        while stack:
            pgno = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            ptrs = self._nodes(off, lower)
            if flags & P_BRANCH:
                children = []
                for p in ptrs:
                    lo, hi, nflags, _, _ = self._node(off, p)
                    children.append(lo | hi << 16 | nflags << 32)
                stack.extend(reversed(children))
            elif flags & P_LEAF:
                for p in ptrs:
                    lo, hi, nflags, nkey, data_off = self._node(off, p)
                    yield nkey.decode("ascii", "surrogateescape"), \
                        self._leaf_value(lo, hi, nflags, data_off)
            else:
                raise LmdbFormatError(
                    f"page {pgno} has unexpected flags {flags:#x}")

    def keys(self) -> list:
        return [k for k, _ in self.items()]

    def __len__(self):
        return self.entries

    def __contains__(self, key) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def __getstate__(self):
        # the map and the file are the process's own: a spawned DataLoader
        # worker maps the file anew
        return {"path": self._path}

    def __setstate__(self, state):
        self.__init__(state["path"])

    def close(self):
        mm, self._mm = self._mm, None
        if mm is not None:
            mm.close()
            self._f.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LmdbKeyedReader:
    """The keyed-archive interface shared with PackedImageReader (keys() /
    get() / len), over an ``*.lmdb`` directory.  Keys come from
    ``meta_info.txt`` when present (BasicSR convention: ``name.png (h,w,c)
    level`` per line, lmdb key = name without extension — reference
    data/utils_data.py:116-156); otherwise from a B-tree scan."""

    def __init__(self, db_path: str):
        self._db = PurePythonLmdb(db_path)
        self._meta = {}
        meta_file = osp.join(db_path, "meta_info.txt") \
            if osp.isdir(db_path) else None
        if meta_file and osp.exists(meta_file):
            with open(meta_file) as f:
                for line in f:
                    name = line.split()[0] if line.split() else None
                    if name:
                        self._meta[osp.splitext(name)[0]] = name
        self._keys = sorted(self._meta) if self._meta else self._db.keys()

    def keys(self) -> list:
        return list(self._keys)

    def filename(self, key: str) -> str:
        """Original filename (with extension) for an lmdb key."""
        return self._meta.get(key, key)

    def get(self, key: str) -> bytes:
        return self._db.get(key)

    def __len__(self):
        return len(self._keys)

    def __contains__(self, key):
        return key in self._keys
