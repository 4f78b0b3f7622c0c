"""Convert a BasicSR-style ``*.lmdb`` image archive into the packed
TFRecord archive that `data/packed.py` reads (counterpart of
tools/lmdb_to_tfrecord.py).

Reads go through the pure-Python LMDB parser (`data/lmdb_reader.py`), so
no lmdb package is needed.  Each record keeps its image's original file
name (the extension restored from meta_info.txt), so the packed archive
pairs by the same base names as the folder it was made from, and its
bytes are the archive's own, unchanged.

    python -m textualdegremoval_tpu_torch.tools.lmdb_to_tfrecord \\
        <src.lmdb> <out_prefix>

writes <out_prefix>.tfrecord and <out_prefix>.index.json.
"""

from __future__ import annotations

import json
import sys

from textualdegremoval_tpu_torch.data.lmdb_reader import LmdbKeyedReader
from textualdegremoval_tpu_torch.data.packed import (
    TFRecordWriter, _encode_payload,
)


def convert(src_lmdb: str, out_prefix: str) -> int:
    """Pack every record of the lmdb archive; returns how many."""
    reader = LmdbKeyedReader(src_lmdb)
    index = {}
    with TFRecordWriter(out_prefix + ".tfrecord") as w:
        for key in reader.keys():
            name = reader.filename(key)
            off, _ = w.write(_encode_payload(name, reader.get(key)))
            index[name] = off
    with open(out_prefix + ".index.json", "w") as f:
        json.dump(index, f)
    return len(index)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    n = convert(*argv)
    print(f"packed {n} records -> {argv[1]}.tfrecord")
    return 0


if __name__ == "__main__":
    sys.exit(main())
