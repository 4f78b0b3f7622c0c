"""Byte-stream file backends (the port's counterpart of
textualdegremoval_tpu/utils/file_client.py, reference
utils/file_client.py:5-187): `FileClient(backend, **kwargs).get(key)`.

disk reads a file; lmdb reads a reference `*.lmdb` archive through the
pure-Python parser (data/lmdb_reader.py; no lmdb package is needed);
tfrecord reads a packed archive (data/packed.py); memcached needs the
cluster's proprietary `mc` client, as the reference's does, and raises
without it.
"""

from __future__ import annotations


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class LmdbBackend:
    def __init__(self, db_path: str):
        from textualdegremoval_tpu_torch.data.lmdb_reader import (
            PurePythonLmdb,
        )

        self._db = PurePythonLmdb(db_path)

    def get(self, key: str) -> bytes:
        return self._db.get(key)


class MemcachedBackend:
    """Cluster memcached reads (reference utils/file_client.py:26-58),
    through the proprietary `mc` client the reference also requires."""

    def __init__(self, server_list_cfg: str, client_cfg: str,
                 sys_path: str | None = None):
        if sys_path is not None:
            import sys

            sys.path.append(sys_path)
        try:
            import mc
        except ImportError as e:
            raise ImportError(
                "memcached backend requested but the mc client is not "
                "installed") from e
        self._mc = mc
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg,
                                                      client_cfg)
        self._buffer = mc.pyvector()

    def get(self, filepath: str) -> bytes:
        self._client.Get(str(filepath), self._buffer)
        return self._mc.ConvertBuffer(self._buffer)


class TfrecordBackend:
    """Keyed reads from a packed TFRecord archive (data/packed.py)."""

    def __init__(self, db_path: str, verify: bool = False):
        from textualdegremoval_tpu_torch.data.packed import PackedImageReader

        self._reader = PackedImageReader(db_path, verify=verify)

    def get(self, key: str) -> bytes:
        return self._reader.get(key)


class FileClient:
    _backends = {"disk": DiskBackend, "lmdb": LmdbBackend,
                 "memcached": MemcachedBackend, "tfrecord": TfrecordBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"backend {backend} not supported; choose from "
                f"{sorted(self._backends)}")
        self.backend = self._backends[backend](**kwargs)

    def get(self, filepath: str) -> bytes:
        return self.backend.get(filepath)
