"""Filesystem-URL model repository: HDFS (and any fsspec scheme).

The reference ships a dedicated HDFS model store
(storage/hdfs/src/main/scala/org/apache/predictionio/data/storage/hdfs/HDFSModels.scala:31)
whose whole job is get/put/delete of one blob per engine instance on a
Hadoop filesystem.  The JAX package's store, ported whole (the same object
names, so either package loads a blob the other wrote), reaches every such
filesystem through ``fsspec``: the same 40 lines serve ``hdfs://``,
``gs://``, ``s3a://``-style object stores, ``file://`` and ``memory://``,
whichever drivers the deployment installs.

Config::

    PIO_STORAGE_SOURCES_<NAME>_TYPE=hdfs
    PIO_STORAGE_SOURCES_<NAME>_PATH=hdfs://namenode:8020/pio/models

(TYPE=hdfs is the reference-parity spelling; the PATH url picks the actual
protocol, so pointing it at gs://bucket/models works unchanged.)

Writes go through a temp name + rename, the HDFS-native way to make a
blob visible atomically (readers never see a half-written model).
"""

from __future__ import annotations

from predictionio_tpu_torch.data.storage import base


class FsspecModels(base.Models):
    """Model blobs under one filesystem URL, one object per instance."""

    def __init__(self, url: str, fs=None):
        if fs is None:
            try:
                import fsspec
            except ImportError as e:
                raise ImportError(
                    "the hdfs/fsspec model store requires fsspec"
                ) from e
            fs, url = fsspec.core.url_to_fs(url)
        self.fs = fs
        self.root = url.rstrip("/")
        self.fs.makedirs(self.root, exist_ok=True)

    def _path(self, instance_id: str) -> str:
        safe = instance_id.replace("/", "_").replace("..", "_")
        return f"{self.root}/pio_model_{safe}.bin"

    def insert(self, instance_id: str, blob: bytes) -> None:
        path = self._path(instance_id)
        tmp = path + ".tmp"
        with self.fs.open(tmp, "wb") as f:
            f.write(blob)
        # rename is the atomic-visibility primitive on HDFS; object stores
        # without rename fall back to copy+delete inside fsspec
        self.fs.mv(tmp, path)

    def get(self, instance_id: str) -> bytes | None:
        path = self._path(instance_id)
        if not self.fs.exists(path):
            return None
        with self.fs.open(path, "rb") as f:
            return f.read()

    def delete(self, instance_id: str) -> bool:
        path = self._path(instance_id)
        if not self.fs.exists(path):
            return False
        self.fs.rm(path)
        return True
