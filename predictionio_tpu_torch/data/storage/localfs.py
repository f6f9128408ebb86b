"""Filesystem model blob store.

Parity target: ``data/.../storage/localfs/LocalFSModels.scala`` — model
blobs as flat files under a configured directory, keyed by engine-instance
id. This is the MODELDATA-only backend (``PIO_STORAGE_SOURCES_<N>_TYPE=
localfs``, ``..._PATH=<dir>``); binding METADATA/EVENTDATA to it fails at
registry level, as with the reference's backend capability matrix.

Blobs land in ``<dir>/pio_model_<id>`` with an atomic rename so a crashed
writer never leaves a torn model for a concurrent deploy to load.

The port's copy of ``predictionio_tpu/data/storage/localfs.py``,
unchanged but for its imports.
"""

from __future__ import annotations

import hashlib
import os
import re
import tempfile
from typing import Optional

from predictionio_tpu_torch.data.storage import base

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe file write: temp file in the target directory,
    fsync, then atomic rename — readers only ever see complete
    content, and the content survives a crash that outlives the page
    cache (a kill-9 never loses a rename; power loss needs the fsync).
    Shared by the model blob store below, the jsonlfs entity-props
    snapshot, the batchpredict manifest and the training checkpoints —
    every filesystem store that persists derived state a crashed
    writer must never leave torn."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_" + os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        try:
            # directory-entry durability (the rename itself), best
            # effort — not every fs/platform lets you fsync a dir fd
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _fname(mid: str) -> str:
    """Sanitized, INJECTIVE id -> filename mapping: the readable prefix
    cannot escape the directory, and the id-hash suffix keeps distinct
    ids ('a/b' vs 'a_b') from colliding onto one file."""
    digest = hashlib.sha256(mid.encode("utf-8")).hexdigest()[:16]
    return f"pio_model_{_SAFE.sub('_', mid)[:80]}_{digest}"


class LocalFSModels(base.Models):
    def __init__(self, config: Optional[dict] = None):
        cfg = config or {}
        self._dir = cfg.get("path") or os.path.join(
            os.getcwd(), ".pio_store", "models")
        os.makedirs(self._dir, exist_ok=True)

    def insert(self, m: base.Model) -> None:
        atomic_write_bytes(os.path.join(self._dir, _fname(m.id)), m.models)

    def get(self, mid: str) -> Optional[base.Model]:
        path = os.path.join(self._dir, _fname(mid))
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return base.Model(id=mid, models=f.read())

    def delete(self, mid: str) -> bool:
        path = os.path.join(self._dir, _fname(mid))
        if not os.path.exists(path):
            return False
        os.unlink(path)
        return True
