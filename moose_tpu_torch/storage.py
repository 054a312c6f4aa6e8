"""Storage backends for Load/Save ops.

Reference ``moose/src/storage/``: a dict-like interface with two
implementations — the in-memory dict used by LocalMooseRuntime, and
:class:`FilesystemStorage` persisting ``.npy`` arrays and reading ``.csv``
tables with a JSON column query (storage/filesystem/mod.rs:18-80,
numpy.rs, csv.rs).

The port's own copy of ``moose_tpu/storage.py``: it is numpy only and
imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import tempfile
from pathlib import Path

import numpy as np

from .errors import StorageError


class FilesystemStorage:
    """Maps keys to files under ``root``: ``<key>.npy`` (typed arrays,
    save+load) or ``<key>.csv`` (load-only tables with optional JSON
    column query, matching the reference's csv reader)."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str, suffix: str) -> Path:
        # append (never substitute) the suffix: with_suffix would truncate
        # dotted keys like "model.v1" and collide distinct keys
        p = self.root / (key + suffix)
        if self.root.resolve() not in p.resolve().parents:
            raise StorageError(f"storage key escapes root: {key!r}")
        return p

    def __contains__(self, key: str) -> bool:
        return (
            self._path(key, ".npy").exists()
            or self._path(key, ".csv").exists()
        )

    def __getitem__(self, key: str):
        return self.load(key)

    def __setitem__(self, key: str, value):
        self.save(key, value)

    def setdefault(self, key: str, default):
        return self.load(key) if key in self else default

    def load(self, key: str, query: str = ""):
        npy = self._path(key, ".npy")
        if npy.exists():
            return np.load(npy, allow_pickle=False)
        csv_path = self._path(key, ".csv")
        if csv_path.exists():
            return self._load_csv(csv_path, query)
        raise StorageError(f"no value for key {key!r} in {self.root}")

    def save(self, key: str, value):
        arr = np.asarray(value)
        if arr.dtype == object:
            raise StorageError(
                f"cannot persist object-dtype array under key {key!r}"
            )
        # write-then-rename: a crash mid-write must never leave a
        # truncated .npy at the key's path (it would poison every later
        # load).  The temp file lives in the SAME directory so
        # os.replace stays an atomic same-filesystem rename.
        target = self._path(key, ".npy")
        # hierarchical keys ("ckpt/gen-0/model#s0") map to subdirectories
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.NamedTemporaryFile(
            dir=target.parent, prefix=target.name + ".", suffix=".tmp",
            delete=False,
        )
        try:
            np.save(tmp, arr, allow_pickle=False)
            tmp.flush()
            os.fsync(tmp.fileno())
            tmp.close()
            os.replace(tmp.name, target)
        except BaseException:
            tmp.close()
            with contextlib.suppress(OSError):
                os.unlink(tmp.name)
            raise

    def list_keys(self, prefix: str = "") -> list:
        """Keys under ``prefix``, sorted.  The storage-level enumeration
        checkpoint retention/GC and resume discovery build on — callers
        never walk the filesystem behind the abstraction's back."""
        # walk only the subtree the prefix pins down: checkpoint
        # control calls enumerate '_ckpt/...' many times per epoch and
        # must not pay a recursive scan of every unrelated dataset
        # file in the store
        base = self.root
        head, _, _ = prefix.rpartition("/")
        if head:
            candidate = base / head
            if not candidate.exists():
                return []
            base = candidate
        keys = []
        for path in base.rglob("*"):
            if not path.is_file() or path.suffix not in (".npy", ".csv"):
                continue
            key = str(path.relative_to(self.root))[: -len(path.suffix)]
            if key.startswith(prefix):
                keys.append(key)
        return sorted(keys)

    def delete(self, key: str) -> None:
        """Remove a key (both representations); missing keys are a
        typed :class:`StorageError`, matching :meth:`load`.  Emptied
        parent directories (auto-created by hierarchical-key saves) are
        pruned back up to the root, so checkpoint generation GC does
        not leak one directory tree per pruned generation."""
        found = False
        for suffix in (".npy", ".csv"):
            path = self._path(key, suffix)
            if path.exists():
                path.unlink()
                found = True
                parent = path.parent
                root = self.root.resolve()
                while parent.resolve() != root:
                    try:
                        parent.rmdir()  # only succeeds when empty
                    except OSError:
                        break
                    parent = parent.parent
        if not found:
            raise StorageError(
                f"no value for key {key!r} in {self.root}"
            )

    def _load_csv(self, path: Path, query: str):
        """Load a csv as float64 columns; ``query`` is the reference's
        JSON column selector, e.g. '{"select_columns": ["x", "y"]}'."""
        columns = None
        if query:
            try:
                spec = json.loads(query)
            except json.JSONDecodeError as e:
                raise StorageError(f"bad csv query {query!r}: {e}") from e
            columns = spec.get("select_columns")
        with path.open(newline="") as f:
            reader = csv.DictReader(f)
            names = reader.fieldnames or []
            use = columns if columns is not None else names
            missing = [c for c in use if c not in names]
            if missing:
                raise StorageError(
                    f"csv {path.name} has no columns {missing}"
                )
            rows = [[float(row[c]) for c in use] for row in reader]
        return np.asarray(rows, dtype=np.float64)
