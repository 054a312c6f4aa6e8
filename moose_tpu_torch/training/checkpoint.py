"""Per-party secret-shared checkpoint store.

The port's own copy of ``moose_tpu/training/checkpoint.py``: the same
``_ckpt/gen-%08d/`` keys, manifest JSON and blake2b digests, so a
generation directory written by either package is read and validated
by the other.  The store holds numpy arrays on the host and has no
device.

One :class:`CheckpointStore` wraps one party's storage backend (a
:class:`~moose_tpu_torch.storage.FilesystemStorage` for durability, any
dict-like for tests) and gives the training protocol its commit
discipline:

- **Staged writes**: ``Save`` ops whose key carries the checkpoint
  prefix (what ``SaveShares`` writes on each party) land in an
  in-memory staging buffer, not on disk, so a session that dies
  mid-epoch leaves the durable state untouched.
- **Atomic generation commit**: :meth:`commit` writes every staged
  array to a fresh ``_ckpt/gen-%08d/`` namespace through the backend's
  atomic save (tempfile + ``os.replace``), writes a checksum manifest
  last, then flips the ``CURRENT`` pointer.  A crash at any point leaves
  either the old or the new generation current, never a torn one.
- **Validated reads**: ``Load`` ops under the prefix resolve against
  the pinned (or current) generation; the manifest is verified on
  first open (format version, per-array blake2b digests, fixed-keys
  discipline tag) and a torn, tampered or stale generation is rejected
  with a typed :class:`~moose_tpu_torch.errors.CheckpointError`; reads
  fall back to the newest previous valid generation where the protocol
  allows it.
- **Durable pin**: the training driver pins the epoch every party must
  read from (parties may have committed different epochs when a
  failure interleaved with the commit fanout); the pin survives a
  restart.
- **Bounded retention**: old generations beyond ``retain`` are deleted
  through the backend's ``list_keys``/``delete``, never by walking the
  filesystem behind the abstraction's back.

Everything else passes through to the backend unchanged, so a runtime
configured with a CheckpointStore still serves ordinary ``Load``/``Save``
traffic.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import flight as flight_mod
from .. import metrics as metrics_mod
from ..errors import CheckpointError, StorageError

CKPT_FORMAT = 1

# backend-side namespace for checkpoint machinery (distinct from the
# graph-level key prefix so a graph key can never collide with it)
_META = "_ckpt"

_METRICS: Optional[Dict[str, Any]] = None


def _metrics() -> Dict[str, Any]:
    global _METRICS
    if _METRICS is None:
        _METRICS = {
            "commits": metrics_mod.counter(
                "moose_tpu_training_checkpoint_commits_total",
                "committed checkpoint generations, by party",
                ("party",),
            ),
            "invalid": metrics_mod.counter(
                "moose_tpu_training_checkpoint_invalid_total",
                "checkpoint generations rejected at validation",
                ("reason",),
            ),
            "commit_s": metrics_mod.histogram(
                "moose_tpu_training_checkpoint_commit_seconds",
                "wall seconds per checkpoint generation commit",
            ),
        }
    return _METRICS


def _fixed_keys_digest() -> Optional[str]:
    """Digest of the PRF-determinism discipline in effect: under
    ``MOOSE_TPU_FIXED_KEYS`` every party's PrfKeyGen is a pure function
    of (tag, identity, op name), so a checkpoint written under one tag
    is only bit-exactly resumable under the SAME tag — the manifest
    records it and validation rejects a mismatch instead of silently
    breaking the resume bit-exactness contract."""
    tag = os.environ.get("MOOSE_TPU_FIXED_KEYS")
    if not tag:
        return None
    return hashlib.blake2b(tag.encode(), digest_size=8).hexdigest()


def _array_digest(arr: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.dtype).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# -- backend shims (FilesystemStorage protocol OR plain dict) -----------


def _b_save(backing: Any, key: str, value: Any) -> None:
    if hasattr(backing, "save"):
        backing.save(key, value)
    else:
        backing[key] = np.asarray(value)


def _b_load(backing: Any, key: str) -> Any:
    if hasattr(backing, "load"):
        return backing.load(key)
    return backing[key]


def _b_contains(backing: Any, key: str) -> bool:
    return key in backing


def _b_list(backing: Any, prefix: str) -> List[str]:
    if hasattr(backing, "list_keys"):
        return backing.list_keys(prefix)
    return sorted(k for k in backing if k.startswith(prefix))


def _b_delete(backing: Any, key: str) -> None:
    if hasattr(backing, "delete"):
        backing.delete(key)
    else:
        backing.pop(key, None)


def _json_save(backing: Any, key: str, obj: Any) -> None:
    _b_save(
        backing, key,
        np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8).copy(),
    )


def _json_load(backing: Any, key: str) -> Any:
    return json.loads(bytes(np.asarray(_b_load(backing, key))).decode())


class CheckpointStore:
    """Storage wrapper implementing the secret-shared checkpoint
    protocol for ONE party.  Drop-in for the worker/runtime storage
    interface (``load``/``__getitem__``/``__setitem__``/
    ``__contains__``/``setdefault``)."""

    def __init__(self, backing: Any, party: str = "",
                 prefix: str = "ckpt/", retain: int = 2) -> None:
        if retain < 2:
            # the two-phase commit protocol NEEDS the previous
            # generation to survive one more epoch: a party that
            # committed epoch N may be asked to re-serve epoch N-1 when
            # a peer's commit failed
            raise CheckpointError(
                f"checkpoint retention must be >= 2, got {retain}"
            )
        self.backing = backing
        self.party = party
        self.prefix = prefix
        self.retain = int(retain)
        self._lock = threading.RLock()
        self._staged: Dict[str, np.ndarray] = {}
        # generation -> manifest (validated) / None (known invalid)
        self._verdicts: Dict[int, Optional[dict]] = {}
        # memoized read-generation: every checkpoint load/contains
        # would otherwise re-walk the backend's key space (a recursive
        # directory scan on FilesystemStorage) — the only mutation
        # points are commit() and pin() on THIS instance, which
        # invalidate it
        self._read_gen: Optional[int] = None

    # -- storage protocol (what workers and local runtimes call) --------

    def load(self, key: str, query: str = "") -> Any:
        if not key.startswith(self.prefix):
            return _b_load(self.backing, key)
        with self._lock:
            gen = self._read_generation()
            return _b_load(self.backing, f"{_META}/gen-{gen:08d}/{key}")

    def __getitem__(self, key: str) -> Any:
        return self.load(key)

    def __setitem__(self, key: str, value: Any) -> None:
        if not key.startswith(self.prefix):
            _b_save(self.backing, key, value)
            return
        with self._lock:
            self._staged[key] = np.asarray(value)

    def __contains__(self, key: str) -> bool:
        if not key.startswith(self.prefix):
            return _b_contains(self.backing, key)
        # a checkpoint key with NO valid generation raises the typed
        # CheckpointError instead of answering False: the callers of
        # this probe (worker/interpreter Load binding) would otherwise
        # mask the torn/tampered/stale diagnosis as a generic missing
        # key
        with self._lock:
            gen = self._read_generation()
        return _b_contains(
            self.backing, f"{_META}/gen-{gen:08d}/{key}"
        )

    def setdefault(self, key: str, default: Any) -> Any:
        return self.load(key) if key in self else default

    # -- generation resolution ------------------------------------------

    def _generations(self) -> List[int]:
        gens: set = set()
        head = f"{_META}/gen-"
        for key in _b_list(self.backing, head):
            rest = key[len(head):]
            num = rest.split("/", 1)[0]
            if num.isdigit():
                gens.add(int(num))
        return sorted(gens)

    def _manifest(self, gen: int) -> Optional[Dict[str, Any]]:
        """Validated manifest of ``gen``, or None when the generation is
        torn/tampered/stale (verdicts memoized per store instance)."""
        if gen in self._verdicts:
            return self._verdicts[gen]
        verdict: Optional[Dict[str, Any]] = None
        reason: Optional[str] = None
        try:
            manifest = _json_load(
                self.backing, f"{_META}/gen-{gen:08d}/MANIFEST"
            )
            if manifest.get("format") != CKPT_FORMAT:
                reason = "format"
            else:
                fixed = _fixed_keys_digest()
                recorded = manifest.get("fixed_keys")
                if fixed is not None and recorded is not None \
                        and fixed != recorded:
                    # resuming under a different PRF determinism tag
                    # silently voids bit-exactness — reject loudly
                    reason = "fixed_keys"
            if reason is None:
                for key, spec in manifest["keys"].items():
                    arr = np.asarray(_b_load(
                        self.backing, f"{_META}/gen-{gen:08d}/{key}"
                    ))
                    if _array_digest(arr) != spec["digest"]:
                        reason = "tampered"
                        break
                else:
                    verdict = manifest
        except (StorageError, KeyError, ValueError, json.JSONDecodeError):
            reason = "torn"
        if verdict is None:
            _metrics()["invalid"].inc(reason=reason or "torn")
            flight_mod.record(
                "checkpoint_invalid", party=self.party, generation=gen,
                reason=reason or "torn",
            )
        self._verdicts[gen] = verdict
        return verdict

    def _read_generation(self) -> int:
        """The generation reads resolve to: the newest VALID generation
        of the pinned epoch when a pin is set, else the CURRENT pointer
        (falling back past torn/stale generations to the newest valid
        one).  Memoized until the next commit/pin on this instance."""
        if self._read_gen is not None:
            return self._read_gen
        self._read_gen = self._resolve_read_generation()
        return self._read_gen

    def _resolve_read_generation(self) -> int:
        pin = self._read_pin()
        gens = self._generations()
        if pin is not None:
            for gen in reversed(gens):
                manifest = self._manifest(gen)
                if manifest is not None and manifest["epoch"] == pin:
                    return gen
            raise CheckpointError(
                f"{self.party}: no valid checkpoint generation for "
                f"pinned epoch {pin}"
            )
        current: Optional[dict] = None
        if _b_contains(self.backing, f"{_META}/CURRENT"):
            try:
                current = _json_load(self.backing, f"{_META}/CURRENT")
            except (ValueError, json.JSONDecodeError):
                current = None
        if current is not None:
            gen = int(current.get("generation", -1))
            if gen in gens and self._manifest(gen) is not None:
                return gen
            # stale/torn CURRENT: reject it, use the newest valid
            # previous generation instead (typed fallback, recorded)
            _metrics()["invalid"].inc(reason="stale_current")
            flight_mod.record(
                "checkpoint_invalid", party=self.party,
                generation=gen, reason="stale_current",
            )
        for gen in reversed(gens):
            if self._manifest(gen) is not None:
                return gen
        raise CheckpointError(
            f"{self.party}: no valid checkpoint generation exists"
        )

    def _read_pin(self) -> Optional[int]:
        if not _b_contains(self.backing, f"{_META}/PIN"):
            return None
        try:
            return int(_json_load(self.backing, f"{_META}/PIN")["epoch"])
        except (ValueError, KeyError, json.JSONDecodeError):
            return None

    # -- the driver-facing control surface ------------------------------

    def query(self) -> dict:
        """Committed state of this party: valid epochs (ascending, one
        entry per epoch — the newest valid generation wins), the
        current epoch, the durable pin, and what is currently staged."""
        with self._lock:
            by_epoch: Dict[int, int] = {}
            for gen in self._generations():
                manifest = self._manifest(gen)
                if manifest is not None:
                    by_epoch[int(manifest["epoch"])] = gen
            latest = max(by_epoch) if by_epoch else None
            return {
                "epochs": sorted(by_epoch),
                "latest": latest,
                "pin": self._read_pin(),
                "staged": sorted(self._staged),
                "format": CKPT_FORMAT,
            }

    def pin(self, epoch: Optional[int]) -> dict:
        """Durably pin reads to ``epoch`` (None unpins).  Survives a
        worker restart — a party restarted mid-epoch in a mixed-commit
        state must keep reading the generation the driver chose, not
        whatever its own CURRENT happens to be."""
        with self._lock:
            if epoch is None:
                if _b_contains(self.backing, f"{_META}/PIN"):
                    _b_delete(self.backing, f"{_META}/PIN")
            else:
                _json_save(
                    self.backing, f"{_META}/PIN", {"epoch": int(epoch)}
                )
            self._read_gen = None
            return {"pin": epoch}

    def discard_staged(self) -> dict:
        with self._lock:
            n = len(self._staged)
            self._staged.clear()
            return {"discarded": n}

    def commit(self, epoch: int, expected: Optional[list] = None,
               meta: Optional[dict] = None) -> dict:
        """Promote the staged share arrays to a durable generation.

        Write order is the crash-safety argument: arrays first (each an
        atomic tempfile+replace), the checksum MANIFEST second, the
        CURRENT pointer flip last — a crash anywhere leaves the
        previous generation current and the half-written one invisible
        (and detectably invalid).  Retrying a commit whose ack was lost
        is safe: an empty stage against an already-current epoch is
        answered idempotently."""
        t0 = time.monotonic()
        with self._lock:
            epoch = int(epoch)
            if not self._staged:
                cur = self.query()
                if cur["latest"] is not None and epoch in (
                    set(cur["epochs"])
                ):
                    return {"generation": None, "epoch": epoch,
                            "idempotent": True}
                raise CheckpointError(
                    f"{self.party}: commit({epoch}) with nothing staged"
                )
            if expected is not None:
                want = set(expected)
                have = set(self._staged)
                if want != have:
                    raise CheckpointError(
                        f"{self.party}: torn commit({epoch}): staged "
                        f"{sorted(have)} != expected {sorted(want)}"
                    )
            gens = self._generations()
            gen = (gens[-1] + 1) if gens else 0
            head = f"{_META}/gen-{gen:08d}"
            keys: Dict[str, Dict[str, Any]] = {}
            for key, arr in sorted(self._staged.items()):
                _b_save(self.backing, f"{head}/{key}", arr)
                keys[key] = {
                    "digest": _array_digest(arr),
                    "shape": [int(s) for s in arr.shape],
                    "dtype": str(arr.dtype),
                }
            manifest = {
                "format": CKPT_FORMAT,
                "generation": gen,
                "epoch": epoch,
                "keys": keys,
                "fixed_keys": _fixed_keys_digest(),
                "meta": dict(meta or {}),
            }
            _json_save(self.backing, f"{head}/MANIFEST", manifest)
            _json_save(
                self.backing, f"{_META}/CURRENT",
                {"format": CKPT_FORMAT, "generation": gen, "epoch": epoch},
            )
            self._verdicts[gen] = manifest
            self._staged.clear()
            self._read_gen = None
            self._prune(gen)
        _metrics()["commits"].inc(party=self.party or "local")
        _metrics()["commit_s"].observe(time.monotonic() - t0)
        flight_mod.record(
            "checkpoint_committed", party=self.party, epoch=epoch,
            generation=gen, keys=len(keys),
        )
        return {"generation": gen, "epoch": epoch, "idempotent": False}

    def _prune(self, newest: int) -> None:
        """Bounded retention: keep every generation of the newest
        ``retain`` DISTINCT epochs (an epoch re-committed after a
        partial fanout may own two generations — the pinned previous
        epoch must still survive), delete everything else through the
        backend abstraction."""
        gens = self._generations()
        epoch_of = {
            gen: (
                None if (m := self._manifest(gen)) is None
                else int(m["epoch"])
            )
            for gen in gens
        }
        distinct = sorted({e for e in epoch_of.values() if e is not None})
        keep = set(distinct[-self.retain:])
        for gen in gens:
            if gen == newest or epoch_of[gen] in keep:
                continue
            head = f"{_META}/gen-{gen:08d}"
            for key in _b_list(self.backing, head + "/"):
                try:
                    _b_delete(self.backing, key)
                except StorageError:  # pragma: no cover - racing delete
                    pass
            self._verdicts.pop(gen, None)

    # -- rpc dispatch ----------------------------------------------------

    def checkpoint_control(self, cmd: str, args: dict) -> dict:
        """Single dispatch point for the choreography StorageControl
        rpc (and the in-process driver): every command returns a
        msgpack-able dict."""
        args = dict(args or {})
        if cmd == "query":
            return self.query()
        if cmd == "pin":
            return self.pin(args.get("epoch"))
        if cmd == "commit":
            return self.commit(
                args["epoch"], expected=args.get("expected"),
                meta=args.get("meta"),
            )
        if cmd == "discard":
            return self.discard_staged()
        raise CheckpointError(f"unknown checkpoint command {cmd!r}")
