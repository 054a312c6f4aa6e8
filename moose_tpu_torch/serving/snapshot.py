"""Durable warm-state snapshots for the serving registry.

The port's own copy of ``moose_tpu/serving/snapshot.py``.  A snapshot
persists what survives a process restart, so a new replica starts warm:

- the **traced computation** of every registered model, serialized by
  the port's ``serde`` (the same bytes the JAX package writes for the
  same model);
- the **lowered computations** the runtime compiled during warm-up
  (models it routes per-host and lowers), keyed as the runtime's
  compiled cache keys them;
- each model's **resolved plan state**, its buckets and warm-up report;
- under ``MOOSE_TPU_FIXED_KEYS``, a per-bucket **probe digest**: the
  blake2b of a canned deterministic evaluation, recomputed at load so a
  restored replica is proven BIT-IDENTICAL to the replica that wrote
  the snapshot before it serves traffic.

What the reference's snapshot holds beyond this has no counterpart in
the port, and is recorded in the reference's own form:

- the validated-jit plan registry and the per-``(kernel, width)``
  Pallas verdicts: a CUDA graph cannot be serialized, so a restored
  server captures and validates its plans anew, and the port's kernels
  have no first-use verdicts (a wrapper launches its kernel or raises):
  ``plan_states`` and ``kernel_verdicts`` are written empty and restore
  nothing;
- ``jax.export`` artifacts of the compiled buckets: every bucket is
  recorded with an ``unsupported:plan-<plan mode>-<layout>`` verdict,
  the form the reference writes for a plan ``jax.export`` cannot
  serialize;
- the jax persistent compilation cache: the port compiles no program at
  serve time (its CUDA kernels are built once per process,
  ``native/build.py``), so there is nothing to cache and no counterpart.

The backend gate compares the port's own backend string,
``cuda:<device name>`` or ``cpu``.

Layout (versioned, atomic)::

    <dir>/snapshot-<n>/MANIFEST.json      # format, versions, checksums
    <dir>/snapshot-<n>/<model>.comp       # serde computation bytes
    <dir>/snapshot-<n>/<model>.lowered.<i>  # auto-lowered graphs
    <dir>/CURRENT                         # points at the live snapshot

Writers stage a complete ``snapshot-<n>`` directory, fsync it, then
atomically repoint ``CURRENT`` — a crash mid-write leaves the previous
snapshot live and the orphan staging directory is pruned on the next
save.  Readers resolve ``CURRENT``, verify the manifest checksum chain,
and fall back to fresh registration on ANY validation failure (typed
:class:`~moose_tpu_torch.errors.SnapshotError` — never serve suspect
state).

Invalidation rules (any mismatch rejects the snapshot): snapshot format
version, package version, per-file blake2b checksums, the model-source
digests the caller passes (blitzen digests the ONNX bytes + feature
count + max batch), and the fixed-keys probe digests.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .. import __version__ as _pkg_version
from ..errors import SnapshotError
from ..logger import get_logger

SNAPSHOT_FORMAT = 1
_CURRENT = "CURRENT"


# -- helpers ----------------------------------------------------------------


def _blake(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _freeze(obj):
    """Recursively convert JSON lists back into the tuples the runtime
    cache keys are made of.  Every sequence inside a plan-cache key is a
    tuple of (bool | int | float | str | tuple), so a blanket
    list->tuple restore reproduces the exact key object."""
    if isinstance(obj, list):
        return tuple(_freeze(x) for x in obj)
    return obj


def _probe_rows(bucket: int, row_shape: Tuple[int, ...]) -> np.ndarray:
    """The canned deterministic probe input for one bucket — the same
    generator discipline registry warmup uses, so probe evaluations
    replay a shape the plan already compiled."""
    rng = np.random.default_rng(bucket)
    return rng.normal(size=(bucket, *row_shape))


def _fixed_keys_active() -> bool:
    return bool(os.environ.get("MOOSE_TPU_FIXED_KEYS"))


def _result_digest(arr: np.ndarray) -> str:
    arr = np.asarray(arr)
    meta = f"{arr.shape}|{arr.dtype}".encode()
    return _blake(meta + np.ascontiguousarray(arr).tobytes())


@contextlib.contextmanager
def _fleet_lock(directory: Path, exclusive: bool):
    """Cross-process advisory lock on the snapshot directory: replicas
    legitimately SHARE a snapshot dir (that is the fleet warm-start
    story), so concurrent writers (two replicas draining at once) must
    serialize publication, and a reader mid-restore must never see its
    snapshot pruned out from under it.  Writers take the lock
    exclusively around publish+prune; readers take it shared while
    slurping blobs into memory (never across the re-warm)."""
    import fcntl

    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a+b") as fd:
        fcntl.flock(
            fd, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
        )
        try:
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)


# -- AOT records and the backend -------------------------------------------


def _aot_records(model) -> Dict[int, dict]:
    """One AOT record per bucket.  No plan of the port is a serializable
    program (an eager plan, or CUDA graphs), so every bucket is
    ``unsupported:plan-<plan mode>-<layout>`` (the reference's verdict
    form for a plan ``jax.export`` cannot serialize), with the plan key
    of the executor that runs it."""
    out = {}
    for bucket in model.buckets:
        warm = model.warmup_report.get(bucket) or {}
        layout = warm.get("layout") or "unknown"
        if warm.get("lowered"):
            plan_key = "physical"
        else:
            plan_key = "stacked" if layout == "stacked" else "logical"
        mode = warm.get("plan_mode") or "eager"
        out[int(bucket)] = {
            "verdict": f"unsupported:plan-{mode}-{layout}",
            "plan_key": plan_key,
        }
    return out


def _backend(runtime) -> str:
    """The port's backend string: ``cuda:<device name>`` or ``cpu``."""
    device = getattr(runtime, "device", None)
    if device is None or device.type != "cuda":
        return "cpu"
    import torch

    return f"cuda:{torch.cuda.get_device_name(device)}"


# -- save -------------------------------------------------------------------


def save_snapshot(
    server_or_registry,
    directory,
    source_digests: Optional[Dict[str, str]] = None,
    only: Optional[set] = None,
) -> Path:
    """Write a complete warm-state snapshot of every registered model to
    ``directory`` and atomically repoint ``CURRENT`` at it.  Returns the
    new snapshot path.  ``source_digests`` (model name -> opaque digest
    of whatever the caller registered from, e.g. the ONNX bytes) become
    load-time invalidation keys.  ``only`` restricts the snapshot to the
    named models — a replica with ephemeral control-plane generations
    loaded snapshots just its durable set, so the restore side's
    source-digest set-equality check still holds."""
    from ..serde import serialize_computation

    registry = getattr(server_or_registry, "registry", server_or_registry)
    runtime = registry.runtime
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    # the stage is private (unique temp name): blob writes and the
    # probe evaluations run UNLOCKED; only the publish below (sequence
    # number, rename, CURRENT repoint, prune) needs the fleet lock
    stage = Path(tempfile.mkdtemp(
        dir=directory, prefix="snapshot-staging."
    ))
    try:
        manifest = {
            "format": SNAPSHOT_FORMAT,
            "package_version": _pkg_version,
            "backend": _backend(runtime),
            "fixed_keys": _fixed_keys_active(),
            # the port's kernels keep no verdicts (see the docstring)
            "kernel_verdicts": {},
            "models": {},
            "files": {},
        }
        for name in registry.names():
            if only is not None and name not in only:
                continue
            model = registry.get(name)
            entry = {
                "input_name": model.input_name,
                "row_shape": list(model.row_shape),
                "buckets": list(model.buckets),
                "warmup_report": {
                    str(b): dict(r)
                    for b, r in model.warmup_report.items()
                },
                # a CUDA graph cannot be serialized: a restored server
                # validates its plans anew
                "plan_states": {},
                "stacked_rejected": model.comp in getattr(
                    runtime, "_stacked_rejected", ()
                ),
                "lowered": [],
                "aot": {},
                "probe_digests": {},
            }
            if source_digests and name in source_digests:
                entry["source_digest"] = source_digests[name]
            _write_blob(
                stage, manifest, f"{name}.comp",
                serialize_computation(model.comp),
            )
            entry["comp_file"] = f"{name}.comp"
            # auto-lowered graphs (per-host routed models), keyed as
            # the runtime keys them
            per_comp = getattr(runtime, "_compiled_cache", {}).get(
                model.comp
            ) or {}
            for i, (key, compiled) in enumerate(per_comp.items()):
                lowered = (
                    compiled[0] if isinstance(compiled, tuple) else compiled
                )
                fname = f"{name}.lowered.{i}"
                _write_blob(
                    stage, manifest, fname,
                    serialize_computation(lowered),
                )
                entry["lowered"].append({
                    "key": key, "file": fname, "plan_states": {},
                })
            entry["aot"] = {
                str(b): r for b, r in _aot_records(model).items()
            }
            if _fixed_keys_active():
                # bit-exactness anchors: one canned evaluation per
                # bucket, digested — the load side must reproduce every
                # digest before the restored replica serves traffic
                for bucket in model.buckets:
                    result, _ = registry.evaluate(
                        model, _probe_rows(bucket, model.row_shape)
                    )
                    entry["probe_digests"][str(bucket)] = (
                        _result_digest(result)
                    )
            manifest["models"][name] = entry
        body = json.dumps(manifest, indent=1, sort_keys=True).encode()
        (stage / "MANIFEST.json").write_bytes(body)
        _fsync_dir_tree(stage)
        with _fleet_lock(directory, exclusive=True):
            final = directory / f"snapshot-{_next_seq(directory)}"
            os.rename(stage, final)
            _repoint_current(directory, final.name)
            _prune(directory, keep=final.name)
    except BaseException:
        _rmtree(stage)
        raise
    get_logger().info(
        "snapshot: wrote %s (%d model(s)) in %.2fs",
        final, len(manifest["models"]), time.perf_counter() - t0,
    )
    return final


def _write_blob(stage: Path, manifest: dict, fname: str,
                data: bytes) -> None:
    (stage / fname).write_bytes(data)
    manifest["files"][fname] = {
        "bytes": len(data), "blake2b": _blake(data),
    }


def _next_seq(directory: Path) -> int:
    seqs = [0]
    for p in directory.glob("snapshot-*"):
        tail = p.name.split("-", 1)[1].split(".", 1)[0]
        if tail.isdigit():
            seqs.append(int(tail))
    return max(seqs) + 1


def _repoint_current(directory: Path, name: str) -> None:
    tmp = directory / (_CURRENT + ".tmp")
    tmp.write_text(name + "\n")
    os.replace(tmp, directory / _CURRENT)


def _prune(directory: Path, keep: str, history: int = 1) -> None:
    """Drop crash-orphaned staging leftovers and all but ``history``
    predecessors.  A staging dir is only an orphan when it is OLD —
    a recent one may belong to another replica mid-save (staging is
    deliberately done outside the fleet lock)."""
    snaps = [
        p for p in directory.glob("snapshot-*")
        if p.is_dir() and p.name != keep
    ]
    now = time.time()
    stale = [
        p for p in snaps
        if "staging" in p.name and now - p.stat().st_mtime > 3600
    ]
    # numeric sort: lexicographic ordering would rank snapshot-10
    # before snapshot-9 and delete the true predecessor
    numbered = sorted(
        (
            p for p in snaps
            if "staging" not in p.name
            and p.name.split("-")[-1].isdigit()
        ),
        key=lambda p: int(p.name.split("-")[-1]),
    )
    stale += numbered[:-history] if history else numbered
    for p in stale:
        _rmtree(p)


def _rmtree(path: Path) -> None:
    import shutil

    with contextlib.suppress(OSError):
        shutil.rmtree(path)


def _fsync_dir_tree(stage: Path) -> None:
    with contextlib.suppress(OSError):
        for p in stage.iterdir():
            with open(p, "rb") as f:
                os.fsync(f.fileno())
        fd = os.open(stage, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


# -- load -------------------------------------------------------------------


def current_snapshot_path(directory) -> Optional[Path]:
    """Resolve ``CURRENT`` to the live snapshot directory (None when no
    snapshot has ever been written)."""
    directory = Path(directory)
    pointer = directory / _CURRENT
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    path = directory / name
    return path if path.is_dir() else None


def read_manifest(snapshot_path: Path) -> dict:
    """Parse + checksum-verify a snapshot's manifest.  Raises
    :class:`SnapshotError` on any validation failure."""
    return _read_verified(snapshot_path)[0]


def _read_verified(snapshot_path: Path):
    """(manifest, {fname: bytes}) with every blob checksum-verified —
    the blobs come back IN MEMORY so the caller can release the fleet
    lock before the (slow) re-warm, immune to concurrent pruning."""
    try:
        manifest = json.loads(
            (snapshot_path / "MANIFEST.json").read_text()
        )
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"unreadable manifest in {snapshot_path}: {e}")
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(
            f"snapshot format {manifest.get('format')!r} != supported "
            f"{SNAPSHOT_FORMAT}"
        )
    if manifest.get("package_version") != _pkg_version:
        raise SnapshotError(
            f"snapshot written by moose_tpu_torch "
            f"{manifest.get('package_version')!r}, this build is "
            f"{_pkg_version!r}"
        )
    blobs: Dict[str, bytes] = {}
    for fname, spec in (manifest.get("files") or {}).items():
        try:
            data = (snapshot_path / fname).read_bytes()
        except OSError as e:
            raise SnapshotError(f"snapshot blob {fname} unreadable: {e}")
        if _blake(data) != spec.get("blake2b"):
            raise SnapshotError(
                f"snapshot blob {fname} failed its checksum"
            )
        blobs[fname] = data
    return manifest, blobs


def restore_registry(
    registry,
    directory,
    source_digests: Optional[Dict[str, str]] = None,
    rewarm: bool = True,
) -> dict:
    """Restore every model in the live snapshot under ``directory`` into
    ``registry`` (which must be empty of those names).  Returns a report
    ``{models, rewarm_s, probe_checked, aot}``.

    Restore order per model: deserialize the traced computation,
    reinstall the lowered graphs in the runtime's compiled cache, then,
    when ``rewarm``, run ONE evaluation per bucket.  The restored
    computation is a Computation, so no evaluation re-enters the
    tracer.  Under MOOSE_TPU_FIXED_KEYS the rewarm doubles as the
    bit-exactness proof against the writer's probe digests; any
    divergence raises :class:`SnapshotError` before the model is
    installed."""
    from ..serde import deserialize_computation
    from .registry import RegisteredModel

    directory = Path(directory)
    if not directory.is_dir():
        raise SnapshotError(f"no snapshot under {directory}")
    with _fleet_lock(directory, exclusive=False):
        snapshot_path = current_snapshot_path(directory)
        if snapshot_path is None:
            raise SnapshotError(f"no snapshot under {directory}")
        manifest, blobs = _read_verified(snapshot_path)
    models = manifest.get("models") or {}
    if not models:
        raise SnapshotError(f"snapshot {snapshot_path} holds no models")
    if source_digests is not None:
        if set(source_digests) != set(models):
            raise SnapshotError(
                f"snapshot models {sorted(models)} != requested "
                f"{sorted(source_digests)}"
            )
        for name, digest in source_digests.items():
            if models[name].get("source_digest") != digest:
                raise SnapshotError(
                    f"model {name!r}: source digest mismatch (the "
                    "model file changed since the snapshot was written)"
                )
    runtime = registry.runtime
    check_probes = _fixed_keys_active() and manifest.get("fixed_keys")
    report = {
        "snapshot": str(snapshot_path),
        "models": [],
        "rewarm_s": 0.0,
        "probe_checked": 0,
        # plan states and kernel verdicts restore into nothing: the port
        # keeps neither, whatever a snapshot holds or its backend was
        "kernel_verdicts_restored": 0,
        "same_backend": manifest.get("backend") == _backend(runtime),
        "aot": {},
    }
    t0 = time.perf_counter()
    # staged install: nothing lands in registry._models until EVERY
    # model restored and proved out — a failure on the Nth model must
    # leave the registry empty so the caller's fresh-registration
    # fallback can re-register all names without collisions
    staged: Dict[str, object] = {}
    for name, entry in models.items():
        comp = deserialize_computation(blobs[entry["comp_file"]])
        if entry.get("stacked_rejected") and hasattr(
            runtime, "_stacked_rejected"
        ):
            runtime._stacked_rejected.add(comp)
        compiled_cache = getattr(runtime, "_compiled_cache", None)
        if compiled_cache is not None and entry.get("lowered"):
            per_comp = compiled_cache.setdefault(comp, {})
            for item in entry["lowered"]:
                per_comp[_freeze(item["key"])] = deserialize_computation(
                    blobs[item["file"]])
        model = RegisteredModel(
            name=name,
            comp=comp,
            input_name=entry["input_name"],
            row_shape=tuple(entry["row_shape"]),
            buckets=tuple(int(b) for b in entry["buckets"]),
            warmup_report={
                int(b): dict(r)
                for b, r in (entry.get("warmup_report") or {}).items()
            },
        )
        # no AOT artifact is written (see the module docstring): each
        # bucket keeps the verdict it was saved with
        aot_verdicts = {
            bucket: record.get("verdict", "")
            for bucket, record in (entry.get("aot") or {}).items()
        }
        report["aot"][name] = aot_verdicts
        if rewarm:
            for bucket in model.buckets:
                result, _ = registry.evaluate(
                    model, _probe_rows(bucket, model.row_shape)
                )
                want = (entry.get("probe_digests") or {}).get(str(bucket))
                if check_probes and want is not None:
                    got = _result_digest(result)
                    if got != want:
                        raise SnapshotError(
                            f"model {name!r} bucket {bucket}: probe "
                            f"digest {got} != snapshot {want} — restored "
                            "state is not bit-identical"
                        )
                    report["probe_checked"] += 1
        staged[name] = model
        report["models"].append(name)
    registry._models.update(staged)
    report["rewarm_s"] = time.perf_counter() - t0
    from ..metrics import counter

    aot_counter = counter(
        "moose_tpu_serving_aot_buckets_total",
        "AOT bucket artifacts by restore verdict",
        labels=("verdict",),
    )
    for verdicts in report["aot"].values():
        for verdict in verdicts.values():
            aot_counter.inc(verdict=verdict.split(":", 1)[0])
    get_logger().info(
        "snapshot: restored %d model(s) from %s in %.2fs "
        "(%d probe digest(s) verified)",
        len(report["models"]), snapshot_path, report["rewarm_s"],
        report["probe_checked"],
    )
    return report
