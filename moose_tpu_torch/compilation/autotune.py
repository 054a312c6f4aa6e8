"""The plan autotuner's serving part: decisions with their provenance,
the measurement store, and the serving bucket ladder.

The port's own copy of the part of ``moose_tpu/compilation/autotune.py``
that serving needs (framework-neutral: ``os``, ``json`` and
``threading``).  The registry picks its warm-up buckets with
:func:`serving_bucket_plan` and records each bucket's steady-state
latency in :func:`measurements` (``bucket_latency`` rows), so a later
registration prunes buckets that measure flat against the next one.

Decision discipline (every decision carries its provenance):

- ``override``: an explicit knob wins verbatim (for the bucket ladder,
  an explicit ``buckets=`` at registration);
- ``measured``: recorded measurements decided.  They are injectable
  (:meth:`Measurements.record` / :meth:`Measurements.load`), so a
  decision is a pure function of (measurements, environment): the same
  measurements give the same plan, in either package;
- ``default``: no signal, the pre-autotuner behaviour.

The rest of the reference's autotuner (the segment limit, the worker
floor, coalescing, the Pallas-against-XLA kernel votes, the transport,
and the per-computation :func:`autotune_plan`) is ROADMAP queue 1,
item 13b: each of those names raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = [
    "Decision",
    "PlanAutotune",
    "Measurements",
    "measurements",
    "autotune_enabled",
    "autotune_plan",
    "segment_limit_for",
    "worker_min_seg_for",
    "dot_shape_class",
    "dot_kernel_wanted",
    "dot_decision_table",
    "reset_dot_decisions",
    "ensure_dot_measurement",
    "measure_dot_micro",
    "transport_choice",
    "serving_bucket_plan",
    "reset_cache",
]


def autotune_enabled() -> bool:
    """MOOSE_TPU_AUTOTUNE=0 restores the fixed-knob defaults entirely
    (every decision reports source="default"/"override")."""
    return os.environ.get("MOOSE_TPU_AUTOTUNE", "1") != "0"


# ---------------------------------------------------------------------------
# Decisions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved plan choice with its provenance."""

    knob: str
    choice: Any
    source: str  # "override" | "measured" | "predicted" | "default"
    why: str

    def as_dict(self) -> Dict[str, Any]:
        return {
            "choice": self.choice, "source": self.source, "why": self.why,
        }


class PlanAutotune:
    """The resolved decision set for one computation (ordered)."""

    def __init__(self, decisions: Sequence[Decision]):
        self.decisions: Tuple[Decision, ...] = tuple(decisions)

    def __getitem__(self, knob: str) -> Decision:
        for d in self.decisions:
            if d.knob == knob:
                return d
        raise KeyError(knob)

    def get(self, knob: str) -> Optional[Decision]:
        try:
            return self[knob]
        except KeyError:
            return None

    def choice(self, knob: str, default: Any = None) -> Any:
        d = self.get(knob)
        return default if d is None else d.choice

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        """JSON-shaped decision table (insertion = decision order)."""
        return {d.knob: d.as_dict() for d in self.decisions}


# ---------------------------------------------------------------------------
# Measurements: the injectable store the decisions read
# ---------------------------------------------------------------------------


class Measurements:
    """Per-process store of micro measurements.

    Keys are ``(kind, width, detail)`` string triples, e.g.
    ``("bucket_latency", 0, "8")`` for a serving warm-up timing.  Values
    are plain dicts of floats.  The store is injectable and serializable
    so decisions are reproducible across processes: feed the same
    measurements, get the same plan."""

    def __init__(self):
        self._data: Dict[Tuple[str, int, str], Dict[str, float]] = {}
        self._lock = threading.Lock()

    def record(self, kind: str, width: int, detail: str,
               **values: float) -> None:
        with self._lock:
            self._data[(str(kind), int(width), str(detail))] = {
                k: float(v) for k, v in values.items()
            }

    def get(self, kind: str, width: int,
            detail: str) -> Optional[Dict[str, float]]:
        with self._lock:
            row = self._data.get((str(kind), int(width), str(detail)))
            return dict(row) if row is not None else None

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """JSON-shaped dump: ``"kind/width/detail" -> row``."""
        with self._lock:
            return {
                f"{k}/{w}/{d}": dict(row)
                for (k, w, d), row in sorted(self._data.items())
            }

    def load(self, snapshot: Dict[str, Dict[str, float]]) -> None:
        """Inverse of :meth:`snapshot` (merge, not replace)."""
        for key, row in snapshot.items():
            kind, width, detail = key.split("/", 2)
            self.record(kind, int(width), detail, **row)

    def load_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self.load(json.load(f))

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


_MEASUREMENTS = Measurements()


def measurements() -> Measurements:
    """The process-global measurement store."""
    return _MEASUREMENTS


# ---------------------------------------------------------------------------
# The serving bucket ladder
# ---------------------------------------------------------------------------


def serving_bucket_plan(max_batch: int) -> Decision:
    """Warm-up bucket ladder.  Default: the full power-of-two ladder.
    With measured flat-latency evidence (``bucket_latency`` rows from an
    earlier registration's warm-up), prune buckets whose measured
    latency is within 10% of the next bucket's: padding into the bigger
    bucket costs nothing there, and each pruned bucket saves a warm-up
    evaluation."""
    from ..serving.registry import power_of_two_buckets

    ladder = power_of_two_buckets(max_batch)
    if not autotune_enabled():
        return Decision(
            "serving_buckets", list(ladder), "default",
            "autotune disabled",
        )
    lat = {
        b: row.get("eval_s")
        for b in ladder
        for row in (_MEASUREMENTS.get("bucket_latency", 0, str(b)),)
        if row and row.get("eval_s")
    }
    if len(lat) < 2:
        return Decision(
            "serving_buckets", list(ladder), "default",
            "no bucket latency measurements; full power-of-two ladder",
        )
    kept = [ladder[-1]]  # the max bucket is always servable
    for b, nxt in zip(ladder[:-1], ladder[1:]):
        lb, ln = lat.get(b), lat.get(nxt)
        if lb is not None and ln is not None and ln <= lb * 1.1:
            continue  # flat: route b-sized batches into nxt
        kept.append(b)
    kept = sorted(set(kept))
    pruned = [b for b in ladder if b not in kept]
    if pruned:
        return Decision(
            "serving_buckets", kept, "measured",
            f"pruned {pruned}: measured latency flat within 10% of the "
            "next bucket (padding is free there)",
        )
    return Decision(
        "serving_buckets", list(ladder), "measured",
        "measured latencies scale with bucket size; full ladder kept",
    )


def reset_cache() -> None:
    """Forget cached per-computation decision sets (tests).  The port
    resolves no per-computation set (:func:`autotune_plan` is item
    13b), so there is nothing cached to forget."""


# ---------------------------------------------------------------------------
# Not ported: ROADMAP queue 1, item 13b
# ---------------------------------------------------------------------------


def _item_13b(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"autotune.{name} is a plan-autotuner decision the port has "
            "not taken yet (ROADMAP queue 1, item 13b)"
        )

    refuse.__name__ = refuse.__qualname__ = name
    refuse.__doc__ = (
        f"The reference's ``autotune.{name}``: ROADMAP queue 1, item 13b."
    )
    return refuse


autotune_plan = _item_13b("autotune_plan")
segment_limit_for = _item_13b("segment_limit_for")
worker_min_seg_for = _item_13b("worker_min_seg_for")
coalesce_decision = _item_13b("coalesce_decision")
pallas_family_decision = _item_13b("pallas_family_decision")
dot_shape_class = _item_13b("dot_shape_class")
dot_kernel_decision = _item_13b("dot_kernel_decision")
dot_kernel_wanted = _item_13b("dot_kernel_wanted")
dot_decision_table = _item_13b("dot_decision_table")
reset_dot_decisions = _item_13b("reset_dot_decisions")
ensure_dot_measurement = _item_13b("ensure_dot_measurement")
measure_dot_micro = _item_13b("measure_dot_micro")
transport_choice = _item_13b("transport_choice")
