"""The plan autotuner (MSA9xx): decisions with their provenance, the
measurement store, and the per-computation decision set.

The port's own copy of ``moose_tpu/compilation/autotune.py``: every
decision is the same pure function of (computation, measurements,
environment) as the reference's, reading the same ``MOOSE_TPU_*``
overrides and giving the same :class:`Decision` (choice, source, why).
What each decision governs in the port:

=================  =====================================  ==================
decision            input (override knob)                  in the port
=================  =====================================  ==================
``segment_limit``  estimated lowered size                 a record: the port
                   (MOOSE_TPU_JIT_SEGMENT)                compiles nothing
``worker_min_seg`` role-schedule segment histogram        the distributed
                   (MOOSE_TPU_WORKER_MIN_SEG)             worker's segments
``coalesce``       MSA6xx envelope prediction             the worker's
                                                          ``send_many``
``pallas``         measured kernel A/B rows               a record: on the
                   (MOOSE_TPU_PALLAS)                     card every kernel
                                                          runs (kernel or
                                                          raise)
``pallas_dot``     measured dot rows per shape class      a record, as
                   (MOOSE_TPU_PALLAS_DOT)                 ``pallas``
``transport``      MSA6xx fabric-vs-grpc pricing          gRPC: no fabric
                   (MOOSE_TPU_FABRIC)                     domain exists yet
``serving_buckets``measured flat-latency evidence         the registry's
                   (explicit ``buckets=``)                warm-up ladder
=================  =====================================  ==================

Decision discipline (every decision carries its provenance):

- ``override``: an explicit knob wins verbatim;
- ``measured``: recorded measurements decided.  They are injectable
  (:meth:`Measurements.record` / :meth:`Measurements.load`), so a
  decision is a pure function of (computation, measurements,
  environment): the same measurements give the same plan, in either
  package;
- ``predicted``: the cost model or the balanced-segmentation rule
  decided without a timer;
- ``default``: no signal, the pre-autotuner behaviour.

No fallback: a ``False`` kernel decision never routes a CUDA tensor to a
plain version.  On a card run the interpreter reports such a decision in
``last_plan["autotune"]`` with ``"applied": false`` and warns once for an
override knob.  On the CPU the kernels' plain versions run, and the
decisions are the reference's there (its kernels are off on the CPU):
``pallas`` False and an empty :func:`dot_decision_table`.

:func:`measure_dot_micro` times K1 (``native.ring_kernels.
dot_cross_terms``) at a shape class's canonical shape with CUDA events
and records the median in the reference's file format under its own key
(``cuda_s``); a ``dot_cross_terms`` row decides ``pallas_dot`` only with
the reference's ``pallas_s``/``xla_s`` pair.  The stacked layout's
secure dot records each (width, class) decision it meets on the card, as
the reference's dispatch does, and nothing measures on demand (the
reference's ``ensure_dot_measurement`` has no counterpart): the decision
routes nothing there, so a micro in the middle of a request would only
cost that request.

Surfaces: ``runtime.last_plan["autotune"]``, a ``plan_autotuned``
flight event per fresh decision set, and ``moose_tpu_autotune_*``
metrics.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import weakref
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
    "measure_dot_micro",
    "transport_choice",
    "serving_bucket_plan",
    "reset_cache",
]

# the pre-autotuner fixed defaults the decisions start from
_DEFAULT_SEGMENT_LIMIT = 2000
_DEFAULT_WORKER_MIN_SEG = 4

# canonical microbench shapes per dot shape class: representative of
# the headline 1000x1000 dot, the training-step dot and predictor
# inference
_DOT_CLASS_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "mxu": (512, 512, 128),
    "tall": (1024, 128, 8),
    "small": (128, 100, 2),
}


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

    Keys are ``(kind, width, detail)`` string triples — e.g.
    ``("dot_cross_terms", 128, "mxu")`` for a dot A/B at the mxu shape
    class, ``("bucket_latency", 0, "8")`` for a serving warmup timing.
    Values are plain dicts (``{"pallas_s": .., "xla_s": ..}`` for A/B
    rows).  The store is injectable and serializable so autotune
    decisions are reproducible across processes: feed the same
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
# Individual decision functions (each: env override > measured/predicted
# > default) — pure given (inputs, measurements, env)
# ---------------------------------------------------------------------------


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError as e:
        from ..errors import ConfigurationError

        raise ConfigurationError(
            f"{name} must be an integer, got {raw!r}"
        ) from e


def segment_limit_for(est_ops: int) -> Decision:
    """Balanced segmentation: XLA compile time is superlinear in program
    size (measured ~quadratic, see ``interpreter._segment_limit``), so
    for a graph of ``est_ops`` host-op equivalents the cheapest split
    into segments of at most the default limit is the *balanced* one —
    ceil(est/ceil(est/limit)) — not default-sized segments plus a tail
    (2100 ops as 2000+100 costs ~4.01M compile units; as 1050+1050 it
    costs ~2.2M)."""
    env = _env_int("MOOSE_TPU_JIT_SEGMENT")
    if env is not None:
        return Decision(
            "segment_limit", env if env > 0 else (1 << 62), "override",
            f"MOOSE_TPU_JIT_SEGMENT={env}",
        )
    limit = _DEFAULT_SEGMENT_LIMIT
    if not autotune_enabled() or est_ops <= limit:
        return Decision(
            "segment_limit", limit, "default",
            f"~{est_ops} ops fit the default segment budget"
            if est_ops <= limit else "autotune disabled",
        )
    n_seg = -(-est_ops // limit)
    balanced = -(-est_ops // n_seg)
    return Decision(
        "segment_limit", balanced, "predicted",
        f"~{est_ops} ops -> {n_seg} balanced segments of <={balanced} "
        "(superlinear compile: balanced beats default+tail)",
    )


def worker_min_seg_for(segment_sizes: Sequence[int] = ()) -> Decision:
    """Worker eager floor: segments below it skip jit validation (a
    2-op XLA program saves ~one dispatch but costs a validation
    compile).  When the role schedule is dominated by tiny segments,
    raising the floor to cover them saves their validation compiles —
    the op count is unchanged, only the jit/eager boundary moves (the
    worker's outputs are bit-identical either way: eager and jitted
    segments run the same kernels)."""
    env = _env_int("MOOSE_TPU_WORKER_MIN_SEG")
    if env is not None:
        return Decision(
            "worker_min_seg", max(1, env), "override",
            f"MOOSE_TPU_WORKER_MIN_SEG={env}",
        )
    floor = _DEFAULT_WORKER_MIN_SEG
    if not autotune_enabled() or not segment_sizes:
        return Decision(
            "worker_min_seg", floor, "default",
            "no schedule signal" if autotune_enabled()
            else "autotune disabled",
        )
    small = sorted(s for s in segment_sizes if s < 16)
    if small and len(small) * 2 >= len(segment_sizes):
        # majority-tiny schedule: lift the floor to the median tiny
        # size so the long tail of sub-16-op segments runs eagerly
        # instead of paying a validation compile each
        floor = max(floor, small[len(small) // 2] + 1)
        return Decision(
            "worker_min_seg", floor, "predicted",
            f"{len(small)}/{len(segment_sizes)} segments under 16 ops; "
            f"eager floor {floor} skips their validation compiles",
        )
    return Decision(
        "worker_min_seg", floor, "predicted",
        f"schedule is compile-bound ({len(segment_sizes)} segments, "
        f"{len(small)} tiny); default floor stands",
    )


def coalesce_decision(
    predicted: Optional[Dict[str, Any]] = None,
) -> Decision:
    """Deterministic coalescing is strictly dominant under the MSA6xx
    envelope model (send_many merges per-(flush-group, receiver)
    buckets; a singleton bucket degenerates to a plain send), so the
    decision is predicted, not measured.  ``predicted`` may carry a
    cost_report excerpt to quote the actual envelope savings."""
    why = "send_many envelopes <= singleton sends for every schedule"
    if predicted:
        saved = predicted.get("envelopes_saved")
        if saved is not None:
            why = f"MSA6xx predicts {saved} envelopes saved"
    return Decision("coalesce", True, "predicted", why)


def _on_card(device) -> bool:
    """Whether ``device`` (a torch device, its name, or None for the
    CPU) is a CUDA device: where the reference's kernels would be on."""
    return device is not None and str(device).startswith("cuda")


def pallas_family_decision(width: int = 128, device=None) -> Decision:
    """The elementwise kernel family (fx_mul / msb / sigmoid ladder):
    measured A/B rows win; otherwise the backend default, the
    reference's "TPU on, CPU off" read as the card on, the CPU off."""
    env = os.environ.get("MOOSE_TPU_PALLAS")
    if env not in (None, ""):
        return Decision(
            "pallas", env == "1", "override", f"MOOSE_TPU_PALLAS={env}",
        )
    if autotune_enabled():
        votes = []
        for kern in ("fx_mul", "msb", "fx_sigmoid"):
            row = _MEASUREMENTS.get(kern, width, "default")
            if row and "pallas_s" in row and "xla_s" in row:
                votes.append(row["pallas_s"] < row["xla_s"])
        if votes:
            on = sum(votes) * 2 >= len(votes)
            return Decision(
                "pallas", on, "measured",
                f"{sum(votes)}/{len(votes)} measured kernels faster "
                "than their XLA twins",
            )
    on = _on_card(device)
    return Decision(
        "pallas", on, "default",
        "backend auto (TPU on, CPU off)" if autotune_enabled()
        else "autotune disabled",
    )


def dot_shape_class(m: int, k: int, n: int) -> str:
    """Coarse dot shape taxonomy for the per-class kernel policy:

    - ``mxu``: every dim >= 64 — square-ish MXU-resident work (the
      1000x1000 headline dot).
    - ``tall``: m >= 256 and k >= 32 — large-batch/training-step dots
      ((1024, 100) @ (100, 1) forward, its transpose gradient): big
      operand traffic, narrow output.
    - ``small``: predictor-inference shapes, where the reference's
      limb_int8 XLA path wins — no global default flip.
    """
    if min(m, k, n) >= 64:
        return "mxu"
    if m >= 256 and k >= 32:
        return "tall"
    return "small"


def dot_kernel_decision(
    width: int, shape: Optional[Tuple[int, int, int]] = None,
) -> Decision:
    """Per-shape-class Pallas dot on/off.  The env knob stays absolute
    (1 = always when the family is on, 0 = never); without it, the
    *measured* A/B row of the shape's class decides — no measurement
    means the honest default off."""
    env = os.environ.get("MOOSE_TPU_PALLAS_DOT")
    if env in ("0", "1"):
        return Decision(
            "pallas_dot", env == "1", "override",
            f"MOOSE_TPU_PALLAS_DOT={env}",
        )
    if shape is None or not autotune_enabled():
        return Decision(
            "pallas_dot", False, "default",
            "no shape context" if autotune_enabled()
            else "autotune disabled",
        )
    cls = dot_shape_class(*shape)
    row = _MEASUREMENTS.get("dot_cross_terms", width, cls)
    if row and "pallas_s" in row and "xla_s" in row:
        on = row["pallas_s"] < row["xla_s"]
        return Decision(
            "pallas_dot", on, "measured",
            f"class={cls}: pallas {row['pallas_s']:.2e}s vs "
            f"limb_int8 {row['xla_s']:.2e}s",
        )
    return Decision(
        "pallas_dot", False, "default",
        f"class={cls}: no A/B measurement; limb_int8 stands",
    )


# per-(width, class) decisions the trace-time dispatch actually made —
# the resolved-plan surface (`last_plan["autotune"]["pallas_dot_classes"]`)
# reports these, since logical graph signatures carry no static shapes
_DOT_DECISIONS: Dict[Tuple[int, str], Decision] = {}
_DOT_DECISIONS_LOCK = threading.Lock()


def dot_decision_table() -> Dict[str, Dict[str, Any]]:
    """Decision per (ring width, dot shape class) observed at dispatch
    so far this process, e.g. ``{"ring128/tall": {"choice": true,
    "source": "measured", ...}}``."""
    with _DOT_DECISIONS_LOCK:
        return {
            f"ring{w}/{cls}": d.as_dict()
            for (w, cls), d in sorted(_DOT_DECISIONS.items())
        }


def reset_dot_decisions() -> None:
    """Forget the observed dispatch decisions (tests, bench A/B)."""
    with _DOT_DECISIONS_LOCK:
        _DOT_DECISIONS.clear()


def dot_kernel_wanted(
    width: int, shape: Optional[Tuple[int, int, int]] = None,
) -> bool:
    """The decision the stacked layout's secure dot
    (``parallel.spmd``) records for each product of matrices on the
    card, where the reference's dispatch asks it: decided from the
    recorded rows, never measured on demand (see the module docstring),
    and recorded in :func:`dot_decision_table`.  K1 runs whatever it
    says."""
    if shape is None:
        return False
    decision = dot_kernel_decision(width, shape)
    with _DOT_DECISIONS_LOCK:
        _DOT_DECISIONS[(width, dot_shape_class(*shape))] = decision
    return bool(decision.choice)


# -- dot microbenchmark ------------------------------------------------------


def measure_dot_micro(width: int, cls: str, iters: int = 3,
                      device="cuda") -> Optional[Dict[str, float]]:
    """Time K1 (``dot_cross_terms``, both cross terms) at the class's
    canonical shape on the card with CUDA events: the median of
    ``iters`` timed launches after one warm-up.  Records the row
    ``{"cuda_s": ...}`` into the global measurement store and returns
    it; returns None without a card (a failed timing is "no
    measurement", never an execution failure)."""
    import numpy as np
    import torch

    from ..native import ring_kernels as rk

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    m, k, n = _DOT_CLASS_SHAPES[cls]
    rng = np.random.default_rng(0xA0_70_7E)

    def rand_ring(shape):
        def words():
            raw = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
            return torch.from_numpy(raw.view(np.int64)).to(dev)

        return words(), (words() if width == 128 else None)

    x0, x1 = rand_ring((3, m, k)), rand_ring((3, m, k))
    y0, ys = rand_ring((3, k, n)), rand_ring((3, k, n))
    try:
        rk.dot_cross_terms(x0, x1, y0, ys, width)  # warm (build, load)
        times = []
        for _ in range(max(1, iters)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rk.dot_cross_terms(x0, x1, y0, ys, width)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    except (RuntimeError, ValueError):
        return None
    cuda_s = float(sorted(times)[len(times) // 2])
    _MEASUREMENTS.record("dot_cross_terms", width, cls, cuda_s=cuda_s)
    from .. import metrics

    metrics.counter(
        "moose_tpu_autotune_measure_total",
        "on-demand autotune microbenchmarks run",
        labels=("kind", "detail"),
    ).inc(kind="dot_cross_terms", detail=cls)
    return {"cuda_s": cuda_s}


def transport_choice(
    fabric_parties: Sequence[str] = (),
    session_parties: Sequence[str] = (),
    predicted: Optional[Dict[str, float]] = None,
) -> Decision:
    """Fabric vs gRPC, only where a FabricDomain attestation covers the
    session's parties (transport is a *trust* decision first: no
    attestation, no fabric — MSA505).  With attestation, MSA6xx prices
    both transports; fabric wins unless the prediction says otherwise
    (it strips serde framing, so it wins whenever hops are cheap)."""
    env = os.environ.get("MOOSE_TPU_FABRIC")
    if env in ("0", "1"):
        choice = "fabric" if env == "1" else "grpc"
        return Decision(
            "transport", choice, "override", f"MOOSE_TPU_FABRIC={env}",
        )
    members = frozenset(fabric_parties)
    if not members or not frozenset(session_parties) <= members:
        return Decision(
            "transport", "grpc", "default",
            "no attested fabric domain covers the session parties",
        )
    if not autotune_enabled():
        return Decision("transport", "grpc", "default",
                        "autotune disabled")
    if predicted:
        fb = predicted.get("fabric_bytes")
        gb = predicted.get("grpc_bytes")
        if fb is not None and gb is not None:
            choice = "fabric" if fb <= gb else "grpc"
            return Decision(
                "transport", choice, "predicted",
                f"MSA6xx: fabric {fb:.0f}B vs grpc {gb:.0f}B on the wire",
            )
    return Decision(
        "transport", "fabric", "predicted",
        "attested domain; fabric strips per-transfer serde framing",
    )


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


# ---------------------------------------------------------------------------
# The per-computation entry point (weak-keyed cache, flight, metrics)
# ---------------------------------------------------------------------------

_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_CACHE_LOCK = threading.Lock()


def reset_cache() -> None:
    """Forget cached per-computation decision sets (tests)."""
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()


def _count_decisions(plan: PlanAutotune) -> None:
    from .. import metrics

    metrics.counter(
        "moose_tpu_autotune_plans_total",
        "computations a fresh autotune decision set was resolved for",
    ).inc()
    dec = metrics.counter(
        "moose_tpu_autotune_decisions_total",
        "autotune decisions by knob and provenance",
        labels=("knob", "source"),
    )
    for d in plan.decisions:
        dec.inc(knob=d.knob, source=d.source)


def autotune_plan(comp, *, est_ops: Optional[int] = None,
                  segment_sizes: Sequence[int] = (),
                  fabric_parties: Sequence[str] = (),
                  session_parties: Sequence[str] = (),
                  width: int = 128, device=None) -> PlanAutotune:
    """Resolve (and weak-key cache) the decision set for ``comp``.

    Callers pass whatever plan context they have: the interpreter its
    effective-op estimate, the worker its segment histogram and fabric
    attestation; ``device`` is the run's device (None: the CPU), which
    decides ``pallas``'s default.  The result is deterministic given
    (computation, measurements, env) — the cache is an optimization,
    not a dependency.  It is keyed on the computation and the device
    kind, which decides ``pallas``'s default."""
    kind = "cuda" if _on_card(device) else "cpu"
    with _CACHE_LOCK:
        try:
            cached = (_PLAN_CACHE.get(comp) or {}).get(kind)
        except TypeError:  # unhashable / non-weakrefable computations
            cached = None
        if cached is not None:
            from .. import metrics

            metrics.counter(
                "moose_tpu_autotune_cache_hits_total",
                "autotune decision sets served from the weak cache",
            ).inc()
            return cached

    n = est_ops if est_ops is not None else _estimate_ops(comp)
    plan = PlanAutotune([
        segment_limit_for(n),
        worker_min_seg_for(segment_sizes),
        coalesce_decision(),
        pallas_family_decision(width, device),
        dot_kernel_decision(width, _dominant_dot_shape(comp)),
        transport_choice(fabric_parties, session_parties),
    ])
    with _CACHE_LOCK:
        try:
            _PLAN_CACHE.setdefault(comp, {})[kind] = plan
        except TypeError:
            pass
    _count_decisions(plan)
    from .. import flight

    flight.record(
        "plan_autotuned",
        computation=getattr(comp, "name", None) or hex(id(comp)),
        est_ops=n,
        decisions={
            d.knob: {"choice": d.choice, "source": d.source}
            for d in plan.decisions
        },
    )
    return plan


def _estimate_ops(comp) -> int:
    """Host-op-equivalent size estimate (the heavy-jit gate's currency),
    tolerant of both logical and lowered graphs."""
    ops = getattr(comp, "operations", None)
    if not ops:
        return 0
    try:
        from ..computation import ReplicatedPlacement
        from ..dialects.logical import EXPANSION_WEIGHTS

        total = 0
        for op in ops.values():
            plc = comp.placements.get(op.placement_name)
            if isinstance(plc, ReplicatedPlacement):
                total += EXPANSION_WEIGHTS.get(op.kind, 20)
            else:
                total += 3
        return total
    except Exception:  # noqa: BLE001 — sizing is best-effort
        return len(ops)


def _dominant_dot_shape(comp) -> Optional[Tuple[int, int, int]]:
    """The largest replicated Dot's (m, k, n) when shapes are statically
    known — the shape whose class the plan-level pallas_dot decision
    reports.  Trace-time dispatch still decides per actual shape."""
    ops = getattr(comp, "operations", None)
    if not ops:
        return None
    best: Optional[Tuple[int, int, int]] = None
    for op in ops.values():
        if op.kind != "Dot":
            continue
        try:
            shapes = [
                tuple(int(d) for d in ty.shape)
                for ty in op.signature.input_types
                if getattr(ty, "shape", None) is not None
            ]
        except Exception:  # noqa: BLE001 — shapeless signatures
            continue
        if len(shapes) != 2 or len(shapes[0]) != 2 or len(shapes[1]) != 2:
            continue
        m, k = shapes[0]
        k2, n = shapes[1]
        if k != k2:
            continue
        cand = (m, k, n)
        if best is None or m * k * n > best[0] * best[1] * best[2]:
            best = cand
    return best
