"""The distributed worker's compiled fast path: per-role validated
segments with communication overlap.

The port's own copy of ``moose_tpu/distributed/worker_plan.py``.  The
worker's **role subgraph** (its own ops, in global topological order) is
split at Send/Receive/host boundaries into compute segments by the same
``compilation.analysis.schedule.build_role_schedule`` the static
analyzer checks (with the autotuned eager floor,
``schedule.worker_min_seg_decision``), so what prancer proves about a
plan is what this worker runs, and the cost model's wire prediction is
the wire this worker emits:

- each validatable segment (at least ``MOOSE_TPU_WORKER_MIN_SEG`` ops,
  no dynamic-shape kind) runs as the plan's jitted form: on the card
  captured as a CUDA graph (``execution.graphs``, one private pool a
  role plan) and replayed, on the CPU the same segment function run
  uncaptured.  It is **validated** before it is trusted: for the plan's
  first ``MOOSE_TPU_JIT_SELFCHECK`` sessions the candidate runs against
  the segment's eager run on the same inputs and must agree word for
  word; a segment that diverges is pinned eager, and the session goes
  on from the eager result;
- a PRF key that enters a segment (the role's own hoisted PrfKeyGen, or
  a received one) is bound as a row of the segment's ``(n_keys, 4)`` key
  table on the device, so each DeriveSeed -> SampleSeeded in it is one
  K7 launch that makes its seed on the card, and a replay draws the
  session's masks, not the capture's;
- sends enqueue on a background sender thread at segment boundaries;
  each segment's deferred flush group buckets per receiver and every
  >=2-payload bucket coalesces into one ``send_many`` envelope,
  deterministically (plan-driven);
- all Receives are posted up front, and a prefetcher fills arriving
  payloads into segment input slots while segments compute;
- plans are vetted before they run: :func:`get_plan` raises the typed
  :class:`~moose_tpu_torch.errors.PlanRejectedError` on would-hang plans
  (MSA5xx) and on key-lineage errors (MSA8xx); the worker then runs the
  legacy scheduler of :mod:`worker`.

:func:`use_fast_path` chooses the scheduler as the JAX package does:
``MOOSE_TPU_WORKER_JIT`` wins, else ``MOOSE_TPU_JIT`` (default on)
decides, and the ``aes-ctr`` PRF or ``MOOSE_TPU_JIT_SELFCHECK=0`` keeps
the legacy scheduler.  Under ``MOOSE_TPU_FIXED_KEYS`` both schedulers
give the same words.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Optional

import torch

from ..compilation.analysis.schedule import build_role_schedule
from ..errors import (
    NetworkingError,
    PlanRejectedError,
    SessionAbortedError,
)

# The segmentation rules (host-step / hoistable / deferrable kind sets,
# the deferred-send cap, the sliver threshold) live in
# compilation.analysis.schedule: the worker builds its plan from the same
# ``build_role_schedule`` the static analyzer checks, so what prancer
# proves about a plan is what this worker runs.


def worker_jit_enabled(default: Optional[bool] = None) -> bool:
    """Whether the compiled worker fast path is on, the JAX package's
    rule: an explicit ``MOOSE_TPU_WORKER_JIT`` wins; otherwise
    ``default`` where given (a one-session program such as ``dasher``
    passes False), else the runtime-wide ``MOOSE_TPU_JIT`` (default on)
    decides, so a test suite's eager default keeps workers on the legacy
    scheduler while deployments get the fast path."""
    raw = os.environ.get("MOOSE_TPU_WORKER_JIT")
    if raw is not None:
        return raw not in ("0", "")
    if default is not None:
        return default
    return os.environ.get("MOOSE_TPU_JIT", "1") != "0"


def use_fast_path() -> bool:
    """The fast path unless it is off, or the PRF is the host-side
    ``aes-ctr`` stream (a segment's jitted form refuses it, as
    ``jax.jit`` does), or the self-check is off (``MOOSE_TPU_JIT_SELFCHECK
    =0``: an unvalidated segment is never run).  Purely environmental:
    the same verdict for every computation and role."""
    if not worker_jit_enabled():
        return False
    from ..dialects import ring

    if ring.get_prf_impl() == "aes-ctr":
        return False
    from ..execution.interpreter import _selfcheck_runs

    return _selfcheck_runs() > 0


# ---------------------------------------------------------------------------
# plan statistics (asserted by tests: a warm plan never re-validates)
# ---------------------------------------------------------------------------

PLAN_STATS = {
    "plans_built": 0,
    "cache_hits": 0,
    "validating_evaluations": 0,
    "segments_pinned": 0,
    "plans_rejected": 0,
}
_STATS_LOCK = threading.Lock()

# bridge onto the unified metrics registry (metrics.py): every plan
# decision is visible on /metrics under these names
_STAT_METRIC_NAMES = {
    "plans_built": "moose_tpu_worker_plans_built_total",
    "cache_hits": "moose_tpu_worker_plan_cache_hits_total",
    "validating_evaluations": "moose_tpu_worker_plan_validating_total",
    "segments_pinned": "moose_tpu_worker_segments_pinned_total",
    "plans_rejected": "moose_tpu_worker_plans_rejected_total",
}
_STAT_HELP = {
    "plans_built": "role plans built (compile + boundary analysis)",
    "cache_hits": "role plans served warm from the (computation, role) "
                  "cache",
    "validating_evaluations": "sessions that ran at least one "
                              "jit-vs-eager segment comparison",
    "segments_pinned": "segments pinned eager after divergence",
    "plans_rejected": "plans rejected at build time by the MSA5xx "
                      "schedule analyzer (legacy-scheduler fallback)",
}


_STAT_COUNTERS = None


def _stat(key: str, n: int = 1) -> None:
    global _STAT_COUNTERS
    with _STATS_LOCK:
        PLAN_STATS[key] += n
    if _STAT_COUNTERS is None:
        from .. import metrics

        _STAT_COUNTERS = {
            k: metrics.counter(_STAT_METRIC_NAMES[k], _STAT_HELP[k])
            for k in _STAT_METRIC_NAMES
        }
    _STAT_COUNTERS[key].inc(n)


def plan_stats() -> dict:
    with _STATS_LOCK:
        return dict(PLAN_STATS)


# ---------------------------------------------------------------------------
# cost-model drift watchdog: the static analyzer's predictions are
# compared against what this worker MEASURED, continuously, on every
# planned session.  A mismatch is
# the standing alarm that the planner's cost inputs drifted from the
# runtime wire path (counter + flight event; the session itself is never
# failed by its own observability).
# ---------------------------------------------------------------------------


def _drift_fault_applies(identity: str) -> bool:
    """TEST-ONLY (MOOSE_TPU_DRIFT_FAULT): ``1`` perturbs every party's
    coalescing, a party name perturbs only that party — the watchdog
    coverage hook, mirroring MOOSE_TPU_SELFCHECK_FAULT's role for the
    ladder."""
    raw = os.environ.get("MOOSE_TPU_DRIFT_FAULT", "")
    return raw == "1" or (bool(raw) and raw == identity)


def _watchdog_enabled() -> bool:
    return os.environ.get("MOOSE_TPU_COST_WATCHDOG", "1") != "0"


# (cost report, value specs) per computation, keyed by (transport,
# session-id length) — the only two inputs the wire prediction depends
# on besides the graph itself.  Weak-keyed like the plan cache: serving
# traffic must not re-serialize placeholder payloads per session.
_cost_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_DRIFT_COUNTER = None
_WATCHDOG_COUNTER = None


def _drift_counter():
    global _DRIFT_COUNTER
    if _DRIFT_COUNTER is None:
        from .. import metrics

        _DRIFT_COUNTER = metrics.counter(
            "moose_tpu_cost_drift_total",
            "cost-model predictions contradicted by measured session "
            "counters, by kind (the planner's cost inputs drifted)",
            ("kind",),
        )
    return _DRIFT_COUNTER


def _watchdog_counter():
    global _WATCHDOG_COUNTER
    if _WATCHDOG_COUNTER is None:
        from .. import metrics

        _WATCHDOG_COUNTER = metrics.counter(
            "moose_tpu_cost_watchdog_sessions_total",
            "planned sessions screened by the cost-drift watchdog, by "
            "outcome (ok / drift / skipped)",
            ("outcome",),
        )
    return _WATCHDOG_COUNTER


def _watchdog_transport(networking) -> Optional[str]:
    """The cost-model transport semantics matching ``networking``, or
    None when no exact prediction exists: ChaosNetworking decomposes
    coalescing fault-by-fault, TcpNetworking has no ``send_many``, and
    a non-serializing LocalNetworking never touches the wire codec."""
    name = type(networking).__name__
    if name == "GrpcNetworking":
        return "grpc"
    if name == "FabricNetworking":
        return "fabric"
    if name == "LocalNetworking":
        return "local" if getattr(networking, "_serialize", False) else None
    return None


def _cost_prediction(comp, transport: str, session_id: str,
                     fabric_ctx=None):
    key = (transport, len(session_id), fabric_ctx)
    with _cache_lock:
        per_comp = _cost_cache.get(comp)
        if per_comp is None:
            per_comp = _cost_cache[comp] = {}
        entry = per_comp.get(key)
    if entry is not None:
        return entry
    from ..compilation.analysis.cost import cost_report, infer_specs

    entry = (
        cost_report(
            comp, session_id=session_id, transport=transport,
            fabric_parties=fabric_ctx[0] if fabric_ctx else None,
        ),
        infer_specs(comp),
    )
    with _cache_lock:
        per_comp[key] = entry
    return entry


def _live_bytes_overruns(plan, env: dict, specs, cap: int = 4):
    """Boundary values whose REAL in-memory bytes exceed the model's
    ``memory_bytes`` — the observable inputs of the MSA603 live-buffer
    high-water marks.  Undercounting is the drift that matters (the hwm
    stops being an upper bound); a conservative model is fine."""
    from ..compilation.analysis.cost import memory_bytes
    from .fabric import leaf_bytes, value_leaves

    over: dict = {}
    names: set = set()
    for seg in plan.segments:
        names.update(seg.in_names)
        names.update(seg.out_names)
    for name in sorted(names):
        value = env.get(name)
        spec = specs.get(name)
        if value is None or spec is None:
            continue
        predicted = memory_bytes(spec)
        if predicted is None:
            continue
        measured = leaf_bytes(value_leaves(value))
        if measured > predicted:
            over[name] = {"predicted": predicted, "measured": measured}
            if len(over) >= cap:
                break
    return over


def check_cost_drift(comp, identity: str, session_id: str, networking,
                     sender, receives: int, env: dict,
                     plan) -> Optional[dict]:
    """Compare this party's measured session counters (singles,
    coalesced envelopes/payloads, tx bytes, receives, boundary value
    bytes) against the static cost model's per-party prediction.  On
    mismatch: ONE ``cost_drift`` flight event for the session carrying
    every mismatched kind, plus ``moose_tpu_cost_drift_total{kind}``
    increments.  Returns the mismatch dict (None when clean/skipped) —
    and NEVER raises: the watchdog explains sessions, it must not fail
    them."""
    from ..logger import get_logger

    try:
        if not _watchdog_enabled():
            return None
        transport = _watchdog_transport(networking)
        if transport is None:
            _watchdog_counter().inc(outcome="skipped")
            return None
        fabric_ctx = None
        if transport == "fabric":
            # None when the fabric is disabled or chaos force-wire
            # latches make the edge set key-dependent — no exact
            # prediction exists then, so the watchdog stands down
            fabric_ctx = networking.fabric_cost_context()
            if fabric_ctx is None:
                _watchdog_counter().inc(outcome="skipped")
                return None
        report, specs = _cost_prediction(
            comp, transport, session_id, fabric_ctx
        )
        party = report["per_party"].get(identity)
        if party is None or party["unresolved_sends"]:
            _watchdog_counter().inc(outcome="skipped")
            return None
        stats = sender.stats
        measured = {
            "send_many_envelopes": stats["envelopes"],
            "send_many_payloads": stats["env_payloads"],
            # local transports count coalesced payloads as sends too
            # (send_many delegates to send); grpc sends one rpc frame,
            # and a fabric envelope is one batched permute program
            "sends": stats["singles"] + (
                stats["env_payloads"]
                if transport not in ("grpc", "fabric") else 0
            ),
            "receives": int(receives),
        }
        predicted = {k: int(party[k]) for k in measured}
        tx = sender.measured_tx_bytes
        if tx is not None:
            measured["tx_bytes"] = int(tx)
            predicted["tx_bytes"] = int(party["tx_bytes"])
        mismatches = {
            k: {"predicted": predicted[k], "measured": measured[k]}
            for k in measured
            if measured[k] != predicted[k]
        }
        over = _live_bytes_overruns(plan, env, specs)
        if over:
            mismatches["live_bytes"] = over
        if not mismatches:
            _watchdog_counter().inc(outcome="ok")
            return None
        _watchdog_counter().inc(outcome="drift")
        for kind in mismatches:
            _drift_counter().inc(kind=kind)
        from .. import flight

        flight.record(
            "cost_drift", party=identity, session=session_id,
            transport=transport, mismatches=mismatches,
        )
        get_logger().warning(
            "cost-model drift on %s (session %s): %s — the static "
            "analyzer's prediction no longer matches the runtime wire "
            "path", identity, session_id, sorted(mismatches),
        )
        return mismatches
    except Exception as e:  # noqa: BLE001 — observability must never
        # fail the session it observes
        get_logger().debug("cost-drift watchdog errored: %s", e)
        return None


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


class _Segment:
    """One compute segment of a role plan: a run of consecutive
    non-boundary ops.  A validatable segment runs as its jitted form (a
    CUDA graph on the card, the segment function uncaptured on the CPU)
    once it has agreed word for word with its eager run on its first
    sessions; any other segment runs eagerly.  Its PRF keys are rows of
    its own key table on the device."""

    def __init__(self, index: int, names: list, in_names: list,
                 out_names: list, comp_ref, identity: str,
                 validatable: bool, checks: int, device, pool):
        self.index = index
        self.names = names
        self.in_names = in_names
        self.out_names = out_names
        self._comp_ref = comp_ref
        self._identity = identity
        self.validatable = validatable
        # "validating" -> "jit" (promoted) | "eager" (pinned/unjittable)
        self.mode = "validating" if validatable else "eager"
        self.pinned = False
        self.checks_left = checks
        self._device = device
        # the role plan's graph pool on the card, None on the CPU
        self._pool = pool
        self._jit = None
        self._static = None
        # held from binding the key table to copying a replay's outputs
        # out: the next replay overwrites both
        self._lock = threading.Lock()

    @property
    def captured(self) -> bool:
        """Whether a CUDA graph of this segment is held."""
        return bool(getattr(self._jit, "captured", False))

    def _make_fn(self, fault_kinds=frozenset()):
        names = self.names
        outs = self.out_names
        comp_ref = self._comp_ref
        identity = self._identity
        device = self._device

        def seg(env_in: dict):
            from ..execution import graphs
            from ..execution.interpreter import _fault_perturb
            from ..execution.physical import execute_kernel
            from ..execution.session import EagerSession

            comp = comp_ref()
            if comp is None:  # pragma: no cover - defensive
                raise RuntimeError("computation was garbage-collected")
            sess = EagerSession(device, session_id=f"seg-{identity}")
            env = dict(env_in)
            for n in names:
                op = comp.operations[n]
                # named in a failed capture's error
                graphs.current_op(n)
                env[n] = execute_kernel(
                    sess, op, identity, [env[i] for i in op.inputs])
                if fault_kinds and op.kind in fault_kinds:
                    env[n] = _fault_perturb(env[n])
            return {n: env[n] for n in outs}

        return seg

    def _jit_fn(self):
        if self._jit is None:
            from ..execution import graphs
            from ..execution.interpreter import _fault_kinds

            # fault injection applies to the CANDIDATE only (the test
            # hook forcing divergence where no real one occurs, see
            # interpreter._fault_kinds)
            self._jit = graphs.graphed(
                self._make_fn(_fault_kinds()),
                f"{self._identity} segment {self.index}", self._pool)
        return self._jit

    def _bind_keys(self, env_in: dict, static: bool) -> dict:
        """``env_in`` with each PRF key (host words: a key enters a
        segment from a PrfKeyGen or a Receive step, and no segment passes
        one on) made a row of this segment's ``(n_keys, 4)`` key table on
        the device (on the card in its static buffer, which a capture
        reads, when ``static``), so its draws' seeds are made by K7 on
        the device."""
        from ..execution import graphs
        from ..values import HostPrfKey

        keys = [n for n in self.in_names
                if isinstance(env_in[n], HostPrfKey)]
        if not keys:
            return env_in
        table = graphs.host_key_table([env_in[n].value for n in keys])
        if static and self._pool is not None:
            if self._static is None:
                self._static = graphs.StaticInputs(self._device)
            table = self._static.put("keys", table)
        else:
            table = table.to(self._device)
        env = dict(env_in)
        for i, n in enumerate(keys):
            key = env_in[n]
            env[n] = HostPrfKey(table[i], key.plc, origin=key.origin)
        return env

    @staticmethod
    def _copy_out(out: dict) -> dict:
        """A run's outputs copied out of the graph's pool and the key
        table (a seed a segment passes on holds its key's row), which the
        next session overwrites."""
        from ..execution import graphs

        return graphs.map_tensors(out, torch.clone)

    def run(self, env_in: dict,
            session_id: Optional[str] = None) -> tuple:
        """Execute the segment; returns ``(out_env, validated)`` where
        ``validated`` reports whether this call ran a candidate-against-
        eager comparison (the plan-level "validating evaluation"
        counter).  ``session_id`` stamps a pin's flight event so the
        decision reaches that session's postmortem.  A capture or replay
        that fails raises ``GraphCaptureError`` naming the segment and
        op, and fails the session."""
        if self.mode == "eager":
            return self._make_fn()(self._bind_keys(env_in, False)), False
        with self._lock:
            return self._run_locked(env_in, session_id)

    def _run_locked(self, env_in: dict, session_id) -> tuple:
        from .. import profiling
        from ..execution.interpreter import _results_equal
        from ..logger import get_logger

        mode = self.mode
        env = self._bind_keys(env_in, mode != "eager")
        if mode == "eager":  # pinned while this call waited
            return self._make_fn()(env), False
        captured = self._pool is not None
        if mode == "jit":
            out = self._jit_fn()(env)
            return (self._copy_out(out) if captured else out), False
        # validating: the eager result is the reference AND the value
        # the session continues from — a divergent candidate never
        # contaminates the protocol
        with profiling.phase(
            "ladder_validate", segment=self.index, party=self._identity,
        ):
            ref = self._make_fn()(env)
            if captured:
                ref = self._copy_out(ref)
        # a candidate that fails to capture, replay or launch fails the
        # session (the fast path never runs under aes-ctr, the one
        # refusal jax.jit shares)
        with profiling.phase(
            "ladder_validate", segment=self.index, party=self._identity,
        ):
            got = self._jit_fn()(env)
        ok = _results_equal(ref, got)
        if not ok:
            # the candidate's graph is kept, never replayed: dropping the
            # only graph of the role's pool would release the pool under
            # its later captures
            self.mode = "eager"
            self.pinned = True
            _stat("segments_pinned")
            from .. import flight

            flight.record(
                "segment_pinned", party=self._identity,
                session=session_id, segment=self.index,
                ops=len(self.names),
            )
            get_logger().warning(
                "worker segment %d (%d ops, %s..%s) diverged from "
                "its eager reference; pinned eager", self.index,
                len(self.names), self.names[0], self.names[-1],
            )
        else:
            self.checks_left -= 1
            if self.checks_left <= 0:
                self.mode = "jit"
        return ref, True


# ---------------------------------------------------------------------------
# the role plan
# ---------------------------------------------------------------------------


class RolePlan:
    """Static execution plan for one (computation, role, device): the
    ordered step list (host-boundary ops interleaved with compute
    segments) plus per-segment validated state, and on the card the
    private graph pool its segments' captures share.  Cached weak-keyed
    on the computation, so it must not hold it strongly."""

    # MSA704 summary attached by get_plan (advisory; {} until set)
    ranges_advisory: dict = {}

    def __init__(self, comp, identity: str, device="cpu"):
        from ..execution import graphs
        from ..execution.interpreter import _selfcheck_runs

        self.identity = identity
        self._comp_ref = weakref.ref(comp)
        self.device = torch.device(device)
        checks = _selfcheck_runs()
        # one pool a role plan: its segments replay in capture order,
        # each under its own lock, on the device's current stream; its
        # hundreds of small captures skip torch.cuda.graph's synchronize
        # and cache release (done once here)
        self.pool = (graphs.GraphPool(self.device, free_cache=False)
                     if self.device.type == "cuda" else None)

        # the statically-checkable schedule skeleton — segmentation,
        # hoisting, deferral, flush grouping — comes from the SAME
        # reconstruction the MSA5xx analyzer and MSA6xx cost model use
        # (including the autotuned eager floor: the two-pass min_seg
        # resolution lives in reconstruct_schedules, so the plan the
        # analyzer approved and the wire costs the watchdog predicts
        # are byte-for-byte the plan that runs)
        from ..compilation.analysis.schedule import (
            reconstruct_schedules,
            worker_min_seg_decision,
        )

        self.autotune_min_seg = worker_min_seg_decision(comp)
        schedule = reconstruct_schedules(comp).get(identity)
        if schedule is None:  # role with no ops of its own
            schedule = build_role_schedule(
                comp, identity, min_seg=self.autotune_min_seg.choice
            )
        self.schedule = schedule
        self.segments = [
            _Segment(
                seg.index, list(seg.names), list(seg.in_names),
                list(seg.out_names), self._comp_ref, identity,
                validatable=seg.validatable, checks=checks,
                device=self.device, pool=self.pool,
            )
            for seg in schedule.segments
        ]
        self.steps = [
            (kind, payload if kind != "sends" else list(payload))
            for kind, payload in schedule.steps
        ]
        self.recv_names = list(schedule.recv_names)

    @property
    def pinned_segments(self) -> list:
        return [s.index for s in self.segments if s.pinned]

    @property
    def plan_mode(self) -> str:
        """Resolved (or currently-validating) plan shape: ``full-jit``
        (the role's whole compute is one jitted program), ``segmented``
        (several jitted segments, possibly with pins), ``validating``,
        or ``eager`` (no jittable compute / everything pinned)."""
        segs = [s for s in self.segments if s.validatable]
        if not segs:
            return "eager"
        if any(s.mode == "validating" for s in segs):
            return "validating"
        jitted = [s for s in segs if s.mode == "jit"]
        if not jitted:
            return "eager"
        if len(self.segments) == 1 and not self.pinned_segments:
            return "full-jit"
        return "segmented"

    @property
    def captured_graphs(self) -> int:
        """Segments whose CUDA graph the plan holds (0 on the CPU)."""
        return sum(s.captured for s in self.segments)


# Resolved-plan cache, weak-keyed on the computation (the worker server
# memoizes deserialization by computation bytes, so repeat sessions of
# one computation share the object and hit here).
_plan_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_cache_lock = threading.Lock()

# MSA5xx verdict per computation: the schedule analysis is pure graph
# work (no compiles), but on serving traffic the same computation
# arrives thousands of times — cache the error list weak-keyed like the
# plans themselves.
_verdict_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# MSA704 summary per computation (advisory only — the worker has no
# declared arg ranges, so this is the structural representable-interval
# demand; it never rejects a plan).
_ranges_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# MSA8xx verdict per computation: key-lineage errors (mis-wired setup,
# missing domain separation, stream-position reuse) are correctness
# *and* secrecy bugs, so like the MSA5xx schedule verdict they reject
# the plan rather than advise.  Weak-keyed: serving traffic replays the
# same computation object thousands of times.
_keystream_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _ranges_advisory(comp) -> dict:
    """The range analysis' per-computation summary (peak raw-bit demand,
    minimal ring width), attached to every resolved plan so operators
    can see ring-width headroom per role without rerunning prancer.
    Advisory by construction: no declared ranges, no errors raised."""
    with _cache_lock:
        cached = _ranges_cache.get(comp)
    if cached is not None:
        return cached
    try:
        from ..compilation.analysis.ranges import range_report

        advisory = dict(range_report(comp)["summary"])
    except Exception:  # noqa: BLE001 — advisory data must never take
        # down plan building
        advisory = {}
    with _cache_lock:
        _ranges_cache[comp] = advisory
    return advisory


def _keystream_errors(comp) -> list:
    """Error-severity MSA8xx findings for ``comp`` (worker graphs are
    already lowered, so the analyzer sees the real Sample/DeriveSeed
    ops directly).  An analysis *crash* must never take down plan
    building — only a clean run that found real errors rejects."""
    with _cache_lock:
        cached = _keystream_cache.get(comp)
    if cached is not None:
        return cached
    try:
        from ..compilation.analysis import Severity
        from ..compilation.analysis.keystream import analyze_keystream

        errors = [d for d in analyze_keystream(comp)
                  if d.severity >= Severity.ERROR]
    except Exception:  # noqa: BLE001 — fail open, like _ranges_advisory
        errors = []
    with _cache_lock:
        _keystream_cache[comp] = errors
    return errors


def _schedule_errors(comp) -> list:
    with _cache_lock:
        cached = _verdict_cache.get(comp)
    if cached is not None:
        return cached
    from ..compilation.analysis.schedule import plan_errors

    errors = plan_errors(comp)
    with _cache_lock:
        _verdict_cache[comp] = errors
    return errors


def get_plan(comp, identity: str, session_id: Optional[str] = None,
             device="cpu") -> RolePlan:
    """Build (or serve warm) the role plan on ``device`` — AFTER the
    static schedule analyzer approved the computation.  A would-hang
    plan (MSA5xx error: wait cycle, oversubscribed rendezvous,
    use-before-arrival) raises
    :class:`~moose_tpu_torch.errors.PlanRejectedError` at build time;
    the worker then falls back to the legacy eager scheduler, so the
    failure mode is a typed diagnostic instead of a runtime hang.  A
    plan holds its device's captures, so one is kept for each (role,
    device); ``execute_role`` passes the worker's device (a plan built
    for the CPU, the default here, captures nothing)."""
    from .. import devices

    slot = (identity, devices.canonical(device))
    with _cache_lock:
        per_comp = _plan_cache.get(comp)
        if per_comp is None:
            per_comp = _plan_cache[comp] = {}
        plan = per_comp.get(slot)
    if plan is not None:
        _stat("cache_hits")
        return plan
    errors = _schedule_errors(comp)
    if errors:
        from ..compilation.analysis.diagnostics import format_diagnostics

        _stat("plans_rejected")
        from .. import flight

        flight.record(
            "plan_rejected", party=identity, session=session_id,
            rules=sorted({d.rule for d in errors}),
            findings=len(errors),
        )
        raise PlanRejectedError(
            f"worker plan for role {identity!r} rejected by the "
            f"schedule analyzer with {len(errors)} error(s):\n"
            + format_diagnostics(errors),
            diagnostics=errors,
        )
    key_errors = _keystream_errors(comp)
    if key_errors:
        from ..compilation.analysis.diagnostics import format_diagnostics

        _stat("plans_rejected")
        from .. import flight

        flight.record(
            "plan_rejected", party=identity, session=session_id,
            rules=sorted({d.rule for d in key_errors}),
            findings=len(key_errors),
        )
        raise PlanRejectedError(
            f"worker plan for role {identity!r} rejected by the "
            f"keystream analyzer with {len(key_errors)} error(s):\n"
            + format_diagnostics(key_errors),
            diagnostics=key_errors,
        )
    plan = RolePlan(comp, identity, slot[1])
    plan.ranges_advisory = _ranges_advisory(comp)
    with _cache_lock:
        existing = _plan_cache[comp].get(slot)
        if existing is not None:
            return existing
        _plan_cache[comp][slot] = plan
    _stat("plans_built")
    from .. import flight

    # session-stamped so the plan decision reaches the session-filtered
    # postmortem (last_session_report["flight"])
    flight.record(
        "plan_built", party=identity, session=session_id,
        mode=plan.plan_mode, segments=len(plan.segments),
        steps=len(plan.steps), receives=len(plan.recv_names),
        min_ring_width=plan.ranges_advisory.get("min_ring_width"),
        peak_raw_bits=plan.ranges_advisory.get("peak_raw_bits"),
        min_seg=plan.autotune_min_seg.choice,
        min_seg_source=plan.autotune_min_seg.source,
    )
    return plan


# ---------------------------------------------------------------------------
# communication overlap: async sender + receive prefetcher
# ---------------------------------------------------------------------------


class _AsyncSender:
    """Background send queue: the orchestrator enqueues single sends
    (host-step sends) or whole deferred flush groups (one per segment
    close) and moves on; this thread serializes and transmits off the
    critical path.  Coalescing is DETERMINISTIC and plan-driven: within
    one flush group, payloads bucket per receiver (first-appearance
    order, payload order preserved) and each >=2-payload bucket becomes
    exactly one ``send_many`` envelope — never across groups, never
    timing-dependent — so the static cost model predicts envelope
    counts and wire bytes exactly and chaos fault schedules (keyed on
    stable rendezvous keys) replay identically.  Errors become the
    session's root cause via ``on_error``."""

    def __init__(self, networking, session_id: str, on_error,
                 progress=None, identity: str = ""):
        from .. import telemetry

        self._net = networking
        self._session_id = session_id
        self._on_error = on_error
        self._progress = progress
        self._identity = identity
        # the sender thread inherits the enclosing trace context (the
        # session's launch context) so any span it opens stitches into
        # the session trace instead of starting an orphan root
        self._ctx = telemetry.current_context()
        self._items: deque = deque()
        self._cv = threading.Condition()
        self._pending = 0
        self._closed = False
        self._error = None
        # per-session measured wire stats (the cost-drift watchdog
        # compares these against the static cost model's prediction for
        # this party): singles = payloads transmitted one send() each,
        # envelopes/env_payloads = coalesced send_many units, tx_bytes =
        # sum of the transport's reported transmitted bytes (None once
        # any transmission couldn't report a size)
        self.stats = {
            "singles": 0, "envelopes": 0, "env_payloads": 0,
            "tx_bytes": 0,
        }
        self._bytes_unknown = False
        self._thread = threading.Thread(
            target=self._run_thread, daemon=True, name="moose-sender",
        )
        self._thread.start()

    def _run_thread(self) -> None:
        from .. import telemetry

        with telemetry.use_context(self._ctx):
            self._loop()

    def enqueue(self, value, receiver: str, rendezvous_key: str) -> None:
        """One single-payload transmission unit (a host-step Send with
        nothing to defer behind): never coalesced."""
        with self._cv:
            if self._error is not None:
                return  # session already failing; drop silently
            self._items.append(
                (receiver, [(rendezvous_key, value)])
            )
            self._pending += 1
            self._cv.notify()

    def enqueue_group(self, sends: list) -> None:
        """One deferred flush group: ``[(value, receiver, key), ...]``
        buckets per receiver (first-appearance order; per-receiver
        payload order preserved) and each bucket transmits as ONE unit
        — a ``send_many`` envelope when it carries >=2 payloads.
        Payloads to different receivers commute (rendezvous-keyed), so
        the bucketing never reorders anything a peer can observe."""
        buckets: dict = {}
        order: list = []
        for value, receiver, key in sends:
            if receiver not in buckets:
                buckets[receiver] = []
                order.append(receiver)
            buckets[receiver].append((key, value))
        if _drift_fault_applies(self._identity):
            # TEST-ONLY perturbation (MOOSE_TPU_DRIFT_FAULT): transmit
            # every payload as its own singleton unit, deliberately
            # breaking the deterministic coalescing the static cost
            # model predicts — the watchdog must flag this session as
            # cost_drift (tests/test_profiling.py)
            with self._cv:
                if self._error is not None:
                    return
                for receiver in order:
                    for payload in buckets[receiver]:
                        self._items.append((receiver, [payload]))
                        self._pending += 1
                self._cv.notify()
            return
        with self._cv:
            if self._error is not None:
                return
            for receiver in order:
                self._items.append((receiver, buckets[receiver]))
                self._pending += len(buckets[receiver])
            self._cv.notify()

    def _take_unit(self) -> Optional[tuple]:
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait(0.2)
            if not self._items:
                return None
            return self._items.popleft()

    def _loop(self) -> None:
        while True:
            unit = self._take_unit()
            if unit is None:
                return
            receiver, payloads = unit
            try:
                if self._error is None:
                    self._transmit(receiver, payloads)
            except BaseException as e:  # noqa: BLE001 — root cause
                with self._cv:
                    if self._error is None:
                        self._error = e
                self._on_error(e)
            finally:
                with self._cv:
                    self._pending -= len(payloads)
                    self._cv.notify_all()

    def _transmit(self, receiver: str, payloads: list) -> None:
        from .. import flight, profiling

        send_many = getattr(self._net, "send_many", None)
        with profiling.phase(
            "net_send", receiver=receiver, payloads=len(payloads),
        ):
            if len(payloads) > 1 and send_many is not None:
                sent = send_many(payloads, receiver, self._session_id)
                self.stats["envelopes"] += 1
                self.stats["env_payloads"] += len(payloads)
                self._tally_bytes(sent)
            else:
                for key, value in payloads:
                    sent = self._net.send(
                        value, receiver, key, self._session_id
                    )
                    self.stats["singles"] += 1
                    self._tally_bytes(sent)
        flight.record(
            "send", party=self._identity or None,
            session=self._session_id, receiver=receiver,
            payloads=len(payloads), coalesced=len(payloads) > 1,
        )
        if self._progress is not None:
            self._progress.bump()

    def _tally_bytes(self, sent) -> None:
        if sent is None:
            self._bytes_unknown = True
        elif not self._bytes_unknown:
            self.stats["tx_bytes"] += int(sent)

    @property
    def measured_tx_bytes(self):
        """Transmitted bytes this session, or None when any transport
        call couldn't report a size (watchdog then skips the bytes
        comparison instead of flagging a phantom drift)."""
        return None if self._bytes_unknown else self.stats["tx_bytes"]

    def flush(self, timeout: float, cancel=None) -> None:
        """Block until every enqueued send has been transmitted (the
        worker must not report success while peers still await its
        payloads); raises the first transmit error, if any."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending > 0 and self._error is None:
                if cancel is not None and cancel.is_set():
                    break
                if time.monotonic() > deadline:
                    raise NetworkingError(
                        f"{self._pending} queued send(s) not flushed "
                        f"after {timeout}s"
                    )
                self._cv.wait(0.2)
            if self._error is not None:
                raise self._error

    def close(self) -> None:
        """Stop the sender thread.  With nothing queued it has ended when
        this returns; units queued behind a failure still go out."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            idle = self._pending == 0
        if idle:
            self._thread.join()


_PREFETCH_COUNTER = None


def _prefetch_counter():
    """Cached family (one registry lookup ever — this sits on the
    per-receive hot path)."""
    global _PREFETCH_COUNTER
    if _PREFETCH_COUNTER is None:
        from .. import metrics

        _PREFETCH_COUNTER = metrics.counter(
            "moose_tpu_worker_prefetch_total",
            "receive waits at the orchestrator, by whether the "
            "prefetcher already held the payload",
            ("outcome",),
        )
    return _PREFETCH_COUNTER


class _ReceivePrefetcher:
    """Posts EVERY Receive of the role up front and fills arriving
    payloads into per-name slots while segments compute, so the
    orchestrator's ``wait`` usually returns immediately.  Pollable
    transports (try_receive) get one poller thread for all keys; others
    get one waiter thread per receive (both mirror the legacy
    scheduler's discipline — receives never occupy compute slots)."""

    def __init__(self, comp, recv_names, networking, session_id: str,
                 identity: str, timeout: float, cancel, progress,
                 on_error):
        from .. import telemetry

        self._net = networking
        self._session_id = session_id
        self._identity = identity
        self._timeout = timeout
        self._cancel = cancel
        self._progress = progress
        self._on_error = on_error
        self._stop = threading.Event()
        self._values: dict = {}
        self._events = {n: threading.Event() for n in recv_names}
        self._ops = {n: comp.operations[n] for n in recv_names}
        # prefetch threads inherit the session trace context (no orphan
        # roots; see _AsyncSender)
        self._ctx = telemetry.current_context()
        self._threads: list = []
        if not recv_names:
            return
        if hasattr(networking, "try_receive"):
            t = threading.Thread(
                target=self._with_ctx, args=(self._poll,), daemon=True,
                name=f"moose-{identity}-prefetch",
            )
            t.start()
            self._threads.append(t)
        else:
            for n in recv_names:
                t = threading.Thread(
                    target=self._with_ctx, args=(self._wait_one, n),
                    daemon=True,
                    name=f"moose-{identity}-recv-{n}",
                )
                t.start()
                self._threads.append(t)

    def _with_ctx(self, fn, *args) -> None:
        from .. import telemetry

        with telemetry.use_context(self._ctx):
            fn(*args)

    def _arrived(self, name: str, value) -> None:
        self._values[name] = value
        self._events[name].set()
        self._progress.bump()

    def _poll(self) -> None:
        get_act = getattr(self._net, "activity_for", None)
        activity = (
            get_act(self._session_id) if get_act is not None else None
        )
        outstanding = dict(self._ops)
        while outstanding and not self._stop.is_set():
            if self._cancel is not None and self._cancel.is_set():
                return
            if activity is not None:
                activity.clear()
            arrived = []
            for name, op in outstanding.items():
                try:
                    ok, val = self._net.try_receive(
                        op.attributes["sender"],
                        op.attributes["rendezvous_key"],
                        self._session_id,
                        plc=self._identity,
                    )
                except BaseException as e:  # noqa: BLE001 — root cause
                    self._on_error(e)
                    return
                if ok:
                    arrived.append(name)
                    self._arrived(name, val)
            for name in arrived:
                outstanding.pop(name, None)
            if activity is not None:
                activity.wait(0.1)
            else:
                time.sleep(0.005)

    def _wait_one(self, name: str) -> None:
        op = self._ops[name]
        try:
            val = self._net.receive(
                op.attributes["sender"],
                op.attributes["rendezvous_key"],
                self._session_id,
                plc=self._identity,
                timeout=self._timeout,
                cancel=self._stop,
                progress=self._progress,
            )
        except SessionAbortedError:
            return  # the abort or the stop is already the outcome
        except BaseException as e:  # noqa: BLE001 — root cause
            self._on_error(e)
            return
        self._arrived(name, val)

    def wait(self, name: str):
        """Block until ``name``'s payload arrived; progress-clock
        timeout semantics identical to a direct blocking receive."""
        from .. import flight
        from .networking import sliced_wait

        from .. import profiling

        op = self._ops[name]
        hit = self._events[name].is_set()
        _prefetch_counter().inc(outcome="hit" if hit else "wait")
        with profiling.phase(
            "net_receive", key=op.attributes.get("rendezvous_key", ""),
            prefetched=hit,
        ):
            sliced_wait(
                self._events[name].wait, self._timeout, self._cancel,
                op.attributes["rendezvous_key"], self._progress,
            )
        flight.record(
            "receive", party=self._identity, session=self._session_id,
            sender=op.attributes.get("sender"),
            key=op.attributes.get("rendezvous_key"),
            prefetched=hit,
        )
        return self._values.pop(name)

    def stop(self) -> None:
        """Give up every receive still posted; the prefetch threads have
        ended when this returns (a blocked receive notices within one
        slice of its wait)."""
        self._stop.set()
        for thread in self._threads:
            thread.join()


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------


def execute_role_planned(
    comp,
    identity: str,
    storage: dict,
    arguments: dict,
    networking,
    session_id: str,
    timeout: float,
    cancel,
    progress,
    plan: RolePlan,
    device,
) -> dict:
    """Run one role through its compiled plan on ``device``: host steps
    and segments execute in the global topological order (a
    linearization every worker shares, so the cluster stays
    deadlock-free: any blocked receive's matching send precedes it
    globally and sends never block), with sends async behind and
    receives prefetched ahead.  Segments run validated (:class:`_Segment`);
    host steps, an unseeded Sample included, run eagerly in the role's
    session."""
    from .. import telemetry
    from .worker import _AnyEvent, _exec_host_op

    from ..execution.physical import execute_kernel
    from ..execution.session import EagerSession

    t0 = time.perf_counter()
    env: dict = {}
    outputs: dict = {}
    # the role's one session, as the legacy scheduler's: host steps and
    # segments run through the same kernel dispatch; lazy master key
    # makes this cheap even when the role has none
    host_sess = EagerSession(device, session_id=session_id)
    local_abort = threading.Event()
    abort_any = _AnyEvent(cancel, local_abort)
    failure: list = []
    flock = threading.Lock()

    def fail(exc: BaseException) -> None:
        with flock:
            if not failure:
                failure.append(exc)
        local_abort.set()

    sender = _AsyncSender(
        networking, session_id, fail, progress, identity=identity
    )
    prefetcher = _ReceivePrefetcher(
        comp, plan.recv_names, networking, session_id, identity,
        timeout, abort_any, progress, fail,
    )
    validated = False
    receives_measured = 0
    with telemetry.span(
        "execute_role", party=identity, steps=len(plan.steps),
    ) as root:
        try:
            for kind, payload in plan.steps:
                if abort_any.is_set():
                    raise SessionAbortedError(
                        f"session {session_id} aborted"
                    )
                if kind == "seg":
                    from .. import profiling

                    seg = plan.segments[payload]
                    with telemetry.span(
                        "worker_segment", party=identity,
                        segment=seg.index, ops=len(seg.names),
                        mode=seg.mode,
                    ):
                        out, did_validate = seg.run(
                            {n: env[n] for n in seg.in_names},
                            session_id=session_id,
                        )
                        # device-fenced only while a profiler is active:
                        # the worker_segment phase then owns its device
                        # time instead of the next blocking call
                        profiling.fence(out)
                    env.update(out)
                    validated |= did_validate
                    progress.bump()
                    continue
                if kind == "sends":
                    # one deferred flush group: the sender buckets it
                    # per receiver and coalesces deterministically (the
                    # static cost model walks the identical grouping)
                    from ..values import HostUnit

                    group = []
                    for n in payload:
                        op = comp.operations[n]
                        group.append((
                            env[op.inputs[0]],
                            op.attributes["receiver"],
                            op.attributes["rendezvous_key"],
                        ))
                        env[n] = HostUnit(identity)
                    sender.enqueue_group(group)
                    continue
                op = comp.operations[payload]
                if op.kind == "Send":
                    # not reachable from build_role_schedule (sends ride
                    # in flush groups), kept for hand-built plans
                    sender.enqueue(
                        env[op.inputs[0]],
                        op.attributes["receiver"],
                        op.attributes["rendezvous_key"],
                    )
                    from ..values import HostUnit

                    env[payload] = HostUnit(identity)
                elif op.kind == "Receive":
                    env[payload] = prefetcher.wait(payload)
                    receives_measured += 1
                elif op.kind == "Sample":
                    # unseeded draw: a hard segment boundary (jitting it
                    # would bake one draw into the compiled program) but
                    # NOT an _exec_host_op kind — run the legacy
                    # scheduler's eager kernel
                    env[payload] = execute_kernel(
                        host_sess, op, identity,
                        [env[i] for i in op.inputs],
                    )
                    progress.bump()
                else:
                    env[payload] = _exec_host_op(
                        op, env, identity, arguments, storage, outputs,
                        host_sess,
                    )
                    progress.bump()
            sender.flush(timeout, abort_any)
        except BaseException as e:  # noqa: BLE001 — first error wins
            fail(e)
        finally:
            prefetcher.stop()
            sender.close()
        root.attrs["plan_mode"] = plan.plan_mode
        root.attrs["pinned_segments"] = len(plan.pinned_segments)

    if validated:
        _stat("validating_evaluations")
    if failure:
        exc = failure[0]
        if cancel is not None and cancel.is_set() and not isinstance(
            exc, SessionAbortedError
        ):
            raise SessionAbortedError(
                f"session {session_id} aborted"
            ) from exc
        raise exc
    if cancel is not None and cancel.is_set():
        raise SessionAbortedError(f"session {session_id} aborted")

    # the session SUCCEEDED: screen its measured wire/memory counters
    # against the static cost model (continuous drift watchdog)
    check_cost_drift(
        comp, identity, session_id, networking, sender,
        receives_measured, env, plan,
    )

    elapsed = int((time.perf_counter() - t0) * 1e6)
    return {
        "outputs": outputs,
        "elapsed_time_micros": elapsed,
        "plan_mode": plan.plan_mode,
        "pinned_segments": plan.pinned_segments,
    }
