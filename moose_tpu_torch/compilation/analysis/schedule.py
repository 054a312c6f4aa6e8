"""Static schedule analysis over distributed execution plans (``MSA5xx``).

The op-level communication rules (MSA2xx) check the *graph* the compiler
emitted; the distributed workers execute a *plan* derived from it —
:mod:`moose_tpu.distributed.worker_plan` reorders each role's subgraph:
input-free host ops hoist before merged compute segments, value-consuming
host ops (Send/Save/Output) defer after them, consecutive deferred sends
coalesce into one ``send_many`` flush group per receiver, and every
Receive is prefetched but *waited on* at its step position by a strictly
sequential orchestrator.  A malformed plan is a silent runtime hang, so
this module makes the plan itself machine-checkable **without
executing**:

- :func:`build_role_schedule` reconstructs one role's step schedule with
  the exact segmentation rules the worker applies (the worker's
  ``RolePlan`` builds its runtime plan from this same function, so the
  analysis can never drift from execution);
- :func:`analyze_schedule` proves deadlock-freedom of the cross-role
  segment-level wait graph under send-coalescing and receive-prefetch
  semantics — a strict generalization of MSA204, which only sees
  op-granularity dataflow edges and cannot model the sequential
  orchestrator (where a receive blocks every later step of its role,
  related by dataflow or not) or a deferred send moving past its
  original position.

Rules:

- ``MSA501`` (error): unsatisfiable wait — the fixed point of the
  segment-level wait graph leaves a Receive step that can never be
  served under single-delivery rendezvous semantics (a wait cycle
  between sequential role schedules, a key whose every Send is itself
  blocked, a key with no Send at all, or a key oversubscribed by
  several Receives).  The sequential orchestrator would hang.
- ``MSA502`` (warning): deferred-send overflow — more than
  ``MAX_DEFERRED`` value-consuming host ops queued behind one merged
  segment forces an early segment split (previously a silent fallback);
  the flush happens earlier and the segment merge is lost.
- ``MSA503`` (error): receive arrives later than first use — a step
  consumes a value whose producing step (a Receive wait, or any other
  step) comes *after* it in the role's schedule; the orchestrator would
  read an absent environment slot.
- ``MSA504`` (info): segment inputs straddle the jit/eager boundary — a
  jit-candidate segment consumes values produced by always-eager sliver
  segments (below ``MOOSE_TPU_WORKER_MIN_SEG``, or carrying
  dynamic-shape kinds), paying a host/device crossing per input per
  evaluation.
- ``MSA505`` (error): fabric-lowered schedule not provably
  deadlock-free — run only when a FabricDomain claims a session (see
  :func:`analyze_fabric_schedules`); rejection makes the fabric
  transport fall back to the wire on every edge of the computation.

On graphs with composite placements (pre-lowering) or without any
Send/Receive op (single-role / pre-networking) the analysis is a no-op,
so it is safe to run unconditionally.

The port's own copy of ``moose_tpu/compilation/analysis/schedule.py``:
the same schedules from the same segmentation rules
(``execution.interpreter.plan_segments``), so its reports equal the
reference's, and the distributed worker (``distributed.worker_plan``)
builds its plan from them.  :func:`worker_min_seg_decision` gives the
plan autotuner's decision for the worker's eager floor.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import (
    Any,
    Dict,
    FrozenSet,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from ...computation import Computation, HostPlacement
from .diagnostics import Diagnostic, Severity

__all__ = [
    "DEFERRABLE_KINDS",
    "DYNAMIC_SHAPE_KINDS",
    "HOISTABLE_KINDS",
    "HOST_STEP_KINDS",
    "MAX_DEFERRED",
    "RoleSchedule",
    "SegmentPlan",
    "Step",
    "analyze_fabric_schedules",
    "analyze_schedule",
    "analyze_schedules",
    "build_role_schedule",
    "plan_errors",
    "reconstruct_schedules",
    "worker_min_seg",
    "worker_min_seg_decision",
]

# One plan step: ("op", op_name) — a host-boundary op the orchestrator
# resolves itself; ("seg", segment_index) — a merged compute segment;
# ("sends", (op_name, ...)) — a deferred-send flush group whose
# consecutive same-receiver payloads coalesce into send_many envelopes.
Step = Tuple[str, Any]

# Kinds the orchestrator resolves on the host side, OUTSIDE compute
# segments: I/O boundaries, communication, and entropy draws (PrfKeyGen /
# Sample must stay eager — jitting them would bake one draw into the
# compiled program and replay it forever).
HOST_STEP_KINDS = frozenset({
    "Input", "Load", "Save", "Output", "Send", "Receive", "PrfKeyGen",
    "Sample",
})

# Of those, only some actually FORCE a segment split.  A lowered
# protocol graph interleaves communication with compute every few ops —
# splitting at every host step would shatter a role into hundreds of
# tiny XLA programs (measured ~300 for one logreg role), paying compile
# and dispatch per fragment.  Instead:
#  - HOISTABLE ops have no dataflow inputs (PrfKeyGen, Input): they
#    execute BEFORE the merged segment, their values entering as
#    ordinary segment inputs;
#  - DEFERRABLE ops only consume values (Send, Save, Output): they
#    execute right AFTER the merged segment that produces their
#    operands.  A deferred Send still flushes before the next receive
#    WAIT, so the deadlock argument is untouched — the orchestrator
#    never blocks between a send's original position and its deferred
#    flush;
#  - HARD boundaries end the segment: Receive (the value arrives
#    mid-order), Load (its key is computed locally), Sample (consumes a
#    locally-computed shape, cannot hoist).
HOISTABLE_KINDS = frozenset({"PrfKeyGen", "Input"})
DEFERRABLE_KINDS = frozenset({"Send", "Save", "Output"})

# dynamic-shape kinds XLA cannot compile; segments containing one run
# eagerly and are never validated (there is no candidate to validate)
DYNAMIC_SHAPE_KINDS = frozenset({"Select"})

# bound on sends deferred behind one merged segment: merging trades
# send latency (peers wait for the whole segment) for dispatch cost, so
# cap how much latency one segment may hoard.  Exceeding it splits the
# segment early — surfaced as MSA502.
MAX_DEFERRED = 16


def worker_min_seg() -> int:
    """Segments below this many ops always run eagerly on the worker
    (not validated, not counted as pinned): a 2-op XLA program saves
    ~one dispatch but costs a compile during validation."""
    raw = os.environ.get("MOOSE_TPU_WORKER_MIN_SEG", "4")
    try:
        return max(1, int(raw))
    except ValueError as e:
        from ...errors import ConfigurationError

        raise ConfigurationError(
            f"MOOSE_TPU_WORKER_MIN_SEG must be an integer, got {raw!r}"
        ) from e


def _segment_limit() -> int:
    from ...execution.interpreter import _segment_limit as limit_fn

    return int(limit_fn())


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One merged compute segment of a role schedule: the op run it
    compiles, its boundary dataflow, and whether the worker would
    jit-validate it (``validatable``) or always run it eagerly."""

    index: int
    names: Tuple[str, ...]
    in_names: Tuple[str, ...]
    out_names: Tuple[str, ...]
    validatable: bool


@dataclasses.dataclass(frozen=True)
class RoleSchedule:
    """The statically-reconstructed execution plan of one role: the
    ordered step list the sequential orchestrator walks, its compute
    segments, and the step index at which every op's value
    materializes (``exec_step``)."""

    role: str
    steps: Tuple[Step, ...]
    segments: Tuple[SegmentPlan, ...]
    recv_names: Tuple[str, ...]
    # (segment index closed early, deferred-op count at the cap)
    overflows: Tuple[Tuple[int, int], ...]
    exec_step: Dict[str, int]

    def summary(self) -> Dict[str, object]:
        """Machine-readable schedule shape (prancer ``--schedule``)."""
        return {
            "role": self.role,
            "steps": len(self.steps),
            "segments": [
                {
                    "index": seg.index,
                    "ops": len(seg.names),
                    "inputs": len(seg.in_names),
                    "outputs": len(seg.out_names),
                    "validatable": seg.validatable,
                }
                for seg in self.segments
            ],
            "receives": len(self.recv_names),
            "deferred_flushes": [
                {"segment": si, "deferred": n} for si, n in self.overflows
            ],
            "send_groups": [
                list(payload) for kind, payload in self.steps
                if kind == "sends"
            ],
        }


def build_role_schedule(
    comp: Computation,
    role: str,
    order: Optional[Sequence[str]] = None,
    limit: Optional[int] = None,
    min_seg: Optional[int] = None,
    max_deferred: int = MAX_DEFERRED,
) -> RoleSchedule:
    """Reconstruct ``role``'s worker plan from the segmentation rules —
    the single source of truth shared with ``worker_plan.RolePlan``, so
    what the analyzer proves is what the worker runs.  ``order`` is the
    shared global linearization (defaults to ``comp.toposort_names()``,
    which every worker derives identically from the same bytes)."""
    from ...execution.interpreter import plan_segments

    if order is None:
        order = comp.toposort_names()
    if limit is None:
        limit = _segment_limit()
    if min_seg is None:
        min_seg = worker_min_seg()
    mine = [
        n for n in order
        if comp.placement_of(comp.operations[n]).name == role
    ]

    chunks: List[List[str]] = []
    steps: List[Step] = []
    chunk: List[str] = []
    pre: List[str] = []
    post: List[str] = []
    overflows: List[Tuple[int, int]] = []

    def flush_post() -> None:
        """Emit deferred ops, grouping consecutive Sends into one flush
        group (the async sender coalesces each group per receiver)."""
        group: List[str] = []
        for n in post:
            if comp.operations[n].kind == "Send":
                group.append(n)
                continue
            if group:
                steps.append(("sends", tuple(group)))
                group = []
            steps.append(("op", n))
        if group:
            steps.append(("sends", tuple(group)))

    def close(overflow: bool = False) -> None:
        nonlocal chunk, pre, post
        for n in pre:
            steps.append(("op", n))
        if chunk:
            chunks.append(chunk)
            steps.append(("seg", len(chunks) - 1))
            if overflow:
                overflows.append((len(chunks) - 1, len(post)))
        flush_post()
        chunk, pre, post = [], [], []

    for n in mine:
        kind = comp.operations[n].kind
        if kind in HOISTABLE_KINDS:
            pre.append(n)
        elif kind in DEFERRABLE_KINDS:
            if not chunk:
                close()  # nothing to defer behind: flush hoisted ops
                if kind == "Send":
                    steps.append(("sends", (n,)))
                else:
                    steps.append(("op", n))
            else:
                post.append(n)
                if len(post) >= max_deferred:
                    close(overflow=True)
        elif kind in HOST_STEP_KINDS:  # hard: Receive/Load/Sample
            close()
            steps.append(("op", n))
        else:
            chunk.append(n)
            if len(chunk) >= limit:
                close()
    close()

    # boundary-dataflow analysis over the partial role graph: values
    # produced outside any chunk (Receives, host-boundary steps) are
    # external env inputs
    _, in_names, _ = plan_segments(
        mine, {}, lambda n: comp.operations[n].inputs, limit,
        chunks=chunks,
    )
    # a segment's outputs are the values ANY later consumer needs —
    # later segments (their in_names) or host-boundary steps
    # (Send/Save/Output/... inputs); plan_segments only sees chunk
    # consumers, so fold the boundary consumers in here
    needed = set()
    for ins in in_names:
        needed.update(ins)
    for n in mine:
        op = comp.operations[n]
        if op.kind in HOST_STEP_KINDS:
            needed.update(op.inputs)
    segments = tuple(
        SegmentPlan(
            index=si,
            names=tuple(names),
            in_names=tuple(in_names[si]),
            out_names=tuple(sorted(x for x in names if x in needed)),
            validatable=(
                len(names) >= min_seg
                and not any(
                    comp.operations[n].kind in DYNAMIC_SHAPE_KINDS
                    for n in names
                )
            ),
        )
        for si, names in enumerate(chunks)
    )

    exec_step: Dict[str, int] = {}
    for idx, (kind, payload) in enumerate(steps):
        if kind == "seg":
            for n in segments[int(str(payload))].names:
                exec_step[n] = idx
        elif kind == "sends":
            for n in payload:
                exec_step[str(n)] = idx
        else:
            exec_step[str(payload)] = idx

    return RoleSchedule(
        role=role,
        steps=tuple(steps),
        segments=segments,
        recv_names=tuple(
            n for n in mine if comp.operations[n].kind == "Receive"
        ),
        overflows=tuple(overflows),
        exec_step=exec_step,
    )


_reconstruct_cache: "weakref.WeakKeyDictionary[Computation, Dict[Tuple[int, int, int], Dict[str, RoleSchedule]]]" = (
    weakref.WeakKeyDictionary()
)


def reconstruct_schedules(
    comp: Computation,
    roles: Optional[Sequence[str]] = None,
    limit: Optional[int] = None,
    min_seg: Optional[int] = None,
    max_deferred: int = MAX_DEFERRED,
) -> Dict[str, RoleSchedule]:
    """Every role's reconstructed schedule over ONE shared global
    linearization (the cross-role wait graph is only meaningful when
    all schedules agree on the order, exactly as the workers do).

    All-role reconstructions are memoized weak-keyed on the computation
    (per resolved knob values): one ``analyze()`` run asks for the
    schedules from both the schedule and cost analyses, the worker plan
    gate asks again per session, and the walk is O(ops) pure Python —
    pay it once per graph."""
    resolved_limit = _segment_limit() if limit is None else limit
    if roles is not None:
        resolved = worker_min_seg() if min_seg is None else min_seg
        order = comp.toposort_names()
        return {
            role: build_role_schedule(
                comp, role, order=order, limit=resolved_limit,
                min_seg=resolved, max_deferred=max_deferred,
            )
            for role in roles
        }
    if min_seg is None:
        # default resolution is autotune-aware, TWO-PASS: build at the
        # env floor, decide from the segment histogram, rebuild only if
        # the floor lifts.  Resolving here (not in the worker) keeps the
        # MSA5xx analyzer, the MSA6xx cost model, fabric and prancer on
        # the SAME schedule the worker runs — predictions cannot drift.
        # Both passes hit the explicit-min_seg memo below.
        base = reconstruct_schedules(
            comp, limit=limit, min_seg=worker_min_seg(),
            max_deferred=max_deferred,
        )
        decision = worker_min_seg_decision(comp, base)
        if decision.choice == worker_min_seg():
            return base
        return reconstruct_schedules(
            comp, limit=limit, min_seg=decision.choice,
            max_deferred=max_deferred,
        )
    resolved_min = min_seg
    knobs = (resolved_limit, resolved_min, max_deferred)
    per_comp = _reconstruct_cache.get(comp)
    if per_comp is not None and knobs in per_comp:
        return per_comp[knobs]
    order = comp.toposort_names()
    schedules = {
        role: build_role_schedule(
            comp, role, order=order, limit=resolved_limit,
            min_seg=resolved_min, max_deferred=max_deferred,
        )
        for role in sorted({
            comp.placement_of(op).name
            for op in comp.operations.values()
        })
    }
    if per_comp is None:
        per_comp = _reconstruct_cache[comp] = {}
    per_comp[knobs] = schedules
    return schedules


def worker_min_seg_decision(comp: Computation, base=None):
    """The autotuned worker eager-floor decision for ``comp`` (a
    :class:`~moose_tpu_torch.compilation.autotune.Decision`): env
    override > segment-histogram heuristic > default.  ``base`` may
    carry the env-floor schedules to decide from (avoids a rebuild);
    without it they come from the memoized reconstruction.  Deterministic
    given (computation, env): every process resolves the same floor."""
    from .. import autotune

    if base is None:
        base = reconstruct_schedules(comp, min_seg=worker_min_seg())
    sizes = [
        len(seg.names)
        for sched in base.values()
        for seg in sched.segments
    ]
    return autotune.worker_min_seg_for(sizes)


def _analyzable(comp: Computation) -> bool:
    """Plans exist only for lowered, networked, host-only graphs; on
    anything else (single-role, pre-networking, composite placements)
    the schedule analysis is a documented no-op."""
    if not all(
        isinstance(plc, HostPlacement) for plc in comp.placements.values()
    ):
        return False
    return any(
        op.kind in ("Send", "Receive")
        for op in comp.operations.values()
    )


def analyze_schedule(comp: Computation) -> List[Diagnostic]:
    """MSA5xx entry point registered with :func:`analysis.analyze`."""
    if not _analyzable(comp):
        return []
    try:
        schedules = reconstruct_schedules(comp)
    except ValueError as e:
        # toposort rejected the graph (dataflow/rendezvous cycle):
        # there is no linearization to schedule, which IS the deadlock
        return [Diagnostic(
            "MSA501", Severity.ERROR,
            f"no consistent linearization exists to schedule: {e}",
        )]
    return analyze_schedules(comp, schedules)


def plan_errors(comp: Computation) -> List[Diagnostic]:
    """Error-severity schedule findings only — the worker-side
    build-time gate (``worker_plan.get_plan`` rejects plans on these
    and falls back to the legacy eager scheduler)."""
    return [
        d for d in analyze_schedule(comp)
        if d.severity >= Severity.ERROR
    ]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def analyze_schedules(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
) -> List[Diagnostic]:
    """Run every MSA5xx rule over explicit schedules.  Public so tests
    (and future planners) can check hand-built plans that the
    by-construction-safe reconstruction could never produce."""
    diagnostics: List[Diagnostic] = []
    diagnostics.extend(_check_wait_graph(comp, schedules))
    diagnostics.extend(_check_overflows(comp, schedules))
    diagnostics.extend(_check_use_before_arrival(comp, schedules))
    diagnostics.extend(_check_boundary_straddle(comp, schedules))
    return diagnostics


def _check_wait_graph(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
) -> List[Diagnostic]:
    """MSA501: fixed point of the cross-role wait graph.

    Model: each role executes its step list strictly sequentially; only
    a Receive step blocks, and it completes when ONE payload of its
    rendezvous key has been flushed by a completed Send step and not
    already consumed by another Receive (single-delivery cell-store
    semantics: a session never refills a consumed key).  Send flushes —
    deferred, coalesced, or immediate — never block, so a step
    completes as soon as its role predecessor and (for receives) its
    payload are available.  Any step the fixed point cannot complete is
    a would-hang, reported with the blocking chain."""
    ops = comp.operations
    # rendezvous key -> send op names / receive (role, step, op name)
    sends_of: Dict[str, List[str]] = {}
    recvs_of: Dict[str, List[Tuple[str, int, str]]] = {}
    send_role_step: Dict[str, Tuple[str, int]] = {}
    for role, sched in schedules.items():
        for name in sched.exec_step:
            op = ops[name]
            key = op.attributes.get("rendezvous_key")
            if not isinstance(key, str):
                continue  # malformed attributes are MSA203's domain
            if op.kind == "Send":
                sends_of.setdefault(key, []).append(name)
                send_role_step[name] = (role, sched.exec_step[name])
            elif op.kind == "Receive":
                recvs_of.setdefault(key, []).append(
                    (role, sched.exec_step[name], name)
                )

    # single delivery: the first-scheduled receive of a key is the one
    # the payload can serve; later receives of the same key are
    # unsatisfiable by construction (the cell store drops duplicate
    # deliveries of consumed keys)
    serviceable: Dict[str, Tuple[str, int, str]] = {}
    oversubscribed: List[Tuple[str, int, str, str]] = []
    for key, recvs in recvs_of.items():
        ranked = sorted(recvs, key=lambda r: (r[1], r[0]))
        serviceable[key] = ranked[0]
        for role, step, name in ranked[1:]:
            oversubscribed.append((role, step, name, key))

    pointer = {role: 0 for role in schedules}
    done_sends: Set[str] = set()

    def _recv_ready(role: str, name: str) -> bool:
        key = ops[name].attributes.get("rendezvous_key")
        if not isinstance(key, str):
            return True  # not modellable here; MSA203 reports it
        if serviceable.get(key, (None,))[0] != role or \
                serviceable[key][2] != name:
            return False  # oversubscribed: payload serves another wait
        return any(s in done_sends for s in sends_of.get(key, ()))

    progressed = True
    while progressed:
        progressed = False
        for role, sched in schedules.items():
            while pointer[role] < len(sched.steps):
                kind, payload = sched.steps[pointer[role]]
                if (
                    kind == "op"
                    and ops[str(payload)].kind == "Receive"
                    and not _recv_ready(role, str(payload))
                ):
                    break
                if kind == "sends":
                    done_sends.update(str(n) for n in payload)
                elif kind == "op" and ops[str(payload)].kind == "Send":
                    done_sends.add(str(payload))
                pointer[role] += 1
                progressed = True

    stuck = {
        role: sched.steps[pointer[role]]
        for role, sched in schedules.items()
        if pointer[role] < len(sched.steps)
    }
    if not stuck and not oversubscribed:
        return []

    diagnostics: List[Diagnostic] = []
    for role, step, name, key in sorted(oversubscribed):
        winner = serviceable[key]
        diagnostics.append(Diagnostic(
            "MSA501", Severity.ERROR,
            f"rendezvous key {key!r} is oversubscribed: its single "
            f"payload serves {winner[2]!r} on {winner[0]!r}, so this "
            f"wait can never be satisfied (the cell store drops "
            f"duplicate deliveries of consumed keys)",
            op=name, placement=role,
        ))

    already = {name for _, _, name, _ in oversubscribed}
    seen_chains: Set[Any] = set()
    for role in sorted(stuck):
        kind, payload = stuck[role]
        if kind != "op" or ops[str(payload)].kind != "Receive":
            continue  # blocked transitively behind this role's receive
        if str(payload) in already:
            continue  # the oversubscription diagnostic already says why
        chain = _blocking_chain(
            comp, schedules, pointer, sends_of, role, str(payload)
        )
        signature = frozenset(chain)
        if signature in seen_chains:
            continue
        seen_chains.add(signature)
        key = ops[str(payload)].attributes.get("rendezvous_key")
        if not sends_of.get(key or ""):
            detail = f"no Send in any role's schedule flushes key {key!r}"
        else:
            detail = "blocking chain " + " <- ".join(
                f"{r}:{n}" for r, n in chain
            )
        diagnostics.append(Diagnostic(
            "MSA501", Severity.ERROR,
            f"the sequential orchestrator would hang: receive "
            f"{payload!r} (key {key!r}) can never be served; {detail}",
            op=str(payload), placement=role,
        ))
    return diagnostics


def _blocking_chain(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
    pointer: Dict[str, int],
    sends_of: Dict[str, List[str]],
    role: str,
    recv_name: str,
) -> List[Tuple[str, str]]:
    """Readable who-waits-on-whom path from one stuck receive: follow
    its key to a blocked sender role, then to THAT role's stuck
    receive, until a node repeats."""
    chain: List[Tuple[str, str]] = []
    seen: Set[Tuple[str, str]] = set()
    current: Optional[Tuple[str, str]] = (role, recv_name)
    while current is not None and current not in seen:
        seen.add(current)
        chain.append(current)
        r, name = current
        key = comp.operations[name].attributes.get("rendezvous_key")
        current = None
        for send in sends_of.get(key or "", ()):
            for peer, sched in schedules.items():
                step = sched.exec_step.get(send)
                if step is None or pointer[peer] >= len(sched.steps):
                    continue
                if step >= pointer[peer]:
                    stuck_kind, stuck_payload = sched.steps[pointer[peer]]
                    if stuck_kind == "op" and comp.operations[
                        str(stuck_payload)
                    ].kind == "Receive":
                        current = (peer, str(stuck_payload))
                    break
            if current is not None:
                break
    return chain


def _check_overflows(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
) -> List[Diagnostic]:
    """MSA502: the deferred-send cap forced an early segment split."""
    diagnostics: List[Diagnostic] = []
    for role in sorted(schedules):
        for seg_index, count in schedules[role].overflows:
            seg = schedules[role].segments[seg_index]
            diagnostics.append(Diagnostic(
                "MSA502", Severity.WARNING,
                f"deferred-send overflow: {count} value-consuming host "
                f"ops queued behind segment {seg_index} "
                f"({len(seg.names)} ops) hit the cap of {MAX_DEFERRED} "
                f"and forced an early segment split",
                op=seg.names[-1] if seg.names else None,
                placement=role,
            ))
    return diagnostics


def _check_use_before_arrival(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
) -> List[Diagnostic]:
    """MSA503: a step consumes a value whose producing step comes later
    in the same role's schedule (for Receives: the payload arrives in a
    later step than its first use)."""
    diagnostics: List[Diagnostic] = []
    for role in sorted(schedules):
        sched = schedules[role]
        for idx, (kind, payload) in enumerate(sched.steps):
            if kind == "seg":
                consumer = f"segment {payload}"
                inputs = sched.segments[int(str(payload))].in_names
                anchor = sched.segments[int(str(payload))].names[0]
            elif kind == "sends":
                consumer = f"send group {list(payload)}"
                inputs = tuple(
                    i for n in payload
                    for i in comp.operations[str(n)].inputs
                )
                anchor = str(payload[0])
            else:
                consumer = f"op {payload!r}"
                inputs = tuple(comp.operations[str(payload)].inputs)
                anchor = str(payload)
            for i in inputs:
                produced_at = sched.exec_step.get(i)
                if produced_at is None or produced_at <= idx:
                    continue
                producer_kind = comp.operations[i].kind
                what = (
                    "its Receive wait"
                    if producer_kind == "Receive"
                    else f"its producing {producer_kind} step"
                )
                diagnostics.append(Diagnostic(
                    "MSA503", Severity.ERROR,
                    f"{consumer} at step {idx} consumes {i!r} but "
                    f"{what} is scheduled later (step {produced_at}); "
                    f"the orchestrator would read an absent value",
                    op=anchor, placement=role,
                ))
    return diagnostics


def _check_boundary_straddle(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
) -> List[Diagnostic]:
    """MSA504: a jit-candidate segment consumes values produced by
    always-eager sliver segments — every such input crosses the
    host/device boundary per evaluation."""
    diagnostics: List[Diagnostic] = []
    for role in sorted(schedules):
        sched = schedules[role]
        produced_in: Dict[str, SegmentPlan] = {}
        for seg in sched.segments:
            for n in seg.names:
                produced_in[n] = seg
        for seg in sched.segments:
            if not seg.validatable:
                continue
            eager_inputs = [
                i for i in seg.in_names
                if i in produced_in and not produced_in[i].validatable
            ]
            if eager_inputs:
                diagnostics.append(Diagnostic(
                    "MSA504", Severity.INFO,
                    f"segment {seg.index} ({len(seg.names)} ops) is a "
                    f"jit candidate but {len(eager_inputs)} of its "
                    f"inputs come from always-eager sliver segments "
                    f"(first: {eager_inputs[0]!r}); each crosses the "
                    f"host/device boundary every evaluation",
                    op=seg.names[0], placement=role,
                ))
    return diagnostics


def analyze_fabric_schedules(
    comp: Computation,
    schedules: Dict[str, RoleSchedule],
    fabric_parties: FrozenSet[str],
) -> List[Diagnostic]:
    """MSA505: deadlock-freedom of the FABRIC-lowered schedule.

    When both endpoints of an edge are members of one
    :class:`~moose_tpu.distributed.fabric.FabricDomain`, the transfer is
    a collective permute on a shared device fabric instead of a buffered
    wire frame.  That is a stronger execution model than the one MSA501
    proves: collectives on one fabric edge retire in launch order, a
    coalesced flush group is ONE batched program (all payloads or
    none), and under the ``colocated_tee`` trust model both endpoint
    parties must issue matching collectives in the same order.  The
    fabric therefore refuses any schedule it cannot prove under three
    rules, each reported as an ``MSA505`` error (the runtime falls back
    to the wire on rejection — fallback is graceful, entering an
    unprovable collective schedule is not):

    1. the MSA501 wait-graph fixed point must already hold (a schedule
       the wire would hang on is certainly not fabric-safe);
    2. no two intra-fabric Sends may share a rendezvous key — a second
       permute program racing into a consumed rendezvous cell is a
       silent payload loss, where the wire's duplicate frame is merely
       dropped;
    3. per fabric edge (sender party -> receiver party), the receiver's
       wait order must not invert the sender's flush order for any key
       pair — inverted collectives on one ordered channel are the
       classic issue-order deadlock.

    Public and pure over explicit ``schedules`` so tests can hand the
    rule schedules the by-construction-safe reconstruction could never
    produce (the plan-build-time gate in ``FabricNetworking.
    prepare_fabric`` calls this with the worker's reconstructed
    schedules)."""
    if not _analyzable(comp):
        return []
    fabric_parties = frozenset(fabric_parties)
    ops = comp.operations
    diagnostics: List[Diagnostic] = []

    def _receiver_of(name: str) -> Optional[str]:
        return ops[name].attributes.get("receiver")

    # rule 1: the wire fixed point, re-coded — the fabric gate runs at
    # plan-build time per session and must reject on its own authority
    for d in _check_wait_graph(comp, schedules):
        diagnostics.append(Diagnostic(
            "MSA505", Severity.ERROR,
            "fabric lowering refused: the underlying wait graph is "
            f"already unsatisfiable — {d.message}",
            op=d.op, placement=d.placement,
        ))

    # rule 2: duplicate intra-fabric sends on one rendezvous key
    fabric_sends: Dict[str, List[str]] = {}
    for role, sched in schedules.items():
        if role not in fabric_parties:
            continue
        for name in sched.exec_step:
            op = ops[name]
            if op.kind != "Send":
                continue
            key = op.attributes.get("rendezvous_key")
            receiver = _receiver_of(name)
            if isinstance(key, str) and receiver in fabric_parties:
                fabric_sends.setdefault(key, []).append(name)
    for key, names in sorted(fabric_sends.items()):
        if len(names) > 1:
            diagnostics.append(Diagnostic(
                "MSA505", Severity.ERROR,
                f"rendezvous key {key!r} has {len(names)} intra-fabric "
                f"Sends ({sorted(names)}); a second collective permute "
                "racing into a consumed rendezvous cell is a silent "
                "payload loss on the fabric",
                op=sorted(names)[1],
            ))

    # rule 3: per-edge launch-order consistency.  Flush order = the
    # order send steps complete in the sender's schedule ("sends"
    # groups flush in payload order); wait order = the receiver's
    # receive steps in step order.
    flush_order: Dict[Tuple[str, str], List[str]] = {}
    wait_order: Dict[Tuple[str, str], List[str]] = {}
    for role, sched in schedules.items():
        if role not in fabric_parties:
            continue
        for kind, payload in sched.steps:
            names: Sequence[str]
            if kind == "sends":
                names = [str(n) for n in payload]
            elif kind == "op" and ops[str(payload)].kind in (
                "Send", "Receive"
            ):
                names = [str(payload)]
            else:
                continue
            for name in names:
                op = ops[name]
                key = op.attributes.get("rendezvous_key")
                if not isinstance(key, str):
                    continue
                if op.kind == "Send":
                    receiver = _receiver_of(name)
                    if receiver in fabric_parties:
                        flush_order.setdefault(
                            (role, str(receiver)), []
                        ).append(key)
                else:
                    sender = op.attributes.get("sender")
                    if sender in fabric_parties:
                        wait_order.setdefault(
                            (str(sender), role), []
                        ).append(key)
    for edge in sorted(set(flush_order) & set(wait_order)):
        flushed = flush_order[edge]
        flush_pos = {k: i for i, k in enumerate(flushed)}
        waited = [k for k in wait_order[edge] if k in flush_pos]
        for a, b in zip(waited, waited[1:]):
            if flush_pos[a] > flush_pos[b]:
                diagnostics.append(Diagnostic(
                    "MSA505", Severity.ERROR,
                    f"fabric edge {edge[0]}->{edge[1]}: receiver waits "
                    f"key {a!r} before {b!r} but the sender launches "
                    f"their permutes in the opposite order; inverted "
                    "collectives on one ordered channel are an "
                    "issue-order deadlock",
                    placement=edge[1],
                ))
                break  # one inversion per edge is enough to reject
    return diagnostics


RULES = {
    "MSA501": "unsatisfiable wait in the segment-level plan (sequential "
              "orchestrator would hang: wait cycle, blocked or missing "
              "sender, or oversubscribed rendezvous key)",
    "MSA502": "deferred-send overflow: >MAX_DEFERRED host ops behind one "
              "segment forced an early split",
    "MSA503": "value consumed at a step before the step that produces "
              "it (receive arrives later than first use)",
    "MSA504": "jit-candidate segment consumes always-eager sliver-"
              "segment outputs (host/device crossing per input)",
    "MSA505": "fabric-lowered schedule not provably deadlock-free "
              "(unsatisfiable wait graph, duplicate intra-fabric "
              "rendezvous key, or inverted per-edge collective launch "
              "order); the fabric transport falls back to the wire",
}
