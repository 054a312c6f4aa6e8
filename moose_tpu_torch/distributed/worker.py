"""Role-filtered parallel execution of a lowered computation on one worker.

The port's own copy of ``moose_tpu/distributed/worker.py``: one worker's
host ops run on its ``device`` (the card unless the caller asks for the
CPU) through the physical executor's kernels
(``execution.physical.execute_kernel`` on an ``EagerSession``): a host
ring Dot launches K1 (product-only), a host ring Mul K4 and each
SampleSeeded one K7 draw.  Under ``MOOSE_TPU_FIXED_KEYS`` a worker
derives its PRF keys as the JAX package's worker does (blake2b of
``fixed|identity|op name``), so its words equal the JAX worker's.

The distributed counterpart of the local physical executor: each worker
takes the same global host-level graph and keeps only the operations
pinned to its own identity.  With the fast path on (the default, as in
the JAX package) it runs them through its compiled role plan
(:mod:`worker_plan`: validated segments, CUDA graphs on the card);
without it, or where the analyzers reject the plan, it runs them with
the dependency-counted parallelism of :func:`execute_role_legacy` — the
re-design of the reference's one-async-task-per-op executor
(execution/asynchronous.rs:453-531) for Python threads:

- compute/send ops run on a bounded thread pool (torch/numpy release
  the GIL for the heavy parts, so independent branches genuinely overlap);
- every Receive gets its own waiter thread, so a blocked receive can
  never occupy a compute slot.

Deadlock freedom: receives don't hold pool slots, compute ops depend only
on locally-available values, and sends are non-blocking w.r.t. the
rendezvous (the receiver's cell store buffers out-of-order arrivals), so
the pool always drains; for any blocked receive the matching send is on
some peer whose own pool drains by the same argument — induction over the
global dataflow order.

Failure discipline: the FIRST exception is the root cause (reference
join_on_first_error, execution/asynchronous.rs:27-74).  It cancels every
in-flight and pending op of the session locally and is re-raised to the
caller; the choreography layer then fans the abort out to peer workers.
A ``SessionAbortedError`` (we were cancelled by someone else's root
cause) is re-raised as-is so the caller knows not to re-fan-out.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..computation import Computation, HostPlacement
from ..errors import (
    KernelError,
    MissingArgumentError,
    SessionAbortedError,
    StorageError,
)
from ..execution.physical import _lift_boundary, execute_kernel
from ..execution.session import EagerSession
from ..values import HostPrfKey, HostString, HostUnit


def _pool_size() -> int:
    raw = os.environ.get("MOOSE_TPU_WORKER_THREADS")
    if raw:
        from ..errors import ConfigurationError

        try:
            n = int(raw)
        except ValueError as e:
            raise ConfigurationError(
                f"MOOSE_TPU_WORKER_THREADS must be an integer >= 1, "
                f"got {raw!r}"
            ) from e
        if n < 1:
            raise ConfigurationError(
                f"MOOSE_TPU_WORKER_THREADS must be >= 1, got {n}"
            )
        return n
    # floor of 2 even on 1-core hosts: torch/numpy/serde release the GIL,
    # so a second thread overlaps wire serialization with compute
    return max(2, min(8, os.cpu_count() or 4))


class _AnyEvent:
    """is_set() over several events — lets a receive slice on both the
    external abort (choreographer/peer) and the local first-error."""

    def __init__(self, *events):
        self._events = [e for e in events if e is not None]

    def is_set(self) -> bool:
        return any(e.is_set() for e in self._events)


def _fixed_key_words(fixed: str, identity: str, name: str) -> tuple:
    """The JAX package's worker key under ``MOOSE_TPU_FIXED_KEYS``:
    blake2b of ``fixed|identity|op name``, four little-endian u32."""
    import hashlib

    digest = hashlib.blake2b(
        f"{fixed}|{identity}|{name}".encode(), digest_size=16,
    ).digest()
    return tuple(int(w) for w in np.frombuffer(digest, dtype=np.uint32))


def _exec_host_op(op, env: dict, identity: str, arguments: dict,
                  storage, outputs: dict, sess: EagerSession):
    """Execute one host-boundary op (Input/Load/Save/Output/PrfKeyGen)
    eagerly on ``sess``'s device — shared by the legacy parallel
    scheduler and the planned one (worker_plan), so argument lifting,
    storage discipline and the fixed-keys gate cannot drift between
    them."""
    from ..execution.interpreter import _save_user_value, _to_user_value

    kind = op.kind
    if kind == "PrfKeyGen":
        fixed = os.environ.get("MOOSE_TPU_FIXED_KEYS")
        if fixed:
            # TEST-ONLY determinism: reproducible keys for bit-exact
            # comparisons (a retry against its first attempt, the port's
            # worker against the JAX package's).  Gated like the weak
            # default PRF: a real deployment must never run with
            # derivable keys.
            if os.environ.get("MOOSE_TPU_ALLOW_WEAK_PRF") != "1":
                from ..errors import ConfigurationError

                raise ConfigurationError(
                    "MOOSE_TPU_FIXED_KEYS is a testing knob and "
                    "requires MOOSE_TPU_ALLOW_WEAK_PRF=1 — fixed "
                    "PRF keys void all inter-party secrecy"
                )
            words = _fixed_key_words(fixed, identity, op.name)
        else:
            # each party generates its own key from local entropy —
            # this is where the distributed deployment gets real
            # inter-party security, unlike the single-trust-domain
            # local runtime
            words = tuple(int(w) for w in np.frombuffer(
                secrets.token_bytes(16), dtype=np.uint32))
        return HostPrfKey(words, identity, origin=op.name)
    if kind == "Input":
        val = arguments.get(op.name)
        if val is None:
            raise MissingArgumentError(
                f"missing argument {op.name!r} on {identity}"
            )
        if isinstance(val, str):
            return HostString(val, identity)
        return _lift_boundary(np.asarray(val), op, identity, sess.device)
    if kind == "Load":
        key_val = env[op.inputs[0]]
        key = (
            key_val.value
            if isinstance(key_val, HostString)
            else str(key_val)
        )
        query = ""
        if len(op.inputs) > 1:
            q = env[op.inputs[1]]
            query = q.value if isinstance(q, HostString) else str(q)
        if key not in storage:
            raise StorageError(
                f"no value for key {key!r} in storage of {identity!r}"
            )
        if hasattr(storage, "load"):
            raw = storage.load(key, query)
        else:
            raw = storage[key]
        return _lift_boundary(np.asarray(raw), op, identity, sess.device)
    if kind == "Save":
        key = env[op.inputs[0]]
        if not isinstance(key, HostString):
            raise KernelError(
                f"Save {op.name}: key must be a string, found "
                f"{type(key).__name__}"
            )
        storage[key.value] = _save_user_value(sess, env[op.inputs[1]])
        return HostUnit(identity)
    if kind == "Output":
        value = env[op.inputs[0]]
        # keyed by the Output tag like the local executors and the
        # reference (execution/asynchronous.rs:623)
        outputs[op.attributes.get("tag", op.name)] = _to_user_value(
            sess, value)
        return value
    raise KernelError(f"not a host-boundary op: {kind} ({op.name})")


def validate_deployable(comp: Computation) -> None:
    """Reject graphs that would fail opaquely mid-run: composite
    placements (lowering skipped) and raw cross-host edges (networking
    pass skipped)."""
    composite = [
        plc.name for plc in comp.placements.values()
        if not isinstance(plc, HostPlacement)
    ]
    if composite:
        raise KernelError(
            "worker received an uncompiled computation (composite "
            f"placements {composite}); compile it first — e.g. "
            "`elk compile --passes typing,lowering,prune,networking,"
            "toposort`"
        )
    for op in comp.operations.values():
        plc_name = comp.placement_of(op).name
        for inp in op.inputs:
            src = comp.operations[inp]
            if (
                comp.placement_of(src).name != plc_name
                and op.kind != "Receive"
            ):
                raise KernelError(
                    f"op {op.name} on {plc_name} reads {inp} from "
                    f"{comp.placement_of(src).name} without a "
                    "Send/Receive pair; run the `networking` compiler "
                    "pass before deploying"
                )


def _begin_role(comp: Computation, networking, session_id: str, device,
                progress):
    """What every scheduler does before a role's first op: the PRF gate,
    the device (None takes the networking backend's), the deployability
    check and the fabric's plan; returns (device, progress clock)."""
    # genuinely-distributed parties must not derive share masks from the
    # non-cryptographic default PRF (the client runtime guards too, but
    # workers execute whatever arrives)
    from ..dialects.ring import require_strong_prf

    require_strong_prf("distributed worker")

    from .networking import ProgressClock

    if device is None:
        device = getattr(networking, "device", None)
    if device is None:
        from .. import devices

        device = devices.resolve()
    validate_deployable(comp)
    # fabric transports resolve this computation's rendezvous keys to
    # permute schedules at plan-build time (MSA505 deadlock gate; a
    # rejected computation is latched wire-only for the session) —
    # delegates through proxy transports like ChaosNetworking
    prepare_fabric = getattr(networking, "prepare_fabric", None)
    if prepare_fabric is not None:
        prepare_fabric(comp, session_id)
    if progress is None:
        progress = ProgressClock()
    return device, progress


def execute_role(
    comp: Computation,
    identity: str,
    storage: dict,
    arguments: Optional[dict],
    networking,
    session_id: str,
    timeout: float = 120.0,
    cancel=None,
    max_workers: Optional[int] = None,
    progress=None,
    device=None,
) -> dict:
    """Execute ``identity``'s share of a lowered computation; returns
    {"outputs": {...}, "elapsed_time_micros": int, "plan_mode": str,
    "pinned_segments": [...]}, the reference's result keys.

    With ``worker_plan.use_fast_path()`` (the JAX package's verdict from
    ``MOOSE_TPU_WORKER_JIT``, ``MOOSE_TPU_JIT``, the self-check and the
    PRF) the role runs through its compiled plan (:mod:`worker_plan`):
    the role subgraph splits at Send/Receive boundaries into compute
    segments, each validated against its eager run on the plan's first
    sessions and then replayed as a CUDA graph on the card (run
    uncaptured on the CPU), sends go async and coalesce, receives
    prefetch; ``plan_mode`` is ``"validating"``, then ``"segmented"``
    or ``"full-jit"`` (``"eager"`` where nothing is jittable), and
    ``pinned_segments`` lists the segments that diverged.  Without it,
    or where the schedule or keystream analyzer rejects the plan
    (``PlanRejectedError``), the role runs on the dependency-counted
    scheduler of :func:`execute_role_legacy` (``plan_mode`` "eager").

    ``cancel``: optional ``threading.Event`` — a set event (choreographer
    abort or peer-failure fanout) stops pending ops and interrupts
    blocked receives promptly; the run raises ``SessionAbortedError``.

    ``progress``: optional :class:`~.networking.ProgressClock`.  Receives
    time out ``timeout`` seconds after the LAST progress (local op
    completion, or whatever else the caller bumps it on — the gRPC
    worker bumps it on successful peer pings), not after dispatch: the
    schedulers start every receive waiter up front, so a fixed deadline
    would kill any pipeline whose upstream takes longer than ``timeout``
    to produce.

    ``device``: where this worker's tensors live; None takes the
    networking backend's ``device`` (the card unless its caller asked
    for the CPU).
    """
    from ..errors import PlanRejectedError
    from . import worker_plan

    t0 = time.perf_counter()
    arguments = arguments or {}
    device, progress = _begin_role(comp, networking, session_id, device,
                                   progress)
    if worker_plan.use_fast_path():
        try:
            plan = worker_plan.get_plan(comp, identity,
                                        session_id=session_id, device=device)
        except PlanRejectedError as e:
            from ..logger import get_logger

            # the analyzer proved the sequential plan would hang (or its
            # keys mis-wired); the dependency-driven scheduler is not
            # subject to the plan's step ordering, so demote instead of
            # failing the session
            get_logger().warning(
                "worker plan for %s rejected by the schedule analyzer; "
                "falling back to the legacy eager scheduler: %s",
                identity, e,
            )
        else:
            return worker_plan.execute_role_planned(
                comp, identity, storage, arguments, networking,
                session_id, timeout, cancel, progress, plan, device,
            )
    return _run_legacy(comp, identity, storage, arguments, networking,
                       session_id, timeout, cancel, max_workers,
                       progress, device, t0)


def execute_role_legacy(
    comp: Computation,
    identity: str,
    storage: dict,
    arguments: Optional[dict],
    networking,
    session_id: str,
    timeout: float = 120.0,
    cancel=None,
    max_workers: Optional[int] = None,
    progress=None,
    device=None,
) -> dict:
    """:func:`execute_role` on the legacy dependency-counted scheduler
    alone, whatever the knobs and the plan: the route without the fast
    path or with a rejected plan, and the scheduler the parity tests
    hold against the planned one.  Same arguments and result."""
    t0 = time.perf_counter()
    device, progress = _begin_role(comp, networking, session_id, device,
                                   progress)
    return _run_legacy(comp, identity, storage, arguments or {},
                       networking, session_id, timeout, cancel,
                       max_workers, progress, device, t0)


def _run_legacy(comp: Computation, identity: str, storage: dict,
                arguments: dict, networking, session_id: str,
                timeout: float, cancel, max_workers: Optional[int],
                progress, device, t0: float) -> dict:
    """The legacy scheduler: every op of the role on a bounded pool as
    its inputs arrive, each Receive on a poller or a waiter thread."""
    sess = EagerSession(device, session_id=session_id)
    env: dict = {}
    outputs: dict = {}

    def exec_one(op):
        """Run one op to a value; called off-thread, must not touch
        scheduler state."""
        kind = op.kind
        if kind == "Send":
            networking.send(
                env[op.inputs[0]],
                op.attributes["receiver"],
                op.attributes["rendezvous_key"],
                session_id,
            )
            from .. import flight

            flight.record(
                "send", party=identity, session=session_id,
                receiver=op.attributes["receiver"], payloads=1,
                coalesced=False,
            )
            return HostUnit(identity)
        if kind == "Receive":
            return networking.receive(
                op.attributes["sender"],
                op.attributes["rendezvous_key"],
                session_id,
                plc=identity,
                timeout=timeout,
                cancel=abort_any,
                progress=progress,
            )
        if kind in ("PrfKeyGen", "Input", "Load", "Save", "Output"):
            return _exec_host_op(
                op, env, identity, arguments, storage, outputs, sess
            )
        args = [env[i] for i in op.inputs]
        return execute_kernel(sess, op, identity, args)

    # ---- dependency-counted scheduler --------------------------------
    mine = [
        comp.operations[name]
        for name in comp.toposort_names()
        if comp.placement_of(comp.operations[name]).name == identity
    ]
    local_abort = threading.Event()
    abort_any = _AnyEvent(cancel, local_abort)

    if not mine:
        return {
            "outputs": {}, "elapsed_time_micros": 0,
            "plan_mode": "eager", "pinned_segments": [],
        }

    pending: dict = {}
    dependents: dict = {name: [] for name in (op.name for op in mine)}
    for op in mine:
        if op.kind == "Receive":
            # a Receive's inputs live on the sender's host; the value
            # arrives through the rendezvous store, not the local env
            local = []
        else:
            local = [i for i in op.inputs if i in dependents]
        pending[op.name] = len(local)
        for i in local:
            dependents[i].append(op.name)
    by_name = {op.name: op for op in mine}

    from concurrent.futures import ThreadPoolExecutor

    lock = threading.Lock()
    done = threading.Event()
    remaining = [len(mine)]
    failure: list = []  # [exception] — first error wins

    def fail(exc: BaseException) -> None:
        with lock:
            if not failure:
                failure.append(exc)
        local_abort.set()
        done.set()

    n_compute = max_workers or _pool_size()
    from ..native import ring_kernels

    # the pool's threads count their launches into the launch tallies
    # open on the caller's thread (one role's launches, where several
    # roles run in one process)
    pool = ThreadPoolExecutor(
        max_workers=n_compute,
        thread_name_prefix=f"moose-{identity}",
        initializer=ring_kernels.adopt_tallies,
        initargs=(ring_kernels.thread_tallies(),),
    )

    def finish(name: str, ready_sink: Callable[[object], None]) -> None:
        progress.bump()
        newly_ready = []
        with lock:
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
            for dep in dependents[name]:
                pending[dep] -= 1
                if pending[dep] == 0:
                    newly_ready.append(by_name[dep])
        for op in newly_ready:
            ready_sink(op)

    # Receives: one POLLER thread probes every outstanding rendezvous via
    # the transport's non-blocking try_receive — thousands of receives
    # cost one thread, not one each (deadlock-free: receives never hold
    # compute slots, and the poller itself never blocks on any single
    # key).  Transports without try_receive (raw TCP) fall back to a
    # waiter thread per receive.
    pollable = hasattr(networking, "try_receive")
    recv_lock = threading.Lock()
    outstanding: dict = {}  # op name -> op, receives awaiting payload

    def poll_receives() -> None:
        get_act = getattr(networking, "activity_for", None)
        activity = get_act(session_id) if get_act is not None else None
        while not abort_any.is_set():
            if activity is not None:
                activity.clear()
            with recv_lock:
                items = list(outstanding.items())
            if not items:
                if done.is_set():
                    return
            arrived = []
            for name, op in items:
                try:
                    ok, val = networking.try_receive(
                        op.attributes["sender"],
                        op.attributes["rendezvous_key"],
                        session_id,
                        plc=identity,
                    )
                except BaseException as e:  # noqa: BLE001 — root cause
                    fail(e)
                    return
                if ok:
                    env[name] = val
                    with recv_lock:
                        outstanding.pop(name, None)
                    arrived.append(name)
            for name in arrived:
                finish(name, dispatch)
            if items and not arrived and (
                time.monotonic() > progress.last + timeout
            ):
                from ..errors import ReceiveTimeoutError

                keys = sorted(
                    op.attributes["rendezvous_key"] for _, op in items
                )[:4]
                fail(ReceiveTimeoutError(
                    f"receive timed out after {timeout}s of no session "
                    f"progress; {len(items)} pending (first keys "
                    f"{keys})"
                ))
                return
            if activity is not None:
                activity.wait(0.1)
            else:
                time.sleep(0.005)

    def dispatch(op) -> None:
        if abort_any.is_set():
            return  # the main wait loop polls the abort, not `done`
        if op.kind == "Receive":
            if pollable:
                with recv_lock:
                    outstanding[op.name] = op
                get_act = getattr(networking, "activity_for", None)
                if get_act is not None:
                    get_act(session_id).set()  # wake poller: new key
            else:
                # dedicated waiter thread: blocked receives must never
                # occupy compute slots (deadlock-freedom invariant)
                threading.Thread(
                    target=run_op, args=(op,), daemon=True,
                    name=f"moose-{identity}-recv-{op.name}",
                ).start()
        else:
            try:
                pool.submit(run_op, op)
            except RuntimeError:
                # raced an abort-triggered pool shutdown; the abort
                # outcome is already decided, just stop feeding it
                if not abort_any.is_set():
                    raise

    def run_op(op) -> None:
        try:
            env[op.name] = exec_one(op)
        except BaseException as e:  # noqa: BLE001 — root cause capture
            fail(e)
            return
        finish(op.name, dispatch)

    initial = [op for op in mine if pending[op.name] == 0]
    has_receives = any(op.kind == "Receive" for op in mine)
    poller = None
    # the eager scheduler's root span: adopts the session's propagated
    # TraceContext (installed by the worker server around this call) so
    # even the legacy path stitches into the client's distributed trace
    from .. import telemetry

    with telemetry.span(
        "execute_role", party=identity, ops=len(mine), plan_mode="eager",
    ):
        try:
            for op in initial:
                dispatch(op)
            if pollable and has_receives:
                poller = threading.Thread(
                    target=poll_receives, daemon=True,
                    name=f"moose-{identity}-recv-poller",
                )
                poller.start()
            # `done` fires on completion or local failure; an external
            # abort (choreographer / peer fanout) only sets its event, so
            # poll it — in-flight receives unwind via their own sliced
            # waits
            while not done.wait(0.1):
                if abort_any.is_set():
                    break
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    if failure:
        exc = failure[0]
        if cancel is not None and cancel.is_set() and not isinstance(
            exc, SessionAbortedError
        ):
            # the external abort raced our own error path: report it as
            # an abort so the caller doesn't re-fan-out
            raise SessionAbortedError(
                f"session {session_id} aborted"
            ) from exc
        raise exc
    if cancel is not None and cancel.is_set():
        raise SessionAbortedError(f"session {session_id} aborted")

    elapsed = int((time.perf_counter() - t0) * 1e6)
    return {
        "outputs": outputs, "elapsed_time_micros": elapsed,
        "plan_mode": "eager", "pinned_segments": [],
    }
