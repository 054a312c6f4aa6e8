"""Choreography: session orchestration across workers over gRPC.

The port's own copy of ``moose_tpu/distributed/choreography.py``: the
same rpc methods, msgpack payloads and failure discipline, so a port
worker and a JAX worker answer the same client.  A :class:`WorkerServer`
runs its role on ``device`` (the card unless the caller asks for the
CPU); on the card it builds the kernels a worker launches (K1, K4, K7)
before it accepts a session, so a first-use ``nvcc`` never stalls a
session its peers are waiting on.  A worker arms the deterministic chaos
layer (``chaos.py``) when given a ``ChaosConfig`` or ``MOOSE_TPU_CHAOS``,
and lowers its intra-domain edges to device copies when given a
``FabricDomain`` it belongs to (``fabric.py``).

Reference ``moose/src/choreography/grpc.rs:34-234`` +
``protos/choreography.proto``: LaunchComputation / RetrieveResults /
AbortComputation, with per-session result cells and duplicate-session
protection.  gRPC methods carry raw msgpack bytes (no protoc codegen
needed; the reference uses tonic+prost — the method *names* and semantics
match, the payload codec is msgpack like the rest of this framework).

Failure discipline (beyond the reference, whose abort handler is
``unimplemented!()``, choreography/grpc.rs:200-205):

- **abort fanout**: the first worker to hit a root-cause error aborts the
  session on every peer via a participant-level AbortSession rpc, so a
  3-party protocol fails fast everywhere instead of leaving two parties
  blocked in receives until timeout (the reference's
  ``join_on_first_error`` does this within one process,
  execution/asynchronous.rs:27-74; we extend it across workers);
- **failure detector**: while a session runs, each worker pings its peers;
  a peer that stops answering for ``ping_misses`` consecutive rounds
  fails the session locally and fans the abort out to the survivors — a
  killed worker is detected in ~``ping_misses * ping_interval`` seconds.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Optional

import msgpack

from ..errors import (
    NetworkingError,
    PeerUnreachableError,
    SessionAbortedError,
    SessionAlreadyExistsError,
    to_wire,
)
from .networking import GrpcNetworking, _CellStore

LAUNCH = "/moose.Choreography/LaunchComputation"
RETRIEVE = "/moose.Choreography/RetrieveResults"
ABORT = "/moose.Choreography/AbortComputation"
FLIGHT = "/moose.Choreography/GetFlight"
STORAGE_CONTROL = "/moose.Choreography/StorageControl"
SEND_VALUE = "/moose.Networking/SendValue"
ABORT_SESSION = "/moose.Networking/AbortSession"
PING = "/moose.Networking/Ping"


def _pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _unpack(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class _SessionState:
    """Book-keeping for one running session."""

    __slots__ = (
        "cancel", "finished", "peers", "abort_reason", "abort_envelope",
        "progress",
    )

    def __init__(self, peers):
        from .networking import ProgressClock

        self.cancel = threading.Event()
        # set once the run thread has posted the session's result: the
        # failure detector ends at once instead of a ping interval later
        self.finished = threading.Event()
        self.peers = list(peers)
        # set when the cancel came from outside (choreographer or peer
        # fanout) so the run thread records the root cause, not a bare
        # "aborted"; the envelope carries the TYPED root cause so the
        # client re-raises the real exception class
        self.abort_reason: Optional[str] = None
        self.abort_envelope: Optional[dict] = None
        # receives extend their deadline while this advances; bumped by
        # local op completions AND successful peer pings, so a party
        # idling while live peers crunch a long pipeline never times out
        self.progress = ProgressClock()


class WorkerServer:
    """One worker daemon: hosts the choreography service and the gRPC
    networking endpoint, executes its role of launched sessions in
    background threads (reference comet, bin/comet/comet.rs:12-83)."""

    def __init__(self, identity: str, port: int, endpoints: dict,
                 storage: Optional[dict] = None, tls=None,
                 choreographer: Optional[str] = None,
                 ping_interval: float = 0.5, ping_misses: int = 3,
                 startup_grace: float = 30.0,
                 receive_timeout: Optional[float] = None,
                 stall_grace: Optional[float] = None,
                 chaos=None, metrics_port: Optional[int] = None,
                 fabric_domain=None, device="cuda"):
        from .. import devices

        self.identity = identity
        # where this worker's tensors live (received values included)
        self.device = devices.resolve(device)
        self.port = port
        self.endpoints = dict(endpoints)
        self.storage = storage if storage is not None else {}
        self.tls = tls  # distributed.tls.TlsConfig or None
        # when set (requires tls), only a peer whose certificate CN equals
        # this name may launch/abort sessions (reference
        # choreography/grpc.rs:64-94 check_choreographer)
        self.choreographer = choreographer
        if choreographer is not None and tls is None:
            raise NetworkingError(
                "choreographer authorization requires a TlsConfig — "
                "without mTLS there is no verified peer identity"
            )
        # failure-detector cadence; interval <= 0 disables the detector.
        # startup_grace: how long an as-yet-never-reachable peer is
        # tolerated (workers may come up in any order); once a peer has
        # answered one ping, ping_misses consecutive failures trip.
        self.ping_interval = ping_interval
        self.ping_misses = ping_misses
        self.startup_grace = startup_grace
        # how long a blocked receive tolerates NO session progress
        # anywhere (local op completions or peer op advances) before it
        # fails retryably; env override for whole deployments
        if receive_timeout is None:
            import os

            receive_timeout = float(
                os.environ.get("MOOSE_TPU_RECEIVE_TIMEOUT", "120")
            )
        self.receive_timeout = receive_timeout
        # how long blocked receives tolerate live-but-NOT-advancing
        # peers beyond the last real op advance: one giant op (a huge
        # jit compile, a 200k-op segment) may legitimately exceed
        # receive_timeout with every count frozen, so extension
        # continues for this bounded budget — unlike the unbounded
        # liveness extension it replaces, a mutually-blocked cluster
        # (lost send) still times out at ~stall_grace + receive_timeout
        self.stall_grace = (
            2.0 * receive_timeout if stall_grace is None else stall_grace
        )
        import collections

        # chaos: explicit config, or MOOSE_TPU_CHAOS from the
        # environment (comet daemons pick the same schedule up without
        # new flags); None disables.  The transport is WRAPPED so every
        # send/ping of this worker flows through the fault schedule.
        from .chaos import ChaosConfig

        self.chaos = chaos if chaos is not None else ChaosConfig.from_env()
        networking = GrpcNetworking(
            identity, self.endpoints, tls=tls, device=self.device
        )
        # layering: wire -> fabric -> chaos.  The fabric lowers
        # intra-domain edges to device copies over the wire's cell
        # store; chaos stays outermost so fault decisions happen per
        # logical rendezvous key before the lowering (a dropped key
        # latches onto the wire for its replay)
        self.fabric_domain = fabric_domain
        if fabric_domain is not None and fabric_domain.is_member(identity):
            from .fabric import FabricNetworking

            networking = FabricNetworking(
                fabric_domain, identity, networking
            )
        if self.chaos is not None:
            self.chaos.register_kill_hook(identity, self._chaos_kill)
            networking = self.chaos.wrap(networking, identity)
        self.networking = networking
        self._sessions: dict = {}  # session id -> _SessionState (running)
        # every session's run and failure-detector threads not yet known
        # to have ended: stop() joins them
        self._threads: list = []
        # serialized-computation memo: repeat sessions of one computation
        # (serving traffic) must share ONE deserialized object, because
        # the worker's resolved role plans are weak-keyed on it — a
        # fresh object per launch would re-validate and re-jit every
        # session (same discipline as runtime._bin_cache)
        self._bin_cache: "collections.OrderedDict" = (
            collections.OrderedDict()
        )
        self._aborted: "collections.deque[str]" = collections.deque()
        # aborted session -> root-cause envelope, served through pings:
        # a peer that missed the abort fanout adopts the abort WITH its
        # typed cause instead of a generic retryable SessionAborted
        self._abort_envelopes: dict = {}
        self._completed: "collections.deque[str]" = collections.deque()
        self._results = _CellStore()
        self._lock = threading.Lock()
        self._server = None
        # HTTP metrics/health exposition (GET /metrics Prometheus text,
        # /healthz, /v1/metrics JSON) — explicit kwarg wins, else
        # MOOSE_TPU_METRICS_PORT (0 = ephemeral), else disabled
        self._metrics_port_from_env = False
        if metrics_port is None:
            import os

            raw = os.environ.get("MOOSE_TPU_METRICS_PORT")
            if raw is not None and raw.strip() != "":
                try:
                    metrics_port = int(raw)
                except ValueError as e:
                    raise NetworkingError(
                        "MOOSE_TPU_METRICS_PORT must be an integer, "
                        f"got {raw!r}"
                    ) from e
                self._metrics_port_from_env = True
        self.metrics_port = metrics_port
        self.metrics_server = None

    # -- rpc handlers ---------------------------------------------------

    def _check_choreographer(self, context) -> None:
        if self.choreographer is None:
            return
        from .tls import peer_common_name, reject

        peer = peer_common_name(context) if context is not None else None
        if peer != self.choreographer:
            reject(
                context,
                f"unauthorized choreographer: peer CN {peer!r}, expected "
                f"{self.choreographer!r}",
            )

    def _launch(self, request: bytes, context=None) -> bytes:
        self._check_choreographer(context)
        return self._launch_inner(request)

    def _launch_inner(self, request: bytes) -> bytes:
        from .. import flight, telemetry
        from ..computation import HostPlacement
        from ..serde import deserialize_computation, deserialize_value

        msg = _unpack(request)
        session_id = msg["session_id"]
        # the client's propagated trace position (Dapper-style): this
        # worker's execute_role root and every span under it — including
        # detector trips and abort fanouts — join the client's trace
        trace_ctx = telemetry.TraceContext.from_dict(msg.get("trace"))
        state = _SessionState([])
        with self._lock:
            if session_id in self._aborted:
                # abort raced ahead of launch (gRPC retry/reordering):
                # honor it — never start the session
                raise SessionAlreadyExistsError(
                    f"{session_id} (aborted before launch)"
                )
            if session_id in self._sessions or session_id in self._completed:
                raise SessionAlreadyExistsError(session_id)
            self._sessions[session_id] = state
        flight.record(
            "launch", party=self.identity, session=session_id,
            args=sorted(msg.get("arguments") or {}),
        )

        def run_in_ctx():
            with telemetry.use_context(trace_ctx):
                run()

        def run():
            from .worker import execute_role

            fanout_reason = None
            fanout_envelope = None
            try:
                # deserialization happens off the rpc thread: a large
                # lowered graph (an AES decrypt circuit is ~200k ops)
                # would otherwise hold the launch rpc past its deadline
                comp = self._computation_for(msg["computation"])
                state.peers.extend(
                    plc.name for plc in comp.placements.values()
                    if isinstance(plc, HostPlacement)
                    and plc.name != self.identity
                    and plc.name in self.endpoints
                )
                if state.peers and self.ping_interval > 0:
                    def detect():
                        # the detector thread inherits the session's
                        # trace context so its detector_trip spans
                        # stitch into the distributed trace
                        with telemetry.use_context(trace_ctx):
                            self._failure_detector(session_id, state)

                    self._spawn(detect, f"moose-fd-{session_id[:8]}")
                arguments = {
                    name: deserialize_value(blob)
                    for name, blob in (msg.get("arguments") or {}).items()
                }
                result = execute_role(
                    comp, self.identity, self.storage, arguments,
                    self.networking, session_id, cancel=state.cancel,
                    progress=state.progress,
                    timeout=self.receive_timeout, device=self.device,
                )
                # resolved transport descriptor rides along so the
                # client's session report (and bench rows) record what
                # this party's traffic actually used
                descriptor = getattr(
                    self.networking, "transport_descriptor", None
                )
                transport = (
                    descriptor() if descriptor is not None
                    else {"transport": "grpc", "trust_model": None}
                )
                payload = _pack({
                    "outputs": {
                        name: _serialize_output(value)
                        for name, value in result["outputs"].items()
                    },
                    "elapsed_time_micros": result["elapsed_time_micros"],
                    # resolved worker-plan shape rides along so the
                    # client (and the distributed smoke/bench) can
                    # assert every role reached its compiled plan
                    "plan_mode": result.get("plan_mode"),
                    "pinned_segments": result.get("pinned_segments", []),
                    "transport": transport.get("transport"),
                    "trust_model": transport.get("trust_model"),
                })
                flight.record(
                    "session_completed", party=self.identity,
                    session=session_id,
                    elapsed_micros=result["elapsed_time_micros"],
                    plan_mode=result.get("plan_mode"),
                )
            except SessionAbortedError as e:
                # someone else's root cause cancelled us; the initiator
                # already fanned out and (if it was this server) already
                # put the canonical error cell
                payload = _pack({
                    "error": state.abort_reason or "aborted",
                    "envelope": state.abort_envelope
                    or to_wire(e, self.identity),
                })
                flight.record(
                    "session_aborted", party=self.identity,
                    session=session_id,
                    reason=state.abort_reason or "aborted",
                )
            except Exception as e:  # surfaced on retrieve + fanned out
                fanout_envelope = to_wire(e, self.identity)
                fanout_reason = f"{type(e).__name__}: {e}"
                payload = _pack({
                    "error": fanout_reason, "envelope": fanout_envelope,
                })
                flight.record(
                    "session_error", party=self.identity,
                    session=session_id, error=fanout_reason,
                )
            # an aborted session already has its canonical error result;
            # putting again would either clobber it or recreate a
            # never-consumed cell.  The check and put happen under the
            # same lock as _abort's add+put so the two cannot interleave.
            with self._lock:
                self._sessions.pop(session_id, None)
                state.finished.set()
                if session_id not in self._aborted:
                    self._results.put(session_id, payload)
                    if fanout_reason is None:
                        self._completed.append(session_id)
                        while len(self._completed) > self._MAX_ABORTED:
                            self._completed.popleft()
                    else:
                        # a root-cause failure is remembered as ABORTED,
                        # not completed: peers' pings then adopt the
                        # abort even if the fanout below never lands
                        # (the result cell above keeps the real error
                        # for the retriever)
                        self._remember_aborted_locked(
                            session_id, fanout_envelope
                        )
            if fanout_reason is not None:
                # peers may be unknown if the failure hit before the
                # graph deserialized — notify every configured endpoint
                targets = state.peers or [
                    p for p in self.endpoints if p != self.identity
                ]
                self._fanout_abort(
                    session_id, fanout_reason, targets,
                    envelope=fanout_envelope,
                )

        self._spawn(run_in_ctx, f"moose-session-{session_id[:8]}")
        return _pack({"ok": True})

    def _spawn(self, target, name: str) -> None:
        """Start one of a session's threads, for stop() to join."""
        thread = threading.Thread(target=target, daemon=True, name=name)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(thread)
        thread.start()

    # bound on memoized deserialized computations (a serving deployment
    # cycles through a handful of models; 32 mirrors runtime._bin_cache)
    _MAX_BIN_CACHE = 32

    def _computation_for(self, blob: bytes):
        """Deserialize ``blob``, memoized on the bytes: the worker's
        resolved role plans (worker_plan) are weak-keyed on the
        Computation object, so repeat sessions must share it for the
        plan cache — and its validated jit — to survive across
        launches."""
        from ..serde import deserialize_computation

        with self._lock:
            comp = self._bin_cache.get(blob)
            if comp is not None:
                self._bin_cache.move_to_end(blob)
                return comp
        comp = deserialize_computation(blob)
        with self._lock:
            existing = self._bin_cache.get(blob)
            if existing is not None:
                return existing
            self._bin_cache[blob] = comp
            while len(self._bin_cache) > self._MAX_BIN_CACHE:
                self._bin_cache.popitem(last=False)
        return comp

    def _retrieve(self, request: bytes, context=None) -> bytes:
        # results carry the computation's outputs — only the configured
        # choreographer may read them, same as launch/abort
        self._check_choreographer(context)
        msg = _unpack(request)
        timeout = float(msg.get("timeout", 120.0))
        return self._results.get(msg["session_id"], timeout)

    def _get_flight(self, request: bytes, context=None) -> bytes:
        """Serve this process's recent flight-recorder events for the
        requested session ids (the client's postmortem collection on
        terminal session failure).  Events describe execution structure
        — keys, plan modes, error strings — never payload values; still
        choreographer-gated like retrieve, since error strings may leak
        operational detail."""
        self._check_choreographer(context)
        from .. import flight

        msg = _unpack(request)
        events = flight.get_recorder().events(
            sessions=msg.get("session_ids") or (),
            limit=msg.get("limit"),
        )
        return _pack({"events": events})

    def _storage_control(self, request: bytes, context=None) -> bytes:
        """Checkpoint control plane for the training supervisor
        (query / pin / commit / discard against this party's
        CheckpointStore).  Choreographer-gated like launch/retrieve —
        commit and pin decide which model generation this party serves.
        Errors travel as typed wire envelopes so the supervisor re-raises
        the real class (CheckpointError is non-retryable; a transport
        failure reaching a dead worker classifies retryable at the
        client)."""
        self._check_choreographer(context)
        msg = _unpack(request)
        cmd = msg.get("cmd")
        try:
            store = self.storage
            if not hasattr(store, "checkpoint_control"):
                from ..errors import ConfigurationError

                raise ConfigurationError(
                    f"{self.identity}: storage has no checkpoint "
                    "support (start the worker with a CheckpointStore "
                    "— comet: --checkpoint)"
                )
            result = store.checkpoint_control(cmd, msg.get("args") or {})
            return _pack({"ok": True, "result": result})
        except Exception as e:  # noqa: BLE001 — typed envelope below
            return _pack({
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "envelope": to_wire(e, self.identity),
            })

    # bound on remembered aborted/completed ids (replay/late-send
    # protection); old entries age out FIFO so a long-lived worker's
    # state stays bounded
    _MAX_ABORTED = 4096

    def _remember_aborted_locked(self, session_id: str,
                                 envelope: Optional[dict]) -> None:
        """Record an aborted id (+ typed cause for ping adoption);
        caller holds ``self._lock``."""
        self._aborted.append(session_id)
        if envelope is not None:
            self._abort_envelopes[session_id] = envelope
        while len(self._aborted) > self._MAX_ABORTED:
            old = self._aborted.popleft()
            self._abort_envelopes.pop(old, None)

    def _abort(self, request: bytes, context=None) -> bytes:
        self._check_choreographer(context)
        msg = _unpack(request)
        self._abort_local(msg["session_id"], reason="aborted")
        return _pack({"ok": True})

    def _abort_local(self, session_id: str, reason: str,
                     envelope: Optional[dict] = None) -> None:
        """Shared abort path (choreographer rpc, peer fanout, failure
        detector): cancel a running session, record the canonical error
        cell, remember the id so late launches/sends are dropped.  An
        already-completed session keeps its real result.  ``envelope``
        is the typed root cause (errors.to_wire) when the aborter knows
        it — a peer's fanned-out failure, a detector trip — so every
        party's result cell re-raises the REAL class at the client."""
        from .. import flight

        flight.record(
            "abort", party=self.identity, session=session_id,
            reason=reason,
        )
        if envelope is None:
            envelope = to_wire(SessionAbortedError(reason), self.identity)
        with self._lock:
            completed = session_id in self._completed
            state = self._sessions.pop(session_id, None)
            self._remember_aborted_locked(session_id, envelope)
            if state is not None:
                # fail-stop semantics: retrievers of a launched session
                # unblock with the canonical error.  Unknown ids get no
                # cell (nobody retrieves a session that never launched;
                # a cell would be retained forever), completed ones keep
                # their real result.
                state.abort_reason = reason
                state.abort_envelope = envelope
                self._results.put(session_id, _pack({
                    "error": reason, "envelope": envelope,
                }))
        if state is not None:
            # cooperative cancellation: the execute threads check the
            # event between ops and inside blocked receives
            # (the reference's abort handler is unimplemented!(),
            # choreography/grpc.rs:200-205)
            state.cancel.set()
        if not completed:
            # drop pending rendezvous payloads so aborted sessions don't
            # retain undelivered tensors in a long-lived worker
            self.networking.cells.drop_session(session_id)

    def _fanout_abort(self, session_id: str, reason: str, peers,
                      envelope: Optional[dict] = None) -> None:
        """Propagate a root-cause error: abort the session on every peer
        (best effort, parallel, short timeout — a dead peer is precisely
        the case we're propagating around).  The typed envelope rides
        along so peers' result cells carry the originator's real error
        class, not a generic 'aborted by'."""
        from .. import telemetry

        msg = f"aborted by {self.identity}: {reason}"
        reached = [0]

        def one(peer):
            # two attempts: a transient failure here would otherwise
            # leave the peer relying on its (slower) failure detector
            for attempt in range(2):
                try:
                    self.networking.abort_session(
                        peer, session_id, msg, envelope=envelope
                    )
                    reached[0] += 1
                    return
                except Exception:  # noqa: BLE001 — peer may be the dead one
                    if attempt == 0:
                        import time

                        time.sleep(0.2)

        with telemetry.span(
            "abort_fanout", session_id=session_id, party=self.identity,
            peers=len(list(peers)), reason=reason,
        ) as s:
            threads = [
                threading.Thread(target=one, args=(p,), daemon=True)
                for p in peers
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=5.0)
            s.attrs["reached"] = reached[0]

    def _abort_session(self, request: bytes, context=None) -> bytes:
        """Participant-level abort (peer fanout target).  Under mTLS the
        claimed sender must match the peer certificate's CN and be a
        configured participant — a choreographer credential is NOT
        required: any party that hit a root cause may fail the session."""
        msg = _unpack(request)
        sender = msg.get("sender")
        if self.tls is not None:
            from .tls import peer_common_name, reject

            peer = (
                peer_common_name(context) if context is not None else None
            )
            if peer is None or peer != sender or peer not in self.endpoints:
                reject(
                    context,
                    f"unauthorized session abort: claimed {sender!r}, "
                    f"peer certificate CN {peer!r}",
                )
        self._abort_local(
            msg["session_id"],
            reason=msg.get("reason", "aborted by peer"),
            envelope=msg.get("envelope"),
        )
        return _pack({"ok": True})

    def _ping(self, request: bytes, context=None) -> bytes:
        msg = _unpack(request) if request else {}
        session_id = msg.get("session_id")
        status = None
        ops = None
        abort_envelope = None
        if session_id is not None:
            with self._lock:
                if session_id in self._sessions:
                    status = "running"
                    # op-completion count: progress EVIDENCE, so a
                    # peer's detector can tell "alive and advancing"
                    # (extend blocked receives) from "alive but stuck"
                    # (let the no-progress timeout fire — e.g. after a
                    # lost send leaves everyone mutually blocked)
                    ops = self._sessions[session_id].progress.count
                elif session_id in self._aborted:
                    status = "aborted"
                    # the typed root cause rides along so an adopter
                    # that missed the fanout still re-raises the real
                    # class (and its retryable bit) at the client
                    abort_envelope = self._abort_envelopes.get(
                        session_id
                    )
                elif session_id in self._completed:
                    status = "completed"
                else:
                    status = "unknown"
        return _pack({
            "ok": True, "identity": self.identity, "session": status,
            "ops": ops, "abort_envelope": abort_envelope,
        })

    def _failure_detector(self, session_id: str, state: _SessionState):
        """Ping session peers while the session runs; a consistently
        unreachable peer fails the session everywhere.  Two kinds of
        miss are weighted differently: a connection-level failure
        (UNAVAILABLE — process dead, port closed) scores 2, a slow
        answer (deadline exceeded — peer alive but saturated, common on
        small shared hosts) scores 1, and the session fails at
        ``2 * ping_misses`` points — so a killed worker is detected in
        ~``ping_misses * ping_interval`` seconds while a busy-but-alive
        peer gets twice the patience.  Peers that were never reachable
        get ``startup_grace`` seconds first (workers come up in any
        order)."""
        import time

        import grpc

        start = time.monotonic()
        misses = {p: 0 for p in state.peers}
        seen = {p: False for p in state.peers}
        last_ops: dict = {}  # peer -> last reported op count / status
        last_advance = time.monotonic()
        trip_at = 2 * self.ping_misses
        while not state.finished.wait(self.ping_interval):
            with self._lock:
                if session_id not in self._sessions:
                    return  # session finished or was aborted
            # progress extends blocked receives only when EVERY peer
            # shows session liveness this round AND at least one peer
            # reports real op advances: a single peer stuck at
            # "unknown" (its launch never arrived — e.g. the client died
            # mid-fanout) must let the hard timeout fire even while the
            # other peers keep answering, and a cluster where every
            # party is mutually blocked (a send was lost on the wire)
            # must time out rather than extend deadlines off bare
            # liveness forever
            all_live = True
            all_completed = bool(state.peers)
            any_advance = False
            for peer in state.peers:
                if state.cancel.is_set():
                    return
                try:
                    resp = self.networking.ping(
                        peer, timeout=3.0, session_id=session_id
                    )
                    seen[peer] = True
                    misses[peer] = 0
                    peer_session = resp.get("session")
                    peer_ops = resp.get("ops")
                    prev = last_ops.get(peer)
                    if peer_session == "completed":
                        # the completion transition is one last advance
                        # (it may deliver this worker's pending value)
                        if prev != "completed":
                            any_advance = True
                        last_ops[peer] = "completed"
                    elif peer_ops is not None:
                        if isinstance(prev, int) and peer_ops > prev:
                            any_advance = True
                        last_ops[peer] = peer_ops
                    if peer_session == "aborted":
                        # the peer killed this session but its fanout
                        # never reached us: adopt the abort instead of
                        # treating the live process as session liveness
                        # (with the peer's typed root cause, when the
                        # ping carried it)
                        reason = (
                            f"session aborted on peer {peer!r} "
                            "(learned via ping)"
                        )
                        self._abort_local(
                            session_id, reason=reason,
                            envelope=resp.get("abort_envelope"),
                        )
                        return
                    if peer_session not in ("running", "completed"):
                        all_live = False
                    if peer_session != "completed":
                        all_completed = False
                except Exception as e:  # noqa: BLE001 — rpc failure
                    all_live = False
                    all_completed = False
                    if (
                        not seen[peer]
                        and time.monotonic() - start < self.startup_grace
                    ):
                        continue
                    hard = (
                        isinstance(e, grpc.RpcError)
                        and e.code() == grpc.StatusCode.UNAVAILABLE
                    )
                    misses[peer] += 2 if hard else 1
                    if misses[peer] >= trip_at:
                        from .. import flight, metrics, telemetry

                        reason = (
                            f"peer {peer!r} unreachable "
                            f"({misses[peer]} ping-miss points)"
                        )
                        envelope = to_wire(
                            PeerUnreachableError(reason), self.identity
                        )
                        metrics.counter(
                            "moose_tpu_detector_trips_total",
                            "failure-detector trips (peer declared "
                            "unreachable)",
                        ).inc()
                        flight.record(
                            "detector_trip", party=self.identity,
                            session=session_id, peer=peer,
                            miss_points=misses[peer],
                        )
                        with telemetry.span(
                            "detector_trip", session_id=session_id,
                            party=self.identity, peer=peer,
                            miss_points=misses[peer],
                        ):
                            self._abort_local(
                                session_id, reason=reason,
                                envelope=envelope,
                            )
                            survivors = [
                                p for p in state.peers if p != peer
                            ]
                            self._fanout_abort(
                                session_id, reason, survivors,
                                envelope=envelope,
                            )
                        return
            # a round where EVERY peer reports 'completed' cannot deliver
            # anything new to this worker's pending receives — bumping
            # progress would extend their deadlines forever when a value
            # this worker still awaits was never sent (role/graph
            # mismatch, dropped send); let the no-progress timeout fire
            # instead.  Liveness alone is not progress
            # either, but live peers get a bounded stall_grace beyond
            # the last real advance — one giant op may legitimately
            # freeze every count for longer than the receive timeout.
            if any_advance:
                last_advance = time.monotonic()
            if (
                all_live and state.peers and not all_completed
                and (
                    any_advance
                    or time.monotonic() - last_advance
                    < self.stall_grace
                )
            ):
                # extend, don't bump: a bump would raise OUR op count,
                # which peers' detectors would read as an advance — a
                # mutual-extension loop that never times out
                state.progress.extend()

    def _send_value(self, request: bytes, context=None) -> bytes:
        # a peer's send may land after this worker aborted the session:
        # drop it so cancelled receives never retain the payload — but
        # only after the mTLS sender check, so a spoofed frame is
        # rejected (not silently ACKed) on this path too
        frame = _unpack(request)
        self.networking.verify_sender(frame, context)
        batch = frame.get("batch")
        if batch:  # coalesced send_many envelope: one session per frame
            first_key = batch[0].get("key", "")
        else:
            first_key = frame.get("key", "")
        session_id = first_key.split("/", 1)[0]
        with self._lock:
            aborted = session_id in self._aborted
        if aborted:
            return b""
        return self.networking.handle_send_value(
            request, context, frame=frame, verified=True
        )

    # -- server lifecycle ----------------------------------------------

    # the kernels a worker's host ops launch on the card: K1 (a host
    # ring Dot), K4 (a host ring Mul) and K7 (every SampleSeeded)
    WORKER_KERNELS = ("dot_cross_terms", "ring_mul", "threefry")

    def start(self):
        import grpc

        if self.device.type == "cuda":
            # built before the port opens: an nvcc at first use would
            # stall a session while the peers' receive clocks run
            from ..native import build

            for name in self.WORKER_KERNELS:
                build.library(name)

        def unary(fn):
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: fn(req, ctx),
                request_deserializer=None,
                response_serializer=None,
            )

        handlers = {
            "LaunchComputation": unary(self._launch),
            "RetrieveResults": unary(self._retrieve),
            "AbortComputation": unary(self._abort),
            "GetFlight": unary(self._get_flight),
            "StorageControl": unary(self._storage_control),
        }
        net_handlers = {
            "SendValue": unary(self._send_value),
            "AbortSession": unary(self._abort_session),
            "Ping": unary(self._ping),
        }
        from .networking import GRPC_MESSAGE_OPTIONS

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16),
            options=GRPC_MESSAGE_OPTIONS,
        )
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "moose.Choreography", handlers
                ),
                grpc.method_handlers_generic_handler(
                    "moose.Networking", net_handlers
                ),
            )
        )
        if self.tls is not None:
            bound = self._server.add_secure_port(
                f"[::]:{self.port}", self.tls.server_credentials()
            )
        else:
            bound = self._server.add_insecure_port(f"[::]:{self.port}")
        if bound == 0:
            raise NetworkingError(f"cannot bind gRPC port {self.port}")
        self.port = bound
        if self.metrics_port is not None and self.metrics_server is None:
            from .. import metrics

            try:
                self.metrics_server = metrics.serve_http(
                    self.metrics_port,
                    health_extra={"identity": self.identity},
                )
            except OSError as e:
                if not self._metrics_port_from_env:
                    raise NetworkingError(
                        f"cannot bind metrics port {self.metrics_port}: "
                        f"{e}"
                    ) from e
                # env-derived fixed port + several workers in ONE
                # process (an in-process cluster inheriting the comet
                # knob): fall back to an ephemeral port instead of
                # crashing startup — the registry is process-global, so
                # any bound port serves the same series
                from ..logger import get_logger

                get_logger().warning(
                    "metrics port %d (MOOSE_TPU_METRICS_PORT) already "
                    "bound in this process; %s falling back to an "
                    "ephemeral port", self.metrics_port, self.identity,
                )
                self.metrics_server = metrics.serve_http(
                    0, health_extra={"identity": self.identity}
                )
            self.metrics_port = self.metrics_server.port
        self._server.start()
        if self.chaos is not None:
            # an in-process 'restart' constructs a fresh WorkerServer
            # over the SAME chaos config: the restarted identity is
            # alive again (its kill-count persists: max_kills bounds
            # how often the schedule may strike it).  Revived only once
            # the server serves, so a failed bind keeps the latch the
            # restarter iterates
            self.chaos.revive(self.identity)
        return self

    # how long stop() waits for a session's threads once it has aborted
    # the session (a kernel or an rpc under way finishes first)
    _STOP_JOIN_S = 30.0

    def stop(self, grace: float = 0.5):
        """Stop serving: in-flight rpcs get ``grace`` seconds, a session
        still running is aborted, and every session's threads (its run,
        receive prefetch and failure detector) have ended when this
        returns."""
        import time

        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        with self._lock:
            running = list(self._sessions)
        for session_id in running:
            self._abort_local(session_id, reason="worker stopped")
        with self._lock:
            threads, self._threads = self._threads, []
        deadline = time.monotonic() + self._STOP_JOIN_S
        for thread in threads:
            thread.join(max(0.0, deadline - time.monotonic()))

    def _chaos_kill(self):
        """Chaos ``kill_after_ops`` hook: die like a SIGKILL'd process,
        stop answering rpcs at once (peers' pings see UNAVAILABLE and
        their detectors trip) without aborting sessions or fanning out.
        The wrapped transport raises on every later op of this
        identity, so the run thread cannot limp along either."""
        server, self._server = self._server, None
        if server is not None:
            server.stop(0)

    def wait(self):
        """Block until the server stops (a stop before the wait returns
        at once)."""
        server = self._server
        if server is not None:
            server.wait_for_termination()


def start_local_cluster(identities, storages=None, device="cuda",
                        **server_kwargs):
    """In-process WorkerServer cluster on ephemeral 127.0.0.1 gRPC
    ports, endpoints cross-wired after every port is known (port 0 means
    the endpoint map cannot be built up front), every worker on
    ``device``.  Returns ``(servers, endpoints)``; caller stops each
    server."""
    servers, endpoints = {}, {}
    for name in identities:
        srv = WorkerServer(
            name, 0, {}, storage=(storages or {}).get(name),
            device=device, **server_kwargs,
        ).start()
        servers[name] = srv
        endpoints[name] = f"127.0.0.1:{srv.port}"
    for srv in servers.values():
        srv.endpoints.update(endpoints)
        srv.networking._endpoints.update(endpoints)
    return servers, endpoints


def start_chaos_restarter(servers, endpoints, storages, chaos,
                          restart_delay_s: float = 1.0,
                          poll_s: float = 0.3, **server_kwargs):
    """Watch a chaos config and 'process-restart' any killed in-process
    worker: stop the stale WorkerServer, rebind a fresh one on the SAME
    port with the SAME (durable) storage and the SAME chaos config
    (``start`` revives the identity; max_kills bounds further strikes).
    ``server_kwargs`` reach the new server (``device=`` among them).
    Returns a zero-arg stop callable."""
    import time as _time

    stop_event = threading.Event()

    def loop():
        from ..logger import get_logger

        while not stop_event.is_set():
            _time.sleep(poll_s)
            if chaos is None:
                continue
            for party in list(chaos._killed):
                # a failed restart (a raced port, a transient bind
                # error) must not kill this watcher: log, retry next poll
                try:
                    _time.sleep(restart_delay_s)
                    old = servers[party]
                    old.stop(grace=0)
                    srv = WorkerServer(
                        party, old.port, dict(endpoints),
                        storage=(storages or {}).get(party),
                        chaos=chaos, **server_kwargs,
                    )
                    srv.start()
                    servers[party] = srv
                except Exception:  # noqa: BLE001 - retried next poll
                    get_logger().warning(
                        "chaos restarter: restart of %r failed; "
                        "retrying", party, exc_info=True,
                    )

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()

    def stop():
        stop_event.set()
        thread.join(timeout=3.0)

    return stop


def _serialize_output(value) -> bytes:
    from ..serde import serialize_value

    return serialize_value(value)


class ChoreographyClient:
    """Client stub for one worker (reference GrpcMooseRuntime fan-out,
    execution/grpc.rs:57-84)."""

    def __init__(self, endpoint: str, tls=None,
                 expected_identity: Optional[str] = None):
        import grpc

        if tls is not None:
            if expected_identity is None:
                # certificates bind to party names, not addresses — an
                # endpoint can never match a CN, so fail loudly here
                # instead of with an opaque handshake error per-RPC
                raise ValueError(
                    "expected_identity is required with tls: the worker "
                    "certificate's CN is its party name"
                )
            self._channel = tls.secure_channel(endpoint, expected_identity)
        else:
            from .networking import GRPC_MESSAGE_OPTIONS

            self._channel = grpc.insecure_channel(
                endpoint, options=GRPC_MESSAGE_OPTIONS
            )

    def launch(self, session_id: str, comp_bytes: bytes,
               arguments: dict, trace: Optional[dict] = None):
        from ..serde import serialize_value

        payload = _pack({
            "session_id": session_id,
            "computation": comp_bytes,
            "arguments": {
                name: serialize_value(v) for name, v in arguments.items()
            },
            # the client's TraceContext (telemetry.TraceContext.to_dict)
            # — the worker's spans join this trace (Dapper propagation)
            "trace": trace,
        })
        fn = self._channel.unary_unary(LAUNCH)
        # generous: the payload may be a multi-MB serialized graph and
        # the worker may be busy; actual graph deserialization happens
        # off the rpc thread on the worker
        return _unpack(fn(payload, timeout=120.0))

    def retrieve(self, session_id: str, timeout: float = 120.0):
        fn = self._channel.unary_unary(RETRIEVE)
        payload = _pack({"session_id": session_id, "timeout": timeout})
        return _unpack(fn(payload, timeout=timeout + 10.0))

    def abort(self, session_id: str):
        fn = self._channel.unary_unary(ABORT)
        return _unpack(fn(_pack({"session_id": session_id}), timeout=10.0))

    def flight(self, session_ids, limit: Optional[int] = None,
               timeout: float = 5.0) -> list:
        """Fetch the worker's recent flight-recorder events for the
        given session ids (postmortem collection; short timeout — the
        worker may be the dead party)."""
        fn = self._channel.unary_unary(FLIGHT)
        payload = _pack({
            "session_ids": list(session_ids), "limit": limit,
        })
        return _unpack(fn(payload, timeout=timeout)).get("events", [])

    def storage_control(self, cmd: str, args: Optional[dict] = None,
                        timeout: float = 30.0):
        """Drive the worker's CheckpointStore (training control plane).
        Wire-envelope errors re-raise as their real class — a
        CheckpointError on the worker is a CheckpointError here."""
        fn = self._channel.unary_unary(STORAGE_CONTROL)
        resp = _unpack(fn(
            _pack({"cmd": cmd, "args": args or {}}), timeout=timeout,
        ))
        if not resp.get("ok"):
            from ..errors import from_wire

            envelope = resp.get("envelope")
            if envelope:
                raise from_wire(envelope)
            raise NetworkingError(
                f"storage_control({cmd}) failed: {resp.get('error')}"
            )
        return resp.get("result")
