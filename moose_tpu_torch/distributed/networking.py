"""Networking backends: value transfer keyed by (sender, receiver,
rendezvous key, session id).

The port's own copy of ``moose_tpu/distributed/networking.py`` (the
reference's ``moose/src/networking/``): ``send(value, receiver,
rendezvous_key, session_id)`` / ``receive(sender, rendezvous_key,
session_id)``, with

- :class:`LocalNetworking`: an in-memory store for tests and the dasher
  single-process simulator (networking/local.rs);
- :class:`GrpcNetworking`: one ``SendValue`` rpc, out-of-order delivery
  handled by posting receive cells before sends arrive
  (networking/grpc.rs:25-234);
- :class:`TcpNetworking`: length-prefixed frames over the native
  ``tcp_transport.cpp`` (networking/tcpstream.rs), built with ``g++`` at
  first use.

Values cross the wire as the JAX package's msgpack bytes
(``serde.serialize_value``), so a port worker and a JAX worker speak the
same frames; a received value's tensors land on the backend's
``device`` (seeds and keys stay host words).  The static cost model
(``compilation/analysis/cost.py``) prices every transfer with the frame
packers here.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..errors import NetworkingError

DEFAULT_TIMEOUT_S = 120.0

_NET_METRICS = None


def _net_metrics():
    """Lazily-created wire counters on the global registry (every
    transport shares the families, labelled by transport kind)."""
    global _NET_METRICS
    if _NET_METRICS is None:
        from .. import metrics

        _NET_METRICS = {
            "tx_bytes": metrics.counter(
                "moose_tpu_net_tx_bytes_total",
                "serialized bytes handed to the wire",
                ("transport",),
            ),
            "rx_bytes": metrics.counter(
                "moose_tpu_net_rx_bytes_total",
                "serialized bytes received off the wire",
                ("transport",),
            ),
            "sends": metrics.counter(
                "moose_tpu_net_sends_total",
                "single-payload value sends",
                ("transport",),
            ),
            "send_many": metrics.counter(
                "moose_tpu_net_send_many_total",
                "coalesced send_many envelopes",
                ("transport",),
            ),
            "send_many_payloads": metrics.counter(
                "moose_tpu_net_send_many_payloads_total",
                "rendezvous payloads carried inside send_many envelopes",
                ("transport",),
            ),
            "receives": metrics.counter(
                "moose_tpu_net_receives_total",
                "rendezvous payloads consumed by receives",
                ("transport",),
            ),
        }
    return _NET_METRICS

# tensors routinely exceed gRPC's 4 MB default cap (an 800x800 float64 is
# already ~5 MB on the wire); the reference raises the tonic limits the
# same way for its SendValue payloads
GRPC_MESSAGE_OPTIONS = (
    ("grpc.max_send_message_length", -1),
    ("grpc.max_receive_message_length", -1),
)


def transfer_key(session_id: str, rendezvous_key: str) -> str:
    return f"{session_id}/{rendezvous_key}"


def pack_value_frame(sender: str, key: str, payload: bytes) -> bytes:
    """The single-payload SendValue frame.  Module-level (not a method)
    so the static cost model (analysis/cost.py) can price a transfer
    with the exact bytes the transport will emit — the frame layout has
    one definition."""
    import msgpack

    return msgpack.packb(
        {"key": key, "sender": sender, "value": payload},
        use_bin_type=True,
    )


def pack_batch_frame(sender: str, entries) -> bytes:
    """The coalesced send_many envelope: ``entries`` is
    ``[(transfer_key, payload_bytes), ...]`` — one rpc carrying several
    rendezvous payloads of one session.  Shared with the cost model
    like :func:`pack_value_frame`."""
    import msgpack

    return msgpack.packb(
        {
            "sender": sender,
            "batch": [
                {"key": key, "value": payload} for key, payload in entries
            ],
        },
        use_bin_type=True,
    )


class ProgressClock:
    """Monotonic liveness marker shared by a worker's ops: every local op
    completion (and, on gRPC workers, every successful peer ping) bumps
    it, and a blocked receive's deadline extends to ``last + timeout`` —
    so the timeout means "no sign of progress anywhere for timeout
    seconds", not "this one op took long" (the parallel scheduler
    dispatches all receives at launch, so a fixed per-op deadline would
    spuriously kill long pipelines)."""

    __slots__ = ("last", "count")

    def __init__(self):
        import time as _time

        self.last = _time.monotonic()
        # monotone completion counter: pings report it so a peer can
        # distinguish "alive and advancing" from "alive but stuck" —
        # only the former may extend blocked receives (a dropped send
        # would otherwise let mutually-blocked live workers extend each
        # other's deadlines forever)
        self.count = 0

    def bump(self):
        import time as _time

        self.last = _time.monotonic()
        self.count += 1

    def extend(self):
        """Extend the deadline WITHOUT claiming an op completed.  The
        failure detector uses this when peers report real advances:
        counting its own extension as progress would let two mutually
        blocked workers read each other's detector activity as op
        advances and extend forever."""
        import time as _time

        self.last = _time.monotonic()


def sliced_wait(wait_slice, timeout: float, cancel, what: str,
                progress: "ProgressClock" = None) -> None:
    """Wait for ``wait_slice(seconds) -> bool`` to report arrival.

    With no cancel event or progress clock this is one full-length wait;
    otherwise the wait runs in <=200ms slices: a set cancel event
    interrupts a blocked receive promptly (checked both before and after
    each slice so an abort in the final slice is reported as
    cancellation, not a spurious timeout), and a bumped progress clock
    extends the deadline.  Shared by every transport so the semantics
    can't drift."""
    import time as _time

    from ..errors import SessionAbortedError

    from ..errors import ReceiveTimeoutError

    if cancel is None and progress is None:
        if not wait_slice(timeout):
            raise ReceiveTimeoutError(
                f"receive timed out after {timeout}s for {what!r}"
            )
        return
    deadline = _time.monotonic() + timeout
    while True:
        if cancel is not None and cancel.is_set():
            raise SessionAbortedError(
                f"receive for {what!r} cancelled (session aborted)"
            )
        if progress is not None:
            deadline = max(deadline, progress.last + timeout)
        remaining = deadline - _time.monotonic()
        if remaining <= 0:
            raise ReceiveTimeoutError(
                f"receive timed out after {timeout}s (no session "
                f"progress) for {what!r}"
            )
        if wait_slice(min(0.2, remaining)):
            return


class _CellStore:
    """Rendezvous-keyed blocking cells: receive may be posted before the
    send arrives (reference AsyncCell store, networking/grpc.rs:189-207)."""

    # bound on remembered per-session activity events (mirrors the
    # worker server's session-id bookkeeping bound)
    _MAX_ACTIVITY = 4096

    def __init__(self):
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._values: dict = {}
        self._events: dict = {}
        # keys already consumed by a receive: a duplicate delivery
        # (gRPC retry, chaos dup_send) of a consumed key must be
        # DROPPED, not re-posted — sessions never reuse a rendezvous
        # key, so a re-put could only recreate a never-consumed cell
        # (a slow leak) or hand a stale copy to nobody.  Bounded LRU,
        # same discipline as the session-id bookkeeping.
        self._delivered: "OrderedDict[str, None]" = OrderedDict()
        # per-session arrival wakeups: each session's receive poller
        # sleeps on ITS event — a shared one would let one session's
        # poller swallow another's wakeup (clear/wait race), degrading
        # concurrent sessions to the fallback poll interval.  LRU so a
        # busy long-lived session is never evicted by short-session
        # churn (every touch refreshes recency).
        self._activity: "OrderedDict[str, threading.Event]" = OrderedDict()

    def _mark_delivered(self, key: str) -> None:
        # caller holds self._lock
        self._delivered[key] = None
        while len(self._delivered) > self._MAX_ACTIVITY:
            self._delivered.popitem(last=False)

    def activity_for(self, session_id: str):
        with self._lock:
            ev = self._activity.get(session_id)
            if ev is None:
                ev = self._activity[session_id] = threading.Event()
                while len(self._activity) > self._MAX_ACTIVITY:
                    self._activity.popitem(last=False)
            else:
                self._activity.move_to_end(session_id)
            return ev

    def put(self, key: str, value):
        session_id = key.split("/", 1)[0]
        with self._lock:
            if key in self._delivered:
                return  # duplicate delivery of a consumed key: drop
            self._values[key] = value
            ev = self._events.get(key)
            if ev is None:
                ev = self._events[key] = threading.Event()
        ev.set()
        self.activity_for(session_id).set()

    def try_take(self, key: str):
        """Non-blocking probe: (True, value) and consume if present."""
        with self._lock:
            if key in self._values:
                self._events.pop(key, None)
                self._mark_delivered(key)
                return True, self._values.pop(key)
        return False, None

    def get(self, key: str, timeout: float, cancel=None, progress=None):
        with self._lock:
            ev = self._events.get(key)
            if ev is None:
                ev = self._events[key] = threading.Event()
        sliced_wait(ev.wait, timeout, cancel, key, progress)
        with self._lock:
            # single-consumer: drop the cell after use (sessions never
            # reuse a rendezvous key)
            self._events.pop(key, None)
            self._mark_delivered(key)
            return self._values.pop(key)

    def drop_session(self, session_id: str) -> int:
        """Remove every pending cell of one session (abort-path GC —
        payloads that arrived for a cancelled receive would otherwise be
        retained forever in a long-lived worker)."""
        prefix = f"{session_id}/"
        with self._lock:
            stale = [k for k in self._events if k.startswith(prefix)]
            stale += [
                k for k in self._values
                if k.startswith(prefix) and k not in self._events
            ]
            for k in stale:
                self._events.pop(k, None)
                self._values.pop(k, None)
            self._activity.pop(session_id, None)
        return len(stale)


class LocalNetworking:
    """In-memory networking shared by all virtual identities in one
    process.  Serializes values through the real wire codec so local tests
    exercise the same path as gRPC; ``device`` is where received tensors
    land (the card unless the caller asks for the CPU)."""

    def __init__(self, serialize: bool = True, device="cuda"):
        from .. import devices

        self._store = _CellStore()
        self._serialize = serialize
        # received tensors land here (every identity of one process
        # shares the store, and the device)
        self.device = devices.resolve(device)

    def send(self, value, receiver: str, rendezvous_key: str,
             session_id: str):
        from .. import profiling
        from ..serde import serialize_value

        if self._serialize:
            with profiling.phase("serde", direction="tx"):
                payload = serialize_value(value)
        else:
            payload = value
        m = _net_metrics()
        m["sends"].inc(transport="local")
        if self._serialize:
            m["tx_bytes"].inc(len(payload), transport="local")
        self._store.put(transfer_key(session_id, rendezvous_key), payload)
        # transmitted bytes (the cost-drift watchdog tallies these per
        # session; None when the payload never hit the wire codec)
        return len(payload) if self._serialize else None

    def send_many(self, items, receiver: str, session_id: str):
        """Coalesced delivery of ``[(rendezvous_key, value), ...]`` to
        one receiver (the worker fast path batches same-destination
        sends at segment boundaries); in-memory this is just the loop,
        kept so local tests exercise the same call shape as gRPC."""
        m = _net_metrics()
        m["send_many"].inc(transport="local")
        m["send_many_payloads"].inc(len(items), transport="local")
        total = 0
        unknown = False
        for rendezvous_key, value in items:
            sent = self.send(value, receiver, rendezvous_key, session_id)
            if sent is None:
                unknown = True
            else:
                total += sent
        return None if unknown else total

    def receive(self, sender: str, rendezvous_key: str, session_id: str,
                plc: str = "", timeout: float = DEFAULT_TIMEOUT_S,
                cancel=None, progress=None):
        from ..serde import deserialize_value

        payload = self._store.get(
            transfer_key(session_id, rendezvous_key), timeout, cancel,
            progress,
        )
        m = _net_metrics()
        m["receives"].inc(transport="local")
        if self._serialize:
            from .. import profiling

            m["rx_bytes"].inc(len(payload), transport="local")
            with profiling.phase("serde", direction="rx"):
                return deserialize_value(payload, plc, self.device)
        return payload

    def activity_for(self, session_id: str):
        return self._store.activity_for(session_id)

    def try_receive(self, sender: str, rendezvous_key: str,
                    session_id: str, plc: str = ""):
        """Non-blocking receive probe for the worker's single poller
        thread: (True, value) if the payload has arrived."""
        from ..serde import deserialize_value

        ok, payload = self._store.try_take(
            transfer_key(session_id, rendezvous_key)
        )
        if not ok:
            return False, None
        m = _net_metrics()
        m["receives"].inc(transport="local")
        if self._serialize:
            from .. import profiling

            m["rx_bytes"].inc(len(payload), transport="local")
            with profiling.phase("serde", direction="rx"):
                return True, deserialize_value(payload, plc, self.device)
        return True, payload


class TcpNetworking:
    """Raw TCP transport backed by the native C++ library
    (``native/tcp_transport.cpp``; reference networking/tcpstream.rs).

    ``endpoints`` maps identity -> "host:port"; the local identity's
    server must be started with :meth:`start`.  Received tensors land on
    ``device``."""

    def __init__(self, identity: str, endpoints: dict,
                 device="cuda"):
        from ..native import tcp

        self._identity = identity
        self._endpoints = dict(endpoints)
        self.device = device
        self._lib = tcp.load()
        self._server = None

    def start(self):
        from ..native import tcp

        _, port = self._endpoints[self._identity].rsplit(":", 1)
        self._server = tcp.ServerHandle(self._lib, int(port))
        return self

    def stop(self):
        if self._server is not None:
            self._server.close()
            self._server = None

    def send(self, value, receiver: str, rendezvous_key: str,
             session_id: str, max_retry_s: float = 30.0):
        import time

        from ..native import tcp
        from ..serde import serialize_value

        endpoint = self._endpoints.get(receiver)
        if endpoint is None:
            raise NetworkingError(f"unknown receiver identity {receiver!r}")
        host, port = endpoint.rsplit(":", 1)
        key = transfer_key(session_id, rendezvous_key)
        payload = serialize_value(value)
        m = _net_metrics()
        m["sends"].inc(transport="tcp")
        m["tx_bytes"].inc(len(payload), transport="tcp")
        # retry with backoff so workers may come up in any order
        # (networking/constants.rs backoff discipline)
        delay = 0.05
        deadline = time.monotonic() + max_retry_s
        while True:
            try:
                tcp.send(self._lib, host, int(port), key, payload)
                return len(payload)
            except NetworkingError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

    def receive(self, sender: str, rendezvous_key: str, session_id: str,
                plc: str = "", timeout: float = DEFAULT_TIMEOUT_S,
                cancel=None, progress=None):
        import time

        from ..errors import ReceiveTimeoutError
        from ..serde import deserialize_value

        if self._server is None:
            raise NetworkingError(
                "TcpNetworking.receive before start(): the local server "
                "owns the rendezvous store"
            )
        key = transfer_key(session_id, rendezvous_key)
        box: list = []

        def wait_slice(seconds: float) -> bool:
            # the native wait is uninterruptible, so slices bound how
            # long a cancel can go unnoticed; a native call that returns
            # early without a value sleeps out its slice
            t0 = time.monotonic()
            try:
                box.append(
                    self._server.receive(key, max(1, int(seconds * 1000)))
                )
                return True
            except ReceiveTimeoutError:
                elapsed = time.monotonic() - t0
                if elapsed < seconds / 2:
                    time.sleep(seconds - elapsed)
                return False

        sliced_wait(wait_slice, timeout, cancel, key, progress)
        m = _net_metrics()
        m["receives"].inc(transport="tcp")
        m["rx_bytes"].inc(len(box[0]), transport="tcp")
        return deserialize_value(box[0], plc, self.device)


SEND_VALUE_METHOD = "/moose.Networking/SendValue"
ABORT_SESSION_METHOD = "/moose.Networking/AbortSession"
PING_METHOD = "/moose.Networking/Ping"


class GrpcNetworking:
    """gRPC transport: a single SendValue rpc posts into the receiver's
    cell store (reference networking/grpc.rs); received tensors land on
    ``device``.  The server half is hosted
    by the worker (see distributed.choreography.WorkerServer), which also
    serves the participant-level AbortSession and Ping methods used by
    the abort fanout and failure detector."""

    def __init__(self, identity: str, endpoints: dict, cells: Optional[
            _CellStore] = None, tls=None, device="cuda"):
        from .. import devices

        self._identity = identity
        # the worker's device: received tensors land here
        self.device = devices.resolve(device)
        self._endpoints = dict(endpoints)
        self.cells = cells or _CellStore()
        self._channels: dict = {}
        self._lock = threading.Lock()
        self._tls = tls  # distributed.tls.TlsConfig or None

    def _stub(self, receiver: str, method: str = SEND_VALUE_METHOD):
        import grpc

        with self._lock:
            ch = self._channels.get(receiver)
            if ch is None:
                endpoint = self._endpoints.get(receiver)
                if endpoint is None:
                    raise NetworkingError(
                        f"unknown receiver identity {receiver!r}"
                    )
                if self._tls is not None:
                    # the server must present a certificate for the
                    # *receiver identity* (CN = party name)
                    ch = self._tls.secure_channel(endpoint, receiver)
                else:
                    ch = grpc.insecure_channel(
                        endpoint, options=GRPC_MESSAGE_OPTIONS
                    )
                self._channels[receiver] = ch
            return ch.unary_unary(method)

    def ping(self, receiver: str, timeout: float = 1.0,
             session_id: str = None) -> dict:
        """Liveness probe against a peer's worker daemon (failure
        detector); raises on any transport error.  With ``session_id``
        the response carries that session's status on the peer
        ("running" / "completed" / "aborted" / "unknown") so a live
        PROCESS whose session already died is distinguishable from real
        liveness — otherwise a missed abort fanout would keep extending
        receive deadlines forever."""
        import msgpack

        payload = msgpack.packb(
            {"from": self._identity, "session_id": session_id},
            use_bin_type=True,
        )
        raw = self._stub(receiver, PING_METHOD)(payload, timeout=timeout)
        return msgpack.unpackb(raw, raw=False) if raw else {}

    def abort_session(self, receiver: str, session_id: str,
                      reason: str, timeout: float = 3.0,
                      envelope: Optional[dict] = None):
        """Participant-level abort on a peer (first-error fanout). No
        retry: a fanout target that is down is already failing the
        session its own way.  ``envelope`` (errors.to_wire) carries the
        typed root cause so the peer's result cell keeps the real error
        class."""
        import msgpack

        payload = msgpack.packb(
            {
                "session_id": session_id,
                "reason": reason,
                "sender": self._identity,
                "envelope": envelope,
            },
            use_bin_type=True,
        )
        self._stub(receiver, ABORT_SESSION_METHOD)(
            payload, timeout=timeout
        )

    def verify_sender(self, frame: dict, context) -> None:
        """Under mTLS the claimed sender must match the peer
        certificate's CN (reference networking/grpc.rs:150-160 rejects
        spoofed senders); no-op without TLS."""
        if self._tls is None:
            return
        from .tls import peer_common_name, reject

        # fail closed: with mTLS configured, a missing context/peer
        # identity is as unacceptable as a mismatched one
        peer = peer_common_name(context) if context is not None else None
        claimed = frame.get("sender")
        if peer is None or peer != claimed:
            reject(
                context,
                f"sender identity mismatch: claimed {claimed!r}, "
                f"peer certificate CN {peer!r}",
            )

    def handle_send_value(self, request: bytes, context=None,
                          frame=None, verified: bool = False) -> bytes:
        """Server-side handler: unpack (key ‖ value) frame and post it
        (``frame`` lets a caller that already unpacked skip the repeat;
        ``verified`` skips the sender check when the caller already ran
        :meth:`verify_sender`).  A ``batch`` frame (send_many envelope)
        posts every entry — one rpc carrying several rendezvous
        payloads of one session."""
        import msgpack

        if frame is None:
            frame = msgpack.unpackb(request, raw=False)
        if not verified:
            self.verify_sender(frame, context)
        _net_metrics()["rx_bytes"].inc(len(request), transport="grpc")
        batch = frame.get("batch")
        if batch is not None:
            for entry in batch:
                self.cells.put(entry["key"], entry["value"])
        else:
            self.cells.put(frame["key"], frame["value"])
        return b""

    def _transmit(self, receiver: str, frame: bytes) -> None:
        # retry with backoff (reference networking/grpc.rs:106-112 retries
        # for up to 5 minutes; workers may come up in any order)
        import time

        delay = 0.05
        deadline = time.monotonic() + 60.0
        while True:
            try:
                self._stub(receiver)(frame, timeout=10.0)
                return
            except Exception as e:  # grpc.RpcError
                # authorization rejections arrive as PERMISSION_DENIED
                # (tls.reject) and are permanent — retrying would hide
                # the real error behind a 60s hang per send
                import grpc

                if (
                    isinstance(e, grpc.RpcError)
                    and e.code() == grpc.StatusCode.PERMISSION_DENIED
                ):
                    from ..errors import AuthorizationError

                    raise AuthorizationError(
                        f"send to {receiver!r} rejected: {e}"
                    ) from e
                if time.monotonic() > deadline:
                    raise NetworkingError(
                        f"send to {receiver!r} failed: {e}"
                    ) from e
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

    def send(self, value, receiver: str, rendezvous_key: str,
             session_id: str):
        from .. import profiling
        from ..serde import serialize_value

        with profiling.phase("serde", direction="tx"):
            frame = pack_value_frame(
                self._identity,
                transfer_key(session_id, rendezvous_key),
                serialize_value(value),
            )
        m = _net_metrics()
        m["sends"].inc(transport="grpc")
        m["tx_bytes"].inc(len(frame), transport="grpc")
        self._transmit(receiver, frame)
        return len(frame)

    def send_many(self, items, receiver: str, session_id: str):
        """One SendValue rpc carrying several rendezvous payloads
        (``[(rendezvous_key, value), ...]``) — the worker fast path
        coalesces same-destination sends at segment boundaries so a
        protocol round costs one envelope per peer instead of one rpc
        per tensor."""
        from .. import profiling
        from ..serde import serialize_value

        with profiling.phase("serde", direction="tx", payloads=len(items)):
            frame = pack_batch_frame(
                self._identity,
                [
                    (transfer_key(session_id, key), serialize_value(value))
                    for key, value in items
                ],
            )
        m = _net_metrics()
        m["send_many"].inc(transport="grpc")
        m["send_many_payloads"].inc(len(items), transport="grpc")
        m["tx_bytes"].inc(len(frame), transport="grpc")
        self._transmit(receiver, frame)
        return len(frame)

    def receive(self, sender: str, rendezvous_key: str, session_id: str,
                plc: str = "", timeout: float = DEFAULT_TIMEOUT_S,
                cancel=None, progress=None):
        from .. import profiling
        from ..serde import deserialize_value

        payload = self.cells.get(
            transfer_key(session_id, rendezvous_key), timeout, cancel,
            progress,
        )
        _net_metrics()["receives"].inc(transport="grpc")
        with profiling.phase("serde", direction="rx"):
            return deserialize_value(payload, plc, self.device)

    def activity_for(self, session_id: str):
        return self.cells.activity_for(session_id)

    def try_receive(self, sender: str, rendezvous_key: str,
                    session_id: str, plc: str = ""):
        """Non-blocking receive probe (see LocalNetworking.try_receive)."""
        from ..serde import deserialize_value

        ok, payload = self.cells.try_take(
            transfer_key(session_id, rendezvous_key)
        )
        if not ok:
            return False, None
        _net_metrics()["receives"].inc(transport="grpc")
        from .. import profiling

        with profiling.phase("serde", direction="rx"):
            return True, deserialize_value(payload, plc, self.device)
