"""Tracing / profiling spans (reference aux subsystem: ``tracing`` crate
spans + Jaeger export behind the ``telemetry`` feature, ``reindeer.rs:7-30``,
and per-role elapsed-time surfaced to Python,
``choreography/grpc.rs:26-30,186-192`` + ``pymoose/src/bindings.rs:320-328``).

The port's own copy of ``moose_tpu/telemetry.py`` (framework-neutral;
its OTLP counters go to the port's :mod:`.metrics`).  The reference
traces one span per async op task; here the interesting phases are
*trace → compile → execute*: the runtime opens ``evaluate_computation``,
``trace``, ``compile`` (a lowering), ``evaluate_compiled`` and
``execute`` (which closes once the outputs are numpy on the host, so it
covers the card's work), each compiler pass a ``pass:<name>``, and under
``MOOSE_TPU_TRACE_OPS=1`` each op of an eager walk an ``op:<kind>``.  We
record a lightweight span tree per top-level entry point:

- always-on, bounded: only the most recent completed root span tree is
  retained (no unbounded accumulation in serving loops);
- ``span("name")`` context manager nests via a thread-local stack, so
  worker threads get independent trees;
- ``last_trace()`` returns the tree, ``report()`` pretty-prints it,
  ``to_json()`` exports it for external tooling (the Jaeger analogue —
  zero-egress environments get a file instead of a collector);
- ``MOOSE_TPU_TRACE=1`` additionally prints every completed root tree to
  stderr, the moral equivalent of ``RUST_LOG=debug`` on the reference
  binaries;
- ``configure_otlp(endpoint)`` (or ``MOOSE_TPU_OTLP=http://host:4318``,
  or ``comet --telemetry``) exports every completed root tree to an
  OTLP/HTTP collector (Jaeger, Grafana Tempo, otel-collector, ...) —
  the counterpart of the reference's ``telemetry`` feature that ships
  worker spans to Jaeger (``reindeer.rs:7-30``, ``comet.rs:30-41``).
  The exporter is stdlib-only (urllib on a daemon thread), never blocks
  the caller, and drops batches rather than stall a worker.

**Distributed trace propagation** (Dapper-style): every span carries a
stable ``trace_id`` / ``span_id`` minted at creation.  A root span
adopts the thread's ambient :class:`TraceContext` (installed with
:func:`use_context`) as its parent, so one logical session exports as
ONE stitched trace: the client supervisor mints a context per session
attempt, ships it in the launch rpc, workers adopt it around
``execute_role``, and background threads (async sender, receive
prefetcher, failure detector, batch scheduler) inherit the enclosing
context instead of starting orphan roots.  :func:`current_context`
captures the innermost active span as a context to hand to a thread or
a peer.

Runtimes surface coarse phase timings as ``runtime.last_timings``
(micros, like the reference's per-role map).
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# maps perf_counter timestamps (span clock) onto the unix epoch for OTLP
_EPOCH_OFFSET_S = time.time() - time.perf_counter()


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class TraceContext:
    """Propagatable trace position: the trace every new root joins and
    the span id it hangs under.  Wire shape is a plain two-key dict so
    it rides msgpack/JSON launch messages unchanged."""

    trace_id: str
    span_id: str

    @staticmethod
    def new() -> "TraceContext":
        return TraceContext(_new_trace_id(), _new_span_id())

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_dict(raw) -> Optional["TraceContext"]:
        if not isinstance(raw, dict):
            return None
        trace_id = raw.get("trace_id")
        span_id = raw.get("span_id")
        if not trace_id or not span_id:
            return None
        return TraceContext(str(trace_id), str(span_id))


@dataclass
class Span:
    name: str
    start_s: float
    end_s: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)
    # stable ids minted at creation (OTLP export and cross-party
    # stitching use these; a root under an ambient TraceContext carries
    # the REMOTE parent's span id in parent_span_id)
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: Optional[str] = None

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    @property
    def duration_micros(self) -> int:
        return int(self.duration_s * 1e6)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_micros": self.duration_micros,
            "attrs": self.attrs,
            "children": [c.to_dict() for c in self.children],
        }

    def find(self, name: str) -> Optional["Span"]:
        """First span with `name` in this subtree (depth-first)."""
        if self.name == name:
            return self
        for child in self.children:
            found = child.find(name)
            if found is not None:
                return found
        return None


class _State(threading.local):
    def __init__(self):
        self.stack: List[Span] = []
        self.last_root: Optional[Span] = None
        # ambient TraceContext adopted by root spans on this thread
        # (installed with use_context; inherited by worker/background
        # threads so their spans stitch into the session trace)
        self.context: Optional[TraceContext] = None


_state = _State()


def current_context() -> Optional[TraceContext]:
    """The innermost active span as a TraceContext (to hand to a
    thread or ship to a peer), or the thread's ambient context when no
    span is open, or None."""
    if _state.stack:
        s = _state.stack[-1]
        return TraceContext(s.trace_id, s.span_id)
    return _state.context


@contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Install ``ctx`` as this thread's ambient trace context: root
    spans opened inside become children of ``ctx.span_id`` in
    ``ctx.trace_id`` instead of minting fresh orphan traces.  ``None``
    restores orphan-root behaviour (useful to scope a worker thread
    back out of an adopted session)."""
    prev = _state.context
    _state.context = ctx
    try:
        yield ctx
    finally:
        _state.context = prev


def _echo_enabled() -> bool:
    return os.environ.get("MOOSE_TPU_TRACE", "0") not in ("0", "")


# Completed-span hook: the profiling module (moose_tpu/profiling.py)
# installs one while a capture window is active, so EVERY span — not
# just roots — lands on its timeline with the propagated trace ids.
# One None check on the span-close path when no profiler runs.
_span_hook = None


def set_span_hook(hook) -> None:
    """Install (or clear, with ``None``) the completed-span callback.
    Owned by the profiling module; the hook must never raise."""
    global _span_hook
    _span_hook = hook


def trace_ops_enabled() -> bool:
    """Per-op spans in eager execution (MOOSE_TPU_TRACE_OPS; read when a
    computation's plan is built)."""
    return os.environ.get("MOOSE_TPU_TRACE_OPS", "0") not in ("0", "")


@contextmanager
def span(name: str, **attrs):
    """Record a timed span; nests under the enclosing span, if any.
    Roots adopt the thread's ambient :class:`TraceContext` (see
    :func:`use_context`) so distributed children stitch into the
    session trace."""
    s = Span(name=name, start_s=time.perf_counter(), attrs=dict(attrs))
    parent = _state.stack[-1] if _state.stack else None
    s.span_id = _new_span_id()
    if parent is not None:
        s.trace_id = parent.trace_id
        s.parent_span_id = parent.span_id
    elif _state.context is not None:
        s.trace_id = _state.context.trace_id
        s.parent_span_id = _state.context.span_id
    else:
        s.trace_id = _new_trace_id()
    _state.stack.append(s)
    try:
        yield s
    finally:
        s.end_s = time.perf_counter()
        _state.stack.pop()
        hook = _span_hook
        if hook is not None:
            try:
                hook(s)
            except Exception:  # noqa: BLE001 — observability must never
                pass  # fail the operation it observes
        if parent is not None:
            parent.children.append(s)
        else:
            _state.last_root = s
            if _echo_enabled():
                report(file=sys.stderr)
            exporter = _get_exporter()
            if exporter is not None:
                exporter.export(s)


def last_trace() -> Optional[Span]:
    """The most recent completed root span tree on this thread."""
    return _state.last_root


def to_json() -> str:
    root = _state.last_root
    return json.dumps(root.to_dict() if root is not None else None)


def report(file=None) -> None:
    """Pretty-print the last completed root span tree."""
    root = _state.last_root
    out = file if file is not None else sys.stderr

    def emit(s: Span, depth: int):
        pad = "  " * depth
        attrs = (
            " " + " ".join(f"{k}={v}" for k, v in s.attrs.items())
            if s.attrs
            else ""
        )
        print(
            f"{pad}{s.name}: {s.duration_s * 1e3:.3f} ms{attrs}", file=out
        )
        for child in s.children:
            emit(child, depth + 1)

    if root is None:
        print("(no trace recorded)", file=out)
    else:
        emit(root, 0)


# ---------------------------------------------------------------------------
# OTLP/HTTP span export (reference: tracing-opentelemetry + Jaeger agent
# behind the `telemetry` feature, reindeer.rs:7-30; enabled per worker by
# `comet --telemetry`, comet.rs:30-41).  Stdlib-only: spans are encoded
# with the OTLP JSON mapping and POSTed to {endpoint}/v1/traces from a
# daemon thread so a slow or absent collector can never stall a worker.
# ---------------------------------------------------------------------------


def _otlp_attr_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP JSON carries int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: Dict[str, Any]) -> list:
    return [
        {"key": str(k), "value": _otlp_attr_value(v)}
        for k, v in attrs.items()
    ]


class OtlpExporter:
    """Exports completed root span trees to an OTLP/HTTP collector."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "moose_tpu",
        timeout_s: float = 2.0,
        max_queue: int = 256,
    ):
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/v1/traces"):
            self.endpoint += "/v1/traces"
        self.service_name = service_name
        self.timeout_s = timeout_s
        self.dropped = 0
        self.exported = 0
        self.last_error: Optional[str] = None
        self._q: "queue.Queue[Optional[Span]]" = queue.Queue(
            maxsize=max_queue
        )
        self._thread = threading.Thread(
            target=self._drain, daemon=True, name="otlp-export"
        )
        self._thread.start()

    # -- producer side (span completion; must never block) --
    def export(self, root: Span) -> None:
        try:
            self._q.put_nowait(root)
        except queue.Full:
            self.dropped += 1
            from . import metrics

            metrics.counter(
                "moose_tpu_otlp_dropped_total",
                "root span trees dropped (full queue or collector error)",
            ).inc()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until everything queued so far has been sent (tests).
        Returns False (instead of blocking past ``timeout_s``) when the
        queue stays full or the drain doesn't finish in time — the
        "never blocks the caller" contract holds here too."""
        # an event sentinel rides the queue behind everything already
        # enqueued; when the worker reaches it, all prior batches have
        # finished their POSTs.  The enqueue itself must not block on a
        # full queue (a dead drain thread would park the caller forever
        # on a blocking put), so it retries put_nowait under the SAME
        # deadline as the wait — the whole call is bounded by timeout_s.
        deadline = time.monotonic() + timeout_s
        done = threading.Event()
        if not self._put_until(done, deadline):
            return False
        return done.wait(max(0.0, deadline - time.monotonic()))

    def _put_with_deadline(self, item, timeout_s: float) -> bool:
        return self._put_until(item, time.monotonic() + timeout_s)

    def _put_until(self, item, deadline: float) -> bool:
        while True:
            try:
                self._q.put_nowait(item)
                return True
            except queue.Full:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.01)

    def shutdown(self) -> None:
        """Stop the drain thread (after finishing everything queued).
        Best effort on a wedged full queue: give up rather than hang."""
        if self._put_with_deadline(_SHUTDOWN, 5.0):
            self._thread.join(timeout=5.0)

    # -- consumer side --
    def _drain(self) -> None:
        from . import metrics

        exported_c = metrics.counter(
            "moose_tpu_otlp_exported_total",
            "root span trees successfully POSTed to the OTLP collector",
        )
        dropped_c = metrics.counter(
            "moose_tpu_otlp_dropped_total",
            "root span trees dropped (full queue or collector error)",
        )
        while True:
            root = self._q.get()
            if root is _SHUTDOWN:
                return
            if isinstance(root, threading.Event):
                root.set()
                continue
            try:
                self._post(self.encode(root))
                self.exported += 1
                exported_c.inc()
            except Exception as e:  # collector down: drop, remember why
                self.dropped += 1
                dropped_c.inc()
                self.last_error = str(e)

    def _post(self, payload: dict) -> None:
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=self.timeout_s).read()

    def encode(self, root: Span) -> dict:
        """One root tree -> one OTLP resourceSpans payload.  Uses the
        spans' PROPAGATED ids (minted at span creation, inherited from
        the ambient TraceContext across threads and parties) so a
        3-party session exports one stitched trace — not a fresh random
        trace per exporting process."""
        trace_id = root.trace_id or _new_trace_id()
        spans: List[dict] = []

        def walk(s: Span, parent_id: Optional[str]) -> None:
            span_id = s.span_id or _new_span_id()
            start_ns = int((s.start_s + _EPOCH_OFFSET_S) * 1e9)
            end_ns = int((s.end_s + _EPOCH_OFFSET_S) * 1e9)
            rec = {
                "traceId": s.trace_id or trace_id,
                "spanId": span_id,
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(end_ns),
                "attributes": _otlp_attrs(s.attrs),
            }
            if parent_id is not None:
                rec["parentSpanId"] = parent_id
            spans.append(rec)
            for child in s.children:
                walk(child, span_id)

        # the root's REMOTE parent (the client's attempt span) arrives
        # through its parent_span_id — minted locally only for true
        # orphans
        walk(root, root.parent_span_id)
        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": _otlp_attrs(
                            {"service.name": self.service_name}
                        )
                    },
                    "scopeSpans": [
                        {"scope": {"name": "moose_tpu"}, "spans": spans}
                    ],
                }
            ]
        }


_SHUTDOWN = object()
_exporter: Optional[OtlpExporter] = None
_exporter_env_checked = False
_exporter_lock = threading.Lock()
_atexit_registered = False


def _register_atexit() -> None:
    """Drain the export queue at interpreter exit so spans completed just
    before shutdown still reach the collector (daemon threads would
    otherwise be killed mid-queue)."""
    global _atexit_registered
    if _atexit_registered:
        return
    import atexit

    def _flush_on_exit():
        exp = _exporter
        if exp is not None:
            exp.flush(timeout_s=3.0)

    atexit.register(_flush_on_exit)
    _atexit_registered = True


def configure_otlp(
    endpoint: str, service_name: str = "moose_tpu"
) -> OtlpExporter:
    """Install the global OTLP exporter; completed root span trees are
    shipped to ``endpoint`` from now on.  Returns the exporter (tests use
    ``.flush()``/``.exported``)."""
    global _exporter, _exporter_env_checked
    with _exporter_lock:
        if _exporter is not None:
            _exporter.shutdown()
        _exporter = OtlpExporter(endpoint, service_name=service_name)
        _exporter_env_checked = True
        _register_atexit()
        return _exporter


def disable_otlp() -> None:
    global _exporter, _exporter_env_checked
    with _exporter_lock:
        if _exporter is not None:
            _exporter.shutdown()
        _exporter = None
        _exporter_env_checked = True


def _get_exporter() -> Optional[OtlpExporter]:
    """Active exporter, lazily honouring MOOSE_TPU_OTLP on first use."""
    global _exporter, _exporter_env_checked
    if _exporter is not None or _exporter_env_checked:
        return _exporter
    with _exporter_lock:
        if not _exporter_env_checked:
            _exporter_env_checked = True
            endpoint = os.environ.get("MOOSE_TPU_OTLP")
            if endpoint:
                _exporter = OtlpExporter(
                    endpoint,
                    service_name=os.environ.get(
                        "MOOSE_TPU_OTLP_SERVICE", "moose_tpu"
                    ),
                )
                _register_atexit()
    return _exporter


_MISSING = object()


def _find_attr(s: Optional[Span], key: str):
    if s is None:
        return _MISSING
    if key in s.attrs:
        return s.attrs[key]
    for child in s.children:
        value = _find_attr(child, key)
        if value is not _MISSING:
            return value
    return _MISSING


def find_attr(root: Optional[Span], key: str, default=None):
    """Depth-first search of a span tree for the first span carrying
    attribute ``key``; returns that attribute's value.  Runtimes use
    this to lift executor-level plan attributes (``plan_mode``,
    ``pinned_ops`` — set on the ``execute`` span by both local
    interpreters) into ``last_timings`` without coupling to which
    executor actually ran."""
    value = _find_attr(root, key)
    return default if value is _MISSING else value


def phase_timings(root: Optional[Span] = None) -> Dict[str, int]:
    """Flatten a span tree into a {name: duration_micros} map — the Local
    analogue of the reference's per-role elapsed-time map.  Durations of
    same-named spans accumulate (e.g. a pass listed twice reports the sum
    of both runs)."""
    root = root if root is not None else _state.last_root
    timings: Dict[str, int] = {}

    def walk(s: Span):
        timings[s.name] = timings.get(s.name, 0) + s.duration_micros
        for child in s.children:
            walk(child)

    if root is not None:
        walk(root)
    return timings
