"""Timeline profiler: where the time (wall and device) goes, as a
Perfetto/Chrome trace stitched to the session trace ids.

The port's own copy of ``moose_tpu/profiling.py`` (the same phase
taxonomy, event fields and trace ids, so one reader reads a trace of
either package).  A low-overhead recorder attributes wall time (and, at
segment boundaries, device time through :func:`fence`) to a fixed
taxonomy of named phases:

===================  =====================================================
phase                recorded by
===================  =====================================================
``trace``            eDSL tracing (runtime span, via the span hook)
``compile``          lowering-pipeline compiles (runtime span)
``build_plan``       executor plan construction (interpreter span)
``bind_arguments``   host->device argument upload (interpreter span)
``execute``          one local evaluation, end to end (interpreter span)
``ladder_validate``  validated-jit self-check comparisons (the JAX
                     package's; the port compiles nothing)
``segment_execute``  one plan segment, device-fenced
``worker_segment``   one distributed worker segment (worker span)
``pallas_selfcheck`` first-use kernel check (the JAX package's)
``pallas_dispatch``  instant marker: a primitive routed into its kernel
``host_transfer``    device->host materialization of outputs/saves
``serde``            wire codec serialize/deserialize of one payload
``net_send``         one transmission unit (single send or envelope)
``net_receive``      orchestrator wait for one prefetched receive
``serve_queue_wait`` batcher: submit -> dispatch claim, per request
``serve_compute``    batcher: one micro-batch evaluation, device-fenced
``run_computation``  client session supervisor (and its ``attempt`` /
                     ``launch`` / ``retrieve`` / ``backoff`` children)
``execute_role``     one worker's whole role execution (worker span)
``serve_batch``      one dispatched micro-batch (batcher span)
===================  =====================================================

Design rules:

- **Off by default, near-zero cost when off**: every hook is a single
  module-global ``None`` check.
- **One pipeline with telemetry**: an active profiler installs a span
  hook (:func:`telemetry.set_span_hook`), so every span (``execute``,
  ``execute_role``, ``worker_segment``, ``serve_batch``, the client
  supervisor tree, ...) lands in the timeline with its ``trace_id``.
- **Device time is fenced**: CUDA launches return before the card has
  run them, so a phase that should own device time calls :func:`fence`
  on its results before closing; it waits on the current CUDA stream of
  each CUDA tensor's device, and only while a profiler is active.  All
  work of one process shares that stream, so a fenced phase of one
  in-process worker also waits for its peers' queued work.
- **Device annotation**: while the process has initialized CUDA, each
  phase is also an NVTX range (``torch.cuda.nvtx``), labelling the
  device timeline for a vendor profiler; elsewhere none is opened.
- **Summaries ride the metrics registry**: each closed phase observes
  ``moose_tpu_phase_seconds{phase=...}`` while profiling is active.

Activation: ``MOOSE_TPU_PROFILE=/path/trace.json`` (whole process,
written at exit and on :func:`stop`), :func:`start` / :func:`stop`, or
``GET /debug/profile?seconds=N`` on blitzen and on a worker's metrics
port (one capture at a time; a concurrent one gets a typed busy error).

Load the output at https://ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# maps perf_counter timestamps onto the unix epoch (same convention as
# telemetry's OTLP export, so the two timelines line up)
_EPOCH_OFFSET_S = time.time() - time.perf_counter()

_DEFAULT_MAX_EVENTS = 200_000


class ProfilerBusyError(RuntimeError):
    """A capture window is already running (one at a time: overlapping
    windows would interleave their event streams)."""


class Profiler:
    """Bounded in-memory timeline; one per capture window."""

    def __init__(self, path: Optional[str] = None,
                 max_events: int = _DEFAULT_MAX_EVENTS):
        self.path = path
        self.max_events = max(1024, int(max_events))
        self.started_s = time.perf_counter()
        self.stopped_s: Optional[float] = None
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}
        self._pid = os.getpid()

    # -- producer side -------------------------------------------------

    def _append(self, event: dict) -> None:
        tid = threading.get_ident()
        event["pid"] = self._pid
        event["tid"] = tid
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(event)

    def record_complete(self, name: str, start_s: float, end_s: float,
                        cat: str = "phase",
                        args: Optional[dict] = None) -> None:
        """One Chrome ``"X"`` (complete) event from perf_counter
        seconds."""
        self._append({
            "name": str(name),
            "cat": cat,
            "ph": "X",
            "ts": (start_s + _EPOCH_OFFSET_S) * 1e6,
            "dur": max(0.0, (end_s - start_s) * 1e6),
            "args": dict(args or {}),
        })

    def record_instant(self, name: str, cat: str = "mark",
                       args: Optional[dict] = None) -> None:
        self._append({
            "name": str(name),
            "cat": cat,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": (time.perf_counter() + _EPOCH_OFFSET_S) * 1e6,
            "args": dict(args or {}),
        })

    # -- consumer side -------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """The Perfetto/Chrome-trace JSON document (loadable at
        ui.perfetto.dev / chrome://tracing)."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self._pid,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(names.items())
        ]
        end_s = (
            self.stopped_s if self.stopped_s is not None
            else time.perf_counter()
        )
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "moose_tpu_torch.profiling",
                "started_unix_s": self.started_s + _EPOCH_OFFSET_S,
                "duration_s": end_s - self.started_s,
                "dropped_events": self.dropped,
            },
        }

    def summary(self) -> Dict[str, dict]:
        """{phase: {"count", "total_s"}} over the recorded window."""
        out: Dict[str, dict] = {}
        with self._lock:
            events = list(self._events)
        for e in events:
            if e.get("ph") != "X":
                continue
            entry = out.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            entry["count"] += 1
            entry["total_s"] += e.get("dur", 0.0) / 1e6
        return out

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no output path configured for this profiler")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome_trace(), fh)
        return path


# ---------------------------------------------------------------------------
# module-global activation (the hot-path flag every hook checks)
# ---------------------------------------------------------------------------

_active: Optional[Profiler] = None
_env_checked = False
_state_lock = threading.Lock()
_atexit_registered = False

_PHASE_HISTOGRAM = None


def _phase_histogram():
    global _PHASE_HISTOGRAM
    if _PHASE_HISTOGRAM is None:
        from . import metrics

        _PHASE_HISTOGRAM = metrics.histogram(
            "moose_tpu_phase_seconds",
            "per-phase wall/device seconds while a profile capture is "
            "active (the Prometheus summary of the Perfetto timeline)",
            labels=("phase",),
        )
    return _PHASE_HISTOGRAM


def active() -> Optional[Profiler]:
    """The active profiler, honouring ``MOOSE_TPU_PROFILE`` lazily on
    first use (same discipline as the OTLP exporter)."""
    global _env_checked
    prof = _active
    if prof is not None or _env_checked:
        return prof
    with _state_lock:
        if not _env_checked:
            _env_checked = True
            path = os.environ.get("MOOSE_TPU_PROFILE")
            if path:
                _start_locked(path, from_env=True)
    return _active


def _install_span_hook(prof: Profiler) -> None:
    from . import telemetry

    def on_span(span) -> None:
        args: Dict[str, Any] = {
            k: v for k, v in span.attrs.items()
            if isinstance(v, (str, int, float, bool))
        }
        if span.trace_id:
            args["trace_id"] = span.trace_id
            args["span_id"] = span.span_id
        prof.record_complete(
            span.name, span.start_s, span.end_s, cat="span", args=args
        )
        _phase_histogram().observe(span.duration_s, phase=span.name)

    telemetry.set_span_hook(on_span)


def _start_locked(path: Optional[str], from_env: bool = False) -> Profiler:
    global _active, _atexit_registered
    prof = Profiler(path=path)
    prof.from_env = from_env
    _active = prof
    _install_span_hook(prof)
    if path and not _atexit_registered:
        import atexit

        def _save_on_exit():
            p = _active
            if p is not None and p.path:
                p.stopped_s = time.perf_counter()
                try:
                    p.save()
                except OSError:
                    pass

        atexit.register(_save_on_exit)
        _atexit_registered = True
    return prof


def start(path: Optional[str] = None,
          max_events: int = _DEFAULT_MAX_EVENTS) -> Profiler:
    """Begin a capture window.  Raises :class:`ProfilerBusyError` when
    one is already running (overlapping windows would interleave)."""
    global _env_checked
    with _state_lock:
        _env_checked = True
        if _active is not None:
            raise ProfilerBusyError(
                "a profile capture is already active; stop() it first"
            )
        prof = _start_locked(path)
        prof.max_events = max(1024, int(max_events))
        return prof


def stop() -> Optional[dict]:
    """End the capture window; returns the Perfetto JSON document (and
    writes it to the profiler's path, if one was configured).  When the
    stopped window was a programmatic one (``start()`` / ``capture()``)
    and ``MOOSE_TPU_PROFILE`` requests a whole-process profile, that
    env profile resumes immediately — a bounded endpoint capture must
    not silently cancel the operator's process-lifetime trace (events
    recorded before/while the programmatic window ran are not in it)."""
    global _active, _env_checked
    with _state_lock:
        prof = _active
        if prof is None:
            return None
        _active = None
        from . import telemetry

        telemetry.set_span_hook(None)
        if (
            not getattr(prof, "from_env", False)
            and os.environ.get("MOOSE_TPU_PROFILE")
        ):
            _env_checked = False
    prof.stopped_s = time.perf_counter()
    if prof.path:
        try:
            prof.save()
        except OSError:
            pass
    trace = prof.to_chrome_trace()
    if not _env_checked:
        active()  # resume the env-requested whole-process profile
    return trace


def capture(seconds: float, max_events: int = _DEFAULT_MAX_EVENTS) -> dict:
    """Profile the live process for ``seconds`` and return the Perfetto
    JSON — the ``/debug/profile?seconds=N`` endpoint body.  Bounded and
    exclusive: raises :class:`ProfilerBusyError` while another window
    (endpoint or ``MOOSE_TPU_PROFILE``) is running."""
    seconds = min(max(0.05, float(seconds)), 300.0)
    start(max_events=max_events)
    try:
        time.sleep(seconds)
    finally:
        trace = stop()
    return trace if trace is not None else {"traceEvents": []}


# ---------------------------------------------------------------------------
# the instrumentation hooks (no-ops while inactive)
# ---------------------------------------------------------------------------


def _trace_args(args: dict) -> dict:
    """Stitch the ambient telemetry trace id into a phase's args."""
    from . import telemetry

    ctx = telemetry.current_context()
    if ctx is not None:
        args["trace_id"] = ctx.trace_id
    return args


@contextmanager
def phase(name: str, **args):
    """Record one named phase.  A no-op (single None check) while no
    profiler is active — safe on hot paths."""
    prof = _active if _env_checked else active()
    if prof is None:
        yield
        return
    start_s = time.perf_counter()
    annotation = _device_annotation(name)
    try:
        if annotation is not None:
            with annotation:
                yield
        else:
            yield
    finally:
        end_s = time.perf_counter()
        prof.record_complete(
            name, start_s, end_s, args=_trace_args(dict(args))
        )
        _phase_histogram().observe(end_s - start_s, phase=name)


def record_complete(name: str, start_s: float, end_s: float,
                    **args) -> None:
    """Record a phase whose boundaries were measured elsewhere (e.g. the
    batcher's queue-wait: submit instant -> dispatch claim)."""
    prof = _active if _env_checked else active()
    if prof is None:
        return
    prof.record_complete(name, start_s, end_s, args=_trace_args(dict(args)))
    _phase_histogram().observe(max(0.0, end_s - start_s), phase=name)


def record_instant(name: str, **args) -> None:
    prof = _active if _env_checked else active()
    if prof is None:
        return
    prof.record_instant(name, args=_trace_args(dict(args)))


def fence(*trees) -> None:
    """Wait until the card has run the work that produces every CUDA
    tensor leaf of ``trees``: a synchronize of the current stream of each
    leaf's device.  Only while a profiler is active, so the enclosing
    phase owns its device time instead of whichever later call first
    synchronizes; the un-profiled path never pays this barrier."""
    if (_active if _env_checked else active()) is None:
        return
    import torch

    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for item in v.values():
                walk(item)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name, None))

    walk(trees)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def _device_annotation(name: str):
    """An NVTX range named ``name`` while this process has initialized
    CUDA (its run is on the card), so phases also label the device
    timeline when a vendor profiler is attached; None elsewhere."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.nvtx.range(name)


# ---------------------------------------------------------------------------
# HTTP endpoint helper (blitzen + metrics.MetricsServer /debug/profile)
# ---------------------------------------------------------------------------


def handle_profile_request(query: str) -> tuple:
    """Shared ``/debug/profile`` handler: parse ``seconds=N`` from the
    query string, run a capture, return ``(status, payload_dict)``.
    ``409`` while another capture is active, ``400`` on a bad param."""
    from urllib.parse import parse_qs

    params = parse_qs(query or "")
    raw = (params.get("seconds") or ["2"])[0]
    try:
        seconds = float(raw)
    except ValueError:
        return 400, {
            "error": "ValueError",
            "message": f"seconds must be a number, got {raw!r}",
        }
    try:
        return 200, capture(seconds)
    except ProfilerBusyError as e:
        return 409, {"error": "ProfilerBusyError", "message": str(e)}
