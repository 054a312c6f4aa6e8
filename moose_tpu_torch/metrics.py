"""Unified metrics registry: labeled, thread-safe counters / gauges /
histograms with Prometheus text and JSON exposition.

The port's own copy of ``moose_tpu/metrics.py`` (framework-neutral:
json, re and threading; the HTTP server from the standard library),
with the same metric names, so counters such as
``moose_tpu_training_resumes_total`` read the same in both packages.
Every process exposes the one process-global catalogue two ways:

- ``render_prometheus()`` — the ``GET /metrics`` text format scraped by
  Prometheus / Grafana Alloy / any OpenMetrics collector;
- ``snapshot()`` — a JSON-able dict (the ``/v1/metrics`` payload and the
  assertion surface of tests and smoke scripts).

Design rules:

- metrics are **created on first use** (``counter(name, help)`` is
  get-or-create) so instrumented modules never need registration order;
- label sets are fixed per metric at creation; values key on the label
  *values* tuple;
- everything is guarded by one lock per registry — these are cold-path
  increments (one per epoch / commit / plan decision, not per tensor
  element), so a contended lock is not a concern;
- the registry is **process-global** (``REGISTRY``) because its job is
  whole-process exposition; tests assert on *deltas* via
  :func:`snapshot`, never on absolute values.

``serve_http(port)`` starts the stdlib exposition server: ``GET
/metrics`` serves the Prometheus text, ``GET /healthz`` a JSON health
document, ``GET /v1/metrics`` the JSON snapshot.  The JAX package's
``/debug/profile`` capture needs its ``profiling`` module, which the
port has not taken yet (ROADMAP queue 1, item 13): that path answers
404 here.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-shaped default buckets (seconds), doubling from 1ms to ~65s
DEFAULT_BUCKETS = tuple(0.001 * 2 ** i for i in range(17))


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


class _Metric:
    """Shared shape for one named metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = lock
        self._values: Dict[Tuple[str, ...], float] = {}

    def _label_key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels "
                f"{sorted(self.label_names)}, got {sorted(labels)}"
            )
        return tuple(str(labels[n]) for n in self.label_names)

    # -- exposition ----------------------------------------------------

    def _render_series(self, key: Tuple[str, ...], value) -> str:
        if self.label_names:
            labels = ",".join(
                f'{n}="{_escape_label_value(v)}"'
                for n, v in zip(self.label_names, key)
            )
            return f"{self.name}{{{labels}}} {_fmt(value)}"
        return f"{self.name} {_fmt(value)}"

    def render(self) -> list:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._values):
            lines.append(self._render_series(key, self._values[key]))
        return lines

    def snapshot_values(self):
        return {
            ",".join(
                f"{n}={v}" for n, v in zip(self.label_names, key)
            ): value
            for key, value in self._values.items()
        }


def _fmt(value: float) -> str:
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc {amount})"
            )
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._values.get(key, 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._values.get(key, 0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus model: ``_bucket``
    series carry counts of observations ``<= le``, plus ``_sum`` and
    ``_count``)."""

    kind = "histogram"

    def __init__(self, name, help, label_names, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label key: [counts per bucket] + [sum, count]
        self._hist: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._label_key(labels)
        with self._lock:
            state = self._hist.get(key)
            if state is None:
                state = self._hist[key] = [
                    [0] * len(self.buckets), 0.0, 0,
                ]
            counts, total, n = state
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            state[1] = total + value
            state[2] = n + 1

    def render(self) -> list:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._hist):
            counts, total, n = self._hist[key]
            base = list(zip(self.label_names, key))
            for bound, count in zip(self.buckets, counts):
                labels = ",".join(
                    f'{ln}="{_escape_label_value(lv)}"'
                    for ln, lv in base + [("le", _fmt(bound))]
                )
                lines.append(f"{self.name}_bucket{{{labels}}} {count}")
            inf_labels = ",".join(
                f'{ln}="{_escape_label_value(lv)}"'
                for ln, lv in base + [("le", "+Inf")]
            )
            lines.append(f"{self.name}_bucket{{{inf_labels}}} {n}")
            suffix = (
                "{" + ",".join(
                    f'{ln}="{_escape_label_value(lv)}"' for ln, lv in base
                ) + "}"
                if base
                else ""
            )
            lines.append(f"{self.name}_sum{suffix} {_fmt(total)}")
            lines.append(f"{self.name}_count{suffix} {n}")
        return lines

    def snapshot_values(self):
        out = {}
        for key, (counts, total, n) in self._hist.items():
            label = ",".join(
                f"{ln}={lv}" for ln, lv in zip(self.label_names, key)
            )
            out[label] = {"sum": total, "count": n}
        return out


class MetricsRegistry:
    """One process-wide catalogue of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help, label_names, self._lock, **kwargs)
                self._metrics[name] = metric
                return metric
        if not isinstance(metric, cls):
            raise ValueError(
                f"metric {name!r} already registered as {metric.kind}"
            )
        if metric.label_names != label_names:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{metric.label_names}, requested {label_names}"
            )
        return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def render_prometheus(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
            lines = []
            for metric in metrics:
                lines.extend(metric.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "type": metric.kind,
                    "values": metric.snapshot_values(),
                }
                for name, metric in sorted(self._metrics.items())
            }

    def get(self, name: str) -> Optional[_Metric]:
        """The registered family, or None (assertion / snapshot-delta
        surface: ``REGISTRY.get(n).value(**labels)``)."""
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default: float = 0, **labels) -> float:
        """Current value of a counter/gauge series, or ``default`` when
        the family or series doesn't exist yet (bench/smoke delta
        helper)."""
        metric = self.get(name)
        if metric is None or not hasattr(metric, "value"):
            return default
        try:
            return metric.value(**labels)
        except ValueError:
            return default

    def reset(self) -> None:
        """Drop every registered family (tests only — production code
        relies on create-on-first-use, so a reset mid-flight only loses
        history, never breaks instrumentation)."""
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def snapshot() -> dict:
    return REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# HTTP exposition
# ---------------------------------------------------------------------------


class MetricsServer:
    """Stdlib HTTP exposition server on a daemon thread.

    ``GET /metrics`` — Prometheus text (the scrape target);
    ``GET /v1/metrics`` — the JSON snapshot;
    ``GET /healthz`` — ``{"status": "ok", **health_extra}``.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 health_extra: Optional[dict] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = registry if registry is not None else REGISTRY
        extra = dict(health_extra or {})

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, body: bytes,
                       content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are periodic noise
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    self._reply(
                        200,
                        registry.render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/v1/metrics":
                    self._reply(
                        200,
                        json.dumps(registry.snapshot()).encode(),
                        "application/json",
                    )
                elif self.path == "/healthz":
                    self._reply(
                        200,
                        json.dumps({"status": "ok", **extra}).encode(),
                        "application/json",
                    )
                else:
                    self._reply(
                        404,
                        json.dumps(
                            {"error": "NotFound", "path": self.path}
                        ).encode(),
                        "application/json",
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"moose-metrics-{self.port}",
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def serve_http(port: int, host: str = "127.0.0.1",
               health_extra: Optional[dict] = None) -> MetricsServer:
    """Start the metrics exposition server; returns it (``.port`` is
    resolved when ``port`` was 0)."""
    return MetricsServer(port, host=host, health_extra=health_extra)
