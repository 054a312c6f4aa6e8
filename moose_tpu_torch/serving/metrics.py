"""Serving telemetry: aggregate counters + per-request latency quantiles
(the port's own copy of ``moose_tpu/serving/metrics.py``, over the
port's :mod:`moose_tpu_torch.metrics` registry).

Every dispatched batch emits a ``serve_batch`` span through the existing
``telemetry`` module (queue depth, batch size, bucket, fill ratio, plan
state as span attrs — so OTLP export and ``MOOSE_TPU_TRACE=1`` work
unchanged); this module keeps the cheap always-on aggregates a serving
loop needs without retaining span trees: batch-size histogram, batch
fill ratio, p50/p99 request latency, deadline misses, and admission
rejections.  ``retraces_after_warm`` is the acceptance hook for the
warm registry: a registered model must never re-trace once registration
finished, so it stays 0 in a healthy server (the tests and
``chip_smoke.py`` assert this).  The reference's
``validating_after_warm`` has no counterpart: the port's plans never
validate.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Optional


def _quantile(sorted_values, q: float) -> Optional[float]:
    if not sorted_values:
        return None
    # nearest-rank with rounding UP: a flooring index would report the
    # MINIMUM as "p99" for small samples (int(0.99 * 1) == 0)
    idx = min(len(sorted_values) - 1, math.ceil(q * len(sorted_values)) - 1)
    return sorted_values[max(0, idx)]


def _registry_metrics():
    """Bridge counters on the unified registry (metrics.py): the
    aggregates below stay the windowed JSON surface, while these are
    the monotone whole-process series Prometheus scrapes."""
    from .. import metrics

    return {
        "batches": metrics.counter(
            "moose_tpu_serving_batches_total",
            "micro-batches dispatched",
        ),
        "rows": metrics.counter(
            "moose_tpu_serving_rows_total", "rows served",
        ),
        "overloads": metrics.counter(
            "moose_tpu_serving_overloads_total",
            "submissions rejected by admission control (HTTP 429)",
        ),
        "deadline_misses": metrics.counter(
            "moose_tpu_serving_deadline_misses_total",
            "results delivered after their deadline",
        ),
        "deadline_drops": metrics.counter(
            "moose_tpu_serving_deadline_drops_total",
            "requests expired in queue, never batched (HTTP 504)",
        ),
        "eval_failures": metrics.counter(
            "moose_tpu_serving_eval_failures_total",
            "batches that failed evaluation",
        ),
        "latency": metrics.histogram(
            "moose_tpu_serving_request_latency_seconds",
            "request latency from submit to scatter",
        ),
        # the serve_batch latency, DECOMPOSED: queue-wait is
        # submit -> dispatch claim per request; compute is one batch's
        # evaluation.  The profiler's serve_queue_wait / serve_compute
        # phases record the identical instants, so the Perfetto
        # timeline and a Prometheus scrape agree on where serving time
        # goes.
        "queue_wait": metrics.histogram(
            "moose_tpu_serving_queue_wait_seconds",
            "per-request wait from submit to batch dispatch claim",
        ),
        "compute": metrics.histogram(
            "moose_tpu_serving_compute_seconds",
            "per-batch evaluation time (registry.evaluate)",
        ),
        # the warm-registry acceptance counter, scrapeable: the fleet
        # smoke asserts a snapshot-restored replica holds it at 0
        # from its /metrics endpoint alone (no in-process access)
        "retraces_after_warm": metrics.counter(
            "moose_tpu_serving_retraces_after_warm_total",
            "serving batches that re-entered the tracer after warmup",
        ),
        "drained": metrics.counter(
            "moose_tpu_serving_drained_requests_total",
            "queued requests completed with retryable "
            "ReplicaDrainingError during shutdown",
        ),
    }


class ServingMetrics:
    """Thread-safe aggregate serving counters (one instance per
    :class:`~moose_tpu_torch.serving.server.InferenceServer`).  Every record
    also increments the unified registry's monotone serving counters,
    so ``GET /metrics`` (Prometheus) and ``/v1/metrics`` (this
    windowed JSON snapshot) describe the same traffic."""

    def __init__(self, latency_window: int = 4096):
        self._lock = threading.Lock()
        self._registry = _registry_metrics()
        self.batches = 0
        self.rows_served = 0
        self.fill_sum = 0.0  # sum of rows/bucket over batches
        self.batch_size_hist: Dict[int, int] = {}
        self.deadline_misses = 0  # results delivered after their deadline
        self.deadline_drops = 0  # expired before dispatch, never batched
        self.overloads = 0  # submissions rejected by admission control
        self.eval_failures = 0
        self.drained_requests = 0  # completed with ReplicaDrainingError
        # acceptance counter: must stay 0 after registration
        self.retraces_after_warm = 0
        # most recent request latencies (seconds), bounded — plus the
        # two components the batcher decomposes them into
        self._latencies = deque(maxlen=latency_window)
        self._queue_waits = deque(maxlen=latency_window)
        self._computes = deque(maxlen=latency_window)

    def record_batch(self, rows: int, bucket: int,
                     retraced: bool) -> None:
        with self._lock:
            self.batches += 1
            self.rows_served += rows
            self.fill_sum += rows / float(bucket)
            self.batch_size_hist[bucket] = (
                self.batch_size_hist.get(bucket, 0) + 1
            )
            if retraced:
                self.retraces_after_warm += 1
        self._registry["batches"].inc()
        self._registry["rows"].inc(rows)
        if retraced:
            self._registry["retraces_after_warm"].inc()

    def record_latency(self, seconds: float, missed_deadline: bool) -> None:
        with self._lock:
            self._latencies.append(seconds)
            if missed_deadline:
                self.deadline_misses += 1
        self._registry["latency"].observe(seconds)
        if missed_deadline:
            self._registry["deadline_misses"].inc()

    def record_queue_wait(self, seconds: float) -> None:
        """One request's submit -> dispatch-claim wait."""
        with self._lock:
            self._queue_waits.append(seconds)
        self._registry["queue_wait"].observe(seconds)

    def record_compute(self, seconds: float) -> None:
        """One batch's evaluation time."""
        with self._lock:
            self._computes.append(seconds)
        self._registry["compute"].observe(seconds)

    def record_deadline_drop(self) -> None:
        with self._lock:
            self.deadline_drops += 1
        self._registry["deadline_drops"].inc()

    def record_overload(self) -> None:
        with self._lock:
            self.overloads += 1
        self._registry["overloads"].inc()

    def record_eval_failure(self) -> None:
        with self._lock:
            self.eval_failures += 1
        self._registry["eval_failures"].inc()

    def record_drained(self, count: int = 1) -> None:
        with self._lock:
            self.drained_requests += count
        self._registry["drained"].inc(count)

    def reset_window(self) -> None:
        """Zero the traffic aggregates (batches, fill, histogram,
        latencies, misses/drops/overloads) so a measurement window
        starts clean — e.g. bench snapshots after a warm-up loop.  The
        ``*_after_warm`` acceptance counters are NOT reset: they must
        hold over the server's whole post-registration lifetime."""
        with self._lock:
            self.batches = 0
            self.rows_served = 0
            self.fill_sum = 0.0
            self.batch_size_hist = {}
            self.deadline_misses = 0
            self.deadline_drops = 0
            self.overloads = 0
            self.eval_failures = 0
            self._latencies.clear()
            self._queue_waits.clear()
            self._computes.clear()

    def snapshot(self) -> dict:
        """One JSON-able dict of every aggregate (the ``blitzen``
        ``/v1/metrics`` payload and the bench/smoke assertion surface)."""
        with self._lock:
            lat = sorted(self._latencies)
            waits = sorted(self._queue_waits)
            computes = sorted(self._computes)
            batches = self.batches
            return {
                "batches": batches,
                "rows_served": self.rows_served,
                "batch_fill_ratio": (
                    self.fill_sum / batches if batches else None
                ),
                "batch_size_hist": dict(self.batch_size_hist),
                "request_latency_p50_s": _quantile(lat, 0.50),
                "request_latency_p99_s": _quantile(lat, 0.99),
                "queue_wait_p50_s": _quantile(waits, 0.50),
                "queue_wait_p99_s": _quantile(waits, 0.99),
                "compute_p50_s": _quantile(computes, 0.50),
                "compute_p99_s": _quantile(computes, 0.99),
                "deadline_misses": self.deadline_misses,
                "deadline_drops": self.deadline_drops,
                "overloads": self.overloads,
                "eval_failures": self.eval_failures,
                "drained_requests": self.drained_requests,
                "retraces_after_warm": self.retraces_after_warm,
            }
