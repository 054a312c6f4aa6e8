"""Dynamic micro-batching scheduler, the port's own copy of
``moose_tpu/serving/batcher.py``.

One :class:`ModelQueue` per registered model: a bounded pending-request
queue plus a scheduler thread that coalesces concurrent requests into
the batch sizes the device is fast at.  The scheduler thread is the only
thread that evaluates (and so launches device work); callers' threads
enqueue numpy rows and get numpy rows back.  The dispatch policy:

- a batch OPENS when the first request arrives and DISPATCHES when it
  holds ``max_batch`` rows or ``max_wait_ms`` has elapsed since it
  opened, whichever comes first (an idle queue costs nothing — the
  scheduler blocks on a condition variable, no polling);
- assembled rows are padded to the smallest registered power-of-two
  bucket, so every evaluation replays a warm compiled plan instead of
  recompiling for each distinct batch size;
- per-row results scatter back to the per-request futures;
- admission control: a full queue rejects ``submit`` with typed
  :class:`~moose_tpu_torch.errors.ServerOverloadedError` immediately (callers
  shed load; nothing ever blocks on a full queue);
- requests whose deadline expired while queued are completed with
  :class:`~moose_tpu_torch.errors.DeadlineExceededError` and are NEVER given
  batch rows — an expired request cannot contaminate (or consume
  capacity in) a batch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import telemetry
from ..errors import (
    ConfigurationError,
    DeadlineExceededError,
    ReplicaDrainingError,
    ServerOverloadedError,
)
from .config import ServingConfig
from .metrics import ServingMetrics
from .registry import ModelRegistry, RegisteredModel


@dataclass
class _Request:
    rows: np.ndarray  # (k, *row_shape), k >= 1
    future: Future
    enqueued_s: float
    deadline_s: Optional[float]  # absolute perf_counter seconds

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s


@dataclass
class ModelQueue:
    """Bounded queue + scheduler thread for one registered model."""

    model: RegisteredModel
    registry: ModelRegistry
    config: ServingConfig
    metrics: ServingMetrics
    _pending: deque = field(default_factory=deque)
    _pending_rows: int = 0

    def __post_init__(self):
        self._cv = threading.Condition()
        self._closed = False
        self._draining = False
        # batches popped from _pending but not yet fully dispatched:
        # drain() must wait on BOTH (a request leaves _pending before
        # its evaluation runs)
        self._in_flight = 0
        # the scheduler thread inherits the registration-time trace
        # context (if any): its serve_batch roots stitch under the
        # server's trace instead of starting orphan roots per batch
        self._trace_ctx = telemetry.current_context()
        self._thread = threading.Thread(
            target=self._loop_in_ctx,
            daemon=True,
            name=f"serve-{self.model.name}",
        )
        self._thread.start()

    def _loop_in_ctx(self) -> None:
        with telemetry.use_context(self._trace_ctx):
            self._loop()

    # -- client side -------------------------------------------------------

    def submit(self, rows: np.ndarray,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request (``rows`` of shape ``(k, *row_shape)`` or
        a single row of ``row_shape``); returns its Future.  Raises
        ``ServerOverloadedError`` synchronously when the queue is full
        and ``ConfigurationError`` on shape mismatch."""
        rows = np.asarray(rows, dtype=np.float64)
        if rows.shape == self.model.row_shape:
            rows = rows[np.newaxis]
        if rows.ndim < 1 or rows.shape[1:] != self.model.row_shape:
            raise ConfigurationError(
                f"model {self.model.name!r} expects rows of shape "
                f"{self.model.row_shape}, got {rows.shape}"
            )
        if rows.shape[0] < 1:
            raise ConfigurationError("a request must carry >= 1 rows")
        # the admission bound MUST match the scheduler's row budget
        # (_gather): a request admitted here but too large to ever pop
        # would head-of-line-block the queue forever
        max_request = min(self.config.max_batch, self.model.buckets[-1])
        if rows.shape[0] > max_request:
            raise ConfigurationError(
                f"request of {rows.shape[0]} rows exceeds the largest "
                f"admissible batch {max_request}; split it client-side"
            )
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        now = time.perf_counter()
        request = _Request(
            rows=rows,
            future=Future(),
            enqueued_s=now,
            deadline_s=(
                now + deadline_ms / 1e3 if deadline_ms is not None else None
            ),
        )
        with self._cv:
            if self._closed or self._draining:
                # RETRYABLE: the request was never evaluated, so the
                # router can safely resubmit it to another replica (a
                # non-retryable error here would fail the caller for a
                # purely operational event — a rolling restart)
                raise ReplicaDrainingError(
                    f"model queue {self.model.name!r} is "
                    f"{'shut down' if self._closed else 'draining'}; "
                    "retry on another replica"
                )
            if len(self._pending) >= self.config.queue_bound:
                self.metrics.record_overload()
                raise ServerOverloadedError(
                    f"model {self.model.name!r}: queue full "
                    f"({self.config.queue_bound} pending requests); "
                    "back off and retry"
                )
            self._pending.append(request)
            self._pending_rows += rows.shape[0]
            self._cv.notify()
        return request.future

    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: close admission (new submissions raise
        retryable :class:`ReplicaDrainingError`) but keep the scheduler
        dispatching until every already-admitted request completes —
        including the batch the scheduler already popped but has not
        finished evaluating — up to ``timeout_s``.  Returns True when
        everything finished in time.  Call :meth:`close` afterwards to
        stop the scheduler thread (any leftovers then complete with the
        same retryable error)."""
        from .. import flight

        flight.record("serving_drain", model=self.model.name)
        deadline = time.perf_counter() + timeout_s
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._pending or self._in_flight:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.05))
        return True

    def close(self, timeout_s: float = 10.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)
        # drain anything the scheduler no longer owns
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
            self._pending_rows = 0
        drained = 0
        for request in leftovers:
            # claim first: a caller-cancelled future rejects
            # set_exception with InvalidStateError, which would abort
            # this drain loop and strand the remaining leftovers
            if not request.future.set_running_or_notify_cancel():
                continue
            # retryable by design: these requests were never evaluated,
            # so the fleet router resubmits them to another replica
            # instead of surfacing a failure to the caller
            request.future.set_exception(
                ReplicaDrainingError(
                    f"model queue {self.model.name!r} shut down before "
                    "the request was served; retry on another replica"
                )
            )
            drained += 1
        if drained:
            self.metrics.record_drained(drained)

    # -- scheduler side ----------------------------------------------------

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return  # closed and drained
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — last-ditch guard:
                # the scheduler thread must NEVER die holding futures
                # (callers would hang); fail them and keep serving
                for request in batch:
                    if not request.future.done():
                        try:
                            request.future.set_exception(e)
                        except Exception:  # noqa: BLE001 — already done
                            pass
            finally:
                with self._cv:
                    self._in_flight -= 1
                    self._cv.notify_all()

    def _gather(self):
        """Block for the first pending request, then hold the batch open
        until ``max_batch`` rows are pending or ``max_wait_ms`` has
        elapsed; pop whole requests up to the row budget (never more
        than the largest registered bucket can carry)."""
        max_rows = min(self.config.max_batch, self.model.buckets[-1])
        with self._cv:
            while not self._pending:
                if self._closed:
                    return None
                self._cv.wait()
            opened_s = time.perf_counter()
            deadline_s = opened_s + self.config.max_wait_ms / 1e3
            # draining: no new requests can arrive, so holding the
            # batch open for stragglers only delays the shutdown
            while (
                self._pending_rows < max_rows
                and not self._closed
                and not self._draining
            ):
                remaining = deadline_s - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch: list[_Request] = []
            rows = 0
            while self._pending:
                nxt = self._pending[0]
                if rows + nxt.rows.shape[0] > max_rows:
                    break
                self._pending.popleft()
                self._pending_rows -= nxt.rows.shape[0]
                rows += nxt.rows.shape[0]
                batch.append(nxt)
            if batch:
                # counted while still under the lock: drain() must see
                # (pending empty AND nothing mid-dispatch) atomically
                self._in_flight += 1
            return batch

    def _dispatch(self, batch) -> None:
        # ONE model snapshot for the whole batch: a hot-swap
        # (server.replace_model) flips model between any two
        # reads, and a batch padded against one RegisteredModel must be
        # evaluated against the SAME one (its buckets, its warm plans)
        model = self.model
        # deadline admission: expired requests complete exceptionally
        # and never occupy batch rows
        now = time.perf_counter()
        live: list[_Request] = []
        for request in batch:
            # claim the future first: a caller-cancelled request drops
            # out here, and a claimed (RUNNING) future can no longer be
            # cancelled out from under the scatter below
            if not request.future.set_running_or_notify_cancel():
                continue
            if request.expired(now):
                self.metrics.record_deadline_drop()
                request.future.set_exception(
                    DeadlineExceededError(
                        f"model {model.name!r}: deadline expired "
                        "after "
                        f"{(now - request.enqueued_s) * 1e3:.1f} ms in "
                        "queue; request was not evaluated"
                    )
                )
                continue
            live.append(request)
        if not live:
            return
        from .. import profiling

        # queue-wait component per request, measured at the two instants
        # the batcher already owns (submit -> dispatch claim): the
        # profiler's timeline and Prometheus agree on it
        for request in live:
            self.metrics.record_queue_wait(now - request.enqueued_s)
            profiling.record_complete(
                "serve_queue_wait", request.enqueued_s, now,
                model=model.name,
            )
        with telemetry.span(
            "serve_batch",
            model=model.name,
            queue_depth=self.depth(),
        ) as sp:
            try:
                rows = np.concatenate([r.rows for r in live], axis=0)
                padded, bucket = model.pad(rows)
                sp.attrs["rows"] = int(rows.shape[0])
                sp.attrs["bucket"] = int(bucket)
                t_compute = time.perf_counter()
                # the result comes back as host numpy, so compute_s
                # covers the device's work and the scatter below touches
                # no device tensor
                with profiling.phase(
                    "serve_compute", model=model.name,
                    bucket=int(bucket),
                ):
                    result, report = self.registry.evaluate(
                        model, padded
                    )
                    profiling.fence(result)
                compute_s = time.perf_counter() - t_compute
                self.metrics.record_compute(compute_s)
                sp.attrs["compute_s"] = compute_s
            except Exception as e:  # noqa: BLE001 — the batch fails as
                # a unit; every caller gets the typed root cause (and
                # the scheduler thread survives to serve later batches)
                self.metrics.record_eval_failure()
                sp.attrs["error"] = type(e).__name__
                for request in live:
                    request.future.set_exception(e)
                return
            sp.attrs["fill"] = rows.shape[0] / float(bucket)
            sp.attrs["plan_state"] = str(report["plan_state"])
            sp.attrs["retraced"] = report["retraced"]
        self.metrics.record_batch(
            rows=int(rows.shape[0]),
            bucket=int(bucket),
            retraced=report["retraced"],
        )
        done = time.perf_counter()
        offset = 0
        for request in live:
            k = request.rows.shape[0]
            slice_ = np.asarray(result)[offset:offset + k]
            offset += k
            missed = request.expired(done)
            self.metrics.record_latency(
                done - request.enqueued_s, missed_deadline=missed
            )
            if missed:
                # too late to be useful: surface the typed error (the
                # rows were evaluated — that cost is already sunk and
                # counted as a miss in telemetry)
                request.future.set_exception(
                    DeadlineExceededError(
                        f"model {model.name!r}: result ready "
                        f"{(done - request.deadline_s) * 1e3:.1f} ms "
                        "past the deadline"
                    )
                )
            else:
                request.future.set_result(slice_.copy())
