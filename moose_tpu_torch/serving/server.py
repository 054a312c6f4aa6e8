"""In-process secure-inference server: registry + per-model batchers.

The port's own copy of ``moose_tpu/serving/server.py``: the programmatic
API behind the ``blitzen`` daemon::

    from moose_tpu_torch.serving import InferenceServer

    server = InferenceServer()                   # on the CUDA card
    server.register_model("logreg", model, row_shape=(100,))
    y = server.predict("logreg", x_row)          # sync helper
    fut = server.submit("logreg", x_rows)        # async: a Future
    print(server.metrics_snapshot())

Lifecycle: ``register_model`` pays the trace, the lint and one warm-up
evaluation per bucket once; ``submit``/``predict`` only ever replay warm
plans.  Without a ``runtime`` the server builds a ``LocalMooseRuntime``
on ``device``, which defaults to ``"cuda"`` and raises without a card
unless the caller passes ``device="cpu"``.  See
``moose_tpu_torch/serving/batcher.py`` for the dispatch/backpressure
policy and ``config.ServingConfig`` for the knobs.
"""

from __future__ import annotations

from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Dict, Optional, Tuple

import numpy as np

from .. import devices
from ..errors import ConfigurationError
from .batcher import ModelQueue
from .config import ServingConfig
from .metrics import ServingMetrics
from .registry import ModelRegistry


class InferenceServer:
    """Micro-batching secure-inference server over one shared runtime."""

    def __init__(self, config: Optional[ServingConfig] = None,
                 runtime=None, device=devices.DEFAULT_DEVICE):
        self.config = config or ServingConfig.from_env()
        self.registry = ModelRegistry(
            runtime=runtime, config=self.config, device=device
        )
        self.metrics = ServingMetrics()
        self._queues: Dict[str, ModelQueue] = {}
        self._closed = False
        self._draining = False

    # -- lifecycle ---------------------------------------------------------

    def register_model(
        self,
        name: str,
        model,
        row_shape: Tuple[int, ...],
        buckets: Tuple[int, ...] = (),
        fixedpoint_dtype=None,
        input_name: Optional[str] = None,
        arg_ranges=None,
    ):
        """Register + warm a model and start its micro-batch scheduler.
        Buckets default to powers of two up to ``config.max_batch``.
        ``arg_ranges`` declares real-space input bounds and arms the
        MSA7xx overflow gate at registration (see
        ``ModelRegistry.register``)."""
        if self._closed:
            raise ConfigurationError("server is shut down")
        registered = self.registry.register(
            name,
            model,
            row_shape=row_shape,
            buckets=buckets,
            fixedpoint_dtype=fixedpoint_dtype,
            input_name=input_name,
            arg_ranges=arg_ranges,
        )
        self._queues[name] = ModelQueue(
            model=registered,
            registry=self.registry,
            config=self.config,
            metrics=self.metrics,
        )
        return registered

    def replace_model(
        self,
        name: str,
        model,
        row_shape: Tuple[int, ...],
        buckets: Tuple[int, ...] = (),
        fixedpoint_dtype=None,
        input_name: Optional[str] = None,
    ):
        """Hot-swap a live model with ZERO dropped requests: the
        replacement warms fully under the registry's staging name while
        the old version answers everything, then the queue's model
        reference flips atomically — in-flight batches finish against
        the old object (its plans stay cached), new batches bucket
        against the new one."""
        if self._closed:
            raise ConfigurationError("server is shut down")
        registered = self.registry.replace(
            name,
            model,
            row_shape=row_shape,
            buckets=buckets,
            fixedpoint_dtype=fixedpoint_dtype,
            input_name=input_name,
        )
        queue = self._queues.get(name)
        if queue is not None:
            queue.model = registered
        return registered

    def unregister_model(self, name: str) -> None:
        """Retire a model (the control plane unloading a generation):
        drop the registration, then close its queue — requests it
        already holds are still served on the popped model, any the
        scheduler leaves fail with a retryable ``ReplicaDrainingError``
        so the router resubmits them elsewhere.  The name leaves the
        registry first, so a request racing the close is answered as
        a generation miss, never as a client error."""
        if name not in self._queues:
            raise ConfigurationError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._queues)}"
            )
        self.registry.unregister(name)
        self._queues.pop(name).close()

    def load_snapshot(self, directory, source_digests=None,
                      rewarm: bool = True) -> dict:
        """Restore every model from the live warm-state snapshot under
        ``directory`` (see :mod:`.snapshot`) and start a micro-batch
        scheduler per restored model.  Raises
        :class:`~moose_tpu_torch.errors.SnapshotError` on any validation
        failure, leaving the server empty (callers fall back to fresh
        ``register_model`` calls)."""
        from . import snapshot as snapshot_mod

        if self._closed:
            raise ConfigurationError("server is shut down")
        report = snapshot_mod.restore_registry(
            self.registry, directory,
            source_digests=source_digests, rewarm=rewarm,
        )
        for name in report["models"]:
            self._queues[name] = ModelQueue(
                model=self.registry.get(name),
                registry=self.registry,
                config=self.config,
                metrics=self.metrics,
            )
        return report

    def save_snapshot(self, directory, source_digests=None, only=None):
        """Persist the warm registry (see :mod:`.snapshot`); returns the
        new snapshot path.  ``only`` restricts the snapshot to the named
        models (drain-time snapshots exclude ephemeral control-plane
        generations)."""
        from . import snapshot as snapshot_mod

        return snapshot_mod.save_snapshot(
            self, directory, source_digests=source_digests, only=only
        )

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown, phase one: stop admission on every model
        queue (submissions raise retryable ``ReplicaDrainingError``) and
        wait for all in-flight requests to finish, bounded by
        ``timeout_s`` total.  Returns True when every queue emptied in
        time.  The server stays alive for metrics scrapes; call
        :meth:`close` to stop the scheduler threads afterwards."""
        import time

        self._draining = True
        deadline = time.perf_counter() + timeout_s
        drained = True
        for queue in self._queues.values():
            remaining = max(0.0, deadline - time.perf_counter())
            drained = queue.drain(timeout_s=remaining) and drained
        return drained

    @property
    def draining(self) -> bool:
        return self._draining

    def close(self) -> None:
        self._closed = True
        for queue in self._queues.values():
            queue.close()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request path ------------------------------------------------------

    def submit(self, model_name: str, x,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the
        per-row results (shape ``(k, ...)`` for a ``(k, *row_shape)``
        request, ``(1, ...)`` for a bare row).  Raises
        ``ServerOverloadedError`` when the model's queue is full and
        the Future raises ``DeadlineExceededError`` on expiry."""
        queue = self._queues.get(model_name)
        if queue is None:
            raise ConfigurationError(
                f"unknown model {model_name!r}; registered: "
                f"{sorted(self._queues)}"
            )
        return queue.submit(x, deadline_ms=deadline_ms)

    def predict(self, model_name: str, x,
                deadline_ms: Optional[float] = None,
                timeout_s: Optional[float] = 120.0) -> np.ndarray:
        """Synchronous submit + await.  A wait timeout cancels the
        queued request so a caller that gave up never occupies batch
        rows (the batcher drops cancelled futures at gather time)."""
        future = self.submit(model_name, x, deadline_ms=deadline_ms)
        try:
            return future.result(timeout=timeout_s)
        except FutureTimeoutError:
            future.cancel()
            raise

    # -- observability -----------------------------------------------------

    def queue_depth(self, model_name: str) -> int:
        return self._queues[model_name].depth()

    def metrics_snapshot(self) -> dict:
        """Aggregate serving metrics plus per-model queue depths and
        warmup reports."""
        snap = self.metrics.snapshot()
        snap["queue_depths"] = {
            name: q.depth() for name, q in self._queues.items()
        }
        snap["models"] = {
            name: {
                "buckets": list(q.model.buckets),
                "warmup": {
                    str(b): dict(r)
                    for b, r in q.model.warmup_report.items()
                },
            }
            for name, q in self._queues.items()
        }
        return snap
