"""Secure-inference serving: a warm model registry and dynamic
micro-batching, the port's own copy of ``moose_tpu/serving/``.

A single request pays the trace and runs a batch of one; the secure
protocol's per-launch cost is amortised over the rows of a batch.  This
package closes that gap for serving traffic:

- :mod:`registry`: traces a predictor once per (model, fixed-point
  dtype), lints it at the door, and warms every batch bucket with one
  evaluation on the port's runtime, so requests never pay the trace;
- :mod:`batcher`: per-model bounded queues; the scheduler thread
  coalesces pending requests up to ``max_batch`` rows or
  ``max_wait_ms`` (whichever first), pads to a power-of-two bucket,
  evaluates once, copies the result to numpy and scatters the rows to
  the callers, with deadlines and typed ``ServerOverloadedError``
  backpressure;
- :mod:`server`: the in-process :class:`InferenceServer` (``bin/blitzen``
  wraps it with an HTTP front end; ``bin/donner`` routes over replicas);
- :mod:`metrics`: queue depth, batch sizes and fill, p50/p99 request
  latency, deadline misses, and the warm-path acceptance counters (no
  re-trace after warm-up);
- :mod:`snapshot`: durable warm-state snapshots (traced computations,
  lowered graphs, plan states, fixed-keys probe digests), so a replica
  restarts warm;
- :mod:`controlplane`: the train, canary, promote or roll back loop
  over a fleet.

Every evaluation runs on the server's runtime device (the CUDA card
unless the caller asks for the CPU) on the scheduler thread under the
registry's ``eval_lock``; the callers' threads only ever see numpy.

Knobs: ``MOOSE_TPU_SERVE_MAX_BATCH`` / ``MOOSE_TPU_SERVE_MAX_WAIT_MS``
/ ``MOOSE_TPU_SERVE_QUEUE`` / ``MOOSE_TPU_SERVE_DEADLINE_MS`` (see
:mod:`config`), ``MOOSE_TPU_SNAPSHOT_DIR`` (see :mod:`snapshot`),
``MOOSE_TPU_CANARY_*`` (see :mod:`controlplane`).
"""

from .config import ServingConfig
from .metrics import ServingMetrics
from .registry import (
    ModelRegistry,
    RegisteredModel,
    bucket_for,
    power_of_two_buckets,
)
from .batcher import ModelQueue
from .controlplane import (
    CanaryConfig,
    ControlPlane,
    HttpFleetClient,
    LocalFleetClient,
    SessionGenerationProducer,
)
from .server import InferenceServer
from .snapshot import (
    current_snapshot_path,
    restore_registry,
    save_snapshot,
)

__all__ = [
    "CanaryConfig",
    "ControlPlane",
    "HttpFleetClient",
    "InferenceServer",
    "LocalFleetClient",
    "ModelQueue",
    "ModelRegistry",
    "RegisteredModel",
    "ServingConfig",
    "ServingMetrics",
    "SessionGenerationProducer",
    "bucket_for",
    "current_snapshot_path",
    "power_of_two_buckets",
    "restore_registry",
    "save_snapshot",
]
