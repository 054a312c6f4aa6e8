"""Serving knobs (env-overridable, flag-overridable in ``blitzen``); the
port's own copy of ``moose_tpu/serving/config.py``.

- ``MOOSE_TPU_SERVE_MAX_BATCH`` — largest batch one evaluation carries
  (also the largest padding bucket); default 256.
- ``MOOSE_TPU_SERVE_MAX_WAIT_MS`` — how long the micro-batcher holds an
  open batch for more requests before dispatching; default 2.0 ms.
  Coalescing stops at ``max_batch`` rows or ``max_wait_ms`` elapsed,
  whichever comes first.
- ``MOOSE_TPU_SERVE_QUEUE`` — per-model pending-request bound; a full
  queue REJECTS new submissions with ``ServerOverloadedError`` (never
  blocks); default 1024.
- ``MOOSE_TPU_SERVE_DEADLINE_MS`` — default per-request deadline; unset
  means no deadline unless the request carries one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ..errors import ConfigurationError


def _env_number(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError as e:
        raise ConfigurationError(
            f"{name} must be a number, got {raw!r}"
        ) from e


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 256
    max_wait_ms: float = 2.0
    queue_bound: int = 1024
    default_deadline_ms: Optional[float] = None

    @classmethod
    def from_env(cls, **overrides) -> "ServingConfig":
        """Env-derived config; keyword overrides win (CLI flags)."""
        values = {
            "max_batch": _env_number(
                "MOOSE_TPU_SERVE_MAX_BATCH", cls.max_batch, int
            ),
            "max_wait_ms": _env_number(
                "MOOSE_TPU_SERVE_MAX_WAIT_MS", cls.max_wait_ms, float
            ),
            "queue_bound": _env_number(
                "MOOSE_TPU_SERVE_QUEUE", cls.queue_bound, int
            ),
            "default_deadline_ms": _env_number(
                "MOOSE_TPU_SERVE_DEADLINE_MS", None, float
            ),
        }
        values.update(
            {k: v for k, v in overrides.items() if v is not None}
        )
        config = cls(**values)
        if config.max_batch < 1:
            raise ConfigurationError(
                f"max_batch must be >= 1, got {config.max_batch}"
            )
        if config.queue_bound < 1:
            raise ConfigurationError(
                f"queue_bound must be >= 1, got {config.queue_bound}"
            )
        if config.max_wait_ms < 0:
            raise ConfigurationError(
                f"max_wait_ms must be >= 0, got {config.max_wait_ms}"
            )
        if (
            config.default_deadline_ms is not None
            and config.default_deadline_ms <= 0
        ):
            # a non-positive deadline expires every request at dispatch
            # (blitzen would answer 504 for ALL traffic) — fail at
            # startup like the other knobs
            raise ConfigurationError(
                "default_deadline_ms must be > 0, got "
                f"{config.default_deadline_ms}"
            )
        return config
