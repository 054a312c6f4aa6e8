"""User-facing runtime of the port.

``LocalMooseRuntime`` of ``moose_tpu/runtime.py``: several virtual hosts
in one process with their storage, executing traced computations in the
party-stacked layout on one device — the CUDA card unless the caller
asks for the CPU.  Storage holds numpy arrays: Load lifts them onto the
device, Save writes numpy back.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

from . import devices
from .computation import Computation
from .edsl import base as edsl_base
from .edsl import tracer
from .errors import ConfigurationError
from .execution.interpreter import Interpreter


def _lift_computation(computation, arguments):
    if isinstance(computation, edsl_base.AbstractComputation):
        computation = tracer.trace(computation)
    if not isinstance(computation, Computation):
        raise ValueError(
            "`computation` must be an AbstractComputation or Computation, "
            f"found {type(computation)}"
        )
    return computation, dict(arguments or {})


class LocalMooseRuntime:
    def __init__(
        self,
        identities: List[str],
        storage_mapping: Optional[Dict[str, Dict]] = None,
        layout: Optional[str] = None,
        device=devices.DEFAULT_DEVICE,
    ):
        if layout not in (None, "auto", "stacked"):
            raise ConfigurationError(
                f"the port runs the stacked layout only, got {layout!r} "
                "(the per-host layout is ROADMAP queue 1, item 8)"
            )
        self.device = devices.resolve(device)
        self.layout = "stacked"
        storage_mapping = storage_mapping or {}
        for identity in storage_mapping:
            if identity not in identities:
                raise ValueError(
                    f"unknown identity {identity} in `storage_mapping`, "
                    f"must be one of {identities}"
                )
        self.identities = list(identities)
        # plain dicts are copied; storage objects (FilesystemStorage, or
        # anything with a .load) are kept as they are, and the walk reads
        # and writes through them
        self.storage = {
            identity: (
                store
                if hasattr(store := storage_mapping.get(identity, {}),
                           "load")
                else dict(store)
            )
            for identity in identities
        }
        self._interpreter = Interpreter(self.device)
        # weak-keyed on the computation object: repeated evaluations of
        # one AbstractComputation trace it once
        self._trace_cache = weakref.WeakKeyDictionary()

    def set_default(self):
        edsl_base.set_current_runtime(self)

    def evaluate_computation(self, computation, arguments=None):
        if isinstance(computation, edsl_base.AbstractComputation):
            traced = self._trace_cache.get(computation)
            if traced is None:
                traced = self._trace_cache[computation] = tracer.trace(
                    computation
                )
            computation = traced
        computation, arguments = _lift_computation(computation, arguments)
        return self._interpreter.evaluate(
            computation, arguments, self.storage
        )

    def read_value_from_storage(self, identity: str, key: str):
        return self.storage[identity][key]

    def write_value_to_storage(self, identity: str, key: str, value):
        if identity not in self.storage:
            raise ValueError(f"unknown identity {identity}")
        self.storage[identity][key] = value
        return value
