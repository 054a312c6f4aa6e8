"""User-facing runtime of the port.

``LocalMooseRuntime`` of ``moose_tpu/runtime.py``: several virtual hosts
in one process with their storage, executing traced computations, or
serialized ones (``evaluate_compiled``), in the party-stacked layout on
one device — the CUDA card unless the caller asks for the CPU.  Storage
holds numpy arrays: Load lifts them onto the device, Save writes numpy
back.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
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


# op kinds that only a lowered (host-level) graph contains: such a graph
# runs on the JAX package's per-host physical executor, which the port
# does not have yet (ROADMAP queue 1, item 8)
_LOWERED_KINDS = frozenset({
    "RingFixedpointEncode", "RingFixedpointDecode",
    "RingFixedpointMean", "PrfKeyGen", "DeriveSeed", "SampleSeeded",
    "Sample", "Send", "Receive", "RingInject", "BitCompose",
    "BitDecompose", "BitExtract", "Shl", "Shr", "Fill", "ShlDim",
    "Im2Col",
})
_PER_HOST = "the per-host layout is ROADMAP queue 1, item 8"


class LocalMooseRuntime:
    def __init__(
        self,
        identities: List[str],
        storage_mapping: Optional[Dict[str, Dict]] = None,
        use_jit: Optional[bool] = None,
        layout: Optional[str] = None,
        mesh=None,
        device=devices.DEFAULT_DEVICE,
    ):
        if layout not in (None, "auto", "stacked"):
            raise ConfigurationError(
                f"the port runs the stacked layout only, got {layout!r} "
                f"({_PER_HOST})"
            )
        if mesh is not None:
            raise ConfigurationError(
                "the port runs on one device; a device mesh is ROADMAP "
                "queue 1, item 12"
            )
        self.device = devices.resolve(device)
        self.layout = "stacked"
        # the JAX package's validated-jit switch, recorded: the port runs
        # eagerly either way
        self.use_jit = use_jit
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
        # serialized-computation memo of evaluate_compiled, by the bytes
        self._bin_cache: "OrderedDict[bytes, Computation]" = OrderedDict()

    def set_default(self):
        edsl_base.set_current_runtime(self)

    def evaluate_computation(self, computation, arguments=None,
                             compiler_passes=None):
        if compiler_passes is not None:
            # the JAX package lowers the graph through these passes and
            # runs the per-host physical executor
            raise NotImplementedError(
                f"compiler_passes lower the graph to the per-host layout "
                f"({_PER_HOST})"
            )
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

    def evaluate_compiled(self, comp_bin, arguments=None):
        """Run a serialized computation (``serde.serialize_computation``,
        ``elk_compiler.compile_computation``) on the stacked layout."""
        from .serde import deserialize_computation

        # each blob is decoded once, and later calls reuse its object
        comp = self._bin_cache.get(comp_bin)
        if comp is None:
            comp = deserialize_computation(comp_bin)
            self._bin_cache[comp_bin] = comp
            while len(self._bin_cache) > 32:  # bounded LRU
                self._bin_cache.popitem(last=False)
        else:
            # a hot computation must not be evicted ahead of cold ones
            self._bin_cache.move_to_end(comp_bin)
        lowered = sorted({op.kind for op in comp.operations.values()
                          if op.kind in _LOWERED_KINDS})
        if lowered:
            raise NotImplementedError(
                f"a lowered computation ({', '.join(lowered)}) runs on the "
                f"per-host physical executor ({_PER_HOST})"
            )
        return self.evaluate_computation(comp, arguments)

    def read_value_from_storage(self, identity: str, key: str):
        return self.storage[identity][key]

    def write_value_to_storage(self, identity: str, key: str, value):
        if identity not in self.storage:
            raise ValueError(f"unknown identity {identity}")
        self.storage[identity][key] = value
        return value
