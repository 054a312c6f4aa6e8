"""User-facing runtime of the port.

``LocalMooseRuntime`` of ``moose_tpu/runtime.py``: several virtual hosts
in one process with their storage, executing traced computations, or
serialized ones (``evaluate_compiled``), on one device — the CUDA card
unless the caller asks for the CPU.  Storage holds numpy arrays: Load
lifts them onto the device, Save writes numpy back.

Two layouts run a graph, as in the JAX package: the per-host layout
(``dialects/logical.py``, six separately placed arrays a sharing) and the
party-stacked one (``dialects/stacked.py``).  ``layout="auto"`` (the
default) runs a graph with a replicated op that ``stacked.supports``
admits on the stacked layout and anything else per-host, rerouting a
graph the stacked layout rejects mid-run (``TypeMismatchError``);
``"stacked"`` skips the replicated-op screen; ``"per-host"`` always runs
per-host.  The two layouts draw different masks, so their results agree
to the truncation's noise, not word for word.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

from . import devices
from .computation import Computation
from .edsl import base as edsl_base
from .edsl import tracer
from .dialects import logical, stacked
from .errors import ConfigurationError, TypeMismatchError
from .execution.interpreter import Interpreter
from .logger import get_logger


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
# does not have yet (ROADMAP queue 1, item 8b)
_LOWERED_KINDS = frozenset({
    "RingFixedpointEncode", "RingFixedpointDecode",
    "RingFixedpointMean", "PrfKeyGen", "DeriveSeed", "SampleSeeded",
    "Sample", "Send", "Receive", "RingInject", "BitCompose",
    "BitDecompose", "BitExtract", "Shl", "Shr", "Fill", "ShlDim",
    "Im2Col",
})
_LOWERING = (
    "lowering and the physical executor are ROADMAP queue 1, item 8b"
)
LAYOUTS = ("auto", "per-host", "stacked")


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
        layout = "auto" if layout is None else layout
        if layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {layout!r}; expected 'auto', "
                "'per-host' or 'stacked'"
            )
        if mesh is not None:
            raise ConfigurationError(
                "the port runs on one device; a device mesh is ROADMAP "
                "queue 1, item 12"
            )
        self.device = devices.resolve(device)
        self.layout = layout
        # the JAX package's validated-jit switch, recorded: the port runs
        # eagerly either way, and lowers nothing (item 8b)
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
        self._interpreter = Interpreter(self.device, logical)
        self._stacked = Interpreter(self.device, stacked)
        # computations the stacked layout rejected mid-run
        # (TypeMismatchError): later evaluations go straight to per-host
        self._stacked_rejected = weakref.WeakSet()
        # the layout that ran the last evaluation, as the JAX package
        # reports it (the port's plans are always eager)
        self.last_plan: Dict = {}
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
                f"compiler_passes lower the graph for the physical "
                f"executor ({_LOWERING})"
            )
        if isinstance(computation, edsl_base.AbstractComputation):
            traced = self._trace_cache.get(computation)
            if traced is None:
                traced = self._trace_cache[computation] = tracer.trace(
                    computation
                )
            computation = traced
        computation, arguments = _lift_computation(computation, arguments)
        self.last_plan = {}
        if self.layout_for(computation) == "stacked":
            try:
                result = self._stacked.evaluate(
                    computation, arguments, self.storage)
            except TypeMismatchError as e:
                # stacked.supports admitted the graph but a kernel
                # rejected a value mid-run; storage is written only after
                # a walk completes, so the per-host rerun is safe
                self._stacked_rejected.add(computation)
                get_logger().warning(
                    "stacked layout rejected the computation (%s); "
                    "falling back to the per-host layout", e)
            else:
                self.last_plan = _plan("stacked")
                return result
        result = self._interpreter.evaluate(
            computation, arguments, self.storage)
        self.last_plan = _plan("per-host")
        return result

    def layout_for(self, computation: Computation) -> str:
        """The layout an evaluation of ``computation`` starts on: the
        JAX runtime's routing (``moose_tpu/runtime.py:196-262``).
        ``"auto"`` keeps a graph without a replicated op per-host (there
        is nothing to stack); a graph ``stacked.supports`` rejects, or one
        it rejected mid-run before, runs per-host under either stacked
        setting."""
        if self.layout == "per-host" or computation in self._stacked_rejected:
            return "per-host"
        if self.layout == "auto" and not _has_replicated_op(computation):
            return "per-host"
        return "stacked" if stacked.supports(computation) else "per-host"

    def evaluate_compiled(self, comp_bin, arguments=None):
        """Run a serialized computation (``serde.serialize_computation``,
        ``elk_compiler.compile_computation``), routed as
        :meth:`evaluate_computation` routes it."""
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
                f"per-host physical executor ({_LOWERING})"
            )
        return self.evaluate_computation(comp, arguments)

    def read_value_from_storage(self, identity: str, key: str):
        return self.storage[identity][key]

    def write_value_to_storage(self, identity: str, key: str, value):
        if identity not in self.storage:
            raise ValueError(f"unknown identity {identity}")
        self.storage[identity][key] = value
        return value


def _has_replicated_op(computation: Computation) -> bool:
    from .computation import ReplicatedPlacement

    return any(
        isinstance(computation.placements.get(op.placement_name),
                   ReplicatedPlacement)
        for op in computation.operations.values()
    )


def _plan(layout: str) -> dict:
    """``last_plan`` of an evaluation: its layout, and the JAX package's
    plan keys for an eager plan."""
    return {"layout": layout, "plan_mode": "eager", "pinned_ops": []}
