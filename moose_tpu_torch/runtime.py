"""User-facing runtime of the port.

``LocalMooseRuntime`` of ``moose_tpu/runtime.py``: several virtual hosts
in one process with their storage, executing traced computations, or
serialized ones (``evaluate_compiled``), on one device — the CUDA card
unless the caller asks for the CPU.  Storage holds numpy arrays: Load
lifts them onto the device, Save writes numpy back.

A graph runs as the JAX runtime routes it.  ``layout="auto"`` (the
default) runs a graph with a replicated op that ``stacked.supports``
admits on the party-stacked layout (``dialects/stacked.py``), rerouting
a graph the stacked layout rejects mid-run (``TypeMismatchError``);
``"stacked"`` skips the replicated-op screen; ``"per-host"`` always runs
per-host.  Per-host, a graph is lowered (``compilation``, the
reference's DEFAULT_PASSES) and runs on the physical executor
(``execution/physical.py``) when the caller passes ``compiler_passes``,
when it is already lowered, or under ``use_jit`` when its estimated
lowered size passes the JAX package's segment limit
(:meth:`LocalMooseRuntime._auto_lower_passes`); else it runs on the
logical walk (``dialects/logical.py``).  ``use_jit`` resolves as the JAX
package resolves it (``MOOSE_TPU_JIT``, default on) and only chooses the
route: the port executes eagerly either way.  The two layouts draw
different masks, so their results agree to the truncation's noise, not
word for word; the walk and the lowered graph do too.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

from . import devices
from .computation import AES_TY_NAMES, Computation
from .edsl import base as edsl_base
from .edsl import tracer
from .dialects import logical, stacked
from .errors import ConfigurationError, TypeMismatchError
from .execution.interpreter import Interpreter, binding_cache_key
from .execution.physical import PhysicalInterpreter
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


# op kinds that only a lowered (host-level) graph contains: the positive
# marker for routing to the physical executor.  All-host graphs without
# these are logical computations and keep the logical walk
_LOWERED_KINDS = frozenset({
    "RingFixedpointEncode", "RingFixedpointDecode",
    "RingFixedpointMean", "PrfKeyGen", "DeriveSeed", "SampleSeeded",
    "Sample", "Send", "Receive", "RingInject", "BitCompose",
    "BitDecompose", "BitExtract", "Shl", "Shr", "Fill", "ShlDim",
    "Im2Col",
})
# the JAX package's rough lowered sizes of replicated-placement ops, in
# host ops (moose_tpu/dialects/logical.py EXPANSION_WEIGHTS): they decide
# whether a graph is lowered under use_jit
EXPANSION_WEIGHTS = {
    "Softmax": 11000, "Sqrt": 13500, "Log": 9500, "Log2": 9500,
    "Div": 4100, "Inverse": 4100, "Exp": 4600, "Sigmoid": 4600,
    "Pow2": 4600, "Argmax": 3000, "MaxPool2D": 3000, "AvgPool2D": 150,
    "Maximum": 2000, "Less": 950, "Greater": 950, "Equal": 1200,
    "Sign": 950, "Abs": 1000, "Relu": 1000, "Mux": 200,
    "Dot": 170, "Mul": 130, "Conv2D": 250, "Decrypt": 200000,
}
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
        # the JAX package's validated-jit switch: it chooses the route
        # (a big per-host graph is lowered), and the port runs eagerly on
        # either route
        if use_jit is None:
            use_jit = os.environ.get("MOOSE_TPU_JIT", "1") != "0"
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
        self._physical = PhysicalInterpreter(self.device)
        # (traced computation, passes, binding) -> lowered Computation,
        # weak-keyed on the computation as the JAX runtime keys it
        self._compiled_cache = weakref.WeakKeyDictionary()
        # computations the stacked layout rejected mid-run
        # (TypeMismatchError): later evaluations go straight to per-host
        self._stacked_rejected = weakref.WeakSet()
        # the layout that ran the last evaluation, as the JAX package
        # reports it, and whether the physical executor ran it (the
        # port's plans are always eager)
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
        if isinstance(computation, edsl_base.AbstractComputation):
            traced = self._trace_cache.get(computation)
            if traced is None:
                traced = self._trace_cache[computation] = tracer.trace(
                    computation
                )
            computation = traced
        computation, arguments = _lift_computation(computation, arguments)
        self.last_plan = {}
        lowered = _is_lowered(computation)
        if compiler_passes is None and self.layout_for(computation) == \
                "stacked":
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
        if compiler_passes is None and self.use_jit and not lowered:
            # a protocol-heavy graph expands to thousands of host ops in
            # one logical op: the JAX runtime lowers it to bound its jit
            # programs, and the port follows its route
            compiler_passes = self._auto_lower_passes(computation)
        if compiler_passes is not None:
            computation = self._lowered(computation, arguments,
                                        compiler_passes)
            lowered = True
        if lowered:
            result = self._physical.evaluate(
                computation, self.storage, arguments, use_jit=self.use_jit)
        else:
            result = self._interpreter.evaluate(
                computation, arguments, self.storage)
        self.last_plan = _plan("per-host", lowered)
        return result

    def _lowered(self, computation, arguments, passes):
        """``computation`` compiled through ``passes`` for the shapes of
        ``arguments`` (and of its Loads in storage), cached under the JAX
        runtime's key: the passes, the binding and the specs."""
        from .compilation import compile_computation
        from .compilation.lowering import arg_specs_from_arguments

        specs = arg_specs_from_arguments(
            arguments, storage=self.storage, comp=computation)
        # callable passes have no stable identity: run them uncached
        cacheable = all(isinstance(p, str) for p in passes)
        key = None
        if cacheable:
            per_comp = self._compiled_cache.get(computation)
            if per_comp is None:
                per_comp = self._compiled_cache[computation] = {}
            # a storage write that changes a loaded value's shape must
            # miss the cache
            key = (
                tuple(passes),
                binding_cache_key(arguments, self.use_jit),
                tuple(sorted(
                    (n, s) if isinstance(s, (str, int, float))
                    else (n, tuple(s[0]), str(s[1]))
                    for n, s in specs.items()
                )),
            )
            compiled = per_comp.get(key)
            if compiled is not None:
                return compiled
        compiled = compile_computation(computation, passes=passes,
                                       arg_specs=specs)
        if cacheable:
            per_comp[key] = compiled
        return compiled

    @staticmethod
    def _auto_lower_passes(computation):
        """DEFAULT_PASSES when the graph's estimated lowered size passes
        the segment limit, else None (the logical walk): the JAX
        runtime's decision (``moose_tpu/runtime.py:365-389``).  An
        AES-typed graph is never lowered here."""
        from .compilation import DEFAULT_PASSES
        from .computation import ReplicatedPlacement

        limit = _segment_limit()
        total = 0
        for op in computation.operations.values():
            for ty in (op.signature.return_type, *op.signature.input_types):
                if ty is not None and ty.name in AES_TY_NAMES:
                    return None
            plc = computation.placements.get(op.placement_name)
            if isinstance(plc, ReplicatedPlacement):
                total += EXPANSION_WEIGHTS.get(op.kind, 20)
            else:
                total += 3
            if total > limit:
                return list(DEFAULT_PASSES)
        return None

    def layout_for(self, computation: Computation) -> str:
        """The layout an evaluation of ``computation`` starts on: the
        JAX runtime's routing (``moose_tpu/runtime.py:196-262``).
        ``"auto"`` keeps a graph without a replicated op per-host (there
        is nothing to stack); a lowered graph, a graph ``stacked.supports``
        rejects, or one it rejected mid-run before, runs per-host under
        either stacked setting."""
        if (self.layout == "per-host" or _is_lowered(computation)
                or computation in self._stacked_rejected):
            return "per-host"
        if self.layout == "auto" and not _has_replicated_op(computation):
            return "per-host"
        return "stacked" if stacked.supports(computation) else "per-host"

    def evaluate_compiled(self, comp_bin, arguments=None):
        """Run a serialized computation (``serde.serialize_computation``,
        ``elk_compiler.compile_computation``), routed as
        :meth:`evaluate_computation` routes it: a lowered graph runs on
        the physical executor."""
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


def _is_lowered(computation: Computation) -> bool:
    return any(op.kind in _LOWERED_KINDS
               for op in computation.operations.values())


def _segment_limit() -> int:
    """The JAX package's jit segment limit (``MOOSE_TPU_JIT_SEGMENT``,
    default 2000; 0 disables), against which a graph's estimated lowered
    size decides the route."""
    raw = os.environ.get("MOOSE_TPU_JIT_SEGMENT", "2000")
    try:
        n = int(raw)
    except ValueError as e:
        raise ConfigurationError(
            f"MOOSE_TPU_JIT_SEGMENT must be an integer, got {raw!r}"
        ) from e
    return n if n > 0 else (1 << 62)


def _plan(layout: str, lowered: bool = False) -> dict:
    """``last_plan`` of an evaluation: its layout, whether the physical
    executor ran a lowered graph, and the JAX package's plan keys for an
    eager plan."""
    return {"layout": layout, "lowered": lowered, "plan_mode": "eager",
            "pinned_ops": []}
