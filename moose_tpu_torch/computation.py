"""The moose_tpu intermediate representation (IR).

TPU-native re-design of the reference IR (``moose/src/computation.rs``): a
named dataflow graph whose operations are pinned to *placements*.  The dtype
and shape math of each kernel is delegated to JAX/XLA at execution time; the
IR's job is to carry the placement structure, the operator vocabulary, the
value type system, and (de)serialization.

Key differences from the reference (by design, for TPU):
- Operations are plain dataclasses; the operator vocabulary is an open
  registry of names + attribute schemas instead of a closed Rust enum
  (reference ``Operator`` enum, computation.rs:828-914).
- The graph is kept in insertion order; ``toposort`` is a compiler pass.

The port's own copy of ``moose_tpu/computation.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations

import dataclasses
import hashlib
import secrets
from typing import Any, Iterable, Optional

from . import dtypes as dt

# ---------------------------------------------------------------------------
# Placements (reference: Placement enum, computation.rs:1626)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostPlacement:
    name: str

    @property
    def kind(self) -> str:
        return "Host"

    def to_textual(self) -> str:
        return f"@Host({self.name})"


@dataclasses.dataclass(frozen=True)
class ReplicatedPlacement:
    """3-party replicated secret-sharing placement (virtual unit of 3 hosts)."""

    name: str
    owners: tuple[str, str, str]

    def __post_init__(self):
        object.__setattr__(self, "owners", tuple(self.owners))
        assert len(self.owners) == 3

    @property
    def kind(self) -> str:
        return "Replicated"

    def host_placements(self) -> tuple[HostPlacement, HostPlacement, HostPlacement]:
        return tuple(HostPlacement(o) for o in self.owners)

    def to_textual(self) -> str:
        return f"@Replicated({', '.join(self.owners)})"


@dataclasses.dataclass(frozen=True)
class AdditivePlacement:
    """2-party additive secret-sharing placement (helper sub-protocols)."""

    name: str
    owners: tuple[str, str]

    def __post_init__(self):
        object.__setattr__(self, "owners", tuple(self.owners))
        assert len(self.owners) == 2

    @property
    def kind(self) -> str:
        return "Additive"

    def host_placements(self) -> tuple[HostPlacement, HostPlacement]:
        return tuple(HostPlacement(o) for o in self.owners)

    def to_textual(self) -> str:
        return f"@Additive({', '.join(self.owners)})"


@dataclasses.dataclass(frozen=True)
class Mirrored3Placement:
    """Public values kept in lockstep on 3 hosts (no secret sharing)."""

    name: str
    owners: tuple[str, str, str]

    def __post_init__(self):
        object.__setattr__(self, "owners", tuple(self.owners))
        assert len(self.owners) == 3

    @property
    def kind(self) -> str:
        return "Mirrored3"

    def host_placements(self) -> tuple[HostPlacement, HostPlacement, HostPlacement]:
        return tuple(HostPlacement(o) for o in self.owners)

    def to_textual(self) -> str:
        return f"@Mirrored3({', '.join(self.owners)})"


Placement = HostPlacement | ReplicatedPlacement | AdditivePlacement | Mirrored3Placement


# ---------------------------------------------------------------------------
# Value types (reference: Ty, computation.rs:330-591 + types.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ty:
    """A value type.  ``name`` identifies the concrete type (e.g.
    ``HostRing128Tensor``); logical tensors carry a ``dtype``; fixed types
    carry precision inside their dtype."""

    name: str
    dtype: Optional[dt.DType] = None

    def to_textual(self) -> str:
        if self.name == "Tensor":
            return f"Tensor<{self.dtype.short_textual()}>"
        if self.name in ("HostFixed64Tensor", "HostFixed128Tensor",
                         "ReplicatedFixed64Tensor", "ReplicatedFixed128Tensor",
                         "Mirrored3Fixed64Tensor", "Mirrored3Fixed128Tensor"):
            i = self.dtype.integral_precision
            f = self.dtype.fractional_precision
            return f"{self.name}<{i}, {f}>"
        return self.name

    def __str__(self) -> str:
        return self.to_textual()


def tensor_ty(dtype: dt.DType) -> Ty:
    return Ty("Tensor", dtype)


# Frequently used concrete types.
UnitTy = Ty("Unit")
ShapeTy = Ty("HostShape")
SeedTy = Ty("HostSeed")
PrfKeyTy = Ty("HostPrfKey")
StringTy = Ty("HostString")
HostFloat32TensorTy = Ty("HostFloat32Tensor", dt.float32)
HostFloat64TensorTy = Ty("HostFloat64Tensor", dt.float64)
HostInt64TensorTy = Ty("HostInt64Tensor", dt.int64)
HostUint64TensorTy = Ty("HostUint64Tensor", dt.uint64)
HostBitTensorTy = Ty("HostBitTensor", dt.bool_)
HostRing64TensorTy = Ty("HostRing64Tensor")
HostRing128TensorTy = Ty("HostRing128Tensor")
ReplicatedRing64TensorTy = Ty("ReplicatedRing64Tensor")
ReplicatedRing128TensorTy = Ty("ReplicatedRing128Tensor")
ReplicatedBitTensorTy = Ty("ReplicatedBitTensor")
AdditiveRing64TensorTy = Ty("AdditiveRing64Tensor")
AdditiveRing128TensorTy = Ty("AdditiveRing128Tensor")
Mirrored3Ring64TensorTy = Ty("Mirrored3Ring64Tensor")
Mirrored3Ring128TensorTy = Ty("Mirrored3Ring128Tensor")
AesTensorTy = Ty("AesTensor")
AesKeyTy = Ty("AesKey")
ReplicatedAesKeyTy = Ty("ReplicatedAesKey")
HostAesKeyTy = Ty("HostAesKey")

# every AES-typed value name, for boundary dispatch/guards
AES_TY_NAMES = frozenset(
    {"AesTensor", "AesKey", "HostAesKey", "ReplicatedAesKey"}
)


def host_fixed_ty(dtype: dt.DType) -> Ty:
    total = 64 if dtype.name == "fixed64" else 128
    return Ty(f"HostFixed{total}Tensor", dtype)


def rep_fixed_ty(dtype: dt.DType) -> Ty:
    total = 64 if dtype.name == "fixed64" else 128
    return Ty(f"ReplicatedFixed{total}Tensor", dtype)


# ---------------------------------------------------------------------------
# Signatures (reference: Signature, computation.rs:620-767)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Signature:
    input_types: tuple[Ty, ...]
    return_type: Ty
    # variadic signatures (reference Signature::variadic,
    # computation.rs:620-767) carry ONE element type that every input
    # shares; textual form is ``[T] -> R`` and arity is unchecked
    variadic: bool = False

    def __post_init__(self):
        object.__setattr__(self, "input_types", tuple(self.input_types))

    @property
    def arity(self) -> int:
        return len(self.input_types)

    def to_textual(self) -> str:
        if self.variadic:
            return (
                f"[{self.input_types[0].to_textual()}] -> "
                f"{self.return_type.to_textual()}"
            )
        ins = ", ".join(t.to_textual() for t in self.input_types)
        return f"({ins}) -> {self.return_type.to_textual()}"


def signature(input_types: Iterable[Ty], return_type: Ty) -> Signature:
    return Signature(tuple(input_types), return_type)


# ---------------------------------------------------------------------------
# Operator vocabulary (reference: operators! macro, computation.rs:828-914)
# ---------------------------------------------------------------------------

OPERATORS = [
    "Abs", "Add", "And", "AtLeast2D", "BitExtract", "Broadcast", "Cast",
    "Concat", "Constant", "Decrypt", "DeriveSeed", "Div", "Diag", "Dot",
    "ExpandDims", "Identity", "IndexAxis", "Inverse", "Input", "Load", "Mul",
    "Mean", "Output", "Ones", "Or", "PrfKeyGen", "Reshape", "Receive",
    "Relu", "RingFixedpointArgmax", "RingFixedpointDecode",
    "RingFixedpointEncode", "RingInject", "RingFixedpointMean", "Sample",
    "SampleSeeded", "Select", "Send", "Save", "Shape", "Shl", "Shr", "Sign",
    "Slice", "Sqrt", "Squeeze", "Sub", "Sum", "Transpose", "Xor", "Zeros",
    # Fixed-point operators
    "Equal", "EqualZero", "Exp", "FixedpointEncode", "FixedpointDecode",
    "Greater", "Less", "Neg", "Pow2", "Sigmoid",
    # Additive operators
    "AdtToRep",
    # Replicated operators
    "AddN", "Argmax", "BitDecompose", "BitCompose", "Fill", "Index", "Log2",
    "Log", "Maximum", "Msb", "Mux", "RepToAdt", "Reveal", "Share", "Softmax",
    "ShlDim", "TruncPr",
    # Mirrored operators
    "Demirror", "Mirror",
    # Secret-shared checkpoint boundary (training): each party durably
    # persists / reloads ITS OWN replicated share pair through its local
    # storage — lowering expands these into per-owner ring-typed
    # Load/Save ops, so the model state never exists in the clear
    "LoadShares", "SaveShares",
    # Convolution / pooling (north-star extension — BASELINE.json configs
    # list encrypted ResNet-style inference; no reference counterpart)
    "Conv2D", "AvgPool2D", "MaxPool2D", "Im2Col",
]

OPERATOR_SET = frozenset(OPERATORS)


# ---------------------------------------------------------------------------
# Operations & computations
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Operation:
    """One node of the dataflow graph (reference: computation.rs:1656)."""

    name: str
    kind: str
    inputs: list[str]
    placement_name: str
    signature: Signature
    attributes: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in OPERATOR_SET:
            raise ValueError(f"unknown operator kind: {self.kind}")


@dataclasses.dataclass(eq=False)
class Computation:
    """A named dataflow graph (reference: NamedComputation,
    computation.rs:1663-1666).

    Identity-based equality/hash so computations can key weak caches
    (compiled-plan reuse) without structural comparison cost."""

    operations: dict[str, Operation] = dataclasses.field(default_factory=dict)
    placements: dict[str, Placement] = dataclasses.field(default_factory=dict)

    def add_operation(self, op: Operation) -> Operation:
        if op.name in self.operations:
            raise ValueError(f"duplicate operation name: {op.name}")
        self.operations[op.name] = op
        return op

    def add_placement(self, plc: Placement) -> Placement:
        existing = self.placements.get(plc.name)
        if existing is not None and existing != plc:
            raise ValueError(f"conflicting placement for name {plc.name}")
        self.placements[plc.name] = plc
        return plc

    def placement(self, name: str) -> Placement:
        return self.placements[name]

    def placement_of(self, op: Operation) -> Placement:
        return self.placements[op.placement_name]

    def find_outputs(self) -> list[Operation]:
        return [op for op in self.operations.values() if op.kind == "Output"]

    def find_inputs(self) -> list[Operation]:
        return [op for op in self.operations.values() if op.kind == "Input"]

    def consumers(self) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {name: [] for name in self.operations}
        for op in self.operations.values():
            for inp in op.inputs:
                out[inp].append(op.name)
        return out

    def toposort_names(self) -> list[str]:
        """Kahn topological order over dataflow edges, plus the Send/Receive
        rendezvous edges (reference: as_graph(), computation.rs:1879-1942)."""
        indeg: dict[str, int] = {name: 0 for name in self.operations}
        adj: dict[str, list[str]] = {name: [] for name in self.operations}
        # Stitch Send -> Receive edges by rendezvous key within the graph.
        sends: dict[str, str] = {}
        for op in self.operations.values():
            if op.kind == "Send":
                sends[op.attributes["rendezvous_key"]] = op.name
        for op in self.operations.values():
            deps = list(op.inputs)
            if op.kind == "Receive":
                rdv = op.attributes["rendezvous_key"]
                if rdv in sends:
                    deps.append(sends[rdv])
            for dep in deps:
                if dep not in self.operations:
                    raise ValueError(
                        f"operation {op.name} depends on unknown {dep}"
                    )
                adj[dep].append(op.name)
                indeg[op.name] += 1
        ready = [n for n, d in indeg.items() if d == 0]
        order: list[str] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.operations):
            raise ValueError("cycle detected in computation graph")
        return order

    def clone_empty(self) -> "Computation":
        c = Computation()
        c.placements = dict(self.placements)
        return c


# ---------------------------------------------------------------------------
# Session ids & rendezvous keys
# ---------------------------------------------------------------------------


class SessionId:
    """128-bit session identifier derived by hashing an arbitrary string
    (reference: computation.rs:95-144, blake3-based; we use blake2b which is
    in the Python standard library — documented deviation)."""

    __slots__ = ("_bytes", "_text")

    def __init__(self, text: str):
        self._text = text
        self._bytes = hashlib.blake2b(text.encode(), digest_size=16).digest()

    @classmethod
    def random(cls) -> "SessionId":
        return cls(secrets.token_hex(16))

    @property
    def text(self) -> str:
        return self._text

    def to_bytes(self) -> bytes:
        return self._bytes

    def __eq__(self, other):
        return isinstance(other, SessionId) and self._bytes == other._bytes

    def __hash__(self):
        return hash(self._bytes)

    def __repr__(self):
        return f"SessionId({self._text!r})"


class RendezvousKey:
    """128-bit tag addressing one value transfer inside a session
    (reference: computation.rs:30-93)."""

    __slots__ = ("_bytes",)

    def __init__(self, raw: bytes | str | int):
        if isinstance(raw, int):
            raw = raw.to_bytes(16, "little")
        elif isinstance(raw, str):
            raw = hashlib.blake2b(raw.encode(), digest_size=16).digest()
        assert isinstance(raw, bytes) and len(raw) == 16
        self._bytes = raw

    @classmethod
    def from_index(cls, index: int) -> "RendezvousKey":
        return cls(index)

    def to_bytes(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other):
        return isinstance(other, RendezvousKey) and self._bytes == other._bytes

    def __hash__(self):
        return hash(self._bytes)

    def __repr__(self):
        return f"RendezvousKey({self.hex()})"
