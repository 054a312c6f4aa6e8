"""Static communication/memory cost model over execution plans
(``MSA6xx`` + the machine-readable plan report).

Given a lowered, networked computation, this module predicts — without
executing anything — exactly what the runtime's metrics registry will
count for one session:

- per-party **tx/rx bytes** on the wire, to the byte: value payloads
  are priced by serializing zero-filled placeholders of the inferred
  shape/dtype through the REAL codec (:func:`moose_tpu_torch.serde.
  serialize_value`), and transport envelopes through the REAL frame
  packers (:func:`moose_tpu_torch.distributed.networking.pack_value_frame` /
  ``pack_batch_frame``) — msgpack sizes depend only on dtype, shape and
  key strings, all statically known, so the prediction cannot drift
  from the wire format;
- **envelope and payload counts after coalescing**: the worker plan's
  deferred-send flush groups coalesce per receiver into ``send_many``
  envelopes; the model walks the same reconstructed schedule
  (:mod:`.schedule`) the worker executes;
- per-segment **live-buffer high-water-mark**: the peak bytes of
  values simultaneously live while a compute segment executes
  (inputs + intermediates + outputs, with dead values retired at their
  last in-segment use).

The shape/dtype layer is a tiny abstract interpreter
(:func:`infer_specs`) over the host-level op vocabulary; unknown shapes
(e.g. an ``Input`` without a provided spec) propagate as unknown and
unify through elementwise ops (the protocol masks every share with a
statically-shaped sample, so in practice everything a Send carries
resolves).

Rules:

- ``MSA601`` (warning): a Send payload's size cannot be resolved
  statically — the cost model (and the predicted-vs-measured CI gate)
  is incomplete for this graph.
- ``MSA602`` (info): jumbo transfer — one rendezvous payload exceeds
  ``JUMBO_PAYLOAD_BYTES``; consider splitting before it monopolizes an
  envelope.
- ``MSA603`` (info): a segment's live-buffer high-water-mark exceeds
  ``LIVE_BUFFER_NOTE_BYTES`` — the jit candidate will hold that much
  device memory at once.

Like the schedule analysis, everything here is a no-op on
pre-networking or composite-placement graphs.

The port's own copy of ``moose_tpu/compilation/analysis/cost.py``: the
same model, sizing each payload through the port's value codec
(``serde.serialize_value``, the JAX package's bytes) and transport
helpers (``distributed.fabric``, ``distributed.networking``) on a zero
placeholder of the port's values.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import dtypes as dt
from ...computation import Computation, Operation
from .diagnostics import Diagnostic, Severity
from .schedule import (
    RoleSchedule,
    _analyzable,
    reconstruct_schedules,
)

__all__ = [
    "JUMBO_PAYLOAD_BYTES",
    "LIVE_BUFFER_NOTE_BYTES",
    "ValueSpec",
    "analyze_cost",
    "cost_report",
    "infer_specs",
    "memory_bytes",
    "payload_bytes",
]

# one payload above this is flagged MSA602 (gRPC's default cap is 4 MB;
# we lift it, but a transfer this size deserves a look)
JUMBO_PAYLOAD_BYTES = 64 * 1024 * 1024
# a segment holding more than this live at once is noted (MSA603)
LIVE_BUFFER_NOTE_BYTES = 1024 * 1024 * 1024


def _threshold(
    override: Optional[int], env_var: str, default: int
) -> int:
    """MSA602/MSA603 note thresholds: explicit argument (prancer
    --jumbo-bytes / --live-buffer-bytes) beats the env knob beats the
    module default."""
    if override is not None:
        return int(override)
    env = os.environ.get(env_var)
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return default

UNKNOWN_SHAPE: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class ValueSpec:
    """Abstract value: enough to price its wire and memory footprint.

    ``kind``: ``ring`` (+``width``), ``bit``, ``tensor`` (+``dtype``),
    ``shape``/``string`` (+``value``), ``seed``, ``key``, ``unit``, or
    ``unknown``.  ``shape`` is the array shape, or ``None`` when not
    statically resolved."""

    kind: str
    shape: Optional[Tuple[int, ...]] = None
    width: int = 64
    dtype: Optional[dt.DType] = None
    value: Any = None

    @property
    def resolved(self) -> bool:
        if self.kind in ("seed", "key", "unit"):
            return True
        if self.kind in ("shape", "string"):
            return self.value is not None
        return self.kind != "unknown" and self.shape is not None


UNKNOWN = ValueSpec("unknown")
UNIT = ValueSpec("unit")


def _cache_token(spec: ValueSpec) -> Tuple[Any, ...]:
    value = spec.value
    if isinstance(value, (list, np.ndarray)):
        value = tuple(np.asarray(value).flatten().tolist())
    return (spec.kind, spec.shape, spec.width, spec.dtype, value)


_PAYLOAD_CACHE: Dict[Tuple[Any, ...], Optional[int]] = {}


def payload_bytes(spec: ValueSpec) -> Optional[int]:
    """Exact ``serialize_value`` size of a value matching ``spec`` —
    measured by serializing a zero-filled placeholder through the real
    codec (tensor payload bytes travel as raw bins, so content never
    changes the length; shapes/dtypes/widths are in the spec)."""
    token = _cache_token(spec)
    if token in _PAYLOAD_CACHE:
        return _PAYLOAD_CACHE[token]
    placeholder = _placeholder(spec)
    size: Optional[int] = None
    if placeholder is not None:
        from ...serde import serialize_value

        size = len(serialize_value(placeholder))
    _PAYLOAD_CACHE[token] = size
    return size


def _placeholder(spec: ValueSpec) -> Any:
    """A zero-filled port value matching ``spec``, its tensors on the
    CPU (ring words int64, bits uint8), or None when the spec is not
    sized."""
    import torch

    from ...values import (
        HostBitTensor,
        HostPrfKey,
        HostRingTensor,
        HostSeed,
        HostShape,
        HostString,
        HostTensor,
        HostUnit,
    )

    if spec.kind == "ring" and spec.shape is not None:
        lo = torch.zeros(spec.shape, dtype=torch.int64)
        hi = (
            torch.zeros(spec.shape, dtype=torch.int64)
            if spec.width == 128 else None
        )
        return HostRingTensor(lo, hi, spec.width, "static")
    if spec.kind == "bit" and spec.shape is not None:
        return HostBitTensor(
            torch.zeros(spec.shape, dtype=torch.uint8), "static"
        )
    if spec.kind == "tensor" and spec.shape is not None:
        dtype = spec.dtype or dt.float64
        arr = np.zeros(spec.shape, dtype=np.dtype(dtype.numpy_name))
        if arr.dtype == np.uint64:  # the port keeps u64 words as int64
            arr = arr.view(np.int64)
        return HostTensor(torch.from_numpy(arr), "static", dtype)
    if spec.kind == "shape" and spec.value is not None:
        return HostShape(tuple(int(d) for d in spec.value), "static")
    if spec.kind == "string" and spec.value is not None:
        return HostString(str(spec.value), "static")
    if spec.kind == "seed":
        return HostSeed((0, 0, 0, 0), "static")
    if spec.kind == "key":
        return HostPrfKey((0, 0, 0, 0), "static")
    if spec.kind == "unit":
        return HostUnit("static")
    return None


_FABRIC_PAYLOAD_CACHE: Dict[Tuple[Any, ...], Optional[Tuple[int, int]]] = {}


def fabric_payload(spec: ValueSpec) -> Optional[Tuple[int, int]]:
    """``(array leaf count, device bytes)`` a fabric transfer of a value
    matching ``spec`` moves — computed with the SAME tree-leaf + nbytes
    accounting the runtime applies (``distributed.fabric.value_leaves``
    / ``leaf_bytes``) on the zero placeholder, which is what makes
    predicted fabric bytes equal measured counter deltas exactly.  A
    leaf count of 0 (HostUnit/HostShape/HostString) is the passthrough
    case: no permute, zero bytes, on both sides of the prediction."""
    token = _cache_token(spec)
    if token in _FABRIC_PAYLOAD_CACHE:
        return _FABRIC_PAYLOAD_CACHE[token]
    placeholder = _placeholder(spec)
    result: Optional[Tuple[int, int]] = None
    if placeholder is not None:
        from ...distributed.fabric import leaf_bytes, value_leaves

        leaves = value_leaves(placeholder)
        result = (len(leaves), leaf_bytes(leaves))
    _FABRIC_PAYLOAD_CACHE[token] = result
    return result


def fabric_hops(fabric_parties: Sequence[str], sender: str,
                receiver: str) -> int:
    """MSA6xx permute distance: ring hops between mesh positions, in
    the domain's declaration order (mirrors ``FabricDomain.hops``)."""
    order = list(fabric_parties)
    n = len(order)
    d = (order.index(receiver) - order.index(sender)) % n
    return min(d, n - d) or n


def memory_bytes(spec: ValueSpec) -> Optional[int]:
    """In-memory footprint (device/host array bytes, not wire bytes)."""
    if spec.kind in ("seed", "key"):
        return 16
    if spec.kind in ("shape", "string", "unit"):
        return 0
    if spec.shape is None:
        return None
    n = int(np.prod(spec.shape)) if spec.shape else 1
    if spec.kind == "ring":
        return n * (16 if spec.width == 128 else 8)
    if spec.kind == "bit":
        return n  # one uint8 lane per bit
    if spec.kind == "tensor":
        dtype = spec.dtype or dt.float64
        return n * np.dtype(dtype.numpy_name).itemsize
    return None


# ---------------------------------------------------------------------------
# shape/dtype inference (abstract interpretation over host-level ops)
# ---------------------------------------------------------------------------


def _ring_width_of(ty_name: str) -> int:
    return 128 if "128" in ty_name else 64


def _unify(*shapes: Optional[Tuple[int, ...]]) -> Optional[Tuple[int, ...]]:
    """Broadcast-unify; an unknown side adopts the other (protocol
    elementwise ops always act on equal-shaped operands — the masks are
    statically shaped even when the user input is not)."""
    known = [s for s in shapes if s is not None]
    if not known:
        return None
    try:
        return tuple(int(d) for d in np.broadcast_shapes(*known))
    except ValueError:
        return None


def _tensorlike(args: Sequence[ValueSpec]) -> ValueSpec:
    """The carrier spec of an elementwise result: first ring, else
    first bit, else first tensor, else unknown."""
    for kind in ("ring", "bit", "tensor"):
        for a in args:
            if a.kind == kind:
                return a
    return UNKNOWN


def _elementwise(op: Operation, args: List[ValueSpec]) -> ValueSpec:
    carrier = _tensorlike(args)
    shape = _unify(*(
        a.shape for a in args if a.kind in ("ring", "bit", "tensor")
    ))
    if carrier.kind == "unknown":
        return UNKNOWN
    return dataclasses.replace(carrier, shape=shape)


def _shape_value(spec: ValueSpec) -> Optional[Tuple[int, ...]]:
    if spec.kind == "shape" and spec.value is not None:
        return tuple(int(d) for d in spec.value)
    return None


def _dot_shape(
    a: Optional[Tuple[int, ...]], b: Optional[Tuple[int, ...]]
) -> Optional[Tuple[int, ...]]:
    if a is None or b is None:
        return None
    if len(a) == 1 and len(b) == 1:
        return ()
    if len(a) == 2 and len(b) == 2:
        return (a[0], b[1])
    if len(a) == 1:
        return tuple(b[:-2]) + (b[-1],) if len(b) >= 2 else None
    if len(b) == 1:
        return tuple(a[:-1])
    return tuple(a[:-1]) + (b[-1],)


def _reduce_shape(
    shape: Optional[Tuple[int, ...]], axis: Any
) -> Optional[Tuple[int, ...]]:
    if shape is None:
        return None
    if axis is None:
        return ()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    try:
        axes = tuple(a % len(shape) for a in axes)
    except (TypeError, ZeroDivisionError):
        return None
    return tuple(d for i, d in enumerate(shape) if i not in axes)


def _slice_shape(
    shape: Optional[Tuple[int, ...]], op: Operation
) -> Optional[Tuple[int, ...]]:
    if shape is None:
        return None
    attrs = op.attributes
    spec = attrs.get("slices", attrs.get("slice_spec"))
    try:
        if spec is not None:
            slices = tuple(
                Ellipsis
                if s == "..."
                else (slice(*s) if isinstance(s, (tuple, list)) else s)
                for s in spec
            )
            return tuple(np.zeros(shape, dtype=np.bool_)[slices].shape)
        begin, end = attrs.get("begin"), attrs.get("end")
        if begin is None or end is None:
            return None
        idx = tuple(slice(b, e) for b, e in zip(begin, end))
        return tuple(np.zeros(shape, dtype=np.bool_)[idx].shape)
    except (IndexError, ValueError, TypeError):
        return None


def _spec_for(
    comp: Computation,
    op: Operation,
    args: List[ValueSpec],
    send_by_key: Dict[str, Operation],
    specs: Dict[str, ValueSpec],
) -> ValueSpec:
    kind = op.kind
    A = op.attributes
    ret = op.signature.return_type

    if kind == "Constant":
        value = A.get("value")
        if ret.name == "HostShape":
            return ValueSpec(
                "shape", value=tuple(int(d) for d in value)
            )
        if ret.name == "HostString":
            return ValueSpec("string", value=value)
        arr_shape = tuple(np.asarray(value).shape)
        if ret.name.startswith("HostRing"):
            return ValueSpec(
                "ring", arr_shape, width=_ring_width_of(ret.name)
            )
        if ret.name == "HostBitTensor":
            return ValueSpec("bit", arr_shape)
        return ValueSpec("tensor", arr_shape, dtype=ret.dtype)
    if kind == "Input":
        return ValueSpec("tensor", UNKNOWN_SHAPE, dtype=ret.dtype)
    if kind == "Load":
        return ValueSpec("tensor", UNKNOWN_SHAPE, dtype=ret.dtype)
    if kind in ("Save", "Send"):
        return UNIT
    if kind == "Output":
        return args[0] if args else UNKNOWN
    if kind == "Receive":
        key = A.get("rendezvous_key")
        send = send_by_key.get(key) if isinstance(key, str) else None
        if send is not None and send.inputs:
            return specs.get(send.inputs[0], UNKNOWN)
        return UNKNOWN
    if kind == "PrfKeyGen":
        return ValueSpec("key")
    if kind == "DeriveSeed":
        return ValueSpec("seed")
    if kind in ("Sample", "SampleSeeded"):
        shp = _shape_value(args[0]) if args else None
        if ret.name == "HostBitTensor":
            return ValueSpec("bit", shp)
        return ValueSpec("ring", shp, width=_ring_width_of(ret.name))
    if kind == "Fill":
        shp = _shape_value(args[0]) if args else None
        if ret.name == "HostBitTensor":
            return ValueSpec("bit", shp)
        return ValueSpec("ring", shp, width=_ring_width_of(ret.name))
    if kind in ("Zeros", "Ones"):
        shp = _shape_value(args[0]) if args else None
        return ValueSpec("tensor", shp, dtype=ret.dtype or dt.float64)
    if kind == "Identity":
        return args[0] if args else UNKNOWN
    if kind == "Shape":
        if args and args[0].shape is not None:
            return ValueSpec("shape", value=args[0].shape)
        return ValueSpec("shape")
    if kind in ("Add", "Sub", "Mul", "Div", "And", "Or", "Xor", "Mux",
                "Maximum", "AddN", "Relu", "Abs", "Sign", "Neg",
                "Sigmoid", "Exp", "Log", "Log2", "Sqrt", "Pow2",
                "Softmax", "Inverse", "EqualZero"):
        return _elementwise(op, args)
    if kind in ("Less", "Greater", "Equal"):
        base = _elementwise(op, args)
        if ret.name == "HostBitTensor":
            return ValueSpec("bit", base.shape)
        return ValueSpec("tensor", base.shape, dtype=ret.dtype or dt.bool_)
    if kind in ("Shl", "Shr", "ShlDim"):
        return args[0] if args else UNKNOWN
    if kind == "BitExtract":
        shp = args[0].shape if args else None
        return ValueSpec("bit", shp)
    if kind == "RingInject":
        shp = args[0].shape if args else None
        return ValueSpec("ring", shp, width=_ring_width_of(ret.name))
    if kind == "BitDecompose":
        if not args or args[0].shape is None:
            return ValueSpec("bit")
        bits = 128 if args[0].width == 128 else 64
        return ValueSpec("bit", (bits,) + tuple(args[0].shape))
    if kind == "BitCompose":
        shp = args[0].shape if args else None
        inner = tuple(shp[1:]) if shp else None
        return ValueSpec("ring", inner, width=_ring_width_of(ret.name))
    if kind == "RingFixedpointEncode":
        shp = args[0].shape if args else None
        return ValueSpec("ring", shp, width=_ring_width_of(ret.name))
    if kind == "RingFixedpointDecode":
        shp = args[0].shape if args else None
        return ValueSpec("tensor", shp, dtype=ret.dtype or dt.float64)
    if kind == "RingFixedpointMean":
        shp = _reduce_shape(args[0].shape if args else None, A.get("axis"))
        return ValueSpec(
            "ring", shp, width=args[0].width if args else 64
        )
    if kind == "Cast":
        shp = args[0].shape if args else None
        target = A.get("dtype") or ret.dtype
        return ValueSpec("tensor", shp, dtype=target)
    if kind == "Dot":
        carrier = _tensorlike(args)
        shp = _dot_shape(
            args[0].shape if args else None,
            args[1].shape if len(args) > 1 else None,
        )
        if carrier.kind == "unknown":
            return UNKNOWN
        return dataclasses.replace(carrier, shape=shp)
    if kind in ("Sum", "Mean"):
        carrier = _tensorlike(args)
        shp = _reduce_shape(args[0].shape if args else None, A.get("axis"))
        if carrier.kind == "unknown":
            return UNKNOWN
        if kind == "Mean" and carrier.kind == "tensor":
            return ValueSpec("tensor", shp, dtype=carrier.dtype)
        return dataclasses.replace(carrier, shape=shp)
    if kind == "Argmax":
        carrier = _tensorlike(args)
        shp = _reduce_shape(args[0].shape if args else None, A.get("axis"))
        if carrier.kind == "unknown":
            return UNKNOWN
        return dataclasses.replace(carrier, shape=shp)
    if kind == "Concat":
        carrier = _tensorlike(args)
        axis = int(A.get("axis", 0) or 0)
        shapes = [a.shape for a in args]
        if carrier.kind == "unknown" or any(s is None for s in shapes):
            return dataclasses.replace(carrier, shape=None) \
                if carrier.kind != "unknown" else UNKNOWN
        first = list(shapes[0])  # type: ignore[arg-type]
        axis %= len(first)
        first[axis] = sum(int(s[axis]) for s in shapes)  # type: ignore[index]
        return dataclasses.replace(carrier, shape=tuple(first))
    if kind == "ExpandDims":
        if not args or args[0].shape is None:
            return args[0] if args else UNKNOWN
        axis = A.get("axis", 0)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shp = list(args[0].shape)
        for ax in sorted(int(a) for a in axes):
            shp.insert(ax if ax >= 0 else len(shp) + ax + 1, 1)
        return dataclasses.replace(args[0], shape=tuple(shp))
    if kind == "Squeeze":
        if not args or args[0].shape is None:
            return args[0] if args else UNKNOWN
        axis = A.get("axis")
        shp = args[0].shape
        if axis is None:
            out = tuple(d for d in shp if d != 1)
        else:
            axes = {(
                int(a) % len(shp)
            ) for a in ((axis,) if isinstance(axis, int) else axis)}
            out = tuple(d for i, d in enumerate(shp) if i not in axes)
        return dataclasses.replace(args[0], shape=out)
    if kind == "IndexAxis":
        shp = _reduce_shape(
            args[0].shape if args else None, A.get("axis", 0)
        )
        return (
            dataclasses.replace(args[0], shape=shp) if args else UNKNOWN
        )
    if kind == "Slice":
        if args and args[0].kind == "shape":
            value = _shape_value(args[0])
            begin, end = A.get("begin"), A.get("end")
            if value is None or begin is None or end is None:
                return ValueSpec("shape")
            return ValueSpec(
                "shape", value=value[int(begin[0]):int(end[0])]
            )
        shp = _slice_shape(args[0].shape if args else None, op)
        return (
            dataclasses.replace(args[0], shape=shp) if args else UNKNOWN
        )
    if kind == "Reshape":
        shp = _shape_value(args[1]) if len(args) > 1 else None
        return (
            dataclasses.replace(args[0], shape=shp) if args else UNKNOWN
        )
    if kind == "Broadcast":
        shp = _shape_value(args[1]) if len(args) > 1 else None
        return (
            dataclasses.replace(args[0], shape=shp) if args else UNKNOWN
        )
    if kind == "Transpose":
        if not args or args[0].shape is None:
            return args[0] if args else UNKNOWN
        axes = A.get("axes")
        shp = args[0].shape
        if axes is None:
            out = tuple(reversed(shp))
        else:
            out = tuple(shp[int(a)] for a in axes)
        return dataclasses.replace(args[0], shape=out)
    if kind == "Diag":
        if not args or args[0].shape is None:
            return args[0] if args else UNKNOWN
        shp = args[0].shape
        out = (
            (shp[0], shp[0]) if len(shp) == 1 else (min(shp[0], shp[1]),)
        )
        return dataclasses.replace(args[0], shape=out)
    if kind == "AtLeast2D":
        if not args or args[0].shape is None:
            return args[0] if args else UNKNOWN
        shp = args[0].shape
        if len(shp) >= 2:
            return args[0]
        n = shp[0] if shp else 1
        out = (n, 1) if A.get("to_column_vector") else (1, n)
        return dataclasses.replace(args[0], shape=out)
    # Select is dynamic-shape by definition; Conv2D/Im2Col/pools and
    # anything else exotic degrade to unknown — priced conservatively
    # and surfaced through MSA601 if a Send carries them.
    return UNKNOWN


def infer_specs(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
) -> Dict[str, ValueSpec]:
    """Abstract-interpret the graph in topological order, returning a
    :class:`ValueSpec` per op.  ``arg_specs`` optionally pins shapes
    for ``Input``/``Load`` ops: ``{op_name: (shape, np_dtype)}`` or
    ``{op_name: shape}`` (the same convention as the compiler's
    ``arg_specs``)."""
    arg_specs = dict(arg_specs or {})
    send_by_key: Dict[str, Operation] = {}
    for op in comp.operations.values():
        if op.kind == "Send":
            key = op.attributes.get("rendezvous_key")
            if isinstance(key, str):
                send_by_key[key] = op
    specs: Dict[str, ValueSpec] = {}
    for name in comp.toposort_names():
        op = comp.operations[name]
        if op.kind in ("Input", "Load") and name in arg_specs:
            raw = arg_specs[name]
            shape: Any = raw
            dtype: Any = None
            if (
                isinstance(raw, tuple) and len(raw) == 2
                and isinstance(raw[0], (tuple, list))
            ):
                shape, dtype = raw
            dd = (
                dt.from_numpy(np.dtype(dtype)) if dtype is not None
                else (op.signature.return_type.dtype or dt.float64)
            )
            specs[name] = ValueSpec(
                "tensor", tuple(int(d) for d in shape), dtype=dd
            )
            continue
        args = [specs.get(i, UNKNOWN) for i in op.inputs]
        specs[name] = _spec_for(comp, op, args, send_by_key, specs)
    return specs


# ---------------------------------------------------------------------------
# the cost model: schedule walk -> wire counters + live buffers
# ---------------------------------------------------------------------------


def _group_by_receiver(
    comp: Computation, group: Sequence[str]
) -> List[Tuple[str, List[str]]]:
    """One flush group's receiver buckets, in first-appearance order —
    the exact coalescing the async sender applies
    (``_AsyncSender.enqueue_group``)."""
    buckets: Dict[str, List[str]] = {}
    order: List[str] = []
    for name in group:
        receiver = comp.operations[name].attributes.get("receiver", "")
        if receiver not in buckets:
            buckets[receiver] = []
            order.append(receiver)
        buckets[receiver].append(name)
    return [(receiver, buckets[receiver]) for receiver in order]


def _segment_live_hwm(
    comp: Computation,
    seg_names: Sequence[str],
    in_names: Sequence[str],
    out_names: Sequence[str],
    specs: Dict[str, ValueSpec],
) -> Tuple[Optional[int], bool]:
    """Peak simultaneously-live bytes while the segment executes:
    inputs live at entry, produced values live from their op, dead
    values retired after their last in-segment use (outputs never
    retire).  Returns (hwm, exact) — hwm is the best known lower bound
    when some spec is unresolved (exact=False)."""
    last_use: Dict[str, int] = {}
    for pos, name in enumerate(seg_names):
        for i in comp.operations[name].inputs:
            last_use[i] = pos
    keep = set(out_names)
    live: Dict[str, int] = {}
    exact = True

    def size_of(name: str) -> Optional[int]:
        return memory_bytes(specs.get(name, UNKNOWN))

    for i in in_names:
        b = size_of(i)
        if b is None:
            exact = False
        else:
            live[i] = b
    hwm = sum(live.values())
    for pos, name in enumerate(seg_names):
        b = size_of(name)
        if b is None:
            exact = False
        else:
            live[name] = b
        hwm = max(hwm, sum(live.values()))
        for i in list(live):
            if i not in keep and last_use.get(i, -1) <= pos:
                if i != name:
                    live.pop(i, None)
    return hwm, exact


def cost_report(
    comp: Computation,
    session_id: str = "0" * 32,
    arg_specs: Optional[Dict[str, Any]] = None,
    transport: str = "grpc",
    coalesce: bool = True,
    schedules: Optional[Dict[str, RoleSchedule]] = None,
    arg_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    fabric_parties: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """The machine-readable plan report: predicted per-party wire
    counters for ONE session under ``transport`` semantics, plus
    per-segment live-buffer high-water-marks.

    ``session_id`` only matters through its length (it rides in every
    transfer key; the client mints 32-hex-char ids).  ``coalesce=False``
    prices the legacy eager scheduler (every send a singleton).
    Predictions match the runtime metrics registry exactly — the
    ``dist_smoke`` CI gate asserts it.

    ``transport="fabric"`` prices edges whose BOTH endpoints are in
    ``fabric_parties`` (an ordered tuple — ring position = hop count)
    as collective permutes: device leaf bytes with no serde framing,
    one permute per flush bucket (batched when the bucket coalesces
    more than one array-bearing payload), plus a ``fabric_cost`` of
    bytes x ring hops per transfer.  Edges crossing the domain boundary
    keep exact gRPC frame pricing — mixed sessions stay exact.

    When ``arg_ranges`` declares real-space input bounds, the report
    gains a ``ranges`` block (the MSA704 per-value precision report) —
    together wire bytes + ring-width demand are the planner's inputs
    for the ring64-vs-ring128 choice (ROADMAP item 4)."""
    from ...distributed.networking import (
        pack_batch_frame,
        pack_value_frame,
        transfer_key,
    )

    if schedules is None:
        schedules = reconstruct_schedules(comp)
    specs = infer_specs(comp, arg_specs)

    parties = sorted(schedules)
    fabric_order: Tuple[str, ...] = tuple(fabric_parties or ())
    if transport == "fabric" and not fabric_order:
        fabric_order = tuple(parties)
    fabric_members = frozenset(fabric_order)
    per_party: Dict[str, Dict[str, Any]] = {
        p: {
            "tx_bytes": 0, "rx_bytes": 0, "sends": 0,
            "send_many_envelopes": 0, "send_many_payloads": 0,
            "receives": 0, "segments": [], "unresolved_sends": [],
        }
        for p in parties
    }
    if transport == "fabric":
        for p in parties:
            per_party[p].update({
                "fabric_permutes": 0, "fabric_batched_permutes": 0,
                "fabric_permute_payloads": 0, "fabric_tx_bytes": 0,
                "fabric_cost": 0, "fallback_sends": 0,
            })
    resolved = True

    def _fabric_edge(sender: str, receiver: str) -> bool:
        return (
            transport == "fabric"
            and sender in fabric_members
            and receiver in fabric_members
        )

    def _payload(send_name: str) -> Optional[int]:
        op = comp.operations[send_name]
        if not op.inputs:
            return None
        return payload_bytes(specs.get(op.inputs[0], UNKNOWN))

    for party in parties:
        sched = schedules[party]
        stats = per_party[party]
        flush_groups: List[Sequence[str]] = []
        for kind, payload in sched.steps:
            if kind == "sends":
                flush_groups.append([str(n) for n in payload])
            elif kind == "op" and comp.operations[
                str(payload)
            ].kind == "Send":
                flush_groups.append([str(payload)])
        if not coalesce:
            flush_groups = [
                [n] for group in flush_groups for n in group
            ]
        for group in flush_groups:
            for receiver, names in _group_by_receiver(comp, group):
                if _fabric_edge(party, receiver):
                    fsizes = [
                        fabric_payload(specs.get(
                            comp.operations[n].inputs[0], UNKNOWN
                        )) if comp.operations[n].inputs else None
                        for n in names
                    ]
                    if any(s is None for s in fsizes):
                        resolved = False
                        stats["unresolved_sends"].extend(
                            n for n, s in zip(names, fsizes)
                            if s is None
                        )
                        continue
                    leafy = [s for s in fsizes
                             if s is not None and s[0] > 0]
                    total_bytes = sum(b for _, b in leafy)
                    if len(names) > 1 and coalesce:
                        # FabricNetworking.send_many: one batched
                        # permute moves every array-bearing payload
                        stats["send_many_envelopes"] += 1
                        stats["send_many_payloads"] += len(names)
                        if leafy:
                            stats["fabric_permutes"] += 1
                            stats["fabric_permute_payloads"] += len(
                                leafy
                            )
                            if len(leafy) > 1:
                                stats["fabric_batched_permutes"] += 1
                    else:
                        # singleton send(): one permute per array-
                        # bearing payload, passthrough for the rest
                        stats["sends"] += len(names)
                        stats["fabric_permutes"] += len(leafy)
                        stats["fabric_permute_payloads"] += len(leafy)
                    stats["fabric_tx_bytes"] += total_bytes
                    stats["tx_bytes"] += total_bytes
                    stats["fabric_cost"] += total_bytes * fabric_hops(
                        fabric_order, party, receiver
                    )
                    per_party[receiver]["rx_bytes"] += total_bytes
                    continue
                sizes = [_payload(n) for n in names]
                if any(s is None for s in sizes):
                    resolved = False
                    stats["unresolved_sends"].extend(
                        n for n, s in zip(names, sizes) if s is None
                    )
                    continue
                entries = [
                    (
                        transfer_key(
                            session_id,
                            str(comp.operations[n].attributes.get(
                                "rendezvous_key"
                            )),
                        ),
                        b"\x00" * int(s),  # placeholder payload bytes
                    )
                    for n, s in zip(names, sizes)
                ]
                if transport == "fabric":
                    # an edge crossing the trust boundary: exact wire
                    # (gRPC frame) pricing, tallied as fallbacks
                    stats["fallback_sends"] += len(names)
                if len(names) > 1 and coalesce:
                    stats["send_many_envelopes"] += 1
                    stats["send_many_payloads"] += len(names)
                    if transport in ("grpc", "fabric"):
                        frame = len(pack_batch_frame(party, entries))
                        stats["tx_bytes"] += frame
                        per_party[receiver]["rx_bytes"] += frame
                    else:
                        # LocalNetworking.send_many delegates to send():
                        # payload-granular byte and send counters
                        stats["sends"] += len(names)
                        for _, payload_blob in entries:
                            stats["tx_bytes"] += len(payload_blob)
                            per_party[receiver]["rx_bytes"] += len(
                                payload_blob
                            )
                else:
                    for (key, payload_blob), name in zip(entries, names):
                        stats["sends"] += 1
                        if transport in ("grpc", "fabric"):
                            frame = len(pack_value_frame(
                                party, key, payload_blob
                            ))
                            stats["tx_bytes"] += frame
                            per_party[receiver]["rx_bytes"] += frame
                        else:
                            stats["tx_bytes"] += len(payload_blob)
                            per_party[receiver]["rx_bytes"] += len(
                                payload_blob
                            )
        stats["receives"] = len(sched.recv_names)
        for seg in sched.segments:
            hwm, exact = _segment_live_hwm(
                comp, seg.names, seg.in_names, seg.out_names, specs
            )
            stats["segments"].append({
                "index": seg.index,
                "ops": len(seg.names),
                "live_bytes_hwm": hwm,
                "exact": exact,
                "validatable": seg.validatable,
            })

    total_keys = [
        "tx_bytes", "rx_bytes", "sends", "send_many_envelopes",
        "send_many_payloads", "receives",
    ]
    if transport == "fabric":
        total_keys += [
            "fabric_permutes", "fabric_batched_permutes",
            "fabric_permute_payloads", "fabric_tx_bytes",
            "fabric_cost", "fallback_sends",
        ]
    totals = {
        k: sum(int(per_party[p][k]) for p in parties)
        for k in total_keys
    }
    report = {
        "transport": transport,
        "coalesce": coalesce,
        "session_id_len": len(session_id),
        "resolved": resolved,
        "per_party": per_party,
        "totals": totals,
    }
    if transport == "fabric":
        report["fabric_parties"] = list(fabric_order)
    if arg_ranges is not None:
        from .ranges import range_report

        report["ranges"] = range_report(
            comp, arg_specs=arg_specs, arg_ranges=arg_ranges
        )
    return report


def analyze_cost(
    comp: Computation,
    jumbo_bytes: Optional[int] = None,
    live_buffer_bytes: Optional[int] = None,
) -> List[Diagnostic]:
    """MSA6xx entry point registered with :func:`analysis.analyze`.
    ``jumbo_bytes``/``live_buffer_bytes`` override the MSA602/MSA603
    note thresholds (env: ``MOOSE_TPU_LINT_JUMBO_BYTES``,
    ``MOOSE_TPU_LINT_LIVE_BUFFER_BYTES``)."""
    if not _analyzable(comp):
        return []
    jumbo = _threshold(
        jumbo_bytes, "MOOSE_TPU_LINT_JUMBO_BYTES", JUMBO_PAYLOAD_BYTES
    )
    live_note = _threshold(
        live_buffer_bytes, "MOOSE_TPU_LINT_LIVE_BUFFER_BYTES",
        LIVE_BUFFER_NOTE_BYTES,
    )
    try:
        schedules = reconstruct_schedules(comp)
    except ValueError:
        return []  # unschedulable graphs are MSA501's finding
    specs = infer_specs(comp)
    diagnostics: List[Diagnostic] = []
    for name in sorted(comp.operations):
        op = comp.operations[name]
        if op.kind != "Send" or not op.inputs:
            continue
        spec = specs.get(op.inputs[0], UNKNOWN)
        size = payload_bytes(spec)
        if size is None:
            diagnostics.append(Diagnostic(
                "MSA601", Severity.WARNING,
                f"Send payload {op.inputs[0]!r} has no statically "
                f"resolvable size (kind={spec.kind}, shape="
                f"{spec.shape}); the cost model is incomplete for "
                f"this graph",
                op=name, placement=op.placement_name,
            ))
        elif size > jumbo:
            diagnostics.append(Diagnostic(
                "MSA602", Severity.INFO,
                f"jumbo transfer: payload {op.inputs[0]!r} serializes "
                f"to {size} bytes (> {jumbo})",
                op=name, placement=op.placement_name,
            ))
    for role in sorted(schedules):
        sched = schedules[role]
        for seg in sched.segments:
            hwm, exact = _segment_live_hwm(
                comp, seg.names, seg.in_names, seg.out_names, specs
            )
            if exact and hwm is not None and hwm > live_note:
                diagnostics.append(Diagnostic(
                    "MSA603", Severity.INFO,
                    f"segment {seg.index} on {role!r} holds "
                    f"{hwm} bytes live at its high-water mark "
                    f"(> {live_note})",
                    op=seg.names[0], placement=role,
                ))
    return diagnostics


RULES = {
    "MSA601": "Send payload size not statically resolvable (cost model "
              "incomplete for this graph)",
    "MSA602": "jumbo transfer: one rendezvous payload exceeds the "
              "envelope-size note threshold",
    "MSA603": "segment live-buffer high-water-mark exceeds the device-"
              "memory note threshold",
}
