"""Computation (de)serialization: reference-compatible msgpack.

Implements the ``__type__``-tagged msgpack schema of the reference's Python
bridge (``pymoose/pymoose/computation/utils.py:84-175``), so logical
computations serialized by pymoose deserialize here and vice versa:

- operations are tagged ``<Kind>Operation`` with the reference's field
  names (``inputs`` as a dict keyed lhs/rhs/x/array{i}/...),
- value types are tagged ``TensorType``/``StringType``/... with ``DType``
  sub-tags,
- placements are tagged ``HostPlacement``/``ReplicatedPlacement``/
  ``MirroredPlacement``,
- constants are tagged ``TensorConstant``/``ShapeConstant``/... and
  ndarrays ``{"__type__": "ndarray", dtype, items, shape}``.

Host-level (lowered) computations contain operators the reference's
*Python* schema never carries (SampleSeeded, DeriveSeed, ...; in the
reference those only exist in the Rust IR).  They are serialized with a
``RawOperation`` extension tag carrying kind + attributes verbatim, so any
moose_tpu computation — logical or lowered — round-trips through this
module.

The port's own copy of the computation codec of ``moose_tpu/serde.py``:
it imports nothing of the JAX package and writes the same bytes.  The
runtime value codec (``serialize_value``/``deserialize_value``, the wire
format of Send/Receive between distributed workers) comes with the
distributed runtime (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

from typing import Any

import msgpack
import numpy as np

from . import dtypes as dt
from .computation import (
    AdditivePlacement,
    Computation,
    HostPlacement,
    Mirrored3Placement,
    Operation,
    ReplicatedPlacement,
    Signature,
    Ty,
)
from .errors import MalformedComputationError

# ---------------------------------------------------------------------------
# Operator kind <-> reference msgpack tag
# ---------------------------------------------------------------------------

_KIND_TO_TAG = {
    "Abs": "AbsOperation",
    "Add": "AddOperation",
    "AddN": "AddNOperation",
    "Argmax": "ArgmaxOperation",
    "AtLeast2D": "AtLeast2DOperation",
    "And": "BitwiseAndOperation",
    "Or": "BitwiseOrOperation",
    "Cast": "CastOperation",
    "Concat": "ConcatenateOperation",
    "Constant": "ConstantOperation",
    "Decrypt": "DecryptOperation",
    "Div": "DivOperation",
    "Dot": "DotOperation",
    "Equal": "EqualOperation",
    "ExpandDims": "ExpandDimsOperation",
    "Exp": "ExpOperation",
    "Greater": "GreaterOperation",
    "Identity": "IdentityOperation",
    "IndexAxis": "IndexAxisOperation",
    "Input": "InputOperation",
    "Inverse": "InverseOperation",
    "Less": "LessOperation",
    "Load": "LoadOperation",
    "Log": "LogOperation",
    "Log2": "Log2Operation",
    "Maximum": "MaximumOperation",
    "Mean": "MeanOperation",
    "Mul": "MulOperation",
    "Mux": "MuxOperation",
    "Ones": "OnesOperation",
    "Zeros": "ZerosOperation",
    "Output": "OutputOperation",
    "Sigmoid": "SigmoidOperation",
    "Relu": "ReluOperation",
    "Select": "SelectOperation",
    "Softmax": "SoftmaxOperation",
    "Reshape": "ReshapeOperation",
    "Save": "SaveOperation",
    "Shape": "ShapeOperation",
    "Squeeze": "SqueezeOperation",
    "Sqrt": "SqrtOperation",
    "Sub": "SubOperation",
    "Sum": "SumOperation",
    "Transpose": "TransposeOperation",
}
_TAG_TO_KIND = {v: k for k, v in _KIND_TO_TAG.items()}
_TAG_TO_KIND["SliceOperation"] = "Slice"
_TAG_TO_KIND["StridedSliceOperation"] = "Slice"

# Attribute fields carried flat on the reference op dataclasses, per kind.
_ATTR_FIELDS = {
    "Argmax": ("axis", "upmost_index"),
    "AtLeast2D": ("to_column_vector",),
    "Concat": ("axis",),
    "Constant": ("value",),
    "ExpandDims": ("axis",),
    "IndexAxis": ("axis", "index"),
    "Mean": ("axis",),
    "Output": ("tag",),
    "Select": ("axis",),
    "Softmax": ("axis", "upmost_index"),
    "Squeeze": ("axis",),
    "Sum": ("axis",),
}

# Input-dict key conventions of the reference tracer.
_BINARY = ("lhs", "rhs")
_INPUT_KEYS = {
    "Load": ("key", "query"),
    "Save": ("key", "value"),
    "Decrypt": ("key", "ciphertext"),
    "Mux": ("selector", "x", "y"),
    "Select": ("x", "index"),
    "Reshape": ("x", "shape"),
    "Ones": ("shape",),
    "Zeros": ("shape",),
    "Output": ("value",),
}
_NARY_KINDS = frozenset({"AddN", "Maximum", "Concat"})


def _input_keys(kind: str, n: int):
    keys = _INPUT_KEYS.get(kind)
    if keys is not None:
        return keys[:n]
    if kind in _NARY_KINDS:
        return tuple(f"array{i}" for i in range(n))
    if n == 2:
        return _BINARY
    if n == 1:
        return ("x",)
    return tuple(f"array{i}" for i in range(n))


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _encode_dtype(dtype: dt.DType) -> dict:
    if dtype.is_fixedpoint:
        return {
            "__type__": "DType",
            "name": "fixed",
            "integral_precision": dtype.integral_precision,
            "fractional_precision": dtype.fractional_precision,
        }
    return {"__type__": "DType", "name": dtype.name}


def _encode_ty(ty: Ty) -> dict:
    if ty.name == "Tensor":
        return {"__type__": "TensorType", "dtype": _encode_dtype(ty.dtype)}
    if ty.name == "AesTensor":
        return {"__type__": "AesTensorType", "dtype": _encode_dtype(ty.dtype)}
    simple = {
        "Unit": "UnitType",
        "Unknown": "UnknownType",
        "HostString": "StringType",
        "HostShape": "ShapeType",
        "HostBytes": "BytesType",
        "HostInt": "IntType",
        "HostFloat": "FloatType",
        "AesKey": "AesKeyType",
    }
    if ty.name in simple:
        return {"__type__": simple[ty.name]}
    # moose_tpu extension for host-level concrete types
    out = {"__type__": "RawType", "name": ty.name}
    if ty.dtype is not None:
        out["dtype"] = _encode_dtype(ty.dtype)
    return out


def _encode_ndarray(arr: np.ndarray) -> dict:
    if arr.dtype == object:
        # arbitrary-precision ring constants (Python ints beyond int64,
        # e.g. 2^127 bit-compose weights) — msgpack cannot carry them raw
        return {
            "__type__": "ndarray",
            "dtype": "object_int",
            "items": [str(int(v)) for v in arr.flatten().tolist()],
            "shape": list(arr.shape),
        }
    return {
        "__type__": "ndarray",
        "dtype": str(arr.dtype),
        "items": arr.flatten().tolist(),
        "shape": list(arr.shape),
    }


def _encode_constant(value: Any) -> Any:
    if isinstance(value, str):
        return {"__type__": "StringConstant", "value": value}
    if isinstance(value, bytes):
        return {"__type__": "BytesConstant", "value": value}
    if isinstance(value, bool):
        return {"__type__": "IntConstant", "value": int(value)}
    if isinstance(value, (int, np.integer)):
        v = int(value)
        if not (-(1 << 63) <= v < (1 << 64)):
            return {"__type__": "BigIntConstant", "value": str(v)}
        return {"__type__": "IntConstant", "value": v}
    if isinstance(value, (float, np.floating)):
        return {"__type__": "FloatConstant", "value": float(value)}
    if isinstance(value, (tuple, list)) and all(
        isinstance(v, (int, np.integer))
        and -(1 << 63) <= int(v) < (1 << 64)
        for v in value
    ):
        return {"__type__": "ShapeConstant", "value": [int(v) for v in value]}
    arr = np.asarray(value)
    return {"__type__": "TensorConstant", "value": _encode_ndarray(arr)}


def _encode_attr(value: Any) -> Any:
    """Encode a non-Constant attribute value."""
    if isinstance(value, dt.DType):
        return _encode_dtype(value)
    if isinstance(value, np.ndarray):
        return _encode_ndarray(value)
    if isinstance(value, slice):
        return {
            "__type__": "PySlice",
            "start": value.start,
            "step": value.step,
            "stop": value.stop,
        }
    if isinstance(value, tuple):
        return [_encode_attr(v) for v in value]
    if isinstance(value, list):
        return [_encode_attr(v) for v in value]
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, int) and not (-(1 << 63) <= value < (1 << 64)):
        return {"__type__": "BigIntConstant", "value": str(value)}
    if isinstance(value, (np.floating,)):
        return float(value)
    return value


def _encode_operation(op: Operation) -> dict:
    tag = _KIND_TO_TAG.get(op.kind)
    keys = _input_keys(op.kind, len(op.inputs))
    inputs = dict(zip(keys, op.inputs))
    input_types = dict(
        zip(keys, (_encode_ty(t) for t in op.signature.input_types))
    )
    sig = {
        "__type__": "OpSignature",
        "input_types": input_types,
        "return_type": _encode_ty(op.signature.return_type),
    }
    if op.signature.variadic:
        sig["variadic"] = True
    base = {
        "name": op.name,
        "inputs": inputs,
        "placement_name": op.placement_name,
        "signature": sig,
    }
    if op.kind == "Slice" and tag is None:
        # reference distinguishes Slice (begin/end) from StridedSlice
        if "slices" in op.attributes or "slice_spec" in op.attributes:
            spec = op.attributes.get("slices", op.attributes.get("slice_spec"))
            return {
                "__type__": "StridedSliceOperation",
                **base,
                "slices": _encode_attr(spec),
            }
        return {
            "__type__": "SliceOperation",
            **base,
            "begin": _encode_attr(op.attributes.get("begin")),
            "end": _encode_attr(op.attributes.get("end")),
        }
    extra_attrs = dict(op.attributes)
    if tag is not None:
        out = {"__type__": tag, **base}
        for field in _ATTR_FIELDS.get(op.kind, ()):
            v = extra_attrs.pop(field, None)
            out[field] = (
                _encode_constant(v) if field == "value" else _encode_attr(v)
            )
        if op.kind == "Cast" and "dtype" in extra_attrs:
            # our Cast carries the target dtype as an attribute; the
            # reference recovers it from the signature — keep both
            extra_attrs.pop("dtype")
        if op.kind == "Input":
            extra_attrs.pop("arg_name", None)
        if extra_attrs:
            out["attributes"] = {
                k: _encode_attr(v) for k, v in extra_attrs.items()
            }
        return out
    # moose_tpu extension: host-level / protocol ops
    enc_attrs = {}
    for k, v in extra_attrs.items():
        enc_attrs[k] = (
            _encode_constant(v) if k == "value" else _encode_attr(v)
        )
    return {
        "__type__": "RawOperation",
        **base,
        "kind": op.kind,
        "attributes": enc_attrs,
    }


def _encode_placement(plc) -> dict:
    if isinstance(plc, HostPlacement):
        return {"__type__": "HostPlacement", "name": plc.name}
    if isinstance(plc, ReplicatedPlacement):
        return {
            "__type__": "ReplicatedPlacement",
            "name": plc.name,
            "player_names": list(plc.owners),
        }
    if isinstance(plc, Mirrored3Placement):
        return {
            "__type__": "MirroredPlacement",
            "name": plc.name,
            "player_names": list(plc.owners),
        }
    if isinstance(plc, AdditivePlacement):
        return {
            "__type__": "AdditivePlacement",
            "name": plc.name,
            "player_names": list(plc.owners),
        }
    raise MalformedComputationError(f"unknown placement {plc!r}")


def serialize_computation(comp: Computation) -> bytes:
    payload = {
        "__type__": "Computation",
        "operations": {
            name: _encode_operation(op)
            for name, op in comp.operations.items()
        },
        "placements": {
            name: _encode_placement(plc)
            for name, plc in comp.placements.items()
        },
    }
    return msgpack.packb(payload, use_bin_type=True)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

_SIMPLE_TYPE_TAGS = {
    "UnitType": Ty("Unit"),
    "UnknownType": Ty("Unknown"),
    "StringType": Ty("HostString"),
    "ShapeType": Ty("HostShape"),
    "BytesType": Ty("HostBytes"),
    "IntType": Ty("HostInt"),
    "FloatType": Ty("HostFloat"),
    "AesKeyType": Ty("AesKey"),
}

_DTYPE_BY_NAME = {
    d.name: d
    for d in (
        dt.int32, dt.int64, dt.uint32, dt.uint64,
        dt.float32, dt.float64, dt.bool_,
    )
}


def _decode_dtype(obj: dict) -> dt.DType:
    name = obj["name"]
    if name == "fixed" or name.startswith("fixed"):
        i = obj.get("integral_precision")
        f = obj.get("fractional_precision")
        if i is None:
            import re

            m = re.match(r"fixed([0-9]+)_([0-9]+)", name)
            i, f = int(m.group(1)), int(m.group(2))
        return dt.fixed(i, f)
    return _DTYPE_BY_NAME[name]


def _decode_ty(obj) -> Ty:
    if not isinstance(obj, dict):
        raise MalformedComputationError(f"bad type object {obj!r}")
    tag = obj["__type__"]
    if tag == "TensorType":
        return Ty("Tensor", obj["dtype"])
    if tag == "AesTensorType":
        return Ty("AesTensor", obj["dtype"])
    if tag == "RawType":
        return Ty(obj["name"], obj.get("dtype"))
    ty = _SIMPLE_TYPE_TAGS.get(tag)
    if ty is None:
        raise MalformedComputationError(f"unknown type tag {tag!r}")
    return ty


def _decode_hook(obj: dict):
    tag = obj.get("__type__")
    if tag is None:
        return obj
    if tag == "DType":
        return _decode_dtype(obj)
    if tag == "ndarray_raw":
        # zero-copy view over the msgpack buffer — READ-ONLY.  Every
        # Host* consumer immediately wraps it in jnp.asarray (device
        # arrays are immutable by design, so no writability is lost);
        # the one user-facing numpy path (RawNdarray) re-normalizes to
        # a writable copy in deserialize_value.
        return np.frombuffer(obj["data"], dtype=obj["dtype"]).reshape(
            obj["shape"]
        )
    if tag == "ndarray":
        if obj["dtype"] == "object_int":
            arr = np.empty(len(obj["items"]), dtype=object)
            arr[:] = [int(v) for v in obj["items"]]
            return arr.reshape(obj["shape"])
        return np.array(obj["items"], dtype=obj["dtype"]).reshape(
            obj["shape"]
        )
    if tag == "BigIntConstant":
        return int(obj["value"])
    if tag == "PySlice":
        return slice(obj["start"], obj["stop"], obj["step"])
    if tag in (
        "ShapeConstant", "StringConstant", "BytesConstant",
        "IntConstant", "FloatConstant", "TensorConstant",
    ):
        v = obj["value"]
        return tuple(v) if tag == "ShapeConstant" else v
    return obj  # types / ops / placements resolved in a second pass


def _decode_placement(obj: dict):
    tag = obj["__type__"]
    if tag == "HostPlacement":
        return HostPlacement(obj["name"])
    if tag == "ReplicatedPlacement":
        return ReplicatedPlacement(obj["name"], tuple(obj["player_names"]))
    if tag == "MirroredPlacement":
        return Mirrored3Placement(obj["name"], tuple(obj["player_names"]))
    if tag == "AdditivePlacement":
        return AdditivePlacement(obj["name"], tuple(obj["player_names"]))
    raise MalformedComputationError(f"unknown placement tag {tag!r}")


def _decode_operation(obj: dict) -> Operation:
    tag = obj["__type__"]
    if tag == "RawOperation":
        kind = obj["kind"]
    else:
        kind = _TAG_TO_KIND.get(tag)
        if kind is None:
            raise MalformedComputationError(f"unknown op tag {tag!r}")
    keys = list(obj["inputs"].keys())
    # preserve the reference tracer's positional conventions
    order = _input_keys(kind, len(keys))
    if set(order) == set(keys):
        inputs = [obj["inputs"][k] for k in order]
        type_order = order
    else:
        inputs = [obj["inputs"][k] for k in keys]
        type_order = keys
    sig_obj = obj["signature"]
    input_types = tuple(
        _decode_ty(sig_obj["input_types"][k])
        for k in type_order
        if k in sig_obj["input_types"]
    )
    return_type = _decode_ty(sig_obj["return_type"])

    attributes = dict(obj.get("attributes") or {})
    if tag == "SliceOperation":
        attributes["begin"] = obj.get("begin")
        attributes["end"] = obj.get("end")
    elif tag == "StridedSliceOperation":
        attributes["slices"] = tuple(obj["slices"] or ())
        # canonical attribute key across eDSL + symbolic lowering
    else:
        for field in _ATTR_FIELDS.get(kind, ()):
            if field in obj:
                v = obj[field]
                if isinstance(v, list):
                    v = tuple(v)
                attributes[field] = v
    if kind == "Cast" and "dtype" not in attributes:
        if return_type.dtype is not None:
            attributes["dtype"] = return_type.dtype
    if kind == "Input" and "arg_name" not in attributes:
        attributes["arg_name"] = obj["name"]

    return Operation(
        name=obj["name"],
        kind=kind,
        inputs=inputs,
        placement_name=obj["placement_name"],
        signature=Signature(input_types, return_type,
                            variadic=bool(sig_obj.get("variadic", False))),
        attributes=attributes,
    )


def deserialize_computation(data: bytes) -> Computation:
    payload = msgpack.unpackb(
        data, object_hook=_decode_hook, raw=False, strict_map_key=False
    )
    if not isinstance(payload, dict) or payload.get("__type__") != "Computation":
        raise MalformedComputationError(
            "payload is not a serialized Computation"
        )
    comp = Computation()
    for plc_obj in payload["placements"].values():
        comp.add_placement(_decode_placement(plc_obj))
    for op_obj in payload["operations"].values():
        comp.add_operation(_decode_operation(op_obj))
    return comp


def load_computation(path) -> Computation:
    """Read a computation from ``path`` in either on-disk format: the
    line-per-op textual form (``.moose``/``.txt`` extension, or a file
    starting with an ASCII letter) or msgpack.  The shared loader of the
    CLI tool family (elk, dasher, prancer)."""
    import pathlib

    from .textual import parse_computation

    path = str(path)
    data = pathlib.Path(path).read_bytes()
    if path.endswith((".moose", ".txt")) or data[:1].isalpha():
        return parse_computation(data.decode())
    return deserialize_computation(data)
