"""Minimal self-contained ONNX ModelProto reader/writer.

The environment has no ``onnx`` package, so this module implements the
small protobuf subset the predictor importers need (reference importers:
``pymoose/pymoose/predictors/onnx_convert.py:8-92`` and friends operate on
``onnx.ModelProto`` objects).  The classes here expose the same attribute
surface (``model.graph.node[i].attribute``, ``tensor.float_data``,
``input.type.tensor_type.shape.dim[j].dim_value`` …), so predictor code is
source-compatible with both a real ``onnx`` proto and this shim, and
``load_model`` accepts either.

The wire format implemented is plain protobuf (varint / 64-bit /
length-delimited / 32-bit fields; packed repeated scalars), and the field
numbers follow the public onnx.proto3 schema.  Both directions are
implemented: decode (for importing user models) and encode (so tests can
fabricate ONNX fixtures from freshly-trained sklearn models without
skl2onnx).

The port's own copy of ``moose_tpu/predictors/onnx_proto.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Wire-level codec
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # protobuf int64 negative encoding
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _WIRE_64BIT:
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            size, pos = _read_varint(buf, pos)
            value = buf[pos : pos + size]
            pos += size
        elif wire == _WIRE_32BIT:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _to_signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


# ---------------------------------------------------------------------------
# Schema-driven messages
# ---------------------------------------------------------------------------
#
# Each message class declares FIELDS: {field_number: (attr, kind)} where
# kind is one of:
#   "int"      varint scalar (int64/enum, sign-aware)
#   "int+"     repeated varint (accepts packed or one-per-field)
#   "float"    32-bit float scalar
#   "float+"   repeated float (packed or unpacked)
#   "double+"  repeated double
#   "bytes"    length-delimited bytes scalar
#   "bytes+"   repeated bytes
#   "str"      length-delimited utf-8 string scalar
#   ("msg", C)   nested message scalar of class C
#   ("msg+", C)  repeated nested message of class C


class _Message:
    FIELDS: dict[int, tuple] = {}

    def __init__(self, **kwargs):
        for attr, kind in self.FIELDS.values():
            if _is_repeated(kind):
                setattr(self, attr, [])
            else:
                setattr(self, attr, _scalar_default(kind))
        for key, val in kwargs.items():
            setattr(self, key, val)

    # -- decode ------------------------------------------------------------

    @classmethod
    def decode(cls, buf: bytes):
        msg = cls()
        for field, wire, value in _iter_fields(buf):
            spec = cls.FIELDS.get(field)
            if spec is None:
                continue  # unknown field: skip (forward compat)
            attr, kind = spec
            if kind == "int":
                setattr(msg, attr, _to_signed64(value))
            elif kind == "int+":
                if wire == _WIRE_LEN:  # packed
                    pos = 0
                    items = getattr(msg, attr)
                    while pos < len(value):
                        v, pos = _read_varint(value, pos)
                        items.append(_to_signed64(v))
                else:
                    getattr(msg, attr).append(_to_signed64(value))
            elif kind == "float":
                setattr(msg, attr, struct.unpack("<f", value)[0])
            elif kind == "float+":
                if wire == _WIRE_LEN:
                    getattr(msg, attr).extend(
                        struct.unpack(f"<{len(value) // 4}f", value)
                    )
                else:
                    getattr(msg, attr).append(struct.unpack("<f", value)[0])
            elif kind == "double+":
                if wire == _WIRE_LEN:
                    getattr(msg, attr).extend(
                        struct.unpack(f"<{len(value) // 8}d", value)
                    )
                else:
                    getattr(msg, attr).append(struct.unpack("<d", value)[0])
            elif kind == "bytes":
                setattr(msg, attr, bytes(value))
            elif kind == "bytes+":
                getattr(msg, attr).append(bytes(value))
            elif kind == "str":
                setattr(msg, attr, value.decode("utf-8"))
            elif kind[0] == "msg":
                setattr(msg, attr, kind[1].decode(value))
            elif kind[0] == "msg+":
                getattr(msg, attr).append(kind[1].decode(value))
            else:  # pragma: no cover
                raise ValueError(f"unknown field kind {kind!r}")
        return msg

    # -- encode ------------------------------------------------------------

    def encode(self) -> bytes:
        out = bytearray()
        for field, (attr, kind) in sorted(self.FIELDS.items()):
            value = getattr(self, attr)
            if kind == "int":
                if value:
                    _write_varint(out, field << 3 | _WIRE_VARINT)
                    _write_varint(out, value)
            elif kind == "int+":
                if value:  # packed
                    payload = bytearray()
                    for v in value:
                        _write_varint(payload, int(v))
                    _write_len(out, field, bytes(payload))
            elif kind == "float":
                if value:
                    _write_varint(out, field << 3 | _WIRE_32BIT)
                    out += struct.pack("<f", value)
            elif kind == "float+":
                if value:
                    _write_len(
                        out, field, struct.pack(f"<{len(value)}f", *value)
                    )
            elif kind == "double+":
                if value:
                    _write_len(
                        out, field, struct.pack(f"<{len(value)}d", *value)
                    )
            elif kind == "bytes":
                if value:
                    _write_len(out, field, bytes(value))
            elif kind == "bytes+":
                for v in value:
                    _write_len(out, field, bytes(v))
            elif kind == "str":
                if value:
                    _write_len(out, field, value.encode("utf-8"))
            elif kind[0] == "msg":
                if value is not None:
                    _write_len(out, field, value.encode())
            elif kind[0] == "msg+":
                for v in value:
                    _write_len(out, field, v.encode())
        return bytes(out)

    def __repr__(self):
        attrs = ", ".join(
            f"{attr}={getattr(self, attr)!r}"
            for attr, _ in self.FIELDS.values()
            if getattr(self, attr)
        )
        return f"{type(self).__name__}({attrs})"


def _is_repeated(kind) -> bool:
    return (isinstance(kind, str) and kind.endswith("+")) or (
        not isinstance(kind, str) and kind[0].endswith("+")
    )


def _scalar_default(kind):
    if kind == "int":
        return 0
    if kind == "float":
        return 0.0
    if kind == "bytes":
        return b""
    if kind == "str":
        return ""
    return None  # nested message


def _write_len(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, field << 3 | _WIRE_LEN)
    _write_varint(out, len(payload))
    out += payload


# ---------------------------------------------------------------------------
# ONNX messages (field numbers: public onnx.proto3)
# ---------------------------------------------------------------------------


class TensorShapeDim(_Message):
    FIELDS = {1: ("dim_value", "int"), 2: ("dim_param", "str")}


class TensorShapeProto(_Message):
    FIELDS = {1: ("dim", ("msg+", TensorShapeDim))}


class TensorTypeProto(_Message):
    FIELDS = {
        1: ("elem_type", "int"),
        2: ("shape", ("msg", TensorShapeProto)),
    }


class TypeProto(_Message):
    FIELDS = {1: ("tensor_type", ("msg", TensorTypeProto))}


class ValueInfoProto(_Message):
    FIELDS = {1: ("name", "str"), 2: ("type", ("msg", TypeProto))}


class TensorProto(_Message):
    # DataType enum values (subset): FLOAT=1, INT32=6, INT64=7, DOUBLE=11
    FLOAT, INT32, INT64, DOUBLE = 1, 6, 7, 11

    FIELDS = {
        1: ("dims", "int+"),
        2: ("data_type", "int"),
        4: ("float_data", "float+"),
        5: ("int32_data", "int+"),
        7: ("int64_data", "int+"),
        8: ("name", "str"),
        9: ("raw_data", "bytes"),
        10: ("double_data", "double+"),
    }


class AttributeProto(_Message):
    # AttributeType enum
    UNDEFINED, FLOAT, INT, STRING, TENSOR = 0, 1, 2, 3, 4
    FLOATS, INTS, STRINGS = 6, 7, 8

    FIELDS = {
        1: ("name", "str"),
        2: ("f", "float"),
        3: ("i", "int"),
        4: ("s", "bytes"),
        5: ("t", ("msg", TensorProto)),
        7: ("floats", "float+"),
        8: ("ints", "int+"),
        9: ("strings", "bytes+"),
        20: ("type", "int"),
    }


class NodeProto(_Message):
    FIELDS = {
        1: ("input", "bytes+"),
        2: ("output", "bytes+"),
        3: ("name", "str"),
        4: ("op_type", "str"),
        5: ("attribute", ("msg+", AttributeProto)),
        7: ("domain", "str"),
    }

    @classmethod
    def decode(cls, buf):
        msg = super().decode(buf)
        msg.input = [b.decode("utf-8") for b in msg.input]
        msg.output = [b.decode("utf-8") for b in msg.output]
        return msg

    def encode(self):
        orig_in, orig_out = self.input, self.output
        self.input = [
            s.encode("utf-8") if isinstance(s, str) else s for s in orig_in
        ]
        self.output = [
            s.encode("utf-8") if isinstance(s, str) else s for s in orig_out
        ]
        try:
            return super().encode()
        finally:
            self.input, self.output = orig_in, orig_out


class GraphProto(_Message):
    FIELDS = {
        1: ("node", ("msg+", NodeProto)),
        2: ("name", "str"),
        5: ("initializer", ("msg+", TensorProto)),
        11: ("input", ("msg+", ValueInfoProto)),
        12: ("output", ("msg+", ValueInfoProto)),
    }


class OperatorSetIdProto(_Message):
    FIELDS = {1: ("domain", "str"), 2: ("version", "int")}


class ModelProto(_Message):
    FIELDS = {
        1: ("ir_version", "int"),
        2: ("producer_name", "str"),
        3: ("producer_version", "str"),
        4: ("domain", "str"),
        5: ("model_version", "int"),
        7: ("graph", ("msg", GraphProto)),
        8: ("opset_import", ("msg+", OperatorSetIdProto)),
    }


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def load_model(source: Any) -> Any:
    """Normalize an ONNX model source to a ModelProto-like object.

    Accepts: this module's ModelProto, a real ``onnx.ModelProto`` (passed
    through untouched — the attribute surface matches), raw serialized
    bytes, a filesystem path, or an open binary file object.
    """
    if isinstance(source, ModelProto):
        return source
    if hasattr(source, "graph") and hasattr(source, "producer_name"):
        return source  # a real onnx.ModelProto (or compatible)
    if hasattr(source, "read"):
        source = source.read()
    if isinstance(source, str):
        with open(source, "rb") as f:
            source = f.read()
    if isinstance(source, (bytes, bytearray)):
        return ModelProto.decode(bytes(source))
    raise TypeError(f"cannot load ONNX model from {type(source).__name__}")


def tensor_to_numpy(tensor) -> "np.ndarray":
    """Materialize a TensorProto's payload (works on shim and real onnx)."""
    import numpy as np

    dims = list(tensor.dims) or None
    if tensor.raw_data:
        dtype = {
            TensorProto.FLOAT: "<f4",
            TensorProto.INT32: "<i4",
            TensorProto.INT64: "<i8",
            TensorProto.DOUBLE: "<f8",
        }.get(tensor.data_type)
        if dtype is None:
            raise ValueError(
                f"unsupported tensor data_type {tensor.data_type}"
            )
        arr = np.frombuffer(bytes(tensor.raw_data), dtype=dtype)
    elif len(tensor.float_data):
        arr = np.asarray(list(tensor.float_data), dtype=np.float32)
    elif len(tensor.double_data):
        arr = np.asarray(list(tensor.double_data), dtype=np.float64)
    elif len(tensor.int64_data):
        arr = np.asarray(list(tensor.int64_data), dtype=np.int64)
    elif len(tensor.int32_data):
        arr = np.asarray(list(tensor.int32_data), dtype=np.int32)
    else:
        arr = np.zeros(0, dtype=np.float32)
    if dims is not None:
        arr = arr.reshape(dims)
    return arr


# ---------------------------------------------------------------------------
# Builders (used by tests to fabricate fixtures without skl2onnx)
# ---------------------------------------------------------------------------


def make_attribute(name: str, value) -> AttributeProto:
    attr = AttributeProto(name=name)
    if isinstance(value, bytes):
        attr.type, attr.s = AttributeProto.STRING, value
    elif isinstance(value, str):
        attr.type, attr.s = AttributeProto.STRING, value.encode()
    elif isinstance(value, float):
        attr.type, attr.f = AttributeProto.FLOAT, value
    elif isinstance(value, int):
        attr.type, attr.i = AttributeProto.INT, value
    elif isinstance(value, TensorProto):
        attr.type, attr.t = AttributeProto.TENSOR, value
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (bytes, str)) for v in value):
            attr.type = AttributeProto.STRINGS
            attr.strings = [
                v.encode() if isinstance(v, str) else v for v in value
            ]
        elif all(isinstance(v, int) for v in value):
            attr.type, attr.ints = AttributeProto.INTS, list(value)
        else:
            attr.type = AttributeProto.FLOATS
            attr.floats = [float(v) for v in value]
    else:
        raise TypeError(f"cannot infer attribute type for {value!r}")
    return attr


def make_node(op_type: str, inputs, outputs, name="", **attributes) -> NodeProto:
    node = NodeProto(
        op_type=op_type, name=name, input=list(inputs), output=list(outputs)
    )
    node.attribute = [make_attribute(k, v) for k, v in attributes.items()]
    return node


def make_tensor_value_info(name: str, elem_type: int, shape) -> ValueInfoProto:
    dims = []
    for d in shape:
        if d is None:
            dims.append(TensorShapeDim(dim_param="batch"))
        elif isinstance(d, str):
            dims.append(TensorShapeDim(dim_param=d))
        else:
            dims.append(TensorShapeDim(dim_value=int(d)))
    return ValueInfoProto(
        name=name,
        type=TypeProto(
            tensor_type=TensorTypeProto(
                elem_type=elem_type, shape=TensorShapeProto(dim=dims)
            )
        ),
    )


def make_initializer(name: str, array) -> TensorProto:
    import numpy as np

    arr = np.asarray(array, dtype=np.float32)
    return TensorProto(
        name=name,
        dims=list(arr.shape),
        data_type=TensorProto.FLOAT,
        float_data=[float(v) for v in arr.ravel()],
    )


def make_model(graph: GraphProto, producer_name: str = "") -> ModelProto:
    return ModelProto(
        ir_version=8,
        producer_name=producer_name,
        graph=graph,
        opset_import=[OperatorSetIdProto(domain="ai.onnx.ml", version=3)],
    )
