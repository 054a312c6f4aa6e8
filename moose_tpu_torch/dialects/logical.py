"""Logical dialect: host and mirrored dispatch of the slice's IR ops.

The part of ``moose_tpu/dialects/logical.py`` the stacked layout
delegates to — ``_execute_host`` and ``_execute_mir`` — limited to the op kinds of the slice's two graphs
(the eDSL secure dot and the ONNX linear regressor).  Any other kind
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import numpy as np

from .. import dtypes as dt
from ..computation import HostPlacement, Mirrored3Placement
from ..values import (
    HostFixedTensor,
    HostRingTensor,
    HostShape,
    HostTensor,
    Mir3FixedTensor,
    Mir3Tensor,
)

# op kinds each placement family executes in this slice (Input and
# Output are resolved by the interpreter's walk)
HOST_KINDS = frozenset({"Cast", "Shape", "Slice", "Ones", "ExpandDims"})
MIR_KINDS = frozenset({"Constant", "Cast"})

_LATER = "ROADMAP queue 1, items 6-8"


def _width_of_dtype(dtype: dt.DType) -> int:
    return 64 if dtype.name == "fixed64" else 128


def to_host(sess, plc_name: str, v):
    """Materialize a host value on ``plc_name`` (a relabel)."""
    if isinstance(v, (HostTensor, HostRingTensor, HostShape)):
        return sess.place(plc_name, v)
    if isinstance(v, HostFixedTensor):
        return HostFixedTensor(
            sess.place(plc_name, v.tensor),
            v.integral_precision,
            v.fractional_precision,
        )
    raise NotImplementedError(
        f"placing {type(v).__name__} on host {plc_name} ({_LATER})"
    )


def _mirrored_to_public_ring(v):
    """The 3 per-party host ring tensors of a mirrored fixed value."""
    if isinstance(v, Mir3FixedTensor):
        return v.tensor.values, v.fractional_precision
    raise TypeError(type(v).__name__)


def _execute_host(sess, comp, op, plc: HostPlacement, args):
    kind = op.kind
    h = plc.name
    ret_dtype = op.signature.return_type.dtype

    if kind == "Cast":
        return _cast_on_host(sess, h, args[0], ret_dtype)
    if kind == "Shape":
        x = to_host(sess, h, args[0])
        if isinstance(x, HostFixedTensor):
            x = x.tensor
        return sess.shape(h, x)
    if kind == "Ones":
        shp = to_host(sess, h, args[0])
        return sess.ones(h, shp, ret_dtype or dt.float64)
    if kind == "ExpandDims":
        x = to_host(sess, h, args[0])
        if not isinstance(x, HostTensor):
            raise NotImplementedError(
                f"host ExpandDims of {type(x).__name__} ({_LATER})"
            )
        for a in sorted(op.attributes["axis"]):
            x = sess.expand_dims(h, x, a)
        return x
    if kind == "Slice":
        return _host_slice(sess, op, h, args)
    raise NotImplementedError(f"host op {kind} ({op.name}; {_LATER})")


def _cast_on_host(sess, h, v, target: dt.DType):
    v = to_host(sess, h, v)
    if target.is_fixedpoint:
        if not isinstance(v, HostTensor):
            raise NotImplementedError(
                f"host Cast of {type(v).__name__} to {target} ({_LATER})"
            )
        return sess.fixedpoint_encode(
            h, v, target.integral_precision, target.fractional_precision,
            _width_of_dtype(target),
        )
    if isinstance(v, HostFixedTensor):
        return sess.fixedpoint_decode(h, v, target)
    return sess.cast(h, v, target)


def _host_slice(sess, op, h, args):
    x = to_host(sess, h, args[0])
    if not isinstance(x, HostShape) or "slices" in op.attributes:
        raise NotImplementedError(
            f"host Slice of {type(x).__name__} ({_LATER})"
        )
    begin, end = op.attributes["begin"], op.attributes["end"]
    return HostShape(x.value[slice(begin, end)], h)


def _execute_mir(sess, comp, op, plc: Mirrored3Placement, args):
    kind = op.kind
    ret_dtype = op.signature.return_type.dtype

    if kind == "Constant" and ret_dtype is not None \
            and not ret_dtype.is_fixedpoint:
        vals = tuple(
            sess.constant(owner, np.asarray(op.attributes["value"]),
                          ret_dtype)
            for owner in plc.owners
        )
        return Mir3Tensor(vals, plc.name)

    if kind == "Cast":
        v = args[0]
        if isinstance(v, Mir3Tensor) and ret_dtype.is_fixedpoint:
            width = _width_of_dtype(ret_dtype)
            vals = tuple(
                sess.ring_fixedpoint_encode(
                    t.plc, t, ret_dtype.fractional_precision, width
                )
                for t in v.values
            )
            return Mir3FixedTensor(
                Mir3Tensor(vals, plc.name),
                ret_dtype.integral_precision,
                ret_dtype.fractional_precision,
            )
        raise NotImplementedError(
            f"mirrored Cast of {type(v).__name__} to {ret_dtype} ({_LATER})"
        )

    raise NotImplementedError(f"mirrored op {kind} ({op.name}; {_LATER})")
