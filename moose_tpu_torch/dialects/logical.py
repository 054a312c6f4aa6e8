"""Logical dialect: host and mirrored dispatch of the port's IR ops.

The part of ``moose_tpu/dialects/logical.py`` the stacked layout
delegates to (``to_host``, ``_execute_host``, ``_execute_mir``,
``_constant_on_host`` and ``decode_slice_spec``), limited to the host and
mirrored op kinds of the port's graphs.  Any other kind raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import numpy as np

from .. import dtypes as dt
from ..computation import HostPlacement, Mirrored3Placement
from ..values import (
    AesTensor,
    HostAesKey,
    HostBitTensor,
    HostFixedTensor,
    HostRingTensor,
    HostShape,
    HostString,
    HostTensor,
    HostUnit,
    Mir3FixedTensor,
    Mir3Tensor,
)
from . import mirrored as mir_ops

# op kinds each placement family executes; Load and Save are resolved by
# the interpreter's walk at the host boundary, as Input and Output are
HOST_KINDS = frozenset({
    "Cast", "Shape", "Slice", "Ones", "ExpandDims", "Identity", "Constant",
    "Load", "Save",
})
MIR_KINDS = frozenset({"Constant", "Cast"})

# what the host and mirrored placements do not run yet: secret integers
# and host bit values (the rest of item 6) and the per-host layout's other
# kinds (item 8)
_LATER = "ROADMAP queue 1, items 6 and 8"


def _width_of_dtype(dtype: dt.DType) -> int:
    return 64 if dtype.name == "fixed64" else 128


def to_host(sess, plc_name: str, v):
    """Materialize a host or mirrored value on ``plc_name``: a relabel,
    or the owner's copy of a mirrored value."""
    if isinstance(v, (HostTensor, HostBitTensor, HostRingTensor,
                      HostShape, HostString, HostUnit, AesTensor,
                      HostAesKey)):
        return sess.place(plc_name, v)
    if isinstance(v, HostFixedTensor):
        return HostFixedTensor(
            sess.place(plc_name, v.tensor),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, Mir3FixedTensor):
        return HostFixedTensor(
            mir_ops.demirror(sess, _mirrored_placement(v.tensor),
                             v.tensor, plc_name),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, Mir3Tensor):
        return mir_ops.demirror(sess, _mirrored_placement(v), v, plc_name)
    raise NotImplementedError(
        f"placing {type(v).__name__} on host {plc_name} ({_LATER})"
    )


def _mirrored_placement(v: Mir3Tensor) -> Mirrored3Placement:
    """The placement a mirrored value lives on, from its three copies'
    owners (the port binds no placement table to its sessions)."""
    return Mirrored3Placement(v.plc, tuple(t.plc for t in v.values))


def _mirrored_to_public_ring(v):
    """The 3 per-party host ring tensors of a mirrored fixed value."""
    if isinstance(v, Mir3FixedTensor):
        return v.tensor.values, v.fractional_precision
    raise TypeError(type(v).__name__)


def _execute_host(sess, comp, op, plc: HostPlacement, args):
    kind = op.kind
    h = plc.name
    ret_dtype = op.signature.return_type.dtype

    if kind == "Constant":
        return _constant_on_host(sess, h, op)
    if kind == "Identity":
        return to_host(sess, h, args[0])
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


def _constant_on_host(sess, h, op):
    """A Constant op's value as a host value on ``h``: a string (a Load
    or Save key), a shape, a fixed-point tensor (encoded from float64), a
    static scalar or a tensor of the op's dtype."""
    value = op.attributes["value"]
    ret = op.signature.return_type
    if isinstance(value, str):
        return HostString(value, h)
    if ret.name == "HostShape":
        return HostShape(tuple(int(d) for d in np.asarray(value)), h)
    dtype = ret.dtype
    if dtype is not None and dtype.is_fixedpoint:
        t = sess.constant(h, np.asarray(value, dtype=np.float64), dt.float64)
        return sess.fixedpoint_encode(
            h, t, dtype.integral_precision, dtype.fractional_precision,
            _width_of_dtype(dtype),
        )
    if isinstance(value, (int, float)):
        return value  # static scalar (IntType/FloatType)
    return sess.constant(h, np.asarray(value), dtype)


def decode_slice_spec(attributes) -> tuple:
    """The Python slice tuple of a Slice op's attributes; the ``"..."``
    marker becomes a real Ellipsis, expanded against the operand's
    rank."""
    if "slices" in attributes:
        return tuple(
            Ellipsis if s == "..." else slice(*s)
            for s in attributes["slices"]
        )
    return (slice(attributes["begin"], attributes["end"]),)


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
    if isinstance(v, HostRingTensor):
        # a revealed index (Argmax): its low words as uint64, then cast
        return sess.cast_ring_lo(h, v, target)
    return sess.cast(h, v, target)


def _host_slice(sess, op, h, args):
    x = to_host(sess, h, args[0])
    if not isinstance(x, HostShape) or "slices" in op.attributes:
        raise NotImplementedError(
            f"host Slice of {type(x).__name__} ({_LATER})"
        )
    return HostShape(x.value[decode_slice_spec(op.attributes)[0]], h)


def _execute_mir(sess, comp, op, plc: Mirrored3Placement, args):
    kind = op.kind
    ret_dtype = op.signature.return_type.dtype

    if kind == "Constant" and ret_dtype is not None:
        value = np.asarray(op.attributes["value"])
        if not ret_dtype.is_fixedpoint:
            return Mir3Tensor(
                tuple(sess.constant(owner, value, ret_dtype)
                      for owner in plc.owners),
                plc.name,
            )
        floats = Mir3Tensor(
            tuple(sess.constant(owner, value.astype(np.float64),
                                dt.float64)
                  for owner in plc.owners),
            plc.name,
        )
        return Mir3FixedTensor(
            mir_ops.ring_fixedpoint_encode(
                sess, plc, floats, ret_dtype.fractional_precision,
                _width_of_dtype(ret_dtype),
            ),
            ret_dtype.integral_precision,
            ret_dtype.fractional_precision,
        )

    if kind == "Cast":
        v = args[0]
        if isinstance(v, Mir3Tensor) and ret_dtype.is_fixedpoint:
            return Mir3FixedTensor(
                mir_ops.ring_fixedpoint_encode(
                    sess, plc, v, ret_dtype.fractional_precision,
                    _width_of_dtype(ret_dtype),
                ),
                ret_dtype.integral_precision,
                ret_dtype.fractional_precision,
            )
        if isinstance(v, Mir3FixedTensor) and not ret_dtype.is_fixedpoint:
            return mir_ops.ring_fixedpoint_decode(
                sess, plc, v.tensor, v.fractional_precision, ret_dtype
            )
        raise NotImplementedError(
            f"mirrored Cast of {type(v).__name__} to {ret_dtype} ({_LATER})"
        )

    raise NotImplementedError(f"mirrored op {kind} ({op.name}; {_LATER})")
