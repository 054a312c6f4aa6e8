"""Logical dialect: dtype- and placement-polymorphic dispatch of IR ops
in the per-host layout.

The port of ``moose_tpu/dialects/logical.py`` (the reference's
``moose/src/logical/ops.rs``): each logical operation pattern-matches on
(placement kind, runtime value kind) and forwards to the host,
fixedpoint, replicated and mirrored kernels.  Implicit conversions
mirror the reference's lowering: feeding a host value into a replicated
op shares it; placing a replicated value on a host op reveals it;
mirrored values demirror on hosts and act as public constants on
replicated placements.  The stacked layout (``stacked.py``) delegates
its host and mirrored ops here.

Deviation (the JAX package's, kept): plaintext *host* fixed-point math
(exp/log/sqrt/sigmoid/softmax, the pools, Div) decodes to float64, runs
the float kernel and re-encodes.  The secure replicated path uses the
ring protocols of ``fixedpoint.py``.

The dispatch is written against the session surface only, so it runs on
the eager session and, for lowering, on the symbolic one
(``execution/symbolic.py``) alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from ..computation import (
    Computation,
    HostPlacement,
    Mirrored3Placement,
    Operation,
    ReplicatedPlacement,
)
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
    RepFixedTensor,
    RepTensor,
)
from . import fixedpoint as fx
from . import mirrored as mir_ops
from . import replicated as rep_ops

# the kinds the host and mirrored placements execute: the reference's
# _execute_host and _execute_mir; the stacked layout runs its host and
# mirrored ops here
HOST_KINDS = frozenset({
    "Constant", "Identity", "Output", "Cast", "Shape", "Ones", "Zeros",
    "Inverse", "Add", "Sub", "Mul", "Div", "Dot", "Conv2D", "AvgPool2D",
    "MaxPool2D", "AddN", "Neg", "Less", "Greater", "Equal", "And", "Or",
    "Xor", "Mux", "Sum", "Mean", "Exp", "Log", "Log2", "Sqrt", "Sigmoid",
    "Relu", "Abs", "Softmax", "Argmax", "Maximum", "Concat", "Reshape",
    "ExpandDims", "Squeeze", "Transpose", "IndexAxis", "AtLeast2D",
    "Broadcast", "Slice", "Select", "Decrypt",
})
MIR_KINDS = frozenset({"Constant", "Cast"})


def _width_of_dtype(dtype: dt.DType) -> int:
    return 64 if dtype.name == "fixed64" else 128


# ---------------------------------------------------------------------------
# Implicit conversions
# ---------------------------------------------------------------------------


def to_host(sess, plc_name: str, v):
    """Materialize any logical value as a host value on ``plc_name``."""
    if isinstance(v, (HostTensor, HostBitTensor, HostRingTensor, HostShape,
                      HostString, HostUnit, AesTensor, HostAesKey)):
        return sess.place(plc_name, v)
    if isinstance(v, HostFixedTensor):
        return HostFixedTensor(
            sess.place(plc_name, v.tensor),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, RepFixedTensor):
        rep = _rep_placement_of(sess, v.tensor)
        ring = rep_ops.reveal(sess, rep, v.tensor, plc_name)
        return HostFixedTensor(
            ring, v.integral_precision, v.fractional_precision
        )
    if isinstance(v, RepTensor):
        return rep_ops.reveal(sess, _rep_placement_of(sess, v), v, plc_name)
    if isinstance(v, Mir3FixedTensor):
        return HostFixedTensor(
            mir_ops.demirror(sess, _mirrored_placement(v.tensor),
                             v.tensor, plc_name),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, Mir3Tensor):
        return mir_ops.demirror(sess, _mirrored_placement(v), v, plc_name)
    raise TypeError(f"cannot place {type(v).__name__} on host {plc_name}")


def to_rep(sess, rep: ReplicatedPlacement, v):
    """Materialize any logical tensor value as a replicated sharing."""
    if isinstance(v, (RepFixedTensor, RepTensor)):
        return v
    if isinstance(v, HostFixedTensor):
        return RepFixedTensor(
            rep_ops.share(sess, rep, v.tensor),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, (HostBitTensor, HostRingTensor)):
        return rep_ops.share(sess, rep, v)
    if isinstance(v, Mir3FixedTensor):
        h = to_host(sess, rep.owners[0], v)
        return to_rep(sess, rep, h)
    if isinstance(v, HostTensor):
        if v.dtype is not None and v.dtype.is_integer:
            # an integer host tensor lifts at scale 0 into ring64 (the
            # integer dialect's HostT is HostRing64Tensor,
            # integer/mod.rs:12-15), then shares
            ring64 = sess.ring_fixedpoint_encode(v.plc, v, 0, 64)
            return rep_ops.share(sess, rep, ring64)
        raise TypeError(
            "cannot share a plaintext float tensor; cast to a fixed dtype "
            "first (reference requires FixedpointEncode before Share)"
        )
    raise TypeError(f"cannot share {type(v).__name__}")


def bind_placements(sess, comp: Computation):
    """Give the session the computation's placement table, where the
    conversions find a replicated placement's owners."""
    sess._placements = comp.placements


def make_session(master_key, device, key_domain: int = 0):
    """Dialect hook of the interpreter: this layout executes against a
    plain EagerSession."""
    from ..execution.session import EagerSession

    return EagerSession(device, master_key=master_key, key_domain=key_domain)


def lift_aes_input(sess, comp, op, arr, plc_name: str, device):
    """Dialect hook: an AES boundary value as host bits, and a replicated
    AES key shared from its first owner into this layout's replicated
    bits, as the reference's walk shares it at its Input."""
    from . import aes

    return aes.lift_input(sess, comp, op, arr, plc_name, device)


def unsupported_ops(comp: Computation) -> list:
    """Nothing: this layout runs every kind the reference's per-host walk
    runs, the secret-shared checkpoints included (the interpreter's
    walk binds LoadShares and stages SaveShares).  A kind the reference
    lacks raises its own error when it is reached."""
    return []


def _rep_placement_of(sess, x: RepTensor) -> ReplicatedPlacement:
    """The replicated placement of a sharing: from the bound placement
    table, else from its shares' owners."""
    table = getattr(sess, "_placements", None)
    if table is not None and x.plc in table:
        plc = table[x.plc]
        if not isinstance(plc, ReplicatedPlacement):
            from ..errors import TypeMismatchError

            raise TypeMismatchError(
                f"placement {x.plc!r} is {type(plc).__name__}, expected "
                "Replicated"
            )
        return plc
    return ReplicatedPlacement(x.plc, tuple(s[0].plc for s in x.shares))


def _mirrored_placement(v: Mir3Tensor) -> Mirrored3Placement:
    """The placement a mirrored value lives on, from its three copies'
    owners (the stacked layout binds no placement table to its host
    session)."""
    return Mirrored3Placement(v.plc, tuple(t.plc for t in v.values))


# ---------------------------------------------------------------------------
# Host fixed-point helpers (plaintext ring arithmetic)
# ---------------------------------------------------------------------------


def _host_fixed_binop(sess, plc, x: HostFixedTensor, y: HostFixedTensor, op):
    if x.fractional_precision != y.fractional_precision:
        from ..errors import TypeMismatchError

        raise TypeMismatchError(
            "host fixed operands disagree on fractional precision: "
            f"{x.fractional_precision} vs {y.fractional_precision}"
        )
    f = x.fractional_precision
    i = max(x.integral_precision, y.integral_precision)
    a, b = x.tensor, y.tensor
    if op == "Add":
        z = sess.add(plc, a, b)
    elif op == "Sub":
        z = sess.sub(plc, a, b)
    elif op == "Mul":
        z = sess.shr_arith(plc, sess.mul(plc, a, b), f)
    elif op == "Dot":
        z = sess.shr_arith(plc, sess.dot(plc, a, b), f)
    else:
        raise ValueError(op)
    return HostFixedTensor(z, i, f)


def _host_fixed_via_float(sess, plc, op_fn, x: HostFixedTensor):
    v = sess.fixedpoint_decode(plc, x)
    out = op_fn(v)
    return sess.fixedpoint_encode(
        plc, out, x.integral_precision, x.fractional_precision, x.tensor.width
    )


# ---------------------------------------------------------------------------
# Replicated helpers for ops not in fixedpoint.py
# ---------------------------------------------------------------------------


def _rep_zeros_like(sess, rep, x: RepFixedTensor) -> RepTensor:
    shp = fx._shape_of(sess, rep, x.tensor)
    return rep_ops.fill(sess, rep, shp, 0, fx._width_of(x.tensor))


def _rep_relu(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    sign = rep_ops.msb(sess, rep, x.tensor)
    zeros = _rep_zeros_like(sess, rep, x)
    out = rep_ops.mux_bit(sess, rep, sign, zeros, x.tensor)
    return RepFixedTensor(out, x.integral_precision, x.fractional_precision)


def _rep_abs(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    sign = rep_ops.msb(sess, rep, x.tensor)
    negx = rep_ops.neg(sess, rep, x.tensor)
    out = rep_ops.mux_bit(sess, rep, sign, negx, x.tensor)
    return RepFixedTensor(out, x.integral_precision, x.fractional_precision)


def _mirrored_to_public_ring(v):
    """Extract the 3 per-party host ring tensors from a mirrored fixed."""
    if isinstance(v, Mir3FixedTensor):
        return v.tensor.values, v.fractional_precision
    raise TypeError(type(v).__name__)


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------


_HOST_STRUCTURAL_KINDS = frozenset(
    {"Reshape", "ExpandDims", "Squeeze", "Transpose", "IndexAxis",
     "AtLeast2D", "Broadcast"}
)

_REP_STRUCTURAL = {
    "Reshape": rep_ops.reshape,
    "ExpandDims": rep_ops.expand_dims,
    "Squeeze": rep_ops.squeeze,
    "Transpose": rep_ops.transpose,
    "IndexAxis": rep_ops.index_axis,
}

# kind -> session method name (dispatched per-session so symbolic lowering
# records these as graph nodes)
_HOST_MATH = {
    "Exp": "exp",
    "Log": "log",
    "Log2": "log2",
    "Sqrt": "sqrt",
    "Sigmoid": "sigmoid",
    "Relu": "relu",
    "Abs": "abs",
}

_REP_MATH = {
    "Exp": fx.exp,
    "Log": fx.log,
    "Log2": fx.log2,
    "Sqrt": fx.sqrt,
    "Sigmoid": fx.sigmoid,
}

def execute_op(sess, comp: Computation, op: Operation, args: list):
    """Execute one logical operation given its already-computed inputs."""
    plc = comp.placement_of(op)
    if isinstance(plc, HostPlacement):
        return _execute_host(sess, comp, op, plc, args)
    if isinstance(plc, ReplicatedPlacement):
        return _execute_rep(sess, comp, op, plc, args)
    if isinstance(plc, Mirrored3Placement):
        return _execute_mir(sess, comp, op, plc, args)
    raise TypeError(f"unsupported placement {plc!r} for op {op.name}")


# -- host placement ---------------------------------------------------------


def _execute_host(sess, comp, op, plc: HostPlacement, args):
    kind = op.kind
    h = plc.name
    ret_dtype = op.signature.return_type.dtype

    if kind == "Constant":
        return _constant_on_host(sess, h, op)
    if kind == "Identity":
        return to_host(sess, h, args[0])
    if kind == "Output":
        return to_host(sess, h, args[0])
    if kind == "Cast":
        return _cast_on_host(sess, h, args[0], ret_dtype)
    if kind == "Shape":
        x = to_host(sess, h, args[0])
        if isinstance(x, HostFixedTensor):
            x = x.tensor
        return sess.shape(h, x)
    if kind in ("Ones", "Zeros"):
        shp = to_host(sess, h, args[0])
        fn = sess.ones if kind == "Ones" else sess.zeros
        return fn(h, shp, ret_dtype or dt.float64)
    if kind == "Inverse":
        return sess.inverse(h, to_host(sess, h, args[0]))

    if kind in ("Add", "Sub", "Mul", "Div", "Dot"):
        x = to_host(sess, h, args[0])
        y = to_host(sess, h, args[1])
        if isinstance(x, HostFixedTensor) or isinstance(y, HostFixedTensor):
            if kind == "Div":
                # plaintext fixed division via float (documented deviation)
                xv = sess.fixedpoint_decode(h, x)
                yv = sess.fixedpoint_decode(h, y)
                out = sess.div(h, xv, yv)
                return sess.fixedpoint_encode(
                    h, out, x.integral_precision, x.fractional_precision,
                    x.tensor.width,
                )
            return _host_fixed_binop(sess, h, x, y, kind)
        fn = {
            "Add": sess.add, "Sub": sess.sub, "Mul": sess.mul,
            "Div": sess.div, "Dot": sess.dot,
        }[kind]
        return fn(h, x, y)

    if kind == "Conv2D":
        x = to_host(sess, h, args[0])
        k = to_host(sess, h, args[1])
        strides = tuple(op.attributes.get("strides", (1, 1)))
        padding = op.attributes.get("padding", "VALID")
        if isinstance(x, HostFixedTensor):
            if x.fractional_precision != k.fractional_precision:
                from ..errors import TypeMismatchError

                raise TypeMismatchError(
                    "conv operands disagree on fractional precision: "
                    f"{x.fractional_precision} vs {k.fractional_precision}"
                )
            z = sess.shr_arith(
                h,
                sess.conv2d(h, x.tensor, k.tensor, strides, padding),
                x.fractional_precision,
            )
            return HostFixedTensor(
                z,
                max(x.integral_precision, k.integral_precision),
                x.fractional_precision,
            )
        return sess.conv2d(h, x, k, strides, padding)

    if kind in ("AvgPool2D", "MaxPool2D"):
        x = to_host(sess, h, args[0])
        pool = tuple(op.attributes["pool_size"])
        strides = op.attributes.get("strides")
        strides = tuple(strides) if strides is not None else None
        padding = op.attributes.get("padding", "VALID")
        method = (
            sess.avg_pool2d if kind == "AvgPool2D" else sess.max_pool2d
        )
        if isinstance(x, HostFixedTensor):
            # plaintext reference path: pool in float, re-encode
            # (documented deviation, same discipline as host Div)
            return _host_fixed_via_float(
                sess, h, lambda v: method(h, v, pool, strides, padding), x
            )
        return method(h, x, pool, strides, padding)

    if kind == "AddN":
        vals = [to_host(sess, h, a) for a in args]
        out = vals[0]
        for v in vals[1:]:
            out = (
                _host_fixed_binop(sess, h, out, v, "Add")
                if isinstance(out, HostFixedTensor)
                else sess.add(h, out, v)
            )
        return out

    if kind == "Neg":
        x = to_host(sess, h, args[0])
        if isinstance(x, HostFixedTensor):
            return HostFixedTensor(
                sess.neg(h, x.tensor),
                x.integral_precision,
                x.fractional_precision,
            )
        return sess.neg(h, x)

    if kind in ("Less", "Greater", "Equal"):
        x = to_host(sess, h, args[0])
        y = to_host(sess, h, args[1])
        if isinstance(x, HostFixedTensor):
            x = sess.fixedpoint_decode(h, x)
        if isinstance(y, HostFixedTensor):
            y = sess.fixedpoint_decode(h, y)
        fn = {"Less": sess.less, "Greater": sess.greater,
              "Equal": sess.equal}[kind]
        return fn(h, x, y)

    if kind in ("And", "Or", "Xor"):
        x = to_host(sess, h, args[0])
        y = to_host(sess, h, args[1])
        fn = {"And": sess.and_, "Or": sess.or_, "Xor": sess.xor}[kind]
        return fn(h, x, y)

    if kind == "Mux":
        s = to_host(sess, h, args[0])
        x = to_host(sess, h, args[1])
        y = to_host(sess, h, args[2])
        if isinstance(x, HostFixedTensor):
            assert isinstance(y, HostFixedTensor), (
                f"Mux branches must both be fixed, found {type(y).__name__}"
            )
            lo = torch.where(s.value != 0, x.tensor.lo, y.tensor.lo)
            hi = (
                torch.where(s.value != 0, x.tensor.hi, y.tensor.hi)
                if x.tensor.hi is not None
                else None
            )
            return HostFixedTensor(
                HostRingTensor(lo, hi, x.tensor.width, h),
                x.integral_precision,
                x.fractional_precision,
            )
        return sess.mux(h, s, x, y)

    if kind in ("Sum", "Mean"):
        x = to_host(sess, h, args[0])
        axis = op.attributes.get("axis")
        if isinstance(x, HostFixedTensor):
            if kind == "Sum":
                return HostFixedTensor(
                    sess.sum(h, x.tensor, axis),
                    x.integral_precision,
                    x.fractional_precision,
                )
            scaled = sess.ring_fixedpoint_mean(
                h, x.tensor, axis, x.fractional_precision
            )
            return HostFixedTensor(
                sess.shr_arith(h, scaled, x.fractional_precision),
                x.integral_precision,
                x.fractional_precision,
            )
        fn = sess.sum if kind == "Sum" else sess.mean
        return fn(h, x, axis)

    if kind in _HOST_MATH:
        x = to_host(sess, h, args[0])
        method = getattr(sess, _HOST_MATH[kind])
        if isinstance(x, HostFixedTensor):
            return _host_fixed_via_float(sess, h, lambda v: method(h, v), x)
        return method(h, x)

    if kind == "Softmax":
        x = to_host(sess, h, args[0])
        axis = op.attributes["axis"]
        if isinstance(x, HostFixedTensor):
            return _host_fixed_via_float(
                sess, h, lambda v: sess.softmax(h, v, axis), x
            )
        return sess.softmax(h, x, axis)

    if kind == "Argmax":
        x = to_host(sess, h, args[0])
        axis = op.attributes["axis"]
        if isinstance(x, HostFixedTensor):
            x = sess.fixedpoint_decode(h, x)
        return sess.argmax(h, x, axis)

    if kind == "Maximum":
        vals = [to_host(sess, h, a) for a in args]
        if isinstance(vals[0], HostFixedTensor):
            f = vals[0].fractional_precision
            i = vals[0].integral_precision
            w = vals[0].tensor.width
            floats = [sess.fixedpoint_decode(h, v) for v in vals]
            return sess.fixedpoint_encode(h, sess.maximum(h, floats), i, f, w)
        return sess.maximum(h, vals)

    if kind == "Concat":
        vals = [to_host(sess, h, a) for a in args]
        axis = op.attributes.get("axis", 0)
        if isinstance(vals[0], HostFixedTensor):
            rings = [v.tensor for v in vals]
            return HostFixedTensor(
                sess.concat(h, rings, axis),
                vals[0].integral_precision,
                vals[0].fractional_precision,
            )
        return sess.concat(h, vals, axis)

    if kind in _HOST_STRUCTURAL_KINDS:
        return _host_structural(sess, comp, op, h, args)

    if kind == "Slice":
        return _host_slice(sess, op, h, args)

    if kind == "Select":
        x = to_host(sess, h, args[0])
        index = to_host(sess, h, args[1])
        axis = op.attributes["axis"]
        return sess.select(h, x, axis, index)

    if kind == "Decrypt":
        from . import aes

        return aes.decrypt_host(sess, h, args[0], args[1], op)

    raise NotImplementedError(f"host op {kind} ({op.name})")


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


def _cast_on_host(sess, h, v, target: dt.DType):
    v = to_host(sess, h, v)
    if target.is_fixedpoint:
        if isinstance(v, HostFixedTensor):
            # fixed -> fixed precision move: rescale the raw ring value
            df = target.fractional_precision - v.fractional_precision
            t = v.tensor
            if df > 0:
                t = sess.shl(h, t, df)
            elif df < 0:
                t = sess.shr_arith(h, t, -df)
            return HostFixedTensor(
                t,
                target.integral_precision,
                target.fractional_precision,
            )
        assert isinstance(v, HostTensor)
        return sess.fixedpoint_encode(
            h,
            v,
            target.integral_precision,
            target.fractional_precision,
            _width_of_dtype(target),
        )
    if isinstance(v, HostFixedTensor):
        return sess.fixedpoint_decode(h, v, target)
    if isinstance(v, HostRingTensor):
        # a revealed index (Argmax): its low words as uint64, then cast
        return sess.cast_ring_lo(h, v, target)
    return sess.cast(h, v, target)


def _host_structural(sess, comp, op, h, args):
    kind = op.kind
    x = to_host(sess, h, args[0])
    is_fixed = isinstance(x, HostFixedTensor)
    inner = x.tensor if is_fixed else x

    if kind == "Reshape":
        shp = to_host(sess, h, args[1])
        out = sess.reshape(h, inner, shp)
    elif kind == "Broadcast":
        shp = to_host(sess, h, args[1])
        out = sess.broadcast(h, inner, shp)
    elif kind == "ExpandDims":
        axes = op.attributes["axis"]
        out = inner
        for a in sorted(axes):
            out = sess.expand_dims(h, out, a)
    elif kind == "Squeeze":
        out = sess.squeeze(h, inner, op.attributes.get("axis"))
    elif kind == "Transpose":
        out = sess.transpose(h, inner, op.attributes.get("axes"))
    elif kind == "IndexAxis":
        out = sess.index_axis(
            h, inner, op.attributes["axis"], op.attributes["index"]
        )
    elif kind == "AtLeast2D":
        out = sess.at_least_2d(
            h, inner, op.attributes.get("to_column_vector", False)
        )
    else:
        raise NotImplementedError(kind)
    if is_fixed:
        return HostFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )
    return out


def decode_slice_spec(attributes) -> tuple:
    """Rebuild the python slice tuple from Slice op attributes; the
    ``"..."`` marker becomes a real Ellipsis, expanded against
    the operand's actual rank (see edsl.strided_slice)."""
    if "slices" in attributes:
        return tuple(
            Ellipsis if s == "..." else slice(*s)
            for s in attributes["slices"]
        )
    return (slice(attributes["begin"], attributes["end"]),)


def _host_slice(sess, op, h, args):
    x = to_host(sess, h, args[0])
    spec = decode_slice_spec(op.attributes)
    if isinstance(x, HostShape):
        if len(spec) != 1 or not isinstance(spec[0], slice):
            from ..errors import KernelError

            raise KernelError(
                f"shape slicing takes a single slice, found {spec!r}"
            )
        return HostShape(x.value[spec[0]], h)
    is_fixed = isinstance(x, HostFixedTensor)
    inner = x.tensor if is_fixed else x
    out = sess.strided_slice(h, inner, spec)
    if is_fixed:
        return HostFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )
    return out


# -- replicated placement ---------------------------------------------------


def _execute_rep(sess, comp, op, plc: ReplicatedPlacement, args):
    kind = op.kind
    rep = plc
    ret_dtype = op.signature.return_type.dtype

    def fixed_args():
        return [to_rep(sess, rep, a) for a in args]

    if kind == "Identity":
        return to_rep(sess, rep, args[0])

    if kind == "Constant":
        # build the host constant on owners[0] then share (scalar operator
        # sugar like `y + 1.0` inside `with rep:` lands here)
        host_op = Operation(
            name=op.name,
            kind="Constant",
            inputs=[],
            placement_name=rep.owners[0],
            signature=op.signature,
            attributes=op.attributes,
        )
        h = _constant_on_host(sess, rep.owners[0], host_op)
        if isinstance(h, (HostShape, HostString)):
            # public metadata (shapes, storage keys) is never shared
            return h
        return to_rep(sess, rep, h)

    if kind in ("Add", "Sub", "Mul", "Dot", "Div"):
        x, y = args
        # Mirrored public operand paths
        if isinstance(y, Mir3FixedTensor) and kind in ("Add", "Sub", "Mul"):
            xr = to_rep(sess, rep, x)
            return _rep_public_binop(sess, rep, xr, y, kind, right=True)
        if isinstance(x, Mir3FixedTensor) and kind in ("Add", "Sub", "Mul"):
            yr = to_rep(sess, rep, y)
            return _rep_public_binop(sess, rep, yr, x, kind, right=False)
        xr = to_rep(sess, rep, x)
        yr = to_rep(sess, rep, y)
        bare_x = isinstance(xr, RepTensor)
        bare_y = isinstance(yr, RepTensor)
        if bare_x != bare_y:
            from ..errors import TypeMismatchError

            raise TypeMismatchError(
                f"{kind} mixes a secret integer (bare ring shares) with "
                "a secret fixed-point tensor; cast one side first "
                f"(got {type(xr).__name__} and {type(yr).__name__})"
            )
        if bare_x and bare_y:
            # secret-shared uint64 (integer dialect,
            # reference integer/mod.rs:12-15): bare ring shares with NO
            # fixed-point scale — plain wrapping ring arithmetic, no
            # truncation (mul/dot cost one reshare round)
            fn = {
                "Add": rep_ops.add, "Sub": rep_ops.sub,
                "Mul": rep_ops.mul, "Dot": rep_ops.dot,
            }.get(kind)
            if fn is None:
                raise NotImplementedError(
                    "Div on secret uint64 is undefined (ring division); "
                    "cast to a fixed dtype first"
                )
            return fn(sess, rep, xr, yr)
        fn = {"Add": fx.add, "Sub": fx.sub, "Mul": fx.mul, "Dot": fx.dot,
              "Div": fx.div}[kind]
        return fn(sess, rep, xr, yr)

    if kind == "Conv2D":
        x = to_rep(sess, rep, args[0])
        k = to_rep(sess, rep, args[1])
        return fx.conv2d(
            sess, rep, x, k,
            strides=tuple(op.attributes.get("strides", (1, 1))),
            padding=op.attributes.get("padding", "VALID"),
        )

    if kind in ("AvgPool2D", "MaxPool2D"):
        x = to_rep(sess, rep, args[0])
        pool = tuple(op.attributes["pool_size"])
        strides = op.attributes.get("strides")
        strides = tuple(strides) if strides is not None else None
        padding = op.attributes.get("padding", "VALID")
        fn = fx.avg_pool2d if kind == "AvgPool2D" else fx.max_pool2d
        return fn(sess, rep, x, pool, strides, padding)

    if kind == "AddN":
        vals = fixed_args()
        out = vals[0]
        for v in vals[1:]:
            out = fx.add(sess, rep, out, v)
        return out

    if kind == "Neg":
        x = to_rep(sess, rep, args[0])
        return fx.neg(sess, rep, x)

    if kind in ("Less", "Greater", "Equal"):
        x = to_rep(sess, rep, args[0])
        y = to_rep(sess, rep, args[1])
        if kind == "Less":
            return rep_ops.less(sess, rep, x.tensor, y.tensor)
        if kind == "Greater":
            return rep_ops.greater(sess, rep, x.tensor, y.tensor)
        # Equal (reference replicated/compare.rs)
        return rep_ops.equal_bit(sess, rep, x.tensor, y.tensor)

    if kind in ("And", "Or", "Xor"):
        x = to_rep(sess, rep, args[0])
        y = to_rep(sess, rep, args[1])
        fn = {"And": rep_ops.and_bits, "Or": rep_ops.or_bits,
              "Xor": rep_ops.xor}[kind]
        return fn(sess, rep, x, y)

    if kind == "Mux":
        s = to_rep(sess, rep, args[0])  # RepTensor bits
        x = to_rep(sess, rep, args[1])
        y = to_rep(sess, rep, args[2])
        out = rep_ops.mux_bit(sess, rep, s, x.tensor, y.tensor)
        return RepFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )

    if kind in ("Sum", "Mean"):
        x = to_rep(sess, rep, args[0])
        axis = op.attributes.get("axis")
        fn = fx.sum_ if kind == "Sum" else fx.mean
        return fn(sess, rep, x, axis)

    if kind in _REP_MATH:
        x = to_rep(sess, rep, args[0])
        return _REP_MATH[kind](sess, rep, x)

    if kind == "Relu":
        return _rep_relu(sess, rep, to_rep(sess, rep, args[0]))

    if kind == "Abs":
        return _rep_abs(sess, rep, to_rep(sess, rep, args[0]))

    if kind == "Softmax":
        x = to_rep(sess, rep, args[0])
        return fx.softmax(
            sess, rep, x, op.attributes["axis"], op.attributes["upmost_index"]
        )

    if kind == "Argmax":
        x = to_rep(sess, rep, args[0])
        return fx.argmax(
            sess, rep, x, op.attributes["axis"], op.attributes["upmost_index"]
        )

    if kind == "Maximum":
        vals = fixed_args()
        return fx.maximum(sess, rep, vals)

    if kind == "Concat":
        vals = fixed_args()
        axis = op.attributes.get("axis", 0)
        out = rep_ops.concat(sess, rep, [v.tensor for v in vals], axis)
        return RepFixedTensor(
            out, vals[0].integral_precision, vals[0].fractional_precision
        )

    if kind in _REP_STRUCTURAL:
        x = to_rep(sess, rep, args[0])
        return _rep_structural(sess, comp, op, rep, x, args)

    if kind == "Slice":
        x = to_rep(sess, rep, args[0])
        spec = decode_slice_spec(op.attributes)
        if isinstance(x, RepFixedTensor):
            out = rep_ops.strided_slice(sess, rep, x.tensor, spec)
            return RepFixedTensor(
                out, x.integral_precision, x.fractional_precision
            )
        return rep_ops.strided_slice(sess, rep, x, spec)

    if kind == "Shape":
        x = to_rep(sess, rep, args[0])
        inner = x.tensor if isinstance(x, RepFixedTensor) else x
        return fx._shape_of(sess, rep, inner)

    if kind == "Cast":
        # fixed->fixed precision moves; anything else must go via a host.
        x = to_rep(sess, rep, args[0])
        assert ret_dtype is not None and ret_dtype.is_fixedpoint
        assert isinstance(x, RepFixedTensor)
        cur_f = x.fractional_precision
        new_f = ret_dtype.fractional_precision
        t = x.tensor
        if new_f > cur_f:
            t = rep_ops.shl(sess, rep, t, new_f - cur_f)
        elif new_f < cur_f:
            t = rep_ops.trunc_pr(sess, rep, t, cur_f - new_f)
        return RepFixedTensor(
            t, ret_dtype.integral_precision, new_f
        )

    if kind == "Decrypt":
        from . import aes

        return aes.decrypt_rep(sess, rep, args[0], args[1], op)

    raise NotImplementedError(f"replicated op {kind} ({op.name})")


def _rep_public_binop(sess, rep, x: RepFixedTensor, pub: Mir3FixedTensor,
                      kind: str, right: bool):
    """x (+|-|*) mirrored-public value without extra sharing rounds
    (reference fixedpoint dialect Mir ops)."""
    values, pub_f = _mirrored_to_public_ring(pub)
    assert pub_f == x.fractional_precision
    if kind == "Add":
        out = rep_ops.add_public(
            sess, rep, x.tensor, values[0], c_on_p2=values[2]
        )
        return RepFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )
    if kind == "Sub":
        if right:
            out = rep_ops.sub_public(
                sess, rep, x.tensor, values[0], c_on_p2=values[2]
            )
        else:
            # pub - x = -(x - pub)
            out = rep_ops.sub_public(
                sess, rep, x.tensor, values[0], c_on_p2=values[2]
            )
            out = rep_ops.neg(sess, rep, out)
        return RepFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )
    if kind == "Mul":
        out = rep_ops.mul_public(sess, rep, x.tensor, values)
        out = rep_ops.trunc_pr(sess, rep, out, x.fractional_precision)
        return RepFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )
    raise ValueError(kind)


def _rep_structural(sess, comp, op, rep, x, args):
    kind = op.kind
    is_fixed = isinstance(x, RepFixedTensor)
    inner = x.tensor if is_fixed else x
    fn = _REP_STRUCTURAL[kind]
    if kind == "Reshape":
        shp = to_host(sess, rep.owners[0], args[1])
        out = fn(sess, rep, inner, shp)
    elif kind == "ExpandDims":
        axes = op.attributes["axis"]
        out = inner
        for a in sorted(axes):
            out = fn(sess, rep, out, axis=a)
    elif kind == "Squeeze":
        out = fn(sess, rep, inner, op.attributes.get("axis"))
    elif kind == "IndexAxis":
        out = fn(sess, rep, inner, op.attributes["axis"],
                 op.attributes["index"])
    elif kind == "Transpose":
        out = fn(sess, rep, inner, axes=op.attributes.get("axes"))
    else:
        out = fn(sess, rep, inner)
    if is_fixed:
        return RepFixedTensor(
            out, x.integral_precision, x.fractional_precision
        )
    return out


def _execute_mir(sess, comp, op, plc: Mirrored3Placement, args):
    kind = op.kind
    mir = plc
    ret_dtype = op.signature.return_type.dtype

    if kind == "Constant":
        value = op.attributes["value"]
        if ret_dtype is not None and ret_dtype.is_fixedpoint:
            width = _width_of_dtype(ret_dtype)
            vals = []
            for owner in mir.owners:
                t = sess.constant(
                    owner, np.asarray(value, dtype=np.float64), dt.float64
                )
                vals.append(
                    sess.ring_fixedpoint_encode(
                        owner, t, ret_dtype.fractional_precision, width
                    )
                )
            return Mir3FixedTensor(
                Mir3Tensor(tuple(vals), mir.name),
                ret_dtype.integral_precision,
                ret_dtype.fractional_precision,
            )
        vals = tuple(
            sess.constant(owner, np.asarray(value), ret_dtype)
            for owner in mir.owners
        )
        return Mir3Tensor(vals, mir.name)

    if kind == "Cast":
        v = args[0]
        assert ret_dtype is not None
        if isinstance(v, Mir3Tensor) and ret_dtype.is_fixedpoint:
            width = _width_of_dtype(ret_dtype)
            vals = tuple(
                sess.ring_fixedpoint_encode(
                    t.plc, t, ret_dtype.fractional_precision, width
                )
                for t in v.values
            )
            return Mir3FixedTensor(
                Mir3Tensor(vals, mir.name),
                ret_dtype.integral_precision,
                ret_dtype.fractional_precision,
            )
        if isinstance(v, Mir3FixedTensor) and not ret_dtype.is_fixedpoint:
            vals = tuple(
                sess.ring_fixedpoint_decode(
                    t.plc, t, v.fractional_precision, ret_dtype
                )
                for t in v.tensor.values
            )
            return Mir3Tensor(vals, mir.name)
        raise NotImplementedError("mirrored cast variant")

    raise NotImplementedError(f"mirrored op {kind} ({op.name})")
