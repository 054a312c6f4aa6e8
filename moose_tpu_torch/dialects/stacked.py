"""Stacked dialect: executes logical computations in the party-stacked
layout on one device.

PyTorch counterpart of ``moose_tpu/dialects/stacked.py`` for the slice's
graphs.  Replicated tensors become ``SpmdRep``/``SpmdFixed`` (one word
tensor with a leading party axis); host and mirrored ops delegate to the
logical dialect.  The replicated kinds are those of the eDSL secure dot,
the ONNX linear regressor, the ONNX logistic regression and the SGD
trainers' step (``Dot``, ``Concat``, ``Sigmoid``, ``IndexAxis``,
``ExpandDims``, ``Transpose``, ``Sub`` and the other arithmetic of the
classifier heads) plus the fixed-point precision move ``Cast``; any
other kind is refused by :func:`supports` and raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import math

from ..computation import (
    Computation,
    HostPlacement,
    Mirrored3Placement,
    Operation,
    ReplicatedPlacement,
)
from ..errors import TypeMismatchError
from ..execution.session import EagerSession
from ..parallel import spmd
from ..parallel import spmd_math as sm
from ..parallel.spmd import SpmdFixed, SpmdRep, SpmdSession
from ..values import HostFixedTensor, HostRingTensor, Mir3FixedTensor
from . import logical

REP_KINDS = frozenset({
    "Dot", "Concat", "Cast", "Sigmoid", "IndexAxis", "ExpandDims", "Add",
    "Sub", "Mul", "Div", "Sum", "Transpose",
})
BOUNDARY_KINDS = frozenset({"Input", "Output"})

_LATER = "ROADMAP queue 1, items 3-8"

_STACKED_VALUES = (SpmdRep, SpmdFixed)


class StackedSession:
    """Pairs an :class:`EagerSession` (host kernels) with an
    :class:`SpmdSession` (party-stacked PRF draws) under one master key,
    both on ``device``."""

    def __init__(self, master_key, device, key_domain: int = 0):
        self.host = EagerSession(device)
        self.spmd = SpmdSession(master_key, device, domain=key_domain)

    @property
    def session_id(self):
        return self.host.session_id


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def to_rep(sess: StackedSession, v):
    """Materialize a logical value as a party-stacked sharing."""
    if isinstance(v, _STACKED_VALUES):
        return v
    if isinstance(v, HostFixedTensor):
        t = v.tensor
        return SpmdFixed(
            spmd.share(sess.spmd, t.lo, t.hi, t.width),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, Mir3FixedTensor):
        # mirrored values are public; a trivial sharing keeps them cheap
        values, frac = logical._mirrored_to_public_ring(v)
        c = values[0]
        return SpmdFixed(
            spmd.public_to_rep(c.lo, c.hi, c.width),
            v.integral_precision,
            frac,
        )
    raise TypeMismatchError(
        f"cannot share {type(v).__name__} in the port's stacked layout "
        f"({_LATER})"
    )


def to_host(sess: StackedSession, plc_name: str, v):
    """Materialize a logical value as a host value on ``plc_name``."""
    if isinstance(v, SpmdFixed):
        lo, hi = spmd.reveal(v.tensor)
        return HostFixedTensor(
            HostRingTensor(lo, hi, v.tensor.width, plc_name),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, SpmdRep):
        lo, hi = spmd.reveal(v)
        return HostRingTensor(lo, hi, v.width, plc_name)
    return logical.to_host(sess.host, plc_name, v)


# ---------------------------------------------------------------------------
# Replicated-placement dispatch
# ---------------------------------------------------------------------------


def _fixed(v, kind: str) -> SpmdFixed:
    if not isinstance(v, SpmdFixed):
        raise TypeMismatchError(
            f"stacked {kind} takes secret fixed-point tensors, got "
            f"{type(v).__name__} ({_LATER})"
        )
    return v


def _fx(t: SpmdRep, like: SpmdFixed) -> SpmdFixed:
    return SpmdFixed(t, like.integral_precision, like.fractional_precision)


def _public_binop(sess, x: SpmdFixed, pub: Mir3FixedTensor, kind: str,
                  right: bool) -> SpmdFixed:
    """x (+|-|*) mirrored-public value without sharing rounds; ``right``
    says the public value is the right operand (pub - x = -(x - pub))."""
    values, pub_f = logical._mirrored_to_public_ring(pub)
    if pub_f != x.fractional_precision:
        raise TypeMismatchError(
            f"{kind} operands disagree on fractional precision: "
            f"{x.fractional_precision} vs mirrored {pub_f}"
        )
    c = values[0]
    if kind == "Add":
        return _fx(spmd.add_public(x.tensor, c.lo, c.hi), x)
    if kind == "Sub":
        out = spmd.sub_public(x.tensor, c.lo, c.hi)
        return _fx(out if right else spmd.neg(out), x)
    out = spmd.mul_public(x.tensor, c.lo, c.hi)
    return _fx(spmd.trunc_pr(sess.spmd, out, x.fractional_precision), x)


def _align_logical_ranks(x: SpmdFixed, y: SpmdFixed):
    """Prepend singleton logical axes (after the (party, slot) prefix) to
    the lower-rank operand, so elementwise ops broadcast by logical
    shape."""

    def lift(v: SpmdFixed, n: int) -> SpmdFixed:
        if n <= 0:
            return v
        t = v.tensor
        return _fx(spmd.reshape(t, (1,) * n + t.shape), v)

    rx, ry = len(x.tensor.shape), len(y.tensor.shape)
    return lift(x, ry - rx), lift(y, rx - ry)


_SECRET_BINOPS = {
    "Add": lambda s, x, y: spmd.fx_add(x, y),
    "Sub": lambda s, x, y: spmd.fx_sub(x, y),
    "Mul": spmd.fx_mul,
    "Div": sm.fx_div,
}


def _fx_sum(x: SpmdFixed, axis) -> SpmdFixed:
    t = x.tensor
    if axis is None:
        t, axis = spmd.reshape(t, (math.prod(t.shape),)), 0
    return _fx(spmd.sum_axis(t, axis), x)


def _execute_rep(sess: StackedSession, comp, op: Operation,
                 rep: ReplicatedPlacement, args):
    kind = op.kind
    ret_dtype = op.signature.return_type.dtype

    if kind == "Dot":
        x = _fixed(to_rep(sess, args[0]), kind)
        y = _fixed(to_rep(sess, args[1]), kind)
        return spmd.fx_dot(sess.spmd, x, y)

    if kind in _SECRET_BINOPS:
        x, y = args
        if isinstance(y, Mir3FixedTensor) and kind != "Div":
            return _public_binop(sess, _fixed(to_rep(sess, x), kind), y,
                                 kind, right=True)
        if isinstance(x, Mir3FixedTensor) and kind != "Div":
            return _public_binop(sess, _fixed(to_rep(sess, y), kind), x,
                                 kind, right=False)
        xr, yr = _align_logical_ranks(
            _fixed(to_rep(sess, x), kind), _fixed(to_rep(sess, y), kind)
        )
        return _SECRET_BINOPS[kind](sess.spmd, xr, yr)

    if kind == "Sigmoid":
        return sm.fx_sigmoid(sess.spmd, _fixed(to_rep(sess, args[0]), kind))

    if kind == "Sum":
        x = _fixed(to_rep(sess, args[0]), kind)
        return _fx_sum(x, op.attributes.get("axis"))

    if kind == "IndexAxis":
        x = _fixed(to_rep(sess, args[0]), kind)
        out = spmd.index_axis(
            x.tensor, op.attributes["axis"], op.attributes["index"]
        )
        return _fx(out, x)

    if kind == "Transpose":
        x = _fixed(to_rep(sess, args[0]), kind)
        return _fx(spmd.transpose(x.tensor, op.attributes.get("axes")), x)

    if kind == "ExpandDims":
        x = _fixed(to_rep(sess, args[0]), kind)
        out = x.tensor
        for a in sorted(op.attributes["axis"]):
            out = spmd.expand_dims(out, a)
        return _fx(out, x)

    if kind == "Concat":
        vals = [_fixed(to_rep(sess, a), kind) for a in args]
        axis = op.attributes.get("axis", 0)
        out = spmd.concat([v.tensor for v in vals], axis)
        return SpmdFixed(
            out, vals[0].integral_precision, vals[0].fractional_precision
        )

    if kind == "Cast":
        if ret_dtype is None or not ret_dtype.is_fixedpoint:
            raise TypeMismatchError(
                "stacked Cast on a replicated placement must target a "
                f"fixed-point dtype, got {ret_dtype}"
            )
        x = _fixed(to_rep(sess, args[0]), kind)
        cur_f = x.fractional_precision
        new_f = ret_dtype.fractional_precision
        t = x.tensor
        if new_f > cur_f:
            t = spmd.shl(t, new_f - cur_f)
        elif new_f < cur_f:
            t = spmd.trunc_pr(sess.spmd, t, cur_f - new_f)
        return SpmdFixed(t, ret_dtype.integral_precision, new_f)

    raise NotImplementedError(
        f"stacked replicated op {kind} ({op.name}; {_LATER})"
    )


def unsupported_ops(comp: Computation) -> list:
    """``(placement kind, op kind)`` of every op the port cannot run yet."""
    missing = []
    for op in comp.operations.values():
        plc = comp.placements.get(op.placement_name)
        if op.kind in BOUNDARY_KINDS:
            continue
        if isinstance(plc, ReplicatedPlacement):
            ok = op.kind in REP_KINDS
        elif isinstance(plc, HostPlacement):
            ok = op.kind in logical.HOST_KINDS
        elif isinstance(plc, Mirrored3Placement):
            ok = op.kind in logical.MIR_KINDS
        else:
            ok = False
        if not ok:
            missing.append((type(plc).__name__, op.kind))
    return missing


def supports(comp: Computation) -> bool:
    """Whether every op of ``comp`` has a path in the port."""
    return not unsupported_ops(comp)


def execute_op(sess: StackedSession, comp: Computation, op: Operation,
               args: list):
    """Execute one logical operation in the stacked layout."""
    plc = comp.placement_of(op)
    if isinstance(plc, HostPlacement):
        h_args = [
            to_host(sess, plc.name, a) if isinstance(a, _STACKED_VALUES)
            else a
            for a in args
        ]
        return logical._execute_host(sess.host, comp, op, plc, h_args)
    if isinstance(plc, ReplicatedPlacement):
        return _execute_rep(sess, comp, op, plc, args)
    if isinstance(plc, Mirrored3Placement):
        return logical._execute_mir(sess.host, comp, op, plc, args)
    raise TypeError(f"unsupported placement {plc!r} for op {op.name}")
