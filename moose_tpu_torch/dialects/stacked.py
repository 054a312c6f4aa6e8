"""Stacked dialect: executes logical computations in the party-stacked
layout on one device.

PyTorch counterpart of ``moose_tpu/dialects/stacked.py``.  Replicated
tensors become ``SpmdRep``/``SpmdFixed``/``SpmdBits`` (one tensor with a
leading party axis); host and mirrored ops delegate to the logical
dialect.  The replicated kinds (:data:`REP_KINDS`) are the reference's
41, Decrypt (AES-GCM decryption under MPC, ``dialects/aes.py``) among
them.  Operands are secret fixed-point tensors, bits where a kind takes
them, and secret integers: an integer host tensor lifts at scale 0 into
the ring its consuming op names (:func:`_op_ring_width`) and is shared
bare, as is the index tensor ``Argmax`` returns; Add, Sub, Mul, Dot,
Sum and the structural kinds run on such bare sharings without
truncation, a bare sharing reveals to a ``HostRingTensor``, and a Cast
moves it into the fixed family.  AES values cross the
host boundary as the reference's stacked layout takes them
(:func:`lift_aes_input`).  :func:`unsupported_ops` lists what a graph
needs beyond that, and every refusal names its ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..computation import (
    AES_TY_NAMES,
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
from ..parallel.spmd_math import SpmdBits
from ..values import (
    HostBitTensor,
    HostFixedTensor,
    HostRingTensor,
    HostShape,
    HostString,
    HostTensor,
    Mir3FixedTensor,
)
from . import aes, host, logical

REP_KINDS = frozenset({
    "Identity", "Constant", "Add", "Sub", "Mul", "Dot", "Div", "AddN",
    "Neg", "Less", "Greater", "Equal", "And", "Or", "Xor", "Mux", "Sum",
    "Mean", "Exp", "Log", "Log2", "Sqrt", "Sigmoid", "Relu", "Abs",
    "Softmax", "Argmax", "Maximum", "Concat", "Reshape", "ExpandDims",
    "Squeeze", "Transpose", "IndexAxis", "Slice", "Shape", "Cast",
    "Decrypt", "Conv2D", "AvgPool2D", "MaxPool2D",
})
# resolved by the interpreter's walk, on any placement
BOUNDARY_KINDS = frozenset({"Input", "Output", "Load", "Save"})

def roadmap_item(placement_kind: str, op_kind: str) -> str:
    """Where an op kind this layout refuses on a placement of
    ``placement_kind`` (a placement class name) runs: every such kind,
    the secret-shared checkpoints (LoadShares, SaveShares) among them,
    runs on the per-host layout, as in the reference."""
    return "the per-host layout runs it"


_STACKED_VALUES = (SpmdRep, SpmdFixed, SpmdBits)


class StackedSession:
    """Pairs an :class:`EagerSession` (host kernels) with an
    :class:`SpmdSession` (party-stacked PRF draws) under one master key,
    both on ``device``.  ``mesh`` (optional, ``spmd.make_mesh``)
    constrains each fresh sharing to the (parties, data) mesh, its first
    axis over ``"data"``."""

    def __init__(self, master_key, device, key_domain: int = 0,
                 mesh=None):
        self.host = EagerSession(device)
        self.spmd = SpmdSession(master_key, device, domain=key_domain)
        self.mesh = mesh

    @property
    def session_id(self):
        return self.host.session_id


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def _constrain_opt(sess: StackedSession, t: SpmdRep) -> SpmdRep:
    if sess.mesh is None:
        return t
    return spmd.constrain(t, sess.mesh, 0 if t.lo.ndim > 2 else None)


def _share_ring(sess: StackedSession, t: HostRingTensor) -> SpmdRep:
    return _constrain_opt(
        sess, spmd.share(sess.spmd, t.lo, t.hi, t.width))


def to_rep(sess: StackedSession, v, width: Optional[int] = None):
    """Materialize a logical value as a party-stacked sharing.

    ``width`` is the ring a secret integer lifts into (the value itself
    carries none): callers read it off the consuming op's signature with
    :func:`_op_ring_width`; ``None`` lifts at 64, the integer dialect's
    own ring."""
    if isinstance(v, _STACKED_VALUES):
        return v
    if isinstance(v, HostFixedTensor):
        return SpmdFixed(
            _share_ring(sess, v.tensor),
            v.integral_precision,
            v.fractional_precision,
        )
    if isinstance(v, HostBitTensor):
        return sm.share_bits(sess.spmd, v.value)
    if isinstance(v, Mir3FixedTensor):
        # mirrored values are public; a trivial sharing keeps them cheap
        values, frac = logical._mirrored_to_public_ring(v)
        c = values[0]
        return SpmdFixed(
            spmd.public_to_rep(c.lo, c.hi, c.width),
            v.integral_precision,
            frac,
        )
    if isinstance(v, HostRingTensor):
        return _share_ring(sess, v)
    if isinstance(v, HostTensor):
        if v.dtype is not None and v.dtype.is_integer:
            # the integer dialect's lift (reference integer/mod.rs:12-15)
            ring_t = sess.host.ring_fixedpoint_encode(v.plc, v, 0,
                                                      width or 64)
            return _share_ring(sess, ring_t)
        raise TypeMismatchError(
            "cannot share a plaintext float tensor; cast to a fixed "
            "dtype first (reference requires FixedpointEncode before "
            "Share)"
        )
    raise TypeMismatchError(
        f"cannot share {type(v).__name__} in stacked layout"
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
    if isinstance(v, SpmdBits):
        return HostBitTensor(sm.reveal_bits(v), plc_name)
    return logical.to_host(sess.host, plc_name, v)


# ---------------------------------------------------------------------------
# Structural helpers on the logical axes of (3, 2, *shape)
# ---------------------------------------------------------------------------


def _squeeze_arr(a, axis):
    if axis is None:
        return a.reshape(a.shape[:2] + tuple(d for d in a.shape[2:]
                                             if d != 1))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for ax in sorted((spmd._laxis(a, ax) for ax in axes), reverse=True):
        if a.shape[ax] != 1:
            raise ValueError(f"cannot squeeze axis {ax - 2} of size "
                             f"{a.shape[ax]}")
        a = a.squeeze(ax)
    return a


def _slice_arr(a, spec):
    # numpy's basic indexing, negative steps included, past the (party,
    # slot) axes
    return host.strided_index(a, (slice(None), slice(None)) + tuple(spec))


_squeeze = spmd._structural(_squeeze_arr)
_strided_slice = spmd._structural(_slice_arr)


# ---------------------------------------------------------------------------
# Replicated-placement dispatch
# ---------------------------------------------------------------------------


def _fixed(v, kind: str) -> SpmdFixed:
    if not isinstance(v, SpmdFixed):
        raise TypeMismatchError(
            f"stacked {kind} takes secret fixed-point tensors, got "
            f"{type(v).__name__}"
        )
    return v


def _op_ring_width(op: Operation) -> Optional[int]:
    """The ring a secret integer operand of ``op`` lifts into, read off
    its signature: a fixed-point dtype among its types decides, then a
    Ring-typed signature by name; ``None`` when nothing says (the lift
    then takes 64)."""
    sig = op.signature
    types = (sig.return_type, *sig.input_types)
    for ty in types:
        d = getattr(ty, "dtype", None)
        if d is not None and d.is_fixedpoint:
            return 64 if d.name == "fixed64" else 128
    for ty in types:
        name = getattr(ty, "name", "") or ""
        if "Ring128" in name:
            return 128
        if "Ring64" in name:
            return 64
    return None


def _bits(v, kind: str) -> SpmdBits:
    if not isinstance(v, SpmdBits):
        raise TypeMismatchError(
            f"stacked {kind} takes shared bits, got {type(v).__name__}"
        )
    return v


def _fx(t: SpmdRep, like: SpmdFixed) -> SpmdFixed:
    return SpmdFixed(t, like.integral_precision, like.fractional_precision)


def _inner(x, kind: str) -> SpmdRep:
    """The word sharing of a fixed-point or bare integer sharing."""
    if isinstance(x, SpmdFixed):
        return x.tensor
    if isinstance(x, SpmdRep):
        return x
    raise TypeMismatchError(
        f"stacked {kind} takes secret tensors, got {type(x).__name__}")


def _on_inner(x, fn):
    """``fn`` on the word tensor of a fixed-point sharing (keeping its
    precision), of a bare index sharing or of shared bits."""
    if isinstance(x, SpmdFixed):
        return _fx(fn(x.tensor), x)
    if isinstance(x, (SpmdRep, SpmdBits)):
        return fn(x)
    raise TypeMismatchError(
        f"stacked structural ops take secret tensors, got {type(x).__name__}"
    )


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


def _align_logical_ranks(*vals):
    """Elementwise operands (fixed-point, bare integer sharings or bits)
    broadcast by logical shape: the stacked tensors carry a (party, slot)
    prefix, so a lower-rank operand gets singleton logical axes after
    it, as broadcasting would prepend them to the logical shape."""
    ranks = [len(v.tensor.shape) if isinstance(v, SpmdFixed)
             else len(v.shape) for v in vals]
    top = max(ranks)

    def lift(v, n):
        if n == 0:
            return v
        if isinstance(v, SpmdBits):
            a = v.arr
            return SpmdBits(a.reshape(a.shape[:2] + (1,) * n + a.shape[2:]))
        if isinstance(v, SpmdRep):
            return spmd.reshape(v, (1,) * n + v.shape)
        t = v.tensor
        return _fx(spmd.reshape(t, (1,) * n + t.shape), v)

    return tuple(lift(v, top - r) for v, r in zip(vals, ranks))


_SECRET_BINOPS = {
    "Add": lambda s, x, y: spmd.fx_add(x, y),
    "Sub": lambda s, x, y: spmd.fx_sub(x, y),
    "Mul": spmd.fx_mul,
    "Dot": spmd.fx_dot,
    "Div": sm.fx_div,
}
# the same kinds on secret integers: wrapping ring arithmetic on the
# bare sharings, no truncation (Mul and Dot reshare once)
_INTEGER_BINOPS = {
    "Add": lambda s, x, y: spmd.add(x, y),
    "Sub": lambda s, x, y: spmd.sub(x, y),
    "Mul": spmd.mul,
    "Dot": spmd.dot,
}


def _secret_binop(sess, kind: str, x, y):
    """A secret Add, Sub, Mul, Dot or Div of two sharings of one family:
    both secret integers (bare) or both fixed-point."""
    bare_x, bare_y = isinstance(x, SpmdRep), isinstance(y, SpmdRep)
    if bare_x != bare_y:
        raise TypeMismatchError(
            f"{kind} mixes a secret integer with a secret fixed-point "
            f"tensor (got {type(x).__name__} and {type(y).__name__})"
        )
    if kind != "Dot":  # contraction has its own shape rules
        x, y = _align_logical_ranks(x, y)
    if not bare_x:
        return _SECRET_BINOPS[kind](sess.spmd, _fixed(x, kind),
                                    _fixed(y, kind))
    if kind not in _INTEGER_BINOPS:
        raise NotImplementedError(
            "Div on secret uint64 is undefined (ring division)"
        )
    return _INTEGER_BINOPS[kind](sess.spmd, x, y)


def _sum(x: SpmdRep, axis) -> SpmdRep:
    if axis is None:
        x, axis = spmd.reshape(x, (math.prod(x.shape),)), 0
    return spmd.sum_axis(x, axis)


def _fx_sum(x: SpmdFixed, axis) -> SpmdFixed:
    return _fx(_sum(x.tensor, axis), x)


def _fx_mean(sess, x: SpmdFixed, axis) -> SpmdFixed:
    n = math.prod(x.tensor.shape) if axis is None else x.tensor.shape[axis]
    return spmd.fx_mul_public(sess.spmd, _fx_sum(x, axis), 1.0 / n)


def _relu(sess, x: SpmdFixed) -> SpmdFixed:
    s = sm.msb(sess.spmd, x.tensor)  # 1 <=> negative
    zeros = spmd.fill_public(x.tensor.shape, x.tensor.width, 0,
                             x.tensor.lo.device)
    return _fx(sm.mux_bit(sess.spmd, s, zeros, x.tensor), x)


def _abs(sess, x: SpmdFixed) -> SpmdFixed:
    s = sm.msb(sess.spmd, x.tensor)
    return _fx(sm.mux_bit(sess.spmd, s, spmd.neg(x.tensor), x.tensor), x)


_FX_MATH = {
    "Exp": sm.fx_exp,
    "Log": sm.fx_log,
    "Log2": sm.fx_log2,
    "Sqrt": sm.fx_sqrt,
    "Sigmoid": sm.fx_sigmoid,
}


def _constant(sess: StackedSession, op: Operation, rep):
    """A replicated Constant: built on the first owner as the host
    Constant, then shared (a shape or a string stays on the host)."""
    host_op = Operation(
        name=op.name, kind="Constant", inputs=[],
        placement_name=rep.owners[0], signature=op.signature,
        attributes=op.attributes,
    )
    h = logical._constant_on_host(sess.host, rep.owners[0], host_op)
    # public metadata (shapes, storage keys) is never shared
    return h if isinstance(h, (HostShape, HostString)) else to_rep(sess, h)


def _execute_rep(sess: StackedSession, comp, op: Operation,
                 rep: ReplicatedPlacement, args):
    kind = op.kind
    ret_dtype = op.signature.return_type.dtype
    attrs = op.attributes
    lift_width = _op_ring_width(op)

    def as_rep(v):
        return to_rep(sess, v, width=lift_width)

    def fixed(v):
        return _fixed(as_rep(v), kind)

    if kind == "Identity":
        return as_rep(args[0])

    if kind == "Constant":
        return _constant(sess, op, rep)

    if kind == "Conv2D":
        x, k = fixed(args[0]), fixed(args[1])
        if x.fractional_precision != k.fractional_precision:
            raise TypeMismatchError(
                "conv operands disagree on fractional precision: "
                f"{x.fractional_precision} vs {k.fractional_precision}"
            )
        return spmd.fx_conv2d(
            sess.spmd, x, k, strides=tuple(attrs.get("strides", (1, 1))),
            padding=attrs.get("padding", "VALID"),
        )

    if kind in ("AvgPool2D", "MaxPool2D"):
        strides = attrs.get("strides")
        fn = sm.fx_avg_pool2d if kind == "AvgPool2D" else sm.fx_max_pool2d
        return fn(sess.spmd, fixed(args[0]), tuple(attrs["pool_size"]),
                  None if strides is None else tuple(strides),
                  attrs.get("padding", "VALID"))

    if kind in _SECRET_BINOPS:
        x, y = args
        if kind in ("Add", "Sub", "Mul"):
            if isinstance(y, Mir3FixedTensor):
                return _public_binop(sess, fixed(x), y, kind, right=True)
            if isinstance(x, Mir3FixedTensor):
                return _public_binop(sess, fixed(y), x, kind, right=False)
        return _secret_binop(sess, kind, as_rep(x), as_rep(y))

    if kind == "AddN":
        vals = [as_rep(a) for a in args]
        out = vals[0]
        for v in vals[1:]:
            out = (spmd.add(out, v) if isinstance(out, SpmdRep)
                   else spmd.fx_add(_fixed(out, kind), _fixed(v, kind)))
        return out

    if kind == "Neg":
        return _on_inner(as_rep(args[0]), spmd.neg)

    if kind in ("Less", "Greater", "Equal"):
        x, y = _align_logical_ranks(as_rep(args[0]), as_rep(args[1]))
        fn = {"Less": sm.less, "Greater": sm.greater,
              "Equal": sm.equal_bit}[kind]
        return fn(sess.spmd, _inner(x, kind), _inner(y, kind))

    if kind in ("And", "Or", "Xor"):
        x = _bits(as_rep(args[0]), kind)
        y = _bits(as_rep(args[1]), kind)
        if kind == "Xor":
            return sm.bits_xor(x, y)
        fn = sm.bits_and if kind == "And" else sm.bits_or
        return fn(sess.spmd, x, y)

    if kind == "Mux":
        s, x, y = _align_logical_ranks(
            _bits(as_rep(args[0]), kind), as_rep(args[1]), as_rep(args[2]),
        )
        if isinstance(x, SpmdRep) and isinstance(y, SpmdRep):
            return sm.mux_bit(sess.spmd, s, x, y)
        x, y = _fixed(x, kind), _fixed(y, kind)
        return _fx(sm.mux_bit(sess.spmd, s, x.tensor, y.tensor), x)

    if kind in ("Sum", "Mean"):
        x = as_rep(args[0])
        if isinstance(x, SpmdRep):
            if kind == "Mean":
                raise TypeMismatchError(
                    "Mean on secret uint64 is undefined (ring division); "
                    "cast to a fixed dtype first"
                )
            return _sum(x, attrs.get("axis"))
        if kind == "Sum":
            return _fx_sum(_fixed(x, kind), attrs.get("axis"))
        return _fx_mean(sess, _fixed(x, kind), attrs.get("axis"))

    if kind in _FX_MATH:
        return _FX_MATH[kind](sess.spmd, fixed(args[0]))

    if kind == "Relu":
        return _relu(sess, fixed(args[0]))

    if kind == "Abs":
        return _abs(sess, fixed(args[0]))

    if kind == "Softmax":
        return sm.fx_softmax(sess.spmd, fixed(args[0]), attrs["axis"],
                             upmost_index=attrs.get("upmost_index"))

    if kind == "Argmax":
        return sm.fx_argmax(sess.spmd, fixed(args[0]), attrs["axis"],
                            upmost_index=attrs.get("upmost_index"))

    if kind == "Maximum":
        vals = [as_rep(a) for a in args]
        if isinstance(vals[0], SpmdRep):
            raise TypeMismatchError(
                "Maximum on secret uint64 needs a signed comparison "
                "convention; cast to a fixed dtype first"
            )
        return sm.fx_maximum(
            sess.spmd, _align_logical_ranks(*[_fixed(v, kind)
                                              for v in vals])
        )

    if kind == "Concat":
        vals = [as_rep(a) for a in args]
        axis = attrs.get("axis", 0)
        if isinstance(vals[0], SpmdRep):
            return spmd.concat(vals, axis)
        vals = [_fixed(v, kind) for v in vals]
        out = spmd.concat([v.tensor for v in vals], axis)
        return _fx(out, vals[0])

    if kind == "Reshape":
        shp = to_host(sess, rep.owners[0], args[1])
        return _on_inner(as_rep(args[0]),
                         lambda t: spmd.reshape(t, tuple(shp.value)))

    if kind == "ExpandDims":
        def expand(t):
            for a in sorted(attrs["axis"]):
                t = spmd.expand_dims(t, a)
            return t

        return _on_inner(as_rep(args[0]), expand)

    if kind == "Squeeze":
        return _on_inner(as_rep(args[0]),
                         lambda t: _squeeze(t, attrs.get("axis")))

    if kind == "Transpose":
        return _on_inner(as_rep(args[0]),
                         lambda t: spmd.transpose(t, attrs.get("axes")))

    if kind == "IndexAxis":
        return _on_inner(
            as_rep(args[0]),
            lambda t: spmd.index_axis(t, attrs["axis"], attrs["index"]),
        )

    if kind == "Slice":
        spec = logical.decode_slice_spec(attrs)
        return _on_inner(as_rep(args[0]),
                         lambda t: _strided_slice(t, spec))

    if kind == "Shape":
        x = as_rep(args[0])
        inner = x.tensor if isinstance(x, SpmdFixed) else x
        return HostShape(tuple(inner.shape), rep.owners[0])

    if kind == "Decrypt":
        return aes.decrypt_stacked(sess.spmd, op, args[0], args[1])

    if kind == "Cast":
        if ret_dtype is None or not ret_dtype.is_fixedpoint:
            raise TypeMismatchError(
                "stacked Cast on a replicated placement must target a "
                f"fixed-point dtype, got {ret_dtype}"
            )
        x = as_rep(args[0])
        new_f = ret_dtype.fractional_precision
        if isinstance(x, SpmdRep):
            # secret integer -> fixed: the scale-0 shares scaled by 2^f;
            # the lift above already took the target's ring, and a
            # sharing made at another width cannot be relabelled, so the
            # runtime reruns such a graph per-host
            target_w = 64 if ret_dtype.name == "fixed64" else 128
            if x.width != target_w:
                raise TypeMismatchError(
                    f"stacked Cast to {ret_dtype} needs a ring{target_w} "
                    f"sharing, got ring{x.width}"
                )
            t = spmd.shl(x, new_f) if new_f else x
            return SpmdFixed(t, ret_dtype.integral_precision, new_f)
        x = _fixed(x, kind)
        cur_f = x.fractional_precision
        t = x.tensor
        if new_f > cur_f:
            t = spmd.shl(t, new_f - cur_f)
        elif new_f < cur_f:
            t = spmd.trunc_pr(sess.spmd, t, cur_f - new_f)
        return SpmdFixed(t, ret_dtype.integral_precision, new_f)

    raise NotImplementedError(
        f"stacked replicated op {kind} ({op.name}; "
        f"{roadmap_item('ReplicatedPlacement', kind)})"
    )


# replicated kinds whose operands must agree on the value family: a
# secret integer (bare ring shares) against a secret fixed-point tensor
_MIXED_SENSITIVE_KINDS = frozenset({
    "Add", "Sub", "Mul", "Dot", "Div", "AddN", "Less", "Greater",
    "Equal", "Maximum", "Mux", "Concat",
})


def _rep_screen(op: Operation) -> bool:
    """The reference's signature screens of a replicated op: no float
    constant to share, a Cast only within the fixed family, no secret
    integer mixed with a secret fixed-point tensor."""
    sig = op.signature
    ret_dtype = sig.return_type.dtype if sig.return_type else None
    if op.kind == "Constant" and ret_dtype is not None \
            and ret_dtype.is_float:
        return False
    if op.kind == "Cast" and (ret_dtype is None
                              or not ret_dtype.is_fixedpoint):
        return False
    if op.kind in _MIXED_SENSITIVE_KINDS:
        dts = [ty.dtype for ty in (sig.return_type, *sig.input_types)
               if getattr(ty, "dtype", None) is not None]
        if any(d.is_integer for d in dts) and any(
                d.is_fixedpoint for d in dts):
            return False
    return True


def unsupported_ops(comp: Computation) -> list:
    """``(placement kind, op kind)`` of every op this layout does not
    run, by the reference's ``stacked.supports``: a replicated kind
    beyond :data:`REP_KINDS` or past its signature screens, Select (its
    shape depends on the data), and AES values on a host anywhere but at
    the boundary (Input, Output) and through Identity.  The runtime runs
    such a graph on the per-host layout, as the reference does."""
    missing = []
    for op in comp.operations.values():
        plc = comp.placements.get(op.placement_name)
        if op.kind in BOUNDARY_KINDS:
            continue
        if op.kind == "Select":
            ok = False
        elif isinstance(plc, ReplicatedPlacement):
            ok = op.kind in REP_KINDS and _rep_screen(op)
        elif isinstance(plc, HostPlacement):
            ok = op.kind in logical.HOST_KINDS and (
                op.kind == "Identity" or not any(
                    ty is not None and ty.name in AES_TY_NAMES
                    for ty in op.signature.input_types))
        elif isinstance(plc, Mirrored3Placement):
            ok = op.kind in logical.MIR_KINDS
        else:
            ok = False
        if not ok:
            missing.append((type(plc).__name__, op.kind))
    return missing


def effective_ops(comp: Computation) -> int:
    """The expanded program size of ``comp``, the JAX package's estimate:
    a stacked graph is short at the logical level, but a replicated
    nonlinear op expands to thousands of kernels, so each replicated op
    weighs ``logical.EXPANSION_WEIGHTS`` (20 by default) and any other 3.
    The plan autotuner sizes the stacked layout's segments from it."""
    total = 0
    for op in comp.operations.values():
        plc = comp.placements.get(op.placement_name)
        if isinstance(plc, ReplicatedPlacement):
            total += logical.EXPANSION_WEIGHTS.get(op.kind, 20)
        else:
            total += 3
    return total


def supports(comp: Computation) -> bool:
    """Whether every op of ``comp`` has a path in the port."""
    return not unsupported_ops(comp)


def bind_placements(sess, comp: Computation) -> None:
    """Dialect hook of the interpreter: this layout's values carry what
    their conversions need."""


def lift_aes_input(sess: StackedSession, comp, op, arr, plc_name: str,
                   device):
    """An AES boundary value of the stacked layout: a ciphertext stays a
    host bit tensor (shared at Decrypt); a replicated-placement key is
    shared where it is lifted, straight into the party-stacked bit
    layout, so its bit bank claims its nonce index at the Input op."""
    plc = comp.placements[plc_name]
    ret = op.signature.return_type
    if isinstance(plc, ReplicatedPlacement) and ret.name in (
            "AesKey", "ReplicatedAesKey"):
        return aes.StackedAesKey(
            sm.share_bits(sess.spmd, aes._input_bits(arr, device)))
    return aes.lift_input(sess.host, comp, op, arr, plc_name, device)


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


class StackedDialect:
    """The stacked layout as the interpreter's dialect: its ``mesh``
    (``spmd.make_mesh``, or None) reaches every session it makes."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def make_session(self, master_key, device,
                     key_domain: int = 0) -> StackedSession:
        return StackedSession(master_key, device, key_domain,
                              mesh=self.mesh)

    unsupported_ops = staticmethod(unsupported_ops)
    roadmap_item = staticmethod(roadmap_item)
    bind_placements = staticmethod(bind_placements)
    lift_aes_input = staticmethod(lift_aes_input)
    to_host = staticmethod(to_host)
    execute_op = staticmethod(execute_op)
