"""Stacked dialect: executes logical computations in the party-stacked
layout on one device.

PyTorch counterpart of ``moose_tpu/dialects/stacked.py``.  Replicated
tensors become ``SpmdRep``/``SpmdFixed``/``SpmdBits`` (one tensor with a
leading party axis); host and mirrored ops delegate to the logical
dialect.  The replicated kinds (:data:`REP_KINDS`) are the reference's
41, Decrypt (AES-GCM decryption under MPC, ``dialects/aes.py``) among
them.  Operands are secret fixed-point tensors, and bits where a kind
takes them; a secret integer (the scale-0 lift, item 6) is refused,
except the bare index tensor ``Argmax`` returns, which structural kinds
carry and which reveals to a ``HostRingTensor``.  AES values cross the
host boundary as the reference's stacked layout takes them
(:func:`lift_aes_input`).  :func:`unsupported_ops` lists what a graph
needs beyond that, and every refusal names its ROADMAP item.
"""

from __future__ import annotations

import math

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
    Mir3FixedTensor,
)
from . import aes, logical

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

# secret integers: the scale-0 lift
_INTEGER = "ROADMAP queue 1, item 6"


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
    raise TypeMismatchError(
        f"cannot share {type(v).__name__} in the port's stacked layout "
        f"(secret integers: {_INTEGER})"
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
    return a[(slice(None), slice(None)) + tuple(spec)]


_squeeze = spmd._structural(_squeeze_arr)
_strided_slice = spmd._structural(_slice_arr)


# ---------------------------------------------------------------------------
# Replicated-placement dispatch
# ---------------------------------------------------------------------------


def _fixed(v, kind: str) -> SpmdFixed:
    if not isinstance(v, SpmdFixed):
        later = f" (secret integers: {_INTEGER})" if isinstance(
            v, SpmdRep) else ""
        raise TypeMismatchError(
            f"stacked {kind} takes secret fixed-point tensors, got "
            f"{type(v).__name__}{later}"
        )
    return v


def _bits(v, kind: str) -> SpmdBits:
    if not isinstance(v, SpmdBits):
        raise TypeMismatchError(
            f"stacked {kind} takes shared bits, got {type(v).__name__}"
        )
    return v


def _fx(t: SpmdRep, like: SpmdFixed) -> SpmdFixed:
    return SpmdFixed(t, like.integral_precision, like.fractional_precision)


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
    """Elementwise operands (fixed-point or bits) broadcast by logical
    shape: the stacked tensors carry a (party, slot) prefix, so a
    lower-rank operand gets singleton logical axes after it, as
    broadcasting would prepend them to the logical shape."""
    ranks = [len(v.shape) if isinstance(v, SpmdBits) else len(v.tensor.shape)
             for v in vals]
    top = max(ranks)

    def lift(v, n):
        if n == 0:
            return v
        if isinstance(v, SpmdBits):
            a = v.arr
            return SpmdBits(a.reshape(a.shape[:2] + (1,) * n + a.shape[2:]))
        t = v.tensor
        return _fx(spmd.reshape(t, (1,) * n + t.shape), v)

    return tuple(lift(v, top - r) for v, r in zip(vals, ranks))


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

    def fixed(v):
        return _fixed(to_rep(sess, v), kind)

    if kind == "Identity":
        return to_rep(sess, args[0])

    if kind == "Constant":
        return _constant(sess, op, rep)

    if kind == "Dot":
        return spmd.fx_dot(sess.spmd, fixed(args[0]), fixed(args[1]))

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
        if isinstance(y, Mir3FixedTensor) and kind != "Div":
            return _public_binop(sess, fixed(x), y, kind, right=True)
        if isinstance(x, Mir3FixedTensor) and kind != "Div":
            return _public_binop(sess, fixed(y), x, kind, right=False)
        xr, yr = _align_logical_ranks(fixed(x), fixed(y))
        return _SECRET_BINOPS[kind](sess.spmd, xr, yr)

    if kind == "AddN":
        vals = [fixed(a) for a in args]
        out = vals[0]
        for v in vals[1:]:
            out = spmd.fx_add(out, v)
        return out

    if kind == "Neg":
        x = fixed(args[0])
        return _fx(spmd.neg(x.tensor), x)

    if kind in ("Less", "Greater", "Equal"):
        x, y = _align_logical_ranks(fixed(args[0]), fixed(args[1]))
        fn = {"Less": sm.less, "Greater": sm.greater,
              "Equal": sm.equal_bit}[kind]
        return fn(sess.spmd, x.tensor, y.tensor)

    if kind in ("And", "Or", "Xor"):
        x = _bits(to_rep(sess, args[0]), kind)
        y = _bits(to_rep(sess, args[1]), kind)
        if kind == "Xor":
            return sm.bits_xor(x, y)
        fn = sm.bits_and if kind == "And" else sm.bits_or
        return fn(sess.spmd, x, y)

    if kind == "Mux":
        s, x, y = _align_logical_ranks(
            _bits(to_rep(sess, args[0]), kind), fixed(args[1]),
            fixed(args[2]),
        )
        return _fx(sm.mux_bit(sess.spmd, s, x.tensor, y.tensor), x)

    if kind == "Sum":
        return _fx_sum(fixed(args[0]), attrs.get("axis"))

    if kind == "Mean":
        return _fx_mean(sess, fixed(args[0]), attrs.get("axis"))

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
        return sm.fx_maximum(
            sess.spmd, _align_logical_ranks(*[fixed(a) for a in args])
        )

    if kind == "Concat":
        vals = [fixed(a) for a in args]
        out = spmd.concat([v.tensor for v in vals], attrs.get("axis", 0))
        return _fx(out, vals[0])

    if kind == "Reshape":
        shp = to_host(sess, rep.owners[0], args[1])
        return _on_inner(to_rep(sess, args[0]),
                         lambda t: spmd.reshape(t, tuple(shp.value)))

    if kind == "ExpandDims":
        def expand(t):
            for a in sorted(attrs["axis"]):
                t = spmd.expand_dims(t, a)
            return t

        return _on_inner(to_rep(sess, args[0]), expand)

    if kind == "Squeeze":
        return _on_inner(to_rep(sess, args[0]),
                         lambda t: _squeeze(t, attrs.get("axis")))

    if kind == "Transpose":
        return _on_inner(to_rep(sess, args[0]),
                         lambda t: spmd.transpose(t, attrs.get("axes")))

    if kind == "IndexAxis":
        return _on_inner(
            to_rep(sess, args[0]),
            lambda t: spmd.index_axis(t, attrs["axis"], attrs["index"]),
        )

    if kind == "Slice":
        spec = logical.decode_slice_spec(attrs)
        return _on_inner(to_rep(sess, args[0]),
                         lambda t: _strided_slice(t, spec))

    if kind == "Shape":
        x = to_rep(sess, args[0])
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
        x = fixed(args[0])
        cur_f = x.fractional_precision
        new_f = ret_dtype.fractional_precision
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


def supports(comp: Computation) -> bool:
    """Whether every op of ``comp`` has a path in the port."""
    return not unsupported_ops(comp)


def make_session(master_key, device, key_domain: int = 0) -> StackedSession:
    """Dialect hook of the interpreter."""
    return StackedSession(master_key, device, key_domain)


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
        bits = torch.as_tensor(np.asarray(arr).astype(np.uint8),
                               device=device)
        return aes.StackedAesKey(sm.share_bits(sess.spmd, bits))
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
