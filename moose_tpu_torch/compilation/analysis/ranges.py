"""Fixed-point value-range & overflow analysis (rule family ``MSA7xx``).

An abstract interpreter over the logical (and, partially, the lowered)
op vocabulary that propagates a per-value interval + fractional-
precision fact through the fixed/ring op algebra: ``fx_mul``/``fx_dot``
double the fractional bits before ``trunc_pr`` restores them, dot
products and reductions accumulate ``log2(k)`` extra bits, and
``trunc_pr`` itself carries a probabilistic ±1 LSB error — so a value
whose magnitude drifts past the ring's integer headroom wraps silently
in Z_{2^width} with no runtime error anywhere.  This module makes that
failure a *compile-time* diagnostic.

The lattice
-----------

Each value gets a :class:`RangeFact`: a real-space interval
``[lo, hi]`` (decoded, i.e. raw/2^f), the fixed-point encoding
(``integral``/``frac``/``width``), a shape (for dot/reduce accumulation
counts), and a ``declared`` flag.  ``declared`` is the load-bearing
bit: it is True only when the bounds derive *solely* from declared
facts — caller-supplied arg ranges, literal constants, or structural
output bounds (sigmoid ∈ [0, 1], comparison bits ∈ {0, 1}).  Unknown
inputs unify to the encoding's representable interval ``[-2^i, 2^i]``
with ``declared=False``; anything computed from such a value keeps
``declared=False``.

Severity policy: the representable interval of a *wide* encoding can
structurally exceed the pre-truncation bound (the shipped
fixed(24, 40) on ring128 does: 2·64 > 125) while every value that
actually flows through the graph is tiny — that configuration works in
production and must keep linting clean.  So **MSA701/MSA702 only ever
fire on declared chains**: intervals an operator *asserted*, where
overflow is a provable specification bug rather than a pessimistic
worst case.  Undeclared chains still contribute to the MSA704 report
(marked ``declared: false``) so the planner sees the structural demand.

Rules
-----

- ``MSA701`` (error): a declared interval provably exceeds the ring's
  integer headroom at some op — guaranteed wraparound for in-spec
  inputs.  The message carries the per-op bit-growth chain.
- ``MSA702`` (warning): a declared chain's headroom margin falls below
  a configurable bit threshold (default 2 bits — e.g. a dot over k
  rows leaving <2 bits of slack).
- ``MSA703`` (warning): a polynomial/comparison input interval exits
  the approximation's valid domain (sigmoid/exp/pow2 exponent range,
  log/sqrt positivity, division by an interval containing zero,
  comparison difference wrap) — the result is garbage even without
  ring overflow.
- ``MSA704`` (info): per-computation precision summary; the full
  per-value report is :func:`range_report`, which also feeds
  ``cost_report()`` so the planner can later pick ring64 vs ring128.

Soundness caveats (also in DEVELOP.md):

- ``trunc_pr`` carries a probabilistic ±1 LSB error; every truncating
  op widens its result interval by at least one ulp (2^-f), and the
  nonlinear protocols (sigmoid/exp/div/sqrt/...) by a generous
  approximation slack, so the dynamic-range oracle test's measured
  values stay inside the static interval.
- On **lowered** graphs, every value that touches a PRF sample
  (``Sample``/``SampleSeeded`` — i.e. every secret share and mask) is
  uniformly random in Z_{2^width}; such values carry a ``uniform``
  fact and are exempt from overflow judgment (a share wrapping is the
  protocol working, not a bug).  The lowered-level analysis therefore
  only judges plaintext host fixed chains; the logical level is where
  the value semantics live.
- Comparison protocols require the *difference* of the operands not to
  wrap; MSA703 checks that, but only when both operand intervals are
  known.

The port's own copy of
``moose_tpu/compilation/analysis/ranges.py``: pure graph and numpy
code, it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import dtypes as dt
from ...computation import Computation, Operation
from .cost import _dot_shape, _reduce_shape, _slice_shape
from .diagnostics import Diagnostic, Severity

__all__ = [
    "DEFAULT_MARGIN_BITS",
    "RangeFact",
    "analyze_ranges",
    "infer_ranges",
    "range_report",
]

# MSA702 fires when a declared chain leaves fewer spare bits than this
# (prancer --margin-bits / MOOSE_TPU_LINT_MARGIN_BITS override).
DEFAULT_MARGIN_BITS = 2

# trunc_pr error is ±1 LSB per truncation; we widen every truncating
# result by a few ulps so accumulated probabilistic error over a chain
# of truncs stays inside the interval.
_TRUNC_SLACK_ULPS = 4.0
# the iterative protocols (sigmoid's single-division form, Goldschmidt
# div, sqrt via 2^(log2/2), pow2's polynomial) run several truncating
# rounds; their outputs get a generous absolute + relative slack.
_APPROX_SLACK_ULPS = 64.0
_APPROX_REL_SLACK = 2.0 ** -10


def _margin_bits(override: Optional[float] = None) -> float:
    if override is not None:
        return float(override)
    env = os.environ.get("MOOSE_TPU_LINT_MARGIN_BITS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return float(DEFAULT_MARGIN_BITS)


@dataclasses.dataclass(frozen=True)
class RangeFact:
    """Abstract value: real-space interval + fixed-point encoding.

    ``kind``: ``fixed`` (encoded tensor — logical fixed dtype or a
    host/replicated/mirrored fixed type), ``float``/``int`` (plaintext
    numerics), ``bit`` (0/1 lanes), ``uniform`` (lowered-graph share or
    mask: uniformly random ring element, exempt from judgment), or
    ``other`` (units, strings, keys, ...).

    ``lo``/``hi`` are decoded real bounds (``None`` = unknown).
    ``declared`` marks bounds derived solely from declared facts; only
    declared chains can raise MSA701/702.  ``shape`` feeds dot/reduce
    accumulation counts."""

    kind: str = "other"
    lo: Optional[float] = None
    hi: Optional[float] = None
    integral: Optional[int] = None
    frac: Optional[int] = None
    width: Optional[int] = None
    declared: bool = False
    shape: Optional[Tuple[int, ...]] = None
    # peak intermediate demand in raw bits at the op that produced this
    # value (e.g. a dot's pre-trunc accumulation at 2f fractional bits)
    # — what ring-width planning has to provision for, as opposed to
    # raw_bits() which is only the *stored* result's magnitude
    pre_bits: Optional[float] = None

    @property
    def bounded(self) -> bool:
        return self.lo is not None and self.hi is not None

    @property
    def max_abs(self) -> Optional[float]:
        if not self.bounded:
            return None
        return max(abs(float(self.lo)), abs(float(self.hi)))

    def raw_bits(self) -> Optional[float]:
        """Magnitude of the encoded value in bits: log2(max|v| · 2^f)."""
        if self.max_abs is None or self.frac is None:
            return None
        raw = self.max_abs * (2.0 ** self.frac)
        return math.log2(raw) if raw > 0 else 0.0


_TOP = RangeFact()
_UNIFORM = RangeFact(kind="uniform")


def _is_fixed_ty(ty: Any) -> bool:
    if ty.dtype is not None and ty.dtype.is_fixedpoint:
        return True
    return "Fixed" in ty.name


def _fixed_params(ty: Any) -> Tuple[int, int, int]:
    """(integral, frac, width) of a fixed-typed value."""
    d = ty.dtype
    if d is not None and d.is_fixedpoint:
        width = 64 if d.name == "fixed64" else 128
        return int(d.integral_precision), int(d.fractional_precision), width
    # fixed container type without a dtype (defensive)
    width = 64 if "64" in ty.name else 128
    return width // 4, width // 2, width


def _is_bit_ty(ty: Any) -> bool:
    if "Bit" in ty.name:
        return True
    return ty.dtype is not None and ty.dtype.name == "bool"


def _representable(i: int, f: int, width: int) -> RangeFact:
    """The encoding's representable interval — the unknown-input seed."""
    bound = float(2.0 ** i)
    return RangeFact(
        kind="fixed", lo=-bound, hi=bound, integral=i, frac=f,
        width=width, declared=False,
    )


def _widen(
    fact: RangeFact, ulps: float = _TRUNC_SLACK_ULPS, rel: float = 0.0
) -> RangeFact:
    """Pad a fact's interval for trunc_pr / approximation error."""
    if not fact.bounded or fact.frac is None:
        return fact
    pad = ulps * (2.0 ** -fact.frac)
    lo = float(fact.lo) - pad - abs(float(fact.lo)) * rel
    hi = float(fact.hi) + pad + abs(float(fact.hi)) * rel
    return dataclasses.replace(fact, lo=lo, hi=hi)


def _interval_mul(a: RangeFact, b: RangeFact) -> Tuple[
    Optional[float], Optional[float]
]:
    if not (a.bounded and b.bounded):
        return None, None
    prods = [
        float(a.lo) * float(b.lo), float(a.lo) * float(b.hi),
        float(a.hi) * float(b.lo), float(a.hi) * float(b.hi),
    ]
    return min(prods), max(prods)


def _contraction_len(
    a_shape: Optional[Tuple[int, ...]], b_shape: Optional[Tuple[int, ...]]
) -> Optional[int]:
    if a_shape is not None and len(a_shape) >= 1:
        return int(a_shape[-1])
    if b_shape is not None and len(b_shape) >= 1:
        return int(b_shape[0])
    return None


def _reduced_count(
    shape: Optional[Tuple[int, ...]], axis: Any
) -> Optional[int]:
    if shape is None:
        return None
    if axis is None:
        return int(np.prod(shape)) if shape else 1
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    try:
        axes = tuple(int(a) % len(shape) for a in axes)
    except (ValueError, ZeroDivisionError):
        return None
    return int(np.prod([shape[a] for a in axes])) if axes else 1


# ---------------------------------------------------------------------------
# seeds: arg ranges, constants, loads
# ---------------------------------------------------------------------------


def _normalize_arg_specs(
    arg_specs: Optional[Dict[str, Any]]
) -> Dict[str, Tuple[int, ...]]:
    """The compiler's ``arg_specs`` convention ({name: shape} or
    {name: (shape, np_dtype)}) reduced to {name: shape}."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, raw in (arg_specs or {}).items():
        shape: Any = raw
        if (
            isinstance(raw, tuple) and len(raw) == 2
            and isinstance(raw[0], (tuple, list))
        ):
            shape = raw[0]
        try:
            shapes[name] = tuple(int(d) for d in shape)
        except (TypeError, ValueError):
            continue
    return shapes


def _range_for(
    op: Operation,
    comp: Computation,
    arg_ranges: Dict[str, Tuple[float, float]],
    facts: Dict[str, RangeFact],
) -> Optional[Tuple[float, float]]:
    """A declared [lo, hi] for an Input/Load/LoadShares op: matched by
    op name, by ``arg_name`` attribute, or (for keyed loads) by the
    storage key string."""
    for candidate in (op.name, op.attributes.get("arg_name")):
        if candidate in arg_ranges:
            return arg_ranges[str(candidate)]
    key = op.attributes.get("key")
    if key is None and op.inputs:
        key_op = comp.operations.get(op.inputs[0])
        if key_op is not None and key_op.kind == "Constant":
            key = key_op.attributes.get("value")
    if isinstance(key, str) and key in arg_ranges:
        return arg_ranges[key]
    return None


def _const_fact(op: Operation) -> RangeFact:
    ret = op.signature.return_type
    value = op.attributes.get("value")
    if isinstance(value, str) or value is None:
        return _TOP
    try:
        arr = np.asarray(value, dtype=np.float64)
        lo, hi = float(arr.min()), float(arr.max())
        shape = tuple(int(d) for d in np.asarray(value).shape)
    except (TypeError, ValueError):
        return _TOP
    kind = "float"
    if ret.dtype is not None and not ret.dtype.is_fixedpoint:
        if ret.dtype.name.startswith(("int", "uint")):
            kind = "int"
        elif ret.dtype.name == "bool":
            kind = "bit"
    return RangeFact(kind=kind, lo=lo, hi=hi, declared=True, shape=shape)


# ---------------------------------------------------------------------------
# the transfer function
# ---------------------------------------------------------------------------


_PASSTHROUGH_KINDS = frozenset({
    "Identity", "Output", "Transpose", "Reshape", "ExpandDims",
    "Squeeze", "IndexAxis", "Slice", "Broadcast", "AtLeast2D", "Diag",
})

# nonlinear protocols whose outputs get approximation slack
_UNIT_KINDS = frozenset({"Save", "SaveShares", "Send"})


def _passthrough_shape(
    op: Operation, fact: RangeFact
) -> Optional[Tuple[int, ...]]:
    A = op.attributes
    shape = fact.shape
    kind = op.kind
    if kind in ("Identity", "Output"):
        return shape
    if kind == "Transpose":
        if shape is None:
            return None
        axes = A.get("axes")
        if axes is None:
            return tuple(reversed(shape))
        return tuple(shape[int(a)] for a in axes)
    if kind == "ExpandDims":
        if shape is None:
            return None
        axis = A.get("axis", 0)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        out = list(shape)
        for ax in sorted(int(a) for a in axes):
            out.insert(ax if ax >= 0 else len(out) + ax + 1, 1)
        return tuple(out)
    if kind == "Squeeze":
        if shape is None:
            return None
        axis = A.get("axis")
        if axis is None:
            return tuple(d for d in shape if d != 1)
        axes = {
            int(a) % len(shape)
            for a in ((axis,) if isinstance(axis, int) else axis)
        }
        return tuple(d for i, d in enumerate(shape) if i not in axes)
    if kind == "IndexAxis":
        return _reduce_shape(shape, A.get("axis", 0))
    if kind == "Slice":
        return _slice_shape(shape, op)
    if kind == "AtLeast2D":
        if shape is None:
            return None
        if len(shape) >= 2:
            return shape
        n = shape[0] if shape else 1
        return (n, 1) if A.get("to_column_vector") else (1, n)
    if kind == "Diag":
        if shape is None:
            return None
        if len(shape) == 1:
            return (shape[0], shape[0])
        return (min(shape[0], shape[1]),)
    # Reshape/Broadcast need the shape operand; resolved by caller
    return None


class _Analyzer:
    """One pass over ``comp`` in topological order; collects facts and
    diagnostics."""

    def __init__(
        self,
        comp: Computation,
        arg_specs: Optional[Dict[str, Any]],
        arg_ranges: Optional[Dict[str, Tuple[float, float]]],
        margin_bits: Optional[float],
    ) -> None:
        self.comp = comp
        self.arg_shapes = _normalize_arg_specs(arg_specs)
        self.arg_ranges = {
            str(k): (float(lo), float(hi))
            for k, (lo, hi) in (arg_ranges or {}).items()
        }
        self.margin = _margin_bits(margin_bits)
        self.facts: Dict[str, RangeFact] = {}
        self.diagnostics: List[Diagnostic] = []
        # op name -> one-line bit-growth note, for MSA701's chain
        self.notes: Dict[str, str] = {}
        # op name -> the input op the note chains back through
        self.parents: Dict[str, Optional[str]] = {}
        self._flagged: set[str] = set()

    # -- chain rendering ---------------------------------------------------

    def _chain(self, name: str, depth: int = 8) -> str:
        lines: List[str] = []
        cursor: Optional[str] = name
        while cursor is not None and depth > 0:
            note = self.notes.get(cursor)
            if note is None:
                break
            lines.append(f"    {note}")
            cursor = self.parents.get(cursor)
            depth -= 1
        return "\n".join(lines)

    def _note(
        self, op: Operation, fact: RangeFact, detail: str = ""
    ) -> None:
        bits = fact.raw_bits()
        parent: Optional[str] = None
        best = -1.0
        for inp in op.inputs:
            f = self.facts.get(inp)
            if f is None:
                continue
            b = f.raw_bits()
            if b is not None and b > best and inp in self.notes:
                best, parent = b, inp
        self.parents[op.name] = parent
        desc = f"{op.name} ({op.kind})"
        if fact.max_abs is not None:
            desc += f": |v| <= {fact.max_abs:.6g}"
        if bits is not None:
            desc += f", raw {bits:.1f} bits"
        if detail:
            desc += f" [{detail}]"
        self.notes[op.name] = desc

    # -- overflow / margin judgment ---------------------------------------

    def _judge(
        self,
        op: Operation,
        fact: RangeFact,
        pre_trunc_bits: Optional[float],
        budget_bits: Optional[int],
        what: str,
    ) -> None:
        """MSA701/702 on a declared chain whose raw demand approaches or
        exceeds the ring budget."""
        if (
            pre_trunc_bits is None or budget_bits is None
            or not fact.declared or op.name in self._flagged
        ):
            return
        if pre_trunc_bits > budget_bits:
            self._flagged.add(op.name)
            self.diagnostics.append(Diagnostic(
                "MSA701", Severity.ERROR,
                f"guaranteed ring overflow: {what} at {op.name!r} needs "
                f"{pre_trunc_bits:.1f} raw bits but the ring{fact.width} "
                f"budget is {budget_bits} bits — values in the declared "
                f"ranges wrap in Z_2^{fact.width}; bit-growth chain:\n"
                + self._chain(op.name),
                op=op.name, placement=op.placement_name,
            ))
        elif budget_bits - pre_trunc_bits < self.margin:
            self._flagged.add(op.name)
            self.diagnostics.append(Diagnostic(
                "MSA702", Severity.WARNING,
                f"thin headroom: {what} at {op.name!r} needs "
                f"{pre_trunc_bits:.1f} of {budget_bits} raw bits — only "
                f"{budget_bits - pre_trunc_bits:.1f} bits of margin left "
                f"(threshold {self.margin:g}); bit-growth chain:\n"
                + self._chain(op.name),
                op=op.name, placement=op.placement_name,
            ))

    def _domain(self, op: Operation, message: str) -> None:
        self.diagnostics.append(Diagnostic(
            "MSA703", Severity.WARNING, message,
            op=op.name, placement=op.placement_name,
        ))

    # -- the walk ----------------------------------------------------------

    def run(self) -> None:
        try:
            order = self.comp.toposort_names()
        except ValueError:
            # broken dataflow edge (unknown input / cycle): MSA304 owns
            # the report; range facts are simply unavailable
            return
        for name in order:
            op = self.comp.operations[name]
            fact = self._transfer(op)
            self.facts[name] = fact
            if fact.kind == "fixed":
                self._note(op, fact)

    def _args(self, op: Operation) -> List[RangeFact]:
        return [self.facts.get(i, _TOP) for i in op.inputs]

    def _fixed_out(
        self,
        op: Operation,
        lo: Optional[float],
        hi: Optional[float],
        declared: bool,
        shape: Optional[Tuple[int, ...]],
    ) -> RangeFact:
        """A fixed-typed result; unknown bounds fall back to the
        encoding's representable interval."""
        i, f, width = _fixed_params(op.signature.return_type)
        if lo is None or hi is None:
            rep = _representable(i, f, width)
            return dataclasses.replace(rep, shape=shape)
        return RangeFact(
            kind="fixed", lo=lo, hi=hi, integral=i, frac=f, width=width,
            declared=declared, shape=shape,
        )

    def _transfer(self, op: Operation) -> RangeFact:  # noqa: C901 — the
        # op-vocabulary switch is long but flat, like cost._spec_for
        kind = op.kind
        A = op.attributes
        ret = op.signature.return_type
        args = self._args(op)

        if kind in _UNIT_KINDS or ret.name == "Unit":
            return _TOP
        if kind == "Constant":
            fact = _const_fact(op)
            if _is_fixed_ty(ret) and fact.bounded:
                return self._fixed_out(
                    op, fact.lo, fact.hi, True, fact.shape
                )
            return fact
        if kind == "Input" or kind == "Load":
            declared_range = _range_for(
                op, self.comp, self.arg_ranges, self.facts
            )
            shape = self.arg_shapes.get(op.name) or self.arg_shapes.get(
                str(A.get("arg_name"))
            )
            if _is_fixed_ty(ret):
                if declared_range is not None:
                    return self._fixed_out(
                        op, declared_range[0], declared_range[1], True,
                        shape,
                    )
                return self._fixed_out(op, None, None, False, shape)
            lo, hi = (
                declared_range if declared_range is not None
                else (None, None)
            )
            return RangeFact(
                kind="float", lo=lo, hi=hi,
                declared=declared_range is not None, shape=shape,
            )
        if kind == "LoadShares":
            declared_range = _range_for(
                op, self.comp, self.arg_ranges, self.facts
            )
            shape = A.get("shape")
            shape = (
                tuple(int(d) for d in shape) if shape is not None else None
            )
            if declared_range is not None:
                return self._fixed_out(
                    op, declared_range[0], declared_range[1], True, shape
                )
            return self._fixed_out(op, None, None, False, shape)

        # lowered-graph PRF samples: shares and masks are uniform ring
        # elements — exempt from judgment, and they poison everything
        # they touch (see module docstring).
        if kind in ("Sample", "SampleSeeded"):
            return _UNIFORM
        if any(a.kind == "uniform" for a in args):
            return _UNIFORM

        if kind in _PASSTHROUGH_KINDS:
            base = args[0] if args else _TOP
            if kind in ("Reshape", "Broadcast"):
                return dataclasses.replace(base, shape=None)
            return dataclasses.replace(
                base, shape=_passthrough_shape(op, base)
            )
        if kind == "Cast":
            return self._cast(op, args, ret)
        if kind in ("Add", "Sub", "AddN"):
            return self._add_like(op, args)
        if kind == "Neg":
            base = args[0] if args else _TOP
            if not base.bounded:
                return base
            return dataclasses.replace(
                base, lo=-float(base.hi), hi=-float(base.lo)
            )
        if kind == "Abs":
            base = args[0] if args else _TOP
            if not base.bounded:
                return base
            lo = (
                0.0 if float(base.lo) <= 0.0 <= float(base.hi)
                else min(abs(float(base.lo)), abs(float(base.hi)))
            )
            return _widen(dataclasses.replace(
                base, lo=lo, hi=float(base.max_abs or 0.0)
            ))
        if kind == "Relu":
            base = args[0] if args else _TOP
            if not base.bounded:
                return base
            return _widen(dataclasses.replace(
                base, lo=max(0.0, float(base.lo)),
                hi=max(0.0, float(base.hi)),
            ))
        if kind == "Sign":
            base = args[0] if args else _TOP
            return dataclasses.replace(
                base, lo=-1.0, hi=1.0, declared=True
            )
        if kind == "Mul":
            return self._mul(op, args)
        if kind == "Dot":
            return self._dot(op, args)
        if kind in ("Sum", "Mean", "RingFixedpointMean"):
            return self._reduce(op, args)
        if kind == "Concat":
            return self._union(op, args, concat=True)
        if kind in ("Maximum", "Mux"):
            operands = args if kind == "Maximum" else args[1:]
            return self._union(op, operands)
        if kind in ("Sigmoid", "Softmax"):
            return self._sigmoid_like(op, args)
        if kind in ("Exp", "Pow2"):
            return self._exp_like(op, args)
        if kind in ("Log", "Log2", "Sqrt"):
            return self._log_like(op, args)
        if kind in ("Div", "Inverse"):
            return self._div_like(op, args)
        if kind in ("Less", "Greater", "Equal", "EqualZero"):
            return self._compare(op, args)
        if kind in ("Argmax", "RingFixedpointArgmax"):
            base = args[0] if args else _TOP
            shape = _reduce_shape(base.shape, A.get("axis"))
            n = _reduced_count(base.shape, A.get("axis"))
            hi = float(n - 1) if n else None
            return RangeFact(
                kind="int", lo=0.0 if n else None, hi=hi,
                declared=n is not None, shape=shape,
            )
        if kind == "RingFixedpointEncode":
            base = args[0] if args else _TOP
            i, f, width = _fixed_params(ret) if _is_fixed_ty(ret) else (
                None, None, None
            )
            frac = A.get("fractional_precision", f)
            if frac is None or not base.bounded:
                return _TOP
            return RangeFact(
                kind="fixed", lo=base.lo, hi=base.hi,
                integral=A.get("integral_precision", i),
                frac=int(frac), width=width or 64,
                declared=base.declared, shape=base.shape,
            )
        if kind in ("RingFixedpointDecode", "FixedpointDecode"):
            base = args[0] if args else _TOP
            return RangeFact(
                kind="float", lo=base.lo, hi=base.hi,
                declared=base.declared, shape=base.shape,
            )
        if kind == "TruncPr":
            base = args[0] if args else _TOP
            amount = A.get("amount")
            if base.kind != "fixed" or amount is None:
                return _TOP
            frac = (base.frac or 0) - int(amount)
            return _widen(dataclasses.replace(base, frac=frac))
        if kind == "Reveal":
            return args[0] if args else _TOP
        # everything else (AES, bit-level protocol ops, Shape, Select,
        # conv/pool, Receive, ...) degrades to top — sound, reported as
        # unknown in MSA704's report
        return _TOP

    # -- per-family transfers ---------------------------------------------

    def _cast(
        self, op: Operation, args: List[RangeFact], ret: Any
    ) -> RangeFact:
        base = args[0] if args else _TOP
        if _is_fixed_ty(ret):
            i, f, width = _fixed_params(ret)
            if base.bounded:
                # encoding quantizes to the grid (half-ulp) — and a
                # declared range that exceeds the representable
                # interval wraps at encode time already
                fact = _widen(
                    self._fixed_out(
                        op, base.lo, base.hi, base.declared, base.shape
                    ),
                    ulps=1.0,
                )
                if (
                    base.declared
                    and (fact.max_abs or 0.0) >= float(2.0 ** i)
                ):
                    self._note(op, fact, f"encode into fixed({i},{f})")
                    self._judge(
                        op, fact, fact.raw_bits(), i + f,
                        f"encoding into fixed({i},{f})",
                    )
                return fact
            return self._fixed_out(op, None, None, False, base.shape)
        # fixed -> float (or float -> float): interval survives
        return RangeFact(
            kind="float", lo=base.lo, hi=base.hi,
            declared=base.declared, shape=base.shape,
        )

    def _add_like(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        numeric = [a for a in args if a.kind in ("fixed", "float", "int")]
        if not numeric:
            return _TOP
        shape = None
        for a in numeric:
            if a.shape is not None:
                shape = a.shape
                break
        if not all(a.bounded for a in numeric):
            if any(a.kind == "fixed" for a in numeric):
                return self._fixed_out(op, None, None, False, shape)
            return RangeFact(kind="float", shape=shape)
        if op.kind == "Sub":
            lo = float(numeric[0].lo) - float(numeric[1].hi)
            hi = float(numeric[0].hi) - float(numeric[1].lo)
        else:
            lo = sum(float(a.lo) for a in numeric)
            hi = sum(float(a.hi) for a in numeric)
        declared = all(a.declared for a in numeric)
        if any(a.kind == "fixed" for a in numeric):
            fact = self._fixed_out(op, lo, hi, declared, shape)
            self._note(op, fact)
            # additions stay in the ring un-truncated: the raw result
            # must fit the signed ring, 2^{width-1}
            if fact.width is not None:
                self._judge(
                    op, fact, fact.raw_bits(),
                    int(fact.width) - 1, f"{op.kind.lower()} result",
                )
            return fact
        return RangeFact(
            kind=numeric[0].kind, lo=lo, hi=hi, declared=declared,
            shape=shape,
        )

    def _mul(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        a = args[0] if args else _TOP
        b = args[1] if len(args) > 1 else _TOP
        lo, hi = _interval_mul(a, b)
        declared = a.declared and b.declared
        shape = a.shape if a.shape is not None else b.shape
        if not any(x.kind == "fixed" for x in (a, b)):
            return RangeFact(
                kind="float", lo=lo, hi=hi, declared=declared, shape=shape
            )
        fact = _widen(self._fixed_out(op, lo, hi, declared, shape))
        # fx_mul: ring product at 2f fractional bits, then trunc_pr(f);
        # the pre-trunc raw magnitude must satisfy |x| < 2^{width-3}
        if (
            fact.width is not None and fact.frac is not None
            and a.max_abs is not None and b.max_abs is not None
        ):
            raw = a.max_abs * b.max_abs * (2.0 ** (2 * fact.frac))
            pre = math.log2(raw) if raw > 0 else 0.0
            self._note(
                op, fact,
                f"pre-trunc product at 2f={2 * fact.frac} frac bits: "
                f"{pre:.1f} bits",
            )
            self._judge(
                op, fact, pre, int(fact.width) - 3, "pre-trunc product"
            )
            fact = dataclasses.replace(fact, pre_bits=pre)
        else:
            self._note(op, fact)
        return fact

    def _dot(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        a = args[0] if args else _TOP
        b = args[1] if len(args) > 1 else _TOP
        shape = _dot_shape(a.shape, b.shape)
        k = _contraction_len(a.shape, b.shape)
        declared = a.declared and b.declared
        if (
            k is None or a.max_abs is None or b.max_abs is None
        ):
            if any(x.kind == "fixed" for x in (a, b)):
                # magnitude bound needs the contraction length; without
                # a shape the result is only representable-bounded
                return self._fixed_out(op, None, None, False, shape)
            return RangeFact(kind="float", shape=shape)
        bound = float(k) * a.max_abs * b.max_abs
        if not any(x.kind == "fixed" for x in (a, b)):
            return RangeFact(
                kind="float", lo=-bound, hi=bound, declared=declared,
                shape=shape,
            )
        fact = _widen(
            self._fixed_out(op, -bound, bound, declared, shape),
            ulps=_TRUNC_SLACK_ULPS + float(k),
        )
        if fact.width is not None and fact.frac is not None:
            raw = bound * (2.0 ** (2 * fact.frac))
            pre = math.log2(raw) if raw > 0 else 0.0
            self._note(
                op, fact,
                f"dot over k={k}: +{math.log2(k):.1f} bits accumulation "
                f"at 2f={2 * fact.frac} frac bits -> {pre:.1f} bits "
                f"pre-trunc",
            )
            self._judge(
                op, fact, pre, int(fact.width) - 3,
                f"pre-trunc dot accumulation (k={k})",
            )
            fact = dataclasses.replace(fact, pre_bits=pre)
        return fact

    def _reduce(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        base = args[0] if args else _TOP
        axis = op.attributes.get("axis")
        shape = _reduce_shape(base.shape, axis)
        k = _reduced_count(base.shape, axis)
        if base.max_abs is None or k is None:
            if base.kind == "fixed":
                return self._fixed_out(op, None, None, False, shape)
            return RangeFact(kind=base.kind or "float", shape=shape)
        if op.kind == "Sum":
            lo = float(k) * min(0.0, float(base.lo))
            hi = float(k) * max(0.0, float(base.hi))
            if base.kind != "fixed":
                return RangeFact(
                    kind=base.kind, lo=lo, hi=hi,
                    declared=base.declared, shape=shape,
                )
            fact = self._fixed_out(op, lo, hi, base.declared, shape)
            self._note(
                op, fact,
                f"sum over k={k}: +{math.log2(max(k, 1)):.1f} bits",
            )
            # fx sum is a raw ring sum (no trunc): fits iff < 2^{width-1}
            if fact.width is not None:
                self._judge(
                    op, fact, fact.raw_bits(), int(fact.width) - 1,
                    f"sum accumulation (k={k})",
                )
            return fact
        # Mean: sum, multiply by encoded 1/k, trunc — the mean itself
        # stays inside the operand hull; pre-trunc raw magnitude is the
        # sum at ~2f fractional bits
        lo, hi = float(base.lo), float(base.hi)
        if base.kind != "fixed":
            return RangeFact(
                kind=base.kind, lo=lo, hi=hi, declared=base.declared,
                shape=shape,
            )
        fact = _widen(self._fixed_out(op, lo, hi, base.declared, shape))
        if fact.width is not None and fact.frac is not None:
            raw = (
                float(base.max_abs) * (2.0 ** (2 * fact.frac))
            )
            pre = math.log2(raw) if raw > 0 else 0.0
            self._note(op, fact, f"mean over k={k}")
            self._judge(
                op, fact, pre, int(fact.width) - 3, "pre-trunc mean"
            )
            fact = dataclasses.replace(fact, pre_bits=pre)
        return fact

    def _union(
        self, op: Operation, args: List[RangeFact], concat: bool = False
    ) -> RangeFact:
        numeric = [a for a in args if a.kind in ("fixed", "float", "int")]
        if not numeric:
            return _TOP
        shape: Optional[Tuple[int, ...]] = None
        if concat:
            shapes = [a.shape for a in numeric]
            if all(s is not None for s in shapes):
                try:
                    axis = int(op.attributes.get("axis", 0) or 0)
                    first = list(shapes[0])  # type: ignore[arg-type]
                    axis %= len(first)
                    first[axis] = sum(
                        int(s[axis]) for s in shapes  # type: ignore[index]
                    )
                    shape = tuple(first)
                except (IndexError, ZeroDivisionError, TypeError):
                    # ragged/scalar operand ranks: the interval union
                    # below is still sound, only the shape is unknown
                    shape = None
        else:
            shape = numeric[0].shape
        if not all(a.bounded for a in numeric):
            if any(a.kind == "fixed" for a in numeric):
                return self._fixed_out(op, None, None, False, shape)
            return RangeFact(kind="float", shape=shape)
        lo = min(float(a.lo) for a in numeric)
        hi = max(float(a.hi) for a in numeric)
        declared = all(a.declared for a in numeric)
        if any(a.kind == "fixed" for a in numeric):
            return self._fixed_out(op, lo, hi, declared, shape)
        return RangeFact(
            kind=numeric[0].kind, lo=lo, hi=hi, declared=declared,
            shape=shape,
        )

    def _sigmoid_like(
        self, op: Operation, args: List[RangeFact]
    ) -> RangeFact:
        base = args[0] if args else _TOP
        fact = self._fixed_out(op, 0.0, 1.0, True, base.shape)
        if not _is_fixed_ty(op.signature.return_type):
            return RangeFact(
                kind="float", lo=0.0, hi=1.0, declared=True,
                shape=base.shape,
            )
        # sigmoid computes y = 2^{|z| log2 e}; the intermediate power
        # must stay representable: |z| * log2(e) <= i - 1.  softmax
        # clamps its own input internally (see dialects/fixedpoint.py),
        # so only sigmoid gets the domain check.  Declared intervals
        # only: the *representable* interval always exceeds the domain,
        # and an unproven domain is MSA704-report territory, not a
        # warning on every graph.
        if (
            op.kind == "Sigmoid" and base.kind == "fixed"
            and base.declared
            and base.max_abs is not None and fact.integral is not None
        ):
            limit = (float(fact.integral) - 1.0) / math.log2(math.e)
            if base.max_abs > limit:
                self._domain(
                    op,
                    f"sigmoid input interval |x| <= {base.max_abs:.6g} "
                    f"exits the approximation domain |x| <= {limit:.4g} "
                    f"for fixed({fact.integral},{fact.frac}) — the "
                    f"2^|x| intermediate overflows and the result is "
                    f"garbage",
                )
        return _widen(fact, ulps=_APPROX_SLACK_ULPS)

    def _exp_like(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        base = args[0] if args else _TOP
        ret = op.signature.return_type
        i, f, width = (
            _fixed_params(ret) if _is_fixed_ty(ret) else (None, None, None)
        )
        scale = math.log2(math.e) if op.kind == "Exp" else 1.0
        lo = hi = None
        declared = False
        if base.bounded:
            declared = base.declared
            grow = math.exp if op.kind == "Exp" else (
                lambda v: 2.0 ** v  # noqa: E731 — tiny local map
            )
            try:
                lo, hi = grow(float(base.lo)), grow(float(base.hi))
            except OverflowError:
                lo = hi = None
            if (
                base.kind == "fixed" and base.declared and i is not None
                and float(base.hi) * scale > float(i) - 1.0
            ):
                self._domain(
                    op,
                    f"{op.kind.lower()} input reaches "
                    f"{float(base.hi):.6g}; the exponent "
                    f"{float(base.hi) * scale:.4g} exceeds the "
                    f"representable power {i - 1} of fixed({i},{f}) — "
                    f"the result saturates to garbage",
                )
                lo = hi = None  # beyond-domain growth isn't meaningful
            if not declared:
                # exp of the representable interval is not a useful
                # bound; fall back to the representable interval
                lo = hi = None
        if not _is_fixed_ty(ret):
            return RangeFact(
                kind="float", lo=lo, hi=hi, declared=declared,
                shape=base.shape,
            )
        return _widen(
            self._fixed_out(op, lo, hi, declared, base.shape),
            ulps=_APPROX_SLACK_ULPS, rel=_APPROX_REL_SLACK,
        )

    def _log_like(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        base = args[0] if args else _TOP
        ret = op.signature.return_type
        fn = {
            "Log": math.log, "Log2": math.log2, "Sqrt": math.sqrt,
        }[op.kind]
        lo = hi = None
        declared = False
        if base.bounded:
            if float(base.lo) <= 0.0:
                if base.declared:
                    self._domain(
                        op,
                        f"{op.kind.lower()} input interval "
                        f"[{float(base.lo):.6g}, {float(base.hi):.6g}] "
                        f"includes non-positive values — outside the "
                        f"protocol's domain (requires x > 0)",
                    )
            else:
                declared = base.declared
                lo, hi = fn(float(base.lo)), fn(float(base.hi))
        if not _is_fixed_ty(ret):
            return RangeFact(
                kind="float", lo=lo, hi=hi, declared=declared,
                shape=base.shape,
            )
        return _widen(
            self._fixed_out(op, lo, hi, declared, base.shape),
            ulps=_APPROX_SLACK_ULPS, rel=_APPROX_REL_SLACK,
        )

    def _div_like(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        if op.kind == "Inverse":
            num = RangeFact(kind="float", lo=1.0, hi=1.0, declared=True)
            den = args[0] if args else _TOP
        else:
            num = args[0] if args else _TOP
            den = args[1] if len(args) > 1 else _TOP
        ret = op.signature.return_type
        lo = hi = None
        declared = False
        if den.bounded and float(den.lo) <= 0.0 <= float(den.hi):
            if den.declared:
                self._domain(
                    op,
                    f"divisor interval [{float(den.lo):.6g}, "
                    f"{float(den.hi):.6g}] contains zero — the "
                    f"Goldschmidt reciprocal diverges on this domain",
                )
        elif num.bounded and den.bounded:
            declared = num.declared and den.declared
            min_den = min(abs(float(den.lo)), abs(float(den.hi)))
            if min_den > 0.0:
                bound = float(num.max_abs or 0.0) / min_den
                lo, hi = -bound, bound
        if not _is_fixed_ty(ret):
            return RangeFact(
                kind="float", lo=lo, hi=hi, declared=declared,
                shape=num.shape if num.shape is not None else den.shape,
            )
        return _widen(
            self._fixed_out(
                op, lo, hi, declared,
                num.shape if num.shape is not None else den.shape,
            ),
            ulps=_APPROX_SLACK_ULPS, rel=_APPROX_REL_SLACK,
        )

    def _compare(self, op: Operation, args: List[RangeFact]) -> RangeFact:
        a = args[0] if args else _TOP
        b = args[1] if len(args) > 1 else RangeFact(
            kind="int", lo=0.0, hi=0.0, declared=True
        )
        # the msb-based comparison protocols need the operand
        # difference not to wrap: |a - b| raw < 2^{width-1}
        if (
            op.kind != "EqualZero" and a.kind == "fixed"
            and a.bounded and b.bounded and a.frac is not None
            and a.width is not None and a.declared and b.declared
        ):
            spread = max(
                abs(float(a.hi) - float(b.lo)),
                abs(float(b.hi) - float(a.lo)),
            )
            raw = spread * (2.0 ** a.frac)
            if raw >= 2.0 ** (int(a.width) - 1):
                self._domain(
                    op,
                    f"comparison operand spread {spread:.6g} wraps the "
                    f"ring{a.width} difference (needs "
                    f"{math.log2(raw) if raw > 0 else 0:.1f} raw bits "
                    f"of {int(a.width) - 1}) — the sign of a wrapped "
                    f"difference is meaningless",
                )
        shape = a.shape if a.shape is not None else b.shape
        return RangeFact(
            kind="bit", lo=0.0, hi=1.0, declared=True, shape=shape
        )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def infer_ranges(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
    arg_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
) -> Dict[str, RangeFact]:
    """Per-op :class:`RangeFact`s (no diagnostics).  ``arg_specs`` pins
    Input/Load shapes (compiler convention); ``arg_ranges`` declares
    real-space ``{input name or storage key: (lo, hi)}`` bounds."""
    an = _Analyzer(comp, arg_specs, arg_ranges, None)
    an.run()
    return an.facts


def analyze_ranges(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
    arg_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    margin_bits: Optional[float] = None,
) -> List[Diagnostic]:
    """MSA7xx entry point registered with :func:`analysis.analyze`."""
    an = _Analyzer(comp, arg_specs, arg_ranges, margin_bits)
    an.run()
    diagnostics = an.diagnostics
    summary = _summarize(comp, an.facts)
    if summary is not None:
        peak_op, peak_bits, width, n_fixed, n_declared = summary
        min_width = _min_ring_width(peak_bits)
        diagnostics.append(Diagnostic(
            "MSA704", Severity.INFO,
            f"range report: {n_fixed} fixed-point value(s), "
            f"{n_declared} with declared bounds; peak demand "
            f"{peak_bits:.1f} raw bits of {width - 3} available at "
            f"{peak_op!r}; minimal ring width {min_width} "
            f"(full report: prancer --ranges / range_report())",
            op=peak_op,
            placement=comp.operations[peak_op].placement_name,
        ))
    return diagnostics


def _min_ring_width(peak_bits: float) -> int:
    # the pre-trunc bound is |x| < 2^{width-3}
    return 64 if peak_bits <= 61.0 else 128


def _summarize(
    comp: Computation, facts: Dict[str, RangeFact]
) -> Optional[Tuple[str, float, int, int, int]]:
    peak_op: Optional[str] = None
    peak_bits = -1.0
    width = 64
    n_fixed = 0
    n_declared = 0
    for name, fact in facts.items():
        if fact.kind != "fixed":
            continue
        n_fixed += 1
        if fact.declared:
            n_declared += 1
        bits = fact.raw_bits()
        # demand is the op's peak intermediate (pre-trunc accumulation)
        # when it has one, else the stored result's magnitude
        if fact.pre_bits is not None:
            bits = max(bits or 0.0, fact.pre_bits)
        if bits is not None and bits > peak_bits:
            peak_bits = bits
            peak_op = name
            width = int(fact.width or 64)
    if peak_op is None:
        return None
    return peak_op, peak_bits, width, n_fixed, n_declared


def range_report(
    comp: Computation,
    arg_specs: Optional[Dict[str, Any]] = None,
    arg_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
) -> Dict[str, Any]:
    """The machine-readable per-value precision report (MSA704's data):
    one record per fixed-point value plus a summary block — the input
    the planner needs to choose ring64 vs ring128 per computation
    (ROADMAP item 4), surfaced through ``prancer --ranges`` and
    ``cost_report(..., arg_ranges=)``."""
    facts = infer_ranges(comp, arg_specs, arg_ranges)
    values: Dict[str, Any] = {}
    for name in sorted(facts):
        fact = facts[name]
        if fact.kind not in ("fixed", "uniform"):
            continue
        record: Dict[str, Any] = {
            "kind": fact.kind,
            "declared": fact.declared,
        }
        if fact.kind == "fixed":
            record.update({
                "lo": fact.lo, "hi": fact.hi,
                "integral": fact.integral, "frac": fact.frac,
                "width": fact.width, "raw_bits": fact.raw_bits(),
                "pre_trunc_bits": fact.pre_bits,
                "shape": (
                    list(fact.shape) if fact.shape is not None else None
                ),
            })
        values[name] = record
    summary = _summarize(comp, facts)
    report: Dict[str, Any] = {"values": values}
    if summary is not None:
        peak_op, peak_bits, width, n_fixed, n_declared = summary
        report["summary"] = {
            "fixed_values": n_fixed,
            "declared_values": n_declared,
            "peak_raw_bits": peak_bits,
            "peak_op": peak_op,
            "ring_width": width,
            "min_ring_width": _min_ring_width(peak_bits),
        }
    else:
        report["summary"] = {
            "fixed_values": 0, "declared_values": 0,
            "peak_raw_bits": None, "peak_op": None,
            "ring_width": None, "min_ring_width": None,
        }
    return report


RULES = {
    "MSA701": "guaranteed ring overflow: a declared value interval "
              "provably exceeds the ring's integer headroom",
    "MSA702": "thin headroom: a declared chain's overflow margin is "
              "below the configured bit threshold",
    "MSA703": "approximation domain exit: a polynomial/comparison "
              "input interval leaves the protocol's valid domain",
    "MSA704": "per-value precision report (planner input for ring64 "
              "vs ring128 selection)",
}
