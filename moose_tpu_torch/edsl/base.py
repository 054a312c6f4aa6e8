"""The moose_tpu eDSL: placement-annotated expressions traced from Python.

API-compatible re-design of the reference eDSL
(``pymoose/pymoose/edsl/base.py``): the same builder vocabulary and placement
context managers, but expressions are a single generic dataclass carrying
``(op, inputs, attributes, placement, vtype)`` instead of ~55 bespoke classes
— the operator vocabulary already lives in the IR
(``moose_tpu/computation.py``), so the eDSL stays a thin layer.

The port's own copy of ``moose_tpu/edsl/base.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import numpy as np

from .. import dtypes as dt
from .. import vtypes as ty

# ---------------------------------------------------------------------------
# Runtime registry (reference edsl/base.py:43-51)
# ---------------------------------------------------------------------------

_CURRENT_RUNTIME = None


def get_current_runtime():
    return _CURRENT_RUNTIME


def set_current_runtime(runtime):
    global _CURRENT_RUNTIME
    _CURRENT_RUNTIME = runtime


# ---------------------------------------------------------------------------
# Placement expressions & context stack (reference edsl/base.py:55-104)
# ---------------------------------------------------------------------------

_PLACEMENT_STACK: list["PlacementExpression"] = []


@dataclasses.dataclass
class PlacementExpression:
    name: str

    def __enter__(self):
        _PLACEMENT_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        _PLACEMENT_STACK.pop()


@dataclasses.dataclass
class HostPlacementExpression(PlacementExpression):
    def __hash__(self):
        return hash(("host", self.name))


@dataclasses.dataclass
class MirroredPlacementExpression(PlacementExpression):
    players: tuple = ()

    def __hash__(self):
        return hash(("mirrored", self.name))


@dataclasses.dataclass
class ReplicatedPlacementExpression(PlacementExpression):
    players: tuple = ()

    def __hash__(self):
        return hash(("replicated", self.name))


def host_placement(name: str) -> HostPlacementExpression:
    return HostPlacementExpression(name=name)


def mirrored_placement(name: str, players) -> MirroredPlacementExpression:
    players = tuple(players)
    assert len(players) == 3
    return MirroredPlacementExpression(name=name, players=players)


def replicated_placement(name: str, players) -> ReplicatedPlacementExpression:
    players = tuple(players)
    assert len(players) == 3
    return ReplicatedPlacementExpression(name=name, players=players)


def get_current_placement() -> PlacementExpression:
    if not _PLACEMENT_STACK:
        raise RuntimeError(
            "expected to be in a placement context; use `with plc:` or pass "
            "`placement=`"
        )
    return _PLACEMENT_STACK[-1]


def _materialize_placement_arg(plc) -> PlacementExpression:
    if plc is None:
        return get_current_placement()
    assert isinstance(plc, PlacementExpression), plc
    return plc


# ---------------------------------------------------------------------------
# Argument annotation (reference edsl/base.py:107-135)
# ---------------------------------------------------------------------------


class Argument:
    def __init__(self, placement, dtype=None, vtype=None):
        self.placement = placement
        self.dtype = dtype
        self.vtype = _maybe_lift_dtype_to_tensor_vtype(dtype, vtype)


def _maybe_lift_dtype_to_tensor_vtype(dtype, vtype):
    if dtype is None and vtype is None:
        return None
    if vtype is not None:
        if dtype is not None and isinstance(vtype, ty.TensorType):
            assert vtype.dtype == dtype
        return vtype
    if isinstance(dtype, dt.DType):
        return ty.TensorType(dtype)
    raise ValueError(f"unknown dtype {dtype!r}")


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Expression:
    """One eDSL node.  ``op`` names an IR operator kind; identity-based
    equality makes the traced graph a DAG exactly as the user built it."""

    op: str
    inputs: tuple
    attributes: dict
    placement: PlacementExpression
    vtype: Optional[ty.ValueType]

    def __hash__(self):
        return id(self)

    @property
    def dtype(self):
        if isinstance(self.vtype, (ty.TensorType, ty.AesTensorType)):
            return self.vtype.dtype
        return None

    # -- operator sugar (reference edsl/base.py:146-258) -------------------

    def __getitem__(self, slice_spec):
        # ShapeType slicing: shape[i:j] -> Sliced (reference base.py:170-187)
        if isinstance(self.vtype, ty.ShapeType):
            if isinstance(slice_spec, (tuple, list)):
                if len(slice_spec) != 2:
                    raise ValueError(
                        "Indexing ShapeType requires a simple slice with "
                        "only `start` & `stop` values."
                    )
                begin, end = slice_spec
            elif isinstance(slice_spec, slice):
                if slice_spec.step is not None:
                    raise ValueError(
                        "Indexing ShapeType requires a simple slice with "
                        "only `start` & `stop` values."
                    )
                begin, end = slice_spec.start, slice_spec.stop
            else:
                raise IndexError(
                    f"unsupported ShapeType slice spec {slice_spec!r}"
                )
            return sliced(self, begin, end, placement=self.placement)
        if isinstance(slice_spec, (slice, int, np.integer)) or (
            slice_spec is Ellipsis
        ):
            slice_spec = (slice_spec,)
        if isinstance(slice_spec, (tuple, list)) and all(
            isinstance(s, (slice, int, np.integer)) or s is Ellipsis
            for s in slice_spec
        ):
            spec = list(slice_spec)
            # integer indices: numpy semantics — select then drop the
            # axis.  Rewrite i -> slice(i, i+1) and squeeze the axis
            # afterwards; axes after an Ellipsis are counted from the end.
            int_axes = []
            ellipsis_at = next(
                (p for p, s in enumerate(spec) if s is Ellipsis), None
            )
            for p, s in enumerate(spec):
                if isinstance(s, (int, np.integer)):
                    i = int(s)
                    stop = i + 1 if i != -1 else None
                    spec[p] = slice(i, stop)
                    if ellipsis_at is not None and p > ellipsis_at:
                        int_axes.append(p - len(spec))
                    else:
                        int_axes.append(p)
            out = strided_slice(self, tuple(spec),
                                placement=self.placement)
            if int_axes:
                out = squeeze(out, axis=tuple(int_axes),
                              placement=self.placement)
            return out
        raise ValueError(f"unsupported slice spec {slice_spec!r}")

    def __neg__(self):
        if (
            isinstance(self.vtype, ty.TensorType)
            and not self.vtype.dtype.is_signed
        ):
            raise TypeError(
                f"Cannot negate Tensor of unsigned DType {self.vtype.dtype}."
            )
        return neg(self, placement=self.placement)

    def __abs__(self):
        if (
            isinstance(self.vtype, ty.TensorType)
            and not self.vtype.dtype.is_signed
        ):
            raise TypeError(
                "Cannot take absolute value of Tensor of unsigned DType "
                f"{self.vtype.dtype}."
            )
        return abs(self, placement=self.placement)

    def __add__(self, other):
        return add(self, _lift(other, self), placement=None)

    def __radd__(self, other):
        return add(_lift(other, self), self, placement=None)

    def __sub__(self, other):
        return sub(self, _lift(other, self), placement=None)

    def __rsub__(self, other):
        return sub(_lift(other, self), self, placement=None)

    def __mul__(self, other):
        return mul(self, _lift(other, self), placement=None)

    def __rmul__(self, other):
        return mul(_lift(other, self), self, placement=None)

    def __truediv__(self, other):
        return div(self, _lift(other, self), placement=None)

    def __rtruediv__(self, other):
        return div(_lift(other, self), self, placement=None)

    def __matmul__(self, other):
        return dot(self, other, placement=None)

    def __rmatmul__(self, other):
        return dot(other, self, placement=None)

    def __lt__(self, other):
        return less(self, _lift(other, self), placement=None)

    def __gt__(self, other):
        return greater(self, _lift(other, self), placement=None)

    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__
    __itruediv__ = __truediv__
    __imatmul__ = __matmul__


def _lift(value, like: Expression) -> Expression:
    if isinstance(value, Expression):
        return value
    return constant(value, dtype=like.dtype, placement=like.placement)


def _expr(op, inputs, attributes, placement, vtype) -> Expression:
    return Expression(
        op=op,
        inputs=tuple(inputs),
        attributes=dict(attributes),
        placement=placement,
        vtype=vtype,
    )


def _assimilate_dtypes(lhs: Expression, rhs: Expression, fn_name: str):
    lv, rv = lhs.vtype, rhs.vtype
    if isinstance(lv, ty.TensorType) and isinstance(rv, ty.TensorType):
        if lv.dtype != rv.dtype:
            raise ValueError(
                f"dtype mismatch in {fn_name}: {lv.dtype} vs {rv.dtype}"
            )
        return lv
    return lv if lv is not None else rv


# ---------------------------------------------------------------------------
# Builders (reference edsl/base.py:611-1770)
# ---------------------------------------------------------------------------


def identity(x, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Identity", [x], {}, placement, x.vtype)


def add_n(arrays, placement=None):
    placement = _materialize_placement_arg(placement)
    arrays = list(arrays)
    assert len(arrays) > 0
    return _expr("AddN", arrays, {}, placement, arrays[0].vtype)


def concatenate(arrays, axis=0, placement=None):
    placement = _materialize_placement_arg(placement)
    arrays = list(arrays)
    return _expr("Concat", arrays, {"axis": axis}, placement, arrays[0].vtype)


def maximum(arrays, placement=None):
    placement = _materialize_placement_arg(placement)
    arrays = list(arrays)
    return _expr("Maximum", arrays, {}, placement, arrays[0].vtype)


def decrypt(key, ciphertext, placement=None):
    placement = _materialize_placement_arg(placement)
    if not isinstance(key.vtype, ty.AesKeyType):
        raise ValueError(
            f"`key` expected to be of type AesKeyType, found {key.vtype}"
        )
    if not isinstance(ciphertext.vtype, ty.AesTensorType):
        raise ValueError(
            "`ciphertext` expected to be of type AesTensorType, found "
            f"{ciphertext.vtype}"
        )
    out = ty.TensorType(ciphertext.vtype.dtype)
    return _expr("Decrypt", [key, ciphertext], {}, placement, out)


def constant(value, dtype=None, vtype=None, placement=None):
    placement = _materialize_placement_arg(placement)
    vtype = _maybe_lift_dtype_to_tensor_vtype(dtype, vtype)
    value, vtype = _interpret_value(value, vtype)
    return _expr("Constant", [], {"value": value}, placement, vtype)


def _interpret_value(value, vtype):
    if isinstance(value, str):
        return value, vtype or ty.StringType()
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        if vtype is None:
            return value, ty.IntType()
        if isinstance(vtype, (ty.FloatType, ty.IntType)):
            return value, vtype
        return np.array(value), vtype
    if isinstance(value, (float, np.floating)):
        if vtype is None:
            return value, ty.FloatType()
        if isinstance(vtype, (ty.FloatType, ty.IntType)):
            return value, vtype
        return np.array(value), vtype
    if isinstance(value, bool):
        return np.array(value), vtype or ty.TensorType(dt.bool_)
    if isinstance(value, (list, tuple)):
        value = np.asarray(value)
    if isinstance(value, np.ndarray):
        if vtype is None:
            vtype = ty.TensorType(dt.from_numpy(value.dtype))
        return value, vtype
    raise ValueError(f"cannot interpret constant value {value!r}")


def _binary(op, lhs, rhs, placement, fn_name, vtype=None):
    placement = _materialize_placement_arg(placement)
    vtype = vtype or _assimilate_dtypes(lhs, rhs, fn_name)
    return _expr(op, [lhs, rhs], {}, placement, vtype)


def add(lhs, rhs, placement=None):
    return _binary("Add", lhs, rhs, placement, "add")


def sub(lhs, rhs, placement=None):
    return _binary("Sub", lhs, rhs, placement, "sub")


def mul(lhs, rhs, placement=None):
    return _binary("Mul", lhs, rhs, placement, "mul")


def dot(lhs, rhs, placement=None):
    return _binary("Dot", lhs, rhs, placement, "dot")


def conv2d(x, kernel, strides=(1, 1), padding="VALID", placement=None):
    """2-D convolution: NHWC input, HWIO kernel.  ``padding`` is "VALID",
    "SAME", or explicit ((top, bottom), (left, right)).  North-star
    extension (BASELINE.json: encrypted ResNet-style inference); the
    reference model zoo is Gemm-only."""
    placement = _materialize_placement_arg(placement)
    vtype = _assimilate_dtypes(x, kernel, "conv2d")
    if not isinstance(padding, str):
        padding = tuple(tuple(int(p) for p in side) for side in padding)
    return _expr(
        "Conv2D",
        [x, kernel],
        {"strides": tuple(int(s) for s in strides), "padding": padding},
        placement,
        vtype,
    )


def _pool2d(op, x, pool_size, strides, padding, placement):
    placement = _materialize_placement_arg(placement)
    if not isinstance(padding, str):
        padding = tuple(tuple(int(p) for p in side) for side in padding)
    attrs = {
        "pool_size": tuple(int(p) for p in pool_size),
        "padding": padding,
    }
    if strides is not None:
        attrs["strides"] = tuple(int(s) for s in strides)
    return _expr(op, [x], attrs, placement, x.vtype)


def avg_pool2d(x, pool_size, strides=None, padding="VALID", placement=None):
    """Average pooling over NHWC; strides default to the pool size.
    Padded windows divide by the full pool size (zeros included) — the
    equivalent of ONNX's count_include_pad=1."""
    return _pool2d("AvgPool2D", x, pool_size, strides, padding, placement)


def max_pool2d(x, pool_size, strides=None, padding="VALID", placement=None):
    """Max pooling over NHWC; strides default to the pool size.  On
    replicated placements zero padding is used, which equals the usual
    -inf padding whenever activations are non-negative (post-ReLU)."""
    return _pool2d("MaxPool2D", x, pool_size, strides, padding, placement)


def div(lhs, rhs, placement=None):
    return _binary("Div", lhs, rhs, placement, "div")


def less(lhs, rhs, placement=None):
    return _binary(
        "Less", lhs, rhs, placement, "less", vtype=ty.TensorType(dt.bool_)
    )


def greater(lhs, rhs, placement=None):
    return _binary(
        "Greater", lhs, rhs, placement, "greater",
        vtype=ty.TensorType(dt.bool_),
    )


def logical_and(lhs, rhs, placement=None):
    return _binary("And", lhs, rhs, placement, "logical_and")


def logical_or(lhs, rhs, placement=None):
    return _binary("Or", lhs, rhs, placement, "logical_or")


def logical_xor(lhs, rhs, placement=None):
    return _binary("Xor", lhs, rhs, placement, "logical_xor")


def equal(lhs, rhs, placement=None):
    return _binary(
        "Equal", lhs, rhs, placement, "equal", vtype=ty.TensorType(dt.bool_)
    )


def inverse(x, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Inverse", [x], {}, placement, x.vtype)


def neg(x, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Neg", [x], {}, placement, x.vtype)


def expand_dims(x, axis, placement=None):
    placement = _materialize_placement_arg(placement)
    if isinstance(axis, int):
        axis = [axis]
    return _expr("ExpandDims", [x], {"axis": list(axis)}, placement, x.vtype)


def squeeze(x, axis=None, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Squeeze", [x], {"axis": axis}, placement, x.vtype)


def ones(shape, dtype, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Ones", [shape], {}, placement, ty.TensorType(dtype))


def zeros(shape, dtype, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Zeros", [shape], {}, placement, ty.TensorType(dtype))


def square(x, placement=None):
    return mul(x, x, placement=placement)


def sum(x, axis=None, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Sum", [x], {"axis": axis}, placement, x.vtype)


def mean(x, axis=None, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Mean", [x], {"axis": axis}, placement, x.vtype)


def _unary(op, x, placement):
    placement = _materialize_placement_arg(placement)
    return _expr(op, [x], {}, placement, x.vtype)


def exp(x, placement=None):
    return _unary("Exp", x, placement)


def sqrt(x, placement=None):
    return _unary("Sqrt", x, placement)


def sigmoid(x, placement=None):
    return _unary("Sigmoid", x, placement)


def relu(x, placement=None):
    return _unary("Relu", x, placement)


def log(x, placement=None):
    return _unary("Log", x, placement)


def log2(x, placement=None):
    return _unary("Log2", x, placement)


def abs(x, placement=None):
    return _unary("Abs", x, placement)


def softmax(x, axis, upmost_index, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr(
        "Softmax",
        [x],
        {"axis": axis, "upmost_index": upmost_index},
        placement,
        x.vtype,
    )


def argmax(x, axis, upmost_index, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr(
        "Argmax",
        [x],
        {"axis": axis, "upmost_index": upmost_index},
        placement,
        ty.TensorType(dt.uint64),
    )


def shape(x, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Shape", [x], {}, placement, ty.ShapeType())


def index_axis(x, axis, index, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr(
        "IndexAxis", [x], {"axis": axis, "index": index}, placement, x.vtype
    )


def select(x, axis, index, placement=None):
    assert isinstance(x, Expression)
    assert isinstance(index, Expression)
    if not isinstance(axis, int):
        raise ValueError(f"`axis` must be an int, found {axis!r}")
    placement = _materialize_placement_arg(placement)
    return _expr("Select", [x, index], {"axis": axis}, placement, x.vtype)


def sliced(x, begin, end, placement=None):
    if not isinstance(begin, (int, type(None))) or not isinstance(
        end, (int, type(None))
    ):
        raise TypeError(
            f"slice bounds must be ints or None, found {begin!r}:{end!r}"
        )
    placement = _materialize_placement_arg(placement)
    return _expr("Slice", [x], {"begin": begin, "end": end}, placement, x.vtype)


def strided_slice(x, slices, placement=None):
    """Multi-axis slice.  Entries may be ``slice`` objects or ``Ellipsis``;
    Ellipsis is kept symbolic (encoded as ``"..."``) and expanded to the
    right number of full slices by the kernel, where the operand rank is
    known — rewriting it to a single ``slice(None)`` at trace time would
    silently shift later axes (e.g. ``x[..., 0:1]`` on rank 3)."""
    placement = _materialize_placement_arg(placement)
    spec = []
    for s in slices:
        if s is Ellipsis:
            spec.append("...")
        elif isinstance(s, slice):
            spec.append((s.start, s.stop, s.step))
        else:
            raise TypeError(f"unsupported slice entry {s!r}")
    if spec.count("...") > 1:
        raise ValueError("at most one Ellipsis is allowed in a slice spec")
    return _expr("Slice", [x], {"slices": tuple(spec)}, placement, x.vtype)


def transpose(x, axes=None, placement=None):
    """Transpose; ``axes=None`` reverses all axes (numpy semantics),
    otherwise a permutation like (0, 2, 3, 1)."""
    placement = _materialize_placement_arg(placement)
    attrs = {}
    if axes is not None:
        attrs["axes"] = tuple(int(a) for a in axes)
    return _expr("Transpose", [x], attrs, placement, x.vtype)


def atleast_2d(x, to_column_vector=False, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr(
        "AtLeast2D",
        [x],
        {"to_column_vector": to_column_vector},
        placement,
        x.vtype,
    )


def reshape(x, shape, placement=None):
    placement = _materialize_placement_arg(placement)
    if not isinstance(shape, Expression):
        shape = constant(
            np.asarray(shape, dtype=np.int64),
            vtype=ty.ShapeType(),
            placement=placement,
        )
    return _expr("Reshape", [x, shape], {}, placement, x.vtype)


def broadcast_to(x, shape, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Broadcast", [x, shape], {}, placement, x.vtype)


def mux(selector, x, y, placement=None):
    placement = _materialize_placement_arg(placement)
    if not isinstance(selector.vtype, ty.TensorType) or not (
        selector.vtype.dtype.is_boolean
    ):
        raise ValueError(
            f"`selector` must be a boolean tensor, found {selector.vtype}"
        )
    vtype = _assimilate_dtypes(x, y, "mux")
    return _expr("Mux", [selector, x, y], {}, placement, vtype)


def cast(x, dtype, placement=None):
    placement = _materialize_placement_arg(placement)
    assert isinstance(dtype, dt.DType)
    return _expr("Cast", [x], {}, placement, ty.TensorType(dtype))


def load(key, query="", dtype=None, vtype=None, placement=None):
    placement = _materialize_placement_arg(placement)
    vtype = _maybe_lift_dtype_to_tensor_vtype(dtype, vtype)
    if isinstance(key, str):
        key = constant(key, placement=placement)
    if isinstance(query, str):
        query = constant(query, placement=placement)
    return _expr("Load", [key, query], {}, placement, vtype)


def save(key, value, placement=None):
    placement = _materialize_placement_arg(placement)
    if isinstance(key, str):
        key = constant(key, placement=placement)
    return _expr("Save", [key, value], {}, placement, ty.UnitType())


def load_shares(key, shape, dtype, placement=None):
    """Reload a secret-shared tensor persisted with :func:`save_shares`.

    Placed on a replicated placement: lowering expands this into two
    ring-typed ``Load`` ops per party (each party reads back the share
    pair it saved from its OWN storage), reassembled as the replicated
    sharing — the value is never reconstructed in the clear anywhere.
    ``shape`` must be static (XLA) and ``dtype`` a fixed-point dtype;
    ``key`` must be a string constant so checkpoint keys stay stable
    across epochs (compiled-plan caches key on the computation bytes).
    """
    placement = _materialize_placement_arg(placement)
    if not isinstance(dtype, dt.DType) or not dtype.is_fixedpoint:
        raise ValueError(
            f"load_shares requires a fixed-point dtype, found {dtype!r}"
        )
    if isinstance(key, str):
        key = constant(key, placement=placement)
    return _expr(
        "LoadShares",
        [key],
        {"shape": tuple(int(s) for s in shape)},
        placement,
        ty.TensorType(dtype),
    )


def save_shares(key, value, placement=None):
    """Durably persist a replicated value AS SHARES: lowering expands
    this into two ring-typed ``Save`` ops per party, so each party
    writes exactly the share pair it already holds to its own storage
    and no party (or the client) ever sees the plaintext.  The inverse
    of :func:`load_shares`; the training checkpoint protocol
    (``moose_tpu.training``) builds on this pair."""
    placement = _materialize_placement_arg(placement)
    if isinstance(key, str):
        key = constant(key, placement=placement)
    return _expr("SaveShares", [key, value], {}, placement, ty.UnitType())


def output(tag, value, placement=None):
    placement = _materialize_placement_arg(placement)
    return _expr("Output", [value], {"tag": tag}, placement, value.vtype)


# ---------------------------------------------------------------------------
# @computation (reference edsl/base.py:1773-1877)
# ---------------------------------------------------------------------------


class AbstractComputation:
    def __init__(self, func, role_map=None):
        self.func = func
        self.role_map = role_map

    def with_role_map(self, role_map):
        roles = {
            (k.name if isinstance(k, PlacementExpression) else k): (
                v.name if isinstance(v, PlacementExpression) else v
            )
            for k, v in role_map.items()
        }
        return AbstractComputation(self.func, roles)

    def __call__(self, *args, **kwargs):
        runtime = get_current_runtime()
        if runtime is None:
            raise RuntimeError(
                "no default runtime; call runtime.set_default() first"
            )
        import inspect

        params = list(inspect.signature(self.func).parameters)
        arguments = dict(zip(params, args))
        arguments.update(kwargs)
        return runtime.evaluate_computation(self, arguments=arguments)


def computation(func=None, role_map=None):
    if func is None:
        return lambda f: computation(f, role_map=role_map)
    return AbstractComputation(func, role_map)
