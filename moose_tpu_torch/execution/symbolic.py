"""SymbolicSession: the compiler half of the session duality.

The port of ``moose_tpu/execution/symbolic.py`` (the reference's
``moose/src/execution/symbolic.rs:139-200``): the protocol kernels of
``dialects/`` are written once against the session surface, and lowering
is running them with a session that records host-level operations into a
new ``Computation`` instead of executing them.

Symbolic values reuse the concrete value dataclasses (``HostRingTensor``,
``HostBitTensor``, ...) so the dialects' isinstance checks, ``.width``,
``.plc`` and ``.shape`` work unchanged; only the payloads are
:class:`SymArray` handles naming the producing operation.  Shapes are
inferred with numpy's shape rules on zero-stride dummies, so the
session holds no tensor and needs no device.

The eager session fuses three protocol steps into one call each (a
product's per-party cross terms, K3 or K1 on the card, and the
truncation's tail, K2).  Here the cross-term methods record the JAX
package's composition, op for op and in Python's evaluation order, and
``fused_trunc = False`` makes ``replicated.trunc_pr`` run the reference's
composition ``adt_to_rep(additive.trunc_pr(rep_to_adt(x)))``: the
lowered graph is the JAX package's, op name for op name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import dtypes as dt
from ..computation import (
    Computation,
    HostPlacement,
    Operation,
    Signature,
    Ty,
)
from ..errors import CompilationError, TypeMismatchError
from ..values import (
    HostBitTensor,
    HostFixedTensor,
    HostPrfKey,
    HostRingTensor,
    HostSeed,
    HostShape,
    HostString,
    HostTensor,
    HostUnit,
)


class SymArray:
    """Array payload of a symbolic value: names the producing op and tracks
    the static shape."""

    __slots__ = ("op", "_shape")

    def __init__(self, op: str, shape: Optional[tuple]):
        self.op = op
        self._shape = None if shape is None else tuple(int(d) for d in shape)

    @property
    def shape(self) -> tuple:
        if self._shape is None:
            raise CompilationError(
                f"shape of symbolic value {self.op!r} is data-dependent "
                "(produced by Select) and cannot be used at lowering time"
            )
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return f"SymArray({self.op!r}, {self._shape})"


@dataclasses.dataclass
class SymShape(HostShape):
    """A shape value during lowering: concrete tuple + optional producing
    op (materialized lazily as a Constant when used as an op input)."""

    op: Optional[str] = None


def _dummy(shape: tuple):
    """Zero-stride dummy array for numpy shape-rule inference (no
    allocation)."""
    return np.broadcast_to(np.int8(0), tuple(shape))


def _dot_shape(sa: tuple, sb: tuple) -> tuple:
    la, lb = len(sa), len(sb)
    if la == 2 and lb == 2:
        return (sa[0], sb[1])
    if la == 2 and lb == 1:
        return (sa[0],)
    if la == 1 and lb == 2:
        return (sb[1],)
    if la == 1 and lb == 1:
        return ()
    raise CompilationError(f"dot on ranks {la} x {lb} not supported")


def _reduce_shape(shape: tuple, axis) -> tuple:
    if axis is None:
        return ()
    return tuple(d for i, d in enumerate(shape) if i != axis % len(shape))


def _tensor_ty(dtype: dt.DType) -> Ty:
    if dtype.is_boolean:
        return Ty("HostBitTensor", dt.bool_)
    name = {
        "float32": "HostFloat32Tensor",
        "float64": "HostFloat64Tensor",
        "int32": "HostInt32Tensor",
        "int64": "HostInt64Tensor",
        "uint32": "HostUint32Tensor",
        "uint64": "HostUint64Tensor",
    }[dtype.name]
    return Ty(name, dtype)


def _ring_ty(width: int) -> Ty:
    return Ty(f"HostRing{width}Tensor")


_BIT_TY = Ty("HostBitTensor", dt.bool_)
_SHAPE_TY = Ty("HostShape")
_SEED_TY = Ty("HostSeed")
_KEY_TY = Ty("HostPrfKey")
_STRING_TY = Ty("HostString")
_UNIT_TY = Ty("Unit")


def _ty_of(v) -> Ty:
    if isinstance(v, HostRingTensor):
        return _ring_ty(v.width)
    if isinstance(v, HostBitTensor):
        return _BIT_TY
    if isinstance(v, HostTensor):
        return _tensor_ty(v.dtype)
    if isinstance(v, HostShape):
        return _SHAPE_TY
    if isinstance(v, HostSeed):
        return _SEED_TY
    if isinstance(v, HostPrfKey):
        return _KEY_TY
    if isinstance(v, HostString):
        return _STRING_TY
    if isinstance(v, HostUnit):
        return _UNIT_TY
    raise TypeMismatchError(f"no Ty for {type(v).__name__}")


class SymbolicSession:
    """Records host-level operations into ``self.computation``.

    Implements the :class:`EagerSession` method surface; the dialect code
    (replicated, additive, mirrored, fixedpoint, logical, aes) runs
    unchanged on top and its host-primitive calls become graph nodes.
    """

    # replicated.trunc_pr runs the reference's composition, whose ops the
    # lowered graph records, not the eager session's fused tail
    fused_trunc = False

    def __init__(self, computation: Optional[Computation] = None):
        self.computation = computation or Computation()
        self._counter = 0
        self._setup_cache: dict = {}
        self._const_cache: dict = {}
        self._placements = self.computation.placements

    # ------------------------------------------------------------------
    # Graph construction
    # ------------------------------------------------------------------

    def fresh_name(self, prefix: str = "op") -> str:
        name = f"{prefix}_{self._counter}"
        self._counter += 1
        return name

    def _ensure_host_placement(self, plc: str):
        if plc not in self.computation.placements:
            self.computation.add_placement(HostPlacement(plc))

    def add_operation(
        self,
        kind: str,
        inputs: list,
        plc: str,
        sig: Signature,
        attributes: Optional[dict] = None,
        name: Optional[str] = None,
    ) -> str:
        self._ensure_host_placement(plc)
        name = name or self.fresh_name()
        self.computation.add_operation(
            Operation(
                name=name,
                kind=kind,
                inputs=list(inputs),
                placement_name=plc,
                signature=sig,
                attributes=attributes or {},
            )
        )
        return name

    def _name_of(self, v) -> str:
        """The producing op of a symbolic value, materializing constants
        lazily for shapes/strings."""
        if isinstance(v, HostRingTensor):
            return v.lo.op
        if isinstance(v, (HostTensor, HostBitTensor, HostSeed, HostPrfKey)):
            return v.value.op
        if isinstance(v, SymShape):
            if v.op is not None:
                return v.op
            return self._shape_const(v.value, v.plc)
        if isinstance(v, HostShape):
            return self._shape_const(v.value, v.plc)
        if isinstance(v, HostString):
            known = getattr(v, "op", None)
            return known or self._string_const(v.value, v.plc)
        raise TypeMismatchError(
            f"cannot use {type(v).__name__} as a symbolic op input"
        )

    def _shape_const(self, value: tuple, plc: str) -> str:
        key = ("shape", tuple(value), plc)
        cached = self._const_cache.get(key)
        if cached is None:
            cached = self.add_operation(
                "Constant", [], plc,
                Signature((), _SHAPE_TY),
                {"value": tuple(int(d) for d in value)},
            )
            self._const_cache[key] = cached
        return cached

    def _string_const(self, value: str, plc: str) -> str:
        key = ("string", value, plc)
        cached = self._const_cache.get(key)
        if cached is None:
            cached = self.add_operation(
                "Constant", [], plc,
                Signature((), _STRING_TY),
                {"value": value},
            )
            self._const_cache[key] = cached
        return cached

    def _emit(self, kind, args, plc, ret_ty, attributes=None, name=None):
        inputs = [self._name_of(a) for a in args]
        sig = Signature(tuple(_ty_of(a) for a in args), ret_ty)
        return self.add_operation(kind, inputs, plc, sig, attributes, name)

    # Typed output constructors ----------------------------------------

    def _ring(self, op: str, shape, width: int, plc: str) -> HostRingTensor:
        lo = SymArray(op, shape)
        hi = SymArray(op, shape) if width == 128 else None
        return HostRingTensor(lo, hi, width, plc)

    def _bit(self, op: str, shape, plc: str) -> HostBitTensor:
        return HostBitTensor(SymArray(op, shape), plc)

    def _tensor(self, op: str, shape, plc: str, dtype: dt.DType):
        return HostTensor(SymArray(op, shape), plc, dtype)

    def _like(self, op: str, shape, x, plc: Optional[str] = None):
        """Output value of the same leaf kind as ``x`` with a new shape."""
        plc = plc or x.plc
        if isinstance(x, HostRingTensor):
            return self._ring(op, shape, x.width, plc)
        if isinstance(x, HostBitTensor):
            return self._bit(op, shape, plc)
        if isinstance(x, HostPrfKey):
            return HostPrfKey(SymArray(op, shape), plc)
        if isinstance(x, HostSeed):
            return HostSeed(SymArray(op, shape), plc)
        return self._tensor(op, shape, plc, x.dtype)

    # ------------------------------------------------------------------
    # Setup cache (same protocol as EagerSession)
    # ------------------------------------------------------------------

    def replicated_setup(self, rep_plc):
        from ..dialects import replicated

        cache_key = (rep_plc.name, rep_plc.owners)
        cached = self._setup_cache.get(cache_key)
        if cached is None:
            cached = replicated.gen_setup(self, rep_plc)
            self._setup_cache[cache_key] = cached
        return cached

    # ------------------------------------------------------------------
    # PRF keys & seeds
    # ------------------------------------------------------------------

    def key_gen(self, plc: str) -> HostPrfKey:
        op = self._emit("PrfKeyGen", [], plc, _KEY_TY)
        return HostPrfKey(SymArray(op, (4,)), plc)

    def derive_seed(self, plc, key, sync_key: bytes) -> HostSeed:
        op = self._emit(
            "DeriveSeed", [key], plc, _SEED_TY, {"sync_key": sync_key}
        )
        return HostSeed(SymArray(op, (4,)), plc)

    def sample_uniform_seeded(self, plc, shp, seed, width: int):
        op = self._emit(
            "SampleSeeded", [shp, seed], plc, _ring_ty(width), {}
        )
        return self._ring(op, tuple(shp.value), width, plc)

    def sample_bits_seeded(self, plc, shp, seed, width: int):
        op = self._emit(
            "SampleSeeded", [shp, seed], plc, _ring_ty(width),
            {"max_value": 1},
        )
        return self._ring(op, tuple(shp.value), width, plc)

    def sample_bit_tensor_seeded(self, plc, shp, seed):
        op = self._emit(
            "SampleSeeded", [shp, seed], plc, _BIT_TY, {"max_value": 1}
        )
        return self._bit(op, tuple(shp.value), plc)

    # ------------------------------------------------------------------
    # Value movement
    # ------------------------------------------------------------------

    def place(self, plc: str, x):
        if getattr(x, "plc", plc) == plc:
            return x
        if isinstance(x, HostShape):
            return SymShape(x.value, plc, getattr(x, "op", None))
        if isinstance(x, HostString):
            return HostString(x.value, plc)
        if isinstance(x, HostUnit):
            return HostUnit(plc)
        # A cross-host move: an Identity op pinned to the destination; the
        # networking pass later splits the edge into Send/Receive
        # (reference compilation/networking.rs:77-119).
        ret = _ty_of(x)
        op = self._emit("Identity", [x], plc, ret)
        return self._like(op, self._shape_of_leaf(x), x, plc=plc)

    @staticmethod
    def _shape_of_leaf(x) -> Optional[tuple]:
        arr = x.lo if isinstance(x, HostRingTensor) else x.value
        return arr._shape if isinstance(arr, SymArray) else tuple(arr.shape)

    # ------------------------------------------------------------------
    # Structural / metadata
    # ------------------------------------------------------------------

    def shape(self, plc, x) -> SymShape:
        return SymShape(self._shape_of_leaf(x), plc)

    def constant(self, plc, value, dtype=None):
        if isinstance(value, str):
            return HostString(value, plc)
        if isinstance(value, (tuple, list)) and all(
            isinstance(v, (int, np.integer)) for v in value
        ) and dtype is None:
            return SymShape(tuple(int(v) for v in value), plc)
        arr = np.asarray(value)
        if dtype is not None and not dtype.is_fixedpoint:
            arr = arr.astype(np.dtype(dtype.numpy_name))
        if arr.dtype == np.bool_:
            op = self.add_operation(
                "Constant", [], plc, Signature((), _BIT_TY),
                {"value": arr.astype(np.uint8)},
            )
            return self._bit(op, arr.shape, plc)
        out_dtype = dt.from_numpy(arr.dtype)
        op = self.add_operation(
            "Constant", [], plc, Signature((), _tensor_ty(out_dtype)),
            {"value": arr},
        )
        return self._tensor(op, arr.shape, plc, out_dtype)

    def fill(self, plc, shp, value, ty_name: str):
        shape = tuple(shp.value)
        if ty_name.startswith("HostRing"):
            width = 128 if "128" in ty_name else 64
            op = self._emit(
                "Fill", [shp], plc, _ring_ty(width), {"value": int(value)}
            )
            return self._ring(op, shape, width, plc)
        if ty_name == "HostBitTensor":
            op = self._emit(
                "Fill", [shp], plc, _BIT_TY, {"value": int(value) & 1}
            )
            return self._bit(op, shape, plc)
        raise CompilationError(f"fill for {ty_name}")

    def zeros(self, plc, shp, dtype=dt.float64):
        op = self._emit("Zeros", [shp], plc, _tensor_ty(dtype))
        return self._tensor(op, tuple(shp.value), plc, dtype)

    def ones(self, plc, shp, dtype=dt.float64):
        op = self._emit("Ones", [shp], plc, _tensor_ty(dtype))
        return self._tensor(op, tuple(shp.value), plc, dtype)

    def ring_zeros(self, plc, shp, width: int):
        return self.fill(plc, shp, 0, f"HostRing{width}Tensor")

    def ring_constant(self, plc, ints, width: int):
        arr = np.asarray(ints, dtype=object)
        op = self.add_operation(
            "Constant", [], plc, Signature((), _ring_ty(width)),
            {"value": ints},
        )
        return self._ring(op, arr.shape, width, plc)

    def reshape(self, plc, x, shp):
        op = self._emit("Reshape", [x, shp], plc, _ty_of(x))
        return self._like(op, tuple(shp.value), x)

    def transpose(self, plc, x, axes=None):
        attrs = {"axes": tuple(axes)} if axes is not None else None
        op = self._emit("Transpose", [x], plc, _ty_of(x), attrs)
        shape = self._shape_of_leaf(x)
        if axes is None:
            shape = tuple(reversed(shape))
        else:
            shape = tuple(shape[a] for a in axes)
        return self._like(op, shape, x)

    def expand_dims(self, plc, x, axis):
        op = self._emit("ExpandDims", [x], plc, _ty_of(x), {"axis": axis})
        shape = np.expand_dims(_dummy(self._shape_of_leaf(x)), axis).shape
        return self._like(op, shape, x)

    def squeeze(self, plc, x, axis=None):
        op = self._emit("Squeeze", [x], plc, _ty_of(x), {"axis": axis})
        shape = np.squeeze(_dummy(self._shape_of_leaf(x)), axis=axis).shape
        return self._like(op, shape, x)

    def concat(self, plc, xs, axis=0):
        op = self._emit("Concat", list(xs), plc, _ty_of(xs[0]),
                        {"axis": axis})
        shape = np.concatenate(
            [_dummy(self._shape_of_leaf(x)) for x in xs], axis=axis
        ).shape
        return self._like(op, shape, xs[0])

    def index_axis(self, plc, x, axis, index):
        op = self._emit("IndexAxis", [x], plc, _ty_of(x),
                        {"axis": axis, "index": index})
        shape = np.take(_dummy(self._shape_of_leaf(x)), index, axis=axis).shape
        return self._like(op, shape, x)

    def slice(self, plc, x, begin, end):
        op = self._emit("Slice", [x], plc, _ty_of(x),
                        {"begin": tuple(begin), "end": tuple(end)})
        d = _dummy(self._shape_of_leaf(x))
        shape = d[tuple(slice(b, e) for b, e in zip(begin, end))].shape
        return self._like(op, shape, x)

    def strided_slice(self, plc, x, slices):
        spec = tuple(
            (s.start, s.stop, s.step)
            if isinstance(s, slice)
            else ("..." if s is Ellipsis else s)
            for s in slices
        )
        op = self._emit("Slice", [x], plc, _ty_of(x), {"slices": spec})
        shape = _dummy(self._shape_of_leaf(x))[tuple(slices)].shape
        return self._like(op, shape, x)

    def broadcast(self, plc, x, shp):
        op = self._emit("Broadcast", [x, shp], plc, _ty_of(x))
        return self._like(op, tuple(shp.value), x)

    def diag(self, plc, x):
        op = self._emit("Diag", [x], plc, _ty_of(x))
        shape = np.diag(_dummy(self._shape_of_leaf(x))).shape
        return self._like(op, shape, x)

    def shl_dim(self, plc, x, amount, bit_length):
        op = self._emit("ShlDim", [x], plc, _ty_of(x),
                        {"amount": amount, "bit_length": bit_length})
        return self._like(op, self._shape_of_leaf(x), x)

    def at_least_2d(self, plc, x, to_column_vector=False):
        op = self._emit("AtLeast2D", [x], plc, _ty_of(x),
                        {"to_column_vector": to_column_vector})
        shape = self._shape_of_leaf(x)
        if len(shape) == 0:
            shape = (1, 1)
        elif len(shape) == 1:
            shape = (shape[0], 1) if to_column_vector else (1, shape[0])
        return self._like(op, shape, x)

    # ------------------------------------------------------------------
    # Arithmetic
    # ------------------------------------------------------------------

    def _binop(self, kind, plc, x, y):
        op = self._emit(kind, [x, y], plc, _ty_of(x))
        shape = np.broadcast_shapes(
            self._shape_of_leaf(x), self._shape_of_leaf(y)
        )
        return self._like(op, shape, x)

    def add(self, plc, x, y):
        return self._binop("Add", plc, x, y)

    def sub(self, plc, x, y):
        return self._binop("Sub", plc, x, y)

    def mul(self, plc, x, y):
        if isinstance(x, HostBitTensor):
            return self._binop("And", plc, x, y)
        return self._binop("Mul", plc, x, y)

    def div(self, plc, x, y):
        return self._binop("Div", plc, x, y)

    def dot(self, plc, x, y):
        op = self._emit("Dot", [x, y], plc, _ty_of(x))
        shape = _dot_shape(self._shape_of_leaf(x), self._shape_of_leaf(y))
        return self._like(op, shape, x)

    def _cross_terms(self, plc, contract, x0, x1, y0, y1):
        """One party's ``x0·(y0 + y1) + x1·y0``, recorded as the JAX
        package's ``replicated._mul_like`` composes it: the inner add,
        the two contractions, the outer add."""
        return self.add(
            plc, contract(plc, x0, self.add(plc, y0, y1)),
            contract(plc, x1, y0),
        )

    def mul_cross_terms(self, plc, x0, x1, y0, y1):
        return self._cross_terms(plc, self.mul, x0, x1, y0, y1)

    def dot_cross_terms(self, plc, x0, x1, y0, y1):
        return self._cross_terms(plc, self.dot, x0, x1, y0, y1)

    def conv_cross_terms(self, plc, x0, x1, k0, k1, strides=(1, 1),
                         padding="VALID"):
        return self._cross_terms(
            plc, lambda p, a, b: self.conv2d(p, a, b, strides, padding),
            x0, x1, k0, k1,
        )

    def _conv_spatial(self, x, kh, kw, strides, padding):
        from ..dialects import ring

        n, h, w, _ = self._shape_of_leaf(x)
        sh, sw = strides
        (p0, p1), (q0, q1) = ring.resolve_padding(
            padding, h, w, kh, kw, sh, sw
        )
        return (
            n,
            ring.conv_out_size(h, kh, sh, p0, p1),
            ring.conv_out_size(w, kw, sw, q0, q1),
        )

    def conv2d(self, plc, x, k, strides=(1, 1), padding="VALID"):
        op = self._emit(
            "Conv2D", [x, k], plc, _ty_of(x),
            {"strides": tuple(strides), "padding": padding},
        )
        kh, kw, _, o = self._shape_of_leaf(k)
        n, oh, ow = self._conv_spatial(x, kh, kw, strides, padding)
        return self._like(op, (n, oh, ow, o), x)

    def im2col(self, plc, x, kh, kw, strides=(1, 1), padding="VALID"):
        op = self._emit(
            "Im2Col", [x], plc, _ty_of(x),
            {"kh": kh, "kw": kw, "strides": tuple(strides),
             "padding": padding},
        )
        c = self._shape_of_leaf(x)[3]
        n, oh, ow = self._conv_spatial(x, kh, kw, strides, padding)
        return self._like(op, (n, oh, ow, kh * kw * c), x)

    def _pool2d(self, kind, plc, x, pool, strides, padding):
        strides = tuple(strides) if strides is not None else tuple(pool)
        attrs = {
            "pool_size": tuple(pool), "strides": strides,
            "padding": padding,
        }
        op = self._emit(kind, [x], plc, _ty_of(x), attrs)
        c = self._shape_of_leaf(x)[3]
        n, oh, ow = self._conv_spatial(
            x, pool[0], pool[1], strides, padding
        )
        return self._like(op, (n, oh, ow, c), x)

    def avg_pool2d(self, plc, x, pool, strides=None, padding="VALID"):
        return self._pool2d("AvgPool2D", plc, x, pool, strides, padding)

    def max_pool2d(self, plc, x, pool, strides=None, padding="VALID"):
        return self._pool2d("MaxPool2D", plc, x, pool, strides, padding)

    def neg(self, plc, x):
        op = self._emit("Neg", [x], plc, _ty_of(x))
        return self._like(op, self._shape_of_leaf(x), x)

    def sum(self, plc, x, axis=None):
        op = self._emit("Sum", [x], plc, _ty_of(x), {"axis": axis})
        return self._like(op, _reduce_shape(self._shape_of_leaf(x), axis), x)

    def mean(self, plc, x, axis=None):
        op = self._emit("Mean", [x], plc, _ty_of(x), {"axis": axis})
        return self._like(op, _reduce_shape(self._shape_of_leaf(x), axis), x)

    def shl(self, plc, x, amount: int):
        op = self._emit("Shl", [x], plc, _ty_of(x), {"amount": amount})
        return self._like(op, self._shape_of_leaf(x), x)

    def shr(self, plc, x, amount: int):
        op = self._emit("Shr", [x], plc, _ty_of(x), {"amount": amount})
        return self._like(op, self._shape_of_leaf(x), x)

    def shr_arith(self, plc, x, amount: int):
        op = self._emit("Shr", [x], plc, _ty_of(x),
                        {"amount": amount, "arithmetic": True})
        return self._like(op, self._shape_of_leaf(x), x)

    # ------------------------------------------------------------------
    # Bits
    # ------------------------------------------------------------------

    def xor(self, plc, x, y):
        return self._binop("Xor", plc, x, y)

    def and_(self, plc, x, y):
        return self._binop("And", plc, x, y)

    def or_(self, plc, x, y):
        return self._binop("Or", plc, x, y)

    def bit_neg(self, plc, x):
        op = self._emit("Neg", [x], plc, _BIT_TY)
        return self._bit(op, self._shape_of_leaf(x), plc)

    def bit_extract(self, plc, x, bit_idx: int):
        op = self._emit("BitExtract", [x], plc, _BIT_TY,
                        {"bit_idx": bit_idx})
        return self._bit(op, self._shape_of_leaf(x), plc)

    def ring_inject(self, plc, b, bit_idx: int, width: int):
        op = self._emit("RingInject", [b], plc, _ring_ty(width),
                        {"bit_idx": bit_idx})
        return self._ring(op, self._shape_of_leaf(b), width, plc)

    def decompose_bits(self, plc, x):
        op = self._emit("BitDecompose", [x], plc, _BIT_TY)
        shape = (x.width,) + tuple(self._shape_of_leaf(x))
        return self._bit(op, shape, plc)

    def compose_bits(self, plc, b, width: int):
        op = self._emit("BitCompose", [b], plc, _ring_ty(width))
        return self._ring(op, tuple(self._shape_of_leaf(b))[1:], width, plc)

    # ------------------------------------------------------------------
    # Fixed-point
    # ------------------------------------------------------------------

    def ring_fixedpoint_encode(self, plc, x, frac: int, width: int):
        op = self._emit(
            "RingFixedpointEncode", [x], plc, _ring_ty(width),
            {"scaling_base": 2, "scaling_exp": frac},
        )
        return self._ring(op, self._shape_of_leaf(x), width, plc)

    def ring_fixedpoint_decode(self, plc, x, frac: int, dtype=dt.float64):
        op = self._emit(
            "RingFixedpointDecode", [x], plc, _tensor_ty(dtype),
            {"scaling_base": 2, "scaling_exp": frac},
        )
        return self._tensor(op, self._shape_of_leaf(x), plc, dtype)

    def ring_fixedpoint_mean(self, plc, x, axis, frac: int):
        op = self._emit(
            "RingFixedpointMean", [x], plc, _ty_of(x),
            {"axis": axis, "scaling_base": 2, "scaling_exp": frac},
        )
        return self._like(op, _reduce_shape(self._shape_of_leaf(x), axis), x)

    def fixedpoint_encode(self, plc, x, integ: int, frac: int, width: int):
        return HostFixedTensor(
            self.ring_fixedpoint_encode(plc, x, frac, width), integ, frac
        )

    def fixedpoint_decode(self, plc, x, dtype=dt.float64):
        return self.ring_fixedpoint_decode(
            plc, x.tensor, x.fractional_precision, dtype
        )

    # ------------------------------------------------------------------
    # Plaintext math
    # ------------------------------------------------------------------

    def _unary(self, kind, plc, x, attributes=None):
        op = self._emit(kind, [x], plc, _ty_of(x), attributes)
        return self._like(op, self._shape_of_leaf(x), x)

    def exp(self, plc, x):
        return self._unary("Exp", plc, x)

    def log(self, plc, x):
        return self._unary("Log", plc, x)

    def log2(self, plc, x):
        return self._unary("Log2", plc, x)

    def sqrt(self, plc, x):
        return self._unary("Sqrt", plc, x)

    def sigmoid(self, plc, x):
        return self._unary("Sigmoid", plc, x)

    def relu(self, plc, x):
        return self._unary("Relu", plc, x)

    def abs(self, plc, x):
        return self._unary("Abs", plc, x)

    def sign(self, plc, x):
        return self._unary("Sign", plc, x)

    def pow2(self, plc, x):
        return self._unary("Pow2", plc, x)

    def softmax(self, plc, x, axis):
        return self._unary("Softmax", plc, x, {"axis": axis})

    def argmax(self, plc, x, axis):
        op = self._emit("Argmax", [x], plc, _tensor_ty(dt.uint64),
                        {"axis": axis})
        return self._tensor(
            op, _reduce_shape(self._shape_of_leaf(x), axis), plc, dt.uint64
        )

    def maximum(self, plc, xs):
        op = self._emit("Maximum", list(xs), plc, _ty_of(xs[0]))
        shape = np.broadcast_shapes(*[self._shape_of_leaf(x) for x in xs])
        return self._like(op, shape, xs[0])

    def inverse(self, plc, x):
        return self._unary("Inverse", plc, x)

    def less(self, plc, x, y):
        op = self._emit("Less", [x, y], plc, _BIT_TY)
        shape = np.broadcast_shapes(
            self._shape_of_leaf(x), self._shape_of_leaf(y)
        )
        return self._bit(op, shape, plc)

    def greater(self, plc, x, y):
        op = self._emit("Greater", [x, y], plc, _BIT_TY)
        shape = np.broadcast_shapes(
            self._shape_of_leaf(x), self._shape_of_leaf(y)
        )
        return self._bit(op, shape, plc)

    def equal(self, plc, x, y):
        op = self._emit("Equal", [x, y], plc, _BIT_TY)
        shape = np.broadcast_shapes(
            self._shape_of_leaf(x), self._shape_of_leaf(y)
        )
        return self._bit(op, shape, plc)

    def mux(self, plc, s, x, y):
        op = self._emit("Mux", [s, x, y], plc, _ty_of(x))
        shape = np.broadcast_shapes(
            self._shape_of_leaf(s),
            self._shape_of_leaf(x),
            self._shape_of_leaf(y),
        )
        return self._like(op, shape, x)

    def cast(self, plc, x, target: dt.DType):
        if target.is_boolean:
            op = self._emit("Cast", [x], plc, _BIT_TY, {"dtype": target})
            return self._bit(op, self._shape_of_leaf(x), plc)
        op = self._emit("Cast", [x], plc, _tensor_ty(target),
                        {"dtype": target})
        return self._tensor(op, self._shape_of_leaf(x), plc, target)

    def lift_ring_lo(self, plc, x, dtype=dt.uint64):
        op = self._emit("Cast", [x], plc, _tensor_ty(dtype),
                        {"dtype": dtype})
        return self._tensor(op, self._shape_of_leaf(x), plc, dtype)

    def cast_ring_lo(self, plc, x, target: dt.DType):
        """The eager session's one call, as the reference's two Casts: the
        low words to uint64, then to ``target``."""
        return self.cast(plc, self.lift_ring_lo(plc, x, dt.uint64), target)

    def select(self, plc, x, axis, index):
        op = self._emit("Select", [x, index], plc, _ty_of(x),
                        {"axis": axis})
        return self._like(op, None, x)
