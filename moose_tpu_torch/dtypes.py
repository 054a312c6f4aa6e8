"""Logical tensor dtypes for the moose_tpu framework.

TPU-native re-design of the reference's dtype lattice
(``pymoose/pymoose/computation/dtypes.py`` and ``moose/src/logical/mod.rs:18-34``):
the logical ``Tensor`` type abstracts over Float32/Float64/Bool/Uint64 plaintext
dtypes and Fixed64/Fixed128 fixed-point dtypes backed by ring tensors.

The port's own copy of ``moose_tpu/dtypes.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DType:
    """A logical dtype.

    ``name`` is the canonical short name (e.g. ``float64``, ``fixed128``).
    Fixed-point dtypes carry ``integral_precision`` / ``fractional_precision``.
    """

    name: str
    numpy_name: str | None = None
    is_float: bool = False
    is_integer: bool = False
    is_signed: bool = False
    is_boolean: bool = False
    is_fixedpoint: bool = False
    integral_precision: int | None = None
    fractional_precision: int | None = None

    @property
    def is_plaintext(self) -> bool:
        return not self.is_fixedpoint

    @property
    def precision(self) -> tuple[int, int] | None:
        if not self.is_fixedpoint:
            return None
        return (self.integral_precision, self.fractional_precision)

    def __str__(self) -> str:
        if self.is_fixedpoint:
            return (
                f"{self.name}({self.integral_precision}, "
                f"{self.fractional_precision})"
            )
        return self.name

    def __repr__(self) -> str:
        return str(self)

    def short_textual(self) -> str:
        """Textual-format spelling, e.g. ``Fixed128(24, 40)`` or ``Float64``."""
        mapping = {
            "float32": "Float32",
            "float64": "Float64",
            "int32": "Int32",
            "int64": "Int64",
            "uint32": "Uint32",
            "uint64": "Uint64",
            "bool": "Bool",
        }
        if self.is_fixedpoint:
            total = 64 if self.name == "fixed64" else 128
            return (
                f"Fixed{total}({self.integral_precision}, "
                f"{self.fractional_precision})"
            )
        return mapping[self.name]


float32 = DType("float32", "float32", is_float=True, is_signed=True)
float64 = DType("float64", "float64", is_float=True, is_signed=True)
int32 = DType("int32", "int32", is_integer=True, is_signed=True)
int64 = DType("int64", "int64", is_integer=True, is_signed=True)
uint32 = DType("uint32", "uint32", is_integer=True)
uint64 = DType("uint64", "uint64", is_integer=True)
bool_ = DType("bool", "bool", is_boolean=True)


# Accumulation headroom bits reserved when auto-selecting ring64 (covers
# reductions over up to 2^10 elements; see ``fixed``).
_RING64_HEADROOM = 10


def fixed(integral_precision: int, fractional_precision: int) -> DType:
    """Fixed-point dtype backed by a ring chosen by total precision.

    Mirrors the reference's ``pm.fixed(i, f)``.  The reference maps every
    fixed dtype to the 128-bit ring (pymoose/src/computation.rs:682); we
    instead select the 64-bit ring whenever all protocols still fit, which
    halves limb count on TPU.  The binding constraint: a raw product has
    magnitude < 2^{2(i+f)} and must satisfy trunc_pr's input bound
    |x| < 2^{width-3} (additive trunc with sign bit and overflow-correction
    slack), so a single product needs ``2*(i+f) <= 61``.  Reductions (Dot,
    Sum, AddN, Mean) accumulate up to log2(k) extra bits on top of that, so
    we keep ``_RING64_HEADROOM`` bits of slack — ring64 is only chosen when
    ``2*(i+f) + 10 <= 61``, safe for contractions over up to 2^10 = 1024
    elements.  Use ``fixed64(i, f)`` / ``fixed128(i, f)`` to force a ring.
    """
    if 2 * (integral_precision + fractional_precision) + _RING64_HEADROOM <= 61:
        name = "fixed64"
    else:
        name = "fixed128"
    return DType(
        name,
        is_fixedpoint=True,
        is_signed=True,
        integral_precision=integral_precision,
        fractional_precision=fractional_precision,
    )


def fixed64(integral_precision: int, fractional_precision: int) -> DType:
    return DType(
        "fixed64",
        is_fixedpoint=True,
        is_signed=True,
        integral_precision=integral_precision,
        fractional_precision=fractional_precision,
    )


def fixed128(integral_precision: int, fractional_precision: int) -> DType:
    return DType(
        "fixed128",
        is_fixedpoint=True,
        is_signed=True,
        integral_precision=integral_precision,
        fractional_precision=fractional_precision,
    )


_BY_NAME = {
    "float32": float32,
    "float64": float64,
    "int32": int32,
    "int64": int64,
    "uint32": uint32,
    "uint64": uint64,
    "bool": bool_,
}


def from_name(name: str, precision: tuple[int, int] | None = None) -> DType:
    if name == "fixed64":
        return fixed64(*precision)
    if name == "fixed128":
        return fixed128(*precision)
    return _BY_NAME[name]


def from_numpy(np_dtype) -> DType:
    import numpy as np

    return _BY_NAME[np.dtype(np_dtype).name]
