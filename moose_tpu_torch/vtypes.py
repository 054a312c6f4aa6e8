"""Logical value types carried by eDSL expressions and IR signatures.

Mirror of the reference's ``pymoose/pymoose/computation/types.py`` value-type
family (TensorType & friends).  These are *logical* types: they say what a
value is to the user (a tensor of some dtype, a string, a shape), not where it
lives — placement is orthogonal and tracked on the operation.

The port's own copy of ``moose_tpu/vtypes.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import dtypes as dt
from .computation import (
    AesKeyTy,
    AesTensorTy,
    ShapeTy,
    StringTy,
    Ty,
    UnitTy,
    tensor_ty,
)


@dataclasses.dataclass(frozen=True)
class ValueType:
    def to_ty(self) -> Ty:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UnitType(ValueType):
    def to_ty(self) -> Ty:
        return UnitTy


@dataclasses.dataclass(frozen=True)
class UnknownType(ValueType):
    def to_ty(self) -> Ty:
        return Ty("Unknown")


@dataclasses.dataclass(frozen=True)
class TensorType(ValueType):
    dtype: dt.DType

    def to_ty(self) -> Ty:
        return tensor_ty(self.dtype)


@dataclasses.dataclass(frozen=True)
class AesTensorType(ValueType):
    dtype: dt.DType  # fixed-point dtype of the plaintext

    def to_ty(self) -> Ty:
        return dataclasses.replace(AesTensorTy, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class AesKeyType(ValueType):
    def to_ty(self) -> Ty:
        return AesKeyTy


@dataclasses.dataclass(frozen=True)
class BytesType(ValueType):
    def to_ty(self) -> Ty:
        return Ty("HostBytes")


@dataclasses.dataclass(frozen=True)
class StringType(ValueType):
    def to_ty(self) -> Ty:
        return StringTy


@dataclasses.dataclass(frozen=True)
class IntType(ValueType):
    def to_ty(self) -> Ty:
        return Ty("HostInt")


@dataclasses.dataclass(frozen=True)
class FloatType(ValueType):
    def to_ty(self) -> Ty:
        return Ty("HostFloat")


@dataclasses.dataclass(frozen=True)
class ShapeType(ValueType):
    def to_ty(self) -> Ty:
        return ShapeTy


def from_ty(ty: Ty) -> ValueType:
    if ty.name == "Tensor":
        return TensorType(ty.dtype)
    mapping = {
        "Unit": UnitType(),
        "HostString": StringType(),
        "HostShape": ShapeType(),
        "AesKey": AesKeyType(),
        "HostBytes": BytesType(),
        "HostInt": IntType(),
        "HostFloat": FloatType(),
        "Unknown": UnknownType(),
    }
    if ty.name == "AesTensor":
        return AesTensorType(ty.dtype)
    if ty.name in mapping:
        return mapping[ty.name]
    raise ValueError(f"no logical value type for {ty.name}")
