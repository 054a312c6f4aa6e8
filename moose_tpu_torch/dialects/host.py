"""Host-placement kernels on PyTorch tensors.

The subset of ``moose_tpu/dialects/host.py`` that the slice's graphs
reach: placement relabels, shapes, constants, ``fill``, ``ones``,
``expand_dims``, casts, the fixed-point encode/decode and the ring
arithmetic and shifts the mirrored dialect maps over its three hosts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dtypes as dt
from ..values import (
    HostBitTensor,
    HostRingTensor,
    HostShape,
    HostTensor,
    torch_dtype,
)
from . import ring


def place(x, plc: str):
    """Move/claim a value onto a host placement (a relabel in
    single-process execution)."""
    return dataclasses.replace(x, plc=plc) if hasattr(x, "plc") else x


def shape(x, plc: str) -> HostShape:
    if isinstance(x, HostRingTensor):
        return HostShape(tuple(x.lo.shape), plc)
    return HostShape(tuple(x.value.shape), plc)


def constant(value, plc: str, dtype: dt.DType, device) -> HostTensor:
    arr = np.asarray(value).astype(np.dtype(dtype.numpy_name))
    return HostTensor(torch.as_tensor(arr, device=device), plc, dtype)


def fill(shp: HostShape, value, plc: str, ty_name: str, device):
    if ty_name.startswith("HostRing"):
        width = 128 if "128" in ty_name else 64
        lo, hi = ring.fill_like_shape(shp.value, width, int(value), device)
        return HostRingTensor(lo, hi, width, plc)
    if ty_name == "HostBitTensor":
        return HostBitTensor(
            torch.full(tuple(shp.value), int(value) & 1, dtype=torch.uint8,
                       device=device),
            plc,
        )
    raise NotImplementedError(f"fill for {ty_name}")


def ones(shp: HostShape, dtype: dt.DType, plc: str, device) -> HostTensor:
    return HostTensor(
        torch.ones(shp.value, dtype=torch_dtype(dtype), device=device),
        plc, dtype,
    )


def expand_dims(x: HostTensor, plc: str, axis: int) -> HostTensor:
    return HostTensor(x.value.unsqueeze(axis), plc, x.dtype)


def cast(x: HostTensor, target: dt.DType, plc: str) -> HostTensor:
    return HostTensor(x.value.to(torch_dtype(target)), plc, target)


def cast_ring_lo(x: HostRingTensor, target: dt.DType,
                 plc: str) -> HostTensor:
    """Cast the low words of ring values, read as uint64 (small
    non-negative values, such as a revealed Argmax index), to
    ``target``."""
    if target.is_float:
        value = ring.u64_to_float64(x.lo)
    else:
        value = x.lo
    return HostTensor(value.to(torch_dtype(target)), plc, target)


def ring_fixedpoint_encode(x: HostTensor, frac_precision: int, width: int,
                           plc: str) -> HostRingTensor:
    lo, hi = ring.fixedpoint_encode(x.value, frac_precision, width)
    return HostRingTensor(lo, hi, width, plc)


def ring_fixedpoint_decode(x: HostRingTensor, frac_precision: int, plc: str,
                           dtype: dt.DType = dt.float64) -> HostTensor:
    v = ring.fixedpoint_decode(x.lo, x.hi, frac_precision)
    return HostTensor(v.to(torch_dtype(dtype)), plc, dtype)


def _ring2(fn):
    def kernel(x: HostRingTensor, y: HostRingTensor,
               plc: str) -> HostRingTensor:
        lo, hi = fn(x.lo, x.hi, y.lo, y.hi)
        return HostRingTensor(lo, hi, x.width, plc)

    return kernel


ring_add = _ring2(ring.add)
ring_sub = _ring2(ring.sub)
ring_mul = _ring2(ring.mul)


def ring_shl(x: HostRingTensor, amount: int, plc: str) -> HostRingTensor:
    lo, hi = ring.shl(x.lo, x.hi, amount)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_shr(x: HostRingTensor, amount: int, plc: str) -> HostRingTensor:
    lo, hi = ring.shr(x.lo, x.hi, amount)
    return HostRingTensor(lo, hi, x.width, plc)
