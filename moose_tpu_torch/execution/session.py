"""Sessions: the host-primitive interface the dialects are written against.

The eager half of ``moose_tpu/execution/session.py``: every method takes
the host placement name the op is pinned to and runs the host kernel on
the session's device.  Only the kernels the slice's graphs reach are
here.
"""

from __future__ import annotations

import secrets
from typing import Optional

import torch

from .. import dtypes as dt
from ..dialects import host
from ..values import HostFixedTensor


class EagerSession:
    """Direct execution of host kernels on ``device``."""

    def __init__(self, device, session_id: Optional[str] = None):
        self.session_id = session_id or secrets.token_hex(8)
        self.device = torch.device(device)

    def place(self, plc: str, x):
        return host.place(x, plc)

    def shape(self, plc, x):
        return host.shape(x, plc)

    def constant(self, plc, value, dtype: dt.DType):
        return host.constant(value, plc, dtype, self.device)

    def fill(self, plc, shp, value, ty_name: str):
        return host.fill(shp, value, plc, ty_name, self.device)

    def ones(self, plc, shp, dtype=dt.float64):
        return host.ones(shp, dtype, plc, self.device)

    def expand_dims(self, plc, x, axis):
        return host.expand_dims(x, plc, axis)

    def cast(self, plc, x, target: dt.DType):
        return host.cast(x, target, plc)

    def cast_ring_lo(self, plc, x, target: dt.DType):
        return host.cast_ring_lo(x, target, plc)

    # ring arithmetic and shifts, as the mirrored dialect maps them over
    # its three hosts
    def add(self, plc, x, y):
        return host.ring_add(x, y, plc)

    def sub(self, plc, x, y):
        return host.ring_sub(x, y, plc)

    def mul(self, plc, x, y):
        return host.ring_mul(x, y, plc)

    def shl(self, plc, x, amount: int):
        return host.ring_shl(x, amount, plc)

    def shr(self, plc, x, amount: int):
        return host.ring_shr(x, amount, plc)

    def ring_fixedpoint_encode(self, plc, x, frac: int, width: int):
        return host.ring_fixedpoint_encode(x, frac, width, plc)

    def ring_fixedpoint_decode(self, plc, x, frac: int, dtype=dt.float64):
        return host.ring_fixedpoint_decode(x, frac, plc, dtype)

    def fixedpoint_encode(self, plc, x, integ: int, frac: int, width: int):
        return HostFixedTensor(
            self.ring_fixedpoint_encode(plc, x, frac, width), integ, frac
        )

    def fixedpoint_decode(self, plc, x, dtype=dt.float64):
        return self.ring_fixedpoint_decode(
            plc, x.tensor, x.fractional_precision, dtype
        )
