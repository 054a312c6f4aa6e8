"""Fixed-point constants of the protocol library.

The port's copy of the two constants ``moose_tpu/dialects/fixedpoint.py``
defines for the stacked protocols: the raw-integer encoding of a public
float (``encode_const``), the Taylor coefficients of 2^x (``P_1045``)
and the Pade coefficients of log2 (``P_2524``/``Q_2524``).  The rest of that module is the per-host protocol layer,
which the port has not reached (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import functools
import math


@functools.lru_cache(maxsize=None)
def encode_const(value: float, frac: int, width: int) -> int:
    """A float as a two's-complement fixed-point raw integer mod
    2^width, rounded half to even."""
    raw = int(round(value * (2 ** frac)))
    return raw % (1 << width)


# Taylor coefficients of 2^x = sum (ln 2)^i / i! * x^i
P_1045 = [math.log(2.0) ** i / math.factorial(i) for i in range(100)]

# Pade approximation of log2 on [0.5, 1): P_2524(x) / Q_2524(x)
P_2524 = [-2.05466671951, -8.8626599391, 6.10585199015, 4.81147460989]
Q_2524 = [0.353553425277, 4.54517087629, 6.42784209029, 1.0]
