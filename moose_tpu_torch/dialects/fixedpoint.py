"""Fixed-point constants of the protocol library.

The port's copy of the two constants ``moose_tpu/dialects/fixedpoint.py``
defines for the stacked protocols: the raw-integer encoding of a public
float (``encode_const``) and the Taylor coefficients of 2^x
(``P_1045``).  The rest of that module is the per-host protocol layer,
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
