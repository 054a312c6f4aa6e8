"""Mirrored dialect: public values kept in lockstep on 3 hosts so they can
interact with secret tensors without triple communication
(``moose/src/mirrored/``).

The port of ``moose_tpu/dialects/mirrored.py``: each function maps the
session's host kernel over the three owners of a
:class:`~moose_tpu_torch.computation.Mirrored3Placement`.
"""

from __future__ import annotations

from .. import dtypes as dt
from ..computation import Mirrored3Placement
from ..values import Mir3Tensor


def mirror(sess, mir: Mirrored3Placement, x) -> Mir3Tensor:
    """Replicate a host value onto all three owners (mirrored/ops.rs:140)."""
    return Mir3Tensor(
        tuple(sess.place(o, x) for o in mir.owners), mir.name
    )


def demirror(sess, mir: Mirrored3Placement, x: Mir3Tensor, to_plc: str):
    for i, o in enumerate(mir.owners):
        if o == to_plc:
            return x.values[i]
    return sess.place(to_plc, x.values[0])


def fill(sess, mir: Mirrored3Placement, shp, value, ty_name: str) -> Mir3Tensor:
    return Mir3Tensor(
        tuple(sess.fill(o, shp, value, ty_name) for o in mir.owners),
        mir.name,
    )


def _map(sess, mir, fn, *xs):
    return Mir3Tensor(
        tuple(
            fn(mir.owners[i], *[x.values[i] for x in xs]) for i in range(3)
        ),
        mir.name,
    )


def add(sess, mir, x, y):
    return _map(sess, mir, lambda plc, a, b: sess.add(plc, a, b), x, y)


def sub(sess, mir, x, y):
    return _map(sess, mir, lambda plc, a, b: sess.sub(plc, a, b), x, y)


def mul(sess, mir, x, y):
    return _map(sess, mir, lambda plc, a, b: sess.mul(plc, a, b), x, y)


def shl(sess, mir, x, amount: int):
    return _map(sess, mir, lambda plc, a: sess.shl(plc, a, amount), x)


def shr(sess, mir, x, amount: int):
    return _map(sess, mir, lambda plc, a: sess.shr(plc, a, amount), x)


def ring_fixedpoint_encode(sess, mir, x: Mir3Tensor, frac: int, width: int):
    return _map(
        sess,
        mir,
        lambda plc, a: sess.ring_fixedpoint_encode(plc, a, frac, width),
        x,
    )


def ring_fixedpoint_decode(sess, mir, x: Mir3Tensor, frac: int,
                           dtype=dt.float64):
    return _map(
        sess,
        mir,
        lambda plc, a: sess.ring_fixedpoint_decode(plc, a, frac, dtype),
        x,
    )
