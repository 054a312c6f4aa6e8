"""The port's tournaments (moose_tpu_torch/parallel/spmd_math.py) against
moose_tpu on the CPU: ``fx_max``, ``fx_argmax`` and ``fx_softmax`` along
axis 1 of size 5 and 10 (odd rounds carry their last entry over; 10
classes along axis 1 is the multinomial classifier's case), argmax and
softmax also over a window (``upmost_index``), at ring128 fixed(24,40)
and ring64 fixed(8,17) under both threefry streams.  Every share agrees
word for word; the revealed results are held to numpy's max and argmax
(inputs apart by far more than an LSB) and to the float64 softmax within
5e-3 (tests/test_predictors.py:85).  Ring64 along axis 1 runs in
``tests/test_torch_softmax_ring64.py``; axis 0 of size 3 and
``fx_maximum`` share none of these shapes and run in
``tests/test_torch_softmax_axis0.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch import values
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm

from torch_parity import assert_words_equal, prf

MK = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A], np.uint32)
STREAMS = ("threefry", "threefry-pallas")
PRECISIONS = ((128, 24, 40), (64, 8, 17))
OTHER = 2  # the size of the axis not reduced
SOFTMAX_TOL = 5e-3


def _rep_equal(got, want, label=""):
    assert got.width == want.width
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _inputs(n, axis):
    """Distinct values a quarter apart, shuffled, n along ``axis``."""
    rng = np.random.default_rng(10 * n + axis)
    shape = (n, OTHER) if axis == 0 else (OTHER, n)
    x = rng.permutation(np.arange(n * OTHER) * 0.25 - n * OTHER / 8)
    return x.reshape(shape)


def _indices(rep):
    ring = values.HostRingTensor(*tspmd.reveal(rep), rep.width, "carole")
    return values.to_numpy(ring).astype(np.int64)


@pytest.mark.parametrize("stream", STREAMS)
# ring64 shares no compile with ring128 and runs in
# tests/test_torch_softmax_ring64.py, on another test worker
@pytest.mark.parametrize("width,integ,frac", PRECISIONS[:1])
# each (size, axis) is a new set of shapes, which the JAX package's eager
# kernels compile anew: three cover both axes and odd and even sizes.  10
# runs first: its tournament rounds hold 5's, whose compiles 5 reuses.
# Axis 0 (size 3) shares none of them and runs in
# tests/test_torch_softmax_axis0.py, on another test worker
@pytest.mark.parametrize("n,axis", ((10, 1), (5, 1)))
def test_tournaments_match(stream, width, integ, frac, n, axis):
    check_tournaments(stream, width, integ, frac, n, axis)


def check_tournaments(stream, width, integ, frac, n, axis):
    x = _inputs(n, axis)
    window = n - 1
    ops = {
        "max": lambda m, s, v: m.fx_max(s, v, axis),
        "argmax": lambda m, s, v: m.fx_argmax(s, v, axis),
        "argmax window": lambda m, s, v: m.fx_argmax(
            s, v, axis, upmost_index=window),
        "softmax": lambda m, s, v: m.fx_softmax(s, v, axis),
        "softmax window": lambda m, s, v: m.fx_softmax(
            s, v, axis, upmost_index=window),
    }
    js, ts = jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")
    got, want = {}, {}
    with prf(stream):
        jx = jspmd.fx_encode_share(js, jnp.asarray(x), integ, frac, width)
        tx = tspmd.fx_encode_share(ts, torch.as_tensor(x), integ, frac,
                                   width)
        for name, op in ops.items():
            want[name] = op(jsm, js, jx)
            got[name] = op(tsm, ts, tx)
    assert ts._counter == js._counter
    for name in ops:
        g, w = got[name], want[name]
        if name.startswith("argmax"):
            _rep_equal(g, w, name)
        else:
            _rep_equal(g.tensor, w.tensor, name)
    assert np.array_equal(tspmd.fx_reveal_decode(got["max"]).numpy(),
                          x.max(axis=axis))
    assert np.array_equal(_indices(got["argmax"]), x.argmax(axis=axis))
    sub = x[:window] if axis == 0 else x[:, :window]
    assert np.array_equal(_indices(got["argmax window"]),
                          sub.argmax(axis=axis))
    soft = tspmd.fx_reveal_decode(got["softmax"]).numpy()
    assert np.abs(soft - _softmax(x, axis)).max() < SOFTMAX_TOL
    # the window bounds only the max the softmax subtracts
    shift = np.expand_dims(sub.max(axis=axis), axis)
    e = np.exp(x - shift)
    soft = tspmd.fx_reveal_decode(got["softmax window"]).numpy()
    assert np.abs(soft - e / e.sum(axis=axis, keepdims=True)).max() < \
        SOFTMAX_TOL
