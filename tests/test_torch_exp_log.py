"""The port's exponential, logarithm and root
(moose_tpu_torch/parallel/spmd_math.py) against moose_tpu on the CPU:
``fx_pow2`` (clamped and lower-bounded), ``fx_exp``, ``int2fl``,
``fx_log2``, ``fx_log`` and ``fx_sqrt``, at ring128 fixed(24,40) and
ring64 fixed(8,17), under both threefry streams.  Every share agrees word
for word; the decoded results are also held to the float64 functions
within the JAX package's own tolerances (tests/test_fixedpoint_math.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm

from torch_parity import assert_words_equal, prf

MK = np.array([0x2B7E1516, 0x28AED2A6, 0xABF71588, 0x09CF4F3C], np.uint32)
STREAMS = ("threefry", "threefry-pallas")
PRECISIONS = ((128, 24, 40), (64, 8, 17))
# one logical shape (6,) for every test: the JAX package's eager kernels
# compile once per width.  2^x stays below 2^i at the ring64 precision.
POW_X = np.array([-3.25, -0.5, 0.0, 0.75, 2.5, 5.0])
# below -f the clamped branch holds 2^x at its floor
UNDER_X = np.array([-30.0, -17.5, -1.0, 0.0, 1.5, 3.0])
POS_X = np.array([0.125, 0.5, 1.0, 1.75, 6.0, 37.5])


def _rep_equal(got, want, label=""):
    assert got.width == want.width
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


def _run(stream, width, integ, frac, x, jfn, tfn):
    """``jfn``/``tfn`` on the fixed-point sharing of ``x`` in sessions
    under one key; returns both results and the port's session."""
    js, ts = jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")
    with prf(stream):
        jx = jspmd.fx_encode_share(js, jnp.asarray(x), integ, frac, width)
        tx = tspmd.fx_encode_share(ts, torch.as_tensor(x), integ, frac,
                                   width)
        want, got = jfn(js, jx), tfn(ts, tx)
    assert ts._counter == js._counter
    return got, want


def _decoded(z):
    return tspmd.fx_reveal_decode(z).numpy()


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_fx_pow2_both_branches_match(stream, width, integ, frac):
    got, want = _run(stream, width, integ, frac, POW_X, jsm.fx_pow2,
                     tsm.fx_pow2)
    _rep_equal(got.tensor, want.tensor, "fx_pow2")
    assert np.allclose(_decoded(got), 2.0 ** POW_X, rtol=1e-3, atol=1e-3)
    got, want = _run(
        stream, width, integ, frac, POW_X,
        lambda s, v: jsm.fx_pow2(s, v, lower_bounded=True),
        lambda s, v: tsm.fx_pow2(s, v, lower_bounded=True),
    )
    _rep_equal(got.tensor, want.tensor, "fx_pow2 lower_bounded")
    assert np.allclose(_decoded(got), 2.0 ** POW_X, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_fx_pow2_clamps_below_minus_f(stream, width, integ, frac):
    got, want = _run(stream, width, integ, frac, UNDER_X, jsm.fx_pow2,
                     tsm.fx_pow2)
    _rep_equal(got.tensor, want.tensor, "fx_pow2 clamped")
    assert np.allclose(_decoded(got), 2.0 ** UNDER_X, atol=2.0 ** -(frac - 3))


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_fx_exp_matches(stream, width, integ, frac):
    x = POW_X * 0.6
    got, want = _run(stream, width, integ, frac, x, jsm.fx_exp, tsm.fx_exp)
    _rep_equal(got.tensor, want.tensor, "fx_exp")
    assert np.allclose(_decoded(got), np.exp(x), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_int2fl_matches(stream, width, integ, frac):
    x = np.array([-37.5, -1.0, 0.0, 0.125, 3.0, 100.25])
    if width == 64:
        x = x / 2.0  # inside +-2^(i-1) at fixed(8, 17)

    def run(mod, s, v):
        return mod.int2fl(s, v.tensor, integ + frac, frac)

    got, want = _run(stream, width, integ, frac, x,
                     lambda s, v: run(jsm, s, v), lambda s, v: run(tsm, s, v))
    for g, w, label in zip(got, want, ("v", "p", "s", "z")):
        _rep_equal(g, w, f"int2fl {label}")
    # x = (1 - 2s)(1 - z) v 2^p with v in [0.5, 1) at scale f
    v = tspmd.fx_reveal_decode(tspmd.SpmdFixed(got[0], integ, frac)).numpy()
    p, s, z = (tring.fixedpoint_decode(*tspmd.reveal(t), 0).numpy()
               for t in got[1:])
    rebuilt = (1 - 2 * s) * (1 - z) * v * 2.0 ** p
    assert np.allclose(rebuilt, x, rtol=1e-4)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_fx_log2_log_and_sqrt_match(stream, width, integ, frac):
    for name, want_fn in (("fx_log2", np.log2), ("fx_log", np.log),
                          ("fx_sqrt", np.sqrt)):
        got, want = _run(stream, width, integ, frac, POS_X,
                         getattr(jsm, name), getattr(tsm, name))
        _rep_equal(got.tensor, want.tensor, name)
        assert np.allclose(_decoded(got), want_fn(POS_X), atol=5e-3,
                           rtol=1e-3), name
