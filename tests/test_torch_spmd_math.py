"""The port's protocol sigmoid (moose_tpu_torch/parallel/spmd_math.py)
and the elementwise protocol it stands on (secure and public multiplies,
public adds, sums) against moose_tpu: under one master key and the
threefry PRF both packages draw the same masks and banks, so every share
agrees word for word."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.dialects import ring as jring
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    threefry,
)

MK = np.array([0x0F1E2D3C, 0x4B5A6978, 0x8796A5B4, 0xC3D2E1F0], np.uint32)
# (width, integral, fractional): ring64 divides only below 2(i+f) <= 64
PRECISIONS = ((128, 24, 40), (64, 8, 17))
# one logical shape (6,) for every test, so the JAX package's eager
# kernels compile once per width and the file stays quick


def _rep_equal(got, want, label=""):
    assert got.width == want.width
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


def _shared(width, integ, frac, *values):
    """Both sessions and the fixed-point sharings of ``values`` in each."""
    js = jspmd.SpmdSession(MK)
    ts = tspmd.SpmdSession(MK, "cpu")
    jx = [jspmd.fx_encode_share(js, jnp.asarray(v), integ, frac, width)
          for v in values]
    tx = [tspmd.fx_encode_share(ts, torch.as_tensor(v), integ, frac, width)
          for v in values]
    return js, ts, jx, tx


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_multiplies_and_public_ops_match(threefry, width, integ, frac):
    rng = np.random.default_rng(width)
    a, b = rng.normal(size=6), rng.normal(size=6)
    js, ts, (ja, jb), (ta, tb) = _shared(width, integ, frac, a, b)
    _rep_equal(tspmd.mul(ts, ta.tensor, tb.tensor),
               jspmd.mul(js, ja.tensor, jb.tensor), "mul")
    tz, jz = tspmd.fx_mul(ts, ta, tb), jspmd.fx_mul(js, ja, jb)
    _rep_equal(tz.tensor, jz.tensor, "fx_mul")
    assert np.abs(tspmd.fx_reveal_decode(tz).numpy() - a * b).max() < \
        2.0 ** -(frac - 4)
    _rep_equal(tspmd.fx_mul_public(ts, ta, math.log2(math.e)).tensor,
               jspmd.fx_mul_public(js, ja, math.log2(math.e)).tensor,
               "fx_mul_public")
    _rep_equal(tspmd.fx_add_public(ta, -1.25).tensor,
               jspmd.fx_add_public(ja, -1.25).tensor, "fx_add_public")
    raw = (1 << (width - 1)) + 12345
    c_t = tring.fill_like_shape((), width, raw, "cpu")
    c_j = jring.fill_like_shape((), width, raw)
    for name in ("add_public", "sub_public", "mul_public"):
        _rep_equal(getattr(tspmd, name)(ta.tensor, *c_t),
                   getattr(jspmd, name)(ja.tensor, *c_j), name)
    _rep_equal(tspmd.public_sub(*c_t, ta.tensor),
               jspmd.public_sub(*c_j, ja.tensor), "public_sub")
    _rep_equal(tspmd.fill_public((6,), width, raw, "cpu"),
               jspmd.fill_public((6,), width, raw), "fill_public")
    for axis in (0, -1):
        _rep_equal(tspmd.sum_axis(ta.tensor, axis),
                   jspmd.sum_axis(ja.tensor, axis), f"sum_axis {axis}")
    _rep_equal(tspmd.fx_add(ta, tb).tensor, jspmd.fx_add(ja, jb).tensor)
    _rep_equal(tspmd.fx_sub(ta, tb).tensor, jspmd.fx_sub(ja, jb).tensor)


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_bit_protocols_match(threefry, width, integ, frac):
    x = np.array([-3.5, -1e-4, 0.0, 2.25, 7.0, -0.5])
    js, ts, (jx,), (tx,) = _shared(width, integ, frac, x)
    tbits = tsm.bit_decompose(ts, tx.tensor)
    jbits = jsm.bit_decompose(js, jx.tensor)
    assert np.array_equal(tbits.arr.numpy(), np.asarray(jbits.arr))
    tm, jm = tsm.msb(ts, tx.tensor), jsm.msb(js, jx.tensor)
    assert np.array_equal(tm.arr.numpy(), np.asarray(jm.arr))
    # the revealed msb is the sign
    revealed = tm.arr[0, 0] ^ tm.arr[1, 0] ^ tm.arr[2, 0]
    assert revealed.tolist() == [1, 1, 0, 0, 0, 1]
    _rep_equal(tsm.b2a(ts, tm, width), jsm.b2a(js, jm, width), "b2a")
    _rep_equal(tsm.mux_bit(ts, tm, tspmd.neg(tx.tensor), tx.tensor),
               jsm.mux_bit(js, jm, jspmd.neg(jx.tensor), jx.tensor),
               "mux_bit")
    tor = tsm.bits_or(ts, tbits, tsm.shl_bits(tbits, 3))
    jor = jsm.bits_or(js, jbits, jsm.shl_bits(jbits, 3))
    assert np.array_equal(tor.arr.numpy(), np.asarray(jor.arr))
    assert np.array_equal(tsm.bits_not(tm).arr.numpy(),
                          np.asarray(jsm.bits_not(jm).arr))


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_polynomial_eval_matches(threefry, width, integ, frac):
    x = np.array([0.1, 0.5, 0.9, 0.0, 0.3, 0.75])
    coeffs = [1.0, 0.5, -0.25, 0.125, 2.0 ** -(frac + 3)]
    js, ts, (jx,), (tx,) = _shared(width, integ, frac, x)
    tz = tsm.polynomial_eval(ts, coeffs, tx)
    jz = jsm.polynomial_eval(js, coeffs, jx)
    _rep_equal(tz.tensor, jz.tensor, "polynomial_eval")
    want = 1 + 0.5 * x - 0.25 * x ** 2 + 0.125 * x ** 3
    assert np.abs(tspmd.fx_reveal_decode(tz).numpy() - want).max() < \
        2.0 ** -(frac - 4)
    # one coefficient left after dropping: a public fill, no draws
    const = tsm.polynomial_eval(ts, [0.75, 1e-30], tx)
    assert np.all(tspmd.fx_reveal_decode(const).numpy() == 0.75)


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_fx_div_matches(threefry, width, integ, frac):
    a = np.array([1.0, -2.5, 3.0, 0.125, 0.0, 6.0])
    b = np.array([3.0, 0.5, 7.25, 1.5, 2.0, 0.75])
    js, ts, (ja, jb), (ta, tb) = _shared(width, integ, frac, a, b)
    tz = tsm.fx_div(ts, ta, tb)
    _rep_equal(tz.tensor, jsm.fx_div(js, ja, jb).tensor, "fx_div")
    assert np.abs(tspmd.fx_reveal_decode(tz).numpy() - a / b).max() < 1e-3


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_fx_sigmoid_matches(threefry, width, integ, frac):
    # |x| stays inside e^|x| < 2^i at the ring64 precision
    x = np.array([-4.0, -1.5, -0.25, 0.0, 0.5, 4.5])
    js, ts, (jx,), (tx,) = _shared(width, integ, frac, x)
    tz = tsm.fx_sigmoid(ts, tx)
    _rep_equal(tz.tensor, jsm.fx_sigmoid(js, jx).tensor, "fx_sigmoid")
    got = tspmd.fx_reveal_decode(tz).numpy()
    assert np.abs(got - 1 / (1 + np.exp(-x))).max() < 5e-3


def test_division_refuses_too_narrow_a_ring(threefry):
    _, ts, _, (ta,) = _shared(64, 14, 23, np.ones(2))
    with pytest.raises(Exception, match="ring width"):
        tsm.fx_div(ts, ta, ta)
