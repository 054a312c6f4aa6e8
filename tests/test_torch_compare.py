"""The port's bit sharings and comparisons
(moose_tpu_torch/parallel/spmd_math.py) against moose_tpu on the CPU:
``share_bits``/``reveal_bits``, ``kogge_stone``, ``bit_compose``,
``less``, ``greater``, ``equal_zero_bit`` and ``equal_bit``.  Under one
master key both packages draw the same masks and banks in either threefry
stream, so every share agrees word for word; the revealed results are
also checked against the plaintext comparison."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm

from torch_parity import assert_words_equal, prf

MK = np.array([0x13579BDF, 0x2468ACE0, 0x0F0F0F0F, 0xF0E1D2C3], np.uint32)
STREAMS = ("threefry", "threefry-pallas")
# (width, integral, fractional)
PRECISIONS = ((128, 24, 40), (64, 8, 17))
# one logical shape (6,) for the comparisons, so the JAX package's eager
# kernels compile once per width
X = np.array([-3.5, -1e-4, 0.0, 2.25, 7.0, -0.5])
Y = np.array([-3.5, 1e-4, 0.25, 2.0, -7.0, -0.5])


def _rep_equal(got, want, label=""):
    assert got.width == want.width
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


def _bits_equal(got, want, label=""):
    assert np.array_equal(got.arr.numpy(), np.asarray(want.arr)), label


def _sessions():
    return jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")


def _shared(js, ts, width, integ, frac, *values):
    jx = [jspmd.fx_encode_share(js, jnp.asarray(v), integ, frac, width)
          .tensor for v in values]
    tx = [tspmd.fx_encode_share(ts, torch.as_tensor(v), integ, frac, width)
          .tensor for v in values]
    return jx, tx


@pytest.mark.parametrize("stream", STREAMS)
def test_share_and_reveal_bits_match(stream):
    b = np.random.default_rng(1).integers(0, 2, size=(4, 7), dtype=np.uint8)
    js, ts = _sessions()
    with prf(stream):
        jb = jsm.share_bits(js, jnp.asarray(b))
        tb = tsm.share_bits(ts, torch.from_numpy(b))
    _bits_equal(tb, jb, "share_bits")
    assert tb.arr.dtype == torch.uint8 and tb.shape == (4, 7)
    assert np.array_equal(tsm.reveal_bits(tb).numpy(), b)
    assert np.array_equal(np.asarray(jsm.reveal_bits(jb)), b)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("k", (8, 64))
def test_kogge_stone_adds_bit_shares(stream, k):
    rng = np.random.default_rng(k)
    a = rng.integers(0, 1 << (k - 1), size=5, dtype=np.uint64)
    b = rng.integers(0, 1 << (k - 1), size=5, dtype=np.uint64)

    def planes(v):  # (k, 5) bits, LSB first
        return ((v[None, :] >> np.arange(k, dtype=np.uint64)[:, None])
                & np.uint64(1)).astype(np.uint8)

    js, ts = _sessions()
    with prf(stream):
        ja, jb = (jsm.share_bits(js, jnp.asarray(planes(v))) for v in (a, b))
        ta, tb = (tsm.share_bits(ts, torch.from_numpy(planes(v)))
                  for v in (a, b))
        jz = jsm.kogge_stone(js, ja, jb, k)
        tz = tsm.kogge_stone(ts, ta, tb, k)
    _bits_equal(tz, jz, "kogge_stone")
    assert ts._counter == js._counter
    got = tsm.reveal_bits(tz).numpy().astype(np.uint64)
    total = (got << np.arange(k, dtype=np.uint64)[:, None]).sum(
        axis=0, dtype=np.uint64)
    mask = np.uint64((1 << k) - 1)
    assert np.array_equal(total & mask, (a + b) & mask)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_bit_compose_inverts_bit_decompose(stream, width, integ, frac):
    js, ts = _sessions()
    with prf(stream):
        (jx,), (tx,) = _shared(js, ts, width, integ, frac, X)
        jz = jsm.bit_compose(js, jsm.bit_decompose(js, jx), width)
        tz = tsm.bit_compose(ts, tsm.bit_decompose(ts, tx), width)
    _rep_equal(tz, jz, "bit_compose")
    assert_words_equal(tspmd.reveal(tz), tspmd.reveal(tx), "composed value")


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_less_and_greater_match(stream, width, integ, frac):
    js, ts = _sessions()
    with prf(stream):
        (jx, jy), (tx, ty) = _shared(js, ts, width, integ, frac, X, Y)
        jl, tl = jsm.less(js, jx, jy), tsm.less(ts, tx, ty)
        jg, tg = jsm.greater(js, jx, jy), tsm.greater(ts, tx, ty)
    _bits_equal(tl, jl, "less")
    _bits_equal(tg, jg, "greater")
    # the comparison of the encoded values (-1e-4 and 1e-4 stay apart at
    # both precisions; equal inputs are neither less nor greater)
    assert tsm.reveal_bits(tl).tolist() == (X < Y).astype(int).tolist()
    assert tsm.reveal_bits(tg).tolist() == (X > Y).astype(int).tolist()


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_equal_zero_and_equal_bits_match(stream, width, integ, frac):
    js, ts = _sessions()
    with prf(stream):
        (jx, jy), (tx, ty) = _shared(js, ts, width, integ, frac, X, Y)
        jz, tz = jsm.equal_zero_bit(js, jx), tsm.equal_zero_bit(ts, tx)
        je, te = jsm.equal_bit(js, jx, jy), tsm.equal_bit(ts, tx, ty)
    _bits_equal(tz, jz, "equal_zero_bit")
    _bits_equal(te, je, "equal_bit")
    assert ts._counter == js._counter
    assert tsm.reveal_bits(tz).tolist() == (X == 0).astype(int).tolist()
    assert tsm.reveal_bits(te).tolist() == (X == Y).astype(int).tolist()


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_public_raw_helpers_match(width, integ, frac):
    js, ts = _sessions()
    with prf("threefry"):
        (jx,), (tx,) = _shared(js, ts, width, integ, frac, X)
    raw = (1 << (width - 1)) + 977
    _rep_equal(tsm.mul_public_raw(tx, raw), jsm.mul_public_raw(jx, raw),
               "mul_public_raw")
    got = tsm.fx_add_public_raw(tspmd.SpmdFixed(tx, integ, frac), raw)
    want = jsm.fx_add_public_raw(jspmd.SpmdFixed(jx, integ, frac), raw)
    assert (got.integral_precision, got.fractional_precision) == (integ, frac)
    _rep_equal(got.tensor, want.tensor, "fx_add_public_raw")
