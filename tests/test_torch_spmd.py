"""The port's party-stacked protocol (moose_tpu_torch/parallel/spmd.py)
against moose_tpu/parallel/spmd.py: under one master key and the threefry
PRF both draw the same masks, so shares agree word for word."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    rand_words,
    threefry,
    to_jax,
    to_port,
)

MK = np.array([0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D], np.uint32)


def _sessions(domain=0):
    return (
        jspmd.SpmdSession(MK, domain=domain),
        tspmd.SpmdSession(MK, "cpu", domain=domain),
    )


def _assert_rep_equal(got, want, label=""):
    assert got.width == want.width
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


@pytest.mark.parametrize("domain", (0, 3))
@pytest.mark.parametrize("width", (64, 128))
def test_session_draws_match(threefry, domain, width):
    js, ts = _sessions(domain)
    for shape in ((2, 3), (5,)):
        assert_words_equal(
            ts.sample_bank(shape, width), js.sample_bank(shape, width)
        )
        assert_words_equal(ts.sample(shape, width), js.sample(shape, width))


@pytest.mark.parametrize("width", (64, 128))
def test_share_reveal_match(threefry, width):
    js, ts = _sessions()
    x = rand_words(np.random.default_rng(width), (4, 3), width)
    jrep = jspmd.share(js, *to_jax(x), width)
    trep = tspmd.share(ts, *to_port(x), width)
    _assert_rep_equal(trep, jrep, "share")
    assert_words_equal(tspmd.reveal(trep), x, "reveal")
    assert_words_equal(tspmd.zero_share(ts, (4, 3), width),
                       jspmd.zero_share(js, (4, 3), width), "zero_share")


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("amount", (23, 40))
def test_trunc_pr_matches(threefry, width, amount):
    js, ts = _sessions()
    x = rand_words(np.random.default_rng(amount), (3, 4), width)
    jrep = jspmd.share(js, *to_jax(x), width)
    trep = tspmd.share(ts, *to_port(x), width)
    _assert_rep_equal(
        tspmd.trunc_pr(ts, trep, amount), jspmd.trunc_pr(js, jrep, amount),
        "trunc_pr",
    )


@pytest.mark.parametrize("width,precision,shapes", (
    (128, (24, 40), ((8, 6), (6, 1))),
    (128, (14, 23), ((6, 5), (5, 4))),
    (64, (14, 23), ((6, 5), (5, 4))),
))
def test_fx_dot_shares_match(threefry, width, precision, shapes):
    integ, frac = precision
    rng = np.random.default_rng(frac)
    x = rng.normal(size=shapes[0])
    y = rng.normal(size=shapes[1])
    js, ts = _sessions()
    jx = jspmd.fx_encode_share(js, jnp.asarray(x), integ, frac, width)
    jy = jspmd.fx_encode_share(js, jnp.asarray(y), integ, frac, width)
    jz = jspmd.fx_dot(js, jx, jy)
    tx = tspmd.fx_encode_share(ts, torch.as_tensor(x), integ, frac, width)
    ty = tspmd.fx_encode_share(ts, torch.as_tensor(y), integ, frac, width)
    tz = tspmd.fx_dot(ts, tx, ty)
    _assert_rep_equal(tz.tensor, jz.tensor, "fx_dot shares")
    assert (tz.integral_precision, tz.fractional_precision) == (integ, frac)
    want = np.asarray(jspmd.fx_reveal_decode(jz))
    got = tspmd.fx_reveal_decode(tz).numpy()
    assert np.array_equal(got, want)
    assert np.abs(got - x @ y).max() < 2.0 ** -(frac - 6)


def test_dot_without_truncation_matches(threefry):
    width = 64
    js, ts = _sessions()
    rng = np.random.default_rng(9)
    x = rand_words(rng, (3, 4), width)
    y = rand_words(rng, (4, 2), width)
    jz = jspmd.dot(js, jspmd.share(js, *to_jax(x), width),
                   jspmd.share(js, *to_jax(y), width))
    tz = tspmd.dot(ts, tspmd.share(ts, *to_port(x), width),
                   tspmd.share(ts, *to_port(y), width))
    _assert_rep_equal(tz, jz, "dot")


@pytest.mark.parametrize("width", (64, 128))
def test_structural_ops_match(threefry, width):
    js, ts = _sessions()
    rng = np.random.default_rng(width + 1)
    a = rand_words(rng, (2, 3), width)
    b = rand_words(rng, (2, 1), width)
    ja = jspmd.share(js, *to_jax(a), width)
    jb = jspmd.share(js, *to_jax(b), width)
    ta = tspmd.share(ts, *to_port(a), width)
    tb = tspmd.share(ts, *to_port(b), width)
    _assert_rep_equal(tspmd.concat([tb, ta], 1), jspmd.concat([jb, ja], 1))
    _assert_rep_equal(tspmd.expand_dims(ta, -1), jspmd.expand_dims(ja, -1))
    _assert_rep_equal(tspmd.reshape(ta, (3, 2)), jspmd.reshape(ja, (3, 2)))
    _assert_rep_equal(tspmd.index_axis(ta, 1, 2),
                      jspmd.index_axis(ja, 1, 2))
    pub = rand_words(rng, (2, 2), width)
    _assert_rep_equal(tspmd.public_to_rep(*to_port(pub), width),
                      jspmd.public_to_rep(*to_jax(pub), width))
    _assert_rep_equal(tspmd.shl(ta, 5), jspmd.shl(ja, 5))
    _assert_rep_equal(tspmd.add(ta, ta), jspmd.add(ja, ja))
    _assert_rep_equal(tspmd.sub(ta, ta), jspmd.sub(ja, ja))
    _assert_rep_equal(tspmd.neg(ta), jspmd.neg(ja))


def test_vector_dot_names_its_roadmap_item(threefry):
    # named when the port refused vector operands, naming the ROADMAP
    # item that would bring them; they came with it: v @ v runs, a 0-d
    # product word for word the reference's (tests/test_torch_conv.py
    # holds the other vector shapes)
    js, ts = _sessions()
    words = rand_words(np.random.default_rng(1), (4,), 64)
    jv = jspmd.share(js, *to_jax(words), 64)
    tv = tspmd.share(ts, *to_port(words), 64)
    got = tspmd.dot(ts, tv, tv)
    assert got.shape == ()
    _assert_rep_equal(got, jspmd.dot(js, jv, jv), "vector dot")


def test_session_keeps_seed_words_on_the_host():
    ts = tspmd.SpmdSession(MK, "cpu")
    seed = ts._next_seed()
    assert all(isinstance(w, int) and 0 <= w < 1 << 32 for w in seed)
    assert tring.mix_seed(MK, (1, 0x5B3D9E21, 1 ^ 0xA5A5A5A5, 7)) == \
        ts._next_seed()
