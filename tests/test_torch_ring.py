"""Ring arithmetic, fixed-point codec and PRF of the port against the JAX
package, word for word (moose_tpu_torch/dialects/ring.py vs
moose_tpu/dialects/ring.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from moose_tpu.dialects import ring as jring

from moose_tpu_torch.dialects import ring as tring

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    rand_words,
    threefry,
    to_jax,
    to_port,
)

U64_MAX = (1 << 64) - 1
EDGE_WORDS = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
              (1 << 63) + 1, U64_MAX - 1, U64_MAX]
SHIFTS = (0, 1, 31, 32, 63, 64, 65, 87, 100, 127, 128, 130)

word = st.one_of(st.sampled_from(EDGE_WORDS), st.integers(0, U64_MAX))
words = st.lists(word, min_size=1, max_size=12)


def _pair(lo_list, hi_list, width):
    n = min(len(lo_list), len(hi_list))
    lo = np.array(lo_list[:n], dtype=np.uint64)
    hi = None if width == 64 else np.array(hi_list[:n], dtype=np.uint64)
    return lo, hi


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("op", ("add", "sub", "mul"))
@settings(max_examples=25, deadline=None)
@given(a_lo=words, a_hi=words, b_lo=words, b_hi=words)
def test_binary_ops_match_jax(width, op, a_lo, a_hi, b_lo, b_hi):
    n = min(map(len, (a_lo, a_hi, b_lo, b_hi)))
    a = _pair(a_lo[:n], a_hi[:n], width)
    b = _pair(b_lo[:n], b_hi[:n], width)
    want = getattr(jring, op)(*to_jax(a), *to_jax(b))
    got = getattr(tring, op)(*to_port(a), *to_port(b))
    assert_words_equal(got, want, f"{op}/ring{width}")


@pytest.mark.parametrize("width", (64, 128))
@settings(max_examples=25, deadline=None)
@given(lo=words, hi=words)
def test_neg_matches_jax(width, lo, hi):
    a = _pair(lo, hi, width)
    assert_words_equal(
        tring.neg(*to_port(a)), jring.neg(*to_jax(a)), f"neg/ring{width}"
    )


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("op", ("shl", "shr"))
@pytest.mark.parametrize("amount", SHIFTS)
def test_shifts_match_jax(width, op, amount):
    rng = np.random.default_rng(amount)
    lo = np.array(EDGE_WORDS + list(rng.integers(0, 1 << 64, 6,
                                                   dtype=np.uint64)),
                  dtype=np.uint64)
    hi = None if width == 64 else lo[::-1].copy()
    want = getattr(jring, op)(*to_jax((lo, hi)), amount)
    got = getattr(tring, op)(*to_port((lo, hi)), amount)
    assert_words_equal(got, want, f"{op}({amount})/ring{width}")


@settings(max_examples=40, deadline=None)
@given(a=words, b=words)
def test_mulwide_matches_jax(a, b):
    n = min(len(a), len(b))
    x = np.array(a[:n], dtype=np.uint64)
    y = np.array(b[:n], dtype=np.uint64)
    want_hi, want_lo = jring.mulwide_u64(jnp.asarray(x), jnp.asarray(y))
    got_hi, got_lo = tring.mulwide_u64(to_port((x, None))[0],
                                       to_port((y, None))[0])
    assert_words_equal((got_lo, got_hi), (want_lo, want_hi), "mulwide")


def test_mulhi_at_u64_max():
    x = np.array([U64_MAX, U64_MAX, 1 << 63], dtype=np.uint64)
    y = np.array([U64_MAX, 2, 1 << 63], dtype=np.uint64)
    got = tring.mulhi_u64(to_port((x, None))[0], to_port((y, None))[0])
    expect = [(int(a) * int(b)) >> 64 for a, b in zip(x, y)]
    assert_words_equal((got, None), (np.array(expect, np.uint64), None))


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("frac", (0, 23, 40))
def test_fixedpoint_encode_decode_match_jax(width, frac):
    rng = np.random.default_rng(frac + width)
    x = np.concatenate([
        rng.normal(size=20) * 1000.0,
        [0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 1e-12, -3.75],
    ])
    if frac == 0:
        x = np.round(x * 7.0)
    want = jring.fixedpoint_encode(jnp.asarray(x), frac, width)
    got = tring.fixedpoint_encode(torch.as_tensor(x), frac, width)
    assert_words_equal(got, want, "encode")
    dec_want = np.asarray(jring.fixedpoint_decode(*want, frac))
    dec_got = tring.fixedpoint_decode(*got, frac).numpy()
    assert np.array_equal(dec_got, dec_want)


@pytest.mark.parametrize("width", (64, 128))
def test_decode_of_random_words_matches_jax(width):
    pair = rand_words(np.random.default_rng(width), (64,), width)
    want = np.asarray(jring.fixedpoint_decode(*to_jax(pair), 40))
    got = tring.fixedpoint_decode(*to_port(pair), 40).numpy()
    assert np.array_equal(got, want)


def test_u64_to_float64_rounds_like_numpy():
    x = np.array(EDGE_WORDS + [(1 << 53) + 1, (1 << 64) - 1025,
                               (1 << 64) - 1024], dtype=np.uint64)
    got = tring.u64_to_float64(to_port((x, None))[0]).numpy()
    assert np.array_equal(got, x.astype(np.float64))


@pytest.mark.parametrize("seed_words", (
    (0, 0, 0, 0),
    (0xDEADBEEF, 1, 0x80000001, 0xFFFFFFFF),
    (77, 78, 79, 80),
))
def test_mix_seed_matches_jax_threefry(threefry, seed_words):
    seed = np.array(seed_words, dtype=np.uint32)
    for idx in (0, 1, 5, 0xFFFFFFFF):
        nonce = np.array(
            [idx, 0x5B3D9E21, idx ^ 0xA5A5A5A5, 7], dtype=np.uint32
        )
        want = np.asarray(jring.mix_seed(seed, nonce))
        assert tuple(int(w) for w in want) == tring.mix_seed(seed, nonce)


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("shape", ((), (7,), (3, 4, 5)))
def test_sample_uniform_seeded_matches_jax_threefry(threefry, width, shape):
    seed = np.array([1, 0x9E3779B9, 0xFFFFFFFF, 42], dtype=np.uint32)
    want = jring.sample_uniform_seeded(shape, seed, width)
    got = tring.sample_uniform_seeded(shape, tuple(seed), width, "cpu")
    assert_words_equal(got, want, f"sample{shape}/ring{width}")


def test_fill_like_shape_matches_jax():
    value = (1 << 127) + (1 << 64) + 5
    want = jring.fill_like_shape((2, 3), 128, value)
    got = tring.fill_like_shape((2, 3), 128, value, "cpu")
    assert_words_equal(got, want)
