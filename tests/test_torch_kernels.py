"""The port's K1 (dot_cross_terms) and K2 (trunc_combine) against the
JAX package's Pallas kernels (interpret mode on the CPU) and their lax
twins, word for word.  The CUDA kernels against their plain versions:
tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest
from moose_tpu.dialects import ring as jring
from moose_tpu.native import ring128_kernels as jrk
from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.native import ring_kernels as rk

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    rand_words,
    to_jax,
    to_port,
)

WIDTHS = (64, 128)
# (m, k, n): ragged on purpose, plus the shapes of the slice's graphs cut
# to size (an (m, 101) @ (101, 1) linear regressor)
DOT_SHAPES = ((5, 7, 3), (1, 1, 1), (4, 101, 1), (9, 33, 17))
TRUNC_SHAPES = ((4, 5), (9,), (3, 1))


def _dot_inputs(seed, m, k, n, width):
    rng = np.random.default_rng(seed)
    x0 = rand_words(rng, (3, m, k), width)
    x1 = rand_words(rng, (3, m, k), width)
    y0 = rand_words(rng, (3, k, n), width)
    y1 = rand_words(rng, (3, k, n), width)
    return x0, x1, y0, y1


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", DOT_SHAPES)
def test_dot_cross_terms_plain_matches_lax_twin(width, shape):
    m, k, n = shape
    x0, x1, y0, y1 = _dot_inputs(m * 100 + k + n, m, k, n, width)
    jx0, jx1, jy0, jy1 = map(to_jax, (x0, x1, y0, y1))
    jys = jring.add(*jy0, *jy1)
    want = jring.add(
        *jspmd._dot_contract(*jx0, *jys), *jspmd._dot_contract(*jx1, *jy0)
    )
    ys = tring.add(*to_port(y0), *to_port(y1))
    got = rk.dot_cross_terms_plain(
        to_port(x0), to_port(x1), to_port(y0), ys, width
    )
    assert_words_equal(got, want, f"dot{shape}/ring{width}")


@pytest.mark.parametrize("width", WIDTHS)
def test_dot_cross_terms_plain_matches_pallas_kernel(width):
    m, k, n = 5, 7, 3
    x0, x1, y0, y1 = _dot_inputs(width, m, k, n, width)
    jy0, jy1 = to_jax(y0), to_jax(y1)
    jys = jring.add(*jy0, *jy1)
    want = jrk.dot_cross_terms(to_jax(x0), to_jax(x1), jy0, jys, width)
    ys = tring.add(*to_port(y0), *to_port(y1))
    before = dict(rk.LAUNCHES)
    got = rk.dot_cross_terms(to_port(x0), to_port(x1), to_port(y0), ys,
                             width)
    assert_words_equal(got, want, f"pallas dot/ring{width}")
    # CPU tensors take the plain version and launch nothing
    assert rk.LAUNCHES == before


def _trunc_inputs(seed, shape, width):
    rng = np.random.default_rng(seed)
    return [rand_words(rng, shape, width) for _ in range(7)]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("amount", (0, 7, 23, 40, 62))
def test_trunc_combine_plain_matches_lax_twin(width, amount):
    for shape in TRUNC_SHAPES:
        ins = _trunc_inputs(amount + width, shape, width)
        a0, a1, *draws = ins
        want = jspmd._trunc_combine_lax(
            to_jax(a0), to_jax(a1), tuple(map(to_jax, draws)), width, amount
        )
        got = rk.trunc_combine(
            to_port(a0), to_port(a1), tuple(map(to_port, draws)), width,
            amount,
        )
        assert_words_equal(got, want, f"trunc{shape}/{amount}/ring{width}")


EDGE_WORDS = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                      dtype=np.uint64)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("amount", (23, 40))
def test_trunc_combine_plain_matches_lax_twin_on_edge_words(width, amount):
    # every input word drawn from the carry/sign edge values, so masks,
    # reveal and the MSB overflow correction all wrap
    rng = np.random.default_rng(width * amount)
    ins = [
        (rng.choice(EDGE_WORDS, size=(5, 5)),
         None if width == 64 else rng.choice(EDGE_WORDS, size=(5, 5)))
        for _ in range(7)
    ]
    a0, a1, *draws = ins
    want = jspmd._trunc_combine_lax(
        to_jax(a0), to_jax(a1), tuple(map(to_jax, draws)), width, amount
    )
    got = rk.trunc_combine_plain(
        to_port(a0), to_port(a1), tuple(map(to_port, draws)), width, amount
    )
    assert_words_equal(got, want, f"edge trunc/{amount}/ring{width}")


@pytest.mark.parametrize("width", WIDTHS)
def test_trunc_combine_plain_matches_pallas_kernel(width):
    amount = 40 if width == 128 else 23
    shape = (4, 5)
    a0, a1, *draws = _trunc_inputs(width, shape, width)
    want = jrk.trunc_combine(
        to_jax(a0), to_jax(a1), tuple(map(to_jax, draws)), width, amount,
        shape,
    )
    got = rk.trunc_combine_plain(
        to_port(a0), to_port(a1), tuple(map(to_port, draws)), width, amount
    )
    assert_words_equal(got, want, f"pallas trunc/ring{width}")


def test_plain_dot_runs_beyond_one_float64_chunk(monkeypatch):
    # a contraction split over several exact float64 chunks sums the
    # same as one
    monkeypatch.setattr(rk, "_F64_CHUNK", 4)
    m, k, n, width = 3, 11, 2, 128
    x0, x1, y0, y1 = _dot_inputs(11, m, k, n, width)
    jx0, jx1, jy0, jy1 = map(to_jax, (x0, x1, y0, y1))
    jys = jring.add(*jy0, *jy1)
    want = jring.add(
        *jspmd._dot_contract(*jx0, *jys), *jspmd._dot_contract(*jx1, *jy0)
    )
    ys = tring.add(*to_port(y0), *to_port(y1))
    got = rk.dot_cross_terms_plain(
        to_port(x0), to_port(x1), to_port(y0), ys, width
    )
    assert_words_equal(got, want)
