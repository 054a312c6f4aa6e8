"""The port's bit draws, ring sums and kernels K3 (cross_terms_mul), K4
(ring_mul) and K5 (bit_decompose/msb) against the JAX package: the plain
versions against the lax twins at several shapes and on edge words, and
against the Pallas kernels in interpret mode at one tiny shape per
width, word for word.  The CUDA kernels against their plain versions:
tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.dialects import ring as jring
from moose_tpu.native import ring128_kernels as jrk
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch import interop
from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    rand_words,
    threefry,
    to_jax,
    to_port,
)

WIDTHS = (64, 128)
SHAPES = ((3, 5), (3, 17), (3, 2, 3, 7), (3, 64, 9))
EDGE_WORDS = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                      dtype=np.uint64)
MK = np.array([0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D], np.uint32)


def _edge_words(rng, shape, width):
    lo = rng.choice(EDGE_WORDS, size=shape)
    return lo, None if width == 64 else rng.choice(EDGE_WORDS, size=shape)


@pytest.mark.parametrize("domain", (0, 5))
def test_bit_bank_draws_match(threefry, domain):
    js = jspmd.SpmdSession(MK, domain=domain)
    ts = tspmd.SpmdSession(MK, "cpu", domain=domain)
    for shape in ((128, 4), (7,), (64, 2, 3)):
        got = ts.sample_bit_bank(shape)
        want = np.asarray(js.sample_bit_bank(shape))
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want)
    # a bit draw and a uniform draw advance the same nonce counter
    assert_words_equal(ts.sample((3,), 128), js.sample((3,), 128))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("axis", (0, 1, 2))
def test_sum_matches_jax(width, axis):
    rng = np.random.default_rng(width + axis)
    for words in (rand_words(rng, (9, 4, 3), width),
                  _edge_words(rng, (9, 4, 3), width)):
        assert_words_equal(
            tring.sum_(*to_port(words), axis=axis),
            jring.sum_(*to_jax(words), axis=axis),
            f"sum axis {axis}/ring{width}",
        )


@pytest.mark.parametrize("width", WIDTHS)
def test_python_int_lift_matches_jax(width):
    values = [0, 1, (1 << 63) + 5, (1 << 64) - 1, 1 << 64, (1 << 127) + 3]
    values = [v % (1 << width) for v in values]
    assert_words_equal(
        tring.from_python_ints(values, width, "cpu"),
        jring.from_python_ints(values, width),
    )


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_cross_terms_mul_plain_matches_lax_twin(width, shape):
    rng = np.random.default_rng(sum(shape) + width)
    for draw in (rand_words, _edge_words):
        x0, x1, y0, y1 = (draw(rng, shape, width) for _ in range(4))
        jy0 = to_jax(y0)
        want = jring.add(
            *jring.mul(*to_jax(x0), *jring.add(*jy0, *to_jax(y1))),
            *jring.mul(*to_jax(x1), *jy0),
        )
        got = rk.cross_terms_mul(*map(to_port, (x0, x1, y0, y1)), width)
        assert_words_equal(got, want, f"cross{shape}/ring{width}")


@pytest.mark.parametrize("width", WIDTHS)
def test_cross_terms_mul_plain_matches_pallas_kernel(width):
    x0, x1, y0, y1 = (
        rand_words(np.random.default_rng(width + i), (3, 5), width)
        for i in range(4)
    )
    want = jrk.cross_terms_mul(*map(to_jax, (x0, x1, y0, y1)), width)
    before = dict(rk.LAUNCHES)
    got = rk.cross_terms_mul(*map(to_port, (x0, x1, y0, y1)), width)
    assert_words_equal(got, want, f"pallas cross/ring{width}")
    assert rk.LAUNCHES == before  # CPU tensors launch nothing


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ring_mul_plain_matches_lax_twin(width, shape):
    rng = np.random.default_rng(sum(shape) * width)
    for draw in (rand_words, _edge_words):
        a, b = draw(rng, shape, width), draw(rng, shape, width)
        assert_words_equal(
            rk.ring_mul(*to_port(a), *to_port(b), width),
            jring.mul(*to_jax(a), *to_jax(b)),
            f"ring_mul{shape}/ring{width}",
        )


@pytest.mark.parametrize("width", WIDTHS)
def test_ring_mul_plain_matches_pallas_kernel(width):
    rng = np.random.default_rng(width)
    a, b = (rand_words(rng, (3, 2, 4), width) for _ in range(2))
    assert_words_equal(
        rk.ring_mul(*to_port(a), *to_port(b), width),
        jrk.ring_mul(*to_jax(a), *to_jax(b), width),
        f"pallas ring_mul/ring{width}",
    )


def test_adder_bank_count_matches_jax():
    for width in WIDTHS:
        assert rk.adder_bank_count(width) == jrk.adder_bank_count(width)
    assert rk.adder_bank_count(128) == 16


def _bits_inputs(seed, shape, width, edge=False):
    rng = np.random.default_rng(seed)
    draw = _edge_words if edge else rand_words
    x = draw(rng, (3, 2) + shape, width)
    banks = rng.integers(
        0, 2, size=(rk.adder_bank_count(width), 3, width) + shape,
        dtype=np.uint8,
    )
    return x, banks


def _port_banks(banks):
    return torch.from_numpy(banks.copy())


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", ((4,), (2, 3), (1,)))
def test_bit_decompose_plain_matches_lax_twin(width, shape):
    for edge in (False, True):
        x, banks = _bits_inputs(len(shape) + width, shape, width, edge)
        want = np.asarray(jsm._bit_decompose_with_banks(
            *to_jax(x), width, jnp.asarray(banks)
        ))
        got = rk.bit_decompose(*to_port(x), width, _port_banks(banks))
        assert got.shape == (3, 2, width) + shape
        assert np.array_equal(got.numpy(), want)
        got_msb = rk.msb(*to_port(x), width, _port_banks(banks))
        assert np.array_equal(got_msb.numpy(), want[:, :, width - 1])


@pytest.mark.parametrize("width", WIDTHS)
def test_bits_adder_plain_matches_pallas_kernels(width):
    x, banks = _bits_inputs(width, (2,), width)
    jx, jbanks = to_jax(x), jnp.asarray(banks)
    want = np.asarray(jrk.bit_decompose(*jx, width, jbanks))
    want_msb = np.asarray(jrk.msb(*jx, width, jbanks))
    before = dict(rk.LAUNCHES)
    got = rk.bit_decompose(*to_port(x), width, _port_banks(banks))
    got_msb = rk.msb(*to_port(x), width, _port_banks(banks))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got_msb.numpy(), want_msb)
    assert rk.LAUNCHES == before


def test_bits_adder_refuses_a_wrong_bank_count():
    x, banks = _bits_inputs(3, (2,), 64)
    for wrong in (banks[:-1], np.concatenate([banks, banks[:1]])):
        with pytest.raises(ValueError, match="banks"):
            rk.bit_decompose(*to_port(x), 64, _port_banks(wrong))


def test_word_layout_of_bit_planes():
    # bit j of a held share is plane j: (1 << 63) | 5 lights bits 0, 2, 63
    lo = np.zeros((3, 2, 1), np.uint64)
    lo[0, 0, 0] = (1 << 63) | 5
    banks = np.zeros((rk.adder_bank_count(64), 3, 64, 1), np.uint8)
    bits = rk.bit_decompose(
        interop.ring_from_numpy(lo, device="cpu")[0], None, 64,
        _port_banks(banks),
    )
    # x = x_0 alone, with zero banks: party 0's slot 0 holds the bits
    assert [int(b) for b in np.flatnonzero(bits[0, 0, :, 0].numpy())] == \
        [0, 2, 63]
