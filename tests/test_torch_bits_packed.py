"""The layouts of the redesigned K5 (bits_adder) and K4 (ring_mul)
kernels, on the CPU.

K5 packs its uint8 AND banks into u64 masks and runs the adder on masks:
``bits_bank_masks_plain`` and ``bit_decompose_masks_plain`` model those
two stages and are held against the port's plain versions and the JAX
package's lax twin (``spmd_math._bit_decompose_with_banks``), bit for
bit.  K4 broadcasts the public factor itself: ``rk.ring_mul`` with b at
a broadcast shape, its collapsed stride walk (``ring_mul_dims``) and
``spmd.mul_public`` are held against the JAX ``ring.mul`` and
``mul_public``; the Pallas ring_mul once per width (test_torch_bits.py
holds the Pallas bit kernels against the port's plain versions).  The
CUDA kernels against their plain versions: tests/test_torch_cuda.py, on
the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.dialects import ring as jring
from moose_tpu.native import ring128_kernels as jrk
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import assert_words_equal, rand_words, to_jax, to_port

WIDTHS = (64, 128)
EDGE_WORDS = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                      dtype=np.uint64)
# element counts off the pack stage's 16-element groups and 64-bit words
COUNTS = ((1,), (5,), (17,), (2, 9))


def _edge_words(rng, shape, width):
    lo = rng.choice(EDGE_WORDS, size=shape)
    return lo, None if width == 64 else rng.choice(EDGE_WORDS, size=shape)


def _banks(rng, shape, width, fill=None):
    bank_shape = (rk.adder_bank_count(width), 3, width) + shape
    if fill is not None:
        return np.full(bank_shape, fill, dtype=np.uint8)
    return rng.integers(0, 2, size=bank_shape, dtype=np.uint8)


def _packed(x, width, banks, msb_only):
    tb = torch.from_numpy(banks.copy())
    masks = rk.bits_bank_masks_plain(tb, width)
    return rk.bit_decompose_masks_plain(*to_port(x), width, masks, msb_only)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", COUNTS)
@pytest.mark.parametrize("draw", ("random", "edge"))
@pytest.mark.parametrize("fill", (None, 0, 1))
def test_packed_adder_matches_plain(width, shape, draw, fill):
    rng = np.random.default_rng(width + sum(shape) + (fill or 0) * 7)
    x = (rand_words if draw == "random" else _edge_words)(
        rng, (3, 2) + shape, width)
    banks = _banks(rng, shape, width, fill)
    tb = torch.from_numpy(banks.copy())
    want = rk.bit_decompose_plain(*to_port(x), width, tb)
    got = _packed(x, width, banks, msb_only=False)
    assert got.dtype == torch.uint8 and got.shape == (3, 2, width) + shape
    assert torch.equal(got, want)
    assert torch.equal(_packed(x, width, banks, msb_only=True),
                       rk.msb_plain(*to_port(x), width, tb))


@pytest.mark.parametrize("width", WIDTHS)
def test_packed_adder_matches_jax_lax_twin(width):
    # one JAX call: 17 random elements, then 5 of edge words
    rng = np.random.default_rng(width)
    x = tuple(
        None if r is None else np.concatenate([r, e], axis=-1)
        for r, e in zip(rand_words(rng, (3, 2, 17), width),
                        _edge_words(rng, (3, 2, 5), width))
    )
    banks = _banks(rng, (22,), width)
    want = np.asarray(jsm._bit_decompose_with_banks(
        *to_jax(x), width, jnp.asarray(banks)))
    assert np.array_equal(_packed(x, width, banks, False).numpy(), want)
    assert np.array_equal(_packed(x, width, banks, True).numpy(),
                          want[:, :, width - 1])


def test_bank_mask_layout():
    # one bit set in the banks: bank 2, party 1, bit row 70 (word 1, bit
    # 6) of element 3 of 5; and bit row 63 (word 0, bit 63) of element 0
    banks = np.zeros((rk.adder_bank_count(128), 3, 128, 5), np.uint8)
    banks[2, 1, 70, 3] = 1
    banks[0, 2, 63, 0] = 1
    masks = rk.bits_bank_masks_plain(torch.from_numpy(banks), 128)
    assert masks.dtype == torch.int64
    assert masks.shape == (rk.adder_bank_count(128), 3, 2, 5)
    want = torch.zeros_like(masks)
    want[2, 1, 1, 3] = 1 << 6
    want[0, 2, 0, 0] = -(1 << 63)  # bit 63 of an int64 word
    assert torch.equal(masks, want)
    # the data axes flatten into the element axis, in order
    folded = rk.bits_bank_masks_plain(
        torch.from_numpy(banks.reshape(banks.shape[:3] + (5, 1))), 128)
    assert torch.equal(folded, want)


# b's shapes against the shares' (3, 2, 64, n) of spmd_math's weighted
# bit sums and public multiplies
B_SHAPES = ((), (64, 1), (1, 9), (1, 1, 9), (2, 1, 1), (3, 2, 64, 9))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("b_shape", B_SHAPES)
def test_ring_mul_broadcasts_b(width, b_shape):
    shape = (3, 2, 64, 9)
    rng = np.random.default_rng(width + len(b_shape))
    for draw in (rand_words, _edge_words):
        a, b = draw(rng, shape, width), draw(rng, b_shape, width)
        jb = tuple(None if w is None else jnp.broadcast_to(w, shape)
                   for w in to_jax(b))
        assert_words_equal(
            rk.ring_mul(*to_port(a), *to_port(b), width),
            jring.mul(*to_jax(a), *jb),
            f"ring_mul {b_shape}/ring{width}",
        )


@pytest.mark.parametrize("width", WIDTHS)
def test_ring_mul_broadcast_matches_the_pallas_kernel(width):
    rng = np.random.default_rng(width + 2)
    shape = (3, 2, 4)
    a, b = rand_words(rng, shape, width), rand_words(rng, (1, 4), width)
    jb = tuple(None if w is None else jnp.broadcast_to(w, shape)
               for w in to_jax(b))
    assert_words_equal(
        rk.ring_mul(*to_port(a), *to_port(b), width),
        jrk.ring_mul(*to_jax(a), *jb, width),
        f"pallas ring_mul broadcast/ring{width}",
    )


@pytest.mark.parametrize("b_shape,want", (
    ((64, 1), [(6, 0), (64, 1), (1024, 0)]),
    ((1, 1024), [(6 * 64, 0), (1024, 1)]),
    ((3, 2, 64, 1024), [(3 * 2 * 64 * 1024, 1)]),
    ((2, 1, 1), [(3, 0), (2, 1), (64 * 1024, 0)]),
))
def test_ring_mul_dims_collapse_the_broadcast(b_shape, want):
    b = torch.zeros(b_shape, dtype=torch.int64)
    assert rk.ring_mul_dims((3, 2, 64, 1024), b) == want


@pytest.mark.parametrize("b_shape", B_SHAPES[1:])
def test_ring_mul_dims_address_the_broadcast_words(b_shape):
    # walking the collapsed axes from b's first word reads exactly the
    # words of b broadcast to a's shape, for contiguous, transposed and
    # expanded b
    shape = (3, 2, 64, 9)
    base = torch.arange(int(np.prod(b_shape)), dtype=torch.int64)
    for b in (base.reshape(b_shape),
              base.reshape(b_shape[::-1]).permute(
                  *reversed(range(len(b_shape)))),
              base.reshape(b_shape).expand(shape)):
        dims = rk.ring_mul_dims(shape, b)
        offsets = torch.zeros(1, dtype=torch.int64)
        for size, stride in dims:
            offsets = (offsets[:, None]
                       + stride * torch.arange(size)).reshape(-1)
        flat = b.as_strided((b.untyped_storage().nbytes() // 8,), (1,), 0)
        got = flat[offsets + b.storage_offset()]
        assert torch.equal(got, torch.broadcast_to(b, shape).reshape(-1))


def test_ring_mul_refuses_b_that_does_not_broadcast():
    a = to_port(rand_words(np.random.default_rng(0), (3, 2, 4), 128))
    for b_shape in ((5,), (3, 2, 4, 1), (2, 2, 4)):
        b = to_port(rand_words(np.random.default_rng(1), b_shape, 128))
        with pytest.raises(ValueError, match="broadcast"):
            rk.ring_mul(*a, *b, 128)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("c_shape", ((), (64, 1), (1, 9)))
def test_mul_public_matches_jax(width, c_shape):
    rng = np.random.default_rng(width + len(c_shape))
    x = rand_words(rng, (3, 2, 64, 9), width)
    c = rand_words(rng, c_shape, width)
    want = jspmd.mul_public(jspmd.SpmdRep(*to_jax(x), width), *to_jax(c))
    got = tspmd.mul_public(tspmd.SpmdRep(*to_port(x), width), *to_port(c))
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi),
                       f"mul_public {c_shape}/ring{width}")
