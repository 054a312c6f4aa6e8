"""The arithmetic of the port's K1 CUDA kernel (csrc/dot_cross_terms.cu),
on the CPU, through its plain model ``dot_cross_terms_limbs_plain``: the
K-major 8-bit limb planes of the K-concatenated operands, the
per-diagonal sums reduced mod 2^32 at the kernel's segment depth, and the
fold into the ring word.  The model is held word for word against
``dot_cross_terms_plain`` and against the JAX package's K1 (its Pallas
kernel in interpret mode, and its lax twin where the Pallas kernel would
take minutes); the kernel itself against the plain version on the card:
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from moose_tpu.dialects import ring as jring
from moose_tpu.native import ring128_kernels as jrk
from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.native import ring_kernels as rk

from torch_parity import assert_words_equal, rand_words, to_jax, to_port

WIDTHS = (64, 128)
# ragged shapes, the edges of the 64-row and 32/64-column output tiles,
# the thin n of the predictors and trainers, K' across a 32-byte chunk,
# and k = 0
SHAPES = ((5, 7, 3), (1, 1, 1), (64, 16, 32), (65, 17, 33), (9, 33, 65),
          (4, 101, 1), (3, 40, 8), (2, 0, 3))
ONES = (1 << 64) - 1


def _ones(shape, width):
    words = np.full(shape, ONES, dtype=np.uint64)
    return words, None if width == 64 else words.copy()


def _operands(rng, m, k, n, width):
    return ([rand_words(rng, (3, m, k), width) for _ in range(2)]
            + [rand_words(rng, (3, k, n), width) for _ in range(2)])


def _port_args(x0, x1, y0, y1, width):
    ys = tring.add(*to_port(y0), *to_port(y1))
    return to_port(x0), to_port(x1), to_port(y0), ys


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert torch.equal(got[1], want[1])


def _lax_twin(x0, x1, y0, y1):
    jys = jring.add(*to_jax(y0), *to_jax(y1))
    return jring.add(*jspmd._dot_contract(*to_jax(x0), *jys),
                     *jspmd._dot_contract(*to_jax(x1), *to_jax(y0)))


def test_segment_depth_and_geometry():
    # (L-4) * K' * 255^2 < 2^32 for the diagonals that need their value
    assert rk.dot_segment_depth(128) == 5504
    assert rk.dot_segment_depth(64) == 16512
    for width in WIDTHS:
        depth = rk.dot_segment_depth(width)
        assert depth % 32 == 0
        assert (width // 8 - 4) * depth * 255 ** 2 < 1 << 32
        assert (width // 8 - 4) * (depth + 32) * 255 ** 2 >= 1 << 32
    # the secure dot's 1000^3: 16 x 32 tiles of 64 x 32 words per party at
    # ring128, 63 chunks of K' = 2000, 99 MB of limb planes per operand
    assert rk.dot_geometry(3, 1000, 1000, 1000, 128) == (
        16, 32, 63, 99090432, 99090432)
    assert rk.dot_geometry(3, 1000, 1000, 1000, 64) == (
        16, 16, 63, 49545216, 49545216)
    assert rk.dot_geometry(3, 1024, 101, 1, 128)[:3] == (16, 1, 7)
    # the product-only mode: K' = k, half the chunks
    assert rk.dot_geometry(1, 1000, 1000, 1000, 128, terms=1) == (
        16, 32, 32, 16777216, 16777216)
    assert rk.dot_geometry(1, 1024, 100, 2, 128, terms=1)[:3] == (16, 1, 4)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("product_only", (False, True))
def test_limbs_model_matches_plain(width, shape, product_only):
    # product_only: x1 and y0 None, K' = k, the host ring Dot's x0 @ ysum
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    args = _port_args(*_operands(rng, m, k, n, width), width)
    if product_only:
        args = (args[0], None, None, args[3])
    got = rk.dot_cross_terms_limbs_plain(*args, width)
    want = rk.dot_cross_terms_plain(*args, width)
    _assert_same(got, want)
    if product_only:
        _assert_same(want, rk.ring_matmul_plain(args[0], args[3], width))


@pytest.mark.parametrize("width", WIDTHS)
def test_limbs_model_matches_pallas_kernel(width):
    # random words, then all-ones words (every limb 0xFF)
    rng = np.random.default_rng(width + 4)
    m, k, n = 5, 7, 3
    ops = _operands(rng, m, k, n, width)
    ops[1] = _ones((3, m, k), width)
    ops[3] = _ones((3, k, n), width)
    jys = jring.add(*to_jax(ops[2]), *to_jax(ops[3]))
    want = jrk.dot_cross_terms(to_jax(ops[0]), to_jax(ops[1]),
                               to_jax(ops[2]), jys, width)
    got = rk.dot_cross_terms_limbs_plain(*_port_args(*ops, width), width)
    assert_words_equal(got, want, f"pallas limbs/ring{width}")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("past", (False, True))
def test_limbs_model_across_its_segment_depth(width, past):
    # all-ones words, the largest diagonal sums, at K' = 2k just under one
    # segment and just past it (two segments folded)
    depth = rk.dot_segment_depth(width)
    k = depth // 2 + (16 if past else -16)
    ops = [_ones((3, 2, k), width)] * 2 + [_ones((3, k, 3), width)] * 2
    args = _port_args(*ops, width)
    got = rk.dot_cross_terms_limbs_plain(*args, width)
    assert_words_equal(got, _lax_twin(*ops), f"ones k={k}/ring{width}")
    _assert_same(got, rk.dot_cross_terms_plain(*args, width))


@pytest.mark.parametrize("width", WIDTHS)
def test_limbs_model_refuses_a_segment_past_its_bound(width):
    # one segment of depth + 32 on all-ones words lets a diagonal that needs
    # its true value reach 2^32; the kernel's depth keeps it below
    depth = rk.dot_segment_depth(width)
    k = depth // 2 + 16
    ops = [_ones((3, 1, k), width)] * 2 + [_ones((3, k, 1), width)] * 2
    args = _port_args(*ops, width)
    with pytest.raises(AssertionError, match="2\\^32"):
        rk.dot_cross_terms_limbs_plain(*args, width, depth=2 * k)
    at_bound = [_ones((3, 1, depth // 2), width)] * 2 + [
        _ones((3, depth // 2, 1), width)] * 2
    rk.dot_cross_terms_limbs_plain(*_port_args(*at_bound, width), width,
                                   depth=depth)


@pytest.mark.parametrize("width", WIDTHS)
def test_limb_planes_are_k_major_and_concatenated(width):
    rng = np.random.default_rng(width)
    m, k, n = 3, 5, 2
    x0, x1, y0, y1 = _operands(rng, m, k, n, width)
    a8, b8 = rk.dot_limb_planes(to_port(x0), to_port(x1), to_port(y0),
                                to_port(y1), width)
    cols = rk.dot_tile_cols(width)
    assert tuple(a8.shape) == (3, width // 8, 64, 32)
    assert tuple(b8.shape) == (3, width // 8, cols, 32)
    a, b = a8.numpy(), b8.numpy()

    def limb(pair, index, l):
        word = pair[0][index] if l < 8 else pair[1][index]
        return (int(word) >> (8 * (l % 8))) & 0xFF

    for l in range(width // 8):
        for r in range(m):
            for kk in range(2 * k):
                src = x0 if kk < k else x1
                assert a[1, l, r, kk] == limb(src, (1, r, kk % k), l)
        for c in range(n):
            for kk in range(2 * k):
                src = y1 if kk < k else y0
                assert b[2, l, c, kk] == limb(src, (2, kk % k, c), l)
    # zero padding past m, n and K'
    assert not a[:, :, m:].any() and not a[:, :, :, 2 * k:].any()
    assert not b[:, :, n:].any() and not b[:, :, :, 2 * k:].any()


def test_limb_tiles_follow_the_no_swizzle_k_major_layout():
    rng = np.random.default_rng(7)
    parties, limbs, rows, depth, tile_rows = 2, 3, 128, 64, 64
    planes = rng.integers(0, 256, size=(parties, limbs, rows, depth),
                          dtype=np.uint8)
    flat = rk.dot_limb_tiles(torch.from_numpy(planes), tile_rows).numpy()
    chunks = depth // 32
    for p in range(parties):
        for l in range(limbs):
            for r in range(rows):
                for kk in range(depth):
                    tile, rr = divmod(r, tile_rows)
                    chunk, c = divmod(kk, 32)
                    at = (((p * (rows // tile_rows) + tile) * chunks + chunk)
                          * limbs + l) * tile_rows * 32
                    at += (rr // 8) * 256 + (c // 16) * 128 + (rr % 8) * 16
                    at += c % 16
                    assert flat[at] == planes[p, l, r, kk]


def test_chip_smoke_counts_k1_limb_work():
    # chip_smoke.py's K1 bound and int8 yardstick count the same limb
    # pairs: 136 at ring128, 36 at ring64, over three parties and K' = 2k
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke

    assert chip_smoke.dot_int8_macs(1000, 1000, 1000, 128) == (
        3 * 136 * 1000 * 2000 * 1000)
    assert chip_smoke.dot_int8_macs(7, 5, 3, 64) == 3 * 36 * 7 * 10 * 3
    for width in WIDTHS:
        ms, by = chip_smoke.dot_bound(1000, 1000, 1000, width)
        ops = 2 * chip_smoke.dot_int8_macs(1000, 1000, 1000, width)
        assert by == "operations"
        assert ms == pytest.approx(ops / chip_smoke.INT8_TENSOR_OPS_PER_S * 1e3)
        # the product-only mode: one party, one contraction of depth k
        ms, by = chip_smoke.dot_bound(1000, 1000, 1000, width, parties=1,
                                      terms=1)
        assert by == "operations"
        assert ms == pytest.approx(ops / 6 / chip_smoke.INT8_TENSOR_OPS_PER_S
                                   * 1e3)
