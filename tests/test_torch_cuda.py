"""The port's CUDA kernels (K1-K7) against their plain PyTorch versions,
on the card, word for word, and whole requests on the card against the
same requests on the CPU.  Every test here needs a CUDA device and
skips without one.

The card's machine has no JAX, and tests/conftest.py imports it, so run
this file there without the conftest:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from moose_tpu_torch import interop
from moose_tpu_torch.dialects import ring
from moose_tpu_torch.native import ring_kernels as rk

WIDTHS = (64, 128)
# (m, k, n): ragged shapes; the edges of K1's 64-row and 32/64-column
# output tiles in m and n (64, 65, 128, 129 rows; 32, 33, 64, 65 columns);
# the thin n of the predictors and trainers (1, 8, 32); the dense
# predictors' layers at batch 1024 (100 -> 64 -> 32 -> 1, and one more k
# each); the ResNet's im2col contractions at batch 1024 (1,024 and 256
# row tiles against a 4-column output) and its Gemm head; and k = 0
DOT_SHAPES = (
    (5, 7, 3), (1, 1, 1), (4, 101, 1), (9, 33, 17), (70, 130, 66),
    (64, 16, 32), (65, 16, 33), (128, 48, 64), (129, 20, 65),
    (128, 100, 1), (100, 128, 1), (128, 100, 8), (128, 100, 32),
    (100, 128, 32), (1024, 100, 64), (1024, 101, 64), (1024, 64, 32),
    (1024, 65, 32), (1024, 32, 1), (1024, 33, 1), (65536, 27, 4),
    (16384, 36, 4), (1024, 4, 3), (5, 0, 3),
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


def _words(rng, shape, width, device):
    lo = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    hi = (
        None if width == 64
        else rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    )
    return interop.ring_from_numpy(lo, hi, device=device)


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    if want[1] is not None:
        assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", DOT_SHAPES)
def test_dot_cross_terms_kernel_matches_plain(cuda, width, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x0, x1 = (_words(rng, (3, m, k), width, cuda) for _ in range(2))
    y0, y1 = (_words(rng, (3, k, n), width, cuda) for _ in range(2))
    ys = ring.add(*y0, *y1)
    before = rk.LAUNCHES["dot_cross_terms"]
    got = rk.dot_cross_terms(x0, x1, y0, ys, width)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["dot_cross_terms"] == before + 1
    _assert_equal(got, rk.dot_cross_terms_plain(x0, x1, y0, ys, width))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", DOT_SHAPES)
def test_dot_cross_terms_product_only_matches_plain(cuda, width, shape):
    """K1's product-only mode (x1 and y0 None: x0 @ ysum, depth k), as
    a host ring Dot launches it, on the party-batched operands and
    through ``ring_matmul`` on a matrix pair."""
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + 1)
    x0 = _words(rng, (3, m, k), width, cuda)
    ys = _words(rng, (3, k, n), width, cuda)
    before = rk.LAUNCHES["dot_cross_terms"]
    got = rk.dot_cross_terms(x0, None, None, ys, width)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["dot_cross_terms"] == before + 1
    _assert_equal(got, rk.ring_matmul_plain(x0, ys, width))
    a, b = (tuple(None if t is None else t[1] for t in p) for p in (x0, ys))
    got = rk.ring_matmul(a, b, width)
    assert rk.LAUNCHES["dot_cross_terms"] == before + 2
    _assert_equal(got, rk.ring_matmul_plain(a, b, width))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("amount", (0, 23, 40, 62))
def test_trunc_combine_kernel_matches_plain(cuda, width, amount):
    rng = np.random.default_rng(amount)
    a0, a1, *draws = (_words(rng, (1000, 3), width, cuda) for _ in range(7))
    before = rk.LAUNCHES["trunc_combine"]
    got = rk.trunc_combine(a0, a1, tuple(draws), width, amount)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["trunc_combine"] == before + 1
    _assert_equal(
        got, rk.trunc_combine_plain(a0, a1, tuple(draws), width, amount)
    )


def _ones(shape, width, device):
    words = np.full(shape, (1 << 64) - 1, dtype=np.uint64)
    return interop.ring_from_numpy(
        words, None if width == 64 else words.copy(), device=device
    )


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("past", (False, True))
def test_dot_cross_terms_kernel_across_its_widening_depth(cuda, width, past):
    # K' = 2k just under and just past one segment: random words, then
    # all-ones words (every limb 0xFF, the largest diagonal sums)
    depth = rk.dot_segment_depth(width)
    k = depth // 2 + (48 if past else -16)
    rng = np.random.default_rng(k)
    for draw in (_words, None):
        def words(shape):
            if draw is None:
                return _ones(shape, width, cuda)
            return draw(rng, shape, width, cuda)

        x0, x1 = words((3, 9, k)), words((3, 9, k))
        y0, ys = words((3, k, 17)), words((3, k, 17))
        _assert_equal(rk.dot_cross_terms(x0, x1, y0, ys, width),
                      rk.dot_cross_terms_plain(x0, x1, y0, ys, width))


EDGE_WORDS = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                      dtype=np.uint64)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_kernels_match_plain_on_edge_words(cuda, width):
    rng = np.random.default_rng(width)

    def edge(shape):
        return interop.ring_from_numpy(
            rng.choice(EDGE_WORDS, size=shape),
            None if width == 64 else rng.choice(EDGE_WORDS, size=shape),
            device=cuda,
        )

    for m, k, n in ((9, 40, 7), (65, 300, 33)):
        x0, x1 = edge((3, m, k)), edge((3, m, k))
        y0, ys = edge((3, k, n)), edge((3, k, n))
        _assert_equal(rk.dot_cross_terms(x0, x1, y0, ys, width),
                      rk.dot_cross_terms_plain(x0, x1, y0, ys, width))
        ones = _ones((3, m, k), width, cuda), _ones((3, k, n), width, cuda)
        _assert_equal(rk.dot_cross_terms(ones[0], ones[0], ones[1], ones[1],
                                         width),
                      rk.dot_cross_terms_plain(ones[0], ones[0], ones[1],
                                               ones[1], width))
    a0, a1, *draws = (edge((64,)) for _ in range(7))
    for amount in (0, 23, 40, width - 2):
        _assert_equal(
            rk.trunc_combine(a0, a1, tuple(draws), width, amount),
            rk.trunc_combine_plain(a0, a1, tuple(draws), width, amount),
        )


@pytest.mark.gpu
def test_wrapper_refuses_strided_words(cuda):
    x = torch.zeros((3, 2, 4, 4), dtype=torch.int64, device=cuda)
    pair = (x[:, 0], None)
    with pytest.raises(ValueError, match="contiguous"):
        rk.dot_cross_terms(pair, pair, pair, pair, 64)


ELEMENTWISE_SHAPES = ((3, 5), (3, 1000), (3, 64, 1024), (3, 2, 7, 3))


def _edge(rng, shape, width, device):
    return interop.ring_from_numpy(
        rng.choice(EDGE_WORDS, size=shape),
        None if width == 64 else rng.choice(EDGE_WORDS, size=shape),
        device=device,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", ELEMENTWISE_SHAPES)
def test_cross_terms_mul_kernel_matches_plain(cuda, width, shape):
    rng = np.random.default_rng(sum(shape))
    for draw in (_words, _edge):
        ops = [draw(rng, shape, width, cuda) for _ in range(4)]
        before = rk.LAUNCHES["cross_terms_mul"]
        got = rk.cross_terms_mul(*ops, width)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["cross_terms_mul"] == before + 1
        _assert_equal(got, rk.cross_terms_mul_plain(*ops, width))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", ELEMENTWISE_SHAPES)
def test_ring_mul_kernel_matches_plain(cuda, width, shape):
    rng = np.random.default_rng(sum(shape) + 1)
    for draw in (_words, _edge):
        a, b = draw(rng, shape, width, cuda), draw(rng, shape, width, cuda)
        before = rk.LAUNCHES["ring_mul"]
        got = rk.ring_mul(*a, *b, width)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["ring_mul"] == before + 1
        _assert_equal(got, rk.ring_mul_plain(*a, *b, width))


# b's own shapes against the shares' (3, 2, 64, n)
B_SHAPES = {
    "()": lambda n: (), "(64,1)": lambda n: (64, 1),
    "(1,n)": lambda n: (1, n), "(64,n)": lambda n: (64, n),
}


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("b_axes", tuple(B_SHAPES))
@pytest.mark.parametrize("n", (1, 7, 1000, 1025))
def test_ring_mul_kernel_broadcasts_b(cuda, width, b_axes, n):
    shape = (3, 2, 64, n)
    b_shape = B_SHAPES[b_axes](n)
    rng = np.random.default_rng(n + len(b_shape) + width)
    for draw in (_words, _edge):
        a, b = draw(rng, shape, width, cuda), draw(rng, b_shape, width, cuda)
        before = rk.LAUNCHES["ring_mul"]
        got = rk.ring_mul(*a, *b, width)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["ring_mul"] == before + 1
        assert got[0].shape == shape
        _assert_equal(got, rk.ring_mul_plain(*a, *b, width))


def _at_offset(pair, offset):
    """The same words as a contiguous view ``offset`` words into a larger
    buffer."""
    def view(t):
        if t is None:
            return None
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out
    return view(pair[0]), view(pair[1])


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 9, 1000))
def test_ring_mul_kernel_on_views_at_odd_offsets(cuda, width, n):
    # the 16-byte path's scalar head and tail: a's planes and b at odd
    # and even word offsets, alike and apart; b also expanded (stride 0)
    # and transposed
    shape = (3, 2, n)
    rng = np.random.default_rng(n + width)
    a, b = _words(rng, shape, width, cuda), _words(rng, shape, width, cuda)
    want = rk.ring_mul_plain(*a, *b, width)
    for a_off, b_off in ((1, 1), (1, 0), (0, 1), (3, 2)):
        va = _at_offset(a, a_off)
        if width == 128:  # the high plane at the other parity
            va = (va[0], _at_offset((a[1], None), a_off + 1)[0])
        got = rk.ring_mul(*va, *_at_offset(b, b_off), width)
        _assert_equal(got, want)
        assert got[0].is_contiguous()
    row = _words(rng, (n,), width, cuda)
    expanded = tuple(None if t is None else t.expand(shape) for t in row)
    _assert_equal(rk.ring_mul(*a, *expanded, width),
                  rk.ring_mul_plain(*a, *row, width))
    tb = _words(rng, (n, 2, 3), width, cuda)
    transposed = tuple(None if t is None else t.permute(2, 1, 0) for t in tb)
    _assert_equal(rk.ring_mul(*a, *transposed, width),
                  rk.ring_mul_plain(*a, *transposed, width))


def _banks(rng, n, width, device, fill=None):
    shape = (rk.adder_bank_count(width), 3, width, n)
    if fill is None:
        banks = rng.integers(0, 2, size=shape, dtype=np.uint8)
    else:
        banks = np.full(shape, fill, dtype=np.uint8)
    return torch.from_numpy(banks).to(device)


BITS_COUNTS = (1, 5, 128, 1000, 1024, 4096, 4097)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", BITS_COUNTS)
@pytest.mark.parametrize("fill", (0, 1))
def test_bits_adder_kernel_on_uniform_banks(cuda, width, n, fill):
    # all-zero and all-ones banks on edge words, and the banks as a view
    # off 16-byte alignment (the pack stage's byte path)
    rng = np.random.default_rng(n + width + fill)
    x = _edge(rng, (3, 2, n), width, cuda)
    banks = _banks(rng, n, width, cuda, fill)
    buf = torch.empty(banks.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(banks.shape)
    shifted.copy_(banks)
    want = rk.bit_decompose_plain(*x, width, banks)
    for b in (banks, shifted):
        assert torch.equal(rk.bit_decompose(*x, width, b), want)
        assert torch.equal(rk.msb(*x, width, b), want[:, :, width - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", BITS_COUNTS)
def test_bits_adder_kernel_matches_plain(cuda, width, n):
    rng = np.random.default_rng(n + width)
    for draw in (_words, _edge):
        x = draw(rng, (3, 2, n), width, cuda)
        banks = _banks(rng, n, width, cuda)
        before = dict(rk.LAUNCHES)
        bits = rk.bit_decompose(*x, width, banks)
        top = rk.msb(*x, width, banks)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["bit_decompose"] == before["bit_decompose"] + 1
        assert rk.LAUNCHES["msb"] == before["msb"] + 1
        want = rk.bit_decompose_plain(*x, width, banks)
        assert torch.equal(bits, want)
        assert torch.equal(top, want[:, :, width - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("n", (32768, 65536))
def test_msb_kernel_at_the_mlp_relu_sizes(cuda, n):
    # relu's msb of the (1024, 32) and (1024, 64) hidden layers, ring128,
    # its 16 bit banks drawn on the card as the session draws them
    _check_msb(cuda, n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (131072, 262144))
def test_msb_kernel_at_the_resnet_sizes(cuda, n):
    # the ResNet's max pool's first round over (1024, 4, 4, 2, 4) halves
    # and its first relu over (1024, 8, 8, 4)
    _check_msb(cuda, n)


def _check_msb(cuda, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    x = tuple(torch.randint(-2**63, 2**63 - 1, (3, 2, n), generator=gen,
                            dtype=torch.int64, device=cuda) for _ in range(2))
    banks = torch.randint(0, 2, (rk.adder_bank_count(128), 3, 128, n),
                          generator=gen, dtype=torch.uint8, device=cuda)
    before = rk.LAUNCHES["msb"]
    top = rk.msb(*x, 128, banks)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["msb"] == before + 1
    assert torch.equal(top, rk.msb_plain(*x, 128, banks))


@pytest.mark.gpu
@pytest.mark.parametrize("width,f", ((64, 23), (64, 35), (128, 40),
                                     (128, 62)))
# the last two: the three-lane variant's stage beyond 48 KB (63 steps),
# and more warps of elements than its grid has blocks
@pytest.mark.parametrize("n,steps", ((7, 1), (1024, 14), (1000, 3), (40, 63),
                                     (50000, 2)))
def test_horner_kernel_matches_plain(cuda, width, f, n, steps):
    rng = np.random.default_rng(n + steps + f)
    raws = [int(v) for v in rng.integers(0, 1 << 63, size=steps + 1)]
    x0, x1 = (_words(rng, (3, n), width, cuda) for _ in range(2))
    zbanks = _words(rng, (steps, 3, n), width, cuda)
    tdraws = _words(rng, (steps, 5, n), width, cuda)
    before = rk.LAUNCHES["horner"]
    got = rk.horner(x0, x1, width, raws, f, zbanks, tdraws)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["horner"] == before + 1
    want = rk.horner_plain(x0, x1, width, raws, f, zbanks, tdraws)
    for g, w in zip(got, want):
        _assert_equal(g, w)


@pytest.mark.gpu
def test_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    x = _words(rng, (3, 2, 4), 128, cuda)
    short = _banks(rng, 4, 128, cuda)[:-1]
    with pytest.raises(ValueError, match="banks"):
        rk.bit_decompose(*x, 128, short.contiguous())
    x0 = _words(rng, (3, 4), 64, cuda)
    draws = _words(rng, (64, 5, 4), 64, cuda)
    banks = _words(rng, (64, 3, 4), 64, cuda)
    with pytest.raises(ValueError, match="steps"):
        rk.horner(x0, x0, 64, list(range(65)), 23, banks, draws)
    a = _words(rng, (3, 2, 4), 128, cuda)
    for b_shape in ((5,), (3, 2, 4, 1), (2, 2, 4)):
        b = _words(rng, b_shape, 128, cuda)
        with pytest.raises(ValueError, match="broadcast"):
            rk.ring_mul(*a, *b, 128)


PRF_LAYOUTS = tuple(rk.PRF_LAYOUTS)
# odd counts, the edges of a 64-bit word of bits, a 65,536-lane block
# edge, and the secure dot's (2, 3, 1000, 1000) draw
PRF_COUNTS = (1, 7, 63, 64, 65, 1000, 65537, 2 * 3 * 1000 * 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", PRF_LAYOUTS)
@pytest.mark.parametrize("n", PRF_COUNTS)
def test_threefry_kernel_matches_plain(cuda, layout, n):
    counter = rk.PRF_LAYOUTS[layout][1]
    for k0, k1 in ((0, 0), (0x243F6A88, 0xFFFFFFFF)):
        before = rk.LAUNCHES[counter]
        words = rk.threefry_words(k0, k1, n, layout, cuda)
        bits = rk.threefry_bits(k0, k1, n, layout, cuda)
        torch.cuda.synchronize()
        assert rk.LAUNCHES[counter] == before + 2
        assert words.dtype == torch.int64 and bits.dtype == torch.uint8
        assert torch.equal(
            words, rk.threefry_words_plain(k0, k1, n, layout, cuda)
        )
        assert torch.equal(
            bits, rk.threefry_bits_plain(k0, k1, n, layout, cuda)
        )


@pytest.mark.gpu
@pytest.mark.parametrize("impl", PRF_LAYOUTS)
def test_sampling_on_the_card_matches_the_cpu(cuda, impl):
    prev = ring.get_prf_impl()
    ring.set_prf_impl(impl)
    try:
        seed = (1, 2, 3, 4)
        for shape in ((3, 1000, 1000), (3, 7), ()):
            for width in WIDTHS:
                got = ring.sample_uniform_seeded(shape, seed, width, cuda)
                want = ring.sample_uniform_seeded(shape, seed, width, "cpu")
                _assert_equal(
                    tuple(None if t is None else t.cpu() for t in got), want
                )
            bits = ring.sample_bits_seeded(shape, seed, cuda)
            assert torch.equal(
                bits.cpu(), ring.sample_bits_seeded(shape, seed, "cpu")
            )
    finally:
        ring.set_prf_impl(prev)


@pytest.mark.gpu
def test_threefry_wrapper_refuses_what_its_kernel_does_not_take(cuda):
    with pytest.raises(ValueError, match="2\\^32"):
        rk.threefry_words(1, 2, (1 << 32) + 1, "threefry-pallas", cuda)
    with pytest.raises(ValueError, match="2\\^32"):
        rk.threefry_bits(1, 2, (64 << 32) + 1, "threefry-pallas", cuda)
    with pytest.raises(ValueError, match="u32"):
        rk.threefry_words(-1, 2, 8, "threefry", cuda)
    with pytest.raises(ValueError, match="layout"):
        rk.threefry_bits(1, 2, 8, "philox", cuda)
    before = dict(rk.LAUNCHES)
    empty = rk.threefry_words(1, 2, 0, "threefry", cuda)
    assert empty.shape == (0,) and rk.LAUNCHES == before


MK = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)


def _group(specs, device):
    """Group draws of ``(kind, n, offset)``: kind "w64", "w128" or "bits";
    each plane at ``offset`` elements into a buffer of its own, so a bit
    destination can start off a 16-byte boundary."""
    draws = []
    for kind, n, offset in specs:
        dtype = torch.uint8 if kind == "bits" else torch.int64
        planes = tuple(
            (torch.zeros(n + offset, dtype=dtype, device=device), offset)
            for _ in range(2 if kind == "w128" else 1)
        )
        draws.append(rk.GroupDraw(kind == "bits", n, planes))
    return draws


# (kind, n, offset) groups: the logistic regression's Horner group (84
# draws at (3, 1024) ring128), an adder group (16 bit banks of (3, 128,
# 64)), empty and one-element draws, odd tails, unaligned bit
# destinations, and a group past one launch's 224 draws
GROUPS = {
    "horner": [("w128", 3 * 1024, 0)] + [("w128", 1024, 0)] * 5
    + ([("w128", 3 * 1024, 0)] + [("w128", 1024, 0)] * 5) * 13,
    "adder": [("bits", 3 * 128 * 64, 0)] * 16,
    "edges": [("w64", 0, 0), ("bits", 1, 0), ("w128", 1, 0), ("bits", 0, 0),
              ("w64", 1, 0), ("bits", 65, 3), ("bits", 129, 1),
              ("bits", 64, 8), ("w128", 7, 1), ("bits", 1000, 5)],
    "many": [("w64", 3, 0), ("bits", 70, 2)] * 120,
    "large": [("w128", 1 << 20, 0), ("bits", 3 * 128 * 1024, 0)],
    # tiles of several outputs a thread that straddle a ring128 draw's two
    # planes and end mid-tile
    "large_odd": [("w128", 1000003, 0), ("bits", 3 * 128 * 1000 + 5, 3),
                  ("w64", 77777, 1), ("w128", 5, 0)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", PRF_LAYOUTS)
@pytest.mark.parametrize("group", tuple(GROUPS))
def test_threefry_group_kernel_matches_plain(cuda, layout, group):
    specs = GROUPS[group]
    draws = _group(specs, cuda)
    want = _group(specs, "cpu")
    counter = rk.PRF_LAYOUTS[layout][1]
    before = rk.LAUNCHES[counter]
    rk.threefry_group(MK, 3, 1000, layout, draws)
    torch.cuda.synchronize()
    launches = -(-len(specs) // rk.GROUP_MAX_DRAWS)
    assert rk.LAUNCHES[counter] == before + launches
    rk.threefry_group_plain(MK, 3, 1000, layout, want)
    for got, ref in zip(draws, want):
        for (g, _), (w, _) in zip(got.planes, ref.planes):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", PRF_LAYOUTS)
def test_card_session_derives_no_seed_on_the_host(cuda, impl, monkeypatch):
    """A CUDA session's draws, a secure multiply and the protocol
    sigmoid run without ring.mix_seed, and give the CPU session's words."""
    from moose_tpu_torch.parallel import spmd, spmd_math

    prev = ring.get_prf_impl()
    ring.set_prf_impl(impl)
    try:
        rng = np.random.default_rng(5)
        x = rng.normal(size=(3, 4)) * 2.0

        def run(device):
            sess = spmd.SpmdSession(MK, device)
            fx = spmd.fx_encode_share(
                sess, torch.tensor(x, device=device), 8, 27, 128)
            y = spmd_math.fx_sigmoid(sess, fx)
            z = spmd.mul(sess, fx.tensor, y.tensor)
            draws = sess.sample_group([("bank", (2, 3), 64),
                                       ("bit_bank", (5,), None)])
            return [y.tensor.lo, y.tensor.hi, z.lo, z.hi, draws[0][0],
                    draws[1]], sess._counter

        want, count = run("cpu")

        def refuse(*args, **kwargs):
            raise AssertionError("a seed was derived on the host")

        monkeypatch.setattr(ring, "mix_seed", refuse)
        got, got_count = run(cuda)
        torch.cuda.synchronize()
    finally:
        ring.set_prf_impl(prev)
    assert got_count == count
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _pair_layout(rng, shape, width, device):
    """A consistent replicated sharing's (3, 2, *shape) words: party i
    holds (z_i, z_{i+1})."""
    z = _words(rng, (3,) + shape, width, device)
    return tuple(None if w is None
                 else torch.stack([w, torch.roll(w, -1, dims=0)], dim=1)
                 for w in z)


# (x, y) logical shapes: the sigmoid's (3,2,1024) and (3,2,64,1024,1)
# against (1,1024,1), tails, a scalar, and a 2^20-element call
RESHARE_SHAPES = (
    ((1024,), (1024,)), ((64, 1024, 1), (64, 1024, 1)),
    ((64, 1024, 1), (1, 1024, 1)), ((1, 1024, 1), (64, 1024, 1)),
    ((7, 1, 3), (1, 5, 3)), ((1,), (1,)), ((5,), (1,)), ((1 << 20,), (1 << 20,)),
)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shapes", RESHARE_SHAPES, ids=str)
def test_cross_terms_reshare_kernel_matches_plain(cuda, width, shapes):
    rng = np.random.default_rng(sum(map(len, shapes)))
    x, y = (_pair_layout(rng, s, width, cuda) for s in shapes)
    shape = tuple(np.broadcast_shapes(*shapes))
    bank = _words(rng, (3,) + shape, width, cuda)
    before = rk.LAUNCHES["cross_terms_reshare"]
    got = rk.cross_terms_reshare(x, y, bank, width)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["cross_terms_reshare"] == before + 1
    _assert_equal(got, rk.cross_terms_reshare_plain(x, y, bank, width))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_cross_terms_reshare_kernel_reads_strided_views(cuda, width):
    rng = np.random.default_rng(9)
    x = _pair_layout(rng, (33, 65), width, cuda)
    x = tuple(None if w is None else w.transpose(2, 3) for w in x)
    y = _pair_layout(rng, (130, 33), width, cuda)
    y = tuple(None if w is None else w[:, :, ::2] for w in y)
    bank = _words(rng, (3, 65, 33), width, cuda)
    _assert_equal(rk.cross_terms_reshare(x, y, bank, width),
                  rk.cross_terms_reshare_plain(x, y, bank, width))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_secure_mul_runs_one_reshare_and_one_group(cuda, width, monkeypatch):
    """spmd.mul on the card: one cross_terms_reshare launch, one K7
    group, no slot copies, no zero_share or _pairs; its words equal the
    composition it replaced."""
    from moose_tpu_torch.parallel import spmd

    rng = np.random.default_rng(width)
    sess = spmd.SpmdSession(MK, cuda)
    x = spmd.share(sess, *_words(rng, (64, 1024, 1), width, cuda), width)
    y = spmd.share(sess, *_words(rng, (1, 1024, 1), width, cuda), width)
    counter = sess._counter
    before = dict(rk.LAUNCHES)

    def unused(*args, **kwargs):
        raise AssertionError("spmd.mul ran the composition")

    for name in ("slot_words", "zero_share", "_pairs"):
        monkeypatch.setattr(spmd, name, unused)
    got = spmd.mul(sess, x, y)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in rk.LAUNCHES.items() if v != before[k]}
    assert moved == {"cross_terms_reshare": 1, "prf_threefry": 1}
    monkeypatch.undo()
    sess._counter = counter
    want = spmd._reshare(sess, *spmd._mul_terms(x, y), width)
    _assert_equal((got.lo, got.hi), (want.lo, want.hi))


def _view(words, how):
    """A strided view of pair-layout words: the last two logical axes
    swapped, or the first logical axis broadcast from size 1."""
    def one(w):
        if w is None:
            return None
        if how == "transposed":
            return w.transpose(-1, -2)
        return w[:, :, :1].expand(w.shape)

    return tuple(one(w) for w in words)


# (input, logical shape, view): trunc_pairs on the pair layout (the
# logistic regression's (1024,), a transposed and a broadcast view, a
# scalar, 10^6) and on a matrix product's cross terms (the secure dot's
# (1000, 1000), a ragged one)
TRUNC_PAIRS_CASES = (
    ("pairs", (1024,), None), ("pairs", (33, 65), "transposed"),
    ("pairs", (7, 1000), "broadcast"), ("pairs", (), None),
    ("pairs", (10 ** 6,), None), ("cross", (1000, 1000), None),
    ("cross", (5, 3), None),
)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("amount", (0, 23, 40, "width - 2"))
@pytest.mark.parametrize("case", TRUNC_PAIRS_CASES, ids=str)
def test_trunc_pairs_kernel_matches_plain(cuda, width, amount, case):
    amount = width - 2 if amount == "width - 2" else amount
    kind, shape, view = case
    rng = np.random.default_rng(len(shape) + width + amount)
    bank = None
    if kind == "pairs":
        x = _pair_layout(rng, shape, width, cuda)
        if view:
            x = _view(x, view)
            assert not x[0].is_contiguous()
            shape = tuple(x[0].shape[2:])
    else:
        x = _words(rng, (3,) + shape, width, cuda)
        bank = _words(rng, (3,) + shape, width, cuda)
    draws = _words(rng, (5,) + shape, width, cuda)
    before = dict(rk.LAUNCHES)
    got = rk.trunc_pairs(x, draws, width, amount, bank=bank)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in rk.LAUNCHES.items()
             if v != before[k]}
    assert moved == {"trunc_pairs": 1}
    assert got[0].shape == (3, 2) + shape and got[0].is_contiguous()
    _assert_equal(got, rk.trunc_pairs_plain(x, draws, width, amount, bank))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_trunc_pairs_kernel_on_edge_words_and_empty(cuda, width):
    rng = np.random.default_rng(width + 3)
    z = _edge(rng, (3, 64), width, cuda)
    x = tuple(None if w is None
              else torch.stack([w, torch.roll(w, -1, dims=0)], dim=1)
              for w in z)
    draws = _edge(rng, (5, 64), width, cuda)
    for amount in (0, 23, 40, width - 2):
        _assert_equal(rk.trunc_pairs(x, draws, width, amount),
                      rk.trunc_pairs_plain(x, draws, width, amount))
        _assert_equal(rk.trunc_pairs(z, draws, width, amount, bank=z),
                      rk.trunc_pairs_plain(z, draws, width, amount, z))
    empty = _words(rng, (3, 2, 0, 4), width, cuda)
    before = dict(rk.LAUNCHES)
    got = rk.trunc_pairs(empty, _words(rng, (5, 0, 4), width, cuda), width,
                         23)
    assert rk.LAUNCHES == before and got[0].shape == (3, 2, 0, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_trunc_pairs_wrapper_refuses_what_its_kernel_does_not_take(cuda,
                                                                   width):
    """A bad amount, shape or layout raises on CUDA tensors; nothing
    launches and no plain version runs in its place."""
    rng = np.random.default_rng(11)
    x = _pair_layout(rng, (4, 6), width, cuda)
    draws = _words(rng, (5, 4, 6), width, cuda)
    bank = _words(rng, (3, 4, 6), width, cuda)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA call ran the plain version")

    before = dict(rk.LAUNCHES)
    saved = rk.trunc_pairs_plain
    rk.trunc_pairs_plain = plain
    try:
        for amount in (-1, width - 1):
            with pytest.raises(ValueError, match="amount"):
                rk.trunc_pairs(x, draws, width, amount)
        with pytest.raises(ValueError, match="draws"):
            rk.trunc_pairs(x, tuple(None if w is None else w[:, :3]
                                    for w in draws), width, 23)
        with pytest.raises(ValueError, match="contiguous"):
            rk.trunc_pairs(x, tuple(None if w is None else
                                    w.transpose(1, 2).contiguous()
                                    .transpose(1, 2) for w in draws),
                           width, 23)
        with pytest.raises(ValueError, match="contiguous"):
            rk.trunc_pairs(tuple(None if w is None else w.transpose(1, 2)
                                 .contiguous().transpose(1, 2)
                                 for w in bank), draws, width, 23,
                           bank=bank)
        with pytest.raises(ValueError, match="words"):
            rk.trunc_pairs(bank, draws, width, 23)
        if width == 128:
            odd = (x[0], x[1].transpose(2, 3).contiguous().transpose(2, 3))
            with pytest.raises(ValueError, match="laid out unlike"):
                rk.trunc_pairs(odd, draws, width, 23)
    finally:
        rk.trunc_pairs_plain = saved
    assert rk.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
def test_truncation_and_horner_run_two_device_launches(cuda, width):
    """spmd.trunc_pr of (1024,) and polynomial_eval each run one K7 group
    and one kernel of their own, counted by the wrappers, and nothing
    else on the card: torch.profiler sees those two kernels and no other
    device work.  Their words equal the CPU session's."""
    import chip_smoke
    from moose_tpu_torch.dialects.fixedpoint import P_1045
    from moose_tpu_torch.parallel import spmd, spmd_math

    frac = 62 if width == 128 else 20

    def run(device):
        sess = spmd.SpmdSession(MK, device)
        rng = np.random.default_rng(width)
        x = spmd.share(sess, *_words(rng, (1024,), width, device), width)
        ops = (
            ("trunc_pairs", lambda: spmd.trunc_pr(sess, x, 40)),
            ("horner", lambda: spmd_math.polynomial_eval(
                sess, P_1045, spmd.SpmdFixed(x, 2, frac),
                min_coeff=2.0 ** -(frac + 4)).tensor),
        )
        outs = []
        for name, op in ops:
            if device == "cpu":
                outs.append(op())
                continue
            before = dict(rk.LAUNCHES)
            out, seen = chip_smoke.device_events(torch, op)
            outs.append(out)
            moved = {k: v - before[k] for k, v in rk.LAUNCHES.items()
                     if v != before[k]}
            ours = [e for e in seen
                    if any(k in e for k in chip_smoke.PORT_KERNELS)]
            assert moved == {name: 1, "prf_threefry": 1}, moved
            assert len(seen) == 2 and len(ours) == 2, seen
        return [w for rep in outs for w in (rep.lo, rep.hi)]

    want = run("cpu")
    got = run(cuda)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g.cpu(), w)


# lanes an element: both variants of the horner kernel
HORNER_LANES = (1, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("lanes", HORNER_LANES)
@pytest.mark.parametrize("case", (((1024,), None), ((1000,), None),
                                  ((33, 65), "transposed"),
                                  ((7, 100), "broadcast"), ((), None)),
                         ids=str)
def test_horner_pairs_kernel_matches_plain(cuda, width, lanes, case,
                                           monkeypatch):
    """horner_pairs reads x's pair slots in place (contiguous, transposed,
    broadcast, 0-d) in either variant, and writes the pair layout word
    for word as the plain ladder does."""
    shape, view = case
    steps, f = (14, 62) if width == 128 else (9, 35)
    rng = np.random.default_rng(len(shape) + lanes)
    raws = [int(v) for v in rng.integers(0, 1 << 63, size=steps + 1)]
    x = _words(rng, (3, 2) + shape, width, cuda)  # any two slots
    if view:
        x = _view(x, view)
        shape = tuple(x[0].shape[2:])
    zbanks = _words(rng, (steps, 3) + shape, width, cuda)
    tdraws = _words(rng, (steps, 5) + shape, width, cuda)
    monkeypatch.setattr(rk, "horner_lanes", lambda n: lanes)
    before = rk.LAUNCHES["horner"]
    got = rk.horner_pairs(x, width, raws, f, zbanks, tdraws)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["horner"] == before + 1
    assert got[0].shape == (3, 2) + shape and got[0].is_contiguous()
    slots = [tuple(None if w is None else w[:, s] for w in x) for s in (0, 1)]
    acc0, acc1 = rk.horner_plain(*slots, width, raws, f, zbanks, tdraws)
    for g, a, b in zip(got, acc0, acc1):
        if g is not None:
            assert torch.equal(g[:, 0], a) and torch.equal(g[:, 1], b)


@pytest.mark.gpu
def test_horner_wrapper_refuses_bad_amounts_and_layouts(cuda):
    rng = np.random.default_rng(12)
    x = _words(rng, (3, 2, 8), 128, cuda)
    banks = _words(rng, (2, 3, 8), 128, cuda)
    draws = _words(rng, (2, 5, 8), 128, cuda)
    before = dict(rk.LAUNCHES)
    for f in (-1, 127):
        with pytest.raises(ValueError, match="amount"):
            rk.horner_pairs(x, 128, [1, 2, 3], f, banks, draws)
    with pytest.raises(ValueError, match="tdraws"):
        rk.horner_pairs(x, 128, [1, 2, 3], 40, banks, tuple(
            w[:, :4] for w in draws))
    with pytest.raises(ValueError, match="contiguous"):
        rk.horner_pairs(x, 128, [1, 2, 3], 40, tuple(
            w.transpose(0, 1).contiguous().transpose(0, 1) for w in banks),
            draws)
    with pytest.raises(ValueError, match="laid out unlike"):
        rk.horner_pairs((x[0], x[1].transpose(0, 1).contiguous()
                         .transpose(0, 1)), 128, [1, 2, 3], 40, banks, draws)
    assert rk.LAUNCHES == before


# the protocol library's kernel cases: log2's Pade ladders (negative raws,
# 3 steps) at fixed(24,40) and fixed(14,23); the exp ladder at (1024, 10),
# past the three-lane variant's 4,096 elements
@pytest.mark.gpu
@pytest.mark.parametrize("coeffs", ("P_2524", "Q_2524", "P_1045"))
@pytest.mark.parametrize("shape,f", (((1024, 10), 40), ((1024,), 23),
                                     ((1024, 10), 62)), ids=str)
def test_horner_on_the_protocol_library_ladders(cuda, coeffs, shape, f):
    from moose_tpu_torch.dialects import fixedpoint

    steps = 14 if coeffs == "P_1045" else 3
    raws = [fixedpoint.encode_const(c, f, 128)
            for c in reversed(getattr(fixedpoint, coeffs)[:steps + 1])]
    rng = np.random.default_rng(f + len(shape))
    x = _pair_layout(rng, shape, 128, cuda)
    zbanks = _words(rng, (steps, 3) + shape, 128, cuda)
    tdraws = _words(rng, (steps, 5) + shape, 128, cuda)
    assert rk.horner_lanes(int(np.prod(shape))) == (
        1 if np.prod(shape) > 4096 else 3)
    got = rk.horner_pairs(x, 128, raws, f, zbanks, tdraws)
    _assert_equal(got, rk.horner_pairs_plain(x, 128, raws, f, zbanks,
                                             tdraws))


@pytest.mark.gpu
def test_dot_cross_terms_at_the_multinomial_logits(cuda):
    rng = np.random.default_rng(1024)
    x0, x1 = (_words(rng, (3, 1024, 101), 128, cuda) for _ in range(2))
    y0, y1 = (_words(rng, (3, 101, 10), 128, cuda) for _ in range(2))
    ys = ring.add(*y0, *y1)
    _assert_equal(rk.dot_cross_terms(x0, x1, y0, ys, 128),
                  rk.dot_cross_terms_plain(x0, x1, y0, ys, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m", (5, 2, 1))
def test_tournament_halves_through_k3_and_k5(cuda, width, m):
    """A tournament round's strided halves: K3 reads them in place, and
    ``less`` (K5's msb) and the mux over them give the CPU session's
    words."""
    from moose_tpu_torch.parallel import spmd, spmd_math

    rng = np.random.default_rng(m)
    both = _pair_layout(rng, (64, 2 * m), width, cuda)
    x, y = (tuple(None if w is None else w[..., s::2] for w in both)
            for s in (0, 1))
    assert not x[0].is_contiguous()
    bank = _words(rng, (3, 64, m), width, cuda)
    _assert_equal(rk.cross_terms_reshare(x, y, bank, width),
                  rk.cross_terms_reshare_plain(x, y, bank, width))

    def run(device):
        sess = spmd.SpmdSession(MK, device)
        t = spmd.SpmdRep(*(None if w is None else w.to(device) for w in both),
                         width)
        a = spmd_math._slice_axis(t, 1, slice(0, 2 * m, 2))
        b = spmd_math._slice_axis(t, 1, slice(1, 2 * m, 2))
        lt = spmd_math.less(sess, a, b)
        mx = spmd_math.mux_bit(sess, lt, b, a)
        return lt.arr, mx.lo, mx.hi

    for g, w in zip(run(cuda), run("cpu")):
        assert (g is None and w is None) or torch.equal(g.cpu(), w)


# the protocol library's functions at (512, 10): 5,120 elements, past
# K6's three-lane variant as the multinomial classifier's (1024, 10) is,
# at half the plain path's CPU time (positive inputs for the logarithms
# and the root)
LIBRARY_FUNCTIONS = (
    ("less", lambda sm, s, x, y: sm.less(s, x.tensor, y.tensor).arr),
    ("equal_bit", lambda sm, s, x, y: sm.equal_bit(s, x.tensor,
                                                   x.tensor).arr),
    ("fx_exp", lambda sm, s, x, y: sm.fx_exp(s, x).tensor),
    ("fx_log2", lambda sm, s, x, y: sm.fx_log2(s, y).tensor),
    ("fx_sqrt", lambda sm, s, x, y: sm.fx_sqrt(s, y).tensor),
    ("fx_max", lambda sm, s, x, y: sm.fx_max(s, x, 1).tensor),
    ("fx_argmax", lambda sm, s, x, y: sm.fx_argmax(s, x, 1, 10)),
    ("fx_softmax", lambda sm, s, x, y: sm.fx_softmax(s, x, 1, 10).tensor),
)


@pytest.mark.gpu
@pytest.mark.parametrize("name,fn", LIBRARY_FUNCTIONS,
                         ids=[n for n, _ in LIBRARY_FUNCTIONS])
def test_protocol_library_on_the_card_matches_the_cpu(cuda, name, fn):
    from moose_tpu_torch.parallel import spmd, spmd_math

    rng = np.random.default_rng(len(name))
    xv = rng.normal(size=(512, 10)) * 2.0
    yv = rng.uniform(0.1, 100.0, size=(512, 10))

    def run(device):
        sess = spmd.SpmdSession(MK, device)
        x, y = (spmd.fx_encode_share(sess, torch.as_tensor(v, device=device),
                                     24, 40, 128) for v in (xv, yv))
        out = fn(spmd_math, sess, x, y)
        return [out] if isinstance(out, torch.Tensor) else [out.lo, out.hi]

    for g, w in zip(run(cuda), run("cpu")):
        assert torch.equal(g.cpu(), w), name


def _on_both(monkeypatch, run):
    """``run(device)`` on the card and on the CPU under fixed keys."""
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "card-vs-cpu")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")
    return run("cuda"), run("cpu")


@pytest.mark.gpu
def test_correlation_on_the_card_matches_the_cpu(cuda, monkeypatch):
    import moose_tpu_torch as tm
    from moose_tpu_torch.runtime import LocalMooseRuntime

    chip_smoke = _chip_smoke()
    columns = chip_smoke.correlated_columns(64)

    def run(device):
        before = dict(rk.LAUNCHES)
        value, runtime = chip_smoke.run_correlation(
            LocalMooseRuntime, chip_smoke.correlation_computation(tm),
            *columns, device=device)
        launched = {k: v - before[k] for k, v in rk.LAUNCHES.items()}
        return value, launched

    (got, launched), (want, _) = _on_both(monkeypatch, run)
    # numpy back from the card's storage, the CPU's words
    assert type(got) is np.ndarray and np.array_equal(got, want)
    for name in ("trunc_pairs", "cross_terms_reshare", "ring_mul", "msb",
                 "bit_decompose", "horner", "prf_threefry"):
        assert launched[name] >= 1, name
    assert launched["dot_cross_terms"] == 0


@pytest.mark.gpu
def test_mlp_request_on_the_card_matches_the_cpu(cuda, monkeypatch):
    from moose_tpu_torch.predictors import from_onnx, sklearn_export
    from moose_tpu_torch.runtime import LocalMooseRuntime

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(11)
    model = chip_smoke.mlp_model(rng, chip_smoke.MLPC_FEATURES,
                                 chip_smoke.MLPC_HIDDEN)
    pred = from_onnx(sklearn_export.mlp_onnx(
        model, chip_smoke.MLPC_FEATURES, classifier=True))
    comp = pred.predictor_factory()
    x = rng.normal(size=(64, chip_smoke.MLPC_FEATURES))

    def run(device):
        return LocalMooseRuntime(["alice", "bob", "carole"], device=device) \
            .evaluate_computation(comp, {"x": x})["output_0"]

    got, want = _on_both(monkeypatch, run)
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.dense_reference(pred, x)).max() < \
        chip_smoke.MLPC_TOL


@pytest.mark.gpu
def test_resnet_request_on_the_card_matches_the_cpu(cuda, monkeypatch):
    from moose_tpu_torch.predictors import from_onnx, sklearn_export
    from moose_tpu_torch.runtime import LocalMooseRuntime

    chip_smoke = _chip_smoke()
    model, params = sklearn_export.resnet_block_onnx(
        seed=chip_smoke.SEED, in_ch=chip_smoke.RESNET_CH,
        mid_ch=chip_smoke.RESNET_MID, size=chip_smoke.RESNET_SIZE,
        n_classes=chip_smoke.RESNET_CLASSES)
    comp = from_onnx(model).predictor_factory()
    x = np.random.default_rng(12).normal(
        size=(16, chip_smoke.RESNET_CH, chip_smoke.RESNET_SIZE,
              chip_smoke.RESNET_SIZE)) * 0.5

    def run(device):
        before = dict(rk.LAUNCHES)
        out = LocalMooseRuntime(["alice", "bob", "carole"], device=device) \
            .evaluate_computation(comp, {"x": x})["output_0"]
        return out, {k: v - before[k] for k, v in rk.LAUNCHES.items()}

    (got, launched), (want, _) = _on_both(monkeypatch, run)
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.resnet_reference(params, x)).max() < \
        chip_smoke.RESNET_TOL
    for name in ("dot_cross_terms", "trunc_pairs", "cross_terms_reshare",
                 "ring_mul", "msb", "bit_decompose", "horner",
                 "prf_threefry"):
        assert launched[name] >= 1, name


@pytest.mark.gpu
def test_aes_input_request_on_the_card_matches_the_cpu(cuda, monkeypatch):
    # phase 15's request at a batch of 8 rows: Decrypt's circuit, then
    # the logistic regression
    import moose_tpu_torch as tm
    from moose_tpu_torch.dialects import aes
    from moose_tpu_torch.runtime import LocalMooseRuntime

    chip_smoke = _chip_smoke()
    model = chip_smoke.logistic_regression(
        np.random.default_rng(13), chip_smoke.AES_FEATURES, aes=True)
    comp = chip_smoke.aes_inference_computation(
        tm, model, tm.fixed(*chip_smoke.AES_PRECISION))
    x = np.random.default_rng(14).normal(size=(8, chip_smoke.AES_FEATURES))
    key, nonce = chip_smoke.aes_key_nonce()
    args = {"aes_data": aes.encrypt_fixed_array(
        key, nonce, x, chip_smoke.AES_PRECISION[1]),
        "aes_key": aes.bytes_to_bits_be(key)}

    def run(device):
        before = dict(rk.LAUNCHES)
        out = LocalMooseRuntime(["alice", "bob", "carole"], device=device) \
            .evaluate_computation(comp, args)["output_0"]
        return out, {k: v - before[k] for k, v in rk.LAUNCHES.items()}

    (got, launched), (want, _) = _on_both(monkeypatch, run)
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.logistic_reference(model, x)).max() < \
        chip_smoke.AES_TOL
    for name in ("dot_cross_terms", "trunc_pairs", "cross_terms_reshare",
                 "ring_mul", "msb", "bit_decompose", "horner",
                 "prf_threefry"):
        assert launched[name] >= 1, name
    assert launched["prf_threefry"] == 134


@pytest.mark.gpu
def test_aes_ctr_request_on_the_card_matches_the_cpu(cuda, monkeypatch):
    # phase 16's request at 64 rows: every draw expanded on the host
    from moose_tpu_torch.runtime import LocalMooseRuntime

    chip_smoke = _chip_smoke()
    model = chip_smoke.logistic_regression(
        np.random.default_rng(15), chip_smoke.LOGREG_FEATURES)
    comp = model.predictor_factory()
    x = np.random.default_rng(16).normal(
        size=(64, chip_smoke.LOGREG_FEATURES))

    def run(device):
        before = dict(rk.LAUNCHES)
        out = LocalMooseRuntime(["alice", "bob", "carole"], device=device) \
            .evaluate_computation(comp, {"x": x})["output_0"]
        return out, {k: v - before[k] for k, v in rk.LAUNCHES.items()}

    prev = ring.get_prf_impl()
    ring.set_prf_impl("aes-ctr")
    try:
        (got, launched), (want, _) = _on_both(monkeypatch, run)
    finally:
        ring.set_prf_impl(prev)
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.logistic_reference(model, x)).max() < \
        chip_smoke.LOGREG_TOL
    assert launched["prf_threefry"] == launched["prf_threefry_pallas"] == 0
    assert launched["prf_aes_ctr_host"] == 50
    for name in ("dot_cross_terms", "trunc_pairs", "cross_terms_reshare",
                 "ring_mul", "msb", "bit_decompose", "horner"):
        assert launched[name] >= 1, name


# -- the per-host layout ----------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m,k,n", ((1000, 1000, 1000), (5, 7, 3),
                                   (1024, 101, 1), (1, 4, 1)))
def test_dot_cross_terms_at_one_party_matches_plain(cuda, width, m, k, n):
    """K1 as the per-host layout launches it: one party's
    x0 @ (y0 + y1) + x1 @ y0 (``party_dot_cross_terms``), and a host
    ring Dot with zero x1 and y0 (``ring_matmul``)."""
    rng = np.random.default_rng(m + k + n + width)
    x0, x1 = (_words(rng, (m, k), width, "cuda") for _ in range(2))
    y0, y1 = (_words(rng, (k, n), width, "cuda") for _ in range(2))
    ys = ring.add(*y0, *y1)
    got = rk.party_dot_cross_terms(x0, x1, y0, ys, width)
    want = rk.dot_cross_terms_plain(
        *(tuple(t.cpu() if t is not None else None for t in p)
          for p in (x0, x1, y0, ys)), width)
    _assert_equal(tuple(t.cpu() if t is not None else None for t in got),
                  want)
    got = rk.ring_matmul(x0, y0, width)
    want = rk.ring_matmul_plain(
        tuple(t.cpu() if t is not None else None for t in x0),
        tuple(t.cpu() if t is not None else None for t in y0), width)
    _assert_equal(tuple(t.cpu() if t is not None else None for t in got),
                  want)


@pytest.mark.gpu
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape,axis", (((1024, 2), 0), ((3, 5), 1),
                                        ((4, 3), None)))
def test_host_fixedpoint_mean_launches_ring_mul(cuda, width, shape, axis):
    """A host fixed-point Mean's factor goes through K4 on the card, to
    the CPU's words."""
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.values import HostRingTensor

    rng = np.random.default_rng(width + len(shape))
    x = _words(rng, shape, width, "cuda")
    before = rk.LAUNCHES["ring_mul"]
    got = host.ring_fixedpoint_mean(HostRingTensor(*x, width, "alice"),
                                    axis, 40, "alice")
    assert rk.LAUNCHES["ring_mul"] == before + 1
    want = host.ring_fixedpoint_mean(
        HostRingTensor(*(None if t is None else t.cpu() for t in x), width,
                       "alice"), axis, 40, "alice")
    _assert_equal((got.lo.cpu(), None if got.hi is None else got.hi.cpu()),
                  (want.lo, want.hi))


def _per_host_on_both(monkeypatch, comp, args):
    """(card, CPU) outputs and the card's launches of one per-host
    request under fixed keys."""
    from moose_tpu_torch.runtime import LocalMooseRuntime

    def run(device):
        before = dict(rk.LAUNCHES)
        runtime = LocalMooseRuntime(["alice", "bob", "carole"],
                                    layout="per-host", use_jit=False,
                                    device=device)
        out = runtime.evaluate_computation(comp, args)["output_0"]
        assert runtime.last_plan["layout"] == "per-host"
        return out, {k: v - before[k] for k, v in rk.LAUNCHES.items()}

    return _on_both(monkeypatch, run)


@pytest.mark.gpu
def test_per_host_secure_dot_on_the_card_matches_the_cpu(cuda, monkeypatch):
    import moose_tpu_torch as tm

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(17)
    args = {"x": rng.normal(size=(64, 48)), "y": rng.normal(size=(48, 32))}
    (got, launched), (want, _) = _per_host_on_both(
        monkeypatch, chip_smoke.secure_dot_computation(tm), args)
    assert np.array_equal(got, want)
    assert np.abs(got - args["x"] @ args["y"]).max() < chip_smoke.DOT_TOL
    # one K1 a party, one K2 truncation, 16 single draws
    assert launched["dot_cross_terms"] == 3
    assert launched["trunc_combine"] == 1
    assert launched["prf_threefry"] == chip_smoke.PER_HOST_DOT_K7


@pytest.mark.gpu
def test_per_host_logistic_regression_on_the_card_matches_the_cpu(
        cuda, monkeypatch):
    chip_smoke = _chip_smoke()
    model = chip_smoke.logistic_regression(
        np.random.default_rng(18), chip_smoke.LOGREG_FEATURES)
    x = np.random.default_rng(19).normal(
        size=(64, chip_smoke.LOGREG_FEATURES))
    (got, launched), (want, _) = _per_host_on_both(
        monkeypatch, model.predictor_factory(), {"x": x})
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.logistic_reference(model, x)).max() < \
        chip_smoke.LOGREG_TOL
    for name in ("dot_cross_terms", "trunc_combine", "cross_terms_mul",
                 "ring_mul", "prf_threefry"):
        assert launched[name] >= 1, name
    for name in ("trunc_pairs", "cross_terms_reshare", "bit_decompose",
                 "msb", "horner", "prf_threefry_pallas"):
        assert launched[name] == 0, name
    assert launched["prf_threefry"] == chip_smoke.PER_HOST_LOGREG_K7


@pytest.mark.gpu
def test_per_host_host_math_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """chip_smoke's host-only graph (host Dot, Exp, Mean, Softmax),
    per-host on the card, equal to the CPU's words."""
    import moose_tpu_torch as tm

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(20)
    args = {"x": rng.normal(size=(64, 10)) * 0.1,
            "y": rng.normal(size=(2, 10)) * 0.1}
    (got, launched), (want, _) = _per_host_on_both(
        monkeypatch, chip_smoke.host_math_computation(tm), args)
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.host_math_reference(**args)).max() < 1e-6
    for name in ("dot_cross_terms", "ring_mul"):
        assert launched[name] >= 1, name


def _lowered_logreg(rows=64):
    """chip_smoke's config-3 model lowered (DEFAULT_PASSES, nonces pinned)
    for ``rows`` rows, with its arguments."""
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.lowering import (
        arg_specs_from_arguments,
    )
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.edsl import tracer

    chip_smoke = _chip_smoke()
    model = chip_smoke.logistic_regression(
        np.random.default_rng(21), chip_smoke.LOGREG_FEATURES)
    args = {"x": np.random.default_rng(22).normal(
        size=(rows, chip_smoke.LOGREG_FEATURES))}
    with host.deterministic_sync_keys(chip_smoke.SEED):
        lowered = compile_computation(
            tracer.trace(model.predictor_factory()), DEFAULT_PASSES,
            arg_specs_from_arguments(args))
    return chip_smoke, model, lowered, args


@pytest.mark.gpu
def test_physical_executor_launches_k1_k4_and_k7(cuda, monkeypatch):
    """A lowered config-3 request on the card: every host ring Dot on K1
    in its product-only mode, every host ring Mul on K4, every
    SampleSeeded one K7 draw, and no fused protocol step; the CPU's
    words."""
    from moose_tpu_torch.execution.physical import execute_physical

    chip_smoke, model, lowered, args = _lowered_logreg()
    kinds = [op.kind for op in lowered.operations.values()]

    def run(device):
        before = dict(rk.LAUNCHES)
        out = execute_physical(lowered, {}, args,
                               device=device)["output_0"]
        return out, {k: v - before[k] for k, v in rk.LAUNCHES.items()}

    (got, launched), (want, cpu_launched) = _on_both(monkeypatch, run)
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.logistic_reference(
        model, args["x"])).max() < chip_smoke.LOGREG_TOL
    assert launched["dot_cross_terms"] == kinds.count("Dot") > 0
    assert launched["ring_mul"] >= 1
    assert launched["prf_threefry"] == kinds.count("SampleSeeded")
    for name in ("trunc_combine", "trunc_pairs", "cross_terms_mul",
                 "cross_terms_reshare", "bit_decompose", "msb", "horner",
                 "prf_threefry_pallas"):
        assert launched[name] == 0, name
    assert not any(cpu_launched.values())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("Mul", "Dot"))
def test_physical_executor_raises_rather_than_run_a_plain_version(cuda,
                                                                  kind):
    """A host ring Mul or Dot whose second operand is not on the card
    raises in its kernel's wrapper; no plain version runs in its
    place."""
    from types import SimpleNamespace

    from moose_tpu_torch.execution.physical import execute_kernel
    from moose_tpu_torch.execution.session import EagerSession
    from moose_tpu_torch.values import HostRingTensor

    rng = np.random.default_rng(23)
    x = HostRingTensor(*_words(rng, (4, 4), 128, "cuda"), 128, "alice")
    y = HostRingTensor(*_words(rng, (4, 4), 128, "cpu"), 128, "alice")
    op = SimpleNamespace(kind=kind, name="op_0", attributes={},
                         signature=SimpleNamespace(return_type=None))
    before = dict(rk.LAUNCHES)
    with pytest.raises((ValueError, RuntimeError)):
        execute_kernel(EagerSession("cuda"), op, "alice", [x, y])
    assert rk.LAUNCHES == before


@pytest.mark.gpu
def test_lowered_request_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The lowered route through the runtime and from bytes: the cold
    request lowers under pinned nonces, and the card's words are the
    CPU's, as chip_smoke's phase 19 holds them at full width."""
    from moose_tpu_torch import serde
    from moose_tpu_torch.compilation import DEFAULT_PASSES
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.runtime import LocalMooseRuntime

    chip_smoke, model, lowered, args = _lowered_logreg(rows=32)
    blob = serde.serialize_computation(lowered)

    def run(device):
        runtime = LocalMooseRuntime(["alice", "bob", "carole"],
                                    layout="per-host", device=device)
        with host.deterministic_sync_keys(chip_smoke.SEED):
            out = runtime.evaluate_computation(
                model.predictor_factory(), args,
                compiler_passes=DEFAULT_PASSES)["output_0"]
        assert runtime.last_plan["lowered"] is True
        from_bytes = runtime.evaluate_compiled(blob, args)["output_0"]
        return out, from_bytes

    (got, got_bytes), (want, want_bytes) = _on_both(monkeypatch, run)
    assert np.array_equal(got, want) and np.array_equal(got_bytes, want)
    assert np.array_equal(want_bytes, want)


def _epoch_on_both(monkeypatch, tmp_path, use_jit):
    """Every party's committed words, the exported weights and the card's
    launches of one training session (init and two epochs of
    LogregSGDTrainer at 32 x 6, two steps an epoch) on the card and on the
    CPU under fixed keys, the lowering's nonces pinned."""
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.predictors.trainers import LogregSGDTrainer
    from moose_tpu_torch.runtime import LocalMooseRuntime
    from moose_tpu_torch.storage import FilesystemStorage
    from moose_tpu_torch.training import (
        CheckpointStore,
        TrainingConfig,
        TrainingSession,
    )
    from moose_tpu_torch.training.session import LocalTrainingCluster

    chip_smoke = _chip_smoke()
    ids = ["alice", "bob", "carole"]
    x, y = chip_smoke.training_data(np.random.default_rng(21), 32, 6)

    def run(device):
        before = dict(rk.LAUNCHES)
        stores = {p: CheckpointStore(FilesystemStorage(
            str(tmp_path / device / p)), party=p) for p in ids}
        runtime = LocalMooseRuntime(ids, storage_mapping=stores,
                                    use_jit=use_jit, device=device)
        trainer = LogregSGDTrainer(6, 0.1, steps_per_epoch=2)
        with host.deterministic_sync_keys(chip_smoke.SEED):
            report = TrainingSession(
                trainer, LocalTrainingCluster(runtime, ids),
                TrainingConfig(epochs=2)).run(x, y)
        words = {(p, k): np.asarray(stores[p].load(k)) for p in ids
                 for k in trainer.expected_staged()}
        return (words, report["weights"]["w"],
                {k: v - before[k] for k, v in rk.LAUNCHES.items()})

    return _on_both(monkeypatch, run)


@pytest.mark.gpu
@pytest.mark.parametrize("use_jit", (False, True), ids=("walk", "lowered"))
def test_training_epochs_on_the_card_match_the_cpu(cuda, monkeypatch,
                                                   tmp_path, use_jit):
    (words, w, launched), (cpu_words, cpu_w, _) = _epoch_on_both(
        monkeypatch, tmp_path, use_jit)
    assert words.keys() == cpu_words.keys() and len(words) == 6
    for key, want in cpu_words.items():
        assert np.array_equal(words[key], want), key
    assert np.array_equal(w, cpu_w)
    # the walk's step: K1 a party, K2's additive tail, K3 unfused, K4,
    # K7 single draws; the lowered epoch: K1 product-only, K4, K7
    kernels = (("dot_cross_terms", "ring_mul", "prf_threefry") if use_jit
               else ("dot_cross_terms", "trunc_combine", "cross_terms_mul",
                     "ring_mul", "prf_threefry"))
    for name in kernels:
        assert launched[name] >= 1, name
    for name in ("trunc_pairs", "cross_terms_reshare", "bit_decompose",
                 "msb", "horner", "prf_threefry_pallas"):
        assert launched[name] == 0, name


@pytest.mark.gpu
def test_logreg_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    from moose_tpu_torch.parallel import spmd

    chip_smoke = _chip_smoke()
    x, y = chip_smoke.training_data(np.random.default_rng(22), 3 * 32, 8)
    before = dict(rk.LAUNCHES)
    got = chip_smoke.spmd_training(torch, spmd, x, y, 32, 0.1, "cuda")
    launched = {k: v - before[k] for k, v in rk.LAUNCHES.items()}
    want = chip_smoke.spmd_training(torch, spmd, x, y, 32, 0.1, "cpu")
    assert np.array_equal(got, want)
    for name in ("dot_cross_terms", "trunc_pairs", "cross_terms_reshare",
                 "ring_mul", "prf_threefry"):
        assert launched[name] >= 1, name


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke
