"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

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
DOT_SHAPES = ((5, 7, 3), (1, 1, 1), (4, 101, 1), (9, 33, 17), (70, 130, 66))


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

    x0, x1 = edge((3, 9, 40)), edge((3, 9, 40))
    y0, ys = edge((3, 40, 7)), edge((3, 40, 7))
    _assert_equal(rk.dot_cross_terms(x0, x1, y0, ys, width),
                  rk.dot_cross_terms_plain(x0, x1, y0, ys, width))
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
