"""K3's fused entry point ``cross_terms_reshare`` (a secure elementwise
multiply's cross terms and reshare, reading the operands' pair layout in
place) on the CPU, through its plain version: word for word equal to the
composition it replaces, ``_reshare(sess, *_mul_terms(x, y),
width)``, and to the JAX package's ``spmd.mul`` under one master key and
the threefry PRF, at ring64 and ring128, at one shape and broadcast
shapes (the sigmoid's (3, 2, k, rows, 1) operands at small sizes), and
on strided views; the kernel's collapsed broadcast axes; and the fused
multiply-and-truncate that uses it."""

import numpy as np
import pytest
import torch

from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    rand_words,
    threefry,
    to_jax,
    to_port,
)

MK = np.array([0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D], np.uint32)
# (x, y) logical shapes: equal, and broadcast either way as the sigmoid's
# top_most_index and weighted sums multiply (k, rows, 1) by (1, rows, 1)
SHAPES = (
    ((5,), (5,)), ((3, 4), (3, 4)), ((4, 6, 1), (4, 6, 1)),
    ((4, 6, 1), (1, 6, 1)), ((1, 6, 1), (4, 6, 1)), ((4, 1, 3), (1, 5, 3)),
    ((1,), (1,)),
)


def _shared(seed, shapes, width):
    """Both packages' sessions and the same two sharings in each."""
    js = jspmd.SpmdSession(MK)
    ts = tspmd.SpmdSession(MK, "cpu")
    rng = np.random.default_rng(seed)
    pairs = []
    for shape in shapes:
        x = rand_words(rng, shape, width)
        pairs.append((jspmd.share(js, *to_jax(x), width),
                      tspmd.share(ts, *to_port(x), width)))
    return js, ts, pairs


def _words(t):
    return t.lo, t.hi


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("shapes", SHAPES, ids=str)
def test_reshare_matches_the_composition_and_jax(threefry, width, shapes):
    js, ts, ((jx, tx), (jy, ty)) = _shared(sum(map(len, shapes)), shapes,
                                           width)
    counter = ts._counter
    before = dict(rk.LAUNCHES)
    got = tspmd.mul(ts, tx, ty)
    assert rk.LAUNCHES == before
    assert ts._counter == counter + 1  # one zero-share bank
    want = jspmd.mul(js, jx, jy)
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), "spmd.mul")
    # the composition it replaces, from the same nonce
    ts._counter = counter
    old = tspmd._reshare(ts, *tspmd._mul_terms(tx, ty), width)
    assert torch.equal(got.lo, old.lo)
    assert width == 64 or torch.equal(got.hi, old.hi)


@pytest.mark.parametrize("width", (64, 128))
def test_reshare_reads_strided_views_in_place(threefry, width):
    """Transposed and sliced operands, as the protocol's structural ops
    leave them, give what their contiguous copies give."""
    _, ts, ((_, tx), (_, ty)) = _shared(3, ((4, 6), (6, 4)), width)
    x = tspmd.transpose(tx)  # (6, 4), a strided view
    y = tspmd.index_axis(tspmd.expand_dims(ty, 0), 0, 0)
    assert not x.lo.is_contiguous()
    bank = ts.sample_bank((6, 4), width)
    got = rk.cross_terms_reshare(_words(x), _words(y), bank, width)
    want = rk.cross_terms_reshare(
        tuple(None if w is None else w.contiguous() for w in _words(x)),
        _words(y), bank, width,
    )
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def test_reshare_dims_collapse_the_common_shape():
    def words(shape):
        return torch.zeros((3, 2) + shape, dtype=torch.int64)

    x, y = words((4, 6, 1)), words((1, 6, 1))
    assert rk.walk_dims((4, 6, 1), x, y) == [(4, 6, 0), (6, 1, 1)]
    same = words((4, 6, 1))
    assert rk.walk_dims((4, 6, 1), same, same) == [(24, 1, 1)]
    assert rk.walk_dims((), words(()), words(())) == []
    t = words((6, 4)).transpose(2, 3)  # logical (4, 6), strided
    assert rk.walk_dims((4, 6), t, words((4, 6))) == [(4, 1, 6),
                                                      (6, 4, 1)]
    # a lower-rank operand broadcasts over the leading axes
    assert rk.walk_dims((2, 3), words((3,)), words((2, 3))) == [
        (2, 0, 3), (3, 1, 1)]


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("shapes", (((3, 4), (3, 4)), ((4, 2, 1), (1, 2, 1))),
                         ids=str)
def test_fused_mul_and_trunc_matches_jax(threefry, width, shapes):
    """fx_mul's elementwise multiply-and-truncate reads the reshared
    pair layout; its zero-share bank and five truncation draws are one
    group."""
    js, ts, ((jx, tx), (jy, ty)) = _shared(7, shapes, width)
    jfx = [jspmd.SpmdFixed(t, 8, 20) for t in (jx, jy)]
    tfx = [tspmd.SpmdFixed(t, 8, 20) for t in (tx, ty)]
    counter = ts._counter
    got = tspmd.fx_mul(ts, *tfx).tensor
    want = jspmd.fx_mul(js, *jfx).tensor
    assert ts._counter == counter + 6
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), "fx_mul")
