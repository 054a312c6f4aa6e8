"""The port's whole truncation (K2's ``trunc_pairs`` entry: the pair
layout, or a matrix product's cross terms and zero-share bank, in; the
pair layout out) on the CPU, through its plain version, against
``moose_tpu``: ``spmd.trunc_pr`` and the fused multiply-and-truncate
``_mul_like_trunc`` (elementwise, broadcast in both orders, on a
transposed operand, and the 2-D dot, directly and through ``fx_mul`` /
``fx_dot``) give the same ring words under one master key, in both PRF
streams, at ring64 and ring128; also on a 0-d and an empty operand, on
words near +-2^(k-2), and at the amounts 0 and width - 2.  The CUDA
kernel against the plain version: tests/test_torch_cuda.py, on the
card."""

import numpy as np
import pytest
import torch

from moose_tpu.dialects import ring as jring
from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import (
    assert_words_equal,
    prf,
    rand_words,
    to_jax,
    to_port,
)

MK = np.array([0x02468ACE, 0x13579BDF, 0xCAFEF00D, 0x600DD00D], np.uint32)
PRFS = ("threefry", "threefry-pallas")
WIDTHS = (64, 128)


@pytest.fixture(params=PRFS)
def stream(request):
    """Both packages on one PRF stream, restored afterwards."""
    with prf(request.param):
        yield request.param


def _sessions():
    return jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")


def _drawable(shape):
    """Whether the reference can draw at ``shape``: its Pallas PRF in
    moose_tpu cannot draw 0 words, so under threefry-pallas an empty
    operand runs in the port alone."""
    return jring.get_prf_impl() != "threefry-pallas" or 0 not in shape


def _share(sessions, words, width):
    """The same plaintext words shared in both packages' sessions (the
    reference's None where it cannot draw them)."""
    js, ts = sessions
    jx = (jspmd.share(js, *to_jax(words), width)
          if _drawable(words[0].shape) else None)
    return jx, tspmd.share(ts, *to_port(words), width)


def _edge_words(shape, width):
    """Plaintexts at and around +-2^(w-3) and +-2^(w-2) (the truncation's
    input bound at k = w - 1 is 2^(k-2)), as ring words."""
    rng = np.random.default_rng(width)
    near = []
    for top in (width - 3, width - 2):
        for off in (-2, -1, 0, 1):
            near += [(1 << top) + off, -(1 << top) + off]
    values = rng.choice(np.array(near, dtype=object), size=shape)
    mask = (1 << width) - 1
    lo = np.vectorize(lambda v: (v & mask) & ((1 << 64) - 1),
                      otypes=[np.uint64])(values)
    hi = None if width == 64 else np.vectorize(
        lambda v: (v & mask) >> 64, otypes=[np.uint64])(values)
    return lo, hi


def _operand(case, width):
    """(plaintext words, transform) of a trunc_pr case: the port's
    transposed operand is a strided view, the reference's a copy."""
    rng = np.random.default_rng(len(case) + width)
    if case == "contiguous":
        return rand_words(rng, (4, 5), width), None
    if case == "transposed":
        return rand_words(rng, (3, 6), width), "transpose"
    if case == "scalar":
        return rand_words(rng, (), width), None
    if case == "empty":
        return rand_words(rng, (2, 0), width), None
    return _edge_words((3, 7), width), None


def _assert_rep(got, want, label):
    assert got.width == want.width
    assert got.shape == tuple(want.lo.shape[2:])
    assert got.lo.is_contiguous()
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


def _reference(shape, width, run):
    """The reference's result, or where it cannot draw (``_drawable``)
    the empty pair layout the port must give."""
    if not _drawable(shape):
        empty = np.zeros((3, 2) + tuple(shape), np.uint64)
        return jspmd.SpmdRep(empty, None if width == 64 else empty, width)
    return run()


def _cases(cases, extremes):
    """(case, amount) pairs: every case at a middle amount, the
    ``extremes`` also at 0 and width - 2."""
    return [(case, 23) for case in cases] + [
        (case, amount) for case in extremes for amount in ("zero",
                                                           "width - 2")]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case,amount", _cases(
    ("contiguous", "transposed", "scalar", "empty", "edge"),
    ("contiguous", "edge")))
def test_trunc_pr_matches_reference(stream, width, case, amount):
    amount = {"zero": 0, "width - 2": width - 2}.get(amount, amount)
    sessions = _sessions()
    words, transform = _operand(case, width)
    jx, tx = _share(sessions, words, width)
    if transform:
        jx, tx = jspmd.transpose_2d(jx), tspmd.transpose(tx)
        assert not tx.lo.is_contiguous()
    js, ts = sessions
    counter = ts._counter
    before = dict(rk.LAUNCHES)
    got = tspmd.trunc_pr(ts, tx, amount)
    assert rk.LAUNCHES == before  # the CPU runs the plain versions
    assert ts._counter == counter + 5
    want = _reference(got.shape, width,
                      lambda: jspmd.trunc_pr(js, jx, amount))
    _assert_rep(got, want, f"trunc_pr {case} by {amount}")


# (x, y) logical shapes of the elementwise cases; "T" marks an operand
# that is a transposed view of the shape's reverse
PRODUCTS = {
    "elementwise": ((3, 4), (3, 4)),
    "broadcast (4,1) x (4,5)": ((4, 1), (4, 5)),
    "broadcast (4,5) x (4,1)": ((4, 5), (4, 1)),
    "transposed": ("T", (4, 3)),
    "scalar": ((), ()),
    "empty": ((0, 3), (0, 3)),
    "dot": ((5, 3), (3, 4)),
}


def _product_operands(case, width):
    sessions = _sessions()
    rng = np.random.default_rng(sum(map(ord, case)))
    shapes = PRODUCTS[case]
    reps = []
    for shape in shapes:
        if shape == "T":
            jx, tx = _share(sessions, rand_words(rng, (3, 4), width), width)
            reps.append((jspmd.transpose_2d(jx), tspmd.transpose(tx)))
        else:
            reps.append(_share(sessions, rand_words(rng, shape, width),
                               width))
    return sessions, reps


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case,amount", _cases(tuple(PRODUCTS),
                                               ("elementwise", "dot")))
def test_mul_like_trunc_matches_reference(stream, width, case, amount):
    amount = {"zero": 0, "width - 2": width - 2}.get(amount, amount)
    (js, ts), ((jx, tx), (jy, ty)) = _product_operands(case, width)
    dot = case == "dot"
    counter = ts._counter
    got = tspmd._mul_like_trunc(
        ts, tx, ty, tspmd._dot_terms if dot else tspmd._mul_terms, amount)
    # one group: the zero-share bank and the five truncation draws
    assert ts._counter == counter + 6
    want = _reference(got.shape, width, lambda: jspmd._mul_like_trunc(
        js, jx, jy, jspmd._dot_contract if dot else jring.mul, amount))
    _assert_rep(got, want, f"_mul_like_trunc {case} by {amount}")


@pytest.mark.parametrize("width,precision", ((64, (8, 20)),
                                             (128, (24, 40))))
@pytest.mark.parametrize("case", ("elementwise", "broadcast (4,1) x (4,5)",
                                  "transposed", "dot"))
def test_fixed_point_products_match_reference(stream, width, precision,
                                              case):
    (js, ts), ((jx, tx), (jy, ty)) = _product_operands(case, width)
    fx = [(jspmd.SpmdFixed(j, *precision), tspmd.SpmdFixed(t, *precision))
          for j, t in ((jx, tx), (jy, ty))]
    op = "fx_dot" if case == "dot" else "fx_mul"
    got = getattr(tspmd, op)(ts, fx[0][1], fx[1][1]).tensor
    want = getattr(jspmd, op)(js, fx[0][0], fx[1][0]).tensor
    _assert_rep(got, want, f"{op} {case}")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("secret_first", (True, False))
def test_public_product_then_trunc_matches_reference(stream, width,
                                                     secret_first):
    """A secret (4, 1) times a public (4, 5) constant, either shape
    first, then trunc_pr at the broadcast (4, 5), as a replicated Mul of
    a secret by a larger mirrored constant runs it
    (tests/test_torch_mul_broadcast.py)."""
    sessions = _sessions()
    rng = np.random.default_rng(width)
    shapes = ((4, 1), (4, 5)) if secret_first else ((4, 5), (4, 1))
    jx, tx = _share(sessions, rand_words(rng, shapes[0], width), width)
    c = rand_words(rng, shapes[1], width)
    js, ts = sessions
    got = tspmd.trunc_pr(ts, tspmd.mul_public(tx, *to_port(c)), 23)
    want = jspmd.trunc_pr(js, jspmd.mul_public(jx, *to_jax(c)), 23)
    _assert_rep(got, want, "mul_public then trunc_pr")


def _h(t, *index):
    return None if t is None else t[index]


def _pair_layout(z):
    return tuple(None if w is None
                 else torch.stack([w, torch.roll(w, -1, dims=0)], dim=1)
                 for w in z)


@pytest.mark.parametrize("width", WIDTHS)
def test_trunc_pairs_inputs_agree_with_trunc_combine(width):
    """The kernel's two inputs agree: a matrix product's cross terms with
    the zero-share bank give what their reshared pair layout gives, and
    both the pair layout of trunc_combine on the additive form."""
    rng = np.random.default_rng(width + 1)
    v = to_port(rand_words(rng, (3, 4, 5), width))
    bank = to_port(rand_words(rng, (3, 4, 5), width))
    draws = to_port(rand_words(rng, (5, 4, 5), width))
    z = tring.add(*v, *tring.sub(*bank, *(
        None if w is None else torch.roll(w, -1, dims=0) for w in bank)))
    a0 = tring.add(z[0][0], _h(z[1], 0), z[0][1], _h(z[1], 1))
    a1 = z[0][2], _h(z[1], 2)
    d = tuple((draws[0][j], _h(draws[1], j)) for j in range(5))
    want = _pair_layout(rk.trunc_combine(a0, a1, d, width, 23))
    for got in (rk.trunc_pairs(v, draws, width, 23, bank=bank),
                rk.trunc_pairs(_pair_layout(z), draws, width, 23)):
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)


def test_trunc_pairs_refuses_what_it_does_not_take():
    words = torch.zeros((3, 2, 4), dtype=torch.int64)
    draws = torch.zeros((5, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="amount"):
        rk.trunc_pairs((words, None), (draws, None), 64, 63)
    with pytest.raises(ValueError, match="draws"):
        rk.trunc_pairs((words, None), (draws[:4], None), 64, 23)
    with pytest.raises(ValueError, match="words"):
        rk.trunc_pairs((words[:, 0], None), (draws, None), 64, 23)
