"""The grouped PRF draws of the port (K7, ``ring_kernels.threefry_group``
and ``SpmdSession.sample_group``) against the draws one by one, on the
CPU, where the group runs its plain version: word for word in both
stream layouts, for groups of mixed kinds, Horner's interleaved bank and
five truncation draws, and an adder's 16 bit banks written into the
stacked array; the session counter; the bit-domain tag; the 2^32 refusal;
and the group's draws against the JAX package's ``SpmdSession.sample*``
sequence under the same master key and domain.  On the CPU no launch
counter moves."""

import numpy as np
import pytest
import torch

from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import (  # noqa: F401  (fixtures)
    assert_words_equal,
    prf,
    threefry,
    threefry_pallas,
)

MK = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
LAYOUTS = ("threefry", "threefry-pallas")
# mixed kinds; (3, 50) and (3, 129) leave a threefry-pallas bit draw a
# tail that does not fill a 64-bit word
MIXED = (
    ("sample", (4, 3), 64), ("bank", (5,), 128), ("bit_bank", (50,), None),
    ("sample", (), 128), ("bank", (2, 3), 64), ("bit_bank", (129,), None),
    ("sample", (7,), 128),
)


def _sequential(master, domain, first, specs, layout):
    """The draws one by one, as the session drew them before groups:
    per draw the host-derived seed and ``sample_uniform_seeded`` /
    ``sample_bits_seeded``."""
    out = []
    with prf(layout):
        for j, (kind, shape, width) in enumerate(specs):
            seed = tring.draw_seed(master, domain, first + j)
            shape = ((3,) if kind != "sample" else ()) + tuple(shape)
            if kind == "bit_bank":
                out.append(tring.sample_bits_seeded(shape, seed, "cpu"))
            else:
                out.append(tring.sample_uniform_seeded(shape, seed, width,
                                                       "cpu"))
    return out


def _assert_draws_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == torch.uint8 and torch.equal(g, w)
        else:
            assert torch.equal(g[0], w[0])
            assert (g[1] is None) == (w[1] is None)
            assert w[1] is None or torch.equal(g[1], w[1])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("domain", (0, 3))
def test_mixed_group_matches_the_draws_one_by_one(layout, domain):
    sess = tspmd.SpmdSession(MK, "cpu", domain=domain)
    sess.sample((2,), 64)  # the group starts at nonce index 1
    before = dict(rk.LAUNCHES)
    with prf(layout):
        got = sess.sample_group(MIXED)
    assert rk.LAUNCHES == before
    specs = [spec[:3] for spec in MIXED]
    _assert_draws_equal(got, _sequential(MK, domain, 1, specs, layout))
    assert sess._counter == 1 + len(MIXED)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("width", (64, 128))
def test_horner_group_writes_the_stacked_planes(layout, width):
    """Per step one bank and five draws, straight into the (steps, 3,
    *shape) banks and (steps, 5, *shape) draws, as polynomial_eval
    draws them for the horner kernel."""
    steps, shape, n = 3, (2, 5), 10
    sess = tspmd.SpmdSession(MK, "cpu")

    def planes(lead):
        lo = torch.zeros((steps, lead) + shape, dtype=torch.int64)
        return lo, None if width == 64 else torch.zeros_like(lo)

    def at(t, *i):
        return None if t is None else t[i]

    def refs(lo, hi, offset):
        return (lo, offset), None if hi is None else (hi, offset)

    (zb_lo, zb_hi), (td_lo, td_hi) = planes(3), planes(5)
    specs = []
    for s in range(steps):
        specs.append(("bank", shape, width, refs(zb_lo, zb_hi, 3 * n * s)))
        specs += [("sample", shape, width,
                   refs(td_lo, td_hi, n * (5 * s + d))) for d in range(5)]
    with prf(layout):
        assert sess.sample_group(specs) == [None] * len(specs)
    want = _sequential(MK, 0, 0, [spec[:3] for spec in specs], layout)
    got = []
    for s in range(steps):
        got.append((zb_lo[s], at(zb_hi, s)))
        got += [(td_lo[s, d], at(td_hi, s, d)) for d in range(5)]
    _assert_draws_equal(got, want)
    assert sess._counter == 6 * steps


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adder_group_writes_the_stacked_banks(layout):
    """The 16 bit banks of a ring128 decomposition into the (16, 3, 128,
    *shape) array the bits_adder kernel reads, and the same through
    spmd_math's own drawing."""
    from moose_tpu_torch.parallel import spmd_math

    n_ands = rk.adder_bank_count(128)
    shape = (128, 3)
    sess = tspmd.SpmdSession(MK, "cpu")
    x = tspmd.SpmdRep(torch.zeros((3, 2, 3), dtype=torch.int64),
                      torch.zeros((3, 2, 3), dtype=torch.int64), 128)
    with prf(layout):
        banks = spmd_math._draw_adder_banks(sess, x)
    want = _sequential(MK, 0, 0, [("bit_bank", shape, None)] * n_ands,
                       layout)
    assert banks.shape == (n_ands, 3) + shape
    _assert_draws_equal(list(banks), want)
    assert sess._counter == n_ands


@pytest.mark.parametrize("layout", LAYOUTS)
def test_group_wrapper_takes_two_planes_in_stream_order(layout):
    """A ring128 draw is one (2, n) draw: stream words [0, n) are its
    high plane, [n, 2n) its low plane."""
    n = 37
    words = torch.zeros(3 * n, dtype=torch.int64)
    bits = torch.zeros(n + 3, dtype=torch.uint8)
    rk.threefry_group(MK, 5, 9, layout, [
        rk.GroupDraw(False, n, ((words, 2 * n), (words, 0))),
        rk.GroupDraw(True, n, ((bits, 3),)),
    ])
    key = tring.stream_key(tring.draw_seed(MK, 5, 9), layout, False)
    both = rk.threefry_words_plain(*key, 2 * n, layout, "cpu")
    assert torch.equal(words[2 * n:], both[:n])  # the high plane
    assert torch.equal(words[:n], both[n:])
    assert not words[n:2 * n].any()  # nothing outside the planes
    key = tring.stream_key(tring.draw_seed(MK, 5, 10), layout, True)
    assert torch.equal(bits[3:],
                       rk.threefry_bits_plain(*key, n, layout, "cpu"))
    assert not bits[:3].any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bit_draws_carry_the_domain_tag(layout):
    """A bit draw keys the tagged seed (top bit of word 3 flipped), not
    the seed itself and not the master key."""
    n = 200
    bits = torch.empty(n, dtype=torch.uint8)
    rk.threefry_group(MK, 0, 4, layout, [rk.GroupDraw(True, n, ((bits, 0),))])
    seed = tring.draw_seed(MK, 0, 4)
    tagged = seed[:3] + (seed[3] ^ 0x80000000,)
    assert tring.stream_key(seed, layout, True) == \
        tring.stream_key(tagged, layout, False)
    for key, equal in (
        (tring.stream_key(tagged, layout, False), True),
        (tring.stream_key(seed, layout, False), False),
        (tring.stream_key(MK, layout, True), False),
    ):
        plain = rk.threefry_bits_plain(*key, n, layout, "cpu")
        assert torch.equal(bits, plain) == equal


def test_pallas_group_refuses_beyond_its_counter_before_allocating(
        monkeypatch, threefry_pallas):
    sess = tspmd.SpmdSession(MK, "cpu")

    def no_alloc(*args, **kwargs):
        raise AssertionError("allocated before refusing")

    monkeypatch.setattr(torch, "empty", no_alloc)
    monkeypatch.setattr(torch, "arange", no_alloc)
    for specs in (
        [("sample", (2,), 64), ("sample", (1 << 16, (1 << 16) + 1), 64)],
        [("bank", ((1 << 30) + 1,), 128)],
        [("bit_bank", ((64 << 31) + 1,), None)],
    ):
        with pytest.raises(ValueError, match="2\\^32"):
            sess.sample_group(specs)
    assert sess._counter == 0  # a refused group claims no nonce
    with pytest.raises(ValueError, match="2\\^32"):
        rk.refuse_beyond_counter("threefry-pallas", False, (1 << 31) + 1, 2)
    rk.refuse_beyond_counter("threefry", False, (1 << 31) + 1, 2)


def test_group_refuses_planes_it_cannot_fill():
    words = torch.empty(8, dtype=torch.int64)

    def group(*draws, layout="threefry"):
        rk.threefry_group(MK, 0, 0, layout, list(draws))

    with pytest.raises(ValueError, match="layout"):
        group(rk.GroupDraw(False, 8, ((words, 0),)), layout="rbg")
    with pytest.raises(ValueError, match="uint8"):
        group(rk.GroupDraw(True, 8, ((words, 0),)))
    with pytest.raises(ValueError, match="outside"):
        group(rk.GroupDraw(False, 5, ((words, 0), (words, 4))))
    with pytest.raises(ValueError, match="one plane"):
        group(rk.GroupDraw(True, 4, ((words.view(torch.uint8), 0),) * 2))
    with pytest.raises(ValueError, match="contiguous"):
        group(rk.GroupDraw(False, 2, ((words.view(2, 4).t(), 0),)))
    with pytest.raises(ValueError, match="negative"):
        group(rk.GroupDraw(False, -1, ((words, 0),)))
    sess = tspmd.SpmdSession(MK, "cpu")
    with pytest.raises(ValueError, match="kind"):
        sess.sample_group([("draw", (2,), 64)])
    with pytest.raises(ValueError, match="outside"):
        sess.sample_group([("sample", (2, 4), 64, ((words, 1), None))])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("domain", (0, 7))
def test_group_matches_the_jax_session(layout, domain):
    js = jspmd.SpmdSession(np.array(MK, np.uint32), domain=domain)
    ts = tspmd.SpmdSession(MK, "cpu", domain=domain)
    with prf(layout):
        want = [
            js.sample((4, 3), 64), js.sample_bank((5,), 128),
            js.sample_bit_bank((50,)), js.sample((), 128),
            js.sample_bank((2, 3), 64), js.sample_bit_bank((129,)),
            js.sample((7,), 128),
        ]
        got = ts.sample_group(MIXED)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            assert_words_equal(g, w)
