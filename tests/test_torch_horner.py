"""The port's K6 (horner) against the JAX package: the plain version
against the unfused ladder ``spmd_math._horner_lax`` fed the same
pre-drawn randomness at several shapes, coefficient counts and
truncation amounts, and against the Pallas kernel in interpret mode at
one tiny shape per width, word for word.  The CUDA kernel against its
plain version: tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest

from moose_tpu.native import ring128_kernels as jrk
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.native import ring_kernels as rk

from torch_parity import (  # noqa: F401
    assert_words_equal,
    rand_words,
    to_jax,
    to_port,
)


def _stack(pairs):
    """numpy (lo, hi) pairs of one shape stacked on a new leading axis."""
    lo = np.stack([p[0] for p in pairs])
    return lo, None if pairs[0][1] is None else np.stack([p[1] for p in pairs])


def _ladder_inputs(seed, shape, width, steps):
    """Random shares of x, raw coefficients and, per step, one zero-share
    bank (3, *shape) and five truncation draws (*shape)."""
    rng = np.random.default_rng(seed)
    x = rand_words(rng, (3, 2) + shape, width)
    raws = [int(v) for v in rng.integers(0, 1 << 62, size=steps + 1)]
    banks = [rand_words(rng, (3,) + shape, width) for _ in range(steps)]
    draws = [[rand_words(rng, shape, width) for _ in range(5)]
             for _ in range(steps)]
    return x, raws, banks, draws


def _port_call(fn, x, width, raws, f, banks, draws):
    lo, hi = to_port(x)
    slot = [(lo[:, s].contiguous(),
             None if hi is None else hi[:, s].contiguous()) for s in (0, 1)]
    zbanks = to_port(_stack(banks))
    tdraws = to_port(_stack([_stack(ds) for ds in draws]))
    return fn(slot[0], slot[1], width, raws, f, zbanks, tdraws)


def _jax_ladder(x, width, raws, f, banks, draws):
    queue = []
    for bank, ds in zip(banks, draws):
        queue.append(to_jax(bank))
        queue.extend(to_jax(d) for d in ds)
    rep = jspmd.SpmdRep(*to_jax(x), width)
    return jsm._horner_lax(jsm._ReplaySession(queue), rep, raws, f)


def _assert_slots_equal(got, rep, label):
    for s in (0, 1):
        want = (rep.lo[:, s], None if rep.hi is None else rep.hi[:, s])
        assert_words_equal(got[s], want, f"{label} slot {s}")


@pytest.mark.parametrize("width,f", ((64, 23), (64, 35), (128, 40),
                                     (128, 62)))
@pytest.mark.parametrize("shape,steps", (((4,), 3), ((2, 3), 1), ((5,), 14)))
def test_horner_plain_matches_unfused_ladder(width, f, shape, steps):
    x, raws, banks, draws = _ladder_inputs(width + f + steps, shape, width,
                                           steps)
    raws = [r % (1 << width) for r in raws]
    got = _port_call(rk.horner, x, width, raws, f, banks, draws)
    want = _jax_ladder(x, width, raws, f, banks, draws)
    _assert_slots_equal(got, want, f"horner{shape}/{steps}/ring{width}")


@pytest.mark.parametrize("width,f", ((64, 23), (128, 62)))
def test_horner_plain_matches_pallas_kernel(width, f):
    shape, steps = (3,), 2
    x, raws, banks, draws = _ladder_inputs(width, shape, width, steps)
    lo, hi = to_jax(x)
    zb, td = _stack(banks), _stack([_stack(ds) for ds in draws])
    s0, s1 = jrk.horner(
        (lo[:, 0], None if hi is None else hi[:, 0]),
        (lo[:, 1], None if hi is None else hi[:, 1]),
        width, raws, f, to_jax(zb), to_jax(td), shape,
    )
    before = dict(rk.LAUNCHES)
    got = _port_call(rk.horner, x, width, raws, f, banks, draws)
    assert_words_equal(got[0], s0, "pallas horner slot 0")
    assert_words_equal(got[1], s1, "pallas horner slot 1")
    assert rk.LAUNCHES == before


def test_horner_ladder_decodes_the_polynomial():
    # the shared plain ladder on a trivial sharing of x = 0.5 evaluates
    # 1 + 0.5 x + 0.25 x^2 within the truncation noise
    f, width = 20, 64
    raw = [int(round(c * (1 << f))) for c in (0.25, 0.5, 1.0)]
    xv = np.zeros((3, 2, 2), np.uint64)
    xv[0, 0] = xv[2, 1] = 1 << (f - 1)
    rng = np.random.default_rng(0)
    banks = [rand_words(rng, (3, 2), width) for _ in range(2)]
    draws = [[rand_words(rng, (2,), width) for _ in range(5)]
             for _ in range(2)]
    s0, _ = _port_call(rk.horner, (xv, None), width, raw, f, banks, draws)
    value = int(sum(int(w) for w in s0[0][:, 0].numpy().view(np.uint64)))
    value = (value % (1 << 64)) / (1 << f)
    assert abs(value - (1 + 0.25 + 0.0625)) < 2.0 ** -(f - 3)


MK = np.array([0x0F1E2D3C, 0x4B5A6978, 0x8796A5B4, 0xC3D2E1F0], np.uint32)


@pytest.mark.parametrize("impl", ("threefry", "threefry-pallas"))
@pytest.mark.parametrize("width,frac", ((64, 20), (128, 40)))
@pytest.mark.parametrize("layout", ("contiguous", "transposed"))
def test_polynomial_eval_reads_and_writes_the_pair_layout(impl, width, frac,
                                                          layout):
    """polynomial_eval through horner_pairs, which reads x's pair slots
    in place (a transposed view is not copied) and returns the result's
    pair layout, equals the JAX package's polynomial_eval word for word
    under one master key, its draws one group."""
    from moose_tpu.dialects.fixedpoint import P_1045 as JP_1045
    from moose_tpu_torch.dialects.fixedpoint import P_1045
    from moose_tpu_torch.parallel import spmd as tspmd
    from moose_tpu_torch.parallel import spmd_math as tsm

    from torch_parity import prf

    with prf(impl):
        js, ts = jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")
        words = rand_words(np.random.default_rng(width + len(layout)),
                           (3, 6), width)
        jx = jspmd.share(js, *to_jax(words), width)
        tx = tspmd.share(ts, *to_port(words), width)
        if layout == "transposed":
            jx, tx = jspmd.transpose_2d(jx), tspmd.transpose(tx)
            assert not tx.lo.is_contiguous()
        counter = ts._counter
        got = tsm.polynomial_eval(ts, P_1045, tspmd.SpmdFixed(tx, 2, frac),
                                  min_coeff=2.0 ** -(frac + 4)).tensor
        want = jsm.polynomial_eval(js, JP_1045, jspmd.SpmdFixed(jx, 2, frac),
                                   min_coeff=2.0 ** -(frac + 4)).tensor
    # every step's six draws (a bank and five truncation draws), one group
    drawn = ts._counter - counter
    assert drawn > 0 and drawn % 6 == 0
    assert got.lo.shape == (3, 2) + tx.shape and got.lo.is_contiguous()
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi),
                       f"polynomial_eval {layout} ring{width}")
