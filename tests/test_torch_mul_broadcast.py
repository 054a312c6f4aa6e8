"""A replicated Mul of a secret by a mirrored constant of a larger
broadcast shape: a secret fixed(14,23) (4, 1) cast on alice times a
mirrored (4, 5) constant, in both operand orders, through the JAX
LocalMooseRuntime (stacked layout) and the port's on the CPU under fixed
keys.  The port broadcasts the shares to (4, 5) before its ring_mul
kernel, so the truncation after it draws at (4, 5) as the reference's
does, and the outputs are bit-identical."""

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_logreg import (  # noqa: F401  (fixtures)
    IDS,
    fixed_keys,
    threefry,
)
from torch_parity import rand_words, to_port

PRECISION = (14, 23)


def mul_by_mirrored(pm, constant, secret_first):
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    mir = pm.mirrored_placement("mir", players=[alice, bob, carole])
    fx = pm.fixed(*PRECISION)

    @pm.computation
    def comp(x: pm.Argument(alice, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with mir:
            c = pm.cast(pm.constant(constant, dtype=pm.float64), dtype=fx)
        with rep:
            z = pm.mul(xf, c) if secret_first else pm.mul(c, xf)
        with alice:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return comp


@pytest.mark.parametrize("secret_first", (True, False),
                         ids=("secret_times_constant",
                              "constant_times_secret"))
def test_mirrored_mul_broadcasts_like_the_reference(fixed_keys,
                                                    secret_first):
    rng = np.random.default_rng(45)
    x = rng.normal(size=(4, 1))
    constant = rng.normal(size=(4, 5))
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(
            mul_by_mirrored(jm, constant, secret_first), {"x": x}
        )["output_0"]
    before = dict(rk.LAUNCHES)
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        mul_by_mirrored(tm, constant, secret_first), {"x": x}
    )["output_0"]
    assert rk.LAUNCHES == before  # the CPU runs the plain versions
    assert got.shape == (4, 5) and np.array_equal(got, want)
    assert np.abs(got - x * constant).max() < 1e-5


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("shares,const", (
    ((4, 1), (4, 5)), ((1, 5), (4, 1)), ((2, 1, 3), (4, 1)),
    ((4, 5), (5,)),
))
def test_mul_public_broadcasts_the_shares_when_it_must(width, shares,
                                                       const):
    rng = np.random.default_rng(width + len(shares))
    sess = tspmd.SpmdSession((1, 2, 3, 4), "cpu")
    x = tspmd.share(sess, *to_port(rand_words(rng, shares, width)), width)
    c_lo, c_hi = to_port(rand_words(rng, const, width))
    got = tspmd.mul_public(x, c_lo, c_hi)
    shape = tuple(np.broadcast_shapes(shares, const))
    assert got.shape == shape
    want_lo, want_hi = rk.ring_mul_plain(
        x.lo.expand((3, 2) + shape), None if x.hi is None
        else x.hi.expand((3, 2) + shape), c_lo, c_hi, width,
    )
    assert torch.equal(got.lo, want_lo)
    assert want_hi is None or torch.equal(got.hi, want_hi)
