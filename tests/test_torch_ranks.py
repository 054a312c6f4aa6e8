"""The ring Dot at every rank the JAX package takes, against the JAX
package on the CPU: its rule is ``dot_general``'s, x's last axis against
y's first (``out.shape == x.shape[:-1] + y.shape[1:]``), and a pair it
refuses is refused.

At the protocol level both packages' ``spmd.dot`` and ``spmd.fx_dot``
(the stacked layout) and ``replicated.dot`` with its truncation (the
per-host layout) run on the same shares under one master key, so the
words must be equal one by one, under both threefry streams at both
widths; the host ring Dot (``ring.matmul``) likewise on random words.
At the runtime level both packages' ``LocalMooseRuntime`` run the
replicated and the host Dot on each layout, through
scripts/torch_rank_sweep.py's graphs and verdict, as do the cases of
the other faults that sweep found and the port repaired."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.computation import ReplicatedPlacement as JRep
from moose_tpu.dialects import host as jhost
from moose_tpu.dialects import replicated as jrep
from moose_tpu.dialects import ring as jring
from moose_tpu.execution.session import EagerSession as JaxSession
from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch import interop
from moose_tpu_torch.computation import ReplicatedPlacement as TRep
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.dialects import replicated as trep
from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.execution.session import EagerSession
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import (  # noqa: F401  (fixture)
    assert_shares_equal,
    assert_words_equal,
    jax_rep_from_numpy,
    prf,
    rand_words,
    threefry,
    to_jax,
    to_port,
)

MK = np.array([0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D], np.uint32)
IDS = ("alice", "bob", "carole")
SYNC_SEED = 20261018
STREAMS = ("threefry", "threefry-pallas")
WIDTHS = (64, 128)
# (width, (integral, fractional) precision)
PRECISIONS = ((128, (24, 40)), (64, (14, 23)))
# the pairs the JAX package takes, and the two it refuses
ADMITTED = (
    ((2, 3, 4), (4, 5)), ((2, 3, 4), (4,)), ((2, 3, 4, 5), (5, 2)),
    ((3, 4), (4, 5, 6)), ((4,), (4, 5, 6)),
)
REFUSED = (((2, 3, 4), (2, 4, 5)), ((2, 3, 4), (2, 3, 4)))
JREP, TREP = JRep("rep", IDS), TRep("rep", IDS)


def _ids(pair):
    return "@".join("x".join(map(str, s)) for s in pair)


def _sweep():
    """scripts/torch_rank_sweep.py as a module."""
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "torch_rank_sweep.py"
    spec = importlib.util.spec_from_file_location("torch_rank_sweep", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sweep = _sweep()


# -- the stacked protocol ------------------------------------------------------


@pytest.mark.parametrize("pair", ADMITTED, ids=_ids)
@pytest.mark.parametrize("width,precision", PRECISIONS)
@pytest.mark.parametrize("stream", STREAMS)
def test_stacked_dot_matches_the_reference(stream, width, precision, pair):
    xs, ys = pair
    rng = np.random.default_rng(len(xs) * 10 + len(ys))
    x, y = rng.normal(size=xs), rng.normal(size=ys)
    with prf(stream):
        js, ts = jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")
        jx, jy = (jspmd.fx_encode_share(js, jnp.asarray(v), *precision,
                                        width) for v in (x, y))
        tx, ty = (tspmd.fx_encode_share(ts, torch.as_tensor(v), *precision,
                                        width) for v in (x, y))
        want = jspmd.dot(js, jx.tensor, jy.tensor)
        got = tspmd.dot(ts, tx.tensor, ty.tensor)
        want_fx = jspmd.fx_dot(js, jx, jy)
        got_fx = tspmd.fx_dot(ts, tx, ty)
    out = xs[:-1] + ys[1:]
    assert got.shape == out
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), "dot")
    assert_words_equal((got_fx.tensor.lo, got_fx.tensor.hi),
                       (want_fx.tensor.lo, want_fx.tensor.hi), "fx_dot")
    err = np.abs(tspmd.fx_reveal_decode(got_fx).numpy()
                 - np.tensordot(x, y, 1)).max()
    assert err < 2.0 ** -(precision[1] - 6)


@pytest.mark.parametrize("pair", REFUSED, ids=_ids)
@pytest.mark.parametrize("width", WIDTHS)
def test_stacked_dot_refuses_what_the_reference_refuses(threefry, width,
                                                        pair):
    js, ts = jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")
    jx, jy = (jspmd.share(js, jnp.zeros(s, jnp.uint64), None
                          if width == 64 else jnp.zeros(s, jnp.uint64),
                          width) for s in pair)
    tx, ty = (tspmd.share(ts, torch.zeros(s, dtype=torch.int64), None
                          if width == 64 else torch.zeros(
                              s, dtype=torch.int64), width) for s in pair)
    with pytest.raises(TypeError, match="contracting dimensions"):
        jspmd.dot(js, jx, jy)
    for fn in (tspmd.dot, tspmd.fx_dot):
        args = (tx, ty) if fn is tspmd.dot else (
            tspmd.SpmdFixed(tx, 24, 40), tspmd.SpmdFixed(ty, 24, 40))
        with pytest.raises(ValueError, match=r"cannot contract \(2, 3, 4\)"):
            fn(ts, *args)


# -- the per-host protocol -----------------------------------------------------


def _rep_input(rng, shape, width):
    """(JAX, port) consistent replicated sharings of random words."""
    parts = [rand_words(rng, shape, width) for _ in range(3)]
    shares = tuple(((parts[i], IDS[i]), (parts[(i + 1) % 3], IDS[i]))
                   for i in range(3))
    return (jax_rep_from_numpy(shares, "rep"),
            interop.rep_from_numpy(shares, "rep", device="cpu"))


def _per_host(pair, width, stream, amount):
    """Both packages' replicated Dot of ``pair`` then its truncation by
    ``amount`` in one EagerSession each, under one master key and pinned
    nonces: ((port, JAX) Dot, (port, JAX) trunc)."""
    rng = np.random.default_rng(len(pair[0]) * 10 + len(pair[1]) + width)
    x, y = (_rep_input(rng, s, width) for s in pair)
    with prf(stream), jhost.deterministic_sync_keys(SYNC_SEED), \
            thost.deterministic_sync_keys(SYNC_SEED):
        js = JaxSession(master_key=MK)
        ts = EagerSession("cpu", master_key=MK)
        want = jrep.dot(js, JREP, x[0], y[0])
        got = trep.dot(ts, TREP, x[1], y[1])
        want_t = jrep.trunc_pr(js, JREP, want, amount)
        got_t = trep.trunc_pr(ts, TREP, got, amount)
    return (got, want), (got_t, want_t)


@pytest.mark.parametrize("pair", ADMITTED, ids=_ids)
@pytest.mark.parametrize("width,precision", PRECISIONS)
@pytest.mark.parametrize("stream", STREAMS)
def test_per_host_dot_matches_the_reference(stream, width, precision, pair):
    (got, want), (got_t, want_t) = _per_host(pair, width, stream,
                                             precision[1])
    assert tuple(got.shares[0][0].lo.shape) == pair[0][:-1] + pair[1][1:]
    assert_shares_equal(got, want, "dot")
    assert_shares_equal(got_t, want_t, "trunc_pr")


@pytest.mark.parametrize("pair", REFUSED, ids=_ids)
def test_per_host_dot_refuses_what_the_reference_refuses(threefry, pair):
    rng = np.random.default_rng(7)
    x, y = (_rep_input(rng, s, 128) for s in pair)
    with jhost.deterministic_sync_keys(SYNC_SEED), \
            thost.deterministic_sync_keys(SYNC_SEED):
        with pytest.raises(TypeError, match="contracting dimensions"):
            jrep.dot(JaxSession(master_key=MK), JREP, x[0], y[0])
        with pytest.raises(ValueError, match=r"cannot contract \(2, 3, 4\)"):
            trep.dot(EagerSession("cpu", master_key=MK), TREP, x[1], y[1])


# -- the host ring Dot ---------------------------------------------------------


@pytest.mark.parametrize("pair", ADMITTED + REFUSED + (((3,), (3,)),),
                         ids=_ids)
@pytest.mark.parametrize("width", WIDTHS)
def test_host_ring_dot_matches_the_reference(width, pair):
    rng = np.random.default_rng(width + len(pair[0]))
    x, y = (rand_words(rng, s, width) for s in pair)
    if pair in REFUSED:
        with pytest.raises(TypeError, match="contracting dimensions"):
            jring.matmul(*to_jax(x), *to_jax(y))
        with pytest.raises(ValueError, match="cannot contract"):
            tring.matmul(*to_port(x), *to_port(y))
        return
    got = tring.matmul(*to_port(x), *to_port(y))
    assert tuple(got[0].shape) == pair[0][:-1] + pair[1][1:]
    assert_words_equal(got, jring.matmul(*to_jax(x), *to_jax(y)),
                       "ring.matmul")


def test_a_0d_operand_is_refused():
    """The rule has no axis to contract on a 0-d operand; the JAX
    package fails on it too (an ``IndexError`` of its own)."""
    x, y = (torch.zeros(s, dtype=torch.int64) for s in ((), (3,)))
    for a, b in ((x, y), (y, x)):
        with pytest.raises(ValueError, match="cannot contract"):
            tring.matmul(a, None, b, None)


# -- the runtimes --------------------------------------------------------------


RUNTIME_PAIRS = (((3, 4), (4, 5, 6)), ((4,), (4, 5, 6)),
                 ((2, 3, 4), (2, 4, 5)))


@pytest.mark.parametrize("pair", RUNTIME_PAIRS, ids=_ids)
@pytest.mark.parametrize("family", ("rep", "host"))
def test_runtime_dot_matches_the_reference(family, pair):
    """Both packages' runtimes on the stacked and per-host layouts give
    equal outputs, or both refuse the pair."""
    xs, ys = pair
    case = (f"{family}:Dot", _ids(pair), xs, ys, sweep.FX)
    for row in sweep.run_case(case, ("stacked", "per-host")):
        assert row["verdict"] == "agree", row
        if pair in REFUSED:
            assert "error" in row["jax"] and row["port"]["error"] == \
                "ValueError", row
        else:
            assert row["port"]["outputs"] == {
                "output_0": [list(xs[:-1] + ys[1:]), "float64"]}, row


# -- the other faults of the rank sweep ----------------------------------------

# (kind, rank, routes): a 0-d operand's axis -1, which torch takes and
# numpy refuses; Select on a 0-d operand, which numpy's compress takes as
# shape (1,); a negative-step Slice of a replicated tensor on the stacked
# layout, which torch's slicing refuses
SWEEP_FAULTS = (
    ("host:Sum", 0, sweep.ROUTES), ("host:Softmax", 0, sweep.ROUTES),
    ("host:Argmax", 0, sweep.ROUTES), ("rep:Sum", 0, sweep.ROUTES),
    ("host:Select", 0, ("stacked", "per-host")),
    ("rep:Slice", 1, ("stacked",)), ("rep:Slice", 4, ("stacked",)),
)


@pytest.mark.parametrize("kind,rank,routes", SWEEP_FAULTS,
                         ids=[f"{k}-r{r}" for k, r, _ in SWEEP_FAULTS])
def test_sweep_fault_is_repaired(kind, rank, routes):
    shape = sweep.SHAPES[rank]
    for row in sweep.run_case((kind, f"r{rank}", shape, shape, sweep.FX),
                              routes):
        assert row["verdict"] == "agree", row
