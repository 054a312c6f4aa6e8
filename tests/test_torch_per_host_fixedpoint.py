"""The per-host layout's fixed-point library against the JAX package's,
word for word: the 25 protocol-library kinds of ``chip_smoke``'s library
graph (exp, log, log2, sqrt, softmax, argmax, maximum, the comparisons,
the muxes and the structural kinds) through both runtimes'
``layout="per-host"``, and sigmoid, the Goldschmidt division, exp, the
pools, maximum and argmax called on the dialect at (2, 4) fixed(24,40).

The library graph is the file's one heavy JAX reference (about 50 s of
eager compiles on the CPU), shared by a module-scoped fixture; the
dialect calls reuse its compiled shapes."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.dialects import fixedpoint as jfx
from moose_tpu.dialects import replicated as jrep
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime
from moose_tpu.values import RepFixedTensor as JFixed

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import fixedpoint as tfx
from moose_tpu_torch.dialects import replicated as trep
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime
from moose_tpu_torch.values import RepFixedTensor as TFixed

from moose_tpu_torch import interop

from test_torch_per_host_dialects import (
    JREP,
    TREP,
    assert_shares_equal,
    both,
    jax_host_from_numpy,
    ring_input,
)
from torch_parity import (  # noqa: F401  (fixtures)
    fixed_keys_env,
    load_chip_smoke,
    prf,
    threefry,
    threefry_pallas,
)

cs = load_chip_smoke()
IDS = ["alice", "bob", "carole"]
ROWS, COLS = 2, 4
I_P, F_P = 24, 40


@pytest.fixture(scope="module")
def library_runs():
    """Both runtimes' per-host outputs of the library graph at (2, 4),
    under threefry and fixed keys."""
    args = cs.library_inputs(np.random.default_rng(11), rows=ROWS,
                             cols=COLS)
    with prf("threefry"), fixed_keys_env():
        want = JaxRuntime(IDS, layout="per-host", use_jit=False) \
            .evaluate_computation(
                cs.library_computation(jm, rows=ROWS, cols=COLS), args)
        runtime = PortRuntime(IDS, layout="per-host", device="cpu")
        got = runtime.evaluate_computation(
            cs.library_computation(tm, rows=ROWS, cols=COLS), args)
    return got, want, args, runtime.last_plan


@pytest.mark.parametrize("index,kind", list(enumerate(cs.LIBRARY_KINDS)),
                         ids=list(cs.LIBRARY_KINDS))
def test_library_kind_matches_the_jax_per_host_runtime(library_runs, index,
                                                       kind):
    got, want, _, plan = library_runs
    name = f"output_{index}"
    g, w = np.asarray(got[name]), np.asarray(want[name])
    assert plan["layout"] == "per-host"
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w), kind


def test_library_outputs_hold_their_float64_limits(library_runs):
    got, _, args, _ = library_runs
    errs, failed = cs.library_errors(got, args)
    assert not failed, errs


def _fixed_input(rng, positive=False):
    """(JAX, port) fixed(24,40) ring128 sharings of floats: shared from
    alice in the session that uses them."""
    values = rng.normal(size=(ROWS, COLS))
    if positive:
        values = np.abs(values) + 0.5
    raw = np.round(values * 2.0 ** F_P).astype(np.int64)
    lo = raw.view(np.uint64)
    hi = np.where(raw < 0, np.uint64(2 ** 64 - 1), np.uint64(0))
    words = (lo, hi)
    return (jax_host_from_numpy(words, "alice"),
            interop.host_from_numpy(words, "alice", device="cpu")), values


def _run(fn_name, *, positive=False, extra=()):
    rng = np.random.default_rng(sum(map(ord, fn_name)))
    x, _ = _fixed_input(rng)
    y, _ = _fixed_input(rng, positive=positive)

    def run(rep_ops, fx_ops, rep, fixed):
        def fn(sess, x, y):
            a = fixed(rep_ops.share(sess, rep, x), I_P, F_P)
            b = fixed(rep_ops.share(sess, rep, y), I_P, F_P)
            return getattr(fx_ops, fn_name)(sess, rep, *{
                "div": (a, b), "maximum": ([a, b],),
            }.get(fn_name, (a,)), *extra)
        return fn

    return both(run(jrep, jfx, JREP, JFixed), run(trep, tfx, TREP, TFixed),
                x, y)


@pytest.mark.parametrize("fn_name,extra", (
    ("sigmoid", ()), ("exp", ()), ("div", ()), ("maximum", ()),
    ("argmax", (1, COLS)), ("softmax", (1, COLS)),
), ids=lambda v: v if isinstance(v, str) else "")
def test_fixedpoint_function_matches_under_threefry_pallas(threefry_pallas,
                                                           fn_name, extra):
    got, want = _run(fn_name, positive=fn_name == "div", extra=extra)
    if fn_name == "argmax":
        assert_shares_equal(got, want, fn_name)
    else:
        assert (got.integral_precision, got.fractional_precision) == \
            (want.integral_precision, want.fractional_precision)
        assert_shares_equal(got.tensor, want.tensor, fn_name)


@pytest.mark.parametrize("pool", ("avg_pool2d", "max_pool2d"))
def test_pools_match(threefry, pool):
    rng = np.random.default_rng(7)
    img = ring_input(rng, (1, 4, 4, 2), 128)

    def run(rep_ops, fx_ops, rep, fixed):
        def fn(sess, x):
            a = fixed(rep_ops.share(sess, rep, x), I_P, F_P)
            return getattr(fx_ops, pool)(sess, rep, a, (2, 2))
        return fn

    got, want = both(run(jrep, jfx, JREP, JFixed),
                     run(trep, tfx, TREP, TFixed), img)
    assert_shares_equal(got.tensor, want.tensor, pool)
