"""The stacked layout's compiled plan (``execution/interpreter.py``,
``execution/graphs.py``) on the CPU, where a plan's segments run
uncaptured through the code the card captures.

- The secure dot (4x3 @ 3x2, fixed(14,23)) through the port's eager walk,
  its whole-graph plan and its segmented plan (``MOOSE_TPU_JIT_SEGMENT=3``)
  under two master keys and threefry, word for word the JAX package's
  jitted plans of the same shape, with the same ``last_plan``.  (Config
  3's plans are held in ``tests/test_torch_logreg.py``, beside the JAX
  runs they share.)
- The validated-jit ladder on the port's stacked plans reaches the rungs,
  pins and states that ``tests/test_selfcheck.py`` expects of the JAX
  package's (its tests at lines 73-160, 323-398, 440-458, 510-525), and
  the runtime reroutes an exhausted plan to the per-host layout.
- aes-ctr is refused under ``use_jit`` in both packages, with the same
  words.
- K7's group under a key tensor equals its draws under the key's words.
- Two threads on one plan get the single-thread words.
"""

import os
import threading

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.errors import ConfigurationError as JaxConfigurationError
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import ring, stacked
from moose_tpu_torch.edsl import tracer
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.execution import graphs
from moose_tpu_torch.execution import interpreter as interp
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import fixed_keys_env, prf, threefry  # noqa: F401

IDS = ["alice", "bob", "carole"]
KEYS = ("plan-a", "plan-b")


def _players(pm):
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    return alice, bob, carole, pm.replicated_placement(
        "rep", players=[alice, bob, carole])


def dot_comp(pm):
    """``tests/test_selfcheck.py``'s ``_dot_comp``."""
    alice, bob, carole, rep = _players(pm)

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.float64),
             w: pm.Argument(placement=bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=pm.fixed(14, 23))
        with bob:
            wf = pm.cast(w, dtype=pm.fixed(14, 23))
        with rep:
            y = pm.dot(xf, wf)
        with carole:
            out = pm.cast(y, dtype=pm.float64)
        return out

    return comp


def mul_add_comp(pm):
    """``tests/test_selfcheck.py``'s ``_mul_add_comp``."""
    alice, bob, carole, rep = _players(pm)

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.float64),
             w: pm.Argument(placement=bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=pm.fixed(8, 17))
        with bob:
            wf = pm.cast(w, dtype=pm.fixed(8, 17))
        with rep:
            y = pm.add(pm.mul(xf, wf), xf)
        with carole:
            out = pm.cast(y, dtype=pm.float64)
        return out

    return comp


def linear_comp(pm):
    """``tests/test_stacked_backend.py``'s ``_linear_comp``: exact on
    both layouts."""
    alice, bob, carole, rep = _players(pm)

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.float64),
             y: pm.Argument(placement=bob, dtype=pm.float64)):
        with alice:
            x_f = pm.cast(x, dtype=pm.fixed(14, 23))
        with bob:
            y_f = pm.cast(y, dtype=pm.fixed(14, 23))
        with rep:
            z = pm.add(x_f, pm.sub(x_f, y_f))
        with carole:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return comp


@pytest.fixture(scope="module")
def jax_dot():
    """The JAX package's stacked dot at 4x3 @ 3x2, jitted whole and in
    segments of 3 ops, under both keys: {(segment, key): (words,
    last_plan)}.  One runtime a plan shape, so each compiles once."""
    rng = np.random.default_rng(5)
    args = {"x": rng.normal(size=(4, 3)), "w": rng.normal(size=(3, 2))}
    got = {}
    with prf("threefry"):
        for segment in (None, "3"):
            saved = os.environ.pop("MOOSE_TPU_JIT_SEGMENT", None)
            if segment:
                os.environ["MOOSE_TPU_JIT_SEGMENT"] = segment
            try:
                runtime = JaxRuntime(IDS, layout="stacked", use_jit=True)
                comp = dot_comp(jm)
                for key in KEYS:
                    with fixed_keys_env(key):
                        out = runtime.evaluate_computation(comp, args)
                    plan = {k: v for k, v in runtime.last_plan.items()
                            if k != "autotune"}
                    got[(segment, key)] = (np.asarray(out["output_0"]), plan)
            finally:
                os.environ.pop("MOOSE_TPU_JIT_SEGMENT", None)
                if saved is not None:
                    os.environ["MOOSE_TPU_JIT_SEGMENT"] = saved
    return args, got


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("mode", ("eager", "whole-graph", "segmented"))
def test_secure_dot_plans_are_the_jax_package_s(jax_dot, threefry,
                                                monkeypatch, mode, key):
    args, want = jax_dot
    segment = "3" if mode == "segmented" else None
    if segment:
        monkeypatch.setenv("MOOSE_TPU_JIT_SEGMENT", segment)
    runtime = PortRuntime(IDS, layout="stacked", use_jit=mode != "eager",
                          device="cpu")
    with fixed_keys_env(key):
        out = runtime.evaluate_computation(dot_comp(tm), args)["output_0"]
    words, plan = want[(segment, key)]
    # the JAX package's jitted words are its eager walk's (its own
    # self-check); its segments draw from their own key domains
    assert np.array_equal(out, words)
    assert np.abs(out - args["x"] @ args["w"]).max() < 1e-5
    expected = dict(plan)
    if mode == "eager":
        expected.update(plan_mode="eager")
    for k, v in expected.items():
        assert runtime.last_plan[k] == v, k
    assert runtime.last_plan["cuda_graphs"] == 0  # nothing is captured


# -- the ladder: tests/test_selfcheck.py's expectations -------------------


def _runner(comp, args, checks):
    """A validated runner of ``comp``'s stacked plan on the CPU, with the
    plan's binding."""
    traced = tracer.trace(comp)
    dialect = stacked.StackedDialect()
    runner = interp._SelfCheckRunner(traced, args, checks, dialect=dialect,
                                     device="cpu")
    dyn = interp.Interpreter("cpu", dialect)._bind_dynamic(
        runner.eager_plan, traced, args, {}, None)
    return traced, runner, dyn


def _mk(i=0):
    return torch.tensor(np.arange(4) + 77 + i, dtype=torch.int64)


def _decoded(result):
    outputs, _ = result
    (value,) = outputs.values()
    return interp._to_user_value(None, value)


@pytest.fixture()
def dot_setup():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 4))
    w = rng.normal(size=(4, 2))
    return dot_comp(tm), {"x": x, "w": w}, x @ w


def _drive(runner, dyn, first, most=12):
    outs = []
    for i in range(most):
        if runner.mode != "validating":
            break
        outs.append(runner.run(_mk(first + i), dyn))
    return outs


def test_selfcheck_promotes_after_clean_runs(dot_setup):
    comp, args, want = dot_setup
    _, runner, dyn = _runner(comp, args, checks=2)
    assert runner.mode == "validating"
    out1 = runner.run(_mk(0), dyn)
    assert runner.mode == "validating"  # one clean run of two
    out2 = runner.run(_mk(1), dyn)
    assert runner.mode == "jit" and runner.plan_mode == "whole-graph"
    out3 = runner.run(_mk(2), dyn)
    for out in (out1, out2, out3):
        np.testing.assert_allclose(_decoded(out), want, atol=1e-5)


def test_selfcheck_demotes_down_ladder_on_divergence(dot_setup):
    comp, args, want = dot_setup
    _, runner, dyn = _runner(comp, args, checks=1)
    real = runner._jit_fn

    def corrupted(master_key, d):
        outputs, saves = real(master_key, d)
        return graphs.map_tensors(outputs, lambda t: t + 5e13), saves

    runner._jit_fn = corrupted
    out = runner.run(_mk(3), dyn)
    # the divergence returned the eager result and moved one rung down,
    # to an honest candidate, which promotes
    np.testing.assert_allclose(_decoded(out), want, atol=1e-5)
    assert runner.mode == "validating" and runner._level == 1
    out2 = runner.run(_mk(4), dyn)
    assert runner.mode == "jit"
    np.testing.assert_allclose(_decoded(out2), want, atol=1e-5)


def test_selfcheck_pins_eager_when_every_rung_fails(dot_setup):
    comp, args, want = dot_setup
    _, runner, dyn = _runner(comp, args, checks=1)

    def broken(master_key, d):
        raise RuntimeError("injected candidate failure")

    runner._jit_fn = broken
    runner._build_candidate = lambda: setattr(runner, "_jit_fn", broken)
    # each rung forgives one failure to run before a second burns it
    for i in range(2 * len(interp._SelfCheckRunner.LADDER)):
        np.testing.assert_allclose(
            _decoded(runner.run(_mk(10 + i), dyn)), want, atol=1e-5)
    assert runner.mode == "eager" and runner.exhausted
    np.testing.assert_allclose(_decoded(runner.run(_mk(20), dyn)), want,
                               atol=1e-5)


def test_a_failed_capture_raises_through_the_ladder(dot_setup):
    # unlike a candidate that fails to run (retried, then demoted), a
    # graph that cannot be captured or replayed is a fault
    comp, args, _ = dot_setup
    _, runner, dyn = _runner(comp, args, checks=1)

    def uncapturable(master_key, d):
        raise graphs.GraphCaptureError("capturing whole graph failed")

    runner._jit_fn = uncapturable
    with pytest.raises(graphs.GraphCaptureError):
        runner.run(_mk(5), dyn)
    assert runner.mode == "validating" and runner._level == 0


def test_results_equal_is_exact(dot_setup):
    comp, args, _ = dot_setup
    _, runner, dyn = _runner(comp, args, checks=1)
    ref = runner._invoke(runner._ref_fn, _mk(30), dyn)
    assert interp._results_equal(ref, ref)
    outputs, saves = ref
    bumped = graphs.map_tensors(outputs, lambda t: t + 1e-9)
    assert not interp._results_equal((bumped, saves), ref)


def test_selfcheck_runs_env(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "5")
    assert interp._selfcheck_runs() == 5
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "0")
    assert interp._selfcheck_runs() == 0
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "nope")
    with pytest.raises(ConfigurationError):
        interp._selfcheck_runs()


def test_per_op_rung_pins_exactly_the_faulted_op(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FAULT", "Mul")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3)) * 0.5
    w = rng.normal(size=(4, 3)) * 0.5
    args = {"x": x, "w": w}
    comp = mul_add_comp(tm)
    traced, runner, dyn = _runner(comp, args, checks=1)
    muls = sorted(n for n, op in traced.operations.items()
                  if op.kind == "Mul")
    assert len(muls) == 1
    outs = _drive(runner, dyn, 40)
    # the whole-graph, 200-op and 50-op rungs carry the fault: the ladder
    # lands on the per-op rung with exactly the faulted op pinned
    assert [runner.mode, runner.plan_mode] == ["per-op", "per-op"]
    assert runner.pinned_ops == muls
    out = runner.run(_mk(99), dyn)  # the mixed steady state
    for o in outs + [out]:
        np.testing.assert_allclose(_decoded(o), x * w + x, atol=5e-3)
    # the plan registry restores the promotion and the pins for a new
    # runner of the same computation
    runner2 = interp._SelfCheckRunner(traced, args, 1,
                                      dialect=stacked.StackedDialect(),
                                      device="cpu")
    assert runner2.mode == "per-op" and runner2.pinned_ops == muls
    np.testing.assert_allclose(_decoded(runner2.run(_mk(120), dyn)),
                               x * w + x, atol=5e-3)


def test_per_op_limit_skips_rung_to_eager(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FAULT", "Mul")
    monkeypatch.setenv("MOOSE_TPU_PEROP_MAX", "2")
    rng = np.random.default_rng(6)
    args = {"x": rng.normal(size=(2, 2)), "w": rng.normal(size=(2, 2))}
    _, runner, dyn = _runner(mul_add_comp(tm), args, checks=1)
    _drive(runner, dyn, 70)
    assert runner.mode == "eager" and runner.exhausted


def test_small_graph_promotes_to_segmented_via_runtime(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FORCE", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SEGMENT", "3")
    rng = np.random.default_rng(44)
    args = {"x": rng.normal(size=(3, 2)), "w": rng.normal(size=(2, 2))}
    runtime = PortRuntime(IDS, use_jit=True, device="cpu")
    comp = dot_comp(tm)
    states = []
    for _ in range(3):  # two validating runs (the default K=2), then jit
        got = runtime.evaluate_computation(comp, args)["output_0"]
        np.testing.assert_allclose(got, args["x"] @ args["w"], atol=1e-5)
        states.append(runtime.last_plan["plan_state"])
    assert states == ["validating", "jit", "jit"]
    assert runtime.last_plan["plan_mode"] == "segmented"
    assert runtime.last_plan["pinned_ops"] == []


def test_stacked_ladder_exhaustion_reroutes_to_per_host(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FORCE", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    comp = linear_comp(tm)
    rng = np.random.default_rng(9)
    args = {"x": rng.normal(size=(8, 3)), "y": rng.normal(size=(8, 3))}
    runtime = PortRuntime(IDS, layout="stacked", use_jit=True,
                          device="cpu")
    (got1,) = runtime.evaluate_computation(comp, arguments=args).values()
    assert runtime.last_plan["layout"] == "stacked"
    traced = runtime._trace_cache[comp]
    (cached,) = runtime._stacked._cache[traced].values()
    runner = cached.fn.__self__
    assert isinstance(runner, interp._SelfCheckRunner)
    runner.mode = "eager"
    runner._save_state()
    assert runtime._stacked.plan_exhausted(traced, args)
    (got2,) = runtime.evaluate_computation(comp, arguments=args).values()
    assert runtime.last_plan["layout"] == "per-host"  # rerouted
    assert runtime.last_plan["plan_mode"] is not None
    np.testing.assert_array_equal(got1, got2)


# -- aes-ctr, K7's key tensor, the plan lock --------------------------------


def test_aes_ctr_is_refused_under_use_jit_in_both_packages():
    rng = np.random.default_rng(7)
    args = {"x": rng.normal(size=(4, 3)), "w": rng.normal(size=(3, 2))}
    with prf("aes-ctr"):
        with pytest.raises(JaxConfigurationError) as jax_error:
            JaxRuntime(IDS, layout="stacked", use_jit=True) \
                .evaluate_computation(dot_comp(jm), args)
        with pytest.raises(ConfigurationError) as port_error:
            PortRuntime(IDS, layout="stacked", use_jit=True, device="cpu") \
                .evaluate_computation(dot_comp(tm), args)
    assert str(port_error.value) == str(jax_error.value) == \
        ring.AES_CTR_UNDER_JIT


@pytest.mark.parametrize("layout", ("threefry", "threefry-pallas"))
def test_threefry_group_key_tensor_equals_the_key_words(layout):
    words = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
    spec = (("w128", 300), ("bits", 200), ("w64", 70))

    def draws():
        return [rk.GroupDraw(kind == "bits", n, tuple(
            (torch.zeros(n, dtype=torch.uint8 if kind == "bits"
                         else torch.int64), 0)
            for _ in range(2 if kind == "w128" else 1)))
            for kind, n in spec]

    def planes(ds):
        return [buf for d in ds for buf, _ in d.planes]

    by_tensor, by_words, plain = draws(), draws(), draws()
    rk.threefry_group(rk.key_tensor(words, "cpu"), 3, 1000, layout,
                      by_tensor)
    rk.threefry_group(words, 3, 1000, layout, by_words)
    rk.threefry_group_plain(words, 3, 1000, layout, plain)
    for a, b, c in zip(planes(by_tensor), planes(by_words), planes(plain)):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="4 words"):
        rk.threefry_group(torch.zeros(3, dtype=torch.int64), 3, 1000,
                          layout, draws())


def test_two_threads_on_one_plan_get_the_single_thread_words():
    rng = np.random.default_rng(11)
    inputs = [[{"x": rng.normal(size=(4, 3)), "w": rng.normal(size=(3, 2))}
               for _ in range(3)] for _ in range(2)]
    runtime = PortRuntime(IDS, use_jit=True, device="cpu")
    comp = dot_comp(tm)
    with fixed_keys_env("plan-threads"):
        single = [[runtime.evaluate_computation(comp, a)["output_0"]
                   for a in mine] for mine in inputs]
        got = [[None] * 3, [None] * 3]

        def serve(t):
            for i, a in enumerate(inputs[t]):
                got[t][i] = runtime.evaluate_computation(comp, a)["output_0"]

        threads = [threading.Thread(target=serve, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for mine, ones in zip(got, single):
        for a, b in zip(mine, ones):
            assert np.array_equal(a, b)
