"""The physical executor's compiled plans against the JAX package.

(a) The JAX package's four physical self-check cases
(tests/test_selfcheck.py): the same lowered dot (3 x 4 @ 4 x 2,
fixed(14,23)) and mul (3 x 2, fixed(8,17)) graphs, lowered by both
packages under one pinned nonce stream, through the port's
``_SelfCheckRunner`` with the physical hooks: promotion after clean runs,
demotion on a corrupted candidate, the per-op rung pinning exactly the
faulted ``Neg``, and chunks above a ``MOOSE_TPU_PEROP_MAX`` of 10.  Every
result is held to the JAX package's ``execute_physical(...,
use_jit=False)`` under fixed keys, word for word.  (b) The seven graphs
of tests/test_torch_physical.py through ``PhysicalInterpreter`` at
``use_jit=True`` under ``MOOSE_TPU_SELFCHECK_FORCE=1``, whole and in
5-op segments: outputs and storage word-equal to the JAX package's
eager physical run (the one float host Exp within one ulp, as there).
(c) K7's plain version under a draw's own key, in modes (b) and (c),
against ``ring.mix_seed`` and the stream's plain expansion.  (d)
``last_plan`` of the auto-lowered route and of ``evaluate_compiled``.
(e) aes-ctr under ``use_jit`` in both packages: refused outright without
the self-check, and with it the same ladder, down to the per-op rung
with the same ops pinned.  The JAX sides run eagerly (the self-check
ladder of (e) is the JAX package's own)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.execution import physical as jphysical
from moose_tpu.execution.physical import execute_physical as jexecute

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import ring
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.execution import interpreter as interp
from moose_tpu_torch.execution import physical
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_physical import GRAPHS, assert_outputs_equal
from torch_parity import fixed_keys_env, lowered_pair, lowering_case, prf

IDS = ["alice", "bob", "carole"]
SYNC_SEED = 20261024


# -- (a) the JAX package's physical self-check cases ----------------------


def _selfcheck_graph(pm, kind):
    """tests/test_selfcheck.py's lowered dot and mul computations, for
    either package's module."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    dtype = pm.fixed(14, 23) if kind == "dot" else pm.fixed(8, 17)

    @pm.computation
    def comp(
        x: pm.Argument(placement=alice, dtype=pm.float64),
        w: pm.Argument(placement=bob, dtype=pm.float64),
    ):
        with alice:
            xf = pm.cast(x, dtype=dtype)
        with bob:
            wf = pm.cast(w, dtype=dtype)
        with rep:
            y = pm.dot(xf, wf) if kind == "dot" else pm.mul(xf, wf)
        with carole:
            out = pm.cast(y, dtype=pm.float64)
        return out

    return comp


def _selfcheck_args(kind):
    if kind == "dot":
        rng = np.random.default_rng(33)
        return {"x": rng.normal(size=(3, 4)), "w": rng.normal(size=(4, 2))}
    rng = np.random.default_rng(44)
    return {"x": rng.normal(size=(3, 2)), "w": rng.normal(size=(3, 2))}


def _lowered(package, kind, args):
    """One package's lowering of a self-check graph (DEFAULT_PASSES but
    networking), inside its own pinned nonce stream."""
    import importlib

    compilation = importlib.import_module(package + ".compilation")
    lowering = importlib.import_module(package + ".compilation.lowering")
    tracer = importlib.import_module(package + ".edsl.tracer")
    host = importlib.import_module(package + ".dialects.host")
    pm = jm if package == "moose_tpu" else tm
    passes = [p for p in compilation.DEFAULT_PASSES if p != "networking"]
    with host.deterministic_sync_keys(SYNC_SEED):
        return compilation.compile_computation(
            tracer.trace(_selfcheck_graph(pm, kind)), passes,
            arg_specs=lowering.arg_specs_from_arguments(args))


@pytest.fixture(scope="module")
def jax_words():
    """The JAX package's eager physical outputs of both self-check graphs
    under fixed keys."""
    out = {}
    with prf("threefry"), fixed_keys_env():
        for kind in ("dot", "mul"):
            args = _selfcheck_args(kind)
            out[kind] = jexecute(_lowered("moose_tpu", kind, args), {}, args,
                                 use_jit=False)["output_0"]
    return out


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FORCE", "1")
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "torch-parity")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")
    with prf("threefry"):
        yield monkeypatch


def _runner(comp, args, checks, per_op=True):
    return interp._SelfCheckRunner(
        comp, args, checks, builder=physical._physical_plan_builder,
        pin_nonces=False,
        per_op_builder=physical._physical_per_op_builder if per_op else None,
        plan_key="physical", device="cpu")


def _run(runner, args):
    """One evaluation's words: the fixed keys as the plan's key table,
    the arguments as the JAX tests pass them (numpy)."""
    order, key_ops, dyn_names, _, _ = runner.eager_plan
    dyn = {n: np.asarray(args[n]) for n in dyn_names}
    return runner.run(physical.plan_keys(key_ops, "cpu"), dyn)


def _decoded(result):
    (value,) = result[0].values()
    return interp._to_user_value(None, value)


def _drive(runner, args, most=12):
    outs = []
    for _ in range(most):
        if runner.mode != "validating":
            break
        outs.append(_run(runner, args))
    return outs


def test_both_packages_lower_the_self_check_graphs_alike():
    from torch_parity import same_graph

    for kind in ("dot", "mul"):
        args = _selfcheck_args(kind)
        same_graph(_lowered("moose_tpu", kind, args),
                   _lowered("moose_tpu_torch", kind, args))


def test_physical_selfcheck_promotes_and_is_exact(forced, jax_words):
    args = _selfcheck_args("dot")
    # the runner holds the graph weakly, as the plan caches do
    comp = _lowered("moose_tpu_torch", "dot", args)
    runner = _runner(comp, args, 2, per_op=False)
    assert runner.mode == "validating"
    out1 = _run(runner, args)
    assert runner.mode == "validating"
    out2 = _run(runner, args)
    assert runner.mode == "jit"
    out3 = _run(runner, args)
    for out in (out1, out2, out3):
        assert np.array_equal(_decoded(out), jax_words["dot"])
    assert np.abs(jax_words["dot"] - args["x"] @ args["w"]).max() < 1e-5


def test_physical_selfcheck_demotes_on_corruption(forced, jax_words):
    args = _selfcheck_args("dot")
    # the runner holds the graph weakly, as the plan caches do
    comp = _lowered("moose_tpu_torch", "dot", args)
    runner = _runner(comp, args, 1, per_op=False)
    real_jit = runner._jit_fn

    def corrupted(keys, dyn):
        outputs, saves = real_jit(keys, dyn)
        return {k: dataclasses.replace(v, value=v.value + 5e13)
                for k, v in outputs.items()}, saves

    runner._jit_fn = corrupted
    out = _run(runner, args)
    # the eager reference's words, and the ladder one rung down
    assert np.array_equal(_decoded(out), jax_words["dot"])
    assert runner.mode == "validating"
    assert runner._level == 1


def test_physical_per_op_rung_is_bit_exact_with_pinned_op(forced,
                                                        jax_words):
    args = _selfcheck_args("mul")
    comp = _lowered("moose_tpu_torch", "mul", args)
    neg_ops = sorted(n for n, op in comp.operations.items()
                     if op.kind == "Neg")
    assert len(neg_ops) == 1
    forced.setenv("MOOSE_TPU_SELFCHECK_FAULT", "Neg")
    runner = _runner(comp, args, 1)
    outs = _drive(runner, args)
    assert runner.mode == "per-op"
    assert runner.pinned_ops == neg_ops
    mixed = _run(runner, args)
    order, key_ops, _, _, _ = runner.eager_plan
    dyn = {n: np.asarray(args[n]) for n in runner.eager_plan.dyn_names}
    ref = runner._eager_fn(physical.plan_keys(key_ops, "cpu"), dyn)
    assert interp._results_equal(mixed, ref)
    for out in outs + [mixed]:
        assert np.array_equal(_decoded(out), jax_words["mul"])


def test_physical_per_op_rung_chunks_above_cap(forced, jax_words):
    args = _selfcheck_args("mul")
    comp = _lowered("moose_tpu_torch", "mul", args)
    order = comp.toposort_names()
    heads = {order[i] for i in range(0, len(order), 50)
             if any(comp.operations[n].kind == "Neg"
                    for n in order[i:i + 50])}
    assert len(heads) == 1
    forced.setenv("MOOSE_TPU_SELFCHECK_FAULT", "Neg")
    forced.setenv("MOOSE_TPU_PEROP_MAX", "10")
    runner = _runner(comp, args, 1)
    outs = _drive(runner, args)
    assert runner.mode == "per-op" and not runner.exhausted
    assert runner._per_op.seg_size == 50
    assert runner.pinned_ops == sorted(heads)
    assert not runner._per_op.all_pinned()
    mixed = _run(runner, args)
    for out in outs + [mixed]:
        assert np.array_equal(_decoded(out), jax_words["mul"])


# -- (b) the seven physical graphs through the plans ----------------------


@pytest.fixture(scope="module")
def seven():
    """Each graph of tests/test_torch_physical.py: the port's lowered
    graph, its arguments and storage, and the JAX package's eager
    physical outputs and storage under fixed keys."""
    out = {}
    with prf("threefry"), fixed_keys_env():
        for name in GRAPHS:
            jl, tl, args, storage = lowered_pair(name)
            jstore = copy.deepcopy(storage)
            want = jexecute(jl, jstore, args, use_jit=False)
            out[name] = (tl, args, storage, want, jstore)
    return out


@pytest.mark.parametrize("segment", ("2000", "5"))
@pytest.mark.parametrize("name", GRAPHS)
def test_plans_give_the_jax_package_s_eager_words(seven, forced, name,
                                                  segment):
    forced.setenv("MOOSE_TPU_JIT_SEGMENT", segment)
    tl, args, storage, want, jstore = seven[name]
    # a fresh copy of the graph: its plan registry entry is its own
    tl = copy.deepcopy(tl)
    executor = physical.PhysicalInterpreter("cpu")
    states = []
    for _ in range(3):
        tstore = copy.deepcopy(storage)
        got = executor.evaluate(tl, tstore, args, use_jit=True)
        states.append(executor.last_plan_info["plan_state"])
        assert_outputs_equal(got, want,
                             ("output_0",) if name == "host_math" else ())
        assert tstore.keys() == jstore.keys()
        for plc, store in jstore.items():
            for key, value in store.items():
                assert np.array_equal(tstore[plc][key], np.asarray(value))
    assert states == ["validating", "jit", "jit"]
    mode = executor.last_plan_info["plan_mode"]
    assert mode == ("segmented" if int(segment) < len(tl.operations)
                    else "whole-graph")


def test_execute_physical_keeps_one_interpreter_a_device(seven, forced):
    tl, args, _, want, _ = seven["rep_dot"]
    tl = copy.deepcopy(tl)
    assert physical.default_interpreter("cpu") is \
        physical.default_interpreter("cpu")
    states = []
    for _ in range(3):
        got = physical.execute_physical(tl, {}, args, device="cpu")
        assert_outputs_equal(got, want)
        states.append(
            physical.default_interpreter("cpu").last_plan_info["plan_state"])
    # one plan validated over the calls, not one a call
    assert states == ["validating", "jit", "jit"]


# -- (c) K7's plain version under a draw's own key -------------------------

KEY = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
NONCE = (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)


@pytest.mark.parametrize("layout", ("threefry", "threefry-pallas"))
@pytest.mark.parametrize("bits,untagged", ((False, False), (True, False),
                                           (True, True)))
@pytest.mark.parametrize("nonce", (NONCE, None))
def test_k7_plain_under_a_draw_s_own_key(layout, bits, untagged, nonce):
    n = 200
    key = torch.tensor(KEY, dtype=torch.int64)
    before = dict(rk.LAUNCHES)
    got = rk.threefry_seeded(key, nonce, n, layout, bits, untagged)
    assert rk.LAUNCHES == before  # the CPU launches nothing
    seed = ring.mix_seed(KEY, nonce) if nonce is not None else KEY
    if bits and not untagged:
        seed = ring._bit_domain_seed(seed)
    k0, k1 = ring.stream_key(seed, layout, bits=False)
    plain = rk.threefry_bits_plain if bits else rk.threefry_words_plain
    assert torch.equal(got, plain(k0, k1, n, layout, "cpu"))
    # a meta key gives the shape and computes nothing
    meta = rk.threefry_seeded(key.to("meta"), nonce, n, layout, bits,
                              untagged)
    assert meta.device.type == "meta" and tuple(meta.shape) == (n,)


def test_device_seeds_draw_the_host_seeds_words():
    """A DeriveSeed of a key tensor keeps the key and the nonce (no host
    arithmetic) and draws the words of the host-derived seed, under both
    threefry streams and for each kind of draw."""
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.values import DeviceSeed, HostPrfKey, HostShape

    sync = bytes(range(16))
    shp = HostShape((3, 5), "alice")
    for stream in ("threefry", "threefry-pallas"):
        with prf(stream):
            on_host = host.derive_seed(HostPrfKey(KEY, "alice"), sync,
                                       "alice")
            kept = host.derive_seed(HostPrfKey(
                torch.tensor(KEY, dtype=torch.int64), "alice"), sync,
                "alice")
            assert isinstance(kept.value, DeviceSeed)
            for width in (64, 128):
                a = host.sample_uniform_seeded(shp, on_host, width, "alice",
                                               "cpu")
                b = host.sample_uniform_seeded(shp, kept, width, "alice",
                                               "cpu")
                assert torch.equal(a.lo, b.lo)
                assert (a.hi is None) == (b.hi is None)
                assert a.hi is None or torch.equal(a.hi, b.hi)
                a = host.sample_bits_seeded(shp, on_host, width, "alice",
                                            "cpu")
                b = host.sample_bits_seeded(shp, kept, width, "alice", "cpu")
                assert torch.equal(a.lo, b.lo)
            a = host.sample_bit_tensor_seeded(shp, on_host, "alice", "cpu")
            b = host.sample_bit_tensor_seeded(shp, kept, "alice", "cpu")
            assert torch.equal(a.value, b.value)


# -- (d) last_plan of the lowered routes ------------------------------------


def test_last_plan_of_the_lowered_routes(monkeypatch):
    from moose_tpu_torch import serde
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments

    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FORCE", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    _, tt, args, _ = lowering_case("logreg")
    with prf("threefry"):
        runtime = PortRuntime(IDS, layout="per-host", use_jit=True,
                              device="cpu")
        # one validated evaluation promotes (MOOSE_TPU_JIT_SELFCHECK=1)
        runtime.evaluate_computation(tt, args)
        plans = [dict(runtime.last_plan)]
        lowered = compile_computation(tt, DEFAULT_PASSES,
                                      arg_specs_from_arguments(args))
        blob = serde.serialize_computation(lowered)
        compiled = PortRuntime(IDS, use_jit=True, device="cpu")
        out = compiled.evaluate_compiled(blob, args)
        plans.append(dict(compiled.last_plan))
    want = {"layout": "per-host", "lowered": True, "plan_mode": "segmented",
            "pinned_ops": [], "plan_state": "jit", "cuda_graphs": 0}
    assert plans == [want, want]
    assert out["output_0"].shape == (8, 2)
    # the walk at use_jit=False reports no plan state, as before
    eager = PortRuntime(IDS, use_jit=False, device="cpu")
    with prf("threefry"):
        eager.evaluate_compiled(blob, args)
    assert eager.last_plan == {"layout": "per-host", "lowered": True,
                               "plan_mode": "eager", "pinned_ops": []}


# -- (e) aes-ctr under use_jit, in both packages ---------------------------


def test_aes_ctr_under_use_jit_as_the_jax_package(monkeypatch):
    jl, tl, args, storage = lowered_pair("rep_mul")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    with prf("aes-ctr"):
        # without the self-check the jitted plan refuses, every time
        monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FORCE", "0")
        refused = []
        for executor, comp, error in (
                (jphysical.PhysicalInterpreter(), jl, Exception),
                (physical.PhysicalInterpreter("cpu"), tl,
                 ConfigurationError)):
            for _ in range(2):
                with pytest.raises(error) as info:
                    executor.evaluate(comp, copy.deepcopy(storage), args,
                                      use_jit=True)
                refused.append((type(info.value).__name__,
                                str(info.value)))
        assert set(refused) == {("ConfigurationError",
                                 ring.AES_CTR_UNDER_JIT)}
        # with it, the candidates fail to run and the ladder descends to
        # the per-op rung, pinning the same ops in both packages
        monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FORCE", "1")
        settled, errors = [], []
        for executor, comp in ((jphysical.PhysicalInterpreter(), jl),
                               (physical.PhysicalInterpreter("cpu"), tl)):
            comp = copy.deepcopy(comp)
            states, errs = [], []
            for _ in range(12):
                out = executor.evaluate(comp, copy.deepcopy(storage), args,
                                        use_jit=True)
                info = executor.last_plan_info
                states.append(info["plan_mode"])
                errs.append(np.abs(out["output_0"]
                                   - args["x"] * args["y"]).max())
                if info["plan_state"] != "validating":
                    break
            settled.append((states, info["plan_state"],
                            sorted(info["pinned_ops"])))
            errors.append(errs)
    assert settled[0] == settled[1]
    assert settled[1][1] == "per-op" and settled[1][2]
    kinds = {tl.operations[n].kind for n in settled[1][2]}
    assert kinds <= {"DeriveSeed", "SampleSeeded", "Sample"}
    # every evaluation of the port's is right: one session id an
    # evaluation, shared by its per-op sessions (the JAX package's per-op
    # sessions each hash their own, and its per-op words are not: ROADMAP
    # queue 3)
    assert max(errors[1]) < 1e-3
