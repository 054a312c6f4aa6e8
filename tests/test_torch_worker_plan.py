"""The distributed workers' compiled fast path (``moose_tpu_torch/
distributed/worker_plan.py``) held against the JAX package's on the CPU.

The JAX package's four fast-path tests (``tests/test_distributed.py``:
validate, promote and cache; pin only the Dot segments under
``MOOSE_TPU_SELFCHECK_FAULT=Dot``; an unseeded Sample grafted onto a
role; ``MOOSE_TPU_WORKER_JIT=0`` keeps the legacy scheduler) run in both
packages on the same lowered 4x3 @ 3x2 secure dot: each
``plan_stats()`` delta, each role's ``plan_mode`` and
``pinned_segments`` equal the JAX package's own run.  Under
``MOOSE_TPU_FIXED_KEYS`` the port's outputs and every payload it puts
on the wire equal the JAX workers' legacy scheduler's, word for word,
in a validating session, and in a settled one under both threefry
streams.
``use_fast_path()`` gives the JAX package's verdict for every knob and
PRF stream.  On the CPU a segment's jitted form runs uncaptured through
the same code as on the card; the JAX package jits only this dot's
segments here (a few seconds), never config 3's (its lowered graph on
the fast path is ``tests/test_torch_distributed_logreg.py``'s).
"""

import copy
import itertools

import numpy as np
import pytest

from moose_tpu.computation import Operation as JOperation
from moose_tpu.computation import Signature as JSignature
from moose_tpu.computation import Ty as JTy
from moose_tpu.distributed import worker_plan as jworker_plan
from moose_tpu.distributed.networking import LocalNetworking as JaxLocal
from moose_tpu.distributed.networking import ProgressClock as JaxProgressClock
from moose_tpu.distributed.worker import execute_role as jexecute_role
from moose_tpu_torch.computation import Operation, Signature, Ty
from moose_tpu_torch.distributed import worker_plan
from moose_tpu_torch.distributed.networking import LocalNetworking
from moose_tpu_torch.distributed.worker import execute_role

from test_torch_distributed import _capture, _env, _run, lowered_case
from torch_parity import fixed_keys_env, prf

STREAMS = ("threefry", "threefry-pallas")
SESSION = "s-secure_dot"  # the session of lowered_case's JAX words


@pytest.fixture(scope="module")
def case():
    """The secure dot lowered by both packages, and the JAX workers'
    legacy words (outputs and wire payloads) under each stream."""
    return lowered_case("secure_dot", STREAMS)


def _session(pkg, comp, args):
    """One session of ``comp`` on three workers of ``pkg`` ("jax" or
    "port") under fixed keys: the plan statistics' delta, each role's
    (plan_mode, pinned_segments), the outputs and the wire payloads."""
    stats = jworker_plan if pkg == "jax" else worker_plan
    net = JaxLocal() if pkg == "jax" else LocalNetworking(device="cpu")
    wire = _capture(net)
    before = stats.plan_stats()
    with fixed_keys_env():
        if pkg == "jax":
            results, outputs = _run(jexecute_role, comp, args, net, SESSION,
                                    clock_cls=JaxProgressClock)
        else:
            results, outputs = _run(execute_role, comp, args, net, SESSION)
    after = stats.plan_stats()
    delta = {k: after[k] - before[k] for k in after}
    modes = {i: (r["plan_mode"], list(r["pinned_segments"]))
             for i, r in results.items()}
    return delta, modes, outputs, wire


def _assert_words(want, outputs, wire):
    want_out, want_wire = want
    assert set(outputs) == set(want_out)
    for key, value in want_out.items():
        assert np.array_equal(outputs[key], value), key
    assert set(wire) == set(want_wire)
    for key, payload in want_wire.items():
        assert wire[key] == payload, key


def _fast_path():
    return _env(MOOSE_TPU_WORKER_JIT="1", MOOSE_TPU_JIT_SELFCHECK="1")


def _both(case, args=None):
    """Fresh graph objects of both lowerings: each package builds its
    plans anew (plans are cached weak-keyed on the graph)."""
    return copy.deepcopy(case.jl), copy.deepcopy(case.tl), \
        args if args is not None else case.args


# -- (a) the JAX package's four fast-path tests, mirrored ----------------------


def test_fast_path_validates_promotes_and_caches(case, monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    jl, tl, args = _both(case)
    with prf("threefry"):
        for k in range(2):
            jdelta, jmodes, _, _ = _session("jax", jl, args)
            delta, modes, outputs, wire = _session("port", tl, args)
            assert delta == jdelta, k
            assert modes == jmodes, k
            _assert_words(case.want["threefry"], outputs, wire)
    # the first session validated every role, the second ran warm
    assert jdelta["plans_built"] == 0 and jdelta["cache_hits"] == 3
    assert jdelta["validating_evaluations"] == 0
    assert {m for m, _ in modes.values()} <= {"segmented", "full-jit"}


def test_fast_path_pins_only_divergent_segments(case, monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    monkeypatch.setenv("MOOSE_TPU_SELFCHECK_FAULT", "Dot")
    jl, tl, args = _both(case)
    deltas = {"jax": [], "port": []}
    with prf("threefry"):
        for _ in range(2):
            for pkg, comp in (("jax", jl), ("port", tl)):
                delta, modes, outputs, wire = _session(pkg, comp, args)
                deltas[pkg].append((delta, modes))
            # every session goes on from the eager result
            _assert_words(case.want["threefry"], outputs, wire)
    assert deltas["port"] == deltas["jax"]
    pins = {i: p for i, (_, p) in modes.items()}
    assert any(p for _, p in modes.values()), pins
    assert sum(d["segments_pinned"] for d, _ in deltas["port"]) > 0
    # only the segments that hold a Dot are pinned
    for identity, (mode, pinned) in modes.items():
        assert mode in ("segmented", "full-jit")
        plan = worker_plan.get_plan(tl, identity, device="cpu")
        for seg in plan.segments:
            has_dot = any(tl.operations[n].kind == "Dot" for n in seg.names)
            assert (seg.index in pinned) is (has_dot and seg.validatable)


def _graft_sample(comp, pkg):
    """An unseeded draw on alice's role (Constant HostShape -> Sample),
    as the JAX package's test grafts it."""
    op, sig, ty = ((JOperation, JSignature, JTy) if pkg == "jax"
                   else (Operation, Signature, Ty))
    comp.add_operation(op(
        "smp_shape", "Constant", [], "alice", sig((), ty("HostShape")),
        attributes={"value": np.asarray([2, 3])},
    ))
    comp.add_operation(op(
        "smp_draw", "Sample", ["smp_shape"], "alice",
        sig((ty("HostShape"),), ty("HostRing64Tensor")),
    ))
    return comp


def test_fast_path_handles_an_unseeded_sample(case, monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    jl, tl, args = _both(case)
    _graft_sample(jl, "jax")
    _graft_sample(tl, "port")
    with prf("threefry"):
        jdelta, jmodes, _, _ = _session("jax", jl, args)
        delta, modes, outputs, wire = _session("port", tl, args)
    assert (delta, modes) == (jdelta, jmodes)
    _assert_words(case.want["threefry"], outputs, wire)
    plan = worker_plan.get_plan(tl, "alice", device="cpu")
    assert ("op", "smp_draw") in plan.steps


def test_fast_path_off_keeps_the_legacy_scheduler(case, monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "0")
    jl, tl, args = _both(case)
    with prf("threefry"):
        jdelta, jmodes, _, _ = _session("jax", jl, args)
        delta, modes, outputs, wire = _session("port", tl, args)
    assert (delta, modes) == (jdelta, jmodes)
    assert delta == dict.fromkeys(delta, 0)
    assert {m for m, _ in modes.values()} == {"eager"}
    _assert_words(case.want["threefry"], outputs, wire)


@pytest.fixture(scope="module")
def settled(case):
    """One copy of the port's lowered dot whose role plans have
    validated in a session of their own (the validating session's words
    are held by ``test_fast_path_validates_promotes_and_caches``)."""
    tl = copy.deepcopy(case.tl)
    with prf("threefry"), _fast_path():
        delta, modes, _, _ = _session("port", tl, case.args)
    assert delta["validating_evaluations"] == 3, delta
    return tl


@pytest.mark.parametrize("stream", STREAMS)
def test_fast_path_words_are_the_jax_workers(case, settled, stream):
    """A settled session (the jitted segments' words, key rows on the
    device) equals the JAX workers' legacy scheduler under fixed keys."""
    with prf(stream), _fast_path():
        delta, modes, outputs, wire = _session("port", settled, case.args)
    assert delta["validating_evaluations"] == 0, delta
    _assert_words(case.want[stream], outputs, wire)
    assert all(m in ("segmented", "full-jit") and not p
               for m, p in modes.values())


# -- (b) the scheduler's knobs ---------------------------------------------------

KNOBS = {
    "MOOSE_TPU_WORKER_JIT": (None, "", "0", "1"),
    "MOOSE_TPU_JIT": (None, "0", "1"),
    "MOOSE_TPU_JIT_SELFCHECK": (None, "0", "2"),
}


@pytest.mark.parametrize("stream", STREAMS + ("aes-ctr",))
def test_use_fast_path_is_the_jax_package_s(stream, monkeypatch):
    with prf(stream):
        for values in itertools.product(*KNOBS.values()):
            for name, value in zip(KNOBS, values):
                if value is None:
                    monkeypatch.delenv(name, raising=False)
                else:
                    monkeypatch.setenv(name, value)
            assert worker_plan.worker_jit_enabled() is \
                jworker_plan.worker_jit_enabled(), values
            assert worker_plan.use_fast_path() is \
                jworker_plan.use_fast_path(), values
            # dasher's default: the JAX dasher's setdefault of "0"
            assert worker_plan.worker_jit_enabled(default=False) is (
                values[0] not in (None, "0", "")), values
