"""The port's distributed execution (``moose_tpu_torch/distributed/``,
``runtime.GrpcMooseRuntime`` and the comet, cometctl and dasher bins)
held against the JAX package's workers on the CPU.

Three workers run the secure dot (4x3 @ 3x2) over ``LocalNetworking``
and over in-process gRPC (one module cluster); under
``MOOSE_TPU_FIXED_KEYS`` and each threefry stream their outputs, and
every payload a party puts on the wire (the shares it sends, word for
word), equal the JAX package's workers' on the same lowered graph, with
both of the port's schedulers (``execute_role``, which runs a role
through its plan when the fast path is on, and ``execute_role_legacy``).  Config 3's logistic regression (6 x 4)
is ``tests/test_torch_distributed_logreg.py``'s, on this file's helpers:
its eager JAX run (7,335 host ops) costs 15-30 s, which would take this
file past its time budget.  The JAX
side runs its legacy eager scheduler (``MOOSE_TPU_WORKER_JIT=0``): its
planned one jit-compiles segments, and under fixed keys the words do
not depend on the scheduler.  Then the worker's failure discipline
(duplicate session, abort fan-out, a dead peer tripping the failure
detector with short deadlines), the cost model's counters, the plan
statistics, the bins' command lines and mTLS.  Every wait has its own
deadline of at most 30 s (the workers' and their join's: 30 s without
progress on any role)."""

import contextlib
import io
import json
import os
import threading
import time
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest

import moose_tpu as jm
import moose_tpu_torch as tm
from moose_tpu.compilation import DEFAULT_PASSES as JPASSES
from moose_tpu.compilation import compile_computation as jcompile
from moose_tpu.compilation.lowering import arg_specs_from_arguments as jspecs
from moose_tpu.dialects import host as jhost
from moose_tpu.distributed.networking import LocalNetworking as JaxLocal
from moose_tpu.distributed.networking import ProgressClock as JaxProgressClock
from moose_tpu.distributed.worker import execute_role as jexecute_role
from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu_torch import metrics
from moose_tpu_torch.compilation import DEFAULT_PASSES as TPASSES
from moose_tpu_torch.compilation import compile_computation as tcompile
from moose_tpu_torch.compilation.lowering import (
    arg_specs_from_arguments as tspecs,
)
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.distributed import worker_plan
from moose_tpu_torch.distributed.choreography import (
    ChoreographyClient,
    WorkerServer,
    start_local_cluster,
)
from moose_tpu_torch.distributed.networking import (
    LocalNetworking,
    ProgressClock,
)
from moose_tpu_torch.distributed.worker import (
    execute_role,
    execute_role_legacy,
)
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.errors import (
    ConfigurationError,
    SessionAbortedError,
    SessionAlreadyExistsError,
)
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.serde import serialize_computation, serialize_value

from torch_parity import fixed_keys_env, load_chip_smoke, prf

IDS = ("alice", "bob", "carole")
WAIT_S = 30.0
# a retrieve's own deadline: the client adds 10-15 s of slack to it
RETRIEVE_S = 15.0
SEED = 20261018
# (graph, stream) pairs held against the JAX workers here; config 3's
# logistic regression is tests/test_torch_distributed_logreg.py's
PAIRS = (("secure_dot", "threefry"), ("secure_dot", "threefry-pallas"))


def _graphs():
    """(JAX computation, port computation, arguments) of each graph."""
    cs = load_chip_smoke()
    rng = np.random.default_rng(18)
    proto = tsk.logistic_regression_onnx(SimpleNamespace(
        coef_=rng.normal(size=(1, 4)), intercept_=rng.normal(size=(1,)),
        classes_=np.arange(2)), 4).encode()
    return {
        "secure_dot": (
            cs.secure_dot_computation(jm), cs.secure_dot_computation(tm),
            {"x": rng.normal(size=(4, 3)), "y": rng.normal(size=(3, 2))}),
        "logreg": (
            jfrom_onnx(proto).predictor_factory(),
            tfrom_onnx(proto).predictor_factory(),
            {"x": rng.normal(size=(6, 4))}),
    }


def _capture(net):
    """Every payload ``net`` stores, by transfer key (the bytes a party
    sent: its shares, seeds and values in the JAX package's codec)."""
    seen = {}
    put = net._store.put

    def record(key, value):
        seen[key] = value
        put(key, value)

    net._store.put = record
    return seen


def _run(run_role, comp, args, net, session, clock_cls=ProgressClock):
    """Each identity's role on a thread, all three on one progress clock
    (``clock_cls``: the package's ``ProgressClock``, bumped by every op
    any role completes); the outputs of all roles.  A role's receive, and
    the wait here, fail after WAIT_S seconds without progress anywhere:
    the JAX package's first eager run compiles its kernels as it goes,
    for longer than that in all on a loaded CPU."""
    results, errors = {}, {}
    clock = clock_cls()

    def work(identity):
        try:
            results[identity] = run_role(comp, identity, {}, args, net,
                                         session, timeout=WAIT_S,
                                         progress=clock)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors[identity] = e

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in IDS]
    for t in threads:
        t.start()
    while True:
        alive = [t for t in threads if t.is_alive()]
        if not alive or time.monotonic() - clock.last > WAIT_S:
            break
        alive[0].join(0.2)
    assert not any(t.is_alive() for t in threads), "a role hung"
    assert not errors, errors
    return results, {k: v for r in results.values()
                     for k, v in r["outputs"].items()}


@contextlib.contextmanager
def _env(**values):
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lowered_case(name, streams):
    """Both packages' lowered graphs of ``name`` (each lowering inside
    its package's ``deterministic_sync_keys``), and the JAX workers'
    outputs and wire payloads under fixed keys for each of ``streams``."""
    jc, tc, args = _graphs()[name]
    with jhost.deterministic_sync_keys(SEED):
        jl = jcompile(jtracer.trace(jc), JPASSES, jspecs(args))
    with thost.deterministic_sync_keys(SEED):
        tl = tcompile(ttracer.trace(tc), TPASSES, tspecs(args))
    want = {}
    for stream in streams:
        net = JaxLocal()
        wire = _capture(net)
        with prf(stream), fixed_keys_env(), _env(MOOSE_TPU_WORKER_JIT="0"):
            _, outputs = _run(jexecute_role, jl, args, net, "s-" + name,
                              clock_cls=JaxProgressClock)
        want[stream] = (outputs, wire)
    return SimpleNamespace(jl=jl, tl=tl, args=args, want=want)


@pytest.fixture(scope="module")
def cases():
    return {"secure_dot": lowered_case(
        "secure_dot", [s for _, s in PAIRS])}


@pytest.fixture(scope="module")
def cluster():
    """One in-process gRPC cluster of port workers on the CPU."""
    servers, endpoints = start_local_cluster(IDS, device="cpu")
    try:
        yield servers, endpoints
    finally:
        for srv in servers.values():
            srv.stop()


# -- the JAX package's words ---------------------------------------------------


@pytest.mark.parametrize("scheduler", ("legacy", "planned"))
@pytest.mark.parametrize("graph,stream", PAIRS)
def test_local_workers_equal_the_jax_workers_word_for_word(
        cases, graph, stream, scheduler):
    check_local(cases[graph], graph, stream, scheduler)


def check_local(case, graph, stream, scheduler):
    """The port's workers over LocalNetworking under ``scheduler``
    (``execute_role``'s plan, or ``execute_role_legacy``): the JAX
    workers' outputs and wire payloads, word for word.  The plan is the
    compiled fast path with one validating session a plan (a later
    session of ``case.tl`` replays its settled segments)."""
    want_out, want_wire = case.want[stream]
    net = LocalNetworking(device="cpu")
    wire = _capture(net)
    run_role = execute_role if scheduler == "planned" else \
        execute_role_legacy
    before = worker_plan.plan_stats()
    # the planned scheduler is the compiled fast path, which the tests'
    # MOOSE_TPU_JIT=0 turns off unless asked for, as the JAX tests ask
    with prf(stream), fixed_keys_env(), _env(MOOSE_TPU_WORKER_JIT="1",
                                             MOOSE_TPU_JIT_SELFCHECK="1"):
        results, got = _run(run_role, case.tl, case.args, net,
                            "s-" + graph)
    after = worker_plan.plan_stats()
    planned = sum(after[k] - before[k] for k in ("plans_built",
                                                 "cache_hits"))
    assert planned == (len(IDS) if scheduler == "planned" else 0)
    assert set(got) == set(want_out)
    for key, value in want_out.items():
        assert np.array_equal(got[key], value), key
    assert set(wire) == set(want_wire)
    for key, payload in want_wire.items():
        assert wire[key] == payload, key
    modes = {r["plan_mode"] for r in results.values()}
    if scheduler == "planned":
        assert modes <= {"segmented", "full-jit"}, modes
        assert all(r["pinned_segments"] == [] for r in results.values())
    else:
        assert modes == {"eager"}
    x = case.args["x"]
    if graph == "secure_dot":
        np.testing.assert_allclose(got["output_0"], x @ case.args["y"],
                                   atol=1e-4)


@pytest.mark.parametrize("graph,stream", PAIRS)
def test_grpc_workers_equal_the_jax_workers(cases, cluster, graph, stream):
    check_grpc(cases[graph], cluster[1], graph, stream)


def check_grpc(case, endpoints, graph, stream, retrieve_s=RETRIEVE_S):
    """The same lowered bytes launched on the port's gRPC workers (each
    role through its plan: the fast path on, with one validating session
    a plan, as the JAX package's fast-path tests set it): the outputs
    equal the JAX workers' exactly, and every role has settled with no
    segment pinned.  Each retrieve waits at most ``retrieve_s`` seconds
    for its role's outputs."""
    client = {i: ChoreographyClient(endpoints[i]) for i in IDS}
    blob = serialize_computation(case.tl)
    owner = {op.name: case.tl.placement_of(op).name
             for op in case.tl.operations.values() if op.kind == "Input"}
    session = f"grpc-{graph}-{stream}"
    with prf(stream), fixed_keys_env(), _env(MOOSE_TPU_WORKER_JIT="1",
                                             MOOSE_TPU_JIT_SELFCHECK="1"):
        for i in IDS:
            own = {k: v for k, v in case.args.items() if owner.get(k) == i}
            assert client[i].launch(session, blob, own)["ok"]
        results = {i: client[i].retrieve(session, timeout=retrieve_s)
                   for i in IDS}
    from moose_tpu_torch.serde import deserialize_value

    outputs = {}
    for result in results.values():
        assert "error" not in result, result
        assert result["plan_mode"] in ("segmented", "full-jit"), result
        assert result["pinned_segments"] == []
        for name, blob in (result.get("outputs") or {}).items():
            outputs[name] = deserialize_value(blob)
    want_out, _ = case.want[stream]
    assert set(outputs) == set(want_out)
    for name, value in want_out.items():
        assert np.array_equal(outputs[name], value), name


def test_grpc_runtime_runs_the_secure_dot_and_reports(cluster, monkeypatch):
    """``GrpcMooseRuntime`` on the cluster, the workers' fast path on:
    the client compiles and supervises; timings, the settled plan modes
    and the session report come back."""
    from moose_tpu_torch.dialects import ring

    _, endpoints = cluster
    cs = load_chip_smoke()
    rng = np.random.default_rng(4)
    args = {"x": rng.normal(size=(4, 3)), "y": rng.normal(size=(3, 2))}
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    prev = ring.get_prf_impl()
    ring.set_prf_impl("threefry")
    try:
        runtime = tm.GrpcMooseRuntime(endpoints, device="cpu")
        outputs, timings = runtime.evaluate_computation(
            cs.secure_dot_computation(tm), args, timeout=RETRIEVE_S)
    finally:
        ring.set_prf_impl(prev)
    np.testing.assert_allclose(outputs["output_0"], args["x"] @ args["y"],
                               atol=1e-4)
    assert set(timings) == set(IDS) and all(t > 0 for t in timings.values())
    report = runtime.last_session_report
    assert report["ok"] and report["n_attempts"] == 1
    assert report["transport"] == "grpc"
    assert set(runtime.last_plan_modes) == set(IDS)
    for mode in runtime.last_plan_modes.values():
        assert mode["plan_mode"] in ("segmented", "full-jit"), mode
        assert mode["pinned_segments"] == []


# -- the failure discipline ----------------------------------------------------


def _launch_msg(session, blob, args):
    return msgpack.packb({
        "session_id": session, "computation": blob,
        "arguments": {k: serialize_value(v) for k, v in args.items()},
    }, use_bin_type=True)


def _result(srv, session):
    return msgpack.unpackb(srv._results.get(session, timeout=WAIT_S),
                           raw=False)


def test_stop_returns_once_the_server_is_down():
    """``WorkerServer.stop`` waits for the gRPC shutdown: the server has
    terminated when it returns, and a second stop does nothing."""
    srv = WorkerServer("alice", 0, {}, device="cpu").start()
    server = srv._server
    srv.stop()
    assert server.wait_for_termination(timeout=0) is False  # not timed out
    srv.stop()


def test_no_session_thread_outlives_stop(cases, monkeypatch):
    """Every thread a session starts on a worker (its run, receive
    prefetch, failure detector and sender) has ended when
    ``WorkerServer.stop`` returns, for a finished session and for one
    still waiting on a peer that never launched (both on the fast path,
    whose threads these are)."""
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    before = set(threading.enumerate())
    case = cases["secure_dot"]
    blob = serialize_computation(case.tl)
    servers, endpoints = start_local_cluster(IDS, device="cpu")
    try:
        check_grpc(case, endpoints, "secure_dot", "threefry")
        # alice waits on bob's shares of a session bob never launches
        with prf("threefry"):
            servers["alice"]._launch(_launch_msg("hung", blob, case.args))
        assert servers["alice"]._sessions
    finally:
        for srv in servers.values():
            srv.stop()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith("moose-")]
    assert left == []
    assert "worker stopped" in _result(servers["alice"], "hung")["error"]


def test_duplicate_session_is_refused(cases, cluster):
    servers, _ = cluster
    case = cases["secure_dot"]
    blob = serialize_computation(case.tl)
    srv = servers["alice"]
    # with its arguments alice's role waits on bob's shares (bob never
    # launches "dup") until the abort; without them it could fail on its
    # missing argument before the abort arrives
    with prf("threefry"):
        srv._launch(_launch_msg("dup", blob, case.args))
        with pytest.raises(SessionAlreadyExistsError):
            srv._launch(_launch_msg("dup", blob, case.args))
        srv._abort(msgpack.packb({"session_id": "dup"}, use_bin_type=True))
    assert "abort" in _result(srv, "dup")["error"]


def test_abort_fans_out_to_peers(cases, cluster):
    """A launch without bob's argument fails on bob at once; that root
    cause aborts the session on alice and carole well inside the receive
    timeout."""
    servers, _ = cluster
    case = cases["secure_dot"]
    blob = serialize_computation(case.tl)
    with prf("threefry"):
        for srv in servers.values():
            srv._launch_inner(_launch_msg("fo-1", blob,
                                          {"x": case.args["x"]}))
        t0 = time.monotonic()
        results = {i: _result(srv, "fo-1") for i, srv in servers.items()}
    assert time.monotonic() - t0 < 10.0
    assert "missing argument" in results["bob"]["error"]
    for peer in ("alice", "carole"):
        assert "aborted by bob" in results[peer]["error"], results


def test_cancelled_worker_raises_session_aborted(cases):
    case = cases["secure_dot"]
    cancel = threading.Event()
    cancel.set()
    with prf("threefry"), pytest.raises(SessionAbortedError):
        execute_role(case.tl, "alice", {}, case.args,
                     LocalNetworking(device="cpu"), "s-cancel",
                     cancel=cancel)


def test_dead_peer_trips_the_failure_detector(cases, cluster):
    """carole unreachable (a port nothing listens on) while alice and bob
    run: their detectors (0.25 s pings, 3 misses, 1.5 s startup grace)
    fail the session everywhere within seconds."""
    servers, endpoints = cluster
    case = cases["secure_dot"]
    blob = serialize_computation(case.tl)
    live = {i: servers[i] for i in ("alice", "bob")}
    saved = {i: (srv.ping_interval, srv.ping_misses, srv.startup_grace)
             for i, srv in live.items()}
    try:
        for srv in live.values():
            srv.ping_interval, srv.ping_misses, srv.startup_grace = \
                0.25, 3, 1.5
            srv.endpoints["carole"] = "127.0.0.1:9"
            srv.networking._endpoints["carole"] = "127.0.0.1:9"
            srv.networking._channels.pop("carole", None)
        t0 = time.monotonic()
        with prf("threefry"):
            for srv in live.values():
                srv._launch_inner(_launch_msg("fd-1", blob, case.args))
            results = {i: _result(srv, "fd-1") for i, srv in live.items()}
        assert time.monotonic() - t0 < 15.0
        for name, result in results.items():
            assert "error" in result, (name, result)
            assert ("unreachable" in result["error"]
                    or "aborted by" in result["error"]
                    or "aborted on peer" in result["error"]), result
    finally:
        for i, srv in live.items():
            srv.ping_interval, srv.ping_misses, srv.startup_grace = saved[i]
            srv.endpoints["carole"] = endpoints["carole"]
            srv.networking._endpoints["carole"] = endpoints["carole"]
            srv.networking._channels.pop("carole", None)


# -- the cost model and the plan statistics ------------------------------------


def test_cost_model_matches_measured_counters_exactly(cases, monkeypatch):
    """The planned scheduler's wire counters on the local transport equal
    the static cost model's prediction: bytes, singles, coalesced
    envelopes and payloads, receives (the fast path on, as the JAX
    test sets it)."""
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    from moose_tpu_torch.compilation.analysis import cost_report

    case = cases["secure_dot"]
    names = {
        "tx_bytes": "moose_tpu_net_tx_bytes_total",
        "rx_bytes": "moose_tpu_net_rx_bytes_total",
        "sends": "moose_tpu_net_sends_total",
        "send_many_envelopes": "moose_tpu_net_send_many_total",
        "send_many_payloads": "moose_tpu_net_send_many_payloads_total",
        "receives": "moose_tpu_net_receives_total",
    }

    def snap():
        return {k: metrics.REGISTRY.value(v, transport="local")
                for k, v in names.items()}

    before = snap()
    with prf("threefry"):
        _run(execute_role, case.tl, case.args,
             LocalNetworking(device="cpu"), "sess-1")
    measured = {k: int(v - before[k]) for k, v in snap().items()}
    report = cost_report(case.tl, session_id="sess-1", transport="local")
    assert report["resolved"], report
    assert {k: int(report["totals"][k]) for k in names} == measured
    assert measured["send_many_envelopes"] > 0


def test_plan_stats_build_once_and_hit_warm(cases, monkeypatch):
    """Two sessions of one graph on the fast path: each role's plan is
    built at most once and served warm after; a plan validates on at
    most its first MOOSE_TPU_JIT_SELFCHECK (here 1) sessions, so the
    second settles."""
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    monkeypatch.setenv("MOOSE_TPU_JIT_SELFCHECK", "1")
    case = cases["secure_dot"]
    before = worker_plan.plan_stats()
    with prf("threefry"):
        for session in ("warm-1", "warm-2"):
            results, _ = _run(execute_role, case.tl, case.args,
                              LocalNetworking(device="cpu"), session)
    after = worker_plan.plan_stats()
    built = after["plans_built"] - before["plans_built"]
    hits = after["cache_hits"] - before["cache_hits"]
    assert built <= len(IDS) and built + hits == 2 * len(IDS)
    assert hits >= len(IDS)
    assert set(after) == {"plans_built", "cache_hits",
                          "validating_evaluations", "segments_pinned",
                          "plans_rejected"}
    assert after["validating_evaluations"] - before[
        "validating_evaluations"] <= len(IDS)
    assert all(r["plan_mode"] in ("segmented", "full-jit")
               and r["pinned_segments"] == [] for r in results.values())
    plan = worker_plan.get_plan(case.tl, "alice", device="cpu")
    assert plan.autotune_min_seg.knob == "worker_min_seg"


@pytest.mark.parametrize("env,want", (
    ({"MOOSE_TPU_WORKER_JIT": "1"}, True),
    ({"MOOSE_TPU_WORKER_JIT": "0"}, False),
    ({"MOOSE_TPU_WORKER_JIT": "1", "MOOSE_TPU_JIT_SELFCHECK": "0"}, False),
))
def test_scheduler_choice_is_the_reference_s(cases, env, want,
                                             monkeypatch):
    """The knobs that choose the JAX worker's scheduler (its jit, its
    self-check, and aes-ctr, which its jit cannot trace) choose the
    port's the same way (``want``): with the fast path a role runs
    through its plan, without it on the legacy scheduler, and the words
    are the legacy scheduler's either way."""
    from moose_tpu.distributed import worker_plan as jworker_plan

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    case = cases["secure_dot"]
    for stream in ("threefry", "aes-ctr"):
        with prf(stream), fixed_keys_env():
            fast = want and stream != "aes-ctr"
            assert jworker_plan.use_fast_path() is fast
            assert worker_plan.use_fast_path() is fast
            before = worker_plan.plan_stats()
            results, planned = _run(execute_role, case.tl, case.args,
                                    LocalNetworking(device="cpu"), "choice")
            after = worker_plan.plan_stats()
            _, legacy = _run(execute_role_legacy, case.tl, case.args,
                             LocalNetworking(device="cpu"), "choice")
        assert sum(after[k] - before[k] for k in (
            "plans_built", "cache_hits")) == (len(IDS) if fast else 0)
        if not fast:
            assert {r["plan_mode"] for r in results.values()} == {"eager"}
        assert set(planned) == set(legacy)
        for key, value in legacy.items():
            assert np.array_equal(planned[key], value), (stream, key)


# -- the bins ------------------------------------------------------------------


def test_dasher_cli(tmp_path, monkeypatch):
    from moose_tpu_torch.bin import dasher
    from moose_tpu_torch.textual import to_textual

    monkeypatch.delenv("MOOSE_TPU_WORKER_JIT", raising=False)
    cs = load_chip_smoke()
    src = tmp_path / "comp.moose"
    src.write_text(to_textual(ttracer.trace(cs.secure_dot_computation(tm))))
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(2, 3)), rng.normal(size=(3, 1))
    args = tmp_path / "args.json"
    args.write_text(json.dumps({"x": x.tolist(), "y": y.tolist()}))
    out = io.StringIO()
    with prf("threefry"), contextlib.redirect_stdout(out):
        dasher.main([str(src), "--args", str(args), "--device", "cpu",
                     "--timeout", str(WAIT_S)])
    # dasher leaves the process's environment as it found it
    assert "MOOSE_TPU_WORKER_JIT" not in os.environ
    text = out.getvalue()
    assert text.count(" us") == 3 and "output_0 =" in text
    with pytest.raises(ConfigurationError):
        dasher.main([str(src), "--args", str(args)])


def test_cometctl_toml_session_runs_on_the_cluster(tmp_path, cluster):
    from moose_tpu_torch.bin import cometctl

    _, endpoints = cluster
    cs = load_chip_smoke()
    comp = tmp_path / "comp.bin"
    comp.write_bytes(serialize_computation(
        ttracer.trace(cs.secure_dot_computation(tm))))
    session = tmp_path / "s.toml"
    session.write_text(
        'session_id = "toml-1"\n[computation]\n'
        f'path = "{comp}"\n[roles]\n'
        + "".join(f'{i} = "{endpoints[i]}"\n' for i in IDS))
    sid, parsed, roles = cometctl._load_session(str(session))
    assert sid == "toml-1" and roles == {i: endpoints[i] for i in IDS}
    assert set(parsed.operations) == set(
        ttracer.trace(cs.secure_dot_computation(tm)).operations)
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(2, 3)), rng.normal(size=(3, 2))
    args = tmp_path / "args.json"
    args.write_text(json.dumps({"x": x.tolist(), "y": y.tolist()}))
    for argv in (["run", str(session)],
                 ["launch", str(session)],
                 ["retrieve", str(session), "--timeout", str(RETRIEVE_S)]):
        out = io.StringIO()
        with prf("threefry"), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            cometctl.main(argv + (["--args", str(args)]
                                  if argv[0] != "retrieve" else [])
                          + (["--json"] if argv[0] != "launch" else [])
                          + (["--timeout", str(RETRIEVE_S)]
                             if argv[0] == "run" else []))
        if argv[0] != "launch":
            got = np.asarray(json.loads(out.getvalue())["output_0"])
            np.testing.assert_allclose(got, x @ y, atol=1e-4)


def test_comet_main_serves_on_a_thread(cases):
    """comet's ``main`` with port 0 on a thread: it starts a worker on
    the CPU, answers a ping, and returns once its server stops."""
    from moose_tpu_torch.bin import comet

    started = []
    ready = threading.Event()

    def on_start(server):
        started.append(server)
        ready.set()

    thread = threading.Thread(target=comet.main, kwargs={
        "argv": ["--identity", "alice", "--port", "0", "--endpoints",
                 "alice=127.0.0.1:1", "--device", "cpu"],
        "on_start": on_start}, daemon=True)
    thread.start()
    assert ready.wait(WAIT_S)
    (server,) = started
    assert server.device.type == "cpu" and server.port > 0
    server.endpoints["alice"] = f"127.0.0.1:{server.port}"
    server.networking._endpoints["alice"] = server.endpoints["alice"]
    assert server.networking.ping("alice", timeout=5.0)["identity"] == \
        "alice"
    server.stop()
    thread.join(WAIT_S)
    assert not thread.is_alive()


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from moose_tpu_torch.bin import comet

    for build in (
        lambda: WorkerServer("alice", 0, {}),
        lambda: start_local_cluster(["alice"]),
        lambda: LocalNetworking(),
        lambda: tm.GrpcMooseRuntime({"alice": "127.0.0.1:1"}),
        lambda: comet.main(["--identity", "a", "--port", "0",
                            "--endpoints", "a=127.0.0.1:1"]),
    ):
        with pytest.raises(ConfigurationError, match="device='cpu'"):
            build()


def test_not_ported_transports_name_item_12():
    # every transport of item 12 is ported: the TCP transport, the chaos
    # restarter, chaos-armed workers and the fabric (their parity:
    # tests/test_torch_tcp.py, tests/test_torch_chaos.py,
    # tests/test_torch_fabric.py); the package exports what the JAX
    # package's does, and nothing names the item any more
    import moose_tpu.distributed as jdistributed

    from moose_tpu_torch import distributed
    from moose_tpu_torch.distributed import (
        chaos,
        choreography,
        fabric,
        networking,
    )

    net = networking.TcpNetworking("alice", {}, device="cpu")
    assert net.device == "cpu" and distributed.TcpNetworking is \
        networking.TcpNetworking
    assert set(jdistributed.__all__) <= set(distributed.__all__)
    for name in jdistributed.__all__:
        assert getattr(distributed, name) is getattr(fabric, name)
    choreography.start_chaos_restarter({}, {}, {}, None, poll_s=0.01)()
    cfg = chaos.ChaosConfig(seed=1)
    srv = WorkerServer("alice", 0, {}, chaos=cfg, device="cpu")
    assert srv.chaos is cfg
    assert isinstance(srv.networking, chaos.ChaosNetworking)
    assert distributed.WorkerServer is WorkerServer


# -- mTLS ----------------------------------------------------------------------


def _pki(tmp_path, names):
    """A CA and a certificate for each name (CN and DNS subjectAltName
    equal to it), as PEM files."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)

    def pem_key(key):
        return key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption())

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "ca")])
    ca = (x509.CertificateBuilder().subject_name(ca_name)
          .issuer_name(ca_name).public_key(ca_key.public_key())
          .serial_number(1).not_valid_before(now)
          .not_valid_after(now + datetime.timedelta(days=1))
          .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                         critical=True)
          .sign(ca_key, hashes.SHA256()))
    (tmp_path / "ca.pem").write_bytes(ca.public_bytes(
        serialization.Encoding.PEM))
    out = {}
    for serial, name in enumerate(names, start=2):
        key = ec.generate_private_key(ec.SECP256R1())
        cert = (x509.CertificateBuilder()
                .subject_name(x509.Name(
                    [x509.NameAttribute(NameOID.COMMON_NAME, name)]))
                .issuer_name(ca_name).public_key(key.public_key())
                .serial_number(serial).not_valid_before(now)
                .not_valid_after(now + datetime.timedelta(days=1))
                .add_extension(x509.SubjectAlternativeName(
                    [x509.DNSName(name)]), critical=False)
                .sign(ca_key, hashes.SHA256()))
        (tmp_path / f"{name}.pem").write_bytes(cert.public_bytes(
            serialization.Encoding.PEM))
        (tmp_path / f"{name}.key").write_bytes(pem_key(key))
        out[name] = [str(tmp_path / f"{name}.pem"),
                     str(tmp_path / f"{name}.key"),
                     str(tmp_path / "ca.pem")]
    return out


def test_mtls_refuses_an_unauthorised_choreographer(tmp_path):
    import grpc

    from moose_tpu_torch.distributed.tls import tls_config_from_flags

    pki = _pki(tmp_path, ["alice", "choreo", "mallory"])
    tls = {n: tls_config_from_flags(*files) for n, files in pki.items()}
    srv = WorkerServer("alice", 0, {}, tls=tls["alice"],
                       choreographer="choreo", device="cpu").start()
    endpoint = f"127.0.0.1:{srv.port}"
    try:
        good = ChoreographyClient(endpoint, tls=tls["choreo"],
                                  expected_identity="alice")
        assert good.abort("never-launched")["ok"]
        bad = ChoreographyClient(endpoint, tls=tls["mallory"],
                                 expected_identity="alice")
        with pytest.raises(grpc.RpcError) as info:
            bad.abort("never-launched")
        assert info.value.code() == grpc.StatusCode.PERMISSION_DENIED
        with pytest.raises(ValueError, match="expected_identity"):
            ChoreographyClient(endpoint, tls=tls["choreo"])
        with pytest.raises(Exception, match="choreographer"):
            WorkerServer("bob", 0, {}, choreographer="choreo",
                         device="cpu")
    finally:
        srv.stop()
