"""The port's deterministic chaos layer (``moose_tpu_torch/distributed/
chaos.py``), its hooks in the port's workers and client, and
``GrpcTrainingCluster`` resuming a chaos-killed worker, held against the
JAX package on the CPU: tests/test_chaos.py's env parsing, pure
decisions, duplicate and drop bit-exactness, kill detection, kill budget
and permanent-error cases, and tests/test_training.py's gRPC
kill-and-resume.

Tolerances: equality.  Decisions are pure blake2b functions of the seed,
so both packages' configs give the same fractions, fault logs and
``schedule_digest``; under ``MOOSE_TPU_FIXED_KEYS`` and the threefry PRF
a chaos run's outputs (dup, drop) are word-equal to the clean run's and
to the JAX workers' on the same lowered bytes, and a training run
resumed after a kill ends with the clean run's committed share words
and the JAX cluster's weights.  Over the fabric transport (three
virtual CPU device handles, tests/test_chaos.py:739) a dropped send's
replay rides the wire, with the same fault schedule and outputs as
without the fabric."""

import threading
import time

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.dialects import host as jhost
from moose_tpu.distributed import chaos as jchaos
from moose_tpu.edsl import tracer as jtracer

import moose_tpu_torch as tm
from moose_tpu_torch import devices, flight
from moose_tpu_torch import metrics as tmetrics
from moose_tpu_torch.compilation import DEFAULT_PASSES as TPASSES
from moose_tpu_torch.compilation import compile_computation as tcompile
from moose_tpu_torch.compilation.lowering import (
    arg_specs_from_arguments as tspecs,
)
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.distributed import chaos as tchaos
from moose_tpu_torch.distributed.choreography import (
    WorkerServer,
    start_chaos_restarter,
    start_local_cluster,
)
from moose_tpu_torch.distributed.client import GrpcClientRuntime
from moose_tpu_torch.distributed.fabric import FabricDomain, FabricNetworking
from moose_tpu_torch.distributed.networking import LocalNetworking
from moose_tpu_torch.distributed.worker import execute_role
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.errors import (
    CompilationError,
    ConfigurationError,
    NetworkingError,
    PeerUnreachableError,
    SessionAbortedError,
    from_wire,
)

from test_torch_distributed import _env
from torch_parity import fixed_keys_env, prf

IDS = ("alice", "bob", "carole")
# tests/test_chaos.py's seed: it drops exactly one first-attempt send of
# this secure dot, so the supervisor's single resubmission clears it
DROP_SEED = 85
SYNC_SEED = 1234
WORKER_KW = dict(ping_interval=0.25, ping_misses=3, startup_grace=5.0,
                 receive_timeout=2.5, stall_grace=0.5)


def _fast_path():
    """The port's workers on their compiled fast path, one validating
    session a plan, as the JAX package's worker-jit chaos tests set it
    (the tests' ``MOOSE_TPU_JIT=0`` would keep the legacy scheduler)."""
    return _env(MOOSE_TPU_WORKER_JIT="1", MOOSE_TPU_JIT_SELFCHECK="1")


def _assert_settled(modes):
    """Every role ran its plan and settled, nothing pinned on a clean
    graph (``modes``: role -> {"plan_mode", "pinned_segments"})."""
    assert set(modes) == set(IDS), modes
    for party, mode in modes.items():
        assert mode["plan_mode"] in ("segmented", "full-jit"), (party, mode)
        assert mode["pinned_segments"] == [], (party, mode)


def _secure_dot(pm):
    """tests/test_chaos.py's graph, in eDSL module ``pm``."""
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

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


def _args():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(4, 3)), "w": rng.normal(size=(3, 2))}


class _NullTransport:
    def send(self, *a, **kw):
        return 0

    def ping(self, receiver, **kw):
        return {"ok": True}


def _run_cluster_once(pkg, chaos=None, max_attempts=3, **server_kw):
    """One GrpcClientRuntime run of the secure dot on three workers of
    package ``pkg`` ("jax" or "port") under ``chaos`` (``server_kw``:
    more WorkerServer arguments); (outputs, report)."""
    if pkg == "jax":
        from moose_tpu.distributed.choreography import start_local_cluster \
            as start
        from moose_tpu.distributed.client import GrpcClientRuntime as Client

        host, pm, tracer, kw = jhost, jm, jtracer, {}
    else:
        start, Client = start_local_cluster, GrpcClientRuntime
        host, pm, tracer, kw = thost, tm, ttracer, {"device": "cpu"}
    servers, endpoints = start(IDS, chaos=chaos, **WORKER_KW, **kw,
                               **server_kw)
    try:
        runtime = Client(endpoints, max_attempts=max_attempts,
                         backoff_base_s=0.05, backoff_cap_s=0.2)
        with host.deterministic_sync_keys(SYNC_SEED):
            outputs, _ = runtime.run_computation(
                tracer.trace(_secure_dot(pm)), _args(), timeout=30.0)
        return outputs, runtime.last_session_report
    finally:
        for srv in servers.values():
            srv.stop()


@pytest.fixture(scope="module")
def jax_drop_run():
    """The JAX cluster's clean and DROP_SEED runs (its legacy eager
    scheduler), under fixed keys."""
    with prf("threefry"), fixed_keys_env(), _env(MOOSE_TPU_WORKER_JIT="0"):
        clean, _ = _run_cluster_once("jax")
        cfg = jchaos.ChaosConfig(seed=DROP_SEED, drop_send=0.2)
        out, report = _run_cluster_once("jax", cfg)
    assert report["ok"] and report["n_attempts"] == 2
    return clean, out, cfg


# -- the config: parsing and pure decisions ------------------------------------


SPEC = ("seed:17,drop_send:0.2,delay_ms:3,dup_send:0.5,fail_ping:0.25,"
        "kill_after_ops:9,party:carole")
ATTRS = ("seed", "drop_send", "delay_ms", "dup_send", "fail_ping",
         "kill_after_ops", "party", "max_kills")


@pytest.mark.parametrize("spec", [
    SPEC, "seed:1,kill_after_ops:5,max_kills:3", "seed:1,kill_after_ops:5"])
def test_chaos_env_parsing(spec):
    got = tchaos.ChaosConfig.from_env(spec)
    want = jchaos.ChaosConfig.from_env(spec)
    assert [getattr(got, a) for a in ATTRS] == \
        [getattr(want, a) for a in ATTRS]
    assert tchaos.ChaosConfig.from_env("") is None
    for bad in ("seed:1,warp_drive:0.5", "drop_send:1.5", "seed"):
        with pytest.raises(ConfigurationError):
            tchaos.ChaosConfig.from_env(bad)


def test_chaos_decisions_are_pure_functions_of_seed():
    keys = [f"{i:02x}" for i in range(64)]

    def fractions(mod, seed):
        cfg = mod.ChaosConfig(seed=seed, drop_send=0.3)
        return [cfg._fraction("drop_send", k, n) for k in keys
                for n in range(2)]

    assert fractions(tchaos, 42) == fractions(jchaos, 42)
    assert fractions(tchaos, 42) == fractions(tchaos, 42)
    assert fractions(tchaos, 42) != fractions(tchaos, 43)


def test_worker_server_arms_chaos_from_env(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_CHAOS", "seed:5,drop_send:0.1")
    srv = WorkerServer("alice", 0, {}, device="cpu")
    assert srv.chaos is not None and srv.chaos.seed == 5
    assert isinstance(srv.networking, tchaos.ChaosNetworking)
    # wire -> fabric -> chaos, as the JAX package layers them: chaos
    # stays outermost, and a drop latches the fabric's wire path
    from moose_tpu.distributed.choreography import WorkerServer as JWorker
    from moose_tpu.distributed.fabric import FabricDomain as JDomain
    from moose_tpu.distributed.fabric import FabricNetworking as JFabric
    from moose_tpu.distributed.networking import LocalNetworking as JLocal

    dom = FabricDomain({p: (d,) for p, d in zip(
        IDS, devices.virtual_devices("cpu", 3))}, "simulation")
    srv = WorkerServer("alice", 0, {}, device="cpu", fabric_domain=dom)
    jsrv = JWorker("alice", 0, {}, fabric_domain=JDomain.default(
        IDS, trust_model="simulation"))
    for server in (srv, jsrv):
        assert type(server.networking).__name__ == "ChaosNetworking"
        assert type(server.networking._inner).__name__ == \
            "FabricNetworking"
        assert server.fabric_domain.cells_of("alice") is \
            server.networking._inner.cells
    outsider = WorkerServer("mallory", 0, {}, device="cpu",
                            fabric_domain=dom)
    assert type(outsider.networking._inner).__name__ == "GrpcNetworking"
    # a dropped fabric send latches its key onto the wire, in both
    # packages
    for mod, net in (
            (tchaos, FabricNetworking(dom, "alice",
                                      LocalNetworking(device="cpu"))),
            (jchaos, JFabric(jsrv.fabric_domain, "alice", JLocal()))):
        chaotic = mod.ChaosConfig(seed=1, drop_send=1.0).wrap(net, "alice")
        assert chaotic.send(b"v", "bob", "k-drop", "s") is None
        assert net.domain.is_forced_wire("k-drop")
        assert net._wire_reason("bob", "k-drop", "s2") == "forced_wire"


def _scripted(mod):
    """The fault log of a scripted sequence of sends through package
    ``mod``'s chaos layer: first and later attempts of a drop schedule,
    duplicates, delays, and a kill budget with revives."""
    cfg = mod.ChaosConfig(seed=3, drop_send=0.5, dup_send=0.5,
                          kill_after_ops=6, party="alice", max_kills=2)
    net = cfg.wrap(_NullTransport(), "alice")
    killed = []
    for round_ in range(3):
        for i in range(8):
            try:
                net.send(b"v", "bob", f"rdv-{i}", f"session-{round_}")
            except mod.NetworkingError:
                killed.append((round_, i))
                cfg.revive("alice")
    return cfg, killed


def test_drop_dup_and_kill_schedules_equal_the_jax_package_s():
    got, got_killed = _scripted(tchaos)
    want, want_killed = _scripted(jchaos)
    assert got.faults == want.faults
    assert got_killed == want_killed and len(got_killed) == 2
    for kinds in (None, {"drop_send"}, {"dup_send", "kill"}):
        assert got.schedule_digest(kinds) == want.schedule_digest(kinds)


def test_drop_schedule_is_per_attempt_not_per_session():
    cfg = tchaos.ChaosConfig(seed=3, drop_send=1.0)
    net = cfg.wrap(_NullTransport(), "alice")
    net.send(b"v", "bob", "rdv-0", "session-a")
    assert len([f for f in cfg.faults if f["kind"] == "drop_send"]) == 1
    for session in ("session-b", "session-c"):
        net.send(b"v", "bob", "rdv-0", session)
    assert len([f for f in cfg.faults if f["kind"] == "drop_send"]) == 1


def test_kill_budget_caps_at_max_kills_and_revive_restores():
    cfg = tchaos.ChaosConfig(seed=5, kill_after_ops=2, party="alice",
                             max_kills=1)
    net = cfg.wrap(_NullTransport(), "alice")
    net.send(b"v", "bob", "k0", "s")
    net.send(b"v", "bob", "k1", "s")
    with pytest.raises(NetworkingError):  # op 3 exceeds the budget
        net.send(b"v", "bob", "k2", "s")
    with pytest.raises(NetworkingError):  # latched dead
        net.send(b"v", "bob", "k3", "s")
    with pytest.raises(NetworkingError):
        net.ping("bob")
    cfg.revive("alice")
    for i in range(10):  # kill budget spent: runs clean from here on
        net.send(b"v", "bob", f"post-{i}", "s")
    assert len([f for f in cfg.faults if f["kind"] == "kill"]) == 1


# -- bit-exactness under faults ------------------------------------------------


def test_duplicate_sends_leave_outputs_bit_exact_over_local_transport(
        jax_drop_run):
    args = _args()
    with thost.deterministic_sync_keys(SYNC_SEED):
        compiled = tcompile(ttracer.trace(_secure_dot(tm)), TPASSES,
                            tspecs(args))
    modes = {}

    def run(chaos):
        net = LocalNetworking(device="cpu")
        results, errors = {}, {}

        def work(identity):
            try:
                wrapped = chaos.wrap(net, identity) if chaos else net
                results[identity] = execute_role(
                    compiled, identity, {}, args, wrapped,
                    session_id="dup-1", timeout=30.0)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors[identity] = e

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in IDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        modes.update(results)
        return {k: v for r in results.values()
                for k, v in r["outputs"].items()}

    with prf("threefry"), fixed_keys_env(), _fast_path():
        baseline = run(None)
        chaos = tchaos.ChaosConfig(seed=3, dup_send=1.0)
        chaotic = run(chaos)
    assert [f for f in chaos.faults if f["kind"] == "dup_send"]
    _assert_settled(modes)
    jax_clean = jax_drop_run[0]
    assert set(baseline) == set(chaotic) == set(jax_clean)
    for name in baseline:
        assert np.array_equal(baseline[name], chaotic[name])
        assert np.array_equal(baseline[name], np.asarray(jax_clean[name]))


def test_dropped_send_retried_bit_exact_and_schedule_reproducible(
        jax_drop_run):
    jax_clean, jax_out, jax_cfg = jax_drop_run
    with prf("threefry"), fixed_keys_env(), _fast_path():
        baseline, base_report = _run_cluster_once("port")
        cfg = tchaos.ChaosConfig(seed=DROP_SEED, drop_send=0.2)
        out, report = _run_cluster_once("port", cfg)
    assert base_report["ok"] and base_report["n_attempts"] == 1
    _assert_settled(base_report["plan_modes"])
    _assert_settled(report["plan_modes"])
    drops = [f for f in cfg.faults if f["kind"] == "drop_send"]
    assert drops
    assert report["ok"] and report["retried"]
    assert report["n_attempts"] == 2
    assert [f["kind"] for f in report["faults_injected"]].count(
        "drop_send") == len(drops)
    first, second = report["attempts"]
    assert first["status"] == "retrieve_failed" and first["retryable"]
    assert second["status"] == "ok"
    # the JAX package's schedule for the same seed, and its words
    assert cfg.schedule_digest(kinds={"drop_send"}) == \
        jax_cfg.schedule_digest(kinds={"drop_send"})
    for name in jax_clean:
        want = np.asarray(jax_clean[name])
        assert np.array_equal(baseline[name], want)
        assert np.array_equal(out[name], want)
        assert np.array_equal(np.asarray(jax_out[name]), want)
    kinds = {e.get("kind") for e in flight.get_recorder().events()}
    assert "chaos_drop_send" in kinds


def test_chaos_drop_over_fabric_replays_on_wire_bit_exact(jax_drop_run):
    """Chaos composes over the fabric (tests/test_chaos.py:739): fault
    decisions key on the logical rendezvous key before the permute
    lowering, a dropped key's replay rides the wire (``forced_wire``),
    and the seed gives the JAX package's fault schedule and words with
    the fabric on."""
    jax_clean, jax_out, jax_cfg = jax_drop_run
    dom = FabricDomain({p: (d,) for p, d in zip(
        IDS, devices.virtual_devices("cpu", 3))}, "simulation")
    forced = tmetrics.REGISTRY.value("moose_tpu_fabric_fallbacks_total",
                                     reason="forced_wire")
    permutes = tmetrics.REGISTRY.value("moose_tpu_fabric_permutes_total")
    cfg = tchaos.ChaosConfig(seed=DROP_SEED, drop_send=0.2)
    with prf("threefry"), fixed_keys_env(), _fast_path():
        out, report = _run_cluster_once("port", cfg, fabric_domain=dom)
    _assert_settled(report["plan_modes"])
    assert [f for f in cfg.faults if f["kind"] == "drop_send"]
    assert report["ok"] is True and report["retried"] is True
    assert report["transport"] == "fabric"
    assert report["trust_model"] == "simulation"
    assert set(report["transports"]) == set(IDS)
    assert tmetrics.REGISTRY.value("moose_tpu_fabric_fallbacks_total",
                                   reason="forced_wire") > forced
    assert tmetrics.REGISTRY.value(
        "moose_tpu_fabric_permutes_total") > permutes
    # the same schedule and words as the JAX cluster's without a fabric
    assert cfg.schedule_digest(kinds={"drop_send"}) == \
        jax_cfg.schedule_digest(kinds={"drop_send"})
    for name in jax_out:
        assert np.array_equal(out[name], np.asarray(jax_out[name]))
        assert np.array_equal(out[name], np.asarray(jax_clean[name]))


def _lowered_blob(args):
    from moose_tpu_torch.serde import serialize_computation

    with thost.deterministic_sync_keys(SYNC_SEED):
        return serialize_computation(tcompile(
            ttracer.trace(_secure_dot(tm)), TPASSES, tspecs(args)))


def test_killed_worker_trips_detector_within_budget():
    import msgpack

    from moose_tpu_torch.serde import serialize_value

    args = _args()
    blob = _lowered_blob(args)
    chaos = tchaos.ChaosConfig(seed=1, kill_after_ops=1, party="carole")
    servers, _ = start_local_cluster(
        IDS, device="cpu", ping_interval=0.25, ping_misses=2,
        startup_grace=5.0, receive_timeout=120.0, chaos=chaos)
    try:
        wire_args = {k: serialize_value(np.asarray(v))
                     for k, v in args.items()}
        t0 = time.monotonic()
        with prf("threefry"), _fast_path():
            for srv in servers.values():
                srv._launch_inner(msgpack.packb(
                    {"session_id": "chaos-kill-1", "computation": blob,
                     "arguments": wire_args}, use_bin_type=True))
            results = {
                name: msgpack.unpackb(
                    srv._results.get("chaos-kill-1", timeout=30.0),
                    raw=False)
                for name, srv in servers.items() if name != "carole"}
        elapsed = time.monotonic() - t0
        assert any(f["kind"] == "kill" for f in chaos.faults)
        assert elapsed < 20.0, f"detection took {elapsed:.1f}s"
        for name, result in results.items():
            assert "error" in result, (name, result)
            exc = from_wire(result["envelope"])
            assert exc.retryable, (name, result)
            assert isinstance(exc, (PeerUnreachableError, NetworkingError,
                                    SessionAbortedError)), (name, result)
    finally:
        for srv in servers.values():
            srv.stop()


def test_permanent_error_not_retried_and_surfaces_typed(monkeypatch):
    from moose_tpu_torch.distributed import worker as worker_mod

    real = worker_mod.execute_role

    def sabotaged(comp, identity, *args, **kwargs):
        if identity == "bob":
            raise CompilationError("injected: bob cannot lower this")
        return real(comp, identity, *args, **kwargs)

    monkeypatch.setattr(worker_mod, "execute_role", sabotaged)
    servers, endpoints = start_local_cluster(
        IDS, device="cpu", ping_interval=0.25, ping_misses=3,
        receive_timeout=20.0)
    try:
        runtime = GrpcClientRuntime(endpoints, max_attempts=3)
        with prf("threefry"), pytest.raises(CompilationError,
                                            match="injected"):
            runtime.run_computation(ttracer.trace(_secure_dot(tm)),
                                    _args(), timeout=30.0)
        report = runtime.last_session_report
        assert report["ok"] is False and report["n_attempts"] == 1
        assert report["attempts"][0]["retryable"] is False
        assert any("CompilationError" in e
                   for e in report["attempts"][0]["errors"].values())
    finally:
        for srv in servers.values():
            srv.stop()


# -- GrpcTrainingCluster: kill, restart, resume bit-exact ----------------------


def _training_run(pkg, root, chaos=None, epochs=2):
    """tests/test_training.py's ``_run_grpc_training`` in package
    ``pkg``: a LogregSGDTrainer(3) over three in-process gRPC workers,
    a chaos-killed worker restarted on its port with its CheckpointStore.
    Returns (report, each party's committed share words)."""
    from test_torch_training_session import _data, _stores

    if pkg == "jax":
        from moose_tpu.distributed import choreography as chor
        from moose_tpu.distributed.client import GrpcClientRuntime as Client
        from moose_tpu.predictors.trainers import LogregSGDTrainer
        from moose_tpu.storage import FilesystemStorage as Fs
        from moose_tpu.training import CheckpointStore as Store
        from moose_tpu.training import TrainingConfig, TrainingSession
        from moose_tpu.training.session import GrpcTrainingCluster

        host, kw = jhost, {}
        stores = _stores(root, Store, Fs)
    else:
        from moose_tpu_torch.distributed import choreography as chor
        from moose_tpu_torch.predictors.trainers import LogregSGDTrainer
        from moose_tpu_torch.training import (
            TrainingConfig,
            TrainingSession,
        )
        from moose_tpu_torch.training.session import GrpcTrainingCluster

        Client, host, kw = GrpcClientRuntime, thost, {"device": "cpu"}
        stores = _stores(root)
    worker_kw = dict(ping_interval=0.25, ping_misses=3, startup_grace=5.0,
                     receive_timeout=5.0, stall_grace=1.0, **kw)
    servers, endpoints = chor.start_local_cluster(
        IDS, storages=stores, chaos=chaos, **worker_kw)
    stop_restarter = chor.start_chaos_restarter(
        servers, endpoints, stores, chaos, **worker_kw)
    try:
        client = Client(endpoints, max_attempts=3, backoff_base_s=0.1,
                        backoff_cap_s=0.5)
        trainer = LogregSGDTrainer(n_features=3, learning_rate=0.1)
        session = TrainingSession(
            trainer, GrpcTrainingCluster(client),
            TrainingConfig(epochs=epochs, session_timeout_s=60,
                           max_epoch_attempts=8, backoff_base_s=0.2,
                           backoff_cap_s=1.0))
        with host.deterministic_sync_keys(SYNC_SEED):
            report = session.run(*_data())
    finally:
        stop_restarter()
        for srv in servers.values():
            srv.stop()
    words = {(p, k): np.asarray(stores[p].load(k)) for p in IDS
             for k in trainer.expected_staged()}
    return report, words


def test_grpc_chaos_kill_mid_epoch_resumes_bit_exact(tmp_path):
    with prf("threefry"), fixed_keys_env("train-test"), \
            _env(MOOSE_TPU_WORKER_JIT="0"):
        want, want_words = _training_run("jax", tmp_path / "jax")
        clean, clean_words = _training_run("port", tmp_path / "clean")
        chaos = tchaos.ChaosConfig(seed=7, kill_after_ops=260,
                                   party="carole", max_kills=1)
        chaotic, chaotic_words = _training_run("port", tmp_path / "chaos",
                                               chaos)
    assert want["ok"] and clean["ok"] and clean["resumes"] == 0
    assert [f for f in chaos.faults if f["kind"] == "kill"]
    assert chaotic["ok"] and chaotic["resumes"] >= 1
    assert np.array_equal(clean["weights"]["w"], chaotic["weights"]["w"])
    assert np.array_equal(clean["weights"]["w"], want["weights"]["w"])
    assert set(clean_words) == set(chaotic_words) == set(want_words)
    for key, words in clean_words.items():
        assert np.array_equal(words, chaotic_words[key]), key
        assert np.array_equal(words, want_words[key]), key
    kinds = {e.get("kind") for e in flight.get_recorder().events()}
    assert "epoch_resumed" in kinds and "epoch_committed" in kinds
