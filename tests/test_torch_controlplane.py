"""The continuous-training control plane on the port, on the CPU: every
non-slow case of ``tests/test_controlplane.py`` on ``moose_tpu_torch``,
and one promote of a real generation over ``LocalFleetClient``.

- pure unit tests over the routing, windowing and config primitives;
- control-plane lifecycle tests against a scripted fake fleet client
  (every promote/rollback ordering and breach reason);
- tests that run the real blitzen HTTP handler (admin surface) over
  real CPU ``InferenceServer`` replicas behind a real donner ``Router``,
  over loopback HTTP.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

# one process/trust domain: the weak default PRF is acceptable here
os.environ.setdefault("MOOSE_TPU_ALLOW_WEAK_PRF", "1")

from moose_tpu_torch import flight  # noqa: E402
from moose_tpu_torch import metrics as metrics_mod  # noqa: E402
from moose_tpu_torch.bin import blitzen, donner  # noqa: E402
from moose_tpu_torch.bin.donner import (  # noqa: E402
    FleetConfig,
    Router,
    _assign_generation,
    _GenWindow,
)
from moose_tpu_torch.errors import ConfigurationError  # noqa: E402
from moose_tpu_torch.serving import (  # noqa: E402
    CanaryConfig,
    ControlPlane,
    HttpFleetClient,
    InferenceServer,
    LocalFleetClient,
    ServingConfig,
)
from moose_tpu_torch.training.export import logreg_onnx_bytes  # noqa: E402

FEATURES = 3
PARTIES = ["alice", "bob", "carole"]

GENERATIONS_TOTAL = "moose_tpu_controlplane_generations_total"
BREACHES_TOTAL = "moose_tpu_controlplane_slo_breaches_total"


@pytest.fixture
def fixed_keys(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "controlplane-test")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")
    monkeypatch.delenv("MOOSE_TPU_CHAOS_SERVE", raising=False)


def _onnx(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return logreg_onnx_bytes(rng.normal(size=(FEATURES, 1)) * 0.5)


def _counter(name: str, **labels) -> float:
    return metrics_mod.REGISTRY.value(name, **labels)


def _events(kind=None):
    out = flight.get_recorder().events(party="controlplane")
    if kind is not None:
        out = [e for e in out if e["kind"] == kind]
    return out


# -- routing / windowing / config unit tests --------------------------------


def test_canary_config_env_and_validation(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_CANARY_FRACTION", "0.5")
    monkeypatch.setenv("MOOSE_TPU_CANARY_MIN_REQUESTS", "7")
    config = CanaryConfig()
    assert config.fraction == 0.5
    assert config.min_requests == 7
    # explicit overrides win over env
    assert CanaryConfig(fraction=0.1).fraction == 0.1
    with pytest.raises(ConfigurationError):
        CanaryConfig(fraction=0.0)
    with pytest.raises(ConfigurationError):
        CanaryConfig(fraction=1.5)
    with pytest.raises(ConfigurationError):
        CanaryConfig(min_requests=0)
    with pytest.raises(ConfigurationError):
        CanaryConfig(bogus_knob=1)
    monkeypatch.setenv("MOOSE_TPU_CANARY_FRACTION", "nope")
    with pytest.raises(ConfigurationError):
        CanaryConfig()


def test_assign_generation_deterministic_sticky_one_way():
    """The same (model, tenant) always lands on the same generation,
    the realized canary fraction tracks the weight, and ramping the
    canary up never moves a canary tenant back to base."""
    weights = {"base": 0.8, "g0001": 0.2}
    tenants = [f"tenant-{i}" for i in range(500)]
    labels = [_assign_generation("m", t, weights) for t in tenants]
    assert labels == [_assign_generation("m", t, weights) for t in tenants]
    fraction = labels.count("g0001") / len(labels)
    assert 0.10 < fraction < 0.32
    wider = {"base": 0.5, "g0001": 0.5}
    for tenant, label in zip(tenants, labels):
        if label == "g0001":
            assert _assign_generation("m", tenant, wider) == "g0001"
    # assignment is per (model, tenant): a different model shuffles it
    other = [_assign_generation("n", t, weights) for t in tenants]
    assert other != labels


def test_gen_window_stats_and_sliding_trim():
    window = _GenWindow(window_s=60.0)
    assert window.stats() == {
        "count": 0, "errors": 0, "error_rate": 0.0,
        "p50_s": 0.0, "p99_s": 0.0,
    }
    for _ in range(99):
        window.add(0.010, error=False)
    window.add(0.500, error=True)
    stats = window.stats()
    assert stats["count"] == 100
    assert stats["errors"] == 1
    assert stats["error_rate"] == pytest.approx(0.01)
    assert stats["p50_s"] == pytest.approx(0.010)
    assert stats["p99_s"] == pytest.approx(0.500)
    # samples age out of the sliding window
    short = _GenWindow(window_s=0.05)
    short.add(0.010, error=False)
    time.sleep(0.08)
    assert short.stats()["count"] == 0


def test_router_route_table_validation_and_snapshot():
    router = Router(["http://127.0.0.1:1"], config=FleetConfig())
    with pytest.raises(ConfigurationError):
        router.set_route("m", {})
    with pytest.raises(ConfigurationError):
        router.set_route("m", {"g": -1.0})
    with pytest.raises(ConfigurationError):
        router.set_route("m", {"base": 1.0}, canary="g")
    assert router.set_route("m", {"base": 3.0, "g": 1.0}, canary="g") is None
    snap = router.fleet_snapshot()["routes"]["m"]
    assert snap["weights"] == {"base": 0.75, "g": 0.25}
    assert snap["canary"] == "g"
    # zero-weight labels are dropped; previous route is returned
    previous = router.set_route("m", {"base": 1.0, "gone": 0.0})
    assert previous["weights"] == {"base": 0.75, "g": 0.25}
    assert router.fleet_snapshot()["routes"]["m"]["weights"] == {
        "base": 1.0
    }
    assert router.clear_route("m") is not None
    assert router.clear_route("m") is None
    assert "m" not in router.fleet_snapshot()["routes"]


def _post(url, payload, headers=None):
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


def test_donner_admin_routes_http_surface():
    router = Router(["http://127.0.0.1:1"], config=FleetConfig())
    admin_httpd, admin_url = _serve(
        donner._make_handler(router, admin=True)
    )
    plain_httpd, plain_url = _serve(
        donner._make_handler(router, admin=False)
    )
    try:
        status, routes = _post(
            admin_url + "/admin/routes",
            {"model": "m", "weights": {"base": 1, "g": 1}, "canary": "g"},
        )
        assert status == 200
        assert routes["m"]["weights"] == {"base": 0.5, "g": 0.5}
        assert routes["m"]["canary"] == "g"
        fleet = json.loads(_get(admin_url + "/fleet"))
        assert fleet["routes"]["m"]["canary"] == "g"
        status, body = _post(
            admin_url + "/admin/routes", {"model": "m", "weights": {}}
        )
        assert status == 400
        assert body["error"] == "ConfigurationError"
        status, routes = _post(
            admin_url + "/admin/routes", {"model": "m", "clear": True}
        )
        assert status == 200 and "m" not in routes
        # without --admin the route surface does not exist
        status, body = _post(
            plain_url + "/admin/routes",
            {"model": "m", "weights": {"base": 1}},
        )
        assert status == 404
    finally:
        admin_httpd.shutdown()
        admin_httpd.server_close()
        plain_httpd.shutdown()
        plain_httpd.server_close()


# -- control-plane lifecycle against a scripted fleet -----------------------


class _FakeFleet:
    """Scripted fleet client: the control plane's full surface with the
    observed window/metrics/drift under test control, recording every
    mutating call in order."""

    def __init__(self, window=None, replica=None, drift_step=0.0):
        self.window = dict(window or {})
        self.replica = dict(replica or {})
        self.drift = 0.0
        self.drift_step = float(drift_step)
        self.calls = []

    def load_generation(self, name, onnx_bytes, n_features, buckets=()):
        self.calls.append(("load", name))

    def unload_generation(self, name):
        self.calls.append(("unload", name))

    def promote_base(self, model, onnx_bytes, n_features):
        self.calls.append(("promote", model))

    def set_route(self, model, weights, canary=None):
        self.calls.append(("route", model, dict(weights), canary))

    def clear_route(self, model):
        self.calls.append(("clear", model))

    def fleet(self):
        return {"routes": {"m": {
            "weights": {}, "canary": None, "window": dict(self.window),
        }}}

    def replica_metrics(self):
        return [dict(self.replica)]

    def cost_drift_total(self):
        self.drift += self.drift_step
        return self.drift


def _fast_config(**overrides):
    defaults = dict(
        fraction=0.25, watch_s=0.05, min_requests=5, p99_slo_s=0.5,
        error_rate_slo=0.05, poll_s=0.01, timeout_s=0.2,
    )
    defaults.update(overrides)
    return CanaryConfig(**defaults)


def test_controlplane_promotes_and_orders_the_flip():
    client = _FakeFleet(
        window={"g1": {"count": 50, "p99_s": 0.01, "error_rate": 0.0}}
    )
    promoted0 = _counter(GENERATIONS_TOTAL, outcome="promoted")
    plane = ControlPlane(client, "m", _fast_config())
    report = plane.run_generation("g1", b"onnx", FEATURES)
    assert report["promoted"] and report["reason"] == "slo_ok"
    assert report["observed"]["count"] == 50
    assert plane.phase == "idle"
    assert plane.history[-1] is report
    # stage -> canary split -> warm+flip base -> move traffic -> retire
    assert [c[0] for c in client.calls] == [
        "load", "route", "promote", "clear", "unload",
    ]
    assert client.calls[0][1] == "m@g1"
    route = client.calls[1]
    assert route[2] == {"base": 0.75, "g1": 0.25} and route[3] == "g1"
    assert _counter(
        GENERATIONS_TOTAL, outcome="promoted"
    ) == promoted0 + 1
    event = _events("generation_promoted")[-1]
    assert event["model"] == "m" and event["generation"] == "g1"
    assert event["promote_s"] >= 0


@pytest.mark.parametrize("window,replica,config,reason", [
    (
        {"count": 50, "p99_s": 3.0, "error_rate": 0.0}, {},
        {}, "latency",
    ),
    (
        {"count": 50, "p99_s": 0.01, "error_rate": 0.5}, {},
        {}, "errors",
    ),
    (
        {"count": 50, "p99_s": 0.01, "error_rate": 0.0},
        {"queue_wait_p99_s": 2.0},
        {"queue_wait_p99_slo_s": 0.5}, "queue_wait",
    ),
    (
        {"count": 50, "p99_s": 0.01, "error_rate": 0.0},
        {"compute_p99_s": 2.0},
        {"compute_p99_slo_s": 0.5}, "compute",
    ),
])
def test_controlplane_rolls_back_on_each_breach_reason(
    window, replica, config, reason
):
    client = _FakeFleet(window={"g2": window}, replica=replica)
    rolled0 = _counter(GENERATIONS_TOTAL, outcome="rolled_back")
    breach0 = _counter(BREACHES_TOTAL, reason=reason)
    plane = ControlPlane(client, "m", _fast_config(**config))
    report = plane.run_generation("g2", b"onnx", FEATURES)
    assert not report["promoted"]
    assert report["reason"] == reason
    # rollback never touches base; the route flip precedes the retire
    kinds = [c[0] for c in client.calls]
    assert "promote" not in kinds
    assert kinds == ["load", "route", "clear", "unload"]
    assert _counter(
        GENERATIONS_TOTAL, outcome="rolled_back"
    ) == rolled0 + 1
    assert _counter(BREACHES_TOTAL, reason=reason) == breach0 + 1
    event = _events("generation_rolled_back")[-1]
    assert event["generation"] == "g2" and event["reason"] == reason


def test_controlplane_rolls_back_on_cost_drift_and_no_traffic():
    # cost drift fires even before min_requests is met: a canary that
    # trips the cost oracle must die immediately
    client = _FakeFleet(window={}, drift_step=1.0)
    plane = ControlPlane(client, "m", _fast_config(cost_drift_max=0))
    report = plane.run_generation("g3", b"onnx", FEATURES)
    assert not report["promoted"] and report["reason"] == "cost_drift"

    # a canary that never collects min_requests is undecidable: after
    # timeout_s it rolls back as no_traffic instead of hanging
    client = _FakeFleet(window={})
    plane = ControlPlane(client, "m", _fast_config(timeout_s=0.1))
    report = plane.run_generation("g4", b"onnx", FEATURES)
    assert not report["promoted"] and report["reason"] == "no_traffic"
    assert [c[0] for c in client.calls] == [
        "load", "route", "clear", "unload",
    ]


# -- real-fleet harness -----------------------------------------------------


class _Replica:
    """One in-process blitzen: a real ``InferenceServer`` behind the
    real blitzen HTTP handler with the admin + chaos surface enabled."""

    def __init__(self, onnx: bytes, model: str = "m"):
        from moose_tpu_torch import predictors

        self.server = InferenceServer(config=ServingConfig.from_env(
            max_batch=2, max_wait_ms=5.0, queue_bound=32,
        ), device="cpu")
        self.server.register_model(
            model, predictors.from_onnx(onnx),
            row_shape=(FEATURES,), buckets=(2,),
        )
        self.httpd, self.url = _serve(
            blitzen._make_handler(self.server, admin=True)
        )

    def set_chaos(self, match: str, delay_ms: float) -> None:
        status, body = _post(
            self.url + "/admin/chaos",
            {"match": match, "delay_ms": delay_ms},
        )
        assert status == 200, body

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.close()


class _Fleet:
    """N blitzen replicas + a donner front door + the HTTP admin client
    the control plane drives — the in-process mirror of the
    scripts/loop_smoke.py topology."""

    def __init__(self, onnx: bytes, n: int = 2, model: str = "m"):
        self.model = model
        self.replicas = [_Replica(onnx, model) for _ in range(n)]
        self.router = Router(
            [r.url for r in self.replicas],
            config=FleetConfig(
                backoff_ms=5.0, backoff_cap_ms=50.0,
                attempt_timeout_s=60.0,
            ),
        )
        for replica in self.router.replicas:
            self.router.probe_once(replica)
        assert len(self.router.ready_replicas()) == n
        self.httpd, self.url = _serve(
            donner._make_handler(self.router, admin=True)
        )
        self.client = HttpFleetClient(
            self.url, [r.url for r in self.replicas], timeout_s=120.0
        )

    def predict(self, x, tenant="default"):
        return _post(
            f"{self.url}/v1/models/{self.model}:predict", {"x": x},
            headers={"X-Moose-Tenant": tenant},
        )

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for replica in self.replicas:
            replica.close()


class _Load:
    """Sustained multi-tenant open-loop-ish load; every answer is
    recorded so the zero-dropped-requests pin is asserted over the
    WHOLE run, not a sample."""

    def __init__(self, fleet, tenants, period_s=0.25):
        self.results = []
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._worker, args=(fleet, t, period_s),
                daemon=True,
            )
            for t in tenants
        ]
        for thread in self._threads:
            thread.start()

    def _worker(self, fleet, tenant, period_s):
        row = list(np.linspace(-0.5, 0.5, FEATURES))
        while not self._stop.is_set():
            try:
                status, _ = fleet.predict([row], tenant=tenant)
            except Exception as exc:  # noqa: BLE001 — a transport-level
                # failure IS a dropped request for this assertion
                status = f"transport:{type(exc).__name__}"
            self.results.append((tenant, status))
            self._stop.wait(period_s)

    def stop(self):
        self._stop.set()
        for thread in self._threads:
            thread.join(timeout=120)
        return list(self.results)


def _split_tenants(model, n_each):
    """n_each tenants pinned to base and n_each pinned to the canary
    half of the hash ring (stable across canary labels — 'base' sorts
    first, so [0, 0.5) is always base at a 50/50 split)."""
    probe = {"base": 0.5, "zzz": 0.5}
    base, canary = [], []
    for i in range(10_000):
        tenant = f"tenant-{i}"
        side = _assign_generation(model, tenant, probe)
        bucket = base if side == "base" else canary
        if len(bucket) < n_each:
            bucket.append(tenant)
        if len(base) == n_each and len(canary) == n_each:
            return base, canary
    raise AssertionError("tenant split not found")


# -- chaos-hardening: SIGKILLed replica mid-canary --------------------------


def test_generation_miss_retries_peer_then_falls_back(fixed_keys):
    """A replica restarted from its durable snapshot mid-canary no
    longer holds the ephemeral generation: donner must retry the peer
    that does, and when the WHOLE fleet loses it, fall back to the
    last-good label — the caller never sees the outage."""
    fleet = _Fleet(_onnx(1), n=2)
    try:
        client = LocalFleetClient(
            fleet.router, [r.server for r in fleet.replicas]
        )
        client.load_generation("m@g1", _onnx(2), FEATURES)
        fleet.router.set_route(
            "m", {"base": 0.5, "g1": 0.5}, canary="g1"
        )
        tenant = _split_tenants("m", 1)[1][0]
        body = json.dumps({"x": [[0.1, 0.2, -0.3]]}).encode()
        headers = {"X-Moose-Tenant": tenant}
        status, payload, info = fleet.router.forward(
            "/v1/models/m:predict", body, headers
        )
        assert status == 200 and info["generation"] == "g1"
        # replica 0 "was SIGKILLed and restarted" without the ephemeral
        # generation: the router rotates to the peer that still has it
        fleet.replicas[0].server.unregister_model("m@g1")
        for _ in range(4):
            status, payload, info = fleet.router.forward(
                "/v1/models/m:predict", body, headers
            )
            assert status == 200, payload
            assert info["generation"] == "g1"
        # the whole fleet loses the generation: fall back to last-good
        fleet.replicas[1].server.unregister_model("m@g1")
        fallbacks0 = fleet.router.metrics.generation_fallbacks.value(
            model="m"
        )
        status, payload, info = fleet.router.forward(
            "/v1/models/m:predict", body, headers
        )
        assert status == 200, payload
        assert info.get("generation_fallback")
        assert info["generation"] == "base"
        assert json.loads(payload)["y"]
        assert fleet.router.metrics.generation_fallbacks.value(
            model="m"
        ) == fallbacks0 + 1
        # the per-generation request counter saw both labels
        for label in ("g1", "base"):
            assert _counter(
                "moose_tpu_donner_generation_requests_total",
                model="m", generation=label,
            ) >= 1
    finally:
        fleet.close()


def test_unload_racing_a_request_answers_a_generation_miss(fixed_keys):
    """A generation retired while its queue still finishes a batch: a
    request that reaches the replica meanwhile is a typed generation
    miss (donner falls back to last-good), never a client error, even
    in a fleet of one replica."""
    fleet = _Fleet(_onnx(1), n=1)
    try:
        client = LocalFleetClient(
            fleet.router, [r.server for r in fleet.replicas]
        )
        client.load_generation("m@g1", _onnx(2), FEATURES)
        fleet.router.set_route(
            "m", {"base": 0.5, "g1": 0.5}, canary="g1"
        )
        tenant = _split_tenants("m", 1)[1][0]
        body = json.dumps({"x": [[0.1, 0.2, -0.3]]}).encode()
        server = fleet.replicas[0].server
        answers = []

        def forward():
            answers.append(fleet.router.forward(
                "/v1/models/m:predict", body, {"X-Moose-Tenant": tenant}
            ))

        def wait_for(done):
            deadline = time.monotonic() + 60
            while not done():
                assert time.monotonic() < deadline
                time.sleep(0.01)

        threads = [threading.Thread(target=forward)]
        with server.registry.eval_lock:
            # a g1 batch in flight, held behind the evaluation lock
            threads[0].start()
            queue = server._queues["m@g1"]
            wait_for(lambda: queue._in_flight == 1)
            # the unload blocks in the queue's close until that batch
            # is served
            threads.append(threading.Thread(
                target=client.unload_generation, args=("m@g1",)))
            threads[1].start()
            wait_for(lambda: "m@g1" not in server._queues)
            threads.append(threading.Thread(target=forward))
            threads[2].start()
            # answered, or falling back to base behind the lock
            wait_for(lambda: not threads[2].is_alive() or fleet.router
                     .metrics.generation_fallbacks.value(model="m") >= 1)
        for thread in threads:
            thread.join(timeout=120)
        assert [status for status, _, _ in answers] == [200, 200]
        # the batch in flight served on g1, the racing request on base
        served = sorted((bool(info.get("generation_fallback")),
                         info["generation"]) for _, _, info in answers)
        assert served == [(False, "g1"), (True, "base")]
        assert server.registry.names() == ["m"]
    finally:
        fleet.close()


# -- a real promote over the in-process fleet client -------------------------


def test_controlplane_promotes_over_a_local_fleet(fixed_keys):
    """One generation staged, canaried, promoted and retired over
    ``LocalFleetClient`` (the donner router plus a replica's server in
    process) while a base and a canary tenant send traffic through
    donner: no request fails, and afterwards the base model serves the
    new weights."""
    fleet = _Fleet(_onnx(1), n=1)
    try:
        client = LocalFleetClient(
            fleet.router, [r.server for r in fleet.replicas]
        )
        base, canary = _split_tenants("m", 1)
        load = _Load(fleet, base + canary, period_s=0.1)
        try:
            plane = ControlPlane(client, "m", CanaryConfig(
                fraction=0.5, watch_s=0.2, min_requests=3,
                p99_slo_s=30.0, error_rate_slo=0.2, poll_s=0.05,
                timeout_s=60.0,
            ))
            report = plane.run_generation("g1", _onnx(2), FEATURES)
        finally:
            results = load.stop()
        assert report["promoted"], report
        assert results and all(status == 200 for _, status in results)
        for replica in fleet.replicas:
            assert replica.server.registry.names() == ["m"]
        x = [[0.4, -0.1, 0.25]]
        status, body = fleet.predict(x)
        assert status == 200
        w = np.random.default_rng(2).normal(size=(FEATURES, 1)) * 0.5
        p = 1.0 / (1.0 + np.exp(-(np.asarray(x) @ w)))
        assert np.abs(np.asarray(body["y"]) - np.hstack([1 - p, p])).max() \
            < 5e-3
    finally:
        fleet.close()
