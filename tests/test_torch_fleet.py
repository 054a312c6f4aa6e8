"""Fleet serving on the port, on the CPU: every non-slow case of
``tests/test_fleet.py`` on ``moose_tpu_torch``: donner's routing,
ejection and retry semantics, blitzen's readiness and graceful drain,
retryable drained requests, and warm-state snapshot restore
bit-exactness.

The router tests run against tiny stdlib dummy replicas (nothing of the
secure path on the request path); the server-side tests register one
small logistic regression each on a CPU server.  The JAX package's
snapshot units (its validated-jit plan registry, its per-kernel Pallas
verdicts and its ``jax.export`` AOT artifacts) have no counterpart in the
port: they are rewritten to pin what the port writes instead, empty plan
states and kernel verdicts and an ``unsupported:plan-eager-<layout>``
record for every bucket.  The computations a snapshot serializes are the
JAX package's bytes for the same model."""

import functools
import json
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from sklearn import linear_model

from moose_tpu import serde as jserde
from moose_tpu.predictors import from_onnx as jfrom_onnx

from moose_tpu_torch import predictors
from moose_tpu_torch.bin.donner import (
    FleetConfig,
    Router,
    TokenBucket,
    _body_retryable,
)
from moose_tpu_torch.errors import (
    ConfigurationError,
    ReplicaDrainingError,
    SnapshotError,
    is_retryable,
    to_wire,
)
from moose_tpu_torch.predictors import sklearn_export as fx
from moose_tpu_torch.serving import InferenceServer, ServingConfig

RNG = np.random.default_rng(7)
FEATURES = 5


@pytest.fixture
def fixed_keys(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "fleet-test")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")


@functools.cache
def _logreg_onnx():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, FEATURES))
    y = (rng.uniform(size=40) > 0.5).astype(int)
    sk = linear_model.LogisticRegression().fit(x, y)
    return fx.logistic_regression_onnx(sk, FEATURES).encode()


@functools.cache
def _logreg_model():
    return predictors.from_onnx(_logreg_onnx())


def _server(**cfg):
    defaults = dict(max_batch=2, max_wait_ms=5.0, queue_bound=8)
    defaults.update(cfg)
    server = InferenceServer(
        config=ServingConfig.from_env(**defaults), device="cpu"
    )
    server.register_model(
        "m", _logreg_model(), row_shape=(FEATURES,), buckets=(2,)
    )
    return server


# -- dummy replicas ---------------------------------------------------------


class _DummyReplica:
    """A scriptable stand-in for blitzen: ``behavior`` picks the POST
    answer, ``ready`` drives /readyz, ``hits`` counts predicts."""

    def __init__(self, behavior="ok", ready=True):
        self.behavior = behavior
        self.ready = ready
        self.hits = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, payload, length_lie=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header(
                    "Content-Length", str(length_lie or len(body))
                )
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/readyz":
                    self._json(
                        200 if outer.ready else 503,
                        {"status": "ready" if outer.ready else "draining"},
                    )
                else:  # /healthz: alive regardless of readiness
                    self._json(200, {"status": "ok"})

            def do_POST(self):
                outer.hits += 1
                length = int(self.headers.get("Content-Length", 0))
                self.rfile.read(length)
                mode = outer.behavior
                if mode == "ok":
                    self._json(200, {"y": [[0.5, 0.5]]})
                elif mode == "draining":
                    self._json(503, {
                        "error": "ReplicaDrainingError",
                        "message": "draining", "retryable": True,
                    })
                elif mode == "overloaded":
                    self._json(429, {
                        "error": "ServerOverloadedError",
                        "message": "queue full", "retryable": True,
                    })
                elif mode == "bad-request":
                    self._json(400, {
                        "error": "ConfigurationError",
                        "message": "bad shape", "retryable": False,
                    })
                elif mode == "deadline":
                    self._json(504, {
                        "error": "DeadlineExceededError",
                        "message": "too late", "retryable": False,
                    })
                elif mode == "kill-mid-response":
                    # chaos: the process dies between headers and body —
                    # the router must classify this as retryable, never
                    # hang, and move to another replica
                    self._json(
                        200, {"y": [[0.5, 0.5]]}, length_lie=65536
                    )
                    self.wfile.flush()
                    self.connection.close()
                elif mode == "hang":
                    time.sleep(30)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        ).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _dead_port_url() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def _mark_all_ready(router):
    for replica in router.replicas:
        replica.ready = True


def _post(url, payload, headers=None):
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(
                resp.headers
            )
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


# -- router unit tests ------------------------------------------------------


def test_token_bucket():
    unlimited = TokenBucket(rate=0, burst=0)
    assert all(unlimited.take() for _ in range(100))
    bucket = TokenBucket(rate=10.0, burst=2.0)
    assert bucket.take() and bucket.take()
    assert not bucket.take()
    time.sleep(0.25)  # ~2.5 tokens refill, capped at burst
    assert bucket.take() and bucket.take()
    assert not bucket.take()


def test_fleet_config_env_and_validation(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_FLEET_RETRIES", "7")
    monkeypatch.setenv("MOOSE_TPU_FLEET_EJECT_AFTER", "5")
    config = FleetConfig()
    assert config.max_attempts == 7
    assert config.eject_after == 5
    # explicit overrides win over env
    assert FleetConfig(max_attempts=2).max_attempts == 2
    monkeypatch.setenv("MOOSE_TPU_FLEET_RETRIES", "nope")
    with pytest.raises(ConfigurationError):
        FleetConfig()
    monkeypatch.delenv("MOOSE_TPU_FLEET_RETRIES")
    with pytest.raises(ConfigurationError):
        FleetConfig(max_attempts=0)


def test_router_ejects_on_readiness_not_liveness():
    """A draining replica is ALIVE (healthz 200) but not ready: the
    router must eject it on /readyz alone, then readmit once readiness
    recovers."""
    a, b = _DummyReplica(), _DummyReplica(ready=False)
    try:
        router = Router(
            [a.url, b.url],
            config=FleetConfig(eject_after=2, readmit_after=2),
        )
        ejections0 = router.metrics.ejections.value()
        readmissions0 = router.metrics.readmissions.value()
        for _ in range(2):
            for replica in router.replicas:
                router.probe_once(replica)
        assert [r.base_url for r in router.ready_replicas()] == [a.url]
        assert router.replicas[1].ejected
        assert router.metrics.ejections.value() == ejections0 + 1
        # readiness recovers -> readmitted after readmit_after probes
        b.ready = True
        for _ in range(2):
            router.probe_once(router.replicas[1])
        assert not router.replicas[1].ejected
        assert len(router.ready_replicas()) == 2
        assert (
            router.metrics.readmissions.value() == readmissions0 + 1
        )
    finally:
        a.close()
        b.close()


def test_retryable_failure_moves_to_different_replica():
    """blitzen's typed 503-draining body must be resubmitted to another
    replica — the caller sees only the eventual 200."""
    a, b = _DummyReplica(behavior="draining"), _DummyReplica()
    try:
        router = Router(
            [a.url, b.url], config=FleetConfig(backoff_ms=1.0)
        )
        _mark_all_ready(router)
        router._rr = 1  # deterministic: first choice lands on a
        status, payload, info = router.forward(
            "/v1/models/m:predict", b'{"x": [[1]]}', {}
        )
        assert status == 200
        assert json.loads(payload)["y"]
        assert a.hits == 1 and b.hits == 1
        assert info["attempts"] == 2
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("behavior", ["bad-request", "deadline"])
def test_non_retryable_passes_through_untouched(behavior):
    a = _DummyReplica(behavior=behavior)
    b = _DummyReplica()
    try:
        router = Router(
            [a.url, b.url], config=FleetConfig(backoff_ms=1.0)
        )
        _mark_all_ready(router)
        router._rr = 1
        status, payload, _ = router.forward(
            "/v1/models/m:predict", b"{}", {}
        )
        body = json.loads(payload)
        assert status == (400 if behavior == "bad-request" else 504)
        assert body["retryable"] is False
        assert b.hits == 0  # never resubmitted
    finally:
        a.close()
        b.close()


def test_chaos_killed_replica_is_retryable_never_hangs():
    """A replica killed mid-predict (connection drops between headers
    and body) surfaces as a retryable failure bounded by the attempt
    timeout — the request completes on another replica."""
    killed = _DummyReplica(behavior="kill-mid-response")
    ok = _DummyReplica()
    try:
        router = Router(
            [killed.url, ok.url],
            config=FleetConfig(backoff_ms=1.0, attempt_timeout_s=5.0),
        )
        _mark_all_ready(router)
        router._rr = 1
        retries0 = router.metrics.retries.value(
            reason="IncompleteRead"
        )
        t0 = time.perf_counter()
        status, payload, _ = router.forward(
            "/v1/models/m:predict", b"{}", {}
        )
        assert status == 200
        assert time.perf_counter() - t0 < 10
        assert router.metrics.retries.value(
            reason="IncompleteRead"
        ) == retries0 + 1
    finally:
        killed.close()
        ok.close()


def test_dead_replica_connection_refused_retries_elsewhere():
    ok = _DummyReplica()
    try:
        router = Router(
            [_dead_port_url(), ok.url],
            config=FleetConfig(backoff_ms=1.0),
        )
        _mark_all_ready(router)
        router._rr = 1
        status, _, info = router.forward(
            "/v1/models/m:predict", b"{}", {}
        )
        assert status == 200
        assert info["attempts"] == 2
    finally:
        ok.close()


def test_hung_replica_bounded_by_attempt_timeout():
    hung, ok = _DummyReplica(behavior="hang"), _DummyReplica()
    try:
        router = Router(
            [hung.url, ok.url],
            config=FleetConfig(backoff_ms=1.0, attempt_timeout_s=0.5),
        )
        _mark_all_ready(router)
        router._rr = 1
        t0 = time.perf_counter()
        status, _, _ = router.forward(
            "/v1/models/m:predict", b"{}", {}
        )
        assert status == 200
        assert time.perf_counter() - t0 < 5
    finally:
        hung.close()
        ok.close()


def test_no_ready_replica_answers_typed_retryable_503():
    router = Router([_dead_port_url()], config=FleetConfig())
    status, payload, _ = router.forward(
        "/v1/models/m:predict", b"{}", {}
    )
    body = json.loads(payload)
    assert status == 503
    assert body["retryable"] is True
    assert body["error"] == "ServerOverloadedError"


def test_per_tenant_token_bucket_admission():
    router = Router(
        [_dead_port_url()],
        config=FleetConfig(tenant_rate=5.0, tenant_burst=2.0),
    )
    rejected0 = router.metrics.tenant_rejections.value(tenant="t1")
    assert router.admit("t1") and router.admit("t1")
    assert not router.admit("t1")
    assert (
        router.metrics.tenant_rejections.value(tenant="t1")
        == rejected0 + 1
    )
    # tenants are isolated buckets
    assert router.admit("t2")


def test_body_retryable_contract():
    assert _body_retryable(b'{"retryable": true}')
    assert not _body_retryable(b'{"retryable": false}')
    assert not _body_retryable(b'{"error": "X"}')
    # non-JSON 5xx garbage (crashed mid-write) counts as retryable
    assert _body_retryable(b"\x00garbage")


# -- snapshot plan/kernel state units --------------------------------------


def _tampered_manifest(path, **fields):
    """Rewrite ``path``'s manifest with ``fields`` set on the manifest
    and its model ``m`` (the checksum chain covers the blobs only)."""
    manifest = json.loads((path / "MANIFEST.json").read_text())
    for key, value in fields.items():
        target = manifest if key == "kernel_verdicts" else \
            manifest["models"]["m"]
        target[key] = value
    (path / "MANIFEST.json").write_text(json.dumps(manifest))


def test_plan_state_capture_roundtrip(tmp_path):
    """The JAX package captures its validated-jit plan registry in a
    snapshot and reinstalls it at restore.  The port's plans are eager
    and keep no ladder state: a snapshot records the plan states empty,
    and a snapshot that holds some restores into nothing and serves."""
    server = _server()
    path = server.save_snapshot(tmp_path, source_digests={"m": "a"})
    server.close()
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert manifest["models"]["m"]["plan_states"] == {}
    _tampered_manifest(path, plan_states={
        "StackedDialect": {"level": 2, "mode": "jit", "pinned": ["op_3"]},
    })
    restored = InferenceServer(
        config=ServingConfig.from_env(max_batch=2), device="cpu"
    )
    report = restored.load_snapshot(tmp_path, source_digests={"m": "a"})
    assert report["models"] == ["m"]
    x = RNG.normal(size=(1, FEATURES))
    assert restored.predict("m", x, timeout_s=120.0).shape == (1, 2)
    restored.close()


def test_kernel_verdict_restore_backend_gate(tmp_path):
    """The JAX package restores per-(kernel, width) Pallas verdicts,
    ``ok`` ones only on the same backend.  The port's kernel wrappers
    launch or raise and keep no verdict: a snapshot writes none and
    restores none whatever it holds, and its backend string is the
    port's own (``cpu`` here, ``cuda:<device name>`` on a card)."""
    server = _server()
    path = server.save_snapshot(tmp_path, source_digests={"m": "a"})
    server.close()
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert manifest["kernel_verdicts"] == {}
    assert manifest["backend"] == "cpu"
    _tampered_manifest(path, kernel_verdicts={
        "msb/128": "fallback:diverged", "horner/64": "ok"})
    restored = InferenceServer(
        config=ServingConfig.from_env(max_batch=2), device="cpu"
    )
    report = restored.load_snapshot(tmp_path, source_digests={"m": "a"})
    assert report["kernel_verdicts_restored"] == 0
    assert report["same_backend"] is True
    restored.close()


def test_aot_artifact_verify_roundtrip(tmp_path):
    """The JAX package round-trips ``jax.export`` bucket artifacts; the
    port serves eager plans no single exported program represents, so
    its snapshot records every bucket as ``unsupported:plan-eager-
    <layout>`` (the JAX package's verdict form for a plan it cannot
    export), writes no artifact, and a restore keeps those verdicts."""
    server = _server()
    path = server.save_snapshot(tmp_path, source_digests={"m": "a"})
    manifest = json.loads((path / "MANIFEST.json").read_text())
    entry = manifest["models"]["m"]
    assert entry["aot"] == {"2": {
        "verdict": "unsupported:plan-eager-stacked", "plan_key": "stacked",
    }}
    assert not [f for f in manifest["files"] if ".aot." in f]
    assert manifest["kernel_verdicts"] == {} and entry["plan_states"] == {}
    assert manifest["backend"] == "cpu"
    server.close()
    restored = InferenceServer(
        config=ServingConfig.from_env(max_batch=2), device="cpu"
    )
    report = restored.load_snapshot(tmp_path, source_digests={"m": "a"})
    assert report["aot"] == {"m": {"2": "unsupported:plan-eager-stacked"}}
    assert report["kernel_verdicts_restored"] == 0
    restored.close()


def test_snapshot_computations_are_the_jax_package_s_bytes(tmp_path):
    """The traced computation a snapshot stores is what the JAX package
    serializes for the same model, byte for byte."""
    server = _server()
    path = server.save_snapshot(tmp_path)
    server.close()
    jcomp = jfrom_onnx(_logreg_onnx()).traced_predictor()
    assert (path / "m.comp").read_bytes() == \
        jserde.serialize_computation(jcomp)


# -- server-side: drain + readiness + snapshot -----------------------------


def test_batcher_close_completes_queued_with_retryable_error():
    """Requests still queued when the batcher shuts
    down must complete with a RETRYABLE typed error (to_wire carries
    retryable=True) so the router resubmits them to another replica —
    and none may hang."""
    server = _server(max_wait_ms=0.0, queue_bound=8)
    x = RNG.normal(size=(1, FEATURES))
    queue = server._queues["m"]
    with server.registry.eval_lock:  # stall dispatch mid-batch
        futures = [server.submit("m", x) for _ in range(6)]
        time.sleep(0.1)  # let the scheduler pop + block on the lock
        threading.Thread(
            target=queue.close, kwargs={"timeout_s": 0.3}, daemon=True
        ).start()
        time.sleep(0.5)  # close() drains leftovers while we hold
    outcomes = {"served": 0, "drained": 0}
    for future in futures:
        try:
            future.result(timeout=60)
            outcomes["served"] += 1
        except ReplicaDrainingError as e:
            assert is_retryable(e)
            assert to_wire(e)["retryable"] is True
            outcomes["drained"] += 1
    # every future completed; the ones never given batch rows were
    # drained retryably
    assert sum(outcomes.values()) == 6
    assert outcomes["drained"] >= 1
    assert server.metrics_snapshot()["drained_requests"] >= 1
    # admission after shutdown is the same retryable signal
    with pytest.raises(ReplicaDrainingError):
        server.submit("m", x)
    server.close()


def test_drain_then_readyz_and_retry_after(fixed_keys):
    """Readiness/liveness split + graceful drain: /healthz stays 200
    throughout, /readyz flips 503 on drain, and a predict during drain
    answers 503 + Retry-After with a retryable typed body."""
    from moose_tpu_torch.bin.blitzen import ReplicaLifecycle, _make_handler

    server = _server()
    lifecycle = ReplicaLifecycle()
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), _make_handler(server, lifecycle)
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        # _make_handler saw a warm registry -> ready
        with urllib.request.urlopen(base + "/readyz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ready"
        x = RNG.normal(size=(1, FEATURES)).tolist()
        status, body, _ = _post(
            base + "/v1/models/m:predict", {"x": x}
        )
        assert status == 200 and len(body["y"]) == 1

        assert lifecycle.start_drain()
        assert not lifecycle.start_drain()  # second SIGTERM: no-op
        assert server.drain(timeout_s=10)

        # liveness still 200; readiness now 503
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
        status, body, _ = _post(
            base + "/v1/models/m:predict", {"x": x}
        )
        assert status == 503
        assert body["error"] == "ReplicaDrainingError"
        assert body["retryable"] is True
        try:
            urllib.request.urlopen(base + "/readyz", timeout=10)
            raise AssertionError("readyz must be 503 while draining")
        except urllib.error.HTTPError as e:
            assert e.code == 503
            assert json.loads(e.read())["status"] == "draining"
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_snapshot_restore_is_bitwise_identical(fixed_keys, tmp_path):
    """Under MOOSE_TPU_FIXED_KEYS a snapshot-
    restored replica's outputs are bit-identical to the replica that
    wrote the snapshot, with zero re-traces after restore — and a stale/tampered snapshot is a
    typed SnapshotError, never silently served."""
    probe = RNG.normal(size=(2, FEATURES))
    server = _server()
    y_fresh = server.predict("m", probe, timeout_s=120.0)
    path = server.save_snapshot(
        tmp_path, source_digests={"m": "digest-A"}
    )
    assert (path / "MANIFEST.json").exists()
    server.close()

    restored = InferenceServer(
        config=ServingConfig.from_env(
            max_batch=2, max_wait_ms=5.0, queue_bound=8
        ),
        device="cpu",
    )
    report = restored.load_snapshot(
        tmp_path, source_digests={"m": "digest-A"}
    )
    assert report["models"] == ["m"]
    assert report["probe_checked"] >= 1  # fixed keys -> digests proven
    y_restored = restored.predict("m", probe, timeout_s=120.0)
    assert y_restored.dtype == y_fresh.dtype
    np.testing.assert_array_equal(y_restored, y_fresh)
    snap = restored.metrics_snapshot()
    assert snap["retraces_after_warm"] == 0
    restored.close()

    # invalidation: a changed model source is rejected...
    with pytest.raises(SnapshotError):
        InferenceServer(
            config=ServingConfig.from_env(max_batch=2), device="cpu"
        ).load_snapshot(
            tmp_path, source_digests={"m": "digest-B"}
        )
    # ...and so is a corrupted blob (checksum chain)
    current = tmp_path / (tmp_path / "CURRENT").read_text().strip()
    comp_file = current / "m.comp"
    comp_file.write_bytes(comp_file.read_bytes()[:-3] + b"\x00\x00\x00")
    with pytest.raises(SnapshotError):
        InferenceServer(
            config=ServingConfig.from_env(max_batch=2), device="cpu"
        ).load_snapshot(
            tmp_path, source_digests={"m": "digest-A"}
        )


def test_snapshot_missing_is_typed_error(tmp_path):
    with pytest.raises(SnapshotError):
        InferenceServer(
            config=ServingConfig.from_env(max_batch=2), device="cpu"
        ).load_snapshot(tmp_path / "nowhere")
