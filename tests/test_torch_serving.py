"""The port's serving layer on the CPU: every case of
``tests/test_serving.py`` on ``moose_tpu_torch.serving``.

Bit-exactness discipline, as in the JAX package's file: replicated
fixed-point results carry ±1 LSB of share-dependent truncation noise and
mask draws depend on the shape, so the exact comparisons pin the PRF
keys (``MOOSE_TPU_FIXED_KEYS``) and compare what the server returns with
a direct evaluation of the identical padded bucket.  The batch
composition is fixed (a long ``max_wait_ms``, exactly one bucket's rows
submitted), so the batcher's timing cannot move a row.  The server
evaluates on its scheduler thread, so these cases also show that the
port's per-thread state (the PRF choice, telemetry, the draw ledger, the
launch counters) carries to that thread.

A served bucket is also held against the JAX package's ``_direct_rows``
of that bucket (:func:`assert_served_bucket_is_the_jax_package_s`), for
the logistic regression and the MLP at ring64 and ring128, under the
same keys and the ``threefry`` stream: equal float for float.  A JAX
evaluation at new shapes costs 10-35 s of eager compiles on the CPU, so
those cases run beside the JAX references of the same models and shapes:
``tests/test_torch_logreg.py`` and ``tests/test_torch_dense.py``."""

import functools
import io
import json
import threading
import time
import urllib.request
from contextlib import redirect_stdout
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.compilation.analysis import lint_check as jlint_check
from moose_tpu.errors import MalformedComputationError as JaxMalformed
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch import predictors
from moose_tpu_torch.errors import (
    ConfigurationError,
    DeadlineExceededError,
    MalformedComputationError,
    ServerOverloadedError,
)
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.runtime import LocalMooseRuntime
from moose_tpu_torch.serving import (
    InferenceServer,
    ServingConfig,
    bucket_for,
    power_of_two_buckets,
)

from torch_parity import threefry  # noqa: F401  (fixture)

sklearn = pytest.importorskip("sklearn")
from sklearn import linear_model, neural_network  # noqa: E402

IDS = ["alice", "bob", "carole"]
RNG = np.random.default_rng(99)
FEATURES = 6
DTYPES = {
    # 2*(8+17)+10 <= 61 -> ring64; fixed(24,40), the default, -> ring128
    "ring64": ((8, 17), tm.fixed(8, 17)),
    "ring128": ((24, 40), tm.fixed(24, 40)),
}


@pytest.fixture
def fixed_keys(monkeypatch, threefry):
    """Pin every PRF draw in both packages (test-only knob) under the
    threefry stream: same shape in, same bits out."""
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "serving-test")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")


@functools.cache
def _onnx(kind):
    """One sklearn fit a kind for the whole file: its ONNX bytes and
    the sklearn model."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(48, FEATURES))
    y = (rng.uniform(size=48) > 0.5).astype(int)
    if kind == "logreg":
        sk = linear_model.LogisticRegression().fit(x, y)
        return tsk.logistic_regression_onnx(sk, FEATURES).encode(), sk
    sk = neural_network.MLPClassifier(
        hidden_layer_sizes=(4,), max_iter=300, random_state=0,
    ).fit(x, y)
    return tsk.mlp_onnx(sk, FEATURES, classifier=True).encode(), sk


@functools.cache
def _model(kind):
    """The port's predictor of ``kind``, cached so its memoized trace is
    shared by every test and runtime."""
    return predictors.from_onnx(_onnx(kind)[0])


def _server(model, dtype=None, buckets=(), **cfg):
    defaults = dict(max_batch=4, max_wait_ms=150.0, queue_bound=16)
    defaults.update(cfg)
    server = InferenceServer(
        config=ServingConfig.from_env(**defaults), device="cpu"
    )
    server.register_model(
        "m", model, row_shape=(FEATURES,), fixedpoint_dtype=dtype,
        buckets=buckets,
    )
    return server


def _direct_rows(registered, batch):
    """Reference: one direct evaluation of the identical padded bucket
    on a fresh port runtime, same traced computation, pinned keys."""
    rt = LocalMooseRuntime(IDS, device="cpu")
    padded, _ = registered.pad(np.asarray(batch, dtype=np.float64))
    (out,) = rt.evaluate_computation(
        registered.comp, arguments={registered.input_name: padded}
    ).values()
    return np.asarray(out)


def _jax_direct_rows(onnx_bytes, precision, padded):
    """The JAX package's ``_direct_rows``: its predictor from the same
    ONNX bytes, traced at the same dtype, evaluated on a fresh JAX
    runtime (stacked layout, eager) at the same padded bucket."""
    comp = jfrom_onnx(onnx_bytes).traced_predictor(jm.fixed(*precision))
    (out,) = JaxRuntime(IDS, use_jit=False).evaluate_computation(
        comp, arguments={"x": padded}
    ).values()
    return np.asarray(out)


def assert_served_bucket_is_the_jax_package_s(onnx_bytes, precision, x,
                                              bucket):
    """``x`` (at most ``bucket`` rows) submitted row by row to a CPU
    server whose one bucket is ``bucket``, under a long ``max_wait_ms``:
    the rows ride one batch, padded to the bucket.  The served rows equal
    a direct evaluation of that padded bucket on the port and the JAX
    package's.  Call under fixed keys and ``threefry`` in both packages;
    returns the served rows."""
    model = predictors.from_onnx(onnx_bytes)
    config = ServingConfig(max_batch=bucket, max_wait_ms=1000.0,
                           queue_bound=bucket)
    with InferenceServer(config=config, device="cpu") as server:
        server.register_model(
            "m", model, row_shape=x.shape[1:], buckets=(bucket,),
            fixedpoint_dtype=tm.fixed(*precision))
        futures = [server.submit("m", row) for row in x]
        got = np.concatenate([f.result(timeout=120) for f in futures])
    assert server.metrics_snapshot()["batch_size_hist"] == {bucket: 1}
    registered = server.registry.get("m")
    padded, _ = registered.pad(np.asarray(x, dtype=np.float64))
    np.testing.assert_array_equal(got, _direct_rows(registered, x)[:len(x)])
    np.testing.assert_array_equal(
        got, _jax_direct_rows(onnx_bytes, precision, padded)[:len(x)])
    return got


def test_bucket_policy():
    assert power_of_two_buckets(1) == (1,)
    assert power_of_two_buckets(6) == (1, 2, 4, 8)
    assert power_of_two_buckets(8) == (1, 2, 4, 8)
    assert bucket_for(3, (1, 2, 4, 8)) == 4
    assert bucket_for(8, (1, 2, 4, 8)) == 8
    with pytest.raises(ConfigurationError):
        bucket_for(9, (1, 2, 4, 8))


def test_config_env_knobs(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_SERVE_MAX_BATCH", "32")
    monkeypatch.setenv("MOOSE_TPU_SERVE_MAX_WAIT_MS", "7.5")
    monkeypatch.setenv("MOOSE_TPU_SERVE_QUEUE", "9")
    config = ServingConfig.from_env()
    assert config.max_batch == 32
    assert config.max_wait_ms == 7.5
    assert config.queue_bound == 9
    # explicit overrides (CLI flags) win over env
    assert ServingConfig.from_env(max_batch=4).max_batch == 4
    monkeypatch.setenv("MOOSE_TPU_SERVE_MAX_BATCH", "zero")
    with pytest.raises(ConfigurationError):
        ServingConfig.from_env()


@pytest.mark.parametrize("dtype_name", ("ring64", "ring128"))
@pytest.mark.parametrize("kind", ("logreg", "mlp"))
def test_padded_batch_rows_bit_exact(fixed_keys, kind, dtype_name):
    """Coalesced and padded serving rows are bitwise identical to a
    direct evaluation of the same padded bucket: the batcher adds
    nothing.  (The same against the JAX package's evaluation: see the
    module docstring.)"""
    x = np.random.default_rng(5).normal(size=(3, FEATURES))
    before = dict(rk.LAUNCHES)
    with _server(_model(kind), dtype=DTYPES[dtype_name][1],
                 buckets=(4,)) as server:
        futures = [server.submit("m", x[i]) for i in range(3)]
        got = np.concatenate([f.result(timeout=120) for f in futures])
    assert rk.LAUNCHES == before  # the CPU runs the plain versions
    registered = server.registry.get("m")
    want = _direct_rows(registered, x)[:3]  # 3 rows pad to bucket 4
    np.testing.assert_array_equal(got, want)
    if dtype_name == "ring128":  # full precision also matches sklearn
        sk = _onnx(kind)[1]
        np.testing.assert_allclose(
            got, sk.predict_proba(x), atol=5e-3 if kind == "logreg" else 2e-2
        )
    snap = server.metrics_snapshot()
    assert snap["batches"] == 1
    assert snap["batch_size_hist"] == {4: 1}
    assert snap["batch_fill_ratio"] == pytest.approx(0.75)


def test_padding_content_never_contaminates(fixed_keys):
    """Same bucket, same keys, different padding garbage: the real rows
    do not move by a single bit."""
    server = _server(_model("logreg"), buckets=(4,))
    registered = server.registry.get("m")
    server.close()
    x = RNG.normal(size=(3, FEATURES))
    zeros = np.zeros((4, FEATURES))
    zeros[:3] = x
    garbage = np.full((4, FEATURES), 1e6)
    garbage[:3] = x
    a = _direct_rows(registered, zeros)
    b = _direct_rows(registered, garbage)
    np.testing.assert_array_equal(a[:3], b[:3])


def test_single_request_unpadded_vs_batch_row(fixed_keys):
    """A lone request runs at bucket 1, genuinely unpadded, and is
    bitwise equal to direct single-request evaluation; the same row
    served inside a padded batch agrees within the protocol's
    truncation noise (shape-dependent mask draws)."""
    model = _model("logreg")
    x = RNG.normal(size=(3, FEATURES))
    with _server(model, max_wait_ms=0.0, buckets=(1, 4)) as server:
        solo = server.predict("m", x[0])
    np.testing.assert_array_equal(
        solo, _direct_rows(server.registry.get("m"), x[0:1])
    )
    with _server(model, buckets=(1, 4)) as server2:
        futures = [server2.submit("m", x[i]) for i in range(3)]
        batched = np.concatenate([f.result(timeout=120) for f in futures])
    # cross-shape: bounded by truncation noise, far below contamination
    assert np.abs(batched[0] - solo[0]).max() <= 64 * 2.0 ** -40


def test_ragged_final_batch_bit_exact(fixed_keys):
    """A 3-row + 2-row request stream against max_batch=4: the 2-row
    request cannot ride the first batch (whole requests only), so the
    scheduler dispatches a ragged bucket-4 batch then a full bucket-2
    batch; each is bitwise equal to its direct padded evaluation."""
    model = _model("logreg")
    x = RNG.normal(size=(5, FEATURES))
    with _server(model, buckets=(2, 4)) as server:
        f1 = server.submit("m", x[:3])
        f2 = server.submit("m", x[3:])
        got1 = f1.result(timeout=120)
        got2 = f2.result(timeout=120)
    registered = server.registry.get("m")
    np.testing.assert_array_equal(got1, _direct_rows(registered, x[:3])[:3])
    np.testing.assert_array_equal(got2, _direct_rows(registered, x[3:])[:2])
    snap = server.metrics_snapshot()
    assert snap["batches"] == 2
    assert snap["batch_size_hist"] == {4: 1, 2: 1}
    assert snap["batch_fill_ratio"] == pytest.approx((0.75 + 1.0) / 2)


def test_expired_request_never_contaminates_batch(fixed_keys):
    """A request whose deadline expired in queue is completed with
    DeadlineExceededError, occupies no batch rows, and the surviving
    request's result is bitwise identical to serving it alone."""
    model = _model("logreg")
    x = RNG.normal(size=(2, FEATURES))
    with _server(model, buckets=(1, 4)) as server:
        dead = server.submit("m", x[0], deadline_ms=0.0)
        live = server.submit("m", x[1])
        with pytest.raises(DeadlineExceededError):
            dead.result(timeout=120)
        got = live.result(timeout=120)
    registered = server.registry.get("m")
    # the survivor rode a bucket-1 batch ALONE: bit-equal to the direct
    # single-row evaluation (had the expired row contaminated the
    # batch, the bucket — and every mask draw — would differ)
    np.testing.assert_array_equal(got, _direct_rows(registered, x[1:2]))
    snap = server.metrics_snapshot()
    assert snap["deadline_drops"] == 1
    assert snap["batch_size_hist"] == {1: 1}


def test_overload_raises_typed_error_not_hang():
    model = _model("logreg")
    server = _server(model, queue_bound=2, max_wait_ms=0.0, buckets=(1,))
    x = RNG.normal(size=(1, FEATURES))
    # stall the dispatcher mid-batch so the queue backs up
    with server.registry.eval_lock:
        futures = [server.submit("m", x)]
        # the dispatcher may pop the first request before blocking on
        # the eval lock; fill the queue to its bound behind it
        deadline = time.perf_counter() + 5.0
        rejected = None
        while time.perf_counter() < deadline:
            try:
                futures.append(server.submit("m", x))
            except ServerOverloadedError as e:
                rejected = e
                break
        assert rejected is not None, "queue never hit its bound"
    # released: everything admitted must still complete
    for future in futures:
        assert future.result(timeout=120).shape == (1, 2)
    assert server.metrics_snapshot()["overloads"] >= 1
    server.close()


def test_no_retrace_after_warmup():
    """Warm-registry acceptance: post-registration traffic never
    re-traces; each bucket warmed until its plan settled (one evaluation
    for a plan that does not validate), and its report names the plan's
    state and mode as ``runtime.last_plan`` gives them."""
    model = _model("logreg")
    with _server(model, buckets=(4,)) as server:
        x = RNG.normal(size=(4, FEATURES))
        for _ in range(3):
            futures = [server.submit("m", x[i]) for i in range(4)]
            for future in futures:
                future.result(timeout=120)
    snap = server.metrics_snapshot()
    assert snap["batches"] >= 1
    assert snap["retraces_after_warm"] == 0
    # the batcher keeps no validating_after_warm counter
    assert "validating_after_warm" not in snap
    assert snap["deadline_misses"] == 0
    warm = snap["models"]["m"]["warmup"]["4"]
    assert set(warm) == {"evals", "plan_state", "plan_mode", "eval_s",
                         "layout", "lowered"}
    # the tests' MOOSE_TPU_JIT=0: the eager plan, which never validates
    assert warm["evals"] == 1
    assert warm["plan_state"] == "static" and warm["plan_mode"] == "eager"
    assert warm["layout"] == "stacked" and warm["lowered"] is False
    assert warm["eval_s"] > 0


def test_unknown_model_and_shape_validation():
    model = _model("logreg")
    with _server(model, buckets=(1, 4)) as server:
        with pytest.raises(ConfigurationError):
            server.submit("nope", np.zeros((1, FEATURES)))
        with pytest.raises(ConfigurationError):
            server.submit("m", np.zeros((1, 7)))  # wrong row shape
        with pytest.raises(ConfigurationError):
            server.submit("m", np.zeros((9, FEATURES)))  # > max bucket


def test_predictor_factory_memoized_no_retrace():
    """Repeated predictor_factory calls return the SAME
    AbstractComputation, so runtimes skip re-tracing entirely; the
    traced computation is memoized beside it and serializes to the JAX
    package's bytes."""
    from moose_tpu import serde as jserde

    from moose_tpu_torch import serde as tserde

    model = predictors.from_onnx(_onnx("logreg")[0])
    ring64 = DTYPES["ring64"][1]
    comp_a = model.predictor_factory()
    comp_b = model.predictor_factory()
    assert comp_a is comp_b
    assert model.predictor_factory(ring64) is model.predictor_factory(ring64)
    assert comp_a is not model.predictor_factory(ring64)
    traced = model.traced_predictor()
    assert traced is model.traced_predictor()
    assert model.traced_predictor(ring64) is not traced
    assert tserde.serialize_computation(traced) == \
        jserde.serialize_computation(
            jfrom_onnx(_onnx("logreg")[0]).traced_predictor())

    rt = LocalMooseRuntime(IDS, device="cpu")
    x = np.zeros((2, FEATURES))
    rt.evaluate_computation(model.predictor_factory(), {"x": x})
    assert "trace" in rt.last_timings  # first eval traces once...
    rt.evaluate_computation(model.predictor_factory(), {"x": x})
    assert "trace" not in rt.last_timings  # ...fresh factory call: hit


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


def test_blitzen_http_metrics_endpoints():
    """GET /metrics serves Prometheus text from the unified registry
    (queue-depth gauge refreshed at scrape) while /v1/metrics keeps the
    JSON snapshot; /debug/profile answers a bounded capture (once ROADMAP
    item 13b's 501)."""
    from moose_tpu_torch.bin.blitzen import _make_handler

    config = ServingConfig(max_batch=4, max_wait_ms=1.0, queue_bound=8)
    with InferenceServer(config=config, device="cpu") as server:
        server.register_model(
            "logreg", _model("logreg"), row_shape=(FEATURES,),
            buckets=(1,),
        )
        server.predict("logreg", RNG.normal(size=(FEATURES,)),
                       timeout_s=120.0)
        httpd, base = _serve(_make_handler(server))
        try:
            text = urllib.request.urlopen(
                f"{base}/metrics", timeout=10
            ).read().decode()
            assert "# TYPE moose_tpu_serving_batches_total counter" in text
            assert 'moose_tpu_serving_queue_depth{model="logreg"}' in text
            assert "moose_tpu_serving_request_latency_seconds_bucket" in (
                text
            )
            snap = json.loads(urllib.request.urlopen(
                f"{base}/v1/metrics", timeout=10
            ).read())
            assert snap["rows_served"] >= 1
            # a bounded capture: the Perfetto JSON of the profiler
            trace = json.loads(urllib.request.urlopen(
                f"{base}/debug/profile?seconds=0.05", timeout=30).read())
            assert "traceEvents" in trace
            assert trace["otherData"]["recorder"] == (
                "moose_tpu_torch.profiling")
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_blitzen_oneshot(tmp_path):
    raw, sk = _onnx("logreg")
    onnx_path = tmp_path / "logreg.onnx"
    onnx_path.write_bytes(raw)
    from moose_tpu_torch.bin import blitzen

    x = RNG.normal(size=(2, FEATURES))
    request = json.dumps({"model": "logreg", "x": x.tolist()})
    buf = io.StringIO()
    with redirect_stdout(buf):
        blitzen.main([
            f"logreg={onnx_path}", "--features", f"logreg={FEATURES}",
            "--max-batch", "2", "--device", "cpu", "--oneshot", request,
        ])
    payload = json.loads(buf.getvalue())
    np.testing.assert_allclose(
        np.asarray(payload["y"]), sk.predict_proba(x), atol=5e-3
    )


def test_register_arg_ranges_gate(fixed_keys):
    """The registration-time MSA7xx overflow gate: declared input
    dynamics the fixed-point encoding cannot hold are rejected at the
    door, with the JAX package's diagnostics; sane dynamics register and
    serve normally."""
    model = _model("logreg")
    server = InferenceServer(
        config=ServingConfig.from_env(max_batch=2, queue_bound=8),
        device="cpu",
    )
    with pytest.raises(MalformedComputationError) as exc_info:
        server.register_model(
            "hot", model, row_shape=(FEATURES,),
            arg_ranges={"x": (-1e15, 1e15)},
        )
    assert any(d.rule == "MSA701" for d in exc_info.value.diagnostics)
    assert "hot" not in server.registry.names()
    # the JAX registry runs the same gate (largest bucket 2) and raises
    # the same diagnostics
    with pytest.raises(JaxMalformed) as jax_info:
        jlint_check(
            jfrom_onnx(_onnx("logreg")[0]).traced_predictor(),
            analyses=["ranges"],
            context={"arg_specs": {"x": (2, FEATURES)},
                     "arg_ranges": {"x": (-1e15, 1e15)}},
        )
    assert [(d.rule, d.op, d.message) for d in exc_info.value.diagnostics] \
        == [(d.rule, d.op, d.message) for d in jax_info.value.diagnostics]

    # declared unit-range inputs fit fixed(24,40)/ring128 comfortably
    server.register_model(
        "ok", model, row_shape=(FEATURES,), arg_ranges={"x": (-1.0, 1.0)},
    )
    out = server.submit("ok", RNG.uniform(-1, 1, size=(FEATURES,))).result(
        timeout=120
    )
    assert np.asarray(out).shape[-1] == 2  # both class columns
    server.close()


def test_entry_points_default_to_the_card():
    """Without a card an InferenceServer (and blitzen's) raises unless it
    is given device="cpu" or a CPU runtime."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        InferenceServer()
    runtime = LocalMooseRuntime(IDS, device="cpu")
    server = InferenceServer(runtime=runtime)
    assert server.registry.runtime is runtime
    server.close()
    assert InferenceServer(device="cpu").registry.runtime.device.type == \
        "cpu"


def test_scheduler_thread_carries_the_process_state(monkeypatch):
    """The batcher's scheduler thread, not the caller, evaluates: the
    process's PRF choice, draw ledger and launch counters see its work,
    and its telemetry spans fill the runtime's ``last_timings``.  Under
    threefry-pallas and fixed keys a served bucket equals a direct
    evaluation under the same stream, and the ledger a request records
    on the caller's thread is the direct evaluation's, draw for draw."""
    from moose_tpu_torch.dialects import ring
    from moose_tpu_torch.execution import drawledger

    from torch_parity import prf

    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "serving-thread")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")
    x = RNG.normal(size=(4, FEATURES))
    with prf("threefry-pallas"), _server(_model("logreg"),
                                         buckets=(4,)) as server:
        before = dict(rk.LAUNCHES)
        with drawledger.recording() as served_ledger:
            got = server.predict("m", x)
        assert rk.LAUNCHES == before  # the CPU runs the plain versions
        assert "execute" in server.registry.runtime.last_timings
        with drawledger.recording() as direct_ledger:
            want = _direct_rows(server.registry.get("m"), x)
        assert ring.get_prf_impl() == "threefry-pallas"
    np.testing.assert_array_equal(got, want)
    assert served_ledger.stacked_trace() == direct_ledger.stacked_trace()
    assert served_ledger.stacked_trace()
