"""The port's timeline profiler (``moose_tpu_torch/profiling.py``) held
against the JAX package's: the same sequence of phases, records and
telemetry spans gives the same Perfetto events (names, categories,
args, nesting and trace ids; times and span ids excluded), the
``/debug/profile`` endpoint's answers (200, 409 busy, 400 bad
parameter), ``fence`` off the profile, and the serving batcher's
``serve_queue_wait`` / ``serve_compute`` records."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from moose_tpu import profiling as jprofiling
from moose_tpu import telemetry as jtelemetry
from moose_tpu_torch import metrics, profiling, telemetry

TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
PARENT = "b7ad6b7169203331"


@pytest.fixture(autouse=True)
def no_capture():
    """No capture left running by (or into) a test, in either package."""
    for mod in (jprofiling, profiling):
        mod.stop()
    yield
    for mod in (jprofiling, profiling):
        mod.stop()


def _sequence(prof_mod, tel_mod):
    """One session's worth of hooks: spans (through the span hook),
    phases nested in them, a record measured elsewhere and an instant,
    under one propagated trace context."""
    prof_mod.start()
    ctx = tel_mod.TraceContext(TRACE_ID, PARENT)
    with tel_mod.use_context(ctx):
        with tel_mod.span("execute_role", party="alice", steps=3):
            with tel_mod.span("worker_segment", party="alice", segment=0,
                              ops=12, mode="eager"):
                with prof_mod.phase("segment_execute", segment=0, ops=12):
                    prof_mod.fence({"x": 1})
            with prof_mod.phase("net_send", receiver="bob", payloads=2):
                with prof_mod.phase("serde", direction="tx", payloads=2):
                    time.sleep(0.001)
            t0 = time.perf_counter()
            time.sleep(0.001)
            prof_mod.record_complete("serve_queue_wait", t0,
                                     time.perf_counter(), model="m")
            prof_mod.record_instant("pallas_dispatch", kernel="ring_mul")
            with prof_mod.phase("host_transfer", outputs=1, saves=0):
                pass
    return prof_mod.stop()


def _structure(trace):
    """Each event without its times, pid/tid and random span id, plus the
    name of its innermost enclosing complete event."""
    events = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    spans = [e for e in events if e["ph"] == "X"]
    out = []
    for e in events:
        parents = [
            p for p in spans
            if p is not e and p["ts"] <= e["ts"]
            and e["ts"] + e.get("dur", 0) <= p["ts"] + p["dur"]
        ]
        parent = min(parents, key=lambda p: p["dur"])["name"] \
            if parents else None
        args = dict(e["args"])
        if "span_id" in args:
            assert len(args.pop("span_id")) == 16
        out.append((e["name"], e["cat"], e["ph"], e.get("s"),
                    sorted(args.items()), parent))
    return sorted(out, key=repr)


def test_the_same_phases_give_the_reference_s_events():
    want = _sequence(jprofiling, jtelemetry)
    got = _sequence(profiling, telemetry)
    assert _structure(got) == _structure(want)
    assert {e["args"].get("trace_id") for e in got["traceEvents"]
            if e["ph"] == "X"} == {TRACE_ID}
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    assert set(got["otherData"]) == set(want["otherData"])
    names = [e for e in got["traceEvents"] if e["ph"] == "M"]
    assert names and all(e["name"] == "thread_name" for e in names)
    assert profiling.active() is None


def test_summary_and_phase_histogram():
    prof = profiling.start()
    for _ in range(3):
        with profiling.phase("serde", direction="rx"):
            pass
    summary = prof.summary()
    profiling.stop()
    assert summary["serde"]["count"] == 3
    snap = metrics.REGISTRY.snapshot()
    assert any("moose_tpu_phase_seconds" in key for key in snap)


def test_busy_and_bad_parameter_answers():
    profiling.start()
    try:
        status, body = profiling.handle_profile_request("seconds=0.05")
        assert status == 409 and body["error"] == "ProfilerBusyError"
        with pytest.raises(profiling.ProfilerBusyError):
            profiling.start()
    finally:
        profiling.stop()
    status, body = profiling.handle_profile_request("seconds=soon")
    assert status == 400 and body["error"] == "ValueError"
    status, body = profiling.handle_profile_request("seconds=0.05")
    assert status == 200 and "traceEvents" in body


def test_metrics_server_debug_profile():
    """The metrics port's ``/debug/profile``: a capture (200, the
    Perfetto JSON), 409 while another capture runs, 400 on a bad
    parameter."""
    server = metrics.serve_http(0)
    base = f"http://127.0.0.1:{server.port}/debug/profile"
    try:
        body = json.loads(urllib.request.urlopen(
            f"{base}?seconds=0.05", timeout=30).read())
        assert "traceEvents" in body
        profiling.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as info:
                urllib.request.urlopen(f"{base}?seconds=0.05", timeout=30)
            assert info.value.code == 409
        finally:
            profiling.stop()
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(f"{base}?seconds=x", timeout=30)
        assert info.value.code == 400
    finally:
        server.close()


def test_fence_does_nothing_when_the_profiler_is_off(monkeypatch):
    """Off the profile no stream is touched; on it, only CUDA tensors'
    streams are (a CPU tensor needs no wait)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: calls.append(a))
    value = {"t": torch.zeros(3), "pair": (torch.ones(2), None)}
    assert profiling.active() is None
    profiling.fence(value)
    profiling.start()
    try:
        profiling.fence(value)
    finally:
        profiling.stop()
    assert calls == []
    # no device annotation is opened off the card
    assert profiling._device_annotation("execute") is None


def test_phase_off_costs_one_check():
    """With no capture a phase records nothing anywhere."""
    prof = profiling.start()
    profiling.stop()
    with profiling.phase("execute"):
        pass
    profiling.record_complete("serve_queue_wait", 0.0, 1.0)
    profiling.record_instant("pallas_dispatch")
    assert prof.summary() == {}


def test_the_batcher_records_queue_wait_and_compute():
    from moose_tpu_torch.serving import InferenceServer, ServingConfig
    from test_torch_serving import FEATURES, _model

    config = ServingConfig(max_batch=2, max_wait_ms=1.0, queue_bound=8)
    with InferenceServer(config=config, device="cpu") as server:
        server.register_model("logreg", _model("logreg"),
                              row_shape=(FEATURES,), buckets=(1, 2))
        rows = np.random.default_rng(2).normal(size=(2, FEATURES))
        profiling.start()
        try:
            threads = [
                threading.Thread(target=server.predict, args=(
                    "logreg", row), kwargs={"timeout_s": 30.0})
                for row in rows
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
        finally:
            trace = profiling.stop()
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    waits = [e for e in events if e["name"] == "serve_queue_wait"]
    computes = [e for e in events if e["name"] == "serve_compute"]
    assert len(waits) == 2
    assert all(e["args"]["model"] == "logreg" for e in waits)
    assert computes and all(
        e["args"]["model"] == "logreg" and e["args"]["bucket"] in (1, 2)
        for e in computes)
    assert {e["name"] for e in events} >= {"serve_batch", "execute"}
