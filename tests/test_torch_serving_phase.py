"""``chip_smoke.py``'s phase 22, secure-inference serving, at a small
size on the CPU (8 features, ``max_batch=8``): the warm-up over the
autotuned ladder, a burst of requests from several threads and one
large request within phase 6's limit, one fixed-keys batch word-equal to
a direct evaluation of its bucket, blitzen's readiness, predict,
``/metrics`` and 429, donner routing around a drained replica, a hot
swap under traffic and a control-plane promote, and a snapshot restored
into a fresh server that serves its first request word-equal and
without a re-trace."""

import sys
from pathlib import Path

import numpy as np
import torch

from moose_tpu_torch.compilation import autotune
from moose_tpu_torch.dialects import ring
from moose_tpu_torch.native import ring_kernels as rk

import moose_tpu_torch as tm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def test_phase22_runs_small_on_the_cpu(monkeypatch):
    for name, value in (("SERVE_FEATURES", 8), ("SERVE_MAX_BATCH", 8),
                        ("SERVE_BURST", ((4, 1), (3, 1), (1, 2))),
                        ("SERVE_THREADS", 2), ("SERVE_BIG", 3),
                        ("SERVE_QUEUE", 4), ("SERVE_PROBE_ROWS", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    saved = autotune.measurements().snapshot()
    autotune.measurements().clear()
    try:
        rng = np.random.default_rng(chip_smoke.SEED)
        classifier = chip_smoke.logistic_regression(rng, 8)
        weights = rng.normal(scale=0.1, size=(8, 1))
        assert ring.get_prf_impl() == "threefry"
        record, launches = chip_smoke.run_serving(
            torch, rk, tm, classifier, weights, rng, card="cpu",
            device="cpu")
    finally:
        autotune.measurements().clear()
        autotune.measurements().load(saved)
    assert record["warmup"]["buckets"] == [1, 2, 4, 8]
    assert record["warmup"]["source"] == "default"
    # the eager plan of the tests' MOOSE_TPU_JIT=0, which never validates
    assert record["warmup"]["plan_state"] == ["static"]
    assert record["burst"]["rows"] == 9
    assert record["burst"]["max_abs_err"] < chip_smoke.LOGREG_TOL
    assert record["fixed_batch"]["equal_to_direct"] == {"cpu": True}
    tol = chip_smoke.LOGREG_TOL
    assert record["http"]["predict_max_abs_err"] < tol
    assert record["http"]["predict_vs_burst_rows"] < tol
    assert record["http"]["flood"]["429"] >= 1
    assert record["http"]["drain_readyz"] == 503
    assert record["routing"]["retry_attempts"] == 2
    assert record["routing"]["b_ejected"]
    for key in ("routed_max_abs_err", "retry_max_abs_err",
                "after_ejection_max_abs_err"):
        assert record["routing"][key] < tol
    assert record["hot_swap"]["failed"] == 0
    assert record["hot_swap"]["promote"]["promoted"]
    assert record["snapshot"]["first_request_equal"]
    assert record["snapshot"]["retraced"] is False
    assert record["snapshot"]["aot"] == {
        str(b): "unsupported:plan-eager-stacked" for b in (1, 2, 4, 8)}
    # the CPU runs the plain versions: no kernel launches on any path
    assert set(launches) == {
        "serving_burst", "serving_big_request", "serving_fixed_batch",
        "serving_http", "serving_routed", "serving_hot_swap",
        "serving_canary", "serving_snapshot_request"}
    assert not any(v for counts in launches.values() for v in counts.values())
