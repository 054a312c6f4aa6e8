"""The port's plan autotuner, serving's part (``moose_tpu_torch/
compilation/autotune.py``), against the JAX package's.

``serving_bucket_plan`` returns the JAX package's ``Decision`` for the
same measurements and environment: pruned, full (measured and scaling),
disabled, and too few rows.  The measurement store round-trips its
snapshot and file, in the JAX package's format.  Every other name of the
reference's ``__all__`` (the plan decisions, once ROADMAP item 13b) is
ported and gives the reference's result on a canonical call;
``tests/test_torch_autotune_plan.py`` holds them under every knob.  So
does ``schedule.worker_min_seg_decision``."""

import json

import pytest

from moose_tpu.compilation import autotune as jautotune

from moose_tpu_torch.compilation import autotune
from moose_tpu_torch.compilation.analysis import schedule

PACKAGES = (jautotune, autotune)

# (bucket -> eval_s) rows, each a case of the ladder decision
LATENCIES = {
    "none": {},
    "too-few-rows": {8: 0.010},
    "pruned": {8: 0.010, 16: 0.0101, 32: 0.020},
    "all-flat": {1: 0.01, 2: 0.0101, 4: 0.0102, 8: 0.0103, 16: 0.0104,
                 32: 0.0105},
    "scaling": {1: 0.001, 2: 0.002, 4: 0.004, 8: 0.008, 16: 0.016,
                32: 0.032},
    "zero-rows": {8: 0.0, 16: 0.0},
}


@pytest.fixture(autouse=True)
def clean_autotune(monkeypatch):
    """Each test sees MOOSE_TPU_AUTOTUNE unset and both packages'
    measurement stores empty; what was there before is restored."""
    monkeypatch.delenv("MOOSE_TPU_AUTOTUNE", raising=False)
    saved = [pkg.measurements().snapshot() for pkg in PACKAGES]
    for pkg in PACKAGES:
        pkg.measurements().clear()
    yield
    for pkg, snap in zip(PACKAGES, saved):
        pkg.measurements().clear()
        pkg.measurements().load(snap)


def _record(rows):
    for pkg in PACKAGES:
        for bucket, lat in rows.items():
            pkg.measurements().record(
                "bucket_latency", 0, str(bucket), eval_s=lat,
            )


@pytest.mark.parametrize("disabled", (False, True),
                         ids=("enabled", "disabled"))
@pytest.mark.parametrize("max_batch", (1, 6, 32))
@pytest.mark.parametrize("case", sorted(LATENCIES))
def test_serving_bucket_plan_is_the_jax_package_s(monkeypatch, case,
                                                   max_batch, disabled):
    if disabled:
        monkeypatch.setenv("MOOSE_TPU_AUTOTUNE", "0")
    _record(LATENCIES[case])
    got = autotune.serving_bucket_plan(max_batch)
    want = jautotune.serving_bucket_plan(max_batch)
    assert isinstance(got, autotune.Decision)
    assert (got.knob, got.choice, got.source, got.why) == \
        (want.knob, want.choice, want.source, want.why)
    assert got.as_dict() == want.as_dict()
    assert autotune.autotune_enabled() is jautotune.autotune_enabled()


def test_serving_bucket_plan_prunes_flat_latencies():
    # default ladder when no measurements
    d0 = autotune.serving_bucket_plan(32)
    assert d0.source == "default" and d0.choice[-1] == 32
    # flat 8-vs-16: 8 pruned; 16-vs-32 scales: 16 kept
    _record(LATENCIES["pruned"])
    d1 = autotune.serving_bucket_plan(32)
    assert d1.source == "measured"
    assert 8 not in d1.choice and 16 in d1.choice and 32 in d1.choice


def test_plan_autotune_table_is_the_jax_package_s():
    decisions = [
        ("serving_buckets", [1, 2], "default", "no signal"),
        ("coalesce", True, "predicted", "send_many"),
    ]
    got = autotune.PlanAutotune(
        [autotune.Decision(*d) for d in decisions])
    want = jautotune.PlanAutotune(
        [jautotune.Decision(*d) for d in decisions])
    assert got.as_dict() == want.as_dict()
    assert got["coalesce"].choice is True
    assert got.get("nope") is None and got.choice("nope", 7) == 7
    with pytest.raises(KeyError):
        got["nope"]


def test_measurements_snapshot_roundtrip(tmp_path):
    """The store round-trips its snapshot, and a file the JAX package's
    store would load gives the port the same rows and the same plan."""
    m = autotune.measurements()
    m.record("bucket_latency", 0, "8", eval_s=0.5)
    m.record("dot_cross_terms", 128, "mxu", pallas_s=1.5, xla_s=2.5)
    snap = m.snapshot()
    m.clear()
    assert m.get("dot_cross_terms", 128, "mxu") is None
    m.load(snap)
    assert m.get("dot_cross_terms", 128, "mxu") == {
        "pallas_s": 1.5, "xla_s": 2.5,
    }
    path = tmp_path / "measurements.json"
    path.write_text(json.dumps(snap))
    jautotune.measurements().load_file(str(path))
    assert jautotune.measurements().snapshot() == snap
    autotune.measurements().clear()
    autotune.measurements().load_file(str(path))
    assert autotune.measurements().snapshot() == snap
    _record({16: 0.5})
    assert autotune.serving_bucket_plan(16).as_dict() == \
        jautotune.serving_bucket_plan(16).as_dict()


def test_registration_records_the_bucket_latency():
    """A registration's warm-up records a ``bucket_latency`` row per
    bucket, and a later plan prunes from those rows as the reference
    does."""
    import numpy as np

    from moose_tpu_torch import predictors
    from moose_tpu_torch.serving import InferenceServer, ServingConfig
    from moose_tpu_torch.training.export import logreg_onnx_bytes

    model = predictors.from_onnx(logreg_onnx_bytes(np.ones((3, 1))))
    with InferenceServer(
        config=ServingConfig(max_batch=2), device="cpu"
    ) as server:
        server.register_model("m", model, row_shape=(3,))
        assert server.registry.get("m").buckets == (1, 2)
    for bucket in (1, 2):
        row = autotune.measurements().get("bucket_latency", 0, str(bucket))
        assert row["eval_s"] > 0
    decision = autotune.serving_bucket_plan(2)
    assert decision.source == "measured"


# the reference's on-demand dot micro, which the port leaves out: its
# dispatch never measures on demand (compilation/autotune.py)
NOT_PORTED = ("ensure_dot_measurement",)

# every name of the reference's __all__ beyond serving's part (ROADMAP
# item 13b, now ported)
ITEM_13B = sorted(set(jautotune.__all__) - set(NOT_PORTED) - {
    "Decision", "PlanAutotune", "Measurements", "measurements",
    "autotune_enabled", "serving_bucket_plan", "reset_cache",
})

# a canonical call of each decision function, on arguments both
# packages take (the two micro functions need the card, and are held in
# test_torch_autotune_plan.py)
CANONICAL = {
    "autotune_plan": lambda mod, comp: mod.autotune_plan(
        comp, est_ops=2500).as_dict(),
    "segment_limit_for": lambda mod, _: mod.segment_limit_for(2500),
    "worker_min_seg_for": lambda mod, _: mod.worker_min_seg_for((2, 3, 40)),
    "coalesce_decision": lambda mod, _: mod.coalesce_decision(),
    "pallas_family_decision": lambda mod, _: mod.pallas_family_decision(),
    "dot_shape_class": lambda mod, _: mod.dot_shape_class(1024, 100, 1),
    "dot_kernel_decision": lambda mod, _: mod.dot_kernel_decision(
        128, (512, 512, 128)),
    "dot_kernel_wanted": lambda mod, _: mod.dot_kernel_wanted(
        128, (128, 100, 2)),
    "dot_decision_table": lambda mod, _: mod.dot_decision_table(),
    "reset_dot_decisions": lambda mod, _: mod.reset_dot_decisions(),
    "transport_choice": lambda mod, _: mod.transport_choice(
        ("alice", "bob"), ("alice",)),
}


def test_the_port_exports_the_reference_s_names():
    assert autotune.__all__ == [n for n in jautotune.__all__
                                if n not in NOT_PORTED]
    assert ITEM_13B and all(hasattr(autotune, n) for n in ITEM_13B)
    assert not any(hasattr(autotune, n) for n in NOT_PORTED)
    autotune.reset_cache()


def _plain(value):
    if isinstance(value, (autotune.Decision, jautotune.Decision)):
        return (value.knob, value.choice, value.source, value.why)
    return value


@pytest.mark.parametrize("name", ITEM_13B + [
    "coalesce_decision", "pallas_family_decision", "dot_kernel_decision",
])
def test_other_decisions_name_item_13b(name):
    """Each decision of ROADMAP item 13b is ported: the reference's
    result on a canonical call (the micros: nothing measured without a
    card)."""
    if name == "measure_dot_micro":
        assert autotune.measure_dot_micro(64, "tall", device="cpu") is None
        return
    from torch_parity import traced_pair

    jcomp, tcomp = traced_pair("secure_dot")
    for mod in PACKAGES:
        mod.reset_dot_decisions()
    try:
        assert _plain(CANONICAL[name](autotune, tcomp)) == _plain(
            CANONICAL[name](jautotune, jcomp))
    finally:
        for mod in PACKAGES:
            mod.reset_dot_decisions()
            mod.reset_cache()


def test_worker_min_seg_decision_keeps_raising():
    """No longer raising: the decision for a lowered graph is the
    reference's."""
    from moose_tpu.compilation.analysis import schedule as jschedule
    from torch_parity import lowered_pair

    jl, tl, _, _ = lowered_pair("rep_sigmoid")
    assert _plain(schedule.worker_min_seg_decision(tl)) == _plain(
        jschedule.worker_min_seg_decision(jl))
