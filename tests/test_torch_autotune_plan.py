"""The port's plan autotuner (``moose_tpu_torch/compilation/autotune.py``)
held against the JAX package's: every decision function under each
override knob and each injected measurement row, the per-computation
decision table of the secure dot, config 3's logistic regression and a
trainer's epoch graph, and the worker's eager-floor decision.  All are
pure functions of (computation, measurements, environment), so the
comparisons are exact."""

import numpy as np
import pytest

import moose_tpu as jm
import moose_tpu_torch as tm
from moose_tpu.compilation import autotune as jautotune
from moose_tpu.compilation.analysis import schedule as jschedule
from moose_tpu.predictors import trainers as jtrainers
from moose_tpu_torch.compilation import autotune
from moose_tpu_torch.compilation.analysis import schedule
from moose_tpu_torch.predictors import trainers as ttrainers

from torch_parity import load_chip_smoke, lowered_pair, traced_pair

KNOBS = ("MOOSE_TPU_AUTOTUNE", "MOOSE_TPU_JIT_SEGMENT",
         "MOOSE_TPU_WORKER_MIN_SEG", "MOOSE_TPU_PALLAS",
         "MOOSE_TPU_PALLAS_DOT", "MOOSE_TPU_FABRIC")


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    """No knob from the environment, and empty measurement stores, plan
    caches and dot tables in both packages, before and after."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def clear():
        for mod in (jautotune, autotune):
            mod.measurements().clear()
            mod.reset_cache()
            mod.reset_dot_decisions()

    clear()
    yield
    clear()


def _record(rows):
    for kind, width, detail, values in rows:
        for mod in (jautotune, autotune):
            mod.measurements().record(kind, width, detail, **values)


def _same(want, got):
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, jautotune.Decision):
        assert (got.knob, got.choice, got.source, got.why) == (
            want.knob, want.choice, want.source, want.why)
    else:
        assert got == want


# (function, args, kwargs) of each decision, at the inputs that reach
# each of its branches
CALLS = {
    "segment_limit_small": ("segment_limit_for", (100,), {}),
    "segment_limit_2100": ("segment_limit_for", (2100,), {}),
    "segment_limit_9000": ("segment_limit_for", (9000,), {}),
    "min_seg_none": ("worker_min_seg_for", ((),), {}),
    "min_seg_tiny": ("worker_min_seg_for", ((3, 3, 5, 40, 2),), {}),
    "min_seg_large": ("worker_min_seg_for", ((20, 30, 40, 3),), {}),
    "coalesce": ("coalesce_decision", (), {}),
    "coalesce_saved": ("coalesce_decision", ({"envelopes_saved": 7},),
                       {}),
    "pallas_128": ("pallas_family_decision", (128,), {}),
    "pallas_64": ("pallas_family_decision", (64,), {}),
    "dot_none": ("dot_kernel_decision", (128, None), {}),
    "dot_mxu": ("dot_kernel_decision", (128, (512, 512, 128)), {}),
    "dot_tall": ("dot_kernel_decision", (128, (1024, 128, 8)), {}),
    "dot_small": ("dot_kernel_decision", (64, (128, 100, 2)), {}),
    "transport_none": ("transport_choice", (), {}),
    "transport_covered": ("transport_choice", (
        ("alice", "bob", "carole"), ("alice", "bob")), {}),
    "transport_partial": ("transport_choice", (
        ("alice", "bob"), ("alice", "bob", "carole")), {}),
    "transport_priced": ("transport_choice", (
        ("alice", "bob"), ("alice", "bob"),
        {"fabric_bytes": 900.0, "grpc_bytes": 400.0}), {}),
}
ENVS = {
    "default": {},
    "autotune-off": {"MOOSE_TPU_AUTOTUNE": "0"},
    "overrides": {"MOOSE_TPU_JIT_SEGMENT": "64",
                  "MOOSE_TPU_WORKER_MIN_SEG": "9",
                  "MOOSE_TPU_PALLAS": "1", "MOOSE_TPU_PALLAS_DOT": "0",
                  "MOOSE_TPU_FABRIC": "1"},
    "overrides-off": {"MOOSE_TPU_JIT_SEGMENT": "0",
                      "MOOSE_TPU_PALLAS": "0", "MOOSE_TPU_PALLAS_DOT": "1",
                      "MOOSE_TPU_FABRIC": "0"},
}
ROWS = {
    "no-rows": [],
    "kernels-win": [
        ("fx_mul", 128, "default", {"pallas_s": 1e-4, "xla_s": 3e-4}),
        ("msb", 128, "default", {"pallas_s": 2e-4, "xla_s": 1e-4}),
        ("fx_sigmoid", 128, "default", {"pallas_s": 1e-3, "xla_s": 2e-3}),
        ("dot_cross_terms", 128, "mxu", {"pallas_s": 1e-3, "xla_s": 2e-3}),
        ("dot_cross_terms", 128, "tall", {"pallas_s": 5e-3, "xla_s": 1e-3}),
    ],
    "kernels-lose": [
        ("fx_mul", 128, "default", {"pallas_s": 4e-4, "xla_s": 3e-4}),
        ("dot_cross_terms", 64, "small", {"pallas_s": 9e-4, "xla_s": 1e-4}),
        ("dot_cross_terms", 128, "mxu", {"cuda_s": 1e-3}),
    ],
}


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("env", sorted(ENVS))
@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_decision_is_the_reference_s(call, env, rows, monkeypatch):
    for key, value in ENVS[env].items():
        monkeypatch.setenv(key, value)
    _record(ROWS[rows])
    name, args, kwargs = CALLS[call]
    _same(getattr(jautotune, name)(*args, **kwargs),
          getattr(autotune, name)(*args, **kwargs))


@pytest.mark.parametrize("shape", ((1000, 1000, 1000), (1024, 100, 1),
                                   (100, 1024, 1), (64, 64, 63),
                                   (256, 32, 1), (255, 32, 1), (1, 1, 1)))
def test_dot_shape_classes_are_the_reference_s(shape):
    assert autotune.dot_shape_class(*shape) == jautotune.dot_shape_class(
        *shape)


@pytest.mark.parametrize("env", ("default", "overrides", "overrides-off"))
def test_dispatch_decision_table_is_the_reference_s(env, monkeypatch):
    """``dot_kernel_wanted`` (each package's dispatch predicate) records
    the same per-(width, class) table from the same rows; no micro runs
    on the CPU in either package."""
    for key, value in ENVS[env].items():
        monkeypatch.setenv(key, value)
    _record(ROWS["kernels-win"])
    for shape in ((512, 512, 128), (1024, 128, 8), (128, 100, 2), None):
        for width in (64, 128):
            assert autotune.dot_kernel_wanted(width, shape) == \
                jautotune.dot_kernel_wanted(width, shape)
    assert autotune.dot_decision_table() == jautotune.dot_decision_table()
    assert autotune.dot_decision_table()
    autotune.reset_dot_decisions()
    assert autotune.dot_decision_table() == {}


def test_the_dot_micro_needs_the_card():
    """``measure_dot_micro`` times K1 on the card only: on the CPU it
    records nothing, and no decision of either package reads a row it
    did not record."""
    assert autotune.measure_dot_micro(128, "small", device="cpu") is None
    assert autotune.measurements().get("dot_cross_terms", 128, "small") \
        is None
    _same(jautotune.dot_kernel_decision(128, (128, 100, 2)),
          autotune.dot_kernel_decision(128, (128, 100, 2)))


# -- per-computation decision tables ----------------------------------------


def _epoch_pair():
    fx = (24, 40)
    return (
        jtrainers.LogregSGDTrainer(5, 0.1, fixedpoint_dtype=jm.fixed(*fx))
        .epoch_computation(8),
        ttrainers.LogregSGDTrainer(5, 0.1, fixedpoint_dtype=tm.fixed(*fx))
        .epoch_computation(8),
    )


def _dot_pair():
    """A secure dot whose signatures carry static shapes, so the plan's
    ``pallas_dot`` reports a shape class (a traced graph's do not)."""
    jl, tl, _, _ = lowered_pair("rep_dot")
    return jl, tl


GRAPHS = {
    "secure_dot": lambda: traced_pair("secure_dot"),
    "logreg": lambda: traced_pair("logreg"),
    "epoch": _epoch_pair,
    "lowered_dot": _dot_pair,
}


@pytest.mark.parametrize("env", ("default", "overrides", "autotune-off"))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_autotune_plan_tables_are_the_reference_s(graph, env, monkeypatch):
    for key, value in ENVS[env].items():
        monkeypatch.setenv(key, value)
    _record(ROWS["kernels-win"])
    jcomp, tcomp = GRAPHS[graph]()
    want = jautotune.autotune_plan(jcomp)
    got = autotune.autotune_plan(tcomp)
    assert got.as_dict() == want.as_dict()
    assert [d.knob for d in got.decisions] == [d.knob for d in want.decisions]
    # the weak cache serves the same set again
    assert autotune.autotune_plan(tcomp) is got
    assert autotune._estimate_ops(tcomp) == jautotune._estimate_ops(jcomp)
    assert autotune._dominant_dot_shape(tcomp) == \
        jautotune._dominant_dot_shape(jcomp)


def test_plan_context_is_the_reference_s():
    """The callers' plan context (an op estimate, a segment histogram, a
    fabric attestation) reaches the same decisions."""
    jcomp, tcomp = traced_pair("secure_dot")
    ctx = dict(est_ops=4321, segment_sizes=(2, 2, 3, 30),
               fabric_parties=("alice", "bob", "carole"),
               session_parties=("alice", "bob"), width=64)
    assert autotune.autotune_plan(tcomp, **ctx).as_dict() == \
        jautotune.autotune_plan(jcomp, **ctx).as_dict()


def test_the_card_turns_the_kernel_family_on():
    """The reference's "TPU on, CPU off" default is the card on, the CPU
    off in the port."""
    assert autotune.pallas_family_decision(128, "cuda").choice is True
    assert autotune.pallas_family_decision(128, "cpu").choice is False
    assert autotune.pallas_family_decision(128).choice is False


@pytest.mark.parametrize("order", (("cpu", "cuda"), ("cuda", "cpu")))
def test_one_computation_on_both_devices_keeps_each_table(order):
    """One traced graph planned for the CPU and for the card, in either
    order: each run reads its own device's table (the card's ``pallas``
    on, the CPU's the reference's), each served warm again, never the
    other device's."""
    jcomp, tcomp = traced_pair("secure_dot")
    want = {"cpu": jautotune.autotune_plan(jcomp).as_dict()}
    want["cuda"] = dict(want["cpu"], pallas=autotune.pallas_family_decision(
        128, "cuda").as_dict())
    assert want["cuda"]["pallas"]["choice"] is True
    plans = {}
    for device in order:
        plans[device] = autotune.autotune_plan(tcomp, device=device)
        assert plans[device].as_dict() == want[device]
    for device in order:
        assert autotune.autotune_plan(tcomp, device=device) is \
            plans[device]


# -- the worker's eager floor -------------------------------------------------


@pytest.mark.parametrize("env", ("default", "autotune-off", "overrides"))
@pytest.mark.parametrize("name", ("rep_dot", "rep_sigmoid"))
def test_worker_min_seg_decision_is_the_reference_s(name, env, monkeypatch):
    for key, value in ENVS[env].items():
        monkeypatch.setenv(key, value)
    jl, tl, _, _ = lowered_pair(name)
    _same(jschedule.worker_min_seg_decision(jl),
          schedule.worker_min_seg_decision(tl))


def test_the_runtime_reports_the_table_on_the_cpu():
    """``last_plan["autotune"]`` of a stacked evaluation on the CPU: the
    decisions of ``autotune_plan`` at the stacked layout's op estimate,
    and the empty dot table of the CPU (no ``applied`` key there)."""
    cs = load_chip_smoke()
    comp = tm.edsl.tracer.trace(cs.secure_dot_computation(tm))
    rng = np.random.default_rng(3)
    runtime = tm.LocalMooseRuntime(["alice", "bob", "carole"],
                                   device="cpu")
    runtime.evaluate_computation(comp, {"x": rng.normal(size=(3, 2)),
                                        "y": rng.normal(size=(2, 2))})
    table = runtime.last_plan["autotune"]
    assert table["pallas_dot_classes"] == {}
    assert table["decisions"] == autotune.autotune_plan(
        comp, est_ops=autotune._estimate_ops(comp)).as_dict()
    assert all("applied" not in d for d in table["decisions"].values())
