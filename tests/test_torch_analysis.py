"""The port's static analyzer held against the JAX package's on the CPU.

- Every test function of ``tests/test_analysis.py`` runs again with its
  analysis calls mirrored (``tests/torch_analysis_mirror.py``): each call
  also runs the port's analyzer on the same graph, carried across as
  bytes, and the two results must be exactly equal — every diagnostic
  (rule, severity, op, placement, message), every report, every
  exception.  Its prancer CLI cases run both CLIs on the same files: the
  same standard output, standard error and exit codes.  The distributed
  worker's ranges advisory (``test_worker_plan_carries_ranges_advisory``)
  also holds the port's worker plan to the JAX package's.
- The port's own traced graphs (config 3, the trainers, the protocol
  library of ``chip_smoke.py``) and lowered ones: the diagnostics of
  every analysis, the range report, the reconstructed schedules and the
  cost report under both transports equal the JAX package's.
- The value codec and the transport helpers the cost model sizes frames
  with write the JAX package's bytes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import moose_tpu.compilation.analysis as janalysis
from moose_tpu import serde as jserde
from moose_tpu import values as jvalues
from moose_tpu.compilation.analysis import cost as jcost
from moose_tpu.compilation.analysis import schedule as jschedule
from moose_tpu.dialects import host as jhost
from moose_tpu.distributed import fabric as jfabric
from moose_tpu.distributed import networking as jnetworking
from moose_tpu.execution import interpreter as jinterpreter

import moose_tpu_torch.compilation.analysis as analysis
from moose_tpu_torch import dtypes as tdt
from moose_tpu_torch import serde, values
from moose_tpu_torch.compilation.analysis import cost, ranges, schedule
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.distributed import fabric, networking
from moose_tpu_torch.execution import interpreter

import test_analysis as jax_analysis
from torch_analysis_mirror import (
    cases,
    mirror,
    mirror_cli,
    mirror_worker_plan,
    normalize,
    run_case,
)
from torch_parity import lowered_pair, traced_pair

REPO = Path(__file__).resolve().parent.parent
# the analysis catalogue and the range analyzer's internals are compared
# directly below: these JAX tests call no analysis entry point
DIRECT = ("test_every_rule_is_catalogued", "test_every_range_rule_is_catalogued",
          "test_concat_union_tolerates_ragged_operand_ranks")


@pytest.mark.parametrize("name,params", cases(jax_analysis, DIRECT))
def test_analysis_case_matches_port(name, params, request, monkeypatch):
    mirror(monkeypatch, jax_analysis)
    mirror_cli(monkeypatch)
    mirror_worker_plan(monkeypatch)
    assert run_case(jax_analysis, name, params, request) > 0


def test_catalogue_matches_the_jax_package():
    assert analysis.RULES == janalysis.RULES
    assert list(analysis.ANALYSES) == list(janalysis.ANALYSES)
    assert analysis.ANALYSIS_CONTEXT_KEYS == janalysis.ANALYSIS_CONTEXT_KEYS
    assert sorted(analysis.__all__) == sorted(janalysis.__all__)


def test_concat_union_tolerates_ragged_operand_ranks():
    """Ranks that differ degrade the concat shape to unknown, as in the
    JAX package (``tests/test_analysis.py``'s regression)."""
    from torch_analysis_mirror import port_computation

    comp = port_computation(jax_analysis._fixed_predict_graph())
    an = ranges._Analyzer(comp, None, None, None)
    op = next(iter(comp.operations.values()))
    matrix = ranges.RangeFact(kind="float", lo=-1.0, hi=1.0, shape=(2, 3))
    scalar = ranges.RangeFact(kind="float", lo=0.0, hi=2.0, shape=())
    for facts in ([matrix, scalar], [scalar, matrix]):
        fused = an._union(op, facts, concat=True)
        assert fused.shape is None
        assert (fused.lo, fused.hi) == (-1.0, 2.0)


@pytest.mark.parametrize("env", (
    {}, {"MOOSE_TPU_AUTOTUNE": "0"}, {"MOOSE_TPU_WORKER_MIN_SEG": "2"},
    {"MOOSE_TPU_WORKER_MIN_SEG": "40"}, {"MOOSE_TPU_JIT_SEGMENT": "64"},
), ids=("default", "autotune-off", "min-seg-2", "min-seg-40",
        "segment-64"))
def test_the_worker_floor_resolves_as_the_autotuner_does(env, monkeypatch):
    """The schedules resolve the worker's eager floor through the
    autotuner's decision to the reference's choice under each of the
    knobs it reads (rep_sigmoid's segments are mostly tiny: its default
    floor lifts to 7)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for name in ("rep_dot", "rep_sigmoid"):
        jl, tl, _, _ = lowered_pair(name)
        assert normalize(schedule.reconstruct_schedules(tl)) == normalize(
            jschedule.reconstruct_schedules(jl)), name


def test_worker_min_seg_decision_names_item_13b():
    """Item 13b is ported: the decision is the reference's, choice,
    source and reason."""
    jl, tl = lowered_pair("rep_dot")[:2]
    want = jschedule.worker_min_seg_decision(jl)
    got = schedule.worker_min_seg_decision(tl)
    assert (got.knob, got.choice, got.source, got.why) == (
        want.knob, want.choice, want.source, want.why)


# -- the port's own graphs -------------------------------------------------


def _diagnostics(diags):
    return [(d.rule, int(d.severity), d.op, d.placement, d.message)
            for d in diags]


TRACED = {
    # name: (arg specs, declared ranges)
    "logreg": ({"x": (8, 5)}, {"x": (-2.0, 2.0)}),
    "secure_dot": ({"x": (4, 3), "y": (3, 2)},
                   {"x": (-1.0, 1.0), "y": (-1.0, 1.0)}),
    "multinomial": ({"x": (8, 5)}, {"x": (-2.0, 2.0)}),
    "library": ({"x": (2, 4), "y": (2, 4), "p": (2, 4)},
                {"x": (-1.0, 1.0), "y": (-1.0, 1.0), "p": (0.5, 2.0)}),
}


@pytest.mark.parametrize("name", sorted(TRACED))
def test_traced_graph_analysis_matches_the_jax_package(name):
    """Every analysis over a traced graph, with its shapes and ranges
    declared: the same diagnostics and the same range report."""
    specs, declared = TRACED[name]
    jc, tc = traced_pair(name)
    context = {"arg_specs": specs, "arg_ranges": declared}
    with jhost.deterministic_sync_keys(5):
        want = janalysis.analyze(jc, context=context)
    with thost.deterministic_sync_keys(5):
        got = analysis.analyze(tc, context=context)
    assert _diagnostics(got) == _diagnostics(want)
    # the keystream analysis lowered the graph: its draw report is there
    assert "MSA805" in {d.rule for d in got}
    assert analysis.range_report(tc, **context) == \
        janalysis.range_report(jc, **context)


@pytest.mark.parametrize("kind", ("logreg", "mlp"))
def test_trainer_graphs_analysis_matches_the_jax_package(kind):
    """The trainers' init, epoch, step and export graphs under their own
    declared specs and ranges (the build-time gate's context): every
    diagnostic of the range and keystream analyses, and every range
    report, equal."""
    import moose_tpu as jm
    import moose_tpu_torch as tm
    from moose_tpu.predictors import trainers as jtrainers
    from moose_tpu_torch.predictors import trainers as ttrainers

    built = []
    for pm, trainers in ((jm, jtrainers), (tm, ttrainers)):
        cls = (trainers.LogregSGDTrainer if kind == "logreg"
               else trainers.MLPSGDTrainer)
        args = (3,) if kind == "logreg" else (3, 2)
        built.append(cls(*args, 0.1, steps_per_epoch=2,
                         fixedpoint_dtype=pm.fixed(14, 23)))
    jtrainer, ttrainer = built
    for graph, rows in (("init", None), ("epoch", 8), ("step", 4),
                        ("export", None)):
        make = f"{graph}_computation"
        jc, tc = ((getattr(t, make)(rows) if rows else getattr(t, make)())
                  for t in (jtrainer, ttrainer))
        specs, declared = ttrainer.range_specs(rows)
        context = {"arg_specs": specs, "arg_ranges": declared}
        with jhost.deterministic_sync_keys(6):
            want = janalysis.analyze(jc, analyses=["ranges", "keystream"],
                                     context=context)
        with thost.deterministic_sync_keys(6):
            got = analysis.analyze(tc, analyses=["ranges", "keystream"],
                                   context=context)
        assert _diagnostics(got) == _diagnostics(want), graph
        assert analysis.range_report(tc, **context) == \
            janalysis.range_report(jc, **context), graph


@pytest.mark.parametrize("name", ("logreg", "rep_dot", "rep_sigmoid"))
def test_lowered_graph_schedules_and_costs_match_the_jax_package(name):
    """A lowered, networked graph: the reconstructed role schedules,
    every analysis's diagnostics and the cost report under the gRPC and
    the fabric transport, equal."""
    jl, tl, _, _ = lowered_pair(name)
    assert normalize(schedule.reconstruct_schedules(tl)) == normalize(
        jschedule.reconstruct_schedules(jl))
    assert _diagnostics(analysis.analyze(tl)) == _diagnostics(
        janalysis.analyze(jl))
    for transport in ("grpc", "fabric"):
        got = cost.cost_report(tl, transport=transport)
        assert got == jcost.cost_report(jl, transport=transport)
        assert got["resolved"], transport


# -- the value codec and the transport helpers -----------------------------


def _value_pairs():
    """(JAX value, port value) of every host value kind the wire carries,
    from one seed."""
    rng = np.random.default_rng(16)
    lo = rng.integers(0, 2**63, size=(2, 3), dtype=np.uint64)
    hi = rng.integers(0, 2**63, size=(2, 3), dtype=np.uint64)
    bits = rng.integers(0, 2, size=(5, 3), dtype=np.uint8)
    f = rng.normal(size=(3, 2))
    words = (1, 2**32 - 1, 7, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)
                                if a.dtype == np.uint64 else a)

    from moose_tpu import dtypes as jdt

    return [
        (jvalues.HostRingTensor(lo, hi, 128, "a"),
         values.HostRingTensor(t(lo), t(hi), 128, "a")),
        (jvalues.HostRingTensor(lo, None, 64, "a"),
         values.HostRingTensor(t(lo), None, 64, "a")),
        (jvalues.HostBitTensor(bits, "a"),
         values.HostBitTensor(torch.from_numpy(bits), "a")),
        (jvalues.HostTensor(f, "a", jdt.float64),
         values.HostTensor(torch.from_numpy(f), "a", tdt.float64)),
        (jvalues.HostTensor(lo, "a", jdt.uint64),
         values.HostTensor(t(lo), "a", tdt.uint64)),
        (jvalues.HostSeed(np.array(words, np.uint32), "a"),
         values.HostSeed(words, "a")),
        (jvalues.HostPrfKey(np.array(words, np.uint32), "a"),
         values.HostPrfKey(words, "a")),
        (jvalues.HostShape((2, 3), "a"), values.HostShape((2, 3), "a")),
        (jvalues.HostString("k", "a"), values.HostString("k", "a")),
        (jvalues.HostUnit("a"), values.HostUnit("a")),
        (np.arange(4.0), np.arange(4.0)),
        (3, 3),
    ]


@pytest.mark.parametrize("index", range(12))
def test_value_codec_writes_the_jax_package_s_bytes(index):
    jv, tv = _value_pairs()[index]
    data = serde.serialize_value(tv)
    assert data == jserde.serialize_value(jv)
    back = serde.deserialize_value(data, "a")
    assert serde.serialize_value(back) == data
    assert type(back).__name__ == type(tv).__name__


@pytest.mark.parametrize("index", range(12))
def test_fabric_leaves_match_the_jax_package(index):
    jv, tv = _value_pairs()[index]
    got, want = fabric.value_leaves(tv), jfabric.value_leaves(jv)
    assert len(got) == len(want)
    assert fabric.leaf_bytes(got) == jfabric.leaf_bytes(want)


def test_transport_frames_match_the_jax_package():
    key = networking.transfer_key("a" * 32, "rdv_0")
    assert key == jnetworking.transfer_key("a" * 32, "rdv_0")
    payload = b"\x01\x02" * 9
    assert networking.pack_value_frame("alice", key, payload) == \
        jnetworking.pack_value_frame("alice", key, payload)
    entries = [(key, payload), (key + "x", b"")]
    assert networking.pack_batch_frame("bob", entries) == \
        jnetworking.pack_batch_frame("bob", entries)


def test_plan_segments_match_the_jax_package():
    jl, tl, _, _ = lowered_pair("rep_dot")
    order = tl.toposort_names()

    def inputs(n):
        return tl.operations[n].inputs

    for limit in (7, 40, 1 << 62):
        assert interpreter.plan_segments(order, {}, inputs, limit) == \
            jinterpreter.plan_segments(order, {}, inputs, limit)
    chunks = [order[:5], order[9:20]]
    assert interpreter.plan_segments(order, {}, inputs, 0, chunks) == \
        jinterpreter.plan_segments(order, {}, inputs, 0, chunks)


# -- the import boundary ---------------------------------------------------

NEW_MODULES = (
    "moose_tpu_torch.compilation.analysis",
    "moose_tpu_torch.compilation.analysis.cost",
    "moose_tpu_torch.compilation.analysis.ranges",
    "moose_tpu_torch.compilation.analysis.keystream",
    "moose_tpu_torch.compilation.analysis.schedule",
    "moose_tpu_torch.execution.drawledger",
    "moose_tpu_torch.telemetry",
    "moose_tpu_torch.bin.prancer",
    "moose_tpu_torch.distributed.fabric",
    "moose_tpu_torch.distributed.networking",
)


def test_analyzer_modules_import_no_jax_or_moose_tpu():
    """Importing the analyzer, the draw ledger, telemetry and prancer adds
    no JAX module and nothing of the JAX package; the AST scan of every
    port source (``tests/test_torch_predictors.py``) reads them too."""
    scanned = {p.relative_to(REPO).as_posix()
               for p in (REPO / "moose_tpu_torch").rglob("*.py")}
    for module in NEW_MODULES:
        path = module.replace(".", "/")
        assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {', '.join(NEW_MODULES)}\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'moose_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_prancer_runs_as_a_module_on_a_blob(tmp_path):
    """``python -m moose_tpu_torch.bin.prancer --format json`` on config
    3's serialized graph prints the JAX CLI's output and exit code."""
    _, tc = traced_pair("logreg")
    blob = tmp_path / "logreg.moose.bin"
    blob.write_bytes(serde.serialize_computation(tc))
    runs = [
        subprocess.run(
            [sys.executable, "-m", f"{pkg}.bin.prancer", str(blob),
             "--format", "json"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        for pkg in ("moose_tpu_torch", "moose_tpu")
    ]
    got, want = runs
    assert (got.returncode, got.stdout) == (want.returncode, want.stdout)
    assert got.returncode == 0
