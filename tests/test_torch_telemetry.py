"""The port's telemetry: spans, phase timings and their OTLP export, on
the CPU.

The test functions of ``tests/test_telemetry.py`` run again against the
port: its ``telemetry`` module, its eDSL and its runtime (on the CPU) in
place of the JAX package's.  Where the port differs, its own test below
says how:

- ``test_runtime_records_phase_timings``: the JAX runtime opens a
  ``build_plan`` span for its jit plan; the port runs eagerly and has no
  plan to build, so it opens none (``trace``, ``evaluate_computation``
  and ``execute`` as the reference).
- ``test_runtime_surfaces_plan_mode``: under ``use_jit=True`` the JAX
  plan is ``whole-graph``; the port's is always ``eager``.
- The distributed session's stitched trace and ``comet --telemetry``
  (``test_distributed_session_exports_one_stitched_trace``,
  ``test_comet_telemetry_flag_wires_exporter``) import the JAX package's
  cluster, client, tracer and comet inside the test: those names are
  the port's there too (its workers on the CPU).
"""

import functools
import inspect

import numpy as np
import pytest

import moose_tpu_torch as tm
from moose_tpu_torch import serde, telemetry
from moose_tpu_torch.compilation import DEFAULT_PASSES, compile_computation
from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

import test_telemetry as jax_telemetry

DIFFERENT = ("test_runtime_records_phase_timings",
             "test_runtime_surfaces_plan_mode")
SHARED = [name for name, fn in vars(jax_telemetry).items()
          if name.startswith("test_") and inspect.isfunction(fn)
          and name not in DIFFERENT]


def _port_in_place_of_jax_imports(monkeypatch):
    """The names the JAX tests import inside their bodies (the worker
    cluster, the gRPC client, the tracer, comet) as the port's."""
    import moose_tpu.bin
    import moose_tpu.distributed.choreography as jchoreography
    import moose_tpu.distributed.client as jclient
    import moose_tpu.edsl

    from moose_tpu_torch.bin import comet
    from moose_tpu_torch.distributed import choreography, client
    from moose_tpu_torch.edsl import tracer

    monkeypatch.setattr(jchoreography, "start_local_cluster",
                        functools.partial(choreography.start_local_cluster,
                                          device="cpu"))
    monkeypatch.setattr(jclient, "GrpcClientRuntime",
                        client.GrpcClientRuntime)
    monkeypatch.setattr(moose_tpu.edsl, "tracer", tracer)
    monkeypatch.setattr(moose_tpu.bin, "comet", comet, raising=False)


@pytest.mark.parametrize("name", SHARED)
def test_telemetry_case_runs_on_the_port(name, request, monkeypatch):
    monkeypatch.setattr(jax_telemetry, "telemetry", telemetry)
    monkeypatch.setattr(jax_telemetry, "pm", tm)
    monkeypatch.setattr(jax_telemetry, "LocalMooseRuntime",
                        functools.partial(PortRuntime, device="cpu"))
    _port_in_place_of_jax_imports(monkeypatch)
    fn = getattr(jax_telemetry, name)
    fn(**{arg: request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})


def _add_graph():
    alice = tm.host_placement("alice")

    @tm.computation
    def comp(x: tm.Argument(placement=alice,
                            vtype=tm.TensorType(tm.float64))):
        with alice:
            y = tm.add(x, x)
        return y

    return comp


def test_runtime_records_phase_timings():
    runtime = PortRuntime(["alice"], device="cpu")
    comp = _add_graph()
    x = np.ones((4,))
    runtime.evaluate_computation(comp, arguments={"x": x})
    t = runtime.last_timings
    for phase in ("evaluate_computation", "trace", "execute"):
        assert phase in t and t[phase] >= 0, (phase, t)
    # eager: no jit plan to build
    assert "build_plan" not in t
    assert t["execute"] <= t["evaluate_computation"]
    runtime.evaluate_computation(comp, arguments={"x": x})
    assert "execute" in runtime.last_timings
    assert "trace" not in runtime.last_timings


def test_runtime_surfaces_plan_mode():
    for use_jit in (False, True):
        runtime = PortRuntime(["alice"], use_jit=use_jit, device="cpu")
        runtime.evaluate_computation(_add_graph(),
                                     arguments={"x": np.ones((4,))})
        assert runtime.last_plan["plan_mode"] == "eager"
        assert runtime.last_plan["pinned_ops"] == []
        assert runtime.last_plan["layout"] == "per-host"
        assert telemetry.find_attr(telemetry.last_trace(),
                                   "plan_mode") == "eager"


def _logreg_step():
    from moose_tpu_torch.predictors.trainers import LogregSGDTrainer

    trainer = LogregSGDTrainer(3, 0.1)
    rng = np.random.default_rng(9)
    args = {"x": rng.normal(size=(4, 3)), "y": rng.uniform(size=(4, 1))}
    for name, shape in trainer.state_shapes.items():
        args[name] = rng.normal(size=shape) * 0.3
    return trainer.step_computation(4), args


def test_stacked_request_and_its_ops_are_timed(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_TRACE_OPS", "1")
    comp, args = _logreg_step()
    runtime = PortRuntime(["alice", "bob", "carole"], device="cpu")
    runtime.evaluate_computation(comp, arguments=args)
    assert runtime.last_plan["layout"] == "stacked"
    t = runtime.last_timings
    assert t["execute"] <= t["evaluate_computation"]
    assert {"op:Dot", "op:Sigmoid", "op:Transpose"} <= set(t)


def test_evaluate_compiled_opens_its_span_and_the_lint_pass_its_own():
    comp, args = _logreg_step()
    with telemetry.span("compile_root") as root:
        lowered = compile_computation(
            comp, DEFAULT_PASSES, arg_specs_from_arguments(args),
            strict=True)
    names = {child.name for child in root.children}
    assert {f"pass:{p}" for p in DEFAULT_PASSES} | {"pass:lint"} == names
    runtime = PortRuntime(["alice", "bob", "carole"], use_jit=False,
                          device="cpu")
    runtime.evaluate_compiled(serde.serialize_computation(lowered), args)
    t = runtime.last_timings
    assert "evaluate_compiled" in t and "execute" in t
    assert t["execute"] <= t["evaluate_compiled"]
    assert runtime.last_plan["lowered"]


def test_a_trailing_lint_pass_is_analyzed_once():
    comp, args = _logreg_step()
    with telemetry.span("compile_root") as root:
        compile_computation(comp, DEFAULT_PASSES + ["lint"],
                            arg_specs_from_arguments(args), strict=True)
    lint = [c for c in root.children if c.name == "pass:lint"]
    assert len(lint) == 1
