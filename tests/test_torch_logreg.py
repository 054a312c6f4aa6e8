"""The slice end to end: ONNX logistic regression (a binary
LinearClassifier exported the sklearn way, LOGISTIC post-transform, the
exact protocol sigmoid) through the JAX LocalMooseRuntime (stacked
layout) and the port's, on the CPU, gives bit-identical outputs under
fixed keys and the threefry PRF, within 5e-3 of the float64 sigmoid;
at fixed(24,40) the port's stacked runs on (3, 2) and (3, 4) device
meshes give the same words.
The two precisions run in separate files (this one and
tests/test_torch_classifier.py) so the JAX reference's cost spreads over
the test workers."""

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch import devices, interop
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import threefry  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

IDS = ["alice", "bob", "carole"]
ROWS, FEATURES = 8, 5


@pytest.fixture
def fixed_keys(monkeypatch, threefry):
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", "torch-parity")
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")


def binary_model(seed):
    """A fitted binary LogisticRegression's attributes, from a seed."""
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        coef_=rng.normal(size=(1, FEATURES)),
        intercept_=rng.normal(size=(1,)) * 0.5,
        classes_=np.array([0, 1]),
    ), rng.normal(size=(ROWS, FEATURES)) * 1.5


def sigmoid_pair(x, w, b):
    p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
    return np.stack([1.0 - p, p], axis=1)


def run_binary_parity(precision, seed):
    """The binary model through both runtimes and the port's own ONNX
    import; returns (port output, float64 reference)."""
    model, x = binary_model(seed)
    jpred = jfrom_onnx(jsk.logistic_regression_onnx(model, FEATURES))
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(
            jpred.predictor_factory(jm.fixed(*precision)), {"x": x}
        )["output_0"]
    tpred = tfrom_onnx(tsk.logistic_regression_onnx(model, FEATURES))
    assert np.array_equal(tpred.coeffs, jpred.coeffs)
    assert np.array_equal(tpred.intercepts, jpred.intercepts)
    before = dict(rk.LAUNCHES)
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        tpred.predictor_factory(tm.fixed(*precision)), {"x": x}
    )["output_0"]
    assert rk.LAUNCHES == before  # the CPU runs the plain versions
    assert got.shape == (ROWS, 2) and got.dtype == np.float64
    assert np.array_equal(got, want)
    # the weights the JAX predictor carries build the same port model
    again = PortRuntime(IDS, device="cpu").evaluate_computation(
        interop.linear_classifier_from_arrays(
            jpred.coeffs, jpred.intercepts, "SIGMOID"
        ).predictor_factory(tm.fixed(*precision)), {"x": x}
    )["output_0"]
    assert np.array_equal(again, want)
    # and on the stacked layout over device meshes of virtual CPU
    # devices, (3, 2) and (3, 4) as make_mesh(6) and make_mesh(12) lay
    # them out: the JAX package's words all the same
    for n in (6, 12):
        mesh = tspmd.make_mesh(devices=devices.virtual_devices("cpu", n))
        runtime = PortRuntime(IDS, layout="stacked", mesh=mesh,
                              device="cpu")
        meshed = runtime.evaluate_computation(
            tpred.predictor_factory(tm.fixed(*precision)), {"x": x}
        )["output_0"]
        assert runtime.last_plan["layout"] == "stacked"
        assert np.array_equal(meshed, want), n
    return got, sigmoid_pair(x, model.coef_[0], model.intercept_[0])


def test_binary_logreg_bit_identical_at_fixed_24_40(fixed_keys):
    got, ref = run_binary_parity((24, 40), seed=24)
    assert np.abs(got - ref).max() < chip_smoke.LOGREG_TOL


_JAX_PLANS: dict = {}


def jax_plan_words(traced, x, segment):
    """The JAX package's words of config 3 under the current fixed key:
    its eager walk, or its plan in segments of ``segment`` ops run
    eagerly, the reference its own self-check holds the jitted segments
    to word for word (jitting the protocol sigmoid takes about a minute
    on this CPU).  Memoized by key and segment."""
    from moose_tpu.dialects import stacked as jstacked
    from moose_tpu.execution import interpreter as jinterp

    memo = (os.environ["MOOSE_TPU_FIXED_KEYS"], segment)
    if memo not in _JAX_PLANS:
        if segment is None:
            out = JaxRuntime(IDS, layout="stacked", use_jit=False) \
                .evaluate_computation(traced, {"x": x})["output_0"]
        else:
            plan = jinterp.build_plan(
                traced, {"x": x}, True, segment_limit=segment,
                jit_segments=False, dialect=jstacked.StackedDialect())
            outputs, _ = plan.fn(jinterp.master_key_words("logical"),
                                 {"x": x})
            out = jinterp._to_user_value(outputs["output_0"])
        _JAX_PLANS[memo] = np.asarray(out)
    return _JAX_PLANS[memo]


@pytest.mark.parametrize("key", ("torch-parity", "torch-parity-b"))
@pytest.mark.parametrize("segment", (None, 5), ids=("whole", "segmented"))
def test_binary_logreg_plans_are_the_jax_package_s(threefry, monkeypatch,
                                                   segment, key):
    """Config 3 at 8 x 5, fixed(24,40), through the port's compiled plan
    (uncaptured on the CPU), whole and segmented
    (``MOOSE_TPU_JIT_SEGMENT=5``: each segment draws from its own key
    domain), under two master keys: the JAX package's words, after the
    JAX runs of the test above in this process."""
    monkeypatch.setenv("MOOSE_TPU_FIXED_KEYS", key)
    monkeypatch.setenv("MOOSE_TPU_ALLOW_WEAK_PRF", "1")
    if segment is not None:
        monkeypatch.setenv("MOOSE_TPU_JIT_SEGMENT", str(segment))
    model, x = binary_model(24)
    jpred = jfrom_onnx(jsk.logistic_regression_onnx(model, FEATURES))
    traced = jtracer.trace(jpred.predictor_factory(jm.fixed(24, 40)))
    want = jax_plan_words(traced, x, segment)
    runtime = PortRuntime(IDS, layout="stacked", use_jit=True, device="cpu")
    got = runtime.evaluate_computation(
        tfrom_onnx(tsk.logistic_regression_onnx(model, FEATURES))
        .predictor_factory(tm.fixed(24, 40)), {"x": x})["output_0"]
    assert runtime.last_plan["plan_mode"] == (
        "whole-graph" if segment is None else "segmented")
    assert len(traced.operations) > 2 * (segment or 0)
    assert np.array_equal(got, want)
    assert np.abs(got - sigmoid_pair(x, model.coef_[0],
                                     model.intercept_[0])).max() < \
        chip_smoke.LOGREG_TOL


def test_chip_smoke_logistic_regression_matches_float64():
    # the model chip_smoke.py serves on the card, cut to 12 features
    pred = chip_smoke.logistic_regression(np.random.default_rng(3), 12)
    x = np.random.default_rng(4).normal(size=(6, 12))
    out = PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x}
    )["output_0"]
    want = chip_smoke.logistic_reference(pred, x)
    assert out.shape == want.shape == (6, 2)
    assert np.abs(out - want).max() < chip_smoke.LOGREG_TOL


@pytest.mark.parametrize("precision", ((24, 40), (8, 17)),
                         ids=("ring128", "ring64"))
def test_served_bucket_is_the_jax_package_s(fixed_keys, precision):
    """``tests/test_serving.py``'s padded-batch case on the port's
    server, held against the JAX package: ROWS - 1 rows coalesced into
    one batch padded to a bucket of ROWS equal the JAX package's direct
    evaluation of that bucket (``tests/test_torch_serving.py``).  At
    fixed(24,40) it shares the JAX compiles of the case above."""
    from test_torch_serving import assert_served_bucket_is_the_jax_package_s

    model, x = binary_model(24)
    data = tsk.logistic_regression_onnx(model, FEATURES).encode()
    got = assert_served_bucket_is_the_jax_package_s(
        data, precision, x[:ROWS - 1], ROWS)
    if precision == (24, 40):  # full precision also matches float64
        ref = sigmoid_pair(x[:ROWS - 1], model.coef_[0],
                           model.intercept_[0])
        assert np.abs(got - ref).max() < chip_smoke.LOGREG_TOL
