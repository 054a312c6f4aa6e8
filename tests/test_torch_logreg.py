"""The slice end to end: ONNX logistic regression (a binary
LinearClassifier exported the sklearn way, LOGISTIC post-transform, the
exact protocol sigmoid) through the JAX LocalMooseRuntime (stacked
layout) and the port's, on the CPU, gives bit-identical outputs under
fixed keys and the threefry PRF, within 5e-3 of the float64 sigmoid.
The two precisions run in separate files (this one and
tests/test_torch_classifier.py) so the JAX reference's cost spreads over
the test workers."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch import interop
from moose_tpu_torch.native import ring_kernels as rk
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
    return got, sigmoid_pair(x, model.coef_[0], model.intercept_[0])


def test_binary_logreg_bit_identical_at_fixed_24_40(fixed_keys):
    got, ref = run_binary_parity((24, 40), seed=24)
    assert np.abs(got - ref).max() < chip_smoke.LOGREG_TOL


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
