"""LinearClassifier heads of the port on the CPU: the binary logistic
regression at fixed(14,23) and the two-sigmoid head of a two-class model
whose rows are not mirrors, bit-identical to the JAX LocalMooseRuntime
(stacked layout) under fixed keys; the SOFTMAX head of multinomial
logistic regression bit-identical too and within 5e-3 of float64; the
one-vs-rest head (Sum, Div) against float64."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.predictors.linear_predictor import (
    LinearClassifier as JaxClassifier,
)
from moose_tpu.predictors.linear_predictor import PostTransform as JaxPT
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch import interop
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_logreg import (  # noqa: F401  (fixtures)
    IDS,
    chip_smoke,
    fixed_keys,
    run_binary_parity,
    threefry,
)


def test_binary_logreg_bit_identical_at_fixed_14_23(fixed_keys):
    got, ref = run_binary_parity((14, 23), seed=14)
    assert np.abs(got - ref).max() < 5e-3


def test_two_sigmoid_head_bit_identical(fixed_keys):
    rng = np.random.default_rng(2)
    coeffs, intercepts = rng.normal(size=(2, 4)), rng.normal(size=(1, 2))
    x = rng.normal(size=(4, 4))
    jpred = JaxClassifier(coeffs, intercepts, post_transform=JaxPT.SIGMOID)
    precision = (14, 23)
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(
            jpred.predictor_factory(jm.fixed(*precision)), {"x": x}
        )["output_0"]
    tpred = interop.linear_classifier_from_arrays(coeffs, intercepts,
                                                  "SIGMOID")
    assert not tpred._mirrored_binary
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        tpred.predictor_factory(tm.fixed(*precision)), {"x": x}
    )["output_0"]
    assert np.array_equal(got, want)
    ref = 1.0 / (1.0 + np.exp(-(x @ coeffs.T + intercepts)))
    assert np.abs(got - ref).max() < 5e-3


def test_one_vs_rest_head_matches_float64():
    rng = np.random.default_rng(3)
    coeffs, intercepts = rng.normal(size=(3, 4)) * 0.5, rng.normal(size=3)
    x = rng.normal(size=(5, 4))
    pred = interop.linear_classifier_from_arrays(coeffs, intercepts,
                                                 "SIGMOID")
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x}
    )["output_0"]
    s = 1.0 / (1.0 + np.exp(-(x @ coeffs.T + intercepts)))
    assert got.shape == (5, 3)
    assert np.abs(got - s / s.sum(axis=1, keepdims=True)).max() < 5e-3


def test_none_head_is_the_logits():
    rng = np.random.default_rng(4)
    coeffs, intercepts = rng.normal(size=(2, 3)), rng.normal(size=2)
    x = rng.normal(size=(4, 3))
    pred = interop.linear_classifier_from_arrays(coeffs, intercepts, "NONE")
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x}
    )["output_0"]
    assert np.abs(got - (x @ coeffs.T + intercepts)).max() < 1e-6


def _softmax(z):
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("precision", ((14, 23), (24, 40)))
def test_softmax_head_bit_identical(fixed_keys, precision):
    # multinomial logistic regression, exported the skl2onnx way (raw
    # class rows, SOFTMAX), through both runtimes and ONNX imports
    rng = np.random.default_rng(precision[0])
    model = type("M", (), {
        "coef_": rng.normal(size=(3, 4)), "intercept_": rng.normal(size=3),
        "classes_": np.arange(3),
    })
    x = rng.normal(size=(5, 4))
    jpred = jfrom_onnx(jsk.logistic_regression_onnx(model, 4))
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(
            jpred.predictor_factory(jm.fixed(*precision)), {"x": x}
        )["output_0"]
    tpred = tfrom_onnx(tsk.logistic_regression_onnx(model, 4))
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        tpred.predictor_factory(tm.fixed(*precision)), {"x": x}
    )["output_0"]
    assert got.shape == (5, 3) and got.dtype == np.float64
    assert np.array_equal(got, want)
    z = x @ model.coef_.T + model.intercept_
    assert np.abs(got - _softmax(z)).max() < 5e-3


def test_softmax_head_matches_float64():
    # ten classes, the multinomial classifier chip_smoke.py serves, cut to
    # 6 features and 4 rows
    rng = np.random.default_rng(5)
    pred = chip_smoke.multinomial_regression(rng, 6)
    x = rng.normal(size=(4, 6))
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x}
    )["output_0"]
    want = _softmax(x @ pred.coeffs.T + pred.intercepts)
    assert got.shape == (4, chip_smoke.MULTI_CLASSES)
    assert np.abs(got - want).max() < chip_smoke.MULTI_TOL
    assert np.array_equal(got.argmax(axis=1), want.argmax(axis=1))


def test_onnx_import_refuses_a_second_linear_node():
    from moose_tpu_torch.predictors import onnx_proto as op

    model = tsk.logistic_regression_onnx(
        type("M", (), {"coef_": np.ones((1, 2)), "intercept_": np.zeros(1),
                       "classes_": np.arange(2)}), 2
    )
    model.graph.node.append(op.make_node(
        "LinearRegressor", ["float_input"], ["y"], coefficients=[1.0, 2.0]
    ))
    with pytest.raises(ValueError, match="at most one"):
        tfrom_onnx(model)
