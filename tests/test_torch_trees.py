"""The tree ensembles through the port on the CPU: random-forest
regressors and binary and multiclass classifiers, at the sizes of
tests/test_predictors.py:94-120, bit-identical to the JAX
LocalMooseRuntime (stacked layout) on the same ONNX bytes under fixed
keys (the binary classifier under both threefry streams), and within the
JAX package's 1e-3 of sklearn.  Both packages batch every split of the
forest into one ``less`` and then run each tree's mux cascade: the traced
ops agree one for one, so every draw index matches.  chip_smoke.py
phase 13's forest builder, cut to a narrow width, against float64."""

import sys
from pathlib import Path

import numpy as np
import pytest

from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk

from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.predictors.tree_ensemble import (
    TreeEnsembleClassifier,
    TreeEnsembleRegressor,
)
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_dense import (
    IDS,
    classification_data,
    regression_data,
    run_both,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

sklearn = pytest.importorskip("sklearn")
from sklearn import ensemble  # noqa: E402


def test_random_forest_regressor_bit_identical():
    x, y = regression_data(np.random.default_rng(11), n=80)
    # six leaves a tree: 20 splits, as many as the binary classifier's
    # below, whose JAX reference then reuses this one's compiles
    sk = ensemble.RandomForestRegressor(
        n_estimators=4, max_depth=3, max_leaf_nodes=6,
        random_state=0).fit(x, y)
    pred, got, want = run_both(
        lambda m: m.random_forest_regressor_onnx(sk, 4), x[:6])
    assert isinstance(pred, TreeEnsembleRegressor)
    assert np.array_equal(got, want)
    assert np.abs(got.ravel() - sk.predict(x[:6])).max() < 1e-3


@pytest.mark.parametrize("stream", ("threefry", "threefry-pallas"))
def test_random_forest_classifier_binary_bit_identical(stream):
    x, y = classification_data(np.random.default_rng(12), 80, 4, 2)
    sk = ensemble.RandomForestClassifier(
        n_estimators=4, max_depth=3, random_state=0).fit(x, y)
    pred, got, want = run_both(
        lambda m: m.random_forest_classifier_onnx(sk, 4), x[:6], stream)
    assert isinstance(pred, TreeEnsembleClassifier)
    assert got.shape == (6, 2) and np.array_equal(got, want)
    assert np.abs(got - sk.predict_proba(x[:6])).max() < 1e-3


def test_random_forest_classifier_multiclass_bit_identical():
    x, y = classification_data(np.random.default_rng(13), 90, 4, 3)
    sk = ensemble.RandomForestClassifier(
        n_estimators=3, max_depth=2, random_state=0).fit(x, y)
    pred, got, want = run_both(
        lambda m: m.random_forest_classifier_onnx(sk, 4), x[:6])
    # one tree per ONNX tree id and class: 3 trees of 3 classes
    assert isinstance(pred, TreeEnsembleClassifier) and len(pred.trees) == 9
    assert got.shape == (6, 3) and np.array_equal(got, want)
    assert np.abs(got - sk.predict_proba(x[:6])).max() < 1e-3


def test_forest_splits_are_one_less():
    # every split of the forest in one (batch, inner nodes) comparison,
    # then the trees' muxes on its columns
    forest = chip_smoke.forest_model(np.random.default_rng(14), 3, 2, 5)
    pred = tfrom_onnx(tsk.random_forest_classifier_onnx(forest, 5))
    from moose_tpu_torch.edsl import tracer

    comp = tracer.trace(pred.predictor_factory())
    kinds = [op.kind for op in comp.operations.values()
             if comp.placements[op.placement_name].kind == "Replicated"]
    assert kinds.count("Less") == 1
    assert kinds.count("Mux") == sum(len(t.inner_nodes()) for t in
                                     pred.trees) == 9
    assert kinds.index("Less") < kinds.index("Mux")


def test_phase_13_forest_at_narrow_width_matches_float64():
    # chip_smoke.py phase 13's forest (8 trees of depth 4 on 100 features)
    # cut to 3 trees of depth 3 on 6 features, 16 rows
    rng = np.random.default_rng(15)
    model = chip_smoke.forest_model(rng, 3, 3, 6)
    data = tsk.random_forest_classifier_onnx(model, 6)
    assert data.encode() == jsk.random_forest_classifier_onnx(model, 6) \
        .encode()
    pred = tfrom_onnx(data)
    assert isinstance(pred, TreeEnsembleClassifier)
    assert type(jfrom_onnx(data.encode())).__name__ == type(pred).__name__
    x = rng.normal(size=(16, 6))
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x})["output_0"]
    ref = chip_smoke.forest_reference(pred, x)
    assert got.shape == (16, 2)
    assert np.abs(got - ref).max() < chip_smoke.FOREST_TOL
    # the reference walks the model's own arrays: leaf probabilities of
    # the positive class over the trees, float32 as ONNX stores them
    p = np.zeros(16)
    for est in model.estimators_:
        t = est.tree_
        for i in range(16):
            n = 0
            while t.children_left[n] != -1:
                thr = np.float32(t.threshold[n])
                n = (t.children_left[n] if x[i, t.feature[n]] < thr
                     else t.children_right[n])
            p[i] += np.float32(t.value[n][0][1] / t.value[n][0].sum() / 3)
    assert np.abs(ref[:, 1] - p).max() < 1e-6
