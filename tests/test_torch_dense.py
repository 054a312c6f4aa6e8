"""The dense predictors through the port on the CPU: sklearn MLP
regressors and classifiers, and pytorch- and tf2onnx-layout
NeuralNetworks.

Each model is exported once to ONNX bytes (both packages' exporters
write the same bytes), imported by each package's ``from_onnx`` and run
through the JAX LocalMooseRuntime (stacked layout) and the port's under
fixed keys: the outputs are bit-identical, under the threefry stream and,
for one model of each family, under threefry-pallas, and within the JAX
package's own tolerance of sklearn (tests/test_predictors.py:112-160).
BASELINE config 5's MLP is chip_smoke.py's builder, here at narrow
widths against float64.  Each JAX run costs 15-35 s on the CPU."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from moose_tpu.edsl import tracer as jtracer
from moose_tpu.predictors import from_onnx as jfrom_onnx
from moose_tpu.predictors import sklearn_export as jsk
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.predictors import from_onnx as tfrom_onnx
from moose_tpu_torch.predictors import layers as tlayers
from moose_tpu_torch.predictors import onnx_proto as op
from moose_tpu_torch.predictors import sklearn_export as tsk
from moose_tpu_torch.predictors.convnet_predictor import ConvNet
from moose_tpu_torch.predictors.multilayer_perceptron_predictor import (
    MLPClassifier,
    MLPRegressor,
)
from moose_tpu_torch.predictors.neural_network_predictor import NeuralNetwork
from moose_tpu_torch.predictors.tree_ensemble import (
    TreeEnsembleClassifier,
    TreeEnsembleRegressor,
)
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import fixed_keys_env, prf

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

sklearn = pytest.importorskip("sklearn")
from sklearn import neural_network  # noqa: E402

IDS = ["alice", "bob", "carole"]


def run_both(export, x, stream="threefry"):
    """``export(sklearn_export module)`` through both packages: the same
    ONNX bytes, both imports, both runtimes under fixed keys and
    ``stream``.  Returns (port predictor, port output, JAX output)."""
    data = export(tsk).encode()
    assert export(jsk).encode() == data
    jpred, tpred = jfrom_onnx(data), tfrom_onnx(data)
    assert type(tpred).__name__ == type(jpred).__name__
    # the same ops, kinds and placements, in the same order: the draws
    # line up one for one
    assert _ops(ttracer.trace(tpred.predictor_factory())) == \
        _ops(jtracer.trace(jpred.predictor_factory()))
    with prf(stream), fixed_keys_env():
        want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
            .evaluate_computation(jpred.predictor_factory(),
                                  {"x": x})["output_0"]
        before = dict(rk.LAUNCHES)
        got = PortRuntime(IDS, device="cpu").evaluate_computation(
            tpred.predictor_factory(), {"x": x})["output_0"]
        assert rk.LAUNCHES == before  # the CPU runs the plain versions
    assert got.dtype == np.float64 and got.shape == want.shape
    return tpred, got, want


def _ops(comp):
    return [(op.name, op.kind, op.placement_name, sorted(op.attributes))
            for op in comp.operations.values()]


def regression_data(rng, n=60, d=5):
    x = rng.normal(size=(n, d))
    y = x @ rng.normal(size=(d,)) + 0.1 * rng.normal(size=n)
    return x, y


def classification_data(rng, n, d, classes):
    x = rng.normal(size=(n, d))
    y = rng.integers(0, classes, size=n)
    x += 0.8 * np.eye(d)[y % d]
    return x, y


@pytest.mark.parametrize("activation", ("identity", "relu", "logistic"))
def test_mlp_regressor_bit_identical(activation):
    x, y = regression_data(np.random.default_rng(1))
    sk = neural_network.MLPRegressor(
        hidden_layer_sizes=(8,), activation=activation, max_iter=200,
        random_state=0,
    ).fit(x, y)
    pred, got, want = run_both(lambda m: m.mlp_onnx(sk, 5), x[:6])
    assert isinstance(pred, MLPRegressor)
    assert np.array_equal(got, want)
    assert np.abs(got.ravel() - sk.predict(x[:6])).max() < 5e-3


@pytest.mark.parametrize("stream", ("threefry", "threefry-pallas"))
def test_mlp_classifier_binary_bit_identical(stream):
    x, y = classification_data(np.random.default_rng(2), 70, 4, 2)
    sk = neural_network.MLPClassifier(
        hidden_layer_sizes=(6,), activation="relu", max_iter=200,
        random_state=0,
    ).fit(x, y)
    pred, got, want = run_both(
        lambda m: m.mlp_onnx(sk, 4, classifier=True), x[:6], stream)
    assert isinstance(pred, MLPClassifier)
    assert got.shape == (6, 2) and np.array_equal(got, want)
    assert np.abs(got - sk.predict_proba(x[:6])).max() < 1e-2


def test_mlp_classifier_multiclass_bit_identical():
    x, y = classification_data(np.random.default_rng(3), 90, 4, 3)
    sk = neural_network.MLPClassifier(
        hidden_layer_sizes=(6,), activation="logistic", max_iter=200,
        random_state=0,
    ).fit(x, y)
    pred, got, want = run_both(
        lambda m: m.mlp_onnx(sk, 4, classifier=True), x[:6])
    assert isinstance(pred, MLPClassifier)
    assert got.shape == (6, 3) and np.array_equal(got, want)
    assert np.abs(got - sk.predict_proba(x[:6])).max() < 1e-2


def test_pytorch_neural_network_bit_identical():
    rng = np.random.default_rng(4)
    d = 4
    w0 = rng.normal(size=(6, d)) * 0.5  # pytorch (out, in) layout
    b0 = rng.normal(size=(6,)) * 0.1
    w1 = rng.normal(size=(1, 6)) * 0.5
    b1 = rng.normal(size=(1,)) * 0.1
    x = rng.normal(size=(5, d))
    pred, got, want = run_both(
        lambda m: m.pytorch_nn_onnx([w0, w1], [b0, b1], ["Relu", "Sigmoid"],
                                    d), x)
    assert isinstance(pred, NeuralNetwork)
    assert np.array_equal(got, want)
    h = np.maximum(x.astype(np.float32) @ w0.T.astype(np.float32) + b0, 0)
    ref = 1 / (1 + np.exp(-(h @ w1.T + b1)))
    assert np.abs(got - ref).max() < 1e-2


def test_pytorch_softmax_network_bit_identical_under_threefry_pallas():
    # chip_smoke.py phase 12's network (relu, relu, softmax) at narrow
    # widths
    rng = np.random.default_rng(5)
    weights, biases, acts = chip_smoke.network_layers(rng, 6, (5, 4), 3)
    x = rng.normal(size=(4, 6))
    pred, got, want = run_both(
        lambda m: m.pytorch_nn_onnx(weights, biases, acts, 6), x,
        "threefry-pallas")
    assert [layer.activation for layer in pred._stack.layers] == \
        ["relu", "relu", "softmax"]
    assert np.array_equal(got, want)
    ref = chip_smoke.dense_reference(pred, x)
    assert np.abs(got - ref).max() < chip_smoke.MULTI_TOL
    assert np.array_equal(got.argmax(axis=1), ref.argmax(axis=1))


def tf2onnx_model(weights, biases, acts, n_features):
    """A tf2onnx export of a dense network: MatMul + Add per layer with
    (in, out) weights, its activation nodes, and the parameters listed
    last layer first, as tf2onnx writes them."""
    nodes, inits, prev = [], [], "input"
    for i, (w, b, act) in enumerate(zip(weights, biases, acts)):
        nodes.append(op.make_node("MatMul", [prev, f"dense_{i}/MatMul:0"],
                                  [f"mm_{i}"]))
        nodes.append(op.make_node("Add", [f"mm_{i}", f"dense_{i}/BiasAdd:0"],
                                  [f"z_{i}"]))
        prev = f"z_{i}"
        if act is not None:
            nodes.append(op.make_node(act, [prev], [f"a_{i}"]))
            prev = f"a_{i}"
    for i in reversed(range(len(weights))):
        inits.append(op.make_initializer(f"dense_{i}/MatMul:0", weights[i]))
        inits.append(op.make_initializer(f"dense_{i}/BiasAdd:0", biases[i]))
    graph = op.GraphProto(
        name="tf_graph", node=nodes, initializer=inits,
        input=[op.make_tensor_value_info("input", op.TensorProto.FLOAT,
                                         [None, n_features])],
        output=[op.make_tensor_value_info(prev, op.TensorProto.FLOAT,
                                          [None, weights[-1].shape[1]])],
    )
    return op.make_model(graph, producer_name="tf2onnx")


def test_tf2onnx_neural_network_bit_identical():
    rng = np.random.default_rng(6)
    weights = [rng.normal(size=(4, 5)) * 0.5, rng.normal(size=(5, 3)) * 0.5,
               rng.normal(size=(3, 2)) * 0.5]
    biases = [rng.normal(size=n) * 0.1 for n in (5, 3, 2)]
    # a layer without an activation node between two affine layers is
    # the identity
    model = tf2onnx_model(weights, biases, ["Relu", None, "Softmax"], 4)
    x = rng.normal(size=(5, 4))
    pred, got, want = run_both(lambda m: model, x)
    assert [layer.activation for layer in pred._stack.layers] == \
        ["relu", "identity", "softmax"]
    for layer, w in zip(pred._stack.layers, weights):
        assert np.array_equal(layer.weights, w.astype(np.float32))
    assert np.array_equal(got, want)
    assert np.abs(got - chip_smoke.dense_reference(pred, x)).max() < 5e-3


def test_config5_mlp_at_narrow_widths_matches_float64():
    # chip_smoke.py phase 11's binary MLPClassifier (relu hidden layers,
    # sigmoid head), cut from 100 -> 64 -> 32 -> 1 to 10 -> 8 -> 4 -> 1
    rng = np.random.default_rng(7)
    model = chip_smoke.mlp_model(rng, 10, (8, 4))
    pred = tfrom_onnx(tsk.mlp_onnx(model, 10, classifier=True))
    assert isinstance(pred, MLPClassifier)
    x = rng.normal(size=(8, 10))
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        pred.predictor_factory(), {"x": x})["output_0"]
    ref = chip_smoke.dense_reference(pred, x)
    assert got.shape == (8, 2)
    assert np.abs(got - ref).max() < chip_smoke.MLPC_TOL
    # the reference forward pass of the float32 weights ONNX stores
    h = x
    for w, b in zip(model.coefs_[:-1], model.intercepts_[:-1]):
        h = np.maximum(h @ w.astype(np.float32) + b.astype(np.float32), 0)
    z = h @ model.coefs_[-1].astype(np.float32) + \
        model.intercepts_[-1].astype(np.float32)
    assert np.abs(ref[:, 1:] - 1 / (1 + np.exp(-z))).max() < 1e-6


def test_from_onnx_dispatches_each_family():
    rng = np.random.default_rng(8)
    mlp = chip_smoke.mlp_model(rng, 3, (2,))
    weights, biases, acts = chip_smoke.network_layers(rng, 3, (2,), 2)
    forest = chip_smoke.forest_model(rng, 2, 2, 3)
    regressor = SimpleNamespace(estimators_=forest.estimators_)
    cases = [
        (tsk.mlp_onnx(mlp, 3), MLPRegressor),
        (tsk.mlp_onnx(mlp, 3, classifier=True), MLPClassifier),
        (tsk.pytorch_nn_onnx(weights, biases, acts, 3), NeuralNetwork),
        (tf2onnx_model([w.T for w in weights], biases, ["Relu", "Softmax"],
                       3), NeuralNetwork),
        (tsk.random_forest_regressor_onnx(regressor, 3),
         TreeEnsembleRegressor),
        (tsk.random_forest_classifier_onnx(forest, 3),
         TreeEnsembleClassifier),
    ]
    for model, cls in cases:
        assert type(tfrom_onnx(model)) is cls
        assert type(tfrom_onnx(model.encode())) is cls
        assert type(jfrom_onnx(model.encode())).__name__ == cls.__name__


def test_from_onnx_gives_a_convnet():
    model, _ = jsk.resnet_block_onnx()
    data = model.encode()
    got, want = tfrom_onnx(data), jfrom_onnx(data)
    assert isinstance(got, ConvNet)
    assert got.input_shape == want.input_shape == (3, 8, 8)
    assert [n.op_type for n in got.nodes] == [n.op_type for n in want.nodes]
    assert got.initializers.keys() == want.initializers.keys()
    for name, arr in want.initializers.items():
        assert np.array_equal(got.initializers[name], arr), name


def test_from_onnx_refuses_an_unknown_graph():
    graph = op.GraphProto(
        name="g", node=[op.make_node("Unknown", ["x"], ["y"])],
        input=[op.make_tensor_value_info("x", op.TensorProto.FLOAT,
                                         [None, 2])],
    )
    with pytest.raises(ValueError, match="Incompatible ONNX graph"):
        tfrom_onnx(op.make_model(graph, producer_name="skl2onnx"))


def test_dense_stack_checks_its_shapes():
    with pytest.raises(ValueError, match="rank-2"):
        tlayers.DenseLayer(np.ones(3), np.ones(3))
    with pytest.raises(ValueError, match="does not match"):
        tlayers.DenseLayer(np.ones((3, 2)), np.ones(3))
    with pytest.raises(ValueError, match="unsupported activation"):
        tlayers.resolve_activation("Tanh")
    assert tlayers.resolve_activation(None) == "identity"
    # a first layer of 3 inputs against a model input of 4 features
    mlp = chip_smoke.mlp_model(np.random.default_rng(9), 3, (2,))
    with pytest.raises(ValueError, match="4 features"):
        tfrom_onnx(tsk.mlp_onnx(mlp, 4))


def test_the_package_exports_the_reference_s_names():
    from moose_tpu import predictors as jpredictors
    from moose_tpu_torch import predictors

    for name in ("MLPClassifier", "MLPRegressor", "NeuralNetwork",
                 "DecisionTreeRegressor", "TreeEnsembleClassifier",
                 "TreeEnsembleRegressor"):
        assert name in predictors.__all__ and name in jpredictors.__all__
        assert getattr(predictors, name).__module__.startswith(
            "moose_tpu_torch.predictors.")
