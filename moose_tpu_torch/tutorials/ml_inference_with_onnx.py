"""Use case: encrypted machine-learning inference from an ONNX model.

The port's program of ``tutorials/ml_inference_with_onnx.py`` (the
reference tutorial ``ml-inference-with-onnx.ipynb``): a healthcare AI
startup trained a diagnosis model; a hospital wants predictions on
patient data that is too sensitive to share.  The model is exported to
ONNX, imported as a predictor, and evaluated under 3-party replicated
secret sharing: the hospital never sees the weights, the startup never
sees the patients.

The model is sklearn's default logistic regression fitted with numpy
(``examples.numpy_logistic``: the card's machine has no sklearn) and
exported by the port's own ONNX encoder
(``moose_tpu_torch.predictors.sklearn_export``); ``from_onnx`` also
accepts any standard ONNX LinearClassifier/TreeEnsemble/MLP proto.
Every party's tensors live on the card unless ``--device cpu``.

    python -m moose_tpu_torch.tutorials.ml_inference_with_onnx
"""

import argparse

import numpy as np

from moose_tpu_torch import predictors
from moose_tpu_torch.examples import parse_args
from moose_tpu_torch.examples.numpy_logistic import (
    fit_logistic_regression,
    train_test_split,
)
from moose_tpu_torch.runtime import LocalMooseRuntime

LIMIT = 1e-2


def train_model(n_samples=300, n_features=10, seed=14):
    """Train a logistic-regression 'heart disease' classifier in float64
    on the reference tutorial's data and split."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_samples, n_features))
    w_true = rng.normal(size=(n_features,))
    y = (x @ w_true + 0.3 * rng.normal(size=n_samples) > 0).astype(int)
    train, test = train_test_split(n_samples, test_size=0.2, random_state=0)
    model = fit_logistic_regression(x[train], y[train])
    return model, x[test]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=8)
    args = parse_args(parser, argv)

    model, x_test = train_model()
    x = x_test[: args.batch]

    # 1. Export the trained model to ONNX (the startup does this once).
    from moose_tpu_torch.predictors import sklearn_export as ox

    onnx_proto = ox.logistic_regression_onnx(model, x.shape[1])

    # 2. Import the ONNX model as a predictor: this builds the
    #    @pm.computation that loads the input on one host, secret-shares
    #    it, runs dot + sigmoid ON SHARES, and reveals only the scores.
    predictor = predictors.from_onnx(onnx_proto)
    print(f"predictor: {type(predictor).__name__}")
    comp = predictor.predictor_factory()

    # 3. Evaluate under the local runtime (one process simulating the
    #    three parties; swap in GrpcMooseRuntime for real deployment:
    #    see scientific_computing_multiple_players --grpc).
    runtime = LocalMooseRuntime(["alice", "bob", "carole"],
                                device=args.device)
    outputs = runtime.evaluate_computation(
        comp, arguments={"x": x.astype(np.float64)}
    )
    (scores,) = outputs.values()
    scores = np.asarray(scores)

    expected = model.predict_proba(x)
    print("encrypted scores[:3]:", np.round(scores[:3], 5).tolist())
    print("float64  scores[:3]:", np.round(expected[:3], 5).tolist())
    np.testing.assert_allclose(scores, expected, atol=LIMIT)
    print("OK — encrypted inference matches the float64 model")
    return scores


if __name__ == "__main__":
    main()
