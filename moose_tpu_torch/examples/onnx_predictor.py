"""ONNX model import + encrypted inference through the predictor zoo
(reference pymoose/pymoose/predictors): train in float64, export to
ONNX, score under 3-party replicated sharing.  The port's program of
``examples/onnx_predictor.py``: the model is fitted with numpy
(``numpy_logistic``, sklearn's default objective) instead of sklearn,
and scored on the card unless ``--device cpu``.

  python -m moose_tpu_torch.examples.onnx_predictor [--device cpu]
"""

import argparse

import numpy as np

from moose_tpu_torch import predictors
from moose_tpu_torch.examples import parse_args
from moose_tpu_torch.examples.numpy_logistic import fit_logistic_regression
from moose_tpu_torch.predictors.sklearn_export import logistic_regression_onnx
from moose_tpu_torch.runtime import LocalMooseRuntime

LIMIT = 5e-3


def model_and_query():
    """The fitted float64 model, its ONNX bytes and the 16 query rows."""
    rng = np.random.default_rng(2)
    x_train = rng.normal(size=(200, 20))
    y_train = (rng.uniform(size=200) > 0.5).astype(int)
    model = fit_logistic_regression(x_train, y_train)
    onnx_bytes = logistic_regression_onnx(model, n_features=20).encode()
    return model, onnx_bytes, rng.normal(size=(16, 20))


def main(argv=None):
    """Score the query under MPC and check it against the float64 model;
    returns the secure probabilities."""
    parser = argparse.ArgumentParser(description=__doc__)
    args = parse_args(parser, argv)

    fitted, onnx_bytes, x = model_and_query()
    model = predictors.from_onnx(onnx_bytes)
    comp = model.predictor_factory()

    runtime = LocalMooseRuntime(["alice", "bob", "carole"],
                                device=args.device)
    (probs,) = runtime.evaluate_computation(
        comp, arguments={"x": x}
    ).values()
    gap = np.abs(probs - fitted.predict_proba(x)).max()
    print(f"max |secure - float64 model| probability gap: {gap:.2e}")
    if not gap < LIMIT:
        raise AssertionError(f"probability gap {gap} >= {LIMIT}")
    print("OK")
    return probs


if __name__ == "__main__":
    main()
