"""Export linear models to skl2onnx-style ONNX with the bundled protobuf
encoder (``linear_regressor_onnx`` and ``logistic_regression_onnx`` of
``moose_tpu/predictors/sklearn_export.py``).

Only ``coef_``, ``intercept_`` and (for classifiers) ``classes_`` are
read, so any object carrying them — a fitted sklearn model or a
``types.SimpleNamespace`` — exports.
"""

import numpy as np

from . import onnx_proto as op

FLOAT = op.TensorProto.FLOAT


def _model(nodes, n_features, producer="skl2onnx", n_outputs=1):
    graph = op.GraphProto(
        name="test_graph",
        node=list(nodes),
        initializer=[],
        input=[
            op.make_tensor_value_info("float_input", FLOAT, [None, n_features])
        ],
        output=[
            op.make_tensor_value_info("variable", FLOAT, [None, n_outputs])
        ],
    )
    return op.make_model(graph, producer_name=producer)


def linear_regressor_onnx(sk_model, n_features):
    coef = np.atleast_2d(np.asarray(sk_model.coef_, dtype=np.float64))
    intercept = np.atleast_1d(np.asarray(sk_model.intercept_))
    node = op.make_node(
        "LinearRegressor",
        ["float_input"],
        ["variable"],
        name="LinearRegressor",
        coefficients=[float(v) for v in coef.ravel()],
        intercepts=[float(v) for v in intercept.ravel()],
        targets=coef.shape[0],
    )
    return _model([node], n_features, n_outputs=coef.shape[0])


def logistic_regression_onnx(sk_model, n_features):
    """skl2onnx layout for LogisticRegression: binary models carry both
    class rows (the negated row for class 0) with the LOGISTIC
    post-transform; multinomial models carry raw rows with SOFTMAX."""
    coef = np.asarray(sk_model.coef_, dtype=np.float64)
    intercept = np.asarray(sk_model.intercept_, dtype=np.float64)
    n_classes = len(sk_model.classes_)
    if n_classes == 2:
        coefficients = np.concatenate([-coef, coef], axis=0)
        intercepts = np.concatenate([-intercept, intercept])
        post = "LOGISTIC"
    else:
        coefficients = coef
        intercepts = intercept
        post = "SOFTMAX"
    node = op.make_node(
        "LinearClassifier",
        ["float_input"],
        ["label", "probabilities"],
        name="LinearClassifier",
        coefficients=[float(v) for v in coefficients.ravel()],
        intercepts=[float(v) for v in intercepts.ravel()],
        classlabels_ints=[int(c) for c in sk_model.classes_],
        post_transform=post,
        multi_class=0,
    )
    return _model([node], n_features, n_outputs=n_classes)
