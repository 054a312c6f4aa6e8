"""Model-type inference for ONNX imports (``from_onnx`` of
``moose_tpu/predictors/onnx_convert.py``; reference
``pymoose/pymoose/predictors/onnx_convert.py:8-92``).

``from_onnx`` sniffs the graph (op types, parameter naming, producer) and
dispatches to the matching predictor family's ``from_onnx``: the
convnet, the linear models, the sklearn MLPs, the pytorch and tf2onnx
dense networks and the tree ensembles.
"""

from . import convnet_predictor
from . import linear_predictor
from . import multilayer_perceptron_predictor
from . import neural_network_predictor
from . import onnx_proto
from . import predictor_utils
from . import tree_ensemble

_SUPPORTED_OP_TYPES = (
    "LinearRegressor",
    "LinearClassifier",
    "TreeEnsembleRegressor",
    "TreeEnsembleClassifier",
)


def from_onnx(model_proto):
    """Infer and construct a predictor from an ONNX model (a ModelProto,
    serialized bytes or a path to a ``.onnx`` file).

    Raises ``ValueError`` if the predictor type cannot be inferred or the
    graph is malformed for the inferred type."""
    model_proto = onnx_proto.load_model(model_proto)

    graph_op_types = {node.op_type for node in model_proto.graph.node}
    if "Conv" in graph_op_types:
        # a convolutional export (ResNet-style; the reference zoo is
        # Gemm-only)
        return convnet_predictor.ConvNet.from_onnx(model_proto)

    if model_proto.producer_name in ("pytorch", "tf2onnx"):
        return neural_network_predictor.NeuralNetwork.from_onnx(model_proto)

    recognized_ops = []
    unrecognized_ops = []
    for node in model_proto.graph.node:
        if node.op_type in _SUPPORTED_OP_TYPES:
            recognized_ops.append(node.op_type)
        else:
            unrecognized_ops.append(node.op_type)
    n_coefficients = len(
        predictor_utils.find_parameters_in_model_proto(
            model_proto, "coefficient", enforce=False
        )
    )

    if len(recognized_ops) > 1:
        raise ValueError(
            "Incompatible ONNX graph provided: graph must contain at most "
            "one node of type LinearRegressor or LinearClassifier or "
            "TreeEnsembleRegressor or TreeEnsembleClassifier, found "
            f"{recognized_ops}"
        )
    if recognized_ops:
        return {
            "LinearRegressor": linear_predictor.LinearRegressor,
            "LinearClassifier": linear_predictor.LinearClassifier,
            "TreeEnsembleRegressor": tree_ensemble.TreeEnsembleRegressor,
            "TreeEnsembleClassifier": tree_ensemble.TreeEnsembleClassifier,
        }[recognized_ops[0]].from_onnx(model_proto)
    if n_coefficients > 1:
        # sklearn MLPs have no marker node but carry stacked coefficient
        # initializers; classifiers additionally ZipMap
        mlp = multilayer_perceptron_predictor
        classes = predictor_utils.find_node_in_model_proto(
            model_proto, "ZipMap", enforce=False
        )
        cls = mlp.MLPRegressor if classes is None else mlp.MLPClassifier
        return cls.from_onnx(model_proto)
    raise ValueError(
        "Incompatible ONNX graph provided: graph must contain a "
        "LinearRegressor or LinearClassifier or TreeEnsembleRegressor or "
        f"TreeEnsembleClassifier node, found: {unrecognized_ops}"
    )
