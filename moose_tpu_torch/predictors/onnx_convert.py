"""Model-type inference for ONNX imports (``from_onnx`` of
``moose_tpu/predictors/onnx_convert.py``), for the model families the
port runs so far: ``LinearRegressor`` and ``LinearClassifier``."""

from . import linear_predictor, onnx_proto

_PREDICTORS = {
    "LinearRegressor": linear_predictor.LinearRegressor,
    "LinearClassifier": linear_predictor.LinearClassifier,
}

# families of the JAX package that later slices port (ROADMAP queue 1,
# item 7)
_LATER_OP_TYPES = (
    "TreeEnsembleRegressor",
    "TreeEnsembleClassifier",
    "Conv",
)


def from_onnx(model_proto):
    """Infer and construct a predictor from an ONNX model (a ModelProto,
    serialized bytes or a path to a ``.onnx`` file)."""
    model_proto = onnx_proto.load_model(model_proto)
    op_types = [node.op_type for node in model_proto.graph.node]
    recognized = [t for t in op_types if t in _PREDICTORS]
    if len(recognized) > 1:
        raise ValueError(
            "Incompatible ONNX graph provided: graph must contain at most "
            "one LinearRegressor or LinearClassifier node, found "
            f"{recognized}"
        )
    if recognized:
        return _PREDICTORS[recognized[0]].from_onnx(model_proto)
    later = sorted(set(op_types) & set(_LATER_OP_TYPES))
    if later or model_proto.producer_name in ("pytorch", "tf2onnx"):
        raise NotImplementedError(
            f"the port does not import {later or model_proto.producer_name} "
            "models yet (ROADMAP queue 1, item 7)"
        )
    raise ValueError(
        "Incompatible ONNX graph provided: graph must contain a "
        f"LinearRegressor or LinearClassifier node, found: {op_types}"
    )
