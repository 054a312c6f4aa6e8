"""Helpers for walking ONNX model protos (reference:
``pymoose/pymoose/predictors/predictor_utils.py``).

Works identically on the bundled shim (``onnx_proto``) and a real
``onnx.ModelProto`` — both expose the same attribute surface.

The port's own copy of ``moose_tpu/predictors/predictor_utils.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from .. import dtypes

DEFAULT_FLOAT_DTYPE = dtypes.float64
DEFAULT_FIXED_DTYPE = dtypes.fixed(24, 40)


def find_attribute_in_node(node, attribute_name, enforce=True):
    for attr in node.attribute:
        if attr.name == attribute_name:
            return attr
    if enforce:
        raise ValueError(
            f"Node {node.name} does not contain attribute {attribute_name}."
        )
    return None


def find_input_shape(input_node):
    return input_node.type.tensor_type.shape.dim


def find_node_in_model_proto(model_proto, operator_name, enforce=True):
    """Find a graph node by op_type or by name (the reference matches on
    ``node.name``, but skl2onnx frequently leaves names empty and the
    reference's own call sites pass op_type strings — matching either way
    covers both)."""
    for node in model_proto.graph.node:
        if operator_name in (node.op_type, node.name):
            return node
    if enforce:
        raise ValueError(
            f"Model proto does not contain operator {operator_name}."
        )
    return None


def find_initializer_in_model_proto(model_proto, operator_name, enforce=True):
    for initializer in model_proto.graph.initializer:
        if initializer.name == operator_name:
            return initializer, initializer.dims
    if enforce:
        raise ValueError(
            f"Model proto does not contain operator {operator_name}."
        )
    return None, None


def find_activation_in_model_proto(model_proto, operator_name, enforce=True):
    """Return the op_type of the node producing output `operator_name`.

    The reference returns ``node.name`` here and compares against strings
    like "Sigmoid"; skl2onnx names nodes after their op type so both work,
    but op_type is the robust signal."""
    for node in model_proto.graph.node:
        if node.output and node.output[0] == operator_name:
            return node.op_type
    if enforce:
        raise ValueError(
            f"Model proto does not contain operator {operator_name}."
        )
    return None


def find_parameters_in_model_proto(model_proto, operator_names, enforce=True):
    if isinstance(operator_names, str):
        operator_names = [operator_names]
    parameters = []
    for initializer in model_proto.graph.initializer:
        if any(name in initializer.name for name in operator_names):
            parameters.append(initializer)
    if enforce and not parameters:
        raise ValueError(
            f"Model proto does not contain parameters {operator_names}."
        )
    return parameters


def find_op_types_in_model_proto(model_proto, enforce=True):
    operations = [node.op_type for node in model_proto.graph.node]
    if enforce and not operations:
        raise ValueError("Model proto nodes do not contain op_type.")
    return operations


def input_n_features(model_proto):
    """Feature count from the model's rank-2 input declaration (shared
    validation for every ONNX importer)."""
    model_input = model_proto.graph.input[0]
    input_shape = find_input_shape(model_input)
    if len(input_shape) != 2:
        raise ValueError(
            f"expected rank-2 model input, found rank {len(input_shape)}"
        )
    return input_shape[1].dim_value
