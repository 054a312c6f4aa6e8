"""Dense feed-forward building blocks shared by the predictor zoo.

This module is the repo's own altitude for the model families the
reference implements twice over (sklearn MLP graphs in
``pymoose/pymoose/predictors/multilayer_perceptron_predictor.py``,
pytorch/tf2onnx exports in ``neural_network_predictor.py``): every one of
those models is a stack of dense layers with per-layer activations, so
the stack is represented ONCE as data (:class:`DenseLayer` /
:class:`DenseStack`) and the per-framework ONNX quirks live in small
extraction functions instead of per-class graph-walking methods.

The port's copy of ``moose_tpu/predictors/layers.py``: the same layers
emit the same eDSL ops in the same order, so the port draws the masks
the JAX package draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

import moose_tpu_torch as pm

from . import onnx_proto, predictor_utils

# ---------------------------------------------------------------------------
# Activation registry: name -> graph builder (z, n_classes) -> expression.
# A registry (rather than per-class if/elif chains) so new activations are
# one entry and every predictor family shares the same vocabulary.
# ---------------------------------------------------------------------------

ACTIVATIONS: dict = {
    "identity": lambda z, n: z,
    "sigmoid": lambda z, n: pm.sigmoid(z),
    "relu": lambda z, n: pm.relu(z),
    "softmax": lambda z, n: pm.softmax(z, axis=1, upmost_index=n),
}


def resolve_activation(name: Optional[str]) -> str:
    """Normalize an ONNX activation node/attribute name to a registry key
    ("Sigmoid" -> "sigmoid", None -> "identity")."""
    if not name:
        return "identity"
    key = str(name).lower()
    if key in ACTIVATIONS:
        return key
    raise ValueError(f"unsupported activation {name!r}")


@dataclasses.dataclass(frozen=True)
class DenseLayer:
    """One affine layer y = x @ W + b with an activation key."""

    weights: np.ndarray  # (in, out), float64
    bias: np.ndarray  # (out,), float64
    activation: str = "identity"

    def __post_init__(self):
        if self.weights.ndim != 2:
            raise ValueError(
                f"dense weights must be rank-2, found {self.weights.shape}"
            )
        if self.bias.ndim != 1 or self.bias.shape[0] != self.weights.shape[1]:
            raise ValueError(
                f"dense bias {self.bias.shape} does not match weights "
                f"{self.weights.shape}"
            )


@dataclasses.dataclass(frozen=True)
class DenseStack:
    """An ordered stack of dense layers plus the class count of the head
    (used by softmax's static tournament width)."""

    layers: tuple

    @property
    def n_outputs(self) -> int:
        return self.layers[-1].weights.shape[1]

    @property
    def n_features(self) -> int:
        return self.layers[0].weights.shape[0]

    def check_features(self, model_proto) -> "DenseStack":
        n = predictor_utils.input_n_features(model_proto)
        if n != self.n_features:
            raise ValueError(
                f"In the ONNX file, the input shape has {n} features and "
                "the shape of the weights for the first layer is: "
                f"{self.layers[0].weights.shape}. Validate you set "
                "correctly the `initial_types` when converting your "
                "model to ONNX."
            )
        return self

    def build(self, x, fixedpoint_dtype, constant_fn,
              head_transform: Optional[Callable] = None):
        """Emit the replicated graph: each layer is one fixed dot against
        mirrored constants + bias, then its activation; the optional
        ``head_transform`` replaces the LAST layer's activation (the
        classifier families decide the head at call time)."""
        n_out = self.n_outputs
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            w = constant_fn(layer.weights, dtype=fixedpoint_dtype)
            b = constant_fn(layer.bias, dtype=fixedpoint_dtype)
            x = pm.add(pm.dot(x, w), b)
            if i == last and head_transform is not None:
                return head_transform(x)
            x = ACTIVATIONS[layer.activation](x, n_out)
        return x


# ---------------------------------------------------------------------------
# ONNX extraction helpers (framework quirks, one place each)
# ---------------------------------------------------------------------------


def _as_arrays(tensors, transpose: bool) -> list:
    out = []
    for t in tensors:
        arr = onnx_proto.tensor_to_numpy(t).astype(np.float64)
        out.append(arr.T if transpose else arr)
    return out


def stack_from_sklearn_mlp(model_proto) -> tuple:
    """(DenseStack, hidden-activation key) from an skl2onnx MLP export:
    parameters are ``coefficient``/``intercepts`` initializers already in
    (in, out) layout, with ONE shared hidden activation announced by the
    ``next_activations`` node chain."""
    weights = _as_arrays(
        predictor_utils.find_parameters_in_model_proto(
            model_proto, ["coefficient"], enforce=False
        ),
        transpose=False,
    )
    biases = _as_arrays(
        predictor_utils.find_parameters_in_model_proto(
            model_proto, ["intercepts"], enforce=False
        ),
        transpose=False,
    )
    act = resolve_activation(
        predictor_utils.find_activation_in_model_proto(
            model_proto, "next_activations", enforce=False
        )
    )
    layers = []
    for i, (w, b) in enumerate(zip(weights, biases)):
        hidden = i < len(weights) - 1
        layers.append(DenseLayer(
            w, b.ravel(), act if hidden else "identity"
        ))
    stack = DenseStack(tuple(layers)).check_features(model_proto)
    return stack, act


def stack_from_torch_or_tf(model_proto) -> DenseStack:
    """DenseStack from a pytorch (Gemm) or tf2onnx (MatMul+Add) export,
    with per-layer activations read off the node sequence.

    Layout quirks handled here and nowhere else:
    - pytorch Gemm stores W as (out, in) and computes x @ W^T -> transpose;
    - tf2onnx lists parameters last-layer-first and its MatMul weights
      are already (in, out) -> reverse, no transpose;
    - consecutive affine nodes imply an identity activation between them;
    - a bare affine head (regressor) has no trailing activation node.
    """
    ops = predictor_utils.find_op_types_in_model_proto(model_proto)
    acts: list = []
    for i, op in enumerate(ops):
        if op in ("Sigmoid", "Softmax", "Relu"):
            acts.append(op.lower())
        if i > 0 and op == "Gemm" and ops[i - 1] == "Gemm":
            acts.append("identity")
        if (
            i > 2
            and op == "Add"
            and ops[i - 1] == "MatMul"
            and ops[i - 2] == "Add"
            and ops[i - 3] == "MatMul"
        ):
            acts.append("identity")

    from_tf = "tf" in model_proto.producer_name
    weights = _as_arrays(
        predictor_utils.find_parameters_in_model_proto(
            model_proto, ["weight", "MatMul"], enforce=False
        ),
        transpose=not from_tf,
    )
    biases = [
        b.ravel()
        for b in _as_arrays(
            predictor_utils.find_parameters_in_model_proto(
                model_proto, ["bias", "BiasAdd"], enforce=False
            ),
            transpose=False,
        )
    ]
    if from_tf:
        weights = weights[::-1]
        biases = biases[::-1]
    while len(acts) < len(weights):
        acts.append("identity")
    layers = tuple(
        DenseLayer(w, b, a) for w, b, a in zip(weights, biases, acts)
    )
    return DenseStack(layers).check_features(model_proto)
