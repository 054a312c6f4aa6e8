"""Generic feed-forward NN predictor for pytorch / tf2onnx exports, over
the shared dense-stack core.

Same model coverage as the reference's
``pymoose/pymoose/predictors/neural_network_predictor.py`` (Gemm /
MatMul+Add graphs with per-layer sigmoid/relu/softmax/identity
activations); the framework-layout quirks live in
:func:`~.layers.stack_from_torch_or_tf` and the graph emission in
:meth:`~.layers.DenseStack.build`, shared with the MLP family.  The
port's copy of ``moose_tpu/predictors/neural_network_predictor.py``.
"""

from enum import Enum

import numpy as np

import moose_tpu_torch as pm  # noqa: F401 — public convenience re-export

from . import predictor, predictor_utils
from .layers import DenseLayer, DenseStack, stack_from_torch_or_tf


class Activation(Enum):
    IDENTITY = 1
    SIGMOID = 2
    SOFTMAX = 3
    RELU = 4


_KEY_TO_ENUM = {
    "identity": Activation.IDENTITY,
    "sigmoid": Activation.SIGMOID,
    "softmax": Activation.SOFTMAX,
    "relu": Activation.RELU,
}
_ENUM_TO_KEY = {v: k for k, v in _KEY_TO_ENUM.items()}


class NeuralNetwork(predictor.Predictor):
    def __init__(self, weights, biases, activations):
        super().__init__()
        self.weights = [np.asarray(w, dtype=np.float64) for w in weights]
        self.biases = [
            np.asarray(b, dtype=np.float64).ravel() for b in biases
        ]
        self.activations = list(activations)
        self.n_classes = self.biases[-1].shape[0]
        self._stack = DenseStack(tuple(
            DenseLayer(w, b, _ENUM_TO_KEY[a])
            for w, b, a in zip(
                self.weights, self.biases, self.activations
            )
        ))

    @classmethod
    def from_onnx(cls, model_proto):
        stack = stack_from_torch_or_tf(model_proto)
        return cls(
            [layer.weights for layer in stack.layers],
            [layer.bias for layer in stack.layers],
            [_KEY_TO_ENUM[layer.activation] for layer in stack.layers],
        )

    def predictor_fn(self, x, fixedpoint_dtype):
        return self._stack.build(
            x, fixedpoint_dtype,
            lambda v, dtype: self.fixedpoint_constant(
                v, plc=self.mirrored, dtype=dtype
            ),
        )

    def __call__(
        self, x, fixedpoint_dtype=predictor_utils.DEFAULT_FIXED_DTYPE
    ):
        return self.predictor_fn(x, fixedpoint_dtype)
