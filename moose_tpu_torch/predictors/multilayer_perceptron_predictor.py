"""sklearn MLP predictors over the shared dense-stack core.

Imports skl2onnx-exported MLPRegressor/MLPClassifier graphs (stacked
``coefficient``/``intercepts`` initializers, one hidden activation shared
across hidden layers) — same models as the reference's
``pymoose/pymoose/predictors/multilayer_perceptron_predictor.py``, but
the network is a :class:`~.layers.DenseStack` value and the graph emission
lives in one place (:meth:`DenseStack.build`) for every predictor family.

The reference-era surface (``Activation`` enum, ``weights``/``biases``/
``activation`` attributes, ``from_onnx``) is preserved.  The port's copy
of ``moose_tpu/predictors/multilayer_perceptron_predictor.py``.
"""

import abc
from enum import Enum

import numpy as np

import moose_tpu_torch as pm

from . import predictor, predictor_utils
from .layers import DenseStack, stack_from_sklearn_mlp


class Activation(Enum):
    IDENTITY = 1
    SIGMOID = 2
    RELU = 3


_KEY_TO_ENUM = {
    "identity": Activation.IDENTITY,
    "sigmoid": Activation.SIGMOID,
    "relu": Activation.RELU,
}
_ENUM_TO_KEY = {v: k for k, v in _KEY_TO_ENUM.items()}


class MLPPredictor(predictor.Predictor, metaclass=abc.ABCMeta):
    def __init__(self, weights, biases, activation):
        super().__init__()
        self.weights = [np.asarray(w, dtype=np.float64) for w in weights]
        self.biases = [
            np.asarray(b, dtype=np.float64).ravel() for b in biases
        ]
        self.activation = activation
        hidden = _ENUM_TO_KEY[activation]
        from .layers import DenseLayer

        self._stack = DenseStack(tuple(
            DenseLayer(
                w, b,
                hidden if i < len(self.weights) - 1 else "identity",
            )
            for i, (w, b) in enumerate(zip(self.weights, self.biases))
        ))

    @classmethod
    def from_onnx(cls, model_proto):
        stack, hidden_key = stack_from_sklearn_mlp(model_proto)
        return cls(
            [layer.weights for layer in stack.layers],
            [layer.bias for layer in stack.layers],
            _KEY_TO_ENUM[hidden_key],
        )

    @abc.abstractmethod
    def post_transform(self, y, fixedpoint_dtype):
        pass

    def _mirrored_constant(self, value, dtype):
        return self.fixedpoint_constant(
            value, plc=self.mirrored, dtype=dtype
        )

    def neural_predictor_fn(self, x, fixedpoint_dtype):
        return self._stack.build(
            x, fixedpoint_dtype,
            lambda v, dtype: self._mirrored_constant(v, dtype),
        )

    def predictor_fn(self, x, fixedpoint_dtype):
        return self.neural_predictor_fn(x, fixedpoint_dtype)

    def __call__(
        self, x, fixedpoint_dtype=predictor_utils.DEFAULT_FIXED_DTYPE
    ):
        y = self.neural_predictor_fn(x, fixedpoint_dtype)
        return self.post_transform(y, fixedpoint_dtype)


class MLPRegressor(MLPPredictor):
    def post_transform(self, y, fixedpoint_dtype):
        return y


class MLPClassifier(MLPPredictor):
    def post_transform(self, y, fixedpoint_dtype):
        n_classes = self._stack.n_outputs
        if n_classes == 1:
            # binary head: emit both class probabilities, sklearn-style
            pos = pm.sigmoid(y)
            one = self._mirrored_constant(1, fixedpoint_dtype)
            return pm.concatenate([pm.sub(one, pos), pos], axis=1)
        if n_classes > 1:
            return pm.softmax(y, axis=1, upmost_index=n_classes)
        raise ValueError("Specify number of classes")
