"""Linear regression predictor.

The ``LinearRegressor`` of ``moose_tpu/predictors/linear_predictor.py``
and its ``LinearPredictor`` base: imports the ``ai.onnx.ml``
LinearRegressor operator and builds the encrypted inference graph — one
replicated fixed-point ``dot`` against mirrored weights, the intercept
folded in by augmenting the input with a ones column,
``y = [1; x] @ [b; W]^T``.  The classifier heads (sigmoid, softmax) are
the next slice.
"""

import abc
import dataclasses
from typing import Optional

import numpy as np

import moose_tpu_torch as pm

from . import predictor, predictor_utils


@dataclasses.dataclass(frozen=True)
class LinearWeights:
    """Validated (coefficients, optional intercepts) pair: ``coeffs`` is
    (n_outputs, n_features), ``intercepts`` (1, n_outputs) or None."""

    coeffs: np.ndarray
    intercepts: Optional[np.ndarray]

    @classmethod
    def of(cls, coeffs, intercepts) -> "LinearWeights":
        coeffs = np.asarray(coeffs, dtype=np.float64)
        if coeffs.ndim == 1:
            coeffs = coeffs[None, :]
        elif coeffs.ndim != 2:
            raise ValueError(
                "Coeffs must be convertible to a rank-2 tensor, found "
                f"shape of {coeffs.shape}."
            )
        if intercepts is not None:
            intercepts = np.asarray(intercepts, dtype=np.float64)
            if intercepts.ndim == 1:
                intercepts = intercepts[None, :]
            if intercepts.ndim != 2 or intercepts.shape[0] != 1:
                raise ValueError(
                    "Intercept must be convertible to a vector, found "
                    f"shape of {intercepts.shape}."
                )
            if coeffs.shape[0] != intercepts.shape[-1]:
                raise ValueError(
                    "Shape mismatch between model coefficients and "
                    f"intercepts: Intercepts size of {coeffs.shape[0]} "
                    "inferred from coefficients, found "
                    f"{intercepts.shape[-1]}."
                )
        return cls(coeffs, intercepts)

    @property
    def n_outputs(self) -> int:
        return self.coeffs.shape[0]

    def augmented_matrix(self) -> np.ndarray:
        """[b; W]^T — the single mirrored constant the dot consumes when
        an intercept is present."""
        return np.concatenate([self.intercepts.T, self.coeffs], axis=1).T


class LinearPredictor(predictor.Predictor, metaclass=abc.ABCMeta):
    def __init__(self, coeffs, intercepts=None):
        super().__init__()
        self._weights = LinearWeights.of(coeffs, intercepts)

    @property
    def coeffs(self) -> np.ndarray:
        return self._weights.coeffs

    @property
    def intercepts(self) -> Optional[np.ndarray]:
        return self._weights.intercepts

    @classmethod
    @abc.abstractmethod
    def from_onnx(cls, model_proto):
        pass

    @abc.abstractmethod
    def post_transform(self, y):
        pass

    @classmethod
    def bias_trick(cls, x, plc, dtype):
        """A column of ones broadcastable against ``x``, so the intercept
        rides the same dot product as the coefficients."""
        ones = pm.ones(
            pm.shape(x, placement=plc)[0:1], dtype=pm.float64,
            placement=plc,
        )
        return pm.cast(
            pm.expand_dims(ones, 1, placement=plc), dtype=dtype,
            placement=plc,
        )

    def predictor_fn(self, x, fixedpoint_dtype):
        """The core linear map y = [1; x] @ [b; W]^T on shares."""
        w = self._weights
        if w.intercepts is None:
            matrix = w.coeffs.T
        else:
            matrix = w.augmented_matrix()
            ones = self.bias_trick(x, plc=self.bob, dtype=fixedpoint_dtype)
            x = pm.concatenate([ones, x], axis=1)
        mirrored_w = self.fixedpoint_constant(
            matrix, plc=self.mirrored, dtype=fixedpoint_dtype
        )
        return pm.dot(x, mirrored_w)

    def __call__(self, x,
                 fixedpoint_dtype=predictor_utils.DEFAULT_FIXED_DTYPE):
        return self.post_transform(self.predictor_fn(x, fixedpoint_dtype))


_FLOATS_ATTR_TYPE = 6  # AttributeProto.FLOATS


def _read_floats(node, name, required=True) -> Optional[np.ndarray]:
    attr = predictor_utils.find_attribute_in_node(node, name, enforce=False)
    if attr is None:
        if required:
            raise ValueError(
                f"{node.op_type} is missing required attribute {name!r}"
            )
        return None
    if attr.type != _FLOATS_ATTR_TYPE:
        raise ValueError(
            f"{node.op_type} {name} must be of type FLOATS, found other."
        )
    return np.asarray(list(attr.floats), dtype=np.float64)


def _require_node(model_proto, op_type):
    node = predictor_utils.find_node_in_model_proto(
        model_proto, op_type, enforce=False
    )
    if node is None:
        raise ValueError(
            "Incompatible ONNX graph provided: graph must contain a "
            f"{op_type} operator."
        )
    return node


def _check_feature_count(model_proto, n_coeffs):
    n_features = predictor_utils.input_n_features(model_proto)
    if n_features != n_coeffs:
        raise ValueError(
            f"In the ONNX file, the input shape has {n_features} "
            f"features and there are {n_coeffs} coefficients. Validate "
            "you set correctly the `initial_types` when converting "
            "your model to ONNX."
        )


class LinearRegressor(LinearPredictor):
    """Linear regression predictor.

    Args:
        coeffs: array-like (n_targets, n_features).
        intercepts: optional array-like vector.
    """

    def post_transform(self, y):
        return y

    @classmethod
    def from_onnx(cls, model_proto):
        node = _require_node(model_proto, "LinearRegressor")
        coeffs = _read_floats(node, "coefficients")
        intercepts = _read_floats(node, "intercepts", required=False)
        targets = predictor_utils.find_attribute_in_node(
            node, "targets", enforce=False
        )
        if targets is not None:
            coeffs = coeffs.reshape(targets.i, -1)
        _check_feature_count(model_proto, coeffs.shape[-1])
        return cls(coeffs=coeffs, intercepts=intercepts)
