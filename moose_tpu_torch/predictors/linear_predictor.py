"""Linear regression and classification predictors.

The ``LinearRegressor`` and ``LinearClassifier`` of
``moose_tpu/predictors/linear_predictor.py`` and their
``LinearPredictor`` base: import the ``ai.onnx.ml`` LinearRegressor /
LinearClassifier operators and build the encrypted inference graph — one
replicated fixed-point ``dot`` against mirrored weights, the intercept
folded in by augmenting the input with a ones column,
``y = [1; x] @ [b; W]^T`` — followed by the classifier's head.  The
LOGISTIC head runs the protocol sigmoid; the SOFTMAX head (multinomial
logistic regression) the protocol softmax over the classes.
"""

import abc
import dataclasses
from enum import Enum
from typing import Optional

import numpy as np

import moose_tpu_torch as pm

from . import predictor, predictor_utils


class PostTransform(Enum):
    """Variants of output processing for linear classification."""

    NONE = 1
    SIGMOID = 2
    SOFTMAX = 3


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


def _read_class_count(node) -> int:
    for attr_name in ("classlabels_ints", "classlabels_strings"):
        attr = predictor_utils.find_attribute_in_node(
            node, attr_name, enforce=False
        )
        if attr is None:
            continue
        labels = attr.ints if attr_name == "classlabels_ints" else attr.strings
        if len(labels):
            return len(labels)
    raise ValueError("LinearClassifier carries no class labels")


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


# post-transform -> head builder factory; the builder receives n_classes
# and returns the graph function
def _sigmoid_head(n_classes):
    if n_classes < 2:
        raise ValueError(
            "Could not infer post-transform in LinearClassifier"
        )
    if n_classes == 2:
        return lambda y: pm.sigmoid(y)

    def normalized(y):
        # sklearn's one-vs-rest probability normalization: sigmoid, then
        # divide by the row sum (instead of softmax)
        s = pm.sigmoid(y)
        return pm.div(s, pm.expand_dims(pm.sum(s, 1), 1))

    return normalized


_HEADS = {
    PostTransform.NONE: lambda n: (lambda y: y),
    PostTransform.SIGMOID: _sigmoid_head,
    PostTransform.SOFTMAX: lambda n: (
        lambda y: pm.softmax(y, axis=1, upmost_index=n)
    ),
}

_ONNX_POST_TRANSFORMS = {
    "NONE": PostTransform.NONE,
    "LOGISTIC": PostTransform.SIGMOID,
    "SOFTMAX": PostTransform.SOFTMAX,
}


def _mirrored_pair(w: LinearWeights) -> bool:
    """True when the two class rows are exact mirrors (-w0 == w1 bitwise,
    intercepts likewise), the layout of sklearn's binary LinearClassifier
    export.  Near-mirrors stay on the two-sigmoid path."""
    if not np.array_equal(w.coeffs[0], -w.coeffs[1]):
        return False
    if w.intercepts is None:
        return True
    return np.array_equal(w.intercepts[:, 0], -w.intercepts[:, 1])


class LinearClassifier(LinearPredictor):
    """Linear classifier predictor.

    Args:
        coeffs: array-like (n_classes, n_features).
        intercepts: optional array-like vector.
        post_transform: PostTransform variant mapping raw scores to
            probabilities.
    """

    def __init__(self, coeffs, intercepts=None, post_transform=None):
        super().__init__(coeffs, intercepts)
        head_factory = _HEADS.get(post_transform)
        if head_factory is None:
            raise ValueError(
                "Could not infer post-transform in LinearClassifier"
            )
        self._head = head_factory(self._weights.n_outputs)
        # the binary export's class rows are exact mirrors (-w, +w): the
        # two logit columns are -z and z, so one protocol sigmoid serves
        # both columns
        self._mirrored_binary = (
            post_transform is PostTransform.SIGMOID
            and self._weights.n_outputs == 2
            and _mirrored_pair(self._weights)
        )

    @classmethod
    def from_onnx(cls, model_proto):
        node = _require_node(model_proto, "LinearClassifier")
        n_classes = _read_class_count(node)
        coeffs = _read_floats(node, "coefficients").reshape(n_classes, -1)
        _check_feature_count(model_proto, coeffs.shape[1])
        intercepts = _read_floats(node, "intercepts", required=False)
        if intercepts is not None:
            intercepts = intercepts.reshape(1, n_classes)
        pt_attr = predictor_utils.find_attribute_in_node(
            node, "post_transform"
        )
        pt_name = bytes(pt_attr.s).decode()
        post_transform = _ONNX_POST_TRANSFORMS.get(pt_name)
        if post_transform is None:
            raise RuntimeError(
                f"{pt_name} post_transform is unsupported for "
                "LinearClassifier."
            )
        return cls(
            coeffs=coeffs, intercepts=intercepts,
            post_transform=post_transform,
        )

    def __call__(self, x,
                 fixedpoint_dtype=predictor_utils.DEFAULT_FIXED_DTYPE):
        y = self.predictor_fn(x, fixedpoint_dtype)
        if self._mirrored_binary:
            return self._complement_sigmoid(y, fixedpoint_dtype)
        return self.post_transform(y)

    def _complement_sigmoid(self, y, fixedpoint_dtype):
        """[1 - p, p] from one sigmoid of the positive-class logit: exact
        for the real sigmoid (sigmoid(-z) = 1 - sigmoid(z)); the
        complement column inherits the positive column's approximation
        error."""
        pos = pm.sigmoid(pm.index_axis(y, axis=1, index=1))
        pos = pm.expand_dims(pos, axis=1)
        one = self.fixedpoint_constant(
            1, plc=self.mirrored, dtype=fixedpoint_dtype
        )
        return pm.concatenate([pm.sub(one, pos), pos], axis=1)

    def post_transform(self, y):
        return self._head(y)
