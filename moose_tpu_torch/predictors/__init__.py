"""Predictors: encrypted inference over imported models.  The port runs
``LinearRegressor`` and ``LinearClassifier`` so far (see ROADMAP.md for
the other families)."""

from . import linear_predictor
from . import onnx_convert
from . import onnx_proto
from . import predictor
from . import predictor_utils
from . import sklearn_export
from .linear_predictor import LinearClassifier, LinearRegressor
from .onnx_convert import from_onnx
from .predictor import Predictor

__all__ = [
    "LinearClassifier",
    "LinearRegressor",
    "Predictor",
    "from_onnx",
    "linear_predictor",
    "onnx_convert",
    "onnx_proto",
    "predictor",
    "predictor_utils",
    "sklearn_export",
]
