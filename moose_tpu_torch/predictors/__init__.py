"""Predictors: encrypted inference over imported models, and the SGD
trainers.  The port runs ``LinearRegressor``, ``LinearClassifier`` and
the trainers' step (``LogregSGDTrainer``, ``MLPSGDTrainer``) so far (see
ROADMAP.md for the other families)."""

from . import linear_predictor
from . import onnx_convert
from . import onnx_proto
from . import predictor
from . import predictor_utils
from . import sklearn_export
from . import trainers
from .linear_predictor import LinearClassifier, LinearRegressor
from .onnx_convert import from_onnx
from .predictor import Predictor
from .trainers import LogregSGDTrainer, MLPSGDTrainer, SecureTrainer

__all__ = [
    "LinearClassifier",
    "LinearRegressor",
    "LogregSGDTrainer",
    "MLPSGDTrainer",
    "Predictor",
    "SecureTrainer",
    "from_onnx",
    "linear_predictor",
    "onnx_convert",
    "onnx_proto",
    "predictor",
    "predictor_utils",
    "sklearn_export",
    "trainers",
]
