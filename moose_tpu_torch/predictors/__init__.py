"""Predictors: encrypted inference over imported models, and the SGD
trainers.  The port runs the linear models (``LinearRegressor``,
``LinearClassifier``), the dense networks (``MLPRegressor``,
``MLPClassifier``, ``NeuralNetwork``), the tree ensembles
(``TreeEnsembleRegressor``, ``TreeEnsembleClassifier``), the convnet
(``ConvNet``), the trainers' step (``LogregSGDTrainer``,
``MLPSGDTrainer``) and the AES input wrapper (``AesWrapper``), which
gives any of those predictors an encrypted-input front end."""

from . import convnet_predictor
from . import layers
from . import linear_predictor
from . import multilayer_perceptron_predictor
from . import neural_network_predictor
from . import onnx_convert
from . import onnx_proto
from . import predictor
from . import predictor_utils
from . import sklearn_export
from . import trainers
from . import tree_ensemble
from .convnet_predictor import ConvNet
from .linear_predictor import LinearClassifier, LinearRegressor
from .multilayer_perceptron_predictor import MLPClassifier, MLPRegressor
from .neural_network_predictor import NeuralNetwork
from .onnx_convert import from_onnx
from .predictor import AesWrapper, Predictor
from .trainers import LogregSGDTrainer, MLPSGDTrainer, SecureTrainer
from .tree_ensemble import (
    DecisionTreeRegressor,
    TreeEnsembleClassifier,
    TreeEnsembleRegressor,
)

__all__ = [
    "AesWrapper",
    "ConvNet",
    "DecisionTreeRegressor",
    "LinearClassifier",
    "LinearRegressor",
    "LogregSGDTrainer",
    "MLPClassifier",
    "MLPRegressor",
    "MLPSGDTrainer",
    "NeuralNetwork",
    "Predictor",
    "SecureTrainer",
    "TreeEnsembleClassifier",
    "TreeEnsembleRegressor",
    "convnet_predictor",
    "from_onnx",
    "layers",
    "linear_predictor",
    "multilayer_perceptron_predictor",
    "neural_network_predictor",
    "onnx_convert",
    "onnx_proto",
    "predictor",
    "predictor_utils",
    "sklearn_export",
    "trainers",
    "tree_ensemble",
]
