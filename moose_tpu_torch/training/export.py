"""Trained-model export: revealed weights -> ONNX -> a predictor.

The port's own copy of ``moose_tpu/training/export.py``: the weights a
:class:`~moose_tpu_torch.training.session.TrainingSession` revealed to
the model receiver become a standard predictor artifact, the same
skl2onnx-layout bytes as the JAX package writes.  Replacing the live
version in a serving registry (:func:`hot_swap`) needs the port's
``serving/`` (ROADMAP queue 1, item 11) and raises until then.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np

from ..predictors import sklearn_export


def logreg_onnx_bytes(weights: np.ndarray,
                      intercept: Optional[np.ndarray] = None) -> bytes:
    """Serialize trained logistic-regression weights as a
    skl2onnx-layout LinearClassifier ONNX model (binary: both class
    rows, LOGISTIC post-transform), importable by ``from_onnx``.
    ``weights`` is the trainer's (n_features, 1) column; the intercept
    defaults to zero (the SGD trainers are bias-free)."""
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    shim = SimpleNamespace(
        coef_=w[None, :],
        intercept_=np.zeros(1) if intercept is None else (
            np.asarray(intercept, dtype=np.float64).reshape(1)
        ),
        classes_=np.array([0, 1]),
    )
    return sklearn_export.logistic_regression_onnx(
        shim, n_features=w.shape[0]
    ).encode()


def trained_predictor(weights: np.ndarray,
                      intercept: Optional[np.ndarray] = None) -> Any:
    """A ``predictors`` instance for the trained logistic-regression
    weights (the object form of :func:`logreg_onnx_bytes`)."""
    from ..predictors import from_onnx

    return from_onnx(logreg_onnx_bytes(weights, intercept))


def onnx_digest(raw: bytes, n_features: int, max_batch: int) -> str:
    """The fleet's source-digest formula for an ONNX artifact: the raw
    bytes plus the registration shape knobs that change the warm
    state."""
    return hashlib.blake2b(
        bytes(raw) + repr((int(n_features), int(max_batch))).encode(),
        digest_size=16,
    ).hexdigest()


def hot_swap(server: Any, name: str, weights: np.ndarray,
             intercept: Optional[np.ndarray] = None) -> Any:
    """Replace the live model ``name`` on an in-process inference server
    with freshly trained weights.  The port has no ``serving/`` yet."""
    raise NotImplementedError(
        "hot_swap needs the port's serving/ (InferenceServer."
        "replace_model): ROADMAP queue 1, item 11"
    )
