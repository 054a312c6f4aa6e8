"""Carry state between the JAX package and the port, through numpy.

Ring words cross as a bitcast: numpy ``uint64`` on the JAX side, the
same 64 bits as ``torch.int64`` here.  Everything takes and returns numpy
arrays only, so this module imports neither ``jax`` nor ``moose_tpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices


def ring_from_numpy(lo_u64: np.ndarray, hi_u64: Optional[np.ndarray] = None,
                    device=devices.DEFAULT_DEVICE
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(lo, hi) uint64 arrays -> (lo, hi) int64 ring words on ``device``
    (``hi`` None for ring64)."""
    dev = devices.resolve(device)

    def words(a):
        # a copy, not np.ascontiguousarray: that makes a 0-d array 1-d
        a = np.array(a, dtype=np.uint64, order="C")
        return torch.from_numpy(a.view(np.int64)).to(dev)

    return words(lo_u64), None if hi_u64 is None else words(hi_u64)


def ring_to_numpy(lo: torch.Tensor, hi: Optional[torch.Tensor] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(lo, hi) int64 ring words -> (lo, hi) uint64 numpy arrays."""

    def words(t):
        return t.detach().cpu().contiguous().numpy().view(np.uint64)

    return words(lo), None if hi is None else words(hi)


def linear_regressor_from_arrays(coeffs: np.ndarray,
                                 intercepts: Optional[np.ndarray]):
    """The port's ``LinearRegressor`` from the ``.coeffs`` and
    ``.intercepts`` arrays of a JAX-package predictor."""
    from .predictors.linear_predictor import LinearRegressor

    return LinearRegressor(
        coeffs=np.asarray(coeffs, dtype=np.float64),
        intercepts=None if intercepts is None
        else np.asarray(intercepts, dtype=np.float64),
    )


def linear_classifier_from_arrays(coeffs: np.ndarray,
                                  intercepts: Optional[np.ndarray],
                                  post_transform: str):
    """The port's ``LinearClassifier`` from the ``.coeffs`` and
    ``.intercepts`` arrays of a JAX-package predictor and the name of its
    post-transform (``"NONE"``, ``"SIGMOID"`` or ``"SOFTMAX"``)."""
    from .predictors.linear_predictor import LinearClassifier, PostTransform

    return LinearClassifier(
        coeffs=np.asarray(coeffs, dtype=np.float64),
        intercepts=None if intercepts is None
        else np.asarray(intercepts, dtype=np.float64),
        post_transform=PostTransform[post_transform],
    )
