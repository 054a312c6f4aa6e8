"""Carry state between the JAX package and the port, through numpy.

Ring words cross as a bitcast: numpy ``uint64`` on the JAX side, the
same 64 bits as ``torch.int64`` here; bits as numpy ``uint8``.  The
per-host layout's values cross share by share: a host tensor as a
``(lo, hi)`` pair of words or a bit array, a ``RepTensor`` as its three
parties' pairs of those, an ``AdtTensor`` as its two, PRF keys and
seeds as four uint32 words.  Everything takes and returns numpy arrays
only, so this module imports neither ``jax`` nor ``moose_tpu``.
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


def host_to_numpy(x):
    """A host ring tensor as its numpy ``(lo, hi)`` words, a host bit
    tensor as a uint8 array."""
    from .values import HostBitTensor

    if isinstance(x, HostBitTensor):
        return x.value.detach().cpu().numpy().astype(np.uint8)
    return ring_to_numpy(x.lo, x.hi)


def host_from_numpy(value, plc: str, device=devices.DEFAULT_DEVICE):
    """:func:`host_to_numpy`'s inverse on ``plc``: a ``(lo, hi)`` pair
    becomes a ring tensor (ring128 iff ``hi`` is given), an array a bit
    tensor."""
    from .values import HostBitTensor, HostRingTensor

    if isinstance(value, tuple):
        lo, hi = ring_from_numpy(value[0], value[1], device=device)
        return HostRingTensor(lo, hi, 64 if hi is None else 128, plc)
    dev = devices.resolve(device)
    return HostBitTensor(
        torch.from_numpy(np.array(value, dtype=np.uint8)).to(dev), plc)


def shares_to_numpy(x):
    """The shares of a ``RepTensor`` (three pairs) or an ``AdtTensor``
    (two), each as :func:`host_to_numpy` gives it, with their owners."""
    from .values import AdtTensor

    if isinstance(x, AdtTensor):
        return tuple((host_to_numpy(s), s.plc) for s in x.shares)
    return tuple(tuple((host_to_numpy(s), s.plc) for s in pair)
                 for pair in x.shares)


def rep_from_numpy(shares, plc: str, device=devices.DEFAULT_DEVICE):
    """A ``RepTensor`` on the replicated placement ``plc`` from
    :func:`shares_to_numpy`'s three pairs."""
    from .values import RepTensor

    return RepTensor(tuple(
        tuple(host_from_numpy(v, owner, device) for v, owner in pair)
        for pair in shares), plc)


def adt_from_numpy(shares, plc: str, device=devices.DEFAULT_DEVICE):
    """An ``AdtTensor`` on the additive placement ``plc`` from
    :func:`shares_to_numpy`'s two shares."""
    from .values import AdtTensor

    return AdtTensor(tuple(host_from_numpy(v, owner, device)
                           for v, owner in shares), plc)


def key_words(x) -> np.ndarray:
    """A ``HostPrfKey``'s or ``HostSeed``'s four words as uint32."""
    return np.asarray(x.value, dtype=np.uint32)


def key_from_numpy(words, plc: str, seed: bool = False):
    """A ``HostPrfKey`` (or, with ``seed``, a ``HostSeed``) on ``plc``
    from four uint32 words."""
    from .values import HostPrfKey, HostSeed

    cls = HostSeed if seed else HostPrfKey
    return cls(tuple(int(w) for w in np.asarray(words, dtype=np.uint32)),
               plc)
