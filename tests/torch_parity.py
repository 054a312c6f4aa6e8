"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package
and through its PyTorch port; ring words cross as numpy uint64 arrays
and are compared word for word.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest

import moose_tpu  # noqa: F401  (enables jax x64 before any jnp use)
import jax.numpy as jnp
from moose_tpu.dialects import ring as jring

from moose_tpu_torch import interop
from moose_tpu_torch.dialects import ring as tring


@contextlib.contextmanager
def prf(name):
    """Both packages on the PRF ``name``.  Each package's choice is
    process-global, so the previous ones are restored afterwards."""
    prev = jring.get_prf_impl(), tring.get_prf_impl()
    jring.set_prf_impl(name)
    tring.set_prf_impl(name)
    try:
        yield
    finally:
        jring.set_prf_impl(prev[0])
        tring.set_prf_impl(prev[1])


@contextlib.contextmanager
def fixed_keys_env(value="torch-parity"):
    """``MOOSE_TPU_FIXED_KEYS`` (with the weak-PRF consent it needs) for
    the block, for fixtures wider than one test."""
    names = ("MOOSE_TPU_FIXED_KEYS", "MOOSE_TPU_ALLOW_WEAK_PRF")
    prev = {name: os.environ.get(name) for name in names}
    os.environ.update(dict(zip(names, (value, "1"))))
    try:
        yield
    finally:
        for name, old in prev.items():
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old


@pytest.fixture
def threefry():
    """Both packages on the threefry PRF, restored afterwards."""
    with prf("threefry"):
        yield


@pytest.fixture
def threefry_pallas():
    """Both packages on the threefry-pallas PRF (K7), restored
    afterwards."""
    with prf("threefry-pallas"):
        yield


@pytest.fixture
def aes_ctr():
    """Both packages on the reference's aes-ctr PRF, restored
    afterwards."""
    with prf("aes-ctr"):
        yield


@pytest.fixture
def cuda():
    """The device of tests that need the card; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


def rand_words(rng, shape, width):
    """A numpy (lo, hi) pair of uniform ring words (hi None for ring64)."""
    lo = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    if width == 64:
        return lo, None
    return lo, rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def to_jax(pair):
    lo, hi = pair
    return jnp.asarray(lo), None if hi is None else jnp.asarray(hi)


def to_port(pair, device="cpu"):
    return interop.ring_from_numpy(pair[0], pair[1], device=device)


def jax_words(pair):
    lo, hi = pair
    return (
        np.asarray(lo).astype(np.uint64),
        None if hi is None else np.asarray(hi).astype(np.uint64),
    )


def assert_words_equal(port_pair, want, label=""):
    """Port (lo, hi) tensors equal the expected numpy/JAX words exactly."""
    got_lo, got_hi = interop.ring_to_numpy(*port_pair)
    want_lo, want_hi = jax_words(want)
    assert got_lo.shape == want_lo.shape, f"{label}: shape"
    assert np.array_equal(got_lo, want_lo), f"{label}: lo words differ"
    if want_hi is None:
        assert got_hi is None, f"{label}: unexpected hi words"
    else:
        assert np.array_equal(got_hi, want_hi), f"{label}: hi words differ"
