"""moose_tpu_torch: the PyTorch/CUDA port of moose_tpu.

A second package beside ``moose_tpu`` (the JAX reference) that runs the
same eDSL, IR and 3-party replicated secret-sharing protocol on PyTorch
tensors, with the hot ring kernels hand-written in CUDA for Hopper
(``csrc/``).  This slice covers the secure dot: an eDSL ``dot`` under a
replicated placement and ONNX ``LinearRegressor`` inference, through
``LocalMooseRuntime`` on its stacked layout.

The package imports ``torch`` and never ``jax`` nor ``moose_tpu``.  Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from . import dtypes
from .dtypes import fixed, float64
from .edsl.base import (
    Argument,
    cast,
    computation,
    concatenate,
    constant,
    dot,
    expand_dims,
    host_placement,
    mirrored_placement,
    ones,
    replicated_placement,
    shape,
)

__all__ = [
    "Argument",
    "LocalMooseRuntime",
    "cast",
    "computation",
    "concatenate",
    "constant",
    "dot",
    "dtypes",
    "expand_dims",
    "fixed",
    "float64",
    "host_placement",
    "mirrored_placement",
    "ones",
    "predictors",
    "replicated_placement",
    "shape",
]


def __getattr__(name):
    # the runtime and the predictors load on first use: the predictors
    # import this package for its eDSL surface
    if name == "LocalMooseRuntime":
        from .runtime import LocalMooseRuntime

        return LocalMooseRuntime
    if name == "predictors":
        import importlib

        return importlib.import_module(".predictors", __name__)
    raise AttributeError(f"module 'moose_tpu_torch' has no attribute {name!r}")
