"""moose_tpu_torch: the PyTorch/CUDA port of moose_tpu.

A second package beside ``moose_tpu`` (the JAX reference) that runs the
same eDSL, IR and 3-party replicated secret-sharing protocol on PyTorch
tensors, with the hot ring kernels hand-written in CUDA for Hopper
(``csrc/``).  The slices ported so far cover the secure dot (an eDSL
``dot`` under a replicated placement), ONNX ``LinearRegressor``
inference, ONNX logistic regression (``LinearClassifier`` with the
exact protocol sigmoid) and the SGD trainers' secure training step
(``predictors.trainers``), the protocol library's comparisons,
exp/log/sqrt and max/argmax/softmax (with ONNX multinomial logistic
regression, the SOFTMAX head), Load and Save against the runtime's
storage (the scientific-computing tutorial's correlation), the dense and
tree predictors (sklearn MLPs, pytorch and tf2onnx networks, random
forests), and secure convolution and pooling with the ONNX convnet (a
small ResNet), through ``LocalMooseRuntime`` on its stacked layout.

The package imports ``torch`` and never ``jax`` nor ``moose_tpu``.  Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from . import dtypes
from .dtypes import fixed, float64
from .edsl.base import (
    Argument,
    abs,
    add,
    add_n,
    argmax,
    avg_pool2d,
    cast,
    computation,
    concatenate,
    constant,
    conv2d,
    div,
    dot,
    equal,
    exp,
    expand_dims,
    greater,
    host_placement,
    identity,
    index_axis,
    less,
    load,
    log,
    log2,
    logical_and,
    logical_or,
    logical_xor,
    max_pool2d,
    maximum,
    mean,
    mirrored_placement,
    mul,
    mux,
    neg,
    ones,
    relu,
    replicated_placement,
    reshape,
    save,
    shape,
    sigmoid,
    sliced,
    softmax,
    sqrt,
    square,
    squeeze,
    strided_slice,
    sub,
    sum,
    transpose,
)

__all__ = [
    "Argument",
    "LocalMooseRuntime",
    "abs",
    "add",
    "add_n",
    "argmax",
    "avg_pool2d",
    "cast",
    "computation",
    "concatenate",
    "constant",
    "conv2d",
    "div",
    "dot",
    "dtypes",
    "equal",
    "exp",
    "expand_dims",
    "fixed",
    "float64",
    "greater",
    "host_placement",
    "identity",
    "index_axis",
    "less",
    "load",
    "log",
    "log2",
    "logical_and",
    "logical_or",
    "logical_xor",
    "max_pool2d",
    "maximum",
    "mean",
    "mirrored_placement",
    "mul",
    "mux",
    "neg",
    "ones",
    "predictors",
    "relu",
    "replicated_placement",
    "reshape",
    "save",
    "shape",
    "sigmoid",
    "sliced",
    "softmax",
    "sqrt",
    "square",
    "squeeze",
    "strided_slice",
    "sub",
    "sum",
    "transpose",
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
