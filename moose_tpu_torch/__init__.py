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
small ResNet), and encrypted-input inference (AES-GCM decryption under
MPC, ``pm.decrypt``, the ``AesWrapper`` predictors) with the reference's
``aes-ctr`` PRF, through ``LocalMooseRuntime`` on its stacked layout;
and computations from bytes: the msgpack and textual codecs
(``serde``, ``textual``), the logical compiler passes
(``compilation``, ``elk_compiler``, the ``bin.elk`` CLI) and
``LocalMooseRuntime.evaluate_compiled``.

The package imports ``torch`` and never ``jax`` nor ``moose_tpu``.  Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from . import dtypes
from .dtypes import (
    bool_,
    fixed,
    fixed64,
    fixed128,
    float32,
    float64,
    int32,
    int64,
    uint32,
    uint64,
)
from .computation import (
    AdditivePlacement,
    Computation,
    HostPlacement,
    Mirrored3Placement,
    Operation,
    ReplicatedPlacement,
)
from .vtypes import (
    AesKeyType,
    AesTensorType,
    BytesType,
    FloatType,
    IntType,
    ShapeType,
    StringType,
    TensorType,
    UnitType,
)
from .edsl.base import (
    Argument,
    abs,
    add,
    add_n,
    argmax,
    atleast_2d,
    avg_pool2d,
    cast,
    computation,
    concatenate,
    constant,
    conv2d,
    decrypt,
    div,
    dot,
    equal,
    exp,
    expand_dims,
    get_current_placement,
    get_current_runtime,
    greater,
    host_placement,
    identity,
    index_axis,
    inverse,
    less,
    load,
    load_shares,
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
    output,
    relu,
    replicated_placement,
    reshape,
    save,
    save_shares,
    select,
    set_current_runtime,
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
    zeros,
)

__all__ = [
    "abs",
    "add",
    "add_n",
    "AdditivePlacement",
    "AesKeyType",
    "AesTensorType",
    "argmax",
    "Argument",
    "atleast_2d",
    "avg_pool2d",
    "bool_",
    "BytesType",
    "cast",
    "Computation",
    "computation",
    "concatenate",
    "constant",
    "conv2d",
    "decrypt",
    "div",
    "dot",
    "dtypes",
    "elk_compiler",
    "equal",
    "exp",
    "expand_dims",
    "fixed",
    "fixed128",
    "fixed64",
    "float32",
    "float64",
    "FloatType",
    "get_current_placement",
    "get_current_runtime",
    "greater",
    "host_placement",
    "HostPlacement",
    "identity",
    "index_axis",
    "int32",
    "int64",
    "IntType",
    "inverse",
    "less",
    "load",
    "load_shares",
    "LocalMooseRuntime",
    "GrpcMooseRuntime",
    "log",
    "log2",
    "logical_and",
    "logical_or",
    "logical_xor",
    "max_pool2d",
    "maximum",
    "mean",
    "Mirrored3Placement",
    "mirrored_placement",
    "mul",
    "mux",
    "neg",
    "ones",
    "Operation",
    "output",
    "predictors",
    "relu",
    "replicated_placement",
    "ReplicatedPlacement",
    "reshape",
    "save",
    "save_shares",
    "select",
    "set_current_runtime",
    "shape",
    "ShapeType",
    "sigmoid",
    "sliced",
    "softmax",
    "sqrt",
    "square",
    "squeeze",
    "strided_slice",
    "StringType",
    "sub",
    "sum",
    "TensorType",
    "transpose",
    "uint32",
    "uint64",
    "UnitType",
    "zeros",
]

__version__ = "0.1.0"


def __getattr__(name):
    # the runtime, the predictors and the compiler load on first use: the
    # predictors import this package for its eDSL surface
    if name in ("LocalMooseRuntime", "GrpcMooseRuntime"):
        from . import runtime

        return getattr(runtime, name)
    if name in ("predictors", "elk_compiler"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'moose_tpu_torch' has no attribute {name!r}")
