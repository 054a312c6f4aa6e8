"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package
and through its PyTorch port; ring words cross as numpy uint64 arrays
and are compared word for word.
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the graphs below as objects
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


# ---------------------------------------------------------------------------
# The per-host layout's values, carried across as numpy
# (tests/test_torch_per_host_*.py)
# ---------------------------------------------------------------------------


def jax_host_to_numpy(x):
    """A JAX host ring tensor as numpy (lo, hi) words, a bit tensor as
    uint8: the form of ``interop.host_to_numpy``."""
    from moose_tpu.values import HostBitTensor

    if isinstance(x, HostBitTensor):
        return np.asarray(x.value).astype(np.uint8)
    return jax_words((x.lo, x.hi))


def jax_host_from_numpy(value, plc):
    from moose_tpu.values import HostBitTensor, HostRingTensor

    if isinstance(value, tuple):
        lo, hi = to_jax(value)
        return HostRingTensor(lo, hi, 64 if hi is None else 128, plc)
    return HostBitTensor(jnp.asarray(np.asarray(value, np.uint8)), plc)


def jax_shares_to_numpy(x):
    """A JAX RepTensor's or AdtTensor's shares in the form of
    ``interop.shares_to_numpy``."""
    from moose_tpu.values import AdtTensor

    if isinstance(x, AdtTensor):
        return tuple((jax_host_to_numpy(s), s.plc) for s in x.shares)
    return tuple(tuple((jax_host_to_numpy(s), s.plc) for s in pair)
                 for pair in x.shares)


def jax_rep_from_numpy(shares, plc):
    from moose_tpu.values import RepTensor

    return RepTensor(tuple(
        tuple(jax_host_from_numpy(v, owner) for v, owner in pair)
        for pair in shares), plc)


def jax_adt_from_numpy(shares, plc):
    from moose_tpu.values import AdtTensor

    return AdtTensor(tuple(jax_host_from_numpy(v, owner)
                           for v, owner in shares), plc)


def _same_numpy_value(a, b, label):
    if isinstance(a, tuple) and len(a) == 2 and isinstance(
            a[0], np.ndarray) and not isinstance(a[1], str):
        assert isinstance(b, tuple), f"{label}: ring against bits"
        for got, want in zip(a, b):
            if want is None:
                assert got is None, f"{label}: unexpected hi words"
                continue
            assert got.shape == want.shape, f"{label}: shape"
            assert np.array_equal(got, want), f"{label}: words differ"
        return
    if isinstance(a, tuple):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _same_numpy_value(x, y, f"{label}[{i}]")
        return
    if isinstance(a, str):
        assert a == b, f"{label}: owner {a} != {b}"
        return
    assert a.shape == b.shape and np.array_equal(a, b), \
        f"{label}: values differ"


def assert_shares_equal(port_value, jax_value, label=""):
    """A port value of the per-host layout (a host ring or bit tensor, a
    RepTensor or an AdtTensor) equals the JAX one share for share, word
    for word, owners included."""
    from moose_tpu.values import AdtTensor, RepTensor

    if isinstance(jax_value, (RepTensor, AdtTensor)):
        got = interop.shares_to_numpy(port_value)
        want = jax_shares_to_numpy(jax_value)
        assert port_value.plc == jax_value.plc, f"{label}: placement"
    else:
        got = (interop.host_to_numpy(port_value), port_value.plc)
        want = (jax_host_to_numpy(jax_value), jax_value.plc)
    _same_numpy_value(got, want, label)


# ---------------------------------------------------------------------------
# Small graphs of every family the port serves, built alike in both
# packages (tests/test_torch_serde.py, test_torch_textual.py,
# test_torch_compiler.py)
# ---------------------------------------------------------------------------

GRAPH_NAMES = ("secure_dot", "logreg", "multinomial", "correlation", "mlp",
               "forest", "resnet", "aes_input", "library", "structural")


def load_chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


def _structural(pm):
    """Conv2D with explicit padding and strides, Transpose, a pool,
    Concat and ExpandDims: the attributes msgpack hands back as lists."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(14, 23)

    @pm.computation
    def structural(x: pm.Argument(alice, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
            k = pm.cast(pm.constant(np.full((2, 2, 1, 2), 0.5),
                                    dtype=pm.float64), dtype=fx)
        with rep:
            y = pm.conv2d(pm.reshape(xf, (1, 4, 4, 1)), k, strides=(2, 1),
                          padding=((1, 0), (0, 1)))
            t = pm.transpose(y, axes=(0, 3, 1, 2))
            p = pm.avg_pool2d(y, pool_size=(2, 2), strides=(1, 1))
            c = pm.concatenate([pm.reshape(t, (1, 16)),
                                pm.reshape(p, (1, 6))], axis=1)
            e = pm.expand_dims(c, axis=[0, 2])
        with bob:
            out = pm.cast(e, dtype=pm.float64)
        return out

    return structural


def graph_pair(name):
    """(JAX computation, port computation) of the family ``name``, at a
    few features: ONNX models exported once and imported by each
    package, eDSL graphs written once for either package's module."""
    from types import SimpleNamespace

    import moose_tpu as jm
    import moose_tpu_torch as tm
    from moose_tpu import predictors as jpred
    from moose_tpu_torch import predictors as tpred
    from moose_tpu_torch.predictors import sklearn_export as tsk

    cs = load_chip_smoke()
    rng = np.random.default_rng(5)

    def onnx(model):
        data = model.encode()
        return tuple(p.from_onnx(data).predictor_factory()
                     for p in (jpred, tpred))

    if name == "secure_dot":
        return tuple(cs.secure_dot_computation(p) for p in (jm, tm))
    if name in ("logreg", "multinomial"):
        k = 1 if name == "logreg" else 3
        return onnx(tsk.logistic_regression_onnx(SimpleNamespace(
            coef_=rng.normal(size=(k, 5)), intercept_=rng.normal(size=(k,)),
            classes_=np.arange(max(k, 2))), 5))
    if name == "correlation":
        return tuple(cs.correlation_computation(p) for p in (jm, tm))
    if name == "mlp":
        return onnx(tsk.mlp_onnx(cs.mlp_model(rng, 5, (4, 3)), 5,
                                 classifier=True))
    if name == "forest":
        return onnx(tsk.random_forest_classifier_onnx(
            cs.forest_model(rng, 2, 2, 5), 5))
    if name == "resnet":
        model, _ = tsk.resnet_block_onnx(seed=3, in_ch=2, mid_ch=3, size=6,
                                         n_classes=2)
        return onnx(model)
    if name == "aes_input":
        sk = SimpleNamespace(coef_=rng.normal(size=(1, 2)),
                             intercept_=rng.normal(size=(1,)),
                             classes_=np.array([0, 1]))
        proto = tsk.logistic_regression_onnx(sk, 2)
        return tuple(
            cs.aes_inference_computation(
                p, pr.AesWrapper(pr.LinearClassifier).from_onnx(proto),
                p.fixed(24, 40))
            for p, pr in ((jm, jpred), (tm, tpred)))
    if name == "library":
        return tuple(cs.library_computation(p, rows=2, cols=4)
                     for p in (jm, tm))
    if name == "structural":
        return tuple(_structural(p) for p in (jm, tm))
    raise KeyError(name)


def traced_pair(name):
    """Both packages' traces of :func:`graph_pair`'s ``name``."""
    from moose_tpu.edsl import tracer as jtracer
    from moose_tpu_torch.edsl import tracer as ttracer

    jc, tc = graph_pair(name)
    return jtracer.trace(jc), ttracer.trace(tc)


def same_graph(a, b):
    """Structural equality of two graphs (either package's), attribute
    values compared as numpy arrays where they are arrays."""
    assert list(a.operations) == list(b.operations)
    assert a.placements.keys() == b.placements.keys()
    for name, plc in a.placements.items():
        other = b.placements[name]
        assert (type(plc).__name__, plc.kind) == (type(other).__name__,
                                                  other.kind)
        assert getattr(plc, "owners", None) == getattr(other, "owners", None)
    for name, op in a.operations.items():
        other = b.operations[name]
        assert (op.kind, op.inputs, op.placement_name) == (
            other.kind, other.inputs, other.placement_name), name
        assert op.signature.to_textual() == other.signature.to_textual()
        assert op.attributes.keys() == other.attributes.keys(), name
        for key, value in op.attributes.items():
            if isinstance(value, np.ndarray):
                assert np.array_equal(value, other.attributes[key])
            else:
                assert repr(value) == repr(other.attributes[key]), (name,
                                                                    key)


# -- graphs of the lowering and physical-executor tests ----------------------


def _compiler_graph(pm, name):
    """The five graphs of tests/test_compiler.py's lowering tests, for
    either package's module: host math, a replicated dot and sigmoid at
    fixed(14, 23), a Load/Save round trip and a replicated multiply at
    fixed(8, 27)."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    if name == "host_math":
        @pm.computation
        def host_math(x: pm.Argument(placement=alice, dtype=pm.float64)):
            with alice:
                y = pm.exp(x) + pm.constant(np.array([1.0, 1.0, 1.0]),
                                            dtype=pm.float64)
            return y

        return host_math
    if name == "rep_dot":
        @pm.computation
        def rep_dot(x: pm.Argument(placement=alice, dtype=pm.float64),
                    w: pm.Argument(placement=bob, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=pm.fixed(14, 23))
            with bob:
                wf = pm.cast(w, dtype=pm.fixed(14, 23))
            with rep:
                y = pm.dot(xf, wf)
            with carole:
                out = pm.cast(y, dtype=pm.float64)
            return out

        return rep_dot
    if name == "rep_sigmoid":
        @pm.computation
        def rep_sigmoid(x: pm.Argument(placement=alice, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=pm.fixed(14, 23))
            with rep:
                y = pm.sigmoid(xf)
            with carole:
                out = pm.cast(y, dtype=pm.float64)
            return out

        return rep_sigmoid
    if name == "save_load":
        @pm.computation
        def save_load(key: pm.Argument(placement=alice,
                                       vtype=pm.StringType())):
            with alice:
                x = pm.load(key, dtype=pm.float64)
                y = x * x
                res = pm.save("squared", y)
            return res

        return save_load
    if name == "rep_mul":
        @pm.computation
        def rep_mul(x: pm.Argument(placement=alice, dtype=pm.float64),
                    y: pm.Argument(placement=bob, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=pm.fixed(8, 27))
            with bob:
                yf = pm.cast(y, dtype=pm.fixed(8, 27))
            with rep:
                z = pm.mul(xf, yf)
            with carole:
                out = pm.cast(z, dtype=pm.float64)
            return out

        return rep_mul
    if name == "select":
        # a host Select whose result no later op needs the shape of: the
        # reference's lowering cannot go further (ROADMAP queue 3)
        keep = np.array([True, False, True])

        @pm.computation
        def select(x: pm.Argument(placement=alice, dtype=pm.float64)):
            with alice:
                s = pm.select(x, 1, pm.constant(keep, dtype=pm.bool_))
                y = pm.mul(s, s)
            with bob:
                out = pm.identity(y)
            return out

        return select
    raise KeyError(name)


COMPILER_GRAPHS = ("host_math", "rep_dot", "rep_sigmoid", "save_load",
                   "rep_mul")
# the five graphs above, config 3 at 8 x 5, a softmax head, a small
# convolution and a Select
LOWERING_GRAPHS = COMPILER_GRAPHS + ("logreg", "multinomial", "structural",
                                     "select")


def lowering_case(name):
    """(JAX trace, port trace, arguments, storage) of one lowering graph,
    its arguments made from a seed with numpy."""
    import moose_tpu as jm
    import moose_tpu_torch as tm
    from moose_tpu.edsl import tracer as jtracer
    from moose_tpu_torch.edsl import tracer as ttracer

    rng = np.random.default_rng(14)
    storage = {}
    if name in COMPILER_GRAPHS + ("select",):
        jc, tc = (_compiler_graph(pm, name) for pm in (jm, tm))
        args = {
            "host_math": lambda: {"x": np.array([0.0, 1.0, 2.0])},
            "rep_dot": lambda: {"x": rng.normal(size=(8, 5)),
                                "w": rng.normal(size=(5, 2))},
            "rep_sigmoid": lambda: {
                "x": np.linspace(-3, 3, 12).reshape(3, 4)},
            "save_load": lambda: {"key": "data"},
            "rep_mul": lambda: {"x": np.array([1.5, -2.0, 0.25]),
                                "y": np.array([4.0, 0.5, -8.0])},
            "select": lambda: {"x": rng.normal(size=(2, 3))},
        }[name]()
        if name == "save_load":
            storage = {"alice": {"data": np.array([2.0, 3.0])}}
    else:
        jc, tc = graph_pair(name)
        shape = (4, 4) if name == "structural" else (8, 5)
        args = {"x": rng.normal(size=shape)}
    return jtracer.trace(jc), ttracer.trace(tc), args, storage


def lowered_pair(name, seed=20261017):
    """Both packages' ``compile_computation(traced, DEFAULT_PASSES +
    ["wellformed"], arg_specs)`` of one lowering graph, each inside its
    own ``deterministic_sync_keys(seed)``; with the case's arguments and
    storage."""
    from moose_tpu.compilation import DEFAULT_PASSES as JPASSES
    from moose_tpu.compilation import compile_computation as jcompile
    from moose_tpu.compilation.lowering import (
        arg_specs_from_arguments as jspecs,
    )
    from moose_tpu.dialects import host as jhost
    from moose_tpu_torch.compilation import DEFAULT_PASSES as TPASSES
    from moose_tpu_torch.compilation import compile_computation as tcompile
    from moose_tpu_torch.compilation.lowering import (
        arg_specs_from_arguments as tspecs,
    )
    from moose_tpu_torch.dialects import host as thost

    jt, tt, args, storage = lowering_case(name)
    with jhost.deterministic_sync_keys(seed):
        jl = jcompile(jt, JPASSES + ["wellformed"],
                      jspecs(args, storage=storage, comp=jt))
    with thost.deterministic_sync_keys(seed):
        tl = tcompile(tt, TPASSES + ["wellformed"],
                      tspecs(args, storage=storage, comp=tt))
    return jl, tl, args, storage
