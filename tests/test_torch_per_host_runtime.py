"""The per-host layout end to end: both runtimes' ``layout="per-host"``
at ``use_jit=False`` (the logical walk: at ``True`` both lower a big
graph to their physical executors, tests/test_torch_physical_models.py)
give equal outputs
under fixed keys for the secure dot and config 3's logistic regression
at 8 x 5 in both threefry streams, and for every kind of the logical
dialect's ``_execute_host``, ``_execute_rep`` and ``_execute_mir``
(one parametrised test; the protocol library's 25 replicated kinds run
in tests/test_torch_per_host_fixedpoint.py).  ``auto`` routes a graph as
the JAX runtime does and reports the layout in ``last_plan``.

Under ``aes-ctr`` a seed is a keyed hash of the session id, which each
session draws from OS entropy, so the per-host layout is not
reproducible there, in the JAX package either: those runs are held to
the decoded tolerance only.

The file's one heavy JAX reference is the logistic regression (about
17 s of eager compiles on the CPU), run once per stream by a module
fixture."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import logical as tlogical
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import (  # noqa: F401  (fixtures)
    fixed_keys_env,
    graph_pair,
    load_chip_smoke,
    prf,
    threefry,
)

cs = load_chip_smoke()
IDS = ["alice", "bob", "carole"]
STREAMS = ("threefry", "threefry-pallas")
FX = (24, 40)
X = np.random.default_rng(3).normal(size=(2, 3))
Y = np.random.default_rng(4).normal(size=(2, 3))


def _outputs_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


def _per_host(jcomp, tcomp, args, stream="threefry"):
    """(port, JAX) outputs of one graph through both runtimes' per-host
    layouts under ``stream`` and fixed keys, and the port's plan."""
    with prf(stream), fixed_keys_env():
        want = JaxRuntime(IDS, layout="per-host", use_jit=False) \
            .evaluate_computation(jcomp, args)
        runtime = PortRuntime(IDS, layout="per-host", use_jit=False,
                              device="cpu")
        got = runtime.evaluate_computation(tcomp, args)
    assert runtime.last_plan == {"layout": "per-host", "lowered": False,
                                 "plan_mode": "eager", "pinned_ops": []}
    return got, want


# -- the secure dot and config 3 ---------------------------------------------


@pytest.mark.parametrize("stream", STREAMS)
def test_secure_dot_matches_the_jax_per_host_runtime(stream):
    args = {"x": X, "y": Y.T}
    got, want = _per_host(cs.secure_dot_computation(jm),
                          cs.secure_dot_computation(tm), args, stream)
    _outputs_equal(got, want)
    assert np.abs(got["output_0"] - X @ Y.T).max() < cs.DOT_TOL


@pytest.fixture(scope="module")
def logreg_runs():
    """Config 3's logistic regression at 8 x 5 per-host in both packages,
    under each stream."""
    jc, tc = graph_pair("logreg")
    x = np.random.default_rng(8).normal(size=(8, 5))
    return {stream: _per_host(jc, tc, {"x": x}, stream)
            for stream in STREAMS}


@pytest.mark.parametrize("stream", STREAMS)
def test_logistic_regression_matches_the_jax_per_host_runtime(logreg_runs,
                                                               stream):
    got, want = logreg_runs[stream]
    _outputs_equal(got, want)
    probs = got["output_0"]
    assert probs.shape == (8, 2) and np.all(np.isfinite(probs))
    assert np.abs(probs.sum(axis=1) - 1.0).max() < 1e-9


def test_per_host_and_stacked_agree_to_the_truncation_noise(logreg_runs):
    """The two layouts draw different masks, so they agree after
    decoding, not word for word."""
    jc, tc = graph_pair("logreg")
    x = np.random.default_rng(8).normal(size=(8, 5))
    with prf("threefry"), fixed_keys_env():
        stacked = PortRuntime(IDS, layout="stacked", device="cpu") \
            .evaluate_computation(tc, {"x": x})["output_0"]
    per_host = logreg_runs["threefry"][0]["output_0"]
    assert np.abs(stacked - per_host).max() < 1e-9


def test_aes_ctr_holds_the_decoded_tolerance_only():
    jc, tc = graph_pair("logreg")
    x = np.random.default_rng(8).normal(size=(8, 5))
    with prf("aes-ctr"), fixed_keys_env():
        want = JaxRuntime(IDS, layout="per-host", use_jit=False) \
            .evaluate_computation(jc, {"x": x})["output_0"]
        got = PortRuntime(IDS, layout="per-host", device="cpu") \
            .evaluate_computation(tc, {"x": x})["output_0"]
    assert got.shape == np.asarray(want).shape
    assert np.abs(got - np.asarray(want)).max() < 1e-9


def test_the_cpu_counts_no_launch(threefry):
    rk.reset_launches()
    PortRuntime(IDS, layout="per-host", device="cpu").evaluate_computation(
        cs.secure_dot_computation(tm), {"x": X, "y": Y.T})
    assert not any(rk.LAUNCHES.values())


# -- every kind of the logical dialect ---------------------------------------


def _graph(pm, kind):
    """A small graph that runs ``kind`` once on its placement family:
    x, y (2, 3) float64 on alice and bob, cast to fixed(24,40) where the
    kind takes fixed-point values; the result to carole."""
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    mir = pm.mirrored_placement("mir", players=[alice, bob, carole])
    fx = pm.fixed(*FX)
    family, op = kind.split(":")

    @pm.computation
    def graph(x: pm.Argument(alice, dtype=pm.float64),
              y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
            kf = pm.cast(pm.constant(np.full((2, 2, 2, 1), 0.25),
                                     dtype=pm.float64), dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        plc = {"host": alice, "rep": rep, "mir": mir}[family]
        with plc:
            out = _kind_expr(pm, op, x, xf, yf, kf, fx)
        with carole:
            if op in _FIXED_OUT:
                out = pm.cast(out, dtype=pm.float64)
            else:
                out = pm.identity(out)
        return out

    return graph


# kinds whose graph gives a fixed-point value (cast to float64 on carole)
_FIXED_OUT = frozenset({
    "Constant", "Identity", "Cast", "Add", "Sub", "Mul", "Div", "Dot",
    "Conv2D", "AvgPool2D", "MaxPool2D", "AddN", "Neg", "Mux", "Sum", "Mean",
    "Exp", "Log", "Log2", "Sqrt", "Sigmoid", "Relu", "Abs", "Softmax",
    "Maximum", "Concat", "Reshape", "ExpandDims", "Squeeze", "Transpose",
    "IndexAxis", "Broadcast", "Slice", "Select", "AddConstant",
    "MulConstant",
})


def _kind_expr(pm, op, x, xf, yf, kf, fx):
    from importlib import import_module

    edsl = import_module(f"{pm.__name__}.edsl.base")
    img = pm.reshape(pm.concatenate([xf, yf], axis=1), (1, 2, 3, 2))
    pos = pm.add(pm.mul(xf, xf), pm.constant(np.array(0.5), dtype=fx))
    lt = pm.less(xf, yf)
    return {
        "Constant": lambda: pm.constant(np.array([[0.25, -1.5, 3.0]]),
                                        dtype=fx),
        "Identity": lambda: pm.identity(xf),
        "Output": lambda: pm.identity(x),
        "Cast": lambda: pm.cast(xf, dtype=pm.fixed(14, 23)),
        "Shape": lambda: pm.shape(xf),
        "Ones": lambda: pm.ones(pm.shape(x), dtype=pm.float64),
        "Zeros": lambda: pm.zeros(pm.shape(x), dtype=pm.float64),
        "Inverse": lambda: pm.inverse(pm.add(
            pm.dot(x, pm.transpose(x)),
            pm.constant(np.eye(2), dtype=pm.float64))),
        "Add": lambda: pm.add(xf, yf),
        "Sub": lambda: pm.sub(xf, yf),
        "Mul": lambda: pm.mul(xf, yf),
        "Div": lambda: pm.div(xf, pos),
        "Dot": lambda: pm.dot(xf, pm.transpose(yf)),
        "Conv2D": lambda: pm.conv2d(img, kf),
        "AvgPool2D": lambda: pm.avg_pool2d(img, pool_size=(2, 2),
                                           strides=(1, 1)),
        "MaxPool2D": lambda: pm.max_pool2d(img, pool_size=(2, 2),
                                           strides=(1, 1)),
        "AddN": lambda: pm.add_n([xf, yf, xf]),
        "Neg": lambda: pm.neg(xf),
        "Less": lambda: lt,
        "Greater": lambda: pm.greater(xf, yf),
        "Equal": lambda: pm.equal(xf, xf),
        "And": lambda: pm.logical_and(lt, pm.greater(xf, yf)),
        "Or": lambda: pm.logical_or(lt, pm.greater(xf, yf)),
        "Xor": lambda: pm.logical_xor(lt, pm.greater(xf, yf)),
        "Mux": lambda: pm.mux(lt, xf, yf),
        "Sum": lambda: pm.sum(xf, axis=1),
        "Mean": lambda: pm.mean(xf, axis=0),
        "Exp": lambda: pm.exp(xf),
        "Log": lambda: pm.log(pos),
        "Log2": lambda: pm.log2(pos),
        "Sqrt": lambda: pm.sqrt(pos),
        "Sigmoid": lambda: pm.sigmoid(xf),
        "Relu": lambda: pm.relu(xf),
        "Abs": lambda: pm.abs(xf),
        "Softmax": lambda: pm.softmax(xf, axis=1, upmost_index=3),
        "Argmax": lambda: pm.argmax(xf, axis=1, upmost_index=3),
        "Maximum": lambda: pm.maximum([xf, yf]),
        "Concat": lambda: pm.concatenate([xf, yf], axis=0),
        "Reshape": lambda: pm.reshape(xf, (3, 2)),
        "ExpandDims": lambda: pm.expand_dims(xf, axis=[0, 2]),
        "Squeeze": lambda: pm.squeeze(pm.expand_dims(xf, axis=1), axis=1),
        "Transpose": lambda: pm.transpose(xf),
        "IndexAxis": lambda: pm.index_axis(xf, axis=1, index=2),
        # float: the reference's host AtLeast2D takes no ring words
        "AtLeast2D": lambda: pm.atleast_2d(pm.index_axis(x, 0, 1),
                                           to_column_vector=True),
        "Broadcast": lambda: edsl.broadcast_to(
            pm.index_axis(xf, 0, 0), pm.shape(xf)),
        # the host fixed tensor's x[1:3]-style slice the stacked layout
        # refused, with a negative step
        "Slice": lambda: pm.strided_slice(xf, (slice(None),
                                               slice(None, None, -1))),
        "Select": lambda: pm.select(xf, 1, pm.constant(
            np.array([True, False, True]), dtype=pm.bool_)),
        "AddConstant": lambda: pm.add(xf, pm.constant(np.array(1.25), dtype=fx)),
        "MulConstant": lambda: pm.mul(xf, pm.constant(np.array(-0.5), dtype=fx)),
    }[op]()


def _mirrored(pm, kind):
    """A mirrored Constant and Cast (float -> fixed -> float) against a
    replicated x."""
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    mir = pm.mirrored_placement("mir", players=[alice, bob, carole])
    fx = pm.fixed(*FX)

    @pm.computation
    def graph(x: pm.Argument(alice, dtype=pm.float64),
              y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with mir:
            if kind == "mir:Constant":
                c = pm.constant(np.array([0.5, -2.0, 1.0]), dtype=fx)
            else:
                c = pm.cast(pm.constant(np.array([0.5, -2.0, 1.0]),
                                        dtype=pm.float64), dtype=fx)
        with rep:
            z = pm.mul(pm.add(xf, c), c)
        with mir:
            back = pm.cast(c, dtype=pm.float64)
        with carole:
            out = (pm.cast(z, dtype=pm.float64), pm.identity(back))
        return out

    return graph


HOST_KINDS = sorted(tlogical.HOST_KINDS - {"Decrypt"})
REP_KINDS = ("Add", "Sub", "Mul", "Dot", "Div", "Conv2D", "AvgPool2D",
             "MaxPool2D", "Sum", "Sigmoid", "Concat", "Transpose",
             "IndexAxis", "ExpandDims", "Cast", "AddConstant", "MulConstant")
KINDS = ([f"host:{k}" for k in HOST_KINDS]
         + [f"rep:{k}" for k in REP_KINDS]
         + ["mir:Constant", "mir:Cast"])


@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_the_jax_per_host_runtime(kind):
    build = _mirrored if kind.startswith("mir:") else _graph
    got, want = _per_host(build(jm, kind), build(tm, kind),
                          {"x": X, "y": Y})
    _outputs_equal(got, want)


def _reference_rep_kinds() -> set:
    """The op kinds the reference's ``logical._execute_rep`` runs, read
    from its source."""
    import inspect
    import re

    from moose_tpu.dialects import logical as jlogical

    src = inspect.getsource(jlogical._execute_rep)
    kinds = set(re.findall(r'kind == "(\w+)"', src))
    for group in re.findall(r"kind in \(([^)]*)\)", src):
        kinds |= set(re.findall(r'"(\w+)"', group))
    return kinds | set(jlogical._REP_MATH) | set(jlogical._REP_STRUCTURAL)


def test_the_kinds_cover_the_dialect():
    # the protocol library's 25 replicated kinds run in
    # test_torch_per_host_fixedpoint.py, Decrypt in
    # test_decrypt_in_the_per_host_layout_matches_the_jax_runtime and
    # test_torch_aes_per_host.py
    assert {k.split(":")[1] for k in KINDS if k.startswith("host:")} | \
        {"Decrypt"} == tlogical.HOST_KINDS
    rep = {k.split(":")[1] for k in KINDS if k.startswith("rep:")}
    assert rep | set(cs.LIBRARY_KINDS) | {"Decrypt"} >= \
        _reference_rep_kinds()


def test_decrypt_in_the_per_host_layout_matches_the_jax_runtime():
    """A replicated AES key lifted at its Input and a replicated Decrypt
    (the bit-sliced circuit on replicated bit shares, ``RepBitOps``):
    the JAX runtime's per-host words, and the exact plaintext."""
    from moose_tpu_torch.dialects import aes as taes

    def graph(pm):
        alice, bob, carole = (pm.host_placement(n) for n in IDS)
        rep = pm.replicated_placement("rep", players=[alice, bob, carole])

        @pm.computation
        def decrypt(aes_data: pm.Argument(alice, vtype=pm.AesTensorType(
                        dtype=pm.fixed(*FX))),
                    aes_key: pm.Argument(rep, vtype=pm.AesKeyType())):
            with rep:
                x = pm.decrypt(aes_key, aes_data)
            with bob:
                out = pm.cast(x, dtype=pm.float64)
            return out

        return decrypt

    key, nonce = bytes(range(16)), bytes(range(40, 52))
    vals = np.array([1.5, -2.25])
    args = {"aes_data": taes.encrypt_fixed_array(key, nonce, vals, FX[1]),
            "aes_key": taes.bytes_to_bits_be(key)}
    got, want = _per_host(graph(jm), graph(tm), args)
    _outputs_equal(got, want)
    assert np.array_equal(got["output_0"], vals)


# -- auto routing -------------------------------------------------------------


@pytest.mark.parametrize("name,build,layout", (
    ("host_only", cs.host_math_computation, "per-host"),
    ("select", cs.selected_product_computation, "per-host"),
    ("secure_dot", lambda pm: cs.secure_dot_computation(pm), "stacked"),
))
def test_auto_routes_as_the_jax_runtime(threefry, name, build, layout):
    args = {"x": X, "y": Y} if name != "secure_dot" else {"x": X, "y": Y.T}
    with fixed_keys_env():
        jax_runtime = JaxRuntime(IDS, use_jit=False)
        want = jax_runtime.evaluate_computation(build(jm), args)
        runtime = PortRuntime(IDS, device="cpu")
        got = runtime.evaluate_computation(build(tm), args)
    assert jax_runtime.last_plan["layout"] == layout
    assert runtime.last_plan["layout"] == layout
    assert runtime.layout_for(ttracer.trace(build(tm))) == layout
    _outputs_equal(got, want)


def test_explicit_layouts_route_as_the_jax_runtime():
    comp = ttracer.trace(cs.host_math_computation(tm))
    assert PortRuntime(IDS, layout="stacked", device="cpu") \
        .layout_for(comp) == "stacked"
    assert PortRuntime(IDS, layout="per-host", device="cpu").layout_for(
        ttracer.trace(cs.secure_dot_computation(tm))) == "per-host"
    # a graph the stacked layout cannot take runs per-host under either
    # stacked setting, as the JAX runtime's fallback does
    assert PortRuntime(IDS, layout="stacked", device="cpu").layout_for(
        ttracer.trace(cs.selected_product_computation(tm))) == "per-host"


def test_phase_18_counts_are_the_cpu_counts(threefry, monkeypatch):
    """chip_smoke's phase-18 ceilings rest on these CPU counts of single
    K7 draws and host seed derivations, which no device changes."""
    from moose_tpu_torch.dialects import ring

    counts = {"draws": 0, "seeds": 0}
    threefry_, mix_seed = rk._threefry, ring.mix_seed

    def draw(*args, **kwargs):
        counts["draws"] += 1
        return threefry_(*args, **kwargs)

    def seed(*args, **kwargs):
        counts["seeds"] += 1
        return mix_seed(*args, **kwargs)

    monkeypatch.setattr(rk, "_threefry", draw)
    monkeypatch.setattr(ring, "mix_seed", seed)
    runtime = PortRuntime(IDS, layout="per-host", device="cpu")
    runtime.evaluate_computation(cs.secure_dot_computation(tm),
                                 {"x": X, "y": Y.T})
    assert (counts["draws"], counts["seeds"]) == (cs.PER_HOST_DOT_K7,
                                                  cs.PER_HOST_DOT_SEEDS)
    model = cs.logistic_regression(np.random.default_rng(9),
                                   cs.LOGREG_FEATURES)
    counts.update(draws=0, seeds=0)
    runtime.evaluate_computation(model.predictor_factory(), {
        "x": np.random.default_rng(10).normal(size=(16, cs.LOGREG_FEATURES))})
    assert (counts["draws"], counts["seeds"]) == (cs.PER_HOST_LOGREG_K7,
                                                  cs.PER_HOST_LOGREG_SEEDS)
