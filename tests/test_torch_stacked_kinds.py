"""Each replicated kind the port's stacked dialect gained with the
protocol library, one traced computation apiece, through the port's
LocalMooseRuntime on the CPU and the JAX LocalMooseRuntime (stacked
layout, eager) under fixed keys and the threefry PRF: the outputs are
equal (decoded floats, bools, uint64 indices or shapes alike); the
convolution and the pools likewise, and a revealed Argmax index cast to
floats on a host.  The port runs all 41 of the reference's kinds, Decrypt
among them (its parity with the JAX package: tests/test_torch_aes.py);
secret integers name their ROADMAP item."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.dialects import stacked as jstacked
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.dialects import stacked as tstacked
from moose_tpu_torch.edsl import tracer
from moose_tpu_torch.errors import TypeMismatchError
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_logreg import IDS, fixed_keys, threefry  # noqa: F401

PRECISION = (14, 23)
# x and y apart by far more than an LSB wherever they are compared; p > 0
ARGS = {
    "x": np.array([[1.5, -2.25, 0.5, 3.0], [-0.75, 2.0, -1.25, 0.25]]),
    "y": np.array([[0.5, -2.25, 1.0, -3.0], [-0.5, 1.75, -1.25, 2.0]]),
    "p": np.array([[0.25, 1.5, 3.0, 7.5], [0.625, 2.0, 12.0, 0.5]]),
}


def _ops(pm, kind, x, y, p, fx):
    """The replicated body of one kind's computation: its result and
    whether the result is fixed-point (decoded to floats on carole)."""
    if kind == "Identity":
        return pm.identity(x), True
    if kind == "Constant":
        c = pm.constant(np.array([[0.5, -1.0, 2.0, 0.125]] * 2), dtype=fx)
        return pm.add(x, c), True
    if kind == "AddN":
        return pm.add_n([x, y, p]), True
    if kind == "Neg":
        return pm.neg(x), True
    if kind == "Less":
        return pm.less(x, y), False
    if kind == "Greater":
        return pm.greater(x, y), False
    if kind == "Equal":
        return pm.equal(x, y), False
    if kind in ("And", "Or", "Xor"):
        fn = {"And": pm.logical_and, "Or": pm.logical_or,
              "Xor": pm.logical_xor}[kind]
        return fn(pm.less(x, y), pm.less(y, p)), False
    if kind == "Mux":
        return pm.mux(pm.less(x, y), x, y), True
    if kind == "Mux, rank-1 selector":  # bits broadcast by logical shape
        sel = pm.less(pm.index_axis(x, axis=0, index=0),
                      pm.index_axis(y, axis=0, index=1))
        return pm.mux(sel, x, y), True
    if kind == "Mean":
        return pm.mean(x, axis=1), True
    if kind in ("Exp", "Relu", "Abs"):
        return getattr(pm, kind.lower())(x), True
    if kind in ("Log", "Log2", "Sqrt"):
        return getattr(pm, kind.lower())(p), True
    if kind == "Softmax":
        return pm.softmax(x, axis=1, upmost_index=3), True
    if kind == "Argmax":
        return pm.argmax(x, axis=1, upmost_index=4), False
    if kind == "Maximum":
        return pm.maximum([x, y, p]), True
    if kind == "Reshape":
        return pm.reshape(x, (4, 2)), True
    if kind == "Squeeze":
        return pm.squeeze(pm.expand_dims(x, axis=0), axis=0), True
    if kind == "Slice":
        return pm.strided_slice(x, (slice(None), slice(1, 4, 2))), True
    if kind == "Shape":
        return pm.shape(x), False
    raise ValueError(kind)


def _computation(pm, kind, precision=PRECISION):
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*precision)

    @pm.computation
    def graph(x: pm.Argument(alice, dtype=pm.float64),
              y: pm.Argument(bob, dtype=pm.float64),
              p: pm.Argument(carole, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        with carole:
            pf = pm.cast(p, dtype=fx)
        with rep:
            z, fixed = _ops(pm, kind, xf, yf, pf, fx)
        with carole:
            out = pm.cast(z, dtype=pm.float64) if fixed else pm.identity(z)
        return out

    return graph


CONV_KINDS = ("Conv2D", "AvgPool2D", "MaxPool2D")
ADDED_KINDS = (
    "Identity", "Constant", "AddN", "Neg", "Less", "Greater", "Equal",
    "And", "Or", "Xor", "Mux", "Mean", "Exp", "Log", "Log2", "Sqrt", "Relu",
    "Abs", "Softmax", "Argmax", "Maximum", "Reshape", "Squeeze", "Slice",
    "Shape",
)


def test_rep_kinds_are_the_reference_s_less_four():
    # four kinds were refused until the convolution came, and Decrypt
    # until the AES path: now the port runs the reference's 41
    assert tstacked.REP_KINDS == jstacked._REP_KINDS
    assert len(tstacked.REP_KINDS) == 41
    assert set(ADDED_KINDS) | set(CONV_KINDS) | {"Decrypt"} <= \
        tstacked.REP_KINDS
    # a Decrypt on a host runs on the reference's per-host layout only,
    # and on the port's (tests/test_torch_aes.py)
    assert tstacked.roadmap_item("HostPlacement", "Decrypt") == \
        "the per-host layout runs it"


@pytest.mark.parametrize("kind", ADDED_KINDS + ("Mux, rank-1 selector",))
def test_kind_matches_the_jax_stacked_runtime(fixed_keys, kind):
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(_computation(jm, kind), ARGS)["output_0"]
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        _computation(tm, kind), ARGS)["output_0"]
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("precision,dtype", (
    ((8, 17), np.uint64), ((14, 23), object),
))
def test_argmax_reaches_the_user_as_ring_words(fixed_keys, precision, dtype):
    # as the reference's to_numpy gives ring words: uint64 at ring64,
    # Python ints at ring128
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        _computation(tm, "Argmax", precision), ARGS)["output_0"]
    assert got.dtype == dtype
    assert np.array_equal(got, ARGS["x"].argmax(axis=1))


def _conv_computation(pm, kind, precision=PRECISION):
    """A Conv2D of alice's NHWC input by bob's HWIO kernel, or a 2x2
    pool of alice's input, revealed to carole as floats."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*precision)

    if kind == "Conv2D":
        @pm.computation
        def graph(x: pm.Argument(alice, dtype=pm.float64),
                  k: pm.Argument(bob, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=fx)
            with bob:
                kf = pm.cast(k, dtype=fx)
            with rep:
                z = pm.conv2d(xf, kf, strides=(1, 1), padding="SAME")
            with carole:
                out = pm.cast(z, dtype=pm.float64)
            return out

        return graph
    pool = pm.avg_pool2d if kind == "AvgPool2D" else pm.max_pool2d

    @pm.computation
    def graph(x: pm.Argument(alice, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with rep:
            z = pool(xf, (2, 2))
        with carole:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return graph


CONV_ARGS = {
    "x": np.random.default_rng(10).normal(size=(2, 4, 4, 2)),
    "k": np.random.default_rng(11).normal(size=(3, 3, 2, 3)) * 0.3,
}


@pytest.mark.parametrize("kind", CONV_KINDS)
def test_conv_kinds_match_the_jax_stacked_runtime(fixed_keys, kind):
    args = dict(CONV_ARGS) if kind == "Conv2D" else {"x": CONV_ARGS["x"]}
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(_conv_computation(jm, kind), args)["output_0"]
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        _conv_computation(tm, kind), args)["output_0"]
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    x = args["x"]
    if kind == "Conv2D":
        xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        ref = sum(xp[:, i:i + 4, j:j + 4] @ args["k"][i, j]
                  for i in range(3) for j in range(3))
    else:
        windows = x.reshape(2, 2, 2, 2, 2, 2)
        ref = (windows.mean(axis=(2, 4)) if kind == "AvgPool2D"
               else windows.max(axis=(2, 4)))
    assert np.abs(got - ref).max() < 1e-4


@pytest.mark.parametrize("kind,item", (("Decrypt", "item 9"),))
def test_refused_kinds_name_their_roadmap_item(fixed_keys, kind, item):
    # item 9 brought the last refused kind: a Decrypt of a host key now
    # runs, and its plaintext is exact
    from moose_tpu_torch import vtypes
    from moose_tpu_torch.dialects import aes

    alice = tm.host_placement("alice")
    bob = tm.host_placement("bob")
    carole = tm.host_placement("carole")
    rep = tm.replicated_placement("rep", players=[alice, bob, carole])
    from moose_tpu_torch.edsl import base as edsl

    @tm.computation
    def graph(key: tm.Argument(alice, vtype=vtypes.AesKeyType()),
              ct: tm.Argument(alice, vtype=vtypes.AesTensorType(
                  tm.fixed(*PRECISION)))):
        with rep:
            z = edsl.decrypt(key, ct)
        with carole:
            out = tm.cast(z, dtype=tm.float64)
        return out

    assert kind in tstacked.REP_KINDS and not tstacked.unsupported_ops(
        tracer.trace(graph))
    key, values = bytes(range(16)), ARGS["x"]
    wire = aes.encrypt_fixed_array(key, bytes(12), values, PRECISION[1])
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        graph, {"key": aes.bytes_to_bits_be(key), "ct": wire})["output_0"]
    assert np.array_equal(got, values)


def test_secret_integers_name_their_roadmap_item(fixed_keys, caplog):
    # the stacked layout still refuses a secret integer (item 6) with a
    # TypeMismatchError; the runtime now reroutes such a graph to the
    # per-host layout, as the JAX runtime does (moose_tpu/runtime.py:
    # 231-246), which adds the bare index shares
    def graph_of(pm):
        alice = pm.host_placement("alice")
        carole = pm.host_placement("carole")
        rep = pm.replicated_placement(
            "rep", players=[alice, pm.host_placement("bob"), carole])

        @pm.computation
        def graph(x: pm.Argument(alice, dtype=pm.float64)):
            with alice:
                xf = pm.cast(x, dtype=pm.fixed(*PRECISION))
            with rep:
                a = pm.argmax(xf, axis=1, upmost_index=4)
                z = pm.add(a, a)
            with carole:
                out = pm.identity(z)
            return out

        return graph

    runtime = PortRuntime(IDS, device="cpu")
    comp = tracer.trace(graph_of(tm))
    assert tstacked.supports(comp)
    with pytest.raises(TypeMismatchError, match="item 6"):
        runtime._stacked.evaluate(comp, {"x": ARGS["x"]})
    with caplog.at_level("WARNING", logger="moose_tpu_torch"):
        got = runtime.evaluate_computation(comp, {"x": ARGS["x"]})
    assert "falling back to the per-host layout" in caplog.text
    assert runtime.last_plan["layout"] == "per-host"
    assert runtime.layout_for(comp) == "per-host"
    want = JaxRuntime(IDS, layout="per-host", use_jit=False) \
        .evaluate_computation(graph_of(jm), {"x": ARGS["x"]})["output_0"]
    assert np.array_equal(got["output_0"], np.asarray(want))
    assert np.array_equal(got["output_0"].astype(np.int64),
                          2 * ARGS["x"].argmax(axis=1))


def _argmax_cast_computation(pm, dtype):
    alice = pm.host_placement("alice")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement(
        "rep", players=[alice, pm.host_placement("bob"), carole])

    @pm.computation
    def graph(x: pm.Argument(alice, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=dtype)
        with rep:
            a = pm.argmax(xf, axis=0, upmost_index=4)
        with carole:
            out = pm.cast(a, dtype=pm.float64)
        return out

    return graph


@pytest.mark.parametrize("dtype", ("fixed(14,23)", "fixed64(8,27)"))
def test_argmax_index_cast_on_a_host_matches_the_jax_stacked_runtime(
        fixed_keys, dtype):
    # a revealed index is ring words on the host: its low words, lifted
    # to uint64, cast to floats (ring128 and ring64)
    make = {"fixed(14,23)": lambda pm: pm.fixed(14, 23),
            "fixed64(8,27)": lambda pm: pm.fixed64(8, 27)}[dtype]
    x = np.array([[1.5, -2.0, 0.25], [-0.5, 3.0, 0.75],
                  [2.5, 1.0, -1.25], [0.5, -3.5, 1.75]])
    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(_argmax_cast_computation(jm, make(jm)),
                              {"x": x})["output_0"]
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        _argmax_cast_computation(tm, make(tm)), {"x": x})["output_0"]
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.array_equal(got, x.argmax(axis=0).astype(np.float64))
