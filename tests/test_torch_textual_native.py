"""The port's C++ textual parser (``moose_tpu_torch/native/
textual_parser.cpp``, built with g++ at first use) against the JAX
package's and against the port's Python grammar, on the CPU.

The tolerance is equality: the graph tests/test_serde_textual.py's
``test_native_parser_matches_python`` builds (tensor literals, dtype
tokens, hex bytes, strings with escapes, nested tuples) parses natively
into the same operations as in Python, and serializes to the JAX
package's native parse's msgpack bytes; ``parse_computation`` hands a
text of 64 KiB or more to the native parser (``textual.PARSES`` counts
which ran) and keeps the reference's behaviour where the build fails."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu import serde as jserde
from moose_tpu import textual as jtextual
from moose_tpu.edsl import tracer as jtracer

import moose_tpu_torch as tm
from moose_tpu_torch import serde as tserde
from moose_tpu_torch import textual as ttextual
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.native import textual as tnative

from torch_parity import same_graph, traced_pair


def _long_tail_graph(pm, C):
    """The reference test's graph, in package ``pm`` with IR module
    ``C``."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.float64)):
        with alice:
            c = pm.constant(np.array([[1.5, -2.0], [0.25, 8.0]]),
                            dtype=pm.float64)
            s = pm.constant("key with \"quotes\" and \\ slashes")
            xf = pm.cast(pm.add(x, c), dtype=pm.fixed(14, 23))
            pm.save(s, xf)
        with rep:
            y = pm.conv2d(
                pm.reshape(xf, (1, 2, 2, 1)),
                pm.cast(pm.constant(np.ones((2, 2, 1, 1)),
                                    dtype=pm.float64),
                        dtype=pm.fixed(14, 23)),
                strides=(2, 1), padding=((1, 0), (0, 1)),
            )
        with bob:
            out = pm.cast(y, dtype=pm.float64)
        return out

    tracer = jtracer if pm is jm else ttracer
    traced = tracer.trace(comp)
    # a hex-bytes attribute (DeriveSeed-style sync keys)
    traced.add_placement(C.HostPlacement("dave"))
    traced.add_operation(C.Operation(
        "seedling", "DeriveSeed", [], "dave",
        C.Signature((), C.Ty("HostSeed")),
        attributes={"sync_key": b"\x00\xffmoose\x22"},
    ))
    return traced


def _ir(name):
    import importlib

    return importlib.import_module(f"{name}.computation")


def test_native_parser_matches_python():
    assert tnative.load() is not None, "g++ did not build the parser"
    text = ttextual.to_textual(_long_tail_graph(tm, _ir("moose_tpu_torch")))
    assert text == jtextual.to_textual(
        _long_tail_graph(jm, _ir("moose_tpu")))
    py = ttextual.parse_computation(text, force_native=False)
    before = dict(ttextual.PARSES)
    nat = ttextual.parse_computation(text, force_native=True)
    assert ttextual.PARSES["native"] == before["native"] + 1
    assert ttextual.PARSES["python"] == before["python"]
    assert set(py.operations) == set(nat.operations)
    assert set(py.placements) == set(nat.placements)
    for name, op1 in py.operations.items():
        op2 = nat.operations[name]
        assert (op1.kind, op1.inputs, op1.placement_name) == (
            op2.kind, op2.inputs, op2.placement_name)
        assert op1.signature == op2.signature
        assert set(op1.attributes) == set(op2.attributes)
        for k, v1 in op1.attributes.items():
            v2 = op2.attributes[k]
            if isinstance(v1, np.ndarray):
                assert np.array_equal(v1, v2)
            else:
                assert v1 == v2 and type(v1) is type(v2), (name, k)
    jnat = jtextual.parse_computation(text, force_native=True)
    assert tserde.serialize_computation(nat) == \
        jserde.serialize_computation(jnat)
    # malformed lines surface an error in both parsers
    with pytest.raises(Exception):
        ttextual.parse_computation("x = Nope(", force_native=True)


@pytest.mark.parametrize("name", ["logreg", "resnet"])
def test_threshold_dispatch_and_bytes(name):
    # a text of 64 KiB or more parses natively by default, a shorter one
    # in Python; either way the bytes are the JAX package's
    jtraced, ttraced = traced_pair(name)
    text = ttextual.to_textual(ttraced)
    native = len(text) >= ttextual._NATIVE_PARSE_THRESHOLD
    before = dict(ttextual.PARSES)
    got = ttextual.parse_computation(text)
    assert ttextual.PARSES["native"] - before["native"] == int(native)
    assert ttextual.PARSES["python"] - before["python"] == int(not native)
    want = jtextual.parse_computation(text)
    same_graph(got, want)
    assert tserde.serialize_computation(got) == \
        jserde.serialize_computation(want)
    assert tserde.serialize_computation(
        ttextual.parse_computation(text, force_native=not native)) == \
        tserde.serialize_computation(got)


def test_a_failed_build_parses_in_python(monkeypatch):
    # the reference's behaviour without a toolchain: the native parse
    # yields nothing and the Python grammar reads the text
    text = ttextual.to_textual(traced_pair("logreg")[1])
    monkeypatch.setattr(tnative, "load", lambda: None)
    before = dict(ttextual.PARSES)
    got = ttextual.parse_computation(text, force_native=True)
    assert ttextual.PARSES["python"] == before["python"] + 1
    assert ttextual.PARSES["native"] == before["native"]
    assert tserde.serialize_computation(got) == \
        jserde.serialize_computation(jtextual.parse_computation(text))
