"""The port's computation codec (``moose_tpu_torch/serde.py``) against the
JAX package's (``moose_tpu/serde.py``) on the CPU.

The tolerance is equality of bytes: the port's serialization of its own
trace equals the JAX package's serialization of the JAX trace for every
family the port serves (the two tracers are copies, so no difference
needs a structural comparison); each package decodes the other's bytes
and re-encodes them to the same bytes; the reference's interop blob
decodes in the port to the JAX package's graph; and the fixture
``golden_torch_logreg.msgpack`` (chip_smoke.py phase 17's graph, written
by the JAX package) is regenerated here, so it cannot drift."""

from pathlib import Path

import msgpack
import numpy as np
import pytest

from moose_tpu import serde as jserde
from moose_tpu.edsl import tracer as jtracer

import moose_tpu_torch as tm
from moose_tpu_torch import serde as tserde
from moose_tpu_torch import textual as ttextual
from moose_tpu_torch.computation import (
    Computation,
    HostPlacement,
    Operation,
    Signature,
    Ty,
)
from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.errors import MalformedComputationError

from torch_parity import (
    GRAPH_NAMES,
    load_chip_smoke,
    same_graph,
    traced_pair,
)

TESTS = Path(__file__).resolve().parent


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_port_writes_the_jax_package_s_bytes(name):
    jtraced, ttraced = traced_pair(name)
    assert tserde.serialize_computation(ttraced) == \
        jserde.serialize_computation(jtraced)


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_each_package_decodes_the_other_s_bytes(name):
    jtraced, ttraced = traced_pair(name)
    jblob = jserde.serialize_computation(jtraced)
    tblob = tserde.serialize_computation(ttraced)
    back = tserde.deserialize_computation(jblob)
    assert tserde.serialize_computation(back) == jblob
    assert jserde.serialize_computation(
        jserde.deserialize_computation(tblob)) == tblob
    same_graph(back, jserde.deserialize_computation(jblob))


def test_reference_interop_blob_decodes_to_the_jax_package_s_graph():
    blob = (TESTS / "golden_pymoose_interop.msgpack").read_bytes()
    got, want = (s.deserialize_computation(blob) for s in (tserde, jserde))
    same_graph(got, want)
    assert tserde.serialize_computation(got) == \
        jserde.serialize_computation(want)


def test_golden_logreg_blob_is_the_jax_package_s_phase_6_graph():
    """chip_smoke.py phase 17 serves this blob on the card, where no JAX
    is installed: config 3's logistic regression at 100 features with
    phase 6's weights, serialized by the JAX package.  Regenerated here
    from the JAX package, and the port's serialization of its own phase
    6 graph writes the same bytes."""
    cs = load_chip_smoke()
    golden = (TESTS / "golden_torch_logreg.msgpack").read_bytes()
    jclf = cs.logistic_regression(cs.phase6_rng(), cs.LOGREG_FEATURES,
                                  package="moose_tpu")
    assert jserde.serialize_computation(
        jtracer.trace(jclf.predictor_factory())) == golden
    tclf = cs.logistic_regression(cs.phase6_rng(), cs.LOGREG_FEATURES)
    assert tserde.serialize_computation(
        ttracer.trace(tclf.predictor_factory())) == golden
    assert np.array_equal(tclf.coeffs, np.asarray(jclf.coeffs))


def test_phase6_rng_replays_chip_smoke_s_draws():
    """chip_smoke.phase6_rng stands where main()'s generator stands when
    phase 6 draws its classifier: after phase 4's operands and phase 5's
    weights and requests."""
    cs = load_chip_smoke()
    rng = np.random.default_rng(cs.SEED)
    rng.normal(size=(cs.DOT_N, cs.DOT_N))
    rng.normal(size=(cs.DOT_N, cs.DOT_N))
    cs.linear_regressor(rng, cs.LINREG_FEATURES)
    for _ in range(cs.LINREG_REQUESTS):
        rng.normal(size=(cs.LINREG_ROWS, cs.LINREG_FEATURES))
    assert np.array_equal(rng.normal(size=8),
                          cs.phase6_rng().normal(size=8))


def test_decoded_dtypes_are_the_port_s():
    """Both spellings of a fixed dtype (the JAX package's and the
    reference encoder's ``{"name": "fixed", ...}``, and the reference
    decoder's ``fixed<i>_<f>``) decode to the port's dtype objects, and
    plaintext dtypes to the port's singletons."""
    def decode(obj):
        return msgpack.unpackb(msgpack.packb(obj, use_bin_type=True),
                               object_hook=tserde._decode_hook, raw=False)

    spelled = {"__type__": "DType", "name": "fixed",
               "integral_precision": 24, "fractional_precision": 40}
    for obj in (spelled, {"__type__": "DType", "name": "fixed24_40"}):
        got = decode(obj)
        assert type(got) is type(tm.fixed(24, 40))
        assert got == tm.fixed(24, 40) and got.is_fixedpoint
    assert decode({"__type__": "DType", "name": "float64"}) is tm.float64
    assert decode({"__type__": "DType", "name": "bool"}) is tm.bool_


def test_attributes_keep_the_jax_package_s_decoded_types():
    """msgpack returns tuples as lists; only the reference's flat
    attribute fields turn back into tuples.  The port decodes exactly
    what the JAX package decodes (its dialects accept both)."""
    jtraced, ttraced = traced_pair("structural")
    blob = tserde.serialize_computation(ttraced)
    got = tserde.deserialize_computation(blob)
    want = jserde.deserialize_computation(blob)
    conv = got.operations["conv2d_0"].attributes
    assert conv["strides"] == [2, 1] and conv["padding"] == [[1, 0], [0, 1]]
    assert got.operations["expanddims_0"].attributes["axis"] == (0, 2)
    for name, op in want.operations.items():
        for key, value in op.attributes.items():
            assert type(got.operations[name].attributes[key]).__name__ \
                == type(value).__name__, (name, key)


def test_ring128_constants_lift_to_the_port_s_words():
    """Integers past int64 travel as BigIntConstant and object_int arrays;
    decoded by the port they lift into (lo, hi) words exactly."""
    comp = Computation()
    comp.add_placement(HostPlacement("alice"))
    weights = np.empty(4, dtype=object)
    weights[:] = [1, (1 << 64) + 5, (1 << 127) - 1, 1 << 127]
    ring_ty = Ty("HostRing128Tensor")
    comp.add_operation(Operation(
        "w", "Constant", [], "alice", Signature((), ring_ty),
        {"value": weights}))
    comp.add_operation(Operation(
        "f", "Fill", ["w"], "alice", Signature((ring_ty,), ring_ty),
        {"value": (1 << 100) + 3}))
    blob = tserde.serialize_computation(comp)
    back = tserde.deserialize_computation(blob)
    assert jserde.serialize_computation(
        jserde.deserialize_computation(blob)) == blob
    value = back.operations["w"].attributes["value"]
    assert value.dtype == object and list(value) == list(weights)
    assert back.operations["f"].attributes["value"] == (1 << 100) + 3
    lo, hi = tring.from_python_ints(value, 128, "cpu")
    words = (hi.numpy().view(np.uint64).astype(object) << 64) \
        + lo.numpy().view(np.uint64).astype(object)
    assert list(words) == list(weights)


def test_load_computation_reads_both_formats(tmp_path):
    """msgpack by content, the textual form by extension (the text keeps
    less than the msgpack schema, so it is held to its own parse)."""
    _, ttraced = traced_pair("logreg")
    blob = tserde.serialize_computation(ttraced)
    binary = tmp_path / "logreg.bin"
    binary.write_bytes(blob)
    text = ttextual.to_textual(ttraced)
    textual_file = tmp_path / "logreg.moose"
    textual_file.write_text(text)
    assert tserde.serialize_computation(
        tserde.load_computation(binary)) == blob
    assert tserde.serialize_computation(
        tserde.load_computation(textual_file)) == \
        tserde.serialize_computation(ttextual.parse_computation(text))


def test_malformed_payloads_raise_the_port_s_error():
    with pytest.raises(MalformedComputationError, match="not a serialized"):
        tserde.deserialize_computation(msgpack.packb({"x": 1}))
    blob = msgpack.packb({
        "__type__": "Computation", "placements": {},
        "operations": {"a": {"__type__": "NopeOperation"}}})
    with pytest.raises(MalformedComputationError, match="unknown op tag"):
        tserde.deserialize_computation(blob)
