"""Computations from bytes through the port's runtime on the CPU:
``LocalMooseRuntime.evaluate_compiled`` (``moose_tpu_torch/runtime.py``)
against the JAX package's runtime on its stacked layout.

Under fixed keys and the threefry stream (``tests/torch_parity.py``)
both runtimes serve the same blobs with equal results: config 3's
logistic regression as the JAX package serialized it
(``golden_torch_logreg.msgpack``, chip_smoke.py phase 17's graph), also
after the port's ``elk_compiler``, and config 4's AES-input graph.
Probabilities below 2 at fixed(24,40) decode exactly, so equal floats
are equal ring words.  Then a lowered blob and ``compiler_passes`` on
the physical executor, a device mesh (refused, naming its ROADMAP
item), and the bounded memo of decoded blobs.  Each JAX run costs 10-30 s of eager
compiles, so each graph runs there once."""

from pathlib import Path

import numpy as np
import pytest

from moose_tpu.compilation import DEFAULT_PASSES as JAX_DEFAULT_PASSES
from moose_tpu.compilation import compile_computation as jcompile
from moose_tpu.compilation.lowering import arg_specs_from_arguments
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime
from moose_tpu.serde import serialize_computation as jserialize

from moose_tpu_torch import devices as tdevices
from moose_tpu_torch import elk_compiler
from moose_tpu_torch import serde as tserde
from moose_tpu_torch.computation import (
    Computation,
    HostFloat64TensorTy,
    HostPlacement,
    Operation,
    Signature,
)
from moose_tpu_torch.dialects import aes as taes
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import (  # noqa: F401  (threefry: a fixture)
    fixed_keys_env,
    load_chip_smoke,
    prf,
    threefry,
    traced_pair,
)

IDS = ["alice", "bob", "carole"]
TESTS = Path(__file__).resolve().parent
PASSES = ["typing", "prune", "toposort", "wellformed"]


def _aes_blob_and_args():
    jtraced, ttraced = traced_pair("aes_input")
    key, nonce = bytes(range(16)), bytes(range(16, 28))
    # two rows of the 2 features of torch_parity's AES-input graph
    x = np.random.default_rng(4).normal(size=(2, 2))
    wire = taes.encrypt_fixed_array(key, nonce, x, 40)
    blob = tserde.serialize_computation(ttraced)
    assert blob == jserialize(jtraced)
    return blob, {"aes_data": wire, "aes_key": taes.bytes_to_bits_be(key)}


@pytest.fixture(scope="module")
def blobs():
    """The blobs both runtimes serve, with their arguments, and the JAX
    runtime's results under threefry and fixed keys."""
    cs = load_chip_smoke()
    golden = (TESTS / "golden_torch_logreg.msgpack").read_bytes()
    x = np.random.default_rng(3).normal(size=(8, cs.LOGREG_FEATURES))
    cases = {
        "golden": (golden, {"x": x}),
        "elk": (elk_compiler.compile_computation(golden, PASSES), {"x": x}),
        "aes_input": _aes_blob_and_args(),
    }
    runtime = JaxRuntime(IDS, layout="stacked", use_jit=False)
    with prf("threefry"), fixed_keys_env():
        want = {name: runtime.evaluate_compiled(blob, args)
                for name, (blob, args) in cases.items()}
    return cases, want


@pytest.mark.parametrize("name", ("golden", "elk", "aes_input"))
def test_evaluate_compiled_equals_the_jax_runtime(blobs, name, threefry):
    cases, want = blobs
    blob, args = cases[name]
    with fixed_keys_env():
        before = dict(rk.LAUNCHES)
        got = PortRuntime(IDS, device="cpu").evaluate_compiled(blob, args)
        assert rk.LAUNCHES == before  # the CPU runs the plain versions
    assert got.keys() == want[name].keys()
    for key, value in want[name].items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype and got[key].shape == \
            value.shape
        assert np.array_equal(got[key], value), key


def test_from_bytes_equals_the_traced_graph(threefry):
    """Phase 17's check on the CPU: the golden blob, its elk-compiled
    bytes and the textual round trip give evaluate_computation's words,
    and the result is within phase 6's limit of float64."""
    from moose_tpu_torch import textual

    cs = load_chip_smoke()
    clf = cs.logistic_regression(cs.phase6_rng(), cs.LOGREG_FEATURES)
    golden = (TESTS / "golden_torch_logreg.msgpack").read_bytes()
    x = np.random.default_rng(5).normal(size=(8, cs.LOGREG_FEATURES))
    traced = tserde.deserialize_computation(golden)
    runtime = PortRuntime(IDS, device="cpu")
    with fixed_keys_env():
        want = runtime.evaluate_computation(clf.predictor_factory(),
                                            {"x": x})["output_0"]
        got = [
            runtime.evaluate_compiled(golden, {"x": x}),
            runtime.evaluate_compiled(
                elk_compiler.compile_computation(golden, cs.BYTES_PASSES),
                {"x": x}),
            runtime.evaluate_computation(
                textual.parse_computation(textual.to_textual(traced)),
                {"x": x}),
        ]
    for out in got:
        assert np.array_equal(out["output_0"], want)
    assert np.abs(want - cs.logistic_reference(clf, x)).max() < \
        cs.LOGREG_TOL


def test_a_jax_lowered_graph_runs_on_the_physical_executor(threefry):
    """A lowered blob the JAX package wrote (its DEFAULT_PASSES) runs on
    the port's physical executor: the JAX runtime's words under fixed
    keys."""
    jtraced, _ = traced_pair("secure_dot")
    args = {"x": np.ones((2, 2)), "y": np.ones((2, 2))}
    lowered = jcompile(jtraced, JAX_DEFAULT_PASSES,
                       arg_specs=arg_specs_from_arguments(args))
    blob = jserialize(lowered)
    runtime = PortRuntime(IDS, device="cpu")
    with fixed_keys_env():
        want = JaxRuntime(IDS, use_jit=False).evaluate_compiled(blob, args)
        got = runtime.evaluate_compiled(blob, args)
    assert runtime.last_plan["lowered"] is True
    assert np.array_equal(got["output_0"], np.asarray(want["output_0"]))
    assert np.abs(got["output_0"] - 2.0).max() < load_chip_smoke().DOT_TOL


def test_compiler_passes_lower_and_a_mesh_is_refused(threefry):
    """``compiler_passes`` lower the graph for the physical executor, as
    in the JAX runtime (word-equal under pinned nonces and fixed keys);
    passes without the lowering leave a logical graph the physical
    executor cannot run, in both packages alike; a mesh on the runtime's
    device runs the stacked layout's words, any other is refused."""
    from moose_tpu.dialects import host as jhost
    from moose_tpu_torch.dialects import host as thost

    jtraced, ttraced = traced_pair("secure_dot")
    runtime = PortRuntime(IDS, device="cpu")
    args = {"x": np.ones((2, 2)), "y": np.ones((2, 2))}
    with fixed_keys_env():
        with jhost.deterministic_sync_keys(5):
            want = JaxRuntime(IDS, use_jit=False).evaluate_computation(
                jtraced, args, compiler_passes=JAX_DEFAULT_PASSES)
        with thost.deterministic_sync_keys(5):
            got = runtime.evaluate_computation(
                ttraced, args, compiler_passes=JAX_DEFAULT_PASSES)
    assert runtime.last_plan["lowered"] is True
    assert np.array_equal(got["output_0"], np.asarray(want["output_0"]))
    for passes in (["typing"], []):
        with pytest.raises(KeyError, match="dtype"):
            JaxRuntime(IDS, use_jit=False).evaluate_computation(
                jtraced, args, compiler_passes=passes)
        with pytest.raises(KeyError, match="dtype"):
            runtime.evaluate_computation(ttraced, args,
                                         compiler_passes=passes)
    # a mesh reaches the stacked layout: six handles over the CPU run
    # the JAX package's stacked words; a mesh on another device than
    # the runtime's, or over several, is refused
    mesh = tspmd.make_mesh(devices=tdevices.virtual_devices("cpu", 6))
    with fixed_keys_env():
        want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
            .evaluate_computation(jtraced, args)["output_0"]
        meshed = PortRuntime(IDS, layout="stacked", mesh=mesh, device="cpu")
        got = meshed.evaluate_computation(ttraced, args)["output_0"]
    assert meshed.last_plan["layout"] == "stacked"
    assert np.array_equal(got, np.asarray(want))
    meta = tspmd.make_mesh(devices=[tdevices.Device(i, "meta")
                                    for i in range(3)])
    with pytest.raises(ConfigurationError, match="mesh on meta"):
        PortRuntime(IDS, mesh=meta, device="cpu")
    cards = tspmd.make_mesh(devices=[tdevices.Device(i, f"cuda:{i}")
                                     for i in range(3)])
    with pytest.raises(NotImplementedError, match="item 12.9"):
        PortRuntime(IDS, mesh=cards, device="cpu")
    # the per-host layout runs a blob too: the JAX package's per-host
    # words under fixed keys
    blob = tserde.serialize_computation(ttraced)
    with fixed_keys_env():
        want = JaxRuntime(IDS, layout="per-host", use_jit=False) \
            .evaluate_computation(jtraced, args)["output_0"]
        per_host = PortRuntime(IDS, layout="per-host", use_jit=False,
                               device="cpu")
        got = per_host.evaluate_compiled(blob, args)["output_0"]
    assert per_host.last_plan["layout"] == "per-host"
    assert np.array_equal(got, np.asarray(want))


def test_the_reference_s_keyword_set():
    """(identities, storage_mapping, use_jit, layout, mesh), as
    examples/logistic_regression.py calls it; use_jit resolves as the
    JAX runtime resolves it (``MOOSE_TPU_JIT``), and the port runs
    eagerly either way."""
    runtime = PortRuntime(IDS, {"alice": {}}, False, "stacked", None,
                          device="cpu")
    assert runtime.use_jit is False and runtime.layout == "stacked"
    assert PortRuntime(IDS, device="cpu").use_jit is \
        JaxRuntime(IDS).use_jit


def _echo_blob(tag):
    """A host-only graph whose Output carries ``tag``: a distinct blob
    for each tag."""
    comp = Computation()
    comp.add_placement(HostPlacement("alice"))
    f64 = HostFloat64TensorTy
    comp.add_operation(Operation("x", "Input", [], "alice",
                                 Signature((), f64)))
    comp.add_operation(Operation("out", "Output", ["x"], "alice",
                                 Signature((f64,), f64), {"tag": tag}))
    return tserde.serialize_computation(comp)


def test_the_memo_holds_32_blobs_and_refreshes_on_a_hit():
    runtime = PortRuntime(IDS, device="cpu")
    x = np.arange(3.0)
    blobs = [_echo_blob(f"y{i}") for i in range(34)]
    for i, blob in enumerate(blobs[:32]):
        assert np.array_equal(
            runtime.evaluate_compiled(blob, {"x": x})[f"y{i}"], x)
    first = runtime._bin_cache[blobs[0]]
    # a hit returns the same object and makes blob 0 the newest
    runtime.evaluate_compiled(blobs[0], {"x": x})
    assert runtime._bin_cache[blobs[0]] is first
    runtime.evaluate_compiled(blobs[32], {"x": x})
    assert len(runtime._bin_cache) == 32
    assert blobs[0] in runtime._bin_cache and blobs[1] not in \
        runtime._bin_cache
    runtime.evaluate_compiled(blobs[33], {"x": x})
    assert blobs[2] not in runtime._bin_cache
    assert list(runtime._bin_cache)[-3:] == [blobs[0], blobs[32], blobs[33]]


def test_read_only_arguments_are_copied_before_lifting():
    """An argument over a read-only buffer (np.frombuffer, as a decoded
    wire value is) lifts as a copy: no warning, and nothing aliases it."""
    import warnings

    data = np.arange(3.0)
    x = np.frombuffer(data.tobytes(), dtype=np.float64)
    assert not x.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = PortRuntime(IDS, device="cpu").evaluate_compiled(
            _echo_blob("y"), {"x": x})["y"]
    assert np.array_equal(out, data)
