"""BASELINE config 2 through the port on the CPU: Load and Save at the
host boundary, the port's storage and mirrored modules, and the
scientific-computing tutorial's ``multiparty_correlation``.

Load and Save through dict storage and through ``FilesystemStorage``
(``.npy`` round trip, ``.csv`` with a JSON column query) against the JAX
package's ``moose_tpu.storage`` on the same files; the correlation at
the tutorial test's 64 rows bit-identical to the JAX LocalMooseRuntime
(stacked layout) under fixed keys and both threefry streams, and the
same overflow word for word at 4,096 rows, where fixed(24,40)'s range
ends; LoadShares and SaveShares through each party's own store, as the
JAX runtime runs them; ``mirrored.py`` against
``moose_tpu/dialects/mirrored.py``.

Each JAX correlation costs 20-35 s on the CPU (its eager kernels compile
per shape), so each runs once per module, in a fixture."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu import storage as jstorage
from moose_tpu.computation import Mirrored3Placement as JaxMirrored
from moose_tpu.dialects import mirrored as jmirrored
from moose_tpu.execution.session import EagerSession as JaxSession
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime
from moose_tpu.values import HostRingTensor as JaxRing
from moose_tpu.values import HostShape as JaxShape
from moose_tpu.values import HostTensor as JaxTensor
from moose_tpu.values import ring_to_limbs as jring_to_limbs

import moose_tpu_torch as tm
from moose_tpu_torch import dtypes as tdt
from moose_tpu_torch import storage as tstorage
from moose_tpu_torch.computation import Mirrored3Placement
from moose_tpu_torch.dialects import mirrored as tmirrored
from moose_tpu_torch.errors import StorageError
from moose_tpu_torch.execution import interpreter as tinterpreter
from moose_tpu_torch.execution.session import EagerSession
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime
from moose_tpu_torch.values import HostRingTensor, HostShape, HostTensor

from torch_parity import (
    assert_words_equal,
    fixed_keys_env,
    prf,
    rand_words,
    threefry,  # noqa: F401  (fixture)
    to_jax,
    to_port,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tutorials"))
import chip_smoke  # noqa: E402
import scientific_computing_multiple_players as tutorial  # noqa: E402

IDS = ["alice", "bob", "carole"]
STREAMS = ("threefry", "threefry-pallas")


# -- the storage module ----------------------------------------------------


def test_filesystem_storage_matches_the_reference(tmp_path):
    port = tstorage.FilesystemStorage(tmp_path / "port")
    ref = jstorage.FilesystemStorage(tmp_path / "ref")
    arr = np.random.default_rng(0).normal(size=(3, 4))
    for store in (port, ref):
        store.save("model.v1", arr)
        store["ckpt/gen-0/w"] = arr[:1]
    # each reads what the other wrote, byte for byte the same files
    for name in ("model.v1.npy", "ckpt/gen-0/w.npy"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    for a, b in ((port, ref), (ref, port)):
        other = type(a)(b.root)
        assert np.array_equal(other.load("model.v1"), arr)
    assert port.list_keys() == ref.list_keys() == ["ckpt/gen-0/w", "model.v1"]
    assert port.list_keys("ckpt/") == ["ckpt/gen-0/w"]
    assert "model.v1" in port and "absent" not in port
    port.delete("ckpt/gen-0/w")
    assert not (tmp_path / "port" / "ckpt").exists()
    for bad in (lambda: port.load("absent"), lambda: port.delete("absent"),
                lambda: port.save("../escape", arr),
                lambda: port.save("obj", np.array([{}], dtype=object))):
        with pytest.raises(StorageError):
            bad()


def test_csv_query_matches_the_reference(tmp_path):
    (tmp_path / "table.csv").write_text("x,y,z\n1,2,3\n4.5,5,6\n")
    query = json.dumps({"select_columns": ["z", "x"]})
    port = tstorage.FilesystemStorage(tmp_path)
    ref = jstorage.FilesystemStorage(tmp_path)
    for q in ("", query):
        got, want = port.load("table", q), ref.load("table", q)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.array_equal(port.load("table", query), [[3, 1], [6, 4.5]])
    with pytest.raises(StorageError, match="no columns"):
        port.load("table", json.dumps({"select_columns": ["w"]}))
    with pytest.raises(StorageError, match="bad csv query"):
        port.load("table", "{")


# -- Load and Save through the runtime -------------------------------------


def _rescale_computation(pm, query=""):
    """alice loads ``x`` (with ``query``), bob's share of the replicated
    work doubles it in fixed(14,23), carole saves the result as ``y``
    and the output is the Save's unit."""
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(14, 23)

    @pm.computation
    def rescale():
        with alice:
            x = pm.cast(pm.load("x", query, dtype=pm.float64), dtype=fx)
        with rep:
            y = pm.add(x, x)
        with carole:
            y = pm.save("y", pm.cast(y, dtype=pm.float64))
        return y

    return rescale


@pytest.fixture(scope="module")
def rescaled():
    """The rescale graph in the JAX package: its saved value from dict
    storage and from ``FilesystemStorage``."""
    x = np.random.default_rng(3).normal(size=(4, 3))
    with prf("threefry"), fixed_keys_env():
        rt = JaxRuntime(IDS, storage_mapping={"alice": {"x": x}},
                        layout="stacked", use_jit=False)
        rt.evaluate_computation(_rescale_computation(jm))
        return x, rt.read_value_from_storage("carole", "y")


def test_load_save_through_dicts(rescaled, threefry):
    x, want = rescaled
    with fixed_keys_env():
        rt = PortRuntime(IDS, storage_mapping={"alice": {"x": x}},
                         device="cpu")
        out = rt.evaluate_computation(_rescale_computation(tm))
    assert out == {"output_0": None}
    got = rt.read_value_from_storage("carole", "y")
    # numpy, never a device tensor, of the reference's dtype and shape
    assert type(got) is np.ndarray and got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.abs(got - 2 * x).max() < 2.0 ** -20


def test_load_save_through_filesystem_storage(tmp_path, rescaled, threefry):
    x, want = rescaled
    tstorage.FilesystemStorage(tmp_path / "alice").save("x", x)
    stores = {name: tstorage.FilesystemStorage(tmp_path / name)
              for name in ("alice", "carole")}
    with fixed_keys_env():
        rt = PortRuntime(IDS, storage_mapping=stores, device="cpu")
        rt.evaluate_computation(_rescale_computation(tm))
    # the runtime keeps the storage objects: the .npy is on disk
    assert rt.storage["carole"] is stores["carole"]
    saved = jstorage.FilesystemStorage(tmp_path / "carole").load("y")
    assert np.array_equal(saved, want)


def test_load_reads_a_csv_with_its_query(tmp_path, threefry):
    rows = np.random.default_rng(4).normal(size=(5, 3))
    text = "a,b,c\n" + "".join(
        ",".join(repr(float(v)) for v in row) + "\n" for row in rows)
    (tmp_path / "alice").mkdir()
    (tmp_path / "alice" / "x.csv").write_text(text)
    query = json.dumps({"select_columns": ["c", "a"]})
    stores = {"alice": tstorage.FilesystemStorage(tmp_path / "alice")}
    rt = PortRuntime(IDS, storage_mapping=stores, device="cpu")
    rt.evaluate_computation(_rescale_computation(tm, query))
    got = rt.read_value_from_storage("carole", "y")
    want = jstorage.FilesystemStorage(tmp_path / "alice").load("x", query)
    assert got.shape == (5, 2)
    assert np.abs(got - 2 * want).max() < 2.0 ** -20


def test_load_of_a_missing_key_names_it():
    rt = PortRuntime(IDS, device="cpu")
    with pytest.raises(KeyError, match="'x' in storage of 'alice'"):
        rt.evaluate_computation(_rescale_computation(tm))


def test_saved_ring_words_are_the_reference_s_limb_planes():
    rng = np.random.default_rng(5)
    for width in (64, 128):
        pair = rand_words(rng, (2, 3), width)
        want = np.asarray(jring_to_limbs(JaxRing(*to_jax(pair), width, "c")))
        got = tinterpreter._save_user_value(
            None, HostRingTensor(*to_port(pair), width, "c"))
        assert got.dtype == np.uint64 and np.array_equal(got, want)


def test_load_shares_and_save_shares_name_their_roadmap_items():
    # ROADMAP queue 1, item 10 ported them, and nothing names an item any
    # more: the walk reads each party's own #s0/#s1 limb planes and saves
    # the pair it holds under the new key, word for word as the JAX
    # runtime does; the stacked layout leaves them to the per-host layout
    from moose_tpu.edsl import base as jedsl
    from moose_tpu_torch.dialects import stacked as tstacked
    from moose_tpu_torch.edsl import base as edsl

    def checkpoint_of(pm, base):
        alice, bob, carole = (pm.host_placement(n) for n in IDS)
        rep = pm.replicated_placement("rep", players=[alice, bob, carole])

        @pm.computation
        def checkpoint():
            with rep:
                w = base.load_shares("w", (2, 1), pm.fixed(24, 40))
                unit = base.save_shares("w_next", w)
            return unit

        return checkpoint

    rng = np.random.default_rng(6)
    stored = {p: {f"w#s{slot}": rng.integers(
        0, 1 << 64, size=(2, 2, 1), dtype=np.uint64) for slot in (0, 1)}
        for p in IDS}
    runtime = PortRuntime(IDS, storage_mapping=stored, device="cpu")
    out = runtime.evaluate_computation(checkpoint_of(tm, edsl))
    assert runtime.last_plan["layout"] == "per-host"
    jax_runtime = JaxRuntime(IDS, storage_mapping=stored, use_jit=False)
    want = jax_runtime.evaluate_computation(checkpoint_of(jm, jedsl))
    assert out == want == {"output_0": None}
    for p in IDS:
        for slot in (0, 1):
            got = runtime.storage[p][f"w_next#s{slot}"]
            assert got.dtype == np.uint64
            assert np.array_equal(got, stored[p][f"w#s{slot}"])
            assert np.array_equal(
                got, np.asarray(jax_runtime.storage[p][f"w_next#s{slot}"]))
    assert tstacked.roadmap_item("ReplicatedPlacement", "LoadShares") == \
        tstacked.roadmap_item("ReplicatedPlacement", "SaveShares") == \
        "the per-host layout runs it"


# -- the mirrored dialect --------------------------------------------------


def _mirrored_pair(pair, width):
    """One ring value mirrored on alice, bob and carole in each package."""
    jsess, tsess = JaxSession(), EagerSession("cpu")
    jmir = JaxMirrored("mir", tuple(IDS))
    tmir = Mirrored3Placement("mir", tuple(IDS))
    jx = jmirrored.mirror(jsess, jmir, JaxRing(*to_jax(pair), width, "alice"))
    tx = tmirrored.mirror(
        tsess, tmir, HostRingTensor(*to_port(pair), width, "alice"))
    return (jsess, jmir, jx), (tsess, tmir, tx)


def _assert_mirrored_equal(got, want, width):
    assert got.plc == want.plc
    for g, w in zip(got.values, want.values):
        assert g.plc == w.plc and g.width == w.width == width
        assert_words_equal((g.lo, g.hi), (w.lo, w.hi))


@pytest.mark.parametrize("width", (64, 128))
def test_mirrored_ring_ops_match_the_reference(width):
    rng = np.random.default_rng(width)
    x, y = rand_words(rng, (3, 2), width), rand_words(rng, (3, 2), width)
    (js, jmir, jx), (ts, tmir, tx) = _mirrored_pair(x, width)
    (_, _, jy), (_, _, ty) = _mirrored_pair(y, width)
    for name in ("add", "sub", "mul"):
        _assert_mirrored_equal(
            getattr(tmirrored, name)(ts, tmir, tx, ty),
            getattr(jmirrored, name)(js, jmir, jx, jy), width)
    for name in ("shl", "shr"):
        for amount in (0, 5, 63, width - 1):
            _assert_mirrored_equal(
                getattr(tmirrored, name)(ts, tmir, tx, amount),
                getattr(jmirrored, name)(js, jmir, jx, amount), width)
    ty_name = f"HostRing{width}Tensor"
    _assert_mirrored_equal(
        tmirrored.fill(ts, tmir, HostShape((2, 2), "alice"), -3, ty_name),
        jmirrored.fill(js, jmir, JaxShape((2, 2), "alice"), -3, ty_name),
        width)
    for to in ("bob", "dave"):
        got = tmirrored.demirror(ts, tmir, tx, to)
        want = jmirrored.demirror(js, jmir, jx, to)
        assert got.plc == want.plc == to
        assert_words_equal((got.lo, got.hi), (want.lo, want.hi))


def test_mirrored_fixedpoint_round_trip_matches_the_reference():
    x = np.random.default_rng(6).normal(size=(2, 3)) * 100
    jsess, tsess = JaxSession(), EagerSession("cpu")
    jmir = JaxMirrored("mir", tuple(IDS))
    tmir = Mirrored3Placement("mir", tuple(IDS))
    jx = jmirrored.mirror(jsess, jmir,
                          JaxTensor(np.asarray(x), "alice", jm.float64))
    tx = tmirrored.mirror(tsess, tmir, HostTensor(
        torch.as_tensor(x), "alice", tdt.float64))
    for width in (64, 128):
        jenc = jmirrored.ring_fixedpoint_encode(jsess, jmir, jx, 23, width)
        tenc = tmirrored.ring_fixedpoint_encode(tsess, tmir, tx, 23, width)
        _assert_mirrored_equal(tenc, jenc, width)
        jdec = jmirrored.ring_fixedpoint_decode(jsess, jmir, jenc, 23)
        tdec = tmirrored.ring_fixedpoint_decode(tsess, tmir, tenc, 23)
        for g, w in zip(tdec.values, jdec.values):
            assert np.array_equal(g.value.numpy(), np.asarray(w.value))


def test_mirrored_values_reach_a_host_through_demirror(threefry):
    # a mirrored fixed-point constant cast to a float on carole: the
    # logical to_host demirrors it (as moose_tpu/dialects/logical.py:81)
    value = np.array([[1.5, -2.25]])

    def build(pm):
        alice, bob, carole = (pm.host_placement(n) for n in IDS)
        mir = pm.mirrored_placement("mir", players=[alice, bob, carole])

        @pm.computation
        def demirror():
            with mir:
                c = pm.cast(pm.constant(value, dtype=pm.float64),
                            dtype=pm.fixed(14, 23))
            with carole:
                out = pm.cast(c, dtype=pm.float64)
            return out

        return demirror

    want = JaxRuntime(IDS, layout="stacked", use_jit=False) \
        .evaluate_computation(build(jm))["output_0"]
    got = PortRuntime(IDS, device="cpu").evaluate_computation(
        build(tm))["output_0"]
    assert np.array_equal(got, want) and np.array_equal(got, value)


# -- BASELINE config 2: the tutorial's correlation --------------------------


def _correlations(n, stream):
    """The tutorial's own computation and columns through the JAX runtime,
    chip_smoke.py's port of it through the port's, under fixed keys."""
    alcohol, grades = tutorial.generate_synthetic_correlated_data(n)
    with prf(stream), fixed_keys_env():
        want, _ = chip_smoke.run_correlation(
            JaxRuntime, tutorial.multiparty_correlation, alcohol, grades,
            layout="stacked", use_jit=False)
        got, runtime = chip_smoke.run_correlation(
            PortRuntime, chip_smoke.correlation_computation(tm), alcohol,
            grades, device="cpu")
    np_corr = np.corrcoef(alcohol.ravel(), grades.ravel())[1, 0]
    return got, want, np_corr, runtime


@pytest.fixture(scope="module")
def correlations():
    return {stream: _correlations(64, stream) for stream in STREAMS}


def test_correlation_columns_are_the_tutorial_s():
    for n in (64, chip_smoke.CORR_SIZES[-1]):
        for got, want in zip(chip_smoke.correlated_columns(n),
                             tutorial.generate_synthetic_correlated_data(n)):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("stream", STREAMS)
def test_correlation_bit_identical(correlations, stream):
    got, want, np_corr, runtime = correlations[stream]
    # what the tutorial reads back: a 0-d float64 numpy array; equal
    # floats decoded from fixed(24,40) below 2^13 are equal ring words
    assert type(got) is np.ndarray and got.shape == () == want.shape
    assert got.dtype == np.float64
    assert np.array_equal(got, want)
    assert abs(float(np.ravel(got)[0]) - np_corr) < chip_smoke.CORR_TOL
    # the departments' columns stay where they were, as numpy
    assert set(runtime.storage["pub_health_dpt"]) == {"alcohol_data"}


def test_correlation_graph_is_the_tutorial_s():
    from moose_tpu.edsl import tracer as jtracer
    from moose_tpu_torch.edsl import tracer as ttracer

    def kinds(comp):
        return sorted(
            (type(comp.placements[op.placement_name]).__name__, op.kind)
            for op in comp.operations.values()
        )

    want = jtracer.trace(tutorial.multiparty_correlation)
    got = ttracer.trace(chip_smoke.correlation_computation(tm))
    assert kinds(got) == kinds(want)
    assert ("HostPlacement", "Load") in kinds(got)


def test_correlation_overflows_as_the_reference_does(threefry):
    # past fixed(24,40)'s range the sums of squares' product wraps: the
    # port gives the reference's wrong answer, word for word
    got, want, np_corr, _ = _correlations(4096, "threefry")
    assert np.array_equal(got, want)
    assert abs(float(got) - np_corr) > 0.5
