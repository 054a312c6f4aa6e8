"""The port's fabric transport (``moose_tpu_torch/distributed/fabric.py``)
held against the JAX package's (``moose_tpu/distributed/fabric.py``) on
the CPU: tests/test_fabric.py's nine cases, and the fabric under
in-process gRPC workers (``WorkerServer(fabric_domain=)``).

Parties are device handles (``devices.local_devices("cpu")`` at 12
virtual devices, as ``tests/conftest.py`` gives the JAX package 12 XLA
CPU devices).  The JAX package moves a payload by a ``lax.ppermute``
program over its party mesh; the port copies each tensor into a fresh
buffer on the receiver's device.  Under ``MOOSE_TPU_FIXED_KEYS`` and
the threefry PRF, with both lowerings inside
``deterministic_sync_keys``, the port's fabric sessions give the JAX
package's fabric session's outputs word for word (4x3 @ 3x2 secure dot,
fixed(14,23)), move no payload over the wire, and their fabric counters
equal the port's cost model exactly."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.compilation import DEFAULT_PASSES as JPASSES
from moose_tpu.compilation import compile_computation as jcompile
from moose_tpu.compilation.lowering import arg_specs_from_arguments as jspecs
from moose_tpu.dialects import host as jhost
from moose_tpu.distributed import fabric as jfabric
from moose_tpu.distributed.networking import LocalNetworking as JaxLocal
from moose_tpu.distributed.networking import ProgressClock as JaxClock
from moose_tpu.distributed.worker import execute_role as jexecute_role
from moose_tpu.edsl import tracer as jtracer

import moose_tpu_torch as tm
from moose_tpu_torch import devices, metrics
from moose_tpu_torch.compilation import DEFAULT_PASSES as TPASSES
from moose_tpu_torch.compilation import compile_computation as tcompile
from moose_tpu_torch.compilation.analysis.cost import cost_report
from moose_tpu_torch.compilation.lowering import (
    arg_specs_from_arguments as tspecs,
)
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.distributed import FabricDomain, FabricNetworking
from moose_tpu_torch.distributed.choreography import start_local_cluster
from moose_tpu_torch.distributed.client import GrpcClientRuntime
from moose_tpu_torch.distributed.fabric import (
    _rebuild,
    fabric_enabled,
    value_leaves,
)
from moose_tpu_torch.distributed.networking import (
    LocalNetworking,
    ProgressClock,
)
from moose_tpu_torch.distributed.worker import execute_role
from moose_tpu_torch.edsl import tracer as ttracer
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.parallel.spmd import fabric_party_mesh
from moose_tpu_torch.values import (
    HostPrfKey,
    HostRingTensor,
    HostString,
    RepTensor,
)

from test_torch_distributed import _env
from torch_parity import fixed_keys_env, prf

IDS = ("alice", "bob", "carole")
SEED = 20261020
SESSION = "fab-1"
WAIT_S = 30.0
COUNTERS = {
    "sends": ("moose_tpu_net_sends_total", {"transport": "fabric"}),
    "fabric_permutes": ("moose_tpu_fabric_permutes_total", {}),
    "fabric_batched_permutes":
        ("moose_tpu_fabric_batched_permutes_total", {}),
    "fabric_permute_payloads":
        ("moose_tpu_fabric_permute_payloads_total", {}),
    "fabric_tx_bytes": ("moose_tpu_fabric_tx_bytes_total", {}),
}


@pytest.fixture(autouse=True, scope="module")
def twelve_cpu_devices():
    """12 virtual CPU devices for the port, as the conftest gives JAX."""
    prev = devices.cpu_device_count()
    devices.set_cpu_device_count(12)
    yield
    devices.set_cpu_device_count(prev)


def _secure_dot(pm):
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.float64),
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

    return comp


def _args():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(4, 3)), "w": rng.normal(size=(3, 2))}


def _run(run_role, comp, args, net_of, session, clock_cls=ProgressClock):
    """Each identity's role on a thread over ``net_of(identity)``; the
    outputs of all roles."""
    results, errors = {}, {}
    clock = clock_cls()

    def work(identity):
        try:
            results[identity] = run_role(comp, identity, {}, args,
                                         net_of(identity), session,
                                         timeout=WAIT_S, progress=clock)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors[identity] = e

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in IDS]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 4 * WAIT_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a role hung"
    assert not errors, errors
    return {k: v for r in results.values() for k, v in r["outputs"].items()}


def _metric(name, **labels):
    return metrics.REGISTRY.value(name, **labels)


def _counts():
    return {k: _metric(n, **lb) for k, (n, lb) in COUNTERS.items()}


@pytest.fixture(scope="module")
def case():
    """The port's trace and lowering of the secure dot, and the JAX
    package's fabric session's outputs under fixed keys."""
    args = _args()
    with jhost.deterministic_sync_keys(SEED):
        jl = jcompile(jtracer.trace(_secure_dot(jm)), JPASSES,
                      jspecs(args))
    traced = ttracer.trace(_secure_dot(tm))
    with thost.deterministic_sync_keys(SEED):
        tl = tcompile(traced, TPASSES, tspecs(args))
    dom = jfabric.FabricDomain.default(IDS, trust_model="simulation")
    inner = JaxLocal()
    nets = {i: jfabric.FabricNetworking(dom, i, inner) for i in IDS}
    with prf("threefry"), fixed_keys_env(), _env(MOOSE_TPU_WORKER_JIT="0"):
        want = _run(jexecute_role, jl, args, nets.get, SESSION,
                    clock_cls=JaxClock)
    return SimpleNamespace(traced=traced, tl=tl, args=args, want={
        k: np.asarray(v) for k, v in want.items()})


def _assert_jax_words(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        assert np.array_equal(np.asarray(got[name]), value), name


# -- domain construction -------------------------------------------------------


def test_fabric_domain_validation():
    devs = devices.local_devices("cpu")
    with pytest.raises(ConfigurationError):
        FabricDomain({"alice": devs[:1], "bob": devs[1:2]},
                     trust_model="tofu")
    with pytest.raises(ConfigurationError):  # < 2 parties is no fabric
        FabricDomain({"alice": devs[:1]}, trust_model="simulation")
    with pytest.raises(ConfigurationError):  # overlapping slices
        FabricDomain({"alice": devs[:1], "bob": devs[:1]},
                     trust_model="simulation")
    # distinct handles over one torch device are distinct devices
    one = devices.virtual_devices("cpu", 2)
    FabricDomain({"alice": one[:1], "bob": one[1:]},
                 trust_model="simulation")
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    jdom = jfabric.FabricDomain.default(IDS, trust_model="simulation")
    assert dom.parties == jdom.parties == IDS
    assert dom.trust_model == "simulation"
    assert [dom.party_index(p) for p in IDS] == [0, 1, 2]
    assert dom.is_member("alice") and not dom.is_member("mallory")
    for a in IDS:
        for b in IDS:
            assert dom.hops(a, b) == jdom.hops(a, b)
    assert dom.cost_context() == jdom.cost_context()
    # too few devices: the JAX package's refusal, word for word
    many = [f"p{i}" for i in range(13)]
    with pytest.raises(jm.errors.ConfigurationError) as jerr:
        jfabric.FabricDomain.default(many, trust_model="simulation")
    with pytest.raises(ConfigurationError) as terr:
        FabricDomain.default(many, trust_model="simulation", device="cpu")
    assert str(terr.value) == str(jerr.value)
    # the port's default device is the card
    if not torch.cuda.is_available():
        with pytest.raises(ConfigurationError, match="device='cpu'"):
            FabricDomain.default(IDS, trust_model="simulation")


def test_fabric_party_mesh_needs_flat_lead_devices():
    import jax

    from moose_tpu.parallel.spmd import fabric_party_mesh as jmesh

    mesh = fabric_party_mesh(devices.local_devices("cpu")[:3])
    want = jmesh(jax.devices()[:3])
    assert mesh.axis_names == want.axis_names == ("parties",)
    assert mesh.devices.shape == want.devices.shape == (3,)
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    assert list(dom.mesh.devices) == [dom.slices[p][0] for p in IDS]
    with pytest.raises(ValueError):
        fabric_party_mesh(devices.local_devices("cpu")[:1])
    with pytest.raises(ValueError):
        fabric_party_mesh([devices.local_devices("cpu")[:2]])


def test_fabric_permute_moves_leaves_bit_exact():
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**63, size=(2, 3)).astype(np.uint64)
    leaves = [
        torch.from_numpy(words.view(np.int64)),
        torch.from_numpy(rng.integers(0, 2**31, size=(4,)).astype(
            np.int32)),
        np.arange(4, dtype=np.uint32),  # a key's words, on the host
    ]
    before = _metric("moose_tpu_fabric_permutes_total")
    moved, nbytes = dom.permute("alice", "carole", leaves)
    assert nbytes == 2 * 3 * 8 + 4 * 4 + 4 * 4  # the JAX package's count
    assert _metric("moose_tpu_fabric_permutes_total") == before + 1
    for src, dst in zip(leaves, moved):
        if isinstance(src, torch.Tensor):
            assert dst.device == dom.device_of("carole")
            assert torch.equal(src, dst)
            # a fresh buffer on the receiver's side, never a view
            assert dst.data_ptr() != src.data_ptr()
        else:
            assert np.array_equal(src, dst) and dst is not src


def test_fabric_networking_rejects_bad_wiring():
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    with pytest.raises(ConfigurationError):  # non-member identity
        FabricNetworking(dom, "mallory", LocalNetworking(device="cpu"))
    with pytest.raises(ConfigurationError):  # raw-object wire path
        FabricNetworking(
            dom, "alice", LocalNetworking(serialize=False, device="cpu"))
    # a wire that delivers to another device than the party's slice
    meta = FabricDomain(
        {"alice": (devices.Device(0, "meta"),),
         "bob": (devices.Device(1, "meta"),)},
        trust_model="simulation")
    with pytest.raises(ConfigurationError, match="one device"):
        FabricNetworking(meta, "alice", LocalNetworking(device="cpu"))


# -- routing: kill switch, force-wire latch, passthrough values ----------------


def test_fabric_kill_switch_routes_everything_to_wire(monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_FABRIC", "0")
    assert not fabric_enabled()
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    net = FabricNetworking(dom, "alice", LocalNetworking(device="cpu"))
    assert net._wire_reason("bob", "k-0", "s-1") == "disabled"
    assert net.fabric_cost_context() is None
    assert net.transport_descriptor()["transport"] == "grpc"


def test_fabric_force_wire_latch_and_cost_context():
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    net = FabricNetworking(dom, "alice", LocalNetworking(device="cpu"))
    assert net._wire_reason("bob", "k-0", "s-1") is None
    assert net._wire_reason("mallory", "k-0", "s-1") == "trust_boundary"
    assert net.fabric_cost_context() == (IDS, "simulation")
    assert net.transport_descriptor() == {
        "transport": "fabric", "trust_model": "simulation"}
    # the chaos drop hook: a latched key rides the wire for good, and
    # the cost model declines to predict (the edge set went key-dependent)
    net.force_wire("k-0")
    assert net._wire_reason("bob", "k-0", "s-2") == "forced_wire"
    assert net._wire_reason("bob", "k-1", "s-2") is None
    assert net.fabric_cost_context() is None


def test_fabric_passthrough_value_restamps_placement():
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    inner = LocalNetworking(device="cpu")
    alice = FabricNetworking(dom, "alice", inner)
    bob = FabricNetworking(dom, "bob", inner)
    before = _metric("moose_tpu_fabric_permutes_total")
    assert alice.send(
        HostString("hello", "alice"), "bob", "k-pass", "s-pass") == 0
    got = bob.receive("alice", "k-pass", "s-pass", plc="bob", timeout=5.0)
    assert isinstance(got, HostString)
    assert got.value == "hello" and got.plc == "bob"
    # no array leaves: no permute
    assert _metric("moose_tpu_fabric_permutes_total") == before
    # a sharing and a key: moved, rebuilt in leaf order, re-placed
    ring = HostRingTensor(torch.arange(6).reshape(2, 3), None, 64, "alice")
    rep = RepTensor(((ring, ring), (ring, ring), (ring, ring)), "rep")
    key = HostPrfKey((1, 2, 3, 2**32 - 1), "alice", origin="gen")
    assert len(value_leaves(rep)) == 6
    assert alice.send_many([("k-rep", rep), ("k-key", key)], "bob",
                           "s-pass") == 6 * 48 + 16
    got = bob.receive("alice", "k-rep", "s-pass", plc="rep2", timeout=5.0)
    assert got.plc == "rep2"
    assert all(torch.equal(s.lo, ring.lo) for p in got.shares for s in p)
    got = bob.receive("alice", "k-key", "s-pass", plc="bob", timeout=5.0)
    # the wire codec's key: the words, the receiver's placement
    assert got == HostPrfKey((1, 2, 3, 2**32 - 1), "bob")
    assert _rebuild(key, value_leaves(key)).value == key.value


# -- end to end: word-equal to the JAX package, zero wire, exact cost ----------


def test_fabric_secure_dot_bit_identical_zero_wire_exact_cost(case,
                                                            monkeypatch):
    # the fast path on, as the JAX package's fabric tests run it: the
    # cost model predicts the plan's coalesced envelopes
    monkeypatch.setenv("MOOSE_TPU_WORKER_JIT", "1")
    tl, args, want = case.tl, case.args, case.want
    dom = FabricDomain.default(IDS, trust_model="simulation", device="cpu")
    inner = LocalNetworking(device="cpu")
    nets = {i: FabricNetworking(dom, i, inner) for i in IDS}
    before, before_wire = _counts(), _metric(
        "moose_tpu_net_sends_total", transport="local")
    with prf("threefry"), fixed_keys_env():
        got = _run(execute_role, tl, args, nets.get, SESSION)
    # no send on the wire transport
    assert _metric("moose_tpu_net_sends_total",
                   transport="local") == before_wire
    _assert_jax_words(got, want)
    np.testing.assert_allclose(got["output_0"], args["x"] @ args["w"],
                               atol=1e-4)
    # measured == predicted exactly, counter for counter (the plan
    # coalesces its sends)
    measured = {k: v - before[k] for k, v in _counts().items()}
    report = cost_report(tl, session_id=SESSION, transport="fabric",
                         fabric_parties=IDS, coalesce=True)
    assert report["resolved"], report
    assert measured == {k: report["totals"][k] for k in COUNTERS}
    assert measured["fabric_permutes"] > 0
    assert report["totals"]["fallback_sends"] == 0
    assert report["fabric_parties"] == list(IDS)


def test_fabric_mixed_trust_falls_back_on_crossing_edges_only(case):
    """carole sits outside the fabric: alice<->bob edges stay on the
    fabric, every edge touching carole rides the wire, and the outputs
    stay the JAX package's."""
    tl, args, want = case.tl, case.args, case.want
    dom = FabricDomain.default(["alice", "bob"],
                               trust_model="colocated_tee", device="cpu")
    inner = LocalNetworking(device="cpu")
    nets = {i: FabricNetworking(dom, i, inner) if dom.is_member(i)
            else inner for i in IDS}
    before_fallbacks = _metric("moose_tpu_fabric_fallbacks_total",
                               reason="trust_boundary")
    before_permutes = _metric("moose_tpu_fabric_permutes_total")
    with prf("threefry"), fixed_keys_env():
        got = _run(execute_role, tl, args, nets.get, "fab-mixed")
    _assert_jax_words(got, want)
    crossed = _metric("moose_tpu_fabric_fallbacks_total",
                      reason="trust_boundary") - before_fallbacks
    permuted = _metric("moose_tpu_fabric_permutes_total") - before_permutes
    assert crossed > 0 and permuted > 0
    report = cost_report(tl, session_id="fab-mixed", transport="fabric",
                         fabric_parties=("alice", "bob"))
    assert report["resolved"], report
    assert crossed == sum(report["per_party"][p]["fallback_sends"]
                          for p in ("alice", "bob"))


@pytest.mark.parametrize("members,transport,trust", [
    (IDS, "fabric", "simulation"),
    (("alice", "bob"), "mixed", "simulation"),
])
def test_fabric_workers_over_grpc(case, members, transport, trust):
    """``start_local_cluster(..., fabric_domain=)``: the workers of the
    domain lower their intra-domain edges, the session report names the
    transport as the JAX client words it, and the outputs are the JAX
    package's fabric session's."""
    dom = FabricDomain.default(members, trust_model=trust, device="cpu")
    servers, endpoints = start_local_cluster(
        IDS, device="cpu", fabric_domain=dom, ping_interval=0.25,
        receive_timeout=WAIT_S)
    before = _metric("moose_tpu_fabric_permutes_total")
    try:
        client = GrpcClientRuntime(endpoints, max_attempts=1)
        with prf("threefry"), fixed_keys_env(), \
                thost.deterministic_sync_keys(SEED):
            got, _ = client.run_computation(case.traced, case.args,
                                            timeout=WAIT_S)
        report = client.last_session_report
    finally:
        for srv in servers.values():
            srv.stop()
    _assert_jax_words(got, case.want)
    assert _metric("moose_tpu_fabric_permutes_total") > before
    assert report["transport"] == transport
    assert report["trust_model"] == trust
    kinds = {p: t["transport"] for p, t in report["transports"].items()}
    assert kinds == {p: "fabric" if p in members else "grpc" for p in IDS}
