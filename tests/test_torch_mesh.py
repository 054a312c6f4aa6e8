"""The port's device meshes (``parallel/spmd.py``'s ``make_mesh``,
``rep_sharding`` and ``constrain``; ``LocalMooseRuntime(mesh=)`` and the
stacked layout's ``StackedDialect(mesh=)``) held against the JAX
package's on the CPU.

The port lays a mesh out over device handles: 12 virtual CPU devices
(``devices.set_cpu_device_count(12)``, as ``tests/conftest.py`` gives
the JAX package 12 XLA CPU devices), all over the one CPU.  Its mesh
shapes and partition specs are the JAX package's; a sharing constrained
to it stays where it is, so every result is word for word the mesh-less
one.  Under ``MOOSE_TPU_FIXED_KEYS`` and threefry the stacked runtime on
``make_mesh(6)`` and ``make_mesh(12)`` gives the JAX package's words on
``make_mesh(6)`` for a secure dot whose shared operand the mesh
constrains (x @ w at 16 x 4, fixed(14,23)); the JAX package's constraint
moves no word either, so one JAX run serves both meshes.
tests/test_stacked_backend.py:275's graph (a secure sigmoid of that
product) runs on both meshes word for word as without a mesh.  A
protocol sigmoid on these meshes is held against the JAX package's
words in tests/test_torch_logreg.py, on the logistic-regression graph
whose JAX run that file already makes (a JAX run of this graph takes
about 30 s of eager dispatch on the CPU, with or without a mesh).  A
mesh over several torch devices is refused (ROADMAP queue 1, item
12.9)."""

import numpy as np
import pytest
import torch

import moose_tpu as jm
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch import devices
from moose_tpu_torch.errors import ConfigurationError
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from torch_parity import fixed_keys_env, prf

IDS = ["alice", "bob", "carole"]
MK = np.array([1, 2, 3, 4], np.uint32)
I, F, W = 14, 23, 128


@pytest.fixture(autouse=True, scope="module")
def twelve_cpu_devices():
    """12 virtual CPU devices for the port, as the conftest gives JAX."""
    prev = devices.cpu_device_count()
    devices.set_cpu_device_count(12)
    yield
    devices.set_cpu_device_count(prev)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12])
def test_make_mesh_shapes(n):
    mesh = tspmd.make_mesh(n, device="cpu")
    want = jspmd.make_mesh(n)
    assert mesh.axis_names == want.axis_names == ("parties", "data")
    assert mesh.devices.shape == want.devices.shape
    # the same devices, in the same places
    assert [d.id for d in mesh.devices.flat] == \
        [d.id for d in want.devices.flat]
    assert mesh.torch_device == torch.device("cpu")
    with mesh:
        assert mesh.shape == dict(zip(want.axis_names,
                                      want.devices.shape))


@pytest.mark.parametrize("batch_axis,ndim", [(0, 2), (1, 2), (None, 2),
                                             (0, 1), (2, 3)])
def test_rep_sharding_spec(batch_axis, ndim):
    mesh, want = tspmd.make_mesh(8, device="cpu"), jspmd.make_mesh(8)
    spec = tspmd.rep_sharding(mesh, batch_axis=batch_axis, ndim=ndim)
    assert spec == tuple(jspmd.rep_sharding(want, batch_axis, ndim).spec)
    assert spec[0] == "parties"


def _logreg_comp(pm, fx_dtype, sigmoid=True):
    """tests/test_stacked_backend.py's graph, in eDSL module ``pm``
    (without its sigmoid: the secure dot alone)."""
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.float64),
             w: pm.Argument(placement=bob, dtype=pm.float64)):
        with alice:
            x_f = pm.cast(x, dtype=fx_dtype)
        with bob:
            w_f = pm.cast(w, dtype=fx_dtype)
        with rep:
            y = pm.dot(x_f, w_f)
            if sigmoid:
                y = pm.sigmoid(y)
        with carole:
            y_host = pm.cast(y, dtype=pm.float64)
        return y_host

    return comp


def _args():
    rng = np.random.default_rng(7)
    return {"x": rng.normal(size=(16, 4)) * 0.5,
            "w": rng.normal(size=(4, 1)) * 0.5}


@pytest.fixture(scope="module")
def jax_on_mesh():
    """The JAX stacked runtime's secure dot on make_mesh(6), under fixed
    keys."""
    runtime = JaxRuntime(IDS, layout="stacked", mesh=jspmd.make_mesh(6),
                         use_jit=False)
    with prf("threefry"), fixed_keys_env():
        (got,) = runtime.evaluate_computation(
            _logreg_comp(jm, jm.fixed(I, F), sigmoid=False),
            arguments=_args()).values()
    return np.asarray(got)


def _port_run(mesh, sigmoid):
    runtime = PortRuntime(IDS, layout="stacked", mesh=mesh, device="cpu")
    with prf("threefry"), fixed_keys_env():
        (got,) = runtime.evaluate_computation(
            _logreg_comp(tm, tm.fixed(I, F), sigmoid),
            arguments=_args()).values()
    assert runtime.last_plan["layout"] == "stacked"
    assert runtime._stacked.dialect.mesh is mesh
    return got


@pytest.mark.parametrize("n", [6, 12])
def test_stacked_runtime_on_party_mesh_equals_jax(jax_on_mesh, n):
    got = _port_run(tspmd.make_mesh(n, device="cpu"), sigmoid=False)
    assert np.array_equal(got, jax_on_mesh)
    args = _args()
    np.testing.assert_allclose(got, args["x"] @ args["w"], atol=1e-5)


@pytest.mark.parametrize("n", [6, 12])
def test_stacked_backend_graph_on_party_mesh(n):
    """tests/test_stacked_backend.py:275: the secure sigmoid on a
    (3, n // 3) mesh, word for word as without a mesh and within the
    reference test's 1e-3."""
    got = _port_run(tspmd.make_mesh(n, device="cpu"), sigmoid=True)
    assert np.array_equal(got, _port_run(None, sigmoid=True))
    args = _args()
    sigmoid = 1.0 / (1.0 + np.exp(-(args["x"] @ args["w"])))
    np.testing.assert_allclose(got, sigmoid, atol=1e-3)


def _share(sess, x):
    return tspmd.fx_encode_share(sess, torch.as_tensor(x), I, F, W)


def test_stacked_softmax_on_party_mesh():
    """tests/test_spmd.py:627: the protocol softmax on a constrained
    sharing over the (3, 2) mesh, word for word the mesh-less softmax
    (held against the JAX package's in tests/test_torch_softmax.py) and
    within test_spmd.py's 2e-3 of float64."""
    mesh = tspmd.make_mesh(6, device="cpu")
    xv = np.random.default_rng(17).normal(size=(4, 5)) * 2

    def run(mesh):
        s = tspmd.SpmdSession(MK, "cpu")
        xf = _share(s, xv)
        if mesh is not None:
            xf = tspmd.SpmdFixed(tspmd.constrain(xf.tensor, mesh, 0), I, F)
        return tsm.fx_softmax(s, xf, 1)

    with prf("threefry"), mesh:
        got, plain = run(mesh), run(None)
    assert torch.equal(got.tensor.lo, plain.tensor.lo)
    assert torch.equal(got.tensor.hi, plain.tensor.hi)
    want = np.exp(xv - xv.max(1, keepdims=True))
    want = want / want.sum(1, keepdims=True)
    np.testing.assert_allclose(tspmd.fx_reveal_decode(got).numpy(), want,
                               atol=2e-3)


def test_a_mesh_over_several_torch_devices_is_item_12_9():
    cards = tspmd.make_mesh(devices=[devices.Device(i, f"cuda:{i}")
                                     for i in range(6)])
    assert cards.shape == {"parties": 3, "data": 2}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, "
                                                  "item 12.9"):
        cards.torch_device
    s = tspmd.SpmdSession(MK, "cpu")
    x = _share(s, np.zeros((4, 2)))
    with pytest.raises(NotImplementedError, match="item 12.9"):
        tspmd.constrain(x.tensor, cards, 0)
    # a sharing never moves to a mesh on another device
    meta = tspmd.make_mesh(devices=[devices.Device(0, "meta")])
    with pytest.raises(ConfigurationError, match="constrained to a mesh"):
        tspmd.constrain(x.tensor, meta, 0)
    # and the one card's (1, 1) mesh is the default where there is one
    if not torch.cuda.is_available():
        with pytest.raises(ConfigurationError, match="device='cpu'"):
            tspmd.make_mesh()
