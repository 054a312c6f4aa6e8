"""``parallel.spmd.logreg_train_step`` and ``fx_sigmoid_poly`` (the
reference's benchmark workload, ``benchmarks/logreg.py``'s ``run_spmd``)
against ``moose_tpu/parallel/spmd.py``, on the CPU.

Under ``threefry`` and one master key both packages draw the same masks,
so the weights' shares after each of 3 steps at 16 rows x 6 features are
equal word for word; the revealed trajectory is within
``benchmarks/logreg.py:145``'s 1e-3 of its float64 replica
(``chip_smoke.plaintext_sgd``), and ``chip_smoke.spmd_training`` (phase
20 (d)) reveals the same weights.  The JAX steps run eagerly (a few
seconds per shape, once per module)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd

from moose_tpu_torch import devices
from moose_tpu_torch.parallel import spmd as tspmd

from torch_parity import assert_words_equal, prf, threefry  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

ROWS, FEATURES, STEPS, LR = 16, 6, 3, 0.1
I, F, W = 24, 40, 128
MASTER = b"moose-tpu-logreg"


def _data():
    return chip_smoke.training_data(np.random.default_rng(5), ROWS * STEPS,
                                    FEATURES)


def _jax_steps(x, y):
    """The weights after each step, as run_spmd's scan body runs them."""
    mk = np.frombuffer(MASTER, dtype=np.uint32)
    sess = jspmd.SpmdSession(mk)
    w = jspmd.fx_encode_share(sess, jnp.zeros((FEATURES, 1)), I, F, W)
    out = []
    for i, k in enumerate(jspmd.derive_step_keys(mk, STEPS)):
        s = jspmd.SpmdSession(k)
        xs = jspmd.fx_encode_share(
            s, jnp.asarray(x[i * ROWS:(i + 1) * ROWS]), I, F, W)
        ys = jspmd.fx_encode_share(
            s, jnp.asarray(y[i * ROWS:(i + 1) * ROWS]), I, F, W)
        w = jspmd.logreg_train_step(s, xs, ys, w, LR)
        out.append(w)
    return out


def _port_steps(x, y, mesh=None):
    mk = np.frombuffer(MASTER, dtype=np.uint32)
    sess = tspmd.SpmdSession(mk, "cpu")
    w = tspmd.fx_encode_share(
        sess, torch.zeros((FEATURES, 1), dtype=torch.float64), I, F, W)
    out = []
    keys = tspmd.derive_step_keys(mk, STEPS, device="cpu").tolist()
    for i, k in enumerate(keys):
        s = tspmd.SpmdSession(k, "cpu")
        xs = tspmd.fx_encode_share(
            s, torch.as_tensor(x[i * ROWS:(i + 1) * ROWS]), I, F, W)
        ys = tspmd.fx_encode_share(
            s, torch.as_tensor(y[i * ROWS:(i + 1) * ROWS]), I, F, W)
        w = tspmd.logreg_train_step(s, xs, ys, w, LR, mesh=mesh)
        out.append(w)
    return out


@pytest.fixture(scope="module")
def trajectories():
    x, y = _data()
    with prf("threefry"):
        return x, y, _jax_steps(x, y), _port_steps(x, y)


@pytest.mark.parametrize("step", range(STEPS))
def test_logreg_train_step_words_match_jax(trajectories, step):
    _, _, jax_ws, port_ws = trajectories
    got, want = port_ws[step], jax_ws[step]
    assert (got.integral_precision, got.fractional_precision) == (I, F)
    assert tuple(got.tensor.lo.shape) == (3, 2, FEATURES, 1)
    assert_words_equal((got.tensor.lo, got.tensor.hi),
                       (want.tensor.lo, want.tensor.hi), f"step {step}")


def test_logreg_train_step_tracks_the_float64_trajectory(trajectories):
    x, y, _, port_ws = trajectories
    got = tspmd.fx_reveal_decode(port_ws[-1]).numpy()
    want = chip_smoke.plaintext_sgd(x, y, ROWS, STEPS, LR)
    assert np.abs(got - want).max() < chip_smoke.SESSION_TOL
    # chip_smoke's phase 20 (d) runs the same steps
    with prf("threefry"):
        phase = chip_smoke.spmd_training(torch, tspmd, x, y, ROWS, LR, "cpu")
    assert np.array_equal(phase, got)


@pytest.mark.parametrize("width,integ,frac", ((128, 24, 40), (64, 14, 23)))
def test_fx_sigmoid_poly_words_match_jax(threefry, width, integ, frac):
    x = np.linspace(-4.0, 4.0, 9)
    mk = np.array([1, 2, 3, 4], np.uint32)
    js, ts = jspmd.SpmdSession(mk), tspmd.SpmdSession(mk, "cpu")
    want = jspmd.fx_sigmoid_poly(
        js, jspmd.fx_encode_share(js, jnp.asarray(x), integ, frac, width))
    got = tspmd.fx_sigmoid_poly(
        ts, tspmd.fx_encode_share(ts, torch.as_tensor(x), integ, frac,
                                  width))
    assert_words_equal((got.tensor.lo, got.tensor.hi),
                       (want.tensor.lo, want.tensor.hi))
    decoded = tspmd.fx_reveal_decode(got).numpy()
    # tests/test_spmd.py:75's limit against the true sigmoid
    assert np.abs(decoded - 1.0 / (1.0 + np.exp(-x))).max() < 0.08


def test_a_mesh_names_its_roadmap_item(trajectories):
    """On a mesh of handles over one device (the (3, 2) mesh of six, as
    tests/test_spmd.py:132 runs it) the steps are the JAX package's word
    for word; a mesh over several torch devices names item 12.9."""
    x, y, jax_ws, _ = trajectories
    mesh = tspmd.make_mesh(devices=devices.virtual_devices("cpu", 6))
    assert mesh.shape == {"parties": 3, "data": 2}
    with prf("threefry"), mesh:
        port_ws = _port_steps(x, y, mesh=mesh)
    for step, (got, want) in enumerate(zip(port_ws, jax_ws)):
        assert_words_equal((got.tensor.lo, got.tensor.hi),
                           (want.tensor.lo, want.tensor.hi), f"step {step}")
    mk = np.array([1, 2, 3, 4], np.uint32)
    sess = tspmd.SpmdSession(mk, "cpu")
    w = tspmd.fx_encode_share(
        sess, torch.zeros((2, 1), dtype=torch.float64), I, F, W)
    x = tspmd.fx_encode_share(
        sess, torch.zeros((4, 2), dtype=torch.float64), I, F, W)
    y = tspmd.fx_encode_share(
        sess, torch.zeros((4, 1), dtype=torch.float64), I, F, W)
    cards = tspmd.make_mesh(devices=[devices.Device(i, f"cuda:{i}")
                                     for i in range(6)])
    with pytest.raises(NotImplementedError, match="item 12.9"):
        tspmd.logreg_train_step(sess, x, y, w, LR, mesh=cards)
