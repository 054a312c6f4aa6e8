"""Word parity of two of the port's programs with the JAX package on the
CPU, under the ``threefry`` stream (and fixed keys for the runtime):

- ``multichip_spmd``'s ``train_and_infer`` (one secure SGD step and the
  two-column softmax) on the port's (3, 2) mesh of six CPU handles
  against the same protocol functions of ``moose_tpu.parallel`` without
  a mesh, from the tutorial's master key and data: the revealed words of
  the new weights and of the probabilities are equal (a mesh moves no
  word in either package: ``tests/test_torch_mesh.py``);
- ``logistic_regression``'s ``predict`` through both packages'
  ``LocalMooseRuntime(use_jit=False)`` under ``MOOSE_TPU_FIXED_KEYS``:
  equal scores, within 5e-3 of the exact sigmoid.  Its queries are 16
  rows against two weight columns, the softmax's (16, 2), so the JAX
  run reuses most of the softmax's eager compiles (about 20 s of JAX
  dispatch here instead of 30).

A file of its own: the JAX package's eager runs take about 50 s here,
``tests/test_torch_examples.py`` the rest of the programs' checks."""

import numpy as np
import pytest

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

from moose_tpu_torch import devices
from moose_tpu_torch.examples import logistic_regression as tlr
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime
from moose_tpu_torch.tutorials import multichip_spmd as tmc

from test_torch_examples import jax_script
from torch_parity import assert_words_equal, fixed_keys_env, prf

IDS = ["alice", "bob", "carole"]
SCORE_TOL = 5e-3


def jax_train_and_infer(mk, x, y, w0):
    """The JAX tutorial's ``train_and_infer`` body without its mesh."""
    I, F, W = tmc.I, tmc.F, tmc.W
    sess = jspmd.SpmdSession(mk)
    xs, ys, ws = (jspmd.fx_encode_share(sess, jnp.asarray(v), I, F, W)
                  for v in (x, y, w0))
    w1 = jspmd.logreg_train_step(sess, xs, ys, ws, lr=0.5)
    logits = jspmd.fx_dot(sess, xs, w1)
    two_col = jsm.fx_softmax(
        sess,
        jspmd.SpmdFixed(
            jspmd.concat([logits.tensor, jspmd.neg(logits.tensor)], 1),
            I, F,
        ),
        axis=1,
    )
    return w1, two_col


@pytest.fixture(scope="module")
def spmd_words():
    """(JAX, port) revealed words of the step's weights and the softmax."""
    mesh = tspmd.make_mesh(
        devices=devices.virtual_devices("cpu", tmc.N_DEVICES))
    x, y, w0, _, mk = tmc.data(mesh)
    with prf("threefry"):
        want = [jspmd.reveal(v.tensor) for v in jax_train_and_infer(
            mk, x, y, w0)]
        with mesh:
            got = [tspmd.reveal(v.tensor) for v in tmc.train_and_infer(
                mk, x, y, w0, mesh, "cpu")]
    return dict(zip(("weights", "softmax"), zip(want, got)))


@pytest.mark.parametrize("which", ["weights", "softmax"])
def test_multichip_step_and_softmax_equal_the_jax_package(spmd_words,
                                                          which):
    want, got = spmd_words[which]
    assert_words_equal(got, want, which)


def test_logistic_regression_predict_equals_the_jax_package(spmd_words):
    """Run after ``spmd_words``, whose JAX compiles it reuses."""
    rng = np.random.default_rng(22)
    args = {"x": rng.normal(size=(16, tlr.N_FEATURES)),
            "w": rng.normal(size=(tlr.N_FEATURES, 2))}
    with prf("threefry"), fixed_keys_env():
        (want,) = JaxRuntime(IDS, use_jit=False).evaluate_computation(
            jax_script("examples.logistic_regression").predict,
            args).values()
        (got,) = PortRuntime(IDS, use_jit=False, device="cpu")\
            .evaluate_computation(tlr.predict, args).values()
    assert got.shape == (16, 2)
    assert np.array_equal(got, np.asarray(want))
    plain = 1 / (1 + np.exp(-(args["x"] @ args["w"])))
    assert np.abs(got - plain).max() < SCORE_TOL
