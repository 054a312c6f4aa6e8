"""The convolution and the pools the port's stacked dialect gained, one
traced computation apiece, through the port's LocalMooseRuntime on the
CPU and the JAX LocalMooseRuntime (stacked layout, eager) under fixed
keys and the threefry PRF: the outputs are equal, and within 1e-4 of
float64.  ``tests/test_torch_stacked_kinds.py``'s cases on NHWC inputs,
whose shapes that file's kinds do not share, so they run in a file of
their own, on another test worker."""

import numpy as np
import pytest

import moose_tpu as jm
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime

import moose_tpu_torch as tm
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime

from test_torch_logreg import IDS, fixed_keys, threefry  # noqa: F401
from test_torch_stacked_kinds import CONV_KINDS, PRECISION


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
