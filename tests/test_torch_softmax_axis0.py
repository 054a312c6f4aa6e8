"""The port's tournaments against moose_tpu on the CPU along axis 0 of
size 3, and ``fx_maximum`` of several tensors: ``tests/
test_torch_softmax.py``'s cases (``fx_max``, ``fx_argmax`` and
``fx_softmax``, also over a window, at ring128 fixed(24,40) and ring64
fixed(8,17) under both threefry streams, every share word for word).
The JAX package's eager kernels compile anew for these shapes, so they
run in a file of their own, on another test worker."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm

from test_torch_softmax import (
    MK,
    PRECISIONS,
    STREAMS,
    _rep_equal,
    check_tournaments,
)
from torch_parity import prf


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
@pytest.mark.parametrize("n,axis", ((3, 0),))
def test_tournaments_match(stream, width, integ, frac, n, axis):
    check_tournaments(stream, width, integ, frac, n, axis)


@pytest.mark.parametrize("width,integ,frac", PRECISIONS)
def test_maximum_of_several_tensors_matches(width, integ, frac):
    rng = np.random.default_rng(width)
    xs = [rng.permutation(12)[:6] * 0.5 - 1.0 for _ in range(3)]
    js, ts = jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")
    with prf("threefry"):
        jx = [jspmd.fx_encode_share(js, jnp.asarray(v), integ, frac, width)
              for v in xs]
        tx = [tspmd.fx_encode_share(ts, torch.as_tensor(v), integ, frac,
                                    width) for v in xs]
        want, got = jsm.fx_maximum(js, jx), tsm.fx_maximum(ts, tx)
    _rep_equal(got.tensor, want.tensor, "fx_maximum")
    assert np.array_equal(tspmd.fx_reveal_decode(got).numpy(),
                          np.max(xs, axis=0))
