"""Use case: the 3-party protocol laid out over a device mesh.

The port's program of ``tutorials/multichip_spmd.py``: instead of three
worker processes exchanging shares over gRPC, one controller runs all
three parties as the ``parties`` axis of a mesh, with the batch axis
data-parallel over the rest.  The protocol math is identical; the
network is the mesh.

What this demonstrates, end to end:

1. party-stacked sharings (``spmd.SpmdRep``: one tensor, leading axes
   ``(party=3, slot=2)``) and the fixed-point layer on top;
2. building a ``(parties, data)`` mesh and constraining shares to it:
   six device handles (``devices.virtual_devices``) over the one card, or
   over the CPU with ``--device cpu``;
3. a secure logistic-regression training step AND a secure softmax
   (bit-decomposition comparisons, Goldschmidt division: the nonlinear
   protocol library of ``parallel/spmd_math.py``) over the mesh, each
   held to the same step on plaintext floats.

The JAX script's fourth section counts the collectives in the compiled
HLO.  The port's plans are CUDA graphs, not XLA programs, and the steps
here run the protocol layer directly, so that check waits for a mesh
over several cards (ROADMAP queue 1, item 12.9).

    python -m moose_tpu_torch.tutorials.multichip_spmd
"""

import argparse

import numpy as np
import torch

from moose_tpu_torch import devices
from moose_tpu_torch.examples import parse_args
from moose_tpu_torch.parallel import spmd
from moose_tpu_torch.parallel import spmd_math as sm

N_DEVICES = 6
I, F, W = 14, 23, 128
MASTER_KEY = b"tutorial-masterk"
STEP_LIMIT = 1e-3
SOFTMAX_LIMIT = 5e-2


def data(mesh):
    """The batch (8 rows a data shard), labels from a generating model,
    zero initial weights and the pinned master key."""
    rng = np.random.default_rng(0)
    batch = 8 * mesh.devices.shape[1]
    x = rng.normal(size=(batch, 16)) * 0.4
    true_w = rng.normal(size=(16, 1))
    y = (x @ true_w > 0).astype(np.float64)
    w0 = np.zeros((16, 1))
    mk = np.frombuffer(MASTER_KEY, dtype=np.uint32)
    return x, y, w0, true_w, mk


def train_and_infer(master_key, x, y, w0, mesh, device):
    """One secure SGD step, then the two-column softmax of the new
    logits: the new weights' and the probabilities' sharings."""
    sess = spmd.SpmdSession(master_key, device)

    def share(v):
        return spmd.fx_encode_share(
            sess, torch.as_tensor(v, device=device), I, F, W)

    xs, ys, ws = share(x), share(y), share(w0)
    # shares are CONSTRAINED onto the mesh: party axis -> 'parties',
    # batch axis -> 'data' (spmd.rep_sharding builds the spec)
    w1 = spmd.logreg_train_step(sess, xs, ys, ws, lr=0.5, mesh=mesh)
    logits = spmd.fx_dot(sess, xs, w1)
    two_col = sm.fx_softmax(
        sess,
        spmd.SpmdFixed(
            spmd.concat([logits.tensor, spmd.neg(logits.tensor)], 1),
            I, F,
        ),
        axis=1,
    )
    return w1, two_col


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    args = parse_args(parser, argv)

    # ---- 1. a (parties=3, data=2) mesh over 6 device handles ----------
    mesh = spmd.make_mesh(
        devices=devices.virtual_devices(args.device, N_DEVICES))
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    x, y, w0, true_w, mk = data(mesh)
    batch = x.shape[0]

    # ---- 2+3. secure training step + softmax over the mesh ------------
    with mesh:
        w1, probs = (
            spmd.fx_reveal_decode(v).cpu().numpy()
            for v in train_and_infer(mk, x, y, w0, mesh, args.device))

    # the revealed results match the same step on plaintext floats
    z = x @ w0
    preds = 0.5 + 0.19828547 * z - 0.00446928 * z**3  # protocol sigmoid
    w_plain = w0 - 0.5 * x.T @ (preds - y) / batch
    if not np.abs(w1 - w_plain).max() < STEP_LIMIT:
        raise AssertionError("training step diverged")
    corr = np.corrcoef(w1.ravel(), true_w.ravel())[0, 1]
    print(f"one secure SGD step: max |Δw vs plaintext| = "
          f"{np.abs(w1 - w_plain).max():.2e}, corr(w, w_true) = {corr:.2f}")

    logits1 = x @ w1
    two = np.concatenate([logits1, -logits1], 1)
    e = np.exp(two - two.max(axis=1, keepdims=True))
    want = e / e.sum(axis=1, keepdims=True)
    print(f"secure softmax: max err vs plaintext = "
          f"{np.abs(probs - want).max():.2e}")
    if not np.abs(probs - want).max() < SOFTMAX_LIMIT:
        raise AssertionError("softmax diverged")

    # ---- 4. the collective mix ----------------------------------------
    print("collective mix: not counted; the port's plans are CUDA graphs, "
          "not XLA programs, and this check waits for a mesh over several "
          "cards (ROADMAP queue 1, item 12.9)")
    print("multichip SPMD tutorial OK")
    return w1, probs


if __name__ == "__main__":
    main()
