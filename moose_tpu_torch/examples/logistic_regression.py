"""Encrypted logistic-regression: train on secret-shared data, then run
encrypted inference (the reference's flagship example,
pymoose/examples/logreg).  The port's program of
``examples/logistic_regression.py``: the same graphs, on the card unless
``--device cpu``.

  python -m moose_tpu_torch.examples.logistic_regression [--device cpu]
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the traced functions as objects
import argparse

import numpy as np

import moose_tpu_torch as pm
from moose_tpu_torch.examples import parse_args
from moose_tpu_torch.runtime import LocalMooseRuntime

alice = pm.host_placement("alice")
bob = pm.host_placement("bob")
carole = pm.host_placement("carole")
rep = pm.replicated_placement("rep", players=[alice, bob, carole])
mirr = pm.mirrored_placement("mirr", players=[alice, bob, carole])

FIXED = pm.fixed(24, 40)
N_FEATURES = 10
BATCH = 64
STEPS = 8
LR = 0.25


@pm.computation
def train(
    x: pm.Argument(placement=alice, dtype=pm.float64),
    y: pm.Argument(placement=alice, dtype=pm.float64),
):
    """alice holds the training data; the model is learned under MPC and
    revealed to bob."""
    with alice:
        xf = pm.cast(x, dtype=FIXED)
        yf = pm.cast(y, dtype=FIXED)

    with bob:
        w = pm.cast(
            pm.constant(np.zeros((N_FEATURES, 1)), dtype=pm.float64),
            dtype=FIXED,
        )
        lr = pm.cast(pm.constant(LR, dtype=pm.float64), dtype=FIXED)

    with mirr:
        inv_batch = pm.constant(1.0 / BATCH, dtype=FIXED)

    with rep:
        xs = pm.identity(xf)  # share once
        ys = pm.identity(yf)
        xT = pm.transpose(xs)
        for _ in range(STEPS):
            y_hat = pm.sigmoid(pm.dot(xs, w))
            grad = pm.mul(pm.dot(xT, y_hat - ys), inv_batch)
            w = w - grad * lr

    with bob:
        w_out = pm.cast(w, dtype=pm.float64)
    return w_out


@pm.computation
def predict(
    x: pm.Argument(placement=carole, dtype=pm.float64),
    w: pm.Argument(placement=bob, dtype=pm.float64),
):
    """carole's query is scored against bob's model without either party
    seeing the other's data."""
    with carole:
        xf = pm.cast(x, dtype=FIXED)
    with bob:
        wf = pm.cast(w, dtype=FIXED)
    with rep:
        score = pm.sigmoid(pm.dot(xf, wf))
    with carole:
        out = pm.cast(score, dtype=pm.float64)
    return out


def main(argv=None):
    """Train, score carole's query and print both gaps; returns the
    fitted and generating weights, the secure scores and the plaintext
    ones."""
    parser = argparse.ArgumentParser(description=__doc__)
    args = parse_args(parser, argv)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, N_FEATURES))
    true_w = rng.normal(size=(N_FEATURES, 1))
    y = (x @ true_w > 0).astype(np.float64)

    # the walk op by op, as the JAX script runs it (use_jit=False)
    runtime = LocalMooseRuntime(["alice", "bob", "carole"], use_jit=False,
                                device=args.device)
    (w_fit,) = runtime.evaluate_computation(
        train, arguments={"x": x, "y": y}
    ).values()
    corr = np.corrcoef(np.ravel(w_fit), np.ravel(true_w))[0, 1]
    print(f"weight correlation with generator: {corr:.3f}")

    x_test = rng.normal(size=(8, N_FEATURES))
    (scores,) = runtime.evaluate_computation(
        predict, arguments={"x": x_test, "w": np.asarray(w_fit)}
    ).values()
    plain = 1 / (1 + np.exp(-(x_test @ np.asarray(w_fit))))
    print("max |secure - plaintext| score gap:",
          float(np.abs(scores - plain).max()))
    return {"w": np.asarray(w_fit), "true_w": true_w,
            "scores": np.asarray(scores), "plain": plain}


if __name__ == "__main__":
    main()
