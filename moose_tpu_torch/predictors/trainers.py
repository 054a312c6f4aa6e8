"""SGD-step training graphs: logistic regression and a one-hidden-layer
MLP.

The port of ``moose_tpu/predictors/trainers.py``.  Gradient descent runs
under MPC with the operator vocabulary of the inference predictors: the
forward pass, the backward pass and the weight update are replicated
fixed-point ops (``dot``, ``sigmoid``, ``transpose``, ``mul``, ``sub``
and a mirrored public scale), so a step runs through
``LocalMooseRuntime`` on the stacked layout, on the card.

Data placement: ``alice`` owns the feature matrix and supplies the
weights of a step in the clear, ``bob`` owns the labels and receives the
updated weights.  The state is plain float arrays (``{"w": (features,
1)}`` or ``{"w1", "w2"}``), passed as arguments and returned as float64
numpy.

Not ported yet: the build-time range and keystream lint (``_range_lint``
needs ``compilation/analysis``, ROADMAP queue 1, item 13), so the step
graph is traced without it; and the checkpointed epochs
(``init_computation``, ``epoch_computation``, ``export_computation``),
whose ``load_shares``/``save_shares`` need the per-host layout and the
checkpoint store (items 8 and 10).
"""

from __future__ import annotations

import inspect

import numpy as np

import moose_tpu_torch as pm

from ..edsl import tracer
from . import predictor, predictor_utils

_CHECKPOINTS = (
    "checkpointed epochs need load_shares/save_shares, which wait for the "
    "per-host layout and the checkpoint store (ROADMAP queue 1, items 8 "
    "and 10); run step_computation instead"
)


def _sigmoid(t):
    return 1.0 / (1.0 + np.exp(-t))


class SecureTrainer(predictor.Predictor):
    """Shared machinery of the SGD trainers: placement context and one
    memoized traced step graph per (dtype, rows), since runtimes cache on
    the Computation object.  The JAX package's ``checkpoint_key``,
    ``feature_range`` and ``weight_range`` serve its checkpoints and range
    lint, which the port does not run yet, and are not taken."""

    def __init__(self, learning_rate: float, fixedpoint_dtype,
                 steps_per_epoch: int):
        super().__init__()
        if steps_per_epoch < 1:
            raise ValueError("steps_per_epoch must be >= 1")
        self.learning_rate = float(learning_rate)
        self.fixedpoint_dtype = (
            fixedpoint_dtype
            if fixedpoint_dtype is not None
            else predictor_utils.DEFAULT_FIXED_DTYPE
        )
        self.steps_per_epoch = int(steps_per_epoch)

    @property
    def state_shapes(self) -> dict:
        """{state tensor name: shape}."""
        raise NotImplementedError

    # -- graph helpers ---------------------------------------------------

    def _scale(self, value, factor: float):
        """Multiply a replicated value by a public scalar (mirrored
        fixed-point constant)."""
        c = self.fixedpoint_constant(
            np.array(factor), plc=self.mirrored,
            dtype=self.fixedpoint_dtype,
        )
        return pm.mul(value, c)

    def _batches(self, n_rows: int):
        """(start, stop) bounds of each minibatch step."""
        if n_rows % self.steps_per_epoch != 0:
            raise ValueError(
                f"{n_rows} rows do not split into {self.steps_per_epoch} "
                "equal minibatch steps"
            )
        b = n_rows // self.steps_per_epoch
        return [(s * b, (s + 1) * b) for s in range(self.steps_per_epoch)]

    # -- computations ----------------------------------------------------

    def init_computation(self):
        raise NotImplementedError(_CHECKPOINTS)

    def epoch_computation(self, n_rows: int):
        raise NotImplementedError(_CHECKPOINTS)

    def export_computation(self):
        raise NotImplementedError(_CHECKPOINTS)

    def step_computation(self, n_rows: int):
        """One SGD step as a traced Computation: plaintext weights in
        (model owner alice), one replicated gradient step on ``n_rows``
        rows, the updated weights revealed to bob as ``output_{i}`` in
        sorted state-name order."""

        def build():
            names = sorted(self.state_shapes)

            def body(x, y, *weights):
                fx = self.fixedpoint_dtype
                with self.alice:
                    xb = pm.cast(x, dtype=fx)
                    state = {
                        name: pm.cast(w, dtype=fx)
                        for name, w in zip(names, weights)
                    }
                with self.bob:
                    yb = pm.cast(y, dtype=fx)
                with self.replicated:
                    state = self.sgd_step(state, xb, yb, n_rows)
                outs = []
                with self.bob:
                    for name in names:
                        outs.append(
                            pm.cast(state[name], dtype=pm.float64)
                        )
                return tuple(outs)

            body.__name__ = "step"
            params = [
                inspect.Parameter(
                    name, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    annotation=pm.Argument(owner, dtype=pm.float64),
                )
                for name, owner in (
                    [("x", self.alice), ("y", self.bob)]
                    + [(name, self.alice) for name in names]
                )
            ]
            body.__signature__ = inspect.Signature(params)
            return tracer.trace(pm.computation(body))

        return self._memoized(
            ("step", self.fixedpoint_dtype, n_rows), build
        )

    # -- per-model hooks -------------------------------------------------

    def sgd_step(self, state: dict, xb, yb, batch_rows: int) -> dict:
        raise NotImplementedError

    def reference_epoch(self, state: dict, x: np.ndarray,
                        y: np.ndarray) -> dict:
        """Float64 numpy mirror of ``steps_per_epoch`` SGD steps with the
        true sigmoid (the MPC graphs use the protocol approximation, so
        comparisons are tolerance-based)."""
        raise NotImplementedError


class LogregSGDTrainer(SecureTrainer):
    """Logistic regression by minibatch SGD:
    ``w -= lr/b * X^T (sigmoid(Xw) - y)``."""

    def __init__(self, n_features: int, learning_rate: float = 0.1,
                 fixedpoint_dtype=None, steps_per_epoch: int = 1):
        super().__init__(learning_rate, fixedpoint_dtype, steps_per_epoch)
        self.n_features = int(n_features)

    @property
    def state_shapes(self) -> dict:
        return {"w": (self.n_features, 1)}

    def sgd_step(self, state, xb, yb, batch_rows):
        w = state["w"]
        err = pm.sub(pm.sigmoid(pm.dot(xb, w)), yb)
        grad = pm.dot(pm.transpose(xb), err)
        return {
            "w": pm.sub(
                w, self._scale(grad, self.learning_rate / batch_rows)
            )
        }

    def reference_epoch(self, state, x, y):
        w = np.asarray(state["w"], dtype=np.float64)
        for a, b in self._batches(x.shape[0]):
            xb, yb = x[a:b], y[a:b]
            err = _sigmoid(xb @ w) - yb
            w = w - self.learning_rate / xb.shape[0] * (xb.T @ err)
        return {"w": w}


class MLPSGDTrainer(SecureTrainer):
    """One-hidden-layer MLP (sigmoid activations, logistic loss); the
    backward pass needs only mul, dot, sub and transpose."""

    def __init__(self, n_features: int, hidden: int,
                 learning_rate: float = 0.1, fixedpoint_dtype=None,
                 steps_per_epoch: int = 1):
        super().__init__(learning_rate, fixedpoint_dtype, steps_per_epoch)
        self.n_features = int(n_features)
        self.hidden = int(hidden)

    @property
    def state_shapes(self) -> dict:
        return {
            "w1": (self.n_features, self.hidden),
            "w2": (self.hidden, 1),
        }

    def sgd_step(self, state, xb, yb, batch_rows):
        w1, w2 = state["w1"], state["w2"]
        h = pm.sigmoid(pm.dot(xb, w1))
        yhat = pm.sigmoid(pm.dot(h, w2))
        # logistic loss + sigmoid output: d2 = yhat - y
        d2 = pm.sub(yhat, yb)
        g2 = pm.dot(pm.transpose(h), d2)
        # dh = (d2 @ w2^T) * h * (1 - h); h - h*h avoids a broadcasted
        # public subtraction
        dh = pm.mul(
            pm.dot(d2, pm.transpose(w2)), pm.sub(h, pm.mul(h, h))
        )
        g1 = pm.dot(pm.transpose(xb), dh)
        lr = self.learning_rate / batch_rows
        return {
            "w1": pm.sub(w1, self._scale(g1, lr)),
            "w2": pm.sub(w2, self._scale(g2, lr)),
        }

    def reference_epoch(self, state, x, y):
        w1 = np.asarray(state["w1"], dtype=np.float64)
        w2 = np.asarray(state["w2"], dtype=np.float64)
        for a, b in self._batches(x.shape[0]):
            xb, yb = x[a:b], y[a:b]
            h = _sigmoid(xb @ w1)
            yhat = _sigmoid(h @ w2)
            d2 = yhat - yb
            g2 = h.T @ d2
            dh = (d2 @ w2.T) * (h - h * h)
            g1 = xb.T @ dh
            lr = self.learning_rate / xb.shape[0]
            w1 = w1 - lr * g1
            w2 = w2 - lr * g2
        return {"w1": w1, "w2": w2}
