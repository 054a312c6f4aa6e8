"""SGD training graphs: logistic regression and a one-hidden-layer MLP.

The port of ``moose_tpu/predictors/trainers.py``.  Gradient descent runs
under MPC with the operator vocabulary of the inference predictors: the
forward pass, the backward pass and the weight update are replicated
fixed-point ops (``dot``, ``sigmoid``, ``transpose``, ``mul``, ``sub``
and a mirrored public scale).

Model state crosses epochs only as secret-shared checkpoints: each epoch
graph opens with ``load_shares`` and closes with ``save_shares``, so
each party touches exactly its own share pair and the weights never
exist in the clear anywhere, the training driver included
(``moose_tpu_torch.training``).  These graphs run on the per-host
layout, on its walk or lowered; the standalone step graph
(:meth:`SecureTrainer.step_computation`) has no checkpoint boundary and
runs on the stacked layout.

Data placement: ``alice`` owns the feature matrix (and supplies the
initial weights once), ``bob`` owns the labels and receives the revealed
model at export.

Every traced graph is the JAX package's, byte for byte through
``serde``.  Not ported yet: the build-time range and keystream lint
(:meth:`SecureTrainer._range_lint` needs ``compilation/analysis``,
ROADMAP queue 1, item 13), which only reads a graph, so the graphs are
traced without it.
"""

from __future__ import annotations

import inspect

import numpy as np

import moose_tpu_torch as pm

from ..compilation.lowering import share_key
from ..edsl import tracer
from . import predictor, predictor_utils

_LINT = "ROADMAP queue 1, item 13"


def _sigmoid(t):
    return 1.0 / (1.0 + np.exp(-t))


class SecureTrainer(predictor.Predictor):
    """Shared machinery of the SGD trainers: placement context, memoized
    traced computations (one trace per graph per trainer instance: the
    runtimes' plan caches key on the Computation object, so epochs must
    reuse it) and the checkpoint key layout."""

    def __init__(self, checkpoint_key: str, learning_rate: float,
                 fixedpoint_dtype, steps_per_epoch: int,
                 feature_range=(-1.0, 1.0), weight_range=(-1.0, 1.0)):
        super().__init__()
        if steps_per_epoch < 1:
            raise ValueError("steps_per_epoch must be >= 1")
        self.checkpoint_key = checkpoint_key
        self.learning_rate = float(learning_rate)
        self.fixedpoint_dtype = (
            fixedpoint_dtype
            if fixedpoint_dtype is not None
            else predictor_utils.DEFAULT_FIXED_DTYPE
        )
        self.steps_per_epoch = int(steps_per_epoch)
        # declared real-space bounds the data and model owners assert for
        # features and weights (labels are structurally in [0, 1]): the
        # range analysis's seeds (range_specs)
        self.feature_range = (
            float(feature_range[0]), float(feature_range[1])
        )
        self.weight_range = (
            float(weight_range[0]), float(weight_range[1])
        )

    # -- checkpoint layout ----------------------------------------------

    @property
    def state_shapes(self) -> dict:
        """{state tensor name: shape}, one ``save_shares`` key per entry,
        at :meth:`state_key`."""
        raise NotImplementedError

    def state_key(self, name: str) -> str:
        return f"{self.checkpoint_key}/{name}"

    def expected_staged(self) -> list:
        """The exact storage keys one epoch must stage on every party:
        the torn-commit screen the checkpoint store enforces."""
        return sorted(
            share_key(self.state_key(name), slot)
            for name in self.state_shapes
            for slot in (0, 1)
        )

    # -- graph helpers ---------------------------------------------------

    def _scale(self, value, factor: float):
        """Multiply a replicated value by a public scalar (mirrored
        fixed-point constant)."""
        c = self.fixedpoint_constant(
            np.array(factor), plc=self.mirrored,
            dtype=self.fixedpoint_dtype,
        )
        return pm.mul(value, c)

    def _load_state(self):
        return {
            name: pm.load_shares(
                self.state_key(name), shape=shape,
                dtype=self.fixedpoint_dtype,
            )
            for name, shape in self.state_shapes.items()
        }

    def _save_state(self, state: dict):
        return [
            pm.save_shares(self.state_key(name), state[name])
            for name in sorted(self.state_shapes)
        ]

    def range_specs(self, n_rows: int = None) -> tuple:
        """``(arg_specs, arg_ranges)`` declaring what the trainer knows
        about its graphs: input shapes (``x``/``y`` when ``n_rows`` is
        known, the state tensors always) and real-space bounds
        (features and weights from the declared ranges, labels in
        [0, 1]), keyed by Input arg name for the init and step graphs and
        by checkpoint storage key for the LoadShares ops of the epoch and
        export graphs."""
        arg_specs = {
            name: shape for name, shape in self.state_shapes.items()
        }
        if n_rows is not None:
            arg_specs["x"] = (int(n_rows), self.n_features)
            arg_specs["y"] = (int(n_rows), 1)
        arg_ranges = {
            "x": self.feature_range,
            "y": (0.0, 1.0),
        }
        for name in self.state_shapes:
            arg_ranges[name] = self.weight_range
            arg_ranges[self.state_key(name)] = self.weight_range
        return arg_specs, arg_ranges

    def _range_lint(self, comp, n_rows: int = None):
        """The JAX package's build-time range and keystream gate over a
        traced trainer graph (``compilation.analysis.lint_check`` with
        :meth:`range_specs`).  It only reads the graph; the port's graphs
        are traced without it."""
        raise NotImplementedError(
            "the trainers' range and keystream lint needs "
            f"compilation/analysis: {_LINT}"
        )

    def _batches(self, n_rows: int):
        """(start, stop) bounds of each in-graph minibatch step."""
        if n_rows % self.steps_per_epoch != 0:
            raise ValueError(
                f"{n_rows} rows do not split into {self.steps_per_epoch} "
                "equal minibatch steps"
            )
        b = n_rows // self.steps_per_epoch
        return [(s * b, (s + 1) * b) for s in range(self.steps_per_epoch)]

    # -- the computations every trainer exposes --------------------------

    def init_computation(self):
        """Bootstrap: the model owner (alice) supplies the initial
        weights in the clear once; they are shared and persisted as the
        epoch-0 checkpoint.  Traced and memoized per instance."""

        def build():
            names = sorted(self.state_shapes)

            def body(*tensors):
                fixed = []
                with self.alice:
                    for t in tensors:
                        fixed.append(
                            pm.cast(t, dtype=self.fixedpoint_dtype)
                        )
                with self.replicated:
                    units = self._save_state(dict(zip(names, fixed)))
                return tuple(units)

            body.__name__ = "init"
            body.__signature__ = inspect.Signature([
                inspect.Parameter(
                    name, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    annotation=pm.Argument(self.alice, dtype=pm.float64),
                )
                for name in names
            ])
            return tracer.trace(pm.computation(body))

        return self._memoized(("init", self.fixedpoint_dtype), build)

    def epoch_computation(self, n_rows: int):
        """One epoch: load shares -> ``steps_per_epoch`` SGD minibatch
        steps -> save shares.  No plaintext output: the client learns
        only that the epoch ran."""

        def build():
            def body(x, y):
                fx = self.fixedpoint_dtype
                with self.alice:
                    xs = [
                        pm.cast(x[a:b], dtype=fx)
                        for a, b in self._batches(n_rows)
                    ]
                with self.bob:
                    ys = [
                        pm.cast(y[a:b], dtype=fx)
                        for a, b in self._batches(n_rows)
                    ]
                with self.replicated:
                    state = self._load_state()
                    for xb, yb in zip(xs, ys):
                        state = self.sgd_step(
                            state, xb, yb,
                            n_rows // self.steps_per_epoch,
                        )
                    units = self._save_state(state)
                return tuple(units)

            body.__name__ = "epoch"
            body.__signature__ = inspect.Signature([
                inspect.Parameter(
                    "x", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    annotation=pm.Argument(self.alice, dtype=pm.float64),
                ),
                inspect.Parameter(
                    "y", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    annotation=pm.Argument(self.bob, dtype=pm.float64),
                ),
            ])
            return tracer.trace(pm.computation(body))

        return self._memoized(
            ("epoch", self.fixedpoint_dtype, n_rows), build
        )

    def step_computation(self, n_rows: int):
        """One SGD step as a traced Computation: plaintext weights in
        (model owner alice), one replicated gradient step on ``n_rows``
        rows, the updated weights revealed to bob as ``output_{i}`` in
        sorted state-name order.  No checkpoint boundary, so it runs on
        the stacked layout."""

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

    def export_computation(self):
        """Reveal the trained state to bob (the model receiver) as
        plaintext floats."""

        def build():
            def body():
                with self.replicated:
                    state = self._load_state()
                outs = []
                with self.bob:
                    for name in sorted(self.state_shapes):
                        outs.append(
                            pm.cast(state[name], dtype=pm.float64)
                        )
                return tuple(outs)

            body.__name__ = "export"
            body.__signature__ = inspect.Signature([])
            return tracer.trace(pm.computation(body))

        return self._memoized(("export", self.fixedpoint_dtype), build)

    def unpack_export(self, outputs: dict) -> dict:
        """Map an export session's ordered outputs back to state
        names."""
        names = sorted(self.state_shapes)
        return {
            name: np.asarray(outputs[f"output_{i}"])
            for i, name in enumerate(names)
        }

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
                 checkpoint_key: str = "ckpt/logreg",
                 fixedpoint_dtype=None, steps_per_epoch: int = 1,
                 feature_range=(-1.0, 1.0), weight_range=(-1.0, 1.0)):
        super().__init__(
            checkpoint_key, learning_rate, fixedpoint_dtype,
            steps_per_epoch, feature_range=feature_range,
            weight_range=weight_range,
        )
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
                 learning_rate: float = 0.1,
                 checkpoint_key: str = "ckpt/mlp",
                 fixedpoint_dtype=None, steps_per_epoch: int = 1,
                 feature_range=(-1.0, 1.0), weight_range=(-1.0, 1.0)):
        super().__init__(
            checkpoint_key, learning_rate, fixedpoint_dtype,
            steps_per_epoch, feature_range=feature_range,
            weight_range=weight_range,
        )
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
