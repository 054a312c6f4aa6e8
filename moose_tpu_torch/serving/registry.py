"""Warm model registry: trace and warm once, serve forever.

The port's own copy of ``moose_tpu/serving/registry.py``.  A registered
model pays its per-plan cost once, at registration, per (model,
batch-bucket) pair:

- the predictor is traced ONCE (``Predictor.traced_predictor`` memoizes
  the traced Computation per (instance, fixed-point dtype), the same
  cache ``predictor_factory`` users hit outside the server);
- the graph is linted strictly at the door (and against declared
  ``arg_ranges`` at the largest bucket), through the port's analyzer;
- each batch bucket is warmed by evaluations on the port's runtime:
  its trace cache, its layout routing and, for a graph the runtime
  lowers, its compiled-graph cache are filled, and each lowered plan is
  linted before the model is committed.

Each bucket is warmed as the JAX package warms it: evaluations on
random rows until the bucket's plan leaves validation (at most
``max_warmup_evals``), so that a request replays a promoted plan (on
the card, CUDA graphs validated against the eager walk,
``moose_tpu_torch/runtime.py``).  The last evaluation records its
``bucket_latency`` for the bucket autotuner once the plan has settled,
and the bucket's ``warmup_report`` names its evaluations, the plan's
state and mode (``runtime.last_plan``), the layout that ran it and
whether it was lowered.
Bucket policy: powers of two up to ``max_batch`` (padding a ragged
batch to the next bucket replays a warm plan).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .. import devices, telemetry
from ..errors import ConfigurationError


def power_of_two_buckets(max_batch: int) -> Tuple[int, ...]:
    """(1, 2, 4, ..., max_batch) — a non-power-of-two max_batch rounds
    UP so a full ``max_batch``-row batch is always servable, at the cost
    of one extra-large warm plan and up to 2x padding on batches above
    the previous power of two.  Pass an explicit ``buckets=`` ladder to
    ``register_model`` to opt out."""
    if max_batch < 1:
        raise ConfigurationError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b <<= 1
    buckets.append(b)
    return tuple(buckets)


def bucket_for(rows: int, buckets: Tuple[int, ...]) -> int:
    """Smallest registered bucket holding ``rows`` rows."""
    for b in buckets:
        if rows <= b:
            return b
    raise ConfigurationError(
        f"batch of {rows} rows exceeds the largest bucket {buckets[-1]}"
    )


@dataclasses.dataclass
class RegisteredModel:
    """One warm model: the traced computation plus everything needed to
    evaluate a padded bucket without re-tracing."""

    name: str
    comp: object  # traced Computation (held strongly: keys weak caches)
    input_name: str
    row_shape: Tuple[int, ...]  # per-row trailing shape
    buckets: Tuple[int, ...]
    warmup_report: Dict[int, dict]  # bucket -> {evals, plan_state, ...}

    def pad(self, rows: np.ndarray) -> Tuple[np.ndarray, int]:
        """Zero-pad a (n, *row_shape) batch up to its bucket."""
        n = rows.shape[0]
        bucket = bucket_for(n, self.buckets)
        if n == bucket:
            return rows, bucket
        padded = np.zeros((bucket, *rows.shape[1:]), dtype=rows.dtype)
        padded[:n] = rows
        return padded, bucket


class ModelRegistry:
    """Registry of warm models over one shared runtime.

    The runtime is single-flight by design (one evaluation launches on
    the device at a time; plan caches are plain dicts): every evaluation,
    warm-up and serving alike, runs under ``eval_lock``, which the
    micro-batch schedulers share.  Without a ``runtime`` the registry
    builds a ``LocalMooseRuntime`` on ``device`` (the CUDA card unless
    the caller asks for the CPU)."""

    def __init__(self, runtime=None, config=None,
                 device=devices.DEFAULT_DEVICE):
        if runtime is None:
            from ..runtime import LocalMooseRuntime

            runtime = LocalMooseRuntime(
                ["alice", "bob", "carole"], device=device
            )
        if config is None:
            from .config import ServingConfig

            config = ServingConfig.from_env()
        self.runtime = runtime
        self.config = config
        self.eval_lock = threading.Lock()
        self._models: Dict[str, RegisteredModel] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def get(self, name: str) -> RegisteredModel:
        try:
            return self._models[name]
        except KeyError:
            raise ConfigurationError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._models)}"
            ) from None

    def names(self):
        return sorted(self._models)

    def register(
        self,
        name: str,
        model,
        row_shape: Tuple[int, ...],
        buckets: Tuple[int, ...] = (),
        fixedpoint_dtype=None,
        input_name: Optional[str] = None,
        max_warmup_evals: int = 12,
        arg_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    ) -> RegisteredModel:
        """Trace, lint and warm ``model`` for every batch bucket; returns
        the warm :class:`RegisteredModel`.

        ``model`` is a ``predictors.Predictor`` (traced via its memoized
        ``traced_predictor``), an ``AbstractComputation``, or an
        already-traced ``Computation``.  ``row_shape`` is the per-row
        input shape (e.g. ``(n_features,)``).  Each bucket is warmed by
        evaluations until its plan has validated (at most
        ``max_warmup_evals``).

        ``arg_ranges`` optionally declares real-space input bounds
        ({input name: (lo, hi)}); when given, the MSA7xx range analysis
        runs strictly at the door against the LARGEST batch bucket
        (worst-case dot accumulation), so a model whose fixed-point
        encoding cannot hold the declared input dynamics is rejected at
        registration instead of wrapping in the ring at serve time."""
        if name in self._models:
            raise ConfigurationError(f"model {name!r} already registered")
        with telemetry.span("register_model", model=name) as root:
            comp = self._resolve(model, fixedpoint_dtype)
            self._check_single_output(comp)
            # strict lint at the door: a model whose graph fails the
            # static analyzer is a typed CompilationError HERE (blitzen
            # answers 4xx at registration) — never a worker hang or a
            # share leak discovered at serve time
            from ..compilation.analysis import lint_check

            with telemetry.span("lint", model=name):
                lint_check(comp)
            input_name = input_name or self._input_name(comp)
            if not buckets:
                # autotuned default ladder: the full power-of-two set,
                # minus buckets whose measured warmup latency (recorded
                # by earlier registrations) is flat against the next
                # bucket — padding is free there and each pruned bucket
                # saves its warmup compiles.  An explicit buckets= stays
                # the override.
                from ..compilation import autotune as _autotune

                bucket_dec = _autotune.serving_bucket_plan(
                    self.config.max_batch
                )
                buckets = tuple(bucket_dec.choice)
                root.attrs["buckets_source"] = bucket_dec.source
                from .. import flight

                flight.record(
                    "serving_buckets_autotuned", model=name,
                    buckets=[int(b) for b in buckets],
                    source=bucket_dec.source, why=bucket_dec.why,
                )
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            if buckets[0] < 1:
                # an explicit 0/negative bucket would warm a degenerate
                # shape and then reject every request at admission
                raise ConfigurationError(
                    f"buckets must all be >= 1, got {buckets}"
                )
            if arg_ranges:
                # before any warmup spend: overflow against the largest
                # bucket is a registration-time rejection
                with telemetry.span("lint_ranges", model=name):
                    lint_check(
                        comp, analyses=["ranges"],
                        context={
                            "arg_specs": {
                                input_name: (
                                    buckets[-1], *tuple(row_shape)
                                )
                            },
                            "arg_ranges": dict(arg_ranges),
                        },
                    )
            warmup_report: Dict[int, dict] = {}
            for bucket in buckets:
                warmup_report[bucket] = self._warm_bucket(
                    comp, input_name, bucket, row_shape, max_warmup_evals
                )
            # the CHOSEN plan: if warmup routed through the lowering
            # pipeline, the lowered/networked graph now sits in the
            # runtime's compiled cache — run the full strict lint
            # (including the MSA5xx schedule rules, which only bite on
            # networked graphs) over it before committing the model
            with telemetry.span("lint_plan", model=name):
                self._lint_resolved_plans(comp)
            root.attrs["buckets"] = list(buckets)
        registered = RegisteredModel(
            name=name,
            comp=comp,
            input_name=input_name,
            row_shape=tuple(row_shape),
            buckets=buckets,
            warmup_report=warmup_report,
        )
        self._models[name] = registered
        return registered

    def replace(
        self,
        name: str,
        model,
        row_shape: Tuple[int, ...],
        **kwargs,
    ) -> RegisteredModel:
        """Warm hot-swap of a live model (the training export path): the
        replacement traces and warms under a staging
        name while the OLD version keeps serving every request, then
        one dict assignment flips the name — in-flight batches against
        the old ``RegisteredModel`` finish on its still-cached plans,
        so nothing is dropped and nothing ever serves cold."""
        import dataclasses as _dc

        if name not in self._models:
            raise ConfigurationError(
                f"model {name!r} is not registered (use register)"
            )
        old = self._models[name]
        # inherit the live registration's bucket ladder when the caller
        # doesn't override it: requests already ADMITTED against the
        # old buckets must still fit the replacement's largest bucket,
        # or a queued batch would fail at pad() after the swap.
        # (fixedpoint_dtype is not recoverable from the old model —
        # callers serving a non-default dtype must re-pass it.)
        if not kwargs.get("buckets"):
            kwargs["buckets"] = old.buckets
        elif max(kwargs["buckets"]) < old.buckets[-1]:
            # a SHRINKING largest bucket would strand any queued
            # request admitted against the old ladder: _gather could
            # never pop it and it would head-of-line-block the queue
            # forever
            raise ConfigurationError(
                f"replace({name!r}): largest bucket "
                f"{max(kwargs['buckets'])} < live {old.buckets[-1]}; "
                "hot-swap buckets must cover every admissible request"
            )
        if tuple(row_shape) != old.row_shape:
            # the batcher admits requests against one row_shape and
            # evaluates them (one model snapshot per batch) possibly
            # after the swap: a shape-changing replacement would fail
            # already-queued rows.  A different shape is a NEW model —
            # register it under a new name and cut traffic over
            raise ConfigurationError(
                f"replace({name!r}): row_shape {tuple(row_shape)} != "
                f"live {old.row_shape}; hot-swap requires an "
                "identical input shape"
            )
        staging = f"__staging__/{name}"
        while staging in self._models:
            staging += "+"
        registered = self.register(
            staging, model, row_shape=row_shape, **kwargs
        )
        del self._models[staging]
        registered = _dc.replace(registered, name=name)
        self._models[name] = registered
        return registered

    def unregister(self, name: str) -> RegisteredModel:
        """Drop a registration (the control plane retiring a rolled-back
        generation).  In-flight evaluations against the popped
        ``RegisteredModel`` finish on its still-cached plans; only the
        NAME disappears."""
        if name not in self._models:
            raise ConfigurationError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._models)}"
            )
        return self._models.pop(name)

    def evaluate(self, model: RegisteredModel, batch: np.ndarray):
        """One warm evaluation of a full (already padded) bucket.
        Returns (per-row outputs, eval_report) where the report carries
        the re-trace / plan-state acceptance bits.  The runtime returns
        its outputs as host numpy arrays, so no caller thread ever
        touches a device tensor."""
        with self.eval_lock:
            outputs = self.runtime.evaluate_computation(
                model.comp, arguments={model.input_name: batch}
            )
            timings = getattr(self.runtime, "last_timings", {})
            plan_state = _plan_state(self.runtime)
        (result,) = outputs.values()
        return np.asarray(result), {
            # a warm evaluation re-entering the tracer means the
            # registry's central promise broke — surfaced per batch
            "retraced": "trace" in timings,
            "plan_state": plan_state,
        }

    # -- internals ---------------------------------------------------------

    def _lint_resolved_plans(self, comp) -> None:
        """Strict-lint every lowered graph the runtime compiled for
        ``comp`` during warmup (the plans serving traffic will actually
        execute).  The MSA5xx schedule analyzer proves the worker plan
        deadlock-free; errors raise the same typed
        ``MalformedComputationError`` the logical-graph lint does."""
        from ..compilation.analysis import lint_check
        from ..computation import Computation

        compiled_cache = getattr(self.runtime, "_compiled_cache", None)
        if compiled_cache is None:
            return
        per_comp = compiled_cache.get(comp) or {}
        seen = set()
        for lowered in per_comp.values():
            if isinstance(lowered, Computation) and lowered not in seen:
                seen.add(lowered)
                lint_check(lowered)

    def _resolve(self, model, fixedpoint_dtype):
        from ..computation import Computation
        from ..edsl import base as edsl_base
        from ..edsl import tracer

        if isinstance(model, Computation):
            return model
        if isinstance(model, edsl_base.AbstractComputation):
            with telemetry.span("trace"):
                return tracer.trace(model)
        if hasattr(model, "traced_predictor"):
            kwargs = (
                {"fixedpoint_dtype": fixedpoint_dtype}
                if fixedpoint_dtype is not None
                else {}
            )
            with telemetry.span("trace"):
                return model.traced_predictor(**kwargs)
        raise ConfigurationError(
            "model must be a Predictor, AbstractComputation, or "
            f"Computation, found {type(model)}"
        )

    @staticmethod
    def _input_name(comp) -> str:
        inputs = [
            n for n, op in comp.operations.items() if op.kind == "Input"
        ]
        if len(inputs) != 1:
            raise ConfigurationError(
                "serving requires a single-Input computation (pass "
                f"input_name= to disambiguate); found {sorted(inputs)}"
            )
        return inputs[0]

    @staticmethod
    def _check_single_output(comp) -> None:
        # the scatter path slices ONE per-row result tensor; reject
        # multi-output graphs at registration (even when input_name= is
        # passed explicitly) instead of failing every request with an
        # unpacking error at serve time
        outputs = [
            n for n, op in comp.operations.items() if op.kind == "Output"
        ]
        if len(outputs) != 1:
            raise ConfigurationError(
                "serving requires a single-Output computation; found "
                f"{sorted(outputs)}"
            )

    def _warm_bucket(self, comp, input_name, bucket, row_shape,
                     max_warmup_evals) -> dict:
        """Drive one bucket's plan through its self-check to a settled
        state, on random rows (as the reference draws them: validating
        evaluations compare a captured plan with the eager walk word for
        word, and all-zero operands would under-exercise the kernels),
        and record its ``bucket_latency`` once it has settled."""
        import time as _time

        rng = np.random.default_rng(bucket)
        x = rng.normal(size=(bucket, *row_shape))
        with telemetry.span("warm_bucket", bucket=bucket) as sp:
            evals = 0
            for _ in range(max(1, max_warmup_evals)):
                with self.eval_lock:
                    t0 = _time.perf_counter()
                    self.runtime.evaluate_computation(
                        comp, arguments={input_name: x}
                    )
                    eval_s = _time.perf_counter() - t0
                    plan_state = _plan_state(self.runtime)
                    plan = dict(getattr(self.runtime, "last_plan", {}))
                evals += 1
                if plan_state != "validating":
                    break
            sp.attrs["evals"] = evals
            sp.attrs["plan_state"] = str(plan_state)
        if plan_state == "validating":
            from ..logger import get_logger

            get_logger().warning(
                "bucket %d still validating after %d warmup evaluations;"
                " serving traffic will finish driving the ladder",
                bucket, evals)
        else:
            # steady-state latency evidence for the bucket autotuner:
            # later registrations prune buckets that measure flat against
            # their next-larger neighbor
            from ..compilation import autotune as _autotune

            _autotune.measurements().record(
                "bucket_latency", 0, str(bucket), eval_s=eval_s,
            )
        report = {"evals": evals, "plan_state": plan_state,
                  "eval_s": eval_s}
        for key in ("plan_mode", "layout", "lowered"):
            if key in plan:
                report[key] = plan[key]
        return report


def _plan_state(runtime):
    """The plan state of the runtime's last evaluation (``last_plan``):
    ``"validating"``, ``"jit"``, ``"per-op"`` or ``"eager"`` for a
    validated stacked plan, ``"static"`` for one that is not validated;
    None where the runtime reports none (the per-host layout)."""
    return (getattr(runtime, "last_plan", {}) or {}).get("plan_state")
