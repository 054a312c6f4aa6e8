"""Fleet control plane: the supervised train -> serve loop (the port's
own copy of ``moose_tpu/serving/controlplane.py``, over the port's
``training/`` and ``serving/``).

The layer that makes the training half (the checkpointed, resumable
``TrainingSession``) and the serving half (the donner/blitzen fleet and
its latency-split observability) load-bearing as ONE system.  A
long-lived training session continuously produces model generations;
for each generation the :class:`ControlPlane`

1. **stages** it onto every replica under the serving name
   ``<model>@<label>`` — full warm-behind-the-curtain registration
   (trace/compile/ladder or snapshot-grade warm paths), the live model
   keeps answering everything;
2. **canaries** it: installs a weighted generation split in donner
   (deterministic tenant hash buckets — one tenant sees ONE
   generation), routing ``canary_fraction`` of traffic to the new
   generation;
3. **watches SLOs** over donner's sliding per-generation window (p99
   latency, typed-error rate) plus the replicas' latency split
   (p99 queue-wait / compute) and the fleet-wide
   ``moose_tpu_cost_drift_total`` counter;
4. **promotes** (hot-swaps the base model to the new weights — atomic
   queue flip, zero dropped requests — then retires the staging name)
   or **auto-rolls-back** on breach (atomic weight flip back to the
   last-good generation, staging name retired, base never touched).

Every transition is a ``generation_*`` flight event and a
``moose_tpu_controlplane_*`` metric.  Chaos-hardening contract (see
tests/test_controlplane.py and scripts/loop_smoke.py): a SIGKILLed
replica mid-canary, a trainer killed mid-epoch, and a poisoned
generation each leave the fleet serving the last-good generation with
zero dropped requests.

Knobs (``MOOSE_TPU_CANARY_*``): see :class:`CanaryConfig`.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from .. import flight as flight_mod
from .. import metrics as metrics_mod
from ..errors import ConfigurationError
from .config import _env_number

_METRICS: Optional[Dict[str, Any]] = None


def _metrics() -> Dict[str, Any]:
    global _METRICS
    if _METRICS is None:
        _METRICS = {
            "generations": metrics_mod.counter(
                "moose_tpu_controlplane_generations_total",
                "model generations by terminal outcome",
                ("outcome",),
            ),
            "breaches": metrics_mod.counter(
                "moose_tpu_controlplane_slo_breaches_total",
                "canary SLO breaches by reason",
                ("reason",),
            ),
            "promote_s": metrics_mod.gauge(
                "moose_tpu_controlplane_promote_seconds",
                "duration of the most recent promotion flip",
            ),
            "rollback_s": metrics_mod.gauge(
                "moose_tpu_controlplane_rollback_seconds",
                "duration of the most recent auto-rollback flip",
            ),
            "phase": metrics_mod.gauge(
                "moose_tpu_controlplane_phase",
                "current lifecycle phase (0 idle, 1 staging, 2 canary, "
                "3 promoting, 4 rolling back)",
            ),
        }
    return _METRICS


_PHASES = {
    "idle": 0, "staging": 1, "canary": 2,
    "promoting": 3, "rolling_back": 4,
}


class CanaryConfig:
    """Control-plane knobs (env-overridable via ``MOOSE_TPU_CANARY_*``).

    - ``fraction``: share of traffic the canary generation receives;
    - ``watch_s``: minimum observation time before promotion;
    - ``min_requests``: minimum canary-window samples before any
      verdict (breach OR promotion) — no decision on noise;
    - ``p99_slo_s`` / ``error_rate_slo``: the canary window SLOs
      (donner's sliding per-generation window);
    - ``queue_wait_p99_slo_s`` / ``compute_p99_slo_s``: the
      latency-split SLOs read from the replicas (0 disables);
    - ``cost_drift_max``: allowed ``moose_tpu_cost_drift_total``
      increments during the canary (any more is a breach);
    - ``poll_s``: SLO poll period;
    - ``epochs_per_generation``: training epochs per produced
      generation (the loop trains to a growing cumulative target, so
      mid-epoch resume carries across generations).
    """

    def __init__(self, **overrides):
        env = {
            "fraction": _env_number(
                "MOOSE_TPU_CANARY_FRACTION", 0.25, float
            ),
            "watch_s": _env_number(
                "MOOSE_TPU_CANARY_WATCH_S", 3.0, float
            ),
            "min_requests": _env_number(
                "MOOSE_TPU_CANARY_MIN_REQUESTS", 20, int
            ),
            "p99_slo_s": _env_number(
                "MOOSE_TPU_CANARY_P99_S", 2.0, float
            ),
            "error_rate_slo": _env_number(
                "MOOSE_TPU_CANARY_ERROR_RATE", 0.02, float
            ),
            "queue_wait_p99_slo_s": _env_number(
                "MOOSE_TPU_CANARY_QUEUE_WAIT_P99_S", 0.0, float
            ),
            "compute_p99_slo_s": _env_number(
                "MOOSE_TPU_CANARY_COMPUTE_P99_S", 0.0, float
            ),
            "cost_drift_max": _env_number(
                "MOOSE_TPU_CANARY_COST_DRIFT", 0, int
            ),
            "poll_s": _env_number(
                "MOOSE_TPU_CANARY_POLL_S", 0.25, float
            ),
            "timeout_s": _env_number(
                "MOOSE_TPU_CANARY_TIMEOUT_S", 60.0, float
            ),
            "epochs_per_generation": _env_number(
                "MOOSE_TPU_CANARY_EPOCHS_PER_GEN", 1, int
            ),
        }
        known = set(env)
        env.update({k: v for k, v in overrides.items() if v is not None})
        unknown = set(env) - known
        if unknown:
            raise ConfigurationError(f"unknown canary knobs: {unknown}")
        for key, value in env.items():
            setattr(self, key, value)
        if not 0.0 < self.fraction <= 1.0:
            raise ConfigurationError(
                f"canary fraction must be in (0, 1], got {self.fraction}"
            )
        if self.min_requests < 1:
            raise ConfigurationError("min_requests must be >= 1")


# -- fleet clients ----------------------------------------------------------


class LocalFleetClient:
    """In-process fleet adapter (tests, bench): a donner Router plus the
    ``InferenceServer`` replicas it routes over — the same surface
    :class:`HttpFleetClient` drives over the wire."""

    def __init__(self, router, servers: List[Any]):
        self.router = router
        self.servers = list(servers)

    def set_route(self, model: str, weights: Dict[str, float],
                  canary: Optional[str] = None) -> None:
        self.router.set_route(model, weights, canary=canary)

    def clear_route(self, model: str) -> None:
        self.router.clear_route(model)

    def fleet(self) -> dict:
        return self.router.fleet_snapshot()

    def load_generation(self, name: str, onnx_bytes: bytes,
                        n_features: int,
                        buckets: Tuple[int, ...] = ()) -> None:
        from ..predictors import from_onnx

        for server in self.servers:
            if name in server.registry:
                server.replace_model(
                    name, from_onnx(onnx_bytes),
                    row_shape=(n_features,), buckets=buckets,
                )
            else:
                server.register_model(
                    name, from_onnx(onnx_bytes),
                    row_shape=(n_features,), buckets=buckets,
                )

    def unload_generation(self, name: str) -> None:
        for server in self.servers:
            if name in server.registry:
                server.unregister_model(name)

    def promote_base(self, model: str, onnx_bytes: bytes,
                     n_features: int) -> None:
        from ..predictors import from_onnx

        for server in self.servers:
            server.replace_model(
                model, from_onnx(onnx_bytes), row_shape=(n_features,)
            )

    def replica_metrics(self) -> List[dict]:
        return [s.metrics_snapshot() for s in self.servers]

    def cost_drift_total(self) -> float:
        metric = metrics_mod.REGISTRY.get("moose_tpu_cost_drift_total")
        if metric is None:
            return 0.0
        return float(sum(metric.snapshot_values().values()))


class HttpFleetClient:
    """Wire fleet adapter: donner's ``/admin/routes`` + ``/fleet`` and
    every replica's ``/admin/models/*`` + ``/v1/metrics`` +
    ``/metrics`` (requires ``--admin`` on both daemons)."""

    def __init__(self, router_url: str, replica_urls: List[str],
                 timeout_s: float = 300.0):
        self.router_url = router_url.rstrip("/")
        self.replica_urls = [u.rstrip("/") for u in replica_urls]
        self.timeout_s = timeout_s

    def _post(self, url: str, payload: dict) -> dict:
        request = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(
            request, timeout=self.timeout_s
        ) as resp:
            return json.loads(resp.read().decode())

    def _get(self, url: str):
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.read().decode()

    def set_route(self, model: str, weights: Dict[str, float],
                  canary: Optional[str] = None) -> None:
        self._post(
            self.router_url + "/admin/routes",
            {"model": model, "weights": weights, "canary": canary},
        )

    def clear_route(self, model: str) -> None:
        self._post(
            self.router_url + "/admin/routes",
            {"model": model, "clear": True},
        )

    def fleet(self) -> dict:
        return json.loads(self._get(self.router_url + "/fleet"))

    def load_generation(self, name: str, onnx_bytes: bytes,
                        n_features: int,
                        buckets: Tuple[int, ...] = ()) -> None:
        payload = {
            "onnx_b64": base64.b64encode(onnx_bytes).decode(),
            "features": int(n_features),
        }
        if buckets:
            payload["buckets"] = [int(b) for b in buckets]
        for url in self.replica_urls:
            self._post(f"{url}/admin/models/{name}:load", payload)

    def unload_generation(self, name: str) -> None:
        import urllib.error

        for url in self.replica_urls:
            try:
                self._post(f"{url}/admin/models/{name}:unload", {})
            except urllib.error.HTTPError as e:
                if e.code != 404:  # already gone (replica restarted)
                    raise

    def promote_base(self, model: str, onnx_bytes: bytes,
                     n_features: int) -> None:
        self.load_generation(model, onnx_bytes, n_features)

    def replica_metrics(self) -> List[dict]:
        return [
            json.loads(self._get(url + "/v1/metrics"))
            for url in self.replica_urls
        ]

    def cost_drift_total(self) -> float:
        total = 0.0
        for url in self.replica_urls:
            for line in self._get(url + "/metrics").splitlines():
                if line.startswith("moose_tpu_cost_drift_total"):
                    try:
                        total += float(line.rsplit(" ", 1)[1])
                    except (IndexError, ValueError):
                        pass
        return total


# -- generation producers ---------------------------------------------------


class SessionGenerationProducer:
    """Drives ONE long-lived :class:`TrainingSession` to a growing
    cumulative epoch target: generation N covers epochs
    ``(N-1)*epochs_per_generation + 1 .. N*epochs_per_generation``,
    resuming from whatever is durably committed — a trainer killed
    mid-epoch resumes into the SAME generation and the loop
    never notices beyond the retry counters."""

    def __init__(self, session, x, y, epochs_per_generation: int = 1):
        self.session = session
        self.x = x
        self.y = y
        self.epochs_per_generation = max(1, int(epochs_per_generation))
        self.generations = 0

    def next_generation(self) -> Tuple[str, bytes, int]:
        """(label, onnx_bytes, n_features) for the next generation."""
        from ..training.export import logreg_onnx_bytes

        self.generations += 1
        target = self.generations * self.epochs_per_generation
        report = self.session.run(self.x, self.y, epochs=target)
        weights = report["weights"]["w"]
        label = f"g{report['final_epoch']:04d}"
        return label, logreg_onnx_bytes(weights), int(
            weights.reshape(-1).shape[0]
        )


# -- the control plane ------------------------------------------------------


class ControlPlane:
    """Canary/promote/rollback supervisor for one fleet model."""

    def __init__(self, client, model: str,
                 config: Optional[CanaryConfig] = None):
        self.client = client
        self.model = model
        self.config = config or CanaryConfig()
        self.history: List[dict] = []
        self._phase("idle")

    def _phase(self, phase: str) -> None:
        self.phase = phase
        _metrics()["phase"].set(_PHASES[phase])

    def _event(self, kind: str, **fields) -> None:
        flight_mod.record(kind, party="controlplane", **fields)

    @staticmethod
    def serving_name(model: str, label: str) -> str:
        return model if label == "base" else f"{model}@{label}"

    # -- SLO evaluation ----------------------------------------------------

    def _slo_verdict(self, label: str,
                     cost_drift_base: float) -> Tuple[str, dict]:
        """("ok"|"wait"|<breach reason>, observed) for one poll."""
        cfg = self.config
        routes = self.client.fleet().get("routes") or {}
        window = (
            (routes.get(self.model) or {}).get("window") or {}
        ).get(label) or {}
        observed = {
            "count": int(window.get("count") or 0),
            "p99_s": float(window.get("p99_s") or 0.0),
            "error_rate": float(window.get("error_rate") or 0.0),
            "cost_drift": (
                self.client.cost_drift_total() - cost_drift_base
            ),
        }
        # the latency split: worst replica wins (one overloaded
        # replica is an SLO problem even if the mean looks fine)
        queue_wait = compute = 0.0
        for snap in self.client.replica_metrics():
            queue_wait = max(
                queue_wait, float(snap.get("queue_wait_p99_s") or 0.0)
            )
            compute = max(
                compute, float(snap.get("compute_p99_s") or 0.0)
            )
        observed["queue_wait_p99_s"] = queue_wait
        observed["compute_p99_s"] = compute
        if observed["cost_drift"] > cfg.cost_drift_max:
            return "cost_drift", observed
        if observed["count"] < cfg.min_requests:
            return "wait", observed
        if observed["p99_s"] > cfg.p99_slo_s:
            return "latency", observed
        if observed["error_rate"] > cfg.error_rate_slo:
            return "errors", observed
        if (
            cfg.queue_wait_p99_slo_s
            and queue_wait > cfg.queue_wait_p99_slo_s
        ):
            return "queue_wait", observed
        if cfg.compute_p99_slo_s and compute > cfg.compute_p99_slo_s:
            return "compute", observed
        return "ok", observed

    # -- the generation lifecycle ------------------------------------------

    def run_generation(self, label: str, onnx_bytes: bytes,
                       n_features: int) -> dict:
        """Stage -> canary -> watch -> promote | rollback, one
        generation.  Returns the generation report (also appended to
        ``history``)."""
        cfg = self.config
        model = self.model
        staging = self.serving_name(model, label)
        report = {
            "model": model, "generation": label, "staging": staging,
            "promoted": False, "reason": "", "observed": {},
        }
        t_start = time.perf_counter()

        self._phase("staging")
        self._event("generation_staged", model=model, generation=label)
        self.client.load_generation(
            staging, onnx_bytes, n_features
        )

        self._phase("canary")
        cost_drift_base = self.client.cost_drift_total()
        self.client.set_route(
            model,
            {"base": 1.0 - cfg.fraction, label: cfg.fraction}
            if cfg.fraction < 1.0 else {label: 1.0},
            canary=label,
        )
        self._event(
            "generation_canary", model=model, generation=label,
            fraction=cfg.fraction,
        )

        verdict = "wait"
        observed: dict = {}
        watch_start = time.monotonic()
        while True:
            time.sleep(cfg.poll_s)
            verdict, observed = self._slo_verdict(label, cost_drift_base)
            if verdict not in ("ok", "wait"):
                break  # breach: roll back NOW, not at watch_s
            if (
                verdict == "ok"
                and time.monotonic() - watch_start >= cfg.watch_s
            ):
                break
            if (
                verdict == "wait"
                and time.monotonic() - watch_start >= cfg.timeout_s
            ):
                # a canary that never collects min_requests is
                # undecidable — treat like a breach and keep last-good
                verdict = "no_traffic"
                break
        report["observed"] = observed

        if verdict == "ok":
            self._phase("promoting")
            t0 = time.perf_counter()
            # warm the new weights under the base name behind the
            # curtain, then the atomic queue flip — zero requests
            # dropped; only THEN move traffic off the staging label and
            # retire it
            self.client.promote_base(model, onnx_bytes, n_features)
            self.client.clear_route(model)
            self.client.unload_generation(staging)
            promote_s = time.perf_counter() - t0
            _metrics()["promote_s"].set(promote_s)
            _metrics()["generations"].inc(outcome="promoted")
            self._event(
                "generation_promoted", model=model, generation=label,
                promote_s=promote_s, **observed,
            )
            report.update(promoted=True, reason="slo_ok",
                          promote_s=promote_s)
        else:
            self._phase("rolling_back")
            t0 = time.perf_counter()
            _metrics()["breaches"].inc(reason=verdict)
            # the flip back IS the rollback: clearing the route is
            # atomic in donner, so every subsequent request routes to
            # the last-good base generation; the poisoned staging name
            # is retired after traffic has moved
            self.client.clear_route(model)
            self.client.unload_generation(staging)
            rollback_s = time.perf_counter() - t0
            _metrics()["rollback_s"].set(rollback_s)
            _metrics()["generations"].inc(outcome="rolled_back")
            self._event(
                "generation_rolled_back", model=model, generation=label,
                reason=verdict, rollback_s=rollback_s, **observed,
            )
            report.update(reason=verdict, rollback_s=rollback_s)

        self._phase("idle")
        report["total_s"] = time.perf_counter() - t_start
        self.history.append(report)
        return report

    def run_loop(self, producer, generations: int = 1) -> List[dict]:
        """The continuous loop: produce (train) -> run one generation
        lifecycle, ``generations`` times.  A produced generation that
        fails to train raises; a generation that breaches its SLO rolls
        back and the loop CONTINUES to the next one (a bad generation
        is an expected outcome, not a loop failure)."""
        reports = []
        for _ in range(generations):
            label, onnx_bytes, n_features = producer.next_generation()
            reports.append(
                self.run_generation(label, onnx_bytes, n_features)
            )
        return reports
