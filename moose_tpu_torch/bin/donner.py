"""donner: the fleet front door — a shared-nothing HTTP router
spreading requests over N blitzen replicas (stdlib-only, like blitzen:
nothing to install in the serving image).  The port's own copy of
``moose_tpu/bin/donner.py``: it forwards bytes and never evaluates, so it
holds no device state.

  python -m moose_tpu_torch.bin.donner \\
      --replica http://127.0.0.1:9001 --replica http://127.0.0.1:9002 \\
      --port 9000

  POST /v1/models/<name>:predict   forwarded to a ready replica
  GET  /metrics                    router metrics, Prometheus text
  GET  /healthz                    router liveness
  GET  /readyz                     200 iff >= 1 replica is ready
  GET  /fleet                      per-replica + per-generation routing
                                   state (JSON)
  POST /admin/routes               set/clear a model's generation split
                                   (only with --admin)

Routing policy (see DEVELOP.md "Fleet serving"):

- **health-based ejection on READINESS, not liveness**: a prober
  thread polls every replica's ``/readyz``; after ``eject_after``
  consecutive failures the replica is ejected from rotation (new
  requests stop routing to it — its in-flight requests drain
  naturally, finishing or failing onto another replica), and after
  ``readmit_after`` consecutive successes it is readmitted;
- **retryable failures move to a DIFFERENT replica**: connection
  failures, per-attempt timeouts, and any HTTP response whose typed
  JSON body carries ``retryable: true`` (blitzen's 503-draining /
  429-overloaded / drained-queue answers) are resubmitted under capped
  exponential backoff with jitter, rotating away from every replica
  already tried this request; non-retryable answers (4xx model errors,
  504 deadline) pass through untouched;
- **per-tenant token-bucket admission** ahead of the replica queues:
  the ``X-Moose-Tenant`` header names the bucket (``default``
  otherwise); an empty bucket answers a typed retryable 429 without
  consuming replica capacity — this layers ON TOP of blitzen's own
  typed 429/504 backpressure, it does not replace it;
- **per-model weighted generation routing** (the control plane's
  canary lever, DEVELOP.md "Continuous training loop"):
  ``set_route(model, {label: weight}, canary=...)`` splits a model's
  traffic across generation labels — label ``base`` is the bare model
  name, any other label routes to the serving name
  ``<model>@<label>``.  Assignment is a deterministic hash bucket of
  ``(model, tenant)``, so one tenant's requests stay on ONE generation
  for a given split, and ramping the canary weight only ever migrates
  tenants base -> canary (never back and forth).  A generation-routed
  request answered 404 ``ModelNotFoundError`` (a replica restarted
  from snapshot without the ephemeral canary) retries on another
  replica and, exhausted, falls back to the last-good label — a
  mid-canary replica kill degrades a tenant to the old generation
  instead of erroring.  Per-(model, generation) sliding windows of
  latency/error samples feed the control plane's SLO watch via
  ``/fleet``.

A request is "dropped" only if every routing attempt is exhausted with
no ready replica to try — the fleet smoke asserts this never happens
across a replica kill + rolling restart.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..errors import ConfigurationError
from ..serving.config import _env_number


class FleetConfig:
    """Router knobs (env-overridable via ``MOOSE_TPU_FLEET_*``, flag-
    overridable in the CLI)."""

    def __init__(self, **overrides):
        env = {
            "probe_interval_ms": _env_number(
                "MOOSE_TPU_FLEET_PROBE_MS", 500.0, float
            ),
            "eject_after": _env_number(
                "MOOSE_TPU_FLEET_EJECT_AFTER", 2, int
            ),
            "readmit_after": _env_number(
                "MOOSE_TPU_FLEET_READMIT_AFTER", 2, int
            ),
            "max_attempts": _env_number(
                "MOOSE_TPU_FLEET_RETRIES", 4, int
            ),
            "backoff_ms": _env_number(
                "MOOSE_TPU_FLEET_BACKOFF_MS", 25.0, float
            ),
            "backoff_cap_ms": _env_number(
                "MOOSE_TPU_FLEET_BACKOFF_CAP_MS", 1000.0, float
            ),
            "attempt_timeout_s": _env_number(
                "MOOSE_TPU_FLEET_TIMEOUT_S", 120.0, float
            ),
            "tenant_rate": _env_number(
                "MOOSE_TPU_FLEET_TENANT_RATE", 0.0, float
            ),
            "tenant_burst": _env_number(
                "MOOSE_TPU_FLEET_TENANT_BURST", 0.0, float
            ),
            "window_s": _env_number(
                "MOOSE_TPU_FLEET_WINDOW_S", 60.0, float
            ),
        }
        env.update({k: v for k, v in overrides.items() if v is not None})
        unknown = set(env) - {
            "probe_interval_ms", "eject_after", "readmit_after",
            "max_attempts", "backoff_ms", "backoff_cap_ms",
            "attempt_timeout_s", "tenant_rate", "tenant_burst",
            "window_s",
        }
        if unknown:
            raise ConfigurationError(f"unknown fleet knobs: {unknown}")
        for key, value in env.items():
            setattr(self, key, value)
        if self.max_attempts < 1:
            raise ConfigurationError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.eject_after < 1 or self.readmit_after < 1:
            raise ConfigurationError(
                "eject_after/readmit_after must be >= 1"
            )


class TokenBucket:
    """Per-tenant admission: ``rate`` tokens/s up to ``burst``.  A rate
    of 0 disables the bucket (every take succeeds)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, self.rate)
        self._tokens = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class _GenWindow:
    """Sliding per-(model, generation) SLO window: (monotonic stamp,
    end-to-end latency, error?) samples trimmed to the last
    ``window_s`` seconds.  ``error`` counts what a client would see as
    a failed or throttled request (5xx or 429) — the control plane's
    typed-error-rate SLO reads ``error_rate`` off ``stats()``."""

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._samples = deque()
        self._lock = threading.Lock()

    def add(self, latency_s: float, error: bool) -> None:
        now = time.monotonic()
        with self._lock:
            self._samples.append((now, float(latency_s), bool(error)))
            self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def stats(self) -> dict:
        with self._lock:
            self._trim(time.monotonic())
            samples = list(self._samples)
        count = len(samples)
        if not count:
            return {
                "count": 0, "errors": 0, "error_rate": 0.0,
                "p50_s": 0.0, "p99_s": 0.0,
            }
        errors = sum(1 for _, _, err in samples if err)
        latencies = sorted(latency for _, latency, _ in samples)

        def pct(p: float) -> float:
            return latencies[min(count - 1, int(p * count))]

        return {
            "count": count,
            "errors": errors,
            "error_rate": errors / count,
            "p50_s": pct(0.50),
            "p99_s": pct(0.99),
        }


def _parse_model_path(path: str) -> Optional[Tuple[str, str]]:
    """``/v1/models/<name>:<action>`` -> (name, action), else None."""
    prefix = "/v1/models/"
    if not path.startswith(prefix) or ":" not in path:
        return None
    name, _, action = path[len(prefix):].partition(":")
    return (name, action) if name and action else None


def _serving_path(model: str, label: str, action: str) -> str:
    name = model if label == "base" else f"{model}@{label}"
    return f"/v1/models/{name}:{action}"


def _assign_generation(model: str, tenant: str,
                       weights: Dict[str, float]) -> str:
    """Deterministic hash-bucket generation assignment: the same
    (model, tenant) always lands at the same point r in [0, 1), and the
    cumulative walk is over SORTED labels — so as a canary's weight
    ramps, tenants only ever cross the boundary in one direction (a
    tenant never flaps between generations mid-ramp)."""
    digest = hashlib.blake2b(
        f"{model}|{tenant}".encode(), digest_size=8
    ).digest()
    r = int.from_bytes(digest, "big") / 2 ** 64
    total = sum(weights.values())
    acc = 0.0
    labels = sorted(weights)
    for label in labels:
        acc += weights[label] / total
        if r < acc:
            return label
    return labels[-1]


class Replica:
    """One blitzen backend: its routing state plus the in-flight count
    the drain logic reads."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        self.ready = False  # until the first successful readiness probe
        self.ejected = False
        self.consecutive_failures = 0
        self.consecutive_successes = 0
        self.in_flight = 0
        self.last_status = "unprobed"
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "url": self.base_url,
                "ready": self.ready,
                "ejected": self.ejected,
                "in_flight": self.in_flight,
                "last_status": self.last_status,
            }


class RouterMetrics:
    def __init__(self):
        from .. import metrics

        self.requests = metrics.counter(
            "moose_tpu_donner_requests_total",
            "requests answered by the router", labels=("outcome",),
        )
        self.retries = metrics.counter(
            "moose_tpu_donner_retries_total",
            "retryable failures resubmitted to another replica",
            labels=("reason",),
        )
        self.ejections = metrics.counter(
            "moose_tpu_donner_ejections_total",
            "replicas ejected on readiness failure",
        )
        self.readmissions = metrics.counter(
            "moose_tpu_donner_readmissions_total",
            "ejected replicas readmitted after readiness recovery",
        )
        self.tenant_rejections = metrics.counter(
            "moose_tpu_donner_tenant_rejections_total",
            "requests rejected by per-tenant token-bucket admission",
            labels=("tenant",),
        )
        self.generation_requests = metrics.counter(
            "moose_tpu_donner_generation_requests_total",
            "requests routed per model generation",
            labels=("model", "generation"),
        )
        self.generation_fallbacks = metrics.counter(
            "moose_tpu_donner_generation_fallbacks_total",
            "generation-routed requests that fell back to the "
            "last-good generation after a fleet-wide generation miss",
            labels=("model",),
        )
        self.ready_gauge = metrics.gauge(
            "moose_tpu_donner_ready_replicas",
            "replicas currently in rotation",
        )
        self.inflight_gauge = metrics.gauge(
            "moose_tpu_donner_in_flight",
            "requests currently forwarded, per replica",
            ("replica",),
        )


class Router:
    """The routing core, independent of the HTTP front end (tests drive
    it directly): readiness probing + ejection, replica choice, typed
    retry, tenant admission."""

    def __init__(self, replica_urls: List[str],
                 config: Optional[FleetConfig] = None):
        if not replica_urls:
            raise ConfigurationError("donner needs at least one --replica")
        self.config = config or FleetConfig()
        self.replicas = [Replica(u) for u in replica_urls]
        self.metrics = RouterMetrics()
        self._rr = 0
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        # per-model generation routing: model -> {"weights": {label:
        # normalized weight}, "canary": label or None}; windows keyed
        # (model, label) outlive route changes so post-flip stats stay
        # scrapeable
        self._routes: Dict[str, dict] = {}
        self._windows: Dict[Tuple[str, str], _GenWindow] = {}
        self._stop = threading.Event()
        self._prober = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._prober = threading.Thread(
            target=self._probe_loop, name="donner-prober", daemon=True
        )
        self._prober.start()

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5)

    # -- health ------------------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            for replica in self.replicas:
                self.probe_once(replica)
            self.metrics.ready_gauge.set(len(self.ready_replicas()))
            self._stop.wait(self.config.probe_interval_ms / 1e3)

    def probe_once(self, replica: Replica) -> bool:
        """One readiness probe; applies the ejection/readmission state
        machine.  Liveness (`/healthz`) is deliberately NOT consulted:
        a draining replica is alive but must stop receiving traffic,
        so rotation keys off readiness alone."""
        try:
            with urllib.request.urlopen(
                replica.base_url + "/readyz", timeout=5
            ) as resp:
                ok = resp.status == 200
                status = f"http-{resp.status}"
        except Exception as e:  # noqa: BLE001 — any probe failure is
            # just "not ready" (connection refused, timeout, 503, ...)
            ok = False
            status = (
                f"http-{e.code}"
                if isinstance(e, urllib.error.HTTPError)
                else type(e).__name__
            )
        with replica._lock:
            replica.last_status = status
            if ok:
                replica.consecutive_failures = 0
                replica.consecutive_successes += 1
                replica.ready = True
                if (
                    replica.ejected
                    and replica.consecutive_successes
                    >= self.config.readmit_after
                ):
                    replica.ejected = False
                    self.metrics.readmissions.inc()
            else:
                replica.consecutive_successes = 0
                replica.consecutive_failures += 1
                if (
                    not replica.ejected
                    and replica.consecutive_failures
                    >= self.config.eject_after
                ):
                    # ejection = connection draining: no NEW requests
                    # route here; forwards already in flight finish (or
                    # fail retryably and move on) on their own
                    replica.ejected = True
                    self.metrics.ejections.inc()
                if replica.ejected:
                    # the eject_after hysteresis applies to ROTATION,
                    # not just the counters: a single probe blip (GC
                    # pause, dropped packet) must not yank a healthy
                    # replica out of rotation — ready only drops once
                    # the failure streak actually ejects it
                    replica.ready = False
        return ok

    def ready_replicas(self) -> List[Replica]:
        return [
            r for r in self.replicas
            if r.ready and not r.ejected
        ]

    # -- admission ---------------------------------------------------------

    def admit(self, tenant: str) -> bool:
        config = self.config
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    config.tenant_rate, config.tenant_burst
                )
        if bucket.take():
            return True
        self.metrics.tenant_rejections.inc(tenant=tenant)
        return False

    # -- routing -----------------------------------------------------------

    def choose(self, exclude) -> Optional[Replica]:
        """Round-robin over ready replicas, skipping ``exclude`` (the
        ones this request already failed on).  Falls back to an
        excluded-but-ready replica only when nothing else is left —
        retrying the same replica beats dropping the request."""
        ready = self.ready_replicas()
        fresh = [r for r in ready if r.base_url not in exclude]
        pool = fresh or ready
        if not pool:
            return None
        with self._lock:
            self._rr += 1
            return pool[self._rr % len(pool)]

    # -- generation routing --------------------------------------------------

    def set_route(self, model: str, weights: Dict[str, float],
                  canary: Optional[str] = None) -> Optional[dict]:
        """Install a weighted generation split for ``model``.  Labels
        are generation names; the reserved label ``base`` is the bare
        model name, anything else routes to ``<model>@<label>``.
        Weights are normalized; zero-weight labels are dropped.
        ``canary`` marks which label the control plane is watching (it
        surfaces in ``/fleet``, routing treats it like any other
        label).  Atomic: in-flight requests see either the old or the
        new split, never a mix.  Returns the previous route (or
        None)."""
        clean: Dict[str, float] = {}
        for label, weight in (weights or {}).items():
            weight = float(weight)
            if weight < 0:
                raise ConfigurationError(
                    f"route weight for {label!r} must be >= 0"
                )
            if weight > 0:
                clean[str(label)] = weight
        total = sum(clean.values())
        if total <= 0:
            raise ConfigurationError(
                f"route for {model!r} needs at least one positive "
                f"weight, got {weights!r}"
            )
        clean = {label: w / total for label, w in clean.items()}
        if canary is not None and canary not in clean:
            raise ConfigurationError(
                f"canary label {canary!r} not among weighted labels "
                f"{sorted(clean)}"
            )
        with self._lock:
            previous = self._routes.get(model)
            self._routes[model] = {"weights": clean, "canary": canary}
        return previous

    def clear_route(self, model: str) -> Optional[dict]:
        """Drop ``model``'s generation split: all traffic back on the
        bare model name.  Atomic, like :meth:`set_route`."""
        with self._lock:
            return self._routes.pop(model, None)

    def _resolve(self, path: str, headers: Dict[str, str]):
        """(model, generation label, routed path) for one request —
        (None, "base", path) when the path is not a model call or the
        model has no route installed."""
        parsed = _parse_model_path(path)
        if parsed is None:
            return None, "base", path
        model, action = parsed
        with self._lock:
            route = self._routes.get(model)
            weights = dict(route["weights"]) if route else None
        if not weights:
            return model, "base", path
        tenant = "default"
        for key, value in headers.items():
            if key.lower() == "x-moose-tenant":
                tenant = value
                break
        label = _assign_generation(model, tenant, weights)
        return model, label, _serving_path(model, label, action)

    def _last_good(self, model: str, failed: str) -> str:
        """The fallback label when ``failed`` is missing fleet-wide:
        ``base`` when it carries weight (or no route is left), else the
        heaviest other label."""
        with self._lock:
            route = self._routes.get(model)
            weights = dict(route["weights"]) if route else {}
        others = {
            label: w for label, w in weights.items() if label != failed
        }
        if not others or "base" in others:
            return "base"
        return max(sorted(others), key=others.get)

    def _window(self, model: str, generation: str) -> _GenWindow:
        key = (model, generation)
        with self._lock:
            window = self._windows.get(key)
            if window is None:
                window = self._windows[key] = _GenWindow(
                    self.config.window_s
                )
            return window

    def forward(self, path: str, body: bytes,
                headers: Dict[str, str]) -> Tuple[int, bytes, dict]:
        """Route one request through the generation split (if any) and
        the replica retry loop: returns (status, body, info).  A
        generation answered 404 ``ModelNotFoundError`` by every tried
        replica falls back to the last-good label — the caller never
        sees a canary-only outage."""
        model, generation, routed = self._resolve(path, headers)
        t0 = time.monotonic()
        status, payload, info = self._forward_attempts(
            routed, body, headers, generation_routed=generation != "base"
        )
        if (
            generation != "base"
            and status == 404
            and _body_error_class(payload) == "ModelNotFoundError"
        ):
            self.metrics.generation_fallbacks.inc(model=model)
            generation = self._last_good(model, generation)
            parsed = _parse_model_path(path)
            fallback = _serving_path(model, generation, parsed[1])
            status, payload, info = self._forward_attempts(
                fallback, body, headers,
                generation_routed=generation != "base",
            )
            info["generation_fallback"] = True
        if model is not None:
            self._window(model, generation).add(
                time.monotonic() - t0,
                error=status >= 500 or status == 429,
            )
            self.metrics.generation_requests.inc(
                model=model, generation=generation
            )
            info["generation"] = generation
        return status, payload, info

    def _forward_attempts(
        self, path: str, body: bytes, headers: Dict[str, str],
        generation_routed: bool = False,
    ) -> Tuple[int, bytes, dict]:
        """The replica retry loop: retryable failures rotate to a
        different replica under capped exponential backoff; after
        ``max_attempts`` the LAST typed answer (or a 503 when no
        replica ever answered) surfaces.  When ``generation_routed``, a
        404 ``ModelNotFoundError`` is treated as retryable too — only a
        replica restarted without the ephemeral generation answers it,
        and a peer that still holds the generation can serve."""
        config = self.config
        tried = set()
        last: Optional[Tuple[int, bytes]] = None
        attempts = 0
        for attempt in range(config.max_attempts):
            replica = self.choose(exclude=tried)
            if replica is None:
                # a transiently empty rotation (rolling restart: the
                # last old replica ejected a probe cycle before the
                # new one is readmitted) is worth waiting out — back
                # off and re-choose instead of dropping the request;
                # prefer the last real typed answer when one exists
                last = last or (
                    503,
                    _typed_body(
                        "ServerOverloadedError",
                        "no ready replica in the fleet; back off "
                        "and retry",
                        retryable=True,
                    ),
                )
                if attempt + 1 < config.max_attempts:
                    backoff = min(
                        config.backoff_cap_ms,
                        config.backoff_ms * (2 ** attempt),
                    ) / 1e3
                    time.sleep(backoff * (0.5 + random.random() / 2))
                continue
            attempts += 1
            tried.add(replica.base_url)
            with replica._lock:
                replica.in_flight += 1
            self.metrics.inflight_gauge.set(
                replica.in_flight, replica=replica.base_url
            )
            try:
                status, payload = self._attempt(
                    replica, path, body, headers
                )
            finally:
                with replica._lock:
                    replica.in_flight -= 1
                self.metrics.inflight_gauge.set(
                    replica.in_flight, replica=replica.base_url
                )
            if status is None:
                # connection-level failure (refused, reset, timeout):
                # retryable by definition — the replica never answered,
                # and predict is a pure function of its inputs, so
                # resubmitting cannot double-apply anything
                self.metrics.retries.inc(reason=payload.decode())
                last = (
                    503,
                    _typed_body(
                        "PeerUnreachableError",
                        f"replica {replica.base_url} unreachable "
                        f"({payload.decode()})",
                        retryable=True,
                    ),
                )
            elif status < 500 and status != 429:
                if (
                    generation_routed
                    and status == 404
                    and _body_error_class(payload) == "ModelNotFoundError"
                ):
                    # generation miss: THIS replica lost the ephemeral
                    # generation (restarted from its durable snapshot);
                    # a peer may still hold it — rotate, don't surface
                    last = (status, payload)
                    self.metrics.retries.inc(reason="generation-miss")
                else:
                    # success or a non-retryable client-side answer:
                    # pass through untouched (bodies already carry
                    # typed errors)
                    self._count(status)
                    return status, payload, {
                        "replica": replica.base_url,
                        "attempts": attempts,
                    }
            else:
                last = (status, payload)
                if not _body_retryable(payload):
                    self._count(status)
                    return status, payload, {
                        "replica": replica.base_url,
                        "attempts": attempts,
                    }
                self.metrics.retries.inc(reason=f"http-{status}")
            if attempt + 1 < config.max_attempts:
                backoff = min(
                    config.backoff_cap_ms,
                    config.backoff_ms * (2 ** attempt),
                ) / 1e3
                time.sleep(backoff * (0.5 + random.random() / 2))
        if last is None:
            last = (
                503,
                _typed_body(
                    "ServerOverloadedError",
                    "no ready replica in the fleet; back off and retry",
                    retryable=True,
                ),
            )
        self._count(last[0])
        return last[0], last[1], {"replica": None, "attempts": attempts}

    def _attempt(self, replica: Replica, path: str, body: bytes,
                 headers: Dict[str, str]):
        """One forward: (status, body) — status None means a
        connection-level failure, body then carries the reason tag."""
        request = urllib.request.Request(
            replica.base_url + path,
            data=body,
            headers={
                "Content-Type": headers.get(
                    "Content-Type", "application/json"
                ),
            },
            method="POST",
        )
        try:
            with urllib.request.urlopen(
                request, timeout=self.config.attempt_timeout_s
            ) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except Exception as e:  # noqa: BLE001 — connection-level only:
            # refused/reset/timeout/DNS; HTTP answers took the branch
            # above
            return None, type(e).__name__.encode()

    def _count(self, status: int) -> None:
        bucket = f"{status // 100}xx"
        self.metrics.requests.inc(outcome=bucket)

    def fleet_snapshot(self) -> dict:
        with self._lock:
            routes = {
                model: {
                    "weights": dict(route["weights"]),
                    "canary": route["canary"],
                    "window": {},
                }
                for model, route in self._routes.items()
            }
            windows = dict(self._windows)
        for (model, generation), window in windows.items():
            entry = routes.setdefault(
                model, {"weights": {}, "canary": None, "window": {}}
            )
            entry["window"][generation] = window.stats()
        return {
            "replicas": [r.snapshot() for r in self.replicas],
            "ready": len(self.ready_replicas()),
            "routes": routes,
        }


def _typed_body(cls: str, message: str, retryable: bool) -> bytes:
    return json.dumps({
        "error": cls, "message": message, "retryable": retryable,
    }).encode()


def _body_error_class(payload: bytes) -> str:
    """The typed ``error`` class of a wire body ("" when untyped)."""
    try:
        return str(json.loads(payload.decode()).get("error") or "")
    except (ValueError, UnicodeDecodeError):
        return ""


def _body_retryable(payload: bytes) -> bool:
    """The typed wire contract: trust the replica's own retryable bit
    (errors.to_wire discipline) — never string-match messages.  A body
    that is not typed JSON (proxy in the middle, crash garbage) is
    treated as retryable only for 5xx, which is the only way this
    function is reached."""
    try:
        return bool(json.loads(payload.decode()).get("retryable"))
    except (ValueError, UnicodeDecodeError):
        return True


def _make_handler(router: Router, admin: bool = False):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes,
                   content_type: str = "application/json",
                   headers: dict = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *log_args):  # quiet by default
            if os.environ.get("MOOSE_TPU_TRACE", "0") not in ("0", ""):
                super().log_message(fmt, *log_args)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b'{"status": "ok"}')
            elif self.path == "/readyz":
                ready = len(router.ready_replicas())
                self._reply(
                    200 if ready else 503,
                    json.dumps({
                        "status": "ready" if ready else "no-replicas",
                        "ready_replicas": ready,
                    }).encode(),
                )
            elif self.path == "/fleet":
                self._reply(
                    200, json.dumps(router.fleet_snapshot()).encode()
                )
            elif self.path == "/metrics":
                from moose_tpu_torch import metrics as metrics_mod

                self._reply(
                    200,
                    metrics_mod.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            else:
                self._reply(
                    404,
                    _typed_body("NotFound", self.path, retryable=False),
                )

        def do_POST(self):
            if admin and self.path == "/admin/routes":
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    spec = json.loads(raw.decode())
                    model = spec["model"]
                    if spec.get("clear"):
                        router.clear_route(model)
                    else:
                        router.set_route(
                            model, spec.get("weights") or {},
                            canary=spec.get("canary"),
                        )
                except (KeyError, ValueError, TypeError,
                        ConfigurationError) as e:
                    self._reply(
                        400,
                        _typed_body(
                            "ConfigurationError", str(e),
                            retryable=False,
                        ),
                    )
                    return
                self._reply(
                    200,
                    json.dumps(
                        router.fleet_snapshot()["routes"]
                    ).encode(),
                )
                return
            if not self.path.startswith("/v1/models/"):
                self._reply(
                    404,
                    _typed_body("NotFound", self.path, retryable=False),
                )
                return
            tenant = self.headers.get("X-Moose-Tenant", "default")
            if not router.admit(tenant):
                self._reply(
                    429,
                    _typed_body(
                        "ServerOverloadedError",
                        f"tenant {tenant!r} exceeded its admission "
                        "rate; back off and retry",
                        retryable=True,
                    ),
                    headers={"Retry-After": "1"},
                )
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length) if length else b"{}"
            status, payload, _ = router.forward(
                self.path, body, dict(self.headers)
            )
            headers = (
                {"Retry-After": "1"} if status in (429, 503) else None
            )
            self._reply(status, payload, headers=headers)

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(prog="donner", description=__doc__)
    parser.add_argument(
        "--replica", action="append", default=[], metavar="URL",
        help="blitzen base URL (repeatable): http://host:port",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument(
        "--probe-interval-ms", type=float, default=None,
        help="readiness probe period (MOOSE_TPU_FLEET_PROBE_MS)",
    )
    parser.add_argument(
        "--eject-after", type=int, default=None,
        help="consecutive readiness failures before ejection "
        "(MOOSE_TPU_FLEET_EJECT_AFTER)",
    )
    parser.add_argument(
        "--readmit-after", type=int, default=None,
        help="consecutive readiness successes before readmission "
        "(MOOSE_TPU_FLEET_READMIT_AFTER)",
    )
    parser.add_argument(
        "--retries", type=int, default=None,
        help="max routing attempts per request "
        "(MOOSE_TPU_FLEET_RETRIES)",
    )
    parser.add_argument(
        "--tenant-rate", type=float, default=None,
        help="per-tenant admitted requests/second, 0 = unlimited "
        "(MOOSE_TPU_FLEET_TENANT_RATE)",
    )
    parser.add_argument(
        "--tenant-burst", type=float, default=None,
        help="per-tenant burst capacity (MOOSE_TPU_FLEET_TENANT_BURST)",
    )
    parser.add_argument(
        "--admin", action="store_true",
        default=os.environ.get("MOOSE_TPU_FLEET_ADMIN", "0") == "1",
        help="enable POST /admin/routes (generation routing control; "
        "bind only on a trusted interface — MOOSE_TPU_FLEET_ADMIN=1)",
    )
    args = parser.parse_args(argv)

    config = FleetConfig(
        probe_interval_ms=args.probe_interval_ms,
        eject_after=args.eject_after,
        readmit_after=args.readmit_after,
        max_attempts=args.retries,
        tenant_rate=args.tenant_rate,
        tenant_burst=args.tenant_burst,
    )
    router = Router(args.replica, config=config)
    router.start()

    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(
        (args.host, args.port), _make_handler(router, admin=args.admin)
    )
    print(
        f"donner: routing over {len(router.replicas)} replica(s) on "
        f"http://{args.host}:{httpd.server_port} "
        f"(eject_after={config.eject_after}, "
        f"retries={config.max_attempts}, "
        f"tenant_rate={config.tenant_rate})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        router.stop()


if __name__ == "__main__":
    main()
