"""blitzen: secure-inference serving daemon — warm model registry +
dynamic micro-batching over an HTTP/JSON front end (stdlib-only, like
the telemetry exporter: nothing to install in the serving image).

The port's own copy of ``moose_tpu/bin/blitzen.py``, serving on the CUDA
card (``--device cpu`` runs the plain PyTorch path)::

  python -m moose_tpu_torch.bin.blitzen logreg=model.onnx --port 9000

  POST /v1/models/<name>:predict   {"x": [[...], ...]}  ->  {"y": [...]}
  GET  /v1/metrics                 serving telemetry snapshot (JSON)
  GET  /metrics                    unified registry, Prometheus text
  GET  /healthz                    liveness: 200 while the process runs
  GET  /readyz                     readiness: 200 only when serving;
                                   503 {"status": "warming"|"draining"}
  GET  /debug/profile?seconds=N    bounded profile capture (Perfetto
                                   JSON; 409 while another runs)
  POST /admin/models/<name>:load   register/hot-swap a generation from
                                   ONNX bytes (only with --admin)
  POST /admin/models/<name>:unload retire a generation (--admin)
  POST /admin/chaos                latency fault injection (--admin)

Every model file is an ONNX graph imported through ``from_onnx``;
registration traces, lints and warms each batch bucket BEFORE the socket
opens, so the first request is as fast as the millionth.  Every
evaluation runs on the batcher's scheduler thread; a handler thread
replies from the numpy rows the batcher scattered and never touches a
device tensor.  Backpressure surfaces as HTTP 429 (queue full) and 504
(deadline expired) with the typed error class and its ``retryable`` bit
in the JSON body.

Fleet mode:

- ``--snapshot-dir`` / ``MOOSE_TPU_SNAPSHOT_DIR``: cold-start from the
  durable warm-state snapshot when a valid one exists, falling back to
  fresh registration — after which the warm state is snapshotted for
  the next restart.
- SIGTERM triggers a **zero-downtime drain**: readiness flips to 503
  (the ``donner`` router stops routing here), new submissions answer
  ``503 + Retry-After`` with a retryable body, in-flight batches
  finish, the warm state is re-snapshotted, and the process exits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import threading
import time
from pathlib import Path


class ReplicaLifecycle:
    """The replica's readiness state machine: ``warming`` -> ``ready``
    -> ``draining`` -> ``stopped``.  ``/healthz`` is liveness (200 for
    as long as the process answers); ``/readyz`` reflects THIS state,
    and the router ejects on readiness, never on liveness — a warming
    or draining replica is alive but must receive no traffic."""

    def __init__(self, name: str = ""):
        # replica identity stamped into the lifecycle flight events so
        # multi-replica postmortems (and a captured
        # flight window) attribute transitions per replica
        self.name = name
        self._state = "warming"
        self._lock = threading.Lock()

    def _record(self, state: str) -> None:
        from moose_tpu_torch import flight

        flight.record(
            f"replica_{state}", party=self.name or None,
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def set_ready(self) -> None:
        with self._lock:
            if self._state != "warming":
                return
            self._state = "ready"
        self._record("ready")

    def start_drain(self) -> bool:
        """Flip to draining; True only for the FIRST caller (signal
        handlers can fire more than once)."""
        with self._lock:
            if self._state in ("draining", "stopped"):
                return False
            self._state = "draining"
        self._record("draining")
        return True

    def stopped(self) -> None:
        with self._lock:
            self._state = "stopped"
        self._record("stopped")


def parse_models(specs) -> dict:
    """name=path.onnx pairs (bare paths name themselves by stem)."""
    out = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = Path(spec).stem, spec
        out[name.strip()] = path.strip()
    return out


def build_server(model_paths: dict, row_features: dict, args):
    """Construct + warm an InferenceServer (shared by serve and
    --oneshot; tests call this directly).  With a snapshot directory
    configured, tries the durable warm-state snapshot FIRST (validated
    against the model files' digests) and only pays the full
    trace/compile/validate cost when no valid snapshot exists — then
    writes one for the next restart."""
    from moose_tpu_torch import predictors
    from moose_tpu_torch.serving import InferenceServer, ServingConfig

    config = ServingConfig.from_env(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_bound=args.queue_bound,
        default_deadline_ms=args.deadline_ms,
    )
    snapshot_dir = getattr(args, "snapshot_dir", None) or os.environ.get(
        "MOOSE_TPU_SNAPSHOT_DIR"
    )
    source_digests = {}
    raws = {}
    for name, path in model_paths.items():
        raw = Path(path).read_bytes()
        raws[name] = raw
        source_digests[name] = hashlib.blake2b(
            raw
            + repr(
                (row_features.get(name), config.max_batch)
            ).encode(),
            digest_size=16,
        ).hexdigest()

    server = InferenceServer(
        config=config, device=getattr(args, "device", "cuda")
    )
    server.snapshot_report = None
    server.source_digests = source_digests
    if snapshot_dir:
        from moose_tpu_torch.errors import SnapshotError
        try:
            server.snapshot_report = server.load_snapshot(
                snapshot_dir, source_digests=source_digests
            )
            print(
                "blitzen: restored warm state from "
                f"{server.snapshot_report['snapshot']} in "
                f"{server.snapshot_report['rewarm_s']:.2f}s "
                f"({server.snapshot_report['probe_checked']} probe "
                "digest(s) verified)",
                flush=True,
            )
            _record_rewarm(server.snapshot_report["rewarm_s"])
            return server
        except SnapshotError as e:
            print(
                f"blitzen: snapshot unusable ({e}); registering fresh",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 — the snapshot contract
            # is "fall back to fresh registration on ANY restore
            # failure": an unexpected class (a rewarm evaluation
            # blowing up on a changed backend that the manifest's
            # package-version check cannot see) must not turn a
            # persistent snapshot volume into a crash loop
            print(
                "blitzen: snapshot restore failed unexpectedly "
                f"({type(e).__name__}: {e}); registering fresh",
                flush=True,
            )
    for name, path in model_paths.items():
        raw = raws[name]
        model = predictors.from_onnx(raw)
        n_features = row_features.get(name)
        if n_features is None:
            # the ONNX input declaration carries the row width; an
            # explicit --features NAME=N overrides it
            from moose_tpu_torch.predictors import onnx_proto, predictor_utils

            try:
                n_features = predictor_utils.input_n_features(
                    onnx_proto.load_model(raw)
                )
                if n_features < 1:
                    # protobuf reports a symbolic (dim_param) feature
                    # dim as dim_value 0 — not inferrable either
                    raise ValueError(
                        "the input declares a symbolic/zero feature dim"
                    )
            except (ValueError, IndexError) as e:
                raise SystemExit(
                    f"--features {name}=N is required (could not infer "
                    f"the row width from the ONNX input: {e})"
                ) from e
        try:
            n_features = int(n_features)
        except ValueError:
            raise SystemExit(
                f"--features {name}={n_features}: N must be an integer"
            ) from None
        if n_features < 1:
            # covers the explicit --features NAME=0 path too (the
            # inference branch above has its own symbolic-dim guard)
            raise SystemExit(
                f"--features {name}={n_features}: N must be >= 1"
            )
        from moose_tpu_torch.errors import CompilationError

        try:
            server.register_model(name, model, row_shape=(n_features,))
        except CompilationError as e:
            # the registry's strict lint rejected the model (share
            # leak, malformed rendezvous, would-deadlock plan, ...):
            # a typed registration-time failure, not a serve-time hang
            raise SystemExit(
                f"model {name!r} failed the static lint at "
                f"registration: {e}"
            ) from e
    if snapshot_dir:
        # warm state is durable from here: the NEXT restart skips the
        # registration cost this process just paid.  Best-effort — the
        # registration SUCCEEDED, so a snapshot failure (disk full,
        # permission) must not take the replica down with it
        try:
            server.save_snapshot(
                snapshot_dir, source_digests=source_digests
            )
        except Exception as e:  # noqa: BLE001 — serve anyway
            print(
                f"blitzen: post-warmup snapshot failed: {e}",
                flush=True,
            )
    return server


def _record_rewarm(seconds: float) -> None:
    from moose_tpu_torch import metrics as metrics_mod

    metrics_mod.gauge(
        "moose_tpu_serving_rewarm_seconds",
        "time to restore warm state from the snapshot at startup",
    ).set(seconds)


def _parse_chaos(spec: str) -> dict:
    """``match:<substr>,delay_ms:<n>`` -> a mutable chaos holder: every
    predict whose serving name contains ``match`` sleeps ``delay_ms``
    first.  The loop smoke poisons a canary generation exactly this way
    (MOOSE_TPU_CHAOS_SERVE, or POST /admin/chaos at runtime)."""
    chaos = {"match": "", "delay_ms": 0.0}
    for part in (spec or "").split(","):
        key, _, value = part.partition(":")
        key = key.strip()
        if key == "match":
            chaos["match"] = value.strip()
        elif key == "delay_ms":
            try:
                chaos["delay_ms"] = float(value)
            except ValueError:
                pass
    return chaos


def _make_handler(server, lifecycle=None, admin: bool = False):
    from concurrent.futures import TimeoutError as FutureTimeoutError
    from http.server import BaseHTTPRequestHandler

    from moose_tpu_torch.errors import (
        CompilationError,
        ConfigurationError,
        ReplicaDrainingError,
        ServerOverloadedError,
        is_retryable,
    )

    chaos = _parse_chaos(os.environ.get("MOOSE_TPU_CHAOS_SERVE", ""))
    lifecycle = lifecycle or ReplicaLifecycle()
    if lifecycle.state == "warming" and server.registry.names():
        # built via the in-process API (tests) where warmup already
        # happened before the handler exists
        lifecycle.set_ready()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict,
                   headers: dict = None) -> None:
            self._reply_raw(
                code, json.dumps(payload).encode(), "application/json",
                headers=headers,
            )

        def _reply_error(self, code: int, exc: BaseException,
                         headers: dict = None) -> None:
            # the typed error class plus its retryable bit: donner (and
            # any other client) decides resubmit-vs-surface from the
            # body alone, never by string-matching messages
            self._reply(
                code,
                {
                    "error": type(exc).__name__,
                    "message": str(exc),
                    "retryable": bool(is_retryable(exc)),
                },
                headers=headers,
            )

        def _reply_raw(self, code: int, body: bytes,
                       content_type: str, headers: dict = None) -> None:
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
                # liveness ONLY: stays 200 through warming and draining
                # (kubelet-style restarts key off liveness; routing
                # keys off readiness below)
                self._reply(
                    200,
                    {"status": "ok", "models": server.registry.names()},
                )
            elif self.path == "/readyz":
                state = lifecycle.state
                self._reply(
                    200 if state == "ready" else 503,
                    {"status": state,
                     "models": server.registry.names()},
                )
            elif self.path.split("?", 1)[0] == "/debug/profile":
                # bounded on-demand profile capture (?seconds=N): the
                # serving-side per-request opt-in (profiling.py)
                from moose_tpu_torch import profiling

                query = (
                    self.path.split("?", 1)[1] if "?" in self.path else ""
                )
                status, payload = profiling.handle_profile_request(query)
                self._reply(status, payload)
            elif self.path == "/v1/metrics":
                self._reply(200, server.metrics_snapshot())
            elif self.path == "/metrics":
                # Prometheus text from the unified registry; queue
                # depths are point-in-time, so refresh the gauge at
                # scrape time
                from moose_tpu_torch import metrics as metrics_mod

                depth_gauge = metrics_mod.gauge(
                    "moose_tpu_serving_queue_depth",
                    "pending requests per model queue",
                    ("model",),
                )
                for name in server.registry.names():
                    depth_gauge.set(
                        server.queue_depth(name), model=name
                    )
                self._reply_raw(
                    200,
                    metrics_mod.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            else:
                self._reply(404, {"error": "NotFound", "path": self.path})

        def do_POST(self):
            if admin and self.path.startswith("/admin/"):
                self._handle_admin()
                return
            prefix, suffix = "/v1/models/", ":predict"
            if not (
                self.path.startswith(prefix)
                and self.path.endswith(suffix)
            ):
                self._reply(404, {"error": "NotFound", "path": self.path})
                return
            name = self.path[len(prefix):-len(suffix)]
            try:
                length = int(self.headers.get("Content-Length", "0"))
                request = json.loads(self.rfile.read(length) or b"{}")
                deadline_ms = request.get("deadline_ms")
                if deadline_ms is not None and not isinstance(
                    deadline_ms, (int, float)
                ):
                    # validate client input here: a str would only blow
                    # up as TypeError inside submit's deadline math,
                    # misclassifying a bad request as a 500
                    raise ValueError(
                        f"deadline_ms must be a number, got {deadline_ms!r}"
                    )
                if lifecycle.state != "ready":
                    # admission is closed while warming/draining; the
                    # Retry-After invites the caller (or donner) to
                    # resubmit elsewhere / later — the typed body says
                    # it is safe (the request was never evaluated)
                    raise ReplicaDrainingError(
                        f"replica is {lifecycle.state}; retry on "
                        "another replica"
                    )
                if name not in server.registry:
                    # 404 + the typed class donner keys its
                    # generation-miss retry on: a replica restarted
                    # from its durable snapshot no longer holds
                    # ephemeral generations — a peer might
                    self._reply(404, {
                        "error": "ModelNotFoundError",
                        "message": (
                            f"unknown model {name!r}; registered: "
                            f"{server.registry.names()}"
                        ),
                        "retryable": False,
                    })
                    return
                if (
                    chaos["match"]
                    and chaos["delay_ms"] > 0
                    and chaos["match"] in name
                ):
                    time.sleep(chaos["delay_ms"] / 1e3)
                try:
                    y = server.predict(
                        name,
                        request["x"],
                        deadline_ms=deadline_ms,
                    )
                except Exception:
                    if name not in server.registry:
                        # the generation was retired between admission
                        # and eval (control-plane rollback racing an
                        # in-flight request): answer the typed
                        # generation-miss so donner retries a peer or
                        # falls back to last-good instead of surfacing
                        self._reply(404, {
                            "error": "ModelNotFoundError",
                            "message": (
                                f"model {name!r} unloaded while the "
                                "request was in flight"
                            ),
                            "retryable": False,
                        })
                        return
                    raise
                self._reply(200, {"y": y.tolist()})
            except ReplicaDrainingError as e:
                self._reply_error(503, e, headers={"Retry-After": "1"})
            except ServerOverloadedError as e:
                self._reply_error(429, e, headers={"Retry-After": "1"})
            except (TimeoutError, FutureTimeoutError) as e:
                # DeadlineExceededError subclasses TimeoutError; the
                # second class is Future.result's py3.10 timeout for a
                # request stuck behind a deep queue — a handler must
                # always answer, never drop the connection
                self._reply_error(504, e)
            except (CompilationError, ConfigurationError, KeyError,
                    ValueError, json.JSONDecodeError) as e:
                # CompilationError covers the registry's strict lint
                # (MalformedComputationError with MSA diagnostics): a
                # bad model is the CLIENT's fault — 4xx, not 500
                self._reply_error(400, e)
            except Exception as e:  # noqa: BLE001 — an eval failure
                # propagates the typed root cause through the request
                # Future; answering 500 (instead of letting the
                # handler abort and drop the keep-alive socket) keeps
                # the always-answer contract for unforeseen classes too
                self._reply_error(500, e)

        # -- control-plane admin surface (only with --admin) -----------

        def _handle_admin(self):
            length = int(self.headers.get("Content-Length", "0"))
            try:
                request = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._reply_error(400, e)
                return
            if self.path == "/admin/chaos":
                chaos["match"] = str(request.get("match") or "")
                chaos["delay_ms"] = float(request.get("delay_ms") or 0.0)
                self._reply(200, {"chaos": dict(chaos)})
                return
            prefix = "/admin/models/"
            if not self.path.startswith(prefix) or ":" not in self.path:
                self._reply(404, {"error": "NotFound", "path": self.path})
                return
            name, _, action = self.path[len(prefix):].partition(":")
            try:
                if action == "load":
                    self._admin_load(name, request)
                elif action == "unload":
                    if name not in server.registry:
                        self._reply(404, {
                            "error": "ModelNotFoundError",
                            "message": f"unknown model {name!r}",
                            "retryable": False,
                        })
                        return
                    server.unregister_model(name)
                    getattr(
                        server, "generation_digests", {}
                    ).pop(name, None)
                    self._reply(200, {"status": "unloaded", "model": name})
                else:
                    self._reply(
                        404, {"error": "NotFound", "path": self.path}
                    )
            except (CompilationError, ConfigurationError, KeyError,
                    ValueError) as e:
                self._reply_error(400, e)
            except Exception as e:  # noqa: BLE001 — always answer
                self._reply_error(500, e)

        def _admin_load(self, name, request):
            """Register (or hot-swap) a model generation from ONNX
            bytes.  Idempotent on the source digest: re-sending the
            same generation (a control-plane retry after a replica
            restart) answers ``already`` without re-warming."""
            import base64

            from moose_tpu_torch import predictors

            if request.get("onnx_b64"):
                raw = base64.b64decode(request["onnx_b64"])
            else:
                raw = Path(request["path"]).read_bytes()
            n_features = int(request["features"])
            buckets = tuple(int(b) for b in request.get("buckets") or ())
            digest = hashlib.blake2b(
                raw + repr(
                    (n_features, server.config.max_batch)
                ).encode(),
                digest_size=16,
            ).hexdigest()
            digests = getattr(server, "generation_digests", None)
            if digests is None:
                digests = server.generation_digests = {}
            if name in server.registry:
                if digests.get(name) == digest:
                    self._reply(200, {
                        "status": "already", "model": name,
                        "digest": digest,
                    })
                    return
                server.replace_model(
                    name, predictors.from_onnx(raw),
                    row_shape=(n_features,), buckets=buckets,
                )
                status = "replaced"
            else:
                server.register_model(
                    name, predictors.from_onnx(raw),
                    row_shape=(n_features,), buckets=buckets,
                )
                status = "registered"
            digests[name] = digest
            self._reply(200, {
                "status": status, "model": name, "digest": digest,
            })

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(prog="blitzen", description=__doc__)
    parser.add_argument(
        "models", nargs="+",
        help="name=path.onnx (bare paths name themselves by stem)",
    )
    parser.add_argument(
        "--features", action="append", default=[], metavar="NAME=N",
        help="per-model row feature count (repeatable)",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the secure evaluations run on (default: the "
        "CUDA card; 'cpu' runs the plain PyTorch path)",
    )
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument(
        "--max-batch", type=int, default=None,
        help="largest coalesced batch / padding bucket "
        "(MOOSE_TPU_SERVE_MAX_BATCH)",
    )
    parser.add_argument(
        "--max-wait-ms", type=float, default=None,
        help="batch hold time (MOOSE_TPU_SERVE_MAX_WAIT_MS)",
    )
    parser.add_argument(
        "--queue-bound", type=int, default=None,
        help="pending-request bound per model (MOOSE_TPU_SERVE_QUEUE)",
    )
    parser.add_argument(
        "--deadline-ms", type=float, default=None,
        help="default per-request deadline (MOOSE_TPU_SERVE_DEADLINE_MS)",
    )
    parser.add_argument(
        "--snapshot-dir", default=None, metavar="DIR",
        help="durable warm-state snapshot directory "
        "(MOOSE_TPU_SNAPSHOT_DIR): restore from it at startup when "
        "valid, write to it after warmup and on graceful drain",
    )
    parser.add_argument(
        "--drain-timeout-s", type=float, default=30.0,
        help="bound on waiting for in-flight requests during a "
        "SIGTERM drain",
    )
    parser.add_argument(
        "--oneshot", default=None, metavar="JSON",
        help='evaluate one {"model": ..., "x": [[...]]} request and '
        "print the result instead of serving (smoke/docs)",
    )
    parser.add_argument(
        "--admin", action="store_true",
        default=os.environ.get("MOOSE_TPU_SERVE_ADMIN", "0") == "1",
        help="enable /admin/* (generation load/unload + chaos knobs; "
        "bind only on a trusted interface — MOOSE_TPU_SERVE_ADMIN=1)",
    )
    args = parser.parse_args(argv)

    model_paths = parse_models(args.models)
    row_features = {}
    for spec in args.features:
        name, sep, value = spec.partition("=")
        if not sep or not value.strip():
            raise SystemExit(
                f"--features expects NAME=N, got {spec!r}"
            )
        row_features[name.strip()] = value.strip()
    unknown = sorted(set(row_features) - set(model_paths))
    if unknown:
        # a typo'd NAME would otherwise be dropped silently and the
        # model fall back to ONNX shape inference
        raise SystemExit(
            f"--features names no registered model: {unknown}; "
            f"models: {sorted(model_paths)}"
        )
    server = build_server(model_paths, row_features, args)

    if args.oneshot is not None:
        request = json.loads(args.oneshot)
        model_name = request.get("model") or next(iter(model_paths))
        y = server.predict(model_name, request["x"])
        print(json.dumps({"y": y.tolist()}))
        server.close()
        return

    import signal
    import time
    from http.server import ThreadingHTTPServer

    lifecycle = ReplicaLifecycle()
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        _make_handler(server, lifecycle, admin=args.admin),
    )
    # the registry is warm (restored or freshly registered) and the
    # socket is bound: this replica may receive traffic
    lifecycle.set_ready()
    snapshot_dir = getattr(args, "snapshot_dir", None) or os.environ.get(
        "MOOSE_TPU_SNAPSHOT_DIR"
    )

    def _drain_sequence():
        # the drain state machine, run while the HTTP server KEEPS
        # ANSWERING: /readyz already says 503 (the router stops
        # routing here) and new predicts answer 503 + Retry-After with
        # a retryable body; now finish every in-flight batch, persist
        # the warm state, and only then stop accepting connections
        t0 = time.perf_counter()
        drained = server.drain(timeout_s=args.drain_timeout_s)
        from moose_tpu_torch import metrics as metrics_mod

        metrics_mod.gauge(
            "moose_tpu_serving_drain_seconds",
            "duration of the most recent graceful drain",
        ).set(time.perf_counter() - t0)
        if snapshot_dir:
            try:
                # only the durable (CLI-registered) models: ephemeral
                # control-plane generations must not enter the snapshot
                # or the restore side's source-digest set-equality
                # check would reject it on the next cold start
                durable = getattr(server, "source_digests", None)
                server.save_snapshot(
                    snapshot_dir,
                    source_digests=durable,
                    only=set(durable) if durable else None,
                )
            except Exception as e:  # noqa: BLE001 — a failed snapshot
                # must not turn a clean drain into a crash loop; the
                # next start falls back to fresh registration
                print(
                    f"blitzen: snapshot on drain failed: {e}",
                    flush=True,
                )
        print(
            "blitzen: drained "
            f"({'clean' if drained else 'timed out'}) in "
            f"{time.perf_counter() - t0:.2f}s; exiting",
            flush=True,
        )
        httpd.shutdown()

    def _on_drain_signal(signum, frame):
        if lifecycle.start_drain():
            # the drain itself runs OUTSIDE the handler: signal
            # handlers must not join threads or write snapshots
            threading.Thread(
                target=_drain_sequence, name="drain", daemon=True
            ).start()
        if signum == signal.SIGINT:
            # a second Ctrl-C force-exits instead of re-entering the
            # (already running) drain
            signal.signal(signal.SIGINT, signal.SIG_DFL)

    signal.signal(signal.SIGTERM, _on_drain_signal)
    # SIGINT drains the same way: serve_forever keeps ANSWERING
    # (503 + Retry-After on predicts, 503 on /readyz) until the drain
    # thread calls httpd.shutdown() — a raised KeyboardInterrupt would
    # instead stop the accept loop BEFORE the drain, leaving probes and
    # retries hanging in the listen backlog for the whole drain window
    signal.signal(signal.SIGINT, _on_drain_signal)
    # port 0 binds an ephemeral port — print the REAL one so fleet
    # tooling can discover it from stdout
    print(
        f"blitzen: serving {server.registry.names()} on "
        f"http://{args.host}:{httpd.server_port} "
        f"(max_batch={server.config.max_batch}, "
        f"max_wait_ms={server.config.max_wait_ms}, "
        f"queue_bound={server.config.queue_bound}, "
        f"snapshot_dir={snapshot_dir})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        # only reachable if SIGINT was re-raised outside our handler
        # (e.g. the SIG_DFL reset above): last-resort synchronous drain
        if lifecycle.start_drain():
            _drain_sequence()
    finally:
        httpd.server_close()
        server.close()
        lifecycle.stopped()


if __name__ == "__main__":
    main()
