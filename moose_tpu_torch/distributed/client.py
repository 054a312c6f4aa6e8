"""Client session supervisor for a cluster of gRPC workers (reference
GrpcMooseRuntime, execution/grpc.rs:11-146), the port's own copy of
``moose_tpu/distributed/client.py``: compile the logical
computation to the host-level graph, fan LaunchComputation out to every
worker IN PARALLEL, retrieve in parallel with first-error-wins, and —
because a session is a pure function of (computation, arguments) and
replay protection drops stale traffic for old ids — resubmit the whole
computation under a fresh session id when the failure is *retryable*
(transport fault, receive timeout, detector trip; see
``errors.is_retryable``).  Permanent failures (compile/type errors,
PERMISSION_DENIED) re-raise immediately as their original typed class,
reconstructed from the wire envelope (``errors.from_wire``).

Every run leaves a ``last_session_report`` on the runtime — attempts,
per-party outcomes, injected chaos faults — mirroring
``runtime.last_plan`` for the local executors."""

from __future__ import annotations

import random
import secrets
import threading
import time
from typing import Optional

from .. import flight as flight_mod
from .. import metrics as metrics_mod
from .. import telemetry
from ..computation import Computation
from ..errors import (
    AuthorizationError,
    MooseError,
    NetworkingError,
    is_retryable,
)
from .choreography import ChoreographyClient


_CLIENT_METRICS = None


def _client_metrics():
    """Lazily-created supervisor counters (cached like
    networking._net_metrics — one registry lookup per family, ever)."""
    global _CLIENT_METRICS
    if _CLIENT_METRICS is None:
        _CLIENT_METRICS = {
            "sessions": metrics_mod.counter(
                "moose_tpu_client_sessions_total",
                "distributed sessions run by this client, by outcome",
                ("outcome",),
            ),
            "retries": metrics_mod.counter(
                "moose_tpu_client_retries_total",
                "retryable session failures that were resubmitted",
            ),
            "aborts": metrics_mod.counter(
                "moose_tpu_client_aborts_total",
                "client-initiated abort fanouts (partial launch / first "
                "retrieve error cleanup)",
            ),
        }
    return _CLIENT_METRICS


def _retryable(exc: BaseException) -> bool:
    """The wire bit when the error crossed the wire (the originator's
    taxonomy already classified the live exception), the local taxonomy
    otherwise."""
    wire_bit = getattr(exc, "retryable", None)
    return bool(wire_bit) if wire_bit is not None else is_retryable(exc)


def _error_from_result(party: str, result: dict) -> MooseError:
    """Typed exception for a worker's error cell.  Envelope-carrying
    cells (every current worker) re-raise the REAL class; bare string
    cells (older workers) degrade to a retryable NetworkingError."""
    from ..errors import from_wire

    envelope = result.get("envelope")
    if envelope:
        return from_wire(envelope)
    exc = NetworkingError(f"worker {party} failed: {result['error']}")
    exc.retryable = True
    return exc


def _classify_rpc_error(exc: BaseException, what: str) -> MooseError:
    """Map a raw transport/launch failure into the taxonomy: mTLS /
    choreographer rejections are permanent, everything else about an
    unreachable or failing worker is retryable."""
    if isinstance(exc, MooseError):
        return exc
    detail = str(exc)
    try:
        import grpc

        if isinstance(exc, grpc.RpcError):
            code = exc.code()
            detail = f"{code.name}: {exc.details()}"
            if code == grpc.StatusCode.PERMISSION_DENIED:
                typed = AuthorizationError(f"{what}: {detail}")
                typed.__cause__ = exc
                return typed
    except ModuleNotFoundError:  # pragma: no cover - grpc ships with repo
        pass
    typed = NetworkingError(f"{what}: {detail}")
    typed.__cause__ = exc
    return typed


def _chaos_marks() -> list:
    """Snapshot (config, fault-log length) for every live in-process
    chaos config, so the report can attribute exactly the faults
    injected during this run."""
    from .chaos import active_configs

    return [(cfg, len(cfg.faults)) for cfg in active_configs()]


def _chaos_new_faults(marks: list) -> list:
    faults = []
    for cfg, mark in marks:
        with cfg._lock:
            faults.extend(dict(f) for f in cfg.faults[mark:])
    return faults


class GrpcClientRuntime:
    def __init__(self, identities: dict, tls=None, max_attempts: int = 3,
                 backoff_base_s: float = 0.25, backoff_cap_s: float = 2.0):
        """``identities``: {identity/placement name: "host:port"};
        ``tls``: optional :class:`moose_tpu.distributed.tls.TlsConfig` —
        each worker must then present a certificate whose CN is its
        identity name.  ``max_attempts``: how many times a RETRYABLE
        failure resubmits the computation (fresh session id, capped
        exponential backoff + jitter) before surfacing."""
        self.identities = dict(identities)
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._clients = {
            name: ChoreographyClient(endpoint, tls=tls,
                                     expected_identity=name)
            for name, endpoint in self.identities.items()
        }
        # supervisor outcome of the most recent run_computation call:
        # attempts, per-party errors, injected chaos faults (the
        # distributed mirror of runtime.last_plan)
        self.last_session_report: dict = {}
        # compiled-computation memo, weak-keyed on the logical
        # computation: lowering bakes fresh DeriveSeed sync-key nonces,
        # so re-compiling per session would ship DIFFERENT bytes each
        # time and the workers' role-plan caches (weak-keyed on the
        # deserialized computation, memoized by bytes) could never hit —
        # every session would re-validate and re-jit
        import weakref

        self._compile_cache: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )

    # -- one attempt ----------------------------------------------------

    def _abort_parties(self, session_id: str, parties) -> None:
        """Best-effort parallel abort — used to clean up launched
        workers after a partial launch failure and to unblock survivors
        after the first retrieve error, so no session outlives the
        abort-fanout window."""
        _client_metrics()["aborts"].inc()
        flight_mod.record(
            "client_abort", party="client", session=session_id,
            parties=sorted(parties),
        )

        def one(name):
            try:
                self._clients[name].abort(session_id)
            except Exception:  # noqa: BLE001 — target may be the dead one
                pass

        threads = [
            threading.Thread(target=one, args=(p,), daemon=True)
            for p in parties
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)

    def _launch_all(self, session_id: str, comp_bytes: bytes,
                    per_party_args: dict, attempt_rec: dict,
                    trace: Optional[dict] = None) -> None:
        """Fan launches out in parallel.  On ANY failure the workers
        that DID launch are aborted before the typed error is raised —
        a partially-launched session must not sit in blocked receives
        until the failure detector notices the missing party."""
        launched: list = []
        failures: dict = {}
        lock = threading.Lock()

        def one(name):
            try:
                resp = self._clients[name].launch(
                    session_id, comp_bytes, per_party_args[name],
                    trace=trace,
                )
                if not resp.get("ok"):
                    raise NetworkingError(
                        f"launch on {name} failed: {resp!r}"
                    )
                with lock:
                    launched.append(name)
            except Exception as e:  # noqa: BLE001 — classified below
                with lock:
                    failures[name] = _classify_rpc_error(
                        e, f"launch on {name} failed"
                    )

        threads = [
            threading.Thread(target=one, args=(n,), daemon=True)
            for n in self._clients
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150.0)
        with lock:
            for name in self._clients:
                # a launch thread still hanging after the join window is
                # a FAILURE, not a success: treating it as launched
                # would run the session against a party that may never
                # have started (and exclude it from the abort sweep)
                if name not in launched and name not in failures:
                    exc = NetworkingError(
                        f"launch on {name} timed out (no response)"
                    )
                    exc.retryable = True
                    failures[name] = exc
        if failures:
            attempt_rec["errors"].update({
                name: f"{type(e).__name__}: {e}"
                for name, e in failures.items()
            })
            attempt_rec["status"] = "launch_failed"
            if launched:
                self._abort_parties(session_id, launched)
            # surface a PERMANENT failure over a retryable one: if any
            # party rejected the computation outright, retrying the
            # transient co-failures would just replay the rejection
            ranked = sorted(
                failures.values(), key=_retryable
            )
            raise ranked[0]

    def _retrieve_all(self, session_id: str, timeout: float,
                      attempt_rec: dict) -> tuple:
        """Retrieve every party in parallel; the FIRST error wins and
        aborts the survivors (serial retrieval would hide a fast
        failure behind a slow success)."""
        from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor
        from concurrent.futures import wait as futures_wait

        from ..serde import deserialize_value
        from ..values import HostUnit

        def one(name):
            try:
                result = self._clients[name].retrieve(
                    session_id, timeout=timeout
                )
            except Exception as e:  # noqa: BLE001 — classified
                raise _classify_rpc_error(
                    e, f"retrieve from {name} failed"
                ) from e
            if "error" in result:
                raise _error_from_result(name, result)
            return name, result

        pool = ThreadPoolExecutor(
            max_workers=max(1, len(self._clients)),
            thread_name_prefix="moose-retrieve",
        )
        futs = {
            pool.submit(one, name): name for name in self._clients
        }
        outputs: dict = {}
        timings: dict = {}
        plan_modes: dict = {}
        transports: dict = {}
        try:
            done, pending = futures_wait(
                futs, timeout=timeout + 15.0,
                return_when=FIRST_EXCEPTION,
            )
            errors: list = []
            for fut in done:
                name = futs[fut]
                exc = fut.exception()
                if exc is not None:
                    attempt_rec["errors"][name] = (
                        f"{type(exc).__name__}: {exc}"
                    )
                    errors.append(exc)
                    continue
                _, result = fut.result()
                attempt_rec["errors"].setdefault(name, "ok")
                timings[name] = result.get("elapsed_time_micros", 0)
                if result.get("plan_mode") is not None:
                    plan_modes[name] = {
                        "plan_mode": result["plan_mode"],
                        "pinned_segments": result.get(
                            "pinned_segments", []
                        ),
                    }
                if result.get("transport") is not None:
                    transports[name] = {
                        "transport": result["transport"],
                        "trust_model": result.get("trust_model"),
                    }
                for out_name, blob in (
                    result.get("outputs") or {}
                ).items():
                    value = deserialize_value(blob)
                    outputs[out_name] = (
                        None if isinstance(value, HostUnit) else value
                    )
            if not errors and pending:
                exc = NetworkingError(
                    f"retrieve timed out after {timeout}s on "
                    f"{sorted(futs[f] for f in pending)}"
                )
                exc.retryable = True
                errors.append(exc)
            # a PERMANENT error is canonical over any retryable
            # co-failure (same ranking as _launch_all): fanout races
            # can land a peer's adopted SessionAborted in the same
            # FIRST_EXCEPTION wake-up as the real root cause, and
            # replaying a deterministic failure just repeats it
            first_error = (
                sorted(errors, key=_retryable)[0] if errors else None
            )
            if first_error is not None:
                attempt_rec["status"] = "retrieve_failed"
                # unblock everyone still running before surfacing: the
                # fastest failure is canonical, survivors are aborted
                self._abort_parties(session_id, list(self._clients))
                raise first_error
        finally:
            pool.shutdown(wait=False)
        return outputs, timings, plan_modes, transports

    def _collect_flight(self, session_ids) -> list:
        """Gather every party's recent flight-recorder events for the
        given session ids: the in-process recorder first (for local
        clusters it already holds all parties' events — including a
        chaos-killed party whose rpc endpoint is gone), then each
        worker's GetFlight rpc best-effort.  Deduplicated on
        (party, seq) — in-process workers serve the same recorder the
        direct read saw."""
        events = flight_mod.get_recorder().events(sessions=session_ids)
        seen = {(e.get("party"), e.get("seq")) for e in events}
        # parallel fanout (same discipline as _abort_parties): in a
        # full partition every rpc times out, and serial 5 s waits
        # would delay the caller's exception by parties x 5 s
        remote_lists: dict = {}

        def one(name):
            try:
                remote_lists[name] = self._clients[name].flight(
                    session_ids
                )
            except Exception:  # noqa: BLE001 — the dead party can't answer
                pass

        threads = [
            threading.Thread(target=one, args=(n,), daemon=True)
            for n in self._clients
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=6.0)
        # snapshot: a straggler thread past its join window must not
        # mutate the dict mid-iteration
        for remote in list(remote_lists.values()):
            for event in remote:
                key = (event.get("party"), event.get("seq"))
                if key in seen:
                    continue
                seen.add(key)
                events.append(event)
        events.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
        return events

    # -- the supervisor loop --------------------------------------------

    def run_computation(
        self,
        computation: Computation,
        arguments: Optional[dict] = None,
        timeout: float = 120.0,
        arg_specs: Optional[dict] = None,
        max_attempts: Optional[int] = None,
    ):
        """Compile + fan out + retrieve, retrying retryable failures.
        ``arg_specs`` supplies shape/dtype specs the client cannot infer
        from ``arguments`` — in particular for Load ops whose values
        live in worker-side storage: ``{load_op_name: ((shape...),
        np_dtype)}``."""
        from ..compilation import DEFAULT_PASSES, compile_computation
        from ..compilation.lowering import arg_specs_from_arguments
        from ..serde import serialize_computation

        arguments = dict(arguments or {})
        specs = arg_specs_from_arguments(arguments)
        specs.update(arg_specs or {})
        specs_key = tuple(sorted(
            (n, s) if isinstance(s, (str, int, float))
            else (n, tuple(s[0]), str(s[1]))
            for n, s in specs.items()
        ))
        per_comp = self._compile_cache.get(computation)
        if per_comp is None:
            per_comp = self._compile_cache[computation] = {}
        cached = per_comp.get(specs_key)
        if cached is None:
            compiled = compile_computation(
                computation,
                DEFAULT_PASSES,
                arg_specs=specs,
            )
            cached = per_comp[specs_key] = (
                compiled, serialize_computation(compiled)
            )
        compiled, comp_bytes = cached

        # each worker receives ONLY the arguments whose Input op lives on
        # its placement — shipping the full cleartext dict to every party
        # would hand carole alice's private inputs and void the trust
        # model this runtime exists for
        owner_of = {
            op.name: compiled.placement_of(op).name
            for op in compiled.operations.values()
            if op.kind == "Input"
        }
        per_party_args = {
            name: {
                arg: v for arg, v in arguments.items()
                if owner_of.get(arg) == name
            }
            for name in self._clients
        }

        attempts = (
            self.max_attempts if max_attempts is None else int(max_attempts)
        )
        attempts = max(1, attempts)
        marks = _chaos_marks()
        report: dict = {
            "ok": False,
            "n_attempts": 0,
            "max_attempts": attempts,
            "attempts": [],
            "faults_injected": [],
        }
        self.last_session_report = report
        session_ids: list = []

        with telemetry.span(
            "run_computation", parties=len(self._clients),
            max_attempts=attempts,
        ) as root:
            try:
                for attempt in range(1, attempts + 1):
                    session_id = secrets.token_hex(16)
                    session_ids.append(session_id)
                    attempt_rec = {
                        "session_id": session_id,
                        "status": "ok",
                        "errors": {},
                        "elapsed_s": 0.0,
                    }
                    report["attempts"].append(attempt_rec)
                    report["n_attempts"] = attempt
                    t0 = time.monotonic()
                    with telemetry.span(
                        "attempt", attempt=attempt, session_id=session_id,
                    ) as att:
                        # one TraceContext per session attempt: workers
                        # adopt it for their execute_role roots, so the
                        # whole 3-party session exports as ONE stitched
                        # trace under this attempt span
                        trace_ctx = telemetry.TraceContext(
                            att.trace_id, att.span_id
                        )
                        flight_mod.record(
                            "attempt", party="client",
                            session=session_id, attempt=attempt,
                        )
                        try:
                            with telemetry.span("launch"):
                                self._launch_all(
                                    session_id, comp_bytes,
                                    per_party_args, attempt_rec,
                                    trace=trace_ctx.to_dict(),
                                )
                            with telemetry.span("retrieve"):
                                outputs, timings, plan_modes, transports = (
                                    self._retrieve_all(
                                        session_id, timeout, attempt_rec
                                    )
                                )
                        except Exception as exc:
                            attempt_rec["elapsed_s"] = (
                                time.monotonic() - t0
                            )
                            attempt_rec["error"] = (
                                f"{type(exc).__name__}: {exc}"
                            )
                            attempt_rec["retryable"] = _retryable(exc)
                            flight_mod.record(
                                "attempt_failed", party="client",
                                session=session_id,
                                status=attempt_rec["status"],
                                error=attempt_rec["error"],
                                retryable=attempt_rec["retryable"],
                            )
                            if (
                                not attempt_rec["retryable"]
                                or attempt >= attempts
                            ):
                                raise
                            _client_metrics()["retries"].inc()
                            # capped exponential backoff + jitter before
                            # the resubmission (fresh session id; replay
                            # protection drops stragglers of this one)
                            delay = min(
                                self.backoff_cap_s,
                                self.backoff_base_s * 2 ** (attempt - 1),
                            )
                            delay += random.uniform(0, delay / 2)
                            with telemetry.span(
                                "backoff", seconds=round(delay, 3)
                            ):
                                time.sleep(delay)
                            continue
                    attempt_rec["elapsed_s"] = time.monotonic() - t0
                    report["ok"] = True
                    root.attrs["attempts_used"] = attempt
                    _client_metrics()["sessions"].inc(outcome="ok")
                    flight_mod.record(
                        "session_ok", party="client", session=session_id,
                        attempts=attempt,
                    )
                    break
            except Exception:
                # terminal failure: attach every party's recent flight
                # events for the attempted session ids to the report —
                # the postmortem record that makes a chaos failure
                # diagnosable, not merely reproducible.  Exception, not
                # BaseException: a KeyboardInterrupt must propagate
                # immediately, not sit behind a best-effort rpc fanout.
                _client_metrics()["sessions"].inc(outcome="failed")
                flight_mod.record(
                    "session_failed", party="client",
                    session=session_ids[-1] if session_ids else None,
                    attempts=report["n_attempts"],
                )
                report["flight"] = self._collect_flight(session_ids)
                raise
            finally:
                report["faults_injected"] = _chaos_new_faults(marks)
                report["retried"] = report["n_attempts"] > 1

        from ..execution.interpreter import ordered_output_names

        outputs = {
            name: outputs[name] for name in ordered_output_names(outputs)
        }
        report["timings"] = dict(timings)
        # resolved per-role worker plans (worker_plan): the distributed
        # mirror of LocalMooseRuntime.last_plan's plan_mode/pinned_ops
        report["plan_modes"] = dict(plan_modes)
        # resolved transport per party, plus the session-level rollup
        # ("fabric" / "grpc" / "mixed") and trust model — BENCH rows and
        # postmortems must say what the traffic actually rode on
        report["transports"] = dict(transports)
        kinds = {t["transport"] for t in transports.values()}
        report["transport"] = (
            (kinds.pop() if len(kinds) == 1 else "mixed")
            if kinds else None
        )
        models = {
            t.get("trust_model") for t in transports.values()
            if t.get("trust_model")
        }
        report["trust_model"] = (
            models.pop() if len(models) == 1
            else (sorted(models) if models else None)
        )
        return outputs, timings
