"""Deterministic chaos layer for the distributed runtime.

PyTorch port's copy of ``moose_tpu/distributed/chaos.py``: host code,
word for word the reference's decisions (so one seed gives one
``schedule_digest`` in both packages), observed through the port's
``flight`` and ``metrics``.

Every failure mode the choreography layer defends against — dropped
sends, delayed sends, duplicate delivery, failed pings, a worker dying
mid-session — becomes injectable ON DEMAND and REPRODUCIBLY: each fault
decision is a pure function of ``(seed, fault kind, stable key, attempt
count)`` via blake2b, so the same seed replays the identical fault
schedule in-process (tests over LocalNetworking), cross-process (comet
daemons reading ``MOOSE_TPU_CHAOS``), and across reruns.  Nothing here
consults wall-clock randomness.

Env format::

    MOOSE_TPU_CHAOS=seed:17,drop_send:0.2,delay_ms:5,dup_send:0.1,\
fail_ping:0.3,kill_after_ops:40,party:carole

- ``seed`` (int): the schedule key; required for any fault to fire.
- ``drop_send`` (probability): a *first-attempt* send of a rendezvous
  key is swallowed — the receiver never sees it and times out.  Client
  resubmissions reuse the same rendezvous keys under a new session id,
  advance the per-key attempt count, and pass — so the supervisor's
  retry path is exercised end to end and still converges.
- ``delay_ms`` (float): every send sleeps this long first (reordering /
  slow-network pressure).
- ``dup_send`` (probability): a send is delivered twice — exercising the
  cell store's duplicate-delivery idempotency.
- ``fail_ping`` (probability): a failure-detector ping raises —
  exercising the miss-point budget without a dead peer.
- ``kill_after_ops`` (int): after this many networking operations the
  party "dies": its gRPC server stops answering (peers see UNAVAILABLE
  and the detector trips) and every further transport op — including
  its own abort fanout, exactly like a SIGKILL — raises.
- ``party`` (name): scope all faults to one identity; unscoped chaos
  applies everywhere (each identity keeps its own op counter).
- ``max_kills`` (int, default 1): lifetime cap on how many times one
  identity dies.  The drop/dup schedules are self-healing across
  sessions (decisions key on STABLE rendezvous keys with per-key
  attempt counts, so an epoch resume under the same seed does not
  re-trip the identical drop), but the kill op-budget is not — a
  revived worker would die again at the same op count forever.  With
  the cap, a restarted WorkerServer (``revive``) runs clean once the
  budget is spent, so multi-session supervisors (training epoch resume)
  converge.  ``max_kills:0`` disables kills entirely.

Transports are wrapped, not modified: :meth:`ChaosConfig.wrap` returns
a :class:`ChaosNetworking` proxy composing over Local/Tcp/Grpc
networking, so the same schedule runs over any wire.
"""

from __future__ import annotations

import hashlib
import threading
import time
import weakref
from typing import Optional

from ..errors import ConfigurationError, NetworkingError

# live configs, for fault-report aggregation (client.last_session_report
# collects in-process fault logs); weak so dead clusters don't pile up
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()


def active_configs() -> list:
    return list(_ACTIVE)


def _observe_fault(kind: str, detail: dict,
                   session: Optional[str] = None) -> None:
    """Mirror an injected fault onto the metrics registry and the
    flight recorder, so chaos activity is visible on /metrics and in
    postmortem session reports — not only in the in-process fault log.
    ``session`` stamps the flight event only: the fault log feeds the
    cross-run determinism digest and session ids are random per run."""
    from .. import flight, metrics

    metrics.counter(
        "moose_tpu_chaos_injections_total",
        "deterministic chaos faults injected, by kind",
        ("kind",),
    ).inc(kind=kind)
    flight.record(
        f"chaos_{kind}", party=detail.get("party"), session=session,
        **{k: v for k, v in detail.items() if k != "party"},
    )


class ChaosConfig:
    """One deterministic fault schedule, shared by every party of an
    in-process cluster (each party wraps its transport via
    :meth:`wrap`; cross-process deployments parse the same env string
    per worker and stay aligned because decisions never depend on
    process-local state)."""

    def __init__(self, seed: int = 0, drop_send: float = 0.0,
                 delay_ms: float = 0.0, dup_send: float = 0.0,
                 fail_ping: float = 0.0,
                 kill_after_ops: Optional[int] = None,
                 party: Optional[str] = None,
                 max_kills: Optional[int] = 1):
        self.seed = int(seed)
        self.drop_send = float(drop_send)
        self.delay_ms = float(delay_ms)
        self.dup_send = float(dup_send)
        self.fail_ping = float(fail_ping)
        self.kill_after_ops = (
            None if kill_after_ops is None else int(kill_after_ops)
        )
        self.party = party
        # cap on how many times ONE identity dies across the config's
        # lifetime (None = unlimited).  Multi-session supervisors (training
        # epochs) need this: drop/dup schedules self-heal across
        # sessions because they key on STABLE rendezvous keys with
        # attempt counts, but the kill op-budget would otherwise
        # re-trip on every revived worker forever and the supervisor
        # could never converge.  Default 1 = the classic
        # kill-once-stay-dead schedule until a revive.
        self.max_kills = None if max_kills is None else int(max_kills)
        self._lock = threading.Lock()
        # per-rendezvous-key send attempts: retries under a fresh
        # session id land on count 1, 2, ... (session ids are random,
        # so schedules must key on the STABLE rendezvous key instead)
        self._send_count: dict = {}
        self._ping_count: dict = {}
        self._ops: dict = {}  # identity -> networking op count
        self._killed: set = set()  # identities past their kill budget
        self._kill_counts: dict = {}  # identity -> lifetime kill count
        self._kill_hooks: dict = {}  # identity -> callable
        self.faults: list = []  # injected-fault log, in schedule order
        _ACTIVE.add(self)

    # -- parsing -------------------------------------------------------

    @classmethod
    def from_env(cls, value: Optional[str] = None) -> Optional[
            "ChaosConfig"]:
        """Parse ``MOOSE_TPU_CHAOS`` (or an explicit spec string);
        None/empty disables chaos."""
        import os

        if value is None:
            value = os.environ.get("MOOSE_TPU_CHAOS", "")
        value = (value or "").strip()
        if not value:
            return None
        kwargs: dict = {}
        for part in value.split(","):
            if not part.strip():
                continue
            key, sep, raw = part.partition(":")
            key, raw = key.strip(), raw.strip()
            if not sep or not raw:
                raise ConfigurationError(
                    f"MOOSE_TPU_CHAOS entry {part!r}: expected key:value"
                )
            try:
                if key == "seed":
                    kwargs["seed"] = int(raw)
                elif key in ("drop_send", "dup_send", "fail_ping"):
                    p = float(raw)
                    if not 0.0 <= p <= 1.0:
                        raise ValueError(p)
                    kwargs[key] = p
                elif key == "delay_ms":
                    kwargs["delay_ms"] = float(raw)
                elif key == "kill_after_ops":
                    kwargs["kill_after_ops"] = int(raw)
                elif key == "max_kills":
                    kwargs["max_kills"] = int(raw)
                elif key == "party":
                    kwargs["party"] = raw
                else:
                    raise ConfigurationError(
                        f"MOOSE_TPU_CHAOS: unknown knob {key!r}"
                    )
            except (TypeError, ValueError) as e:
                raise ConfigurationError(
                    f"MOOSE_TPU_CHAOS entry {part!r}: bad value"
                ) from e
        return cls(**kwargs)

    # -- deterministic decisions ---------------------------------------

    def _fraction(self, *key_parts) -> float:
        """Uniform [0, 1) fraction, a pure function of (seed, parts)."""
        material = "|".join(str(p) for p in (self.seed,) + key_parts)
        digest = hashlib.blake2b(
            material.encode(), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big") / 2.0 ** 64

    def _applies(self, identity: str) -> bool:
        return self.party is None or self.party == identity

    def _record(self, kind: str, _session: Optional[str] = None,
                **detail) -> None:
        with self._lock:
            self.faults.append({"kind": kind, **detail})
        _observe_fault(kind, detail, session=_session)

    def schedule_digest(self, kinds=None) -> str:
        """Stable digest of the injected-fault log — two runs of the
        same seed over the same computation must agree (the CI
        determinism check compares these).  ``kinds`` restricts the
        digest to fault kinds whose OCCURRENCE COUNT is itself
        deterministic (drop/dup/kill); fail_ping entries scale with how
        many detector rounds ran before the session died, which is
        timing, not schedule."""
        with self._lock:
            entries = [
                sorted(f.items()) for f in self.faults
                if kinds is None or f.get("kind") in kinds
            ]
        # order across concurrent parties is scheduling noise; the
        # SCHEDULE is the set of (kind, key, ...) decisions
        material = repr(sorted(map(repr, entries)))
        return hashlib.blake2b(
            material.encode(), digest_size=16
        ).hexdigest()

    # -- kill plumbing -------------------------------------------------

    def register_kill_hook(self, identity: str, hook) -> None:
        """``hook()`` runs once, when ``identity`` exceeds its op
        budget (the WorkerServer registers a stop-serving callback so
        peers observe a dead endpoint, not a graceful shutdown)."""
        self._kill_hooks[identity] = hook

    def _count_op(self, identity: str,
                  session: Optional[str] = None) -> None:
        if self.kill_after_ops is None or not self._applies(identity):
            return
        fire = False
        with self._lock:
            if identity in self._killed:
                raise NetworkingError(
                    f"chaos: {identity!r} killed (op budget exhausted)"
                )
            if (
                self.max_kills is not None
                and self._kill_counts.get(identity, 0) >= self.max_kills
            ):
                # kill budget for this identity is spent: a revived
                # worker runs clean from here on, so a multi-session
                # supervisor (epoch resume) converges instead of dying at
                # the same op count forever
                return
            n = self._ops.get(identity, 0) + 1
            self._ops[identity] = n
            if n > self.kill_after_ops:
                self._killed.add(identity)
                self._kill_counts[identity] = (
                    self._kill_counts.get(identity, 0) + 1
                )
                self.faults.append({
                    "kind": "kill", "party": identity, "after_ops": n - 1,
                })
                fire = True
        if fire:
            _observe_fault(
                "kill", {"party": identity, "after_ops": n - 1},
                session=session,
            )
            hook = self._kill_hooks.get(identity)
            if hook is not None:
                hook()
            raise NetworkingError(
                f"chaos: {identity!r} killed (op budget exhausted)"
            )

    def revive(self, identity: str) -> None:
        """A restarted worker is alive again: clear the killed latch
        and the op counter (the kill-count survives, so ``max_kills``
        bounds how often the schedule can strike).  WorkerServer.start
        calls this — an in-process 'process restart' shares the config
        object, and without the revive every transport op of the
        restarted identity would keep raising forever."""
        with self._lock:
            self._killed.discard(identity)
            self._ops.pop(identity, None)

    def check_alive(self, identity: str) -> None:
        with self._lock:
            if identity in self._killed:
                raise NetworkingError(
                    f"chaos: {identity!r} killed (op budget exhausted)"
                )

    # -- transport wrapper ---------------------------------------------

    def wrap(self, networking, identity: str):
        return ChaosNetworking(networking, identity, self)


class ChaosNetworking:
    """Transport proxy injecting the configured faults for one
    identity.  Everything not intercepted (cells, verify_sender,
    handle_send_value, activity_for, start/stop, ...) delegates to the
    wrapped transport unchanged, so the proxy composes over
    Local/Tcp/Grpc networking alike."""

    def __init__(self, inner, identity: str, config: ChaosConfig):
        self._inner = inner
        self._identity = identity
        self._config = config

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def send(self, value, receiver: str, rendezvous_key: str,
             session_id: str, **kwargs):
        cfg = self._config
        cfg._count_op(self._identity, session=session_id)
        if not cfg._applies(self._identity):
            return self._inner.send(
                value, receiver, rendezvous_key, session_id, **kwargs
            )
        with cfg._lock:
            count = cfg._send_count.get(rendezvous_key, 0)
            cfg._send_count[rendezvous_key] = count + 1
        if cfg.delay_ms > 0:
            cfg._record(
                "delay", _session=session_id, key=rendezvous_key,
                ms=cfg.delay_ms, party=self._identity,
            )
            time.sleep(cfg.delay_ms / 1000.0)
        # only FIRST attempts drop: a supervisor resubmission reuses
        # the rendezvous key at count >= 1 and must go through, so a
        # finite schedule cannot starve the retry path
        if (
            count == 0
            and cfg.drop_send > 0
            and cfg._fraction("drop_send", rendezvous_key) < cfg.drop_send
        ):
            cfg._record(
                "drop_send", _session=session_id, key=rendezvous_key,
                party=self._identity,
            )
            # fabric transports: the dropped key's replay must not
            # re-enter a permute whose payload was already lost; latch
            # it onto the wire (stable key, so the latch survives the
            # supervisor's fresh session id).  The fault record gains no
            # transport field: a seed's schedule digest is the same with
            # the fabric on or off
            force_wire = getattr(self._inner, "force_wire", None)
            if force_wire is not None:
                force_wire(rendezvous_key)
            return None  # swallowed: the receiver never hears of it
        result = self._inner.send(
            value, receiver, rendezvous_key, session_id, **kwargs
        )
        if (
            cfg.dup_send > 0
            and cfg._fraction("dup_send", rendezvous_key, count)
            < cfg.dup_send
        ):
            cfg._record(
                "dup_send", _session=session_id, key=rendezvous_key,
                party=self._identity,
            )
            self._inner.send(
                value, receiver, rendezvous_key, session_id, **kwargs
            )
        return result

    def send_many(self, items, receiver: str, session_id: str):
        """Decompose a coalesced envelope into per-key sends: every
        fault decision keys on the STABLE rendezvous key and attempt
        count, so a seed's schedule is identical whether the worker
        fast path batched the sends or not (the bit-exact-replay
        contract with worker jit on)."""
        for rendezvous_key, value in items:
            self.send(value, receiver, rendezvous_key, session_id)

    def receive(self, *args, **kwargs):
        self._config.check_alive(self._identity)
        return self._inner.receive(*args, **kwargs)

    def try_receive(self, *args, **kwargs):
        # polled every ~100ms per outstanding key: checked for kill but
        # NOT counted toward the op budget (poll cadence is timing
        # noise; counting it would make the kill point nondeterministic)
        self._config.check_alive(self._identity)
        return self._inner.try_receive(*args, **kwargs)

    def ping(self, receiver: str, **kwargs):
        cfg = self._config
        cfg.check_alive(self._identity)
        if cfg._applies(self._identity) and cfg.fail_ping > 0:
            with cfg._lock:
                count = cfg._ping_count.get(receiver, 0)
                cfg._ping_count[receiver] = count + 1
            if cfg._fraction("fail_ping", receiver, count) < cfg.fail_ping:
                cfg._record(
                    "fail_ping", _session=kwargs.get("session_id"),
                    peer=receiver, party=self._identity, count=count,
                )
                raise NetworkingError(
                    f"chaos: ping to {receiver!r} failed"
                )
        return self._inner.ping(receiver, **kwargs)

    def abort_session(self, *args, **kwargs):
        # a killed worker cannot fan its abort out — that silence is
        # precisely what the peers' failure detectors must cover
        self._config.check_alive(self._identity)
        return self._inner.abort_session(*args, **kwargs)
