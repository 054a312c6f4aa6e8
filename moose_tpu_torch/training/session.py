"""The training epoch supervisor.

The port's own copy of ``moose_tpu/training/session.py``.  Runs N epochs
as N successive sessions and owns the checkpoint commit protocol and
epoch-granular recovery.

Per epoch:

1. **pin** every party's reads to the last fully-committed epoch
   (durable: a party restarted mid-epoch keeps reading the generation
   the driver chose even if its own CURRENT has advanced);
2. run the epoch session (``load_shares`` -> SGD steps ->
   ``save_shares``, staged in memory on each party);
3. on success, **commit** on every party (the staged arrays become a
   durable generation, atomically published via the CURRENT pointer).

A retryable failure anywhere (a peer unreachable, a commit fanout that
only partially landed) backs off (capped exponential), re-queries every
party's committed state, and resumes from the newest epoch committed by
all parties.  Committed epochs are never replayed; an epoch whose commit
only reached a subset of parties is re-run from the common base (the
subset re-commits: a new generation, same epoch, which is why checkpoint
retention keeps the previous epoch alive).  Under
``MOOSE_TPU_FIXED_KEYS`` the whole recovery is bit-exact: a resumed run
produces final weights bit-identical to an uninterrupted one.

Flight events: ``epoch_start`` / ``epoch_committed`` /
``epoch_resumed`` (+ the checkpoint store's ``checkpoint_committed`` /
``checkpoint_invalid``); metrics: ``moose_tpu_training_*``; the JAX
package's names, so both packages' records read alike.

:class:`LocalTrainingCluster` runs the sessions on a
``LocalMooseRuntime``.  The distributed adapter,
:class:`GrpcTrainingCluster`, needs the port's ``distributed/``
(ROADMAP queue 1, item 12) and raises until then.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, Optional

from .. import flight as flight_mod
from .. import metrics as metrics_mod
from ..errors import CheckpointError, MooseError, is_retryable

_METRICS: Optional[Dict[str, Any]] = None


def _metrics() -> Dict[str, Any]:
    global _METRICS
    if _METRICS is None:
        _METRICS = {
            "epochs": metrics_mod.counter(
                "moose_tpu_training_epochs_total",
                "training epochs, by outcome",
                ("outcome",),
            ),
            "resumes": metrics_mod.counter(
                "moose_tpu_training_resumes_total",
                "epoch re-runs after a retryable mid-epoch failure "
                "(resumed from the last committed checkpoint)",
            ),
            "runs": metrics_mod.counter(
                "moose_tpu_training_runs_total",
                "training runs, by outcome",
                ("outcome",),
            ),
            "epoch_s": metrics_mod.histogram(
                "moose_tpu_training_epoch_seconds",
                "wall seconds per committed epoch (session + commit)",
            ),
        }
    return _METRICS


def _retryable(exc: BaseException) -> bool:
    wire_bit = getattr(exc, "retryable", None)
    return bool(wire_bit) if wire_bit is not None else is_retryable(exc)


@dataclasses.dataclass
class TrainingConfig:
    epochs: int = 3
    # epoch-level recovery budget (a distributed client's session
    # supervisor has its own per-session retry budget underneath)
    max_epoch_attempts: int = 5
    backoff_base_s: float = 0.25
    backoff_cap_s: float = 2.0
    session_timeout_s: float = 120.0
    # export the trained weights (a reveal-to-bob session) at the end
    export: bool = True


class LocalTrainingCluster:
    """In-process adapter: a LocalMooseRuntime whose per-party storages
    are :class:`~moose_tpu_torch.training.checkpoint.CheckpointStore`
    objects."""

    def __init__(self, runtime: Any, parties: Any) -> None:
        self.runtime = runtime
        self.parties = list(parties)
        for party in self.parties:
            store = runtime.storage.get(party)
            if not hasattr(store, "checkpoint_control"):
                raise CheckpointError(
                    f"party {party!r}: LocalMooseRuntime storage must "
                    "be a CheckpointStore (pass storage_mapping="
                    "{party: CheckpointStore(...)})"
                )

    def run(self, comp: Any, arguments: Any, timeout: float) -> Any:
        return self.runtime.evaluate_computation(
            comp, arguments=arguments
        )

    def control(self, party: str, cmd: str, **args: Any) -> Any:
        return self.runtime.storage[party].checkpoint_control(cmd, args)


class GrpcTrainingCluster:
    """Distributed adapter: sessions over gRPC workers, checkpoint
    control through the choreography StorageControl rpc.  The port has
    no ``distributed/`` yet (ROADMAP queue 1, item 12)."""

    def __init__(self, client: Any,
                 parties: Optional[list] = None) -> None:
        raise NotImplementedError(
            "GrpcTrainingCluster needs the port's distributed/ (gRPC "
            "workers and the StorageControl rpc): ROADMAP queue 1, item 12"
        )


class TrainingSession:
    """Supervised, checkpointed, resumable multi-epoch secure training
    of one ``predictors.trainers.SecureTrainer`` model."""

    def __init__(self, trainer: Any, cluster: Any,
                 config: Optional[TrainingConfig] = None) -> None:
        self.trainer = trainer
        self.cluster = cluster
        self.config = config or TrainingConfig()
        # outcome of the most recent run(): epochs run/skipped/resumed,
        # per-epoch attempts, final committed epoch — the training
        # mirror of the client's last_session_report
        self.last_report: dict = {}

    # -- party control fanout -------------------------------------------

    def _control_all(self, cmd: str, **args: Any) -> dict:
        return {
            party: self.cluster.control(party, cmd, **args)
            for party in self.cluster.parties
        }

    def _common_committed(self) -> Optional[int]:
        """The newest epoch committed (and still valid) on EVERY party
        — the only state the protocol may resume from."""
        queries = self._control_all("query")
        common: Optional[int] = None
        sets = [set(q["epochs"]) for q in queries.values()]
        inter = set.intersection(*sets) if sets else set()
        if inter:
            common = max(inter)
        return common

    def _with_retries(self, fn: Callable[[], Any], what: str) -> Any:
        """Retryable-failure envelope for control-plane steps OUTSIDE
        the epoch loop (queries, the final unpin, the export session):
        a worker mid-restart answers UNAVAILABLE for a second or two,
        and that must not abort a training run whose state is already
        durably committed."""
        cfg = self.config
        for attempt in range(1, cfg.max_epoch_attempts + 1):
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — classified
                if not _retryable(exc) or attempt >= (
                    cfg.max_epoch_attempts
                ):
                    raise
                flight_mod.record(
                    "training_control_retry", party="trainer",
                    what=what, attempt=attempt,
                    error=f"{type(exc).__name__}: {exc}",
                )
                delay = min(
                    cfg.backoff_cap_s,
                    cfg.backoff_base_s * 2 ** (attempt - 1),
                )
                time.sleep(delay + random.uniform(0, delay / 2))

    def _commit_all(self, epoch: int) -> None:
        expected = self.trainer.expected_staged()
        self._control_all(
            "commit", epoch=epoch, expected=expected,
            meta={"model": self.trainer.checkpoint_key},
        )

    # -- the supervisor loop --------------------------------------------

    def run(self, x: Any, y: Any,
            epochs: Optional[int] = None) -> dict:
        """Train to ``epochs`` (default ``config.epochs``) committed
        epochs, resuming from whatever is already durably committed.
        The override is the continuous-training lever: the control
        plane calls ``run(x, y, epochs=N * epochs_per_generation)``
        with a growing cumulative target, so each generation inherits
        the committed state (and the mid-epoch resume machinery) of the
        last.  Returns the report dict (also kept as ``last_report``);
        trained weights under ``"weights"`` when ``config.export``."""
        cfg = self.config
        target_epochs = cfg.epochs if epochs is None else int(epochs)
        trainer = self.trainer
        import numpy as np

        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n_rows = x.shape[0]
        report: dict = {
            "ok": False,
            "target_epochs": target_epochs,
            "epochs_committed": [],
            "epochs_skipped": [],
            "resumes": 0,
            "attempts": {},
        }
        self.last_report = report

        base = self._with_retries(self._common_committed, "query")
        if base is None:
            # bootstrap: share + persist the initial weights as the
            # epoch-0 checkpoint (one session, committed like an epoch)
            init_args = {
                name: self._initial_value(name, shape)
                for name, shape in trainer.state_shapes.items()
            }
            self._run_epoch(
                report, epoch=0,
                comp=trainer.init_computation(),
                arguments=init_args,
            )
            base = 0
        elif base > target_epochs:
            raise CheckpointError(
                f"checkpoint is already at epoch {base}, beyond the "
                f"requested {target_epochs}"
            )
        else:
            report["epochs_skipped"] = list(range(1, base + 1))

        epoch_comp = trainer.epoch_computation(n_rows)
        while base < target_epochs:
            target = base + 1
            self._run_epoch(
                report, epoch=target, comp=epoch_comp,
                arguments={"x": x, "y": y},
            )
            new_base = self._with_retries(
                self._common_committed, "post_epoch_query"
            )
            if new_base is None or new_base < target:
                raise CheckpointError(
                    f"epoch {target} commit did not land on all "
                    f"parties (common committed: {new_base})"
                )
            base = new_base

        # training is durable; drop the pin so later readers see the
        # newest committed state
        self._with_retries(
            lambda: self._control_all("pin", epoch=None), "unpin"
        )
        report["final_epoch"] = base
        report["ok"] = True
        if cfg.export:
            outputs = self._with_retries(
                lambda: self.cluster.run(
                    trainer.export_computation(), {},
                    timeout=cfg.session_timeout_s,
                ),
                "export",
            )
            report["weights"] = trainer.unpack_export(outputs)
        _metrics()["runs"].inc(outcome="ok")
        return report

    def _initial_value(self, name: str, shape: Any) -> Any:
        """Deterministic small init (the model owner would supply real
        initial weights; trainers may override via ``initial_weights``
        attribute)."""
        import numpy as np

        override = getattr(self.trainer, "initial_weights", None)
        if override is not None and name in override:
            return np.asarray(override[name], dtype=np.float64)
        # hashlib, NOT hash(): Python string hashing is salted per
        # process, and a driver relaunched after a pre-commit crash
        # must regenerate the IDENTICAL bootstrap weights or the
        # bit-exact-resume contract silently breaks across processes
        import hashlib

        digest = hashlib.blake2b(
            f"{self.trainer.checkpoint_key}|{name}".encode(),
            digest_size=4,
        ).digest()
        rng = np.random.default_rng(int.from_bytes(digest, "big"))
        return rng.normal(size=shape) * 0.1

    def _run_epoch(self, report: dict, epoch: int, comp: Any,
                   arguments: Any) -> None:
        """One epoch (or the init bootstrap) with epoch-level recovery:
        pin -> session -> commit, retrying retryable failures from the
        re-queried common committed state."""
        cfg = self.config
        attempts = 0
        resumed = False
        while True:
            attempts += 1
            report["attempts"][epoch] = attempts
            t0 = time.monotonic()
            try:
                self._control_all("discard")
                if epoch > 0:
                    # parties may hold newer (partially-committed)
                    # generations after a failed commit fanout: every
                    # read of this session MUST come from the common
                    # base, durably, even across a worker restart
                    self._control_all("pin", epoch=epoch - 1)
                if resumed:
                    _metrics()["resumes"].inc()
                    report["resumes"] += 1
                    flight_mod.record(
                        "epoch_resumed", party="trainer", epoch=epoch,
                        attempt=attempts,
                        from_epoch=epoch - 1 if epoch > 0 else None,
                    )
                flight_mod.record(
                    "epoch_start", party="trainer", epoch=epoch,
                    attempt=attempts,
                )
                self.cluster.run(
                    comp, arguments, timeout=cfg.session_timeout_s
                )
                self._commit_all(epoch)
            except Exception as exc:  # noqa: BLE001 — classified below
                _metrics()["epochs"].inc(outcome="failed")
                flight_mod.record(
                    "epoch_failed", party="trainer", epoch=epoch,
                    attempt=attempts,
                    error=f"{type(exc).__name__}: {exc}",
                    retryable=_retryable(exc),
                )
                if not _retryable(exc) or attempts >= (
                    cfg.max_epoch_attempts
                ):
                    _metrics()["runs"].inc(outcome="failed")
                    raise
                resumed = True
                delay = min(
                    cfg.backoff_cap_s,
                    cfg.backoff_base_s * 2 ** (attempts - 1),
                )
                time.sleep(delay + random.uniform(0, delay / 2))
                # a party may have committed this epoch before the
                # failure hit the others: never replay a FULLY
                # committed epoch.  The query itself may hit a
                # still-dead worker — treat that as "unknown" and let
                # the next attempt's control calls retry it
                try:
                    committed = self._common_committed()
                except Exception as query_exc:  # noqa: BLE001
                    if not _retryable(query_exc):
                        raise
                    committed = None
                if committed is not None and committed >= epoch:
                    report["epochs_committed"].append(epoch)
                    return
                continue
            _metrics()["epochs"].inc(outcome="committed")
            _metrics()["epoch_s"].observe(time.monotonic() - t0)
            flight_mod.record(
                "epoch_committed", party="trainer", epoch=epoch,
                attempt=attempts,
            )
            report["epochs_committed"].append(epoch)
            return
