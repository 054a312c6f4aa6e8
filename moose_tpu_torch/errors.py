"""Typed error hierarchy (reference: ``moose/src/error.rs:7-59``).

The reference carries a closed ``Error`` enum through every kernel and
session; here the same taxonomy is an exception hierarchy so protocol
invariants survive ``python -O`` (a bare ``assert`` would not) and callers
can catch by failure class.

The port's own copy of ``moose_tpu/errors.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations


class MooseError(Exception):
    """Base class for all moose_tpu errors (reference Error, error.rs:7)."""


class KernelError(MooseError):
    """A kernel was invoked with operands violating its contract
    (reference Error::KernelError)."""


class TypeMismatchError(MooseError, TypeError):
    """Unexpected value/dtype/ring width at a kernel or dispatch boundary
    (reference Error::TypeMismatch)."""


class CompilationError(MooseError):
    """A compiler pass failed (reference Error::Compilation)."""


class MalformedComputationError(CompilationError):
    """The computation graph violates well-formedness (reference
    Error::MalformedComputation / MalformedEnvironment).

    When raised by the static analyzer (``compilation.analysis``), the
    ``diagnostics`` attribute carries the individual
    ``Diagnostic`` findings so callers can inspect rule ids
    programmatically instead of parsing the message."""

    def __init__(self, *args, diagnostics=()):
        super().__init__(*args)
        self.diagnostics = tuple(diagnostics)


class PlanRejectedError(MalformedComputationError):
    """The static schedule analyzer (MSA5xx) proved the compiled worker
    plan would hang — raised by ``worker_plan.get_plan`` at BUILD time
    so the worker demotes to the legacy eager scheduler instead of
    blocking at runtime.  Deterministic (a property of the computation),
    hence never retryable.  Carries ``diagnostics`` like its parent."""


class MissingArgumentError(MooseError, KeyError):
    """An Input op had no bound argument at evaluation time."""


class NetworkingError(MooseError):
    """Transport-level send/receive failure (reference Error::Networking)."""


class ReceiveTimeoutError(NetworkingError, TimeoutError):
    """A blocking receive expired without its payload arriving.  A
    DISTINCT class so transports can retry/poll on timeouts without
    string-matching error messages (which silently breaks when wording
    changes)."""


class AuthorizationError(NetworkingError):
    """A peer rejected the request on identity grounds (mTLS CN
    mismatch, unauthorized choreographer — gRPC PERMISSION_DENIED).
    Permanent: resubmitting the same credentials can never succeed, so
    the session supervisor must NOT retry it."""


class PeerUnreachableError(NetworkingError):
    """The failure detector tripped: a session peer stopped answering
    pings for the configured miss budget.  Retryable — the peer may be
    restarting or the partition transient."""


class StorageError(MooseError, KeyError):
    """Load/Save against a storage backend failed (reference
    Error::Storage)."""


class SessionAlreadyExistsError(MooseError):
    """A session id was launched twice on one worker (reference
    Error::SessionAlreadyExists, execution/asynchronous.rs:571-576)."""


class SessionAbortedError(MooseError):
    """A session was cancelled (choreographer abort, peer abort fanout, or
    failure-detector trip) rather than failing on its own work.  Receivers
    of this error must NOT re-fan-out an abort: the initiator already did
    (reference root-cause discipline, execution/asynchronous.rs:27-74)."""


class UnimplementedError(MooseError, NotImplementedError):
    """Operator/placement combination not supported (reference
    Error::UnimplementedOperator)."""


class ConfigurationError(MooseError, ValueError):
    """Invalid runtime/session configuration."""


class ReplicaDrainingError(MooseError):
    """The serving replica is draining (graceful shutdown in progress)
    or shut down before the request was served: admission is closed and
    queued requests are completed with this error instead of being
    evaluated.  RETRYABLE by the taxonomy — the request was never
    executed, so resubmitting it to ANOTHER replica (the ``donner``
    router does this automatically) succeeds without double-evaluation
    risk.  Surfaces over HTTP as ``503`` with a ``Retry-After``
    header."""


class CheckpointError(StorageError):
    """A secret-shared training checkpoint was rejected: torn commit,
    checksum/tamper mismatch, stale or missing generation, format or
    fixed-keys discipline mismatch.  NON-retryable — replaying the same
    session against the same bad checkpoint deterministically fails;
    the training supervisor instead falls back to the previous valid
    generation (or surfaces the error when none exists)."""


class SnapshotError(MooseError):
    """A warm-state snapshot could not be written, or an on-disk
    snapshot failed validation at load time (format-version skew,
    checksum mismatch, model-set mismatch, or a bit-exactness probe
    divergence under ``MOOSE_TPU_FIXED_KEYS``).  Loaders treat this as
    "no snapshot": the replica falls back to a fresh registration
    instead of serving from suspect state."""


class ServerOverloadedError(MooseError):
    """The serving layer's bounded request queue is full (admission
    control, ``moose_tpu/serving``): the request was REJECTED, not
    queued.  Raised synchronously at submit time so callers shed load
    instead of hanging; retryable by the taxonomy — backing off and
    resubmitting can succeed once the queue drains."""


class DeadlineExceededError(MooseError, TimeoutError):
    """A serving request's deadline expired before its result was
    produced.  Requests already expired when their batch is assembled
    are dropped WITHOUT being evaluated (an expired request never
    occupies batch rows); requests that expire mid-evaluation surface
    this error after the fact and count as a deadline miss in serving
    telemetry."""


# ---------------------------------------------------------------------------
# Typed wire errors: structured envelopes for the distributed runtime.
#
# The reference stringifies errors at the session boundary (its abort
# handler is unimplemented!(), choreography/grpc.rs:200); here a failure
# crosses the wire as a small msgpack-able dict so the CLIENT re-raises
# the real typed exception and the session supervisor can tell transient
# faults (resubmit) from permanent ones (surface immediately).
# ---------------------------------------------------------------------------

# Classes whose failures can be healed by resubmitting the computation
# under a fresh session id: transport faults, receive timeouts, detector
# trips, and adopted aborts whose root cause never reached us.  Anything
# authorization-shaped is excluded — same credentials, same rejection.
_PERMANENT_NETWORKING = (AuthorizationError,)


def is_retryable(exc: BaseException) -> bool:
    """True when resubmitting the same (computation, arguments) under a
    fresh session id can plausibly succeed.  Sessions are pure functions
    of their inputs and replay protection drops stale traffic for old
    ids, so the supervisor may replay any *transient* failure; compile
    and type errors (and PERMISSION_DENIED) are deterministic and must
    surface immediately."""
    if isinstance(exc, _PERMANENT_NETWORKING):
        return False
    return isinstance(
        exc,
        (
            NetworkingError,
            SessionAbortedError,
            ServerOverloadedError,
            ReplicaDrainingError,
        ),
    )


def _class_registry() -> dict:
    return {
        cls.__name__: cls
        for cls in list(globals().values())
        if isinstance(cls, type) and issubclass(cls, MooseError)
    }


def _cause_chain(exc: BaseException, limit: int = 8) -> list:
    """[{class, message}] for the __cause__/__context__ chain below
    ``exc`` (nearest first), bounded so a pathological chain cannot
    bloat the wire frame."""
    chain = []
    seen = {id(exc)}
    cur = exc.__cause__ or exc.__context__
    while cur is not None and len(chain) < limit and id(cur) not in seen:
        seen.add(id(cur))
        chain.append({
            "class": type(cur).__name__,
            "message": str(cur),
        })
        cur = cur.__cause__ or cur.__context__
    return chain


def to_wire(exc: BaseException, party: str = "") -> dict:
    """Encode an exception as a wire envelope: error class, originating
    party, root-cause chain, and the retryable bit derived from the
    taxonomy.  msgpack-able (strings/bools only)."""
    return {
        "class": type(exc).__name__,
        "message": str(exc),
        "party": party,
        "retryable": bool(is_retryable(exc)),
        "chain": _cause_chain(exc),
    }


def from_wire(envelope: dict) -> MooseError:
    """Decode an envelope back into a typed exception.  The class is
    resolved by name against this module's taxonomy; a class the local
    build does not know (version skew, non-Moose root cause) degrades to
    :class:`NetworkingError` with the original name preserved in the
    message.  The instance carries ``party`` / ``retryable`` /
    ``wire_chain`` attributes for programmatic inspection."""
    name = envelope.get("class", "NetworkingError")
    cls = _class_registry().get(name)
    message = envelope.get("message", "")
    party = envelope.get("party", "")
    if cls is None:
        message = f"{name}: {message}"
        cls = NetworkingError
    if party:
        message = f"{message} (party {party})"
    exc = cls(message)
    exc.party = party
    # trust the wire bit over local re-derivation: the ORIGINATOR'S
    # taxonomy classified the live exception (a degraded unknown class
    # would otherwise flip permanent -> retryable)
    exc.retryable = bool(envelope.get("retryable", False))
    exc.wire_chain = tuple(
        (c.get("class", ""), c.get("message", ""))
        for c in envelope.get("chain") or ()
    )
    return exc
