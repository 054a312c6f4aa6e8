"""Runtime PRF-draw accounting: the dynamic half of the MSA8xx oracle.

The keystream analysis (:mod:`moose_tpu_torch.compilation.analysis.keystream`)
derives per-(party, key) draw sequences *statically* from the graph; this
module counts what the runtime *actually* draws so the two can be asserted
equal (the draw oracle, ``tests/test_torch_keystream.py``).  Every
bit-exactness guarantee in the system — kernels-on/off identity, snapshot
probe digests, chaos-replay determinism — rests on the invariant that each
execution path consumes each party's PRF streams in the same order from the
correct keys; the oracle is what turns that from convention into a checked
property.

Instrumented choke points:

- :class:`~moose_tpu_torch.execution.session.EagerSession`
  ``sample_*_seeded`` — the per-host layout (the logical dialects and
  the physical executor's lowered plans both funnel through it).
- :meth:`~moose_tpu_torch.parallel.spmd.SpmdSession.sample_group` — the
  party-stacked layout: one event per draw of a group, in the group's
  order, recorded before the group is expanded (one K7 launch on the
  card).

Recording is opt-in and nestable; with no active ledger the hooks are a
single ``if not _LEDGERS`` test, so hot paths pay nothing.  Events carry
Python-level metadata only (placement, key origin, element count) — no
array values — so recording works unchanged on ``meta`` tensors, where
nothing is computed: the static side of the stacked model IS such a
shape-only replay (``compilation.analysis.keystream.stacked_draw_trace``).

The port's own copy of ``moose_tpu/execution/drawledger.py``:
framework-neutral, it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Any, Iterator, Optional


@dataclasses.dataclass(frozen=True)
class DrawEvent:
    """One PRF stream consumption.

    ``layout`` is ``"host"`` (per-host seeded draws) or ``"stacked"``
    (party-stacked session banks).  ``key`` identifies the key lineage:
    the producing op name / session key index for the host layout, the
    ``("master", domain)`` pair for stacked sessions.  ``sync`` is the
    derivation nonce (hex) when one exists.  ``elems`` counts drawn
    elements (for stacked banks: per party slice, excluding the leading
    party axis).  ``op`` is the graph op under execution when the
    interpreter tagged one.
    """

    layout: str
    kind: str  # "ring" | "bits" | "bit_tensor" | "bank" | "sample" | "bit_bank"
    placement: Optional[str]
    key: Any
    sync: Optional[str]
    elems: int
    width: Optional[int]
    op: Optional[str] = None


class DrawLedger:
    """Accumulates :class:`DrawEvent` records for one recording scope."""

    def __init__(self) -> None:
        self.events: list[DrawEvent] = []
        self.current_op: Optional[str] = None

    def record(self, event: DrawEvent) -> None:
        if event.op is None and self.current_op is not None:
            event = dataclasses.replace(event, op=self.current_op)
        self.events.append(event)

    # -- aggregation views used by the oracle ------------------------------

    def host_report(self) -> dict:
        """Per-(placement, key) counts, same shape as the static MSA805
        report's ``per_party_key`` section."""
        out: dict = {}
        for e in self.events:
            if e.layout != "host":
                continue
            slot = out.setdefault(
                (e.placement, _key_label(e.key)),
                {"draws": 0, "elems": 0, "ring_draws": 0, "bit_draws": 0},
            )
            slot["draws"] += 1
            slot["elems"] += e.elems
            if e.kind == "ring":
                slot["ring_draws"] += 1
            else:
                slot["bit_draws"] += 1
        return out

    def stacked_trace(self) -> list[tuple]:
        """The ordered (kind, width, elems) draw sequence of the stacked
        session — the stream-position ledger the oracle compares against
        the static shape-domain trace."""
        return [
            (e.kind, e.width, e.elems)
            for e in self.events
            if e.layout == "stacked"
        ]

    def stacked_counts(self) -> dict:
        out: dict = {"bank": 0, "sample": 0, "bit_bank": 0}
        for e in self.events:
            if e.layout == "stacked":
                out[e.kind] = out.get(e.kind, 0) + 1
        return out


def _key_label(key: Any) -> str:
    """Normalize key origins to a stable string label."""
    if isinstance(key, tuple):
        return ":".join(str(p) for p in key)
    return str(key)


# ---------------------------------------------------------------------------
# Recording scopes
# ---------------------------------------------------------------------------

_LEDGERS: list[DrawLedger] = []


def active() -> Optional[DrawLedger]:
    """The innermost active ledger, or None (the fast-path probe)."""
    return _LEDGERS[-1] if _LEDGERS else None


@contextmanager
def recording() -> Iterator[DrawLedger]:
    ledger = DrawLedger()
    _LEDGERS.append(ledger)
    try:
        yield ledger
    finally:
        _LEDGERS.remove(ledger)


# ---------------------------------------------------------------------------
# Hooks (called from the instrumented sessions; no-ops unless recording)
# ---------------------------------------------------------------------------


def _elems(shape: Any) -> int:
    try:
        return int(math.prod(int(d) for d in tuple(shape)))
    except (TypeError, ValueError):
        return 0


def record_host_draw(placement: str, seed: Any, kind: str, shape: Any,
                     width: Optional[int]) -> None:
    if not _LEDGERS:
        return
    origin = getattr(seed, "origin", None)
    key, sync = (origin if isinstance(origin, tuple) and len(origin) == 2
                 else (origin, None))
    event = DrawEvent(
        layout="host", kind=kind, placement=placement,
        key=key if key is not None else "<untracked>",
        sync=sync.hex() if isinstance(sync, bytes) else sync,
        elems=_elems(shape), width=width,
    )
    for ledger in _LEDGERS:
        ledger.record(event)


def record_stacked_draw(kind: str, shape: Any, width: Optional[int]) -> None:
    if not _LEDGERS:
        return
    event = DrawEvent(
        layout="stacked", kind=kind, placement=None,
        key="master", sync=None, elems=_elems(shape), width=width,
    )
    for ledger in _LEDGERS:
        ledger.record(event)


def tag_op(name: Optional[str]) -> None:
    """Label subsequent draws with the graph op under execution (set by
    the interpreter op walks when a ledger is active)."""
    for ledger in _LEDGERS:
        ledger.current_op = name
