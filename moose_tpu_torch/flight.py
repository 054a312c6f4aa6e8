"""Session flight recorder: a bounded ring of structured events for
postmortems.

The port's own copy of ``moose_tpu/flight.py`` (framework-neutral: json,
os, threading and time only), with the same event kinds and knobs, so a
reader of either package's events reads the same records.  Every
process keeps a bounded ring buffer of structured events (the training
supervisor's epochs, resumes and control retries, the checkpoint
store's commits and rejected generations), each stamped with a
wall-clock time, a per-recorder sequence number, the party that
recorded it and the session it belongs to.

- ``MOOSE_TPU_FLIGHT=/path/events.jsonl`` additionally streams every
  event as one JSON line for offline debugging (append-only; write
  errors are swallowed — the recorder must never fail the session it
  exists to explain).
- ``MOOSE_TPU_FLIGHT_CAP`` bounds the ring (default 2048 events).

Events are plain dicts so they serialize over msgpack/JSON unchanged::

    {"seq": 17, "ts": 1754..., "mono": 812.44, "kind": "send",
     "party": "alice", "session": "ab12...", "receiver": "bob",
     "keys": 3}

``ts`` is wall-clock (human-readable, comparable across hosts to clock
skew); ``mono`` is the process monotonic clock — exact ORDER within one
process regardless of NTP steps, which is what postmortems of ring
events need.

Pretty-print a JSONL dump (one line per event, aligned, sorted)::

    python -m moose_tpu_torch.flight events.jsonl [--session S] [--party P]
        [--kind K] [--tail N]
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Iterable, List, Optional

_DEFAULT_CAP = 2048


class FlightRecorder:
    """Bounded in-memory event ring, optionally streamed as JSONL."""

    def __init__(self, capacity: Optional[int] = None,
                 stream_path: Optional[str] = None):
        if capacity is None:
            raw = os.environ.get("MOOSE_TPU_FLIGHT_CAP", "")
            try:
                capacity = int(raw) if raw else _DEFAULT_CAP
            except ValueError:
                capacity = _DEFAULT_CAP
        self.capacity = max(16, int(capacity))
        self._events: "deque[dict]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._stream_path = (
            stream_path
            if stream_path is not None
            else os.environ.get("MOOSE_TPU_FLIGHT") or None
        )
        self._stream = None
        self._stream_failed = False

    # -- producer side -------------------------------------------------

    def record(self, kind: str, party: Optional[str] = None,
               session: Optional[str] = None, **fields) -> dict:
        """Append one event; returns it.  Never raises: the recorder
        exists to explain failures, not to cause them."""
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": time.time(),
                # monotonic clock alongside wall time: wall clocks skew
                # across parties, so cross-party event ORDER (ring
                # events especially) keys on this within one host and
                # on per-party (mono, seq) lanes across hosts
                "mono": time.monotonic(),
                "kind": str(kind),
            }
            if party is not None:
                event["party"] = party
            if session is not None:
                event["session"] = session
            event.update(fields)
            self._events.append(event)
            self._write_stream_locked(event)
        return event

    def _write_stream_locked(self, event: dict) -> None:
        if self._stream_path is None or self._stream_failed:
            return
        try:
            if self._stream is None:
                self._stream = open(  # noqa: SIM115 — long-lived stream
                    self._stream_path, "a", encoding="utf-8"
                )
            self._stream.write(json.dumps(event, default=str) + "\n")
            self._stream.flush()
        except OSError:
            # a bad path / full disk must not take the session down;
            # one warning's worth of state, then stay silent
            self._stream_failed = True

    # -- consumer side -------------------------------------------------

    def events(self, session: Optional[str] = None,
               sessions: Optional[Iterable[str]] = None,
               party: Optional[str] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Recent events, oldest first, optionally filtered by session
        id(s) and/or party; ``limit`` keeps only the newest N after
        filtering."""
        wanted = set(sessions) if sessions is not None else None
        if session is not None:
            wanted = (wanted or set()) | {session}
        with self._lock:
            out = [
                dict(e) for e in self._events
                if (wanted is None or e.get("session") in wanted)
                and (party is None or e.get("party") == party)
            ]
        if limit is not None:
            out = out[-int(limit):]
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def close(self) -> None:
        with self._lock:
            if self._stream is not None:
                try:
                    self._stream.close()
                except OSError:
                    pass
                self._stream = None


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-global recorder (created lazily so the env knobs are
    read on first use, matching the telemetry exporter discipline)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, party: Optional[str] = None,
           session: Optional[str] = None, **fields) -> dict:
    """Record on the process-global recorder."""
    return get_recorder().record(
        kind, party=party, session=session, **fields
    )


def configure(capacity: Optional[int] = None,
              stream_path: Optional[str] = None) -> FlightRecorder:
    """Replace the global recorder (tests / bins that want an explicit
    stream path instead of the env knob)."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = FlightRecorder(
            capacity=capacity, stream_path=stream_path
        )
        return _recorder


# ---------------------------------------------------------------------------
# JSONL pretty-printer: python -m moose_tpu_torch.flight events.jsonl
# ---------------------------------------------------------------------------

_CORE_FIELDS = ("seq", "ts", "mono", "kind", "party", "session")


def format_event(event: dict) -> str:
    """One aligned human line per event: clock columns, then kind /
    party / session, then every extra field as key=value."""
    import datetime

    ts = event.get("ts")
    when = (
        datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S.%f")[:-3]
        if isinstance(ts, (int, float))
        else "?"
    )
    mono = event.get("mono")
    mono_s = f"{mono:14.6f}" if isinstance(mono, (int, float)) else " " * 14
    session = event.get("session") or "-"
    extras = " ".join(
        f"{k}={json.dumps(v, default=str)}"
        for k, v in event.items()
        if k not in _CORE_FIELDS
    )
    return (
        f"{event.get('seq', '?'):>6} {when} {mono_s} "
        f"{event.get('party') or '-':<10} "
        f"{event.get('kind', '?'):<18} {session[:12]:<12} {extras}"
    ).rstrip()


def _sort_key_fn(events):
    # per-party monotonic lanes order exactly; across parties the lanes
    # interleave by wall clock (skew-limited), with seq as tiebreaker.
    # Each party's mono clock is mapped onto the wall timeline with one
    # constant offset (median of wall - mono, robust to an NTP step
    # mid-run), so a wall-clock correction can never reorder a party's
    # own events.
    offsets: dict = {}
    for e in events:
        mono = e.get("mono")
        if isinstance(mono, (int, float)) and "ts" in e:
            offsets.setdefault(e.get("party"), []).append(e["ts"] - mono)
    medians = {
        party: sorted(deltas)[len(deltas) // 2]
        for party, deltas in offsets.items()
    }

    def key(event: dict):
        mono = event.get("mono")
        ts = event.get("ts", 0)
        if isinstance(mono, (int, float)):
            offset = medians.get(event.get("party"))
            if offset is not None:
                ts = offset + mono
        return (ts, event.get("seq", 0))

    return key


def main(argv=None) -> int:
    """Pretty-print a MOOSE_TPU_FLIGHT JSONL dump."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m moose_tpu_torch.flight",
        description="pretty-print a flight-recorder JSONL dump",
    )
    parser.add_argument("path", help="events.jsonl (MOOSE_TPU_FLIGHT)")
    parser.add_argument("--session", default=None,
                        help="only events of this session id")
    parser.add_argument("--party", default=None,
                        help="only events recorded by this party")
    parser.add_argument("--kind", default=None,
                        help="only events of this kind")
    parser.add_argument("--tail", type=int, default=None, metavar="N",
                        help="only the newest N events after filtering")
    args = parser.parse_args(argv)

    events = []
    bad = 0
    with open(args.path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                bad += 1  # torn tail line of a crashed writer
    events = [
        e for e in events
        if (args.session is None or e.get("session") == args.session)
        and (args.party is None or e.get("party") == args.party)
        and (args.kind is None or e.get("kind") == args.kind)
    ]
    events.sort(key=_sort_key_fn(events))
    if args.tail is not None:
        events = events[-args.tail:] if args.tail > 0 else []
    print(
        f"{'seq':>6} {'wall':<12} {'mono':>14} {'party':<10} "
        f"{'kind':<18} {'session':<12} fields"
    )
    for event in events:
        print(format_event(event))
    if bad:
        print(f"# skipped {bad} unparseable line(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
