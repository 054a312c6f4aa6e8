"""Communication analysis over post-networking graphs (``MSA2xx``).

After the networking pass, every cross-host edge is a Send/Receive pair
stitched by a rendezvous key; the async workers block on those keys at
runtime, so a malformed pairing is a hang (or a value delivered to the
wrong party), not a crash.  These rules make the rendezvous structure
machine-checkable: every key pairs exactly one Send with exactly one
Receive, the sender/receiver attributes agree with the actual placements,
and no wait cycle runs through Send→Receive edges.

Rules:

- ``MSA201`` (error): unpaired rendezvous — a Receive with no matching
  Send (would block forever) or a Send with no matching Receive (value
  never drained).
- ``MSA202`` (error): duplicated rendezvous key among Sends or among
  Receives (the second transfer silently races the first).
- ``MSA203`` (error): Send/Receive attribute inconsistency — missing
  ``rendezvous_key``/``receiver``/``sender`` attributes, attributes
  naming unknown placements, or a pair whose declared endpoints disagree
  with the ops' actual placements.
- ``MSA204`` (error): wait cycle through Send→Receive edges — the async
  workers would deadlock waiting on each other.

On graphs with no Send/Receive ops (pre-networking) the analysis is a
no-op, so it is safe to run unconditionally.

The port's own copy of
``moose_tpu/compilation/analysis/communication.py``: pure graph and numpy
code, it imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict

from ...computation import Computation, Operation
from ..well_formed import rendezvous_attr_problems
from .diagnostics import Diagnostic, Severity


def analyze_communication(comp: Computation) -> list[Diagnostic]:
    diagnostics: list[Diagnostic] = []
    sends: dict[str, list] = defaultdict(list)
    receives: dict[str, list] = defaultdict(list)

    def check_attrs(op: "Operation") -> bool:
        # same contract the fail-fast well_formed_check enforces,
        # collected instead of raised
        for problem in rendezvous_attr_problems(op, comp.placements):
            diagnostics.append(Diagnostic(
                "MSA203", Severity.ERROR, problem,
                op=op.name, placement=op.placement_name,
            ))
        # only a keyed op can participate in pairing
        return "rendezvous_key" in op.attributes

    for op in comp.operations.values():
        if op.kind in ("Send", "Receive"):
            if check_attrs(op):
                group = sends if op.kind == "Send" else receives
                group[op.attributes["rendezvous_key"]].append(op)

    for key, ops in sends.items():
        if len(ops) > 1:
            diagnostics.append(Diagnostic(
                "MSA202", Severity.ERROR,
                f"rendezvous key {key!r} used by {len(ops)} Send ops: "
                f"{[o.name for o in ops]}",
                op=ops[1].name, placement=ops[1].placement_name,
            ))
    for key, ops in receives.items():
        if len(ops) > 1:
            diagnostics.append(Diagnostic(
                "MSA202", Severity.ERROR,
                f"rendezvous key {key!r} used by {len(ops)} Receive ops: "
                f"{[o.name for o in ops]}",
                op=ops[1].name, placement=ops[1].placement_name,
            ))

    for key, ops in receives.items():
        if key not in sends:
            for op in ops:
                diagnostics.append(Diagnostic(
                    "MSA201", Severity.ERROR,
                    f"Receive has no matching Send for rendezvous key "
                    f"{key!r}; the worker would block forever",
                    op=op.name, placement=op.placement_name,
                ))
    for key, ops in sends.items():
        if key not in receives:
            for op in ops:
                diagnostics.append(Diagnostic(
                    "MSA201", Severity.ERROR,
                    f"Send has no matching Receive for rendezvous key "
                    f"{key!r}; the value is never drained",
                    op=op.name, placement=op.placement_name,
                ))

    # Endpoint agreement, for cleanly 1:1-paired keys only (duplicated or
    # unpaired keys are already reported above).
    for key in sends.keys() & receives.keys():
        if len(sends[key]) != 1 or len(receives[key]) != 1:
            continue
        send, recv = sends[key][0], receives[key][0]
        # a missing endpoint attribute is already reported above; only
        # a *present* endpoint can disagree with the paired op
        declared_receiver = send.attributes.get("receiver")
        if declared_receiver is not None and \
                declared_receiver != recv.placement_name:
            diagnostics.append(Diagnostic(
                "MSA203", Severity.ERROR,
                f"Send declares receiver={declared_receiver!r} but the "
                f"paired Receive {recv.name!r} is placed on "
                f"{recv.placement_name!r}",
                op=send.name, placement=send.placement_name,
            ))
        declared_sender = recv.attributes.get("sender")
        if declared_sender is not None and \
                declared_sender != send.placement_name:
            diagnostics.append(Diagnostic(
                "MSA203", Severity.ERROR,
                f"Receive declares sender={declared_sender!r} but the "
                f"paired Send {send.name!r} is placed on "
                f"{send.placement_name!r}",
                op=recv.name, placement=recv.placement_name,
            ))

    diagnostics.extend(_find_wait_cycles(comp, sends))
    return diagnostics


def _find_wait_cycles(comp: Computation, sends) -> list[Diagnostic]:
    """Strongly connected components over dataflow + rendezvous edges;
    every SCC with a cycle (size > 1, or a self-edge) is one deadlock
    component and yields exactly one diagnostic, carrying a concrete op
    path so the deadlock is readable."""
    adj: dict[str, list[str]] = {name: [] for name in comp.operations}
    rendezvous_edges: set[tuple[str, str]] = set()
    for op in comp.operations.values():
        deps = [inp for inp in op.inputs if inp in comp.operations]
        if op.kind == "Receive":
            key = op.attributes.get("rendezvous_key")
            if key in sends and len(sends[key]) == 1:
                send_name = sends[key][0].name
                deps.append(send_name)
                rendezvous_edges.add((send_name, op.name))
        for dep in deps:
            adj[dep].append(op.name)

    diagnostics: list[Diagnostic] = []
    for scc in _tarjan_sccs(adj):
        members = set(scc)
        start = scc[0]
        if len(scc) == 1 and start not in adj[start]:
            continue  # trivial SCC: not on any cycle
        # Walk inside the SCC until a node repeats (strong connectivity
        # guarantees every member has a successor in the SCC).
        path, seen_at = [start], {start: 0}
        while True:
            nxt = next(
                (m for m in adj[path[-1]] if m in members), None
            )
            if nxt is None:  # defensive: cannot happen in a true SCC
                cycle = None
                break
            if nxt in seen_at:
                cycle = path[seen_at[nxt]:] + [nxt]
                break
            seen_at[nxt] = len(path)
            path.append(nxt)
        if cycle is None:  # pragma: no cover
            continue
        via = [
            e for e in zip(cycle, cycle[1:]) if e in rendezvous_edges
        ]
        detail = (
            f"through rendezvous edge(s) "
            f"{[f'{a}->{b}' for a, b in via]}" if via
            else "in local dataflow"
        )
        diagnostics.append(Diagnostic(
            "MSA204", Severity.ERROR,
            f"wait cycle {' -> '.join(cycle)} {detail}; the "
            f"async workers would deadlock",
            op=cycle[0],
            placement=comp.operations[cycle[0]].placement_name,
        ))
    return diagnostics


def _tarjan_sccs(adj: dict[str, list[str]]) -> list[list[str]]:
    """Iterative Tarjan (lint inputs are arbitrary graphs; recursion
    would overflow on deep op chains)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = 0
    for root in adj:
        if root in index:
            continue
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            pushed_child = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj[w])))
                    pushed_child = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if pushed_child:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs


RULES = {
    "MSA201": "unpaired rendezvous key (Receive without Send, or Send "
              "without Receive)",
    "MSA202": "rendezvous key duplicated among Sends or among Receives",
    "MSA203": "Send/Receive attribute missing, unknown, or disagreeing "
              "with actual placements",
    "MSA204": "cross-host wait cycle through Send->Receive edges "
              "(worker deadlock)",
}
