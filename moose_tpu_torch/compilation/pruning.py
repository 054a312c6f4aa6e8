"""Prune pass: drop operations not reachable (reverse) from the graph's
roots (reference compilation/pruning.rs:6).

Roots are Output and Save ops (reference prunes from outputs; Save is also a
side effect we must keep), plus Send ops when the pass runs after
networking — a Send's value is consumed on another host, not via a local
dataflow edge.

The port's own copy of ``moose_tpu/compilation/pruning.py``.
"""

from __future__ import annotations

from ..computation import Computation
from ..errors import MalformedComputationError

_ROOT_KINDS = ("Output", "Save", "Send")


def reachable_from_roots(
    comp: Computation, ignore_unknown_inputs: bool = False
) -> set[str]:
    """Names of ops reachable (walking inputs backwards) from the
    Output/Save/Send roots — what :func:`prune` keeps and what the
    hygiene analysis calls alive.  An input naming a nonexistent op
    raises :class:`MalformedComputationError` unless
    ``ignore_unknown_inputs`` (analyses tolerate broken edges and report
    them under their own rule)."""
    keep: set[str] = set()
    stack = [
        op.name for op in comp.operations.values() if op.kind in _ROOT_KINDS
    ]
    # Receive ops keep their rendezvous'd Send alive implicitly via the
    # _ROOT_KINDS entry above; dataflow edges do the rest.
    while stack:
        name = stack.pop()
        if name in keep:
            continue
        keep.add(name)
        for inp in comp.operations[name].inputs:
            if inp not in comp.operations:
                if ignore_unknown_inputs:
                    continue
                raise MalformedComputationError(
                    f"op {name!r}: input {inp!r} does not exist in the "
                    f"computation"
                )
            stack.append(inp)
    return keep


def prune(comp: Computation) -> Computation:
    keep = reachable_from_roots(comp)

    out = comp.clone_empty()
    for name, op in comp.operations.items():
        if name in keep:
            out.operations[name] = op
    return out
