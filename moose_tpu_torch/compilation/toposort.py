"""Toposort pass: reorder the operation map into a valid execution order
(reference compilation/toposort.rs:4), honoring Send/Receive rendezvous
edges as well as dataflow edges.

The port's own copy of ``moose_tpu/compilation/toposort.py``.
"""

from __future__ import annotations

from ..computation import Computation


def toposort_pass(comp: Computation) -> Computation:
    order = comp.toposort_names()
    out = comp.clone_empty()
    for name in order:
        out.operations[name] = comp.operations[name]
    return out
