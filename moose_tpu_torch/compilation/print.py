"""Graphviz DOT export of a computation graph (reference
``moose/src/compilation/print.rs``): one node per operation, labelled
``name = Kind``, clustered by placement, dataflow edges input -> op.

Usable as a compiler pass (``passes=["dot", ...]`` prints to stdout and
leaves the graph unchanged) or directly via :func:`to_dot` / the elk CLI
(``elk compile comp.moose --format dot``).

The port's own copy of ``moose_tpu/compilation/print.py``.
"""

from __future__ import annotations

from ..computation import Computation

_PLACEMENT_COLORS = {
    "Host": "lightblue",
    "Replicated": "lightsalmon",
    "Additive": "palegreen",
    "Mirrored3": "khaki",
}


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def to_dot(comp: Computation) -> str:
    """Render ``comp`` as a Graphviz DOT digraph, operations grouped into
    per-placement clusters."""
    lines = ["digraph computation {", "  rankdir=TB;"]

    by_placement: dict[str, list] = {}
    for op in comp.operations.values():
        plc = comp.placement_of(op)
        by_placement.setdefault(plc.name, []).append(op)

    for idx, (plc_name, ops) in enumerate(sorted(by_placement.items())):
        plc = comp.placements[plc_name]
        kind = type(plc).__name__.replace("Placement", "")
        color = _PLACEMENT_COLORS.get(kind, "lightgray")
        lines.append(f"  subgraph cluster_{idx} {{")
        lines.append(f"    label={_quote(f'{kind}({plc_name})')};")
        lines.append(f"    style=filled; color={color};")
        for op in ops:
            label = f"{op.name} = {op.kind}"
            lines.append(
                f"    {_quote(op.name)} [label={_quote(label)}];"
            )
        lines.append("  }")

    for op in comp.operations.values():
        for inp in op.inputs:
            lines.append(f"  {_quote(inp)} -> {_quote(op.name)};")

    lines.append("}")
    return "\n".join(lines) + "\n"


def print_pass(comp: Computation) -> Computation:
    """Compiler pass: print the DOT rendering, return the graph unchanged
    (reference print.rs behavior)."""
    print(to_dot(comp))
    return comp
