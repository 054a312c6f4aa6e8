"""Typing pass: one-hop signature inference (reference
compilation/typing.rs:7) — each op's input types are updated from its
producers' return types.

The port's own copy of ``moose_tpu/compilation/typing.py``.
"""

from __future__ import annotations

from ..computation import Computation, Operation, Signature
from ..errors import MalformedComputationError


def typing_pass(comp: Computation) -> Computation:
    out = comp.clone_empty()
    for name, op in comp.operations.items():
        input_types = []
        for inp in op.inputs:
            producer = comp.operations.get(inp)
            if producer is None:
                raise MalformedComputationError(
                    f"op {name} depends on unknown op {inp}"
                )
            input_types.append(producer.signature.return_type)
        out.operations[name] = Operation(
            name=op.name,
            kind=op.kind,
            inputs=list(op.inputs),
            placement_name=op.placement_name,
            signature=Signature(
                tuple(input_types), op.signature.return_type,
                variadic=op.signature.variadic,
            ),
            attributes=op.attributes,
        )
    return out
