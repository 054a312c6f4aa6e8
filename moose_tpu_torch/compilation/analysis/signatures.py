"""Signature consistency analysis (``MSA3xx``).

A full forward pass extending the one-hop ``typing_pass``: every op's
*declared* input types are checked against its producers' *actual* return
types, arity against the signature, and Unit-typed values (the return of
Send/Save side effects) against tensor-shaped consumption.  The typing
pass rewrites input types from producers, so a graph straight out of it
is consistent by construction — these rules catch hand-built graphs,
graphs edited after compilation, and passes that forgot to re-type.

Rules:

- ``MSA301`` (error): declared input type disagrees with the producer's
  return type.
- ``MSA302`` (error): declared arity disagrees with the actual input
  count (non-variadic signatures).
- ``MSA303`` (error): a Unit-typed value is consumed by a non-Output op
  (Units carry no data; consuming one as a tensor is always a bug).
- ``MSA304`` (error): an input references an op that does not exist.

Types named ``Unknown`` (untyped eDSL expressions) are skipped rather
than flagged — absence of type information is not a contradiction.

The port's own copy of
``moose_tpu/compilation/analysis/signatures.py``: pure graph and numpy
code, it imports nothing of the JAX package.
"""

from __future__ import annotations

from ...computation import Computation
from .diagnostics import Diagnostic, Severity


def analyze_signatures(comp: Computation) -> list[Diagnostic]:
    diagnostics: list[Diagnostic] = []
    for name, op in comp.operations.items():
        sig = op.signature
        if not sig.variadic and sig.arity != len(op.inputs):
            diagnostics.append(Diagnostic(
                "MSA302", Severity.ERROR,
                f"signature arity {sig.arity} != {len(op.inputs)} inputs",
                op=name, placement=op.placement_name,
            ))
        for i, inp in enumerate(op.inputs):
            producer = comp.operations.get(inp)
            if producer is None:
                diagnostics.append(Diagnostic(
                    "MSA304", Severity.ERROR,
                    f"input {i} references unknown op {inp!r}",
                    op=name, placement=op.placement_name,
                ))
                continue
            produced = producer.signature.return_type
            if produced.name == "Unit" and op.kind != "Output":
                diagnostics.append(Diagnostic(
                    "MSA303", Severity.ERROR,
                    f"input {i} ({inp!r}, a {producer.kind}) is "
                    f"Unit-typed; {op.kind} consumes it as a value",
                    op=name, placement=op.placement_name,
                ))
                continue
            if sig.variadic:
                declared = sig.input_types[0] if sig.input_types else None
            else:
                declared = sig.input_types[i] if i < sig.arity else None
            if declared is None:
                continue
            if "Unknown" in (declared.name, produced.name):
                continue
            if declared != produced:
                diagnostics.append(Diagnostic(
                    "MSA301", Severity.ERROR,
                    f"input {i} ({inp!r}) declared as "
                    f"{declared.to_textual()} but producer {producer.kind} "
                    f"returns {produced.to_textual()}",
                    op=name, placement=op.placement_name,
                ))
    return diagnostics


RULES = {
    "MSA301": "declared input type disagrees with producer return type",
    "MSA302": "signature arity disagrees with actual input count",
    "MSA303": "Unit-typed value consumed as a tensor",
    "MSA304": "input references an op that does not exist",
}
