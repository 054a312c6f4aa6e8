"""Graph hygiene analysis (``MSA4xx``).

Findings that do not make a graph wrong, but make it bigger or slower
than it needs to be: ops the prune pass would drop, and structurally
identical duplicate ops that a common-subexpression pass could merge.

Rules:

- ``MSA401`` (warning): dead op — unreachable (walking inputs backwards)
  from every Output/Save/Send root; ``prune`` would drop it.  When the
  graph has no roots at all, one summary diagnostic is emitted instead
  of one per op.
- ``MSA402`` (info): CSE candidate — an op structurally identical (kind,
  inputs, placement, signature, attributes) to an earlier op.  Kinds
  with side effects or fresh randomness (Input/Output/Load/Save,
  Send/Receive, Sample, PrfKeyGen) are exempt: merging those changes
  semantics.
- ``MSA403`` (error): duplicate Output tag — two Output ops share one
  results-dict key, so the later one silently overwrites the earlier
  one's entry in every executor.  ``well_formed_check`` rejects this
  fail-fast; the lint reports every collision in one pass.

The port's own copy of
``moose_tpu/compilation/analysis/hygiene.py``: pure graph and numpy
code, it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ...computation import Computation
from ..pruning import _ROOT_KINDS, reachable_from_roots
from .diagnostics import Diagnostic, Severity

# Never propose CSE across these: distinct ops are semantically distinct
# even when structurally identical (side effects, fresh randomness).
_CSE_EXEMPT_KINDS = frozenset({
    "Input", "Output", "Load", "Save", "Send", "Receive", "Sample",
    "PrfKeyGen",
})


def _canonical(value: object) -> object:
    """Hashable structural key for an attribute value (ndarrays by
    content digest, containers recursively)."""
    if isinstance(value, np.ndarray):
        digest = hashlib.blake2b(
            value.tobytes(), digest_size=16
        ).hexdigest()
        return ("ndarray", value.shape, str(value.dtype), digest)
    if isinstance(value, (list, tuple)):
        return tuple(_canonical(v) for v in value)
    if isinstance(value, dict):
        return tuple(
            sorted((k, _canonical(v)) for k, v in value.items())
        )
    if isinstance(value, bytes):
        return hashlib.blake2b(value, digest_size=16).hexdigest()
    try:
        hash(value)
        return value
    except TypeError:
        return repr(value)


def analyze_hygiene(comp: Computation) -> list[Diagnostic]:
    diagnostics: list[Diagnostic] = []

    roots = [
        op.name for op in comp.operations.values()
        if op.kind in _ROOT_KINDS
    ]
    if not roots and comp.operations:
        diagnostics.append(Diagnostic(
            "MSA401", Severity.WARNING,
            f"graph has no Output/Save/Send roots; all "
            f"{len(comp.operations)} ops are dead",
        ))
    else:
        # unknown inputs are MSA304 territory, hence ignore_unknown
        keep = reachable_from_roots(comp, ignore_unknown_inputs=True)
        for name, op in comp.operations.items():
            if name not in keep:
                diagnostics.append(Diagnostic(
                    "MSA401", Severity.WARNING,
                    f"dead op ({op.kind}): unreachable from any "
                    f"Output/Save/Send root; prune would drop it",
                    op=name, placement=op.placement_name,
                ))

    output_tags: dict[str, str] = {}
    for name, op in comp.operations.items():
        if op.kind != "Output":
            continue
        tag = op.attributes.get("tag", name)
        first = output_tags.setdefault(tag, name)
        if first != name:
            diagnostics.append(Diagnostic(
                "MSA403", Severity.ERROR,
                f"duplicate Output tag {tag!r} (also on {first!r}): "
                "the later op silently overwrites the earlier one's "
                "results entry",
                op=name, placement=op.placement_name,
            ))

    seen: dict[tuple, str] = {}
    for name, op in comp.operations.items():
        if op.kind in _CSE_EXEMPT_KINDS:
            continue
        key = (
            op.kind,
            tuple(op.inputs),
            op.placement_name,
            op.signature.to_textual(),
            _canonical(op.attributes),
        )
        first = seen.setdefault(key, name)
        if first != name:
            diagnostics.append(Diagnostic(
                "MSA402", Severity.INFO,
                f"structurally identical to {first!r}; CSE candidate",
                op=name, placement=op.placement_name,
            ))
    return diagnostics


RULES = {
    "MSA401": "dead op: unreachable from any Output/Save/Send root",
    "MSA402": "CSE candidate: structurally identical duplicate op",
    "MSA403": "duplicate Output tag: results dict entries overwrite",
}
