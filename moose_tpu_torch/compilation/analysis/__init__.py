"""Static analysis over the computation IR ("prancer").

A diagnostics framework plus a rule catalogue that makes graph-level
invariants machine-checkable before anything runs on a device: secrecy
(secret shares never collected on one host), communication (every
Receive has a matching Send; no rendezvous deadlock), signature
consistency (declared input types agree with producers), and hygiene
(dead ops, CSE candidates).  Analyses *collect* :class:`Diagnostic`
records instead of raising on the first error; strict callers turn
error-severity findings into :class:`MalformedComputationError` via
:func:`lint_check`.

Entry points:

- :func:`analyze` — run some or all analyses, return diagnostics.
- :func:`lint_check` — analyze and raise on error-severity findings
  (the ``strict=True`` knob of the elk compiler, and the ``lint``
  compiler pass).
- ``python -m moose_tpu_torch.bin.prancer`` — the CLI over serialized
  computations (textual or msgpack).

Rule id space: ``MSA1xx`` secrecy, ``MSA2xx`` communication, ``MSA3xx``
signatures, ``MSA4xx`` hygiene, ``MSA5xx`` execution-plan schedule,
``MSA6xx`` communication/memory cost, ``MSA7xx`` fixed-point value
ranges, ``MSA8xx`` PRF key lineage & stream discipline.  The full
catalogue is in :data:`RULES` and documented in DEVELOP.md.

The port's own copy of ``moose_tpu/compilation/analysis/__init__.py``:
every analysis runs on the port's IR and gives the JAX package's
diagnostics and reports.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from ...computation import Computation
from ...errors import MalformedComputationError
from .communication import RULES as _COMM_RULES
from .communication import analyze_communication
from .cost import RULES as _COST_RULES
from .cost import analyze_cost, cost_report, infer_specs
from .diagnostics import (
    Diagnostic,
    Severity,
    format_diagnostics,
    max_severity,
)
from .hygiene import RULES as _HYGIENE_RULES
from .hygiene import analyze_hygiene
from .keystream import RULES as _KEYSTREAM_RULES
from .keystream import (
    analyze_keystream,
    host_draw_counts,
    keystream_report,
    stacked_draw_trace,
)
from .ranges import RULES as _RANGE_RULES
from .ranges import RangeFact, analyze_ranges, infer_ranges, range_report
from .schedule import RULES as _SCHEDULE_RULES
from .schedule import (
    analyze_schedule,
    build_role_schedule,
    plan_errors,
    reconstruct_schedules,
)
from .secrecy import RULES as _SECRECY_RULES
from .secrecy import analyze_secrecy
from .signatures import RULES as _SIG_RULES
from .signatures import analyze_signatures

__all__ = [
    "ANALYSES", "Diagnostic", "RULES", "RangeFact", "Severity",
    "analyze", "analyze_cost", "analyze_keystream", "analyze_ranges",
    "analyze_schedule", "build_role_schedule", "cost_report",
    "format_diagnostics", "host_draw_counts", "infer_ranges",
    "infer_specs", "keystream_report", "lint_check", "max_severity",
    "plan_errors", "range_report", "reconstruct_schedules",
    "stacked_draw_trace",
]

# name -> analysis function; the public registry (prancer's --analyses
# values and the keys tests select by).
ANALYSES = {
    "secrecy": analyze_secrecy,
    "communication": analyze_communication,
    "signatures": analyze_signatures,
    "hygiene": analyze_hygiene,
    "schedule": analyze_schedule,
    "cost": analyze_cost,
    "ranges": analyze_ranges,
    "keystream": analyze_keystream,
}

# which context keys each analysis accepts; :func:`analyze` forwards
# only what an analysis understands so callers can pass one context
# dict without caring which rule family consumes which knob.
ANALYSIS_CONTEXT_KEYS = {
    "ranges": ("arg_specs", "arg_ranges", "margin_bits"),
    "cost": ("jumbo_bytes", "live_buffer_bytes"),
    "keystream": ("arg_specs",),
}

# rule id -> one-line description (prancer --explain, DEVELOP.md).
RULES = {
    **_SECRECY_RULES, **_COMM_RULES, **_SIG_RULES, **_HYGIENE_RULES,
    **_SCHEDULE_RULES, **_COST_RULES, **_RANGE_RULES,
    **_KEYSTREAM_RULES,
}


def analyze(
    comp: Computation,
    analyses: Optional[Iterable[str]] = None,
    ignore: Iterable[str] = (),
    context: Optional[Dict[str, Any]] = None,
) -> list[Diagnostic]:
    """Run the selected analyses (default: all) over ``comp`` and return
    every finding, most severe first.  ``ignore`` suppresses rule ids
    (exact, e.g. ``MSA402``) or whole families (prefix, e.g. ``MSA4``).
    ``context`` carries analysis inputs (``arg_specs``/``arg_ranges``/
    ``margin_bits`` for ranges, ``jumbo_bytes``/``live_buffer_bytes``
    for cost); each analysis receives only the keys it understands
    (:data:`ANALYSIS_CONTEXT_KEYS`).
    """
    names = list(ANALYSES) if analyses is None else list(analyses)
    # a bare string would otherwise iterate per-character and suppress
    # everything ('M' prefix-matches every rule id)
    ignored = (ignore,) if isinstance(ignore, str) else tuple(ignore)
    ctx = context or {}
    unknown = set(ctx) - {
        k for keys in ANALYSIS_CONTEXT_KEYS.values() for k in keys
    }
    if unknown:
        raise ValueError(
            f"unknown analysis context key(s) {sorted(unknown)}; "
            f"accepted: {sorted({k for keys in ANALYSIS_CONTEXT_KEYS.values() for k in keys})}"
        )
    diagnostics: list[Diagnostic] = []
    for name in names:
        try:
            fn = ANALYSES[name]
        except KeyError:
            raise ValueError(
                f"unknown analysis {name!r}; available: {sorted(ANALYSES)}"
            ) from None
        accepted = ANALYSIS_CONTEXT_KEYS.get(name, ())
        kwargs = {k: ctx[k] for k in accepted if k in ctx}
        diagnostics.extend(fn(comp, **kwargs))
    if ignored:
        diagnostics = [
            d for d in diagnostics
            if not any(d.rule.startswith(pat) for pat in ignored)
        ]
    diagnostics.sort(key=lambda d: (-d.severity, d.rule, d.op or ""))
    return diagnostics


def lint_check(
    comp: Computation,
    analyses: Optional[Iterable[str]] = None,
    ignore: Iterable[str] = (),
    context: Optional[Dict[str, Any]] = None,
) -> Computation:
    """Analyze ``comp`` and raise :class:`MalformedComputationError`
    carrying the findings if any error-severity diagnostic fired;
    usable directly as a compiler pass."""
    diagnostics = analyze(comp, analyses=analyses, ignore=ignore,
                          context=context)
    errors = [d for d in diagnostics if d.severity >= Severity.ERROR]
    if errors:
        raise MalformedComputationError(
            f"computation failed lint with {len(errors)} error(s):\n"
            + format_diagnostics(errors),
            diagnostics=errors,
        )
    return comp
