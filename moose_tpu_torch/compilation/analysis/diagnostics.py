"""Diagnostics framework for graph analyses.

Analyses over the computation IR *collect* :class:`Diagnostic` records
instead of raising on the first finding, so one lint run reports every
violation in a graph (the reference compiler's well-formedness check is
fail-fast; a linter must not be).  Each diagnostic carries a stable rule
id (``MSA1xx`` secrecy, ``MSA2xx`` communication, ``MSA3xx`` signatures,
``MSA4xx`` hygiene — see the catalogue in DEVELOP.md), a severity, the
offending op and placement, and a human-readable message.

The port's own copy of
``moose_tpu/compilation/analysis/diagnostics.py``: pure graph and numpy
code, it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Severity(enum.IntEnum):
    """Ordered severity ladder; comparisons (``>= Severity.ERROR``) pick
    out the findings that should fail a strict compile or a CI lint."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    @classmethod
    def from_str(cls, text: str) -> "Severity":
        try:
            return cls[text.upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {text!r}; expected one of "
                f"{[s.name.lower() for s in cls]}"
            ) from None

    def __str__(self) -> str:
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analysis finding, addressable by rule id."""

    rule: str
    severity: Severity
    message: str
    op: Optional[str] = None
    placement: Optional[str] = None

    def format(self) -> str:
        loc = ""
        if self.op is not None:
            loc += f" op={self.op}"
        if self.placement is not None:
            loc += f" @{self.placement}"
        return f"{self.rule} {self.severity}{loc}: {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": str(self.severity),
            "op": self.op,
            "placement": self.placement,
            "message": self.message,
        }


def format_diagnostics(diagnostics) -> str:
    return "\n".join(d.format() for d in diagnostics)


def max_severity(diagnostics) -> Optional[Severity]:
    return max((d.severity for d in diagnostics), default=None)
