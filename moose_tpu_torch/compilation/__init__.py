"""Compiler: passes over the placement-IR (reference
``moose/src/compilation/mod.rs:17-132``).

The port's own copy of ``moose_tpu/compilation/__init__.py``, with the
logical passes: typing, prune, networking, toposort, the well-formedness
check and the DOT print.  The lowering pass (to the host-level graph
of the physical executor, ROADMAP queue 1, item 8b) and the static analyzer behind ``lint`` and
``strict`` (item 13) are not ported: asking for them raises, naming the
item, and nothing runs in their place.
"""

from __future__ import annotations

import sys
from typing import Optional

from ..computation import Computation
from ..errors import CompilationError
from .networking import networking_pass
from .pruning import prune
from .toposort import toposort_pass
from .typing import typing_pass
from .well_formed import well_formed_check

DEFAULT_PASSES = ["typing", "lowering", "prune", "networking", "toposort"]

_LOWERING = "ROADMAP queue 1, item 8b"
_ANALYZER = "ROADMAP queue 1, item 13"


def compile_computation(
    comp: Computation,
    passes: Optional[list] = None,
    arg_specs: Optional[dict] = None,
    strict: bool = False,
) -> Computation:
    """Run compiler passes over ``comp`` and return the compiled graph
    (reference compile(), compilation/mod.rs:120-132).  ``arg_specs``
    feeds only the lowering pass and is accepted for it."""
    if strict:
        raise NotImplementedError(
            f"strict=True runs the static analyzer, which is not ported "
            f"({_ANALYZER})"
        )
    if passes is None:
        passes = list(DEFAULT_PASSES)
    for p in passes:
        comp = _run_pass(comp, p)
    return comp


def _run_pass(comp, p):
    if p == "typing":
        return typing_pass(comp)
    if p == "lowering":
        raise NotImplementedError(
            f"the lowering pass (the per-host layout) is not ported "
            f"({_LOWERING})"
        )
    if p == "prune":
        return prune(comp)
    if p == "networking":
        return networking_pass(comp)
    if p == "toposort":
        return toposort_pass(comp)
    if p == "wellformed":
        well_formed_check(comp)
        return comp
    if p == "lint":
        raise NotImplementedError(
            f"the lint pass runs the static analyzer, which is not ported "
            f"({_ANALYZER})"
        )
    if p == "dump":
        from ..textual import to_textual

        # not print(): once the `print` submodule is imported, that name
        # in this package's namespace is the module
        sys.stdout.write(to_textual(comp) + "\n")
        return comp
    if p == "dot":
        from .print import print_pass

        return print_pass(comp)
    if callable(p):
        return p(comp) or comp
    raise CompilationError(f"unknown compiler pass: {p!r}")
