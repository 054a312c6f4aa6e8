"""Compiler: passes over the placement-IR (reference
``moose/src/compilation/mod.rs:17-132``).

The port's own copy of ``moose_tpu/compilation/__init__.py``: typing,
lowering (to the host-level graph of the physical executor, run through
the dialect kernels under a ``SymbolicSession``), prune, networking,
toposort, the well-formedness check and the DOT print, with the
reference's DEFAULT_PASSES.  Lowering needs a static shape for every
Input and Load (``arg_specs``, usually
``lowering.arg_specs_from_arguments`` of the first evaluation's
arguments), baked into the lowered graph as HostShape constants.  The
static analyzer behind ``lint`` and ``strict`` (ROADMAP queue 1,
item 13) is not ported: asking for it raises, naming the item, and
nothing runs in its place.
"""

from __future__ import annotations

import sys
from typing import Optional

from ..computation import Computation
from ..errors import CompilationError
from .lowering import lower
from .networking import networking_pass
from .pruning import prune
from .toposort import toposort_pass
from .typing import typing_pass
from .well_formed import well_formed_check

DEFAULT_PASSES = ["typing", "lowering", "prune", "networking", "toposort"]

_ANALYZER = "ROADMAP queue 1, item 13"


def compile_computation(
    comp: Computation,
    passes: Optional[list] = None,
    arg_specs: Optional[dict] = None,
    strict: bool = False,
) -> Computation:
    """Run compiler passes over ``comp`` and return the compiled graph
    (reference compile(), compilation/mod.rs:120-132).  ``arg_specs``
    feeds the lowering pass: ``{input name: (shape, numpy dtype)}``, a
    string or a static scalar."""
    if strict:
        raise NotImplementedError(
            f"strict=True runs the static analyzer, which is not ported "
            f"({_ANALYZER})"
        )
    if passes is None:
        passes = list(DEFAULT_PASSES)
    for p in passes:
        comp = _run_pass(comp, p, arg_specs)
    return comp


def _run_pass(comp, p, arg_specs):
    if p == "typing":
        return typing_pass(comp)
    if p == "lowering":
        return lower(comp, arg_specs)
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
