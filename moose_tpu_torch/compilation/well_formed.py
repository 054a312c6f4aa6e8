"""Well-formedness check (reference compilation/well_formed.rs:13).

The port's own copy of ``moose_tpu/compilation/well_formed.py``.
"""

from __future__ import annotations

from ..computation import Computation, Operation, OPERATOR_SET
from ..errors import MalformedComputationError


def rendezvous_attr_problems(op: Operation, placements: dict) -> list[str]:
    """Problems with a Send/Receive op's rendezvous attributes (empty
    when well-formed).  The ONE definition of the rendezvous contract:
    raised fail-fast here, collected as MSA203 diagnostics by
    ``compilation.analysis.communication``."""
    endpoint_attr = "receiver" if op.kind == "Send" else "sender"
    problems = []
    if "rendezvous_key" not in op.attributes:
        problems.append(f"{op.kind} missing attribute 'rendezvous_key'")
    endpoint = op.attributes.get(endpoint_attr)
    if endpoint is None:
        problems.append(
            f"{op.kind} missing attribute {endpoint_attr!r}"
        )
    elif endpoint not in placements:
        problems.append(
            f"{op.kind} {endpoint_attr} {endpoint!r} is not a placement "
            f"of this computation"
        )
    return problems


def well_formed_check(comp: Computation) -> Computation:
    # Output tags key the results dict in every executor (interpreter,
    # physical, distributed worker — reference
    # execution/asynchronous.rs:623); two Outputs sharing one tag would
    # silently overwrite each other's entry
    output_tags: dict[str, str] = {}
    for name, op in comp.operations.items():
        if op.name != name:
            raise MalformedComputationError(
                f"operation map key {name!r} != op.name {op.name!r}"
            )
        if op.kind not in OPERATOR_SET:
            raise MalformedComputationError(
                f"op {name}: unknown operator kind {op.kind!r}"
            )
        if op.placement_name not in comp.placements:
            raise MalformedComputationError(
                f"op {name}: unknown placement {op.placement_name!r}"
            )
        for inp in op.inputs:
            if inp not in comp.operations:
                raise MalformedComputationError(
                    f"op {name}: unknown input {inp!r}"
                )
        if op.signature.variadic:
            if not op.inputs:
                raise MalformedComputationError(
                    f"op {name}: variadic signature requires at least "
                    "one input"
                )
        elif op.signature.arity != len(op.inputs):
            raise MalformedComputationError(
                f"op {name}: signature arity {op.signature.arity} != "
                f"{len(op.inputs)} inputs"
            )
        # Send/Receive carry their rendezvous contract in attributes; a
        # missing key or an endpoint naming a placement outside the
        # computation hangs the async workers at runtime.
        if op.kind in ("Send", "Receive"):
            problems = rendezvous_attr_problems(op, comp.placements)
            if problems:
                raise MalformedComputationError(
                    f"op {name}: {problems[0]}"
                )
        if op.kind == "Output":
            tag = op.attributes.get("tag", name)
            other = output_tags.setdefault(tag, name)
            if other != name:
                raise MalformedComputationError(
                    f"op {name}: duplicate Output tag {tag!r} (also on "
                    f"{other!r}); the later op would silently overwrite "
                    "the earlier one's results entry"
                )
    # cycle check (toposort raises ValueError; re-raise in the
    # compilation error taxonomy)
    try:
        comp.toposort_names()
    except ValueError as e:
        raise MalformedComputationError(str(e)) from e
    return comp
