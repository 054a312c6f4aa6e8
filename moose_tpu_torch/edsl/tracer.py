"""Tracing: eDSL expression DAG -> logical IR ``Computation``.

Re-design of the reference tracer (``pymoose/pymoose/edsl/tracer.py``): run
the user's Python function on symbolic ``Argument`` expressions, then walk the
resulting DAG (memoized on expression identity) emitting one IR operation per
node.

The port's own copy of ``moose_tpu/edsl/tracer.py``:
it imports nothing of the JAX package, so the port keeps the
framework-neutral code itself.
"""

from __future__ import annotations

import inspect

from .. import computation as ir
from .. import vtypes as ty
from . import base


def trace(abstract_computation: base.AbstractComputation) -> ir.Computation:
    func = abstract_computation.func
    sig = inspect.signature(func)
    symbolic_args = []
    for name, param in sig.parameters.items():
        annotation = param.annotation
        if not isinstance(annotation, base.Argument):
            raise ValueError(
                f"parameter {name} must be annotated with moose_tpu_torch.Argument"
            )
        expr = base.Expression(
            op="Input",
            inputs=(),
            attributes={"arg_name": name},
            placement=annotation.placement,
            vtype=annotation.vtype,
        )
        symbolic_args.append(expr)
    outputs = func(*symbolic_args)
    if not isinstance(outputs, (tuple, list)):
        outputs = (outputs,)

    tracer = _AstTracer()
    comp = tracer.comp
    for i, out_expr in enumerate(outputs):
        if not isinstance(out_expr, base.Expression):
            raise ValueError(
                f"computation must return expressions, found {out_expr!r}"
            )
        out_name = tracer.visit(out_expr)
        out_op = comp.operations[out_name]
        if out_op.kind != "Output":
            comp.add_operation(
                ir.Operation(
                    name=f"output_{i}",
                    kind="Output",
                    inputs=[out_name],
                    placement_name=tracer.placement_name(out_expr.placement),
                    signature=ir.Signature(
                        (out_op.signature.return_type,),
                        out_op.signature.return_type,
                    ),
                    attributes={"tag": f"output_{i}"},
                )
            )
    if abstract_computation.role_map:
        comp = apply_role_map(comp, abstract_computation.role_map)
    return comp


class _AstTracer:
    def __init__(self):
        self.comp = ir.Computation()
        self._memo: dict[int, str] = {}
        self._counters: dict[str, int] = {}

    def placement_name(self, plc_expr: base.PlacementExpression) -> str:
        name = plc_expr.name
        if name not in self.comp.placements:
            self.comp.add_placement(_lower_placement(plc_expr))
        return name

    def _fresh_name(self, kind: str) -> str:
        n = self._counters.get(kind, 0)
        self._counters[kind] = n + 1
        return f"{kind.lower()}_{n}"

    def visit(self, expr: base.Expression) -> str:
        key = id(expr)
        if key in self._memo:
            return self._memo[key]
        input_names = [self.visit(e) for e in expr.inputs]
        input_tys = tuple(
            self.comp.operations[n].signature.return_type for n in input_names
        )
        ret_ty = expr.vtype.to_ty() if expr.vtype is not None else ir.Ty(
            "Unknown"
        )
        if expr.op == "Input":
            name = expr.attributes["arg_name"]
        else:
            name = self._fresh_name(expr.op)
        op = ir.Operation(
            name=name,
            kind=expr.op,
            inputs=input_names,
            placement_name=self.placement_name(expr.placement),
            signature=ir.Signature(input_tys, ret_ty),
            attributes=dict(expr.attributes),
        )
        self.comp.add_operation(op)
        self._memo[key] = name
        return name


def _lower_placement(plc_expr: base.PlacementExpression):
    if isinstance(plc_expr, base.HostPlacementExpression):
        return ir.HostPlacement(plc_expr.name)
    if isinstance(plc_expr, base.ReplicatedPlacementExpression):
        return ir.ReplicatedPlacement(
            plc_expr.name, tuple(p.name for p in plc_expr.players)
        )
    if isinstance(plc_expr, base.MirroredPlacementExpression):
        return ir.Mirrored3Placement(
            plc_expr.name, tuple(p.name for p in plc_expr.players)
        )
    raise TypeError(f"unknown placement expression {plc_expr!r}")


def apply_role_map(comp: ir.Computation, role_map: dict) -> ir.Computation:
    """Re-bind host identities (reference tracer.py:842 role_map)."""

    def rename(owner: str) -> str:
        return role_map.get(owner, owner)

    out = ir.Computation()
    for plc in comp.placements.values():
        if isinstance(plc, ir.HostPlacement):
            out.add_placement(ir.HostPlacement(rename(plc.name)))
        else:
            out.add_placement(
                type(plc)(plc.name, tuple(rename(o) for o in plc.owners))
            )
    for op in comp.operations.values():
        new_op = ir.Operation(
            name=op.name,
            kind=op.kind,
            inputs=list(op.inputs),
            placement_name=rename(op.placement_name)
            if isinstance(comp.placements[op.placement_name], ir.HostPlacement)
            else op.placement_name,
            signature=op.signature,
            attributes=dict(op.attributes),
        )
        out.add_operation(new_op)
    return out
