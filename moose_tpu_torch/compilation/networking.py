"""Networking pass: turn cross-host dataflow edges into Send/Receive pairs
with fresh rendezvous keys (reference compilation/networking.rs:5-120).

For every operation input produced on a different host placement, a
``Send {rendezvous_key, receiver}`` is appended on the producer's host and a
``Receive {rendezvous_key, sender}`` on the consumer's host; transfers are
deduplicated per (producer, destination host) exactly as the reference does.
Identity ops inserted by the SymbolicSession for explicit moves collapse
into the same mechanism (their input edge is the cross-host edge).

The port's own copy of ``moose_tpu/compilation/networking.py``.
"""

from __future__ import annotations

from ..computation import (
    Computation,
    HostPlacement,
    Operation,
    RendezvousKey,
    Signature,
    UnitTy,
)
from ..errors import CompilationError


def networking_pass(comp: Computation) -> Computation:
    out = comp.clone_empty()
    # (producer op name, destination host) -> receive op name
    transfer_cache: dict[tuple, str] = {}
    counter = 0
    # Generated send_{n}/receive_{n} names must not collide with user ops
    # (a user op literally named "send_0" would silently overwrite the
    # generated Send when copied into `out`); skip taken indices.
    taken = set(comp.operations)

    def fresh_pair() -> tuple[str, str, str]:
        nonlocal counter
        while (
            f"send_{counter}" in taken or f"receive_{counter}" in taken
        ):
            counter += 1
        send_name, recv_name = f"send_{counter}", f"receive_{counter}"
        rdv = RendezvousKey.from_index(counter).hex()
        counter += 1
        taken.update((send_name, recv_name))
        return send_name, recv_name, rdv

    def host_of(op: Operation) -> str:
        plc = comp.placements[op.placement_name]
        if not isinstance(plc, HostPlacement):
            raise CompilationError(
                f"networking pass requires a lowered (host-only) graph; "
                f"op {op.name} is on {plc.kind} placement {plc.name}"
            )
        return plc.name

    for name, op in comp.operations.items():
        dst = host_of(op)
        new_inputs = []
        for inp in op.inputs:
            producer = comp.operations[inp]
            src = host_of(producer)
            if src == dst:
                new_inputs.append(inp)
                continue
            cache_key = (inp, dst)
            recv_name = transfer_cache.get(cache_key)
            if recv_name is None:
                send_name, recv_name, rdv = fresh_pair()
                value_ty = producer.signature.return_type
                out.operations[send_name] = Operation(
                    name=send_name,
                    kind="Send",
                    inputs=[inp],
                    placement_name=src,
                    signature=Signature((value_ty,), UnitTy),
                    attributes={
                        "rendezvous_key": rdv,
                        "receiver": dst,
                    },
                )
                out.operations[recv_name] = Operation(
                    name=recv_name,
                    kind="Receive",
                    inputs=[],
                    placement_name=dst,
                    signature=Signature((), value_ty),
                    attributes={
                        "rendezvous_key": rdv,
                        "sender": src,
                    },
                )
                transfer_cache[cache_key] = recv_name
            new_inputs.append(recv_name)
        out.operations[name] = Operation(
            name=op.name,
            kind=op.kind,
            inputs=new_inputs,
            placement_name=op.placement_name,
            signature=op.signature,
            attributes=op.attributes,
        )
    return out
