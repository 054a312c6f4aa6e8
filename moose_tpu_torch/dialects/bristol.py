"""Bristol-Fashion boolean circuit parser + evaluator.

The port's copy of ``moose_tpu/dialects/bristol.py`` (pure Python over a
bit backend): circuits in the `Bristol Fashion format
<https://homes.esat.kuleuven.be/~nsmart/MPC/>`_ evaluate over any backend
with the bit operations of ``aes.StackedBitOps``, so a user-supplied
circuit runs on secret-shared bits in the party-stacked layout.

Gates are grouped into dependency *levels* and each level executes as ONE
batched XOR/AND over stacked wire tensors: one AND (one bit bank, one
reshare) per AND-level instead of one per AND gate.  (The built-in AES
path does not use this module; it is computed algebraically in
``aes.py``.)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..errors import KernelError, MalformedComputationError


@dataclasses.dataclass
class Gate:
    kind: str  # XOR | AND | INV | EQW | NOT
    inputs: tuple
    outputs: tuple


@dataclasses.dataclass
class Circuit:
    num_gates: int
    num_wires: int
    input_widths: list
    output_widths: list
    gates: list

    @property
    def num_inputs(self) -> int:
        return sum(self.input_widths)

    @property
    def num_outputs(self) -> int:
        return sum(self.output_widths)


def parse_circuit(text: str) -> Circuit:
    """Parse the Bristol-Fashion header + gate list
    (bristol_fashion/mod.rs:95-220)."""
    lines = [ln.strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln]
    try:
        num_gates, num_wires = (int(t) for t in lines[0].split()[:2])
        in_parts = [int(t) for t in lines[1].split()]
        n_in, in_widths = in_parts[0], in_parts[1:]
        out_parts = [int(t) for t in lines[2].split()]
        n_out, out_widths = out_parts[0], out_parts[1:]
    except (IndexError, ValueError) as e:
        raise MalformedComputationError(
            f"bad Bristol-Fashion header: {e}"
        ) from e
    if len(in_widths) != n_in or len(out_widths) != n_out:
        raise MalformedComputationError(
            "Bristol-Fashion header widths disagree with counts"
        )
    gates = []
    for ln in lines[3:]:
        toks = ln.split()
        n_i, n_o = int(toks[0]), int(toks[1])
        wires = [int(t) for t in toks[2:2 + n_i + n_o]]
        kind = toks[2 + n_i + n_o]
        if kind not in ("XOR", "AND", "INV", "NOT", "EQW"):
            raise MalformedComputationError(f"unknown gate kind {kind!r}")
        gates.append(
            Gate(kind, tuple(wires[:n_i]), tuple(wires[n_i:n_i + n_o]))
        )
    if len(gates) != num_gates:
        raise MalformedComputationError(
            f"expected {num_gates} gates, parsed {len(gates)}"
        )
    return Circuit(num_gates, num_wires, in_widths, out_widths, gates)


def _schedule_levels(circuit: Circuit) -> list:
    """Group gates into levels: a gate runs as soon as its inputs are
    ready; all gates in a level are independent."""
    ready_at = [0] * circuit.num_wires
    levels: dict[int, list] = {}
    for gate in circuit.gates:
        lvl = max((ready_at[w] for w in gate.inputs), default=0)
        levels.setdefault(lvl, []).append(gate)
        for w in gate.outputs:
            ready_at[w] = lvl + 1
    return [levels[k] for k in sorted(levels)]


def evaluate(circuit: Circuit, B, inputs: Sequence):
    """Evaluate over bit backend ``B`` (``aes.StackedBitOps``).

    ``inputs``: one bit value per circuit input, each with a leading wire
    axis matching that input's width.  Returns one bit value per circuit
    output (leading axis = output width).  Wire order follows the raw file
    (no AES-specific bit reversal — callers own their conventions).
    """
    if len(inputs) != len(circuit.input_widths):
        raise KernelError(
            f"circuit takes {len(circuit.input_widths)} inputs, got "
            f"{len(inputs)}"
        )
    wires: list = [None] * circuit.num_wires
    w = 0
    for value, width in zip(inputs, circuit.input_widths):
        for i in range(width):
            wires[w + i] = B.slice0(value, i, i + 1)
        w += width

    for level in _schedule_levels(circuit):
        # batch the level's binary gates per kind into one stacked op
        for kind in ("XOR", "AND"):
            group = [g for g in level if g.kind == kind]
            if not group:
                continue
            xs = B.concat0([wires[g.inputs[0]] for g in group])
            ys = B.concat0([wires[g.inputs[1]] for g in group])
            zs = B.xor(xs, ys) if kind == "XOR" else B.and_(xs, ys)
            for i, g in enumerate(group):
                wires[g.outputs[0]] = B.slice0(zs, i, i + 1)
        for g in level:
            if g.kind in ("INV", "NOT"):
                wires[g.outputs[0]] = B.not_(wires[g.inputs[0]])
            elif g.kind == "EQW":
                wires[g.outputs[0]] = wires[g.inputs[0]]

    outputs = []
    w = circuit.num_wires
    for width in reversed(circuit.output_widths):
        w -= width
        outputs.append(B.concat0(wires[w:w + width]))
    return list(reversed(outputs))
