#!/usr/bin/env python3
"""The dependent chain of a kernel's innermost loop, counted from its SASS.

    cuobjdump -sass moose_tpu_torch/native/build/libhorner-*.so > horner.sass
    python3 scripts/sass_chain.py horner.sass --function horner_lanes_kernel \\
        --function ILb1E --steps-per-iteration 1

Reads a ``cuobjdump -sass`` dump, takes the function whose mangled name
holds every ``--function`` substring, finds its innermost loop (the
shortest backward branch whose body holds an integer multiply) and
walks the body in program order as a dataflow graph over registers
(R, UR, P, UP; a ``.WIDE`` result and a ``.64`` address are register
pairs).  Each instruction's result is ready at the latest of its
sources plus its latency.  The body runs several passes with the ready
times carried over, and the growth of the latest result per pass in
steady state is the loop's recurrence: the chain a step cannot beat
however many SMs run it.

Latencies are assumptions, not measurements (``LATENCY``): 4 cycles for
the fixed-latency integer pipe (IADD3, LOP3, SHF, SEL, ISETP, IMAD, MOV,
...), the dependent-issue latency microbenchmarks report for Volta and
later (Jia et al., "Dissecting the NVIDIA Volta GPU Architecture via
Microbenchmarking", 2018); 5 for the 64-bit IMAD.WIDE and IMAD.HI
forms; 23 for SHFL; loads count 0, since the loop's loads are issued a
step ahead of their use (csrc/horner.cu).  The floor of a ladder is
then steps x cycles a step / clock.

Prints one JSON object: the function, the loop's bounds and size, the
instructions on the chain and their opcodes, its cycles per iteration
and per step, and the floor in microseconds for ``--steps`` steps at
``--clock-ghz`` (default: 14 steps at the H100's 1.98 GHz).
"""

import argparse
import json
import re
import sys

LATENCY_DEFAULT = 4
LATENCY = {"IMAD.WIDE": 5, "IMAD.HI": 5, "SHFL": 23}
# variable-latency instructions whose results are not on the chain
ZERO_LATENCY = ("LDG", "LD", "LDS", "LDL", "LDC", "ULDC", "S2R", "S2UR",
                "CS2R")
NO_DEST = ("ST", "STG", "STS", "STL", "BRA", "EXIT", "BAR", "BSSY",
           "BSYNC", "WARPSYNC", "NOP", "YIELD", "CALL", "RET", "RED",
           "MEMBAR", "DEPBAR", "ERRBAR", "CCTL", "BPT")
SETP = ("ISETP", "FSETP", "DSETP", "PSETP", "PLOP3", "HSETP2", "UISETP",
        "UPSETP", "UPLOP3")
MULTIPLY = ("IMAD", "UIMAD")

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
REG = re.compile(r"^[!\-|~]*(U?R(?:\d+|Z)|U?P(?:\d+|T))(?:\.\w+)*$")


def split_operands(text):
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def parse(line):
    """(address, opcode, dest registers, source registers, branch target)
    of one SASS line, or None."""
    m = INSN.search(line)
    if not m:
        return None
    addr = int(m.group(1), 16)
    body = m.group(2).strip()
    guard = []
    if body.startswith("@"):
        pred, body = body.split(None, 1)
        guard = [pred.lstrip("@!")]
    parts = body.split(None, 1)
    opcode = parts[0]
    ops = split_operands(parts[1]) if len(parts) > 1 else []
    base = opcode.split(".")[0]
    target = None
    if base == "BRA" and ops:
        t = re.search(r"0x([0-9a-f]+)", ops[-1])
        target = int(t.group(1), 16) if t else None

    def regs(tok):
        """Registers a token names: a pair for .64 addresses."""
        found = []
        for r in re.findall(r"U?R\d+|U?P\d", tok):
            found.append(r)
            if tok.find(r + ".64") >= 0 and r.lstrip("U").startswith("R"):
                found.append(re.sub(r"\d+", lambda d: str(int(d.group()) + 1),
                                    r, count=1))
        return found

    dests, srcs = [], list(guard)
    wide = ".WIDE" in opcode or re.search(r"\.(64|128)\b", opcode)
    if base in NO_DEST:
        for tok in ops:
            srcs += regs(tok)
        return addr, opcode, dests, srcs, target
    i = 0
    if base in SETP:
        while i < len(ops) and re.match(r"^!?U?P(\d|T)$", ops[i]):
            dests += regs(ops[i])
            i += 1
    else:
        seen_r = False
        while i < len(ops):
            m2 = REG.match(ops[i])
            if not m2:
                break
            name = m2.group(1)
            is_pred = name.lstrip("U").startswith("P")
            if not is_pred and seen_r:
                break
            if not is_pred:
                seen_r = True
                d = regs(ops[i])
                if wide and d:
                    width = 4 if ".128" in opcode else 2
                    n0 = int(re.sub(r"\D", "", d[0]))
                    pre = re.match(r"U?R", d[0]).group()
                    d = [f"{pre}{n0 + k}" for k in range(width)]
                dests += d
            else:
                dests += regs(ops[i])
            i += 1
    for j, tok in enumerate(ops[i:]):
        r = regs(tok)
        # IMAD.WIDE's addend is a register pair
        if ".WIDE" in opcode and j == 2 and r and r[0].lstrip("U")[0] == "R":
            n0 = int(re.sub(r"\D", "", r[0]))
            r = [r[0], re.sub(r"\d+", str(n0 + 1), r[0], count=1)]
        srcs += r
    return addr, opcode, dests, srcs, target


def functions(text):
    out, name, lines = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                out[name] = lines
            name, lines = m.group(1), []
        elif name:
            p = parse(line)
            if p:
                lines.append(p)
    if name:
        out[name] = lines
    return out


def latency(opcode):
    base = opcode.split(".")[0]
    if base in ZERO_LATENCY:
        return 0
    for key, cycles in LATENCY.items():
        if opcode.startswith(key):
            return cycles
    return LATENCY_DEFAULT


def loops(insns):
    """(back-branch address, body) of every backward branch."""
    return [(addr, [x for x in insns if target <= x[0] <= addr])
            for addr, _, _, _, target in insns
            if target is not None and target <= addr]


def innermost_loop(insns, at=None):
    """The body of the loop whose backward branch sits at ``at``, or the
    shortest loop body that holds an integer multiply."""
    best = None
    for addr, body in loops(insns):
        if at is not None:
            if addr == at:
                return body
            continue
        if not any(x[1].split(".")[0] in MULTIPLY for x in body):
            continue
        if best is None or len(body) < len(best):
            best = body
    return best


def chain(body, passes=8):
    """(cycles an iteration, instructions of the critical path) of the
    loop ``body`` in steady state: the body runs ``passes`` times with
    each register's ready time carried from pass to pass, and the
    iteration's cycles are the growth of the latest result over the last
    half of the passes, so a recurrence the compiler rotated across the
    loop's back edge is counted whole."""
    ready, producer = {}, {}
    pred = {}
    ends = []
    for it in range(passes):
        longest, end = 0, None
        for k, (_, opcode, dests, srcs, _) in enumerate(body):
            node = (it, k)
            real = [s for s in srcs if s not in ("RZ", "URZ", "PT", "UPT")]
            start, pred[node] = 0, None
            for s in real:
                if ready.get(s, 0) > start:
                    start, pred[node] = ready[s], producer[s]
            t = start + latency(opcode)
            for d in dests:
                if d not in ("RZ", "URZ", "PT", "UPT"):
                    ready[d], producer[d] = t, node
            if dests and t > longest:
                longest, end = t, node
        ends.append((max(ready.values(), default=0), end))
    half = passes // 2
    cycles = (ends[-1][0] - ends[half - 1][0]) / (passes - half)
    # the critical path inside the last pass
    path, node = [], ends[-1][1]
    while node is not None and node[0] == passes - 1:
        path.append(body[node[1]])
        node = pred[node]
    return cycles, path[::-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump")
    ap.add_argument("--function", action="append", required=True,
                    help="a substring of the mangled name (repeatable)")
    ap.add_argument("--loop", type=lambda v: int(v, 16), default=None,
                    help="hex address of the loop's backward branch "
                    "(default: the shortest loop with a multiply)")
    ap.add_argument("--steps-per-iteration", type=int, default=1)
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--clock-ghz", type=float, default=1.98)
    opts = ap.parse_args()
    funcs = functions(open(opts.dump).read())
    names = [n for n in funcs if all(s in n for s in opts.function)]
    if len(names) != 1:
        print(f"sass_chain: {len(names)} functions match: {names}",
              file=sys.stderr)
        return 2
    insns = funcs[names[0]]
    body = innermost_loop(insns, opts.loop)
    if body is None:
        print("sass_chain: no loop with a multiply", file=sys.stderr)
        return 2
    cycles, path = chain(body)
    per_step = cycles / opts.steps_per_iteration
    ops = {}
    for _, opcode, _, _, _ in path:
        ops[opcode] = ops.get(opcode, 0) + 1
    print(json.dumps({
        "function": names[0],
        "loop": [hex(body[0][0]), hex(body[-1][0])],
        "loop_instructions": len(body),
        "loops": {hex(addr): len(b) for addr, b in loops(insns)},
        "steps_per_iteration": opts.steps_per_iteration,
        "chain_instructions": len(path),
        "chain_opcodes": ops,
        "chain_cycles_per_iteration": cycles,
        "chain_cycles_per_step": per_step,
        "steps": opts.steps,
        "clock_ghz": opts.clock_ghz,
        "floor_us": opts.steps * per_step / (opts.clock_ghz * 1e3),
        "latency_assumed": dict(LATENCY, default=LATENCY_DEFAULT,
                                loads=0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
