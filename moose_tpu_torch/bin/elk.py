"""elk: compiler CLI (reference ``moose/src/bin/elk/main.rs:22-97``).

Subcommands:
  compile  — read a computation (textual or msgpack), run compiler passes,
             write it back in either format
  stats    — static graph metrics: op-hist, op-count, out-degree

Examples:
  python -m moose_tpu_torch.bin.elk compile comp.moose -o comp.bin --passes typing,lowering,prune,networking,toposort --arg-specs specs.json
  python -m moose_tpu_torch.bin.elk stats op_hist comp.moose

The port's own copy of ``moose_tpu/bin/elk.py``.  ``--arg-specs`` feeds
the lowering pass: a JSON object of input name to ``[shape, dtype]``.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path


def _read_computation(path: str):
    from moose_tpu_torch.serde import load_computation

    return load_computation(path)


def _write_computation(comp, path: str | None, fmt: str):
    from moose_tpu_torch.serde import serialize_computation
    from moose_tpu_torch.textual import to_textual

    if fmt == "textual":
        out = to_textual(comp).encode()
    elif fmt == "dot":
        from moose_tpu_torch.compilation.print import to_dot

        out = to_dot(comp).encode()
    else:
        out = serialize_computation(comp)
    if path is None or path == "-":
        sys.stdout.buffer.write(out)
    else:
        Path(path).write_bytes(out)


def cmd_compile(args):
    comp = _read_computation(args.input)
    passes = None
    if args.passes is not None:
        passes = [p for p in args.passes.split(",") if p]
    if passes:
        from moose_tpu_torch.compilation import compile_computation

        arg_specs = None
        if args.arg_specs:
            raw = json.loads(Path(args.arg_specs).read_text())
            arg_specs = {
                k: (
                    v
                    if isinstance(v, (str, int, float))
                    else (tuple(v[0]), v[1])
                )
                for k, v in raw.items()
            }
        comp = compile_computation(comp, passes, arg_specs=arg_specs)
    fmt = args.format or (
        "textual" if (args.output or "").endswith((".moose", ".txt"))
        else "msgpack"
    )
    _write_computation(comp, args.output, fmt)


def cmd_stats(args):
    comp = _read_computation(args.input)
    if args.metric == "op_count":
        print(len(comp.operations))
    elif args.metric == "op_hist":
        hist = collections.Counter(
            op.kind for op in comp.operations.values()
        )
        for kind, n in hist.most_common():
            print(f"{n:8d} {kind}")
    elif args.metric == "out_degree":
        deg = collections.Counter()
        for op in comp.operations.values():
            for inp in op.inputs:
                deg[inp] += 1
        hist = collections.Counter(deg.values())
        hist[0] = len(comp.operations) - len(deg)
        for d in sorted(hist):
            print(f"{hist[d]:8d} ops with out-degree {d}")
    else:
        raise SystemExit(f"unknown metric {args.metric}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="elk", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_compile = sub.add_parser("compile", help="run compiler passes")
    p_compile.add_argument("input")
    p_compile.add_argument("-o", "--output", default=None)
    p_compile.add_argument(
        "--passes",
        default=None,
        help="comma-separated pass list (default: no passes, format "
        "conversion only)",
    )
    p_compile.add_argument(
        "--arg-specs",
        default=None,
        help="JSON file mapping input names to [shape, dtype] (required "
        "by the lowering pass: XLA static shapes)",
    )
    p_compile.add_argument(
        "--format", choices=["textual", "msgpack", "dot"], default=None
    )
    p_compile.set_defaults(fn=cmd_compile)

    p_stats = sub.add_parser("stats", help="static graph metrics")
    p_stats.add_argument(
        "metric", choices=["op_hist", "op_count", "out_degree"]
    )
    p_stats.add_argument("input")
    p_stats.set_defaults(fn=cmd_stats)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
