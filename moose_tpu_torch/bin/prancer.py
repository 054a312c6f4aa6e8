"""prancer: static-analysis linter for serialized computations.

Runs the graph analyses of :mod:`moose_tpu_torch.compilation.analysis` —
secrecy/information-flow (MSA1xx), communication pairing/deadlock
(MSA2xx), signature consistency (MSA3xx), graph hygiene (MSA4xx),
execution-plan schedule (MSA5xx), communication/memory cost (MSA6xx),
fixed-point value ranges (MSA7xx), PRF key lineage & stream discipline
(MSA8xx) —
over one or more computation files (textual ``.moose`` or msgpack, like
the rest of the reindeer tool family) and reports every finding.  Exit
status is 1 if any error-severity diagnostic fired (add
``--strict-warnings`` to also fail on warnings), so it slots directly
into CI.

``--schedule`` and ``--cost`` additionally emit the machine-readable
plan report for lowered/networked graphs: per-role segment schedules
reconstructed with the worker's own segmentation rules, and the static
cost model's per-party wire counters (tx/rx bytes, ``send_many``
envelope/payload counts after coalescing) plus per-segment live-buffer
high-water-marks.  ``--role`` filters the report to one role;
``--arg-shape name=16x8`` pins an Input/Load shape the model cannot
infer; ``--session-id`` sets the id whose length prices the transfer
keys (byte counts depend only on its length; the client mints
32-hex-char ids, the default).

``--keystream`` emits the MSA805 key & stream report: every PRF key
root with its generating party and holders, every seeded draw with its
(key, nonce, domain) stream coordinates, and the per-(party, key)
draw-count/stream-offset totals the dynamic draw oracle asserts
against.  Logical graphs are lowered internally, which needs
``--arg-shape`` for every Input/Load (without usable shapes the report
says so instead of guessing).

``--ranges`` emits the MSA7xx per-value precision report (fixed-point
intervals, raw-bit demand, minimal ring width).  ``--arg-range
name=-1:1`` declares a real-space input bound (repeatable; keyed by
Input name or Load/LoadShares storage key) — declared bounds are what
arm the MSA701/702 overflow errors; without them the analysis only
reports representable-interval worst cases.  ``--margin-bits`` tunes
the MSA702 thin-headroom threshold; ``--jumbo-bytes`` /
``--live-buffer-bytes`` tune the MSA602/MSA603 cost note thresholds
(env: ``MOOSE_TPU_LINT_MARGIN_BITS``, ``MOOSE_TPU_LINT_JUMBO_BYTES``,
``MOOSE_TPU_LINT_LIVE_BUFFER_BYTES``).

Examples:
  python -m moose_tpu_torch.bin.prancer comp.moose
  python -m moose_tpu_torch.bin.prancer lowered.bin --analyses communication,hygiene
  python -m moose_tpu_torch.bin.prancer comp.moose --passes typing,prune --format json
  python -m moose_tpu_torch.bin.prancer lowered.bin --schedule --cost --role alice \
      --format json
  python -m moose_tpu_torch.bin.prancer comp.moose --ranges \
      --arg-shape x=16x4 --arg-range x=-1:1 --arg-range w=-2:2
  python -m moose_tpu_torch.bin.prancer comp.moose --keystream --arg-shape x=16x4
  python -m moose_tpu_torch.bin.prancer --explain          # rule catalogue

The port's own copy of ``moose_tpu/bin/prancer.py``: the same flags,
output and exit codes on the same file.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_arg_shapes(pairs) -> dict:
    """``name=16x8`` (or ``name=16,8``) -> {name: (16, 8)}."""
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(
                f"--arg-shape expects name=DIMxDIM..., got {pair!r}"
            )
        name, _, dims = pair.partition("=")
        seps = dims.replace(",", "x")
        try:
            out[name] = tuple(
                int(d) for d in seps.split("x") if d != ""
            )
        except ValueError:
            raise SystemExit(
                f"--arg-shape expects integer dims, got {pair!r}"
            ) from None
    return out


def _parse_arg_ranges(pairs) -> dict:
    """``name=-1:1`` (or ``name=-1,1``) -> {name: (-1.0, 1.0)}."""
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(
                f"--arg-range expects name=LO:HI, got {pair!r}"
            )
        name, _, bounds = pair.partition("=")
        lo, sep, hi = bounds.replace(",", ":").partition(":")
        if not sep:
            raise SystemExit(
                f"--arg-range expects name=LO:HI, got {pair!r}"
            )
        try:
            out[name] = (float(lo), float(hi))
        except ValueError:
            raise SystemExit(
                f"--arg-range expects numeric bounds, got {pair!r}"
            ) from None
        if out[name][0] > out[name][1]:
            raise SystemExit(
                f"--arg-range lower bound exceeds upper in {pair!r}"
            )
    return out


def _context(args) -> dict:
    """Analysis context from the CLI flags (analyze() forwards each key
    only to the analysis that understands it)."""
    ctx: dict = {}
    arg_specs = _parse_arg_shapes(args.arg_shape)
    if arg_specs:
        ctx["arg_specs"] = arg_specs
    arg_ranges = _parse_arg_ranges(args.arg_range)
    if arg_ranges:
        ctx["arg_ranges"] = arg_ranges
    if args.margin_bits is not None:
        ctx["margin_bits"] = args.margin_bits
    if args.jumbo_bytes is not None:
        ctx["jumbo_bytes"] = args.jumbo_bytes
    if args.live_buffer_bytes is not None:
        ctx["live_buffer_bytes"] = args.live_buffer_bytes
    return ctx


def _load(path: str, args):
    from moose_tpu_torch.serde import load_computation

    comp = load_computation(path)
    if args.passes:
        from moose_tpu_torch.compilation import compile_computation

        passes = [p for p in args.passes.split(",") if p]
        comp = compile_computation(comp, passes)
    return comp


def _lint(comp, args) -> list:
    from moose_tpu_torch.compilation.analysis import analyze

    analyses = None
    if args.analyses:
        analyses = [a for a in args.analyses.split(",") if a]
    ignore = [r for r in (args.ignore or "").split(",") if r]
    return analyze(comp, analyses=analyses, ignore=ignore,
                   context=_context(args) or None)


def _plan_report(comp, args) -> dict:
    """The ``--schedule``/``--cost``/``--ranges`` report for one
    computation."""
    from moose_tpu_torch.compilation.analysis import (
        cost_report,
        keystream_report,
        range_report,
        reconstruct_schedules,
    )
    from moose_tpu_torch.compilation.analysis.schedule import _analyzable

    report: dict = {}
    if args.keystream:
        report["keystream"] = keystream_report(
            comp,
            arg_specs=_parse_arg_shapes(args.arg_shape) or None,
        )
    if args.ranges:
        # the range report works on any graph (logical or lowered) —
        # it does not need a schedulable host-level computation
        report["ranges"] = range_report(
            comp,
            arg_specs=_parse_arg_shapes(args.arg_shape) or None,
            arg_ranges=_parse_arg_ranges(args.arg_range) or None,
        )
    if not (args.schedule or args.cost):
        return report  # keystream/ranges need no schedulable graph
    if not _analyzable(comp):
        report["analyzable"] = False
        return report
    report["analyzable"] = True
    all_schedules = reconstruct_schedules(comp)
    schedules = all_schedules
    if args.role:
        if args.role not in schedules:
            raise SystemExit(
                f"--role {args.role!r} not in this computation; roles: "
                f"{sorted(schedules)}"
            )
        schedules = {args.role: schedules[args.role]}
    if args.schedule:
        report["schedule"] = {
            role: sched.summary() for role, sched in schedules.items()
        }
    if args.cost:
        cost = cost_report(
            comp,
            session_id=args.session_id,
            arg_specs=_parse_arg_shapes(args.arg_shape) or None,
            transport=args.transport,
            # cost is cross-role even when the DISPLAY is filtered, so
            # hand it the unfiltered schedules (no re-reconstruction)
            schedules=all_schedules,
        )
        if args.role:
            cost["per_party"] = {
                args.role: cost["per_party"][args.role]
            }
        report["cost"] = cost
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="prancer",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "computations", nargs="*",
        help="computation files to lint (textual .moose or msgpack)",
    )
    parser.add_argument(
        "--analyses", default=None,
        help="comma-separated analyses to run (default: all; secrecy,"
             "communication,signatures,hygiene,schedule,cost,ranges,"
             "keystream)",
    )
    parser.add_argument(
        "--ignore", default=None,
        help="comma-separated rule ids or family prefixes to suppress "
             "(e.g. MSA402 or MSA4)",
    )
    parser.add_argument(
        "--passes", default=None,
        help="compiler passes to run before linting (e.g. "
             "typing,prune,networking — lint the graph the workers "
             "would actually execute)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    parser.add_argument(
        "--strict-warnings", action="store_true",
        help="exit nonzero on warnings too, not just errors",
    )
    parser.add_argument(
        "--schedule", action="store_true",
        help="emit each role's reconstructed worker-plan schedule "
             "(segments, hoists, deferred flush groups)",
    )
    parser.add_argument(
        "--cost", action="store_true",
        help="emit the static cost report (per-party tx/rx bytes, "
             "send_many envelopes/payloads, live-buffer high-water "
             "marks)",
    )
    parser.add_argument(
        "--role", default=None,
        help="filter the --schedule/--cost report to one role",
    )
    parser.add_argument(
        "--session-id", default="0" * 32,
        help="session id used to price transfer keys (only its LENGTH "
             "affects byte counts; default matches the client's "
             "32-hex-char ids)",
    )
    parser.add_argument(
        "--transport", choices=("grpc", "local"), default="grpc",
        help="wire-envelope semantics for --cost (default grpc)",
    )
    parser.add_argument(
        "--arg-shape", action="append", default=None,
        metavar="NAME=16x8",
        help="pin an Input/Load op's shape for the cost and range "
             "models (repeatable)",
    )
    parser.add_argument(
        "--ranges", action="store_true",
        help="emit the MSA7xx per-value precision report (fixed-point "
             "intervals, raw-bit demand, minimal ring width)",
    )
    parser.add_argument(
        "--keystream", action="store_true",
        help="emit the MSA8xx key & stream report (key roots/holders, "
             "per-(party, key) draw counts and stream offsets — the "
             "static side of the dynamic draw oracle)",
    )
    parser.add_argument(
        "--arg-range", action="append", default=None,
        metavar="NAME=LO:HI",
        help="declare a real-space bound for an Input (by name) or "
             "Load/LoadShares (by storage key); declared bounds arm "
             "the MSA701/702 overflow checks (repeatable)",
    )
    parser.add_argument(
        "--margin-bits", type=float, default=None,
        help="MSA702 thin-headroom threshold in bits (default 2; env "
             "MOOSE_TPU_LINT_MARGIN_BITS)",
    )
    parser.add_argument(
        "--jumbo-bytes", type=int, default=None,
        help="MSA602 jumbo-transfer note threshold in bytes (default "
             "64 MiB; env MOOSE_TPU_LINT_JUMBO_BYTES)",
    )
    parser.add_argument(
        "--live-buffer-bytes", type=int, default=None,
        help="MSA603 live-buffer note threshold in bytes (default "
             "1 GiB; env MOOSE_TPU_LINT_LIVE_BUFFER_BYTES)",
    )
    parser.add_argument(
        "--explain", action="store_true",
        help="print the rule catalogue and exit",
    )
    args = parser.parse_args(argv)

    from moose_tpu_torch.compilation.analysis import RULES, Severity

    if args.explain:
        for rule_id in sorted(RULES):
            print(f"{rule_id}  {RULES[rule_id]}")
        return 0
    if not args.computations:
        parser.error("no computation files given (or use --explain)")

    threshold = (
        Severity.WARNING if args.strict_warnings else Severity.ERROR
    )
    want_report = (
        args.schedule or args.cost or args.ranges or args.keystream
    )
    failed = False
    records = []
    reports = {}
    counts = {s: 0 for s in Severity}
    for path in args.computations:
        try:
            comp = _load(path, args)
            diagnostics = _lint(comp, args)
        except Exception as e:  # noqa: BLE001 — unloadable/uncompilable
            # file: report it and keep linting the rest of the batch
            failed = True
            counts[Severity.ERROR] += 1
            msg = f"cannot load/compile: {type(e).__name__}: {e}"
            if args.format == "json":
                records.append({
                    "file": path, "rule": "prancer", "severity": "error",
                    "op": None, "placement": None, "message": msg,
                })
            else:
                print(f"{path}: {msg}", file=sys.stderr)
            continue
        for d in diagnostics:
            counts[d.severity] += 1
            if d.severity >= threshold:
                failed = True
            if args.format == "json":
                records.append({"file": path, **d.to_dict()})
            else:
                print(f"{path}: {d.format()}")
        if want_report:
            try:
                reports[path] = _plan_report(comp, args)
            except SystemExit:
                raise
            except Exception as e:  # noqa: BLE001 — report failure must
                # not mask the lint verdict
                reports[path] = {
                    "error": f"{type(e).__name__}: {e}"
                }
    if args.format == "json":
        payload: object = records
        if want_report:
            payload = {"diagnostics": records, "reports": reports}
        json.dump(payload, sys.stdout, indent=2)
        print()
    else:
        if want_report:
            for path, report in reports.items():
                print(f"# {path} plan report")
                json.dump(report, sys.stdout, indent=2)
                print()
        print(
            f"{len(args.computations)} file(s): "
            f"{counts[Severity.ERROR]} error(s), "
            f"{counts[Severity.WARNING]} warning(s), "
            f"{counts[Severity.INFO]} info(s)"
        )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
