#!/usr/bin/env python3
"""Every kind of the logical dialect at operand ranks 0, 1, 3 and 4,
through the JAX package's and the port's ``LocalMooseRuntime`` on the
CPU, with a table of where they diverge.

The kinds are ``HOST_KINDS`` and ``REP_KINDS`` of
tests/test_torch_per_host_runtime.py and the protocol library's 25
replicated kinds (``chip_smoke.LIBRARY_KINDS``).  Each runs once per
rank in a small graph (x on alice, y on bob, both float64 cast to the
fixed-point dtype, the kind on its placement, the result to carole) on
the routes ``stacked`` and ``per-host`` (the logical walk,
``use_jit=False``) and ``lowered`` (``compiler_passes=DEFAULT_PASSES``,
the physical executor; a graph both lowerings refuse is recorded as
such and not run), under ``MOOSE_TPU_FIXED_KEYS`` and the ``threefry``
PRF, at ``fixed(24,40)``.  The Dot family (host and replicated) also
runs at ``fixed(14,23)`` and on the operand pairs of the ring Dot's
contraction rule (``PAIRS``).

A case's outcome in each package is the output's shapes and dtypes, or
the exception's type; the two agree when both refuse or when both give
bit-equal outputs (the words are equal: decoding is deterministic).
Rank 2 is held by the tests.  The JAX side dominates the time (a
stacked Softmax costs ~20 s of eager compiles), so run it in chunks:

    JAX_PLATFORMS=cpu python scripts/torch_rank_sweep.py \\
        --kinds host:Dot,rep:Dot --ranks 1,3 --out sweep.jsonl

``--out`` appends one JSON line a case; ``--table FILE...`` prints the
divergences of earlier runs' lines without running anything."""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402

IDS = ["alice", "bob", "carole"]
SHAPES = {0: (), 1: (3,), 3: (2, 2, 3), 4: (1, 2, 2, 3)}
FX = (24, 40)
DOT_FX = (14, 23)
# the operand pairs of the ring Dot's rule, x @ y: x's last axis
# against y's first, at any rank; the last two the JAX package refuses
PAIRS = (
    ((2, 3, 4), (4, 5)), ((2, 3, 4), (4,)), ((2, 3, 4, 5), (5, 2)),
    ((3, 4), (4, 5, 6)), ((4,), (4, 5, 6)), ((2, 2, 3), (3, 2, 2)),
    ((2, 3, 4), (2, 4, 5)), ((2, 3, 4), (2, 3, 4)),
)
ROUTES = ("stacked", "per-host", "lowered")
SYNC_SEED = 20261018


def kinds():
    """``family:Kind`` of every kind the sweep runs."""
    import test_torch_per_host_runtime as rt

    rep = list(rt.REP_KINDS) + [k for k in rt.cs.LIBRARY_KINDS
                                if k not in rt.REP_KINDS]
    return [f"host:{k}" for k in rt.HOST_KINDS] + [f"rep:{k}" for k in rep]


def cases(selected, ranks):
    """(kind, label, x shape, y shape, precision) of every case."""
    out = []
    for kind in selected:
        dot = kind.endswith(":Dot")
        for r in (r for r in ranks if r != "pairs"):
            out.append((kind, f"r{r}", SHAPES[r], SHAPES[r], FX))
            if dot:
                out.append((kind, f"r{r}", SHAPES[r], SHAPES[r], DOT_FX))
        if dot and "pairs" in ranks:
            for xs, ys in PAIRS:
                label = "x".join(map(str, xs)) + "@" + "x".join(map(str, ys))
                for fx in (FX, DOT_FX):
                    out.append((kind, label, xs, ys, fx))
    return out


def _expr(pm, op, r, shape, x, xf, yf, pair, fx):
    """``op`` once on operands of rank ``r``: the expressions of
    tests/test_torch_per_host_runtime.py's ``_kind_expr`` with every
    axis, index and shape taken from the rank (the last axis where the
    kind takes one)."""
    from importlib import import_module

    edsl = import_module(f"{pm.__name__}.edsl.base")
    last = r - 1
    n = shape[-1] if shape else 1
    rev = tuple(reversed(shape))

    def pos():
        return pm.add(pm.mul(xf, xf), pm.constant(np.array(0.5), dtype=fx))

    def lt():
        return pm.less(xf, yf)

    def kernel():
        return pm.cast(pm.constant(np.full((2, 2, n, 1), 0.25),
                                   dtype=pm.float64), dtype=fx)

    return {
        "Constant": lambda: pm.constant(
            np.linspace(-1.0, 1.0, max(1, int(np.prod(shape))))
            .reshape(shape), dtype=fx),
        "Identity": lambda: pm.identity(xf),
        "Output": lambda: pm.identity(x),
        "Cast": lambda: pm.cast(xf, dtype=pm.fixed(14, 23)),
        "Shape": lambda: pm.shape(xf),
        "Ones": lambda: pm.ones(pm.shape(x), dtype=pm.float64),
        "Zeros": lambda: pm.zeros(pm.shape(x), dtype=pm.float64),
        "Inverse": lambda: pm.inverse(pm.add(
            pm.dot(x, pm.transpose(x)),
            pm.constant(np.eye(2), dtype=pm.float64))),
        "Add": lambda: pm.add(xf, yf),
        "Sub": lambda: pm.sub(xf, yf),
        "Mul": lambda: pm.mul(xf, yf),
        "Div": lambda: pm.div(xf, pos()),
        "Dot": lambda: pm.dot(xf, yf if pair else pm.transpose(yf)),
        "Conv2D": lambda: pm.conv2d(xf, kernel()),
        "AvgPool2D": lambda: pm.avg_pool2d(xf, pool_size=(2, 2),
                                           strides=(1, 1)),
        "MaxPool2D": lambda: pm.max_pool2d(xf, pool_size=(2, 2),
                                           strides=(1, 1)),
        "AddN": lambda: pm.add_n([xf, yf, xf]),
        "Neg": lambda: pm.neg(xf),
        "Less": lt,
        "Greater": lambda: pm.greater(xf, yf),
        "Equal": lambda: pm.equal(xf, xf),
        "And": lambda: pm.logical_and(lt(), pm.greater(xf, yf)),
        "Or": lambda: pm.logical_or(lt(), pm.greater(xf, yf)),
        "Xor": lambda: pm.logical_xor(lt(), pm.greater(xf, yf)),
        "Mux": lambda: pm.mux(lt(), xf, yf),
        "Sum": lambda: pm.sum(xf, axis=last),
        "Mean": lambda: pm.mean(xf, axis=last),
        "Exp": lambda: pm.exp(xf),
        "Log": lambda: pm.log(pos()),
        "Log2": lambda: pm.log2(pos()),
        "Sqrt": lambda: pm.sqrt(pos()),
        "Sigmoid": lambda: pm.sigmoid(xf),
        "Relu": lambda: pm.relu(xf),
        "Abs": lambda: pm.abs(xf),
        "Softmax": lambda: pm.softmax(xf, axis=last, upmost_index=n),
        "Argmax": lambda: pm.argmax(xf, axis=last, upmost_index=n),
        "Maximum": lambda: pm.maximum([xf, yf]),
        "Concat": lambda: pm.concatenate([xf, yf], axis=max(last, 0)),
        "Reshape": lambda: pm.reshape(xf, rev),
        "ExpandDims": lambda: pm.expand_dims(xf, axis=[0, r + 1]),
        "Squeeze": lambda: pm.squeeze(pm.expand_dims(xf, axis=0), axis=0),
        "Transpose": lambda: pm.transpose(xf),
        "IndexAxis": lambda: pm.index_axis(xf, axis=last, index=n - 1),
        "AtLeast2D": lambda: pm.atleast_2d(x, to_column_vector=True),
        "Broadcast": lambda: edsl.broadcast_to(
            pm.index_axis(xf, 0, 0), pm.shape(xf)),
        "Slice": lambda: pm.strided_slice(
            xf, (slice(None),) * last + (slice(None, None, -1),)),
        "Select": lambda: pm.select(xf, max(last, 0), pm.constant(
            np.array([True, False, True][:n]), dtype=pm.bool_)),
        "AddConstant": lambda: pm.add(
            xf, pm.constant(np.array(1.25), dtype=fx)),
        "MulConstant": lambda: pm.mul(
            xf, pm.constant(np.array(-0.5), dtype=fx)),
    }[op]()


def graph(pm, kind, label, xs, ys, fx_prec):
    # the kinds whose result is fixed-point (cast to float64 on carole)
    from test_torch_per_host_runtime import _FIXED_OUT

    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*fx_prec)
    family, op = kind.split(":")
    pair = not label.startswith("r")
    r = len(xs)

    @pm.computation
    def comp(x: pm.Argument(alice, dtype=pm.float64),
             y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        with {"host": alice, "rep": rep}[family]:
            out = _expr(pm, op, r, xs, x, xf, yf, pair, fx)
        with carole:
            if op in _FIXED_OUT:
                out = pm.cast(out, dtype=pm.float64)
            else:
                out = pm.identity(out)
        return out

    return comp


def _refusal(e):
    return {"error": type(e).__name__, "message": str(e)[:160]}


def _run(package, comp, args, route):
    """One package's outcome of ``comp`` on ``route``."""
    if package == "jax":
        import moose_tpu as pm
        from moose_tpu.compilation import DEFAULT_PASSES, compile_computation
        from moose_tpu.compilation.lowering import arg_specs_from_arguments
        from moose_tpu.dialects import host
        from moose_tpu.edsl import tracer
        from moose_tpu.runtime import LocalMooseRuntime as Runtime
        kw = {"use_jit": False}
    else:
        import moose_tpu_torch as pm  # noqa: F401
        from moose_tpu_torch.compilation import (
            DEFAULT_PASSES, compile_computation)
        from moose_tpu_torch.compilation.lowering import (
            arg_specs_from_arguments)
        from moose_tpu_torch.dialects import host
        from moose_tpu_torch.edsl import tracer
        from moose_tpu_torch.runtime import LocalMooseRuntime as Runtime
        kw = {"use_jit": False, "device": "cpu"}
    started = time.time()
    try:
        if route == "lowered":
            traced = tracer.trace(comp)
            with host.deterministic_sync_keys(SYNC_SEED):
                try:
                    compile_computation(traced, DEFAULT_PASSES,
                                        arg_specs_from_arguments(args))
                except Exception as e:  # noqa: BLE001
                    out = {"lowering": "refused", **_refusal(e)}
                    return out | {"s": time.time() - started}
                got = Runtime(IDS, layout="per-host", **kw) \
                    .evaluate_computation(traced, args,
                                          compiler_passes=DEFAULT_PASSES)
            layout = "lowered"
        else:
            runtime = Runtime(IDS, layout=route, **kw)
            got = runtime.evaluate_computation(comp, args)
            layout = runtime.last_plan.get("layout")
    except Exception as e:  # noqa: BLE001
        return _refusal(e) | {"s": time.time() - started}
    values = {k: np.asarray(v) for k, v in got.items()}
    return {"layout": layout, "s": time.time() - started,
            "outputs": {k: [list(v.shape), str(v.dtype)]
                        for k, v in values.items()},
            "_values": values}


def verdict(jax, port):
    """'agree' or what diverges."""
    if "error" in jax and "error" in port:
        return "agree"
    if "error" in jax:
        return "port gives a result where the reference refuses"
    if "error" in port:
        return "port refuses where the reference gives a result"
    if jax["outputs"] != port["outputs"]:
        return "shapes or dtypes differ"
    for name, want in jax["_values"].items():
        got = port["_values"][name]
        if not np.array_equal(got, want, equal_nan=got.dtype.kind == "f"):
            return "words differ"
    return "agree"


def run_case(case, routes, seed=0):
    from torch_parity import fixed_keys_env, prf

    import moose_tpu as jm
    import moose_tpu_torch as tm

    kind, label, xs, ys, fx = case
    rng = np.random.default_rng(seed)
    args = {"x": rng.normal(size=xs), "y": rng.normal(size=ys)}
    jcomp, tcomp = (graph(pm, kind, label, xs, ys, fx) for pm in (jm, tm))
    rows = []
    for route in routes:
        with prf("threefry"), fixed_keys_env():
            jax = _run("jax", jcomp, args, route)
            port = _run("port", tcomp, args, route)
        row = {"kind": kind, "case": label, "x": list(xs), "y": list(ys),
               "fixed": list(fx), "route": route, "verdict":
               verdict(jax, port),
               "jax": {k: v for k, v in jax.items() if k != "_values"},
               "port": {k: v for k, v in port.items() if k != "_values"}}
        rows.append(row)
        print(f"{kind:18s} {label:16s} fixed{fx} {route:9s} "
              f"{row['verdict']:52s} jax {_brief(jax)} | port "
              f"{_brief(port)}", flush=True)
    return rows


def _brief(outcome):
    if "error" in outcome:
        head = "lowering " if outcome.get("lowering") else ""
        return f"{head}{outcome['error']} ({outcome['s']:.1f} s)"
    shapes = ",".join("x".join(map(str, s)) or "()"
                      for s, _ in outcome["outputs"].values())
    return f"{shapes} ({outcome['s']:.1f} s)"


def table(rows):
    """The divergences as a markdown table."""
    lines = ["| kind | case | fixed | route | verdict | JAX | port |",
             "|---|---|---|---|---|---|---|"]
    for row in rows:
        if row["verdict"] == "agree":
            continue

        def say(o):
            if "error" in o:
                return f"`{o['error']}`: {o['message'][:70]}"
            return "; ".join(f"{tuple(s)} {d}" for s, d in
                             o["outputs"].values())

        lines.append(
            f"| {row['kind']} | {row['case']} | {tuple(row['fixed'])} | "
            f"{row['route']} | {row['verdict']} | {say(row['jax'])} | "
            f"{say(row['port'])} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", help="comma-separated family:Kind or Kind "
                    "(both families); default every kind")
    ap.add_argument("--ranks", default="0,1,3,4,pairs",
                    help="ranks of x and y; 'pairs' adds the Dot "
                    "family's PAIRS")
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--out", help="append one JSON line a case here")
    ap.add_argument("--table", nargs="*", help="print the divergences "
                    "of these JSON-lines files and exit")
    args = ap.parse_args(argv)
    if args.table is not None:
        rows = [json.loads(line) for f in args.table
                for line in Path(f).read_text().splitlines() if line]
        print(table(rows))
        print(f"\n{len(rows)} case-routes, "
              f"{sum(r['verdict'] != 'agree' for r in rows)} diverge")
        return 0
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    every = kinds()
    if args.kinds:
        want = args.kinds.split(",")
        selected = [k for k in every
                    if k in want or k.split(":")[1] in want]
    else:
        selected = every
    ranks = [r if r == "pairs" else int(r)
             for r in args.ranks.split(",") if r]
    routes = args.routes.split(",")
    rows = []
    out = open(args.out, "a") if args.out else contextlib.nullcontext()
    with out:
        for case in cases(selected, ranks):
            for row in run_case(case, routes):
                rows.append(row)
                if args.out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
    print()
    print(table(rows))
    print(f"\n{len(rows)} case-routes, "
          f"{sum(r['verdict'] != 'agree' for r in rows)} diverge")
    return 0


if __name__ == "__main__":
    sys.exit(main())
