"""dasher: single-process simulator of all roles — every identity runs as
a thread over in-memory networking (reference ``moose/src/bin/dasher``).
The port's own copy of ``moose_tpu/bin/dasher.py``: every role's tensors
live on ``--device`` (``cuda`` by default; ``cpu`` runs the plain
PyTorch path).

  python -m moose_tpu_torch.bin.dasher comp.moose --args args.json
"""

from __future__ import annotations

import argparse
import json
import threading
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dasher", description=__doc__)
    parser.add_argument("computation")
    parser.add_argument("--args", default=None)
    parser.add_argument(
        "--passes", default="typing,lowering,prune,networking,toposort"
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of every role's tensors (default: cuda; cpu runs "
        "the plain PyTorch path)",
    )
    parser.add_argument(
        "--timeout", type=float, default=120.0,
        help="seconds a role waits on a receive, and on its peers",
    )
    args = parser.parse_args(argv)

    from moose_tpu_torch.compilation import compile_computation
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.computation import HostPlacement
    from moose_tpu_torch.distributed.networking import LocalNetworking
    from moose_tpu_torch.distributed.worker import (
        execute_role,
        execute_role_legacy,
    )
    from moose_tpu_torch.distributed.worker_plan import worker_jit_enabled
    from moose_tpu_torch.serde import load_computation

    # one-shot simulation, the JAX dasher's rule: the worker fast path's
    # validation pays off from a computation's later sessions, and a
    # dasher run is one session, so the legacy scheduler runs unless
    # MOOSE_TPU_WORKER_JIT=1 opts in (the environment is left as it is)
    run_role = (execute_role if worker_jit_enabled(default=False)
                else execute_role_legacy)

    comp = load_computation(args.computation)

    arguments = {}
    if args.args:
        raw = json.loads(Path(args.args).read_text())
        arguments = {
            k: (v if isinstance(v, (str, int, float)) else np.asarray(v))
            for k, v in raw.items()
        }

    passes = [p for p in args.passes.split(",") if p]
    if passes:
        comp = compile_computation(
            comp, passes, arg_specs=arg_specs_from_arguments(arguments)
        )

    identities = sorted(
        p.name
        for p in comp.placements.values()
        if isinstance(p, HostPlacement)
    )
    net = LocalNetworking(device=args.device)
    if net.device.type == "cuda":
        # every kernel a role launches, built before the roles start
        from moose_tpu_torch.distributed.choreography import WorkerServer
        from moose_tpu_torch.native import build

        build.build_all(WorkerServer.WORKER_KERNELS)
    results: dict = {}
    errors: dict = {}

    def work(identity):
        try:
            results[identity] = run_role(
                comp, identity, {}, arguments, net, session_id="dasher",
                timeout=args.timeout,
            )
        except Exception as e:  # noqa: BLE001 — reported below
            errors[identity] = e

    threads = [
        threading.Thread(target=work, args=(i,), daemon=True)
        for i in identities
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(args.timeout)
    if errors or len(results) < len(identities):
        raise SystemExit(
            "dasher: "
            + "; ".join(
                f"{i}: {type(e).__name__}: {e}" for i, e in errors.items()
            )
            if errors else "dasher: a role did not finish in time"
        )
    for identity in identities:
        r = results[identity]
        print(f"# {identity}: {r['elapsed_time_micros']} us")
        for name, value in r["outputs"].items():
            print(name, "=", value)


if __name__ == "__main__":
    main()
