"""vixen: single-session worker over raw TCP networking (reference
``moose/src/bin/vixen/main.rs``): one process per identity, role
assignment from flags, executes one computation and prints its outputs.
The port's own copy of ``moose_tpu/bin/vixen.py``: the worker's tensors
live on ``--device`` (``cuda`` by default; ``cpu`` runs the plain
PyTorch path), and on the card it builds the kernels its role launches
before it opens its port.

  python -m moose_tpu_torch.bin.vixen --identity alice \
      --endpoints alice=127.0.0.1:21401,bob=127.0.0.1:21402,carole=127.0.0.1:21403 \
      --session-id s1 comp.moose --args args.json [--outputs out.npz]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .comet import parse_endpoints


def main(argv=None):
    parser = argparse.ArgumentParser(prog="vixen", description=__doc__)
    parser.add_argument("computation")
    parser.add_argument("--identity", required=True)
    parser.add_argument("--endpoints", required=True)
    parser.add_argument("--session-id", default="vixen")
    parser.add_argument("--args", default=None)
    parser.add_argument(
        "--passes", default="typing,lowering,prune,networking,toposort",
        help="set to '' if the computation is already lowered",
    )
    parser.add_argument("--storage-dir", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the worker's tensors (default: cuda; cpu runs "
        "the plain PyTorch path)",
    )
    parser.add_argument(
        "--outputs", default=None, metavar="NPZ",
        help="also write this role's outputs, as numpy arrays, to NPZ",
    )
    args = parser.parse_args(argv)

    import torch

    from moose_tpu_torch.compilation import compile_computation
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.distributed.choreography import WorkerServer
    from moose_tpu_torch.distributed.networking import TcpNetworking
    from moose_tpu_torch.distributed.worker import execute_role
    from moose_tpu_torch.serde import deserialize_computation
    from moose_tpu_torch.textual import parse_computation

    data = Path(args.computation).read_bytes()
    if args.computation.endswith((".moose", ".txt")) or data[:1].isalpha():
        comp = parse_computation(data.decode())
    else:
        comp = deserialize_computation(data)

    arguments = {}
    if args.args:
        raw = json.loads(Path(args.args).read_text())
        arguments = {
            k: (v if isinstance(v, (str, int, float)) else np.asarray(v))
            for k, v in raw.items()
        }

    passes = [p for p in args.passes.split(",") if p]
    if passes:
        # lowering samples fresh rendezvous nonces, so every vixen of one
        # session must get the SAME lowered graph: compile it once (elk)
        # and pass --passes '' to a multi-process run
        comp = compile_computation(
            comp, passes, arg_specs=arg_specs_from_arguments(arguments)
        )

    storage: dict = {}
    if args.storage_dir:
        from moose_tpu_torch.storage import FilesystemStorage

        storage = FilesystemStorage(args.storage_dir)

    device = torch.device(args.device)
    if device.type == "cuda":
        # built before the port opens: an nvcc at first use would stall
        # the session while the peers' receive clocks run
        from moose_tpu_torch.native import build

        for name in WorkerServer.WORKER_KERNELS:
            build.library(name)
    net = TcpNetworking(args.identity, parse_endpoints(args.endpoints),
                        device=device)
    net.start()
    try:
        result = execute_role(
            comp, args.identity, storage, arguments, net, args.session_id,
            device=device,
        )
    finally:
        net.stop()
    print(f"# {args.identity}: {result['elapsed_time_micros']} us")
    for name, value in result["outputs"].items():
        print(name, "=", value)
    if args.outputs:
        np.savez(args.outputs, **{
            name: np.asarray(value)
            for name, value in result["outputs"].items()
        })


if __name__ == "__main__":
    main()
