"""rudolph: worker with filesystem choreography + gRPC networking
(reference ``moose/src/bin/rudolph/main.rs`` +
``choreography/filesystem.rs:28-259``): watches a directory for
``*.session`` TOML files and launches each session it finds.  The port's
own copy of ``moose_tpu/bin/rudolph.py``: the worker's tensors live on
``--device`` (``cuda`` by default), and SIGTERM stops the worker, which
then exits 0.

  python -m moose_tpu_torch.bin.rudolph --identity alice --port 50001 \
      --sessions-dir ./sessions [--poll-interval 1.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import threading

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    import tomli as tomllib
from pathlib import Path

import numpy as np


def _launch_from_file(server, path: Path, log):
    cfg = tomllib.loads(path.read_text())
    session_id = cfg.get("session_id") or path.stem
    comp_path = (path.parent / cfg["computation"]["path"]).resolve()
    data = comp_path.read_bytes()
    from moose_tpu_torch.serde import serialize_computation
    from moose_tpu_torch.textual import parse_computation

    if str(comp_path).endswith((".moose", ".txt")) or data[:1].isalpha():
        comp_bytes = serialize_computation(
            parse_computation(data.decode())
        )
    else:
        comp_bytes = data
    roles = dict(cfg["roles"])
    server.endpoints.update(roles)
    server.networking._endpoints.update(roles)
    arguments = {}
    args_path = cfg.get("arguments")
    if args_path:
        import json

        raw = json.loads((path.parent / args_path).read_text())
        arguments = {
            k: (v if isinstance(v, (str, int, float)) else np.asarray(v))
            for k, v in raw.items()
        }
    import msgpack

    from moose_tpu_torch.serde import serialize_value

    server._launch(
        msgpack.packb(
            {
                "session_id": session_id,
                "computation": comp_bytes,
                "arguments": {
                    k: serialize_value(v) for k, v in arguments.items()
                },
            },
            use_bin_type=True,
        )
    )
    log.info("launched session %s from %s", session_id, path.name)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="rudolph", description=__doc__)
    parser.add_argument("--identity", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--sessions-dir", required=True)
    parser.add_argument("--poll-interval", type=float, default=1.0)
    parser.add_argument("--storage-dir", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the worker's tensors (default: cuda; cpu runs "
        "the plain PyTorch path)",
    )
    parser.add_argument("--once", action="store_true",
                        help="scan once and exit (tests)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("rudolph")

    from moose_tpu_torch.distributed.choreography import WorkerServer

    storage = None
    if args.storage_dir:
        from moose_tpu_torch.storage import FilesystemStorage

        storage = FilesystemStorage(args.storage_dir)
    server = WorkerServer(
        args.identity, args.port, {}, storage=storage, device=args.device,
    ).start()
    stopping = threading.Event()
    if threading.current_thread() is threading.main_thread():
        import signal

        # SIGTERM stops the worker: the watch loop ends and rudolph
        # exits 0.  Installed before the line that says it is watching,
        # so a supervisor that signals on that line never meets the
        # default handler
        signal.signal(signal.SIGTERM, lambda *_: stopping.set())
    log.info("worker %s on port %d watching %s", args.identity,
             server.port, args.sessions_dir)

    seen: set = set()
    sessions_dir = Path(args.sessions_dir)
    try:
        while not stopping.is_set():
            for path in sorted(sessions_dir.glob("*.session")):
                stamp = (path.name, path.stat().st_mtime_ns)
                if stamp in seen:
                    continue
                seen.add(stamp)
                try:
                    _launch_from_file(server, path, log)
                except Exception as e:
                    log.error("failed to launch %s: %s", path.name, e)
            if args.once:
                break
            stopping.wait(args.poll_interval)
    finally:
        if stopping.is_set():
            server.stop(grace=1.0)


if __name__ == "__main__":
    main()
