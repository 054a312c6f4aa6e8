"""comet: worker daemon — gRPC choreography + gRPC networking + filesystem
storage (reference ``moose/src/bin/comet/comet.rs:12-83``).  The port's
own copy of ``moose_tpu/bin/comet.py``: the worker's tensors live on
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch path),
and on the card it builds the kernels its role launches before it opens
its port.

  python -m moose_tpu_torch.bin.comet --identity alice --port 50001 \
      --endpoints alice=localhost:50001,bob=localhost:50002,carole=localhost:50003 \
      [--storage-dir /data/alice] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_endpoints(spec: str) -> dict:
    out = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, endpoint = part.partition("=")
        out[name.strip()] = endpoint.strip()
    return out


def main(argv=None, on_start=None):
    """Run the daemon until its server terminates.  ``on_start`` (for an
    embedding caller, such as a test running the daemon on a thread) is
    called with the started :class:`WorkerServer`."""
    parser = argparse.ArgumentParser(prog="comet", description=__doc__)
    parser.add_argument(
        "--identity", required=True,
        default=os.environ.get("MOOSE_IDENTITY"),
    )
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument(
        "--endpoints", required=True,
        help="identity=host:port,... for every worker (gRPC networking "
        "peer table)",
    )
    parser.add_argument(
        "--storage-dir", default=None,
        help="directory for .npy/.csv filesystem storage (in-memory dict "
        "if omitted)",
    )
    parser.add_argument(
        "--checkpoint", action="store_true",
        default=os.environ.get("MOOSE_TPU_CHECKPOINT") == "1",
        help="wrap the filesystem storage in a training CheckpointStore "
        "(secret-shared checkpoint staging/commit/pin protocol + the "
        "StorageControl rpc; requires --storage-dir; also enabled by "
        "MOOSE_TPU_CHECKPOINT=1)",
    )
    parser.add_argument(
        "--tls-cert", default=None,
        help="PEM certificate chain for this identity (CN *and* a "
        "subjectAltName DNS entry must equal --identity — gRPC checks "
        "the SAN); enables mTLS (reference comet certificate flags)",
    )
    parser.add_argument("--tls-key", default=None,
                        help="PEM private key for --tls-cert")
    parser.add_argument("--tls-ca", default=None,
                        help="PEM CA bundle that signs every party")
    parser.add_argument(
        "--choreographer", default=None,
        help="only this certificate CN may launch/abort sessions "
        "(requires the --tls-* flags)",
    )
    parser.add_argument(
        "--telemetry", nargs="?", const="http://localhost:4318",
        default=os.environ.get("MOOSE_TPU_OTLP"), metavar="OTLP_ENDPOINT",
        help="export spans to an OTLP/HTTP collector (Jaeger, Tempo, "
        "otel-collector); bare --telemetry targets the local default "
        "collector port, like the reference's comet --telemetry "
        "(comet.rs:30-41)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="HTTP metrics/health port: GET /metrics serves Prometheus "
        "text from the unified registry, /healthz a JSON health "
        "document, /v1/metrics the JSON snapshot (default: "
        "MOOSE_TPU_METRICS_PORT; 0 picks an ephemeral port; unset "
        "disables)",
    )
    parser.add_argument(
        "--receive-timeout", type=float, default=None,
        help="seconds a blocked receive tolerates zero session progress "
        "before failing retryably (default: MOOSE_TPU_RECEIVE_TIMEOUT "
        "or 120)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the worker's tensors (default: cuda; cpu runs "
        "the plain PyTorch path)",
    )
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.telemetry:
        from moose_tpu_torch import telemetry

        telemetry.configure_otlp(
            args.telemetry,
            service_name=os.environ.get(
                "MOOSE_TPU_OTLP_SERVICE", f"comet:{args.identity}"
            ),
        )
    from moose_tpu_torch.distributed.choreography import WorkerServer

    storage = None
    if args.storage_dir:
        from moose_tpu_torch.storage import FilesystemStorage

        storage = FilesystemStorage(args.storage_dir)
        if args.checkpoint:
            from moose_tpu_torch.training.checkpoint import CheckpointStore

            storage = CheckpointStore(storage, party=args.identity)
    elif args.checkpoint:
        parser.error("--checkpoint requires --storage-dir")
    from moose_tpu_torch.distributed.tls import tls_config_from_flags

    try:
        tls = tls_config_from_flags(args.tls_cert, args.tls_key, args.tls_ca)
    except ValueError as e:
        parser.error(str(e))
    if args.choreographer is not None and tls is None:
        parser.error("--choreographer requires the --tls-* flags")
    server = WorkerServer(
        args.identity, args.port, parse_endpoints(args.endpoints),
        storage=storage, tls=tls, choreographer=args.choreographer,
        receive_timeout=args.receive_timeout,
        metrics_port=args.metrics_port, device=args.device,
    ).start()
    if server.metrics_server is not None:
        logging.getLogger("comet").info(
            "metrics/health endpoint on http://%s:%d/metrics",
            server.metrics_server.host, server.metrics_server.port,
        )
    logging.getLogger("comet").info(
        "worker %s listening on port %d (device %s)", args.identity,
        server.port, server.device,
    )
    import threading

    if threading.current_thread() is threading.main_thread():
        import signal

        # SIGTERM stops the server: the daemon exits 0, cleanly
        signal.signal(signal.SIGTERM, lambda *_: server.stop(grace=1.0))
    if on_start is not None:
        on_start(server)
    server.wait()


if __name__ == "__main__":
    main()
