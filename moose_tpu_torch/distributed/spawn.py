"""Three ``comet`` worker processes on this machine, started for a client
that runs ``GrpcMooseRuntime`` against them and stopped when it is done:
the ``--grpc`` modes of the port's examples and tutorials.  In a real
deployment each party starts its own ``python -m
moose_tpu_torch.bin.comet``.

    with comet_workers("cuda") as endpoints:
        runtime = GrpcMooseRuntime(endpoints, device="cuda")
"""

import contextlib
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

IDENTITIES = ("alice", "bob", "carole")
# a worker on the card builds the kernels its role launches before it
# opens its port
START_S = 300.0
STOP_S = 10.0


def free_ports(n: int) -> list:
    """``n`` ports on 127.0.0.1 that were free a moment ago."""
    ports = []
    with contextlib.ExitStack() as stack:
        for _ in range(n):
            sock = stack.enter_context(socket.socket())
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    return ports


def worker_env() -> dict:
    """This process's environment with the port's checkout first on
    ``PYTHONPATH`` and the threefry PRF unless one is chosen: workers
    that exchange shares refuse the weak default stream."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env.setdefault("MOOSE_TPU_PRF", "threefry")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    return env


def _stop(procs: dict) -> None:
    """SIGTERM every worker still running (comet exits 0 on it), and kill
    one that outlives ``STOP_S``."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    for proc in procs.values():
        try:
            proc.wait(timeout=STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _log_tail(log) -> str:
    log.seek(0)
    return log.read().decode(errors="replace")[-2000:]


@contextlib.contextmanager
def comet_workers(device, identities=IDENTITIES):
    """Start one ``comet --device <device>`` process an identity on free
    ports of 127.0.0.1, wait until each listens, and yield the endpoints
    ``{identity: "127.0.0.1:<port>"}``; every process is stopped on
    exit.  A worker that exits or never listens raises ``RuntimeError``
    with its log."""
    ports = free_ports(len(identities))
    endpoints = {i: f"127.0.0.1:{p}" for i, p in zip(identities, ports)}
    spec = ",".join(f"{i}={e}" for i, e in endpoints.items())
    env = worker_env()
    procs, logs = {}, {}
    with contextlib.ExitStack() as stack:
        try:
            for identity, port in zip(identities, ports):
                logs[identity] = stack.enter_context(tempfile.TemporaryFile())
                procs[identity] = subprocess.Popen(
                    [sys.executable, "-m", "moose_tpu_torch.bin.comet",
                     "--identity", identity, "--port", str(port),
                     "--endpoints", spec, "--device", str(device)],
                    stdout=subprocess.DEVNULL, stderr=logs[identity],
                    env=env)
            deadline = time.monotonic() + START_S
            for identity, port in zip(identities, ports):
                while True:
                    if procs[identity].poll() is not None:
                        raise RuntimeError(
                            f"comet {identity} exited with "
                            f"{procs[identity].returncode}:\n"
                            + _log_tail(logs[identity]))
                    with contextlib.suppress(OSError), \
                            socket.create_connection(("127.0.0.1", port),
                                                     timeout=1.0):
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"comet {identity} did not listen within "
                            f"{START_S:.0f} s:\n" + _log_tail(logs[identity]))
                    time.sleep(0.2)
            yield endpoints
        finally:
            _stop(procs)
