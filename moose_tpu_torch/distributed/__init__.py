"""Distributed execution of the port: networking backends, role-filtered
workers, choreography and the client session supervisor (reference
``moose/src/networking``, ``moose/src/choreography``,
``moose/src/execution/grpc.rs``), the fabric transport (parties as
device slices) and the deterministic chaos layer."""

from typing import Any

# the reference's lazy re-export, over the names the port has: importing
# the package loads no transport (grpc is imported by the classes that
# use it)
_LAZY = {
    "LocalNetworking": "networking",
    "GrpcNetworking": "networking",
    "TcpNetworking": "networking",
    "ProgressClock": "networking",
    "execute_role": "worker",
    "WorkerServer": "choreography",
    "ChoreographyClient": "choreography",
    "start_local_cluster": "choreography",
    "GrpcClientRuntime": "client",
    "TlsConfig": "tls",
    "ChaosConfig": "chaos",
    "ChaosNetworking": "chaos",
    "FabricDomain": "fabric",
    "FabricNetworking": "fabric",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str) -> Any:
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(name)
