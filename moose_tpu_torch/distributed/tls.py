"""mTLS identity for the distributed runtime.

Reference: gRPC transports optionally run under mutual TLS, with the
*certificate common name as the party identity* — senders are verified
against the peer X.509 CN (``networking/grpc.rs:150-160``,
``grpc.rs:1-30``) and the choreographer is authorized by CN
(``choreography/grpc.rs:64-94``); certificates are loaded from PEM files
(``reindeer.rs:40-78``).

The port's own copy of ``moose_tpu/distributed/tls.py`` (framework-
neutral): the same discipline on ``grpc``'s Python credentials API.
A :class:`TlsConfig` holds the local identity's cert/key plus the CA that
signs every party; servers require client auth, and channels override the
TLS target name with the receiver's identity so certificates bind to
*party names*, not network addresses.  Party certificates need the
identity both as CN (checked server-side for sender/choreographer authz)
and as a subjectAltName DNS entry (modern gRPC/BoringSSL matches the
target-name override against the SAN, not the CN).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class TlsConfig:
    """PEM material for one identity (reference reindeer.rs:40-78)."""

    certificate_chain: bytes
    private_key: bytes
    root_ca: bytes

    @classmethod
    def from_files(cls, cert: str, key: str, ca: str) -> "TlsConfig":
        return cls(
            certificate_chain=Path(cert).read_bytes(),
            private_key=Path(key).read_bytes(),
            root_ca=Path(ca).read_bytes(),
        )

    def server_credentials(self):
        import grpc

        return grpc.ssl_server_credentials(
            [(self.private_key, self.certificate_chain)],
            root_certificates=self.root_ca,
            require_client_auth=True,
        )

    def channel_credentials(self):
        import grpc

        return grpc.ssl_channel_credentials(
            root_certificates=self.root_ca,
            private_key=self.private_key,
            certificate_chain=self.certificate_chain,
        )

    def secure_channel(self, endpoint: str, expected_identity: str):
        """Channel to ``endpoint`` whose server must present a certificate
        for ``expected_identity`` (CN = party name, not hostname)."""
        import grpc

        from .networking import GRPC_MESSAGE_OPTIONS

        return grpc.secure_channel(
            endpoint,
            self.channel_credentials(),
            options=(
                ("grpc.ssl_target_name_override", expected_identity),
            ) + GRPC_MESSAGE_OPTIONS,
        )


def tls_config_from_flags(cert: Optional[str], key: Optional[str],
                          ca: Optional[str]) -> Optional["TlsConfig"]:
    """Build a TlsConfig from CLI flags: all three or none.

    Returns None when no flag is given; raises ValueError on a partial
    triple or an unreadable file (shared by the comet and cometctl
    CLIs, whose handlers turn ValueError into a one-line usage error)."""
    if not (cert or key or ca):
        return None
    if not (cert and key and ca):
        raise ValueError(
            "--tls-cert, --tls-key and --tls-ca must be given together"
        )
    try:
        return TlsConfig.from_files(cert, key, ca)
    except OSError as e:
        raise ValueError(f"cannot read TLS material: {e}") from e


def reject(context, message: str) -> None:
    """Refuse an RPC with PERMISSION_DENIED so clients can distinguish
    permanent authorization failures from transient transport errors
    structurally (by status code, not message text)."""
    if context is not None and hasattr(context, "abort"):
        import grpc

        context.abort(grpc.StatusCode.PERMISSION_DENIED, message)
    from ..errors import NetworkingError

    raise NetworkingError(message)


def peer_common_name(context) -> Optional[str]:
    """The peer certificate's CN, or None on a non-TLS connection
    (reference grpc.rs:1-30 extracts the CN from the peer X.509)."""
    try:
        auth = context.auth_context()
    except Exception:  # pragma: no cover - non-grpc test contexts
        return None
    values = auth.get("x509_common_name") if auth else None
    if not values:
        return None
    name = values[0]
    return name.decode() if isinstance(name, bytes) else str(name)
