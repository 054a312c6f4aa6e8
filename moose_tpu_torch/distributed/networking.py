"""Networking helpers: transfer keys and the wire frames of a Send.

The port's own copy of the pure helpers of ``moose_tpu/distributed/
networking.py``, with one definition of the frame layout that the static
cost model (``compilation/analysis/cost.py``) prices every transfer
with.  The networking backends (local, TCP, gRPC) that send these frames
are ROADMAP queue 1, item 12.
"""

from __future__ import annotations


def transfer_key(session_id: str, rendezvous_key: str) -> str:
    return f"{session_id}/{rendezvous_key}"


def pack_value_frame(sender: str, key: str, payload: bytes) -> bytes:
    """The single-payload SendValue frame."""
    import msgpack

    return msgpack.packb(
        {"key": key, "sender": sender, "value": payload},
        use_bin_type=True,
    )


def pack_batch_frame(sender: str, entries) -> bytes:
    """The coalesced send_many envelope: ``entries`` is
    ``[(transfer_key, payload_bytes), ...]``, one rpc carrying several
    rendezvous payloads of one session."""
    import msgpack

    return msgpack.packb(
        {
            "sender": sender,
            "batch": [
                {"key": key, "value": payload} for key, payload in entries
            ],
        },
        use_bin_type=True,
    )
