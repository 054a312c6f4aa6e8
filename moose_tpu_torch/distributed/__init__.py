"""Distributed execution of the port: so far only the transport helpers
the static cost model prices frames with (``fabric.value_leaves`` and
``leaf_bytes``; ``networking.transfer_key`` and the frame packers).  The
workers, the networking backends, the choreographer and the fabric
transport are ROADMAP queue 1, item 12."""
