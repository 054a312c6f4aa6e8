"""Fabric transport helpers: the array leaves a fabric transfer moves.

The port's own copy of the pure helpers of ``moose_tpu/distributed/
fabric.py``.  The static cost model (``compilation/analysis/cost.py``)
prices a fabric transfer with them, on a placeholder value of the
transfer's spec.  The fabric transport itself (parties as device-mesh
slices, a rendezvous as a collective permute) is ROADMAP queue 1,
item 12.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

# array fields of each value class, in the JAX package's pytree order
# (``moose_tpu/values.py``'s registrations); a class absent here has none
_ARRAY_FIELDS = {
    "HostTensor": ("value",),
    "HostBitTensor": ("value",),
    "HostRingTensor": ("lo", "hi"),
    "HostFixedTensor": ("tensor",),
    "RepTensor": ("shares",),
    "RepFixedTensor": ("tensor",),
    "RepSetup": ("keys",),
    "RepBitArray": ("tensor",),
    "AdtTensor": ("shares",),
    "Mir3Tensor": ("values",),
    "Mir3FixedTensor": ("tensor",),
    "HostAesKey": ("bits",),
    "RepAesKey": ("bits",),
    "AesTensor": ("nonce_bits", "cipher_bits"),
}
_WORD_CLASSES = ("HostSeed", "HostPrfKey")


def value_leaves(value) -> list:
    """The array leaves a fabric transfer moves, in the JAX package's
    ``jax.tree_util.tree_leaves`` order: each value class's array fields
    flattened in declaration order, None skipped, a seed's or key's four
    words one uint32 leaf.  Values with no array leaves (HostUnit,
    HostShape, HostString) have none: nothing for a permute to move."""
    out: list = []

    def walk(v):
        if v is None:
            return
        name = type(v).__name__
        if name in _WORD_CLASSES:
            out.append(np.asarray(v.value, dtype=np.uint32))
        elif name in _ARRAY_FIELDS:
            for field in _ARRAY_FIELDS[name]:
                walk(getattr(v, field))
        elif isinstance(v, (tuple, list)):
            for item in v:
                walk(item)
        elif hasattr(v, "plc") or isinstance(v, (str, bytes)):
            return
        else:
            out.append(v)

    walk(value)
    return out


def leaf_bytes(leaves: Sequence[Any]) -> int:
    """Device bytes of ``leaves``: a tensor's elements times their size,
    an array's ``nbytes``."""
    total = 0
    for leaf in leaves:
        if hasattr(leaf, "element_size"):
            total += int(leaf.numel()) * int(leaf.element_size())
        else:
            total += int(np.asarray(leaf).nbytes)
    return total
