"""The ``threefry-pallas`` PRF stream (K7).

PyTorch counterpart of ``moose_tpu/dialects/pallas_prf.py``.  The stream
is threefry2x32-20 in counter mode: the 128-bit seed ``(s0, s1, s2, s3)``
folds to the key ``(s0 ^ s2, s1 ^ s3)``, word ``c`` encrypts the counter
block ``(c, ~c)`` for the u32 lane index ``c``, and a word is
``(y0 << 32) | y1``.  The JAX package expands it with a Pallas kernel;
in the port the hand-written CUDA kernel ``csrc/threefry.cu`` expands it:
a protocol session's draws in groups whose seeds the kernel derives
(``native.ring_kernels.threefry_group``), and a seed given here as a
group of one draw under its key (``threefry_words`` / ``threefry_bits``);
its plain PyTorch version runs for the CPU.

One seed covers 2^32 words.  A larger draw is refused before anything
is allocated (``ring_kernels.refuse_beyond_counter``): its counter would
repeat an earlier lane's, and in the protocol that is a reused mask.

Selected with ``ring.set_prf_impl("threefry-pallas")`` or
``MOOSE_TPU_PRF=threefry-pallas``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..native import ring_kernels as rk
from . import ring

LAYOUT = "threefry-pallas"


def random_bits_u64(seed, shape: Sequence[int], device) -> torch.Tensor:
    """Uniform u64 words (as int64) of ``shape`` from a 128-bit seed, on
    ``device``: lane ``i`` of the flattened shape is word ``i`` of the
    stream."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    k0, k1 = ring.stream_key(seed, LAYOUT, bits=False)
    return rk.threefry_words(k0, k1, n, LAYOUT, device).reshape(shape)


def random_bits_u8(seed, shape: Sequence[int], device) -> torch.Tensor:
    """Uniform bits as uint8 0/1 of ``shape``, 64 to a word: element
    ``64w + j`` of the flattened shape is bit ``j`` of word ``w``, least
    significant first (``ring.sample_bits_seeded`` of the JAX package
    under this PRF)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    # the seed comes tagged for bits (ring.sample_bits_seeded)
    k0, k1 = ring.stream_key(seed, LAYOUT, bits=False)
    return rk.threefry_bits(k0, k1, n, LAYOUT, device).reshape(shape)
