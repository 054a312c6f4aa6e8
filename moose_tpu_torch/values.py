"""Runtime values of the port, backed by PyTorch tensors.

The host, replicated, additive, mirrored and AES value classes of
``moose_tpu/values.py``.  Tensor payloads are ``torch`` tensors on the
runtime's device; ring words are ``torch.int64`` (see
``dialects/ring.py``), ``hi`` present iff the width is 128.  PRF keys and
seeds are four u32 words as a tuple of Python ints: the port derives
seeds on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import dtypes as dt

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
    # the same 64 bits: torch has no uint64 arithmetic on the CPU
    "uint64": torch.int64,
    "bool": torch.bool,
}


def torch_dtype(dtype: dt.DType) -> torch.dtype:
    try:
        return _TORCH_DTYPES[dtype.name]
    except KeyError:
        raise NotImplementedError(
            f"the port has no host tensors of dtype {dtype.name} yet"
        ) from None


@dataclasses.dataclass
class HostUnit:
    """The value of an op that yields nothing, such as Save."""

    plc: str


@dataclasses.dataclass
class HostString:
    """A string on one host: a Load or Save key, or a Load query."""

    value: str
    plc: str


@dataclasses.dataclass
class HostShape:
    """Shapes are runtime values in the IR; the port carries them as
    Python tuples."""

    value: tuple
    plc: str


@dataclasses.dataclass
class DeviceSeed:
    """A 128-bit seed that stays on the device as what it is made of: a
    PRF key ``key`` (a 4-word int64 tensor of u32 values) mixed with the
    four u32 words ``nonce`` by ``ring.mix_seed``, or the key itself with
    ``nonce`` None.  K7 makes the seed where it expands a draw from it
    (``ring_kernels.threefry_seeded``), so nothing is derived on the
    host, and a captured plan replays with the key its table holds."""

    key: torch.Tensor
    nonce: Optional[tuple] = None


@dataclasses.dataclass
class HostSeed:
    """128-bit seed (reference HostSeed): four u32 words, or a
    :class:`DeviceSeed` (a lowered plan's seeds).  ``origin`` is the
    ``(key origin, sync key)`` pair the seed was derived from, kept for
    the draw ledger; it never influences execution."""

    value: tuple
    plc: str
    origin: Any = None

    def ty_name(self) -> str:
        return "HostSeed"


@dataclasses.dataclass
class HostPrfKey:
    """PRF key words (four u32), or a lowered plan's key: a 4-word int64
    tensor on the device, a row of the plan's key table.  ``origin`` is
    the session key index (or the key op) that minted the key; it never
    influences execution."""

    value: tuple
    plc: str
    origin: Any = None

    def ty_name(self) -> str:
        return "HostPrfKey"


@dataclasses.dataclass
class HostTensor:
    """Plaintext float/int tensor owned by one host."""

    value: torch.Tensor
    plc: str
    dtype: dt.DType

    @property
    def shape(self):
        return tuple(self.value.shape)


@dataclasses.dataclass
class HostBitTensor:
    """A tensor of bits owned by one host, one bit a ``torch.uint8``
    lane of 0/1 (the JAX package's layout)."""

    value: torch.Tensor
    plc: str

    @property
    def shape(self):
        return tuple(self.value.shape)


@dataclasses.dataclass
class HostRingTensor:
    """Element of Z_{2^64} or Z_{2^128} as int64 words."""

    lo: torch.Tensor
    hi: Optional[torch.Tensor]
    width: int
    plc: str

    @property
    def shape(self):
        return tuple(self.lo.shape)


@dataclasses.dataclass
class HostFixedTensor:
    """Fixed-point tensor = ring tensor + precision metadata."""

    tensor: HostRingTensor
    integral_precision: int
    fractional_precision: int

    @property
    def plc(self) -> str:
        return self.tensor.plc


@dataclasses.dataclass
class Mir3Tensor:
    """Public value mirrored on 3 hosts."""

    values: tuple
    plc: str


@dataclasses.dataclass
class Mir3FixedTensor:
    tensor: Mir3Tensor
    integral_precision: int
    fractional_precision: int

    @property
    def plc(self) -> str:
        return self.tensor.plc


# ---------------------------------------------------------------------------
# Replicated (3-party) and additive (2-party) values of the per-host layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RepTensor:
    """Replicated secret sharing: x = x0 + x1 + x2, party i holds
    (x_i, x_{i+1}) (reference replicated/mod.rs:74-77).  ``shares[i]``
    is party i's pair, each a HostRingTensor or HostBitTensor placed on
    owner i."""

    shares: tuple  # ((x00, x10), (x11, x21), (x22, x02))
    plc: str  # replicated placement name

    def ty_name(self) -> str:
        inner = self.shares[0][0]
        if isinstance(inner, HostBitTensor):
            return "ReplicatedBitTensor"
        return f"ReplicatedRing{inner.width}Tensor"

    @property
    def shape(self):
        return self.shares[0][0].shape


@dataclasses.dataclass
class RepFixedTensor:
    tensor: RepTensor
    integral_precision: int
    fractional_precision: int

    @property
    def plc(self) -> str:
        return self.tensor.plc

    def ty_name(self) -> str:
        inner = self.tensor.shares[0][0]
        return f"ReplicatedFixed{inner.width}Tensor"


@dataclasses.dataclass
class RepSetup:
    """Pairwise PRF keys: keys[i] = (k_i, k_{i+1}) held by party i
    (reference replicated/setup.rs:5-8)."""

    keys: tuple  # ((k00, k10), (k11, k21), (k22, k02)) of HostPrfKey
    plc: str


@dataclasses.dataclass
class RepBitArray:
    """N-bit bit decomposition: a replicated bit tensor with a leading
    bit axis of static length (reference RepBitArray)."""

    tensor: RepTensor
    num_bits: int

    @property
    def plc(self) -> str:
        return self.tensor.plc

    def ty_name(self) -> str:
        return f"ReplicatedBitArray{self.num_bits}"


@dataclasses.dataclass
class AdtTensor:
    """2-party additive sharing x = x0 + x1 (reference
    additive/mod.rs:48)."""

    shares: tuple  # (x0, x1) HostRingTensors
    plc: str

    def ty_name(self) -> str:
        return f"AdditiveRing{self.shares[0].width}Tensor"


# ---------------------------------------------------------------------------
# AES / encrypted values
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostAesKey:
    """An AES-128 key on one host: a HostBitTensor with leading axis
    128."""

    bits: HostBitTensor
    plc: str

    def ty_name(self) -> str:
        return "HostAesKey"


@dataclasses.dataclass
class RepAesKey:
    """An AES-128 key bit-shared on a replicated placement in the
    per-host layout: a replicated bit array with leading axis 128."""

    bits: RepBitArray

    @property
    def plc(self) -> str:
        return self.bits.plc

    def ty_name(self) -> str:
        return "ReplicatedAesKey"


@dataclasses.dataclass
class AesTensor:
    """AES-128-GCM ciphertext of a fixed-point tensor: per element a
    96-bit nonce and 128 ciphertext bits, each a HostBitTensor with that
    leading bit axis."""

    nonce_bits: HostBitTensor
    cipher_bits: HostBitTensor
    plc: str

    def ty_name(self) -> str:
        return "AesTensor"


def ring_to_limbs(value: HostRingTensor) -> np.ndarray:
    """Persistence form of a ring tensor: uint64 limb planes with a
    leading limb axis, ``(1, *shape)`` for ring64 and ``(2, *shape)``
    (lo, hi) for ring128.  The int64 words are reinterpreted bit for bit,
    so the ``.npy`` bytes are the JAX package's (secret-shared
    checkpoints, ``SaveShares``/``LoadShares``)."""
    limbs = [value.lo] if value.width == 64 else [value.lo, value.hi]
    return np.stack([
        limb.detach().cpu().contiguous().numpy().view(np.uint64)
        for limb in limbs
    ])


def limbs_to_ring(arr, width: int, plc: str, device) -> HostRingTensor:
    """Inverse of :func:`ring_to_limbs`: a ``(n_limbs, *shape)`` uint64
    array as a :class:`HostRingTensor` of ``width`` on ``device``."""
    want = 1 if width == 64 else 2
    arr = np.asarray(arr)
    if arr.ndim < 1 or arr.shape[0] != want:
        raise ValueError(
            f"ring{width} limb array needs leading axis {want}, found "
            f"shape {tuple(arr.shape)}"
        )
    # a copy, not a view: a read-only buffer (np.load's mmap, frombuffer)
    # would be shared with torch
    words = np.array(arr, dtype=np.uint64, order="C").view(np.int64)
    lo = torch.from_numpy(words[0, ...]).to(device)
    hi = (torch.from_numpy(words[1, ...]).to(device) if width == 128
          else None)
    return HostRingTensor(lo, hi, width, plc)


def to_numpy(value: Any):
    """Convert a host-level runtime value to numpy for the user."""
    if isinstance(value, HostTensor):
        arr = value.value.detach().cpu().numpy()
        if value.dtype.name == "uint64":
            return arr.view(np.uint64)
        return arr
    if isinstance(value, HostBitTensor):
        return value.value.detach().cpu().numpy().astype(bool)
    if isinstance(value, HostRingTensor):
        # int64 words are the ring's u64 words bit for bit
        lo = value.lo.detach().cpu().contiguous().numpy().view(np.uint64)
        if value.width == 64:
            return lo
        hi = value.hi.detach().cpu().contiguous().numpy().view(np.uint64)
        return (hi.astype(object) << 64) + lo.astype(object)
    if isinstance(value, HostShape):
        return np.asarray(value.value, dtype=np.int64)
    if isinstance(value, HostString):
        return value.value
    if isinstance(value, HostUnit):
        return None
    raise TypeError(f"cannot convert {type(value).__name__} to numpy")
