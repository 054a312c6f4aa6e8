"""AES-128-CTR pseudo-random generator in the reference's ``aes_prng``
construction, the stream of the ``aes-ctr`` PRF.

The port's own copy of ``moose_tpu/crypto/aes_prng.py`` (numpy only):

- the keystream is AES-128_k(counter) for a 128-bit little-endian
  counter starting at zero, the 16-byte seed used directly as the key;
  output bytes are consumed in keystream order;
- the draw orders are the reference's kernels': a u64 word is 8
  keystream bytes little-endian; a ring128 element draws its HIGH limb
  first (``(next_u64 << 64) + next_u64``); a bit is one keystream byte's
  low bit.

The composed stream is pinned by ``moose_tpu/crypto/prf_golden.json``,
which ``tests/test_torch_aes_ctr.py`` replays through this module.  The
block cipher takes its tables from ``dialects/aes.py`` (FIPS-197); a
refill encrypts all of its counter blocks in one numpy pass.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..dialects.aes import RCON, SBOX, _shift_rows_perm, gmul

_SBOX_NP = np.asarray(SBOX, dtype=np.uint8)
_PERM_NP = np.asarray(_shift_rows_perm(), dtype=np.int64)
_G2_NP = np.asarray([gmul(2, b) for b in range(256)], dtype=np.uint8)
_G3_NP = np.asarray([gmul(3, b) for b in range(256)], dtype=np.uint8)
# MixColumns on the column-major state: output byte 4c + r takes bytes
# 4c + (r + k) % 4 of its column, k = 1, 2, 3
_ROLL = [
    np.asarray([4 * (p // 4) + (p % 4 + k) % 4 for p in range(16)])
    for k in (1, 2, 3)
]


def key_schedule(key: bytes) -> List[np.ndarray]:
    """The 11 AES-128 round keys of ``key``, each a (16,) uint8 array."""
    if len(key) != 16:
        raise ValueError("an AES-128 key is 16 bytes")

    def sub_word(w: List[int]) -> List[int]:
        return [int(SBOX[b]) for b in w]

    words = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(words[i - 1])
        if i % 4 == 0:
            t = sub_word(t[1:] + t[:1])
            t[0] ^= RCON[i // 4 - 1]
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    return [np.asarray(sum(words[4 * r:4 * r + 4], []), dtype=np.uint8)
            for r in range(11)]


def encrypt_blocks(round_keys: List[np.ndarray],
                   blocks: np.ndarray) -> np.ndarray:
    """AES-128 of every row of an (n, 16) uint8 block array under a
    precomputed schedule, by table lookups over the whole batch."""
    state = blocks ^ round_keys[0]
    for r in range(1, 10):
        state = _SBOX_NP[state][:, _PERM_NP]
        state = (_G2_NP[state] ^ _G3_NP[state[:, _ROLL[0]]]
                 ^ state[:, _ROLL[1]] ^ state[:, _ROLL[2]] ^ round_keys[r])
    return _SBOX_NP[state][:, _PERM_NP] ^ round_keys[10]


def counter_blocks(first: int, count: int) -> np.ndarray:
    """The (count, 16) little-endian 128-bit counter blocks first,
    first + 1, ...  A stream never reaches 2^64 blocks, so the high
    eight bytes are zero."""
    out = np.zeros((count, 16), dtype=np.uint8)
    c = np.uint64(first) + np.arange(count, dtype=np.uint64)
    out[:, :8] = c.astype("<u8").view(np.uint8).reshape(count, 8)
    return out


class AesCtrRng:
    def __init__(self, seed: bytes) -> None:
        if len(seed) != 16:
            raise ValueError("AesRng seed must be 16 bytes")
        self._round_keys = key_schedule(bytes(seed))
        self._counter = 0
        self._buf = b""
        self._pos = 0

    def _refill(self, min_bytes: int) -> None:
        need = max(min_bytes - (len(self._buf) - self._pos), 0)
        blocks = max((need + 15) // 16, 1)
        ks = encrypt_blocks(self._round_keys,
                            counter_blocks(self._counter, blocks))
        self._counter += blocks
        self._buf = bytes(self._buf[self._pos:]) + ks.tobytes()
        self._pos = 0

    def next_bytes(self, n: int) -> bytes:
        if len(self._buf) - self._pos < n:
            self._refill(n)
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def next_u64(self) -> int:
        return int.from_bytes(self.next_bytes(8), "little")

    def get_bit(self) -> int:
        return self.next_bytes(1)[0] & 1

    # -- bulk draws in the reference's element orders -------------------

    def uniform_u64(self, size: int) -> np.ndarray:
        return np.frombuffer(self.next_bytes(8 * size), dtype="<u8") \
            .astype(np.uint64)

    def uniform_u128(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) u64 arrays; each element draws its HIGH limb first."""
        raw = np.frombuffer(
            self.next_bytes(16 * size), dtype="<u8"
        ).reshape(size, 2)
        return (raw[:, 1].astype(np.uint64), raw[:, 0].astype(np.uint64))

    def bits(self, size: int) -> np.ndarray:
        raw = np.frombuffer(self.next_bytes(size), dtype=np.uint8)
        return raw & np.uint8(1)


def derive_seed(key_bytes: bytes, session_id: str,
                sync_key: bytes) -> bytes:
    """The reference's DeriveSeed kernel: blake3-derive a hashing key from
    the PRF key, then keyed-hash ``sid_bytes(16) || sync_key(16)`` and
    take 16 output bytes.  ``sid_bytes`` is the blake3 hash of the
    session-id string truncated to 16 bytes; the sync key is its raw
    bytes zero-padded to 16."""
    from .blake3 import blake3, derive_key, keyed_hash

    derived = derive_key("Derive Seed", bytes(key_bytes))
    sid = blake3(session_id.encode(), out_len=16)
    sk = bytes(sync_key)[:16].ljust(16, b"\x00")
    return keyed_hash(derived, sid + sk, out_len=16)
