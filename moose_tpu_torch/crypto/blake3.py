"""Pure-Python BLAKE3 (hash, keyed hash, derive_key, XOF) for the
reference-compatible ``aes-ctr`` PRF.

The port's own copy of ``moose_tpu/crypto/blake3.py`` (pure Python, no
framework): the reference derives per-invocation seeds with
``blake3::derive_key("Derive Seed", key)`` followed by a keyed hash of
``session_id || sync_key`` (the reference's ``host/prim.rs:123-147``).
Those inputs are all <= 64 bytes, so only the single-chunk code paths
are exercised; full chunking is implemented for completeness.  Held to
the official empty-input vector and to ``moose_tpu/crypto/
prf_golden.json``'s derive_seed vectors by ``tests/test_torch_aes_ctr.py``.

Spec: https://github.com/BLAKE3-team/BLAKE3-specs (7-round compression,
SHA-256 IV, 16-word message permutation).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3
KEYED_HASH = 1 << 4
DERIVE_KEY_CONTEXT = 1 << 5
DERIVE_KEY_MATERIAL = 1 << 6

BLOCK_LEN = 64
CHUNK_LEN = 1024
_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state: List[int], a: int, b: int, c: int, d: int,
       mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def _compress(cv: Sequence[int], block_words: Sequence[int],
              counter: int, block_len: int, flags: int) -> List[int]:
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[i] for i in MSG_PERMUTATION]
    return state


def _words(block: bytes) -> Tuple[int, ...]:
    return struct.unpack("<16I", block.ljust(BLOCK_LEN, b"\x00"))


def _chunk_blocks(chunk: bytes) -> List[Tuple[bytes, int]]:
    """Yield (block_bytes, block_len) for one chunk; an empty chunk is a
    single zero-length block (the spec's empty-input convention)."""
    if not chunk:
        return [(b"", 0)]
    out = []
    for i in range(0, len(chunk), BLOCK_LEN):
        b = chunk[i:i + BLOCK_LEN]
        out.append((b, len(b)))
    return out


class _Output:
    """Pending root output: re-compressible at any XOF block counter."""

    def __init__(self, cv: Sequence[int], block_words: Sequence[int],
                 counter: int, block_len: int, flags: int) -> None:
        self.cv = cv
        self.block_words = block_words
        self.counter = counter
        self.block_len = block_len
        self.flags = flags

    def chaining_value(self) -> Tuple[int, ...]:
        st = _compress(
            self.cv, self.block_words, self.counter, self.block_len,
            self.flags,
        )
        return tuple((st[i] ^ st[i + 8]) & _MASK for i in range(8))

    def root_bytes(self, n: int) -> bytes:
        out = bytearray()
        block_counter = 0
        while len(out) < n:
            st = _compress(
                self.cv, self.block_words, block_counter,
                self.block_len, self.flags | ROOT,
            )
            lo = [(st[i] ^ st[i + 8]) & _MASK for i in range(8)]
            hi = [(st[i + 8] ^ self.cv[i]) & _MASK for i in range(8)]
            out += struct.pack("<16I", *(lo + hi))
            block_counter += 1
        return bytes(out[:n])


def _chunk_output(chunk: bytes, key_words: Sequence[int],
                  chunk_counter: int, flags: int) -> _Output:
    cv = tuple(key_words)
    blocks = _chunk_blocks(chunk)
    for i, (b, blen) in enumerate(blocks[:-1]):
        f = flags | (CHUNK_START if i == 0 else 0)
        st = _compress(cv, _words(b), chunk_counter, blen, f)
        cv = tuple((st[j] ^ st[j + 8]) & _MASK for j in range(8))
    b, blen = blocks[-1]
    f = flags | CHUNK_END | (CHUNK_START if len(blocks) == 1 else 0)
    return _Output(cv, _words(b), chunk_counter, blen, f)


def _parent_output(left_cv: Sequence[int], right_cv: Sequence[int],
                   key_words: Sequence[int], flags: int) -> _Output:
    block = struct.pack("<8I", *left_cv) + struct.pack("<8I", *right_cv)
    return _Output(tuple(key_words), _words(block), 0, BLOCK_LEN,
                   flags | PARENT)


def _hash_tree(data: bytes, key_words: Sequence[int],
               flags: int) -> _Output:
    chunks = [
        data[i:i + CHUNK_LEN] for i in range(0, len(data), CHUNK_LEN)
    ] or [b""]
    if len(chunks) == 1:
        return _chunk_output(chunks[0], key_words, 0, flags)
    # left-leaning binary tree over chunk chaining values (left subtree
    # is the largest power-of-two number of chunks)
    def subtree(lo: int, hi: int) -> Tuple[int, ...]:
        if hi - lo == 1:
            return _chunk_output(chunks[lo], key_words, lo, flags)\
                .chaining_value()
        split = 1
        while split * 2 < hi - lo:
            split *= 2
        left = subtree(lo, lo + split)
        right = subtree(lo + split, hi)
        return _parent_output(left, right, key_words, flags)\
            .chaining_value()

    split = 1
    while split * 2 < len(chunks):
        split *= 2
    left = subtree(0, split)
    right = subtree(split, len(chunks))
    return _parent_output(left, right, key_words, flags)


def blake3(data: bytes, key: Optional[bytes] = None, flags: int = 0,
           out_len: int = 32) -> bytes:
    """BLAKE3 hash / keyed hash / XOF.  ``key`` (32 bytes) selects keyed
    mode; ``flags`` is used internally by :func:`derive_key`."""
    if key is not None:
        if len(key) != 32:
            raise ValueError("BLAKE3 key must be 32 bytes")
        key_words = struct.unpack("<8I", key)
        flags = flags | (KEYED_HASH if flags == 0 else 0)
    else:
        key_words = IV
    return _hash_tree(data, key_words, flags).root_bytes(out_len)


def keyed_hash(key: bytes, data: bytes, out_len: int = 32) -> bytes:
    key_words = struct.unpack("<8I", key)
    return _hash_tree(data, key_words, KEYED_HASH).root_bytes(out_len)


def derive_key(context: str, key_material: bytes,
               out_len: int = 32) -> bytes:
    """Two-stage KDF: hash the context string in DERIVE_KEY_CONTEXT mode,
    then the key material keyed by the context key in DERIVE_KEY_MATERIAL
    mode — exactly ``blake3::derive_key`` of the Rust crate."""
    ctx_key = _hash_tree(
        context.encode(), IV, DERIVE_KEY_CONTEXT
    ).root_bytes(32)
    key_words = struct.unpack("<8I", ctx_key)
    return _hash_tree(
        key_material, key_words, DERIVE_KEY_MATERIAL
    ).root_bytes(out_len)
