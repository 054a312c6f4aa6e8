"""AES-128 decryption of encrypted inputs, on host bits and under MPC in
both layouts.

PyTorch counterpart of ``moose_tpu/dialects/aes.py``: the plaintext
AES-128 of numpy (the S-box and the block cipher, the tables of the
``aes-ctr`` PRF, the client-side encryption of the wire format) and the
bit-sliced AES-GCM decryption circuit, over one of three bit backends:
host bits (``HostBitOps``), the per-host layout's replicated bit shares
(``RepBitOps``, one session call a bit op, so the symbolic session
records the circuit when a Decrypt is lowered) and the party-stacked
shares (``StackedBitOps``).

The 16 state bytes are held as 8 bit planes of shape ``(16,) + elem``
(plane j = bit j of every byte, MSB first), so ShiftRows, MixColumns,
the squarings and the S-box's affine map are XORs and gathers over
whole planes.  The S-box is ``A·x^254 ⊕ 0x63`` along the addition chain
x2, x3, x12, x15, x240, x252, x254: each GF(2^8) product is ONE
broadcast AND of shape ``(8, 8, 16, ...)`` and XOR folds, so AES-128 is
80 ANDs (40 on the state, 40 in the key schedule), each one replicated
AND drawing its zero shares in the reference's order.

Bit conventions match the reference: arrays carry a leading bit axis,
index ``8*b + j`` = bit j (MSB first) of byte b.  One AES-GCM block's
keystream is ``AES(key, nonce ‖ counter=2)``; plaintext = ciphertext ⊕
keystream, composed MSB first into Z_{2^128}.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..errors import KernelError, TypeMismatchError
from ..execution.graphs import upload
from ..parallel import spmd
from ..parallel import spmd_math as sm
from ..parallel.spmd import SpmdFixed
from ..parallel.spmd_math import SpmdBits
from ..values import (
    AesTensor,
    HostAesKey,
    HostBitTensor,
    HostFixedTensor,
    RepAesKey,
    RepBitArray,
    RepFixedTensor,
    RepTensor,
)
from . import replicated as rep_ops

# ---------------------------------------------------------------------------
# Plaintext GF(2^8) / AES-128 (numpy ints): the circuit's linear bit
# matrices, the client-side encryption and the oracle of the tests
# ---------------------------------------------------------------------------

_POLY = 0x11B


def gmul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= _POLY
    return r


def _gpow(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = gmul(r, a)
        a = gmul(a, a)
        e >>= 1
    return r


def _affine(y: int) -> int:
    # FIPS-197 affine map (LSB indexing): b_i = y_i ^ y_{i+4} ^ y_{i+5}
    # ^ y_{i+6} ^ y_{i+7} ^ c_i with c = 0x63
    out = 0
    for i in range(8):
        bit = 0
        for k in (0, 4, 5, 6, 7):
            bit ^= (y >> ((i + k) % 8)) & 1
        bit ^= (0x63 >> i) & 1
        out |= bit << i
    return out


SBOX = np.array(
    [_affine(_gpow(x, 254)) if x else _affine(0) for x in range(256)],
    dtype=np.uint8,
)

RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


# AES state is column-major: input byte p holds state[row=p%4][col=p//4]
# (FIPS-197 §3.4); ShiftRows is the position permutation below.

def _shift_rows_perm() -> list:
    # out position p=(r,c) takes in position (r, (c+r)%4)
    return [(p % 4) + 4 * ((p // 4 + p % 4) % 4) for p in range(16)]


def aes128_encrypt_block_np(key: bytes, block: bytes) -> bytes:
    """Plaintext AES-128 of one 16-byte block."""
    from ..crypto.aes_prng import encrypt_blocks, key_schedule

    if len(block) != 16:
        raise ValueError("an AES block is 16 bytes")
    out = encrypt_blocks(key_schedule(key),
                         np.frombuffer(block, dtype=np.uint8)[None])
    return out.tobytes()


def bytes_to_bits_be(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def encrypt_fixed_array(
    key: bytes, nonce: bytes, values: np.ndarray, frac_precision: int
) -> np.ndarray:
    """AES-GCM-encrypt a float array elementwise into the wire format of
    AesTensor inputs: uint8 bits of shape (224,) + values.shape (96 nonce
    bits ‖ 128 masked-plaintext bits per element).

    Each element is encoded as a two's-complement fixed-point 128-bit
    integer (round half to even) and masked with the keystream block
    AES(key, nonce_i ‖ ctr=2), the element's nonce being the base nonce
    with the element index XORed into its last four bytes (big-endian).
    Byte for byte the JAX package's encryption, with every element's
    counter block encrypted in one numpy pass."""
    from ..crypto.aes_prng import encrypt_blocks, key_schedule

    if len(key) != 16 or len(nonce) != 12:
        raise ValueError("AES-GCM takes a 16-byte key and a 12-byte nonce")
    shape = np.asarray(values).shape
    flat = np.asarray(values, dtype=np.float64).ravel()
    n = flat.size
    if n > 1 << 32:
        raise ValueError("at most 2^32 elements share one base nonce")
    # the per-element nonces
    nonces = np.tile(np.frombuffer(nonce, dtype=np.uint8), (n, 1))
    tail = np.uint32(int.from_bytes(nonce[-4:], "big")) ^ \
        np.arange(n, dtype=np.uint64).astype(np.uint32)
    nonces[:, 8:] = tail.astype(">u4").view(np.uint8).reshape(n, 4)
    blocks = np.zeros((n, 16), dtype=np.uint8)
    blocks[:, :12] = nonces
    blocks[:, 15] = 2
    keystream = encrypt_blocks(key_schedule(key), blocks)
    # round(v * 2^f) mod 2^128 as 16 big-endian bytes
    scaled = np.round(flat * float(1 << frac_precision))
    raw = np.zeros((n, 16), dtype=np.uint8)
    small = np.abs(scaled) < 2.0 ** 63
    words = scaled[small].astype(np.int64)
    raw[small, 8:] = words.astype(">i8").view(np.uint8).reshape(-1, 8)
    raw[small, :8] = np.where(words < 0, 0xFF, 0).astype(np.uint8)[:, None]
    for i in np.flatnonzero(~small):
        big = int(scaled[i]) % (1 << 128)
        raw[i] = np.frombuffer(big.to_bytes(16, "big"), dtype=np.uint8)
    out = np.empty((224, n), dtype=np.uint8)
    out[:96] = np.unpackbits(nonces, axis=1).T
    out[96:] = np.unpackbits(raw ^ keystream, axis=1).T
    return out.reshape((224,) + shape)


# ---------------------------------------------------------------------------
# Linear bit matrices (derived numerically; planes are MSB-first)
# ---------------------------------------------------------------------------


def _matrix_of(f) -> np.ndarray:
    """8x8 bit matrix M with out_plane_i = XOR_{j: M[i,j]} in_plane_j,
    planes MSB-first (plane i = bit weight 2^(7-i))."""
    M = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        y = f(1 << (7 - j))
        for i in range(8):
            M[i, j] = (y >> (7 - i)) & 1
    return M


_SQUARE_M = _matrix_of(lambda x: gmul(x, x))
_AFFINE_M = _matrix_of(lambda x: _affine(x) ^ 0x63)  # linear part only
_AFFINE_C = 0x63
# x^e mod poly for e in 8..14, as byte values (reduction of high product
# coefficients in the bilinear multiply)
_REDUCE = {e: _gpow(2, e) for e in range(8, 15)}


# ---------------------------------------------------------------------------
# The bit backends: host bits and the per-host layout's replicated shares
# (session calls), the party-stacked shares (tensor ops)
# ---------------------------------------------------------------------------


class HostBitOps:
    """The circuit's bit operations on one host's bits."""

    def __init__(self, sess, plc: str):
        self.sess = sess
        self.plc = plc

    def xor(self, x, y):
        return self.sess.xor(self.plc, x, y)

    def and_(self, x, y):
        return self.sess.and_(self.plc, x, y)

    def not_(self, x):
        return self.sess.bit_neg(self.plc, x)

    def expand0(self, x, axis):
        return self.sess.expand_dims(self.plc, x, axis)

    def concat0(self, xs):
        return self.sess.concat(self.plc, xs, 0)

    def stack(self, xs):
        return self.concat0([self.expand0(x, 0) for x in xs])

    def slice0(self, x, b, e):
        return self.sess.strided_slice(self.plc, x, (slice(b, e),))

    def take0(self, x, idx):
        return self.concat0([self.slice0(x, i, i + 1) for i in idx])

    def index2(self, x, i, j):
        y = self.sess.index_axis(self.plc, x, 0, i)
        return self.sess.index_axis(self.plc, y, 0, j)

    def _ndim(self, x) -> int:
        return x.value.ndim

    def xor_public(self, x, mask: np.ndarray):
        m = mask.reshape(mask.shape + (1,) * (self._ndim(x) - mask.ndim))
        c = self.sess.constant(self.plc, m.astype(bool))
        return self.sess.xor(self.plc, x, c)

    def compose_ring128(self, bits):
        """bits: leading axis 128, index i = weight 2^i."""
        return self.sess.compose_bits(self.plc, bits, 128)


class RepBitOps:
    """The circuit's bit operations on the per-host layout's replicated
    bit shares: every AND one ``replicated.and_bits`` (its zero shares
    one draw a party)."""

    def __init__(self, sess, rep):
        self.sess = sess
        self.rep = rep

    def xor(self, x, y):
        return rep_ops.xor(self.sess, self.rep, x, y)

    def and_(self, x, y):
        return rep_ops.and_bits(self.sess, self.rep, x, y)

    def not_(self, x):
        return rep_ops.neg_bits(self.sess, self.rep, x)

    def expand0(self, x, axis):
        return rep_ops.expand_dims(self.sess, self.rep, x, axis)

    def concat0(self, xs):
        return rep_ops.concat(self.sess, self.rep, xs, 0)

    def stack(self, xs):
        return self.concat0([self.expand0(x, 0) for x in xs])

    def slice0(self, x, b, e):
        return rep_ops.strided_slice(self.sess, self.rep, x, (slice(b, e),))

    def take0(self, x, idx):
        return self.concat0([self.slice0(x, i, i + 1) for i in idx])

    def index2(self, x, i, j):
        y = rep_ops.index_axis(self.sess, self.rep, x, 0, i)
        return rep_ops.index_axis(self.sess, self.rep, y, 0, j)

    def _ndim(self, x) -> int:
        return x.shares[0][0].value.ndim

    def xor_public(self, x, mask: np.ndarray):
        """XOR with a public constant into share x_0, held by party 0
        (first slot) and party 2 (second slot), as ``neg_bits`` flips
        it."""
        m = mask.reshape(mask.shape + (1,) * (self._ndim(x) - mask.ndim))
        p = self.rep.owners
        s = x.shares
        c0 = self.sess.constant(p[0], m.astype(bool))
        c2 = self.sess.constant(p[2], m.astype(bool))
        return RepTensor(
            (
                (self.sess.xor(p[0], s[0][0], c0), s[0][1]),
                s[1],
                (s[2][0], self.sess.xor(p[2], s[2][1], c2)),
            ),
            self.rep.name,
        )

    def compose_ring128(self, bits):
        return rep_ops.bit_compose(self.sess, self.rep, bits, 128)



@functools.lru_cache(maxsize=None)
def _index(idx: tuple, device: torch.device) -> torch.Tensor:
    return upload(np.asarray(idx, dtype=np.int64), device)


class StackedBitOps:
    """The circuit's bit operations on ``spmd_math.SpmdBits`` arrays (3,
    2, *wires, *elem): every XOR one elementwise op over all parties,
    every AND one ``bits_and`` (one bit bank, one reshare roll)."""

    def __init__(self, sess):
        self.sess = sess  # SpmdSession

    def xor(self, x, y):
        return sm.bits_xor(x, y)

    def and_(self, x, y):
        return sm.bits_and(self.sess, x, y)

    def not_(self, x):
        return sm.bits_not(x)

    def expand0(self, x, axis):
        return SpmdBits(x.arr.unsqueeze(spmd._laxis(x.arr, axis, extra=1)))

    def concat0(self, xs):
        return SpmdBits(torch.cat([x.arr for x in xs], dim=2))

    def stack(self, xs):
        return SpmdBits(torch.stack([x.arr for x in xs], dim=2))

    def slice0(self, x, b, e):
        return SpmdBits(x.arr[:, :, b:e])

    def take0(self, x, idx):
        return SpmdBits(torch.index_select(
            x.arr, 2, _index(tuple(int(i) for i in idx), x.arr.device)))

    def index2(self, x, i, j):
        return SpmdBits(x.arr[:, :, i, j])

    def _ndim(self, x) -> int:
        return x.arr.dim() - 2

    def xor_public(self, x, mask: np.ndarray):
        """XOR with a public constant into share b_0 (pair slots (0, 0)
        and (2, 1)), as ``spmd_math.bits_not`` flips it."""
        m = mask.reshape(mask.shape + (1,) * (self._ndim(x) - mask.ndim))
        m = upload(m.astype(np.uint8), x.arr.device)
        arr = x.arr.clone()
        arr[0, 0] ^= m
        arr[2, 1] ^= m
        return SpmdBits(arr)

    def compose_ring128(self, bits):
        """bits: leading axis 128, index i = weight 2^i."""
        return sm.bit_compose(self.sess, bits, 128)


# ---------------------------------------------------------------------------
# Bit-plane circuit
# ---------------------------------------------------------------------------


def _linear(B, planes, M: np.ndarray):
    out = []
    for i in range(8):
        acc = None
        for j in range(8):
            if M[i, j]:
                acc = planes[j] if acc is None else B.xor(acc, planes[j])
        if acc is None:
            raise KernelError("degenerate linear layer (zero row)")
        out.append(acc)
    return out


def _xor_const_planes(B, planes, byte: int):
    return [
        B.not_(p) if (byte >> (7 - i)) & 1 else p
        for i, p in enumerate(planes)
    ]


def _gf_mul(B, a_planes, b_planes):
    """One GF(2^8) multiplication on bit planes: a single broadcasted AND
    of shape (8, 8, N, ...) + XOR folds + linear reduction."""
    A = B.expand0(B.stack(a_planes), 1)  # (8, 1, N, ...)
    Bv = B.expand0(B.stack(b_planes), 0)  # (1, 8, N, ...)
    prod = B.and_(A, Bv)  # (8, 8, N, ...)
    coeffs: dict = {}
    for i in range(8):
        for j in range(8):
            e = 14 - i - j  # plane i <-> exponent 7-i
            coeffs.setdefault(e, []).append((i, j))
    c = {}
    for e, pairs in coeffs.items():
        acc = None
        for (i, j) in pairs:
            t = B.index2(prod, i, j)
            acc = t if acc is None else B.xor(acc, t)
        c[e] = acc
    out = [c[7 - i] for i in range(8)]  # low coefficients, MSB-first planes
    for e in range(8, 15):
        r = _REDUCE[e]
        for i in range(8):
            if (r >> (7 - i)) & 1:
                out[i] = B.xor(out[i], c[e])
    return out


def _sub_bytes(B, planes):
    """S-box on every byte of the plane set (any leading byte count)."""
    sq = lambda p: _linear(B, p, _SQUARE_M)  # noqa: E731
    x2 = sq(planes)
    x3 = _gf_mul(B, x2, planes)
    x12 = sq(sq(x3))
    x15 = _gf_mul(B, x12, x3)
    x240 = sq(sq(sq(sq(x15))))
    x252 = _gf_mul(B, x240, x12)
    x254 = _gf_mul(B, x252, x2)
    out = _linear(B, x254, _AFFINE_M)
    return _xor_const_planes(B, out, _AFFINE_C)


def _bits_to_planes(B, bits, n_bytes: int):
    return [
        B.take0(bits, [8 * b + j for b in range(n_bytes)]) for j in range(8)
    ]


def _planes_to_bits(B, planes, n_bytes: int):
    pieces = []
    for b in range(n_bytes):
        for j in range(8):
            pieces.append(B.slice0(planes[j], b, b + 1))
    return B.concat0(pieces)


def _xtime(B, planes):
    t2 = [None] * 8
    for i in range(7):
        t2[i] = planes[i + 1]
    msb = planes[0]
    for i in range(8):
        if (0x1B >> (7 - i)) & 1:
            t2[i] = msb if t2[i] is None else B.xor(t2[i], msb)
    if t2[7] is None:  # 0x1B has bit 7 set, so this cannot happen
        raise KernelError("xtime fold lost the carry bit")
    return t2


def _shift_rows(B, planes):
    perm = _shift_rows_perm()
    return [B.take0(p, perm) for p in planes]


def _mix_columns(B, planes):
    t2 = _xtime(B, planes)
    t3 = [B.xor(a, b) for a, b in zip(t2, planes)]

    def perm_k(k):
        return [(p % 4 + k) % 4 + 4 * (p // 4) for p in range(16)]

    p1, p2, p3 = perm_k(1), perm_k(2), perm_k(3)
    out = []
    for i in range(8):
        acc = t2[i]
        acc = B.xor(acc, B.take0(t3[i], p1))
        acc = B.xor(acc, B.take0(planes[i], p2))
        acc = B.xor(acc, B.take0(planes[i], p3))
        out.append(acc)
    return out


def _key_schedule(B, key_planes):
    round_keys = [key_planes]
    prev = key_planes
    for r in range(1, 11):
        last = [B.take0(p, [12, 13, 14, 15]) for p in prev]
        rot = [B.take0(p, [1, 2, 3, 0]) for p in last]
        sub = _sub_bytes(B, rot)
        words = []
        w_prev = [
            [B.take0(p, [4 * w + b for b in range(4)]) for p in prev]
            for w in range(4)
        ]
        # rcon xor hits byte 0 only: flip plane i at position 0 where
        # bit i of RC[r] is set
        rc = RCON[r - 1]
        byte0 = np.array([1, 0, 0, 0], np.uint8)
        t = [
            B.xor_public(p, byte0) if (rc >> (7 - i)) & 1 else p
            for i, p in enumerate(sub)
        ]
        w = [B.xor(a, b) for a, b in zip(w_prev[0], t)]
        words.append(w)
        for k in range(1, 4):
            w = [B.xor(a, b) for a, b in zip(w_prev[k], words[k - 1])]
            words.append(w)
        rk = [
            B.concat0([words[w][i] for w in range(4)]) for i in range(8)
        ]
        round_keys.append(rk)
        prev = rk
    return round_keys


def aes128_encrypt_block(B, key_bits, block_bits):
    """AES-128 on bit values with leading axis 128 (bit 8b+j = byte b,
    bit j MSB-first) over the bit backend ``B``."""
    kp = _bits_to_planes(B, key_bits, 16)
    sp = _bits_to_planes(B, block_bits, 16)
    rks = _key_schedule(B, kp)
    ark = lambda s, k: [B.xor(a, b) for a, b in zip(s, k)]  # noqa: E731
    state = ark(sp, rks[0])
    for r in range(1, 10):
        state = _sub_bytes(B, state)
        state = _shift_rows(B, state)
        state = _mix_columns(B, state)
        state = ark(state, rks[r])
    state = _sub_bytes(B, state)
    state = _shift_rows(B, state)
    state = ark(state, rks[10])
    return _planes_to_bits(B, state, 16)


def aesgcm_decrypt_block(B, key_bits, nonce_bits, cipher_bits):
    """Recover the ring128 plaintext of one AES-GCM block: keystream =
    AES(key, nonce ‖ ctr=2); m = c ⊕ keystream; compose MSB-first bits
    into Z_{2^128}."""
    # one key encrypts every element: align the key's element rank with
    # the ciphertext's so plane XORs broadcast (bit axis leads)
    for _ in range(B._ndim(cipher_bits) - B._ndim(key_bits)):
        key_bits = B.expand0(key_bits, -1)
    # counter block: 96 nonce bits, then the 32-bit counter value 2
    # (bit index 126 set)
    ctr_mask = np.zeros(32, dtype=np.uint8)
    ctr_mask[30] = 1  # bit 126 of the block
    zeros32 = B.slice0(nonce_bits, 0, 32)
    zeros32 = B.xor(zeros32, zeros32)  # 32 zero bit-planes of element shape
    ctr_bits = B.xor_public(zeros32, ctr_mask)
    block_bits = B.concat0([nonce_bits, ctr_bits])
    r_bits = aes128_encrypt_block(B, key_bits, block_bits)
    m_bits = B.xor(cipher_bits, r_bits)
    # bit index i has weight 2^(127-i): reverse, then compose
    m_rev = B.take0(m_bits, list(range(127, -1, -1)))
    return B.compose_ring128(m_rev)


# ---------------------------------------------------------------------------
# The entry points of the logical dialects' Decrypt
# ---------------------------------------------------------------------------


def _ret_precision(op):
    dtype = op.signature.return_type.dtype
    if dtype is None or not dtype.is_fixedpoint:
        raise TypeMismatchError(
            f"Decrypt {op.name}: return dtype must be fixed-point, found "
            f"{dtype}"
        )
    return dtype.integral_precision, dtype.fractional_precision


def decrypt_host(sess, h: str, key, ciphertext, op) -> HostFixedTensor:
    """Decrypt on a host placement (encrypted/ops.rs host_kernel): a
    replicated key is revealed to the host first."""
    from . import logical

    if isinstance(key, RepAesKey):
        rep = logical._rep_placement_of(sess, key.bits.tensor)
        bits = rep_ops.reveal(sess, rep, key.bits.tensor, h)
    elif isinstance(key, HostAesKey):
        bits = sess.place(h, key.bits)
    else:
        raise TypeMismatchError(f"Decrypt key: {type(key).__name__}")
    if not isinstance(ciphertext, AesTensor):
        raise TypeMismatchError(
            f"Decrypt ciphertext: {type(ciphertext).__name__}"
        )
    ring = aesgcm_decrypt_block(
        HostBitOps(sess, h),
        bits,
        sess.place(h, ciphertext.nonce_bits),
        sess.place(h, ciphertext.cipher_bits),
    )
    integ, frac = _ret_precision(op)
    return HostFixedTensor(ring, integ, frac)


def decrypt_rep(sess, rep, key, ciphertext, op) -> RepFixedTensor:
    """Decrypt under MPC in the per-host layout (encrypted/ops.rs
    rep_kernel): a host key is shared first, then the nonce and the
    ciphertext bits; the plaintext is never revealed."""
    if isinstance(key, HostAesKey):
        key_bits = rep_ops.share(sess, rep, key.bits)
    elif isinstance(key, RepAesKey):
        key_bits = key.bits.tensor
    else:
        raise TypeMismatchError(f"Decrypt key: {type(key).__name__}")
    if not isinstance(ciphertext, AesTensor):
        raise TypeMismatchError(
            f"Decrypt ciphertext: {type(ciphertext).__name__}"
        )
    nonce = rep_ops.share(sess, rep, ciphertext.nonce_bits)
    cipher = rep_ops.share(sess, rep, ciphertext.cipher_bits)
    ring = aesgcm_decrypt_block(RepBitOps(sess, rep), key_bits, nonce,
                                cipher)
    integ, frac = _ret_precision(op)
    return RepFixedTensor(ring, integ, frac)


@dataclasses.dataclass
class StackedAesKey:
    """AES key bit-shared in the party-stacked layout (SpmdBits with
    leading wire axis 128)."""

    bits: SpmdBits


def decrypt_stacked(spmd_sess, op, key, ciphertext) -> SpmdFixed:
    """Decrypt under MPC in the party-stacked layout: a host key is
    shared first, then the nonce and the ciphertext, in that order; the
    plaintext is never revealed."""
    if isinstance(key, HostAesKey):
        key_bits = sm.share_bits(spmd_sess, key.bits.value)
    elif isinstance(key, StackedAesKey):
        key_bits = key.bits
    else:
        raise TypeMismatchError(f"Decrypt key: {type(key).__name__}")
    if not isinstance(ciphertext, AesTensor):
        raise TypeMismatchError(
            f"Decrypt ciphertext: {type(ciphertext).__name__}"
        )
    nonce = sm.share_bits(spmd_sess, ciphertext.nonce_bits.value)
    cipher = sm.share_bits(spmd_sess, ciphertext.cipher_bits.value)
    ring = aesgcm_decrypt_block(StackedBitOps(spmd_sess), key_bits, nonce,
                                cipher)
    integ, frac = _ret_precision(op)
    return SpmdFixed(ring, integ, frac)


def _input_bits(arr, device) -> torch.Tensor:
    """An AES input's bits as uint8 on ``device``: a user's array, or the
    uint8 tensor a compiled plan bound ahead of the walk."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(np.asarray(arr).astype(np.uint8), device=device)


def lift_input(sess, comp, op, arr, plc: str, device):
    """A user's bit array as an AES value: an AesTensor ((224,) + shape:
    96 nonce bits, 128 ciphertext bits) or an AesKey ((128,) + shape).  A
    replicated-placement key arrives as cleartext bits on the first owner
    and is shared there in the per-host layout, with ``sess`` (the
    stacked layout shares it itself, ``stacked.lift_aes_input``)."""
    ret = op.signature.return_type
    bits = _input_bits(arr, device)
    plc_obj = comp.placements[plc]
    if ret.name == "AesTensor":
        if bits.shape[0] != 224:
            raise KernelError(
                f"AesTensor input {op.name}: leading axis must be 224 "
                f"(96 nonce + 128 ciphertext bits), found {bits.shape[0]}"
            )
        owner = plc if plc_obj.kind == "Host" else plc_obj.owners[0]
        return AesTensor(
            HostBitTensor(bits[:96], owner),
            HostBitTensor(bits[96:], owner),
            owner,
        )
    if ret.name in ("AesKey", "HostAesKey", "ReplicatedAesKey"):
        if bits.shape[0] != 128:
            raise KernelError(
                f"AesKey input {op.name}: leading axis must be 128, found "
                f"{bits.shape[0]}"
            )
        if plc_obj.kind == "Host":
            return HostAesKey(HostBitTensor(bits, plc), plc)
        if plc_obj.kind == "Replicated":
            host_bits = HostBitTensor(bits, plc_obj.owners[0])
            shared = rep_ops.share(sess, plc_obj, host_bits)
            return RepAesKey(RepBitArray(shared, 128))
    raise TypeMismatchError(
        f"cannot lift AES input of type {ret.name} on a {plc_obj.kind} "
        "placement"
    )
