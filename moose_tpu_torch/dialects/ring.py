"""Ring arithmetic over Z_{2^64} and Z_{2^128} on PyTorch tensors.

PyTorch counterpart of ``moose_tpu/dialects/ring.py``.  A ring word is a
``torch.int64`` tensor holding the same 64 bits as the JAX package's
``uint64`` word (``torch.uint64`` has no add, shift or compare on the
CPU).  Signed int64 addition, subtraction and multiplication wrap, which
is ring semantics; the two places where signedness would show are
written out: logical right shifts mask off the sign fill, and unsigned
compares (carries, borrows) flip the sign bit first.

A ring value is ``(lo, hi)`` with ``hi=None`` for width 64 — the two-word
layout of the JAX package, so shares convert word for word.

The PRF is one of three streams chosen for the process with
:func:`set_prf_impl` (or ``MOOSE_TPU_PRF`` at import).  Two are
threefry2x32-20 in counter mode: ``"threefry"``, the default, reproduces
``jax.random.bits`` on a threefry key (``jax_threefry_partitionable``):
for the flat index i the block ``(i >> 32, i & 0xFFFFFFFF)`` is
encrypted under the key words ``(s >> 32, s & 0xFFFFFFFF)`` of the u64
key ``s``; ``"threefry-pallas"`` is the JAX package's K7 stream
(``pallas_prf.py``).  The third, ``"aes-ctr"``, is the reference's own
construction: AES-128 in counter mode keyed by the seed's 16 bytes,
expanded on the host (``crypto/aes_prng.py``), as the JAX package
expands it.  Seeds are four u32 words.  A protocol session's draws come in groups whose seeds the CUDA
kernel ``csrc/threefry.cu`` derives on the card from the master key and
the nonce schedule (:func:`session_nonce`, :func:`draw_seed`) and
expands; a seed given here is expanded by the same kernel under its key
(:func:`stream_key`).  For the CPU, seeds are derived here in Python
integers and the plain PyTorch version expands them.
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch

from ..errors import ConfigurationError, KernelError

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
SIGN64 = -(1 << 63)
I64 = torch.int64


def signed64(value: int) -> int:
    """The int64 value with the bits of the u64 ``value``."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


# ---------------------------------------------------------------------------
# u64 helpers on int64 words
# ---------------------------------------------------------------------------


def ult(a, b):
    """Unsigned a < b on int64 words: flip the sign bits, compare signed."""
    return torch.bitwise_xor(a, SIGN64) < torch.bitwise_xor(b, SIGN64)


def lshr64(x, amount: int):
    """Logical right shift of int64 words by a static amount."""
    amount = int(amount)
    if amount == 0:
        return x
    if amount >= 64:
        return torch.zeros_like(x)
    return torch.bitwise_and(x >> amount, (1 << (64 - amount)) - 1)


def shl64(x, amount: int):
    amount = int(amount)
    if amount >= 64:
        return torch.zeros_like(x)
    return x << amount


def mulhi_u64(a, b):
    """High 64 bits of the 128-bit product of two u64 words, via 32-bit
    halves (schoolbook, as ``ring.mulhi_u64`` of the JAX package)."""
    al = torch.bitwise_and(a, MASK32)
    ah = lshr64(a, 32)
    bl = torch.bitwise_and(b, MASK32)
    bh = lshr64(b, 32)
    t = al * bl
    u = ah * bl + lshr64(t, 32)
    v = al * bh + torch.bitwise_and(u, MASK32)
    return ah * bh + lshr64(u, 32) + lshr64(v, 32)


def mulwide_u64(a, b):
    """(hi, lo) 128-bit product of u64 words."""
    return mulhi_u64(a, b), a * b


# ---------------------------------------------------------------------------
# Ring element ops.  A ring value is (lo, hi) with hi=None for width 64.
# ---------------------------------------------------------------------------


def add(lo1, hi1, lo2, hi2):
    lo = lo1 + lo2
    if hi1 is None:
        return lo, None
    carry = ult(lo, lo1).to(I64)
    return lo, hi1 + hi2 + carry


def sub(lo1, hi1, lo2, hi2):
    lo = lo1 - lo2
    if hi1 is None:
        return lo, None
    borrow = ult(lo1, lo2).to(I64)
    return lo, hi1 - hi2 - borrow


def neg(lo, hi):
    nlo = torch.zeros_like(lo) - lo
    if hi is None:
        return nlo, None
    borrow = (lo != 0).to(I64)
    return nlo, torch.zeros_like(hi) - hi - borrow


def mul(lo1, hi1, lo2, hi2):
    if hi1 is None:
        return lo1 * lo2, None
    p_hi, p_lo = mulwide_u64(lo1, lo2)
    return p_lo, p_hi + lo1 * hi2 + hi1 * lo2


def shl(lo, hi, amount: int):
    """Logical left shift by a static amount."""
    amount = int(amount)
    if hi is None:
        return shl64(lo, amount), None
    if amount == 0:
        return lo, hi
    if amount >= 128:
        return torch.zeros_like(lo), torch.zeros_like(hi)
    if amount >= 64:
        return torch.zeros_like(lo), shl64(lo, amount - 64)
    return lo << amount, torch.bitwise_or(
        hi << amount, lshr64(lo, 64 - amount)
    )


def shr(lo, hi, amount: int):
    """Logical right shift by a static amount."""
    amount = int(amount)
    if hi is None:
        return lshr64(lo, amount), None
    if amount == 0:
        return lo, hi
    if amount >= 128:
        return torch.zeros_like(lo), torch.zeros_like(hi)
    if amount >= 64:
        return lshr64(hi, amount - 64), torch.zeros_like(hi)
    return (
        torch.bitwise_or(lshr64(lo, amount), hi << (64 - amount)),
        lshr64(hi, amount),
    )


def shr_arith(lo, hi, amount: int):
    """Arithmetic (sign-extending) right shift by a static amount: the
    host fixed-point truncation (the secure path uses TruncPr).  int64's
    own ``>>`` is the arithmetic shift."""
    amount = int(amount)
    if hi is None:
        if amount == 0:
            return lo, None
        return lo >> min(amount, 63), None
    if amount == 0:
        return lo, hi
    sign_fill = hi >> 63
    if amount >= 128:
        return sign_fill, sign_fill
    if amount >= 64:
        new_lo = hi if amount == 64 else hi >> min(amount - 64, 63)
        return new_lo, sign_fill
    return (
        torch.bitwise_or(lshr64(lo, amount), hi << (64 - amount)),
        hi >> amount,
    )


def bit_extract(lo, hi, bit_idx: int):
    """Bit ``bit_idx`` as a ``torch.uint8`` 0/1 tensor."""
    bit_idx = int(bit_idx)
    word = lo if bit_idx < 64 else hi
    return torch.bitwise_and(word >> (bit_idx % 64), 1).to(torch.uint8)


def from_bit(bit, width: int):
    """A 0/1 uint8 tensor injected into the ring (RingInject at bit 0)."""
    lo = bit.to(I64)
    return lo, (torch.zeros_like(lo) if width == 128 else None)


def equal_bits(lo1, hi1, lo2, hi2):
    """Plaintext ring equality as uint8 0/1."""
    eq = lo1 == lo2
    if hi1 is not None:
        eq = torch.logical_and(eq, hi1 == hi2)
    return eq.to(torch.uint8)


def from_numpy_u64(arr, device):
    """A numpy array's values as ring64 words (``hi`` None)."""
    import numpy as np

    words = np.array(arr, dtype=np.uint64, order="C")
    return torch.from_numpy(words.view(np.int64)).to(device), None


def fill_like_shape(shape, width: int, value: int, device):
    value = int(value) % (1 << width)
    lo = torch.full(
        tuple(shape), signed64(value), dtype=I64, device=device
    )
    if width == 64:
        return lo, None
    hi = torch.full(
        tuple(shape), signed64(value >> 64), dtype=I64, device=device
    )
    return lo, hi


def from_python_ints(values: Sequence[int], width: int, device):
    """(lo, hi) words of a 1-D sequence of Python ints, which may reach
    past 2^64 (the high word takes bits 64-127)."""
    ints = [int(v) for v in values]
    lo = torch.tensor([signed64(v) for v in ints], dtype=I64, device=device)
    if width == 64:
        return lo, None
    hi = torch.tensor(
        [signed64(v >> 64) for v in ints], dtype=I64, device=device
    )
    return lo, hi


def sum_(lo, hi, axis: int):
    """Sum-reduce over ``axis`` mod 2^w.  For ring128 the low words are
    summed as 32-bit halves (exact in 64 bits), and the carry into the
    high word is recombined with logical shifts and an unsigned compare,
    as ``ring.sum_`` of the JAX package does."""
    if hi is None:
        return torch.sum(lo, dim=axis), None
    s_ll = torch.sum(torch.bitwise_and(lo, MASK32), dim=axis)
    s_lh = torch.sum(lshr64(lo, 32), dim=axis)
    s_hi = torch.sum(hi, dim=axis)
    lo_out = s_ll + (s_lh << 32)
    carry = lshr64(s_lh, 32) + ult(lo_out, s_ll).to(I64)
    return lo_out, s_hi + carry


# ---------------------------------------------------------------------------
# Convolution helpers: patch extraction for a convolution (im2col, then
# the secure dot's matrix product) and the pools
# ---------------------------------------------------------------------------


def conv_out_size(size: int, k: int, stride: int, pad0: int, pad1: int) -> int:
    return (size + pad0 + pad1 - k) // stride + 1


def resolve_padding(padding, h, w, kh, kw, sh, sw):
    """Normalize padding to ((ph0, ph1), (pw0, pw1)).

    Accepts "VALID", "SAME" (TF convention: output = ceil(in/stride)),
    or explicit ((ph0, ph1), (pw0, pw1))."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        def same(size, k, s):
            out = -(-size // s)
            total = max(0, (out - 1) * s + k - size)
            return total // 2, total - total // 2

        return same(h, kh, sh), same(w, kw, sw)
    (p0, p1), (q0, q1) = padding
    return (int(p0), int(p1)), (int(q0), int(q1))


def check_maxpool_padding(padding, h, w, kh, kw, sh, sw):
    """Shared padding policy for secret max pooling: implicit padding
    would pad with the ring encoding of 0, while the host kernel pads
    with -inf — negative inputs would silently produce different results
    per placement.  Rejected unless MOOSE_TPU_MAXPOOL_ZERO_PAD=1
    explicitly accepts zero-padding semantics."""
    (p0, p1), (q0, q1) = resolve_padding(padding, h, w, kh, kw, sh, sw)
    if (p0, p1, q0, q1) == (0, 0, 0, 0):
        return
    if os.environ.get("MOOSE_TPU_MAXPOOL_ZERO_PAD") == "1":
        return
    raise KernelError(
        "padded max_pool2d on a secret-shared placement pads with the "
        "ring encoding of 0, while the host kernel pads with -inf — "
        "negative inputs would silently produce different results per "
        "placement.  Use VALID padding, pad on the host side, or set "
        "MOOSE_TPU_MAXPOOL_ZERO_PAD=1 to accept zero-padding semantics."
    )


def im2col(x, kh: int, kw: int, strides, padding):
    """Extract conv patches from an NHWC tensor of any dtype (ring words
    or bits).

    Returns (patches, out_h, out_w) where patches has shape
    (N, out_h, out_w, kh*kw*C), the taps in row-major (i, j) order with
    the channels inside each tap — the layout of an HWIO kernel reshaped
    to (kh*kw*C, O)."""
    sh, sw = strides
    n, h, w, c = x.shape
    (ph0, ph1), (pw0, pw1) = resolve_padding(padding, h, w, kh, kw, sh, sw)
    if ph0 or ph1 or pw0 or pw1:
        # zero padding is exact for secret shares too: sharing is linear,
        # so zero-padded shares reconstruct to a zero-padded secret
        padded = x.new_zeros((n, h + ph0 + ph1, w + pw0 + pw1, c))
        padded[:, ph0:ph0 + h, pw0:pw0 + w] = x
        x = padded
    out_h = conv_out_size(h, kh, sh, ph0, ph1)
    out_w = conv_out_size(w, kw, sw, pw0, pw1)
    cols = [
        x[:, i:i + (out_h - 1) * sh + 1:sh, j:j + (out_w - 1) * sw + 1:sw]
        for i in range(kh)
        for j in range(kw)
    ]
    return torch.cat(cols, dim=-1), out_h, out_w


def _promote(lo1, hi1, lo2, hi2):
    """Vector operands of a matrix product as matrices, as
    ``ring.matmul`` of the JAX package promotes them."""
    if lo1.dim() == 1:
        lo1 = lo1[None, :]
        hi1 = None if hi1 is None else hi1[None, :]
    if lo2.dim() == 1:
        lo2 = lo2[:, None]
        hi2 = None if hi2 is None else hi2[:, None]
    return lo1, hi1, lo2, hi2


def _squeeze(t, a_vec: bool, b_vec: bool):
    """The unit axes a promotion added, dropped from a product."""
    if t is None:
        return None
    if a_vec and b_vec:
        return t[0, 0]
    if a_vec:
        return t[0]
    if b_vec:
        return t[..., 0]
    return t


def matmul(lo1, hi1, lo2, hi2):
    """Ring matrix product (Dot) mod 2^w; vector operands are promoted to
    matrices and the unit axes squeezed from the result.  On the card it
    is K1 (``dot_cross_terms`` as ``x0 @ ysum`` with zero ``x1`` and
    ``y0``): PyTorch has no int64 matrix product on CUDA."""
    from ..native import ring_kernels as rk

    a_vec, b_vec = lo1.dim() == 1, lo2.dim() == 1
    lo1, hi1, lo2, hi2 = _promote(lo1, hi1, lo2, hi2)
    width = 64 if hi1 is None else 128
    lo, hi = rk.ring_matmul((lo1, hi1), (lo2, hi2), width)
    return _squeeze(lo, a_vec, b_vec), _squeeze(hi, a_vec, b_vec)


def dot_cross_terms(x0, x1, y0, y1, width: int):
    """One party's cross terms of a secure matrix product,
    ``x0 @ (y0 + y1) + x1 @ y0`` mod 2^w, for (lo, hi) pairs: K1 at one
    party on the card.  Vector operands are promoted, then squeezed."""
    from ..native import ring_kernels as rk

    a_vec, b_vec = x0[0].dim() == 1, y0[0].dim() == 1
    x0l, x0h, y0l, y0h = _promote(*x0, *y0)
    x1l, x1h, y1l, y1h = _promote(*x1, *y1)
    lo, hi = rk.party_dot_cross_terms(
        (x0l, x0h), (x1l, x1h), (y0l, y0h), add(y0l, y0h, y1l, y1h), width
    )
    return _squeeze(lo, a_vec, b_vec), _squeeze(hi, a_vec, b_vec)


def conv_columns(x_lo, x_hi, kshape, strides, padding):
    """An NHWC input's im2col columns for an HWIO kernel of ``kshape``,
    flattened to (N*OH*OW, KH*KW*C), and the output's (N, OH, OW)."""
    kh, kw, c, _ = kshape
    n = x_lo.shape[0]
    p_lo, out_h, out_w = im2col(x_lo, kh, kw, strides, padding)
    rows = n * out_h * out_w
    cols_lo = p_lo.reshape(rows, kh * kw * c)
    cols_hi = None
    if x_hi is not None:
        p_hi, _, _ = im2col(x_hi, kh, kw, strides, padding)
        cols_hi = p_hi.reshape(rows, kh * kw * c)
    return (cols_lo, cols_hi), (n, out_h, out_w)


def kernel_matrix(k_lo, k_hi):
    """An HWIO kernel reshaped to (KH*KW*C, O)."""
    kh, kw, c, o = k_lo.shape
    return (k_lo.reshape(kh * kw * c, o),
            None if k_hi is None else k_hi.reshape(kh * kw * c, o))


def conv2d(x_lo, x_hi, k_lo, k_hi, strides=(1, 1), padding="VALID"):
    """Ring convolution: x (N, H, W, C) * kernel (KH, KW, C, O) ->
    (N, OH, OW, O), exact mod 2^w via im2col and :func:`matmul`."""
    cols, (n, out_h, out_w) = conv_columns(
        x_lo, x_hi, tuple(k_lo.shape), strides, padding)
    lo, hi = matmul(*cols, *kernel_matrix(k_lo, k_hi))
    o = k_lo.shape[-1]
    return (lo.reshape(n, out_h, out_w, o),
            None if hi is None else hi.reshape(n, out_h, out_w, o))


# ---------------------------------------------------------------------------
# Fixed-point encode/decode
# ---------------------------------------------------------------------------


def fixedpoint_encode(x, frac_precision: int, width: int):
    """Encode floats into the ring: round(x * 2^f), two's complement,
    rounding half to even as ``jnp.round`` does."""
    if not x.is_floating_point():
        raise NotImplementedError(
            "the port encodes float tensors only; the integer dialect's "
            "scale-0 lift is ROADMAP queue 1, item 6"
        )
    scaled = torch.round(x.to(torch.float64) * (2.0 ** frac_precision))
    si = scaled.to(I64)
    if width == 64:
        return si, None
    return si, si >> 63  # sign extension


def u64_to_float64(x):
    """Correctly rounded u64 -> float64 of int64 words: the two 32-bit
    halves convert exactly and one addition rounds."""
    hi = lshr64(x, 32).to(torch.float64) * 4294967296.0
    return hi + torch.bitwise_and(x, MASK32).to(torch.float64)


def fixedpoint_decode(lo, hi, frac_precision: int):
    """Decode ring values to float64 as signed two's complement; negatives
    are negated to magnitude before the float conversion, as in the JAX
    package."""
    if hi is None:
        return lo.to(torch.float64) / (2.0 ** frac_precision)
    negative = hi < 0
    mlo, mhi = neg(lo, hi)
    mag_lo = torch.where(negative, mlo, lo)
    mag_hi = torch.where(negative, mhi, hi)
    mag = u64_to_float64(mag_hi) * (2.0 ** 64) + u64_to_float64(mag_lo)
    v = torch.where(negative, -mag, mag)
    return v / (2.0 ** frac_precision)


# ---------------------------------------------------------------------------
# PRF: threefry2x32-20 (the JAX package's "threefry" and "threefry-pallas"
# implementations)
# ---------------------------------------------------------------------------

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_GOLDEN64 = 0x9E3779B97F4A7C15

Seed = Tuple[int, int, int, int]

PRF_IMPLS = ("threefry", "threefry-pallas", "aes-ctr")


def _checked_prf_impl(name: str) -> str:
    if name == "rbg":
        raise ConfigurationError(
            "the rbg PRF is XLA's RngBitGenerator, which has no "
            "counterpart outside XLA; the port offers "
            f"{PRF_IMPLS}"
        )
    if name not in PRF_IMPLS:
        raise ConfigurationError(
            f"PRF impl must be one of {PRF_IMPLS}, got {name!r}"
        )
    return name


_PRF_IMPL = _checked_prf_impl(os.environ.get("MOOSE_TPU_PRF", "threefry"))


def set_prf_impl(name: str) -> None:
    """Select the process's PRF stream: ``"threefry"`` (the default;
    ``jax.random.bits`` on a threefry key) or ``"threefry-pallas"`` (the
    JAX package's K7 stream), both threefry2x32-20 expanded by
    ``csrc/threefry.cu`` on the card; or ``"aes-ctr"``, the reference's
    AES-128-CTR, expanded on the host.  All three are cryptographic
    PRFs.  ``"rbg"`` raises ``ConfigurationError``."""
    global _PRF_IMPL
    _PRF_IMPL = _checked_prf_impl(name)


def get_prf_impl() -> str:
    return _PRF_IMPL


def require_strong_prf(context: str) -> None:
    """Refuse a non-cryptographic PRF where parties distrust each other.
    All of the port's streams are cryptographic, so this passes whenever
    the selection did; it stands where the JAX package gates its rbg
    default."""
    if _PRF_IMPL not in PRF_IMPLS:
        raise ConfigurationError(
            f"{context} requires a cryptographic PRF, got {_PRF_IMPL!r}"
        )


def _rotl32(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32_20(x0, x1, k0: int, k1: int):
    """20 rounds of threefry2x32.  ``x0``/``x1`` are Python ints or int64
    tensors holding u32 values; ``k0``/``k1`` are u32 Python ints.  The
    same code serves seeds on the host and the plain version of the
    counter-mode kernel."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for group in range(5):
        for r in _ROT_A if group % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK32
    return x0, x1


def _key_from_seed(seed: Seed) -> Tuple[int, int]:
    """The (k0, k1) threefry key words ``ring._key_from_seed`` builds for
    a uint32[4] seed: u64 ``data ^ data2 * 0x9E3779B97F4A7C15``, split as
    ``jax.random.key`` splits a u64 seed."""
    data = (seed[0] << 32) | seed[1]
    data2 = (seed[2] << 32) | seed[3]
    s = (data ^ (data2 * _GOLDEN64)) & MASK64
    return s >> 32, s & MASK32


def _seed_words(seed) -> Seed:
    words = tuple(int(w) & MASK32 for w in seed)
    if len(words) != 4:
        raise ValueError(f"a seed is 4 u32 words, got {len(words)}")
    return words


def mix_seed(seed, nonce) -> Seed:
    """Derive a fresh 128-bit seed from (key, public nonce): the four u32
    words of ``jax.random.bits(key, (4,), uint32)`` under the key mixed
    from ``seed ^ (nonce * 0x9E3779B9 + 0x85EBCA6B)``, computed on the
    host in Python integers.  The same under either PRF stream: the JAX
    package derives seeds on the threefry key under both."""
    k = _seed_words(seed)
    n = _seed_words(nonce)
    mixed = tuple(
        ki ^ ((ni * 0x9E3779B9 + 0x85EBCA6B) & MASK32) for ki, ni in zip(k, n)
    )
    k0, k1 = _key_from_seed(mixed)
    out = []
    for i in range(4):
        y0, y1 = threefry2x32_20(0, i, k0, k1)
        out.append(y0 ^ y1)
    return tuple(out)


def session_nonce(idx: int, domain: int) -> Seed:
    """The public nonce of draw ``idx`` of a session in ``domain``: the
    JAX package's ``SpmdSession._next_seed`` schedule."""
    return (
        idx & MASK32,
        0x5B3D9E21 ^ ((domain * 0x85EBCA6B) & MASK32),
        (idx ^ 0xA5A5A5A5) & MASK32,
        7,
    )


def draw_seed(master, domain: int, idx: int) -> Seed:
    """The seed of draw ``idx`` of a session keyed by ``master``, derived
    on the host.  ``csrc/threefry.cu`` derives the same words on the card
    for a group of draws."""
    return mix_seed(master, session_nonce(idx, domain))


def stream_key(seed, layout: str, bits: bool) -> Tuple[int, int]:
    """The threefry key words that expand a draw from ``seed`` in the
    stream ``layout``: for a bit draw the seed takes its domain tag
    first; ``"threefry"`` keys with :func:`_key_from_seed`,
    ``"threefry-pallas"`` folds the seed to ``(s0 ^ s2, s1 ^ s3)``."""
    s = _bit_domain_seed(seed) if bits else _seed_words(seed)
    if layout == "threefry-pallas":
        return s[0] ^ s[2], s[1] ^ s[3]
    return _key_from_seed(s)


def random_bits_u64(seed, shape: Sequence[int], device):
    """``jax.random.bits(key, shape, uint64)`` for the threefry key of
    ``seed``, as int64 words on ``device``."""
    # imported here: ring_kernels is built on this module
    from ..native import ring_kernels as rk

    k0, k1 = stream_key(seed, "threefry", bits=False)
    shape = tuple(int(s) for s in shape)
    return rk.threefry_words(
        k0, k1, math.prod(shape), "threefry", device
    ).reshape(shape)


def _random_bits_u64(seed, shape, device):
    """u64 words of ``shape`` from ``seed`` in the selected stream."""
    if _PRF_IMPL == "threefry-pallas":
        from . import pallas_prf

        return pallas_prf.random_bits_u64(seed, shape, device)
    return random_bits_u64(seed, shape, device)


def seed_bytes(seed) -> bytes:
    """The 16 key bytes of an ``aes-ctr`` stream: the seed's four u32
    words little-endian, as ``np.uint32`` words lay them out."""
    return b"".join(w.to_bytes(4, "little") for w in _seed_words(seed))


def aes_ctr_words(seed, n: int, width: int):
    """``n`` ring elements of the ``aes-ctr`` stream of ``seed`` as numpy
    uint64 ``(lo, hi)`` (hi None at ring64): u64 words little-endian, a
    ring128 element drawing its high word first."""
    from ..crypto.aes_prng import AesCtrRng

    rng = AesCtrRng(seed_bytes(seed))
    if width == 64:
        return rng.uniform_u64(n), None
    return rng.uniform_u128(n)


def aes_ctr_bits(seed, n: int):
    """``n`` bits of the ``aes-ctr`` stream of ``seed`` tagged for bits
    (:func:`_bit_domain_seed`), as numpy uint8 0/1: one keystream byte's
    low bit each."""
    from ..crypto.aes_prng import AesCtrRng

    return AesCtrRng(seed_bytes(_bit_domain_seed(seed))).bits(n)


def _words_tensor(words, shape, device):
    return torch.from_numpy(words.view("<i8").reshape(shape)).to(device)


def sample_uniform_seeded(shape, seed, width: int, device):
    """Uniform ring elements from ``seed``: one u64 draw for ring64; for
    ring128 under threefry one ``(2,)+shape`` draw with ``lo = both[1]``,
    ``hi = both[0]``, under aes-ctr each element's high word first, as
    the JAX package draws them."""
    shape = tuple(int(s) for s in shape)
    if _PRF_IMPL == "aes-ctr":
        lo, hi = aes_ctr_words(seed, math.prod(shape), width)
        return (_words_tensor(lo, shape, device),
                None if hi is None else _words_tensor(hi, shape, device))
    if width == 64:
        return _random_bits_u64(seed, shape, device), None
    both = _random_bits_u64(seed, (2,) + shape, device)
    return both[1], both[0]


def _bit_domain_seed(seed) -> Seed:
    """Domain-separation tag for bit draws: the top bit of the last seed
    word flipped, so a seed reused for a uniform draw and a bit draw
    never indexes the same counter stream."""
    words = _seed_words(seed)
    return words[:3] + (words[3] ^ 0x80000000,)


def sample_bits_seeded(shape, seed, device):
    """Uniform bits as ``torch.uint8`` 0/1 from the tagged ``seed``.
    Under ``"threefry"``: ``jax.random.bits(key, shape, uint8) & 1``, i.e.
    bit 0 of ``y0 ^ y1`` for the counter block of each flat index.  Under
    ``"threefry-pallas"``: ``ceil(n/64)`` words of K7's stream, element
    ``64w + j`` being bit ``j`` of word ``w``.  Under ``"aes-ctr"``: one
    keystream byte's low bit each."""
    tagged = _bit_domain_seed(seed)
    shape = tuple(int(s) for s in shape)
    if _PRF_IMPL == "aes-ctr":
        bits = aes_ctr_bits(seed, math.prod(shape))
        return torch.from_numpy(bits.reshape(shape)).to(device)
    if _PRF_IMPL == "threefry-pallas":
        from . import pallas_prf

        return pallas_prf.random_bits_u8(tagged, shape, device)
    from ..native import ring_kernels as rk

    k0, k1 = stream_key(seed, "threefry", bits=True)
    return rk.threefry_bits(
        k0, k1, math.prod(shape), "threefry", device
    ).reshape(shape)


def sample_bit_tensor_seeded(shape, seed, device):
    """Uniform bits as ``torch.uint8`` 0/1 from the UNTAGGED ``seed``: the
    JAX package's ``host.sample_bit_tensor_seeded``, which draws
    ``jax.random.bits(key, shape, uint8) & 1`` on ``_key_from_seed(seed)``
    under both threefry streams (it has no threefry-pallas branch), and
    one AES-CTR keystream byte's low bit each under ``"aes-ctr"``.  The
    per-host layout's zero shares of bits and its shared bit inputs draw
    here."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if _PRF_IMPL == "aes-ctr":
        from ..crypto.aes_prng import AesCtrRng

        bits = AesCtrRng(seed_bytes(seed)).bits(n)
        return torch.from_numpy(bits.reshape(shape)).to(device)
    from ..native import ring_kernels as rk

    k0, k1 = stream_key(seed, "threefry", bits=False)
    return rk.threefry_bits(k0, k1, n, "threefry", device).reshape(shape)
