"""The protocol sigmoid in the party-stacked layout.

PyTorch counterpart of the part of ``moose_tpu/parallel/spmd_math.py``
that the exact protocol sigmoid runs: replicated bit sharings, bit
decomposition through a Kogge-Stone adder, bit-to-arithmetic conversion,
the most significant bit, selection, Goldschmidt division, the
fixed-point Horner polynomial and 2^x.  The rest of that module (exp,
log, sqrt, max/argmax, softmax, the pools) is a later slice (ROADMAP
queue 1, item 4).

A replicated bit sharing is one ``torch.uint8`` tensor
``(party=3, slot=2, [bits=k,] *shape)`` of 0/1 with XOR share semantics,
the JAX package's layout.  Randomness is drawn from the
:class:`~moose_tpu_torch.parallel.spmd.SpmdSession` in the JAX package's
order; the kernels (``bit_decompose``/``msb``, ``horner``) take their
randomness pre-drawn, so shares stay bit-identical to the JAX package's
under the same master key and PRF.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from ..dialects import ring
from ..dialects.fixedpoint import P_1045, encode_const
from ..errors import KernelError
from ..native import ring_kernels as rk
from . import spmd
from .spmd import SpmdFixed, SpmdRep, SpmdSession

U8 = torch.uint8


# ---------------------------------------------------------------------------
# Replicated bit sharing (XOR over Z_2), party-stacked
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpmdBits:
    """Party-stacked replicated bit tensor: uint8 (3, 2, *shape) in
    {0, 1}; pair layout as SpmdRep (arr[i, 0] = b_i, arr[i, 1] =
    b_{i+1})."""

    arr: torch.Tensor

    @property
    def shape(self):
        return tuple(self.arr.shape[2:])


def _roll(t: torch.Tensor) -> torch.Tensor:
    return torch.roll(t, -1, dims=0)


def bits_xor(x: SpmdBits, y: SpmdBits) -> SpmdBits:
    return SpmdBits(torch.bitwise_xor(x.arr, y.arr))


def bits_not(x: SpmdBits) -> SpmdBits:
    """NOT: flip the public constant 1 into share b_0 only (held at pair
    slots (0, 0) and (2, 1))."""
    arr = x.arr.clone()
    arr[0, 0] ^= 1
    arr[2, 1] ^= 1
    return SpmdBits(arr)


def _bits_and_bank(x: SpmdBits, y: SpmdBits, bank) -> SpmdBits:
    """AND = multiplication over Z_2 with the draw hoisted out: local
    cross terms + the XOR zero share of ``bank`` + the reshare roll."""
    x0, x1 = x.arr[:, 0], x.arr[:, 1]
    y0, y1 = y.arr[:, 0], y.arr[:, 1]
    v = (x0 & (y0 ^ y1)) ^ (x1 & y0)
    z = v ^ (bank ^ _roll(bank))
    return SpmdBits(torch.stack([z, _roll(z)], dim=1))


def bits_and(sess: SpmdSession, x: SpmdBits, y: SpmdBits) -> SpmdBits:
    """AND with a fresh bank of the operands' broadcast shape."""
    v_shape = torch.broadcast_shapes(
        x.arr[:, 0].shape, y.arr[:, 0].shape
    )[1:]
    return _bits_and_bank(x, y, sess.sample_bit_bank(v_shape))


def bits_or(sess: SpmdSession, x: SpmdBits, y: SpmdBits) -> SpmdBits:
    return bits_xor(bits_xor(x, y), bits_and(sess, x, y))


def shl_bits(x: SpmdBits, d: int) -> SpmdBits:
    """Shift along the bit axis (tensor axis 2) toward the MSB, filling
    zeros (a valid XOR sharing of zero)."""
    if d == 0:
        return x
    k = x.arr.shape[2]
    if d >= k:
        return SpmdBits(torch.zeros_like(x.arr))
    z = torch.zeros_like(x.arr[:, :, :d])
    return SpmdBits(torch.cat([z, x.arr[:, :, : k - d]], dim=2))


def _bit_slice(x: SpmdBits, start: int, stop: int) -> SpmdBits:
    return SpmdBits(x.arr[:, :, start:stop])


# ---------------------------------------------------------------------------
# Bit decomposition + adder
# ---------------------------------------------------------------------------


def _plain_bits(lo, hi, width: int) -> torch.Tensor:
    """Bit planes of the held ring shares: (3, 2, k, *shape) uint8.
    ``(w >> s) & 1`` is bit s of the word for s < 64, signed or not."""
    shifts = torch.arange(64, dtype=torch.int64, device=lo.device)
    shifts = shifts.reshape((64,) + (1,) * (lo.dim() - 2))

    def planes(w):
        return torch.bitwise_and(w[:, :, None] >> shifts, 1).to(U8)

    if width == 64:
        return planes(lo)
    return torch.cat([planes(lo), planes(hi)], dim=2)


@functools.lru_cache(maxsize=None)
def _summand_mask(j: int, ndim: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """(3, 2, 1...) mask selecting the pair slots that hold summand x_j:
    (party j, slot 0) and (party j-1, slot 1).  Cached; read-only."""
    m = torch.zeros((3, 2), dtype=dtype, device=device)
    m[j, 0] = 1
    m[(j - 1) % 3, 1] = 1
    return m.reshape((3, 2) + (1,) * (ndim - 2))


def _kogge_stone_banks(x: SpmdBits, y: SpmdBits, k: int,
                       next_bank) -> SpmdBits:
    """Carry-lookahead adder of x + y over k bits consuming banks from
    ``next_bank()``: log2(k) rounds of two ANDs (the last round's p_run
    update would be dead and is skipped)."""
    p = bits_xor(x, y)
    g = _bits_and_bank(x, y, next_bank())
    p_run = p
    d = 1
    while d < k:
        g = bits_xor(g, _bits_and_bank(p_run, shl_bits(g, d), next_bank()))
        if d * 2 < k:
            p_run = _bits_and_bank(p_run, shl_bits(p_run, d), next_bank())
        d *= 2
    return bits_xor(p, shl_bits(g, 1))


def _draw_adder_banks(sess: SpmdSession, x: SpmdRep) -> torch.Tensor:
    """The decomposition's AND banks, drawn in the order the adder
    consumes them, as one K7 group straight into the (n_ands, 3, k,
    *shape) uint8 array the ``bit_decompose``/``msb`` kernel reads."""
    bank_shape = (x.width,) + tuple(x.shape)
    n_ands = rk.adder_bank_count(x.width)
    banks = torch.empty((n_ands, 3) + bank_shape, dtype=U8,
                        device=x.lo.device)
    n = 3 * math.prod(bank_shape)
    sess.sample_group([("bit_bank", bank_shape, None, (banks, i * n))
                       for i in range(n_ands)])
    return banks


def _bit_decompose_with_banks(lo, hi, width: int, banks) -> torch.Tensor:
    """The plain version of the ``bit_decompose`` kernel: bit planes of
    the held shares, the three statically masked summands, carry-save
    and the Kogge-Stone adder over the pre-drawn ``banks`` in order.
    Returns the (3, 2, k, *shape) uint8 bit-share array."""
    B = _plain_bits(lo, hi, width)
    b0, b1, b2 = (
        SpmdBits(B * _summand_mask(j, B.dim(), U8, B.device))
        for j in range(3)
    )
    next_bank = functools.partial(next, iter(banks))
    s = bits_xor(bits_xor(b0, b1), b2)
    c = bits_xor(
        _bits_and_bank(b0, b1, next_bank()),
        _bits_and_bank(bits_xor(b0, b1), b2, next_bank()),
    )
    return _kogge_stone_banks(s, shl_bits(c, 1), width, next_bank).arr


def bit_decompose(sess: SpmdSession, x: SpmdRep) -> SpmdBits:
    """Arithmetic -> binary sharing: x = x_0 + x_1 + x_2 with each
    summand trivially XOR-shared, a carry-save step and one Kogge-Stone
    adder, in the ``bit_decompose`` kernel.  Returns bits with a bit axis
    of length k at tensor axis 2."""
    banks = _draw_adder_banks(sess, x)
    return SpmdBits(rk.bit_decompose(*_words(x), x.width, banks))


def _words(x: SpmdRep):
    return x.lo.contiguous(), None if x.hi is None else x.hi.contiguous()


def b2a(sess: SpmdSession, bits: SpmdBits, width: int) -> SpmdRep:
    """XOR-shared bits -> arithmetic sharing over Z_{2^w}: with
    b = b0 ^ b1 ^ b2 and a ^ b = a + b - 2ab, two secure multiplies
    convert the whole stacked tensor at once."""
    lo_all = bits.arr.to(torch.int64)
    parts = []
    for j in range(3):
        lo = lo_all * _summand_mask(j, lo_all.dim(), torch.int64,
                                    lo_all.device)
        hi = torch.zeros_like(lo) if width == 128 else None
        parts.append(SpmdRep(lo, hi, width))
    a0, a1, a2 = parts

    def arith_xor(u, v):
        uv = spmd.mul(sess, u, v)
        return spmd.sub(spmd.add(u, v), spmd.shl(uv, 1))

    return arith_xor(arith_xor(a0, a1), a2)


def weighted_bit_sum(ring_bits: SpmdRep, weights: Sequence[int]) -> SpmdRep:
    """sum_i ring_bits[i] * weights[i] along the leading (bit) logical
    axis, public integer weights (up to 2^127 at ring128)."""
    nd = len(ring_bits.shape) - 1
    w_lo, w_hi = ring.from_python_ints(
        weights, ring_bits.width, ring_bits.lo.device
    )
    shape = (len(weights),) + (1,) * nd
    z = spmd.mul_public(
        ring_bits, w_lo.reshape(shape),
        None if w_hi is None else w_hi.reshape(shape),
    )
    return spmd.sum_axis(z, 0)


def msb(sess: SpmdSession, x: SpmdRep) -> SpmdBits:
    """The top bit of the decomposition, from the same kernel writing
    only that bit (comparisons need nothing else)."""
    banks = _draw_adder_banks(sess, x)
    return SpmdBits(rk.msb(*_words(x), x.width, banks))


# ---------------------------------------------------------------------------
# Selection and public constants
# ---------------------------------------------------------------------------


def mux_ring(sess, s: SpmdRep, x: SpmdRep, y: SpmdRep) -> SpmdRep:
    """y + s * (x - y) with s an arithmetic 0/1 sharing."""
    return spmd.add(y, spmd.mul(sess, s, spmd.sub(x, y)))


def mux_bit(sess, s_bit: SpmdBits, x: SpmdRep, y: SpmdRep) -> SpmdRep:
    return mux_ring(sess, b2a(sess, s_bit, x.width), x, y)


def _const(x: SpmdRep, raw: int):
    return ring.fill_like_shape((), x.width, raw, x.lo.device)


def add_public_raw(x: SpmdRep, raw: int) -> SpmdRep:
    return spmd.add_public(x, *_const(x, raw))


def public_sub_raw(raw: int, x: SpmdRep) -> SpmdRep:
    return spmd.public_sub(*_const(x, raw), x)


def sign_from_msb(msb_ring: SpmdRep) -> SpmdRep:
    """(-1)^msb = 1 - 2*msb."""
    return public_sub_raw(1, spmd.shl(msb_ring, 1))


# ---------------------------------------------------------------------------
# Normalization + Goldschmidt division
# ---------------------------------------------------------------------------


def prefix_or(sess, bits: SpmdBits, n: int) -> SpmdBits:
    """out[i] = OR(x[0..=i]) along the bit axis; log2(n) rounds, whose
    AND banks (all of the bits' shape) are one K7 group drawn before the
    first round, in the rounds' nonce order."""
    shifts = []
    d = 1
    while d < n:
        shifts.append(d)
        d *= 2
    banks = sess.sample_group(
        [("bit_bank", bits.arr.shape[2:], None)] * len(shifts)
    )
    for d, bank in zip(shifts, banks):
        shifted = shl_bits(bits, d)
        bits = bits_xor(bits_xor(bits, shifted),
                        _bits_and_bank(bits, shifted, bank))
    return bits


def top_most_index(sess, x: SpmdRep, max_bits: int) -> SpmdRep:
    """2^(max_bits - 1 - t) for t = index of x's top set bit: reversed
    prefix-OR differences one-hot the top bit; compose with weights
    2^i."""
    bits = bit_decompose(sess, x)
    rev = SpmdBits(torch.flip(bits.arr[:, :, :max_bits], dims=(2,)))
    y = prefix_or(sess, rev, max_bits)
    z = bits_xor(y, shl_bits(y, 1))
    z_ring = b2a(sess, z, x.width)
    return weighted_bit_sum(z_ring, [1 << i for i in range(max_bits)])


def norm(sess, x: SpmdRep, max_bits: int, positive: bool = False):
    """(|x| upshifted so its top bit sits at max_bits-1, signed upshift
    factor).  ``positive=True`` skips the sign round for callers that
    know x > 0."""
    if positive:
        top = top_most_index(sess, x, max_bits)
        return spmd.mul(sess, x, top), top
    m_ring = b2a(sess, msb(sess, x), x.width)
    sign = sign_from_msb(m_ring)
    abs_x = spmd.mul(sess, sign, x)
    top = top_most_index(sess, abs_x, max_bits)
    upshifted = spmd.mul(sess, abs_x, top)
    signed_top = spmd.mul(sess, sign, top)
    return upshifted, signed_top


def approximate_reciprocal(
    sess, x: SpmdRep, int_precision: int, frac_precision: int,
    positive: bool = False,
) -> SpmdRep:
    """Initial w ~ 1/x for Goldschmidt."""
    total = int_precision + frac_precision
    upshifted, signed_top = norm(sess, x, total, positive=positive)
    alpha_raw = encode_const(2.9142, total, x.width)
    d = public_sub_raw(alpha_raw, spmd.shl(upshifted, 1))
    w = spmd.mul(sess, d, signed_top)
    return spmd.trunc_pr(sess, w, 2 * int_precision)


def fx_div(sess, x: SpmdFixed, y: SpmdFixed,
           positive_divisor: bool = False) -> SpmdFixed:
    """Goldschmidt division with the residual truncated to scale f each
    round, so every product stays within 2f raw bits."""
    i_p = x.integral_precision
    f_p = x.fractional_precision
    k = i_p + f_p
    width = x.tensor.width
    if 2 * k > width:
        raise KernelError(
            f"division requires 2*(i+f) <= ring width, got 2*{k} > {width}"
        )
    theta = max(1, math.ceil(math.log2(k / math.log2(17.0))))

    w = approximate_reciprocal(
        sess, y.tensor, i_p, f_p, positive=positive_divisor
    )
    alpha_raw = encode_const(1.0, f_p, width)

    init_prod = spmd.trunc_pr(sess, spmd.mul(sess, y.tensor, w), f_p)
    a = public_sub_raw(alpha_raw, init_prod)
    b = spmd.trunc_pr(sess, spmd.mul(sess, x.tensor, w), f_p)

    for _ in range(theta):
        a_plus = add_public_raw(a, alpha_raw)
        next_b = spmd.mul(sess, b, a_plus)
        next_a = spmd.mul(sess, a, a)
        a = spmd.trunc_pr(sess, next_a, f_p)
        b = spmd.trunc_pr(sess, next_b, f_p)
    a_plus = add_public_raw(a, alpha_raw)
    b = spmd.trunc_pr(sess, spmd.mul(sess, b, a_plus), f_p)
    return SpmdFixed(b, max(i_p, y.integral_precision), f_p)


# ---------------------------------------------------------------------------
# Polynomial evaluation
# ---------------------------------------------------------------------------


def polynomial_eval(
    sess, coeffs: Sequence[float], x: SpmdFixed, min_coeff=None
) -> SpmdFixed:
    """Horner with public coefficients, sub-precision tail coefficients
    dropped to bound the degree.  The whole ladder runs in the
    ``horner`` kernel, which reads x's pair layout in place and writes
    the result's; its randomness (per step one zero-share bank and five
    truncation draws) is drawn here in the unfused ladder's order, one K7
    group."""
    f = x.fractional_precision
    t = x.tensor
    width = t.width
    eps = max(2.0 ** -(f + 1), min_coeff or 0.0)
    top = len(coeffs)
    while top > 1 and abs(coeffs[top - 1]) < eps:
        top -= 1
    raws = [encode_const(c, f, width) for c in reversed(list(coeffs[:top]))]
    steps = len(raws) - 1
    if steps == 0:
        return SpmdFixed(
            spmd.fill_public(t.shape, width, raws[0], t.lo.device),
            x.integral_precision, f,
        )
    # per step one zero-share bank and five truncation draws, one K7
    # group written straight into the (steps, 3, *shape) banks and the
    # (steps, 5, *shape) draws the kernel reads
    def words(lead):
        lo = torch.empty((steps, lead) + t.shape, dtype=torch.int64,
                         device=t.lo.device)
        return lo, None if width == 64 else torch.empty_like(lo)

    (zb_lo, zb_hi), (td_lo, td_hi) = words(3), words(5)
    n = math.prod(t.shape)

    def planes(lo, hi, at):
        return (lo, at), None if hi is None else (hi, at)

    specs = []
    for step in range(steps):
        specs.append(("bank", t.shape, width,
                      planes(zb_lo, zb_hi, 3 * n * step)))
        specs += [("sample", t.shape, width,
                   planes(td_lo, td_hi, n * (5 * step + d)))
                  for d in range(5)]
    sess.sample_group(specs)
    lo, hi = rk.horner_pairs((t.lo, t.hi), width, raws, f, (zb_lo, zb_hi),
                             (td_lo, td_hi))
    return SpmdFixed(SpmdRep(lo, hi, width), x.integral_precision, f)


# ---------------------------------------------------------------------------
# pow2 and the sigmoid
# ---------------------------------------------------------------------------


def pow2_from_bits(sess, bits: Sequence[SpmdRep], width: int) -> SpmdRep:
    """prod_i (b_i * 2^(2^i) + (1 - b_i)), balanced-tree product."""
    sels = []
    for i, bit in enumerate(bits):
        pos = spmd.shl(bit, 1 << i)
        neg_b = public_sub_raw(1, bit)
        sels.append(spmd.add(pos, neg_b))
    while len(sels) > 1:
        paired = [
            spmd.mul(sess, sels[j], sels[j + 1])
            for j in range(0, len(sels) - 1, 2)
        ]
        if len(sels) % 2:
            paired.append(sels[-1])
        sels = paired
    return sels[0]


def _pow2_positive(sess, x_abs: SpmdRep, i_p: int, f_p: int,
                   int_bound_bits: Optional[int] = None) -> SpmdRep:
    """2^x for a non-negative secret fixed-point value (raw shares at
    scale f): the integer bits select a product of powers, the fraction
    goes through the Taylor polynomial of 2^x."""
    k = i_p + f_p
    width = x_abs.width

    abs_bits = bit_decompose(sess, x_abs)
    bound = int_bound_bits if int_bound_bits is not None else i_p
    n_int = min(bound, width - f_p, max(1, (width - f_p).bit_length()))
    int_bits = _bit_slice(abs_bits, f_p, f_p + n_int)
    int_ring = b2a(sess, int_bits, width)
    higher = [spmd.index_axis(int_ring, 0, i) for i in range(n_int)]
    composed = weighted_bit_sum(
        int_ring, [1 << (f_p + i) for i in range(n_int)]
    )
    frac = spmd.sub(x_abs, composed)

    d = pow2_from_bits(sess, higher, width)

    amount = k - 2 - f_p
    frac_up = spmd.shl(frac, amount)
    frac_fixed = SpmdFixed(frac_up, 2, k - 2)
    e_approx = polynomial_eval(
        sess, P_1045, frac_fixed, min_coeff=2.0 ** -(f_p + 4)
    )
    e_prod = spmd.mul(sess, d, e_approx.tensor)
    return spmd.trunc_pr(sess, e_prod, amount)


def fx_sigmoid(sess, x: SpmdFixed) -> SpmdFixed:
    """Exact protocol sigmoid mux(x<0, 1, y) / (1 + y) with y = e^{|x|}
    — one Goldschmidt run in all."""
    i_p, f_p = x.integral_precision, x.fractional_precision
    width = x.tensor.width

    z = spmd.fx_mul_public(sess, x, math.log2(math.e))
    m_ring = b2a(sess, msb(sess, z.tensor), width)
    abs_z = mux_ring(sess, m_ring, spmd.neg(z.tensor), z.tensor)
    y = _pow2_positive(sess, abs_z, i_p, f_p)

    one_raw = spmd.fill_public(x.tensor.shape, width, 1 << f_p,
                               x.tensor.lo.device)
    num = mux_ring(sess, m_ring, one_raw, y)
    den = add_public_raw(y, 1 << f_p)
    return fx_div(
        sess,
        SpmdFixed(num, i_p, f_p),
        SpmdFixed(den, i_p, f_p),
        positive_divisor=True,
    )
