"""The nonlinear protocol library in the party-stacked layout.

PyTorch counterpart of ``moose_tpu/parallel/spmd_math.py``: replicated
bit sharings, bit decomposition through a Kogge-Stone adder,
bit-to-arithmetic conversion, comparisons (``less``, ``greater``,
``equal_bit``), selection, Goldschmidt division, the fixed-point Horner
polynomial, 2^x and e^x, log2/log/sqrt, the sigmoid, and the tournament
max/argmax and the softmax over an axis, and the average and max
pools.

A replicated bit sharing is one ``torch.uint8`` tensor
``(party=3, slot=2, [bits=k,] *shape)`` of 0/1 with XOR share semantics,
the JAX package's layout.  Randomness is drawn from the
:class:`~moose_tpu_torch.parallel.spmd.SpmdSession` in the JAX package's
order; the kernels (``bit_decompose``/``msb``, ``horner``) take their
randomness pre-drawn, and AND banks that the reference draws back to back
with nothing drawn in between (an adder's, an OR tree's) come as one K7
group, so shares stay bit-identical to the JAX package's under the same
master key and PRF.

The tournaments compare array halves along the reduction axis: every
round is one comparison over the whole remaining tensor.  The halves are
strided views; the kernels that read operands in place (K2, K3, K6) walk
their strides, and the others' callers make their operands contiguous.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from ..dialects import ring
from ..dialects.fixedpoint import P_1045, P_2524, Q_2524, encode_const
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


def share_bits(sess: SpmdSession, b: torch.Tensor) -> SpmdBits:
    """XOR-share a plaintext 0/1 tensor: b_0, b_1 from one bit bank,
    b_2 = b ^ b_0 ^ b_1."""
    bank = sess.sample_bit_bank(tuple(b.shape))
    b2 = b.to(U8) ^ bank[0] ^ bank[1]
    z = torch.stack([bank[0], bank[1], b2])
    return SpmdBits(torch.stack([z, _roll(z)], dim=1))


def reveal_bits(x: SpmdBits) -> torch.Tensor:
    return x.arr[0, 0] ^ x.arr[1, 0] ^ x.arr[2, 0]


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


def _kogge_stone_bank_count(k: int) -> int:
    """The ANDs of a k-bit Kogge-Stone adder: g = x AND y, then per
    round the g update and, while 2d < k, the p_run update."""
    n, d = 1, 1
    while d < k:
        n += 2 if d * 2 < k else 1
        d *= 2
    return n


def kogge_stone(sess, x: SpmdBits, y: SpmdBits, k: int) -> SpmdBits:
    """Carry-lookahead adder on bit shares, log2(k) rounds of two ANDs
    over the whole tensor; its AND banks (all of x's shape) are one K7
    group, drawn in the order the rounds consume them."""
    banks = sess.sample_group(
        [("bit_bank", tuple(x.arr.shape[2:]), None)]
        * _kogge_stone_bank_count(k)
    )
    return _kogge_stone_banks(x, y, k, functools.partial(next, iter(banks)))


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


def bit_compose(sess, bits: SpmdBits, width: int) -> SpmdRep:
    """Binary -> arithmetic sharing of a k-bit decomposition:
    sum_i b2a(bits)[i] * 2^i."""
    ring_bits = b2a(sess, bits, width)
    return weighted_bit_sum(ring_bits, [1 << i for i in range(width)])


def msb(sess: SpmdSession, x: SpmdRep) -> SpmdBits:
    """The top bit of the decomposition, from the same kernel writing
    only that bit (comparisons need nothing else)."""
    banks = _draw_adder_banks(sess, x)
    return SpmdBits(rk.msb(*_words(x), x.width, banks))


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def less(sess, x: SpmdRep, y: SpmdRep) -> SpmdBits:
    """x < y as msb(x - y) (two's complement; valid for |x - y| <
    2^(k-1))."""
    return msb(sess, spmd.sub(x, y))


def greater(sess, x: SpmdRep, y: SpmdRep) -> SpmdBits:
    return less(sess, y, x)


def equal_zero_bit(sess, x: SpmdRep) -> SpmdBits:
    """1 iff x == 0: NOT of the OR tree over x's bits, log2(k) rounds of
    one AND each.  Nothing is drawn between the rounds, so their banks
    (one a round, of the halves' shape) are one K7 group drawn after the
    decomposition's."""
    bits = bit_decompose(sess, x)
    halves = []
    k = x.width
    while k > 1:
        halves.append(k // 2)
        k = k // 2 + k % 2
    banks = sess.sample_group(
        [("bit_bank", (half,) + tuple(x.shape), None) for half in halves]
    )
    k = x.width
    for half, bank in zip(halves, banks):
        a = _bit_slice(bits, 0, half)
        b = _bit_slice(bits, half, 2 * half)
        merged = bits_xor(bits_xor(a, b), _bits_and_bank(a, b, bank))
        if k % 2:
            merged = SpmdBits(
                torch.cat([merged.arr, bits.arr[:, :, k - 1:k]], dim=2))
        k = half + k % 2
        bits = merged
    return bits_not(SpmdBits(bits.arr[:, :, 0]))


def equal_bit(sess, x: SpmdRep, y: SpmdRep) -> SpmdBits:
    return equal_zero_bit(sess, spmd.sub(x, y))


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


def mul_public_raw(x: SpmdRep, raw: int) -> SpmdRep:
    return spmd.mul_public(x, *_const(x, raw))


def fx_add_public_raw(x: SpmdFixed, raw: int) -> SpmdFixed:
    return SpmdFixed(add_public_raw(x.tensor, raw), x.integral_precision,
                     x.fractional_precision)


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


def fx_pow2(sess, x: SpmdFixed, lower_bounded: bool = False) -> SpmdFixed:
    """2^x for either sign through the shifted positive-only form
    2^x = 2^(x + f) >> f; unless ``lower_bounded``, x is first clamped
    from below at -f (where 2^x is below one LSB)."""
    i_p = x.integral_precision
    f_p = x.fractional_precision
    k = i_p + f_p
    width = x.tensor.width
    t = x.tensor
    if not lower_bounded:
        floor_raw = encode_const(-float(f_p), f_p, width)
        floor_t = spmd.fill_public(t.shape, width, floor_raw, t.lo.device)
        under = greater(sess, floor_t, t)
        t = mux_bit(sess, under, floor_t, t)
    shifted = add_public_raw(t, encode_const(float(f_p), f_p, width))
    g = _pow2_positive(
        sess, shifted, i_p, f_p, int_bound_bits=max(1, k.bit_length())
    )
    return SpmdFixed(spmd.trunc_pr(sess, g, f_p), i_p, f_p)


def fx_exp(sess, x: SpmdFixed, lower_bounded: bool = False) -> SpmdFixed:
    scaled = spmd.fx_mul_public(sess, x, math.log2(math.e))
    return fx_pow2(sess, scaled, lower_bounded=lower_bounded)


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


# ---------------------------------------------------------------------------
# log2, log and sqrt
# ---------------------------------------------------------------------------


def int2fl(sess, x: SpmdRep, max_bit_len: int, frac: int):
    """Normalize a secret integer to (v, p, s, z) with
    (1 - 2s)(1 - z) * v * 2^p = x: s its sign, z whether it is 0, v its
    magnitude upshifted to max_bit_len - 1 bits and truncated to scale
    ``frac``, p its bit length less ``frac``.  The reversed bit order of
    the prefix OR is ``torch.flip``."""
    width = x.width
    lam = max_bit_len - 1

    s_ring = b2a(sess, msb(sess, x), width)
    z_ring = b2a(sess, equal_zero_bit(sess, x), width)

    x_pos = mux_ring(sess, s_ring, spmd.neg(x), x)
    pos_bits = bit_decompose(sess, x_pos)
    rev = SpmdBits(torch.flip(pos_bits.arr[:, :, :lam], dims=(2,)))
    b = prefix_or(sess, rev, lam)
    b_ring = b2a(sess, b, width)

    bit_count = weighted_bit_sum(b_ring, [1] * lam)
    b_weighted = weighted_bit_sum(b_ring, [1 << i for i in range(lam)])
    neg_b_sum = public_sub_raw((1 << lam) - 1, b_weighted)

    one_plus = add_public_raw(neg_b_sum, 1)
    x_up = spmd.mul(sess, x_pos, one_plus)
    v = spmd.trunc_pr(sess, x_up, max_bit_len - 1 - frac)

    p_minus_f = add_public_raw(bit_count, (-frac) % (1 << width))
    one_minus_z = public_sub_raw(1, z_ring)
    p = spmd.mul(sess, p_minus_f, one_minus_z)
    return v, p, s_ring, z_ring


def fx_log2(sess, x: SpmdFixed) -> SpmdFixed:
    """log2 x = p + P_2524(v) / Q_2524(v) for x = v * 2^p, v in
    [0.5, 1)."""
    i_p, f_p = x.integral_precision, x.fractional_precision
    v, p, _s, _z = int2fl(sess, x.tensor, i_p + f_p, f_p)
    v_fixed = SpmdFixed(v, i_p, f_p)
    num = polynomial_eval(sess, P_2524, v_fixed)
    den = polynomial_eval(sess, Q_2524, v_fixed)
    quot = fx_div(sess, num, den)
    p_fixed = SpmdFixed(spmd.shl(p, f_p), i_p, f_p)
    return spmd.fx_add(p_fixed, quot)


def fx_log(sess, x: SpmdFixed) -> SpmdFixed:
    return spmd.fx_mul_public(sess, fx_log2(sess, x), math.log(2.0))


def fx_sqrt(sess, x: SpmdFixed) -> SpmdFixed:
    """sqrt(x) = 2^(0.5 * log2(x))."""
    half = spmd.fx_mul_public(sess, fx_log2(sess, x), 0.5)
    return fx_pow2(sess, half)


# ---------------------------------------------------------------------------
# Maximum, argmax and softmax: tournaments over array halves along the
# reduction axis, one comparison a round over the whole remaining tensor
# ---------------------------------------------------------------------------


def _slice_axis(x: SpmdRep, axis: int, sl: slice) -> SpmdRep:
    """A view of x sliced along a logical axis (a positive step)."""
    idx = (slice(None),) * spmd._laxis(x.lo, axis) + (sl,)
    return SpmdRep(x.lo[idx], None if x.hi is None else x.hi[idx], x.width)


def max_axis(sess, x: SpmdRep, axis: int) -> SpmdRep:
    """Tournament max along a logical axis, which is reduced away."""
    n = x.shape[axis]
    while n > 1:
        m = n // 2
        a = _slice_axis(x, axis, slice(0, 2 * m, 2))
        b = _slice_axis(x, axis, slice(1, 2 * m, 2))
        lt = less(sess, a, b)
        mx = mux_bit(sess, lt, b, a)
        if n % 2:
            x = spmd.concat([mx, _slice_axis(x, axis, slice(n - 1, n))],
                            axis)
            n = m + 1
        else:
            x = mx
            n = m
    return spmd.index_axis(x, axis, 0)


def fx_max(sess, x: SpmdFixed, axis: int) -> SpmdFixed:
    return SpmdFixed(max_axis(sess, x.tensor, axis), x.integral_precision,
                     x.fractional_precision)


def fx_maximum(sess, xs: Sequence[SpmdFixed]) -> SpmdFixed:
    """Elementwise maximum of several tensors of one shape."""
    stacked = spmd.stack([x.tensor for x in xs], axis=0)
    return SpmdFixed(max_axis(sess, stacked, 0), xs[0].integral_precision,
                     xs[0].fractional_precision)


def argmax_axis(sess, x: SpmdRep, axis: int) -> SpmdRep:
    """Tournament argmax over (value, index) pairs; the indices start as
    a public iota (a trivial sharing, high word 0 at ring128) carried
    through the muxes."""
    width = x.width
    nd = len(x.shape)
    axis %= nd
    n = x.shape[axis]
    iota = torch.arange(n, dtype=torch.int64, device=x.lo.device)
    iota = iota.reshape((1,) * axis + (n,) + (1,) * (nd - 1 - axis))
    iota = iota.expand(x.shape)
    idx = spmd.public_to_rep(
        iota, torch.zeros_like(iota) if width == 128 else None, width
    )
    while n > 1:
        m = n // 2
        av = _slice_axis(x, axis, slice(0, 2 * m, 2))
        bv = _slice_axis(x, axis, slice(1, 2 * m, 2))
        ai = _slice_axis(idx, axis, slice(0, 2 * m, 2))
        bi = _slice_axis(idx, axis, slice(1, 2 * m, 2))
        s = b2a(sess, less(sess, av, bv), width)
        nv = mux_ring(sess, s, bv, av)
        ni = mux_ring(sess, s, bi, ai)
        if n % 2:
            x = spmd.concat([nv, _slice_axis(x, axis, slice(n - 1, n))],
                            axis)
            idx = spmd.concat(
                [ni, _slice_axis(idx, axis, slice(n - 1, n))], axis
            )
            n = m + 1
        else:
            x, idx = nv, ni
            n = m
    return spmd.index_axis(idx, axis, 0)


def fx_argmax(sess, x: SpmdFixed, axis: int,
              upmost_index: Optional[int] = None) -> SpmdRep:
    """Argmax over the first ``upmost_index`` entries of ``axis`` (the
    whole axis when None or larger); slicing keeps the indices."""
    t = x.tensor
    if upmost_index is not None and upmost_index < t.shape[axis]:
        t = _slice_axis(t, axis, slice(0, upmost_index))
    return argmax_axis(sess, t, axis)


def fx_softmax(sess, x: SpmdFixed, axis: int,
               upmost_index: Optional[int] = None) -> SpmdFixed:
    """Softmax without overflow: subtract the max (over the first
    ``upmost_index`` entries of ``axis``), clamp from below where e^x
    falls under one LSB, exp on the bounded path, zero the clamped
    entries, and normalise by one Goldschmidt division."""
    i_p, f_p = x.integral_precision, x.fractional_precision
    width = x.tensor.width
    device = x.tensor.lo.device

    xmax_src = x.tensor
    if upmost_index is not None and upmost_index < xmax_src.shape[axis]:
        xmax_src = _slice_axis(xmax_src, axis, slice(0, upmost_index))
    xmax = spmd.expand_dims(max_axis(sess, xmax_src, axis), axis)
    diff = spmd.sub(x.tensor, xmax)

    min_val = -1.0 * math.log(2.0) * min(i_p - 1, f_p - 1)
    lower = spmd.fill_public(diff.shape, width,
                             encode_const(min_val, f_p, width), device)
    gt = greater(sess, lower, diff)
    clamped = SpmdFixed(mux_bit(sess, gt, lower, diff), i_p, f_p)
    e_x = fx_exp(sess, clamped, lower_bounded=True)

    zeros = spmd.fill_public(e_x.tensor.shape, width, 0, device)
    normalized = SpmdFixed(mux_bit(sess, gt, zeros, e_x.tensor), i_p, f_p)
    total = spmd.expand_dims(spmd.sum_axis(normalized.tensor, axis), axis)
    return fx_div(sess, normalized, SpmdFixed(total, i_p, f_p),
                  positive_divisor=True)


# ---------------------------------------------------------------------------
# Pooling (stacked forms of fixedpoint.{avg,max}_pool2d)
# ---------------------------------------------------------------------------


def _pool_patches(x: SpmdFixed, pool, strides, padding):
    ph, pw = pool
    strides = tuple(strides) if strides is not None else (ph, pw)
    patches = spmd.im2col(x.tensor, ph, pw, strides, padding)
    # (N, OH, OW, taps*C) with the window laid out [tap0 C..., tap1 C...]
    taps = ph * pw
    shp = patches.shape
    c = shp[-1] // taps
    return spmd.reshape(patches, shp[:3] + (taps, c)), taps


def fx_avg_pool2d(sess, x: SpmdFixed, pool, strides=None,
                  padding="VALID") -> SpmdFixed:
    """Average pooling: share-local window sum (im2col + tap-axis sum,
    no interaction) then one public 1/n multiply + truncation."""
    patches, taps = _pool_patches(x, pool, strides, padding)
    summed = spmd.sum_axis(patches, 3)
    return spmd.fx_mul_public(
        sess,
        SpmdFixed(summed, x.integral_precision, x.fractional_precision),
        1.0 / taps,
    )


def fx_max_pool2d(sess, x: SpmdFixed, pool, strides=None,
                  padding="VALID") -> SpmdFixed:
    """Max pooling: tournament max over the window taps (log2(taps)
    comparison rounds over the whole tensor, along the taps axis of the
    (N, OH, OW, taps, C) patches).  Padding policy shared with the
    per-host dialect (ring.check_maxpool_padding)."""
    ph, pw = pool
    h, w = x.tensor.shape[1:3]
    strides = tuple(strides) if strides is not None else (ph, pw)
    ring.check_maxpool_padding(padding, h, w, ph, pw, *strides)
    patches, taps = _pool_patches(x, pool, strides, padding)
    t = max_axis(sess, patches, 3)
    return SpmdFixed(t, x.integral_precision, x.fractional_precision)
