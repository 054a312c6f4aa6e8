"""Fixed-point dialect: secure fixed-point arithmetic and the math
library on replicated tensors, one host tensor per share.

The port of ``moose_tpu/dialects/fixedpoint.py`` (``moose/src/fixedpoint/``
and the math protocols of
``moose/src/replicated/{division,exp,log,softmax,argmax,sqrt}.rs``),
word for word the JAX package's compositions:

- mul/dot = ring op + probabilistic truncation by f
- division: Goldschmidt iteration seeded by a normalized approximate
  reciprocal (division.rs:20-248)
- pow2/exp: 2^int via bit-selected products, 2^frac via the Taylor series
  of 2^x (P_1045 coefficients, exp.rs:160-215), negative exponents via a
  shifted exponent
- log2/log: int2fl normalization + Pade approximant P_2524/Q_2524
  (log.rs:9-66,112-220)
- sqrt = 2^(log2(x)/2) (sqrt.rs)
- maximum/argmax: tournament tree of less+mux (softmax.rs:10-54, argmax.rs)
- softmax: max-subtract, exp, threshold mux, normalize (softmax.rs:56-130)

All constants are public; only secret-dependent work uses MPC rounds.
``encode_const``, ``P_1045`` and ``P_2524``/``Q_2524`` also serve the
party-stacked protocols (``parallel/spmd_math.py``).
"""

from __future__ import annotations

import functools as _functools
import math
from typing import Optional, Sequence

from ..values import HostShape, RepFixedTensor, RepTensor
from . import replicated as rep_ops


# ---------------------------------------------------------------------------
# Helpers: public constants against replicated tensors
# ---------------------------------------------------------------------------


def _shape_of(sess, rep, x: RepTensor):
    return sess.shape(rep.owners[0], x.shares[0][0])


def _width_of(x: RepTensor) -> int:
    return x.shares[0][0].width


def fill_public(sess, rep, like: RepTensor, raw_value: int) -> RepTensor:
    """Trivial replicated sharing of a public ring constant."""
    shp = _shape_of(sess, rep, like)
    return rep_ops.fill(sess, rep, shp, raw_value, _width_of(like))


@_functools.lru_cache(maxsize=None)
def encode_const(value: float, frac: int, width: int) -> int:
    """Encode a float into the ring as a two's-complement fixed-point raw
    integer (the `as_fixedpoint` helper of the reference), rounded half
    to even; memoized."""
    raw = int(round(value * (2 ** frac)))
    return raw % (1 << width)


def add_public_raw(sess, rep, x: RepTensor, raw: int) -> RepTensor:
    shp = _shape_of(sess, rep, x)
    width = _width_of(x)
    ty = f"HostRing{width}Tensor"
    c0 = sess.fill(rep.owners[0], shp, raw, ty)
    c2 = sess.fill(rep.owners[2], shp, raw, ty)
    return rep_ops.add_public(sess, rep, x, c0, c2)


def public_sub_raw(sess, rep, raw: int, x: RepTensor) -> RepTensor:
    return add_public_raw(sess, rep, rep_ops.neg(sess, rep, x), raw)


def mul_public_raw(sess, rep, x: RepTensor, raw: int) -> RepTensor:
    shp = _shape_of(sess, rep, x)
    width = _width_of(x)
    ty = f"HostRing{width}Tensor"
    cs = [sess.fill(rep.owners[i], shp, raw, ty) for i in range(3)]
    return rep_ops.mul_public(sess, rep, x, cs)


def sign_from_msb(sess, rep, msb_ring: RepTensor) -> RepTensor:
    """(-1)^msb = 1 - 2*msb (division.rs:95-104)."""
    double = rep_ops.shl(sess, rep, msb_ring, 1)
    return public_sub_raw(sess, rep, 1, double)


# ---------------------------------------------------------------------------
# Fixed-level arithmetic
# ---------------------------------------------------------------------------


def _assert_same_precision(x, y):
    if x.fractional_precision != y.fractional_precision:
        from ..errors import TypeMismatchError

        raise TypeMismatchError(
            "fixed-point operands disagree on fractional precision: "
            f"{x.fractional_precision} vs {y.fractional_precision}"
        )


def add(sess, rep, x: RepFixedTensor, y: RepFixedTensor) -> RepFixedTensor:
    _assert_same_precision(x, y)
    return RepFixedTensor(
        rep_ops.add(sess, rep, x.tensor, y.tensor),
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def sub(sess, rep, x: RepFixedTensor, y: RepFixedTensor) -> RepFixedTensor:
    _assert_same_precision(x, y)
    return RepFixedTensor(
        rep_ops.sub(sess, rep, x.tensor, y.tensor),
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def neg(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    return RepFixedTensor(
        rep_ops.neg(sess, rep, x.tensor),
        x.integral_precision,
        x.fractional_precision,
    )


def trunc(sess, rep, x: RepFixedTensor, amount: Optional[int] = None) -> RepFixedTensor:
    amount = x.fractional_precision if amount is None else amount
    return RepFixedTensor(
        rep_ops.trunc_pr(sess, rep, x.tensor, amount),
        x.integral_precision,
        x.fractional_precision,
    )


def mul(sess, rep, x: RepFixedTensor, y: RepFixedTensor) -> RepFixedTensor:
    _assert_same_precision(x, y)
    z = rep_ops.mul(sess, rep, x.tensor, y.tensor)
    z = rep_ops.trunc_pr(sess, rep, z, x.fractional_precision)
    return RepFixedTensor(
        z,
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def dot(sess, rep, x: RepFixedTensor, y: RepFixedTensor) -> RepFixedTensor:
    _assert_same_precision(x, y)
    z = rep_ops.dot(sess, rep, x.tensor, y.tensor)
    z = rep_ops.trunc_pr(sess, rep, z, x.fractional_precision)
    return RepFixedTensor(
        z,
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def sum_(sess, rep, x: RepFixedTensor, axis) -> RepFixedTensor:
    return RepFixedTensor(
        rep_ops.sum_(sess, rep, x.tensor, axis),
        x.integral_precision,
        x.fractional_precision,
    )


def conv2d(sess, rep, x: RepFixedTensor, k: RepFixedTensor,
           strides=(1, 1), padding="VALID") -> RepFixedTensor:
    """Secure fixed-point convolution: one multiplication depth, so a
    single TruncPr after the ring conv (same scale discipline as dot)."""
    _assert_same_precision(x, k)
    z = rep_ops.conv2d(sess, rep, x.tensor, k.tensor, strides, padding)
    z = rep_ops.trunc_pr(sess, rep, z, x.fractional_precision)
    return RepFixedTensor(
        z,
        max(x.integral_precision, k.integral_precision),
        x.fractional_precision,
    )


def avg_pool2d(sess, rep, x: RepFixedTensor, pool, strides=None,
               padding="VALID") -> RepFixedTensor:
    """Average pooling: share-local window sum (im2col + sum over the
    patch axis, no interaction) then one public 1/n multiply + TruncPr."""
    ph, pw = pool
    strides = tuple(strides) if strides is not None else (ph, pw)
    n, h, w, c = x.tensor.shares[0][0].shape
    patches = rep_ops.im2col(sess, rep, x.tensor, ph, pw, strides, padding)
    # patches: (N, OH, OW, ph*pw*C) with the window laid out as
    # [tap0 C..., tap1 C...]; reshape to (N, OH, OW, taps, C), sum taps
    taps = ph * pw
    shp = patches.shares[0][0].shape
    patches = rep_ops.reshape(
        sess, rep, patches,
        HostShape(shp[:3] + (taps, c), rep.owners[0]),
    )
    s = rep_ops.sum_(sess, rep, patches, 3)
    factor = encode_const(
        1.0 / taps, x.fractional_precision, _width_of(x.tensor)
    )
    z = mul_public_raw(sess, rep, s, factor)
    z = rep_ops.trunc_pr(sess, rep, z, x.fractional_precision)
    return RepFixedTensor(z, x.integral_precision, x.fractional_precision)


def max_pool2d(sess, rep, x: RepFixedTensor, pool, strides=None,
               padding="VALID") -> RepFixedTensor:
    """Max pooling: tournament max over the window taps (log2(taps)
    rounds of secure compare+mux; expensive — ResNet uses it once)."""
    ph, pw = pool
    strides = tuple(strides) if strides is not None else (ph, pw)
    _n, h, w, c = x.tensor.shares[0][0].shape
    from . import ring as _ring

    _ring.check_maxpool_padding(padding, h, w, ph, pw, *strides)
    patches = rep_ops.im2col(sess, rep, x.tensor, ph, pw, strides, padding)
    taps = ph * pw
    shp = patches.shares[0][0].shape
    patches = rep_ops.reshape(
        sess, rep, patches, HostShape(shp[:3] + (taps, c), rep.owners[0])
    )
    lanes = [
        rep_ops.index_axis(sess, rep, patches, 3, i) for i in range(taps)
    ]
    t = maximum_ring(sess, rep, lanes)
    return RepFixedTensor(
        t, x.integral_precision, x.fractional_precision
    )


def mean(sess, rep, x: RepFixedTensor, axis) -> RepFixedTensor:
    """Fixed-point mean: sum * encode(1/n) then trunc."""
    s = rep_ops.sum_(sess, rep, x.tensor, axis)
    shp = x.tensor.shares[0][0].shape
    import numpy as np

    n = shp[axis] if axis is not None else int(np.prod(shp))
    factor = encode_const(1.0 / n, x.fractional_precision, _width_of(x.tensor))
    z = mul_public_raw(sess, rep, s, factor)
    z = rep_ops.trunc_pr(sess, rep, z, x.fractional_precision)
    return RepFixedTensor(z, x.integral_precision, x.fractional_precision)


def mul_public_float(sess, rep, x: RepFixedTensor, value: float) -> RepFixedTensor:
    raw = encode_const(value, x.fractional_precision, _width_of(x.tensor))
    z = mul_public_raw(sess, rep, x.tensor, raw)
    z = rep_ops.trunc_pr(sess, rep, z, x.fractional_precision)
    return RepFixedTensor(z, x.integral_precision, x.fractional_precision)


def add_public_float(sess, rep, x: RepFixedTensor, value: float) -> RepFixedTensor:
    raw = encode_const(value, x.fractional_precision, _width_of(x.tensor))
    return RepFixedTensor(
        add_public_raw(sess, rep, x.tensor, raw),
        x.integral_precision,
        x.fractional_precision,
    )


# ---------------------------------------------------------------------------
# Polynomial evaluation with public coefficients (fixedpoint/mod.rs:95-140)
# ---------------------------------------------------------------------------


def polynomial_eval(
    sess, rep, coeffs: Sequence[float], x: RepFixedTensor, min_coeff=None
) -> RepFixedTensor:
    """Horner evaluation; coefficients below the representable precision
    (or the caller's accuracy target ``min_coeff``) are dropped, as the
    reference does, to bound the degree."""
    f = x.fractional_precision
    eps = max(2.0 ** -(f + 1), min_coeff or 0.0)
    top = len(coeffs)
    while top > 1 and abs(coeffs[top - 1]) < eps:
        top -= 1
    cs = list(coeffs[:top])
    acc = None
    for c in reversed(cs):
        if acc is None:
            shp = _shape_of(sess, rep, x.tensor)
            raw = encode_const(c, f, _width_of(x.tensor))
            acc = RepFixedTensor(
                rep_ops.fill(sess, rep, shp, raw, _width_of(x.tensor)),
                x.integral_precision,
                f,
            )
        else:
            acc = add_public_float(sess, rep, mul(sess, rep, acc, x), c)
    return acc


# ---------------------------------------------------------------------------
# Normalization: top-most-bit detection (division.rs:107-248)
# ---------------------------------------------------------------------------


def prefix_or_bits(sess, rep, bits: RepTensor, n: int) -> RepTensor:
    """In-place prefix OR along the leading bit axis: out[i] = OR(x[0..=i]);
    log2(n) rounds (replicated/misc.rs:30)."""
    d = 1
    while d < n:
        shifted = rep_ops.shl_dim(sess, rep, bits, d, n)
        bits = rep_ops.or_bits(sess, rep, bits, shifted)
        d *= 2
    return bits


def top_most_index(sess, rep, x: RepTensor, max_bits: int) -> RepTensor:
    """2^(max_bits - 1 - t) where t is the index of the top set bit of x
    (division.rs:142-226): one-hot the top bit via reversed prefix-OR
    differences, then compose with shifted injections."""
    width = _width_of(x)
    bits = rep_ops.bit_decompose(sess, rep, x)
    low = rep_ops.slice_axis0(sess, rep, bits, 0, max_bits)
    # reverse the bit axis so prefix-OR runs from the top bit down
    rev = rep_ops._map_shares(
        sess,
        rep,
        lambda plc, a: sess.strided_slice(plc, a, (slice(None, None, -1),)),
        low,
    )
    y = prefix_or_bits(sess, rep, rev, max_bits)
    # z[i] = y[i] XOR y[i-1] one-hots the first 1 in reversed order:
    # reversed index i corresponds to original bit index max_bits-1-i, whose
    # contribution is << (max_bits-1-(max_bits-1-i)) = << i.
    y_prev = rep_ops.shl_dim(sess, rep, y, 1, max_bits)
    z = rep_ops.xor(sess, rep, y, y_prev)
    z_ring = rep_ops.b2a_bits(sess, rep, z, width)
    weights = [1 << i for i in range(max_bits)]
    return rep_ops.weighted_bit_sum(sess, rep, z_ring, weights, width)


def norm(sess, rep, x: RepTensor, max_bits: int, positive: bool = False):
    """(|x| upshifted to put its top bit at max_bits-1, signed scale factor)
    (division.rs:107-139).  ``positive=True`` skips the msb/sign round
    entirely — a caller that KNOWS x > 0 (softmax's sum of positive
    exponentials, sigmoid's 1 + e^x) saves a full secure comparison.

    Deviation from the reference (documented, deliberate): division.rs
    returns ``upshifted = x * top`` — the SIGNED value — which makes the
    Goldschmidt seed ``2.9142 - 2*upshifted`` ~2x too large in magnitude
    for negative x (|1 - x*w| ~ 0.96, far outside the seed bound the
    theta iteration count assumes; the reference's own tests never
    exercise a negative divisor, division.rs:258-323).  We return the
    ABSOLUTE upshifted value — abs_x is already computed, so the cost is
    identical — and carry the sign exclusively in signed_top."""
    if positive:
        top = top_most_index(sess, rep, x, max_bits)
        upshifted = rep_ops.mul(sess, rep, x, top)
        return upshifted, top
    m = rep_ops.msb(sess, rep, x)
    m_ring = rep_ops.b2a(sess, rep, m, _width_of(x))
    sign = sign_from_msb(sess, rep, m_ring)
    abs_x = rep_ops.mul(sess, rep, sign, x)
    top = top_most_index(sess, rep, abs_x, max_bits)
    upshifted = rep_ops.mul(sess, rep, abs_x, top)
    signed_top = rep_ops.mul(sess, rep, sign, top)
    return upshifted, signed_top


def approximate_reciprocal(
    sess, rep, x: RepTensor, int_precision: int, frac_precision: int,
    positive: bool = False,
) -> RepTensor:
    """Initial w ~ 1/x for Goldschmidt (division.rs:200-248):
    w = (2.9142 - 2*norm(x)) * signed_topmost, truncated by 2*int."""
    total = int_precision + frac_precision
    upshifted, signed_top = norm(sess, rep, x, total, positive=positive)
    alpha_raw = encode_const(2.9142, total, _width_of(x))
    d = public_sub_raw(
        sess, rep, alpha_raw, rep_ops.shl(sess, rep, upshifted, 1)
    )
    w = rep_ops.mul(sess, rep, d, signed_top)
    return rep_ops.trunc_pr(sess, rep, w, 2 * int_precision)


def div(sess, rep, x: RepFixedTensor, y: RepFixedTensor,
        positive_divisor: bool = False) -> RepFixedTensor:
    """Goldschmidt division (division.rs:20-98), with a rescale-early
    refinement: the reference keeps the residual ``a`` at scale 2f, so the
    ``a*a`` step needs 4f raw bits and silently wraps for f=40 on ring128
    (stalling convergence at the first iteration); we truncate ``a`` to
    scale f each round, which bounds every product by 2f bits — the same
    bound every fixed-point multiply already has — at the cost of ~2^-f
    quantization noise per round."""
    _assert_same_precision(x, y)
    i_p = x.integral_precision
    f_p = x.fractional_precision
    k = i_p + f_p
    width = _width_of(x.tensor)
    if 2 * k > width:
        from ..errors import KernelError

        raise KernelError(
            f"division requires 2*(i+f) <= ring width, got 2*{k} > {width}"
        )
    theta = max(1, math.ceil(math.log2(k / math.log2(17.0))))

    w = approximate_reciprocal(
        sess, rep, y.tensor, i_p, f_p, positive=positive_divisor
    )
    alpha_raw = encode_const(1.0, f_p, width)

    init_prod = rep_ops.trunc_pr(
        sess, rep, rep_ops.mul(sess, rep, y.tensor, w), f_p
    )
    a = public_sub_raw(sess, rep, alpha_raw, init_prod)
    b = rep_ops.mul(sess, rep, x.tensor, w)
    b = rep_ops.trunc_pr(sess, rep, b, f_p)

    for _ in range(theta):
        a_plus = add_public_raw(sess, rep, a, alpha_raw)
        next_b = rep_ops.mul(sess, rep, b, a_plus)
        next_a = rep_ops.mul(sess, rep, a, a)
        a = rep_ops.trunc_pr(sess, rep, next_a, f_p)
        b = rep_ops.trunc_pr(sess, rep, next_b, f_p)
    a_plus = add_public_raw(sess, rep, a, alpha_raw)
    b = rep_ops.mul(sess, rep, b, a_plus)
    b = rep_ops.trunc_pr(sess, rep, b, f_p)
    return RepFixedTensor(b, max(i_p, y.integral_precision), f_p)


# ---------------------------------------------------------------------------
# pow2 / exp (exp.rs)
# ---------------------------------------------------------------------------

# Taylor coefficients of 2^x = sum (ln2)^i / i! * x^i (P_1045, exp.rs:160).
P_1045 = [math.log(2.0) ** i / math.factorial(i) for i in range(100)]


def pow2_from_bits(sess, rep, bits: Sequence[RepTensor], width: int) -> RepTensor:
    """prod_i (b_i * 2^(2^i) + (1 - b_i)) (exp.rs:119-157); bits are
    arithmetic ring shares of the integer exponent's bits.  The product is
    reduced as a balanced tree (depth log2(n)) rather than a left fold —
    same multiplication count, fewer protocol rounds."""
    sels = []
    for i, bit in enumerate(bits):
        pos = rep_ops.shl(sess, rep, bit, 1 << i)
        neg_b = public_sub_raw(sess, rep, 1, bit)
        sels.append(rep_ops.add(sess, rep, pos, neg_b))
    while len(sels) > 1:
        paired = []
        for j in range(0, len(sels) - 1, 2):
            paired.append(rep_ops.mul(sess, rep, sels[j], sels[j + 1]))
        if len(sels) % 2:
            paired.append(sels[-1])
        sels = paired
    return sels[0]


def _pow2_positive(sess, rep, x_abs: RepTensor, i_p: int, f_p: int,
                   int_bound_bits: Optional[int] = None) -> RepTensor:
    """2^x for a NON-NEGATIVE secret fixed-point value (raw ring shares at
    scale f).  The sign/reciprocal handling of ``pow2`` is factored out so
    callers that already know the sign (sigmoid, and pow2's own shifted
    form) can skip it.  ``int_bound_bits`` bounds the bit-length of the
    integer part when the caller knows it exceeds i_p (the shifted-pow2
    input reaches i_p + f_p)."""
    k = i_p + f_p
    width = _width_of(x_abs)

    abs_bits = rep_ops.bit_decompose(sess, rep, x_abs)
    # Integer-exponent bits: any exponent e >= width - f overflows the ring
    # (2^e at scale f needs e + f < width), so bits above
    # bit_length(width - f) select only overflowed values — skipping them
    # changes nothing for in-range inputs and cuts the multiply chain from
    # i_p (e.g. 24) to ~log2(width) (7) selects.
    bound = int_bound_bits if int_bound_bits is not None else i_p
    n_int = min(bound, width - f_p, max(1, (width - f_p).bit_length()))
    int_bits = rep_ops.slice_axis0(sess, rep, abs_bits, f_p, f_p + n_int)
    int_ring = rep_ops.b2a_bits(sess, rep, int_bits, width)
    higher = [
        rep_ops.index_axis(sess, rep, int_ring, 0, i) for i in range(n_int)
    ]
    # compose the integer part back to subtract it out
    composed = rep_ops.weighted_bit_sum(
        sess, rep, int_ring, [1 << (f_p + i) for i in range(n_int)], width
    )
    frac = rep_ops.sub(sess, rep, x_abs, composed)

    d = pow2_from_bits(sess, rep, higher, width)

    # exp_from_parts (exp.rs:177-215): evaluate 2^frac via the series at
    # precision k-2, multiply by 2^int, truncate back to f.  The series
    # only needs to resolve the OUTPUT precision f (plus slack), not the
    # k-2 working precision, so the degree is capped accordingly.
    amount = k - 2 - f_p
    frac_up = rep_ops.shl(sess, rep, frac, amount)
    frac_fixed = RepFixedTensor(frac_up, 2, k - 2)
    e_approx = polynomial_eval(
        sess, rep, P_1045, frac_fixed, min_coeff=2.0 ** -(f_p + 4)
    )
    e_prod = rep_ops.mul(sess, rep, d, e_approx.tensor)
    return rep_ops.trunc_pr(sess, rep, e_prod, amount)


def pow2(sess, rep, x: RepFixedTensor,
         lower_bounded: bool = False) -> RepFixedTensor:
    """2^x for secret fixed-point x of EITHER sign, without the
    reference's reciprocal branch (exp.rs:11-112 computes 1/2^|x| via a
    full Goldschmidt division for negative inputs — roughly half of
    exp's protocol size): 2^x = 2^(x + f) * 2^-f, where x + f >= 0 after
    clamping x below at -f (where 2^x underflows fixed(i, f) to 0
    anyway), and the final 2^-f factor is a plain ring shift-truncation.
    Ring headroom: the shifted result raw value is 2^(x + 2f) <
    2^(i + 2f) <= 2^width (guaranteed by the same 2(i+f) <= width bound
    division imposes).

    ``lower_bounded=True`` skips the clamp when the caller already
    guarantees x >= -f (softmax clamps at its underflow threshold)."""
    i_p = x.integral_precision
    f_p = x.fractional_precision
    k = i_p + f_p
    width = _width_of(x.tensor)

    t = x.tensor
    if not lower_bounded:
        floor_raw = encode_const(-float(f_p), f_p, width)
        shp = _shape_of(sess, rep, t)
        floor_t = rep_ops.fill(sess, rep, shp, floor_raw, width)
        under = rep_ops.greater(sess, rep, floor_t, t)
        t = rep_ops.mux_bit(sess, rep, under, floor_t, t)
    shifted = add_public_raw(
        sess, rep, t, encode_const(float(f_p), f_p, width)
    )
    g = _pow2_positive(
        sess, rep, shifted, i_p, f_p,
        int_bound_bits=max(1, k.bit_length()),
    )
    # g = 2^(x+f) at scale f; shift back down by f: 2^x at scale f
    out = rep_ops.trunc_pr(sess, rep, g, f_p)
    return RepFixedTensor(out, i_p, f_p)


def exp(sess, rep, x: RepFixedTensor,
        lower_bounded: bool = False) -> RepFixedTensor:
    """e^x = 2^(x * log2(e))."""
    scaled = mul_public_float(sess, rep, x, math.log2(math.e))
    return pow2(sess, rep, scaled, lower_bounded=lower_bounded)


# ---------------------------------------------------------------------------
# log2 / log (log.rs)
# ---------------------------------------------------------------------------

P_2524 = [-2.05466671951, -8.8626599391, 6.10585199015, 4.81147460989]
Q_2524 = [0.353553425277, 4.54517087629, 6.42784209029, 1.0]


def int2fl(sess, rep, x: RepTensor, max_bit_len: int, frac: int):
    """Normalize a secret integer to (v, p, s, z) with
    (1-2s)(1-z) * v * 2^p = x (log.rs:112-220)."""
    width = _width_of(x)
    lam = max_bit_len - 1

    sign_bit = rep_ops.msb(sess, rep, x)
    s_ring = rep_ops.b2a(sess, rep, sign_bit, width)
    z_bit = rep_ops.equal_zero_bit(sess, rep, x)
    z_ring = rep_ops.b2a(sess, rep, z_bit, width)

    x_pos = rep_ops.mux_ring(
        sess, rep, s_ring, rep_ops.neg(sess, rep, x), x
    )
    pos_bits = rep_ops.bit_decompose(sess, rep, x_pos)
    low = rep_ops.slice_axis0(sess, rep, pos_bits, 0, lam)
    rev = rep_ops._map_shares(
        sess,
        rep,
        lambda plc, a: sess.strided_slice(plc, a, (slice(None, None, -1),)),
        low,
    )
    b = prefix_or_bits(sess, rep, rev, lam)  # reversed prefix-or
    b_ring = rep_ops.b2a_bits(sess, rep, b, width)

    # b is in reversed order (index 0 = top bit); the reference's
    # neg_b_sum = sum_i (1 - b_rev[i]) << i collapses to 2^(lam-1-t) - 1
    # where t is the top set bit: exactly the upshift factor minus one.
    ones_w = [1] * lam
    bit_count = rep_ops.weighted_bit_sum(sess, rep, b_ring, ones_w, width)
    rev_weights = [1 << i for i in range(lam)]
    b_weighted = rep_ops.weighted_bit_sum(sess, rep, b_ring, rev_weights, width)
    all_weights_sum = (1 << lam) - 1
    neg_b_sum = public_sub_raw(sess, rep, all_weights_sum, b_weighted)

    one_plus = add_public_raw(sess, rep, neg_b_sum, 1)
    x_up = rep_ops.mul(sess, rep, x_pos, one_plus)
    v = rep_ops.trunc_pr(sess, rep, x_up, max_bit_len - 1 - frac)

    # p = (bit_count - f) * (1 - z)
    p_minus_f = add_public_raw(sess, rep, bit_count, (-frac) % (1 << width))
    one_minus_z = public_sub_raw(sess, rep, 1, z_ring)
    p = rep_ops.mul(sess, rep, p_minus_f, one_minus_z)

    return v, p, s_ring, z_ring


def log2(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    i_p, f_p = x.integral_precision, x.fractional_precision
    total = i_p + f_p
    v, p, _s, _z = int2fl(sess, rep, x.tensor, total, f_p)
    v_fixed = RepFixedTensor(v, i_p, f_p)
    num = polynomial_eval(sess, rep, P_2524, v_fixed)
    den = polynomial_eval(sess, rep, Q_2524, v_fixed)
    quot = div(sess, rep, num, den)
    p_fixed = RepFixedTensor(rep_ops.shl(sess, rep, p, f_p), i_p, f_p)
    return add(sess, rep, p_fixed, quot)


def log(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    l2 = log2(sess, rep, x)
    return mul_public_float(sess, rep, l2, math.log(2.0))


def sqrt(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    """sqrt(x) = 2^(0.5*log2(x)) (sqrt.rs)."""
    l2 = log2(sess, rep, x)
    half = mul_public_float(sess, rep, l2, 0.5)
    return pow2(sess, rep, half)


def sigmoid(sess, rep, x: RepFixedTensor) -> RepFixedTensor:
    """1 / (1 + e^-x), via a single division.

    With y = e^{|x|} (positive-branch pow2 only — no reciprocal needed):
    x >= 0:  sigmoid = y / (1 + y)
    x <  0:  sigmoid = (1/y) / (1 + 1/y) = 1 / (1 + y)
    i.e. uniformly mux(x<0, 1, y) / (1 + y).  The naive composition
    exp(-x) then 1/(1+e) runs the Goldschmidt machinery twice (once inside
    pow2's negative branch, once for the outer division); this form runs
    it once, which roughly halves sigmoid's protocol size."""
    i_p, f_p = x.integral_precision, x.fractional_precision
    width = _width_of(x.tensor)

    z = mul_public_float(sess, rep, x, math.log2(math.e))  # e^x = 2^z
    m = rep_ops.msb(sess, rep, z.tensor)
    m_ring = rep_ops.b2a(sess, rep, m, width)
    abs_z = rep_ops.mux_ring(
        sess, rep, m_ring, rep_ops.neg(sess, rep, z.tensor), z.tensor
    )
    y = _pow2_positive(sess, rep, abs_z, i_p, f_p)

    one_raw = fill_public(sess, rep, x.tensor, 1 << f_p)
    num = rep_ops.mux_ring(sess, rep, m_ring, one_raw, y)
    den = add_public_raw(sess, rep, y, 1 << f_p)
    return div(
        sess,
        rep,
        RepFixedTensor(num, i_p, f_p),
        RepFixedTensor(den, i_p, f_p),
        positive_divisor=True,
    )


# ---------------------------------------------------------------------------
# maximum / argmax / softmax (softmax.rs, argmax.rs)
# ---------------------------------------------------------------------------


def _stack_rep(sess, rep, xs: Sequence[RepTensor]) -> RepTensor:
    expanded = [
        rep_ops.expand_dims(sess, rep, x, axis=0) for x in xs
    ]
    if len(expanded) == 1:
        return expanded[0]
    return rep_ops.concat(sess, rep, expanded, axis=0)


def maximum_ring(sess, rep, xs: Sequence[RepTensor]) -> RepTensor:
    """Tournament max via less + mux (softmax.rs:10-54), one STACKED
    comparison per round: all pairs of a round are concatenated on a
    fresh leading axis so each round costs one bit-decompose comparison
    regardless of field size — ceil(log2 n) comparisons total instead of
    n-1 (the dominant cost of a comparison is the secure adder, whose
    protocol size is shape-independent)."""
    n = len(xs)
    if n < 1:
        from ..errors import KernelError

        raise KernelError("maximum requires at least one operand")
    xs = list(xs)
    # stacking needs uniform shapes; broadcast-compatible mixed shapes
    # keep the pairwise elementwise path (less/mux broadcast per share)
    uniform = len({tuple(x.shape) for x in xs}) == 1
    while len(xs) > 1:
        m = len(xs) // 2
        carry = xs[2 * m:]
        evens, odds = xs[0:2 * m:2], xs[1:2 * m:2]
        if m == 1 or not uniform:
            nxt = []
            for a, b in zip(evens, odds):
                lt = rep_ops.less(sess, rep, a, b)
                nxt.append(rep_ops.mux_bit(sess, rep, lt, b, a))
            xs = nxt + list(carry)
            continue
        a = _stack_rep(sess, rep, evens)
        b = _stack_rep(sess, rep, odds)
        lt = rep_ops.less(sess, rep, a, b)
        mx = rep_ops.mux_bit(sess, rep, lt, b, a)
        xs = [
            rep_ops.index_axis(sess, rep, mx, 0, i) for i in range(m)
        ] + list(carry)
    return xs[0]


def maximum(sess, rep, xs: Sequence[RepFixedTensor]) -> RepFixedTensor:
    t = maximum_ring(sess, rep, [x.tensor for x in xs])
    return RepFixedTensor(
        t, xs[0].integral_precision, xs[0].fractional_precision
    )


def argmax_ring(sess, rep, x: RepTensor, axis: int, upmost_index: int) -> RepTensor:
    """Tournament argmax over (index, value) pairs (argmax.rs:6-47);
    indices are public fills carried through muxes.  Rounds are stacked
    like :func:`maximum_ring`: one comparison + one b2a per round."""
    width = _width_of(x)
    vals = [
        rep_ops.index_axis(sess, rep, x, axis, i)
        for i in range(upmost_index)
    ]
    idxs = [fill_public(sess, rep, v, i) for i, v in enumerate(vals)]

    while len(vals) > 1:
        m = len(vals) // 2
        carry_v, carry_i = vals[2 * m:], idxs[2 * m:]
        if m == 1:
            av, bv = vals[0], vals[1]
            ai, bi = idxs[0], idxs[1]
            lt = rep_ops.less(sess, rep, av, bv)
            s = rep_ops.b2a(sess, rep, lt, width)
            vals = [rep_ops.mux_ring(sess, rep, s, bv, av)] + list(carry_v)
            idxs = [rep_ops.mux_ring(sess, rep, s, bi, ai)] + list(carry_i)
            continue
        av = _stack_rep(sess, rep, vals[0:2 * m:2])
        bv = _stack_rep(sess, rep, vals[1:2 * m:2])
        ai = _stack_rep(sess, rep, idxs[0:2 * m:2])
        bi = _stack_rep(sess, rep, idxs[1:2 * m:2])
        lt = rep_ops.less(sess, rep, av, bv)
        s = rep_ops.b2a(sess, rep, lt, width)
        nv = rep_ops.mux_ring(sess, rep, s, bv, av)
        ni = rep_ops.mux_ring(sess, rep, s, bi, ai)
        vals = [
            rep_ops.index_axis(sess, rep, nv, 0, i) for i in range(m)
        ] + list(carry_v)
        idxs = [
            rep_ops.index_axis(sess, rep, ni, 0, i) for i in range(m)
        ] + list(carry_i)
    return idxs[0]


def argmax(sess, rep, x: RepFixedTensor, axis: int, upmost_index: int) -> RepTensor:
    return argmax_ring(sess, rep, x.tensor, axis, upmost_index)


def softmax(
    sess, rep, x: RepFixedTensor, axis: int, upmost_index: int
) -> RepFixedTensor:
    """Numerically-safe softmax (softmax.rs:56-130): subtract max, exp,
    zero out entries below the representable exp threshold, normalize."""
    i_p, f_p = x.integral_precision, x.fractional_precision
    xs = [
        RepFixedTensor(
            rep_ops.index_axis(sess, rep, x.tensor, axis, i), i_p, f_p
        )
        for i in range(upmost_index)
    ]
    xmax = maximum(sess, rep, xs)
    xmax_e = RepFixedTensor(
        rep_ops.expand_dims(sess, rep, xmax.tensor, axis=axis), i_p, f_p
    )
    diff = sub(sess, rep, x, xmax_e)

    # threshold: -(ln 2^min(i_p - 1, f_p)); below it e^diff underflows
    # the OUTPUT encoding (2^-f is the smallest positive fixed value, and
    # the reference's own bound is 2^-(i_p-1)) -> clamp the INPUT there
    # first, so exp can take its shifted positive-only path (diff <= 0
    # and, after the clamp, diff*log2(e) >= -f_p — no reciprocal branch,
    # no second comparison).  The f_p term matters when i_p - 1 > f_p:
    # without it the clamp would pass values below exp's shifted-domain
    # floor and _pow2_positive would wrap.  The -1 gives one power-of-two
    # of headroom so the few ulps of encode_const/trunc_pr rounding
    # between the clamp (on diff) and exp's internal log2(e) scaling
    # cannot push a barely-unclamped element below -f_p
    min_val = -1.0 * math.log(2.0) * min(i_p - 1, f_p - 1)
    width = _width_of(x.tensor)
    lower_raw = encode_const(min_val, f_p, width)
    lower = RepFixedTensor(
        rep_ops.fill(sess, rep, _shape_of(sess, rep, diff.tensor), lower_raw, width),
        i_p,
        f_p,
    )
    gt = rep_ops.greater(sess, rep, lower.tensor, diff.tensor)
    clamped = RepFixedTensor(
        rep_ops.mux_bit(sess, rep, gt, lower.tensor, diff.tensor), i_p, f_p
    )
    e_x = exp(sess, rep, clamped, lower_bounded=True)

    zeros = RepFixedTensor(
        rep_ops.fill(sess, rep, _shape_of(sess, rep, e_x.tensor), 0, width),
        i_p,
        f_p,
    )
    normalized = RepFixedTensor(
        rep_ops.mux_bit(sess, rep, gt, zeros.tensor, e_x.tensor), i_p, f_p
    )
    total = sum_(sess, rep, normalized, axis)
    total_e = RepFixedTensor(
        rep_ops.expand_dims(sess, rep, total.tensor, axis=axis), i_p, f_p
    )
    return div(sess, rep, normalized, total_e, positive_divisor=True)
