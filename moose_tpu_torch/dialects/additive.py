"""Additive dialect: 2-party additive secret sharing used as a helper
sub-protocol (truncation with a third-party mask provider).

The port of ``moose_tpu/dialects/additive.py`` (``moose/src/additive/``):
compositions of session methods, word for word the JAX package's.
Sharing convention: x = x_0 + x_1; party i holds x_i
(additive/mod.rs:48).  :func:`gen_trunc_mask` records its ops in the
JAX package's order, which lowering needs op for op;
:func:`trunc_draws` takes the same draws alone for the per-host layout's
fused truncation (``replicated.trunc_pr``, K2 on the card).
"""

from __future__ import annotations

from ..computation import AdditivePlacement
from ..values import AdtTensor
from .host import random_sync_key


def _draw(sess, owner: str, shp, width: int):
    """One fresh uniform draw at ``owner``: a new key, its seed under the
    next sync nonce, the words."""
    key = sess.key_gen(owner)
    seed = sess.derive_seed(owner, key, random_sync_key())
    return sess.sample_uniform_seeded(owner, shp, seed, width)


def _share_with(sess, adt: AdditivePlacement, x, x0) -> AdtTensor:
    """The sharing (x0, x - x0) of ``x``, held by the two owners."""
    p0, p1 = adt.owners
    x1 = sess.sub(x.plc, x, x0)
    return AdtTensor(
        (sess.place(p0, x0), sess.place(p1, x1)), adt.name
    )


def share_from(sess, adt: AdditivePlacement, x) -> AdtTensor:
    """Additively share a host value owned by one of the two parties (or a
    third party) using a PRF-compressed share (additive/trunc.rs:52-58)."""
    owner = x.plc
    return _share_with(
        sess, adt, x, _draw(sess, owner, sess.shape(owner, x), x.width))


def reveal(sess, adt: AdditivePlacement, x: AdtTensor, to_plc: str):
    a = sess.place(to_plc, x.shares[0])
    b = sess.place(to_plc, x.shares[1])
    return sess.add(to_plc, a, b)


def add(sess, adt, x: AdtTensor, y: AdtTensor) -> AdtTensor:
    return AdtTensor(
        tuple(
            sess.add(adt.owners[i], x.shares[i], y.shares[i]) for i in range(2)
        ),
        adt.name,
    )


def sub(sess, adt, x: AdtTensor, y: AdtTensor) -> AdtTensor:
    return AdtTensor(
        tuple(
            sess.sub(adt.owners[i], x.shares[i], y.shares[i]) for i in range(2)
        ),
        adt.name,
    )


def add_public(sess, adt, x: AdtTensor, c) -> AdtTensor:
    """x + public c: adjust share 0 only; c must live on owners[0]."""
    return AdtTensor(
        (sess.add(adt.owners[0], x.shares[0], c), x.shares[1]), adt.name
    )


def sub_public(sess, adt, x: AdtTensor, c) -> AdtTensor:
    return AdtTensor(
        (sess.sub(adt.owners[0], x.shares[0], c), x.shares[1]), adt.name
    )


def public_sub(sess, adt, c, x: AdtTensor) -> AdtTensor:
    p0, p1 = adt.owners
    return AdtTensor(
        (
            sess.sub(p0, c, x.shares[0]),
            sess.neg(p1, x.shares[1]),
        ),
        adt.name,
    )


def mul_public(sess, adt, x: AdtTensor, c, c_on_p1=None) -> AdtTensor:
    p0, p1 = adt.owners
    if c_on_p1 is None:
        c_on_p1 = sess.place(p1, c)
    return AdtTensor(
        (
            sess.mul(p0, x.shares[0], c),
            sess.mul(p1, x.shares[1], c_on_p1),
        ),
        adt.name,
    )


def shl(sess, adt, x: AdtTensor, amount: int) -> AdtTensor:
    return AdtTensor(
        tuple(
            sess.shl(adt.owners[i], x.shares[i], amount) for i in range(2)
        ),
        adt.name,
    )


# ---------------------------------------------------------------------------
# Probabilistic truncation with helper (additive/trunc.rs:13-170)
# ---------------------------------------------------------------------------


def gen_trunc_mask(sess, provider: str, adt, amount: int, shp, width: int):
    """Provider samples r and additively shares (r, r_top, r_msb) where
    r_top = (r << 1) >> (amount + 1) and r_msb = r >> (k-1)
    (additive/trunc.rs:36-66)."""
    r = _draw(sess, provider, shp, width)
    r_msb = sess.shr(provider, r, width - 1)
    r_top = sess.shr(provider, sess.shl(provider, r, 1), amount + 1)
    return tuple(share_from(sess, adt, v) for v in (r, r_top, r_msb))


def trunc_draws(sess, provider: str, shp, width: int):
    """The draws of :func:`gen_trunc_mask` alone, in its order: r, then
    the first share of each of r, r_top and r_msb (``share_from``'s
    draw); its shifts and subtractions draw nothing.  The fused
    truncation (``replicated.trunc_pr``) takes these and does the rest
    in K2."""
    return tuple(_draw(sess, provider, shp, width) for _ in range(4))


def trunc_pr(
    sess, adt: AdditivePlacement, x: AdtTensor, amount: int, provider: str
) -> AdtTensor:
    """Probabilistic truncation assuming signed inputs in
    [-2^{k-2}, 2^{k-2}) (additive/trunc.rs:115-170): mask, reveal, shift
    in the clear, unmask, with an MSB-overflow correction term."""
    p0, p1 = adt.owners
    if provider in (p0, p1):
        from ..errors import KernelError

        raise KernelError(
            f"trunc provider {provider!r} must be a third party, not one of "
            f"the additive owners {adt.owners}"
        )
    width = x.shares[0].width
    k = width - 1
    shp = sess.shape(p0, x.shares[0])

    r, r_top, r_msb = gen_trunc_mask(sess, provider, adt, amount, shp, width)

    ones = sess.fill(p0, shp, 1, f"HostRing{width}Tensor")
    upshifter = sess.shl(p0, ones, k - 1)
    downshifter = sess.shl(p0, ones, k - amount - 1)

    x_positive = add_public(sess, adt, x, upshifter)
    masked = add(sess, adt, x_positive, r)
    c = reveal(sess, adt, masked, p0)
    c_no_msb = sess.shl(p0, c, 1)
    c_top = sess.shr(p0, c_no_msb, amount + 1)
    c_msb = sess.shr(p0, c, width - 1)

    # overflow = r_msb XOR c_msb = r_msb + c_msb - 2 * r_msb * c_msb
    r_msb_c = mul_public(sess, adt, r_msb, c_msb)
    twice = shl(sess, adt, r_msb_c, 1)
    overflow = sub(sess, adt, add_public(sess, adt, r_msb, c_msb), twice)
    shifted_overflow = shl(sess, adt, overflow, k - amount)

    # y_positive = c_top - r_top + (overflow << (k - amount))
    y_positive = add(
        sess, adt, public_sub(sess, adt, c_top, r_top), shifted_overflow
    )
    return sub_public(sess, adt, y_positive, downshifter)
