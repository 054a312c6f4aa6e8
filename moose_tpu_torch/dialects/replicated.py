"""Replicated dialect: honest-majority 3-party replicated secret sharing
(ABY3-style) over Z_{2^64}/Z_{2^128} and Z_2, one host tensor per share.

The port of ``moose_tpu/dialects/replicated.py``
(``moose/src/replicated/``): kernels are compositions of session host
primitives, and every draw, key and nonce comes in the JAX package's
order, so a walk under the same master key and sync-key stream gives
its words.  Share exchange between parties is a placement relabel.

Three steps run fused on the card, word for word the composition they
replace: a multiply's per-party cross terms ``x_i (y_i + y_{i+1}) +
x_{i+1} y_i`` (K3 elementwise, K1 for a matrix product or a
convolution's im2col columns) and the truncation's tail after its draws
(K2's ``trunc_combine``, :func:`trunc_pr`).

Sharing convention (replicated/mod.rs:74-77): x = x0 + x1 + x2, party i
holds the pair (x_i, x_{i+1}) (indices mod 3); ``RepTensor.shares[i]`` is
party i's pair.
"""

from __future__ import annotations

from typing import Sequence

from ..computation import ReplicatedPlacement
from ..values import (
    AdtTensor,
    HostBitTensor,
    RepSetup,
    RepTensor,
)
from .host import random_sync_key

# ---------------------------------------------------------------------------
# Setup: pairwise PRF keys (replicated/setup.rs:37-59).
# Key k_i is shared by parties i and i-1; party i holds (k_i, k_{i+1}).
# ---------------------------------------------------------------------------


def gen_setup(sess, rep: ReplicatedPlacement) -> RepSetup:
    p = rep.owners
    k0 = sess.key_gen(p[0])
    k1 = sess.key_gen(p[1])
    k2 = sess.key_gen(p[2])
    keys = (
        (k0, sess.place(p[0], k1)),
        (k1, sess.place(p[1], k2)),
        (k2, sess.place(p[2], k0)),
    )
    return RepSetup(keys, rep.name)


def _seeds(sess, rep: ReplicatedPlacement):
    """Per-invocation seeds from the setup keys: party i derives
    (seed_i, seed_{i+1}) with a fresh trace-time nonce
    (replicated/zero_share.rs:8-50)."""
    setup = sess.replicated_setup(rep)
    nonce = random_sync_key()
    out = []
    for i in range(3):
        ki, kip1 = setup.keys[i]
        out.append(
            (
                sess.derive_seed(rep.owners[i], ki, nonce),
                sess.derive_seed(rep.owners[i], kip1, nonce),
            )
        )
    return out


def zero_share_ring(sess, rep: ReplicatedPlacement, shp, width: int):
    """alpha_i = PRF(k_i) - PRF(k_{i+1}); sum_i alpha_i = 0."""
    seeds = _seeds(sess, rep)
    alphas = []
    for i in range(3):
        si = sess.sample_uniform_seeded(rep.owners[i], shp, seeds[i][0], width)
        sip1 = sess.sample_uniform_seeded(
            rep.owners[i], shp, seeds[i][1], width
        )
        alphas.append(sess.sub(rep.owners[i], si, sip1))
    return alphas


def zero_share_bits(sess, rep: ReplicatedPlacement, shp):
    """XOR zero sharing over Z_2."""
    seeds = _seeds(sess, rep)
    alphas = []
    for i in range(3):
        si = sess.sample_bit_tensor_seeded(rep.owners[i], shp, seeds[i][0])
        sip1 = sess.sample_bit_tensor_seeded(rep.owners[i], shp, seeds[i][1])
        alphas.append(sess.xor(rep.owners[i], si, sip1))
    return alphas


# ---------------------------------------------------------------------------
# Share / reveal (replicated/convert.rs)
# ---------------------------------------------------------------------------


def share(sess, rep: ReplicatedPlacement, x) -> RepTensor:
    """PRF-compressed input sharing (convert.rs:49): when the owner is party
    j: x_j = PRF(k_j) (derivable by parties j and j-1 without communication),
    x_{j+1} = x - x_j (sent to party j+1), x_{j+2} = 0.
    """
    owner = x.plc
    p = rep.owners
    setup = sess.replicated_setup(rep)
    shp = sess.shape(owner, x)
    is_bits = isinstance(x, HostBitTensor)

    def sample(plc, seed):
        if is_bits:
            return sess.sample_bit_tensor_seeded(plc, shp, seed)
        return sess.sample_uniform_seeded(plc, shp, seed, x.width)

    def zeros(plc):
        if is_bits:
            return sess.fill(plc, shp, 0, "HostBitTensor")
        return sess.ring_zeros(plc, shp, x.width)

    def sub(plc, a, b):
        if is_bits:
            return sess.xor(plc, a, b)
        return sess.sub(plc, a, b)

    if owner in p:
        j = p.index(owner)
        nonce = random_sync_key()
        # key k_j as held by party j (first slot) and by party j-1 (second).
        k_at_owner = setup.keys[j][0]
        k_at_prev = setup.keys[(j + 2) % 3][1]
        seed_owner = sess.derive_seed(owner, k_at_owner, nonce)
        seed_prev = sess.derive_seed(p[(j + 2) % 3], k_at_prev, nonce)
        x_j = sample(owner, seed_owner)  # party j's copy of x_j
        x_j_prev = sample(p[(j + 2) % 3], seed_prev)  # party j-1's copy
        x_j1 = sub(owner, x, x_j)  # x_{j+1}, computed by owner
        # Build shares[i] = (x_i, x_{i+1}) per party.
        shares = [None, None, None]
        # party j: (x_j, x_{j+1}) both local.
        shares[j] = (x_j, x_j1)
        # party j+1: (x_{j+1} <- sent from owner, x_{j+2} = 0).
        jp = (j + 1) % 3
        shares[jp] = (sess.place(p[jp], x_j1), zeros(p[jp]))
        # party j-1 (= j+2): (x_{j+2} = 0, x_j via PRF).
        jm = (j + 2) % 3
        shares[jm] = (zeros(p[jm]), x_j_prev)
        return RepTensor(tuple(shares), rep.name)

    # Generic owner outside the replicated placement: owner samples two
    # shares from its own entropy and distributes pairs.
    nonce = random_sync_key()
    key = sess.key_gen(owner)
    s0 = sess.derive_seed(owner, key, nonce)
    key2 = sess.key_gen(owner)
    s1 = sess.derive_seed(owner, key2, nonce)
    x0 = sample(owner, s0)
    x1 = sample(owner, s1)
    x2 = sub(owner, sub(owner, x, x0), x1)
    pair = lambda i, a, b: (sess.place(p[i], a), sess.place(p[i], b))
    return RepTensor(
        (pair(0, x0, x1), pair(1, x1, x2), pair(2, x2, x0)), rep.name
    )


def reveal(sess, rep: ReplicatedPlacement, x: RepTensor, to_plc: str):
    """Reconstruct x on ``to_plc`` (convert.rs:202): the target needs the one
    share it does not already hold."""
    p = rep.owners
    is_bits = isinstance(x.shares[0][0], HostBitTensor)
    add = sess.xor if is_bits else sess.add
    if to_plc in p:
        i = p.index(to_plc)
        x_i, x_i1 = x.shares[i]
        # x_{i+2} is the second element of party (i+1)'s pair.
        x_i2 = sess.place(to_plc, x.shares[(i + 1) % 3][1])
        return add(to_plc, add(to_plc, x_i, x_i1), x_i2)
    x0 = sess.place(to_plc, x.shares[0][0])
    x1 = sess.place(to_plc, x.shares[1][0])
    x2 = sess.place(to_plc, x.shares[2][0])
    return add(to_plc, add(to_plc, x0, x1), x2)


# ---------------------------------------------------------------------------
# Linear ops (local, replicated/arith.rs)
# ---------------------------------------------------------------------------


def _map_shares(sess, rep, fn, *xs):
    """Apply a per-party local function: fn(plc, *party_pairs_elementwise)."""
    shares = []
    for i in range(3):
        plc = rep.owners[i]
        a = fn(plc, *[x.shares[i][0] for x in xs])
        b = fn(plc, *[x.shares[i][1] for x in xs])
        shares.append((a, b))
    return RepTensor(tuple(shares), rep.name)


def add(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return _map_shares(sess, rep, lambda plc, a, b: sess.add(plc, a, b), x, y)


def sub(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return _map_shares(sess, rep, lambda plc, a, b: sess.sub(plc, a, b), x, y)


def neg(sess, rep, x: RepTensor) -> RepTensor:
    return _map_shares(sess, rep, lambda plc, a: sess.neg(plc, a), x)


def xor(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return _map_shares(sess, rep, lambda plc, a, b: sess.xor(plc, a, b), x, y)


def add_n(sess, rep, xs: Sequence[RepTensor]) -> RepTensor:
    out = xs[0]
    for x in xs[1:]:
        out = add(sess, rep, out, x)
    return out


def fill(sess, rep, shp, value, width: int) -> RepTensor:
    """Public constant as a trivial sharing (v, 0, 0)."""
    p = rep.owners
    v0 = sess.fill(p[0], shp, value, f"HostRing{width}Tensor")
    z = lambda i: sess.ring_zeros(p[i], shp, width)
    v2 = sess.fill(p[2], shp, value, f"HostRing{width}Tensor")
    return RepTensor(
        ((v0, z(0)), (z(1), z(1)), (z(2), v2)), rep.name
    )


def add_public(sess, rep, x: RepTensor, c, c_on_p2=None) -> RepTensor:
    """x + public constant: only share x_0 is adjusted (by parties 0 and 2,
    who both hold it).  ``c`` must live on owners[0]; ``c_on_p2`` is party
    2's copy (defaults to moving c)."""
    p = rep.owners
    if c_on_p2 is None:
        c_on_p2 = sess.place(p[2], c)
    s = x.shares
    return RepTensor(
        (
            (sess.add(p[0], s[0][0], c), s[0][1]),
            s[1],
            (s[2][0], sess.add(p[2], s[2][1], c_on_p2)),
        ),
        rep.name,
    )


def sub_public(sess, rep, x: RepTensor, c, c_on_p2=None) -> RepTensor:
    p = rep.owners
    if c_on_p2 is None:
        c_on_p2 = sess.place(p[2], c)
    s = x.shares
    return RepTensor(
        (
            (sess.sub(p[0], s[0][0], c), s[0][1]),
            s[1],
            (s[2][0], sess.sub(p[2], s[2][1], c_on_p2)),
        ),
        rep.name,
    )


def mul_public(sess, rep, x: RepTensor, cs) -> RepTensor:
    """x * public constant; ``cs`` is a per-party 3-tuple (mirrored value)."""
    shares = []
    for i in range(3):
        plc = rep.owners[i]
        shares.append(
            (
                sess.mul(plc, x.shares[i][0], cs[i]),
                sess.mul(plc, x.shares[i][1], cs[i]),
            )
        )
    return RepTensor(tuple(shares), rep.name)


def shl(sess, rep, x: RepTensor, amount: int) -> RepTensor:
    return _map_shares(sess, rep, lambda plc, a: sess.shl(plc, a, amount), x)


# ---------------------------------------------------------------------------
# Multiplication & dot (replicated/arith.rs:317-454): local cross products
# + zero-share, then reshare so party i ends with (z_i, z_{i+1}).
# ---------------------------------------------------------------------------


def _mul_like(sess, rep, x: RepTensor, y: RepTensor, cross):
    """Local cross products, a zero share, and the reshare so party i
    ends with (z_i, z_{i+1}).  ``cross(plc, x_i, x_{i+1}, y_i, y_{i+1})``
    is party i's regrouped ``x_i·(y_i + y_{i+1}) + x_{i+1}·y_i`` — exact,
    since the contraction distributes over ring addition, and one
    contraction fewer than the reference's 3-term form
    (replicated/arith.rs:317-367)."""
    p = rep.owners
    vs = []
    for i in range(3):
        x_i, x_i1 = x.shares[i]
        y_i, y_i1 = y.shares[i]
        vs.append(cross(p[i], x_i, x_i1, y_i, y_i1))
    shp = sess.shape(p[0], vs[0])
    width = vs[0].width
    alphas = zero_share_ring(sess, rep, shp, width)
    zs = [sess.add(p[i], vs[i], alphas[i]) for i in range(3)]
    shares = tuple(
        (zs[i], sess.place(p[i], zs[(i + 1) % 3])) for i in range(3)
    )
    return RepTensor(shares, rep.name)


def mul(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return _mul_like(sess, rep, x, y, sess.mul_cross_terms)


def dot(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return _mul_like(sess, rep, x, y, sess.dot_cross_terms)


def conv2d(sess, rep, x: RepTensor, k: RepTensor, strides=(1, 1),
           padding="VALID") -> RepTensor:
    """Secure convolution: the cross-product and zero-share-reshare
    structure of mul/dot (replicated/arith.rs:317-454), the local
    contraction a ring convolution (im2col, then the matrix product).
    NHWC input, HWIO kernel; both secret-shared."""
    return _mul_like(
        sess, rep, x, k,
        lambda plc, a0, a1, b0, b1: sess.conv_cross_terms(
            plc, a0, a1, b0, b1, strides, padding),
    )


def im2col(sess, rep, x: RepTensor, kh: int, kw: int, strides=(1, 1),
           padding="VALID") -> RepTensor:
    """Patch extraction applied share-wise (pure local data movement —
    sharing is linear, so patched shares reconstruct to the patched
    secret).  Used by pooling."""
    return _map_shares(
        sess, rep,
        lambda plc, a: sess.im2col(plc, a, kh, kw, strides, padding), x
    )


def and_bits(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    """AND on replicated bit shares = multiplication over Z_2."""
    p = rep.owners
    vs = []
    for i in range(3):
        plc = p[i]
        x_i, x_i1 = x.shares[i]
        y_i, y_i1 = y.shares[i]
        # regrouped: (x_i & y_i) ^ (x_i & y_{i+1}) ^ (x_{i+1} & y_i)
        # = (x_i & (y_i ^ y_{i+1})) ^ (x_{i+1} & y_i) — AND distributes
        # over XOR, so one fewer AND than the 3-term form
        v = sess.xor(
            plc,
            sess.and_(plc, x_i, sess.xor(plc, y_i, y_i1)),
            sess.and_(plc, x_i1, y_i),
        )
        vs.append(v)
    shp = sess.shape(p[0], vs[0])
    alphas = zero_share_bits(sess, rep, shp)
    zs = [sess.xor(p[i], vs[i], alphas[i]) for i in range(3)]
    shares = tuple(
        (zs[i], sess.place(p[i], zs[(i + 1) % 3])) for i in range(3)
    )
    return RepTensor(shares, rep.name)


def or_bits(sess, rep, x, y):
    """x | y = x ^ y ^ (x & y)."""
    return xor(sess, rep, xor(sess, rep, x, y), and_bits(sess, rep, x, y))


def neg_bits(sess, rep, x: RepTensor) -> RepTensor:
    """NOT: flip the public constant 1 into share x_0 only."""
    p = rep.owners
    s = x.shares
    return RepTensor(
        (
            (sess.bit_neg(p[0], s[0][0]), s[0][1]),
            s[1],
            (s[2][0], sess.bit_neg(p[2], s[2][1])),
        ),
        rep.name,
    )


def sum_(sess, rep, x: RepTensor, axis) -> RepTensor:
    return _map_shares(
        sess, rep, lambda plc, a: sess.sum(plc, a, axis), x
    )


# Structural ops applied shares-wise ---------------------------------------


def _structural(method):
    def kernel(sess, rep, x: RepTensor, *args, **kwargs):
        return _map_shares(
            sess,
            rep,
            lambda plc, a: getattr(sess, method)(plc, a, *args, **kwargs),
            x,
        )

    return kernel


reshape = _structural("reshape")
transpose = _structural("transpose")
expand_dims = _structural("expand_dims")
squeeze = _structural("squeeze")
index_axis = _structural("index_axis")
slice_ = _structural("slice")
strided_slice = _structural("strided_slice")
broadcast = _structural("broadcast")
shl_dim = _structural("shl_dim")
shr_raw = _structural("shr")  # NOT a secure truncation; helper only
diag = _structural("diag")


def concat(sess, rep, xs: Sequence[RepTensor], axis=0) -> RepTensor:
    shares = []
    for i in range(3):
        plc = rep.owners[i]
        a = sess.concat(plc, [x.shares[i][0] for x in xs], axis)
        b = sess.concat(plc, [x.shares[i][1] for x in xs], axis)
        shares.append((a, b))
    return RepTensor(tuple(shares), rep.name)


def index(sess, rep, x: RepTensor, axis: int, idx: int) -> RepTensor:
    return index_axis(sess, rep, x, axis, idx)


# ---------------------------------------------------------------------------
# Truncation (replicated/fixedpoint.rs:80 + additive/trunc.rs): convert to
# 2-party additive sharing between parties 0,1 with party 2 as the mask
# provider, truncate probabilistically, convert back.
# ---------------------------------------------------------------------------


def trunc_pr(sess, rep, x: RepTensor, amount: int) -> RepTensor:
    """Convert to a 2-party additive sharing between parties 0 and 1,
    truncate with party 2 as the mask provider, convert back:
    ``adt_to_rep(additive.trunc_pr(rep_to_adt(x)))``.  A session with
    ``fused_trunc`` (the eager one) takes the draws of
    ``additive.trunc_pr`` and :func:`adt_to_rep` in their order, then
    the arithmetic between them in one K2 ``trunc_combine``, word for
    word the composition; the symbolic session records the composition
    itself."""
    from . import additive
    from ..computation import AdditivePlacement

    p = rep.owners
    adt = AdditivePlacement(f"{rep.name}.adt", p[:2])
    if not sess.fused_trunc:
        y = additive.trunc_pr(sess, adt, rep_to_adt(sess, adt, x), amount,
                              p[2])
        return adt_to_rep(sess, rep, y)
    a0, a1 = rep_to_adt(sess, adt, x).shares
    shp = sess.shape(p[0], a0)
    width = a0.width
    r, m_r, m_rt, m_rm = additive.trunc_draws(sess, p[2], shp, width)
    z0_at_p0, z0_at_p2 = _adt_to_rep_draws(sess, rep, shp, width)
    # z0 and z1 = y_0 - z0 are party 0's, y1 party 1's additive share
    z0, z1, y1 = sess.trunc_combine(
        (p[0], p[0], p[1]), a0, a1, (r, m_r, m_rt, m_rm, z0_at_p0), amount)
    shares = (
        (z0, z1),
        (sess.place(p[1], z1), sess.place(p[1], y1)),
        (sess.place(p[2], y1), z0_at_p2),
    )
    return RepTensor(shares, rep.name)


def rep_to_adt(sess, adt, x: RepTensor) -> AdtTensor:
    """a_0 = x_0 + x_1 (party 0 holds both), a_1 = x_2 (party 1's second
    share) (additive/convert.rs:11)."""
    p0, p1 = adt.owners
    a0 = sess.add(p0, x.shares[0][0], x.shares[0][1])
    a1 = sess.place(p1, x.shares[1][1])
    return AdtTensor((a0, a1), adt.name)


def adt_to_rep(sess, rep, x: AdtTensor) -> RepTensor:
    """PRF-compressed conversion of a 2-party additive sharing held by
    (p0, p1) into a replicated sharing (reference AdtToRepOp,
    additive/convert.rs): with y0 = PRF(k_0) (derivable by p0 and p2 from
    the setup key they share), y1 = x0 - y0 and y2 = x1, the triple
    (y0, y1, y2) replicates x0 + x1 using a single fresh PRF draw and one
    value transfer per neighbor."""
    p = rep.owners
    x0, x1 = x.shares
    if (x0.plc, x1.plc) != (p[0], p[1]):
        # generic owners: fall back to re-share-and-add
        r0 = share(sess, rep, x0)
        r1 = share(sess, rep, x1)
        return add(sess, rep, r0, r1)
    shp = sess.shape(p[0], x0)
    y0_at_p0, y0_at_p2 = _adt_to_rep_draws(sess, rep, shp, x0.width)
    y1 = sess.sub(p[0], x0, y0_at_p0)
    shares = (
        (y0_at_p0, y1),
        (sess.place(p[1], y1), sess.place(p[1], x1)),
        (sess.place(p[2], x1), y0_at_p2),
    )
    return RepTensor(shares, rep.name)


def _adt_to_rep_draws(sess, rep, shp, width: int):
    """:func:`adt_to_rep`'s one PRF draw y0 = PRF(k_0), at party 0 and
    at party 2 (who share k_0)."""
    p = rep.owners
    setup = sess.replicated_setup(rep)
    nonce = random_sync_key()
    # k_0 is held by party 0 (first slot) and party 2 (second slot).
    s_at_p0 = sess.derive_seed(p[0], setup.keys[0][0], nonce)
    s_at_p2 = sess.derive_seed(p[2], setup.keys[2][1], nonce)
    return (sess.sample_uniform_seeded(p[0], shp, s_at_p0, width),
            sess.sample_uniform_seeded(p[2], shp, s_at_p2, width))


# ---------------------------------------------------------------------------
# Bit decomposition, binary adders, MSB (replicated/{bits,misc}.rs)
# ---------------------------------------------------------------------------


def _trivial_sharing(sess, rep, j: int, value_at_holders, zeros_factory):
    """Replicated sharing of a value known to parties j and j-1 where share
    v_j = value and all other shares are zero.  ``value_at_holders`` is
    (copy at party j, copy at party j-1); ``zeros_factory(plc)`` makes the
    zero share for one party."""
    p = rep.owners
    zeros = {i: zeros_factory(p[i]) for i in range(3)}
    shares = [None, None, None]
    jm = (j + 2) % 3
    jp = (j + 1) % 3
    # party j holds (v_j, v_{j+1}=0)
    shares[j] = (value_at_holders[0], zeros[j])
    # party j+1 holds (v_{j+1}=0, v_{j+2}=0)
    shares[jp] = (zeros[jp], zeros[jp])
    # party j-1 holds (v_{j-1}=0, v_j)
    shares[jm] = (zeros[jm], value_at_holders[1])
    return RepTensor(tuple(shares), rep.name)


def _trivial_bit_sharing(sess, rep, j: int, bits_at_holders, shp):
    return _trivial_sharing(
        sess,
        rep,
        j,
        bits_at_holders,
        lambda plc: sess.fill(plc, shp, 0, "HostBitTensor"),
    )


def bit_decompose(sess, rep, x: RepTensor) -> RepTensor:
    """Arithmetic -> binary sharing: x = x_0 + x_1 + x_2 with each summand
    trivially XOR-shared, then a carry-save adder + one Kogge-Stone adder
    (reference: replicated/bits.rs RingBitDecompose + BinaryAdder).

    Returns a replicated bit tensor with a leading bit axis of length k.
    """
    p = rep.owners
    k = x.shares[0][0].width
    shp_in = sess.shape(p[0], x.shares[0][0])
    shp = type(shp_in)((k,) + tuple(shp_in.value), shp_in.plc)
    summands = []
    for j in range(3):
        # x_j: first element of party j's pair, second element of party j-1's.
        at_j = sess.decompose_bits(p[j], x.shares[j][0])
        at_jm = sess.decompose_bits(
            p[(j + 2) % 3], x.shares[(j + 2) % 3][1]
        )
        summands.append(_trivial_bit_sharing(sess, rep, j, (at_j, at_jm), shp))
    b0, b1, b2 = summands
    # carry-save: s = b0^b1^b2 ; c = ((b0&b1) ^ ((b0^b1)&b2)) << 1
    s = xor(sess, rep, xor(sess, rep, b0, b1), b2)
    c = xor(
        sess,
        rep,
        and_bits(sess, rep, b0, b1),
        and_bits(sess, rep, xor(sess, rep, b0, b1), b2),
    )
    c = shl_dim(sess, rep, c, 1, k)
    return binary_adder(sess, rep, s, c, k)


def binary_adder(sess, rep, x: RepTensor, y: RepTensor, k: int) -> RepTensor:
    """Kogge-Stone carry-lookahead adder on replicated bit shares: log2(k)
    rounds of ANDs instead of the reference's ripple adder
    (replicated/misc.rs:176): fewer communication rounds."""
    p = xor(sess, rep, x, y)
    g = and_bits(sess, rep, x, y)
    p_run = p
    d = 1
    while d < k:
        g_sh = shl_dim(sess, rep, g, d, k)
        p_sh = shl_dim(sess, rep, p_run, d, k)
        g = xor(sess, rep, g, and_bits(sess, rep, p_run, g_sh))
        p_run = and_bits(sess, rep, p_run, p_sh)
        d *= 2
    carry_in = shl_dim(sess, rep, g, 1, k)
    return xor(sess, rep, p, carry_in)


def msb(sess, rep, x: RepTensor) -> RepTensor:
    """Most significant bit as a replicated bit tensor
    (replicated/arith.rs:611-654)."""
    k = x.shares[0][0].width
    bits = bit_decompose(sess, rep, x)
    return index_axis(sess, rep, bits, 0, k - 1)


def bit_compose(sess, rep, bits: RepTensor, width: int) -> RepTensor:
    """Binary -> arithmetic for a full STACKED bit array:
    sum_i b2a(bit_i) << i, with the b2a running ONCE over the whole
    stacked tensor (two replicated multiplications total — the
    vectorized dabit-style conversion) and the shifts folded into a
    public weighted sum.  The reference converts per bit via dabits
    (additive/dabit.rs:11-20), costing width rounds; this is the
    amortized form, two secure multiplies regardless of width."""
    ring_bits = b2a_bits(sess, rep, bits, width)
    return weighted_bit_sum(
        sess, rep, ring_bits, [1 << i for i in range(width)], width
    )


def b2a(sess, rep, bit: RepTensor, width: int) -> RepTensor:
    """XOR-shared bit -> arithmetic sharing over Z_{2^w}:
    b = b0 ^ b1 ^ b2 = u ^ b2 where u = b0 ^ b1; arithmetically
    a ^ b = a + b - 2ab, so two replicated multiplications
    (reference uses dabits, additive/dabit.rs; same costs live here as two
    fused multiplies)."""
    p = rep.owners

    def inject_trivial(j):
        # arithmetic trivial sharing of b_j (known to parties j and j-1)
        a_at_j = sess.ring_inject(p[j], bit.shares[j][0], 0, width)
        a_at_jm = sess.ring_inject(
            p[(j + 2) % 3], bit.shares[(j + 2) % 3][1], 0, width
        )
        shp = sess.shape(p[j], a_at_j)
        return _trivial_sharing(
            sess,
            rep,
            j,
            (a_at_j, a_at_jm),
            lambda plc: sess.ring_zeros(plc, shp, width),
        )

    a0 = inject_trivial(0)
    a1 = inject_trivial(1)
    a2 = inject_trivial(2)

    def arith_xor(u, v):
        uv = mul(sess, rep, u, v)
        two_uv = shl(sess, rep, uv, 1)
        return sub(sess, rep, add(sess, rep, u, v), two_uv)

    return arith_xor(arith_xor(a0, a1), a2)


def b2a_bits(sess, rep, bits: RepTensor, width: int) -> RepTensor:
    """Vectorized b2a over a whole (stacked) bit tensor: one pair of
    replicated multiplications regardless of how many bits — crucial to keep
    trace size linear (the reference converts per-bit via dabits)."""
    return b2a(sess, rep, bits, width)


def weighted_bit_sum(sess, rep, bits_ring: RepTensor, weights, width: int) -> RepTensor:
    """sum_i bits_ring[i] * weights[i] along the leading axis, with public
    integer weights broadcast against the remaining axes."""
    import numpy as np

    p = rep.owners
    w = np.asarray(weights, dtype=object).reshape(
        (len(weights),) + (1,) * (len(bits_ring.shares[0][0].shape) - 1)
    )
    cs = [sess.ring_constant(p[i], w, width) for i in range(3)]
    prod = mul_public(sess, rep, bits_ring, cs)
    return sum_(sess, rep, prod, 0)


# ---------------------------------------------------------------------------
# Comparison / selection (replicated/{compare,control_flow}.rs)
# ---------------------------------------------------------------------------


def sign_bit(sess, rep, x: RepTensor) -> RepTensor:
    return msb(sess, rep, x)


def less(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    """x < y as a replicated bit tensor (two's complement comparison:
    msb(x - y), valid when |x - y| < 2^{k-1})."""
    return msb(sess, rep, sub(sess, rep, x, y))


def greater(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return less(sess, rep, y, x)


def equal_zero_bit(sess, rep, x: RepTensor) -> RepTensor:
    """1 iff x == 0: NOT(OR-tree over all bits), log2(k) AND rounds."""
    k = x.shares[0][0].width
    bits = bit_decompose(sess, rep, x)
    # OR-reduce along the bit axis by halving.
    width = k
    while width > 1:
        half = width // 2
        lo = slice_axis0(sess, rep, bits, 0, half)
        hi = slice_axis0(sess, rep, bits, half, 2 * half)
        merged = or_bits(sess, rep, lo, hi)
        if width % 2:
            last = slice_axis0(sess, rep, bits, width - 1, width)
            merged = concat(sess, rep, [merged, last], axis=0)
            width = half + 1
        else:
            width = half
        bits = merged
    any_bit = index_axis(sess, rep, bits, 0, 0)
    return neg_bits(sess, rep, any_bit)


def slice_axis0(sess, rep, x: RepTensor, begin: int, end: int) -> RepTensor:
    return strided_slice(sess, rep, x, (slice(begin, end),))


def equal_bit(sess, rep, x: RepTensor, y: RepTensor) -> RepTensor:
    return equal_zero_bit(sess, rep, sub(sess, rep, x, y))


def mux_bit(sess, rep, s_bit: RepTensor, x: RepTensor, y: RepTensor) -> RepTensor:
    """y + s * (x - y) with s a replicated bit -> arithmetic conversion."""
    width = x.shares[0][0].width
    s = b2a(sess, rep, s_bit, width)
    return mux_ring(sess, rep, s, x, y)


def mux_ring(sess, rep, s: RepTensor, x: RepTensor, y: RepTensor) -> RepTensor:
    d = sub(sess, rep, x, y)
    return add(sess, rep, y, mul(sess, rep, s, d))
