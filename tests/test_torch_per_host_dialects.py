"""The per-host layout's dialects against the JAX package's, word for
word: the host kernels, the additive dialect and the replicated
protocol (share/reveal, mul/dot, the truncation, and_bits, the A2B
adder, msb, b2a, the comparisons and the muxes) at ring64 and ring128.

Both packages run the same function on the same numpy inputs (made from
a seed) in an EagerSession of one master key, with their sync-key
nonces pinned to one Philox stream; every share of the result must be
equal, owners included.  The port runs on the CPU through its kernels'
plain versions, so no launch is counted; its fused truncation (K2's
``trunc_combine``) must equal the reference's composition."""

import contextlib

import numpy as np
import pytest

import moose_tpu  # noqa: F401  (jax x64 before any jnp use)
from moose_tpu.computation import AdditivePlacement as JAdt
from moose_tpu.computation import ReplicatedPlacement as JRep
from moose_tpu.dialects import additive as jadd
from moose_tpu.dialects import host as jhost
from moose_tpu.dialects import replicated as jrep
from moose_tpu.execution.session import EagerSession as JaxSession

from moose_tpu_torch import interop
from moose_tpu_torch.computation import AdditivePlacement as TAdt
from moose_tpu_torch.computation import ReplicatedPlacement as TRep
from moose_tpu_torch.dialects import additive as tadd
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.dialects import replicated as trep
from moose_tpu_torch.execution.session import EagerSession
from moose_tpu_torch.native import ring_kernels as rk

from torch_parity import (  # noqa: F401  (fixtures)
    assert_shares_equal,
    jax_adt_from_numpy,
    jax_host_from_numpy,
    jax_rep_from_numpy,
    prf,
    rand_words,
    threefry,
    threefry_pallas,
)

IDS = ("alice", "bob", "carole")
MASTER = np.array([0x0BADC0DE, 0x12345678, 0x9ABCDEF0, 0x0F1E2D3C],
                  np.uint32)
SYNC_SEED = 20261017
SHAPE = (2, 3)
WIDTHS = (64, 128)
STREAMS = ("threefry", "threefry-pallas")
JREP, TREP = JRep("rep", IDS), TRep("rep", IDS)


@contextlib.contextmanager
def sessions(session_id=None):
    """A JAX and a port EagerSession under one master key, their nonces
    from one pinned stream."""
    js = JaxSession(session_id=session_id, master_key=MASTER)
    ts = EagerSession("cpu", session_id=session_id, master_key=MASTER)
    with jhost.deterministic_sync_keys(SYNC_SEED), \
            thost.deterministic_sync_keys(SYNC_SEED):
        yield js, ts


def ring_input(rng, shape, width, plc="alice"):
    """(JAX, port) host ring tensors of the same random words."""
    words = rand_words(rng, shape, width)
    return (jax_host_from_numpy(words, plc),
            interop.host_from_numpy(words, plc, device="cpu"))


def bit_input(rng, shape, plc="alice"):
    bits = rng.integers(0, 2, size=shape, dtype=np.uint8)
    return (jax_host_from_numpy(bits, plc),
            interop.host_from_numpy(bits, plc, device="cpu"))


def rep_input(rng, shape, width=None):
    """(JAX, port) consistent replicated sharings of random words (of
    bits with ``width`` None): party i holds (x_i, x_{i+1})."""
    if width is None:
        parts = [rng.integers(0, 2, size=shape, dtype=np.uint8)
                 for _ in range(3)]
    else:
        parts = [rand_words(rng, shape, width) for _ in range(3)]
    shares = tuple(((parts[i], IDS[i]), (parts[(i + 1) % 3], IDS[i]))
                   for i in range(3))
    return (jax_rep_from_numpy(shares, "rep"),
            interop.rep_from_numpy(shares, "rep", device="cpu"))


def both(fn_j, fn_t, *inputs):
    """Run ``fn_j`` and ``fn_t`` on the JAX and port halves of
    ``inputs`` in fresh sessions; return both results."""
    with sessions() as (js, ts):
        want = fn_j(js, *(i[0] for i in inputs))
        got = fn_t(ts, *(i[1] for i in inputs))
    return got, want


# -- share / reveal -----------------------------------------------------------


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_share_and_reveal(width, stream):
    rng = np.random.default_rng(width)
    x = ring_input(rng, SHAPE, width, "bob")
    outside = ring_input(rng, SHAPE, width, "dave")
    bits = bit_input(rng, SHAPE, "carole")

    def run(rep_ops, rep):
        def fn(sess, x, outside, bits):
            shared = [rep_ops.share(sess, rep, v) for v in (x, outside,
                                                            bits)]
            revealed = [rep_ops.reveal(sess, rep, s, plc)
                        for s, plc in zip(shared, ("alice", "dave", "bob"))]
            return shared + revealed
        return fn

    with prf(stream):
        got, want = both(run(jrep, JREP), run(trep, TREP), x, outside, bits)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_shares_equal(g, w, f"value {i}")
    # the reveal reconstructs the input
    assert_shares_equal(got[3], jhost.place(x[0], "alice"), "reveal")


# -- products and the truncation --------------------------------------------


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_mul_dot_and_trunc_pr(width, stream):
    rng = np.random.default_rng(10 + width)
    x = rep_input(rng, SHAPE, width)
    y = rep_input(rng, SHAPE, width)
    m = rep_input(rng, SHAPE[::-1], width)
    v = rep_input(rng, (SHAPE[1],), width)
    b = rep_input(rng, (1, SHAPE[1]), width)

    def run(rep_ops, rep):
        def fn(sess, x, y, m, v, b):
            return [
                rep_ops.mul(sess, rep, x, y),
                rep_ops.mul(sess, rep, x, b),  # broadcast
                rep_ops.dot(sess, rep, x, m),
                rep_ops.dot(sess, rep, x, v),  # a vector operand
                rep_ops.trunc_pr(sess, rep, x, 13),
                rep_ops.mul_public(sess, rep, x, [s[0] for s in y.shares]),
            ]
        return fn

    with prf(stream):
        got, want = both(run(jrep, JREP), run(trep, TREP), x, y, m, v, b)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_shares_equal(g, w, f"result {i}")


@pytest.mark.parametrize("width", WIDTHS)
def test_fused_truncation_is_the_reference_composition(threefry, width):
    """K2's plain ``trunc_combine`` in ``replicated.trunc_pr`` equals the
    reference's rep_to_adt -> additive.trunc_pr -> adt_to_rep, composed
    step by step in the JAX package."""
    rng = np.random.default_rng(20 + width)
    x = rep_input(rng, SHAPE, width)
    jadt = JAdt("rep.adt", IDS[:2])

    def composed(sess, x):
        a = jrep.rep_to_adt(sess, jadt, x)
        y = jadd.trunc_pr(sess, jadt, a, 23, IDS[2])
        return jrep.adt_to_rep(sess, JREP, y)

    got, want = both(composed, lambda s, v: trep.trunc_pr(s, TREP, v, 23), x)
    assert_shares_equal(got, want, "trunc_pr")


# -- bits: and, A2B, msb, b2a, comparisons, muxes ----------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_bit_protocols(threefry, width):
    rng = np.random.default_rng(30 + width)
    x = rep_input(rng, SHAPE, width)
    y = rep_input(rng, SHAPE, width)
    p = rep_input(rng, SHAPE)
    q = rep_input(rng, SHAPE)

    def run(rep_ops, rep):
        def fn(sess, x, y, p, q):
            lt = rep_ops.less(sess, rep, x, y)
            return [
                rep_ops.and_bits(sess, rep, p, q),
                rep_ops.or_bits(sess, rep, p, q),
                rep_ops.bit_decompose(sess, rep, x),
                rep_ops.msb(sess, rep, x),
                rep_ops.b2a(sess, rep, p, width),
                lt,
                rep_ops.greater(sess, rep, x, y),
                rep_ops.equal_bit(sess, rep, x, x),
                rep_ops.mux_bit(sess, rep, lt, x, y),
                rep_ops.bit_compose(
                    sess, rep, rep_ops.bit_decompose(sess, rep, y), width),
            ]
        return fn

    got, want = both(run(jrep, JREP), run(trep, TREP), x, y, p, q)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_shares_equal(g, w, f"result {i}")


def test_msb_under_threefry_pallas(threefry_pallas):
    """The A2B adder under K7's stream: its ring draws in the pallas
    layout, its zero-share bits in the threefry layout, as the reference
    draws them."""
    rng = np.random.default_rng(40)
    x = rep_input(rng, SHAPE, 128)
    got, want = both(lambda s, v: jrep.msb(s, JREP, v),
                     lambda s, v: trep.msb(s, TREP, v), x)
    assert_shares_equal(got, want, "msb")


# -- the additive dialect ----------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_additive_dialect(threefry, width):
    rng = np.random.default_rng(50 + width)
    x = ring_input(rng, SHAPE, width, "carole")
    # an additive sharing of random words, carried over as numpy
    shares = tuple((rand_words(rng, SHAPE, width), owner)
                   for owner in IDS[:2])
    given = (jax_adt_from_numpy(shares, "adt"),
             interop.adt_from_numpy(shares, "adt", device="cpu"))
    jadt, tadt = JAdt("adt", IDS[:2]), TAdt("adt", IDS[:2])

    def run(adt_ops, rep_ops, adt, rep):
        def fn(sess, x, given):
            a = adt_ops.share_from(sess, adt, x)
            b = adt_ops.add(sess, adt, a, given)
            t = adt_ops.trunc_pr(sess, adt, b, 7, "carole")
            return [a, b, t, adt_ops.reveal(sess, adt, t, "bob"),
                    adt_ops.shl(sess, adt, a, 3),
                    adt_ops.public_sub(sess, adt, jhost.place(x, "alice")
                                       if adt_ops is jadd else
                                       thost.place(x, "alice"), a),
                    rep_ops.adt_to_rep(sess, rep, t)]
        return fn

    got, want = both(run(jadd, jrep, jadt, JREP), run(tadd, trep, tadt, TREP),
                     x, given)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_shares_equal(g, w, f"result {i}")


# -- host kernels ------------------------------------------------------------


def _host_cases(width):
    """(name, JAX fn, port fn, inputs) of the host ring and bit kernels."""
    rng = np.random.default_rng(60 + width)
    x = ring_input(rng, (2, 4), width)
    y = ring_input(rng, (4, 3), width)
    v = ring_input(rng, (4,), width)
    img = ring_input(rng, (1, 4, 4, 2), width)
    ker = ring_input(rng, (2, 2, 2, 3), width)
    bits = bit_input(rng, (width, 2))
    return [
        ("shr_arith", lambda s, a: s.shr_arith("alice", a, 5), (x,)),
        ("shr_arith_wide", lambda s, a: s.shr_arith("alice", a, 70), (x,)),
        ("bit_extract", lambda s, a: s.bit_extract("alice", a, width - 1),
         (x,)),
        ("decompose_bits", lambda s, a: s.decompose_bits("alice", a), (x,)),
        ("compose_bits", lambda s, b: s.compose_bits("alice", b, width),
         (bits,)),
        ("ring_inject", lambda s, b: s.ring_inject("alice", b, 9, width),
         (bits,)),
        ("dot", lambda s, a, b: s.dot("alice", a, b), (x, y)),
        ("dot_vector", lambda s, a, b: s.dot("alice", a, b), (x, v)),
        ("conv2d", lambda s, a, k: s.conv2d("alice", a, k, (1, 1), "SAME"),
         (img, ker)),
        ("sum", lambda s, a: s.sum("alice", a, 1), (x,)),
        ("mean", lambda s, a: s.ring_fixedpoint_mean("alice", a, 0, 20),
         (x,)),
        ("mul", lambda s, a, b: s.mul("alice", a, b), (x, x)),
        ("neg", lambda s, a: s.neg("alice", a), (x,)),
        ("equal", lambda s, a, b: s.equal("alice", a, b), (x, x)),
        ("shl_dim", lambda s, b: s.shl_dim("alice", b, 3, width), (bits,)),
        ("reversed", lambda s, a: s.strided_slice(
            "alice", a, (slice(None, None, -1),)), (x,)),
        ("transpose", lambda s, a: s.transpose("alice", a), (x,)),
        ("im2col", lambda s, a: s.im2col("alice", a, 2, 2, (2, 1),
                                         ((1, 0), (0, 1))), (img,)),
    ]


HOST_CASES = [case[0] for case in _host_cases(64)]


@pytest.mark.parametrize("name", HOST_CASES)
@pytest.mark.parametrize("width", WIDTHS)
def test_host_kernels(width, name):
    fn, inputs = {c[0]: c[1:] for c in _host_cases(width)}[name]
    got, want = both(fn, fn, *inputs)
    assert_shares_equal(got, want, name)


@pytest.mark.parametrize("stream", STREAMS + ("aes-ctr",))
def test_keys_seeds_and_draws(stream):
    """key_gen's counter and nonce words, derive_seed and the three
    samplers; under aes-ctr the seed is the reference's blake3 of the
    session id, so both sessions take one id."""
    with prf(stream), sessions(session_id="ab" * 8) as (js, ts):
        for _ in range(3):
            jk, tk = js.key_gen("alice"), ts.key_gen("alice")
            assert tk.value == tuple(int(w) for w in np.asarray(jk.value))
            nonce = thost.random_sync_key()
            assert nonce == jhost.random_sync_key()
            jseed = js.derive_seed("alice", jk, nonce)
            tseed = ts.derive_seed("alice", tk, nonce)
            # the JAX key's words carried over derive the same seed
            carried = ts.derive_seed("alice", interop.key_from_numpy(
                np.asarray(jk.value), "alice"), nonce)
            assert carried.value == tseed.value
            assert np.array_equal(interop.key_words(tseed),
                                  np.asarray(jseed.value, np.uint32))
            shp_j = jhost.shape(jhost.constant(np.zeros((3, 5)), "alice"),
                                "alice")
            shp_t = thost.shape(thost.constant(
                np.zeros((3, 5)), "alice", None, "cpu"), "alice")
            for width in WIDTHS:
                assert_shares_equal(
                    ts.sample_uniform_seeded("alice", shp_t, tseed, width),
                    js.sample_uniform_seeded("alice", shp_j, jseed, width),
                    f"uniform {width}")
                assert_shares_equal(
                    ts.sample_bits_seeded("alice", shp_t, tseed, width),
                    js.sample_bits_seeded("alice", shp_j, jseed, width),
                    f"bits {width}")
            assert_shares_equal(
                ts.sample_bit_tensor_seeded("alice", shp_t, tseed),
                js.sample_bit_tensor_seeded("alice", shp_j, jseed),
                "bit tensor")


def test_setup_is_cached_per_placement(threefry):
    with sessions() as (js, ts):
        setups = [ts.replicated_setup(TREP) for _ in range(2)]
        jsetup = js.replicated_setup(JREP)
    assert setups[0] is setups[1]
    assert ts._key_counter == 3
    for tpair, jpair in zip(setups[0].keys, jsetup.keys):
        for tk, jk in zip(tpair, jpair):
            assert tk.plc == jk.plc
            assert np.array_equal(interop.key_words(tk),
                                  np.asarray(jk.value, np.uint32))


def test_the_cpu_launches_no_kernel(threefry):
    rng = np.random.default_rng(70)
    x = rep_input(rng, SHAPE, 128)
    rk.reset_launches()
    with sessions() as (_, ts):
        z = trep.dot(ts, TREP, x[1], trep.transpose(ts, TREP, x[1]))
        trep.trunc_pr(ts, TREP, trep.mul(ts, TREP, z, z), 40)
        trep.msb(ts, TREP, z)
    assert not any(rk.LAUNCHES.values())
