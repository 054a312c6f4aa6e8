"""The port's SymbolicSession against the JAX package's: each protocol
step of the per-host layout, run on both packages' symbolic sessions
under one pinned sync-key stream, records the same host ops, in the same
order, with the same names, shapes and attributes (the recorded graphs
serialize to equal bytes, and the results name the same ops at the same
shapes).

The port's eager session fuses a product's cross terms (K3, K1) and the
truncation's tail (K2); on the symbolic session the same dialect code
must record the reference's composition instead, op for op."""

import importlib

import pytest

import moose_tpu  # noqa: F401  (jax x64 before any jnp use)
from moose_tpu import serde as jserde
from moose_tpu.dialects import host as jhost
from moose_tpu.dialects import replicated as jrep
from moose_tpu.execution import symbolic as jsym

from moose_tpu_torch import serde as tserde
from moose_tpu_torch.dialects import host as thost
from moose_tpu_torch.dialects import replicated as trep
from moose_tpu_torch.execution import symbolic as tsym
from moose_tpu_torch.execution.session import EagerSession

# each package's IR module (the packages' own `computation` names the
# eDSL decorator)
jc, tc = (importlib.import_module(f"{p}.computation")
          for p in ("moose_tpu", "moose_tpu_torch"))
IDS = ("alice", "bob", "carole")
SEED = 20261017
PACKAGES = (
    (jc, jsym, jrep, jhost, jserde),
    (tc, tsym, trep, thost, tserde),
)


def _session(c, sym):
    comp = c.Computation()
    for name in IDS:
        comp.add_placement(c.HostPlacement(name))
    return sym.SymbolicSession(comp)


def _input(sess, c, sym, name, shape, ty="HostRing128Tensor", plc="alice"):
    """An Input op of ``shape`` on ``plc`` and its symbolic value."""
    sess.add_operation("Input", [], plc, c.Signature((), c.Ty(ty)), {},
                       name=name)
    if ty == "HostBitTensor":
        return sess._bit(name, shape, plc)
    return sess._ring(name, shape, 128, plc)


def _step(name, c, sym, rep_ops, sess):
    """Record protocol step ``name``; return its result."""
    rep = c.ReplicatedPlacement("rep", IDS)
    if name == "and_bits":
        a = _input(sess, c, sym, "a", (2, 3), "HostBitTensor")
        b = _input(sess, c, sym, "b", (2, 3), "HostBitTensor", "bob")
        return rep_ops.and_bits(sess, rep, rep_ops.share(sess, rep, a),
                                rep_ops.share(sess, rep, b))
    shapes = {"dot": ((2, 3), (3, 4)), "conv2d": ((1, 4, 4, 2),
                                                  (2, 2, 2, 3))}
    xs, ys = shapes.get(name, ((2, 3), (2, 3)))
    x = rep_ops.share(sess, rep, _input(sess, c, sym, "x", xs))
    if name == "share":
        return x
    if name == "reveal":
        return rep_ops.reveal(sess, rep, x, "carole")
    if name == "trunc_pr":
        return rep_ops.trunc_pr(sess, rep, x, 23)
    y = rep_ops.share(sess, rep, _input(sess, c, sym, "y", ys, plc="bob"))
    if name == "conv2d":
        return rep_ops.conv2d(sess, rep, x, y, strides=(1, 2),
                              padding="SAME")
    return getattr(rep_ops, name)(sess, rep, x, y)


def _leaves(value):
    """(type, producing op, shape) of every leaf of a result."""
    if hasattr(value, "shares"):
        return [leaf for pair in value.shares for v in pair
                for leaf in _leaves(v)]
    arr = value.lo if hasattr(value, "lo") else value.value
    return [(type(value).__name__, value.plc, arr.op, arr._shape)]


@pytest.mark.parametrize("name", ("share", "mul", "dot", "conv2d",
                                  "trunc_pr", "and_bits", "reveal"))
def test_symbolic_session_records_the_jax_package_s_ops(name):
    recorded = []
    for c, sym, rep_ops, host, serde in PACKAGES:
        sess = _session(c, sym)
        with host.deterministic_sync_keys(SEED):
            out = _step(name, c, sym, rep_ops, sess)
        recorded.append((serde.serialize_computation(sess.computation),
                         _leaves(out), sess.computation))
    (jbytes, jleaves, jcomp), (tbytes, tleaves, tcomp) = recorded
    assert [(op.name, op.kind) for op in tcomp.operations.values()] == \
        [(op.name, op.kind) for op in jcomp.operations.values()]
    assert tbytes == jbytes
    assert tleaves == jleaves


def test_fused_steps_are_recorded_as_the_reference_composes_them():
    """A product records an inner Add, two contractions and an outer Add
    a party; a truncation records the additive composition (its mask's
    shifts between the draws), not a fused tail."""
    for name, contraction in (("mul", "Mul"), ("dot", "Dot"),
                              ("conv2d", "Conv2D")):
        sess = _session(tc, tsym)
        with thost.deterministic_sync_keys(SEED):
            _step(name, tc, tsym, trep, sess)
        kinds = [op.kind for op in sess.computation.operations.values()]
        assert kinds.count(contraction) == 6, name
    sess = _session(tc, tsym)
    with thost.deterministic_sync_keys(SEED):
        _step("trunc_pr", tc, tsym, trep, sess)
    kinds = [op.kind for op in sess.computation.operations.values()]
    assert "Shr" in kinds and "Shl" in kinds
    assert not tsym.SymbolicSession.fused_trunc and EagerSession.fused_trunc


def test_symbolic_cast_of_ring_words_is_the_reference_s_two_casts():
    from moose_tpu_torch import dtypes as dt

    sess = _session(tc, tsym)
    x = _input(sess, tc, tsym, "x", (3,))
    out = sess.cast_ring_lo("alice", x, dt.float64)
    casts = [op for op in sess.computation.operations.values()
             if op.kind == "Cast"]
    assert [op.attributes["dtype"].name for op in casts] == ["uint64",
                                                            "float64"]
    assert out.dtype == dt.float64 and out.value._shape == (3,)
