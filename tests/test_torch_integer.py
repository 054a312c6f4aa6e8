"""Secret and public integers in the port against the JAX package: the
integer and boolean graphs of tests/test_integration_acceptance.py
(dtype conversions, uint64 identity and Save, the secret-uint64 dialect,
the replicated Equal) plus int64, bool and values at and beyond 2^63,
through both packages' LocalMooseRuntime on the CPU, in both layouts,
under fixed keys and the threefry PRF.  Outputs are equal exactly (ring
words, uint64, int64 and bool arrays; decoded floats where a graph casts
into the fixed family), and the port runs on the stacked layout every
graph the JAX runtime runs there."""

import numpy as np
import pytest

import importlib

import moose_tpu as jm
from moose_tpu import dtypes as jdt
from moose_tpu.dialects import stacked as jstacked
from moose_tpu.errors import TypeMismatchError as JaxTypeMismatchError
from moose_tpu.runtime import LocalMooseRuntime as JaxRuntime
from moose_tpu.values import HostTensor as JaxHostTensor

import torch

import moose_tpu_torch as tm
from moose_tpu_torch import dtypes as tdt
from moose_tpu_torch.dialects import stacked as tstacked
from moose_tpu_torch.errors import TypeMismatchError
from moose_tpu_torch.runtime import LocalMooseRuntime as PortRuntime
from moose_tpu_torch.values import HostTensor

from test_torch_logreg import IDS, fixed_keys, threefry  # noqa: F401

# the packages' IR modules (their `computation` names the eDSL decorator)
jcomp = importlib.import_module("moose_tpu.computation")
tcomp = importlib.import_module("moose_tpu_torch.computation")
LAYOUTS = ("stacked", "per-host")
TOP = np.uint64(1 << 63)
# uint64 operands with words at and beyond 2^63, where an int64 or
# float64 detour would go wrong
U_X = np.array([[1, 2000000, TOP + np.uint64(5)],
                [3, 2**64 - 1, 1 << 40]], dtype=np.uint64)
U_Y = np.array([[5, 6, 7], [TOP, 1048576, 2**64 - 3]], dtype=np.uint64)


def _players(pm):
    alice, bob, carole = (pm.host_placement(n) for n in IDS)
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    return alice, bob, carole, rep


def _run_both(graph_of, args, layout, storage=None):
    """The graph through both runtimes: outputs (port, JAX) and the
    layout each ran."""
    jrt = JaxRuntime(IDS, layout=layout, use_jit=False)
    want = jrt.evaluate_computation(graph_of(jm), args)
    prt = PortRuntime(IDS, layout=layout, device="cpu")
    got = prt.evaluate_computation(graph_of(tm), args)
    assert prt.last_plan["layout"] == jrt.last_plan["layout"]
    return got, want, prt, jrt


def _assert_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        w = np.asarray(want[name])
        g = np.asarray(got[name])
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("src", ["float64", "float32", "int64", "uint64"])
def test_dtype_cast_round_trip(src, fixed_keys):
    def graph_of(pm):
        alice, *_ = _players(pm)

        @pm.computation
        def comp(xx: pm.Argument(placement=alice,
                                 dtype=getattr(pm, src))):
            with alice:
                f = pm.cast(xx, dtype=pm.fixed(14, 23))
                back = pm.cast(f, dtype=getattr(pm, src))
            return back

        return comp

    x = np.array([1, 2, 3], dtype=np.dtype(src))
    got, want, *_ = _run_both(graph_of, {"xx": x}, "stacked")
    _assert_equal(got, want)
    np.testing.assert_array_equal(got["output_0"].astype(np.float64),
                                  x.astype(np.float64))


def test_uint64_identity_and_save(fixed_keys):
    x = np.array([1, 3, 2, 3, TOP, 2**64 - 1], dtype=np.uint64)

    def graph_of(pm):
        alice, bob, *_ = _players(pm)

        @pm.computation
        def comp():
            with bob:
                c = pm.constant(x)
            with alice:
                moved = pm.identity(c)
                res = pm.save("x_uri", moved)
            return res

        return comp

    _, _, prt, jrt = _run_both(graph_of, {}, "stacked")
    got = prt.read_value_from_storage("alice", "x_uri")
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(
        got, np.asarray(jrt.read_value_from_storage("alice", "x_uri")))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_secret_uint64_integer_dialect(layout, fixed_keys):
    # the acceptance test's graph: floats cast to uint64 on the hosts,
    # then shared, added, multiplied and transposed as secret integers
    def graph_of(pm):
        alice, bob, carole, rep = _players(pm)

        @pm.computation
        def comp(x: pm.Argument(placement=alice, dtype=pm.float64),
                 y: pm.Argument(placement=bob, dtype=pm.float64)):
            with alice:
                xi = pm.cast(x, dtype=pm.uint64)
            with bob:
                yi = pm.cast(y, dtype=pm.uint64)
            with rep:
                s = pm.add(xi, yi)
                p = pm.mul(xi, yi)
                st = pm.transpose(s)
            with carole:
                s_out = pm.cast(st, dtype=pm.uint64)
                p_out = pm.cast(p, dtype=pm.uint64)
            return s_out, p_out

        return comp

    x = np.array([[1.0, 2000000.0], [3.0, 4.0]])
    y = np.array([[5.0, 6.0], [7.0, 1048576.0]])
    got, want, prt, _ = _run_both(graph_of, {"x": x, "y": y}, layout)
    assert prt.last_plan["layout"] == layout
    _assert_equal(got, want)
    xi, yi = x.astype(np.uint64), y.astype(np.uint64)
    np.testing.assert_array_equal(got["output_0"], (xi + yi).T)
    np.testing.assert_array_equal(got["output_1"], xi * yi)


def secret_uint64_graph(pm, with_sum=True):
    """Add, Sub, Mul, Dot and Sum of two secret uint64 arguments, each
    cast back to uint64 on carole: the graph of chip_smoke's phase 24
    (a), with Sub and Sum besides.  The JAX package's per-host layout
    has no Sum of a secret integer, so that graph leaves it out."""
    alice, bob, carole, rep = _players(pm)

    @pm.computation
    def comp(x: pm.Argument(placement=alice, dtype=pm.uint64),
             y: pm.Argument(placement=bob, dtype=pm.uint64)):
        with rep:
            s = pm.add(x, y)
            d = pm.sub(x, y)
            p = pm.mul(x, y)
            m = pm.dot(pm.transpose(x), y)
            vals = (s, d, p, m) + ((pm.sum(p, axis=0),) if with_sum else ())
        with carole:
            outs = tuple(pm.cast(v, dtype=pm.uint64) for v in vals)
        return outs

    return comp


@pytest.mark.parametrize("layout", LAYOUTS)
def test_secret_uint64_beyond_two_to_the_63(layout, fixed_keys):
    got, want, prt, _ = _run_both(
        lambda pm: secret_uint64_graph(pm, layout == "stacked"),
        {"x": U_X, "y": U_Y}, layout)
    assert prt.last_plan["layout"] == layout
    _assert_equal(got, want)
    xo, yo = U_X.astype(object), U_Y.astype(object)
    mod = 1 << 64
    for out, ref in zip(got.values(), (
            (xo + yo) % mod, (xo - yo) % mod, (xo * yo) % mod,
            (xo.T @ yo) % mod, (xo * yo).sum(axis=0) % mod)):
        np.testing.assert_array_equal(out, ref.astype(np.uint64))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_secret_int64_cast_into_the_fixed_family(layout, fixed_keys):
    # signed integers lift with their sign extension; on the stacked
    # layout they also move into the fixed family on the replicated
    # placement (at ring128: the Cast's fixed128 target names the
    # ring), which the JAX package's per-host layout does not do
    stacked = layout == "stacked"

    def graph_of(pm):
        alice, bob, carole, rep = _players(pm)

        @pm.computation
        def comp(x: pm.Argument(placement=alice, dtype=pm.int64),
                 y: pm.Argument(placement=bob, dtype=pm.int64)):
            with rep:
                s = pm.add(x, y)
                p = pm.mul(x, y)
                if stacked:
                    z = pm.mul(pm.cast(x, dtype=pm.fixed(24, 40)),
                               pm.cast(y, dtype=pm.fixed(24, 40)))
            with carole:
                outs = (pm.cast(s, dtype=pm.int64),
                        pm.cast(p, dtype=pm.int64))
                if stacked:
                    outs += (pm.cast(z, dtype=pm.float64),)
            return outs

        return comp

    x = np.array([[-3, 7, -1], [12, -250, 0]], dtype=np.int64)
    y = np.array([[4, -2, -9], [5, 3, -1000]], dtype=np.int64)
    got, want, prt, _ = _run_both(graph_of, {"x": x, "y": y}, layout)
    assert prt.last_plan["layout"] == layout
    _assert_equal(got, want)
    np.testing.assert_array_equal(got["output_0"], x + y)
    np.testing.assert_array_equal(got["output_1"], x * y)
    if stacked:
        np.testing.assert_allclose(got["output_2"], x * y, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bool_arguments_and_shared_bits(layout, fixed_keys):
    def graph_of(pm):
        alice, bob, carole, rep = _players(pm)

        @pm.computation
        def comp(a: pm.Argument(placement=alice, dtype=pm.bool_),
                 b: pm.Argument(placement=bob, dtype=pm.bool_)):
            with rep:
                x = pm.logical_xor(a, b)
                n = pm.logical_and(a, b)
            with carole:
                x_out = pm.identity(x)
                n_out = pm.cast(n, dtype=pm.bool_)
            return x_out, n_out

        return comp

    a = np.array([[True, False, True], [False, False, True]])
    b = np.array([[True, True, False], [False, True, True]])
    got, want, *_ = _run_both(graph_of, {"a": a, "b": b}, layout)
    _assert_equal(got, want)
    np.testing.assert_array_equal(got["output_0"], a ^ b)
    np.testing.assert_array_equal(got["output_1"], a & b)


def test_replicated_equal(fixed_keys):
    x = np.array([1.5, -2.0, 3.0, 0.0])
    y = np.array([1.5, -2.0, 4.0, -1.0])

    def graph_of(pm):
        alice, bob, carole, rep = _players(pm)

        @pm.computation
        def comp(xx: pm.Argument(placement=alice, dtype=pm.float64),
                 yy: pm.Argument(placement=bob, dtype=pm.float64)):
            with alice:
                xf = pm.cast(xx, dtype=pm.fixed(8, 27))
            with bob:
                yf = pm.cast(yy, dtype=pm.fixed(8, 27))
            with rep:
                eq = pm.equal(xf, yf)
            with carole:
                out = pm.cast(eq, dtype=pm.bool_)
            return out

        return comp

    got, want, *_ = _run_both(graph_of, {"xx": x, "yy": y}, "stacked")
    _assert_equal(got, want)
    np.testing.assert_array_equal(got["output_0"], x == y)


def test_host_integer_kinds_at_and_beyond_two_to_the_63(fixed_keys):
    # unsigned compares, casts between uint64, int64, floats and bool_,
    # and the host boundary at both ends
    big = np.array([TOP, 5, 2**64 - 1, 1 << 62], dtype=np.uint64)
    small = np.array([7, TOP + np.uint64(1), 3, 1 << 63], dtype=np.uint64)
    floats = np.array([2.0 ** 63, 2.0 ** 64 - 2048.0, 3.0, 0.0])

    def graph_of(pm):
        alice, *_ = _players(pm)

        @pm.computation
        def comp(u: pm.Argument(placement=alice, dtype=pm.uint64),
                 v: pm.Argument(placement=alice, dtype=pm.uint64),
                 f: pm.Argument(placement=alice, dtype=pm.float64)):
            with alice:
                outs = (
                    pm.less(u, v), pm.greater(u, v),
                    pm.cast(u, dtype=pm.float64),
                    pm.cast(u, dtype=pm.int64),
                    pm.cast(pm.cast(u, dtype=pm.int64), dtype=pm.uint64),
                    pm.cast(u, dtype=pm.bool_),
                    pm.cast(f, dtype=pm.uint64),
                )
            return outs

        return comp

    got, want, *_ = _run_both(graph_of, {"u": big, "v": small, "f": floats},
                              "stacked")
    _assert_equal(got, want)
    np.testing.assert_array_equal(got["output_0"], big < small)
    np.testing.assert_array_equal(got["output_2"], big.astype(np.float64))
    np.testing.assert_array_equal(got["output_6"], floats.astype(np.uint64))


def test_stacked_lift_width_follows_the_op():
    # moose_tpu/dialects/stacked.py:295-313 and tests/
    # test_stacked_backend.py's width cases, in both packages
    key = np.arange(4, dtype=np.uint32) + 3
    jsess = jstacked.StackedSession(key)
    tsess = tstacked.StackedSession(key, "cpu")
    ints = np.arange(6, dtype=np.uint64).reshape(2, 3)
    jv = JaxHostTensor(ints, "alice", jdt.uint64)
    tv = HostTensor(torch.as_tensor(ints.view(np.int64)), "alice",
                    tdt.uint64)
    for width in (None, 128):
        assert tstacked.to_rep(tsess, tv, width=width).width == \
            jstacked.to_rep(jsess, jv, width=width).width
    for name in ("fixed128", "fixed64"):
        ops = [
            C.Operation(
                name="c", kind="Cast", inputs=["a"], placement_name="rep",
                signature=C.signature([C.tensor_ty(d.uint64)],
                                      C.tensor_ty(getattr(d, name)(8, 17))))
            for C, d in ((jcomp, jdt), (tcomp, tdt))
        ]
        assert tstacked._op_ring_width(ops[1]) == \
            jstacked._op_ring_width(ops[0]) == int(name[5:])
    fv = HostTensor(torch.ones(2, 2, dtype=torch.float64), "alice",
                    tdt.float64)
    with pytest.raises(TypeMismatchError):
        tstacked.to_rep(tsess, fv)


def _rep_op(C, kind, in_types, ret_ty):
    return C.Operation(
        name="o", kind=kind, inputs=[f"a{i}" for i in range(len(in_types))],
        placement_name="rep", attributes={"axis": 0},
        signature=C.signature([C.tensor_ty(t) for t in in_types],
                              C.tensor_ty(ret_ty)))


@pytest.mark.parametrize("kind", ["Cast", "Mean", "Maximum", "Add"])
def test_stacked_integer_refusals_match_the_jax_package(kind):
    # a Cast into a fixed dtype of another ring than the sharing's, Mean
    # and Maximum of secret integers, a secret integer added to a
    # fixed-point sharing: both packages refuse with a TypeMismatchError
    from moose_tpu.values import HostFixedTensor as JFixed
    from moose_tpu.values import HostRingTensor as JRing
    from moose_tpu_torch.values import HostFixedTensor as TFixed
    from moose_tpu_torch.values import HostRingTensor as TRing

    key = np.arange(4, dtype=np.uint32) + 11
    ints = np.array([[1, 2], [3, 40]], dtype=np.uint64)
    words = torch.as_tensor(ints.view(np.int64))
    sides = []
    for C, d, st, sess, v, fixed, err in (
        (jcomp, jdt, jstacked, jstacked.StackedSession(key),
         JaxHostTensor(ints, "alice", jdt.uint64),
         JFixed(JRing(ints, None, 64, "alice"), 8, 17),
         JaxTypeMismatchError),
        (tcomp, tdt, tstacked, tstacked.StackedSession(key, "cpu"),
         HostTensor(words, "alice", tdt.uint64),
         TFixed(TRing(words, None, 64, "alice"), 8, 17),
         TypeMismatchError),
    ):
        bare = st.to_rep(sess, v, width=64)
        ins, ret, args = {
            "Cast": ([d.uint64], d.fixed128(14, 23), [bare]),
            "Mean": ([d.uint64], d.uint64, [bare]),
            "Maximum": ([d.uint64] * 2, d.uint64, [bare, bare]),
            "Add": ([d.uint64, d.fixed64(8, 17)], d.fixed64(8, 17),
                    [bare, st.to_rep(sess, fixed)]),
        }[kind]
        with pytest.raises(err) as info:
            st._execute_rep(sess, C.Computation(), _rep_op(C, kind, ins, ret),
                            C.ReplicatedPlacement("rep", tuple(IDS)), args)
        sides.append(str(info.value))
    assert sides[0] == sides[1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chip_smoke_secret_uint64_graph(layout, fixed_keys):
    # chip_smoke.py phase 24 (a)'s graph at a small size: both packages'
    # words, and numpy's uint64 arithmetic
    from torch_parity import load_chip_smoke

    cs = load_chip_smoke()
    gen = np.random.default_rng(cs.SEED)
    x, y = (gen.integers(0, 2 ** 64, size=(6, 4), dtype=np.uint64)
            for _ in range(2))
    got, want, prt, _ = _run_both(cs.secret_uint64_computation,
                                  {"x": x, "y": y}, layout)
    assert prt.last_plan["layout"] == layout
    _assert_equal(got, want)
    for out, ref in zip(got.values(), cs.secret_uint64_reference(x, y)):
        np.testing.assert_array_equal(out, ref)
