"""Secure convolution and pooling of the port against moose_tpu on the
CPU: ``ring.im2col`` and the padding helpers, ``spmd.conv2d`` and
``fx_conv2d`` (im2col, then the secure dot's kernel), the pools
``fx_avg_pool2d`` and ``fx_max_pool2d`` (the max pool's tournament along
the taps axis), vector operands of the secure dot, ``fx_mean_rows`` and
``derive_step_keys``.  Under one master key both packages draw the same
masks, under both threefry streams, so the shares agree word for word;
the decoded results are also held to a float64 convolution in numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moose_tpu.dialects import ring as jring
from moose_tpu.errors import KernelError as JaxKernelError
from moose_tpu.parallel import spmd as jspmd
from moose_tpu.parallel import spmd_math as jsm

from moose_tpu_torch.dialects import ring as tring
from moose_tpu_torch.errors import ConfigurationError, KernelError
from moose_tpu_torch.native import ring_kernels as rk
from moose_tpu_torch.parallel import spmd as tspmd
from moose_tpu_torch.parallel import spmd_math as tsm

from torch_parity import (  # noqa: F401  (fixture)
    assert_words_equal,
    prf,
    rand_words,
    threefry,
    to_jax,
    to_port,
)

MK = np.array([0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D], np.uint32)
STREAMS = ("threefry", "threefry-pallas")
PADDINGS = ("VALID", "SAME", ((1, 0), (2, 1)))
# (width, (integral, fractional) precision)
PRECISIONS = ((128, (24, 40)), (64, (14, 23)))


def _sessions():
    return jspmd.SpmdSession(MK), tspmd.SpmdSession(MK, "cpu")


def _assert_rep(got, want, label):
    assert got.width == want.width
    assert_words_equal((got.lo, got.hi), (want.lo, want.hi), label)


def _share_fixed(sessions, x, width, precision):
    """The float array ``x`` encoded and shared in both packages."""
    js, ts = sessions
    return (
        jspmd.fx_encode_share(js, jnp.asarray(x), *precision, width),
        tspmd.fx_encode_share(ts, torch.as_tensor(x), *precision, width),
    )


def _conv_reference(x, k, strides, padding):
    """float64 NHWC x HWIO convolution."""
    n, h, w, _ = x.shape
    kh, kw, _, o = k.shape
    (p0, p1), (q0, q1) = tring.resolve_padding(padding, h, w, kh, kw,
                                               *strides)
    xp = np.pad(x, ((0, 0), (p0, p1), (q0, q1), (0, 0)))
    oh = tring.conv_out_size(h, kh, strides[0], p0, p1)
    ow = tring.conv_out_size(w, kw, strides[1], q0, q1)
    out = np.zeros((n, oh, ow, o))
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + (oh - 1) * strides[0] + 1:strides[0],
                     j:j + (ow - 1) * strides[1] + 1:strides[1]]
            out += win @ k[i, j]
    return out


@pytest.mark.parametrize("width", (64, 128))
@pytest.mark.parametrize("strides", ((1, 1), (2, 2)))
@pytest.mark.parametrize("padding", PADDINGS, ids=str)
def test_im2col_matches_the_reference(width, strides, padding):
    # a (3, 2) kernel: the taps' (i, j) order shows
    lo, hi = rand_words(np.random.default_rng(width + strides[0]),
                        (2, 5, 6, 3), width)
    t_lo, t_hi = to_port((lo, hi))
    for jword, tword in ((lo, t_lo), (hi, t_hi)):
        if jword is None:
            continue
        want, jh, jw = jring.im2col(jnp.asarray(jword), 3, 2, strides,
                                    padding)
        got, th, tw = tring.im2col(tword, 3, 2, strides, padding)
        assert (th, tw) == (jh, jw)
        assert_words_equal((got, None), (want, None), f"im2col {padding}")


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width", (64, 128))
def test_conv2d_matches_the_reference(stream, width):
    rng = np.random.default_rng(width)
    x = rand_words(rng, (2, 5, 5, 2), width)
    k = rand_words(rng, (3, 3, 2, 3), width)
    with prf(stream):
        js, ts = _sessions()
        jx, jk = (jspmd.share(js, *to_jax(a), width) for a in (x, k))
        tx, tk = (tspmd.share(ts, *to_port(a), width) for a in (x, k))
        want = jspmd.conv2d(js, jx, jk, (1, 1), "SAME")
        got = tspmd.conv2d(ts, tx, tk, (1, 1), "SAME")
    assert got.shape == (2, 5, 5, 3)
    _assert_rep(got, want, "conv2d")


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,precision,strides,padding", (
    PRECISIONS[0] + ((1, 1), ((1, 1), (1, 1))),
    PRECISIONS[1] + ((2, 1), "VALID"),
), ids=("ring128", "ring64"))
def test_fx_conv2d_matches_the_reference(stream, width, precision, strides,
                                         padding):
    rng = np.random.default_rng(precision[1])
    x = rng.normal(size=(2, 6, 5, 3)) * 0.5
    k = rng.normal(size=(3, 3, 3, 4)) * 0.3
    with prf(stream):
        sessions = _sessions()
        (jx, tx), (jk, tk) = (_share_fixed(sessions, a, width, precision)
                              for a in (x, k))
        js, ts = sessions
        counter = ts._counter
        got = tspmd.fx_conv2d(ts, tx, tk, strides, padding)
        # one group: the zero-share bank and the five truncation draws
        assert ts._counter == counter + 6
        want = jspmd.fx_conv2d(js, jx, jk, strides, padding)
    _assert_rep(got.tensor, want.tensor, "fx_conv2d")
    assert (got.integral_precision, got.fractional_precision) == precision
    out = tspmd.fx_reveal_decode(got).numpy()
    assert np.abs(out - _conv_reference(x, k, strides, padding)).max() \
        < 2.0 ** -(precision[1] - 8)


POOLS = (
    # (kind, pool, strides, padding): 2x2 windows at their default
    # strides, as the ResNet pools; a padded 3x3 average at stride 1
    ("avg", (2, 2), None, "VALID"),
    ("avg", (3, 3), (1, 1), "SAME"),
    ("max", (2, 2), None, "VALID"),
)
# the pools' input; the padded max pool's, padded by one row and column,
# gives the tournament the 2x2 max pool's shapes
POOL_SHAPE = (2, 4, 6, 3)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("kind,pool,strides,padding", POOLS, ids=str)
def test_pools_match_the_reference(stream, kind, pool, strides, padding):
    width, precision = PRECISIONS[0]
    x = np.random.default_rng(sum(pool)).normal(size=POOL_SHAPE)
    with prf(stream):
        sessions = _sessions()
        jx, tx = _share_fixed(sessions, x, width, precision)
        js, ts = sessions
        tfn, jfn = ((tsm.fx_avg_pool2d, jsm.fx_avg_pool2d) if kind == "avg"
                    else (tsm.fx_max_pool2d, jsm.fx_max_pool2d))
        got = tfn(ts, tx, pool, strides, padding)
        want = jfn(js, jx, pool, strides, padding)
    _assert_rep(got.tensor, want.tensor, f"{kind} pool {pool}")
    # a pool is a convolution of each channel with one window
    c = x.shape[-1]
    window = np.zeros(pool + (c, c))
    for ch in range(c):
        window[..., ch, ch] = 1.0
    ref_strides = pool if strides is None else strides
    if kind == "avg":
        ref = _conv_reference(x, window / (pool[0] * pool[1]), ref_strides,
                              padding)
    else:
        n, h, w, _ = x.shape
        oh = tring.conv_out_size(h, pool[0], ref_strides[0], 0, 0)
        ow = tring.conv_out_size(w, pool[1], ref_strides[1], 0, 0)
        ref = np.stack([
            x[:, i:i + (oh - 1) * ref_strides[0] + 1:ref_strides[0],
              j:j + (ow - 1) * ref_strides[1] + 1:ref_strides[1]]
            for i in range(pool[0]) for j in range(pool[1])
        ]).max(axis=0)
    out = tspmd.fx_reveal_decode(got).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 2.0 ** -(precision[1] - 8)


def test_padded_max_pool_is_refused_as_the_reference_refuses_it(
        monkeypatch):
    args = (4, 4, 2, 2, 1, 1)
    with pytest.raises(JaxKernelError) as want:
        jring.check_maxpool_padding("SAME", *args)
    with pytest.raises(KernelError) as got:
        tring.check_maxpool_padding("SAME", *args)
    assert str(got.value) == str(want.value)
    assert "MOOSE_TPU_MAXPOOL_ZERO_PAD=1" in str(got.value)
    # VALID, or a padding that resolves to none, passes
    tring.check_maxpool_padding("VALID", *args)
    tring.check_maxpool_padding(((0, 0), (0, 0)), *args)
    x = np.random.default_rng(3).normal(size=(1, 4, 4, 2))
    sessions = _sessions()
    _, tx = _share_fixed(sessions, x, *PRECISIONS[0])
    with pytest.raises(KernelError, match="ZERO_PAD"):
        tsm.fx_max_pool2d(sessions[1], tx, (2, 2), (1, 1), "SAME")


def test_the_zero_pad_escape_runs_the_padded_max_pool(threefry,
                                                      monkeypatch):
    monkeypatch.setenv("MOOSE_TPU_MAXPOOL_ZERO_PAD", "1")
    width, precision = PRECISIONS[0]
    # non-negative: zero padding then equals the usual -inf padding
    n, h, w, c = POOL_SHAPE
    x = np.abs(np.random.default_rng(4).normal(size=(n, h - 1, w - 1, c)))
    sessions = _sessions()
    jx, tx = _share_fixed(sessions, x, width, precision)
    js, ts = sessions
    got = tsm.fx_max_pool2d(ts, tx, (2, 2), None, "SAME")
    want = jsm.fx_max_pool2d(js, jx, (2, 2), None, "SAME")
    _assert_rep(got.tensor, want.tensor, "padded max pool")
    padded = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    ref = padded.reshape(n, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))
    out = tspmd.fx_reveal_decode(got).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 2.0 ** -(precision[1] - 8)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("shapes", (((4, 3), (3,)), ((3,), (3, 5)),
                                    ((3,), (3,))), ids=str)
def test_vector_dot_matches_the_reference(stream, shapes):
    """Vector operands are promoted to matrices for K1 and squeezed from
    its result; the bank and the truncation draws are at the squeezed
    shape, as the reference draws them."""
    width, precision = PRECISIONS[0]
    rng = np.random.default_rng(len(shapes[0]) + 2 * len(shapes[1]))
    x, y = rng.normal(size=shapes[0]), rng.normal(size=shapes[1])
    want_shape = np.matmul(x, y).shape
    with prf(stream):
        sessions = _sessions()
        (jx, tx), (jy, ty) = (_share_fixed(sessions, a, width, precision)
                              for a in (x, y))
        js, ts = sessions
        got = tspmd.fx_dot(ts, tx, ty)
        want = jspmd.fx_dot(js, jx, jy)
        plain = tspmd.dot(ts, tx.tensor, ty.tensor)
        plain_want = jspmd.dot(js, jx.tensor, jy.tensor)
    assert got.tensor.shape == want_shape
    _assert_rep(got.tensor, want.tensor, f"fx_dot {shapes}")
    _assert_rep(plain, plain_want, f"dot {shapes}")
    assert np.abs(tspmd.fx_reveal_decode(got).numpy() - x @ y).max() < 1e-9


def test_dot_refuses_operands_of_higher_rank():
    sess = tspmd.SpmdSession(MK, "cpu")
    x = tspmd.share(sess, torch.zeros((2, 3, 4), dtype=torch.int64), None,
                    64)
    with pytest.raises(ValueError, match="cannot contract"):
        tspmd.dot(sess, x, x)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("width,precision", PRECISIONS)
def test_fx_mean_rows_matches_the_reference(stream, width, precision):
    x = np.random.default_rng(5).normal(size=(6, 3))
    with prf(stream):
        sessions = _sessions()
        jx, tx = _share_fixed(sessions, x, width, precision)
        js, ts = sessions
        got = tspmd.fx_mean_rows(ts, tx)
        want = jspmd.fx_mean_rows(js, jx)
    _assert_rep(got.tensor, want.tensor, "fx_mean_rows")
    assert np.abs(tspmd.fx_reveal_decode(got).numpy()
                  - x.mean(axis=0)).max() < 2.0 ** -(precision[1] - 4)


@pytest.mark.parametrize("salt", (0x9E3779B9, 0x85EBCA6B))
def test_derive_step_keys_gives_the_reference_s_words(salt):
    want = np.asarray(jspmd.derive_step_keys(MK, 7, salt))
    got = tspmd.derive_step_keys(MK, 7, salt, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (7, 4)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 32


def test_derive_step_keys_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        tspmd.derive_step_keys(MK, 2)


def test_the_cpu_runs_no_kernel(threefry):
    width, precision = PRECISIONS[0]
    rng = np.random.default_rng(6)
    sessions = _sessions()
    (_, tx), (_, tk) = (
        _share_fixed(sessions, a, width, precision)
        for a in (rng.normal(size=(1, 4, 4, 2)),
                  rng.normal(size=(2, 2, 2, 2)))
    )
    before = dict(rk.LAUNCHES)
    out = tspmd.fx_conv2d(sessions[1], tx, tk)
    tsm.fx_max_pool2d(sessions[1], out, (3, 3))
    assert rk.LAUNCHES == before
