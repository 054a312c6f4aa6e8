"""Host dialect: plaintext kernels owned by a single host placement.

PyTorch counterpart of ``moose_tpu/dialects/host.py``: every kernel is a
function on the tensors of one host, on the session's device.  Ring
tensors are the ``(lo, hi)`` int64 words of ``ring.py``; bits are
``torch.uint8`` lanes of 0/1.  PRF keys and seeds are four u32 words,
derived on the host (``ring.mix_seed``, or the reference's blake3
construction under ``aes-ctr``) and expanded on the device by K7.

Four products run on the card's hand-written kernels: a ring ``Mul`` is
K4 (``ring_kernels.ring_mul``), a ring ``Dot`` or convolution K1
(``ring.matmul``), a replicated multiply's cross terms K3
(:func:`ring_cross_terms_mul`) and a replicated matrix product's K1
(:func:`ring_dot_cross_terms`).  Everything else is PyTorch's own.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import secrets
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import dtypes as dt
from ..execution.graphs import upload
from ..native import ring_kernels as rk
from ..values import (
    DeviceSeed,
    HostBitTensor,
    HostFixedTensor,
    HostPrfKey,
    HostRingTensor,
    HostSeed,
    HostShape,
    HostString,
    HostTensor,
    torch_dtype,
)
from . import ring

# ---------------------------------------------------------------------------
# Shapes, constants, identities
# ---------------------------------------------------------------------------


def place(x, plc: str):
    """Move/claim a value onto a host placement (a relabel in
    single-process execution)."""
    return dataclasses.replace(x, plc=plc) if hasattr(x, "plc") else x


def shape(x, plc: str) -> HostShape:
    if isinstance(x, HostRingTensor):
        return HostShape(tuple(x.lo.shape), plc)
    return HostShape(tuple(x.value.shape), plc)


def constant(value, plc: str, dtype: Optional[dt.DType], device):
    """Materialize a constant: a numpy array or scalar (at ``dtype``), a
    shape tuple or a string."""
    if isinstance(value, (HostTensor, HostRingTensor, HostBitTensor,
                          HostShape, HostString)):
        return place(value, plc)
    if isinstance(value, str):
        return HostString(value, plc)
    if isinstance(value, (tuple, list)) and dtype is None and all(
        isinstance(v, (int, np.integer)) for v in value
    ):
        return HostShape(tuple(int(v) for v in value), plc)
    arr = np.asarray(value)
    if dtype is not None and not dtype.is_fixedpoint:
        arr = arr.astype(np.dtype(dtype.numpy_name))
    if arr.dtype == np.bool_:
        return HostBitTensor(upload(arr.astype(np.uint8), device), plc)
    dtype = dt.from_numpy(arr.dtype)
    if dtype.name == "uint64":
        arr = arr.view(np.int64)
    return HostTensor(upload(arr, device), plc, dtype)


def fill(shp: HostShape, value, plc: str, ty_name: str, device):
    if ty_name.startswith("HostRing"):
        width = 128 if "128" in ty_name else 64
        lo, hi = ring.fill_like_shape(shp.value, width, int(value), device)
        return HostRingTensor(lo, hi, width, plc)
    if ty_name == "HostBitTensor":
        return HostBitTensor(
            torch.full(tuple(shp.value), int(value) & 1, dtype=torch.uint8,
                       device=device),
            plc,
        )
    raise NotImplementedError(f"fill for {ty_name}")


def ones(shp: HostShape, dtype: dt.DType, plc: str, device) -> HostTensor:
    return HostTensor(
        torch.ones(tuple(shp.value), dtype=torch_dtype(dtype),
                   device=device),
        plc, dtype,
    )


def zeros(shp: HostShape, dtype: dt.DType, plc: str, device) -> HostTensor:
    return HostTensor(
        torch.zeros(tuple(shp.value), dtype=torch_dtype(dtype),
                    device=device),
        plc, dtype,
    )


def ring_zeros(shp: HostShape, width: int, plc: str,
               device) -> HostRingTensor:
    lo, hi = ring.fill_like_shape(shp.value, width, 0, device)
    return HostRingTensor(lo, hi, width, plc)


def ring_constant(ints, width: int, plc: str, device) -> HostRingTensor:
    """Public ring tensor from an array of Python ints (mod 2^width), of
    any shape."""
    arr = np.asarray(ints, dtype=object)
    lo, hi = ring.from_python_ints(arr.reshape(-1), width, device)
    return HostRingTensor(
        lo.reshape(arr.shape),
        None if hi is None else hi.reshape(arr.shape), width, plc,
    )


# ---------------------------------------------------------------------------
# PRF keys & seeds (reference host/prim.rs)
# ---------------------------------------------------------------------------

# Deterministic sync-key streams: under MOOSE_TPU_FIXED_KEYS the
# interpreter pins the public nonces to a Philox stream, so two runs of
# one walk (and the JAX package's walk) see the same nonce sequence.
_SYNC_KEY_STREAM: "contextvars.ContextVar" = contextvars.ContextVar(
    "moose_tpu_torch_sync_key_stream", default=None
)


@contextlib.contextmanager
def deterministic_sync_keys(seed: int):
    """Within the context, :func:`random_sync_key` draws from a numpy
    Philox stream seeded by ``seed`` instead of OS entropy."""
    rng = np.random.Generator(np.random.Philox(int(seed)))
    token = _SYNC_KEY_STREAM.set(rng)
    try:
        yield
    finally:
        _SYNC_KEY_STREAM.reset(token)


def random_sync_key() -> bytes:
    """A fresh public nonce identifying one seed derivation (reference
    SyncKey::random()): the next 16 bytes of the pinned stream, or OS
    entropy."""
    stream = _SYNC_KEY_STREAM.get()
    if stream is not None:
        return stream.bytes(16)
    return secrets.token_bytes(16)


def key_gen(plc: str, key_words) -> HostPrfKey:
    """A PRF key from session-provided entropy words (four u32)."""
    return HostPrfKey(tuple(int(w) & ring.MASK32 for w in key_words), plc)


def derive_seed(key: HostPrfKey, sync_key: bytes, plc: str,
                session_id: str = "") -> HostSeed:
    """A 128-bit seed from a PRF key and a public nonce: one
    ``ring.mix_seed`` of the key and the nonce's four u32 words, or under
    ``aes-ctr`` the reference's construction (blake3 derive_key of the
    key, then a keyed hash of ``session_id || sync_key``,
    host/prim.rs:123-147).  A key on the device (a lowered plan's) gives
    a :class:`~moose_tpu_torch.values.DeviceSeed` of the key and the
    nonce's words: K7 mixes them where it draws, and nothing is derived
    here."""
    words = tuple(int(w) for w in np.frombuffer(
        sync_key[:16].ljust(16, b"\0"), dtype=np.uint32))
    on_device = isinstance(key.value, torch.Tensor)
    if ring.get_prf_impl() == "aes-ctr":
        from ..crypto.aes_prng import derive_seed as reference_derive

        seed = tuple(int(w) for w in np.frombuffer(reference_derive(
            ring.seed_bytes(ring._concrete_seed(DeviceSeed(key.value))
                            if on_device else key.value),
            session_id, sync_key), dtype=np.uint32))
        if on_device:
            # the seed stays in the key's form, as the JAX package's
            # stays an array: a plan's jitted draw from it is refused
            return HostSeed(DeviceSeed(rk.key_tensor(seed, key.value.device)),
                            plc)
        return HostSeed(seed, plc)
    if on_device:
        return HostSeed(DeviceSeed(key.value, words), plc)
    return HostSeed(ring.mix_seed(key.value, words), plc)


def sample_uniform_seeded(shp: HostShape, seed: HostSeed, width: int,
                          plc: str, device) -> HostRingTensor:
    lo, hi = ring.sample_uniform_seeded(shp.value, seed.value, width, device)
    return HostRingTensor(lo, hi, width, plc)


def sample_bits_seeded(shp: HostShape, seed: HostSeed, width: int,
                       plc: str, device) -> HostRingTensor:
    """Uniform bits as ring words, from the bit-domain-tagged seed."""
    bits = ring.sample_bits_seeded(shp.value, seed.value, device)
    lo, hi = ring.from_bit(bits, width)
    return HostRingTensor(lo, hi, width, plc)


def sample_bit_tensor_seeded(shp: HostShape, seed: HostSeed, plc: str,
                             device) -> HostBitTensor:
    """Uniform bits from the untagged seed (see
    ``ring.sample_bit_tensor_seeded``)."""
    return HostBitTensor(
        ring.sample_bit_tensor_seeded(shp.value, seed.value, device), plc)


# ---------------------------------------------------------------------------
# Ring tensor kernels
# ---------------------------------------------------------------------------


def _ring2(fn):
    def kernel(x: HostRingTensor, y: HostRingTensor,
               plc: str) -> HostRingTensor:
        lo, hi = fn(x.lo, x.hi, y.lo, y.hi)
        return HostRingTensor(lo, hi, x.width, plc)

    return kernel


ring_add = _ring2(ring.add)
ring_sub = _ring2(ring.sub)


def _full(t: Optional[torch.Tensor], shp) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if tuple(t.shape) != tuple(shp):
        t = t.expand(shp)
    return t.contiguous()


def ring_mul(x: HostRingTensor, y: HostRingTensor,
             plc: str) -> HostRingTensor:
    """Elementwise ring product with numpy broadcasting: K4 on the card,
    the factor at the result's shape read whole and the other at its own
    shape, broadcast in the kernel."""
    out = torch.broadcast_shapes(x.lo.shape, y.lo.shape)
    a, b = (x, y) if tuple(x.lo.shape) == tuple(out) else (y, x)
    lo, hi = rk.ring_mul(_full(a.lo, out), _full(a.hi, out), b.lo, b.hi,
                         x.width)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_cross_terms_mul(x0: HostRingTensor, x1: HostRingTensor,
                         y0: HostRingTensor, y1: HostRingTensor,
                         plc: str) -> HostRingTensor:
    """One party's cross terms of a secure multiply,
    ``x0 * (y0 + y1) + x1 * y0`` (K3 on the card), broadcast."""
    out = torch.broadcast_shapes(x0.lo.shape, x1.lo.shape, y0.lo.shape,
                                 y1.lo.shape)
    pairs = [(_full(t.lo, out), _full(t.hi, out)) for t in (x0, x1, y0, y1)]
    lo, hi = rk.cross_terms_mul(*pairs, x0.width)
    return HostRingTensor(lo, hi, x0.width, plc)


def ring_dot_cross_terms(x0: HostRingTensor, x1: HostRingTensor,
                         y0: HostRingTensor, y1: HostRingTensor,
                         plc: str) -> HostRingTensor:
    """One party's cross terms of a secure matrix product,
    ``x0 @ (y0 + y1) + x1 @ y0`` (K1 at one party on the card)."""
    lo, hi = ring.dot_cross_terms((x0.lo, x0.hi), (x1.lo, x1.hi),
                                  (y0.lo, y0.hi), (y1.lo, y1.hi), x0.width)
    return HostRingTensor(lo, hi, x0.width, plc)


def ring_conv_cross_terms(x0: HostRingTensor, x1: HostRingTensor,
                          k0: HostRingTensor, k1: HostRingTensor, strides,
                          padding, plc: str) -> HostRingTensor:
    """One party's cross terms of a secure convolution: the im2col
    columns of ``x0`` and ``x1`` against the kernel matrices, through
    :func:`ring_dot_cross_terms`, reshaped to (N, OH, OW, O)."""
    kshape = tuple(k0.lo.shape)
    c0, (n, oh, ow) = ring.conv_columns(x0.lo, x0.hi, kshape, strides,
                                        padding)
    c1, _ = ring.conv_columns(x1.lo, x1.hi, kshape, strides, padding)
    lo, hi = ring.dot_cross_terms(
        c0, c1, ring.kernel_matrix(k0.lo, k0.hi),
        ring.kernel_matrix(k1.lo, k1.hi), x0.width)
    o = kshape[-1]
    return HostRingTensor(
        lo.reshape(n, oh, ow, o),
        None if hi is None else hi.reshape(n, oh, ow, o), x0.width, plc)


def ring_trunc_combine(a0: HostRingTensor, a1: HostRingTensor, draws,
                       amount: int):
    """K2's ``trunc_combine``: the tail of the additive truncation from
    the 2-party sharing (a0, a1) and its five draws (r, m_r, m_rt, m_rm,
    z0, host ring tensors).  Returns the (3, *shape) words (z0, z1, y1)
    of the replicated result as three (lo, hi) pairs."""
    width = a0.width

    def pair(t):
        return t.lo.contiguous(), (
            None if t.hi is None else t.hi.contiguous())

    lo, hi = rk.trunc_combine(pair(a0), pair(a1),
                              tuple(pair(d) for d in draws), width, amount)
    return tuple((lo[i], None if hi is None else hi[i]) for i in range(3))


def ring_neg(x: HostRingTensor, plc: str) -> HostRingTensor:
    lo, hi = ring.neg(x.lo, x.hi)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_dot(x: HostRingTensor, y: HostRingTensor,
             plc: str) -> HostRingTensor:
    lo, hi = ring.matmul(x.lo, x.hi, y.lo, y.hi)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_sum(x: HostRingTensor, axis, plc: str) -> HostRingTensor:
    lo, hi = ring.sum_(x.lo, x.hi, axis)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_conv2d(x: HostRingTensor, k: HostRingTensor, strides, padding,
                plc: str) -> HostRingTensor:
    """Exact ring convolution: NHWC input * HWIO kernel (im2col and the
    ring matrix product)."""
    lo, hi = ring.conv2d(x.lo, x.hi, k.lo, k.hi, strides, padding)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_im2col(x: HostRingTensor, kh: int, kw: int, strides, padding,
                plc: str) -> HostRingTensor:
    """Patch extraction on ring tensors: (N,H,W,C) -> (N,OH,OW,KH*KW*C)."""
    lo, _, _ = ring.im2col(x.lo, kh, kw, strides, padding)
    hi = None
    if x.hi is not None:
        hi, _, _ = ring.im2col(x.hi, kh, kw, strides, padding)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_shl(x: HostRingTensor, amount: int, plc: str) -> HostRingTensor:
    lo, hi = ring.shl(x.lo, x.hi, amount)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_shr(x: HostRingTensor, amount: int, plc: str) -> HostRingTensor:
    lo, hi = ring.shr(x.lo, x.hi, amount)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_shr_arith(x: HostRingTensor, amount: int,
                   plc: str) -> HostRingTensor:
    lo, hi = ring.shr_arith(x.lo, x.hi, amount)
    return HostRingTensor(lo, hi, x.width, plc)


def ring_bit_extract(x: HostRingTensor, bit_idx: int,
                     plc: str) -> HostBitTensor:
    return HostBitTensor(ring.bit_extract(x.lo, x.hi, bit_idx), plc)


def ring_inject(b: HostBitTensor, bit_idx: int, width: int,
                plc: str) -> HostRingTensor:
    lo, hi = ring.from_bit(b.value, width)
    lo, hi = ring.shl(lo, hi, bit_idx)
    return HostRingTensor(lo, hi, width, plc)


def _word_bits(word: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(64, dtype=torch.int64, device=word.device)
    shifts = shifts.reshape((64,) + (1,) * word.dim())
    return torch.bitwise_and(word[None, ...] >> shifts, 1).to(torch.uint8)


def ring_decompose_bits(x: HostRingTensor, plc: str) -> HostBitTensor:
    """All bits of a ring tensor on a new leading axis (BitDecompose),
    least significant first."""
    bits = _word_bits(x.lo)
    if x.width == 128:
        bits = torch.cat([bits, _word_bits(x.hi)], dim=0)
    return HostBitTensor(bits, plc)


def ring_compose_bits(b: HostBitTensor, width: int,
                      plc: str) -> HostRingTensor:
    """Inverse of :func:`ring_decompose_bits` (BitCompose): the weighted
    sum over the leading bit axis."""
    bits = b.value.to(torch.int64)
    shifts = torch.arange(64, dtype=torch.int64, device=bits.device)
    shifts = shifts.reshape((64,) + (1,) * (bits.dim() - 1))
    n_lo = min(width, 64)
    lo = torch.sum(bits[:64] << shifts[:n_lo], dim=0)
    if width == 64:
        return HostRingTensor(lo, None, width, plc)
    hi = torch.sum(bits[64:128] << shifts, dim=0)
    return HostRingTensor(lo, hi, width, plc)


# Structural ops shared by ring, bit and plaintext tensors ------------------


def strided_index(a: torch.Tensor, spec) -> torch.Tensor:
    """numpy's basic indexing ``a[spec]`` (slices with any step, ints,
    None, one Ellipsis) on a torch tensor, which has no negative-step
    slicing: a negative step gathers the indices it names."""
    spec = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
    if any(s is Ellipsis for s in spec):
        i = spec.index(Ellipsis)
        used = sum(1 for s in spec if s is not Ellipsis and s is not None)
        spec = spec[:i] + (slice(None),) * (a.dim() - used) + spec[i + 1:]
    out, dim = a, 0
    for s in spec:
        if s is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(s, slice):
            start, stop, step = s.indices(out.shape[dim])
            if step > 0:
                out = out[(slice(None),) * dim + (slice(start, stop, step),)]
            else:
                idx = torch.arange(start, stop, step, device=out.device)
                out = out.index_select(dim, idx)
            dim += 1
        else:
            out = out.select(dim, int(s))
    return out


def _map(x, fn, plc: str):
    """Apply a tensor transform to any host tensor kind (both words of a
    ring tensor), the result contiguous."""
    def g(a):
        return fn(a).contiguous()

    if isinstance(x, HostRingTensor):
        return HostRingTensor(g(x.lo), None if x.hi is None else g(x.hi),
                              x.width, plc)
    if isinstance(x, HostBitTensor):
        return HostBitTensor(g(x.value), plc)
    return HostTensor(g(x.value), plc, x.dtype)


def expand_dims(x, plc: str, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)

    def fn(a):
        rank = a.dim() + len(axes)
        for ax in sorted(ax % rank for ax in axes):
            a = a.unsqueeze(ax)
        return a

    return _map(x, fn, plc)


def squeeze(x, plc: str, axis=None):
    if axis is None:
        return _map(x, torch.squeeze, plc)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return _map(x, lambda a: torch.squeeze(a, axes), plc)


def transpose(x, plc: str, axes=None):
    def fn(a):
        order = tuple(range(a.dim()))[::-1] if axes is None else tuple(axes)
        return a.permute(order)

    return _map(x, fn, plc)


def reshape(x, shp: HostShape, plc: str):
    return _map(x, lambda a: a.reshape(tuple(shp.value)), plc)


def index_axis(x, axis: int, index: int, plc: str):
    return _map(x, lambda a: a.select(axis, index), plc)


def slice_(x, begin, end, plc: str):
    if isinstance(x, HostShape):
        return HostShape(x.value[begin[0]:end[0]], plc)
    spec = tuple(slice(b, e) for b, e in zip(begin, end))
    return _map(x, lambda a: strided_index(a, spec), plc)


def strided_slice(x, slices, plc: str):
    return _map(x, lambda a: strided_index(a, slices), plc)


def concat(xs: Sequence, axis: int, plc: str):
    x0 = xs[0]
    if isinstance(x0, HostRingTensor):
        lo = torch.cat([x.lo for x in xs], dim=axis)
        hi = (torch.cat([x.hi for x in xs], dim=axis)
              if x0.hi is not None else None)
        return HostRingTensor(lo, hi, x0.width, plc)
    if isinstance(x0, HostBitTensor):
        return HostBitTensor(torch.cat([x.value for x in xs], dim=axis), plc)
    return HostTensor(torch.cat([x.value for x in xs], dim=axis), plc,
                      x0.dtype)


def broadcast(x, shp: HostShape, plc: str):
    return _map(x, lambda a: torch.broadcast_to(a, tuple(shp.value)), plc)


def diag(x, plc: str):
    return _map(x, torch.diag, plc)


def shl_dim(x, amount: int, bit_length: int, plc: str):
    """Shift the leading (bit) axis by ``amount`` positions, filling with
    zeros (reference ShlDim)."""
    return _map(x, lambda a: torch.cat(
        [torch.zeros_like(a[:amount]), a[:bit_length - amount]], dim=0), plc)


def at_least_2d(x: HostTensor, to_column_vector: bool,
                plc: str) -> HostTensor:
    v = x.value
    if v.dim() == 0:
        v = v.reshape(1, 1)
    elif v.dim() == 1:
        v = v.reshape(1, -1)
        if to_column_vector:
            v = v.T.contiguous()
    return HostTensor(v, plc, x.dtype)


# ---------------------------------------------------------------------------
# Bit tensor kernels
# ---------------------------------------------------------------------------


def bit_xor(x: HostBitTensor, y: HostBitTensor, plc: str) -> HostBitTensor:
    return HostBitTensor(torch.bitwise_xor(x.value, y.value), plc)


def bit_and(x: HostBitTensor, y: HostBitTensor, plc: str) -> HostBitTensor:
    return HostBitTensor(torch.bitwise_and(x.value, y.value), plc)


def bit_or(x: HostBitTensor, y: HostBitTensor, plc: str) -> HostBitTensor:
    return HostBitTensor(torch.bitwise_or(x.value, y.value), plc)


def bit_neg(x: HostBitTensor, plc: str) -> HostBitTensor:
    return HostBitTensor(torch.bitwise_xor(x.value, 1), plc)


# ---------------------------------------------------------------------------
# Plaintext float/int kernels
# ---------------------------------------------------------------------------


def _f2(fn):
    def kernel(x: HostTensor, y: HostTensor, plc: str) -> HostTensor:
        return HostTensor(fn(x.value, y.value), plc, x.dtype)

    return kernel


add = _f2(torch.add)
sub = _f2(torch.sub)
mul = _f2(torch.mul)
div = _f2(torch.div)


def dot(x: HostTensor, y: HostTensor, plc: str) -> HostTensor:
    return HostTensor(torch.matmul(x.value, y.value), plc, x.dtype)


def _nchw_padded(v: torch.Tensor, kh, kw, strides, padding, value):
    """An NHWC tensor as NCHW, padded as ``padding`` says (a string or
    explicit pairs) with ``value``."""
    n, h, w, c = v.shape
    (p0, p1), (q0, q1) = ring.resolve_padding(padding, h, w, kh, kw,
                                              *strides)
    v = v.permute(0, 3, 1, 2)
    if p0 or p1 or q0 or q1:
        v = F.pad(v, (q0, q1, p0, p1), value=value)
    return v


def conv2d(x: HostTensor, k: HostTensor, strides, padding,
           plc: str) -> HostTensor:
    """Plaintext convolution: NHWC input * HWIO kernel."""
    kh, kw = k.value.shape[:2]
    strides = tuple(strides)
    v = _nchw_padded(x.value, kh, kw, strides, padding, 0.0)
    out = F.conv2d(v, k.value.permute(3, 2, 0, 1), stride=strides)
    return HostTensor(out.permute(0, 2, 3, 1).contiguous(), plc, x.dtype)


def _pool2d(x: HostTensor, pool, strides, padding, plc: str, init,
            pool_fn) -> HostTensor:
    strides = tuple(strides) if strides is not None else tuple(pool)
    v = _nchw_padded(x.value, pool[0], pool[1], strides, padding, init)
    out = pool_fn(v, tuple(pool), stride=strides)
    return HostTensor(out.permute(0, 2, 3, 1).contiguous(), plc, x.dtype)


def avg_pool2d(x: HostTensor, pool, strides, padding,
               plc: str) -> HostTensor:
    """The window sum over the taps, padding included (zeros), divided
    by the taps, as the reference's reduce-window pool."""
    return _pool2d(x, pool, strides, padding, plc, 0.0, F.avg_pool2d)


def max_pool2d(x: HostTensor, pool, strides, padding,
               plc: str) -> HostTensor:
    return _pool2d(x, pool, strides, padding, plc, -math.inf, F.max_pool2d)


def neg_(x: HostTensor, plc: str) -> HostTensor:
    return HostTensor(-x.value, plc, x.dtype)


def _axis(x: HostTensor, axis):
    ring.check_axis(x.value.dim(), axis)
    return tuple(axis) if isinstance(axis, (tuple, list)) else axis


def sum_(x: HostTensor, axis, plc: str) -> HostTensor:
    return HostTensor(torch.sum(x.value, dim=_axis(x, axis)), plc, x.dtype)


def mean(x: HostTensor, axis, plc: str) -> HostTensor:
    return HostTensor(torch.mean(x.value, dim=_axis(x, axis)), plc,
                      x.dtype)


def _f1(fn):
    def kernel(x: HostTensor, plc: str) -> HostTensor:
        return HostTensor(fn(x.value), plc, x.dtype)

    return kernel


exp = _f1(torch.exp)
log = _f1(torch.log)
log2 = _f1(torch.log2)
sqrt = _f1(torch.sqrt)
sigmoid = _f1(torch.sigmoid)
relu = _f1(torch.relu)
abs_ = _f1(torch.abs)
sign = _f1(torch.sign)
pow2 = _f1(torch.exp2)
inverse = _f1(torch.linalg.inv)


def softmax(x: HostTensor, axis: int, plc: str) -> HostTensor:
    return HostTensor(torch.softmax(x.value, dim=_axis(x, axis)), plc,
                      x.dtype)


def _ordered(x: HostTensor):
    """Words that order as ``x``'s values: a uint64 tensor's int64 words
    with the sign bit flipped, anything else as it is."""
    if x.dtype is not None and x.dtype.name == "uint64":
        return torch.bitwise_xor(x.value, ring.SIGN64)
    return x.value


def argmax(x: HostTensor, axis: int, plc: str) -> HostTensor:
    """Indices as uint64 (their int64 words)."""
    return HostTensor(torch.argmax(_ordered(x), dim=_axis(x, axis)), plc,
                      dt.uint64)


def maximum(xs: Sequence[HostTensor], plc: str) -> HostTensor:
    out = _ordered(xs[0])
    for x in xs[1:]:
        out = torch.maximum(out, _ordered(x))
    if xs[0].dtype is not None and xs[0].dtype.name == "uint64":
        out = torch.bitwise_xor(out, ring.SIGN64)
    return HostTensor(out, plc, xs[0].dtype)


def less(x: HostTensor, y: HostTensor, plc: str) -> HostBitTensor:
    return HostBitTensor((_ordered(x) < _ordered(y)).to(torch.uint8), plc)


def greater(x: HostTensor, y: HostTensor, plc: str) -> HostBitTensor:
    return HostBitTensor((_ordered(x) > _ordered(y)).to(torch.uint8), plc)


def equal(x, y, plc: str) -> HostBitTensor:
    if isinstance(x, HostRingTensor):
        return HostBitTensor(ring.equal_bits(x.lo, x.hi, y.lo, y.hi), plc)
    return HostBitTensor((x.value == y.value).to(torch.uint8), plc)


def mux(s: HostBitTensor, x: HostTensor, y: HostTensor,
        plc: str) -> HostTensor:
    return HostTensor(torch.where(s.value.bool(), x.value, y.value), plc,
                      x.dtype)


def select(x, axis: int, index: HostBitTensor, plc: str):
    """Entries along ``axis`` where the boolean mask is set (reference
    SelectOp, host/ops.rs:605); the output shape depends on the data."""
    keep = torch.nonzero(index.value.reshape(-1).bool()).reshape(-1)
    if isinstance(x, HostFixedTensor):
        return HostFixedTensor(select(x.tensor, axis, index, plc),
                               x.integral_precision, x.fractional_precision)

    def fn(a):
        # numpy's compress, which the reference runs, takes a 0-d
        # tensor as one of shape (1,)
        return a.reshape(a.shape or (1,)).index_select(axis,
                                                        keep.to(a.device))

    return _map(x, fn, plc)


def cast(x, target: dt.DType, plc: str):
    if isinstance(x, HostBitTensor):
        if target.is_boolean:
            return x
        return HostTensor(x.value.to(torch_dtype(target)), plc, target)
    if target.is_boolean:
        return HostBitTensor((x.value != 0).to(torch.uint8), plc)
    value = x.value
    if x.dtype.name == "uint64" and target.is_float:
        # the int64 words hold uint64 values
        value = ring.u64_to_float64(value)
    elif x.dtype.is_float and target.name == "uint64":
        # a value at or beyond 2^63 takes the int64 word of its uint64
        value = value.to(torch.float64)
        big = value >= 2.0 ** 63
        return HostTensor(
            torch.where(big, value - 2.0 ** 64, value).to(torch.int64),
            plc, target)
    return HostTensor(value.to(torch_dtype(target)), plc, target)


def cast_ring_lo(x: HostRingTensor, target: dt.DType,
                 plc: str) -> HostTensor:
    """Cast the low words of ring values, read as uint64 (small
    non-negative values, such as a revealed Argmax index), to
    ``target``."""
    value = ring.u64_to_float64(x.lo) if target.is_float else x.lo
    return HostTensor(value.to(torch_dtype(target)), plc, target)


# ---------------------------------------------------------------------------
# Fixed-point encode/decode on host (reference host/fixedpoint.rs)
# ---------------------------------------------------------------------------


def ring_fixedpoint_encode(x: HostTensor, frac_precision: int, width: int,
                           plc: str) -> HostRingTensor:
    signed = None if x.dtype is None else x.dtype.name != "uint64"
    lo, hi = ring.fixedpoint_encode(x.value, frac_precision, width, signed)
    return HostRingTensor(lo, hi, width, plc)


def ring_fixedpoint_decode(x: HostRingTensor, frac_precision: int, plc: str,
                           dtype: dt.DType = dt.float64) -> HostTensor:
    v = ring.fixedpoint_decode(x.lo, x.hi, frac_precision)
    return HostTensor(v.to(torch_dtype(dtype)), plc, dtype)


def fixedpoint_encode(x: HostTensor, integ: int, frac: int, width: int,
                      plc: str) -> HostFixedTensor:
    return HostFixedTensor(ring_fixedpoint_encode(x, frac, width, plc),
                           integ, frac)


def fixedpoint_decode(x: HostFixedTensor, plc: str,
                      dtype: dt.DType = dt.float64) -> HostTensor:
    return ring_fixedpoint_decode(x.tensor, x.fractional_precision, plc,
                                  dtype)


def ring_fixedpoint_mean(x: HostRingTensor, axis, frac_precision: int,
                         plc: str) -> HostRingTensor:
    """Fixed-point mean (reference RingFixedpointMean): the sum over
    ``axis`` times ``round(2^frac / n)`` (K4 on the card, the factor
    broadcast in the kernel).  The result is one fixed-point scale too
    high; every caller truncates by ``frac_precision``."""
    s = ring_sum(x, axis, plc)
    n = x.lo.shape[axis] if axis is not None else x.lo.numel()
    factor = int(round((2.0 ** frac_precision) / n))
    flo, fhi = ring.fill_like_shape((), x.width, factor, x.lo.device)
    lo, hi = rk.ring_mul(s.lo, s.hi, flo, fhi, x.width)
    return HostRingTensor(lo, hi, x.width, plc)
