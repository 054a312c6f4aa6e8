"""Sessions: the host-primitive interface the dialects are written against.

PyTorch counterpart of ``moose_tpu/execution/session.py``: protocol
kernels (``dialects/replicated.py``, ``additive.py``, ``fixedpoint.py``,
``mirrored.py``) are compositions of these methods and never touch
tensors directly.  Every method takes the host placement name the op is
pinned to and runs the host kernel of ``dialects/host.py`` on the
session's device.
"""

from __future__ import annotations

import secrets
from typing import Optional

import numpy as np

import torch

from .. import dtypes as dt
from ..dialects import host, ring
from ..values import (
    HostBitTensor,
    HostFixedTensor,
    HostPrfKey,
    HostRingTensor,
    HostSeed,
    HostShape,
)


class EagerSession:
    """Direct execution of host kernels on ``device`` (reference
    SyncSession, execution/synchronous.rs:20-27).

    ``master_key`` (four u32 words) seeds PRF-key generation: the i-th
    :meth:`key_gen` derives its key from the master key and the i-th
    nonce of ``key_domain``, as the JAX package's session does, so both
    draw the same keys from the same master key.  Without one, the
    master key is drawn from OS entropy at the first key."""

    # replicated.trunc_pr runs its tail after the draws in one
    # trunc_combine (K2 on the card); the symbolic session does not
    fused_trunc = True

    def __init__(self, device, session_id: Optional[str] = None,
                 master_key=None, key_domain: int = 0):
        self.session_id = session_id or secrets.token_hex(8)
        self.device = torch.device(device)
        self._master = (
            None if master_key is None
            else tuple(int(w) & ring.MASK32 for w in master_key)
        )
        self._key_counter = 0
        # distinct domains partition the key-derivation nonce space
        self._key_domain = int(key_domain)
        self._setup_cache: dict = {}

    @property
    def master(self):
        if self._master is None:
            self._master = tuple(
                int(w) for w in np.frombuffer(secrets.token_bytes(16),
                                              dtype=np.uint32))
        return self._master

    # -- setup cache (reference execution/synchronous.rs:297-307) ----------

    def replicated_setup(self, rep_plc):
        from ..dialects import replicated

        cache_key = (rep_plc.name, rep_plc.owners)
        cached = self._setup_cache.get(cache_key)
        if cached is None:
            cached = replicated.gen_setup(self, rep_plc)
            self._setup_cache[cache_key] = cached
        return cached

    # -- PRF keys & seeds --------------------------------------------------

    def key_gen(self, plc: str) -> HostPrfKey:
        idx = self._key_counter
        self._key_counter += 1
        nonce = (idx, 0x6B657921 ^ self._key_domain, idx ^ 0xDEADBEEF, 1)
        return HostPrfKey(ring.mix_seed(self.master, nonce), plc,
                          origin=("key", idx))

    def derive_seed(self, plc: str, key: HostPrfKey,
                    sync_key: bytes) -> HostSeed:
        seed = host.derive_seed(key, sync_key, plc,
                                session_id=self.session_id)
        seed.origin = (key.origin, sync_key)
        return seed

    def sample_uniform_seeded(self, plc, shp, seed, width: int):
        return host.sample_uniform_seeded(shp, seed, width, plc, self.device)

    def sample_bits_seeded(self, plc, shp, seed, width: int):
        return host.sample_bits_seeded(shp, seed, width, plc, self.device)

    def sample_bit_tensor_seeded(self, plc, shp, seed):
        return host.sample_bit_tensor_seeded(shp, seed, plc, self.device)

    # -- value movement ----------------------------------------------------

    def place(self, plc: str, x):
        """Claim/move a value onto a host placement: a relabel in one
        process."""
        return host.place(x, plc)

    # -- structural / metadata --------------------------------------------

    def shape(self, plc, x) -> HostShape:
        return host.shape(x, plc)

    def constant(self, plc, value, dtype=None):
        return host.constant(value, plc, dtype, self.device)

    def fill(self, plc, shp, value, ty_name: str):
        return host.fill(shp, value, plc, ty_name, self.device)

    def zeros(self, plc, shp, dtype=dt.float64):
        return host.zeros(shp, dtype, plc, self.device)

    def ones(self, plc, shp, dtype=dt.float64):
        return host.ones(shp, dtype, plc, self.device)

    def ring_zeros(self, plc, shp, width: int):
        return host.ring_zeros(shp, width, plc, self.device)

    def ring_constant(self, plc, ints, width: int):
        return host.ring_constant(ints, width, plc, self.device)

    def reshape(self, plc, x, shp):
        return host.reshape(x, shp, plc)

    def transpose(self, plc, x, axes=None):
        return host.transpose(x, plc, axes)

    def expand_dims(self, plc, x, axis):
        return host.expand_dims(x, plc, axis)

    def squeeze(self, plc, x, axis=None):
        return host.squeeze(x, plc, axis)

    def concat(self, plc, xs, axis=0):
        return host.concat(xs, axis, plc)

    def index_axis(self, plc, x, axis, index):
        return host.index_axis(x, axis, index, plc)

    def slice(self, plc, x, begin, end):
        return host.slice_(x, begin, end, plc)

    def strided_slice(self, plc, x, slices):
        return host.strided_slice(x, slices, plc)

    def broadcast(self, plc, x, shp):
        return host.broadcast(x, shp, plc)

    def diag(self, plc, x):
        return host.diag(x, plc)

    def shl_dim(self, plc, x, amount, bit_length):
        return host.shl_dim(x, amount, bit_length, plc)

    def at_least_2d(self, plc, x, to_column_vector=False):
        return host.at_least_2d(x, to_column_vector, plc)

    # -- arithmetic (dispatch on value kind) -------------------------------

    @staticmethod
    def _is_ring(x):
        return isinstance(x, HostRingTensor)

    def add(self, plc, x, y):
        if self._is_ring(x):
            return host.ring_add(x, y, plc)
        return host.add(x, y, plc)

    def sub(self, plc, x, y):
        if self._is_ring(x):
            return host.ring_sub(x, y, plc)
        return host.sub(x, y, plc)

    def mul(self, plc, x, y):
        if self._is_ring(x):
            return host.ring_mul(x, y, plc)
        if isinstance(x, HostBitTensor):
            return host.bit_and(x, y, plc)
        return host.mul(x, y, plc)

    def div(self, plc, x, y):
        return host.div(x, y, plc)

    def dot(self, plc, x, y):
        if self._is_ring(x):
            return host.ring_dot(x, y, plc)
        return host.dot(x, y, plc)

    def mul_cross_terms(self, plc, x0, x1, y0, y1):
        """One party's ``x0 * (y0 + y1) + x1 * y0`` (K3)."""
        return host.ring_cross_terms_mul(x0, x1, y0, y1, plc)

    def dot_cross_terms(self, plc, x0, x1, y0, y1):
        """One party's ``x0 @ (y0 + y1) + x1 @ y0`` (K1)."""
        return host.ring_dot_cross_terms(x0, x1, y0, y1, plc)

    def conv_cross_terms(self, plc, x0, x1, k0, k1, strides=(1, 1),
                         padding="VALID"):
        """One party's cross terms of a convolution (im2col, then K1)."""
        return host.ring_conv_cross_terms(x0, x1, k0, k1, strides, padding,
                                          plc)

    def trunc_combine(self, plcs, a0, a1, draws, amount: int):
        """K2: the replicated result of the additive truncation of
        (a0, a1) from its five draws, as three host ring tensors on
        ``plcs``."""
        words = host.ring_trunc_combine(a0, a1, draws, amount)
        return tuple(HostRingTensor(lo, hi, a0.width, plc)
                     for (lo, hi), plc in zip(words, plcs))

    def conv2d(self, plc, x, k, strides=(1, 1), padding="VALID"):
        if self._is_ring(x):
            return host.ring_conv2d(x, k, strides, padding, plc)
        return host.conv2d(x, k, strides, padding, plc)

    def im2col(self, plc, x, kh, kw, strides=(1, 1), padding="VALID"):
        return host.ring_im2col(x, kh, kw, strides, padding, plc)

    def avg_pool2d(self, plc, x, pool, strides=None, padding="VALID"):
        return host.avg_pool2d(x, pool, strides, padding, plc)

    def max_pool2d(self, plc, x, pool, strides=None, padding="VALID"):
        return host.max_pool2d(x, pool, strides, padding, plc)

    def neg(self, plc, x):
        if self._is_ring(x):
            return host.ring_neg(x, plc)
        return host.neg_(x, plc)

    def sum(self, plc, x, axis=None):
        if self._is_ring(x):
            return host.ring_sum(x, axis, plc)
        return host.sum_(x, axis, plc)

    def mean(self, plc, x, axis=None):
        return host.mean(x, axis, plc)

    def shl(self, plc, x, amount: int):
        return host.ring_shl(x, amount, plc)

    def shr(self, plc, x, amount: int):
        return host.ring_shr(x, amount, plc)

    def shr_arith(self, plc, x, amount: int):
        return host.ring_shr_arith(x, amount, plc)

    # -- bits --------------------------------------------------------------

    def xor(self, plc, x, y):
        return host.bit_xor(x, y, plc)

    def and_(self, plc, x, y):
        return host.bit_and(x, y, plc)

    def or_(self, plc, x, y):
        return host.bit_or(x, y, plc)

    def bit_neg(self, plc, x):
        return host.bit_neg(x, plc)

    def bit_extract(self, plc, x, bit_idx: int):
        return host.ring_bit_extract(x, bit_idx, plc)

    def ring_inject(self, plc, b, bit_idx: int, width: int):
        return host.ring_inject(b, bit_idx, width, plc)

    def decompose_bits(self, plc, x):
        return host.ring_decompose_bits(x, plc)

    def compose_bits(self, plc, b, width: int):
        return host.ring_compose_bits(b, width, plc)

    # -- fixed-point -------------------------------------------------------

    def ring_fixedpoint_encode(self, plc, x, frac: int, width: int):
        return host.ring_fixedpoint_encode(x, frac, width, plc)

    def ring_fixedpoint_decode(self, plc, x, frac: int, dtype=dt.float64):
        return host.ring_fixedpoint_decode(x, frac, plc, dtype)

    def ring_fixedpoint_mean(self, plc, x, axis, frac: int):
        return host.ring_fixedpoint_mean(x, axis, frac, plc)

    # -- plaintext math ----------------------------------------------------

    def exp(self, plc, x):
        return host.exp(x, plc)

    def log(self, plc, x):
        return host.log(x, plc)

    def log2(self, plc, x):
        return host.log2(x, plc)

    def sqrt(self, plc, x):
        return host.sqrt(x, plc)

    def sigmoid(self, plc, x):
        return host.sigmoid(x, plc)

    def relu(self, plc, x):
        return host.relu(x, plc)

    def abs(self, plc, x):
        return host.abs_(x, plc)

    def sign(self, plc, x):
        return host.sign(x, plc)

    def pow2(self, plc, x):
        return host.pow2(x, plc)

    def softmax(self, plc, x, axis):
        return host.softmax(x, axis, plc)

    def argmax(self, plc, x, axis):
        return host.argmax(x, axis, plc)

    def maximum(self, plc, xs):
        return host.maximum(xs, plc)

    def inverse(self, plc, x):
        return host.inverse(x, plc)

    def less(self, plc, x, y):
        return host.less(x, y, plc)

    def greater(self, plc, x, y):
        return host.greater(x, y, plc)

    def equal(self, plc, x, y):
        return host.equal(x, y, plc)

    def mux(self, plc, s, x, y):
        return host.mux(s, x, y, plc)

    def cast(self, plc, x, target: dt.DType):
        return host.cast(x, target, plc)

    def cast_ring_lo(self, plc, x, target: dt.DType):
        return host.cast_ring_lo(x, target, plc)

    def select(self, plc, x, axis, index):
        return host.select(x, axis, index, plc)

    # -- host fixed-point wrappers (compositions of the ring methods) ------

    def fixedpoint_encode(self, plc, x, integ: int, frac: int, width: int):
        return HostFixedTensor(
            self.ring_fixedpoint_encode(plc, x, frac, width), integ, frac
        )

    def fixedpoint_decode(self, plc, x, dtype=dt.float64):
        return self.ring_fixedpoint_decode(
            plc, x.tensor, x.fractional_precision, dtype
        )
