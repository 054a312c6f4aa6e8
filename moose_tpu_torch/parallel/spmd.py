"""Party-stacked execution of the 3-party replicated protocol on one device.

PyTorch counterpart of ``moose_tpu/parallel/spmd.py``: sharing, the
secure dot, convolution and elementwise multiply, public-constant
arithmetic, truncation and the fixed-point layer.  A replicated sharing
is ONE pair of int64 word tensors with leading axes ``(party=3,
slot=2)``: x = x0 + x1 + x2, party i holds the pair
(x_i, x_{i+1}), ``lo[i, 0]`` is x_i and ``lo[i, 1]`` is x_{i+1}.
Share-local math is one tensor op over the party axis; resharing is a
roll over it (for a secure multiply, inside the ``cross_terms_reshare``
kernel).  The mesh helpers (``make_mesh``, ``fabric_party_mesh``,
``rep_sharding``, ``constrain``) lay the JAX package's meshes out over
device handles (``devices.Device``): a mesh whose handles all share one
torch device runs, word for word as without it; one that spans several
torch devices is refused (ROADMAP queue 1, item 12.9).

Randomness comes from :class:`SpmdSession` in the JAX package's exact
nonce schedule, so under the same master key and the threefry PRF both
packages draw the same masks, and the shares agree word for word.  The
draws of one protocol step come in one group: one K7 launch, whose seeds
the card derives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..devices import DEFAULT_DEVICE, canonical, local_devices, resolve
from ..dialects import ring
from ..errors import ConfigurationError
from ..execution import drawledger as _ledger
from ..native import ring_kernels as rk


@dataclasses.dataclass
class SpmdRep:
    """Party-stacked replicated ring tensor: words (3, 2, *shape)."""

    lo: torch.Tensor
    hi: Optional[torch.Tensor]
    width: int

    @property
    def shape(self):
        return tuple(self.lo.shape[2:])


@dataclasses.dataclass
class SpmdFixed:
    tensor: SpmdRep
    integral_precision: int
    fractional_precision: int


# ---------------------------------------------------------------------------
# Session: seed schedule for the PRF draws
# ---------------------------------------------------------------------------


def derive_step_keys(master_key, n: int, salt: int = 0x9E3779B9,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Per-iteration session keys for protocol steps run in a loop: mask
    freshness per step is a protocol concern, so the derivation lives
    here rather than in each caller.  Returns the JAX package's uint32
    words (n, 4) as an int64 tensor, each word in [0, 2^32): PyTorch's
    uint32 has no multiply or xor on every device."""
    device = resolve(device)
    steps = torch.arange(n, dtype=torch.int64, device=device)
    mk = torch.tensor([int(w) & ring.MASK32 for w in master_key],
                      dtype=torch.int64, device=device)
    words = torch.stack(
        [steps, steps * (salt & ring.MASK32), steps ^ 0xC2B2AE35, steps | 1],
        dim=1,
    )
    return torch.bitwise_and(mk[None, :] ^ words, ring.MASK32)


class SpmdSession:
    """Derives all per-invocation randomness from one master key (four
    u32 words) in the JAX package's nonce schedule: draw ``i`` of the
    session is seeded from the master key, the domain and nonce index
    ``i``.  Draws come in groups (:meth:`sample_group`) of consecutive
    indices; under the threefry streams on a CUDA ``device`` one K7
    launch expands a group and derives its seeds on the card, on the CPU
    each seed is derived on the host and the draw expanded by the plain
    version.  Under ``aes-ctr`` the seeds are derived and the group
    expanded on the host on either device, as the JAX package does, and
    copied to the device once (``ring_kernels.aes_ctr_group``).

    The master key lives on the device, as the 4-word int64 tensor
    ``key`` that K7 reads (``ring_kernels.key_tensor``): ``master_key``
    is that tensor, or four u32 words that are uploaded once.  The host
    copy of the words exists only where they were given (the eager walk)
    or on the CPU: aes-ctr needs it, and a captured plan, which gives
    the tensor of its static key buffer, never reads it."""

    def __init__(self, master_key, device, domain: int = 0):
        self.device = torch.device(device)
        if isinstance(master_key, torch.Tensor):
            self.key = master_key
            self._master = (tuple(int(w) for w in master_key.tolist())
                            if master_key.device.type == "cpu" else None)
        else:
            self._master = ring._seed_words(master_key)
            self.key = (None if self.device.type == "meta"
                        else rk.key_tensor(self._master, self.device))
        self._counter = 0
        self._domain = int(domain)

    def _next_seed(self):
        """The next draw's seed derived on the host (``ring.mix_seed``),
        as the CPU path derives it; claims the nonce index."""
        idx = self._counter
        self._counter += 1
        return ring.draw_seed(self.host_key(), self._domain, idx)

    def host_key(self):
        """The master key's four u32 words on the host (aes-ctr's
        seeds): refused for a session given only the card's key, whose
        words a captured plan cannot read."""
        if self._master is None:
            raise ConfigurationError(ring.AES_CTR_UNDER_JIT)
        return self._master

    def sample_group(self, specs):
        """Draw ``specs`` in order, on consecutive nonce indices, in one
        K7 group.  A spec is ``(kind, shape, width)`` or ``(kind, shape,
        width, out)``: kind ``"bank"`` draws (3, *shape) ring elements,
        ``"sample"`` (*shape), ``"bit_bank"`` (3, *shape) uint8 0/1 bits
        (width is ignored).  ``out`` says where the draw goes, as
        (buffer, element offset) planes of contiguous buffers, such as
        the stacked banks a kernel reads: ``(lo, hi)`` planes for words
        (hi None at ring64), one plane for bits.  Returns, in order, each
        draw's (lo, hi) words or bits, views of one buffer the group
        allocates, and None for a draw given its ``out``.  The counter
        ends where the draws one by one would leave it, under every
        PRF."""
        layout = ring.get_prf_impl()
        # per draw: (bits, n, planes, shape); planes given by ``out``, or
        # the offset into the group's own buffer and shape of the view
        plan = []
        totals = {False: 0, True: 0}  # words, bits the group allocates
        for spec in specs:
            kind, shape, width = spec[:3]
            shape = tuple(shape)
            if kind in ("bank", "bit_bank"):
                shape = (3,) + shape
            elif kind != "sample":
                raise ValueError(f"sample_group: unknown kind {kind!r}")
            bits = kind == "bit_bank"
            n = math.prod(shape)
            count = 1 if bits or width == 64 else 2
            # refused before anything is allocated or claimed
            rk.refuse_beyond_counter(layout, bits, n, count)
            if len(spec) > 3:
                out = spec[3]
                # a ring128 draw's planes are (hi, lo) in stream order
                planes = ((out,) if bits else (out[0],) if count == 1
                          else (out[1], out[0]))
                plan.append((bits, n, planes, None))
                continue
            at = totals[bits]
            totals[bits] += (_BIT_ALIGN * -(-n // _BIT_ALIGN) if bits
                             else count * n)
            plan.append((bits, n, tuple(at + p * n for p in range(count)),
                         shape))
        bufs = {
            bits: torch.empty(total, device=self.device,
                              dtype=torch.uint8 if bits else torch.int64)
            for bits, total in totals.items()
            if any(shape is not None and b == bits
                   for b, _, _, shape in plan)
        }
        draws = [
            rk.GroupDraw(bits, n, planes if shape is None
                         else tuple((bufs[bits], at) for at in planes))
            for bits, n, planes, shape in plan
        ]
        if _ledger.active() is not None:
            for spec in specs:
                _ledger.record_stacked_draw(
                    spec[0], spec[1],
                    None if spec[0] == "bit_bank" else spec[2])
        first = self._counter
        self._counter += len(draws)
        if layout == "aes-ctr":
            rk.aes_ctr_group(self.host_key(), self._domain, first, draws)
        else:
            rk.threefry_group(self._master if self.key is None
                              else self.key, self._domain, first, layout,
                              draws)
        outs = []
        for bits, n, planes, shape in plan:
            if shape is None:
                outs.append(None)
            elif bits:
                outs.append(bufs[True][planes[0]:planes[0] + n].view(shape))
            else:
                both = bufs[False][planes[0]:planes[0] + len(planes) * n]
                both = both.view((len(planes),) + shape)
                outs.append((both[0], None) if len(planes) == 1
                            else (both[1], both[0]))
        return outs

    def sample_bank(self, shape, width: int):
        """(3, *shape) uniform ring elements, one per party."""
        return self.sample_group([("bank", shape, width)])[0]

    def sample(self, shape, width: int):
        return self.sample_group([("sample", shape, width)])[0]

    def sample_bit_bank(self, shape):
        """(3, *shape) uniform bits as uint8 0/1, one slice per party."""
        return self.sample_group([("bit_bank", shape, None)])[0]


# bit draws the group allocates start 64 bytes apart: a threefry-pallas
# word of bits is then written with 16-byte stores
_BIT_ALIGN = 64


# ---------------------------------------------------------------------------
# Core protocol
# ---------------------------------------------------------------------------


def _pairs(z_lo, z_hi, width) -> SpmdRep:
    """Stack per-party values z_i into the pair layout (z_i, z_{i+1})."""
    lo = torch.stack([z_lo, torch.roll(z_lo, -1, dims=0)], dim=1)
    hi = (
        None if z_hi is None
        else torch.stack([z_hi, torch.roll(z_hi, -1, dims=0)], dim=1)
    )
    return SpmdRep(lo, hi, width)


def _h(t, *index):
    return None if t is None else t[index]


def share(sess: SpmdSession, x_lo, x_hi, width: int) -> SpmdRep:
    """Share a plaintext ring tensor: x0, x1 ~ PRF, x2 = x - x0 - x1."""
    r_lo, r_hi = sess.sample_bank(x_lo.shape, width)
    s_lo, s_hi = ring.sub(x_lo, x_hi, r_lo[0], _h(r_hi, 0))
    s_lo, s_hi = ring.sub(s_lo, s_hi, r_lo[1], _h(r_hi, 1))
    z_lo = torch.stack([r_lo[0], r_lo[1], s_lo])
    z_hi = None if x_hi is None else torch.stack([r_hi[0], r_hi[1], s_hi])
    return _pairs(z_lo, z_hi, width)


def reveal(x: SpmdRep):
    """Reconstruct the plaintext: sum over parties of first-slot shares."""
    lo, hi = x.lo[0, 0], _h(x.hi, 0, 0)
    for i in (1, 2):
        lo, hi = ring.add(lo, hi, x.lo[i, 0], _h(x.hi, i, 0))
    return lo, hi


def add(x: SpmdRep, y: SpmdRep) -> SpmdRep:
    return SpmdRep(*ring.add(x.lo, x.hi, y.lo, y.hi), x.width)


def sub(x: SpmdRep, y: SpmdRep) -> SpmdRep:
    return SpmdRep(*ring.sub(x.lo, x.hi, y.lo, y.hi), x.width)


def neg(x: SpmdRep) -> SpmdRep:
    return SpmdRep(*ring.neg(x.lo, x.hi), x.width)


def shl(x: SpmdRep, amount: int) -> SpmdRep:
    return SpmdRep(*ring.shl(x.lo, x.hi, amount), x.width)


def zero_share(sess: SpmdSession, shape, width: int):
    """alpha_i = PRF_i - PRF_{i+1}; one bank draw, sums to zero."""
    return _zero_from_bank(*sess.sample_bank(shape, width))


def _zero_from_bank(s_lo, s_hi):
    n_lo = torch.roll(s_lo, -1, dims=0)
    n_hi = None if s_hi is None else torch.roll(s_hi, -1, dims=0)
    return ring.sub(s_lo, s_hi, n_lo, n_hi)


def slot_words(t: SpmdRep, slot: int, shape=None):
    """Pair slot ``slot`` of ``t`` as contiguous (3, *shape) words,
    broadcast to the logical ``shape`` when given."""

    def words(w):
        if w is None:
            return None
        w = w[:, slot]
        if shape is not None:
            w = w.expand((3,) + tuple(shape))
        return w.contiguous()

    return words(t.lo), words(t.hi)


def _mul_terms(x: SpmdRep, y: SpmdRep):
    """Elementwise cross terms v_i = x_i·(y_i + y_{i+1}) + x_{i+1}·y_i
    per party (the regrouped 3-term cross product of the JAX package, two
    products instead of three), the operands broadcast to their common
    logical shape, in the ``cross_terms_mul`` kernel.  The protocol's
    multiplies run it fused with the reshare (:func:`mul`); this unfused
    form is the composition that fusion is held against."""
    shape = torch.broadcast_shapes(x.shape, y.shape)
    return rk.cross_terms_mul(
        slot_words(x, 0, shape), slot_words(x, 1, shape),
        slot_words(y, 0, shape), slot_words(y, 1, shape), x.width,
    )


def _dot_terms(x: SpmdRep, y: SpmdRep):
    """Cross terms of the secure Dot x @ y at any rank, under the JAX
    package's rule (``ring.dot_shapes``: x's last axis against y's
    first), party-batched in the ``dot_cross_terms`` kernel, which takes
    ``y0 + y1`` summed beforehand: each slot's words folded to (3, M, k)
    and (3, k, N), one K1 product, the (3, M, N) result viewed back to
    (3, *x.shape[:-1], *y.shape[1:])."""
    m, k, n, shape = ring.dot_shapes(x.shape, y.shape)
    if x.lo.is_cuda and len(x.shape) == len(y.shape) == 2:
        from ..compilation import autotune

        # the plan's per-class dot decision, recorded for last_plan where
        # the reference's dispatch records it (a product of matrices): it
        # routes nothing, K1 runs whatever it says
        autotune.dot_kernel_wanted(x.width, (m, k, n))

    def fold(t, slot, rows, cols):
        return tuple(None if w is None else w.view(3, rows, cols)
                     for w in slot_words(t, slot))

    y0 = fold(y, 0, k, n)
    v = rk.dot_cross_terms(fold(x, 0, m, k), fold(x, 1, m, k), y0,
                           ring.add(*y0, *fold(y, 1, k, n)), x.width)
    return tuple(None if w is None else w.view((3,) + shape) for w in v)


def _conv_terms(strides, padding):
    """The contraction of a secure convolution, NHWC x HWIO -> (N, OH,
    OW, O): the patches of x (:func:`im2col`) as a (N*OH*OW, KH*KW*C)
    matrix against the kernel reshaped to (KH*KW*C, O), through
    :func:`_dot_terms` — the card runs the secure dot's kernel, as the
    JAX package runs ``ring.conv2d`` (im2col, then its ring matmul)."""

    def contract(x: SpmdRep, k: SpmdRep):
        kh, kw, c, o = k.shape
        patches = im2col(x, kh, kw, strides, padding)
        n, oh, ow, depth = patches.shape
        v = _dot_terms(reshape(patches, (n * oh * ow, depth)),
                       reshape(k, (kh * kw * c, o)))
        return tuple(None if w is None else w.view((3, n, oh, ow, o))
                     for w in v)

    return contract


def _reshare(sess, v_lo, v_hi, width):
    a_lo, a_hi = zero_share(sess, v_lo.shape[1:], width)
    return _pairs(*ring.add(v_lo, v_hi, a_lo, a_hi), width)


def mul(sess: SpmdSession, x: SpmdRep, y: SpmdRep) -> SpmdRep:
    """Secure elementwise multiplication: cross terms + reshare, in the
    ``cross_terms_reshare`` kernel, which reads the operands' pair layout
    in place (broadcasting them to their common logical shape) and the
    zero-share bank, and writes the reshared pair layout; word for word
    ``_reshare(sess, *_mul_terms(x, y), width)``."""
    shape = torch.broadcast_shapes(x.shape, y.shape)
    bank = sess.sample_bank(shape, x.width)
    return SpmdRep(
        *rk.cross_terms_reshare((x.lo, x.hi), (y.lo, y.hi), bank,
                                x.width),
        x.width,
    )


def dot(sess: SpmdSession, x: SpmdRep, y: SpmdRep) -> SpmdRep:
    """Secure matmul: regrouped party-batched cross terms + reshare."""
    return _reshare(sess, *_dot_terms(x, y), x.width)


def conv2d(sess: SpmdSession, x: SpmdRep, k: SpmdRep, strides=(1, 1),
           padding="VALID") -> SpmdRep:
    """Secure convolution (NHWC x HWIO): the cross-product and zero-share
    reshare of mul/dot with the convolution's contraction."""
    return _reshare(sess, *_conv_terms(strides, padding)(x, k), x.width)


def im2col(x: SpmdRep, kh: int, kw: int, strides=(1, 1),
           padding="VALID") -> SpmdRep:
    """Patch extraction applied share-locally (pure data movement;
    sharing is linear, so patched shares reconstruct to the patched
    secret).  The (party, slot) prefix folds into the batch axis for
    ``ring.im2col`` and unfolds after."""

    def go(a):
        three, two, n, h, w, c = a.shape
        patches, out_h, out_w = ring.im2col(
            a.reshape(three * two * n, h, w, c), kh, kw, strides, padding)
        return patches.view(three, two, n, out_h, out_w, patches.shape[-1])

    return SpmdRep(go(x.lo), None if x.hi is None else go(x.hi), x.width)


def public_to_rep(lo, hi, width: int) -> SpmdRep:
    """Trivial replicated sharing of a public plaintext ring tensor:
    x_0 = v, x_1 = x_2 = 0, so only pair slots (party 0, slot 0) and
    (party 2, slot 1) hold v."""

    def stacked(v):
        z = torch.zeros_like(v)
        return torch.stack([
            torch.stack([v, z]), torch.stack([z, z]), torch.stack([z, v])
        ])

    return SpmdRep(stacked(lo), None if hi is None else stacked(hi), width)


def fill_public(shape, width: int, raw: int, device) -> SpmdRep:
    """Trivial replicated sharing of a public ring constant."""
    return public_to_rep(
        *ring.fill_like_shape(shape, width, raw, device), width
    )


def mul_public(x: SpmdRep, c_lo, c_hi) -> SpmdRep:
    """x * public constant (same value on every party) through the
    ``ring_mul`` kernel, the constant at its own shape: the kernel
    broadcasts it to the shares' shape.  Where the two broadcast only to
    a larger shape, the shares are broadcast to it first, as the JAX
    package's ``ring.mul`` broadcasts both operands."""
    full = torch.broadcast_shapes(x.lo.shape, c_lo.shape)

    def words(w):
        return None if w is None else w.expand(full).contiguous()

    x_hi = words(x.hi)
    return SpmdRep(
        *rk.ring_mul(words(x.lo), x_hi, c_lo,
                     None if x_hi is None else c_hi, x.width),
        x.width,
    )


def add_public(x: SpmdRep, c_lo, c_hi) -> SpmdRep:
    """x + public c: only share x_0 (held at [0, 0] and [2, 1]) moves."""
    lo = x.lo.clone()
    hi = None if x.hi is None else x.hi.clone()
    for party, slot in ((0, 0), (2, 1)):
        s_lo, s_hi = ring.add(
            x.lo[party, slot], _h(x.hi, party, slot), c_lo, c_hi
        )
        lo[party, slot] = s_lo
        if hi is not None:
            hi[party, slot] = s_hi
    return SpmdRep(lo, hi, x.width)


def sub_public(x: SpmdRep, c_lo, c_hi) -> SpmdRep:
    return add_public(x, *ring.neg(c_lo, c_hi))


def public_sub(c_lo, c_hi, x: SpmdRep) -> SpmdRep:
    return add_public(neg(x), c_lo, c_hi)


# Structural ops: pure share-local data movement on the logical axes.
# Logical axis a lives at tensor axis a + 2.


def _laxis(arr, axis: int, extra: int = 0) -> int:
    """Logical axis -> tensor axis; negative axes count from the end of
    the LOGICAL shape; ``extra`` admits one-past-the-end for
    expand_dims."""
    nd = arr.dim() - 2 + extra
    if axis < 0:
        axis += nd
    if not 0 <= axis < nd:
        raise ValueError(f"axis {axis} out of range for {nd} logical dims")
    return axis + 2


def _structural(fn):
    def kernel(x: SpmdRep, *args, **kwargs) -> SpmdRep:
        arr = getattr(x, "arr", None)
        if arr is not None:
            # shared bits (SpmdBits, the same (3, 2, *shape) layout):
            # XOR sharing is linear too, so restructured shares
            # reconstruct to the restructured bits (the tree ensembles
            # index their comparison bits)
            return type(x)(fn(arr, *args, **kwargs))
        lo = fn(x.lo, *args, **kwargs)
        hi = None if x.hi is None else fn(x.hi, *args, **kwargs)
        return SpmdRep(lo, hi, x.width)

    return kernel


index_axis = _structural(
    lambda a, axis, idx: a.select(_laxis(a, axis), idx)
)
expand_dims = _structural(
    lambda a, axis: a.unsqueeze(_laxis(a, axis, extra=1))
)
reshape = _structural(lambda a, shape: a.reshape(a.shape[:2] + tuple(shape)))


def _transpose_arr(a, axes=None):
    nd = a.dim() - 2
    if axes is None:
        axes = tuple(range(nd - 1, -1, -1))
    return a.permute((0, 1) + tuple(_laxis(a, ax) for ax in axes))


# Permute the logical axes (all reversed when ``axes`` is None).  The
# result is a strided view: ``cross_terms_reshare``, ``trunc_pairs`` and
# ``horner`` read it in place, the other kernels' callers make slots
# contiguous (:func:`slot_words`, ``mul_public``).
transpose = _structural(_transpose_arr)


def concat(xs, axis: int) -> SpmdRep:
    ax = _laxis(xs[0].lo, axis)
    lo = torch.cat([x.lo for x in xs], dim=ax)
    hi = None if xs[0].hi is None else torch.cat([x.hi for x in xs], dim=ax)
    return SpmdRep(lo, hi, xs[0].width)


def stack(xs, axis: int = 0) -> SpmdRep:
    """Stack sharings of one shape along a new logical axis."""
    ax = _laxis(xs[0].lo, axis, extra=1)
    lo = torch.stack([x.lo for x in xs], dim=ax)
    hi = None if xs[0].hi is None else torch.stack([x.hi for x in xs],
                                                   dim=ax)
    return SpmdRep(lo, hi, xs[0].width)


def sum_axis(x: SpmdRep, axis: int) -> SpmdRep:
    return SpmdRep(
        *ring.sum_(x.lo, x.hi, axis=_laxis(x.lo, axis)), x.width
    )


# ---------------------------------------------------------------------------
# Probabilistic truncation
# ---------------------------------------------------------------------------


def _trunc_draws(sess: SpmdSession, shape, width: int):
    """The five truncation draws (mask r, the three additive-share masks,
    the replicated-compression share z0), in the JAX package's session
    order, as the specs of a group that writes them into one (5, *shape)
    block per plane, and the block's (lo, hi) words that the
    ``trunc_pairs`` kernel reads."""
    lo = torch.empty((5,) + tuple(shape), dtype=torch.int64,
                     device=sess.device)
    hi = None if width == 64 else torch.empty_like(lo)
    n = math.prod(shape)
    specs = [
        ("sample", shape, width,
         ((lo, j * n), None if hi is None else (hi, j * n)))
        for j in range(5)
    ]
    return specs, (lo, hi)


def trunc_pr(sess: SpmdSession, x: SpmdRep, amount: int) -> SpmdRep:
    """Probabilistic truncation of a replicated sharing by ``amount``:
    its five draws in one K7 group, then the ``trunc_pairs`` kernel,
    which reads x's pair layout in place (x_0 + x_1 and x_2, the 2-party
    additive form of the JAX package's ``trunc_pr``) and writes the
    result's."""
    specs, draws = _trunc_draws(sess, x.shape, x.width)
    sess.sample_group(specs)
    return SpmdRep(
        *rk.trunc_pairs((x.lo, x.hi), draws, x.width, amount), x.width
    )


def _mul_like_trunc(sess, x: SpmdRep, y: SpmdRep, contract,
                    amount: int) -> SpmdRep:
    """Fused multiply-and-truncate: cross terms + zero-share, fed straight
    into truncation's 2-party additive form (a0 = z_0 + z_1, a1 = z_2) —
    bit-identical to resharing then ``trunc_pr``, with the same draw
    order: the zero-share bank at the product's shape and the five
    truncation draws are one K7 group.  ``contract`` is the product's
    cross terms: :func:`_mul_terms` (elementwise) runs fused with the
    reshare in the ``cross_terms_reshare`` kernel, whose pair layout
    ``trunc_pairs`` reads; a contraction (:func:`_dot_terms`, a
    :func:`_conv_terms`) gives the (3, *shape) cross terms, which
    ``trunc_pairs`` takes with the bank."""
    width = x.width
    if contract is _mul_terms:
        shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
        v = None
    else:
        v = contract(x, y)
        shape = tuple(v[0].shape[1:])
    specs, draws = _trunc_draws(sess, shape, width)
    bank = sess.sample_group([("bank", shape, width)] + specs)[0]
    if v is None:
        z = rk.cross_terms_reshare((x.lo, x.hi), (y.lo, y.hi), bank, width)
        out = rk.trunc_pairs(z, draws, width, amount)
    else:
        out = rk.trunc_pairs(v, draws, width, amount, bank=bank)
    return SpmdRep(*out, width)


# ---------------------------------------------------------------------------
# Fixed-point layer
# ---------------------------------------------------------------------------


def fx_encode_share(sess, x_float, integ: int, frac: int, width: int):
    lo, hi = ring.fixedpoint_encode(x_float, frac, width)
    return SpmdFixed(share(sess, lo, hi, width), integ, frac)


def fx_reveal_decode(x: SpmdFixed):
    lo, hi = reveal(x.tensor)
    return ring.fixedpoint_decode(lo, hi, x.fractional_precision)


def fx_add(x: SpmdFixed, y: SpmdFixed) -> SpmdFixed:
    return SpmdFixed(
        add(x.tensor, y.tensor),
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def fx_sub(x: SpmdFixed, y: SpmdFixed) -> SpmdFixed:
    return SpmdFixed(
        sub(x.tensor, y.tensor),
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def _fx_product(sess, x: SpmdFixed, y: SpmdFixed, contract) -> SpmdFixed:
    z = _mul_like_trunc(
        sess, x.tensor, y.tensor, contract, x.fractional_precision
    )
    return SpmdFixed(
        z,
        max(x.integral_precision, y.integral_precision),
        x.fractional_precision,
    )


def fx_mul(sess, x: SpmdFixed, y: SpmdFixed) -> SpmdFixed:
    return _fx_product(sess, x, y, _mul_terms)


def fx_dot(sess, x: SpmdFixed, y: SpmdFixed) -> SpmdFixed:
    return _fx_product(sess, x, y, _dot_terms)


def fx_conv2d(sess, x: SpmdFixed, k: SpmdFixed, strides=(1, 1),
              padding="VALID") -> SpmdFixed:
    """Fixed-point secure convolution: one multiplication depth, fused
    with the single truncation like fx_mul/fx_dot."""
    return _fx_product(sess, x, k, _conv_terms(strides, padding))


def _fx_raw(value: float, frac: int, width: int) -> int:
    return int(round(value * (1 << frac))) % (1 << width)


def _scalar(x: SpmdFixed, value: float):
    """The public scalar ``value`` at x's precision as ring words."""
    width = x.tensor.width
    raw = _fx_raw(value, x.fractional_precision, width)
    return ring.fill_like_shape((), width, raw, x.tensor.lo.device)


def fx_mul_public(sess, x: SpmdFixed, value: float) -> SpmdFixed:
    z = mul_public(x.tensor, *_scalar(x, value))
    z = trunc_pr(sess, z, x.fractional_precision)
    return SpmdFixed(z, x.integral_precision, x.fractional_precision)


def fx_transpose(x: SpmdFixed) -> SpmdFixed:
    """Swap the last two logical axes."""
    return SpmdFixed(
        _structural(lambda a: a.transpose(-1, -2))(x.tensor),
        x.integral_precision,
        x.fractional_precision,
    )


def fx_add_public(x: SpmdFixed, value: float) -> SpmdFixed:
    return SpmdFixed(
        add_public(x.tensor, *_scalar(x, value)),
        x.integral_precision,
        x.fractional_precision,
    )


def fx_mean_rows(sess, x: SpmdFixed) -> SpmdFixed:
    """Mean over the leading data axis (axis 0 of the logical shape)."""
    summed = SpmdFixed(sum_axis(x.tensor, 0), x.integral_precision,
                       x.fractional_precision)
    return fx_mul_public(sess, summed, 1.0 / x.tensor.shape[0])


def fx_sigmoid_poly(sess, x: SpmdFixed) -> SpmdFixed:
    """Degree-3 polynomial sigmoid approximation
    sigma(t) ~ 0.5 + 0.198285*t - 0.004469*t^3 (least squares on [-5, 5],
    max error ~0.06), the standard secure-logreg approximation; the
    protocol sigmoid (exp and division) is ``spmd_math.fx_sigmoid``."""
    x2 = fx_mul(sess, x, x)
    x3 = fx_mul(sess, x2, x)
    t1 = fx_mul_public(sess, x, 0.19828547)
    t3 = fx_mul_public(sess, x3, -0.00446928)
    return fx_add_public(fx_add(t1, t3), 0.5)


# ---------------------------------------------------------------------------
# Mesh helpers: the party axis and the batch axis over device handles
# ---------------------------------------------------------------------------


class Mesh:
    """A device mesh: ``devices`` a numpy object array of device handles
    (``devices.Device``), one array axis a name of ``axis_names``, as a
    ``jax.sharding.Mesh``.  ``with mesh:`` is accepted.  A mesh runs
    where all its handles share one torch device (:attr:`torch_device`);
    its sharings then live on that device whole."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def torch_device(self) -> torch.device:
        """The one torch device behind every handle of the mesh."""
        behind = {canonical(d) for d in self.devices.flat}
        if len(behind) > 1:
            raise NotImplementedError(
                "a mesh over several torch devices "
                f"({sorted(map(str, behind))}): sharding a party or batch "
                "axis across cards is ROADMAP queue 1, item 12.9")
        return behind.pop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device=DEFAULT_DEVICE) -> Mesh:
    """Mesh with axes (parties, data) over the first ``n_devices`` of
    ``devices`` (default: ``devices.local_devices(device)``).

    With >= 3 devices the party axis is 3 and ``data = n // 3``, any
    remainder unused (8 devices give a (3, 2) mesh over 6); with fewer
    the parties are co-located (parties=1) and the devices shard the
    batch.  One card gives the (1, 1) mesh."""
    if devices is None:
        devices = local_devices(device)
    devices = list(devices)[: n_devices or len(devices)]
    n = len(devices)
    p, d = (3, n // 3) if n >= 3 else (1, n)
    arr = np.array(devices[: p * d], dtype=object).reshape(p, d)
    return Mesh(arr, ("parties", "data"))


def fabric_party_mesh(devices) -> Mesh:
    """1-D mesh over axis ``"parties"``: one lead device a party, in the
    fabric domain's declaration order (party index = mesh position =
    ring position for the cost model's hop count)."""
    arr = np.array(list(devices), dtype=object)
    if arr.ndim != 1 or arr.size < 2:
        raise ValueError(
            "fabric_party_mesh needs a flat list of >= 2 lead devices, "
            f"got shape {arr.shape}")
    return Mesh(arr, ("parties",))


def rep_sharding(mesh: Mesh, batch_axis: Optional[int] = 0,
                 ndim: int = 2) -> tuple:
    """The partition spec of a stacked share array (3, 2, *shape): the
    party axis over "parties", one data axis over "data"."""
    spec = ["parties", None] + [None] * ndim
    if batch_axis is not None:
        spec[2 + batch_axis] = "data"
    return tuple(spec)


def constrain(x: SpmdRep, mesh: Mesh, batch_axis=0) -> SpmdRep:
    """``x`` placed on ``mesh``: its words on the mesh's one torch
    device, under :func:`rep_sharding`'s spec."""
    # the spec the JAX package constrains to, and its IndexError for a
    # batch axis past the sharing's rank
    rep_sharding(mesh, batch_axis, x.lo.ndim - 2)
    dev = mesh.torch_device
    if x.lo.device != dev:
        raise ConfigurationError(
            f"a sharing on {x.lo.device} constrained to a mesh on {dev}")
    return SpmdRep(x.lo, x.hi, x.width)


# ---------------------------------------------------------------------------
# Flagship computation: secure logistic-regression training step (the
# reference's benchmark workload, benchmarks/logreg.py's run_spmd)
# ---------------------------------------------------------------------------


def logreg_train_step(sess: SpmdSession, x: SpmdFixed, y: SpmdFixed,
                      w: SpmdFixed, lr: float, mesh=None) -> SpmdFixed:
    """One secure SGD step on (batch, features) ``x``, (batch, 1) ``y``
    and (features, 1) ``w``: w -= lr * X^T (sigmoid(Xw) - y) / batch, with
    :func:`fx_sigmoid_poly`; ``x`` constrained to ``mesh`` when given."""
    if mesh is not None:
        x = SpmdFixed(
            constrain(x.tensor, mesh, 0),
            x.integral_precision,
            x.fractional_precision,
        )
    logits = fx_dot(sess, x, w)  # (batch, 1)
    preds = fx_sigmoid_poly(sess, logits)
    err = fx_sub(preds, y)  # (batch, 1)
    xt = fx_transpose(x)  # (features, batch)
    grad = fx_dot(sess, xt, err)  # (features, 1)
    n = x.tensor.shape[0]
    step = fx_mul_public(sess, grad, lr / n)
    return fx_sub(w, step)
