"""Hand-written CUDA kernels of the protocol, with their plain versions.

PyTorch counterpart of the ``moose_tpu/native/ring128_kernels.py``
kernels the secure dot and the protocol sigmoid run:

- ``dot_cross_terms`` (K1): the party-batched cross terms
  ``v_p = x0_p @ (y0+y1)_p + x1_p @ y0_p mod 2^w`` of a secure matmul,
  ``csrc/dot_cross_terms.cu``;
- ``trunc_combine`` (K2): the elementwise tail of probabilistic
  truncation after its five pre-drawn values, and ``trunc_pairs``, the
  whole truncation after its draws from the pair layout (or a matrix
  product's cross terms and zero-share bank) to the pair layout, both
  through one kernel, ``csrc/trunc_combine.cu``;
- ``cross_terms_mul`` (K3): the same cross terms elementwise, and
  ``cross_terms_reshare``, a secure multiply's cross terms fused with its
  reshare, reading the operands' pair layout in place and writing the
  reshared pair layout, ``csrc/cross_terms_mul.cu``;
- ``ring_mul`` (K4): an elementwise ring multiply (a secret times a
  public constant, broadcast in the kernel), ``csrc/ring_mul.cu``;
- ``bit_decompose`` and ``msb`` (K5): arithmetic-to-binary conversion
  through a Kogge-Stone adder over pre-drawn AND banks, all bits or only
  the top one, ``csrc/bits_adder.cu`` (the banks packed into bit masks,
  then the adder on masks);
- ``horner`` (K6): the fused fixed-point Horner ladder of a secret
  polynomial, reading x's pair slots in place and writing the result's
  pair layout (``horner_pairs``), ``csrc/horner.cu``;
- ``threefry_group`` (K7, the ``moose_tpu/dialects/pallas_prf.py``
  kernel): threefry2x32-20 counter-mode expansion of a group of a
  protocol session's draws into u64 words or 0/1 bits, their seeds
  derived in the kernel, in the layout of the default ``threefry``
  stream or of K7's ``threefry-pallas`` stream; ``threefry_words`` and
  ``threefry_bits`` expand one key the caller gives, as a group of one,
  through the same kernel ``csrc/threefry.cu``.

A wrapper dispatches on its tensors' device (for K7, the buffers'),
explicitly: the CPU takes the plain version; CUDA launches the kernel;
``meta`` is shape only, a wrapper returning meta outputs of its shape
and a group fill of meta buffers doing nothing, so the shape-only
replay of the stacked layout
(``compilation.analysis.keystream.stacked_draw_trace``) computes nothing
and launches nothing; any other device raises.  The draws under a
given key (:func:`threefry_words`, :func:`threefry_bits`: the per-host
layout's single draws, which no stacked walk reaches) take the CPU or
CUDA only.  There is no fallback: no CUDA tensor takes another branch.  Each launch adds one to
``LAUNCHES[name]`` (and nothing else does), so a run can show that it
went through the kernels; K2 and K3 count their two entry points apart,
K5 its two modes, and K7 its two layouts (``prf_threefry``,
``prf_threefry_pallas``), one launch a group.

The ``aes-ctr`` PRF is no kernel: :func:`aes_ctr_group` expands a group
on the host, as the JAX package does, and copies it to the device once.
``LAUNCHES["prf_aes_ctr_host"]`` counts those expansions (one a group),
apart from every kernel's count, and ``AES_CTR_HOST`` the keystream
bytes they drew and the host time they took.

The plain versions repeat the kernels' arithmetic in PyTorch.  They are
what the CPU tests hold against the JAX package, and what ``chip_smoke.py``
holds each kernel against on the card; they are no yardstick of speed.
K1-K6 never draw randomness: callers pass the values K7 expanded, so a
computation is bit-identical on either path.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..dialects import ring
from . import build

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]

LAUNCHES = {
    "dot_cross_terms": 0, "trunc_combine": 0, "trunc_pairs": 0,
    "cross_terms_mul": 0, "cross_terms_reshare": 0, "ring_mul": 0,
    "bit_decompose": 0, "msb": 0, "horner": 0,
    "prf_threefry": 0, "prf_threefry_pallas": 0,
    # host expansions of the aes-ctr PRF, one a group: no kernel
    "prf_aes_ctr_host": 0,
}
# keystream bytes the aes-ctr expansions drew, and their host time
AES_CTR_HOST = {"bytes": 0, "ms": 0.0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    AES_CTR_HOST.update(bytes=0, ms=0.0)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _meta_words(shape, width: int, device) -> Pair:
    """Shape-only (lo, hi) ring words: a wrapper's output on ``meta``."""
    lo = torch.empty(tuple(shape), dtype=torch.int64, device=device)
    return lo, (torch.empty_like(lo) if width == 128 else None)


def _check_cuda_words(label: str, t: Optional[torch.Tensor], shape,
                      device: torch.device) -> None:
    if t is None:
        raise ValueError(f"{label}: missing high word for ring128")
    if t.device != device:
        raise ValueError(
            f"{label}: expected a tensor on {device}, got {t.device}"
        )
    if t.dtype != torch.int64:
        raise ValueError(f"{label}: expected int64 ring words, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{label}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{label}: expected a contiguous tensor")


def _check_pair(label: str, pair: Pair, shape, device: torch.device,
                wide: bool) -> None:
    _check_cuda_words(f"{label}.lo", pair[0], shape, device)
    if wide:
        _check_cuda_words(f"{label}.hi", pair[1], shape, device)


def _require_cuda(label: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{label} takes CPU or CUDA tensors, got {device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(label: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{label}: CUDA launch failed with error {err}")


def _roll(t):
    return None if t is None else torch.roll(t, -1, dims=0)


def _at(t, *index):
    return None if t is None else t[index]


def _check_strided(label: str, pair: Pair, shape, device: torch.device,
                   wide: bool) -> None:
    """int64 words of ``shape`` on ``device`` that a kernel reads through
    their strides: any strides, the high word's those of the low."""
    lo, hi = pair
    if lo.device != device or lo.dtype != torch.int64:
        raise ValueError(
            f"{label}: expected int64 words on {device}, got {lo.dtype} on "
            f"{lo.device}"
        )
    if tuple(lo.shape) != tuple(shape):
        raise ValueError(
            f"{label}: expected shape {tuple(shape)}, got {tuple(lo.shape)}"
        )
    if wide and (hi is None or hi.dtype != torch.int64 or hi.device != device
                 or hi.shape != lo.shape or hi.stride() != lo.stride()):
        raise ValueError(f"{label}: hi words missing or laid out unlike lo")


# ring_words.cuh: the most collapsed axes of a strided walk
_WALK_MAX_DIMS = 8
_WalkAxes = ctypes.c_longlong * _WALK_MAX_DIMS


def _logical_stride(t: torch.Tensor, shape, d: int, lead: int) -> int:
    """The word stride of ``t`` (``lead`` leading axes, then its own
    logical shape) along axis ``d`` of the logical ``shape`` it
    broadcasts to: 0 where ``t`` has no such axis or size 1 there."""
    td = d - (len(shape) - (t.dim() - lead))
    return 0 if td < 0 or t.shape[lead + td] == 1 else t.stride(lead + td)


def walk_dims(shape, *operands: torch.Tensor, lead: int = 2):
    """(size, stride of each operand) axes of the logical ``shape``,
    size-1 axes dropped and neighbours that step alike in every operand
    merged, innermost last: what a kernel's strided walk
    (``ring_words.cuh``) takes.  The operands have ``lead`` leading axes
    (2 for the pair layout, 1 for a pair slot) before their own logical
    shapes, which broadcast to ``shape``."""
    dims = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        strides = tuple(_logical_stride(t, shape, d, lead) for t in operands)
        if dims and all(outer == s * size
                        for outer, s in zip(dims[-1][1:], strides)):
            dims[-1] = (dims[-1][0] * size,) + strides
        else:
            dims.append((size,) + strides)
    return dims


def _walk_axes(label: str, dims, operands: int):
    """The ctypes arrays (sizes, then each operand's strides) of a walk."""
    if len(dims) > _WALK_MAX_DIMS:
        raise ValueError(
            f"{label}: the walk takes {len(dims)} axes, the kernel at most "
            f"{_WALK_MAX_DIMS}"
        )
    cols = list(zip(*dims)) if dims else [()] * (1 + operands)
    return [_WalkAxes(*col) for col in cols]


# ---------------------------------------------------------------------------
# K1: party-batched dot cross terms
# ---------------------------------------------------------------------------

# csrc/dot_cross_terms.cu: the limb GEMM's geometry.  A block owns a 64
# x 32 (ring128) or 64 x 64 (ring64) output tile of one party, K' = 2k
# runs in chunks of 32 limb bytes, and the grid's y dimension (the m
# tiles) holds at most 65535 blocks
_DOT_BM = 64
_DOT_BK = 32
_MAX_GRID_Y = 65535
_LIMB_MAX_SQ = 255 * 255

# 16-bit limbs multiplied as float64 matmuls: a limb product is < 2^32,
# so a contraction of up to 2^21 terms stays below 2^53 and is exact
_F64_CHUNK = 1 << 21


def _limbs16_f64(lo, hi):
    words = [lo] if hi is None else [lo, hi]
    return [
        torch.bitwise_and(ring.lshr64(w, 16 * i), 0xFFFF).to(torch.float64)
        for w in words
        for i in range(4)
    ]


def ring_matmul_plain(a: Pair, b: Pair, width: int) -> Pair:
    """Party-batched ring matmul ``(3, m, k) @ (3, k, n) mod 2^width``
    in plain PyTorch: 16-bit limbs, exact float64 matmuls (which CUDA
    has and int64 matmul does not), per-diagonal int64 sums, one shifted
    recombination."""
    la = _limbs16_f64(*a)
    lb = _limbs16_f64(*b)
    k = a[0].shape[-1]
    out_shape = a[0].shape[:-1] + b[0].shape[-1:]
    n_limbs = len(la)
    rlo = torch.zeros(out_shape, dtype=torch.int64, device=a[0].device)
    rhi = None if width == 64 else torch.zeros_like(rlo)
    for s in range(n_limbs):
        diag = torch.zeros_like(rlo)
        for i in range(s + 1):
            j = s - i
            for c0 in range(0, max(k, 1), _F64_CHUNK):
                c1 = min(c0 + _F64_CHUNK, k)
                p = torch.matmul(la[i][..., c0:c1], lb[j][..., c0:c1, :])
                diag = diag + p.to(torch.int64)
        if width == 64:
            rlo = rlo + ring.shl64(diag, 16 * s)
        else:
            rlo, rhi = ring.add(
                rlo, rhi, *ring.shl(diag, torch.zeros_like(diag), 16 * s)
            )
    return rlo, rhi


def dot_cross_terms_plain(x0: Pair, x1: Optional[Pair],
                          y0: Optional[Pair], ysum: Pair,
                          width: int) -> Pair:
    """``x0 @ ysum + x1 @ y0`` mod 2^width; ``x0 @ ysum`` alone when
    ``x1`` and ``y0`` are None (the product-only mode)."""
    v = ring_matmul_plain(x0, ysum, width)
    if x1 is None:
        return v
    t = ring_matmul_plain(x1, y0, width)
    return ring.add(*v, *t)


def dot_tile_cols(width: int) -> int:
    """Output columns of one block of the limb GEMM."""
    return 32 if width == 128 else 64


def dot_segment_depth(width: int) -> int:
    """K' depth of one segment of the limb GEMM.  Diagonal d sums (d+1)
    limb products of at most 255^2 per K' step; the diagonals d <= L-5
    need their true value, the others only mod 2^32 (they land at bit
    8d >= width-32), so a segment is the largest whole number of 32-byte
    chunks that keeps (L-4) * K' * 255^2 below 2^32: 5504 at ring128,
    16512 at ring64."""
    limbs = width // 8
    depth = 0xFFFFFFFF // ((limbs - 4) * _LIMB_MAX_SQ)
    return depth // _DOT_BK * _DOT_BK


def dot_geometry(parties: int, m: int, k: int, n: int, width: int,
                 terms: int = 2):
    """(m tiles, n tiles, K' chunks, A8 bytes, B8 bytes) of one call of
    ``terms`` contractions (K' = terms * k; 1 in the product-only mode):
    the split stage writes A8 [P][m tiles][chunks][L][64 x 32] and B8
    [P][n tiles][chunks][L][cols x 32] limb bytes."""
    limbs = width // 8
    cols = dot_tile_cols(width)
    mt = -(-m // _DOT_BM)
    nt = -(-n // cols)
    kc = -(-terms * k // _DOT_BK)
    a_bytes = parties * mt * kc * limbs * _DOT_BM * _DOT_BK
    b_bytes = parties * nt * kc * limbs * cols * _DOT_BK
    return mt, nt, kc, a_bytes, b_bytes


def _limb_planes(lo_parts, hi_parts, rows_pad: int, depth: int,
                 width: int) -> torch.Tensor:
    """uint8 limb planes (P, L, rows_pad, depth) of the words
    ``lo_parts``/``hi_parts`` ((P, rows, k) each), concatenated along
    the contraction and zero-padded."""
    lo = torch.cat(lo_parts, dim=-1)
    hi = None if width == 64 else torch.cat(hi_parts, dim=-1)
    parties, rows, kk = lo.shape
    planes = torch.zeros((parties, width // 8, rows_pad, depth),
                         dtype=torch.uint8, device=lo.device)
    for limb in range(width // 8):
        word = lo if limb < 8 else hi
        planes[:, limb, :rows, :kk] = torch.bitwise_and(
            ring.lshr64(word, 8 * (limb % 8)), 0xFF
        ).to(torch.uint8)
    return planes


def dot_limb_planes(x0: Pair, x1: Optional[Pair], y0: Optional[Pair],
                    ysum: Pair, width: int):
    """The K-major limb planes of the limb GEMM: A8 (P, L, m tiles * 64,
    K'p) of ``[x0 | x1]`` and B8 (P, L, n tiles * cols, K'p) of
    ``[ysum ; y0]`` transposed, K' = 2k padded to whole 32-byte chunks
    (of ``x0`` and ``ysum`` alone, K' = k, when ``x1`` and ``y0`` are
    None)."""
    parties, m, k = x0[0].shape
    n = ysum[0].shape[-1]
    xs, ys = (x0,), (ysum,)
    if x1 is not None:
        xs, ys = (x0, x1), (ysum, y0)
    mt, nt, kc, _, _ = dot_geometry(parties, m, k, n, width, len(xs))

    def t(w):
        return None if w is None else w.transpose(-1, -2)

    a8 = _limb_planes([x[0] for x in xs], [x[1] for x in xs],
                      mt * _DOT_BM, kc * _DOT_BK, width)
    b8 = _limb_planes([t(y[0]) for y in ys], [t(y[1]) for y in ys],
                      nt * dot_tile_cols(width), kc * _DOT_BK, width)
    return a8, b8


def dot_limb_tiles(planes: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The scratch bytes the split stage writes for ``planes`` (P, L,
    rows, K'p): [P][row tile][chunk][L][tile in wgmma's no-swizzle
    K-major layout], the tile as 8-row groups of two 16-byte K halves
    of 8 rows each ([group][half][row][16 bytes]), flat."""
    parties, limbs, rows, depth = planes.shape
    v = planes.reshape(parties, limbs, rows // tile_rows, tile_rows // 8, 8,
                       depth // _DOT_BK, 2, 16)
    # (P, L, T, rg, r8, kc, h, byte) -> (P, T, kc, L, rg, h, r8, byte)
    return v.permute(0, 2, 5, 1, 3, 6, 4, 7).reshape(-1)


def dot_cross_terms_limbs_plain(x0: Pair, x1: Optional[Pair],
                                y0: Optional[Pair], ysum: Pair, width: int,
                                depth: Optional[int] = None) -> Pair:
    """A plain model of the limb GEMM's arithmetic, for the tests: the
    K-major limb planes of the K-concatenated operands, per segment of
    ``depth`` (the kernel's ``dot_segment_depth``) the diagonal sums
    ``S_d = sum_{i+j=d} A_i B_j^T`` (raising AssertionError where a
    diagonal that needs its true value, d <= L-5, reaches 2^32), each
    reduced mod 2^32 as the s32 accumulators hold it, and the fold
    ``sum_d S_d << 8d`` mod 2^width into the result."""
    parties, m, _ = x0[0].shape
    n = ysum[0].shape[-1]
    limbs = width // 8
    depth = dot_segment_depth(width) if depth is None else depth
    a8, b8 = dot_limb_planes(x0, x1, y0, ysum, width)
    a = a8.to(torch.float64)
    b = b8.to(torch.float64).transpose(-1, -2)
    lo = torch.zeros((parties, a.shape[2], b.shape[-1]), dtype=torch.int64,
                     device=a.device)
    hi = None if width == 64 else torch.zeros_like(lo)
    for c0 in range(0, a.shape[-1], depth):
        c1 = min(c0 + depth, a.shape[-1])
        for d in range(limbs):
            # exact: at most 16 * 5504 products of 255^2, below 2^53
            s = sum(
                torch.matmul(a[:, i, :, c0:c1], b[:, d - i, c0:c1, :])
                for i in range(d + 1)
            ).to(torch.int64)
            if d <= limbs - 5 and bool((s >= 1 << 32).any()):
                raise AssertionError(
                    f"diagonal {d} reached 2^32 in a segment of depth "
                    f"{c1 - c0}"
                )
            s = torch.bitwise_and(s, ring.MASK32)
            if width == 64:
                lo = lo + ring.shl64(s, 8 * d)
            else:
                lo, hi = ring.add(lo, hi,
                                  *ring.shl(s, torch.zeros_like(s), 8 * d))
    return lo[:, :m, :n].contiguous(), (
        None if hi is None else hi[:, :m, :n].contiguous()
    )


def _dot_launch(x0: Pair, x1: Optional[Pair], y0: Optional[Pair],
                ysum: Pair, width: int) -> Pair:
    device = x0[0].device
    if device.type != "cuda" or x0[0].dim() != 3 or ysum[0].dim() != 3:
        raise ValueError(
            "dot_cross_terms takes (3, m, k) and (3, k, n) CUDA tensors"
        )
    if (x1 is None) != (y0 is None):
        raise ValueError("dot_cross_terms: x1 and y0 are given together")
    terms = 1 if x1 is None else 2
    if x1 is None:
        # the product-only mode: the kernel reads no K' past k, so x1 and
        # y0 are never read; x0 and ysum stand in as valid pointers
        x1, y0 = x0, ysum
    parties, m, k = x0[0].shape
    n = ysum[0].shape[-1]
    if max(m, k, n) >= 1 << 30:
        raise ValueError(f"dot_cross_terms: shape ({m}, {k}, {n}) too large")
    mt, _, _, a_bytes, b_bytes = dot_geometry(parties, m, k, n, width,
                                              terms)
    if mt > _MAX_GRID_Y or not 0 < parties <= _MAX_GRID_Y:
        raise ValueError(
            f"dot_cross_terms: ({parties}, {m}) rows exceed the grid's "
            f"{_MAX_GRID_Y} blocks of {_DOT_BM}"
        )
    wide = width == 128
    for label, pair, shape in (
        ("x0", x0, (parties, m, k)), ("x1", x1, (parties, m, k)),
        ("y0", y0, (parties, k, n)), ("ysum", ysum, (parties, k, n)),
    ):
        _check_pair(f"dot_cross_terms {label}", pair, shape, device, wide)
    out_lo = torch.empty((parties, m, n), dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo) if wide else None
    a8 = torch.empty(a_bytes, dtype=torch.uint8, device=device)
    b8 = torch.empty(b_bytes, dtype=torch.uint8, device=device)
    if out_lo.numel() == 0:
        return out_lo, out_hi
    lib = build.library("dot_cross_terms")
    with torch.cuda.device(device):
        err = lib.moose_dot_cross_terms(
            _ptr(x0[0]), _ptr(x0[1] if wide else None),
            _ptr(x1[0]), _ptr(x1[1] if wide else None),
            _ptr(y0[0]), _ptr(y0[1] if wide else None),
            _ptr(ysum[0]), _ptr(ysum[1] if wide else None),
            _ptr(out_lo), _ptr(out_hi), _ptr(a8), _ptr(b8), a_bytes, b_bytes,
            parties, m, k, n, int(wide), terms, _stream(device),
        )
    _raise_on("dot_cross_terms", err)
    return out_lo, out_hi


def dot_cross_terms(x0: Pair, x1: Optional[Pair], y0: Optional[Pair],
                    ysum: Pair, width: int) -> Pair:
    """Party-batched cross terms ``v_p = x0_p @ ysum_p + x1_p @ y0_p``
    mod 2^width for ``(3, m, k)`` and ``(3, k, n)`` ring pairs; the
    caller adds ``ysum = y0 + y1`` first.  With ``x1`` and ``y0`` None,
    the product-only mode: ``x0_p @ ysum_p``, one contraction of depth
    k.  On the card one call runs two device kernels (the limb split and
    the limb GEMM) and counts one launch."""
    if _on_cpu(x0[0]):
        return dot_cross_terms_plain(x0, x1, y0, ysum, width)
    if _on_meta(x0[0]):
        return _meta_words(tuple(x0[0].shape[:-1]) + (ysum[0].shape[-1],),
                           width, x0[0].device)
    out = _dot_launch(x0, x1, y0, ysum, width)
    if out[0].numel() > 0:
        LAUNCHES["dot_cross_terms"] += 1
    return out


def _as_parties(t: Optional[torch.Tensor], parties: int, rows: int,
                cols: int) -> Optional[torch.Tensor]:
    return None if t is None else t.reshape(parties, rows, cols).contiguous()


def _batched(x0: Pair, y: Pair, label: str):
    """The party count and (m, k, n) of a product of (..., m, k) and
    (..., k, n) ring words whose leading axes K1 takes as its party axis:
    equal batch axes, or a batched x against a matrix y (folded into
    x's rows)."""
    a, b = x0[0], y[0]
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f"{label}: cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")
    k, n = b.shape[-2], b.shape[-1]
    if b.dim() == 2:
        return 1, math.prod(a.shape[:-1]), k, n, a.shape[:-1] + (n,)
    if a.shape[:-2] != b.shape[:-2]:
        raise NotImplementedError(
            f"{label}: the card takes equal batch axes, got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}")
    parties = math.prod(a.shape[:-2])
    return parties, a.shape[-2], k, n, a.shape[:-1] + (n,)


def party_dot_cross_terms(x0: Pair, x1: Optional[Pair],
                          y0: Optional[Pair], ysum: Pair,
                          width: int) -> Pair:
    """:func:`dot_cross_terms` of one party's (..., m, k) and (..., k, n)
    operands: ``x0 @ ysum + x1 @ y0`` mod 2^width (``x0 @ ysum`` with
    ``x1`` and ``y0`` None).  The per-host layout runs each party's
    product through here: on the card one K1 launch with the batch (one
    party, or equal batch axes) as K1's party axis."""
    if _on_cpu(x0[0]):
        return dot_cross_terms_plain(x0, x1, y0, ysum, width)
    parties, m, k, n, out_shape = _batched(x0, ysum, "dot_cross_terms")
    wide = width == 128

    def fold(pair, rows, cols):
        if pair is None:
            return None
        return (_as_parties(pair[0], parties, rows, cols),
                _as_parties(pair[1] if wide else None, parties, rows, cols))

    lo, hi = dot_cross_terms(fold(x0, m, k), fold(x1, m, k),
                             fold(y0, k, n), fold(ysum, k, n), width)
    return lo.reshape(out_shape), (
        None if hi is None else hi.reshape(out_shape))


def ring_matmul(a: Pair, b: Pair, width: int) -> Pair:
    """``a @ b`` mod 2^width of (..., m, k) and (..., k, n) ring words.
    For the CPU the plain 16-bit-limb product; on the card K1 in its
    product-only mode (``x0 @ ysum``, depth k): PyTorch has no int64
    matrix product on CUDA, and the plain version's float64 limbs may
    not stand in for the kernel there."""
    if _on_cpu(a[0]):
        return ring_matmul_plain(a, b, width)
    return party_dot_cross_terms(a, None, None, b, width)


# ---------------------------------------------------------------------------
# K2: truncation tail
# ---------------------------------------------------------------------------


def trunc_combine_plain(a0: Pair, a1: Pair, draws, width: int,
                        amount: int):
    """The elementwise tail of probabilistic truncation given its five
    PRF draws (r, m_r, m_rt, m_rm, z0) — the math of
    ``spmd._trunc_combine_lax`` in the JAX package.  Returns the stacked
    (3, *shape) replicated values (z0, z1, y1) as (z_lo, z_hi)."""
    k = width - 1
    a0_lo, a0_hi = a0
    a1_lo, a1_hi = a1
    (r_lo, r_hi), r0, rt0, rm0, (z0_lo, z0_hi) = draws
    device = r_lo.device

    r_msb = ring.shr(r_lo, r_hi, width - 1)
    r_top = ring.shr(*ring.shl(r_lo, r_hi, 1), amount + 1)
    r1 = ring.sub(r_lo, r_hi, *r0)
    rt1 = ring.sub(*r_top, *rt0)
    rm1 = ring.sub(*r_msb, *rm0)

    ones = ring.fill_like_shape(r_lo.shape, width, 1, device)
    up = ring.shl(*ones, k - 1)
    down = ring.shl(*ones, k - amount - 1)

    a0p = ring.add(a0_lo, a0_hi, *up)
    m0 = ring.add(*a0p, *r0)
    m1 = ring.add(a1_lo, a1_hi, *r1)
    c = ring.add(*m0, *m1)

    ctop = ring.shr(*ring.shl(*c, 1), amount + 1)
    cmsb = ring.shr(*c, width - 1)
    cmsb_on = cmsb[0] != 0

    def adt_overflow(rm, first: bool):
        p_lo = torch.where(cmsb_on, rm[0], torch.zeros_like(rm[0]))
        p_hi = (
            None if rm[1] is None
            else torch.where(cmsb_on, rm[1], torch.zeros_like(rm[1]))
        )
        o = ring.sub(*rm, *ring.shl(p_lo, p_hi, 1))
        if first:
            o = ring.add(*o, *cmsb)
        return ring.shl(*o, k - amount)

    of0 = adt_overflow(rm0, True)
    of1 = adt_overflow(rm1, False)

    y0 = ring.sub(*ctop, *rt0)
    y0 = ring.add(*y0, *of0)
    y0 = ring.sub(*y0, *down)
    y1 = ring.add(*ring.neg(*rt1), *of1)

    z1 = ring.sub(*y0, z0_lo, z0_hi)
    z_lo = torch.stack([z0_lo, z1[0], y1[0]])
    z_hi = None if z0_hi is None else torch.stack([z0_hi, z1[1], y1[1]])
    return z_lo, z_hi


# csrc/trunc_combine.cu: its three inputs, and the draws it reads of the
# session's five (r, m_r, m_rt, m_rm, z0): m_r cancels in the reveal
_TRUNC_PAIRS, _TRUNC_CROSS, _TRUNC_ADDITIVE = 0, 1, 2
_TRUNC_DRAWS_READ = (0, 2, 3, 4)


def _trunc_launch(label: str, mode: int, parts, xp: int, dims, draws,
                  out: Pair, n: int, width: int, amount: int,
                  device: torch.device) -> None:
    """One launch of K2's kernel: ``parts`` the (lo, hi) words at which
    x's summed words start, ``draws`` the session's five (lo, hi)
    draws."""
    wide = width == 128
    words = ctypes.c_void_p * len(parts)
    x_lo = words(*(_ptr(p[0]) for p in parts))
    x_hi = words(*(_ptr(p[1]) if wide else None for p in parts))
    read = [draws[j] for j in _TRUNC_DRAWS_READ]
    d_lo = (ctypes.c_void_p * 4)(*(_ptr(d[0]) for d in read))
    d_hi = (ctypes.c_void_p * 4)(*(_ptr(d[1]) if wide else None
                                   for d in read))
    sizes, strides = _walk_axes(label, dims, 1)
    lib = build.library("trunc_combine")
    with torch.cuda.device(device):
        err = lib.moose_trunc_pairs(
            x_lo, x_hi, xp, len(dims), sizes, strides, d_lo, d_hi,
            _ptr(out[0]), _ptr(out[1]), n, mode, amount, int(wide),
            _stream(device),
        )
    _raise_on(label, err)


def trunc_combine(a0: Pair, a1: Pair, draws, width: int, amount: int):
    """The fused tail of ``spmd._trunc_pr_adt``: masks, reveal, overflow
    correction, downshift and additive-to-replicated, from the 2-party
    additive sharing (a0, a1) and the pre-drawn (r, m_r, m_rt, m_rm, z0).
    Returns the stacked (3, *shape) (z_lo, z_hi).  On the card it is
    K2's kernel on the additive input (the reveal reads a0 + a1, and not
    m_r, which cancels in it)."""
    if _on_cpu(a0[0]):
        return trunc_combine_plain(a0, a1, draws, width, amount)
    if _on_meta(a0[0]):
        return _meta_words((3,) + tuple(a0[0].shape), width, a0[0].device)
    if not 0 <= amount <= width - 2:
        raise ValueError(
            f"trunc_combine: amount {amount} out of range for ring{width}"
        )
    device = a0[0].device
    _require_cuda("trunc_combine", device)
    shape = tuple(a0[0].shape)
    wide = width == 128
    pairs = (a0, a1) + tuple(draws)
    labels = ("a0", "a1", "r", "m_r", "m_rt", "m_rm", "z0")
    if len(pairs) != 7:
        raise ValueError(f"trunc_combine: expected 5 draws, got {len(draws)}")
    for label, pair in zip(labels, pairs):
        _check_pair(f"trunc_combine {label}", pair, shape, device, wide)
    out_lo = torch.empty((3,) + shape, dtype=torch.int64,
                         device=a0[0].device)
    out_hi = torch.empty_like(out_lo) if wide else None
    n = a0[0].numel()
    if n == 0:
        return out_lo, out_hi
    _trunc_launch("trunc_combine", _TRUNC_ADDITIVE, (a0, a1), 0, [],
                  tuple(draws), (out_lo, out_hi), n, width, amount, device)
    LAUNCHES["trunc_combine"] += 1
    return out_lo, out_hi


def trunc_pairs_plain(x: Pair, draws: Pair, width: int, amount: int,
                      bank: Optional[Pair] = None) -> Pair:
    """:func:`trunc_pairs` in plain PyTorch, as the protocol computes it:
    the operand's 2-party additive form (slot 0 of each party, or the
    cross terms plus the zero share of ``bank``), :func:`trunc_combine_plain`
    over the five draws of the (5, *shape) block, and the pair layout of
    its result."""
    if bank is None:
        z = _slot(x, 0, x[0].shape[2:])
    else:
        z = ring.add(*x, *ring.sub(*bank, _roll(bank[0]), _roll(bank[1])))
    a0 = ring.add(z[0][0], _at(z[1], 0), z[0][1], _at(z[1], 1))
    a1 = z[0][2], _at(z[1], 2)
    d = tuple((draws[0][j], _at(draws[1], j)) for j in range(5))
    q = trunc_combine_plain(a0, a1, d, width, amount)
    return tuple(
        None if w is None else torch.stack([w, _roll(w)], dim=1) for w in q
    )


def trunc_pairs(x: Pair, draws: Pair, width: int, amount: int,
                bank: Optional[Pair] = None) -> Pair:
    """Probabilistic truncation by ``amount`` after its draws, in one
    kernel, from the pair layout to the pair layout.

    Without ``bank``, ``x`` is the (lo, hi) words of a consistent
    replicated sharing in the (3, 2, *shape) pair layout, read in place
    through its strides, slot 0 of each party only: a0 = x_0 + x_1,
    a1 = x_2.  With ``bank``, ``x`` is a matrix product's contiguous
    (3, *shape) cross terms v and ``bank`` the contiguous (3, *shape)
    zero-share draw: z_p = v_p + s_p - s_{p+1}, a0 = z_0 + z_1,
    a1 = z_2.  ``draws`` is the contiguous (5, *shape) block of r, m_r,
    m_rt, m_rm, z0, as the session drew them.  Returns the result's
    contiguous (3, 2, *shape) pair layout: word for word the pair layout
    of :func:`trunc_combine` on (a0, a1) and the five draws.

    The reveal depends only on a0 + a1, in which the zero shares cancel,
    and not on m_r: the kernel reads neither the bank nor m_r (the plain
    version computes with both, as the protocol does)."""
    if not 0 <= amount <= width - 2:
        raise ValueError(
            f"trunc_pairs: amount {amount} out of range for ring{width}"
        )
    lead = (3, 2) if bank is None else (3,)
    lo = x[0]
    if tuple(lo.shape[:len(lead)]) != lead:
        raise ValueError(
            f"trunc_pairs: expected {lead + ('*shape',)} words, got "
            f"{tuple(lo.shape)}"
        )
    shape = tuple(lo.shape[len(lead):])
    if tuple(draws[0].shape) != (5,) + shape:
        raise ValueError(
            f"trunc_pairs: expected (5, *{shape}) draws, got "
            f"{tuple(draws[0].shape)}"
        )
    if _on_cpu(lo):
        return trunc_pairs_plain(x, draws, width, amount, bank)
    if _on_meta(lo):
        return _meta_words((3, 2) + shape, width, lo.device)
    device = lo.device
    _require_cuda("trunc_pairs", device)
    wide = width == 128
    if bank is None:
        _check_strided("trunc_pairs x", x, lo.shape, device, wide)
    else:
        _check_pair("trunc_pairs v", x, lo.shape, device, wide)
        _check_pair("trunc_pairs bank", bank, lo.shape, device, wide)
    _check_pair("trunc_pairs draws", draws, (5,) + shape, device, wide)
    out_lo = torch.empty((3, 2) + shape, dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo) if wide else None
    n = math.prod(shape)
    if n == 0:
        return out_lo, out_hi
    if bank is None:
        mode, xp, dims = _TRUNC_PAIRS, lo.stride(0), walk_dims(shape, lo)
    else:
        mode, xp, dims = _TRUNC_CROSS, n, []
    rows = tuple((draws[0][j], _at(draws[1], j)) for j in range(5))
    _trunc_launch("trunc_pairs", mode, (x,), xp, dims, rows,
                  (out_lo, out_hi), n, width, amount, device)
    LAUNCHES["trunc_pairs"] += 1
    return out_lo, out_hi


# ---------------------------------------------------------------------------
# K3: elementwise cross terms
# ---------------------------------------------------------------------------


def cross_terms_mul_plain(x0: Pair, x1: Pair, y0: Pair, y1: Pair,
                          width: int) -> Pair:
    return ring.add(
        *ring.mul(*x0, *ring.add(*y0, *y1)), *ring.mul(*x1, *y0)
    )


def cross_terms_mul(x0: Pair, x1: Pair, y0: Pair, y1: Pair,
                    width: int) -> Pair:
    """Elementwise ``v = x0 * (y0 + y1) + x1 * y0 mod 2^width`` — the
    regrouped cross terms of a secure multiply — for four ring pairs of
    one shape (the party axis rides in it)."""
    if _on_cpu(x0[0]):
        return cross_terms_mul_plain(x0, x1, y0, y1, width)
    if _on_meta(x0[0]):
        return _meta_words(x0[0].shape, width, x0[0].device)
    device = x0[0].device
    _require_cuda("cross_terms_mul", device)
    shape = tuple(x0[0].shape)
    wide = width == 128
    pairs = (x0, x1, y0, y1)
    for label, pair in zip(("x0", "x1", "y0", "y1"), pairs):
        _check_pair(f"cross_terms_mul {label}", pair, shape, device, wide)
    out_lo = torch.empty(shape, dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo) if wide else None
    n = out_lo.numel()
    if n == 0:
        return out_lo, out_hi
    lib = build.library("cross_terms_mul")
    ptrs = []
    for pair in pairs:
        ptrs += [_ptr(pair[0]), _ptr(pair[1] if wide else None)]
    with torch.cuda.device(device):
        err = lib.moose_cross_terms_mul(
            *ptrs, _ptr(out_lo), _ptr(out_hi), n, int(wide), _stream(device)
        )
    _raise_on("cross_terms_mul", err)
    LAUNCHES["cross_terms_mul"] += 1
    return out_lo, out_hi


def _slot(t: Pair, slot: int, shape) -> Pair:
    """Pair slot ``slot`` of (3, 2, *own) words broadcast to (3, *shape)."""

    def words(w):
        if w is None:
            return None
        w = w[:, slot]
        w = w.reshape((3,) + (1,) * (len(shape) + 1 - w.dim())
                      + tuple(w.shape[1:]))
        return w.expand((3,) + tuple(shape))

    return words(t[0]), words(t[1])


def cross_terms_reshare_plain(x: Pair, y: Pair, bank: Pair,
                              width: int) -> Pair:
    """``spmd.mul`` as it was composed before the fused kernel: the plain
    cross terms of the pair slots broadcast to the common shape, the zero
    share ``s_i - s_{i+1}`` of ``bank`` added, and the pair layout
    (z_i, z_{i+1}) stacked."""
    shape = torch.broadcast_shapes(x[0].shape[2:], y[0].shape[2:])
    v = cross_terms_mul_plain(_slot(x, 0, shape), _slot(x, 1, shape),
                              _slot(y, 0, shape), _slot(y, 1, shape), width)
    zero = ring.sub(bank[0], bank[1], _roll(bank[0]), _roll(bank[1]))
    z = ring.add(*v, *zero)
    return tuple(
        None if w is None else torch.stack([w, _roll(w)], dim=1) for w in z
    )


def _check_pair_layout(label: str, pair: Pair, device: torch.device,
                       wide: bool) -> None:
    lo, hi = pair
    if lo.device != device or lo.dtype != torch.int64:
        raise ValueError(
            f"{label}: expected int64 words on {device}, got {lo.dtype} on "
            f"{lo.device}"
        )
    if lo.dim() < 2 or tuple(lo.shape[:2]) != (3, 2):
        raise ValueError(
            f"{label}: expected (3, 2, *shape) words, got {tuple(lo.shape)}"
        )
    if wide and (hi is None or hi.dtype != torch.int64 or hi.device != device
                 or hi.shape != lo.shape or hi.stride() != lo.stride()):
        raise ValueError(f"{label}: hi words missing or laid out unlike lo")


def cross_terms_reshare(x: Pair, y: Pair, bank: Pair, width: int) -> Pair:
    """A secure elementwise multiply's cross terms and reshare in one
    kernel: ``x`` and ``y`` are (lo, hi) words in the (3, 2, *shape) pair
    layout of consistent replicated sharings (slot 1 of party i is slot 0
    of party i + 1; the kernel reads slot 0 only), of logical shapes that
    broadcast to a common one, read in place through their strides;
    ``bank`` the contiguous (3, *common) zero-share draw.  Returns the
    reshared pair layout (3, 2, *common): ``out[i, 0] = z_i``,
    ``out[i, 1] = z_{i+1}`` with ``z_i = x_i (y_i + y_{i+1}) + x_{i+1}
    y_i + s_i - s_{i+1}``."""
    shape = tuple(torch.broadcast_shapes(x[0].shape[2:], y[0].shape[2:]))
    if _on_cpu(x[0]):
        return cross_terms_reshare_plain(x, y, bank, width)
    if _on_meta(x[0]):
        return _meta_words((3, 2) + shape, width, x[0].device)
    device = x[0].device
    _require_cuda("cross_terms_reshare", device)
    wide = width == 128
    _check_pair_layout("cross_terms_reshare x", x, device, wide)
    _check_pair_layout("cross_terms_reshare y", y, device, wide)
    _check_pair("cross_terms_reshare bank", bank, (3,) + shape, device, wide)
    out_lo = torch.empty((3, 2) + shape, dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo) if wide else None
    n = math.prod(shape)
    if n == 0:
        return out_lo, out_hi
    dims = walk_dims(shape, x[0], y[0])
    sizes, xs, ys = _walk_axes("cross_terms_reshare", dims, 2)
    lib = build.library("cross_terms_mul")
    with torch.cuda.device(device):
        err = lib.moose_cross_terms_reshare(
            _ptr(x[0]), _ptr(x[1] if wide else None),
            _ptr(y[0]), _ptr(y[1] if wide else None),
            _ptr(bank[0]), _ptr(bank[1] if wide else None),
            _ptr(out_lo), _ptr(out_hi), n, int(wide), len(dims), sizes, xs,
            ys, x[0].stride(0), y[0].stride(0), _stream(device),
        )
    _raise_on("cross_terms_reshare", err)
    LAUNCHES["cross_terms_reshare"] += 1
    return out_lo, out_hi


# ---------------------------------------------------------------------------
# K4: elementwise ring multiply
# ---------------------------------------------------------------------------


# csrc/ring_mul.cu: b's modes and the most axes of a strided b
_B_FULL, _B_SCALAR, _B_STRIDED = 0, 1, 2
_MUL_MAX_DIMS = 8
_MulAxes = ctypes.c_longlong * _MUL_MAX_DIMS


def _broadcasts(b_shape, shape) -> bool:
    """Whether ``b_shape`` broadcasts to ``shape`` (numpy rules), without
    the host time of ``torch.broadcast_shapes`` on every call."""
    if len(b_shape) > len(shape):
        return False
    return all(b in (1, s) for b, s in zip(b_shape[::-1], shape[::-1]))


def ring_mul_plain(lo1, hi1, lo2, hi2, width: int) -> Pair:
    """``a * b`` with PyTorch's broadcasting of b to a's shape."""
    return ring.mul(lo1, hi1, lo2, hi2)


def ring_mul_dims(shape, b: torch.Tensor):
    """b's (size, stride) axes over the flat elements of ``shape``, b
    read through its own strides with 0 on a broadcast axis, size-1 axes
    dropped and neighbours that step alike merged, innermost last: what
    the kernel walks for a strided b."""
    pad = len(shape) - b.dim()
    dims = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        bd = d - pad
        stride = 0 if bd < 0 or b.shape[bd] == 1 else b.stride(bd)
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    return dims


def _words_at_parity(shape, like: torch.Tensor) -> torch.Tensor:
    """Empty int64 words of ``shape`` whose first word has the 16-byte
    parity of ``like``'s, so the kernel's 16-byte accesses of the two
    line up after the same scalar head."""
    n = math.prod(shape)
    if like.data_ptr() % 16 == 0:
        return torch.empty(shape, dtype=torch.int64, device=like.device)
    buf = torch.empty(n + 1, dtype=torch.int64, device=like.device)
    start = 1 if buf.data_ptr() % 16 == 0 else 0
    return buf[start:start + n].view(shape)


def ring_mul(lo1, hi1, lo2, hi2, width: int) -> Pair:
    """Elementwise ``a * b mod 2^width``: ``a`` the (lo, hi) words of
    the shares, ``b`` the other factor at a's shape or at any shape that
    broadcasts to it under numpy rules (``spmd.mul_public`` passes the
    public constant at its own shape; the kernel broadcasts it).  The
    result has a's shape."""
    shape = tuple(lo1.shape)
    b_shape = tuple(lo2.shape)
    if b_shape != shape and not _broadcasts(b_shape, shape):
        raise ValueError(
            f"ring_mul: b of shape {b_shape} does not broadcast to the "
            f"shares' shape {shape}"
        )
    if _on_cpu(lo1):
        return ring_mul_plain(lo1, hi1, lo2, hi2, width)
    if _on_meta(lo1):
        return _meta_words(shape, width, lo1.device)
    device = lo1.device
    _require_cuda("ring_mul", device)
    wide = width == 128
    _check_pair("ring_mul a", (lo1, hi1), shape, device, wide)
    if wide and (hi2 is None or hi2.shape != lo2.shape
                 or hi2.stride() != lo2.stride()):
        raise ValueError("ring_mul b: hi words missing or laid out unlike lo")
    for t in (lo2, hi2) if wide else (lo2,):
        if t.device != device or t.dtype != torch.int64:
            raise ValueError(
                f"ring_mul b: expected int64 words on {device}, got "
                f"{t.dtype} on {t.device}"
            )
    n = math.prod(shape)
    out_lo = _words_at_parity(shape, lo1)
    out_hi = _words_at_parity(shape, lo1) if wide else None
    if n == 0:
        return out_lo, out_hi
    dims = sizes = strides = None
    if b_shape == shape and lo2.is_contiguous():
        mode = _B_FULL
    elif lo2.numel() == 1:
        mode = _B_SCALAR
    else:
        mode = _B_STRIDED
        dims = ring_mul_dims(shape, lo2)
        if len(dims) > _MUL_MAX_DIMS:
            raise ValueError(
                f"ring_mul: b's broadcast takes {len(dims)} axes, the "
                f"kernel at most {_MUL_MAX_DIMS}"
            )
        sizes = _MulAxes(*(size for size, _ in dims))
        strides = _MulAxes(*(stride for _, stride in dims))
    lib = build.library("ring_mul")
    with torch.cuda.device(device):
        err = lib.moose_ring_mul(
            _ptr(lo1), _ptr(hi1 if wide else None),
            _ptr(lo2), _ptr(hi2 if wide else None),
            _ptr(out_lo), _ptr(out_hi), n, int(wide), mode,
            0 if dims is None else len(dims), sizes, strides,
            _stream(device),
        )
    _raise_on("ring_mul", err)
    LAUNCHES["ring_mul"] += 1
    return out_lo, out_hi


# ---------------------------------------------------------------------------
# K5: bit decomposition through the Kogge-Stone adder (and its msb)
# ---------------------------------------------------------------------------


def adder_bank_count(width: int) -> int:
    """How many AND banks a decomposition consumes, in this order: 2
    carry-save ANDs, the adder's first g = x AND y, then per round the g
    update and, while 2d < k, the p_run update."""
    n = 3
    d = 1
    while d < width:
        n += 2 if d * 2 < width else 1
        d *= 2
    return n


def bit_decompose_plain(lo, hi, width: int, banks) -> torch.Tensor:
    """The unfused decomposition over the same banks
    (``spmd_math._bit_decompose_with_banks``)."""
    # imported here: spmd_math is built on this module
    from ..parallel import spmd_math

    return spmd_math._bit_decompose_with_banks(lo, hi, width, banks)


def msb_plain(lo, hi, width: int, banks) -> torch.Tensor:
    return bit_decompose_plain(lo, hi, width, banks)[:, :, width - 1]


def bits_bank_masks_plain(banks: torch.Tensor, width: int) -> torch.Tensor:
    """What the kernel's pack stage writes for ``banks`` (n_ands, 3,
    width, *shape): int64 masks (n_ands, 3, width // 64, n), n the
    elements flat, bit b of word w of element e being bit 0 of the bank
    byte at bit row 64 w + b."""
    n_ands = banks.shape[0]
    rows = banks.reshape(n_ands, 3, width // 64, 64, -1)
    masks = torch.zeros(rows.shape[:3] + rows.shape[4:], dtype=torch.int64,
                        device=banks.device)
    for b in range(64):
        bit = torch.bitwise_and(rows[:, :, :, b], 1).to(torch.int64)
        masks = torch.bitwise_or(masks, ring.shl64(bit, b))
    return masks


def bit_decompose_masks_plain(lo, hi, width: int, masks: torch.Tensor,
                              msb_only: bool) -> torch.Tensor:
    """The kernel's adder stage in plain PyTorch: the decomposition of the
    (3, 2, *shape) words ``(lo, hi)`` from the packed ``masks`` of
    :func:`bits_bank_masks_plain`, each (party, slot) bit vector a ring
    word whose bit j is bit j, a shift along the bits a word shift and
    the party roll a roll of the party axis.  Returns what
    ``bit_decompose`` (or, with ``msb_only``, ``msb``) returns."""
    data = tuple(lo.shape[2:])
    x = (lo.reshape(3, 2, -1), None if hi is None else hi.reshape(3, 2, -1))
    zero = torch.zeros_like(x[0])

    def where(mask, w):
        return None if w is None else torch.where(mask, w, zero)

    def xor(a, b):
        return torch.bitwise_xor(a[0], b[0]), (
            None if a[1] is None else torch.bitwise_xor(a[1], b[1])
        )

    def and_(a, b):
        return torch.bitwise_and(a[0], b[0]), (
            None if a[1] is None else torch.bitwise_and(a[1], b[1])
        )

    def at(a, slot):
        return a[0][:, slot], None if a[1] is None else a[1][:, slot]

    def roll(a):
        return tuple(None if w is None else torch.roll(w, -1, dims=0)
                     for w in a)

    def stack(a, b):
        return tuple(None if u is None else torch.stack([u, v], dim=1)
                     for u, v in zip(a, b))

    def shl(a, d):
        return ring.shl(a[0], a[1], d)

    banks = iter(masks)

    def bits_and(a, b):
        bank = next(banks)  # (3, words, n)
        s = bank[:, 0], None if width == 64 else bank[:, 1]
        v = xor(and_(at(a, 0), xor(at(b, 0), at(b, 1))),
                and_(at(a, 1), at(b, 0)))
        z = xor(v, xor(s, roll(s)))
        return stack(z, roll(z))

    # summand j is the share x_j, held at pair slots (j, 0) and (j-1, 1)
    summands = []
    for j in range(3):
        held = torch.zeros((3, 2, 1), dtype=torch.bool, device=lo.device)
        held[j, 0] = held[(j - 1) % 3, 1] = True
        summands.append((where(held, x[0]), where(held, x[1])))
    b0, b1, b2 = summands
    b01 = xor(b0, b1)
    total = xor(b01, b2)
    carry = xor(bits_and(b0, b1), bits_and(b01, b2))
    y = shl(carry, 1)
    prop = xor(total, y)
    g = bits_and(total, y)
    p_run = prop
    d = 1
    while d < width:
        g = xor(g, bits_and(p_run, shl(g, d)))
        if 2 * d < width:
            p_run = bits_and(p_run, shl(p_run, d))
        d *= 2
    r = xor(prop, shl(g, 1))
    if msb_only:
        top = r[0] if width == 64 else r[1]
        return torch.bitwise_and(ring.lshr64(top, 63), 1).to(
            torch.uint8).reshape((3, 2) + data)
    shifts = torch.arange(64, dtype=torch.int64, device=lo.device)[:, None]
    planes = [torch.bitwise_and(w[:, :, None] >> shifts, 1)
              for w in (r if width == 128 else r[:1])]
    return torch.cat(planes, dim=2).to(torch.uint8).reshape(
        (3, 2, width) + data)


def _bits_adder(lo, hi, width: int, banks, msb_only: bool) -> torch.Tensor:
    name = "msb" if msb_only else "bit_decompose"
    shape = tuple(lo.shape)
    if len(shape) < 2 or shape[:2] != (3, 2):
        raise ValueError(f"{name}: expected (3, 2, *shape) words, got {shape}")
    data = shape[2:]
    # a bank short or too many would skew the draw stream: refuse both
    bank_shape = (adder_bank_count(width), 3, width) + data
    if banks.dtype != torch.uint8 or tuple(banks.shape) != bank_shape:
        raise ValueError(
            f"{name}: expected uint8 banks {bank_shape}, got {banks.dtype} "
            f"{tuple(banks.shape)}"
        )
    if _on_cpu(lo):
        plain = msb_plain if msb_only else bit_decompose_plain
        return plain(lo, hi, width, banks)
    if _on_meta(lo):
        return torch.empty((3, 2) + (() if msb_only else (width,)) + data,
                           dtype=torch.uint8, device=lo.device)
    device = lo.device
    _require_cuda(name, device)
    wide = width == 128
    _check_pair(f"{name} x", (lo, hi), shape, device, wide)
    if banks.device != device or not banks.is_contiguous():
        raise ValueError(f"{name}: expected contiguous banks on {device}")
    out_shape = (3, 2) + (() if msb_only else (width,)) + data
    out = torch.empty(out_shape, dtype=torch.uint8, device=device)
    n = math.prod(data)
    if n == 0:
        return out
    # the pack stage's output, the adder's input
    masks = torch.empty(bank_shape[0] * 3 * (width // 64) * n,
                        dtype=torch.int64, device=device)
    lib = build.library("bits_adder")
    with torch.cuda.device(device):
        err = lib.moose_bits_adder(
            _ptr(lo), _ptr(hi if wide else None), _ptr(banks), _ptr(masks),
            _ptr(out), n, int(wide), int(msb_only), _stream(device),
        )
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def bit_decompose(lo, hi, width: int, banks) -> torch.Tensor:
    """Arithmetic -> binary sharing of the (3, 2, *shape) ring sharing
    ``(lo, hi)``: bit planes of the held shares, the statically masked
    summands, carry-save and a Kogge-Stone adder, consuming the uint8
    AND banks ``(adder_bank_count(width), 3, width, *shape)`` the caller
    drew.  Returns the uint8 bit sharing (3, 2, width, *shape).  On the
    card one call runs two device kernels (the banks packed into masks,
    then the adder) and counts one launch."""
    return _bits_adder(lo, hi, width, banks, msb_only=False)


def msb(lo, hi, width: int, banks) -> torch.Tensor:
    """:func:`bit_decompose` writing only the top bit: (3, 2, *shape)."""
    return _bits_adder(lo, hi, width, banks, msb_only=True)


# ---------------------------------------------------------------------------
# K6: fused Horner ladder
# ---------------------------------------------------------------------------

# csrc/horner.cu carries the coefficients in its argument block
_MAX_HORNER_COEFFS = 64


def _at_party(party: int, raw: int, like: torch.Tensor, width: int) -> Pair:
    """(3, *shape) ring words holding ``raw`` in row ``party``, 0 in the
    others: one pair slot of a trivial public sharing."""
    lo, hi = ring.fill_like_shape(like.shape, width, 0, like.device)
    c_lo, c_hi = ring.fill_like_shape((), width, raw, like.device)
    lo[party] = c_lo
    if hi is not None:
        hi[party] = c_hi
    return lo, hi


def horner_plain(x0: Pair, x1: Pair, width: int, raws, f: int, zbanks: Pair,
                 tdraws: Pair):
    """The unfused ladder over the same draws (``spmd_math._horner_lax``
    of the JAX package fed the pre-drawn values), from the plain K3 and
    K2: per step the cross terms of acc * x, the zero share
    ``s_p - s_{p+1}``, the truncation tail and the next coefficient at
    pair slots (0, 0) and (2, 1)."""
    like = x0[0]
    acc0 = _at_party(0, raws[0], like, width)
    acc1 = _at_party(2, raws[0], like, width)
    for step, raw in enumerate(raws[1:]):
        v = cross_terms_mul_plain(acc0, acc1, x0, x1, width)
        s = (zbanks[0][step], _at(zbanks[1], step))
        z_lo, z_hi = ring.add(*v, *ring.sub(*s, _roll(s[0]), _roll(s[1])))
        a0 = ring.add(z_lo[0], _at(z_hi, 0), z_lo[1], _at(z_hi, 1))
        a1 = (z_lo[2], _at(z_hi, 2))
        draws = tuple(
            (tdraws[0][step, d], _at(tdraws[1], step, d)) for d in range(5)
        )
        q_lo, q_hi = trunc_combine_plain(a0, a1, draws, width, f)
        acc0 = ring.add(q_lo, q_hi, *_at_party(0, raw, like, width))
        acc1 = ring.add(_roll(q_lo), _roll(q_hi),
                        *_at_party(2, raw, like, width))
    return acc0, acc1


def horner_lanes(n: int) -> int:
    """The horner kernel's variant for ``n`` elements: three lanes an
    element (ten elements a block that computes their masks first) while
    the ladder's steps bound it, up to 4,096 elements; one thread an
    element beyond, where its bytes do (``scripts/kernel_ab.py --part
    horner`` measured the crossing)."""
    return 3 if n <= _HORNER_LANES_MAX_N else 1


# csrc/horner.cu: three lanes an element up to this many elements
_HORNER_LANES_MAX_N = 1 << 12


def _horner_launch(x0: Pair, x1: Pair, width: int, raws, f: int,
                   zbanks: Pair, tdraws: Pair) -> Pair:
    device = x0[0].device
    _require_cuda("horner", device)
    steps = len(raws) - 1
    if not 0 < steps < _MAX_HORNER_COEFFS:
        raise ValueError(
            f"horner: {steps} steps, expected 1 to {_MAX_HORNER_COEFFS - 1}"
        )
    if not 0 <= f <= width - 2:
        raise ValueError(f"horner: amount {f} out of range for ring{width}")
    wide = width == 128
    full = tuple(x0[0].shape)
    if len(full) < 1 or full[0] != 3:
        raise ValueError(f"horner: expected (3, *shape) slots, got {full}")
    shape = full[1:]
    _check_strided("horner x0", x0, full, device, wide)
    _check_strided("horner x1", x1, full, device, wide)
    _check_pair("horner zbanks", zbanks, (steps,) + full, device, wide)
    _check_pair("horner tdraws", tdraws, (steps, 5) + shape, device, wide)
    out_lo = torch.empty((3, 2) + shape, dtype=torch.int64, device=device)
    out_hi = torch.empty_like(out_lo) if wide else None
    n = math.prod(shape)
    if n == 0:
        return out_lo, out_hi
    dims = walk_dims(shape, x0[0], x1[0], lead=1)
    sizes, s0, s1 = _walk_axes("horner", dims, 2)
    words = ctypes.c_uint64 * len(raws)
    c_lo = words(*(int(r) & ring.MASK64 for r in raws))
    c_hi = words(*((int(r) >> 64) & ring.MASK64 for r in raws))
    lib = build.library("horner")
    with torch.cuda.device(device):
        err = lib.moose_horner(
            _ptr(x0[0]), _ptr(x0[1] if wide else None), x0[0].stride(0),
            _ptr(x1[0]), _ptr(x1[1] if wide else None), x1[0].stride(0),
            len(dims), sizes, s0, s1,
            _ptr(tdraws[0]), _ptr(tdraws[1] if wide else None),
            _ptr(out_lo), _ptr(out_hi), c_lo, c_hi, steps, f, n,
            horner_lanes(n), int(wide), _stream(device),
        )
    _raise_on("horner", err)
    LAUNCHES["horner"] += 1
    return out_lo, out_hi


def horner(x0: Pair, x1: Pair, width: int, raws, f: int, zbanks: Pair,
           tdraws: Pair):
    """Fused fixed-point Horner ladder (``spmd_math.polynomial_eval``):
    every step's cross terms, zero-share add, truncation by ``f`` and
    coefficient add in one kernel.  ``x0``/``x1`` are the (3, *shape)
    pair slots of x, read in place through their strides; ``raws`` the
    raw coefficients highest degree first (``raws[0]`` seeds the
    accumulator); ``zbanks`` the contiguous (steps, 3, *shape) zero-share
    banks and ``tdraws`` the contiguous (steps, 5, *shape) truncation
    draws, drawn by the caller in the unfused ladder's order.  Returns
    the (slot 0, slot 1) pair slots of the result: on the card, views of
    the pair layout :func:`horner_pairs` returns.

    A step's truncation reveals the sum of its reshared cross terms, in
    which the zero shares cancel, and m_r cancels in the reveal: the
    kernel reads neither ``zbanks`` (their shape is checked) nor m_r, and
    the plain version computes with both, as the protocol does."""
    if _on_cpu(x0[0]):
        return horner_plain(x0, x1, width, raws, f, zbanks, tdraws)
    if _on_meta(x0[0]):
        lo, hi = _meta_words((3, 2) + tuple(x0[0].shape[1:]), width,
                             x0[0].device)
    else:
        lo, hi = _horner_launch(x0, x1, width, raws, f, zbanks, tdraws)
    return tuple((lo[:, s], _at(hi, slice(None), s)) for s in (0, 1))


def horner_pairs_plain(x: Pair, width: int, raws, f: int, zbanks: Pair,
                       tdraws: Pair) -> Pair:
    """:func:`horner_plain` on x's pair slots, its result's two slots
    stacked into the pair layout."""
    shape = x[0].shape[2:]
    acc = horner_plain(_slot(x, 0, shape), _slot(x, 1, shape), width, raws,
                       f, zbanks, tdraws)
    return tuple(None if w0 is None else torch.stack([w0, w1], dim=1)
                 for w0, w1 in zip(*acc))


def horner_pairs(x: Pair, width: int, raws, f: int, zbanks: Pair,
                 tdraws: Pair) -> Pair:
    """:func:`horner` on x's (3, 2, *shape) pair layout, its two slots
    read in place: returns the result's contiguous (3, 2, *shape) pair
    layout."""
    if _on_cpu(x[0]):
        return horner_pairs_plain(x, width, raws, f, zbanks, tdraws)
    shape = x[0].shape[2:]
    if _on_meta(x[0]):
        return _meta_words((3, 2) + tuple(shape), width, x[0].device)
    return _horner_launch(_slot(x, 0, shape), _slot(x, 1, shape), width,
                          raws, f, zbanks, tdraws)


# ---------------------------------------------------------------------------
# K7: threefry counter-mode expansion (both PRF streams), grouped
# ---------------------------------------------------------------------------

# csrc/threefry.cu's code of each stream layout, and its LAUNCHES name
PRF_LAYOUTS = {
    "threefry": (0, "prf_threefry"),
    "threefry-pallas": (1, "prf_threefry_pallas"),
}
# a threefry-pallas key covers 2^32 words: its counter is the u32 lane
# index, and a repeated counter would repeat a mask
PALLAS_MAX_WORDS = 1 << 32
# csrc/threefry.cu: the most draws one launch takes (a larger group takes
# several launches), and the kind bits of a draw
GROUP_MAX_DRAWS = 224
_KIND_BITS, _KIND_TWO_PLANES = 1, 2


class GroupDraw(NamedTuple):
    """One draw of a group: ``n`` outputs per plane, ``bits`` (uint8
    0/1) or u64 words (as int64), written to ``planes``: (buffer, offset)
    pairs, each n outputs at element ``offset`` of a contiguous
    ``buffer``, in stream order.  A ring64 draw or a bit draw has one
    plane; a ring128 draw is one (2, n) draw, its stream words [0, n) the
    high plane and [n, 2n) the low plane, so its planes are (hi, lo)."""

    bits: bool
    n: int
    planes: Tuple[Tuple[torch.Tensor, int], ...]


def refuse_beyond_counter(layout: str, bits: bool, n: int,
                          planes: int = 1) -> None:
    """Refuse a ``threefry-pallas`` draw of more than 2^32 words (``n``
    outputs per plane, bits 64 to a word): its counter would repeat an
    earlier lane's, and in the protocol that is a reused mask.  Callers
    check before they allocate."""
    if layout != "threefry-pallas":
        return
    words = -(-n // 64) if bits else planes * n
    if words > PALLAS_MAX_WORDS:
        raise ValueError(
            f"threefry-pallas draw of {words} words exceeds the 2^32 "
            "counter space of one key"
        )


def _check_layout(layout: str) -> None:
    if layout not in PRF_LAYOUTS:
        raise ValueError(
            f"threefry: layout must be one of {tuple(PRF_LAYOUTS)}, got "
            f"{layout!r}"
        )


def _prf_blocks(k0: int, k1: int, n: int, layout: str, device):
    """The encrypted counter blocks (y0, y1) of elements 0..n-1 of a
    stream, as int64 tensors holding u32 values."""
    c = torch.arange(n, dtype=torch.int64, device=device)
    if layout == "threefry":
        x0, x1 = c >> 32, torch.bitwise_and(c, ring.MASK32)
    else:
        x0, x1 = c, ring.MASK32 - c
    return ring.threefry2x32_20(x0, x1, k0, k1)


def threefry_words_plain(k0: int, k1: int, n: int, layout: str,
                         device) -> torch.Tensor:
    y0, y1 = _prf_blocks(k0, k1, n, layout, device)
    return torch.bitwise_or(y0 << 32, y1)


def threefry_bits_plain(k0: int, k1: int, n: int, layout: str,
                        device) -> torch.Tensor:
    if layout == "threefry":
        y0, y1 = _prf_blocks(k0, k1, n, layout, device)
        bits = torch.bitwise_and(torch.bitwise_xor(y0, y1), 1)
        return bits.to(torch.uint8)
    words = threefry_words_plain(k0, k1, -(-n // 64), layout, device)
    shifts = torch.arange(64, dtype=torch.int64, device=device)
    # bit j of an int64 word, whatever its sign: arithmetic shift, then & 1
    bits = torch.bitwise_and(words[:, None] >> shifts, 1).reshape(-1)
    return bits[:n].to(torch.uint8)


def _expand_plain(key, layout: str, draw: GroupDraw) -> None:
    """Expand one draw of ``key`` into its planes."""
    n = draw.n
    device = draw.planes[0][0].device
    if draw.bits:
        out = threefry_bits_plain(*key, n, layout, device)
        parts = [out]
    else:
        words = threefry_words_plain(*key, len(draw.planes) * n, layout,
                                     device)
        parts = [words[p * n:(p + 1) * n] for p in range(len(draw.planes))]
    for (buf, offset), part in zip(draw.planes, parts):
        buf.view(-1)[offset:offset + n].copy_(part)


def threefry_group_plain(master, domain: int, first: int, layout: str,
                         draws) -> None:
    """The group's draws one by one, as the session drew them before the
    group kernel: per draw the seed derived on the host
    (``ring.draw_seed``, that is ``ring.mix_seed``), keyed in the stream,
    and expanded into the draw's planes."""
    for j, draw in enumerate(draws):
        seed = ring.draw_seed(master, domain, first + j)
        _expand_plain(ring.stream_key(seed, layout, draw.bits), layout, draw)


def _check_group(layout: str, draws, device: torch.device) -> None:
    """Raise on a draw the kernel does not take: each buffer is checked
    once (device, type, contiguity), each plane against its buffer's
    bounds."""
    buffers = {}
    for draw in draws:
        if not 1 <= len(draw.planes) <= (1 if draw.bits else 2):
            raise ValueError(
                f"threefry_group: a {'bit' if draw.bits else 'word'} draw "
                f"takes {'one plane' if draw.bits else 'one or two planes'}"
                f", got {len(draw.planes)}"
            )
        if draw.n < 0:
            raise ValueError(f"threefry_group: negative count {draw.n}")
        refuse_beyond_counter(layout, draw.bits, draw.n, len(draw.planes))
        dtype = torch.uint8 if draw.bits else torch.int64
        for buf, offset in draw.planes:
            known = buffers.get(id(buf))
            if known is None:
                if buf.device != device or not buf.is_contiguous():
                    raise ValueError(
                        f"threefry_group: expected contiguous buffers on "
                        f"{device}, got one on {buf.device}"
                    )
                known = buffers[id(buf)] = (buf.dtype, buf.numel())
            if known[0] != dtype:
                raise ValueError(
                    f"threefry_group: expected a {dtype} buffer, got "
                    f"{known[0]}"
                )
            if offset < 0 or offset + draw.n > known[1]:
                raise ValueError(
                    f"threefry_group: a plane of {draw.n} at {offset} lies "
                    f"outside its buffer of {known[1]}"
                )


def _launch_group(key4, domain: int, first: int, code: int, derive: bool,
                  draws, device: torch.device) -> None:
    count = len(draws)
    lib = build.library("threefry")
    base = {}
    dsts = []
    for draw in draws:
        for buf, offset in (draw.planes[0], draw.planes[-1]):
            at = base.get(id(buf))
            if at is None:
                at = base[id(buf)] = (buf.data_ptr(), buf.element_size())
            dsts.append(at[0] + offset * at[1])
    kinds = (ctypes.c_int * count)(*[
        (_KIND_BITS if d.bits else 0)
        | (_KIND_TWO_PLANES if len(d.planes) == 2 else 0)
        for d in draws
    ])
    with torch.cuda.device(device):
        err = lib.moose_threefry_group(
            (ctypes.c_uint * 4)(*key4), domain & ring.MASK32, first, code,
            int(derive), count,
            (ctypes.c_longlong * count)(*[d.n for d in draws]),
            (ctypes.c_ulonglong * (2 * count))(*dsts), kinds,
            _stream(device),
        )
    _raise_on("threefry", err)


def threefry_group(master, domain: int, first: int, layout: str,
                   draws) -> None:
    """Expand a group of consecutive draws of one protocol session into
    their planes: draw j is the session's draw ``first + j`` under the
    master key ``master`` (4 u32 words) and ``domain``, in the stream
    ``layout``.  On the card the seeds are derived in the kernel, one
    launch per group of up to ``GROUP_MAX_DRAWS`` draws, counted once
    under the layout's ``LAUNCHES`` name; for buffers on the CPU this
    runs :func:`threefry_group_plain`.  Every word equals the draws' one
    by one."""
    _check_layout(layout)
    draws = list(draws)
    if not draws:
        return
    device = draws[0].planes[0][0].device
    _check_group(layout, draws, device)
    master = ring._seed_words(master)
    if device.type == "cpu":
        threefry_group_plain(master, domain, first, layout, draws)
        return
    if device.type == "meta":
        return
    _require_cuda("threefry_group", device)
    code, counter = PRF_LAYOUTS[layout]
    for c0 in range(0, len(draws), GROUP_MAX_DRAWS):
        chunk = draws[c0:c0 + GROUP_MAX_DRAWS]
        if any(d.n for d in chunk):
            _launch_group(master, domain, first + c0, code, True, chunk,
                          device)
            LAUNCHES[counter] += 1


def _threefry(k0: int, k1: int, n: int, layout: str, device,
              bits: bool) -> torch.Tensor:
    _check_layout(layout)
    k0, k1, n = int(k0), int(k1), int(n)
    if not (0 <= k0 <= ring.MASK32 and 0 <= k1 <= ring.MASK32):
        raise ValueError("threefry: key words must be u32 values")
    if n < 0:
        raise ValueError(f"threefry: negative count {n}")
    refuse_beyond_counter(layout, bits, n)
    device = torch.device(device)
    if device.type == "cpu":
        plain = threefry_bits_plain if bits else threefry_words_plain
        return plain(k0, k1, n, layout, device)
    _require_cuda("threefry", device)
    out = torch.empty(n, dtype=torch.uint8 if bits else torch.int64,
                      device=device)
    if n == 0:
        return out
    code, counter = PRF_LAYOUTS[layout]
    # a group of one draw under the key given by the caller
    _launch_group((k0, k1, 0, 0), 0, 0, code, False,
                  [GroupDraw(bits, n, ((out, 0),))], device)
    LAUNCHES[counter] += 1
    return out


def threefry_words(k0: int, k1: int, n: int, layout: str,
                   device) -> torch.Tensor:
    """The first ``n`` u64 words (as int64) of the threefry2x32-20 stream
    keyed by the u32 words ``(k0, k1)``, flat, on ``device``.  ``layout``
    is ``"threefry"`` (word i encrypts the block (i >> 32, i & 0xFFFFFFFF),
    as ``jax.random.bits`` does) or ``"threefry-pallas"`` (K7: word i
    encrypts (i, ~i), at most 2^32 words); a word is (y0 << 32) | y1.
    On the card, a group of one draw of the group kernel under the given
    key."""
    return _threefry(k0, k1, n, layout, device, bits=False)


def threefry_bits(k0: int, k1: int, n: int, layout: str,
                  device) -> torch.Tensor:
    """``n`` uniform bits as uint8 0/1 from the same stream: bit 0 of
    y0 ^ y1 per block for ``"threefry"``; for ``"threefry-pallas"`` 64
    bits per word, element 64w + j being bit j of word w."""
    return _threefry(k0, k1, n, layout, device, bits=True)


# ---------------------------------------------------------------------------
# The aes-ctr PRF: expanded on the host, grouped
# ---------------------------------------------------------------------------


def aes_ctr_group(master, domain: int, first: int, draws) -> None:
    """Expand a group of consecutive draws of one protocol session under
    the ``aes-ctr`` PRF into their planes: draw j is the session's draw
    ``first + j``, its seed ``ring.draw_seed`` (the same derivation as
    the threefry streams'), its words or bits the AES-128-CTR stream of
    that seed (``ring.aes_ctr_words``, ``ring.aes_ctr_bits``).

    This is the reference's construction, and the JAX package expands it
    on the host too: there is no kernel and no fallback here.  The whole
    group is staged in one host buffer and copied to the device once,
    then each plane is filled from it on the device.  Counted under
    ``LAUNCHES["prf_aes_ctr_host"]`` (one a group) and
    ``AES_CTR_HOST``; every word equals the draws' one by one."""
    draws = list(draws)
    if not draws:
        return
    device = draws[0].planes[0][0].device
    _check_group("aes-ctr", draws, device)
    if device.type == "meta":  # shape only: nothing to expand
        return
    master = ring._seed_words(master)
    t0 = time.perf_counter()
    parts, places, at, drawn = [], [], 0, 0
    for j, draw in enumerate(draws):
        if draw.n == 0:
            continue
        seed = ring.draw_seed(master, domain, first + j)
        if draw.bits:
            chunks = [ring.aes_ctr_bits(seed, draw.n)]
        else:
            lo, hi = ring.aes_ctr_words(
                seed, draw.n, 64 if len(draw.planes) == 1 else 128)
            chunks = [lo] if hi is None else [hi, lo]  # the planes' order
        for plane, chunk in zip(draw.planes, chunks):
            raw = chunk.view(np.uint8)
            places.append((plane, at, draw.n, draw.bits))
            parts.append(raw)
            drawn += raw.size
            at += raw.size
            if at % 8:  # the next plane's words start 8-byte aligned
                parts.append(np.zeros(8 - at % 8, dtype=np.uint8))
                at += 8 - at % 8
    AES_CTR_HOST["ms"] += (time.perf_counter() - t0) * 1e3
    if not places:
        return
    staged = torch.from_numpy(np.concatenate(parts)).to(device)
    for (buf, offset), start, n, bits in places:
        src = staged[start:start + n * (1 if bits else 8)]
        buf.view(-1)[offset:offset + n].copy_(
            src if bits else src.view(torch.int64))
    LAUNCHES["prf_aes_ctr_host"] += 1
    AES_CTR_HOST["bytes"] += drawn
