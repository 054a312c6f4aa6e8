"""Hand-written CUDA kernels for the secure dot, with their plain versions.

PyTorch counterpart of the two ``moose_tpu/native/ring128_kernels.py``
kernels every secure dot runs:

- ``dot_cross_terms`` (K1): the party-batched cross terms
  ``v_p = x0_p @ (y0+y1)_p + x1_p @ y0_p mod 2^w`` of a secure matmul,
  ``csrc/dot_cross_terms.cu``;
- ``trunc_combine`` (K2): the elementwise tail of probabilistic
  truncation after its five pre-drawn values, ``csrc/trunc_combine.cu``.

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises: there is no fallback.  Each
launch adds one to ``LAUNCHES[name]`` (and nothing else does), so a run
can show that it went through the kernels.

The plain versions repeat the kernels' arithmetic in PyTorch.  They are
what the CPU tests hold against the JAX package, and what ``chip_smoke.py``
holds each kernel against on the card; they are no yardstick of speed.
Kernels never draw randomness: callers pass the pre-drawn values, so a
computation is bit-identical on either path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..dialects import ring
from . import build

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]

LAUNCHES = {"dot_cross_terms": 0, "trunc_combine": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(label: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{label}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# K1: party-batched dot cross terms
# ---------------------------------------------------------------------------

# csrc/dot_cross_terms.cu: a block covers 64 output rows, and a grid's
# y dimension holds at most 65535 blocks
_DOT_TILE = 64
_MAX_GRID_Y = 65535

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


def dot_cross_terms_plain(x0: Pair, x1: Pair, y0: Pair, ysum: Pair,
                          width: int) -> Pair:
    v = ring_matmul_plain(x0, ysum, width)
    t = ring_matmul_plain(x1, y0, width)
    return ring.add(*v, *t)


def dot_cross_terms(x0: Pair, x1: Pair, y0: Pair, ysum: Pair,
                    width: int) -> Pair:
    """Party-batched cross terms ``v_p = x0_p @ ysum_p + x1_p @ y0_p``
    mod 2^width for ``(3, m, k)`` and ``(3, k, n)`` ring pairs; the
    caller adds ``ysum = y0 + y1`` first."""
    if _on_cpu(x0[0]):
        return dot_cross_terms_plain(x0, x1, y0, ysum, width)
    device = x0[0].device
    if device.type != "cuda" or x0[0].dim() != 3 or y0[0].dim() != 3:
        raise ValueError(
            "dot_cross_terms takes (3, m, k) and (3, k, n) CUDA tensors"
        )
    parties, m, k = x0[0].shape
    n = y0[0].shape[-1]
    if max(m, k, n) >= 1 << 31 or m > _MAX_GRID_Y * _DOT_TILE:
        raise ValueError(f"dot_cross_terms: shape ({m}, {k}, {n}) too large")
    wide = width == 128
    for label, pair, shape in (
        ("x0", x0, (parties, m, k)), ("x1", x1, (parties, m, k)),
        ("y0", y0, (parties, k, n)), ("ysum", ysum, (parties, k, n)),
    ):
        _check_cuda_words(f"dot_cross_terms {label}.lo", pair[0], shape,
                          device)
        if wide:
            _check_cuda_words(f"dot_cross_terms {label}.hi", pair[1], shape,
                              device)
    out_lo = torch.empty((parties, m, n), dtype=torch.int64,
                         device=x0[0].device)
    out_hi = torch.empty_like(out_lo) if wide else None
    if out_lo.numel() == 0:
        return out_lo, out_hi
    lib = build.library("dot_cross_terms")
    with torch.cuda.device(device):
        err = lib.moose_dot_cross_terms(
            _ptr(x0[0]), _ptr(x0[1] if wide else None),
            _ptr(x1[0]), _ptr(x1[1] if wide else None),
            _ptr(y0[0]), _ptr(y0[1] if wide else None),
            _ptr(ysum[0]), _ptr(ysum[1] if wide else None),
            _ptr(out_lo), _ptr(out_hi),
            parties, m, k, n, int(wide),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("dot_cross_terms", err)
    LAUNCHES["dot_cross_terms"] += 1
    return out_lo, out_hi


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


def trunc_combine(a0: Pair, a1: Pair, draws, width: int, amount: int):
    """The fused tail of ``spmd._trunc_pr_adt``: masks, reveal, overflow
    correction, downshift and additive-to-replicated, from the 2-party
    additive sharing (a0, a1) and the pre-drawn (r, m_r, m_rt, m_rm, z0).
    Returns the stacked (3, *shape) (z_lo, z_hi)."""
    if _on_cpu(a0[0]):
        return trunc_combine_plain(a0, a1, draws, width, amount)
    if not 0 <= amount <= width - 2:
        raise ValueError(
            f"trunc_combine: amount {amount} out of range for ring{width}"
        )
    device = a0[0].device
    if device.type != "cuda":
        raise ValueError("trunc_combine takes CUDA tensors")
    shape = tuple(a0[0].shape)
    wide = width == 128
    pairs = (a0, a1) + tuple(draws)
    labels = ("a0", "a1", "r", "m_r", "m_rt", "m_rm", "z0")
    if len(pairs) != 7:
        raise ValueError(f"trunc_combine: expected 5 draws, got {len(draws)}")
    for label, pair in zip(labels, pairs):
        _check_cuda_words(f"trunc_combine {label}.lo", pair[0], shape, device)
        if wide:
            _check_cuda_words(f"trunc_combine {label}.hi", pair[1], shape,
                              device)
    out_lo = torch.empty((3,) + shape, dtype=torch.int64,
                         device=a0[0].device)
    out_hi = torch.empty_like(out_lo) if wide else None
    n = a0[0].numel()
    if n == 0:
        return out_lo, out_hi
    lib = build.library("trunc_combine")
    ptrs = []
    for pair in pairs:
        ptrs += [_ptr(pair[0]), _ptr(pair[1] if wide else None)]
    with torch.cuda.device(device):
        err = lib.moose_trunc_combine(
            *ptrs, _ptr(out_lo), _ptr(out_hi), n, amount, int(wide),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("trunc_combine", err)
    LAUNCHES["trunc_combine"] += 1
    return out_lo, out_hi
