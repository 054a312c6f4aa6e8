// dot_cross_terms: party-batched cross terms of a secure matmul.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py:
// dot_cross_terms (pallas_call body _dot_body, tiling _dot_tile_plan).
// For each party p of 3 it computes, mod 2^64 or 2^128,
//     v_p = x0_p @ ysum_p + x1_p @ y0_p,     x: (3, m, k), y: (3, k, n)
// with the ring words as (lo, hi) u64 pairs.
//
// What bounds it on the card: operations.  Every (p, i, j, k) term is two
// 64x64-bit multiplies for ring64 and, for ring128, two wide products of
// four u64 multiplies each (lo*lo in full with __umul64hi, lo*hi and
// hi*lo mod 2^64).  Hopper has no 64-bit integer multiplier: each of them
// is several 32-bit IMADs, so the kernel is bound by integer multiply
// issue, far above its bytes (2 * 4 operands read once, one output).
//
// What the design does about it: it keeps every product out of device
// memory and reuses each loaded word many times.  A block computes a
// 64 x 64 output tile of one party; the four operands stream through
// shared memory in k-slices of 8, and each of the 256 threads holds a
// 4 x 4 micro-tile of 128-bit accumulators in registers, so a word read
// from shared memory feeds 4 multiply-accumulates.  The TPU kernel's
// 8-bit limbs in u32 lanes, k-segmentation and f32 exactness bound
// worked around Mosaic's missing 64-bit lanes and are not carried over.
// A tensor-core formulation (centered s8 limbs, ring.py:_limbs8_s8_centered
// in the JAX package) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 8;   // contraction slice held in shared memory
constexpr int TY = 16;  // threads per block along rows
constexpr int TX = 16;  // threads per block along columns
constexpr int TM = BM / TY;
constexpr int TN = BN / TX;
constexpr int THREADS = TX * TY;

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
dot_cross_terms_kernel(const uint64_t* __restrict__ x0_lo,
                       const uint64_t* __restrict__ x0_hi,
                       const uint64_t* __restrict__ x1_lo,
                       const uint64_t* __restrict__ x1_hi,
                       const uint64_t* __restrict__ y0_lo,
                       const uint64_t* __restrict__ y0_hi,
                       const uint64_t* __restrict__ ys_lo,
                       const uint64_t* __restrict__ ys_hi,
                       uint64_t* __restrict__ out_lo,
                       uint64_t* __restrict__ out_hi,
                       int m, int k, int n) {
  constexpr int HK = WIDE ? BK : 1;
  // A side: x0 and x1 as [operand][kk][row]; B side: ysum and y0 as
  // [operand][kk][col]
  __shared__ uint64_t sa_lo[2][BK][BM];
  __shared__ uint64_t sa_hi[2][HK][BM];
  __shared__ uint64_t sb_lo[2][BK][BN];
  __shared__ uint64_t sb_hi[2][HK][BN];

  const int p = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;

  const long long a_base = (long long)p * m * k;
  const long long b_base = (long long)p * k * n;

  uint64_t acc_lo[TM][TN];
  uint64_t acc_hi[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_lo[i][j] = 0ull;
      acc_hi[i][j] = 0ull;
    }

  for (int k0 = 0; k0 < k; k0 += BK) {
    // stage the k-slice; out-of-range words load as zero, which adds
    // nothing to any product
#pragma unroll
    for (int t = tid; t < BM * BK; t += THREADS) {
      const int r = t / BK;
      const int c = t % BK;
      const int gr = row0 + r;
      const int gc = k0 + c;
      const bool ok = gr < m && gc < k;
      const long long g = a_base + (long long)gr * k + gc;
      sa_lo[0][c][r] = ok ? x0_lo[g] : 0ull;
      sa_lo[1][c][r] = ok ? x1_lo[g] : 0ull;
      if constexpr (WIDE) {
        sa_hi[0][c][r] = ok ? x0_hi[g] : 0ull;
        sa_hi[1][c][r] = ok ? x1_hi[g] : 0ull;
      }
    }
#pragma unroll
    for (int t = tid; t < BK * BN; t += THREADS) {
      const int r = t / BN;
      const int c = t % BN;
      const int gr = k0 + r;
      const int gc = col0 + c;
      const bool ok = gr < k && gc < n;
      const long long g = b_base + (long long)gr * n + gc;
      sb_lo[0][r][c] = ok ? ys_lo[g] : 0ull;
      sb_lo[1][r][c] = ok ? y0_lo[g] : 0ull;
      if constexpr (WIDE) {
        sb_hi[0][r][c] = ok ? ys_hi[g] : 0ull;
        sb_hi[1][r][c] = ok ? y0_hi[g] : 0ull;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint64_t a0l[TM], a0h[TM], a1l[TM], a1h[TM];
      uint64_t bsl[TN], bsh[TN], b0l[TN], b0h[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + TY * i;
        a0l[i] = sa_lo[0][kk][r];
        a1l[i] = sa_lo[1][kk][r];
        if constexpr (WIDE) {
          a0h[i] = sa_hi[0][kk][r];
          a1h[i] = sa_hi[1][kk][r];
        } else {
          a0h[i] = a1h[i] = 0ull;
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + TX * j;
        bsl[j] = sb_lo[0][kk][c];
        b0l[j] = sb_lo[1][kk][c];
        if constexpr (WIDE) {
          bsh[j] = sb_hi[0][kk][c];
          b0h[j] = sb_hi[1][kk][c];
        } else {
          bsh[j] = b0h[j] = 0ull;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ring_mac<WIDE>(acc_lo[i][j], acc_hi[i][j], a0l[i], a0h[i], bsl[j],
                         bsh[j]);
          ring_mac<WIDE>(acc_lo[i][j], acc_hi[i][j], a1l[i], a1h[i], b0l[j],
                         b0h[j]);
        }
    }
    __syncthreads();
  }

  const long long o_base = (long long)p * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + TY * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + TX * j;
      if (gc >= n) continue;
      const long long o = o_base + (long long)gr * n + gc;
      out_lo[o] = acc_lo[i][j];
      if constexpr (WIDE) out_hi[o] = acc_hi[i][j];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  The
// *_hi pointers are ignored (and may be null) when wide == 0.
extern "C" int moose_dot_cross_terms(const void* x0_lo, const void* x0_hi,
                                     const void* x1_lo, const void* x1_hi,
                                     const void* y0_lo, const void* y0_hi,
                                     const void* ys_lo, const void* ys_hi,
                                     void* out_lo, void* out_hi, int parties,
                                     int m, int k, int n, int wide,
                                     void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, parties);
  const dim3 block(TX, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  if (wide) {
    dot_cross_terms_kernel<true><<<grid, block, 0, s>>>(
        u(x0_lo), u(x0_hi), u(x1_lo), u(x1_hi), u(y0_lo), u(y0_hi),
        u(ys_lo), u(ys_hi), static_cast<uint64_t*>(out_lo),
        static_cast<uint64_t*>(out_hi), m, k, n);
  } else {
    dot_cross_terms_kernel<false><<<grid, block, 0, s>>>(
        u(x0_lo), nullptr, u(x1_lo), nullptr, u(y0_lo), nullptr, u(ys_lo),
        nullptr, static_cast<uint64_t*>(out_lo), nullptr, m, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}
