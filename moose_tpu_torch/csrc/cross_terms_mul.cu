// cross_terms_mul: elementwise cross terms of a secure multiplication.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py:
// cross_terms_mul (pallas_call body _cross_mul_body).  For every element
// of the party-stacked (3, n) pair slots it computes, mod 2^64 or 2^128,
//     v = x0 * (y0 + y1) + x1 * y0
// the regrouped cross terms of spmd.mul (two products instead of three).
//
// What bounds it on the card: bytes.  Per ring128 element it reads four
// (lo, hi) words and writes one, 80 bytes, against two wide products
// (lo*lo in full with __umul64hi, the cross products mod 2^64) and three
// 128-bit adds: a few dozen integer instructions, far below what 80
// bytes take at 3.35 TB/s.
//
// What the design does about it: one thread per element, grid-stride;
// every word is read once and written once, neighbouring threads on
// neighbouring words, so loads and stores coalesce.  The TPU kernel's
// 16-bit limbs in u32 lanes (Mosaic has no 64-bit lanes) are not carried
// over: Hopper multiplies u64 words natively.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
cross_terms_mul_kernel(const uint64_t* __restrict__ x0_lo,
                       const uint64_t* __restrict__ x0_hi,
                       const uint64_t* __restrict__ x1_lo,
                       const uint64_t* __restrict__ x1_hi,
                       const uint64_t* __restrict__ y0_lo,
                       const uint64_t* __restrict__ y0_hi,
                       const uint64_t* __restrict__ y1_lo,
                       const uint64_t* __restrict__ y1_hi,
                       uint64_t* __restrict__ out_lo,
                       uint64_t* __restrict__ out_hi, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Ring x0 = ring_load<WIDE>(x0_lo, x0_hi, i);
    const Ring x1 = ring_load<WIDE>(x1_lo, x1_hi, i);
    const Ring y0 = ring_load<WIDE>(y0_lo, y0_hi, i);
    const Ring y1 = ring_load<WIDE>(y1_lo, y1_hi, i);
    const Ring v = ring_add<WIDE>(ring_mul<WIDE>(x0, ring_add<WIDE>(y0, y1)),
                                  ring_mul<WIDE>(x1, y0));
    ring_store<WIDE>(out_lo, out_hi, i, v);
  }
}

}  // namespace

// Each operand is a (lo, hi) pointer pair of n words; the *_hi pointers
// are ignored (and may be null) when wide == 0.  Launches on `stream`;
// returns cudaGetLastError() of the launch.
extern "C" int moose_cross_terms_mul(const void* x0_lo, const void* x0_hi,
                                     const void* x1_lo, const void* x1_hi,
                                     const void* y0_lo, const void* y0_hi,
                                     const void* y1_lo, const void* y1_hi,
                                     void* out_lo, void* out_hi, long long n,
                                     int wide, void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  if (wide) {
    cross_terms_mul_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                                   s>>>(
        u(x0_lo), u(x0_hi), u(x1_lo), u(x1_hi), u(y0_lo), u(y0_hi), u(y1_lo),
        u(y1_hi), static_cast<uint64_t*>(out_lo),
        static_cast<uint64_t*>(out_hi), n);
  } else {
    cross_terms_mul_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                                    s>>>(
        u(x0_lo), nullptr, u(x1_lo), nullptr, u(y0_lo), nullptr, u(y1_lo),
        nullptr, static_cast<uint64_t*>(out_lo), nullptr, n);
  }
  return static_cast<int>(cudaGetLastError());
}
