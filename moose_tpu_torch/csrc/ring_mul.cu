// ring_mul: elementwise ring multiply.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py: ring_mul
// (pallas_call body _mul_body).  out = a * b mod 2^64 or 2^128 for every
// element; spmd.mul_public calls it with b the public constant broadcast
// to the shares' shape.
//
// What bounds it on the card: bytes.  Per ring128 element it reads two
// (lo, hi) words and writes one, 48 bytes, against one wide product
// (lo*lo in full with __umul64hi, the cross products mod 2^64).
//
// What the design does about it: one thread per element, grid-stride,
// each word read once and written once, neighbouring threads on
// neighbouring words.  The TPU kernel's 16-bit limbs are not carried
// over: Hopper multiplies u64 words natively.  The wrapper materialises
// the broadcast constant (the JAX package broadcasts it the same way
// before its kernel), and the bound counts those bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
ring_mul_kernel(const uint64_t* __restrict__ a_lo,
                const uint64_t* __restrict__ a_hi,
                const uint64_t* __restrict__ b_lo,
                const uint64_t* __restrict__ b_hi,
                uint64_t* __restrict__ out_lo, uint64_t* __restrict__ out_hi,
                long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    ring_store<WIDE>(out_lo, out_hi, i,
                     ring_mul<WIDE>(ring_load<WIDE>(a_lo, a_hi, i),
                                    ring_load<WIDE>(b_lo, b_hi, i)));
  }
}

}  // namespace

// Operands and output are (lo, hi) pointer pairs of n words; the *_hi
// pointers are ignored (and may be null) when wide == 0.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int moose_ring_mul(const void* a_lo, const void* a_hi,
                              const void* b_lo, const void* b_hi,
                              void* out_lo, void* out_hi, long long n,
                              int wide, void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  if (wide) {
    ring_mul_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        u(a_lo), u(a_hi), u(b_lo), u(b_hi), static_cast<uint64_t*>(out_lo),
        static_cast<uint64_t*>(out_hi), n);
  } else {
    ring_mul_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        u(a_lo), nullptr, u(b_lo), nullptr, static_cast<uint64_t*>(out_lo),
        nullptr, n);
  }
  return static_cast<int>(cudaGetLastError());
}
