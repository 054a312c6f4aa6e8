// trunc_combine: the elementwise tail of probabilistic truncation.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py:
// trunc_combine (pallas_call body _trunc_body, limb math _ktrunc).  From
// the 2-party additive sharing (a0, a1) of x and the five values the
// caller drew before it (r, m_r, m_rt, m_rm, z0) it masks x with r,
// reveals c = x + 2^(k-1) + r, corrects the MSB overflow, shifts down by
// `amount` and compresses the additive result into the replicated stack
// (z0, z1, y1), exactly as spmd._trunc_combine_lax of the JAX package.
//
// What bounds it on the card: bytes.  Per ring128 element it reads 7
// (lo, hi) pairs and writes 3, 160 bytes, against a few dozen integer
// operations; at 3.35 TB/s the bytes take far longer than the
// arithmetic.
//
// What the design does about it: one thread per element, every
// intermediate (masks, the revealed c, the overflow terms) in registers,
// so each input word is read once and each output word written once;
// neighbouring threads touch neighbouring words, so every load and store
// is coalesced.  `amount` is a runtime argument and every shift case
// (0, >= 64, >= 128) is written out in ring_words.cuh, whose trunc_tail
// holds the arithmetic; horner.cu runs the same function at every step.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;

struct TruncArgs {
  const uint64_t* lo[7];  // a0, a1, r, m_r, m_rt, m_rm, z0
  const uint64_t* hi[7];
  uint64_t* out_lo;  // (3, n): z0, z1, y1
  uint64_t* out_hi;
};

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
trunc_combine_kernel(TruncArgs args, long long n, int amount) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Ring in[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) in[j] = ring_load<WIDE>(args.lo[j], args.hi[j], i);
    Ring z0, z1, y1;
    trunc_tail<WIDE>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], amount,
                     z0, z1, y1);
    ring_store<WIDE>(args.out_lo, args.out_hi, i, z0);
    ring_store<WIDE>(args.out_lo, args.out_hi, n + i, z1);
    ring_store<WIDE>(args.out_lo, args.out_hi, 2 * n + i, y1);
  }
}

}  // namespace

// Inputs in the order a0, a1, r, m_r, m_rt, m_rm, z0, each as a (lo, hi)
// pointer pair of n words; the *_hi pointers are ignored (and may be
// null) when wide == 0.  Requires 0 <= amount <= width - 2.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int moose_trunc_combine(
    const void* a0_lo, const void* a0_hi, const void* a1_lo,
    const void* a1_hi, const void* r_lo, const void* r_hi,
    const void* mr_lo, const void* mr_hi, const void* mrt_lo,
    const void* mrt_hi, const void* mrm_lo, const void* mrm_hi,
    const void* z0_lo, const void* z0_hi, void* out_lo, void* out_hi,
    long long n, int amount, int wide, void* stream) {
  TruncArgs args;
  const void* los[7] = {a0_lo, a1_lo, r_lo, mr_lo, mrt_lo, mrm_lo, z0_lo};
  const void* his[7] = {a0_hi, a1_hi, r_hi, mr_hi, mrt_hi, mrm_hi, z0_hi};
  for (int j = 0; j < 7; ++j) {
    args.lo[j] = static_cast<const uint64_t*>(los[j]);
    args.hi[j] = static_cast<const uint64_t*>(his[j]);
  }
  args.out_lo = static_cast<uint64_t*>(out_lo);
  args.out_hi = static_cast<uint64_t*>(out_hi);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    trunc_combine_kernel<true>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(args, n, amount);
  } else {
    trunc_combine_kernel<false>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(args, n, amount);
  }
  return static_cast<int>(cudaGetLastError());
}
