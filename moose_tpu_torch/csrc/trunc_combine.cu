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
// (0, >= 64, >= 128) is written out in ring_words.cuh.

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
  constexpr int W = WIDE ? 128 : 64;
  constexpr int K = W - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Ring a0 = ring_load<WIDE>(args.lo[0], args.hi[0], i);
    const Ring a1 = ring_load<WIDE>(args.lo[1], args.hi[1], i);
    const Ring r = ring_load<WIDE>(args.lo[2], args.hi[2], i);
    const Ring mr = ring_load<WIDE>(args.lo[3], args.hi[3], i);
    const Ring mrt = ring_load<WIDE>(args.lo[4], args.hi[4], i);
    const Ring mrm = ring_load<WIDE>(args.lo[5], args.hi[5], i);
    const Ring z0 = ring_load<WIDE>(args.lo[6], args.hi[6], i);

    // the mask's top and msb parts, additively shared against m_rt, m_rm
    const Ring r_msb = ring_shr<WIDE>(r, W - 1);
    const Ring r_top = ring_shr<WIDE>(ring_shl<WIDE>(r, 1), amount + 1);
    const Ring r1 = ring_sub<WIDE>(r, mr);
    const Ring rt1 = ring_sub<WIDE>(r_top, mrt);
    const Ring rm1 = ring_sub<WIDE>(r_msb, mrm);

    const Ring one = ring_const<WIDE>(1ull, 0ull);
    const Ring up = ring_shl<WIDE>(one, K - 1);
    const Ring down = ring_shl<WIDE>(one, K - amount - 1);

    // c = (x + 2^(k-1)) + r, revealed
    const Ring m0 = ring_add<WIDE>(ring_add<WIDE>(a0, up), mr);
    const Ring m1 = ring_add<WIDE>(a1, r1);
    const Ring c = ring_add<WIDE>(m0, m1);

    const Ring ctop = ring_shr<WIDE>(ring_shl<WIDE>(c, 1), amount + 1);
    const Ring cmsb = ring_shr<WIDE>(c, W - 1);  // public 0/1
    const bool cmsb_on = cmsb.lo != 0ull;

    // overflow = r_msb XOR c_msb, additively: rm + cmsb - 2 * rm * cmsb,
    // then moved up to bit k - amount
    const Ring zero = ring_const<WIDE>(0ull, 0ull);
    Ring of0 = ring_sub<WIDE>(mrm, ring_shl<WIDE>(cmsb_on ? mrm : zero, 1));
    of0 = ring_shl<WIDE>(ring_add<WIDE>(of0, cmsb), K - amount);
    Ring of1 = ring_sub<WIDE>(rm1, ring_shl<WIDE>(cmsb_on ? rm1 : zero, 1));
    of1 = ring_shl<WIDE>(of1, K - amount);

    // y = (c_top - r_top) + overflow - 2^(k - amount - 1), additively
    const Ring y0 = ring_sub<WIDE>(
        ring_add<WIDE>(ring_sub<WIDE>(ctop, mrt), of0), down);
    const Ring y1 = ring_add<WIDE>(ring_neg<WIDE>(rt1), of1);

    // additive -> replicated: z0 drawn, z1 = y0 - z0, z2 = y1
    ring_store<WIDE>(args.out_lo, args.out_hi, i, z0);
    ring_store<WIDE>(args.out_lo, args.out_hi, n + i,
                     ring_sub<WIDE>(y0, z0));
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
