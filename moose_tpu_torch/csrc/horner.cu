// horner: the fused fixed-point Horner ladder of a secret polynomial.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py: horner
// (pallas_call body _horner_body).  For a replicated sharing x (pair
// slots x0, x1, each (3, n)) and public coefficients c_0..c_steps (raw
// ring integers, highest degree first) it runs, per element,
//     acc = c_0;  for each step: acc = trunc_pr(acc * x) + c_{step+1}
// as spmd_math._horner_lax of the JAX package does: every step takes the
// cross terms acc0*(x0+x1) + acc1*x0 of all three parties, adds the zero
// share s_p - s_{p+1} of that step's bank, runs the truncation tail on
// a0 = z_0 + z_1, a1 = z_2 with that step's five draws (trunc_tail of
// ring_words.cuh, the code trunc_combine.cu runs), and adds the next
// coefficient at pair slots (0, 0) and (2, 1).
//
// What bounds it on the card: bytes.  Per element it reads the two pair
// slots of x (6 words) and, per step, the bank (3 words) and the five
// draws (5 words), and writes 6 words: (6 + steps * 8) words in,
// 6 out.  Every step's integer work (two wide products per party, the
// truncation tail) is a few hundred 32-bit instructions, below what its
// 128 bytes per step take at 3.35 TB/s.
//
// What the design does about it: one thread per element with all three
// parties' accumulators in registers across the whole loop over steps, so
// no intermediate of the ladder touches device memory and each input word
// is read once.  The coefficients ride in the kernel's argument block.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COEFFS = 64;

struct HornerArgs {
  const uint64_t* x0_lo;  // (3, n) pair slot 0 of x
  const uint64_t* x0_hi;
  const uint64_t* x1_lo;  // (3, n) pair slot 1 of x
  const uint64_t* x1_hi;
  const uint64_t* zb_lo;  // (steps, 3, n) zero-share banks
  const uint64_t* zb_hi;
  const uint64_t* td_lo;  // (steps, 5, n) truncation draws
  const uint64_t* td_hi;
  uint64_t* out_lo;  // (2, 3, n): pair slot 0, then pair slot 1
  uint64_t* out_hi;
  uint64_t c_lo[MAX_COEFFS];
  uint64_t c_hi[MAX_COEFFS];
  int steps;
  int f;
};

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
horner_kernel(const HornerArgs args, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const Ring zero = ring_const<WIDE>(0ull, 0ull);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Ring x0[3], xs[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      x0[p] = ring_load<WIDE>(args.x0_lo, args.x0_hi, p * n + i);
      xs[p] = ring_add<WIDE>(
          x0[p], ring_load<WIDE>(args.x1_lo, args.x1_hi, p * n + i));
    }
    // the trivial sharing of c_0: x_0 = c_0 at (0, 0) and (2, 1)
    const Ring c0 = ring_const<WIDE>(args.c_lo[0], args.c_hi[0]);
    Ring acc0[3] = {c0, zero, zero};
    Ring acc1[3] = {zero, zero, c0};
    for (int st = 0; st < args.steps; ++st) {
      Ring s[3];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        s[p] = ring_load<WIDE>(args.zb_lo, args.zb_hi, (st * 3LL + p) * n + i);
      Ring z[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const Ring v = ring_add<WIDE>(ring_mul<WIDE>(acc0[p], xs[p]),
                                      ring_mul<WIDE>(acc1[p], x0[p]));
        z[p] = ring_add<WIDE>(v, ring_sub<WIDE>(s[p], s[(p + 1) % 3]));
      }
      Ring d[5];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        d[j] = ring_load<WIDE>(args.td_lo, args.td_hi, (st * 5LL + j) * n + i);
      Ring q0, q1, q2;
      trunc_tail<WIDE>(ring_add<WIDE>(z[0], z[1]), z[2], d[0], d[1], d[2],
                       d[3], d[4], args.f, q0, q1, q2);
      const Ring c = ring_const<WIDE>(args.c_lo[st + 1], args.c_hi[st + 1]);
      acc0[0] = ring_add<WIDE>(q0, c);
      acc0[1] = q1;
      acc0[2] = q2;
      acc1[0] = q1;
      acc1[1] = q2;
      acc1[2] = acc0[0];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      ring_store<WIDE>(args.out_lo, args.out_hi, p * n + i, acc0[p]);
      ring_store<WIDE>(args.out_lo, args.out_hi, (3 + p) * n + i, acc1[p]);
    }
  }
}

}  // namespace

// x0, x1: (lo, hi) words (3, n); zbanks: (steps, 3, n); tdraws:
// (steps, 5, n); out: (2, 3, n).  coeff_lo/coeff_hi are host arrays of
// steps + 1 words (0 < steps < MAX_COEFFS); the *_hi pointers are
// ignored (and may be null) when wide == 0.  Requires 0 <= f <=
// width - 2.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for too many coefficients.
extern "C" int moose_horner(const void* x0_lo, const void* x0_hi,
                            const void* x1_lo, const void* x1_hi,
                            const void* zb_lo, const void* zb_hi,
                            const void* td_lo, const void* td_hi,
                            void* out_lo, void* out_hi,
                            const uint64_t* coeff_lo,
                            const uint64_t* coeff_hi, int steps, int f,
                            long long n, int wide, void* stream) {
  if (steps < 1 || steps >= MAX_COEFFS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HornerArgs args;
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  args.x0_lo = u(x0_lo);
  args.x0_hi = u(x0_hi);
  args.x1_lo = u(x1_lo);
  args.x1_hi = u(x1_hi);
  args.zb_lo = u(zb_lo);
  args.zb_hi = u(zb_hi);
  args.td_lo = u(td_lo);
  args.td_hi = u(td_hi);
  args.out_lo = static_cast<uint64_t*>(out_lo);
  args.out_hi = static_cast<uint64_t*>(out_hi);
  for (int j = 0; j < MAX_COEFFS; ++j) {
    args.c_lo[j] = j <= steps ? coeff_lo[j] : 0ull;
    args.c_hi[j] = wide && j <= steps ? coeff_hi[j] : 0ull;
  }
  args.steps = steps;
  args.f = f;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    horner_kernel<true>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(args, n);
  } else {
    horner_kernel<false>
        <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(args, n);
  }
  return static_cast<int>(cudaGetLastError());
}
