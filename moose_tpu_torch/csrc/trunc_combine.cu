// trunc_combine: probabilistic truncation on the card, from the pair
// layout to the pair layout.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py:
// trunc_combine (pallas_call body _trunc_body, limb math _ktrunc).  The
// arithmetic is the truncation tail of ring_words.cuh, word for word
// spmd._trunc_combine_lax of the JAX package: from a sharing of x and
// the five values drawn before it (r, m_r, m_rt, m_rm, z0) it masks x
// with r, reveals c = x + 2^(k-1) + r, corrects the MSB overflow, shifts
// down by `amount` and compresses the additive result into the
// replicated values (z0, z1, z2).  One kernel, one entry point
// (moose_trunc_pairs), three inputs:
//
//   pairs:   a replicated x in the (3, 2, *shape) pair layout, read in
//            place through its own strides (transposed and broadcast
//            views included), slot 0 of each party only: x = x_0 + x_1
//            + x_2 (spmd.trunc_pr, spmd._mul_like_trunc after K3);
//   cross:   a matrix product's party-stacked cross terms v (3, n):
//            x = v_0 + v_1 + v_2 (spmd._mul_like_trunc after K1).  The
//            protocol adds the zero share s_p - s_{p+1} to each v_p
//            before the reveal; those shares sum to zero, so the kernel
//            does not read the bank;
//   additive: the 2-party additive sharing (a0, a1): x = a0 + a1, the
//            counterpart of the TPU kernel (ring_kernels.trunc_combine).
//
// It writes the replicated result's pair layout (3, 2, n), out[p, 0] =
// z_p, out[p, 1] = z_{p+1} (pairs, cross), so that a truncation is one
// K7 launch for its draws and this one, with no PyTorch op around them;
// or the stacked (3, n) values (additive).
//
// What bounds it on the card: bytes.  Per ring128 element it reads 3
// words of x (2 additive) and the 3.5 draw words that reach the result
// (r, m_rt, z0, and m_rm's low word where k - amount >= 64; m_r cancels
// in the reveal) and writes 6 words (3 additive): 200 bytes, against
// some 195 32-bit integer operations, under a fifth of what the bytes
// take at 3.35 TB/s.  At the protocol's 1024 elements, the launch.
//
// What the design does about it: one thread per element, grid-stride;
// every intermediate in registers, each word it needs read once and each
// output word written once; neighbouring threads on neighbouring
// elements, so every plane's loads and stores coalesce when the operand
// is contiguous, and a strided operand's offsets come from the strided
// walk of ring_words.cuh (32-bit magic-number division where they fit),
// as K3's reshare reads its operands.  `amount` is a runtime argument
// and every shift case (0, >= 64, >= 128) is written out in
// ring_words.cuh; horner.cu runs the same tail at every step.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;

// the draws that reach the result, in the session's order without m_r
enum Draw { R = 0, MRT = 1, MRM = 2, Z0 = 3, DRAWS = 4 };

struct Draws {
  const uint64_t* lo[DRAWS];
  const uint64_t* hi[DRAWS];
};

// the summed words of x: party or additive share p at lo[p] + offset
struct Operand {
  const uint64_t* lo[3];
  const uint64_t* hi[3];
};

enum Input { PAIRS = 0, CROSS = 1, ADDITIVE = 2 };

// PARTS words of x summed at each element's walk offset; the result
// written as the pair layout (PAIR_OUT) or the stacked (3, n) values
template <bool WIDE, int PARTS, int MODE, bool PAIR_OUT>
__global__ void __launch_bounds__(THREADS)
trunc_pairs_kernel(Operand x, Walk<1> w, Draws d,
                   uint64_t* __restrict__ out_lo,
                   uint64_t* __restrict__ out_hi, long long n, int amount) {
  const bool mrm_hi = trunc_mrm_hi<WIDE>(amount);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    long long off[1];
    walk_offsets<MODE, 1>(w, e, off);
    Ring sum = ring_load<WIDE>(x.lo[0], x.hi[0], off[0]);
#pragma unroll
    for (int p = 1; p < PARTS; ++p)
      sum = ring_add<WIDE>(sum, ring_load<WIDE>(x.lo[p], x.hi[p], off[0]));
    Ring mrm;
    mrm.lo = d.lo[MRM][e];
    mrm.hi = mrm_hi ? d.hi[MRM][e] : 0ull;
    const TruncMasks m = trunc_masks<WIDE>(
        ring_load<WIDE>(d.lo[R], d.hi[R], e),
        ring_load<WIDE>(d.lo[MRT], d.hi[MRT], e), mrm,
        ring_load<WIDE>(d.lo[Z0], d.hi[Z0], e), amount);
    Ring q[3];
    trunc_finish<WIDE>(m, sum, amount, q[0], q[1], q[2]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (PAIR_OUT) {
        ring_store<WIDE>(out_lo, out_hi, e + 2 * p * n, q[p]);
        ring_store<WIDE>(out_lo, out_hi, e + (2 * p + 1) * n, q[(p + 1) % 3]);
      } else {
        ring_store<WIDE>(out_lo, out_hi, e + p * n, q[p]);
      }
    }
  }
}

template <bool WIDE>
void launch(int input, const Operand& x, const Walk<1>& w, const Draws& d,
            uint64_t* out_lo, uint64_t* out_hi, long long n, int amount,
            cudaStream_t st) {
  const unsigned grid = grid_for(n, THREADS);
  if (input == ADDITIVE) {
    trunc_pairs_kernel<WIDE, 2, WALK_CONTIG, false><<<grid, THREADS, 0, st>>>(
        x, w, d, out_lo, out_hi, n, amount);
  } else if (w.mode == WALK_CONTIG) {
    trunc_pairs_kernel<WIDE, 3, WALK_CONTIG, true><<<grid, THREADS, 0, st>>>(
        x, w, d, out_lo, out_hi, n, amount);
  } else if (w.mode == WALK_FAST) {
    trunc_pairs_kernel<WIDE, 3, WALK_FAST, true><<<grid, THREADS, 0, st>>>(
        x, w, d, out_lo, out_hi, n, amount);
  } else {
    trunc_pairs_kernel<WIDE, 3, WALK_WIDE, true><<<grid, THREADS, 0, st>>>(
        x, w, d, out_lo, out_hi, n, amount);
  }
}

}  // namespace

// The whole truncation of n elements after its draws.
//   input 0 (pairs): x_lo[0] / x_hi[0] point at the (party 0, slot 0)
//     word of the operand's (3, 2, *shape) pair layout, xp words between
//     parties; element e of the logical shape, whose `dims` collapsed
//     axes (innermost last, at most 8) have the sizes `sizes`, is read at
//     the word offset sum_d c_d strides[d] (0 on a broadcast axis).
//   input 1 (cross): x_lo[0] / x_hi[0] the contiguous (3, n) cross terms.
//   input 2 (additive): x_lo[0..1] / x_hi[0..1] the contiguous a0 and a1.
// xp, dims, sizes and strides are ignored but for pairs.  d_lo / d_hi:
// the contiguous r, m_rt, m_rm and z0, n words each (m_r is not read).
// out: the contiguous (3, 2, n) pair layout, or for additive the (3, n)
// values.  The *_hi pointers are ignored (and may be null) when
// wide == 0.  Requires 0 <= amount <= width - 2.  Launches on `stream`;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int moose_trunc_pairs(
    const void* const* x_lo, const void* const* x_hi, long long xp,
    int dims, const long long* sizes, const long long* strides,
    const void* const* d_lo, const void* const* d_hi, void* out_lo,
    void* out_hi, long long n, int input, int amount, int wide,
    void* stream) {
  const int width = wide ? 128 : 64;
  if (input < PAIRS || input > ADDITIVE || amount < 0 ||
      amount > width - 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Walk<1> w;
  const long long* const walk_strides[1] = {strides};
  const long long one = 1;
  const long long* const contig[1] = {&one};
  if (!(input == PAIRS ? walk_init<1>(w, n, dims, sizes, walk_strides)
                       : walk_init<1>(w, n, 1, &n, contig))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  Operand x = {};
  for (int p = 0; p < 3; ++p) {
    const long long at = input == PAIRS ? p * xp : input == CROSS ? p * n : 0;
    const int part = input == ADDITIVE && p > 0 ? 1 : 0;  // a1 twice
    x.lo[p] = u(x_lo[part]) + at;
    x.hi[p] = wide ? u(x_hi[part]) + at : nullptr;
  }
  Draws d;
  for (int j = 0; j < DRAWS; ++j) {
    d.lo[j] = u(d_lo[j]);
    d.hi[j] = wide ? u(d_hi[j]) : nullptr;
  }
  auto o = [](void* ptr) { return static_cast<uint64_t*>(ptr); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    launch<true>(input, x, w, d, o(out_lo), o(out_hi), n, amount, s);
  } else {
    launch<false>(input, x, w, d, o(out_lo), nullptr, n, amount, s);
  }
  return static_cast<int>(cudaGetLastError());
}
