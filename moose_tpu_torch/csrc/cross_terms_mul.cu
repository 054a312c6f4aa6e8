// cross_terms_mul: elementwise cross terms of a secure multiplication,
// alone or fused with the reshare that follows them.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py:
// cross_terms_mul (pallas_call body _cross_mul_body).  Two entry points:
//
//   moose_cross_terms_mul: for every element of the party-stacked (3, n)
//     pair slots, mod 2^64 or 2^128,
//         v = x0 * (y0 + y1) + x1 * y0
//     the regrouped cross terms (two products instead of three).
//   moose_cross_terms_reshare: spmd.mul whole.  It reads the operands x
//     and y in their (3, 2, *shape) pair layout in place (party i holds
//     (x_i, x_{i+1}); only slot 0 is read, x_i, and x_{i+1} is party
//     i + 1's slot 0), each through its own strides, so operands of two
//     logical shapes broadcast to the common one by index arithmetic; and
//     the zero-share bank s (3, *shape) that K7 drew.  One thread owns one
//     logical element for all three parties, in registers:
//         v_i = x_i * (y_i + y_{i+1}) + x_{i+1} * y_i
//         z_i = v_i + s_i - s_{i+1}
//     and writes the reshared pair layout out[i, 0] = z_i,
//     out[i, 1] = z_{i+1}.  What spmd.mul ran around the first entry
//     point (four slot copies, the zero share's two rolls and subtraction,
//     the addition, the pair layout's two rolls and stacks) is gone.
//
// What bounds it on the card: at the protocol's shapes (3 x 1024 to
// 3 x 64 x 1024 elements) the launch: a ring128 call moves 0.25 to
// 12.6 MB, 0.07 to 3.8 us at 3.35 TB/s, below a launch's few
// microseconds.  At 2^20 elements, bytes: per ring128 element the
// reshare reads 3 words of x, 3 of y (slot 0 only, where the first entry
// point's caller copied all 6 of each into four operands) and 3 of the
// bank, and writes 6, 240 bytes, against 6 wide products (lo*lo in full
// with __umul64hi, the cross products mod 2^64) and 12 128-bit adds,
// some 180 32-bit integer instructions, under a tenth of what 240 bytes
// take.
//
// What the design does about it: one thread per element, grid-stride;
// neighbouring threads on neighbouring elements, so every load and store
// of a plane coalesces when the operands are contiguous.  A broadcast
// operand's word index is computed per element from the collapsed common
// shape with 32-bit magic-number division where offsets fit (the strided
// walk of ring_words.cuh, which K2 and K6 share), as ring_mul.cu does for
// its strided factor.  The TPU kernel's
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

// x and y at party 0, slot 0, with xp / yp words between parties, read
// through the walk (operand 0 x, operand 1 y); s the contiguous (3, n)
// bank; out the contiguous (3, 2, n) pair layout
template <bool WIDE, int MODE>
__global__ void __launch_bounds__(THREADS)
cross_terms_reshare_kernel(const uint64_t* __restrict__ x_lo,
                           const uint64_t* __restrict__ x_hi,
                           const uint64_t* __restrict__ y_lo,
                           const uint64_t* __restrict__ y_hi,
                           const uint64_t* __restrict__ s_lo,
                           const uint64_t* __restrict__ s_hi,
                           uint64_t* __restrict__ out_lo,
                           uint64_t* __restrict__ out_hi, long long n,
                           long long xp, long long yp, Walk<2> w) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    long long off[2];
    walk_offsets<MODE, 2>(w, e, off);
    Ring x[3], y[3], s[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = ring_load<WIDE>(x_lo, x_hi, off[0] + i * xp);
      y[i] = ring_load<WIDE>(y_lo, y_hi, off[1] + i * yp);
      s[i] = ring_load<WIDE>(s_lo, s_hi, e + i * n);
    }
    Ring z[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int j = (i + 1) % 3;
      const Ring v = ring_add<WIDE>(
          ring_mul<WIDE>(x[i], ring_add<WIDE>(y[i], y[j])),
          ring_mul<WIDE>(x[j], y[i]));
      z[i] = ring_sub<WIDE>(ring_add<WIDE>(v, s[i]), s[j]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ring_store<WIDE>(out_lo, out_hi, e + 2 * i * n, z[i]);
      ring_store<WIDE>(out_lo, out_hi, e + (2 * i + 1) * n, z[(i + 1) % 3]);
    }
  }
}

template <bool WIDE>
void launch_reshare(const uint64_t* x_lo, const uint64_t* x_hi,
                    const uint64_t* y_lo, const uint64_t* y_hi,
                    const uint64_t* s_lo, const uint64_t* s_hi,
                    uint64_t* out_lo, uint64_t* out_hi, long long n,
                    long long xp, long long yp, const Walk<2>& w,
                    cudaStream_t st) {
  const unsigned grid = grid_for(n, THREADS);
  if (w.mode == WALK_CONTIG) {
    cross_terms_reshare_kernel<WIDE, WALK_CONTIG><<<grid, THREADS, 0, st>>>(
        x_lo, x_hi, y_lo, y_hi, s_lo, s_hi, out_lo, out_hi, n, xp, yp, w);
  } else if (w.mode == WALK_FAST) {
    cross_terms_reshare_kernel<WIDE, WALK_FAST><<<grid, THREADS, 0, st>>>(
        x_lo, x_hi, y_lo, y_hi, s_lo, s_hi, out_lo, out_hi, n, xp, yp, w);
  } else {
    cross_terms_reshare_kernel<WIDE, WALK_WIDE><<<grid, THREADS, 0, st>>>(
        x_lo, x_hi, y_lo, y_hi, s_lo, s_hi, out_lo, out_hi, n, xp, yp, w);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  const unsigned grid = grid_for(n, THREADS);
  if (wide) {
    cross_terms_mul_kernel<true><<<grid, THREADS, 0, s>>>(
        u(x0_lo), u(x0_hi), u(x1_lo), u(x1_hi), u(y0_lo), u(y0_hi), u(y1_lo),
        u(y1_hi), static_cast<uint64_t*>(out_lo),
        static_cast<uint64_t*>(out_hi), n);
  } else {
    cross_terms_mul_kernel<false><<<grid, THREADS, 0, s>>>(
        u(x0_lo), nullptr, u(x1_lo), nullptr, u(y0_lo), nullptr, u(y1_lo),
        nullptr, static_cast<uint64_t*>(out_lo), nullptr, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// spmd.mul's cross terms and reshare.  x and y point at the (party 0,
// slot 0) word of each operand's (3, 2, *shape) pair layout, xp / yp
// words between parties; element e of the n-element common shape, whose
// `dims` collapsed axes (innermost last, at most 8) have the sizes
// `sizes`, reads x at the word offset sum_d c_d x_strides[d] (0 on a
// broadcast axis), y likewise; s is the contiguous (3, n) zero-share bank
// and out the contiguous (3, 2, n) result.  The *_hi pointers are ignored
// (and may be null) when wide == 0.  Launches on `stream`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int moose_cross_terms_reshare(
    const void* x_lo, const void* x_hi, const void* y_lo, const void* y_hi,
    const void* s_lo, const void* s_hi, void* out_lo, void* out_hi,
    long long n, int wide, int dims, const long long* sizes,
    const long long* x_strides, const long long* y_strides, long long xp,
    long long yp, void* stream) {
  Walk<2> w;
  const long long* const strides[2] = {x_strides, y_strides};
  if (!walk_init<2>(w, n, dims, sizes, strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  auto o = [](void* ptr) { return static_cast<uint64_t*>(ptr); };
  if (wide) {
    launch_reshare<true>(u(x_lo), u(x_hi), u(y_lo), u(y_hi), u(s_lo),
                         u(s_hi), o(out_lo), o(out_hi), n, xp, yp, w, s);
  } else {
    launch_reshare<false>(u(x_lo), nullptr, u(y_lo), nullptr, u(s_lo),
                          nullptr, o(out_lo), nullptr, n, xp, yp, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
