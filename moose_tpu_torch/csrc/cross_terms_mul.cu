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
// shape with 32-bit magic-number division where offsets fit (the host
// checks), as ring_mul.cu does for its strided factor.  The TPU kernel's
// 16-bit limbs in u32 lanes (Mosaic has no 64-bit lanes) are not carried
// over: Hopper multiplies u64 words natively.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIMS = 8;

unsigned grid_for(long long n) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

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

// The common logical shape, collapsed (innermost last), and each
// operand's word stride along it (0 on a broadcast axis)
struct Bcast {
  int dims;
  long long size[MAX_DIMS];
  long long xs[MAX_DIMS];
  long long ys[MAX_DIMS];
  // e / size[d] = (umulhi(e, magic[d]) + e) >> shift[d] for e < 2^31
  unsigned magic[MAX_DIMS];
  int shift[MAX_DIMS];
};

enum Mode { CONTIG = 0, FAST = 1, WIDE_INDEX = 2 };

// x's and y's word offsets of element e (party 0, slot 0); the loops are
// unrolled over MAX_DIMS so that every index is a constant
template <int MODE>
__device__ __forceinline__ void offsets(const Bcast& bc, long long e,
                                        long long& xo, long long& yo) {
  if (MODE == CONTIG) {
    xo = yo = e;
  } else if (MODE == FAST) {
    unsigned u = static_cast<unsigned>(e);
    unsigned xoff = 0;
    unsigned yoff = 0;
#pragma unroll
    for (int d = MAX_DIMS - 1; d >= 0; --d) {
      if (d >= bc.dims) continue;
      const unsigned q = (__umulhi(u, bc.magic[d]) + u) >> bc.shift[d];
      const unsigned c = u - q * static_cast<unsigned>(bc.size[d]);
      xoff += c * static_cast<unsigned>(bc.xs[d]);
      yoff += c * static_cast<unsigned>(bc.ys[d]);
      u = q;
    }
    xo = xoff;
    yo = yoff;
  } else {
    xo = yo = 0;
#pragma unroll
    for (int d = MAX_DIMS - 1; d >= 0; --d) {
      if (d >= bc.dims) continue;
      const long long q = e / bc.size[d];
      const long long c = e - q * bc.size[d];
      xo += c * bc.xs[d];
      yo += c * bc.ys[d];
      e = q;
    }
  }
}

// x and y at party 0, slot 0, with xp / yp words between parties; s the
// contiguous (3, n) bank; out the contiguous (3, 2, n) pair layout
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
                           long long xp, long long yp, Bcast bc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    long long xo, yo;
    offsets<MODE>(bc, e, xo, yo);
    Ring x[3], y[3], s[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = ring_load<WIDE>(x_lo, x_hi, xo + i * xp);
      y[i] = ring_load<WIDE>(y_lo, y_hi, yo + i * yp);
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

template <bool WIDE, int MODE>
void launch_reshare(const uint64_t* x_lo, const uint64_t* x_hi,
                    const uint64_t* y_lo, const uint64_t* y_hi,
                    const uint64_t* s_lo, const uint64_t* s_hi,
                    uint64_t* out_lo, uint64_t* out_hi, long long n,
                    long long xp, long long yp, const Bcast& bc,
                    cudaStream_t s) {
  cross_terms_reshare_kernel<WIDE, MODE><<<grid_for(n), THREADS, 0, s>>>(
      x_lo, x_hi, y_lo, y_hi, s_lo, s_hi, out_lo, out_hi, n, xp, yp, bc);
}

template <bool WIDE>
void launch_reshare_mode(int mode, const uint64_t* x_lo, const uint64_t* x_hi,
                         const uint64_t* y_lo, const uint64_t* y_hi,
                         const uint64_t* s_lo, const uint64_t* s_hi,
                         uint64_t* out_lo, uint64_t* out_hi, long long n,
                         long long xp, long long yp, const Bcast& bc,
                         cudaStream_t s) {
  if (mode == CONTIG) {
    launch_reshare<WIDE, CONTIG>(x_lo, x_hi, y_lo, y_hi, s_lo, s_hi, out_lo,
                                 out_hi, n, xp, yp, bc, s);
  } else if (mode == FAST) {
    launch_reshare<WIDE, FAST>(x_lo, x_hi, y_lo, y_hi, s_lo, s_hi, out_lo,
                               out_hi, n, xp, yp, bc, s);
  } else {
    launch_reshare<WIDE, WIDE_INDEX>(x_lo, x_hi, y_lo, y_hi, s_lo, s_hi,
                                     out_lo, out_hi, n, xp, yp, bc, s);
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
  if (wide) {
    cross_terms_mul_kernel<true><<<grid_for(n), THREADS, 0, s>>>(
        u(x0_lo), u(x0_hi), u(x1_lo), u(x1_hi), u(y0_lo), u(y0_hi), u(y1_lo),
        u(y1_hi), static_cast<uint64_t*>(out_lo),
        static_cast<uint64_t*>(out_hi), n);
  } else {
    cross_terms_mul_kernel<false><<<grid_for(n), THREADS, 0, s>>>(
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
  if (n <= 0 || dims < 0 || dims > MAX_DIMS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bcast bc = {};
  bc.dims = dims;
  long long x_last = 0;  // each operand's largest word offset
  long long y_last = 0;
  for (int d = 0; d < dims; ++d) {
    bc.size[d] = sizes[d];
    bc.xs[d] = x_strides[d];
    bc.ys[d] = y_strides[d];
    x_last += (sizes[d] - 1) * x_strides[d];
    y_last += (sizes[d] - 1) * y_strides[d];
  }
  int mode = WIDE_INDEX;
  if (dims == 1 && bc.xs[0] == 1 && bc.ys[0] == 1) {
    mode = CONTIG;
  } else if (n < (1ll << 31) && x_last < (1ll << 31) &&
             y_last < (1ll << 31)) {
    mode = FAST;
    for (int d = 0; d < dims; ++d) {
      // the round-up divider: shift = ceil(log2 size), magic =
      // 2^32 (2^shift - size) / size + 1, exact for dividends below 2^31
      int shift = 0;
      while ((1ll << shift) < bc.size[d]) ++shift;
      bc.shift[d] = shift;
      bc.magic[d] = static_cast<unsigned>(
          ((1ull << 32) * ((1ull << shift) - bc.size[d])) / bc.size[d] + 1);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  auto o = [](void* ptr) { return static_cast<uint64_t*>(ptr); };
  if (wide) {
    launch_reshare_mode<true>(mode, u(x_lo), u(x_hi), u(y_lo), u(y_hi),
                              u(s_lo), u(s_hi), o(out_lo), o(out_hi), n, xp,
                              yp, bc, s);
  } else {
    launch_reshare_mode<false>(mode, u(x_lo), nullptr, u(y_lo), nullptr,
                               u(s_lo), nullptr, o(out_lo), nullptr, n, xp,
                               yp, bc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
