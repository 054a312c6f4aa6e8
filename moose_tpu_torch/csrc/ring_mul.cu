// ring_mul: elementwise ring multiply, the second factor broadcast.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py: ring_mul
// (pallas_call body _mul_body).  out = a * b mod 2^64 or 2^128 for every
// element of a; b is either at a's shape or at any shape that broadcasts
// to it, read through its strides (0 on a broadcast axis).
// spmd.mul_public passes the public constant at its own shape: (), a
// (64, 1) column, the (k, 1, ...) weights of a weighted bit sum.
//
// What bounds it on the card: bytes.  Per ring128 element it reads one
// (lo, hi) word of a and writes one, 32 bytes, plus b's words once (48
// bytes per element when b is at a's shape), against one wide product
// (lo*lo in full with __umul64hi, the cross products mod 2^64).
//
// What the design does about it: 16-byte loads and stores, two u64 words
// of one plane (lo or hi) each, and two such pairs per thread, a warp's
// instruction on 512 contiguous bytes, so a thread has up to eight
// 16-byte loads in flight; the grid covers the call up to eight waves of
// blocks resident on every SM (from the SM count) and loops beyond.  The
// wrapper gives the output the 16-byte parity of a's low plane, so a
// view of a at an odd word offset costs one scalar head element; an odd
// end costs one scalar tail element.  Any other operand that is not
// aligned with a at the head is read with two 8-byte loads instead.  b
// comes in three modes: at a's shape and contiguous (read like a), one
// word (the same word for every thread), or strided (its word index
// computed per pair from the collapsed broadcast shape, dividing by
// magic numbers, and stepped along the innermost axis; with a stride of
// 0 there the word is loaded once per pair).  The TPU kernel's 16-bit
// limbs are not carried over: Hopper multiplies u64 words natively.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int PAIRS = 2;  // aligned pairs of elements per thread per tile
constexpr int WAVES = 8;
constexpr int MAX_DIMS = 8;

enum BMode { B_FULL = 0, B_SCALAR = 1, B_STRIDED = 2 };

// b's broadcast shape, collapsed: element i of a (flat) has coordinates
// in size[0..dims) (innermost last) and reads b's word sum c_d stride[d]
struct Bcast {
  int dims;
  int fast;        // indices and offsets below 2^31: 32-bit arithmetic
  long long run;   // size[dims - 1]
  long long step;  // stride[dims - 1]
  long long size[MAX_DIMS];
  long long stride[MAX_DIMS];
  // i / size[d] = (umulhi(i, magic[d]) + i) >> shift[d] for i < 2^31
  unsigned magic[MAX_DIMS];
  int shift[MAX_DIMS];
};

// b's word offset of element i and i's innermost coordinate; the loops
// are unrolled over MAX_DIMS so that every index is a constant
__device__ __forceinline__ long long b_offset(const Bcast& bc, long long i,
                                              long long& inner) {
  if (bc.fast) {
    unsigned u = static_cast<unsigned>(i);
    unsigned off = 0;
    unsigned in = 0;
#pragma unroll
    for (int d = MAX_DIMS - 1; d >= 0; --d) {
      if (d >= bc.dims) continue;
      const unsigned q = (__umulhi(u, bc.magic[d]) + u) >> bc.shift[d];
      const unsigned c = u - q * static_cast<unsigned>(bc.size[d]);
      if (d == bc.dims - 1) in = c;
      off += c * static_cast<unsigned>(bc.stride[d]);
      u = q;
    }
    inner = in;
    return off;
  }
  long long off = 0;
  inner = 0;
#pragma unroll
  for (int d = MAX_DIMS - 1; d >= 0; --d) {
    if (d >= bc.dims) continue;
    const long long q = i / bc.size[d];
    const long long c = i - q * bc.size[d];
    if (d == bc.dims - 1) inner = c;
    off += c * bc.stride[d];
    i = q;
  }
  return off;
}

__device__ __forceinline__ void load2(const uint64_t* __restrict__ p,
                                      long long i, bool vec, uint64_t& v0,
                                      uint64_t& v1) {
  if (vec) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p + i);
    v0 = v.x;
    v1 = v.y;
  } else {
    v0 = p[i];
    v1 = p[i + 1];
  }
}

// the b words of the pair i, i + 1
template <bool WIDE, int MODE>
__device__ __forceinline__ void load_b(const uint64_t* __restrict__ b_lo,
                                       const uint64_t* __restrict__ b_hi,
                                       long long i, bool vec_lo, bool vec_hi,
                                       const Bcast& bc, uint64_t bl[2],
                                       uint64_t bh[2]) {
  if (MODE == B_FULL) {
    load2(b_lo, i, vec_lo, bl[0], bl[1]);
    if (WIDE) load2(b_hi, i, vec_hi, bh[0], bh[1]);
  } else if (MODE == B_SCALAR) {
    bl[0] = bl[1] = b_lo[0];
    if (WIDE) bh[0] = bh[1] = b_hi[0];
  } else {
    long long inner;
    const long long off = b_offset(bc, i, inner);
    const long long next =
        inner + 1 < bc.run ? off + bc.step : b_offset(bc, i + 1, inner);
    bl[0] = b_lo[off];
    if (WIDE) bh[0] = b_hi[off];
    if (next == off) {  // a stride of 0: the same word
      bl[1] = bl[0];
      if (WIDE) bh[1] = bh[0];
    } else {
      bl[1] = b_lo[next];
      if (WIDE) bh[1] = b_hi[next];
    }
  }
}

// one element, scalar loads: the head and the tail
template <bool WIDE, int MODE>
__device__ __forceinline__ void one(const uint64_t* __restrict__ a_lo,
                                    const uint64_t* __restrict__ a_hi,
                                    const uint64_t* __restrict__ b_lo,
                                    const uint64_t* __restrict__ b_hi,
                                    uint64_t* __restrict__ out_lo,
                                    uint64_t* __restrict__ out_hi,
                                    long long i, const Bcast& bc) {
  long long j = i;
  if (MODE == B_SCALAR) {
    j = 0;
  } else if (MODE == B_STRIDED) {
    long long inner;
    j = b_offset(bc, i, inner);
  }
  ring_store<WIDE>(out_lo, out_hi, i,
                   ring_mul<WIDE>(ring_load<WIDE>(a_lo, a_hi, i),
                                  ring_load<WIDE>(b_lo, b_hi, j)));
}

// pairs of elements (head + 2q, head + 2q + 1), q < pairs, a_lo, out_lo
// and out_hi 16-byte aligned at head; flags: bit 0 a_hi, bit 1 b_lo,
// bit 2 b_hi aligned there too (else read with 8-byte loads).  A block
// takes tiles of PAIRS * THREADS pairs, thread t pairs t, t + THREADS,
// ..., so each load or store instruction of a warp covers 512
// contiguous bytes of one plane; every pair's loads are issued before
// the first product.
template <bool WIDE, int MODE>
__global__ void __launch_bounds__(THREADS)
ring_mul_kernel(const uint64_t* __restrict__ a_lo,
                const uint64_t* __restrict__ a_hi,
                const uint64_t* __restrict__ b_lo,
                const uint64_t* __restrict__ b_hi,
                uint64_t* __restrict__ out_lo, uint64_t* __restrict__ out_hi,
                long long n, int head, int flags, Bcast bc) {
  const bool vec_ahi = flags & 1;
  const bool vec_blo = flags & 2;
  const bool vec_bhi = flags & 4;
  const long long pairs = (n - head) / 2;
  constexpr int TILE = PAIRS * THREADS;
  for (long long tile = (long long)blockIdx.x * TILE; tile < pairs;
       tile += (long long)gridDim.x * TILE) {
    uint64_t al[PAIRS][2] = {}, ah[PAIRS][2] = {};
    uint64_t bl[PAIRS][2] = {}, bh[PAIRS][2] = {};
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const long long q = tile + k * THREADS + threadIdx.x;
      if (q < pairs) {
        const long long i = head + 2 * q;
        load2(a_lo, i, true, al[k][0], al[k][1]);
        if (WIDE) load2(a_hi, i, vec_ahi, ah[k][0], ah[k][1]);
        load_b<WIDE, MODE>(b_lo, b_hi, i, vec_blo, vec_bhi, bc, bl[k],
                           bh[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const long long q = tile + k * THREADS + threadIdx.x;
      if (q < pairs) {
        const long long i = head + 2 * q;
        const Ring r0 = ring_mul<WIDE>(Ring{al[k][0], ah[k][0]},
                                       Ring{bl[k][0], bh[k][0]});
        const Ring r1 = ring_mul<WIDE>(Ring{al[k][1], ah[k][1]},
                                       Ring{bl[k][1], bh[k][1]});
        *reinterpret_cast<ulonglong2*>(out_lo + i) =
            make_ulonglong2(r0.lo, r1.lo);
        if (WIDE) {
          *reinterpret_cast<ulonglong2*>(out_hi + i) =
              make_ulonglong2(r0.hi, r1.hi);
        }
      }
    }
  }
  // the scalar rest: the head element and the odd last one
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (head) one<WIDE, MODE>(a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, 0, bc);
    if ((n - head) % 2) {
      one<WIDE, MODE>(a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, n - 1, bc);
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the most blocks the grid takes: WAVES waves of blocks resident on
// every SM; larger calls loop over tiles
int max_blocks() {
  static int blocks[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (blocks[dev] == 0) {
    int sms = 0;
    int per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    blocks[dev] = sms * (per_sm / THREADS) * WAVES;
  }
  return blocks[dev];
}

template <bool WIDE, int MODE>
void launch(const uint64_t* a_lo, const uint64_t* a_hi, const uint64_t* b_lo,
            const uint64_t* b_hi, uint64_t* out_lo, uint64_t* out_hi,
            long long n, int head, int flags, const Bcast& bc,
            cudaStream_t s) {
  const long long pairs = (n - head) / 2;
  long long blocks = (pairs + PAIRS * THREADS - 1) / (PAIRS * THREADS);
  if (blocks > max_blocks()) blocks = max_blocks();
  if (blocks < 1) blocks = 1;  // the scalar rest
  ring_mul_kernel<WIDE, MODE><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, n, head, flags, bc);
}

template <bool WIDE>
void launch_mode(const uint64_t* a_lo, const uint64_t* a_hi,
                 const uint64_t* b_lo, const uint64_t* b_hi,
                 uint64_t* out_lo, uint64_t* out_hi, long long n, int head,
                 int flags, int mode, const Bcast& bc, cudaStream_t s) {
  if (mode == B_FULL) {
    launch<WIDE, B_FULL>(a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, n, head,
                         flags, bc, s);
  } else if (mode == B_SCALAR) {
    launch<WIDE, B_SCALAR>(a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, n, head,
                           flags, bc, s);
  } else {
    launch<WIDE, B_STRIDED>(a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, n, head,
                            flags, bc, s);
  }
}

}  // namespace

// a and out: (lo, hi) pointer pairs of n contiguous words, out_lo and
// out_hi with the same 16-byte parity as a_lo; b: (lo, hi) words read as
// `mode` says (0: n contiguous words, 1: one word, 2: through the dims
// collapsed sizes and strides, innermost last, at most 8).  The *_hi
// pointers are ignored (and may be null) when wide == 0.  Launches on
// `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int moose_ring_mul(const void* a_lo, const void* a_hi,
                              const void* b_lo, const void* b_hi,
                              void* out_lo, void* out_hi, long long n,
                              int wide, int mode, int dims,
                              const long long* sizes,
                              const long long* strides, void* stream) {
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  const auto al = u(a_lo);
  const int head = aligned(al) ? 0 : 1;
  auto at_head = [&](const void* p) {
    return p != nullptr && aligned(u(p) + head);
  };
  if (n <= 0 || mode < B_FULL || mode > B_STRIDED ||
      (mode == B_STRIDED && (dims < 1 || dims > MAX_DIMS)) ||
      !at_head(out_lo) || (wide && !at_head(out_hi))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bcast bc = {};
  bc.dims = mode == B_STRIDED ? dims : 0;
  for (int d = 0; d < bc.dims; ++d) {
    bc.size[d] = sizes[d];
    bc.stride[d] = strides[d];
  }
  if (bc.dims > 0) {
    bc.run = bc.size[bc.dims - 1];
    bc.step = bc.stride[bc.dims - 1];
  }
  long long last = 0;  // b's largest word offset
  for (int d = 0; d < bc.dims; ++d) last += (bc.size[d] - 1) * bc.stride[d];
  bc.fast = n < (1ll << 31) && last < (1ll << 31);
  for (int d = 0; d < bc.dims && bc.fast; ++d) {
    // the round-up divider: shift = ceil(log2 size), magic =
    // 2^32 (2^shift - size) / size + 1, exact for dividends below 2^31
    int shift = 0;
    while ((1ll << shift) < bc.size[d]) ++shift;
    bc.shift[d] = shift;
    bc.magic[d] = static_cast<unsigned>(
        ((1ull << 32) * ((1ull << shift) - bc.size[d])) / bc.size[d] + 1);
  }
  int flags = 0;
  if (wide && at_head(a_hi)) flags |= 1;
  if (mode == B_FULL && at_head(b_lo)) flags |= 2;
  if (mode == B_FULL && wide && at_head(b_hi)) flags |= 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto o = [](void* ptr) { return static_cast<uint64_t*>(ptr); };
  if (wide) {
    launch_mode<true>(al, u(a_hi), u(b_lo), u(b_hi), o(out_lo), o(out_hi), n,
                      head, flags, mode, bc, s);
  } else {
    launch_mode<false>(al, nullptr, u(b_lo), nullptr, o(out_lo), nullptr, n,
                       head, flags, mode, bc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
