// bits_adder: arithmetic-to-binary conversion (bit decomposition) and its
// most significant bit, one kernel for both.
//
// Replaces the TPU kernels moose_tpu/native/ring128_kernels.py:
// bit_decompose and msb (one pallas_call body, _bits_body).  From a
// party-stacked replicated sharing x = x0 + x1 + x2 (words (3, 2, n)) and
// the pre-drawn AND banks (uint8 0/1, (n_ands, 3, k, n)) it builds the
// bit planes of the held shares, the three statically masked summands,
// the carry-save step and a Kogge-Stone adder, exactly as
// spmd_math._bit_decompose_with_banks of the JAX package, and writes the
// XOR-shared bits (3, 2, k, n) as uint8 0/1, or only bit k - 1
// (3, 2, n) when MSB_ONLY.
//
// What bounds it on the card: bytes.  The AND banks dominate: at ring128
// 16 ANDs x 3 parties x 128 bits = 6,144 bytes per element, against
// 96 bytes of input words and 768 bytes of output bits (6 for msb).  The
// adder itself is a few thousand 32-bit logic operations per element.
//
// What the design does about it: one thread per element.  Each
// (party, slot) bit vector of length k lives in registers as one u64
// (ring64) or two (ring128) bitmasks, so a bit plane of the held share is
// the share's own word, the adder's shift along the bit axis is a word
// shift, AND and XOR are word operations and the party roll is a
// register permutation.  Each bank's 3 x k bytes are packed into masks as
// they are read; the bank layout keeps the element index innermost, so
// neighbouring threads read neighbouring bytes.  Bits are unpacked to
// uint8 planes only on the store.  The banks are consumed in the order of
// adder_bank_count: 2 carry-save ANDs, the adder's first g, then per
// round the g update and, while 2d < k, the p_run update.  The TPU
// kernel's u32 planes and u8 bit arrays in VMEM are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int THREADS = 256;

// a replicated bit sharing of one element: v[party][slot] is the k-bit
// vector of that pair slot, bit j at bit j of the (lo, hi) mask
struct Bits {
  Ring v[3][2];
};

__device__ __forceinline__ Ring bxor(Ring a, Ring b) {
  return Ring{a.lo ^ b.lo, a.hi ^ b.hi};
}

__device__ __forceinline__ Ring band(Ring a, Ring b) {
  return Ring{a.lo & b.lo, a.hi & b.hi};
}

__device__ __forceinline__ Bits bits_xor(const Bits& a, const Bits& b) {
  Bits r;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int s = 0; s < 2; ++s) r.v[p][s] = bxor(a.v[p][s], b.v[p][s]);
  return r;
}

// shift toward the most significant bit by d, filling zeros
template <bool WIDE>
__device__ __forceinline__ Bits bits_shl(const Bits& a, int d) {
  Bits r;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int s = 0; s < 2; ++s) r.v[p][s] = ring_shl<WIDE>(a.v[p][s], d);
  return r;
}

// bank `a` of one element: for each party, bits j = 0..k-1 packed into a
// mask from the bytes at ((a * 3 + p) * k + j) * n + i
template <bool WIDE>
__device__ __forceinline__ void load_bank(const uint8_t* __restrict__ banks,
                                          int a, long long n, long long i,
                                          Ring s[3]) {
  constexpr int K = WIDE ? 128 : 64;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const uint8_t* base = banks + (long long)(a * 3 + p) * K * n + i;
    uint64_t lo = 0ull;
    uint64_t hi = 0ull;
#pragma unroll 16
    for (int j = 0; j < 64; ++j)
      lo |= (uint64_t)(base[(long long)j * n] & 1u) << j;
    if (WIDE) {
#pragma unroll 16
      for (int j = 0; j < 64; ++j)
        hi |= (uint64_t)(base[(long long)(64 + j) * n] & 1u) << j;
    }
    s[p] = Ring{lo, hi};
  }
}

// replicated AND over Z_2 with bank `a` as the XOR zero share:
// z_p = (x_p0 & (y_p0 ^ y_p1)) ^ (x_p1 & y_p0) ^ s_p ^ s_{p+1}, reshared
// into the pair layout (z_p, z_{p+1})
template <bool WIDE>
__device__ __forceinline__ Bits bits_and(const Bits& x, const Bits& y,
                                         const uint8_t* __restrict__ banks,
                                         int a, long long n, long long i) {
  Ring s[3];
  load_bank<WIDE>(banks, a, n, i, s);
  Ring z[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const Ring v = bxor(band(x.v[p][0], bxor(y.v[p][0], y.v[p][1])),
                        band(x.v[p][1], y.v[p][0]));
    z[p] = bxor(v, bxor(s[p], s[(p + 1) % 3]));
  }
  Bits r;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    r.v[p][0] = z[p];
    r.v[p][1] = z[(p + 1) % 3];
  }
  return r;
}

__device__ __forceinline__ uint8_t bit_of(Ring w, int j) {
  const uint64_t word = j < 64 ? w.lo : w.hi;
  return static_cast<uint8_t>((word >> (j & 63)) & 1ull);
}

template <bool WIDE, bool MSB_ONLY>
__global__ void __launch_bounds__(THREADS)
bits_adder_kernel(const uint64_t* __restrict__ x_lo,
                  const uint64_t* __restrict__ x_hi,
                  const uint8_t* __restrict__ banks,
                  uint8_t* __restrict__ out, long long n) {
  constexpr int K = WIDE ? 128 : 64;
  const Ring zero = ring_const<WIDE>(0ull, 0ull);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // summand j is the share x_j, held at pair slots (j, 0) and (j-1, 1)
    Bits b[3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const Ring w = ring_load<WIDE>(x_lo, x_hi, (long long)(p * 2 + s) * n + i);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const bool held = s == 0 ? p == j : p == (j + 2) % 3;
          b[j].v[p][s] = held ? w : zero;
        }
      }

    // carry-save: sum = b0 ^ b1 ^ b2, carry = (b0 & b1) ^ ((b0 ^ b1) & b2)
    const Bits b01 = bits_xor(b[0], b[1]);
    const Bits sum = bits_xor(b01, b[2]);
    const Bits carry = bits_xor(bits_and<WIDE>(b[0], b[1], banks, 0, n, i),
                                bits_and<WIDE>(b01, b[2], banks, 1, n, i));
    const Bits y = bits_shl<WIDE>(carry, 1);

    // Kogge-Stone adder of sum + y: log2(k) rounds of two ANDs
    const Bits prop = bits_xor(sum, y);
    Bits g = bits_and<WIDE>(sum, y, banks, 2, n, i);
    Bits p_run = prop;
    int a = 3;
#pragma unroll
    for (int round = 0; (1 << round) < K; ++round) {
      const int d = 1 << round;
      g = bits_xor(g, bits_and<WIDE>(p_run, bits_shl<WIDE>(g, d), banks, a++,
                                     n, i));
      if (2 * d < K) {
        p_run = bits_and<WIDE>(p_run, bits_shl<WIDE>(p_run, d), banks, a++,
                               n, i);
      }
    }
    const Bits r = bits_xor(prop, bits_shl<WIDE>(g, 1));

#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const long long row = (long long)(p * 2 + s);
        if (MSB_ONLY) {
          out[row * n + i] = bit_of(r.v[p][s], K - 1);
        } else {
#pragma unroll 16
          for (int j = 0; j < K; ++j)
            out[(row * K + j) * n + i] = bit_of(r.v[p][s], j);
        }
      }
  }
}

template <bool WIDE>
void launch(const void* x_lo, const void* x_hi, const void* banks, void* out,
            long long n, int msb_only, unsigned blocks, cudaStream_t s) {
  auto lo = static_cast<const uint64_t*>(x_lo);
  auto hi = WIDE ? static_cast<const uint64_t*>(x_hi) : nullptr;
  auto bk = static_cast<const uint8_t*>(banks);
  auto o = static_cast<uint8_t*>(out);
  if (msb_only) {
    bits_adder_kernel<WIDE, true><<<blocks, THREADS, 0, s>>>(lo, hi, bk, o, n);
  } else {
    bits_adder_kernel<WIDE, false><<<blocks, THREADS, 0, s>>>(lo, hi, bk, o, n);
  }
}

}  // namespace

// x: (lo, hi) words (3, 2, n), the hi pointer ignored (and may be null)
// when wide == 0; banks: uint8 (n_ands, 3, k, n) with n_ands from
// adder_bank_count; out: uint8 (3, 2, k, n), or (3, 2, n) when
// msb_only.  Launches on `stream`; returns cudaGetLastError().
extern "C" int moose_bits_adder(const void* x_lo, const void* x_hi,
                                const void* banks, void* out, long long n,
                                int wide, int msb_only, void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    launch<true>(x_lo, x_hi, banks, out, n, msb_only,
                 static_cast<unsigned>(blocks), s);
  } else {
    launch<false>(x_lo, x_hi, banks, out, n, msb_only,
                  static_cast<unsigned>(blocks), s);
  }
  return static_cast<int>(cudaGetLastError());
}
