// threefry: counter-mode expansion of a threefry2x32-20 key into uniform
// u64 words or uniform bits.
//
// Replaces the TPU kernel moose_tpu/dialects/pallas_prf.py:
// random_bits_u64 (pallas_call body _kernel), and also expands the
// default "threefry" stream, which the JAX package draws with
// jax.random.bits.  The two streams share the cipher and differ in their
// counter layout (the host folds the seed into the key words k0, k1, so
// the kernel never sees a seed):
//
//   layout 0, "threefry" (jax.random.bits on a partitionable threefry
//     key): element i encrypts the block (i >> 32, i & 0xFFFFFFFF);
//     a word is (y0 << 32) | y1, a bit is bit 0 of y0 ^ y1.
//   layout 1, "threefry-pallas" (K7): word i encrypts (c, ~c) for the
//     u32 lane index c = i, so one key covers at most 2^32 words; a word
//     is (y0 << 32) | y1.  Bits come 64 to a word: element 64w + j is
//     bit j of word w, least significant first.
//
// What bounds it on the card: its operations and its store about
// equally.  A word costs 20 rounds of add, rotate and xor plus five key
// injections, some 73 32-bit integer instructions; at the card's issue
// rate (128 lanes per SM and clock) they take about as long as the
// word's 8-byte store at 3.35 TB/s, and the 40 rotations and xors, which
// issue only on the 64 INT32 lanes of an SM, take as long again.
//
// What the design does about it: one thread per output word (per bit for
// layout 0's bits), grid-stride over an int64 count; the cipher runs in
// u32 registers with each rotation one funnel shift, the round schedule
// unrolled with its constants in the instructions, and nothing is read
// from memory.  The TPU kernel's split into two u32 planes (Mosaic has
// no 64-bit lanes) and its 65,536-lane blocks are not carried over: a
// thread writes its u64 word directly, and a layout 1 bit thread writes
// its 64 unpacked bytes as four 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

// 20 rounds of threefry2x32 on the block (x0, x1) under (k0, k1): groups
// of four rounds with rotations (13, 15, 26, 6) and (17, 29, 16, 24) in
// turn, the key schedule injected after each group.
__device__ __forceinline__ void threefry2x32_20(uint32_t& x0, uint32_t& x1,
                                                uint32_t k0, uint32_t k1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  x0 += k0;
  x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// The encrypted counter block of element i in the given layout.
template <int LAYOUT>
__device__ __forceinline__ void block(long long i, uint32_t k0, uint32_t k1,
                                      uint32_t& y0, uint32_t& y1) {
  if (LAYOUT == 0) {
    y0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
    y1 = static_cast<uint32_t>(i);
  } else {
    y0 = static_cast<uint32_t>(i);
    y1 = ~y0;
  }
  threefry2x32_20(y0, y1, k0, k1);
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
threefry_words_kernel(uint64_t* __restrict__ out, long long n, uint32_t k0,
                      uint32_t k1) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t y0, y1;
    block<LAYOUT>(i, k0, k1, y0, y1);
    out[i] = (static_cast<uint64_t>(y0) << 32) | y1;
  }
}

// layout 0: one bit per block, bit 0 of y0 ^ y1
__global__ void __launch_bounds__(THREADS)
threefry_bits_kernel(uint8_t* __restrict__ out, long long n, uint32_t k0,
                     uint32_t k1) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t y0, y1;
    block<0>(i, k0, k1, y0, y1);
    out[i] = static_cast<uint8_t>((y0 ^ y1) & 1u);
  }
}

// Four bits to four 0/1 bytes, bit j to byte j: the products of the
// shifted copies do not overlap, so no carry crosses a byte.
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// layout 1: 64 bits per word; the n outputs are bytes, 16-byte aligned
__global__ void __launch_bounds__(THREADS)
threefry_pallas_bits_kernel(uint8_t* __restrict__ out, long long n,
                            uint32_t k0, uint32_t k1) {
  const long long words = (n + 63) / 64;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += stride) {
    uint32_t y0, y1;
    block<1>(w, k0, k1, y0, y1);
    const uint64_t word = (static_cast<uint64_t>(y0) << 32) | y1;
    const long long base = w * 64;
    if (base + 64 <= n) {
      uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bits16 = static_cast<uint32_t>(word >> (16 * q));
        dst[q] = make_uint4(spread4(bits16 & 0xFu),
                            spread4((bits16 >> 4) & 0xFu),
                            spread4((bits16 >> 8) & 0xFu),
                            spread4((bits16 >> 12) & 0xFu));
      }
    } else {
      for (long long j = 0; j < n - base; ++j) {
        out[base + j] = static_cast<uint8_t>((word >> j) & 1u);
      }
    }
  }
}

unsigned grid_for(long long units) {
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

}  // namespace

// Fills `out` with n outputs of the stream keyed by (k0, k1): u64 words
// when bits == 0, uint8 0/1 bits when bits == 1; layout 0 is "threefry",
// 1 is "threefry-pallas".  Layout 1 refuses more than 2^32 words (its
// u32 counter would repeat) and a bits buffer that is not 16-byte
// aligned.  Launches on `stream`; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for what it refuses.
extern "C" int moose_threefry(void* out, long long n, unsigned int k0,
                              unsigned int k1, int layout, int bits,
                              void* stream) {
  if (n <= 0) return 0;
  const long long words = bits ? (n + 63) / 64 : n;
  if (layout == 1 && words > (1ll << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == 1 && bits && reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bits) {
    uint64_t* dst = static_cast<uint64_t*>(out);
    if (layout == 0) {
      threefry_words_kernel<0><<<grid_for(n), THREADS, 0, s>>>(dst, n, k0, k1);
    } else {
      threefry_words_kernel<1><<<grid_for(n), THREADS, 0, s>>>(dst, n, k0, k1);
    }
  } else {
    uint8_t* dst = static_cast<uint8_t*>(out);
    if (layout == 0) {
      threefry_bits_kernel<<<grid_for(n), THREADS, 0, s>>>(dst, n, k0, k1);
    } else {
      threefry_pallas_bits_kernel<<<grid_for(words), THREADS, 0, s>>>(
          dst, n, k0, k1);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
