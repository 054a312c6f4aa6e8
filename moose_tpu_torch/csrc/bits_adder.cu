// bits_adder: arithmetic-to-binary conversion (bit decomposition) and its
// most significant bit, one pair of kernels for both.
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
// What the design does about it: two kernels.
// 1. bits_adder_pack, run by the whole card: a thread takes one (bank,
//    party) pair, 8 bit rows and 16 consecutive elements, reads each row
//    with one 16-byte load and folds the 8 rows into 16 bytes with
//    (row & 0x0101..01) << r, each byte the bits j..j+7 of one element.
//    The block (8 warps, the 64 rows of one mask word, 512 elements)
//    regroups the bytes through shared memory into u64 masks and writes
//    them element-innermost into the scratch (n_ands, 3, k / 64, n) that
//    the wrapper allocates, 16 bytes a store.
// 2. bits_adder_add, one thread per element in blocks of 64: each
//    (party, slot) bit vector of length k lives in registers as one u64
//    (ring64) or two (ring128) masks, so a bit plane of the held share is
//    the share's own word, the adder's shift along the bit axis is a word
//    shift, AND and XOR are word operations and the party roll is a
//    register permutation.  A bank is 3 (ring64) or 6 (ring128) coalesced
//    u64 loads, issued two banks ahead of the AND that consumes it.  The
//    banks are consumed in the order of adder_bank_count: 2 carry-save
//    ANDs, the adder's first g, then per round the g update and, while
//    2d < k, the p_run update.  bit_decompose unpacks the block's result
//    masks through shared memory (the inverse of the pack's fold) and
//    writes each bit row of 16 consecutive elements with one 16-byte
//    store; msb writes its one plane directly.
// The TPU kernel's u32 planes and u8 bit arrays in VMEM are not carried
// over.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int PACK_THREADS = 256;  // 8 warps: 8 rows of a mask word each
constexpr int PACK_ELEMS = 512;    // 32 lanes x 16 elements
constexpr int ADD_THREADS = 64;    // elements per adder block
constexpr int GROUP = 16;          // elements per 16-byte bit row
constexpr uint64_t LOW_BITS = 0x0101010101010101ull;

// AND banks of a k-bit adder: 2 carry-save, the first g, and per round
// d = 1, 2, 4, ... < k the g update and, while 2d < k, the p_run update
__host__ __device__ constexpr int bank_count(int k) {
  int n = 3;
  for (int d = 1; d < k; d *= 2) n += 2 * d < k ? 2 : 1;
  return n;
}

// ---------------------------------------------------------------------------
// Stage 1: pack the uint8 banks into u64 masks
// ---------------------------------------------------------------------------

// grid (ceil(n / 512), n_ands * 3 * words); blockIdx.y is the mask row
// (bank a, party p, word w) = (a * 3 + p) * words + w, whose bit rows are
// 64 * blockIdx.y .. + 63 of the bank tensor.  VEC: n % 16 == 0 and the
// banks 16-byte aligned, so every row read is one 16-byte load.
__global__ void __launch_bounds__(PACK_THREADS)
bits_adder_pack(const uint8_t* __restrict__ banks,
                uint64_t* __restrict__ masks, long long n, int vec) {
  __shared__ __align__(16) uint8_t planes[8][PACK_ELEMS];
  const int group = threadIdx.x >> 5;  // bit rows 8 * group .. + 7
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.y * 64 + group * 8;
  const long long e0 = (long long)blockIdx.x * PACK_ELEMS + lane * GROUP;

  // byte q of acc[h] gathers bit 0 of rows r = 0..7 of element
  // e0 + 8h + q at its bit r
  uint64_t acc0 = 0ull;
  uint64_t acc1 = 0ull;
  if (vec) {
    if (e0 < n) {  // n % 16 == 0: the group is whole
      ulonglong2 rows[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        rows[r] = *reinterpret_cast<const ulonglong2*>(
            banks + (row0 + r) * n + e0);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc0 |= (rows[r].x & LOW_BITS) << r;
        acc1 |= (rows[r].y & LOW_BITS) << r;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint8_t* row = banks + (row0 + r) * n;
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        const long long e = e0 + q;
        const uint64_t bit = e < n ? (uint64_t)(row[e] & 1u) : 0ull;
        if (q < 8) {
          acc0 |= bit << (8 * q + r);
        } else {
          acc1 |= bit << (8 * (q - 8) + r);
        }
      }
    }
  }
  *reinterpret_cast<ulonglong2*>(&planes[group][lane * GROUP]) =
      make_ulonglong2(acc0, acc1);
  __syncthreads();

  // thread t: elements 2t and 2t + 1 of the block, byte g of each mask
  // from plane g
  const int t = threadIdx.x;
  uint64_t m0 = 0ull;
  uint64_t m1 = 0ull;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(&planes[g][2 * t]);
    m0 |= (uint64_t)(v & 0xFFu) << (8 * g);
    m1 |= (uint64_t)(v >> 8) << (8 * g);
  }
  const long long e = (long long)blockIdx.x * PACK_ELEMS + 2 * t;
  const long long at = (long long)blockIdx.y * n + e;
  if (e + 1 < n && (at & 1) == 0) {
    *reinterpret_cast<ulonglong2*>(masks + at) = make_ulonglong2(m0, m1);
  } else {
    if (e < n) masks[at] = m0;
    if (e + 1 < n) masks[at + 1] = m1;
  }
}

// ---------------------------------------------------------------------------
// Stage 2: the adder on masks
// ---------------------------------------------------------------------------

// a replicated bit sharing of one element: v[party][slot] is the k-bit
// vector of that pair slot, bit j at bit j of the (lo, hi) mask
struct Bits {
  Ring v[3][2];
};

// one AND bank of one element: the zero-share mask of each party
struct Bank {
  Ring s[3];
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

// bank `a` of element i from the masks (n_ands, 3, words, n); a past the
// last bank loads nothing
template <bool WIDE>
__device__ __forceinline__ Bank load_bank(const uint64_t* __restrict__ masks,
                                          int a, long long n, long long i) {
  constexpr int K = WIDE ? 128 : 64;
  constexpr int WORDS = K / 64;
  Bank b;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (a < bank_count(K)) {
      const uint64_t* base = masks + (long long)((a * 3 + p) * WORDS) * n + i;
      b.s[p] = Ring{base[0], WIDE ? base[n] : 0ull};
    } else {
      b.s[p] = Ring{0ull, 0ull};
    }
  }
  return b;
}

// the banks in consumption order, each loaded two ANDs before its use
template <bool WIDE>
struct BankStream {
  const uint64_t* masks;
  long long n;
  long long i;
  int next;
  Bank ahead[2];

  __device__ __forceinline__ BankStream(const uint64_t* __restrict__ m,
                                        long long n_, long long i_)
      : masks(m), n(n_), i(i_), next(2) {
    ahead[0] = load_bank<WIDE>(masks, 0, n, i);
    ahead[1] = load_bank<WIDE>(masks, 1, n, i);
  }

  __device__ __forceinline__ Bank take() {
    const Bank b = ahead[0];
    ahead[0] = ahead[1];
    ahead[1] = load_bank<WIDE>(masks, next++, n, i);
    return b;
  }
};

// replicated AND over Z_2 with bank s as the XOR zero share:
// z_p = (x_p0 & (y_p0 ^ y_p1)) ^ (x_p1 & y_p0) ^ s_p ^ s_{p+1}, reshared
// into the pair layout (z_p, z_{p+1})
__device__ __forceinline__ Bits bits_and(const Bits& x, const Bits& y,
                                         const Bank& bank) {
  Ring z[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const Ring v = bxor(band(x.v[p][0], bxor(y.v[p][0], y.v[p][1])),
                        band(x.v[p][1], y.v[p][0]));
    z[p] = bxor(v, bxor(bank.s[p], bank.s[(p + 1) % 3]));
  }
  Bits r;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    r.v[p][0] = z[p];
    r.v[p][1] = z[(p + 1) % 3];
  }
  return r;
}

// the decomposition of element i: the result masks of each pair slot
template <bool WIDE>
__device__ __forceinline__ Bits decompose(const uint64_t* __restrict__ x_lo,
                                          const uint64_t* __restrict__ x_hi,
                                          const uint64_t* __restrict__ masks,
                                          long long n, long long i) {
  constexpr int K = WIDE ? 128 : 64;
  BankStream<WIDE> banks(masks, n, i);
  const Ring zero = ring_const<WIDE>(0ull, 0ull);
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
  const Bits c0 = bits_and(b[0], b[1], banks.take());
  const Bits carry = bits_xor(c0, bits_and(b01, b[2], banks.take()));
  const Bits y = bits_shl<WIDE>(carry, 1);

  // Kogge-Stone adder of sum + y: log2(k) rounds of two ANDs
  const Bits prop = bits_xor(sum, y);
  Bits g = bits_and(sum, y, banks.take());
  Bits p_run = prop;
#pragma unroll
  for (int round = 0; (1 << round) < K; ++round) {
    const int d = 1 << round;
    g = bits_xor(g, bits_and(p_run, bits_shl<WIDE>(g, d), banks.take()));
    if (2 * d < K) {
      p_run = bits_and(p_run, bits_shl<WIDE>(p_run, d), banks.take());
    }
  }
  return bits_xor(prop, bits_shl<WIDE>(g, 1));
}

// element t of the block's result masks in shared memory: one padding
// word after every 16 elements, so the 16-element reads of the unpack
// fall on distinct banks
__device__ __forceinline__ int slot_of(int t) { return t + (t >> 4); }
constexpr int SLOTS = ADD_THREADS + ADD_THREADS / GROUP;

// the full decomposition of the block's elements base .. base + 63,
// result masks r of this thread's element: the masks to shared memory,
// then each task (row, word, byte g, 16-element group) turns byte g of 16
// masks into bit rows 64 w + 8 g + 0..7 of those 16 elements, one
// 16-byte store per bit row
template <bool WIDE>
__device__ __forceinline__ void write_bits(const Bits& r,
                                           uint8_t* __restrict__ out,
                                           long long n, long long base,
                                           int vec) {
  constexpr int K = WIDE ? 128 : 64;
  constexpr int WORDS = K / 64;
  __shared__ uint64_t res[6][WORDS][SLOTS];
#pragma unroll
  for (int row = 0; row < 6; ++row) {
    const Ring w = r.v[row / 2][row % 2];
    res[row][0][slot_of(threadIdx.x)] = w.lo;
    if (WIDE) res[row][WORDS - 1][slot_of(threadIdx.x)] = w.hi;
  }
  __syncthreads();

  constexpr int EGROUPS = ADD_THREADS / GROUP;
  constexpr int TASKS = 6 * WORDS * 8 * EGROUPS;
  for (int task = threadIdx.x; task < TASKS; task += ADD_THREADS) {
    const int eg = task % EGROUPS;
    const int g = (task / EGROUPS) % 8;
    const int rw = task / (EGROUPS * 8);  // row * WORDS + word
    const int row = rw / WORDS;
    const int word = rw % WORDS;
    const long long e0 = base + eg * GROUP;
    if (e0 >= n) continue;
    uint64_t byte_lo = 0ull;  // byte q: byte g of element e0 + q's mask
    uint64_t byte_hi = 0ull;
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      const uint64_t m = res[row][word][slot_of(eg * GROUP + q)];
      const uint64_t byte = (m >> (8 * g)) & 0xFFull;
      if (q < 8) {
        byte_lo |= byte << (8 * q);
      } else {
        byte_hi |= byte << (8 * (q - 8));
      }
    }
    const long long bit0 = (long long)row * K + word * 64 + g * 8;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      uint8_t* dst = out + (bit0 + b) * n + e0;
      const uint64_t lo = (byte_lo >> b) & LOW_BITS;
      const uint64_t hi = (byte_hi >> b) & LOW_BITS;
      if (vec) {  // n % 16 == 0: the group is whole and aligned
        *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(lo, hi);
      } else {
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
          if (e0 + q < n) {
            dst[q] = static_cast<uint8_t>(
                ((q < 8 ? lo : hi) >> (8 * (q & 7))) & 1ull);
          }
        }
      }
    }
  }
}

template <bool WIDE, bool MSB_ONLY>
__global__ void __launch_bounds__(ADD_THREADS)
bits_adder_add(const uint64_t* __restrict__ x_lo,
               const uint64_t* __restrict__ x_hi,
               const uint64_t* __restrict__ masks,
               uint8_t* __restrict__ out, long long n, int vec) {
  const long long base = (long long)blockIdx.x * ADD_THREADS;
  const long long i = base + threadIdx.x;
  const bool live = i < n;
  Bits r = {};
  if (live) r = decompose<WIDE>(x_lo, x_hi, masks, n, i);
  if constexpr (MSB_ONLY) {
    if (live) {
#pragma unroll
      for (int row = 0; row < 6; ++row) {
        const Ring w = r.v[row / 2][row % 2];
        const uint64_t top = WIDE ? w.hi : w.lo;
        out[(long long)row * n + i] = static_cast<uint8_t>(top >> 63);
      }
    }
  } else {
    write_bits<WIDE>(r, out, n, base, vec);
  }
}

template <bool WIDE>
void launch(const void* x_lo, const void* x_hi, const void* banks,
            void* masks, void* out, long long n, int msb_only,
            cudaStream_t s) {
  constexpr int K = WIDE ? 128 : 64;
  const auto bk = static_cast<const uint8_t*>(banks);
  const auto mk = static_cast<uint64_t*>(masks);
  const int pack_vec =
      n % GROUP == 0 && reinterpret_cast<uintptr_t>(bk) % 16 == 0;
  const dim3 pack_grid(static_cast<unsigned>((n + PACK_ELEMS - 1) / PACK_ELEMS),
                       bank_count(K) * 3 * (K / 64));
  bits_adder_pack<<<pack_grid, PACK_THREADS, 0, s>>>(bk, mk, n, pack_vec);

  const auto lo = static_cast<const uint64_t*>(x_lo);
  const auto hi = WIDE ? static_cast<const uint64_t*>(x_hi) : nullptr;
  const auto o = static_cast<uint8_t*>(out);
  const int out_vec = n % GROUP == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const unsigned blocks =
      static_cast<unsigned>((n + ADD_THREADS - 1) / ADD_THREADS);
  if (msb_only) {
    bits_adder_add<WIDE, true><<<blocks, ADD_THREADS, 0, s>>>(
        lo, hi, mk, o, n, out_vec);
  } else {
    bits_adder_add<WIDE, false><<<blocks, ADD_THREADS, 0, s>>>(
        lo, hi, mk, o, n, out_vec);
  }
}

}  // namespace

// x: (lo, hi) words (3, 2, n), the hi pointer ignored (and may be null)
// when wide == 0; banks: uint8 (n_ands, 3, k, n) with n_ands from
// adder_bank_count; masks: scratch of n_ands * 3 * (k / 64) * n u64
// words, which the pack stage fills; out: uint8 (3, 2, k, n), or
// (3, 2, n) when msb_only.  Launches both stages on `stream`; returns
// cudaGetLastError().
extern "C" int moose_bits_adder(const void* x_lo, const void* x_hi,
                                const void* banks, void* masks, void* out,
                                long long n, int wide, int msb_only,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    launch<true>(x_lo, x_hi, banks, masks, out, n, msb_only, s);
  } else {
    launch<false>(x_lo, x_hi, banks, masks, out, n, msb_only, s);
  }
  return static_cast<int>(cudaGetLastError());
}
