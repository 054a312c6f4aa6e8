// Ring words for the moose_tpu_torch CUDA kernels.
//
// A ring element of Z_{2^64} is one u64 word; of Z_{2^128} a (lo, hi)
// pair of u64 words, exactly the two int64 tensors the Python side
// holds.  Every operation is templated on WIDE (ring128) so that ring64
// drops the high word at compile time.
//
// Shifts: C++ leaves a shift of a 64-bit word by 64 or more undefined,
// and the truncation kernel shifts by amounts that reach 0, >= 64 and
// >= 128 (at fixed(24,40), k - amount = 87).  Every case is written out.
//
// Also here: the truncation tail that K2 (trunc_combine.cu) and K6
// (horner.cu) share, and the strided walk with which K2, K3 and K6 read
// operands through their own strides.

#pragma once

#include <cstdint>

struct Ring {
  uint64_t lo;
  uint64_t hi;
};

template <bool WIDE>
__device__ __forceinline__ Ring ring_load(const uint64_t* __restrict__ lo,
                                          const uint64_t* __restrict__ hi,
                                          long long i) {
  Ring r;
  r.lo = lo[i];
  r.hi = WIDE ? hi[i] : 0ull;
  return r;
}

template <bool WIDE>
__device__ __forceinline__ void ring_store(uint64_t* __restrict__ lo,
                                           uint64_t* __restrict__ hi,
                                           long long i, Ring v) {
  lo[i] = v.lo;
  if (WIDE) hi[i] = v.hi;
}

template <bool WIDE>
__device__ __forceinline__ Ring ring_const(uint64_t lo, uint64_t hi) {
  Ring r;
  r.lo = lo;
  r.hi = WIDE ? hi : 0ull;
  return r;
}

template <bool WIDE>
__device__ __forceinline__ Ring ring_add(Ring a, Ring b) {
  Ring r;
  r.lo = a.lo + b.lo;
  r.hi = WIDE ? a.hi + b.hi + (r.lo < a.lo ? 1ull : 0ull) : 0ull;
  return r;
}

template <bool WIDE>
__device__ __forceinline__ Ring ring_sub(Ring a, Ring b) {
  Ring r;
  r.lo = a.lo - b.lo;
  r.hi = WIDE ? a.hi - b.hi - (a.lo < b.lo ? 1ull : 0ull) : 0ull;
  return r;
}

template <bool WIDE>
__device__ __forceinline__ Ring ring_neg(Ring a) {
  return ring_sub<WIDE>(ring_const<WIDE>(0ull, 0ull), a);
}

// logical left shift by s >= 0
template <bool WIDE>
__device__ __forceinline__ Ring ring_shl(Ring a, int s) {
  Ring r;
  if (!WIDE) {
    r.lo = s >= 64 ? 0ull : (a.lo << s);
    r.hi = 0ull;
    return r;
  }
  if (s == 0) return a;
  if (s >= 128) {
    r.lo = 0ull;
    r.hi = 0ull;
  } else if (s >= 64) {
    r.lo = 0ull;
    r.hi = a.lo << (s - 64);
  } else {
    r.lo = a.lo << s;
    r.hi = (a.hi << s) | (a.lo >> (64 - s));
  }
  return r;
}

// logical right shift by s >= 0
template <bool WIDE>
__device__ __forceinline__ Ring ring_shr(Ring a, int s) {
  Ring r;
  if (!WIDE) {
    r.lo = s >= 64 ? 0ull : (a.lo >> s);
    r.hi = 0ull;
    return r;
  }
  if (s == 0) return a;
  if (s >= 128) {
    r.lo = 0ull;
    r.hi = 0ull;
  } else if (s >= 64) {
    r.lo = a.hi >> (s - 64);
    r.hi = 0ull;
  } else {
    r.lo = (a.lo >> s) | (a.hi << (64 - s));
    r.hi = a.hi >> s;
  }
  return r;
}

// acc += a * b  (mod 2^64 or 2^128).  The 128-bit product keeps
// lo*lo in full (__umul64hi for its high word) and the two cross
// products lo*hi + hi*lo mod 2^64 in the high word.
template <bool WIDE>
__device__ __forceinline__ void ring_mac(uint64_t& acc_lo, uint64_t& acc_hi,
                                         uint64_t a_lo, uint64_t a_hi,
                                         uint64_t b_lo, uint64_t b_hi) {
  const uint64_t p_lo = a_lo * b_lo;
  if (WIDE) {
    const uint64_t p_hi = __umul64hi(a_lo, b_lo) + a_lo * b_hi + a_hi * b_lo;
    acc_lo += p_lo;
    acc_hi += p_hi + (acc_lo < p_lo ? 1ull : 0ull);
  } else {
    acc_lo += p_lo;
  }
}

// a * b  (mod 2^64 or 2^128), the product of ring_mac
template <bool WIDE>
__device__ __forceinline__ Ring ring_mul(Ring a, Ring b) {
  Ring r;
  r.lo = a.lo * b.lo;
  r.hi = WIDE ? __umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo : 0ull;
  return r;
}

// The elementwise tail of probabilistic truncation (spmd._trunc_combine_lax
// of the JAX package).  From the 2-party additive sharing (a0, a1) of x
// and the five values the caller drew before it (r, m_r, m_rt, m_rm, z0)
// it masks x with r, reveals c = x + 2^(k-1) + r, corrects the MSB
// overflow, shifts down by `amount` (0 <= amount <= width - 2) and
// compresses the additive result into the replicated stack (z0, z1, z2).
//
// What reaches the result: the protocol's masked shares
// m0 = a0 + (2^(k-1) + m_r) and m1 = a1 + (r - m_r) add to
// c = (a0 + a1) + 2^(k-1) + r, so m_r cancels and only the sum x = a0 + a1
// matters; the kernels read neither m_r nor the parts of x's sharing
// that cancel in that sum (a resharing's zero shares).  Where
// k - amount >= 64 the overflow term is shifted up by 64 or more, so
// m_rm's high word does not reach the result either (trunc_mrm_hi).
// Every operation is exact mod 2^w, so the result is word for word the
// protocol's (trunc_combine_plain).
//
// It runs in two parts.  trunc_masks takes only the draws: c's msb is
// public 0/1, so every term but c's top bits is fixed per msb before x
// is known.  trunc_finish then takes x: c, its top bits and msb, one add
// and two selects.  Horner's ladder computes every step's masks before
// it runs the steps.
//
// The amount-dependent shifts are (x << 1) >> (amount + 1) and
// x << (k - amount), both by 1 to w - 1.  CASES resolves which word each
// lands in once for a launch (trunc_cases), so a kernel that runs many
// truncations by one amount shifts without branches; TRUNC_ANY decides
// per shift.
constexpr int TRUNC_ANY = -1;
constexpr int TRUNC_TOP_HIGH = 1;  // amount + 1 >= 64
constexpr int TRUNC_UP_HIGH = 2;   // k - amount >= 64

inline int trunc_cases(int width, int amount) {
  if (width == 64) return 0;
  return (amount + 1 >= 64 ? TRUNC_TOP_HIGH : 0) |
         (127 - amount >= 64 ? TRUNC_UP_HIGH : 0);
}

// (x << 1) >> (amount + 1): the bits [amount, k) of x
template <bool WIDE, int CASES>
__device__ __forceinline__ Ring trunc_top(Ring x, int amount) {
  const Ring t = ring_shl<WIDE>(x, 1);
  const int a = amount + 1;
  if (CASES == TRUNC_ANY) return ring_shr<WIDE>(t, a);
  Ring r;
  if (!WIDE) {
    r.lo = t.lo >> a;
    r.hi = 0ull;
  } else if (CASES & TRUNC_TOP_HIGH) {
    r.lo = t.hi >> (a - 64);
    r.hi = 0ull;
  } else {
    r.lo = (t.lo >> a) | (t.hi << (64 - a));
    r.hi = t.hi >> a;
  }
  return r;
}

// x << (k - amount)
template <bool WIDE, int CASES>
__device__ __forceinline__ Ring trunc_up(Ring x, int amount) {
  const int s = (WIDE ? 127 : 63) - amount;
  if (CASES == TRUNC_ANY) return ring_shl<WIDE>(x, s);
  Ring r;
  if (!WIDE) {
    r.lo = x.lo << s;
    r.hi = 0ull;
  } else if (CASES & TRUNC_UP_HIGH) {
    r.lo = 0ull;
    r.hi = x.lo << (s - 64);
  } else {
    r.lo = x.lo << s;
    r.hi = (x.hi << s) | (x.lo >> (64 - s));
  }
  return r;
}

// Whether m_rm's high word reaches the result: only where the overflow
// term's shift k - amount is below 64 (ring128, amount >= 64)
template <bool WIDE, int CASES = TRUNC_ANY>
__device__ __forceinline__ bool trunc_mrm_hi(int amount) {
  if (!WIDE) return false;
  if (CASES == TRUNC_ANY) return 127 - amount < 64;
  return !(CASES & TRUNC_UP_HIGH);
}

struct TruncMasks {
  Ring k;          // 2^(k-1) + r: c = x + k
  Ring z0;         // the drawn share z_0
  Ring z1_add[2];  // z_1 = c_top + z1_add[c_msb]
  Ring z2[2];      // z_2 = z2[c_msb]
};

template <bool WIDE, int CASES = TRUNC_ANY>
__device__ __forceinline__ TruncMasks trunc_masks(Ring r, Ring mrt, Ring mrm,
                                                  Ring z0, int amount) {
  constexpr int W = WIDE ? 128 : 64;
  constexpr int K = W - 1;
  const Ring one = ring_const<WIDE>(1ull, 0ull);
  const Ring up = ring_shl<WIDE>(one, K - 1);
  const Ring down = ring_shl<WIDE>(one, K - amount - 1);
  // the mask's top and msb parts, additively shared against m_rt, m_rm
  const Ring r_msb = ring_shr<WIDE>(r, W - 1);
  const Ring rt1 = ring_sub<WIDE>(trunc_top<WIDE, CASES>(r, amount), mrt);
  const Ring rm1 = ring_sub<WIDE>(r_msb, mrm);
  // overflow = r_msb XOR c_msb, additively (rm + c_msb - 2 rm c_msb on
  // the first share, rm1 - 2 rm1 c_msb on the second), moved up to bit
  // k - amount: for c_msb 0 and 1
  TruncMasks m;
  m.k = ring_add<WIDE>(up, r);
  m.z0 = z0;
  const Ring of0[2] = {
      trunc_up<WIDE, CASES>(mrm, amount),
      trunc_up<WIDE, CASES>(ring_sub<WIDE>(one, mrm), amount)};
  const Ring of1[2] = {trunc_up<WIDE, CASES>(rm1, amount),
                       trunc_up<WIDE, CASES>(ring_neg<WIDE>(rm1), amount)};
  // y0 = (c_top - m_rt) + of0 - 2^(k - amount - 1), z1 = y0 - z0;
  // z2 = y1 = of1 - rt1
  const Ring fixed = ring_add<WIDE>(ring_add<WIDE>(mrt, down), z0);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    m.z1_add[b] = ring_sub<WIDE>(of0[b], fixed);
    m.z2[b] = ring_sub<WIDE>(of1[b], rt1);
  }
  return m;
}

// x: the sum a0 + a1 of the operand's additive sharing
template <bool WIDE, int CASES = TRUNC_ANY>
__device__ __forceinline__ void trunc_finish(const TruncMasks& m, Ring x,
                                             int amount, Ring& out_z0,
                                             Ring& out_z1, Ring& out_z2) {
  constexpr int W = WIDE ? 128 : 64;
  const Ring c = ring_add<WIDE>(x, m.k);
  const Ring ctop = trunc_top<WIDE, CASES>(c, amount);
  const bool msb = ring_shr<WIDE>(c, W - 1).lo != 0ull;
  out_z0 = m.z0;
  out_z1 = ring_add<WIDE>(ctop, msb ? m.z1_add[1] : m.z1_add[0]);
  out_z2 = msb ? m.z2[1] : m.z2[0];
}

// ---------------------------------------------------------------------------
// Strided walks.  A kernel reads an operand in place through its own
// strides: the host collapses the logical shape (size-1 axes dropped,
// neighbours that step alike in every operand merged, innermost last) and
// gives each operand's word stride per axis, 0 on a broadcast axis
// (ring_kernels.walk_dims).  walk_init picks the addressing: contiguous,
// 32-bit magic-number division where every offset fits, else 64-bit
// division.
// ---------------------------------------------------------------------------

constexpr int WALK_MAX_DIMS = 8;

enum WalkMode { WALK_CONTIG = 0, WALK_FAST = 1, WALK_WIDE = 2 };

template <int OPS>
struct Walk {
  int dims;
  int mode;
  long long size[WALK_MAX_DIMS];
  long long stride[OPS][WALK_MAX_DIMS];
  // e / size[d] = (umulhi(e, magic[d]) + e) >> shift[d] for e < 2^31
  unsigned magic[WALK_MAX_DIMS];
  int shift[WALK_MAX_DIMS];
};

// Host side: fill `w` for n elements over `dims` axes of `sizes`,
// operand j stepping strides[j][d] words along axis d.  Returns false
// for arguments the kernels do not take.
template <int OPS>
inline bool walk_init(Walk<OPS>& w, long long n, int dims,
                      const long long* sizes,
                      const long long* const (&strides)[OPS]) {
  if (n <= 0 || dims < 0 || dims > WALK_MAX_DIMS) return false;
  w = Walk<OPS>{};
  w.dims = dims;
  long long last[OPS] = {};  // each operand's largest word offset
  bool contig = dims == 1;
  for (int d = 0; d < dims; ++d) {
    if (sizes[d] < 1) return false;
    w.size[d] = sizes[d];
    for (int j = 0; j < OPS; ++j) {
      if (strides[j][d] < 0) return false;
      w.stride[j][d] = strides[j][d];
      last[j] += (sizes[d] - 1) * strides[j][d];
      contig = contig && strides[j][d] == 1;
    }
  }
  bool fits = n < (1ll << 31);
  for (int j = 0; j < OPS; ++j) fits = fits && last[j] < (1ll << 31);
  w.mode = contig ? WALK_CONTIG : fits ? WALK_FAST : WALK_WIDE;
  // the magic numbers wherever offsets fit: a kernel may walk a
  // contiguous operand the 32-bit way too
  if (fits) {
    for (int d = 0; d < dims; ++d) {
      // the round-up divider: shift = ceil(log2 size), magic =
      // 2^32 (2^shift - size) / size + 1, exact for dividends below 2^31
      int shift = 0;
      while ((1ll << shift) < w.size[d]) ++shift;
      w.shift[d] = shift;
      w.magic[d] = static_cast<unsigned>(
          ((1ull << 32) * ((1ull << shift) - w.size[d])) / w.size[d] + 1);
    }
  }
  return true;
}

// Each operand's word offset of logical element e; the loops are
// unrolled over WALK_MAX_DIMS so that every index is a constant
template <int MODE, int OPS>
__device__ __forceinline__ void walk_offsets(const Walk<OPS>& w, long long e,
                                             long long (&off)[OPS]) {
  if (MODE == WALK_CONTIG) {
#pragma unroll
    for (int j = 0; j < OPS; ++j) off[j] = e;
  } else if (MODE == WALK_FAST) {
    unsigned u = static_cast<unsigned>(e);
    unsigned o[OPS] = {};
#pragma unroll
    for (int d = WALK_MAX_DIMS - 1; d >= 0; --d) {
      if (d >= w.dims) continue;
      const unsigned q = (__umulhi(u, w.magic[d]) + u) >> w.shift[d];
      const unsigned c = u - q * static_cast<unsigned>(w.size[d]);
#pragma unroll
      for (int j = 0; j < OPS; ++j)
        o[j] += c * static_cast<unsigned>(w.stride[j][d]);
      u = q;
    }
#pragma unroll
    for (int j = 0; j < OPS; ++j) off[j] = o[j];
  } else {
#pragma unroll
    for (int j = 0; j < OPS; ++j) off[j] = 0;
#pragma unroll
    for (int d = WALK_MAX_DIMS - 1; d >= 0; --d) {
      if (d >= w.dims) continue;
      const long long q = e / w.size[d];
      const long long c = e - q * w.size[d];
#pragma unroll
      for (int j = 0; j < OPS; ++j) off[j] += c * w.stride[j][d];
      e = q;
    }
  }
}

// Blocks of `threads` for a grid-stride loop over n items: at most 32
// a streaming multiprocessor of the H100's 132
inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}
