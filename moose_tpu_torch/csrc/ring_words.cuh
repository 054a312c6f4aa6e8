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
// compresses the additive result into the replicated stack (z0, z1, y1).
// Shared by trunc_combine.cu and horner.cu.
template <bool WIDE>
__device__ __forceinline__ void trunc_tail(Ring a0, Ring a1, Ring r, Ring mr,
                                           Ring mrt, Ring mrm, Ring z0,
                                           int amount, Ring& out_z0,
                                           Ring& out_z1, Ring& out_y1) {
  constexpr int W = WIDE ? 128 : 64;
  constexpr int K = W - 1;

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
  out_z0 = z0;
  out_z1 = ring_sub<WIDE>(y0, z0);
  out_y1 = y1;
}
