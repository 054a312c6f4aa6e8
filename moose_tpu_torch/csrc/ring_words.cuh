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
