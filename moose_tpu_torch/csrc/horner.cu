// horner: the fused fixed-point Horner ladder of a secret polynomial.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py: horner
// (pallas_call body _horner_body).  For a replicated sharing x, read in
// place through its two pair slots' strides, and public coefficients
// c_0..c_steps (raw ring integers, highest degree first) it runs, per
// element,
//     acc = c_0;  for each step: acc = trunc_pr(acc * x) + c_{step+1}
// as spmd_math._horner_lax of the JAX package does: every step takes
// each party's cross terms v_p = acc0_p (x0_p + x1_p) + acc1_p x0_p,
// reshares them with the zero share s_p - s_{p+1} of that step's bank,
// runs the truncation tail of ring_words.cuh with that step's five draws,
// and adds the next coefficient at pair slots (0, 0) and (2, 1).  It
// writes the result's (3, 2, n) pair layout.  The truncation reveals
// the sum of the resharing, in which the zero shares cancel, and m_r
// cancels in the reveal too (ring_words.cuh): the kernel reads neither
// the banks nor m_r, and its result is word for word the protocol's.
//
// What bounds it on the card: at 2^20 elements, bytes.  Per element it
// reads x's two pair slots (6 words) and, per step, the 3.5 draw words
// that reach the result (r, m_rt, z0, m_rm's low word at the sigmoid's
// amount 62), and writes 6 words.  At the protocol's 1024 elements
// neither bytes nor operations: the ladder's dependent chain, 14 steps
// each of two 128-bit products, the exchange of the parties' v and the
// truncation's reveal, on a few hundred threads.
//
// What the design does about it:
//   - everything of a step that depends only on its draws (the
//     truncation's masks, trunc_masks of ring_words.cuh) is computed
//     first, for all steps and elements of a block at once by all its
//     256 threads, into shared memory: no step waits for another there,
//     and the loads' latency is paid about once;
//   - then the dependent ladder runs three lanes of a warp an element (10
//     elements a block, two lanes idle), lane p holding party p's
//     accumulators: a step is its own two products, the exchange of the
//     parties' v with __shfl_sync and trunc_finish (the masked reveal,
//     its top bits, one add and two selects);
//   - 1024 elements are 103 blocks, one an SM;
//   - the shifts by the truncation amount are resolved to their words
//     once a launch (trunc_cases), so a step runs without branches;
//   - the other variant, one thread an element with all three parties in
//     blocks of 128 and each step's loads issued a step ahead, runs fewer
//     instructions an element and serves large n, where the bytes bound
//     it; the wrapper picks by n (ring_kernels.horner_lanes).
// The coefficients ride in the kernel's argument block.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_words.cuh"

namespace {

constexpr int MAX_COEFFS = 64;
// the three-lane variant: elements of a block, three lanes each, and the
// block's threads; the one-thread variant's block
constexpr int BLOCK_ELEMS = 10;
constexpr int LANES_THREADS = 256;
constexpr int ONE_THREADS = 128;

struct HornerArgs {
  const uint64_t* x0_lo;  // party 0 of pair slot 0 of x
  const uint64_t* x0_hi;
  const uint64_t* x1_lo;  // party 0 of pair slot 1 of x
  const uint64_t* x1_hi;
  long long x0p;  // words between parties, each slot
  long long x1p;
  Walk<2> w;  // the slots' strides: operand 0 slot 0, operand 1 slot 1
  const uint64_t* td_lo;  // (steps, 5, n) truncation draws
  const uint64_t* td_hi;
  uint64_t* out_lo;  // (3, 2, n) pair layout
  uint64_t* out_hi;
  uint64_t c_lo[MAX_COEFFS];
  uint64_t c_hi[MAX_COEFFS];
  long long n;
  int steps;
  int f;
};

template <bool WIDE>
__device__ __forceinline__ Ring coeff(const HornerArgs& a, int j) {
  return ring_const<WIDE>(a.c_lo[j], a.c_hi[j]);
}

// A step's draws that reach the result: r, m_rt, m_rm (its high word
// only where trunc_mrm_hi) and z0, at rows 0, 2, 3 and 4 of the step's
// (5, n) block; m_r (row 1) cancels in the reveal
constexpr int DRAWS = 4;

template <bool WIDE, int CASES>
__device__ __forceinline__ void load_draws(const HornerArgs& a, int st,
                                           long long i, Ring (&d)[DRAWS]) {
  const long long at = st * 5LL * a.n + i;
  d[0] = ring_load<WIDE>(a.td_lo, a.td_hi, at);
  d[1] = ring_load<WIDE>(a.td_lo, a.td_hi, at + 2 * a.n);
  d[2].lo = a.td_lo[at + 3 * a.n];
  d[2].hi = trunc_mrm_hi<WIDE, CASES>(a.f) ? a.td_hi[at + 3 * a.n] : 0ull;
  d[3] = ring_load<WIDE>(a.td_lo, a.td_hi, at + 4 * a.n);
}

template <bool WIDE>
__device__ __forceinline__ Ring shfl_ring(Ring v, int lane) {
  Ring r;
  r.lo = __shfl_sync(0xffffffffu, v.lo, lane);
  r.hi = WIDE ? __shfl_sync(0xffffffffu, v.hi, lane) : 0ull;
  return r;
}

// The ring words a block keeps for one (step, element): the step's
// truncation masks (TruncMasks)
constexpr int MASK_WORDS = 6;

template <bool WIDE>
__device__ __forceinline__ void put(uint64_t* at, int stride, Ring v) {
  at[0] = v.lo;
  if (WIDE) at[stride] = v.hi;
}

template <bool WIDE>
__device__ __forceinline__ Ring get(const uint64_t* at, int stride) {
  Ring v;
  v.lo = at[0];
  v.hi = WIDE ? at[stride] : 0ull;
  return v;
}

// x's pair slots regrouped for the accumulator's consistent sharing:
// with acc0 = (A_0, A_1, A_2) and acc1 = (A_1, A_2, A_0) the revealed sum
// of the cross terms, sum_p acc0_p (x0_p + x1_p) + acc1_p x0_p, is
// sum_p A_p y_p with y_p = x0_p + x1_p + x0_{p-1}: three products a step
// where the protocol has six, and the same ring sum.
template <bool WIDE>
__device__ __forceinline__ Ring regrouped(const HornerArgs& a,
                                          const long long (&off)[2], int p) {
  const Ring x0 = ring_load<WIDE>(a.x0_lo, a.x0_hi, off[0] + p * a.x0p);
  const Ring x1 = ring_load<WIDE>(a.x1_lo, a.x1_hi, off[1] + p * a.x1p);
  const Ring xb = ring_load<WIDE>(a.x0_lo, a.x0_hi,
                                  off[0] + ((p + 2) % 3) * a.x0p);
  return ring_add<WIDE>(ring_add<WIDE>(x0, x1), xb);
}

// Three lanes an element, ten elements a block.  First every thread of
// the block takes (step, element) pairs and computes, from the step's
// draws alone, the truncation's masks into shared memory
// ([step][word][plane][element]): that work has no dependence between
// steps, so the whole block runs it at once and the loads' latency is
// paid about once.  Then one warp runs the ladder, lane p of an element
// holding party p's accumulator A_p: a step is one product A_p y_p, the
// exchange of the parties' products by __shfl_sync and trunc_finish,
// with the step's words read from shared memory off the chain.  A lane
// past the end (or one of the two idle lanes) works on element `base`
// and stores nothing, so every lane takes every __shfl_sync.
template <bool WIDE, int MODE, int CASES>
__global__ void __launch_bounds__(LANES_THREADS)
horner_lanes_kernel(const HornerArgs a) {
  extern __shared__ uint64_t stage[];
  constexpr int PLANES = WIDE ? 2 : 1;
  constexpr int WORD = PLANES * BLOCK_ELEMS;  // a ring word's stride
  constexpr int STEP = MASK_WORDS * WORD;
  const long long n = a.n;
  const long long base = (long long)blockIdx.x * BLOCK_ELEMS;
  for (int item = threadIdx.x; item < a.steps * BLOCK_ELEMS;
       item += blockDim.x) {
    const int st = item / BLOCK_ELEMS;
    const int el = item - st * BLOCK_ELEMS;
    const long long e = base + el < n ? base + el : base;
    Ring d[DRAWS];
    load_draws<WIDE, CASES>(a, st, e, d);
    const TruncMasks m =
        trunc_masks<WIDE, CASES>(d[0], d[1], d[2], d[3], a.f);
    uint64_t* at = stage + st * STEP + el;
    const Ring words[MASK_WORDS] = {m.k,         m.z0,    m.z1_add[0],
                                    m.z1_add[1], m.z2[0], m.z2[1]};
#pragma unroll
    for (int w = 0; w < MASK_WORDS; ++w)
      put<WIDE>(at + w * WORD, BLOCK_ELEMS, words[w]);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;  // no barrier follows

  const int lane = threadIdx.x;
  const int k = lane / 3;  // the block's element; BLOCK_ELEMS for idle lanes
  const int p = lane - 3 * k;  // party
  const bool idle = k >= BLOCK_ELEMS;
  const int kk = idle ? 0 : k;
  const int next = idle ? lane : lane + (p == 2 ? -2 : 1);  // party p + 1
  const int prev = idle ? lane : lane + (p == 0 ? 2 : -1);  // party p + 2
  const long long e = base + k;
  const bool live = !idle && e < n;
  long long off[2];
  walk_offsets<MODE, 2>(a.w, live ? e : base, off);
  const Ring y = regrouped<WIDE>(a, off, p);
  // the trivial sharing of c_0: A = (c_0, 0, 0)
  const Ring zero = ring_const<WIDE>(0ull, 0ull);
  Ring acc = p == 0 ? coeff<WIDE>(a, 0) : zero;
  Ring q0 = zero, q1 = zero, q2 = zero;
  for (int st = 0; st < a.steps; ++st) {
    const uint64_t* at = stage + st * STEP + kk;
    TruncMasks m;
    m.k = get<WIDE>(at, BLOCK_ELEMS);
    m.z0 = get<WIDE>(at + WORD, BLOCK_ELEMS);
    m.z1_add[0] = get<WIDE>(at + 2 * WORD, BLOCK_ELEMS);
    m.z1_add[1] = get<WIDE>(at + 3 * WORD, BLOCK_ELEMS);
    m.z2[0] = get<WIDE>(at + 4 * WORD, BLOCK_ELEMS);
    m.z2[1] = get<WIDE>(at + 5 * WORD, BLOCK_ELEMS);
    const Ring v = ring_mul<WIDE>(acc, y);
    // the revealed sum, added from this lane's party on: the same ring
    // sum in every lane
    const Ring vn = shfl_ring<WIDE>(v, next);
    const Ring vp = shfl_ring<WIDE>(v, prev);
    trunc_finish<WIDE, CASES>(m, ring_add<WIDE>(ring_add<WIDE>(v, vn), vp),
                              a.f, q0, q1, q2);
    q0 = ring_add<WIDE>(q0, coeff<WIDE>(a, st + 1));
    acc = p == 0 ? q0 : p == 1 ? q1 : q2;
  }
  if (live) {
    ring_store<WIDE>(a.out_lo, a.out_hi, 2 * p * n + e, acc);
    ring_store<WIDE>(a.out_lo, a.out_hi, (2 * p + 1) * n + e,
                     p == 0 ? q1 : p == 1 ? q2 : q0);
  }
}

// One thread an element, all three parties in its registers; a step's
// draws are loaded a step ahead.
template <bool WIDE, int MODE, int CASES>
__global__ void __launch_bounds__(ONE_THREADS)
horner_kernel(const HornerArgs a) {
  const long long n = a.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const Ring zero = ring_const<WIDE>(0ull, 0ull);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    long long off[2];
    walk_offsets<MODE, 2>(a.w, e, off);
    Ring x0[3], y[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      x0[p] = ring_load<WIDE>(a.x0_lo, a.x0_hi, off[0] + p * a.x0p);
      y[p] = ring_add<WIDE>(
          x0[p], ring_load<WIDE>(a.x1_lo, a.x1_hi, off[1] + p * a.x1p));
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) y[p] = ring_add<WIDE>(y[p], x0[(p + 2) % 3]);
    Ring acc[3] = {coeff<WIDE>(a, 0), zero, zero};
    Ring d[DRAWS];
    load_draws<WIDE, CASES>(a, 0, e, d);
    for (int st = 0; st < a.steps; ++st) {
      Ring nd[DRAWS] = {zero, zero, zero, zero};
      if (st + 1 < a.steps) load_draws<WIDE, CASES>(a, st + 1, e, nd);
      const TruncMasks m =
          trunc_masks<WIDE, CASES>(d[0], d[1], d[2], d[3], a.f);
      Ring v = ring_mul<WIDE>(acc[0], y[0]);
#pragma unroll
      for (int p = 1; p < 3; ++p)
        v = ring_add<WIDE>(v, ring_mul<WIDE>(acc[p], y[p]));
      trunc_finish<WIDE, CASES>(m, v, a.f, acc[0], acc[1], acc[2]);
      acc[0] = ring_add<WIDE>(acc[0], coeff<WIDE>(a, st + 1));
#pragma unroll
      for (int j = 0; j < DRAWS; ++j) d[j] = nd[j];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      ring_store<WIDE>(a.out_lo, a.out_hi, 2 * p * n + e, acc[p]);
      ring_store<WIDE>(a.out_lo, a.out_hi, (2 * p + 1) * n + e,
                       acc[(p + 1) % 3]);
    }
  }
}

template <bool WIDE, int MODE, int CASES>
int launch(const HornerArgs& a, int lanes, cudaStream_t s) {
  if (lanes == 3) {
    // a block of ten elements, its masks in dynamic shared memory
    const size_t bytes = static_cast<size_t>(a.steps) * MASK_WORDS *
                         (WIDE ? 2 : 1) * BLOCK_ELEMS * sizeof(uint64_t);
    auto kernel = horner_lanes_kernel<WIDE, MODE, CASES>;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long blocks = (a.n + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
    if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), LANES_THREADS, bytes, s>>>(a);
  } else {
    horner_kernel<WIDE, MODE, CASES>
        <<<grid_for(a.n, ONE_THREADS), ONE_THREADS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool WIDE, int MODE>
int launch_cases(const HornerArgs& a, int lanes, cudaStream_t s) {
  if constexpr (!WIDE) {
    return launch<WIDE, MODE, 0>(a, lanes, s);  // one case
  } else {
    switch (trunc_cases(128, a.f)) {
      case TRUNC_TOP_HIGH | TRUNC_UP_HIGH:
        return launch<WIDE, MODE, TRUNC_TOP_HIGH | TRUNC_UP_HIGH>(
            a, lanes, s);
      case TRUNC_TOP_HIGH:
        return launch<WIDE, MODE, TRUNC_TOP_HIGH>(a, lanes, s);
      case TRUNC_UP_HIGH:
        return launch<WIDE, MODE, TRUNC_UP_HIGH>(a, lanes, s);
      default:
        return launch<WIDE, MODE, 0>(a, lanes, s);
    }
  }
}

template <bool WIDE>
int launch_mode(const HornerArgs& a, int lanes, cudaStream_t s) {
  // x is read once an element: the 32-bit walk wherever offsets fit
  if (a.w.mode == WALK_WIDE) {
    return launch_cases<WIDE, WALK_WIDE>(a, lanes, s);
  }
  return launch_cases<WIDE, WALK_FAST>(a, lanes, s);
}

}  // namespace

// x0 / x1 point at party 0 of x's pair slots 0 and 1, x0p / x1p words
// between parties; element e of the n-element logical shape, whose `dims`
// collapsed axes (innermost last, at most 8) have the sizes `sizes`, is
// read at the word offsets sum_d c_d x0_strides[d] and sum_d c_d
// x1_strides[d] (0 on a broadcast axis).  tdraws: contiguous (steps, 5,
// n), each step's r, m_r, m_rt, m_rm, z0 (m_r is not read); out:
// contiguous (3, 2, n).  coeff_lo / coeff_hi are host arrays of steps + 1
// words (0 < steps < MAX_COEFFS).  lanes (1 or 3) chooses the variant:
// three lanes an element in blocks of 256 that compute the masks of
// their ten elements, then run the ladder in one warp; or one thread an
// element in blocks of 128.  The *_hi pointers are ignored (and may be
// null) when wide == 0.  Requires 0 <= f <= width - 2.  Launches
// on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int moose_horner(
    const void* x0_lo, const void* x0_hi, long long x0p, const void* x1_lo,
    const void* x1_hi, long long x1p, int dims, const long long* sizes,
    const long long* x0_strides, const long long* x1_strides,
    const void* td_lo, const void* td_hi, void* out_lo, void* out_hi,
    const uint64_t* coeff_lo, const uint64_t* coeff_hi, int steps, int f,
    long long n, int lanes, int wide, void* stream) {
  const int width = wide ? 128 : 64;
  if (steps < 1 || steps >= MAX_COEFFS || f < 0 || f > width - 2 ||
      (lanes != 1 && lanes != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HornerArgs a = {};
  const long long* const strides[2] = {x0_strides, x1_strides};
  if (!walk_init<2>(a.w, n, dims, sizes, strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  a.x0_lo = u(x0_lo);
  a.x0_hi = wide ? u(x0_hi) : nullptr;
  a.x1_lo = u(x1_lo);
  a.x1_hi = wide ? u(x1_hi) : nullptr;
  a.x0p = x0p;
  a.x1p = x1p;
  a.td_lo = u(td_lo);
  a.td_hi = wide ? u(td_hi) : nullptr;
  a.out_lo = static_cast<uint64_t*>(out_lo);
  a.out_hi = wide ? static_cast<uint64_t*>(out_hi) : nullptr;
  for (int j = 0; j < MAX_COEFFS; ++j) {
    a.c_lo[j] = j <= steps ? coeff_lo[j] : 0ull;
    a.c_hi[j] = wide && j <= steps ? coeff_hi[j] : 0ull;
  }
  a.n = n;
  a.steps = steps;
  a.f = f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_mode<true>(a, lanes, s)
              : launch_mode<false>(a, lanes, s);
}
