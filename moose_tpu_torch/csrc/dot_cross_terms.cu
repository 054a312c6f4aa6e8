// dot_cross_terms: party-batched cross terms of a secure matmul, as an
// exact 8-bit-limb product on Hopper's int8 tensor cores.
//
// Replaces the TPU kernel moose_tpu/native/ring128_kernels.py:
// dot_cross_terms (pallas_call body _dot_body, tiling _dot_tile_plan).
// For each party p it computes, mod 2^w (w = 64 or 128),
//     v_p = x0_p @ ysum_p + x1_p @ y0_p,     x: (P, m, k), y: (P, k, n)
// with the ring words as (lo, hi) u64 pairs.  As the TPU kernel does, it
// splits words into 8-bit limbs and runs the limb products on the matrix
// unit with exact accumulation.
//
// The arithmetic.  The two products of a party are one product of
// depth K' = 2k: [x0 | x1] (m x K') @ [ysum ; y0] (K' x n).  In the
// product-only mode (terms = 1: a plain ring product x0_p @ ysum_p, as
// a host ring Dot needs) K' = k, and x1 and y0 are never read.  A word
// is L = w/8 unsigned limbs; diagonal d of the output is
// S_d = sum_{i+j=d} A_i B_j and the result sum_d S_d 2^(8d) mod 2^w, so
// only the pairs with i + j < L count: 136 at ring128, 36 at ring64.
// The limb products run as wgmma m64nNk32 .s32.u8.u8 (unsigned operands
// need no centering), accumulating mod 2^32.  S_d is needed only mod
// 2^(w-8d), so diagonals d >= L-4 never need more than 32 bits; for
// d <= L-5 the true sum stays below 2^32 while
// K' <= SEG_DEPTH = (2^32-1) / ((L-4) * 255^2), rounded down to a whole
// chunk (5504 at ring128, 16512 at ring64).  A deeper contraction is
// cut into segments of that depth inside the kernel and each segment's
// sums are folded into the w-bit result before the next.
//
// Two device kernels per call:
//  1. dot_cross_terms_split writes the u8 limb planes, K-major, into
//     scratch the wrapper allocates: A8 [P][m/64][K'/32][L][64 x 32] and
//     B8 [P][n/BN][K'/32][L][BN x 32], each 64 x 32 (BN x 32) plane tile
//     in wgmma's no-swizzle canonical layout (8-row x 16-byte core
//     matrices: 16 bytes per row, the two K halves 128 B apart, 8-row
//     groups 256 B apart), zero-padded in m, n and K'.  One block's
//     K-chunk of every plane is then one contiguous run of bytes.
//  2. dot_cross_terms_gemm: a block owns a 64 x BN output tile of one
//     party (BN = 32 at ring128, 64 at ring64).  Its 256 threads stream
//     the K-chunks (all L planes of A and B, 48 KB at ring128) through a
//     4-stage cp.async ring, and its two warpgroups each run the limb
//     pairs of their own diagonals on every staged chunk: warpgroup g
//     holds diagonals g + 2q and L-1-g-2q (q < L/4), L+1 pairs per q, so
//     the pairs split evenly (68 per warpgroup at ring128, 18 at ring64)
//     and each thread keeps 128 s32 accumulators.  Each warpgroup runs its
//     own compile-time specialisation, so its wgmmas are straight-line code
//     on fixed registers, and one chunk's batch stays in flight while the
//     next is issued.  The epilogue folds each warpgroup's diagonals into
//     w-bit partials in shared memory, sums the two and writes out_lo /
//     out_hi.
//
// What bounds it on the card: int8 tensor-core operations (the limb
// pairs of both contractions, 2 * pairs * m * k * n per party) against
// 1,979 TOP/s; the words read once and written once are far fewer.  The
// design keeps every limb plane of a chunk in shared memory for all the
// pairs that use it, so device memory and L2 carry each limb tile once
// per output tile; what limits it is the shared memory the tensor cores
// read (a m64n32k32 reads 3 KB for 64K multiply-adds, 1.5x what 128 B
// per clock feeds at the int8 rate).  The register file sets the tile:
// L accumulators per output word, so 64 x 32 words at ring128.  Four
// warpgroups of 64 accumulators each cap a thread at 128 registers,
// which spilled and made the compiler insert warpgroup arrives; A
// fragments held in registers (wgmma's register-A form) ran slower.
// The whole 1000^3 ring128 call stages 198 MB of limb planes.  The TPU
// kernel's f32 dots, 256-term chunks and host-side k-segmentation worked
// around the TPU's float MXU and VMEM and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output rows per block (one wgmma M)
constexpr int BK = 32;       // K' bytes per chunk (one wgmma K)
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int NWG = 2;       // warpgroups, each running its own diagonals
constexpr int THREADS = 128 * NWG;
// one chunk's wgmma batch stays in flight while the next is issued, so a
// buffer is refilled two chunks after it was read
constexpr int AHEAD = STAGES - 2;  // chunks staged ahead
constexpr int SPLIT_THREADS = 128;
constexpr long long LIMB_MAX_SQ = 255ll * 255ll;

template <int L>
struct Geometry {
  static constexpr int BN = L == 16 ? 32 : 64;
  static constexpr int A_PLANE = BM * BK;
  static constexpr int B_PLANE = BN * BK;
  static constexpr int A_STAGE = L * A_PLANE;
  static constexpr int B_STAGE = L * B_PLANE;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int NACC = L / NWG;    // diagonals per warpgroup
  static constexpr int FRAG = BN / 2;     // s32 values per thread per diagonal
  // chunks per segment: diagonals d <= L-5 stay exact below 2^32
  static constexpr int SEG_CHUNKS =
      static_cast<int>(0xFFFFFFFFull / ((L - 4) * LIMB_MAX_SQ) / BK);
  // a warpgroup's w-bit partials of the tile, one slot per warpgroup
  static constexpr int SLOT = BM * BN * (L == 16 ? 16 : 8);
  static_assert(NWG * SLOT <= SMEM, "partials must fit the stage ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// no-swizzle K-major descriptor: leading byte offset = the K-half stride
// (128 B), stride byte offset = the 8-row group stride (256 B)
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// diagonal of accumulator s of warpgroup g
template <int L>
__host__ __device__ constexpr int diagonal(int g, int s) {
  return (s & 1) ? L - 1 - g - NWG * (s >> 1) : g + NWG * (s >> 1);
}

// every limb pair of warpgroup WG's diagonals on one staged chunk, as
// straight-line code (a loop bound that differs between warpgroups would
// make the compiler serialise the wgmmas)
template <int L, int WG>
__device__ __forceinline__ void chunk_pairs(
    uint32_t (&acc)[Geometry<L>::NACC][Geometry<L>::FRAG], uint32_t sa,
    uint32_t sb) {
  using G = Geometry<L>;
#pragma unroll
  for (int s = 0; s < G::NACC; ++s) {
    const int d = diagonal<L>(WG, s);
#pragma unroll
    for (int i = 0; i <= d; ++i)
      wgmma_u8(acc[s], desc(sa + i * G::A_PLANE),
               desc(sb + (d - i) * G::B_PLANE));
  }
}

// (lo, hi) += v << sh mod 2^128 (sh a multiple of 8 below 128)
__device__ __forceinline__ void add_shifted(uint64_t& lo, uint64_t& hi,
                                            uint32_t v, int sh) {
  const uint64_t w = v;
  if (sh < 64) {
    const uint64_t a = w << sh;
    const uint64_t b = sh > 32 ? w >> (64 - sh) : 0ull;
    lo += a;
    hi += b + (lo < a ? 1ull : 0ull);
  } else {
    hi += w << (sh - 64);
  }
}

// ---------------------------------------------------------------------------
// stage 1: limb planes
// ---------------------------------------------------------------------------

// One thread: 16 consecutive K' bytes of one row of one operand, every
// plane.  Items run (h, r8, rg) fastest, so a warp writes 512 contiguous
// bytes of each plane.  A rows read along x; B "rows" are columns of y.
template <int L>
__global__ void __launch_bounds__(SPLIT_THREADS)
dot_cross_terms_split(const uint64_t* __restrict__ x0_lo,
                      const uint64_t* __restrict__ x0_hi,
                      const uint64_t* __restrict__ x1_lo,
                      const uint64_t* __restrict__ x1_hi,
                      const uint64_t* __restrict__ y0_lo,
                      const uint64_t* __restrict__ y0_hi,
                      const uint64_t* __restrict__ ys_lo,
                      const uint64_t* __restrict__ ys_hi,
                      uint8_t* __restrict__ a8, uint8_t* __restrict__ b8,
                      int m, int k, int depth, int n, int mt, int nt,
                      int kc, long long items_a, long long items) {
  using G = Geometry<L>;
  const long long t = static_cast<long long>(blockIdx.x) * SPLIT_THREADS +
                      threadIdx.x;
  if (t >= items) return;
  const bool is_a = t < items_a;
  const long long u = is_a ? t : t - items_a;
  const int h = static_cast<int>(u & 1);
  const int r8 = static_cast<int>((u >> 1) & 7);
  long long rest = u >> 4;
  const int groups = is_a ? BM / 8 : G::BN / 8;
  const int rg = static_cast<int>(rest % groups);
  rest /= groups;
  const int kcc = static_cast<int>(rest % kc);
  rest /= kc;
  const int tiles = is_a ? mt : nt;
  const int tile = static_cast<int>(rest % tiles);
  const int p = static_cast<int>(rest / tiles);
  const int tile_rows = is_a ? BM : G::BN;
  const int row = tile * tile_rows + rg * 8 + r8;
  const int kk0 = kcc * BK + h * 16;

  uint64_t lo[16], hi[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int kk = kk0 + b;
    const bool first = kk < k;
    const int kx = first ? kk : kk - k;
    uint64_t wl = 0ull, wh = 0ull;
    if (is_a) {
      if (row < m && kk < depth) {
        const long long g = (static_cast<long long>(p) * m + row) * k + kx;
        wl = first ? x0_lo[g] : x1_lo[g];
        if (L == 16) wh = first ? x0_hi[g] : x1_hi[g];
      }
    } else {
      if (row < n && kk < depth) {
        const long long g = (static_cast<long long>(p) * k + kx) * n + row;
        wl = first ? ys_lo[g] : y0_lo[g];
        if (L == 16) wh = first ? ys_hi[g] : y0_hi[g];
      }
    }
    lo[b] = wl;
    hi[b] = wh;
  }

  const long long plane = is_a ? G::A_PLANE : G::B_PLANE;
  uint8_t* dst = (is_a ? a8 : b8) +
                 ((static_cast<long long>(p) * tiles + tile) * kc + kcc) *
                     L * plane +
                 rg * 256 + h * 128 + r8 * 16;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const uint64_t w = l < 8 ? lo[b] : hi[b];
      const uint32_t byte = static_cast<uint32_t>(w >> (8 * (l % 8))) & 0xFFu;
      v[b / 4] |= byte << (8 * (b % 4));
    }
    *reinterpret_cast<uint4*>(dst + l * plane) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// stage 2: the limb GEMM
// ---------------------------------------------------------------------------

// one block barrier for all THREADS (256) threads; the warpgroups reach it
// from their own code paths
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// wgmma fence, commit and wait around them
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// The body of warpgroup WG: every thread stages chunks; WG's own limb
// pairs run on them; WG folds its diagonals into its partial slot.  Each
// warpgroup runs its own specialisation, so its wgmma sequence is
// straight-line code with compile-time accumulators and shifts.
template <int L, int WG>
__device__ __forceinline__ void gemm_body(const uint8_t* __restrict__ a_src,
                                          const uint8_t* __restrict__ b_src,
                                          uint64_t* __restrict__ out_lo,
                                          uint64_t* __restrict__ out_hi,
                                          uint8_t* smem, int m, int n, int kc,
                                          int p, int mtile, int ntile) {
  using G = Geometry<L>;
  const int tid = threadIdx.x;
  const int lane = tid & 127;
  const uint32_t sbase = smem_u32(smem);

  auto load = [&](int chunk, int buf) {
    const uint8_t* as = a_src + static_cast<long long>(chunk) * G::A_STAGE;
    const uint8_t* bs = b_src + static_cast<long long>(chunk) * G::B_STAGE;
    const uint32_t sa = sbase + buf * G::STAGE;
    const uint32_t sb = sa + G::A_STAGE;
#pragma unroll
    for (int i = tid; i < G::A_STAGE / 16; i += THREADS)
      cp_async16(sa + i * 16, as + i * 16);
#pragma unroll
    for (int i = tid; i < G::B_STAGE / 16; i += THREADS)
      cp_async16(sb + i * 16, bs + i * 16);
  };

  const int segments = kc == 0 ? 1 : (kc + G::SEG_CHUNKS - 1) / G::SEG_CHUNKS;
  for (int seg = 0; seg < segments; ++seg) {
    const int c0 = seg * G::SEG_CHUNKS;
    const int nch = min(G::SEG_CHUNKS, kc - c0);
    uint32_t acc[G::NACC][G::FRAG];
#pragma unroll
    for (int s = 0; s < G::NACC; ++s) {
#pragma unroll
      for (int v = 0; v < G::FRAG; ++v) acc[s][v] = 0u;
      fence_operands(acc[s]);
    }

#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
      if (s < nch) load(c0 + s, s);
      cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<AHEAD - 1>();
      fence_proxy_async();
      block_sync();
      // the buffer of chunk c-2, which every warpgroup has finished: each
      // waited for its batch c-2 before this barrier
      const int ahead = c + AHEAD;
      if (ahead < nch) load(c0 + ahead, ahead % STAGES);
      cp_async_commit();

      const uint32_t sa = sbase + (c % STAGES) * G::STAGE;
#pragma unroll
      for (int s = 0; s < G::NACC; ++s) fence_operands(acc[s]);
      wgmma_fence();
      chunk_pairs<L, WG>(acc, sa, sa + G::A_STAGE);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int s = 0; s < G::NACC; ++s) fence_operands(acc[s]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < G::NACC; ++s) fence_operands(acc[s]);
    cp_async_wait<0>();
    block_sync();

    // fold this warpgroup's diagonals into w-bit partials: slot WG
    uint64_t* slot = reinterpret_cast<uint64_t*>(smem + WG * G::SLOT);
    const int warp = lane >> 5;
    const int l32 = lane & 31;
#pragma unroll
    for (int v = 0; v < G::FRAG; ++v) {
      const int row = 16 * warp + (l32 >> 2) + 8 * ((v >> 1) & 1);
      const int col = 8 * (v >> 2) + 2 * (l32 & 3) + (v & 1);
      uint64_t lo = 0ull, hi = 0ull;
#pragma unroll
      for (int s = 0; s < G::NACC; ++s)
        add_shifted(lo, hi, acc[s][v], 8 * diagonal<L>(WG, s));
      if (L == 16) {
        slot[2 * (row * G::BN + col)] = lo;
        slot[2 * (row * G::BN + col) + 1] = hi;
      } else {
        slot[row * G::BN + col] = lo;
      }
    }
    block_sync();

    // sum the NWG (two) warpgroup partials (and the earlier segments'
    // result) and write
    for (int e = tid; e < BM * G::BN; e += THREADS) {
      const int row = e / G::BN;
      const int col = e % G::BN;
      uint64_t lo = 0ull, hi = 0ull;
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        const uint64_t* sl =
            reinterpret_cast<const uint64_t*>(smem + w * G::SLOT);
        if (L == 16) {
          const uint64_t a = sl[2 * e];
          lo += a;
          hi += sl[2 * e + 1] + (lo < a ? 1ull : 0ull);
        } else {
          lo += sl[e];
        }
      }
      const int gr = mtile * BM + row;
      const int gc = ntile * G::BN + col;
      if (gr < m && gc < n) {
        const long long o = (static_cast<long long>(p) * m + gr) * n + gc;
        if (seg > 0) {
          const uint64_t a = out_lo[o];
          lo += a;
          if (L == 16) hi += out_hi[o] + (lo < a ? 1ull : 0ull);
        }
        out_lo[o] = lo;
        if (L == 16) out_hi[o] = hi;
      }
    }
    block_sync();
  }
}

template <int L>
__global__ void __launch_bounds__(THREADS, 1)
dot_cross_terms_gemm(const uint8_t* __restrict__ a8,
                     const uint8_t* __restrict__ b8,
                     uint64_t* __restrict__ out_lo,
                     uint64_t* __restrict__ out_hi, int m, int n, int mt,
                     int nt, int kc) {
  using G = Geometry<L>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int ntile = blockIdx.x;
  const int mtile = blockIdx.y;
  const int p = blockIdx.z;
  const uint8_t* a_src =
      a8 + (static_cast<long long>(p) * mt + mtile) * kc * G::A_STAGE;
  const uint8_t* b_src =
      b8 + (static_cast<long long>(p) * nt + ntile) * kc * G::B_STAGE;
  switch (threadIdx.x >> 7) {
    case 0:
      gemm_body<L, 0>(a_src, b_src, out_lo, out_hi, smem, m, n, kc, p,
                      mtile, ntile);
      break;
    default:
      gemm_body<L, 1>(a_src, b_src, out_lo, out_hi, smem, m, n, kc, p,
                      mtile, ntile);
      break;
  }
}

template <int L>
int launch(const void* const* words, void* out_lo, void* out_hi, void* a8,
           void* b8, long long a8_bytes, long long b8_bytes, int parties,
           int m, int k, int n, int terms, cudaStream_t s) {
  using G = Geometry<L>;
  const long long depth = static_cast<long long>(terms) * k;
  const long long mt = (m + BM - 1) / BM;
  const long long nt = (n + G::BN - 1) / G::BN;
  const long long kc = (depth + BK - 1) / BK;
  const long long need_a = parties * mt * kc * G::A_STAGE;
  const long long need_b = parties * nt * kc * G::B_STAGE;
  if (terms < 1 || terms > 2 || depth > 0x7FFFFFFF || parties < 1 ||
      parties > 65535 || mt > 65535 || nt > 0x7FFFFFFF ||
      kc > 0x7FFFFFFF || a8_bytes < need_a || b8_bytes < need_b)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* ptr) { return static_cast<const uint64_t*>(ptr); };
  const long long items_a = parties * mt * kc * (BM / 8) * 16;
  const long long items = items_a + parties * nt * kc * (G::BN / 8) * 16;
  if (items > 0) {
    const long long blocks = (items + SPLIT_THREADS - 1) / SPLIT_THREADS;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    dot_cross_terms_split<L><<<static_cast<unsigned>(blocks), SPLIT_THREADS,
                               0, s>>>(
        u(words[0]), u(words[1]), u(words[2]), u(words[3]), u(words[4]),
        u(words[5]), u(words[6]), u(words[7]), static_cast<uint8_t*>(a8),
        static_cast<uint8_t*>(b8), m, k, static_cast<int>(depth), n,
        static_cast<int>(mt), static_cast<int>(nt), static_cast<int>(kc),
        items_a, items);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      dot_cross_terms_gemm<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nt), static_cast<unsigned>(mt),
                  static_cast<unsigned>(parties));
  dot_cross_terms_gemm<L><<<grid, THREADS, G::SMEM, s>>>(
      static_cast<const uint8_t*>(a8), static_cast<const uint8_t*>(b8),
      static_cast<uint64_t*>(out_lo), static_cast<uint64_t*>(out_hi), m, n,
      static_cast<int>(mt), static_cast<int>(nt), static_cast<int>(kc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` the split stage into the caller's scratch a8 / b8
// (of a8_bytes / b8_bytes) and the GEMM stage into out_lo / out_hi; returns
// the first cudaGetLastError() that is not 0 (cudaErrorInvalidValue for a
// shape the grid cannot hold, scratch too small, or terms not 1 or 2).
// The *_hi pointers are ignored (and may be null) when wide == 0; with
// terms == 1 (x0 @ ysum alone) x1 and y0 are not read, but must still be
// pointers the caller may read (x0 and ysum will do).
extern "C" int moose_dot_cross_terms(
    const void* x0_lo, const void* x0_hi, const void* x1_lo,
    const void* x1_hi, const void* y0_lo, const void* y0_hi,
    const void* ys_lo, const void* ys_hi, void* out_lo, void* out_hi,
    void* a8, void* b8, long long a8_bytes, long long b8_bytes, int parties,
    int m, int k, int n, int wide, int terms, void* stream) {
  const void* words[8] = {x0_lo, x0_hi, x1_lo, x1_hi,
                          y0_lo, y0_hi, ys_lo, ys_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    return launch<16>(words, out_lo, out_hi, a8, b8, a8_bytes, b8_bytes,
                      parties, m, k, n, terms, s);
  return launch<8>(words, out_lo, out_hi, a8, b8, a8_bytes, b8_bytes, parties,
                   m, k, n, terms, s);
}
