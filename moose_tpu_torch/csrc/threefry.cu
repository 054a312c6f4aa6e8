// threefry: counter-mode expansion of threefry2x32-20 into uniform u64
// words or uniform bits, for a group of draws in one launch.
//
// Replaces the TPU kernel moose_tpu/dialects/pallas_prf.py:
// random_bits_u64 (pallas_call body _kernel), and also expands the
// default "threefry" stream, which the JAX package draws with
// jax.random.bits.  The two streams share the cipher and differ in their
// key and counter layout:
//
//   layout 0, "threefry" (jax.random.bits on a partitionable threefry
//     key): the key is the u64 data ^ data2 * golden of the seed; element
//     i encrypts the block (i >> 32, i & 0xFFFFFFFF); a word is
//     (y0 << 32) | y1, a bit is bit 0 of y0 ^ y1.
//   layout 1, "threefry-pallas" (K7): the key is (s0 ^ s2, s1 ^ s3); word
//     i encrypts (c, ~c) for the u32 lane index c = i, so one key covers
//     at most 2^32 words; a word is (y0 << 32) | y1.  Bits come 64 to a
//     word: element 64w + j is bit j of word w, least significant first.
//
// A group is an ordered list of draws of one protocol session.  Draw j
// of the group is the session's draw first + j: its seed is derived here
// exactly as SpmdSession + ring.mix_seed derive it on the host (the
// nonce (idx, 0x5B3D9E21 ^ domain * 0x85EBCA6B, idx ^ 0xA5A5A5A5, 7)
// mixed into the master key word by word as k ^ (n * 0x9E3779B9 +
// 0x85EBCA6B), keyed like layout 0, and the four words y0 ^ y1 of the
// blocks (0, i), i = 0..3); a bit draw flips the top bit of seed word 3,
// and the seed is then keyed in the group's layout.  A draw of ring128
// words is one (2, n) draw whose stream words [0, n) are its high plane
// and [n, 2n) its low plane; each plane goes to its own destination.
// A group may also carry one key given by the host (derive == 0): that
// is how threefry_words / threefry_bits expand a single key.
//
// What bounds it on the card: its operations and its store about
// equally.  A word costs 20 rounds of add, rotate and xor plus five key
// injections, some 73 32-bit integer instructions; at the card's issue
// rate (128 lanes per SM and clock) they take about as long as the
// word's 8-byte store at 3.35 TB/s, and the 40 rotations and xors, which
// issue only on the 64 INT32 lanes of an SM, take as long again.  At the
// protocol's shapes a draw is small (768 to 393,216 outputs), so one
// launch per draw was bound by the launch and, on the host, by deriving
// each seed in Python.
//
// What the design does about it: one launch expands a whole group (the
// 84 draws of a Horner ladder, the 16 AND banks of an adder), so the
// grid is sized from the group's total work and small draws fill the
// card together.  The draw table travels by value in the kernel's
// parameters (no host-to-device copy).  The work is cut into tiles of
// outputs (words, layout-0 bits, or layout-1 words of 64 bits), each
// inside one draw: 256 threads times 1 to 8 outputs a thread, 256 apart
// so a warp's stores coalesce, more as the group grows past what the
// resident threads take at one a thread (a small group wants the most
// blocks, a large one spreads each tile's bookkeeping over more
// outputs).  One block takes one tile, so the hardware schedules the
// waves: it reads its draw's entry into registers, and warp 0 derives
// the draw's key (lanes 0-3 one seed block each, gathered by shuffles)
// into shared memory, once for the block, not per thread.  A ring128
// draw's tiles end where its two planes meet, so within a tile the
// destination and the counter's base are computed once and each output
// is a 32-bit offset from them.  The cipher runs in u32 registers with
// each rotation one funnel shift.  A layout-1 bit thread writes its 64
// unpacked bytes as four 16-byte stores where the destination is
// aligned, byte by byte where it is not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_UNITS = 8;  // most outputs (units) of a thread in a tile
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DRAWS = 224;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr uint64_t GOLDEN64 = 0x9E3779B97F4A7C15ull;

// a draw's kind: uint8 0/1 bits (else u64 words); two planes (ring128)
constexpr int KIND_BITS = 1;
constexpr int KIND_TWO_PLANES = 2;

// The group, by value in the kernel's parameters (about 7.4 KB at
// MAX_DRAWS; CUDA 12.1+ takes up to 32 KB on sm_70 and later).
struct Group {
  uint32_t master[4];  // derive: the session's master key; else the key
  uint32_t domain;
  int derive;
  int count;
  unsigned long long first;  // the session's nonce index of draw 0
  long long tiles;
  long long tile0[MAX_DRAWS + 1];  // first tile of draw j; [count] = tiles
  long long n[MAX_DRAWS];          // outputs per plane
  unsigned long long dst[MAX_DRAWS][2];
  unsigned char kind[MAX_DRAWS];
};

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

// The threefry key of a u32[4] seed: the u64 data ^ data2 * golden,
// split as jax.random.key splits a u64 seed.
__device__ __forceinline__ void key_from_seed(const uint32_t s[4],
                                              uint32_t& k0, uint32_t& k1) {
  const uint64_t data = (static_cast<uint64_t>(s[0]) << 32) | s[1];
  const uint64_t data2 = (static_cast<uint64_t>(s[2]) << 32) | s[3];
  const uint64_t x = data ^ (data2 * GOLDEN64);
  k0 = static_cast<uint32_t>(x >> 32);
  k1 = static_cast<uint32_t>(x);
}

// The encrypted counter block of stream element i in the given layout.
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

// Warp 0 of the block: the stream key of draw j, into key[0..1].  Every
// lane derives the mixed key; lanes 0-3 encrypt one seed block each, and
// the four seed words are gathered by shuffles.
template <int LAYOUT>
__device__ __forceinline__ void derive_key(const Group& g, int j,
                                           uint32_t* key) {
  const int lane = threadIdx.x & 31;
  const uint32_t idx = static_cast<uint32_t>(g.first + j);
  const uint32_t nonce[4] = {idx, 0x5B3D9E21u ^ (g.domain * 0x85EBCA6Bu),
                             idx ^ 0xA5A5A5A5u, 7u};
  uint32_t mixed[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    mixed[w] = g.master[w] ^ (nonce[w] * 0x9E3779B9u + 0x85EBCA6Bu);
  }
  uint32_t m0, m1;
  key_from_seed(mixed, m0, m1);
  uint32_t y0 = 0u, y1 = static_cast<uint32_t>(lane & 3);
  threefry2x32_20(y0, y1, m0, m1);
  const uint32_t mine = y0 ^ y1;
  uint32_t seed[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) seed[w] = __shfl_sync(0xffffffffu, mine, w);
  if (g.kind[j] & KIND_BITS) seed[3] ^= 0x80000000u;  // the bit tag
  if (lane == 0) {
    if (LAYOUT == 0) {
      key_from_seed(seed, key[0], key[1]);
    } else {
      key[0] = seed[0] ^ seed[2];
      key[1] = seed[1] ^ seed[3];
    }
  }
}

// Four bits to four 0/1 bytes, bit j to byte j: the products of the
// shifted copies do not overlap, so no carry crosses a byte.
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// Layout 1's word w of bits: outputs 64w .. 64w + 63 of the n, least
// significant bit first, as four 16-byte stores where the destination is
// aligned and whole, byte by byte where it is not.
__device__ __forceinline__ void write_bits64(uint8_t* dst, long long n,
                                             long long w, uint32_t k0,
                                             uint32_t k1) {
  uint32_t y0, y1;
  block<1>(w, k0, k1, y0, y1);
  const uint64_t word = (static_cast<uint64_t>(y0) << 32) | y1;
  const long long base = w * 64;
  if (base + 64 <= n && reinterpret_cast<uintptr_t>(dst + base) % 16 == 0) {
    uint4* out = reinterpret_cast<uint4*>(dst + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t bits16 = static_cast<uint32_t>(word >> (16 * q));
      out[q] = make_uint4(spread4(bits16 & 0xFu), spread4((bits16 >> 4) & 0xFu),
                          spread4((bits16 >> 8) & 0xFu),
                          spread4((bits16 >> 12) & 0xFu));
    }
  } else {
    const long long end = n - base < 64 ? n - base : 64;
    for (long long b = 0; b < end; ++b) {
      dst[base + b] = static_cast<uint8_t>((word >> b) & 1u);
    }
  }
}

// A draw's plane: n outputs (words or bits) in units of one cipher block
// each, a layout-1 unit 64 bits
template <int LAYOUT>
__device__ __forceinline__ long long plane_units(long long n, bool is_bits) {
  return is_bits && LAYOUT == 1 ? (n + 63) / 64 : n;
}

// The draw a block expands, in registers (its destinations stay in the
// parameters: an array indexed by the plane would go to local memory)
struct Draw {
  long long n;  // outputs per plane
  long long tiles_per_plane;
  long long tile0;
  bool is_bits;
};

template <int LAYOUT, int TILE>
__device__ __forceinline__ Draw load_draw(const Group& g, int j) {
  Draw d;
  d.n = g.n[j];
  d.is_bits = g.kind[j] & KIND_BITS;
  d.tiles_per_plane = (plane_units<LAYOUT>(d.n, d.is_bits) + TILE - 1) / TILE;
  d.tile0 = g.tile0[j];
  return d;
}

// The draw that owns tile t: the largest j with tile0[j] <= t (draws of
// no tiles are passed over).
__device__ __forceinline__ int draw_of(const Group& g, long long t) {
  int lo = 0;
  int hi = g.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (g.tile0[mid] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Block b expands tile b of the group, thread x its units x,
// x + THREADS, ... (UNITS of them): warp 0 derives the key of the draw
// that owns the tile, once for the block.
template <int LAYOUT, int UNITS>
__global__ void __launch_bounds__(THREADS)
threefry_group_kernel(const __grid_constant__ Group g) {
  constexpr int TILE = THREADS * UNITS;
  __shared__ uint32_t key[2];
  const long long t = blockIdx.x;
  const int j = draw_of(g, t);
  const Draw d = load_draw<LAYOUT, TILE>(g, j);
  uint32_t k0 = g.master[0];
  uint32_t k1 = g.master[1];
  if (g.derive) {
    if (threadIdx.x < 32) derive_key<LAYOUT>(g, j, key);
    __syncthreads();
    k0 = key[0];
    k1 = key[1];
  }
  // the tile's plane (a ring128 draw's tiles end where its planes meet),
  // and its first unit there; then 32-bit offsets within the tile
  const long long tile = t - d.tile0;
  const int plane = tile >= d.tiles_per_plane ? 1 : 0;
  const long long start = (tile - plane * d.tiles_per_plane) * TILE;
  const long long rest = plane_units<LAYOUT>(d.n, d.is_bits) - start;
  const int left = rest < TILE ? static_cast<int>(rest) : TILE;
  if (!d.is_bits) {
    uint64_t* dst = reinterpret_cast<uint64_t*>(g.dst[j][plane]) + start;
    const long long counter = plane * d.n + start;  // the plane's stream
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < left) {
        uint32_t y0, y1;
        block<LAYOUT>(counter + i, k0, k1, y0, y1);
        dst[i] = (static_cast<uint64_t>(y0) << 32) | y1;
      }
    }
  } else if (LAYOUT == 0) {
    uint8_t* dst = reinterpret_cast<uint8_t*>(g.dst[j][0]) + start;
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < left) {
        uint32_t y0, y1;
        block<0>(start + i, k0, k1, y0, y1);
        dst[i] = static_cast<uint8_t>((y0 ^ y1) & 1u);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < left) {
        write_bits64(reinterpret_cast<uint8_t*>(g.dst[j][0]), d.n, start + i,
                     k0, k1);
      }
    }
  }
}

// the blocks resident at once: BLOCKS_PER_SM on every SM
int max_blocks() {
  static int blocks[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (blocks[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks[dev] = (sms > 0 ? sms : 1) * BLOCKS_PER_SM;
  }
  return blocks[dev];
}

template <int LAYOUT>
void launch(const Group& g, int units, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(g.tiles);
  if (units == 1) {
    threefry_group_kernel<LAYOUT, 1><<<grid, THREADS, 0, s>>>(g);
  } else if (units == 2) {
    threefry_group_kernel<LAYOUT, 2><<<grid, THREADS, 0, s>>>(g);
  } else if (units == 4) {
    threefry_group_kernel<LAYOUT, 4><<<grid, THREADS, 0, s>>>(g);
  } else {
    threefry_group_kernel<LAYOUT, 8><<<grid, THREADS, 0, s>>>(g);
  }
}

}  // namespace

// Expands `count` draws (at most 224) in one launch.  Draw j writes
// n[j] outputs per plane: kind[j] bit 0 says uint8 0/1 bits (else u64
// words), bit 1 two planes of words (ring128: stream words [0, n) to
// dst[2j], [n, 2n) to dst[2j + 1]); one plane goes to dst[2j].  With
// derive != 0, draw j's key is derived from the session's master key
// key4, its domain and the nonce index first + j; with derive == 0, key4[0]
// and key4[1] are the key of every draw.  layout 0 is "threefry", 1
// "threefry-pallas"; layout 1 refuses a draw of more than 2^32 words.
// Launches on `stream` (nothing when there is no output); returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for what it
// refuses.
extern "C" int moose_threefry_group(const unsigned int* key4,
                                    unsigned int domain,
                                    unsigned long long first, int layout,
                                    int derive, int count,
                                    const long long* n,
                                    const unsigned long long* dst,
                                    const int* kind, void* stream) {
  if (count < 0 || count > MAX_DRAWS || (layout != 0 && layout != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Group g = {};
  for (int w = 0; w < 4; ++w) g.master[w] = key4[w];
  g.domain = domain;
  g.derive = derive;
  g.count = count;
  g.first = first;
  long long draw_units[MAX_DRAWS];
  int planes[MAX_DRAWS];
  long long total = 0;
  for (int j = 0; j < count; ++j) {
    if (n[j] < 0 || (kind[j] & ~(KIND_BITS | KIND_TWO_PLANES)) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool bits = kind[j] & KIND_BITS;
    const long long words =
        bits ? (n[j] + 63) / 64 : ((kind[j] & KIND_TWO_PLANES) ? 2 : 1) * n[j];
    if (layout == 1 && words > (1ll << 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    draw_units[j] = bits && layout == 0 ? n[j] : words;
    total += draw_units[j];
    planes[j] = (kind[j] & KIND_TWO_PLANES) ? 2 : 1;
    g.n[j] = n[j];
    g.dst[j][0] = dst[2 * j];
    g.dst[j][1] = dst[2 * j + 1];
    g.kind[j] = static_cast<unsigned char>(kind[j]);
  }
  if (total == 0) return 0;
  // units a thread takes in a tile: one while the group does not fill
  // every resident thread (small groups want the most blocks), up to
  // MAX_UNITS as it grows, which spreads the tile's bookkeeping
  int units = 1;
  while (units < MAX_UNITS &&
         total >= 2ll * units * max_blocks() * THREADS) {
    units *= 2;
  }
  const long long tile = static_cast<long long>(THREADS) * units;
  long long tiles = 0;
  for (int j = 0; j < count; ++j) {
    g.tile0[j] = tiles;
    const long long per_plane = draw_units[j] / planes[j];
    tiles += planes[j] * ((per_plane + tile - 1) / tile);
  }
  if (tiles > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  g.tile0[count] = tiles;
  g.tiles = tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    launch<0>(g, units, s);
  } else {
    launch<1>(g, units, s);
  }
  return static_cast<int>(cudaGetLastError());
}
