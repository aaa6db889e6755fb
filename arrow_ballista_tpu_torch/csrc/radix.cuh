// The radix core shared by K4 (sort.cu, sort_order) and K5 (join_build.cu,
// build_side_sort): a stable LSD radix sort of rows whose key is W uint64
// limbs (limb 0 least significant; limb-major arrays, limb m of row i at
// keys[m * n + i]) and whose payload is the int32 row index.
//
// Two forms:
//
// * onesweep (Adinets and Merrill's scheme): an upfront kernel of the
//   caller's own (it makes the keys: K4 packs its sort words, K5 hashes)
//   counts every digit position's histogram at once into a shared-memory
//   histogram per block (rx_up_*); rx_bases turns the blocks' histograms
//   into each pass's digit bases; then one rx_onesweep_pass launch a digit.
//   A pass takes its tile index from an atomic counter (never blockIdx, so
//   a look-back never waits on a tile that was not scheduled), ranks its
//   4,096 or 8,192 rows by digit in shared memory, gets each digit's global offset
//   by decoupled look-back over per-(tile, digit) status words (the flag
//   packed beside the count), and stages keys and rows in shared memory so
//   that each digit's run leaves as one coalesced write.  Launches: the
//   upfront kernel, rx_bases and one a pass; no memset.  The status words
//   of two passes alternate between two buffers: the upfront kernel clears
//   the first pass's buffer and the tile counters, each pass clears the
//   next pass's buffer row by row (the previous pass, which used it, has
//   ended).
// * single block (rx_block_sort): rows that fit one block's shared memory
//   (RX_SB_ROWS) sort inside one launch, keys in shared memory, by a
//   bitonic network over (key, row), whose steps do not grow with the key's
//   bits as radix passes do.
//
// Digits are RX_BITS = 8 bits.  11-bit digits (2,048 bins, 6 passes for
// 64 bits) timed slower on the H100 at every size tried (PERF.md): their
// prefix and look-back take 8 bins a thread.
//
// Stability: a warp holds a contiguous run of rows, item j of lane l being
// row j * 32 + l of the run, so ranking items in order (the lanes of one
// digit found by ballots, rx_match), and warps in order with per-warp
// counts, ranks equal digits in row order; tiles take offsets in tile
// order.  Equal keys keep their row order, which K5's probe depends on bit
// for bit.
//
// Each including library names the namespace of these kernels (RX_NS), so
// that a profile tells K4's passes from K5's by kernel name.
#pragma once

#include "common.cuh"

#ifndef RX_NS
#error "define RX_NS, the namespace of this library's radix kernels, before radix.cuh"
#endif

#define RX_ITEMS 16  // rows a pass thread ranks
#define RX_BITS 8    // bits a digit
#define RX_BINS (1 << RX_BITS)
// A pass block has 256 threads (4,096-row tiles, four blocks an SM) up to
// RX_SMALL_ROWS rows, where more tiles in flight shorten a pass, and 512
// (8,192-row tiles, two an SM) above it, where fewer, larger tiles do;
// 64 registers a thread either way.
#define RX_SMALL_ROWS (1LL << 20)
#define RX_UP_THREADS 512                // the upfront kernels
#define RX_UP_BLOCKS (132 * 4)
#define RX_SB_THREADS 1024  // the single-block form
#define RX_SB_ROWS 8192     // the most rows it takes
#define RX_SMEM_LIMIT 232448  // an H100 block's shared memory (227 KB)
#define RX_SB_SMEM_LIMIT (RX_SMEM_LIMIT - 8192)  // the single-block kernels' static arrays
#define RX_MAX_ROWS (1LL << 30)  // a status word carries a 30-bit count

// look-back status word: flag in bits 31:30, count or prefix below
#define RX_FLAG_AGG 0x40000000u
#define RX_FLAG_INC 0x80000000u
#define RX_VALUE 0x3fffffffu

namespace RX_NS {

__device__ __forceinline__ void rx_store(unsigned* p, unsigned v) { *(volatile unsigned*)p = v; }
__device__ __forceinline__ unsigned rx_load(const unsigned* p) {
  return *(const volatile unsigned*)p;
}

// The lanes whose `d` equals this lane's, from one ballot a bit (bits
// 0..B-1); __match_any_sync does the same, more slowly.
template <int B>
__device__ __forceinline__ unsigned rx_match(unsigned d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const unsigned set = (d >> b) & 1u;
    const unsigned bal = __ballot_sync(0xffffffffu, set);
    peers &= set ? bal : ~bal;
  }
  return peers;
}

static inline int rx_threads(long long n) { return n <= RX_SMALL_ROWS ? 256 : 512; }
static inline long long rx_tiles(long long n) {
  const long long tile = (long long)rx_threads(n) * RX_ITEMS;
  return (n + tile - 1) / tile;
}
static inline int rx_up_blocks(long long n) {
  return ab_grid(n, RX_UP_THREADS, RX_UP_BLOCKS);
}
__host__ __device__ inline int rx_passes(int bits) { return (bits + RX_BITS - 1) / RX_BITS; }
__host__ __device__ inline long long rx_align16(long long bytes) { return (bytes + 15) & ~15LL; }

// --------------------------------------------------------------------------
// the upfront pass: every digit position's histogram in one read
// --------------------------------------------------------------------------

// Zero the block's shared histograms ([P][BINS]); clear the first pass's
// status words and the tile counters (grid-stride, every block a share).
__device__ __forceinline__ void rx_up_begin(unsigned* hist, int hist_len, unsigned* status0,
                                            long long status_words, unsigned* counters, int P) {
  for (int b = threadIdx.x; b < hist_len; b += blockDim.x) hist[b] = 0u;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < status_words; i += step)
    status0[i] = 0u;
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < P; p += blockDim.x) counters[p] = 0u;
  __syncthreads();
}

// Count the digits of passes p.. that end inside limb m (`cur`; `prev` is
// limb m - 1): a digit straddling two limbs is counted with its upper limb.
__device__ __forceinline__ void rx_count_limb(unsigned* hist, int P, uint64_t prev, uint64_t cur,
                                              int m, int W, int& p) {
  while (p < P && (p * RX_BITS + RX_BITS <= 64 * (m + 1) || m == W - 1)) {
    const int bit = p * RX_BITS, sh = bit & 63;
    const uint64_t v = ((bit >> 6) == m) ? (cur >> sh) : ((prev >> sh) | (cur << (64 - sh)));
    atomicAdd(&hist[p * RX_BINS + (unsigned)(v & (RX_BINS - 1))], 1u);
    ++p;
  }
}

// Write the block's histograms to hist_blk[blockIdx][P][BINS].
__device__ __forceinline__ void rx_up_end(const unsigned* hist, int hist_len,
                                          unsigned* __restrict__ hist_blk) {
  __syncthreads();
  unsigned* out = hist_blk + (long long)blockIdx.x * hist_len;
  for (int b = threadIdx.x; b < hist_len; b += blockDim.x) out[b] = hist[b];
}

// The blocks' histograms -> each pass's exclusive digit bases
// (bases[P][BINS]); block p does pass p.  With live_blk (K5: the upfront
// pass counted the digits of live rows only), the n - live dead rows, whose
// keys are all ones, join each pass's all-ones digit, and block 0 writes
// the live count to *n_live.
__global__ void __launch_bounds__(1024)
    rx_bases(const unsigned* __restrict__ hist_blk, int blocks, int P, long long n,
             unsigned* __restrict__ bases, const unsigned long long* __restrict__ live_blk,
             long long* __restrict__ n_live) {
  constexpr int BINS = RX_BINS;
  constexpr int GROUPS = 1024 / BINS;  // blocks summed by one bin's slots
  __shared__ unsigned tot[BINS];
  __shared__ unsigned ws[32];
  __shared__ unsigned long long ws64[32];
  const int p = blockIdx.x;
  for (int b = threadIdx.x; b < BINS; b += blockDim.x) tot[b] = 0u;
  if (live_blk != nullptr) {
    unsigned long long live = 0ULL;
    for (int g = threadIdx.x; g < blocks; g += blockDim.x) live += live_blk[g];
    unsigned long long all;
    ab_block_exclusive_scan<unsigned long long>(live, ws64, &all);  // syncs the block
    if (threadIdx.x == 0) {
      tot[(unsigned)((~0ULL >> (p * RX_BITS)) & (BINS - 1))] = (unsigned)(n - (long long)all);
      if (p == 0) *n_live = (long long)all;
    }
  }
  __syncthreads();
  // each (bin, group) slot sums its bin over every GROUPS-th block
  for (int slot = threadIdx.x; slot < BINS * GROUPS; slot += blockDim.x) {
    const int b = slot % BINS, g0 = slot / BINS;
    unsigned c = 0u;
    for (int g = g0; g < blocks; g += GROUPS) c += hist_blk[((long long)g * P + p) * BINS + b];
    atomicAdd(&tot[b], c);
  }
  __syncthreads();
  const unsigned v = threadIdx.x < BINS ? tot[threadIdx.x] : 0u;
  unsigned total;
  const unsigned run = ab_block_exclusive_scan<unsigned>(v, ws, &total);
  if (threadIdx.x < BINS) bases[(long long)p * BINS + threadIdx.x] = run;
}

// --------------------------------------------------------------------------
// one onesweep pass
// --------------------------------------------------------------------------

struct RxPass {
  const uint64_t* keys_in;
  uint64_t* keys_out;
  const int32_t* rows_in;  // null in the first pass: the row index itself
  int32_t* rows_out;
  long long n;             // rows, and the stride between limbs
  int W;                   // limbs a key
  int bit;                 // the digit's lowest bit
  int move_lo;             // limbs [move_lo, W) are carried to keys_out
  int tiles;
  const unsigned* base;    // [BINS] the pass's digit bases
  unsigned* status;        // [tiles][BINS] this pass's look-back words, zero on entry
  unsigned* status_next;   // the next pass's buffer: cleared here, row by row
  unsigned* counter;       // this pass's tile counter, zero on entry
};

template <int T>
struct RxPassSmem {
  uint64_t stage[T * RX_ITEMS];                  // keys or rows in ranked order
  unsigned short whist[T / 32][RX_BINS];         // per-warp counts, then prefixes
  int bstart[RX_BINS];                           // the tile's first slot of each digit
  int gdelta[RX_BINS];                           // global offset - bstart
  unsigned short dig[T * RX_ITEMS];              // the digit of each ranked slot
  unsigned scan_ws[32];
  int tile;
};

template <int T>
__global__ void __launch_bounds__(T, 1024 / T) rx_onesweep_pass(RxPass a) {
  constexpr int BINS = RX_BINS;
  constexpr unsigned MASK = BINS - 1;
  constexpr int BPT = (BINS + T - 1) / T;  // bins a thread owns
  constexpr int WARPS = T / 32;
  constexpr int TILE = T * RX_ITEMS;
  extern __shared__ uint64_t rx_smem[];
  RxPassSmem<T>& s = *reinterpret_cast<RxPassSmem<T>*>(rx_smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s.tile = (int)atomicAdd(a.counter, 1u);
  for (int b = threadIdx.x; b < WARPS * BINS; b += T) (&s.whist[0][0])[b] = 0;
  __syncthreads();
  const int tile = s.tile;
  const long long tile_base = (long long)tile * TILE;
  const int valid = (int)min((long long)TILE, a.n - tile_base);
  for (int b = threadIdx.x; b < BINS; b += T)
    a.status_next[(long long)tile * BINS + b] = 0u;

  // 1. the digits, warp-striped: warp w holds rows [w * 32 * ITEMS, ...),
  //    item j of lane l being row j * 32 + l of them
  const int seg = warp * 32 * RX_ITEMS;
  const int lm = a.bit >> 6, sh = a.bit & 63;
  const bool straddle = sh + RX_BITS > 64 && lm + 1 < a.W;
  const uint64_t* klo = a.keys_in + (long long)lm * a.n + tile_base;
  unsigned d[RX_ITEMS];
  int pos[RX_ITEMS];
#pragma unroll
  for (int j = 0; j < RX_ITEMS; ++j) {
    const int lr = seg + j * 32 + lane;
    if (lr < valid) {
      uint64_t v = klo[lr] >> sh;
      if (straddle) v |= klo[a.n + lr] << (64 - sh);
      d[j] = (unsigned)(v & MASK);
    } else {
      d[j] = BINS;  // past the end: grouped apart, never counted
    }
  }
  // 2. rank within the warp, rows in order
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < RX_ITEMS; ++j) {
    // bit RX_BITS sets the past-end rows apart
    const unsigned peers = rx_match<RX_BITS + 1>(d[j]);
    const bool live = d[j] < BINS;
    const int before = live ? (int)s.whist[warp][d[j]] : 0;
    pos[j] = before + __popc(peers & lt);
    __syncwarp();
    if (live && (peers & lt) == 0u)
      s.whist[warp][d[j]] = (unsigned short)(before + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // 3. per owned bin: counts over the warps become exclusive prefixes over
  //    the warps; the tile's count is published at once
  unsigned cnt[BPT];
  unsigned tsum = 0u;
  unsigned* st = a.status + (long long)tile * BINS;
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int b = threadIdx.x * BPT + i;
    unsigned run = 0u;
    if (b < BINS) {
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = s.whist[w][b];
        s.whist[w][b] = (unsigned short)run;
        run += c;
      }
      if (tile > 0) rx_store(st + b, RX_FLAG_AGG | run);
    }
    cnt[i] = run;
    tsum += run;
  }
  unsigned ttotal;
  unsigned run = ab_block_exclusive_scan<unsigned>(tsum, s.scan_ws, &ttotal);
  // 4. decoupled look-back: the rows of this digit in earlier tiles, plus
  //    the digit's base (tile 0's inclusive word holds it)
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int b = threadIdx.x * BPT + i;
    if (b < BINS) {
      unsigned excl;
      if (tile == 0) {
        excl = a.base[b];
      } else {
        // nearest first: add aggregates until an inclusive prefix (tile 0's
        // word always is one); an unpublished word (0) is read again
        excl = 0u;
        for (int k = tile - 1;; ) {
          const unsigned v = rx_load(a.status + (long long)k * BINS + b);
          if (v == 0u) continue;
          excl += v & RX_VALUE;
          if (v & RX_FLAG_INC) break;
          --k;
        }
      }
      rx_store(st + b, RX_FLAG_INC | (excl + cnt[i]));
      s.bstart[b] = (int)run;
      s.gdelta[b] = (int)excl - (int)run;
    }
    run += cnt[i];
  }
  __syncthreads();

  // 5. each row's slot in the tile's ranked order
#pragma unroll
  for (int j = 0; j < RX_ITEMS; ++j) {
    if (d[j] < BINS) {
      pos[j] += s.bstart[d[j]] + (int)s.whist[warp][d[j]];
      s.dig[pos[j]] = (unsigned short)d[j];
    }
  }
  // 6. carry the limbs still needed, then the rows: staged in ranked order,
  //    written out in runs of one digit
  for (int m = a.move_lo; m < a.W; ++m) {
    const uint64_t* src = a.keys_in + (long long)m * a.n + tile_base;
#pragma unroll
    for (int j = 0; j < RX_ITEMS; ++j)
      if (d[j] < BINS) s.stage[pos[j]] = src[seg + j * 32 + lane];
    __syncthreads();
    uint64_t* dst = a.keys_out + (long long)m * a.n;
#pragma unroll
    for (int j = 0; j < RX_ITEMS; ++j) {
      const int i = threadIdx.x + j * T;
      if (i < valid) dst[s.gdelta[s.dig[i]] + i] = s.stage[i];
    }
    __syncthreads();
  }
  int32_t* st32 = reinterpret_cast<int32_t*>(s.stage);
#pragma unroll
  for (int j = 0; j < RX_ITEMS; ++j) {
    if (d[j] < BINS) {
      const int lr = seg + j * 32 + lane;
      st32[pos[j]] = a.rows_in ? a.rows_in[tile_base + lr] : (int32_t)(tile_base + lr);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RX_ITEMS; ++j) {
    const int i = threadIdx.x + j * T;
    if (i < valid) a.rows_out[s.gdelta[s.dig[i]] + i] = st32[i];
  }
}

// --------------------------------------------------------------------------
// the onesweep form on the host: scratch and launches after the upfront kernel
// --------------------------------------------------------------------------

// Scratch of the onesweep form past the keys and rows (bytes, each part
// 16-byte aligned): hist_blk u32[G][P][BINS], bases u32[P][BINS], status
// u32[2][tiles][BINS], counters u32[P], live_blk u64[G].
struct RxScratch {
  unsigned* hist_blk;
  unsigned* bases;
  unsigned* status;
  unsigned* counters;
  unsigned long long* live_blk;
  long long status_words;  // one buffer's
};

static inline long long rx_control_bytes(long long n, int P) {
  const long long bins = RX_BINS;
  const long long g = rx_up_blocks(n);
  return ab_align16(g * P * bins * 4) + ab_align16(P * bins * 4) +
         ab_align16(2 * rx_tiles(n) * bins * 4) + ab_align16((long long)P * 4) + ab_align16(g * 8);
}

static inline RxScratch rx_carve(char* p, long long n, int P) {
  const long long bins = RX_BINS;
  const long long g = rx_up_blocks(n);
  RxScratch s;
  s.hist_blk = (unsigned*)p;
  p += ab_align16(g * P * bins * 4);
  s.bases = (unsigned*)p;
  p += ab_align16(P * bins * 4);
  s.status = (unsigned*)p;
  s.status_words = rx_tiles(n) * bins;
  p += ab_align16(2 * s.status_words * 4);
  s.counters = (unsigned*)p;
  p += ab_align16((long long)P * 4);
  s.live_blk = (unsigned long long*)p;
  return s;
}

// raise a kernel's dynamic shared memory limit (static arrays count
// against the same 48 KB default)
template <typename K>
static int rx_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 40 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// After the upfront kernel: the bases, then P passes.  keys[2] and rows[2]
// ping-pong (the upfront kernel wrote keys[0]; pass p reads keys[p & 1] and
// rows[p & 1] and writes the other, so the last pass lands in index P & 1).
// A pass carries only the limbs a later pass reads; the last carries none
// when keep_keys is 0.
template <int T>
static int rx_run_passes(uint64_t* const keys[2], int32_t* const rows[2], long long n, int W,
                         int P, int keep_keys, const RxScratch& sc, cudaStream_t st) {
  const size_t smem = sizeof(RxPassSmem<T>);
  int err = rx_allow_smem(rx_onesweep_pass<T>, smem);
  if (err) return err;
  const long long tiles = rx_tiles(n);
  for (int p = 0; p < P; ++p) {
    RxPass a;
    a.keys_in = keys[p & 1];
    a.keys_out = keys[(p + 1) & 1];
    a.rows_in = p == 0 ? nullptr : rows[p & 1];
    a.rows_out = rows[(p + 1) & 1];
    a.n = n;
    a.W = W;
    a.bit = p * RX_BITS;
    if (p + 1 < P) {
      a.move_lo = ((p + 1) * RX_BITS) >> 6;  // the lowest limb a later pass reads
    } else {
      a.move_lo = keep_keys ? 0 : W;
    }
    a.tiles = (int)tiles;
    a.base = sc.bases + (long long)p * RX_BINS;
    a.status = sc.status + (long long)(p & 1) * sc.status_words;
    a.status_next = sc.status + (long long)((p + 1) & 1) * sc.status_words;
    a.counter = sc.counters + p;
    rx_onesweep_pass<T><<<(unsigned)tiles, T, smem, st>>>(a);
    err = ab_last_error();
    if (err) return err;
  }
  return 0;
}

static int rx_onesweep_passes(uint64_t* const keys[2], int32_t* const rows[2], long long n, int W,
                              int P, int keep_keys, const RxScratch& sc, int up_blocks,
                              long long* n_live, cudaStream_t st) {
  rx_bases<<<P, 1024, 0, st>>>(sc.hist_blk, up_blocks, P, n, sc.bases,
                                  n_live ? sc.live_blk : nullptr, n_live);
  const int err = ab_last_error();
  if (err) return err;
  if (rx_threads(n) == 256) return rx_run_passes<256>(keys, rows, n, W, P, keep_keys, sc, st);
  return rx_run_passes<512>(keys, rows, n, W, P, keep_keys, sc, st);
}

// --------------------------------------------------------------------------
// the single-block form
// --------------------------------------------------------------------------

// key of row a before key of row b: the limbs from the most significant,
// then the row (so the order is the stable one); rows past n sort last
__device__ __forceinline__ bool rx_before(const uint64_t* keys, int n, int W, int a, int b) {
  if (a >= n || b >= n) return a < b;
  for (int m = W - 1; m >= 0; --m) {
    const uint64_t x = keys[(long long)m * n + a], y = keys[(long long)m * n + b];
    if (x != y) return x < y;
  }
  return a < b;
}

// Sorts the row indices 0..n-1 (n <= RX_SB_ROWS) by the keys in shared
// memory (W limbs, limb-major with stride n) with a bitonic network over the
// power of two N >= n, comparing (key, row): log2 N (log2 N + 1) / 2 steps of
// N / 2 compare-exchanges of indices, one __syncthreads each, where the
// radix passes' count grows with the key's bits (21 at q18's five group keys
// over about 1,000 rows).  idx holds N ints and ends with the permutation.
// Every thread of the block calls it.
__device__ void rx_block_sort(const uint64_t* keys, int n, int W, int* idx) {
  int N = 1;
  while (N < n) N <<= 1;
  for (int i = threadIdx.x; i < N; i += blockDim.x) idx[i] = i;
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);  // pairs (i, i + j), i's bit j clear
        const int a = idx[i], b = idx[i + j];
        const bool up = (i & k) == 0;
        if (up ? rx_before(keys, n, W, b, a) : rx_before(keys, n, W, a, b)) {
          idx[i] = b;
          idx[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

static inline int rx_pow2(long long n) {
  int N = 1;
  while (N < n) N <<= 1;
  return N;
}

// dynamic shared memory of a single-block sort of n rows of W limbs, or -1
// where they do not fit
static inline long long rx_block_bytes(long long n, int W) {
  if (n < 1 || n > RX_SB_ROWS) return -1;
  const long long bytes = rx_align16(n * 8 * W) + rx_align16((long long)rx_pow2(n) * 4);
  return bytes <= RX_SB_SMEM_LIMIT ? bytes : -1;
}

// the parts of that shared memory: the keys, then the indices
struct RxBlockParts {
  uint64_t* keys;
  int* idx;
};

__device__ __forceinline__ RxBlockParts rx_block_parts(void* smem, int n, int W) {
  RxBlockParts q;
  q.keys = (uint64_t*)smem;
  q.idx = (int*)((char*)smem + rx_align16((long long)n * 8 * W));
  return q;
}

}  // namespace RX_NS
