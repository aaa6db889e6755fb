// K2: compaction_order — stable permutation that moves live rows first;
// and K16: spill_order — the same core over a spilled build batch's
// partitions (below).
//
// Replaces arrow_ballista_tpu/ops/kernels.py compaction_order (l.88), which
// ColumnBatch.shrink ("batch.shrink"), pack_for_host and the stable
// argsort(~exists) of compact_dense_states use.  A live row's destination
// is the number of live rows before it; a dead row's is n_live plus the
// number of dead rows before it; perm[dest] = i.
//
// Bound: bytes, the mask read once (1 byte a row) and the permutation
// written once (4 bytes a row).  Most calls come at the local engine's
// 131,072-row batches, where launches, not bytes, cost: the parent's three
// launches (tile counts, one block scanning them, the scatter) each read
// the mask byte by byte.
//
// Two forms, both reading the mask as 16-byte words of its aligned base
// (common.cuh ab_mask_word: a view at a byte offset has the same words,
// its first and last ones clipped) and counting a word's live rows with
// __popc.  A round is one word a thread: its rows are ranked by a block
// scan of (valid, live) counts packed in one int, staged in shared memory
// live rows first, then dead rows, in row order, and written out in two
// contiguous runs, so a warp's stores are contiguous (cp_round).
//
// * One launch (k2_compact_one), up to CP_ONE_ROWS rows (2^17, the local
//   engine's batch: chosen by timing both forms): a thread block cluster of
//   up to CP_CLUSTER blocks of 1,024 threads, each holding its share of the
//   mask in shared memory (at most 2,048 words, 32 KB).  A block counts its live rows;
//   after a cluster barrier each reads the others' counts through
//   distributed shared memory (its live prefix and n_live), then scatters
//   its rounds.  No global scratch, no second launch: the analogue of K4's
//   single-block form, spread over several SMs' bandwidth (one block alone
//   moves about one SM's share).  A warp reads the blocks' counts, a lane
//   each; the barrier that keeps a block's shared memory alive while others
//   read it sits at the end, off the critical path.
// * Two launches above it.  k2_compact_count: each block counts a tile of
//   CP_TILE rows and writes its tile's status word (flag and count); the
//   block that draws the last ticket (ab_last_block) writes n_live and
//   resets the per-stream accumulator.  k2_compact_scatter: a tile's live
//   prefix by decoupled look-back over the status words, CP_THREADS words
//   a step, nearest first, stopping at the nearest inclusive word; it
//   publishes its own inclusive word, then scatters its rounds.  Every
//   aggregate is already published, so the look-back never waits, and
//   since the count pass writes every tile's word, the words need no
//   reset.  n_live must be known before any dead row is placed, which is
//   why the count pass cannot be folded away.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define CP_THREADS 256                        // the two-launch form's blocks
#define CP_ROUNDS 2                           // its rounds a tile (timed: 1-8)
#define CP_TILE (CP_THREADS * CP_ROUNDS * 16)  // 8,192 rows
#define CP_ONE_THREADS 1024                   // a block of the one-launch form
#define CP_CLUSTER 8                          // its blocks at most (a portable cluster)
#define CP_ONE_ROWS (1LL << 17)               // the one-launch form's rows at most

#define CP_FLAG_AGG (1ULL << 62)
#define CP_FLAG_INC (1ULL << 63)
#define CP_VALUE ((1ULL << 62) - 1)

// stage slot of the i-th staged row: one pad int after every 32, so that the
// lanes of a warp, whose runs start about 16 slots apart, hit distinct banks
#define CP_STAGE(T) ((T) * 16 + (T) / 2)
__device__ __forceinline__ unsigned cp_slot(unsigned i) { return i + (i >> 5); }

// One round: thread t holds word w, rows r0 + 16 t .. r0 + 16 t + 15 (bytes
// of rows outside [0, n) clear).  Live rows go to perm[live_before ..], dead
// rows to perm[n_live + dead_before ..], each in row order; the round's
// live and dead rows are added to live_before and dead_before.  Rounds must
// not straddle the end of a block's rows unless that end is n.  stage holds
// CP_STAGE(T) ints; ws T / 32.  Every thread of the block calls it.
template <int T>
__device__ __forceinline__ void cp_round(const uint4& w, long long r0, long long n,
                                         long long n_live, long long& live_before,
                                         long long& dead_before, int32_t* __restrict__ perm,
                                         int* stage, unsigned* ws) {
  const long long r = r0 + (long long)threadIdx.x * 16;
  const long long vlo = max(r, 0LL), vhi = min(r + 16, n);
  const unsigned valid = vhi > vlo ? (unsigned)(vhi - vlo) : 0u;
  // (valid, live) in the high and low halves: both sum to at most 16 T
  unsigned total;
  const unsigned ex = ab_block_exclusive_scan<unsigned>((valid << 16) | ab_word_live(w), ws,
                                                        &total);
  const unsigned nl = total & 0xffffu, nv = total >> 16;
  unsigned li = ex & 0xffffu;
  unsigned di = nl + (ex >> 16) - li;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const long long row = r + b;
    if (row < 0 || row >= n) continue;
    if (ab_word_byte(w, b)) stage[cp_slot(li++)] = (int)row;
    else stage[cp_slot(di++)] = (int)row;
  }
  __syncthreads();
  const long long dead_at = n_live + dead_before - nl;
  for (unsigned i = threadIdx.x; i < nv; i += T)
    perm[i < nl ? live_before + i : dead_at + i] = stage[cp_slot(i)];
  live_before += nl;
  dead_before += nv - nl;
  __syncthreads();  // the stage is the next round's
}

// --------------------------------------------------------------------------
// one launch: a cluster, the mask in its blocks' shared memory
// --------------------------------------------------------------------------

// wb: words a block, a multiple of CP_ONE_THREADS (so only the last block's
// last round reaches past its rows, and there past n).  Dynamic shared
// memory: wb words, then the stage.
__global__ void __launch_bounds__(CP_ONE_THREADS, 1)
    k2_compact_one(const uint4* __restrict__ words, int shift, long long n, long long wb,
                   int32_t* __restrict__ perm, int* __restrict__ n_live_out) {
  extern __shared__ uint4 cp_raw[];
  uint4* sw = cp_raw;
  int* stage = reinterpret_cast<int*>(cp_raw + wb);
  __shared__ unsigned ws[CP_ONE_THREADS / 32];
  __shared__ unsigned long long block_live;
  __shared__ long long live_before_block, n_live_all;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long w0 = (long long)rank * wb;
  const long long wend = min(w0 + wb, (n + shift + 15) >> 4);
  unsigned c = 0u;
  for (long long i = threadIdx.x; w0 + i < wend; i += CP_ONE_THREADS) {
    const uint4 v = ab_mask_word(words, w0 + i, (w0 + i) * 16 - shift, n);
    sw[i] = v;
    c += ab_word_live(v);
  }
  unsigned total;
  ab_block_exclusive_scan<unsigned>(c, ws, &total);
  if (threadIdx.x == 0) block_live = total;
  cluster.sync();  // every block's count is in its shared memory
  if (threadIdx.x < 32) {  // lane q reads block q's count
    const unsigned lane = threadIdx.x, blocks = cluster.num_blocks();
    const unsigned long long v = lane < blocks ? *cluster.map_shared_rank(&block_live, lane) : 0ULL;
    unsigned long long before = lane < rank ? v : 0ULL, all = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, o);
      all += __shfl_xor_sync(0xffffffffu, all, o);
    }
    if (lane == 0) {
      live_before_block = (long long)before;
      n_live_all = (long long)all;
      if (rank == 0 && n_live_out != nullptr) *n_live_out = (int)all;
    }
  }
  __syncthreads();
  long long live_before = live_before_block;
  long long dead_before = max(w0 * 16 - shift, 0LL) - live_before;
  const long long n_live = n_live_all;
  for (long long i0 = 0; w0 + i0 < wend; i0 += CP_ONE_THREADS) {
    const long long i = i0 + threadIdx.x;
    const uint4 v = w0 + i < wend ? sw[i] : make_uint4(0u, 0u, 0u, 0u);
    cp_round<CP_ONE_THREADS>(v, (w0 + i0) * 16 - shift, n, n_live, live_before, dead_before,
                             perm, stage, ws);
  }
  cluster.sync();  // no block leaves while another may still read its count
}

// --------------------------------------------------------------------------
// two launches: tile counts, then look-back and scatter
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(CP_THREADS)
    k2_compact_count(const uint4* __restrict__ words, int shift, long long n,
                     unsigned long long* __restrict__ status, unsigned long long* acc,
                     int* __restrict__ n_live) {
  __shared__ unsigned ws[CP_THREADS / 32];
  const long long t = blockIdx.x;
  const long long wt = t * CP_ROUNDS * CP_THREADS;
  uint4 v[CP_ROUNDS];
#pragma unroll
  for (int k = 0; k < CP_ROUNDS; ++k) {
    const long long w = wt + k * CP_THREADS + threadIdx.x;  // coalesced
    v[k] = ab_mask_word(words, w, w * 16 - shift, n);
  }
  unsigned c = 0u;
#pragma unroll
  for (int k = 0; k < CP_ROUNDS; ++k) c += ab_word_live(v[k]);
  unsigned total;
  ab_block_exclusive_scan<unsigned>(c, ws, &total);
  if (threadIdx.x == 0) {
    status[t] = CP_FLAG_AGG | total;
    if (total) atomicAdd(acc, (unsigned long long)total);
    if (ab_last_block(acc + 1)) {
      *n_live = (int)atomicExch(acc, 0ULL);
      acc[1] = 0ULL;
    }
  }
}

__global__ void __launch_bounds__(CP_THREADS)
    k2_compact_scatter(const uint4* __restrict__ words, int shift, long long n,
                       unsigned long long* status, const int* __restrict__ n_live,
                       int32_t* __restrict__ perm) {
  __shared__ int stage[CP_STAGE(CP_THREADS)];
  __shared__ unsigned ws[CP_THREADS / 32];
  __shared__ int first_inc[CP_THREADS / 32];
  __shared__ long long part[CP_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = blockIdx.x;
  const long long wt = t * CP_ROUNDS * CP_THREADS;
  const long long row0 = wt * 16 - shift;
  uint4 w[CP_ROUNDS];
#pragma unroll
  for (int k = 0; k < CP_ROUNDS; ++k) {
    const long long wi = wt + k * CP_THREADS + threadIdx.x;
    w[k] = ab_mask_word(words, wi, wi * 16 - shift, n);
  }
  // the live rows of the tiles before t: windows of CP_THREADS words,
  // nearest first, summed up to and with the nearest inclusive word
  long long excl = 0;
  for (long long end = t; end > 0; end -= CP_THREADS) {
    const long long k = end - 1 - threadIdx.x;
    const unsigned long long v = k >= 0 ? *(const volatile unsigned long long*)(status + k) : 0ULL;
    const unsigned inc = __ballot_sync(0xffffffffu, (v & CP_FLAG_INC) != 0ULL);
    if (lane == 0) first_inc[warp] = inc ? warp * 32 + __ffs(inc) - 1 : CP_THREADS;
    __syncthreads();
    int first = CP_THREADS;
#pragma unroll
    for (int q = 0; q < CP_THREADS / 32; ++q) first = min(first, first_inc[q]);
    long long mine = (int)threadIdx.x <= first ? (long long)(v & CP_VALUE) : 0LL;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, o);
    if (lane == 0) part[warp] = mine;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < CP_THREADS / 32; ++q) excl += part[q];
    __syncthreads();  // first_inc and part are the next window's
    if (first < CP_THREADS) break;
  }
  if (threadIdx.x == 0) {
    const unsigned long long own = status[t] & CP_VALUE;
    *(volatile unsigned long long*)(status + t) = CP_FLAG_INC | (unsigned long long)(excl + own);
  }
  long long live_before = excl;
  long long dead_before = max(row0, 0LL) - excl;
  const long long nl = *n_live;
#pragma unroll
  for (int k = 0; k < CP_ROUNDS; ++k)
    cp_round<CP_THREADS>(w[k], row0 + (long long)k * CP_THREADS * 16, n, nl, live_before,
                         dead_before, perm, stage, ws);
}

// --------------------------------------------------------------------------
// K16: spill_order, K2's core over 2P buckets
// --------------------------------------------------------------------------

// Replaces the reference's "join.spill_part" program (arrow_ballista_tpu/
// ops/operators.py:1512, part_fn: the top log2(P) bits of hash64 over the
// build keys) together with the compaction of pack_for_host
// (arrow_ballista_tpu/ops/kernels.py:122) that the spilled build batch goes
// through next.  A row's bucket is its partition p if live, P + p if dead;
// the output is the stable counting sort of the rows by bucket: live rows
// grouped by partition in ascending order, each group in row order, then
// the dead rows likewise, and the live count.  K2 is the case of one
// partition.  The hash is computed in registers (common.cuh ab_hash_row)
// and each row's partition written once; the bucket bytes stay in shared
// memory (one launch) or make one trip through a scratch array (two).
//
// Bound: bytes.  The keys and the mask read once, the partition (4 bytes
// a row) and the permutation written once.
//
// A round is cp_round widened: a thread holds the bucket bytes of its 8
// rows; its counts of each bucket, packed four to a 64-bit word in 16-bit
// fields, are scanned over the block in one pass (so_block_scan), the
// round's bucket offsets follow from the totals in the same packed words,
// and the rows are staged in bucket order and written out in runs.
//
// * One launch up to CP_ONE_ROWS rows (k16_spill_coop): a cooperative grid
//   of tiles of one round (2,048 rows, up to 64 tiles: a thread's chain of
//   dependent instructions, not bytes, sets a tile's time, so a thread
//   takes 8 rows).  A thread hashes its rows with the keys' loads issued
//   together (so_hash); one block scan both ranks the round and counts the
//   tile; the tiles publish their counts, grid.sync(), and each reads them
//   all (so_tile_starts): each bucket's start and its rows in the tiles
//   before.  (A cluster of 8 blocks, the counts through distributed shared
//   memory, ran on 8 SMs: 0.034 ms at 131,072 rows on an H100, against
//   0.0104 for spill_partition and K2.)
// * Two launches above it, over the same tiles: k16_spill_count hashes a
//   tile and writes its bucket bytes to the scratch array and its counts;
//   k16_spill_scatter reads every tile's counts (so_tile_starts: 32 KB a
//   tile at 2^20 rows, from L2) and places its round.  Nothing persists
//   between calls.  At 524,288 rows it takes 0.0178 ms and at 2^21 0.0586
//   against 0.0118 and 0.0207 for spill_partition and K2 (an H100 80GB
//   HBM3 at 700 W); what holds it back is not known.  Tiles of 4,096 rows
//   took 0.0188 ms at 524,288 rows, 0.0220 with a look-back over the
//   tiles before.

#define SO_PARTS_MAX 8                   // the kernel's partitions at most
#define SO_BUCKETS_MAX (2 * SO_PARTS_MAX)
#define SO_Q (SO_BUCKETS_MAX / 4)        // packed words of four 16-bit counts
#define SO_THREADS 256                   // a block of either form
#define SO_CO_ROWS 8                     // a thread's rows
#define SO_CO_TILE (SO_THREADS * SO_CO_ROWS)  // a tile of either form: 2,048 rows, one round
#define SO_NONE 0xffu                    // the bucket byte of a row past n

struct SoArgs {
  HashCols c;
  const uint8_t* mask;
  long long n;
  int zero, bits, parts;
  int32_t* part;      // n partitions
  int32_t* perm;      // n rows in bucket order
  int* n_live;        // the live count
};

// one column's values of rows r0 .. r0 + R - 1 widened as ab_widen_u64
// does; whole: all R rows lie below n.  Loads are issued together (16-byte
// words where the rows are aligned), so a thread pays one latency a column.
template <int R>
__device__ __forceinline__ void so_widen(const void* p, int kind, long long r0, long long n,
                                         bool whole, uint64_t (&x)[R]) {
  if (kind == AB_KIND_I64) {
    const long long* q = (const long long*)p + r0;
    if (whole && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(q) + k);
        x[2 * k] = (uint64_t)v.x;
        x[2 * k + 1] = (uint64_t)v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) x[k] = r0 + k < n ? (uint64_t)__ldg(q + k) : 0ULL;
    }
  } else if (kind == AB_KIND_I32) {
    const int* q = (const int*)p + r0;
    if (whole && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < R / 4; ++k) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(q) + k);
        x[4 * k] = (uint64_t)(int64_t)v.x;
        x[4 * k + 1] = (uint64_t)(int64_t)v.y;
        x[4 * k + 2] = (uint64_t)(int64_t)v.z;
        x[4 * k + 3] = (uint64_t)(int64_t)v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) x[k] = r0 + k < n ? (uint64_t)(int64_t)__ldg(q + k) : 0ULL;
    }
  } else {  // AB_KIND_BOOL
    const uint8_t* q = (const uint8_t*)p + r0;
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = r0 + k < n ? (uint64_t)(__ldg(q + k) != 0) : 0ULL;
  }
}

// byte k (k < R) of a word of R bucket bytes
template <int R>
__device__ __forceinline__ unsigned so_byte(const unsigned (&w)[R / 4], int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

// Rows r0 .. r0 + R - 1 (R = 4, 8 or 16): their partitions written out
// (16-byte stores where aligned) and their bucket bytes into w (SO_NONE
// past n); cnt gets the word's bucket counts, packed.
template <int R>
__device__ __forceinline__ void so_hash(const SoArgs& a, long long r0,
                                        unsigned long long (&cnt)[SO_Q], unsigned (&w)[R / 4]) {
  const bool whole = r0 + R <= a.n;
  uint64_t h[R];
#pragma unroll
  for (int k = 0; k < R; ++k) h[k] = 0ULL;
  if (!a.zero) {
    for (int j = 0; j < a.c.k; ++j) {
      uint64_t x[R];
      so_widen<R>(a.c.ptr[j], a.c.kind[j], r0, a.n, whole, x);
#pragma unroll
      for (int k = 0; k < R; ++k) h[k] = ab_hash_combine(h[k], x[k]);
    }
  }
  const uint64_t top = (1ULL << a.bits) - 1ULL;
  int p[R];
#pragma unroll
  for (int k = 0; k < R; ++k) p[k] = (int)((h[k] >> (64 - a.bits)) & top);
  int32_t* out = a.part + r0;
  if (whole && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k)
      reinterpret_cast<int4*>(out)[k] = make_int4(p[4 * k], p[4 * k + 1], p[4 * k + 2],
                                                  p[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < a.n) out[k] = p[k];
  }
  // the mask bytes: one load where aligned and whole
  unsigned m[R / 4];
  const uint8_t* q = a.mask + r0;
  if (whole && (reinterpret_cast<uintptr_t>(q) & (R - 1)) == 0) {
    if constexpr (R == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
      m[0] = v.x;
      m[1] = v.y;
      m[2] = v.z;
      m[3] = v.w;
    } else if constexpr (R == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
      m[0] = v.x;
      m[1] = v.y;
    } else {
      m[0] = __ldg(reinterpret_cast<const unsigned*>(q));
    }
  } else {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) m[k] = 0u;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < a.n) m[k >> 2] |= (unsigned)__ldg(q + k) << (8 * (k & 3));
  }
#pragma unroll
  for (int k = 0; k < R / 4; ++k) w[k] = 0u;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const unsigned bk = r0 + k >= a.n ? SO_NONE
                        : so_byte<R>(m, k) ? (unsigned)p[k] : (unsigned)(a.parts + p[k]);
    w[k >> 2] |= bk << (8 * (k & 3));
    const unsigned long long inc = bk == SO_NONE ? 0ULL : 1ULL << (16 * (bk & 3));
#pragma unroll
    for (int qq = 0; qq < SO_Q; ++qq) cnt[qq] += qq == (int)(bk >> 2) ? inc : 0ULL;
  }
}

// exclusive block scan of SO_Q packed words at once; tot gets the block's
// sums.  ws holds (T / 32) * SO_Q words.
template <int T>
__device__ __forceinline__ void so_block_scan(const unsigned long long (&v)[SO_Q],
                                              unsigned long long (&ex)[SO_Q],
                                              unsigned long long (&tot)[SO_Q],
                                              unsigned long long* ws) {
  constexpr int W = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x[SO_Q];
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) {
    x[q] = v[q];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, x[q], o);
      if (lane >= o) x[q] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < SO_Q; ++q) ws[warp * SO_Q + q] = x[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < SO_Q; ++q) {
      unsigned long long w = lane < W ? ws[lane * SO_Q + q] : 0ULL;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < W) ws[lane * SO_Q + q] = w;  // inclusive over warps
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) {
    ex[q] = (warp > 0 ? ws[(warp - 1) * SO_Q + q] : 0ULL) + x[q] - v[q];
    tot[q] = ws[(W - 1) * SO_Q + q];
  }
  __syncthreads();  // ws is the next round's
}

__device__ __forceinline__ unsigned so_field(const unsigned long long (&v)[SO_Q], unsigned b) {
  unsigned long long w = 0ULL;
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) w = q == (int)(b >> 2) ? v[q] : w;
  return (unsigned)(w >> (16 * (b & 3))) & 0xffffu;
}

// The placement of a round of R rows a thread whose counts are scanned: ex,
// the thread's exclusive prefix of each bucket over the block, tot the
// block's counts.
template <int T, int R>
__device__ __forceinline__ void so_place(const unsigned (&w)[R / 4], long long r0, int nb,
                                         const unsigned long long (&ex)[SO_Q],
                                         const unsigned long long (&tot)[SO_Q],
                                         int32_t* __restrict__ perm, int* stage,
                                         uint8_t* stage_b, long long* next, long long* dst) {
  unsigned long long base[SO_Q];
  // the round's bucket offsets: an exclusive prefix over the 16-bit fields
  // (a round's rows, at most R T, fit a field)
  unsigned long long carry = 0ULL;
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) {
    const unsigned long long t = tot[q];
    const unsigned long long incl = t + (t << 16) + (t << 32) + (t << 48);
    base[q] = incl - t + carry * 0x0001000100010001ULL;
    carry += incl >> 48;
  }
  if ((int)threadIdx.x < nb) {  // thread b: where the round's rows of bucket b go
    const unsigned b = threadIdx.x;
    dst[b] = next[b] - (long long)so_field(base, b);
    next[b] += (long long)so_field(tot, b);
  }
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) base[q] += ex[q];
  const long long r = r0 + (long long)threadIdx.x * R;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const unsigned bk = so_byte<R>(w, k);
    if (bk == SO_NONE) continue;
    const unsigned slot = so_field(base, bk);
    const unsigned long long inc = 1ULL << (16 * (bk & 3));
#pragma unroll
    for (int q = 0; q < SO_Q; ++q) base[q] += q == (int)(bk >> 2) ? inc : 0ULL;
    stage[cp_slot(slot)] = (int)(r + k);
    stage_b[slot] = (uint8_t)bk;
  }
  __syncthreads();
  const unsigned nv = (unsigned)carry;
  for (unsigned i = threadIdx.x; i < nv; i += T) perm[dst[stage_b[i]] + i] = stage[cp_slot(i)];
  __syncthreads();  // the stage and dst are the next round's
}

// next[b] = the start of bucket b + its rows in the tiles before t, from
// every tile's counts (tiles * nb words); tile 0 writes the live count.
// Thread (g, b) of 16 groups of 16 sums bucket b over the tiles g, g + 16,
// ..., eight loads in flight at a time (one at a time took the same time:
// 0.0175 against 0.0178 ms for the two launches at 524,288 rows on an
// H100); the groups are summed by shuffles and over the warps in red.
__device__ __forceinline__ void so_tile_starts(const unsigned* counts, long long tiles,
                                               long long t, int nb, int parts, int* n_live,
                                               long long* next,
                                               unsigned long long (*red)[2][SO_BUCKETS_MAX]) {
  constexpr int G = SO_THREADS / SO_BUCKETS_MAX;
  const int b = threadIdx.x % SO_BUCKETS_MAX, g = threadIdx.x / SO_BUCKETS_MAX;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long all = 0ULL, before = 0ULL;
  for (long long i0 = g; i0 < tiles; i0 += 8 * G) {
    unsigned v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long i = i0 + (long long)u * G;
      v[u] = b < nb && i < tiles ? __ldcg(counts + i * nb + b) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      all += v[u];
      before += i0 + (long long)u * G < t ? v[u] : 0u;
    }
  }
  all += __shfl_down_sync(0xffffffffu, all, 16);  // lanes l and l + 16 hold one bucket
  before += __shfl_down_sync(0xffffffffu, before, 16);
  if (lane < 16) {
    red[warp][0][lane] = all;
    red[warp][1][lane] = before;
  }
  __syncthreads();
  if (warp == 0) {  // lane b: bucket b's start, and this tile's first row of it
    unsigned long long sum = 0ULL, bef = 0ULL;
    if ((int)lane < nb) {
#pragma unroll
      for (int w = 0; w < SO_THREADS / 32; ++w) {
        sum += red[w][0][lane];
        bef += red[w][1][lane];
      }
    }
    unsigned long long incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if ((int)lane >= o) incl += y;
    }
    const unsigned long long live = __shfl_sync(0xffffffffu, incl, parts - 1);
    if ((int)lane < nb) next[lane] = (long long)(incl - sum + bef);
    if (t == 0 && lane == 0) *n_live = (int)live;
  }
  __syncthreads();
}

// One launch up to CP_ONE_ROWS rows: a cooperative grid of tiles of one
// round each.  counts: tiles * nb words, no initial value.
__global__ void __launch_bounds__(SO_THREADS) k16_spill_coop(SoArgs a, unsigned* counts) {
  constexpr int T = SO_THREADS;
  __shared__ int stage[CP_STAGE(T)];
  __shared__ uint8_t stage_b[16 * T];
  __shared__ unsigned long long ws[(T / 32) * SO_Q];
  __shared__ long long next[SO_BUCKETS_MAX], dst[SO_BUCKETS_MAX];
  __shared__ unsigned long long red[T / 32][2][SO_BUCKETS_MAX];
  cg::grid_group grid = cg::this_grid();
  const int nb = 2 * a.parts;
  const long long t = blockIdx.x, r0 = t * SO_CO_TILE;
  unsigned long long cnt[SO_Q], ex[SO_Q], tot[SO_Q];
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) cnt[q] = 0ULL;
  unsigned w[SO_CO_ROWS / 4];
  so_hash<SO_CO_ROWS>(a, r0 + SO_CO_ROWS * threadIdx.x, cnt, w);
  so_block_scan<T>(cnt, ex, tot, ws);  // ranks the round and counts the tile
  if ((int)threadIdx.x < nb) counts[t * nb + threadIdx.x] = so_field(tot, threadIdx.x);
  grid.sync();  // every tile's counts are out
  so_tile_starts(counts, gridDim.x, t, nb, a.parts, a.n_live, next, red);
  so_place<T, SO_CO_ROWS>(w, r0, nb, ex, tot, a.perm, stage, stage_b, next, dst);
}

// words: the tiles' bucket bytes (the scatter's input); counts: tiles * nb
// words.  No initial value: each tile writes its own.
__global__ void __launch_bounds__(SO_THREADS)
    k16_spill_count(SoArgs a, uint2* __restrict__ words, unsigned* __restrict__ counts) {
  __shared__ unsigned long long ws[(SO_THREADS / 32) * SO_Q];
  const int nb = 2 * a.parts;
  const long long t = blockIdx.x;
  unsigned long long cnt[SO_Q], ex[SO_Q], tot[SO_Q];
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) cnt[q] = 0ULL;
  unsigned w[SO_CO_ROWS / 4];
  so_hash<SO_CO_ROWS>(a, t * SO_CO_TILE + SO_CO_ROWS * threadIdx.x, cnt, w);
  words[t * SO_THREADS + threadIdx.x] = make_uint2(w[0], w[1]);
  so_block_scan<SO_THREADS>(cnt, ex, tot, ws);
  if ((int)threadIdx.x < nb) counts[t * nb + threadIdx.x] = so_field(tot, threadIdx.x);
}

// the tile's rows placed as k16_spill_coop places them, its bucket bytes
// from the count pass
__global__ void __launch_bounds__(SO_THREADS)
    k16_spill_scatter(SoArgs a, const uint2* __restrict__ words,
                      const unsigned* __restrict__ counts) {
  constexpr int T = SO_THREADS;
  __shared__ int stage[CP_STAGE(T)];
  __shared__ uint8_t stage_b[16 * T];
  __shared__ unsigned long long ws[(T / 32) * SO_Q];
  __shared__ long long next[SO_BUCKETS_MAX], dst[SO_BUCKETS_MAX];
  __shared__ unsigned long long red[T / 32][2][SO_BUCKETS_MAX];
  const int nb = 2 * a.parts;
  const long long t = blockIdx.x;
  const uint2 word = words[t * T + threadIdx.x];
  const unsigned w[SO_CO_ROWS / 4] = {word.x, word.y};
  so_tile_starts(counts, gridDim.x, t, nb, a.parts, a.n_live, next, red);
  unsigned long long cnt[SO_Q], ex[SO_Q], tot[SO_Q];
#pragma unroll
  for (int q = 0; q < SO_Q; ++q) cnt[q] = 0ULL;
#pragma unroll
  for (int k = 0; k < SO_CO_ROWS; ++k) {
    const unsigned bk = so_byte<SO_CO_ROWS>(w, k);
    const unsigned long long inc = bk == SO_NONE ? 0ULL : 1ULL << (16 * (bk & 3));
#pragma unroll
    for (int q = 0; q < SO_Q; ++q) cnt[q] += q == (int)(bk >> 2) ? inc : 0ULL;
  }
  so_block_scan<T>(cnt, ex, tot, ws);
  so_place<T, SO_CO_ROWS>(w, t * SO_CO_TILE, nb, ex, tot, a.perm, stage, stage_b, next, dst);
}

// --------------------------------------------------------------------------
// the C interface
// --------------------------------------------------------------------------

// words of a mask of n rows at the worst shift
static inline long long cp_words(long long n, int shift) { return (n + shift + 15) >> 4; }

// The one-launch form over nwords words: words a block (a multiple of
// CP_ONE_THREADS, the rounds spread evenly over at most CP_CLUSTER blocks)
// and its dynamic shared memory.
static inline long long cp_one_block_words(long long nwords) {
  const long long per = (nwords + CP_ONE_THREADS - 1) / CP_ONE_THREADS;  // rounds in all
  const long long c0 = per < CP_CLUSTER ? per : CP_CLUSTER;
  return (per + c0 - 1) / c0 * CP_ONE_THREADS;
}
static inline size_t cp_one_smem(long long wb) {
  return (size_t)wb * 16 + (size_t)CP_STAGE(CP_ONE_THREADS) * sizeof(int);
}

// Launches a call of n rows takes: 1 up to CP_ONE_ROWS, else 2.
AB_EXPORT int ab_compact_launches(long long n) { return n <= CP_ONE_ROWS ? 1 : 2; }

// int64 status words of the two-launch form
AB_EXPORT long long ab_compact_tiles(long long n) { return (n + 15 + CP_TILE - 1) / CP_TILE; }

// perm: int32[n]; n_live: int32[1], receives the live count; status:
// int64[ab_compact_tiles(n)] (two launches only, no initial value); acc:
// the per-stream uint64[2] accumulator, zero on entry and on exit.
AB_EXPORT int ab_compaction_order(const void* mask, long long n, void* perm, void* n_live,
                                  void* status, void* acc, void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  const int shift = (int)(addr & 15);
  const uint4* words = reinterpret_cast<const uint4*>(addr - shift);
  const long long nwords = cp_words(n, shift);
  if (ab_compact_launches(n) == 1) {
    static AbSmemLimit limit;  // the largest call's shared memory, set once a device
    int err = ab_smem_limit(k2_compact_one,
                            (int)cp_one_smem(cp_one_block_words(cp_words(CP_ONE_ROWS, 15))),
                            limit);
    if (err) return err;
    const long long wb = cp_one_block_words(nwords);
    const unsigned blocks = (unsigned)((nwords + wb - 1) / wb);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(CP_ONE_THREADS, 1, 1);
    cfg.dynamicSmemBytes = cp_one_smem(wb);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(&cfg, k2_compact_one, words, shift, n, wb, (int32_t*)perm,
                                  (int*)n_live);
    if (err) return err;
    return ab_last_error();
  }
  const long long tiles = (nwords + CP_ROUNDS * CP_THREADS - 1) / (CP_ROUNDS * CP_THREADS);
  k2_compact_count<<<(unsigned)tiles, CP_THREADS, 0, s>>>(
      words, shift, n, (unsigned long long*)status, (unsigned long long*)acc, (int*)n_live);
  int err = ab_last_error();
  if (err) return err;
  k2_compact_scatter<<<(unsigned)tiles, CP_THREADS, 0, s>>>(
      words, shift, n, (unsigned long long*)status, (const int*)n_live, (int32_t*)perm);
  return ab_last_error();
}

// K16's launches for n rows: 1 up to CP_ONE_ROWS, else 2.
AB_EXPORT int ab_spill_launches(long long n) { return n <= CP_ONE_ROWS ? 1 : 2; }

// The scratch of a call of n rows: one launch, the tiles' counts (tiles *
// 2 * parts words); two, the tiles' bucket bytes, then tiles * 2 * parts
// counts.  No initial value: each form writes what it reads.
AB_EXPORT long long ab_spill_scratch_bytes(long long n, int parts) {
  const long long tiles = (n + SO_CO_TILE - 1) / SO_CO_TILE;
  return (ab_spill_launches(n) == 1 ? 0 : tiles * SO_CO_TILE) + 4 * tiles * 2 * parts;
}

// ptrs / kinds / k: the key columns (as K3 takes them); mask: bool[n];
// zero: forced collisions (every hash 0); bits: log2 of the partitions, 1
// to 3; part: int32[n]; perm: int32[n]; n_live: int32[1]; scratch:
// ab_spill_scratch_bytes(n, parts) bytes, 16-byte aligned.
AB_EXPORT int ab_spill_order(const void* const* ptrs, const int* kinds, int k, const void* mask,
                             long long n, int zero, int bits, void* part, void* perm,
                             void* n_live, void* scratch, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || bits < 1 || bits > 3) return (int)cudaErrorInvalidValue;
  SoArgs a;
  int err = ab_fill_hash_cols(&a.c, ptrs, kinds, k);
  if (err) return err;
  a.mask = (const uint8_t*)mask;
  a.n = n;
  a.zero = zero;
  a.bits = bits;
  a.parts = 1 << bits;
  a.part = (int32_t*)part;
  a.perm = (int32_t*)perm;
  a.n_live = (int*)n_live;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (ab_spill_launches(n) == 1) {
    const unsigned tiles = (unsigned)((n + SO_CO_TILE - 1) / SO_CO_TILE);
    unsigned* counts = (unsigned*)scratch;
    void* params[] = {&a, &counts};
    err = (int)cudaLaunchCooperativeKernel((const void*)k16_spill_coop, dim3(tiles),
                                           dim3(SO_THREADS), params, 0, s);
    if (err) return err;
    return ab_last_error();
  }
  const long long tiles = (n + SO_CO_TILE - 1) / SO_CO_TILE;
  uint2* words = (uint2*)scratch;
  unsigned* counts = (unsigned*)((char*)scratch + tiles * SO_CO_TILE);
  k16_spill_count<<<(unsigned)tiles, SO_THREADS, 0, s>>>(a, words, counts);
  err = ab_last_error();
  if (err) return err;
  k16_spill_scatter<<<(unsigned)tiles, SO_THREADS, 0, s>>>(a, words, counts);
  return ab_last_error();
}
