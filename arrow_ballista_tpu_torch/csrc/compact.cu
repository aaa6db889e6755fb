// K2: compaction_order — stable permutation that moves live rows first.
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
