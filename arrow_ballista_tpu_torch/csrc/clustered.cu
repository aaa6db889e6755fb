// K9-K11: the kernels of the clustered (presorted) partial aggregate, the
// grouping that q18's subquery takes over key-clustered parquet
// (scheduler/physical_planner.py _clustered_having_pushdown).
//
// K9 presorted_disorder replaces the disorder flag of
// arrow_ballista_tpu/ops/kernels.py grouped_aggregate_presorted (l.237):
//   disorder = any(live[i] & live[i-1] & k[i] < k[i-1]) over the rows in
//   K2's compaction order.  That order is stable and puts the live rows
//   first, so the flag is True exactly when the live keys, in row order,
//   ever decrease (consecutive live rows compared across dead ones): K9
//   reads the rows as they are, with no order or gather.  A lane holds 8
//   rows in K10's layout (below); its words interleave across the warp, so
//   word by word each lane compares its first live key with the last live
//   key of the nearest lower lane that has one (a ballot, then a shuffle
//   from that lane), or of the words before.  The block folds its warps in
//   order into a tile record: whether the tile has a live row, its first
//   and last live key and whether it found a decrease inside.  The block
//   that draws the last ticket folds the records in tile order (a tile's
//   first live key below the last live key of the previous tile that has
//   one is a disorder) and writes the flag.  Keys are read only for words
//   that hold a live row.
// K10 key_range_check replaces "sort.range_check"
// (arrow_ballista_tpu/ops/operators.py:632-654):
//   live = mask & (k != NULL sentinel, when the key is nullable);
//   mismatch = any(live) & (min(k over live) < lo | max(k over live) > hi).
//   That is the OR over rows of live & (k < lo | k > hi): a live row
//   outside [lo, hi] is a live minimum below lo or maximum above hi, and
//   conversely.  So K10 folds one predicated bool a row, __syncthreads_or
//   folds a block, and no min or max is kept.
// K11 clustered_keep replaces "agg.clustered_keep" (operators.py:672-697):
//   keep = mask & (any_j(lo_j <= k <= hi_j) | pred); live = sum(keep).
//   The wrapper hands the kernel the sorted, disjoint union of the
//   non-empty intervals (ops/kernels.py KeepIntervals, merged on the host
//   once per operator): the same set, so the same keep mask.  A row's key
//   is in the union when it is at or below the end of the last interval
//   starting at or below it.  A lane finds that interval for the lowest
//   and the highest of its keys that need the test (live, HAVING false)
//   by binary search over the merged starts; a clustered partial's keys,
//   in key order, mostly share it, and then each row needs one compare.
//   Else each row searches only the starts between the two (ab_in_union).
//   Up to AB_KEEP_SMEM_PAIRS pairs sit in shared memory; more are searched
//   in device memory through L1 (the same code, another pointer).  K11
//   reads a word of keys only where a row of it needs the test: a padded
//   partial's dead tail (most of the main path's rows) reads none.
// All three kernels: a block takes a tile of AB_CL_TILE rows (K9: two warp
// tiles a warp, AB_K9_TILE rows), a lane 8 of them a warp tile as 16-byte
// words of keys (2 int64 or 4 int32 rows a word) and the
// matching 2- or 4-byte integers of mask, pred and keep, laid out so that
// every load and store of a warp is contiguous (ab_load_lane); a lane's
// 8 interval searches run interleaved.  The grid covers the rows once.
// The last, partial warp tile, and inputs not so aligned (views at a byte
// offset), go row by row in the same layout.  One launch a call and no
// memset: each block folds its partial (K10 the flag, K11 the count) into
// a per-stream accumulator, or writes its record (K9) into a per-stream
// state, and the block that draws the last ticket (ab_last_block,
// common.cuh) writes the result and resets the accumulator or the ticket; a
// call with no rows launches one block that does just that.
// Keys are int32 (widened, as the reference's astype(int64)) or int64.
// Bound: bytes (keys, mask and predicate read once, the keep bytes written
// once; K9 the mask and the live rows' keys).  K11 also does at most n x
// (log2 m + 1) compares: far under the card's integer rate at the main
// path's at most a few thousand intervals.
#include <limits.h>

#include "common.cuh"

#define AB_CL_THREADS 256
#define AB_CL_ROWS 8  // rows a lane
#define AB_CL_TILE (AB_CL_THREADS * AB_CL_ROWS)
#define AB_KEEP_SMEM_PAIRS 2048  // merged intervals in shared memory (32 KB)

// A lane takes AB_CL_ROWS rows as AB_CL_ROWS / R 16-byte words of keys, R
// rows a word (R = 2 for int64, 4 for int32): word j of lane l of warp w
// holds rows tile + w * AB_CL_WARP_ROWS + (j * 32 + l) * R .. + R - 1, so
// each load of a warp reads 512 contiguous bytes of keys and 32 R
// contiguous bytes of mask (of pred), one R-byte integer a lane, and each
// store writes 32 R contiguous bytes of keep.
#define AB_CL_WARP_ROWS (32 * AB_CL_ROWS)

template <int R> struct ClBytes;  // R bool bytes as one unsigned integer
template <> struct ClBytes<2> { using U = unsigned short; };
template <> struct ClBytes<4> { using U = unsigned int; };

// key q of a 16-byte word of R = 16 / sizeof(T) keys, widened
template <typename T>
__device__ __forceinline__ long long ab_word_key(const uint4& w, int q) {
  if constexpr (sizeof(T) == 8)
    return q == 0 ? (long long)(((unsigned long long)w.y << 32) | w.x)
                  : (long long)(((unsigned long long)w.w << 32) | w.z);
  else
    return (long long)(int)(q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w);
}

__device__ __forceinline__ bool ab_aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A lane's rows, from 16-byte words where the warp's whole tile is in range
// and every pointer aligned: v the widened keys, bit r of *live / *pred
// row r's mask / predicate (pred may be null).  SPARSE reads a word of
// keys only where a row of it is live with its predicate false (bool
// bytes: mask & ~pred is 0 exactly where no row is); v is 0 elsewhere.
template <typename T, bool SPARSE>
__device__ __forceinline__ void ab_load_lane(const T* __restrict__ k,
                                             const uint8_t* __restrict__ mask,
                                             const uint8_t* __restrict__ pred, long long wbase,
                                             int lane, long long (&v)[AB_CL_ROWS],
                                             unsigned* live, unsigned* predbits) {
  constexpr int R = 16 / sizeof(T), W = AB_CL_ROWS / R;
  using U = typename ClBytes<R>::U;
  uint4 kw[W];
  U mw[W], pw[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const long long r0 = wbase + (long long)(j * 32 + lane) * R;
    mw[j] = __ldg(reinterpret_cast<const U*>(mask + r0));
    pw[j] = pred ? __ldg(reinterpret_cast<const U*>(pred + r0)) : (U)0;
    if (!SPARSE) kw[j] = __ldg(reinterpret_cast<const uint4*>(k + r0));
  }
  if (SPARSE) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long r0 = wbase + (long long)(j * 32 + lane) * R;
      kw[j] = (mw[j] & ~pw[j]) ? __ldg(reinterpret_cast<const uint4*>(k + r0))
                               : make_uint4(0, 0, 0, 0);
    }
  }
  unsigned lb = 0, pb = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v[j * R + q] = ab_word_key<T>(kw[j], q);
      lb |= (unsigned)(((mw[j] >> (8 * q)) & 0xffu) != 0) << (j * R + q);
      pb |= (unsigned)(((pw[j] >> (8 * q)) & 0xffu) != 0) << (j * R + q);
    }
  }
  *live = lb;
  *predbits = pb;
}

// row r of a lane (0 <= r < AB_CL_ROWS), as ab_load_lane lays them out
template <typename T>
__device__ __forceinline__ long long ab_lane_row(long long wbase, int lane, int r) {
  constexpr int R = 16 / sizeof(T);
  return wbase + (long long)((r / R) * 32 + lane) * R + r % R;
}

// K9's fold of rows in order: whether a row is live, the first and the
// last live key, and whether a live key fell below the live key before it
struct ClOrder {
  int has, bad;
  long long first, last;
};

// a's rows, then b's
__device__ __forceinline__ ClOrder ab_order_then(const ClOrder& a, const ClOrder& b) {
  if (!a.has) return {b.has, a.bad | b.bad, b.first, b.last};
  if (!b.has) return {a.has, a.bad | b.bad, a.first, a.last};
  return {1, a.bad | b.bad | (b.first < a.last ? 1 : 0), a.first, b.last};
}

// The block's partial folds, one a thread in row order (K9's last block),
// folded in order into thread 0's return value: each lane takes the lane above it at 1, 2,
// 4, 8 and 16, so lane 0 ends with the warp's 32 in order; then thread 0
// takes the warps in order.
__device__ __forceinline__ ClOrder ab_block_order(ClOrder x, ClOrder* warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    ClOrder y;
    y.has = __shfl_down_sync(0xffffffffu, x.has, o);
    y.bad = __shfl_down_sync(0xffffffffu, x.bad, o);
    y.first = __shfl_down_sync(0xffffffffu, x.first, o);
    y.last = __shfl_down_sync(0xffffffffu, x.last, o);
    if (lane + o < 32) x = ab_order_then(x, y);
  }
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < AB_CL_THREADS / 32; ++w) x = ab_order_then(x, warps[w]);
  return x;
}

#define AB_K9_RECORD 3  // a tile's record: flags (1 a live row, 2 a decrease inside), first, last
#define AB_K9_SUB 2     // consecutive warp tiles a warp (their loads in flight together)
#define AB_K9_TILE (AB_CL_TILE * AB_K9_SUB)

// grid: one block a AB_K9_TILE rows, at least one; state: int64[1 +
// AB_K9_RECORD * grid], the stream's: a ticket (zero between launches,
// reset by the last block), then one record a tile (written before read)
template <typename T>
__global__ void __launch_bounds__(AB_CL_THREADS)
    k9_disorder(const T* __restrict__ k, const uint8_t* __restrict__ mask, long long n,
                uint8_t* __restrict__ flag, long long* __restrict__ state) {
  constexpr int R = 16 / sizeof(T), W = AB_CL_ROWS / R;
  __shared__ ClOrder warps[AB_CL_THREADS / 32];
  __shared__ int last_block;
  const int lane = threadIdx.x & 31;
  const long long wbase0 = (long long)blockIdx.x * AB_K9_TILE +
                           (threadIdx.x >> 5) * (long long)(AB_CL_WARP_ROWS * AB_K9_SUB);
  long long v[AB_K9_SUB][AB_CL_ROWS];
  unsigned live[AB_K9_SUB];
#pragma unroll
  for (int u = 0; u < AB_K9_SUB; ++u) {
    const long long wbase = wbase0 + u * AB_CL_WARP_ROWS;
    live[u] = 0;
    if (ab_aligned(k, 16) && ab_aligned(mask, R) && wbase + AB_CL_WARP_ROWS <= n) {
      unsigned unused;
      ab_load_lane<T, true>(k, mask, nullptr, wbase, lane, v[u], &live[u], &unused);
    } else {  // the last warp tile, or an input at a byte offset: row by row
#pragma unroll
      for (int r = 0; r < AB_CL_ROWS; ++r) {
        const long long i = ab_lane_row<T>(wbase, lane, r);
        v[u][r] = 0;
        if (i < n && mask[i]) {
          live[u] |= 1u << r;
          v[u][r] = (long long)k[i];
        }
      }
    }
  }
  // word by word (each a run of 32 R rows over the lanes), the warp's
  // rows so far in w (the same in every lane)
  ClOrder w = {0, 0, 0, 0};
  int bad = 0;
#pragma unroll
  for (int u = 0; u < AB_K9_SUB; ++u) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      int has = 0;
      long long first = 0, lastk = 0;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = j * R + q;
        if ((live[u] >> r) & 1u) {
          if (has) bad |= v[u][r] < lastk ? 1 : 0;
          else first = v[u][r];
          lastk = v[u][r];
          has = 1;
        }
      }
      const unsigned ball = __ballot_sync(0xffffffffu, has);
      const unsigned lower = ball & ((1u << lane) - 1u);
      const long long before = __shfl_sync(0xffffffffu, lastk, lower ? 31 - __clz(lower) : 0);
      if (has) bad |= (lower ? first < before : (w.has && first < w.last)) ? 1 : 0;
      if (ball) {  // the same in every lane
        const long long f = __shfl_sync(0xffffffffu, first, __ffs(ball) - 1);
        const long long l = __shfl_sync(0xffffffffu, lastk, 31 - __clz(ball));
        if (!w.has) w.first = f;
        w.last = l;
        w.has = 1;
      }
    }
  }
  w.bad = __any_sync(0xffffffffu, bad) ? 1 : 0;
  // the warps in order (each lane holds its warp's fold)
  if (lane == 0) warps[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    ClOrder tile = warps[0];
    for (int i = 1; i < AB_CL_THREADS / 32; ++i) tile = ab_order_then(tile, warps[i]);
    long long* rec = state + 1 + (long long)AB_K9_RECORD * blockIdx.x;
    rec[0] = tile.has | (tile.bad << 1);
    rec[1] = tile.first;
    rec[2] = tile.last;
    last_block = ab_last_block(reinterpret_cast<unsigned long long*>(state)) ? 1 : 0;
  }
  __syncthreads();
  if (!last_block) return;
  // the last block: every tile's record in tile order, a contiguous run a
  // thread, then the threads in order
  const long long tiles = gridDim.x;
  const long long per = (tiles + AB_CL_THREADS - 1) / AB_CL_THREADS;
  const long long t0 = min(tiles, (long long)threadIdx.x * per), t1 = min(tiles, t0 + per);
  ClOrder x = {0, 0, 0, 0};
  for (long long t = t0; t < t1; ++t) {
    const long long* rec = state + 1 + AB_K9_RECORD * t;
    const long long f = __ldcg(rec);
    const ClOrder o = {(int)(f & 1), (int)((f >> 1) & 1), __ldcg(rec + 1), __ldcg(rec + 2)};
    x = ab_order_then(x, o);
  }
  __syncthreads();  // warps[] was read by thread 0 above
  x = ab_block_order(x, warps);
  if (threadIdx.x == 0) {
    *flag = x.bad ? 1 : 0;
    state[0] = 0;  // the ticket, for the next launch on this stream
  }
}

template <typename T>
__global__ void __launch_bounds__(AB_CL_THREADS)
    key_range_check(const T* __restrict__ k, const uint8_t* __restrict__ mask, long long n,
                    int has_sentinel, long long sentinel, long long lo, long long hi,
                    uint8_t* __restrict__ flag, unsigned long long* __restrict__ acc) {
  constexpr int R = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long wbase = (long long)blockIdx.x * AB_CL_TILE + (threadIdx.x >> 5) * AB_CL_WARP_ROWS;
  bool bad = false;
  if (ab_aligned(k, 16) && ab_aligned(mask, R) && wbase + AB_CL_WARP_ROWS <= n) {
    long long v[AB_CL_ROWS];
    unsigned live, unused;
    ab_load_lane<T, false>(k, mask, nullptr, wbase, lane, v, &live, &unused);
#pragma unroll
    for (int r = 0; r < AB_CL_ROWS; ++r) {
      const bool lv = ((live >> r) & 1u) && !(has_sentinel && v[r] == sentinel);
      bad |= lv & ((v[r] < lo) | (v[r] > hi));
    }
  } else {  // the last warp tile, or an input at a byte offset: row by row
    for (int r = 0; r < AB_CL_ROWS; ++r) {
      const long long i = ab_lane_row<T>(wbase, lane, r);
      if (i >= n) continue;
      const long long x = (long long)k[i];
      const bool lv = mask[i] != 0 && !(has_sentinel && x == sentinel);
      bad |= lv & ((x < lo) | (x > hi));
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (bad) atomicOr(acc, 1ULL);
    if (ab_last_block(acc + 1)) {
      *flag = atomicExch(acc, 0ULL) != 0;
      acc[1] = 0;
    }
  }
}

// Bit r set where row r's key v[r] (a row with bit r of need) lies in the
// sorted, disjoint union of [s[j], e[j]], j < m.  A key's interval is the
// last one starting at or below it: pos(k) = how many starts are <= k.
// First pos of the lowest and the highest needed key, a and b, by steps of
// top, top/2, .., 1 (top the largest power of two <= m); every needed key's
// pos lies in [a, b].  When a == b (a clustered partial's keys in key
// order: a lane's rows lie within 256 neighbours, mostly between two
// windows) each row needs one compare with e[a - 1].  Else each row
// searches only the starts in (a, b], the rows' steps interleaved.
template <int ROWS>
__device__ __forceinline__ unsigned ab_in_union(const long long* s, const long long* e, int m,
                                                int top, const long long (&v)[ROWS],
                                                unsigned need) {
  long long lo = LLONG_MAX, hi = LLONG_MIN;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool x = (need >> r) & 1u;
    lo = x && v[r] < lo ? v[r] : lo;
    hi = x && v[r] > hi ? v[r] : hi;
  }
  int a = 0, b = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int na = a + step, nb = b + step;
    if (na <= m && s[na - 1] <= lo) a = na;
    if (nb <= m && s[nb - 1] <= hi) b = nb;
  }
  unsigned hit = 0;
  if (a == b) {
    if (a == 0) return 0u;  // no window starts at or below any needed key
    const long long end = e[a - 1];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) hit |= (unsigned)(v[r] <= end) << r;
    return hit & need;
  }
  int pos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) pos[r] = a;
  for (int step = 1 << (31 - __clz(b - a)); step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int nxt = pos[r] + step;
      if (nxt <= b && s[nxt - 1] <= v[r]) pos[r] = nxt;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) hit |= (unsigned)(pos[r] > 0 && v[r] <= e[pos[r] - 1]) << r;
  return hit & need;
}

template <typename T>
__global__ void __launch_bounds__(AB_CL_THREADS)
    clustered_keep(const T* __restrict__ k, const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ pred, long long n,
                   const long long* __restrict__ starts, const long long* __restrict__ ends,
                   int m, uint8_t* __restrict__ keep, long long* __restrict__ live,
                   unsigned long long* __restrict__ acc) {
  constexpr int R = 16 / sizeof(T), W = AB_CL_ROWS / R;
  using U = typename ClBytes<R>::U;
  extern __shared__ long long s_iv[];  // the merged starts, then their ends
  __shared__ unsigned warp_live[AB_CL_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wbase = (long long)blockIdx.x * AB_CL_TILE + warp * AB_CL_WARP_ROWS;
  const bool vec = ab_aligned(k, 16) && ab_aligned(mask, R) && ab_aligned(pred, R) &&
                   ab_aligned(keep, R) && wbase + AB_CL_WARP_ROWS <= n;
  // the lane's loads are issued before the block waits on the intervals
  long long v[AB_CL_ROWS];
  unsigned lb = 0, pb = 0;
  if (vec) ab_load_lane<T, true>(k, mask, pred, wbase, lane, v, &lb, &pb);
  const long long* s = starts;
  const long long* e = ends;
  if (m <= AB_KEEP_SMEM_PAIRS) {
    for (int j = threadIdx.x; j < m; j += AB_CL_THREADS) {
      s_iv[j] = starts[j];
      s_iv[m + j] = ends[j];
    }
    __syncthreads();
    s = s_iv;
    e = s_iv + m;
  }
  const int top = m > 0 ? 1 << (31 - __clz(m)) : 0;
  unsigned count = 0;
  if (vec) {
    // live rows whose predicate fails need the search; a padded partial's
    // dead tail needs none
    const unsigned need = lb & ~pb;
    const unsigned hit = need ? ab_in_union<AB_CL_ROWS>(s, e, m, top, v, need) : 0u;
    const unsigned kp = lb & (pb | hit);
    count = __popc(kp);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      U out = 0;
#pragma unroll
      for (int q = 0; q < R; ++q) out |= (U)(((kp >> (j * R + q)) & 1u) << (8 * q));
      *reinterpret_cast<U*>(keep + wbase + (long long)(j * 32 + lane) * R) = out;
    }
  } else {  // the last warp tile, or an input at a byte offset: row by row
    for (int r = 0; r < AB_CL_ROWS; ++r) {
      const long long i = ab_lane_row<T>(wbase, lane, r);
      if (i >= n) continue;
      const long long x[1] = {(long long)k[i]};
      const bool kp = mask[i] != 0 && (pred[i] != 0 || ab_in_union<1>(s, e, m, top, x, 1u));
      keep[i] = kp;
      count += kp;
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_live[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = __reduce_add_sync(0xffffffffu, lane < AB_CL_THREADS / 32 ? warp_live[lane] : 0u);
    if (lane == 0) {
      if (count) atomicAdd(acc, (unsigned long long)count);
      if (ab_last_block(acc + 1)) {
        *live = (long long)atomicExch(acc, 0ULL);
        acc[1] = 0;
      }
    }
  }
}

static inline bool key_kind_ok(int kind) { return kind == AB_KIND_I32 || kind == AB_KIND_I64; }

static inline int ab_cl_grid(long long n, unsigned* grid) {
  const long long tiles = (n + AB_CL_TILE - 1) / AB_CL_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = tiles > 0 ? (unsigned)tiles : 1u;  // no rows: one block writes the result
  return 0;
}

// int64 words of K9's per-stream state for n rows: a ticket and one
// record a tile
AB_EXPORT long long ab_disorder_state_words(long long n) {
  const long long tiles = (n + AB_K9_TILE - 1) / AB_K9_TILE;
  return 1 + AB_K9_RECORD * (tiles > 0 ? tiles : 1);
}

// k: int32 or int64[n] (kind); mask: bool[n]; flag: bool[1]; state:
// int64[ab_disorder_state_words(n)], the stream's, its first word zero
// between launches
AB_EXPORT int ab_presorted_disorder(const void* k, int kind, const void* mask, long long n,
                                    void* flag, void* state, void* stream) {
  if (n < 0 || !key_kind_ok(kind) || state == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + AB_K9_TILE - 1) / AB_K9_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = tiles > 0 ? (unsigned)tiles : 1u;  // fewer than two rows: one block
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == AB_KIND_I32)
    k9_disorder<int32_t><<<grid, AB_CL_THREADS, 0, s>>>((const int32_t*)k, (const uint8_t*)mask,
                                                        n, (uint8_t*)flag, (long long*)state);
  else
    k9_disorder<int64_t><<<grid, AB_CL_THREADS, 0, s>>>((const int64_t*)k, (const uint8_t*)mask,
                                                        n, (uint8_t*)flag, (long long*)state);
  return ab_last_error();
}

// flag: bool[1]; sentinel ignored unless has_sentinel; acc: uint64[2], the
// stream's accumulator and ticket, zero between launches
AB_EXPORT int ab_key_range_check(const void* k, int kind, const void* mask, long long n,
                                 int has_sentinel, long long sentinel, long long lo,
                                 long long hi, void* flag, void* acc, void* stream) {
  if (n < 0 || !key_kind_ok(kind) || acc == nullptr) return (int)cudaErrorInvalidValue;
  unsigned grid;
  int err = ab_cl_grid(n, &grid);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == AB_KIND_I32)
    key_range_check<int32_t><<<grid, AB_CL_THREADS, 0, s>>>(
        (const int32_t*)k, (const uint8_t*)mask, n, has_sentinel, sentinel, lo, hi,
        (uint8_t*)flag, (unsigned long long*)acc);
  else
    key_range_check<int64_t><<<grid, AB_CL_THREADS, 0, s>>>(
        (const int64_t*)k, (const uint8_t*)mask, n, has_sentinel, sentinel, lo, hi,
        (uint8_t*)flag, (unsigned long long*)acc);
  return ab_last_error();
}

// pred, keep: bool[n]; starts, ends: int64[m], sorted disjoint intervals;
// live: int64[1]; acc: as for ab_key_range_check
AB_EXPORT int ab_clustered_keep(const void* k, int kind, const void* mask, const void* pred,
                                long long n, const void* starts, const void* ends, int m,
                                void* keep, void* live, void* acc, void* stream) {
  if (n < 0 || m < 0 || !key_kind_ok(kind) || acc == nullptr) return (int)cudaErrorInvalidValue;
  unsigned grid;
  int err = ab_cl_grid(n, &grid);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = m <= AB_KEEP_SMEM_PAIRS ? (size_t)m * 2 * sizeof(long long) : 0;
  if (kind == AB_KIND_I32)
    clustered_keep<int32_t><<<grid, AB_CL_THREADS, smem, s>>>(
        (const int32_t*)k, (const uint8_t*)mask, (const uint8_t*)pred, n,
        (const long long*)starts, (const long long*)ends, m, (uint8_t*)keep, (long long*)live,
        (unsigned long long*)acc);
  else
    clustered_keep<int64_t><<<grid, AB_CL_THREADS, smem, s>>>(
        (const int64_t*)k, (const uint8_t*)mask, (const uint8_t*)pred, n,
        (const long long*)starts, (const long long*)ends, m, (uint8_t*)keep, (long long*)live,
        (unsigned long long*)acc);
  return ab_last_error();
}

