// K8: grouped_on_order — grouped aggregation over rows in group order
// through a permutation (the sort path of grouped_aggregate).
//
// Replaces arrow_ballista_tpu/ops/kernels.py _grouped_aggregate_on_order
// (l.314), which grouped_aggregate (l.266) runs after the K4 sort order (or
// the K2 compaction order when there are no keys): the "agg.grouped"
// program of HashAggregateExec for keys without a dense domain and for
// every global aggregate.  Per the reference:
//   boundary[i] = live[i] & (i == 0 | any key differs from row i-1), or,
//   with no keys, (i == 0) & any(live);
//   seg = cumsum(boundary) - 1; num_groups = sum(boundary);
//   a row adds to slot seg when it is live and 0 <= seg < out_capacity;
//   sums and counts start at 0, min at the type's max, max at its min;
//   each group's first row writes its keys; out_mask = slot <
//   min(num_groups, out_capacity).
// Dead rows may lie anywhere: a live row whose key equals its dead
// neighbour's opens no group, and rows before the first boundary belong to
// segment -1, which is dropped.  int64 sums and counts wrap mod 2^64 and
// int32 sums mod 2^32 (as XLA's segment_sum does), so they are exact in any
// order; float min and max propagate NaN; float sums are taken in the
// kernel's fixed tile order, which differs from the twin's.
//
// Row i of the grouping is row order[i] (int32[n], K4's or K2's
// permutation) of the keys, values and mask as the caller holds them: the
// gathers that would write each column in group order are not needed.
//
// Bound: bytes (the mask, keys and values read once, the slots written
// once).  Done in passes, the grouping takes seven launches (init,
// boundary flags, a three-launch scan, one atomic a row and aggregate, the
// mask), writes the flags and segment ids to device memory and reads them
// back, and serialises the atomics of a group's neighbouring rows on one
// address.
//
// Design: one persistent kernel (k8_seg_fused) and a fill kernel for the
// slots past the last group; no memset, no atomic on a value.
//   * Blocks take tiles of SG_TILE rows from an atomic counter, a thread
//     SG_ITEMS neighbouring rows, every load of a thread issued before any
//     is used (rows past the last read the last).  A thread computes its
//     rows' boundary flags in registers (each row against the row before
//     it, the tile's first row against the previous tile's last); a block
//     scan of the flag counts gives each thread's first segment within the
//     tile.  A tile is a chain of dependent latencies (tile counter, loads,
//     barriers, look-back): timed on the H100 (PERF.md row 8a), 2,048-row
//     tiles of 256 threads beat 1,024- and 4,096-row tiles and 128- or
//     512-thread blocks at the 1M-3M-row shapes (1,024-row tiles won at
//     q3's 4,096 rows).
//   * Reduce-by-key across tiles: a tile's state is its boundary count and
//     the fold of its trailing segment (the rows after its last boundary;
//     the whole tile when it has none), one value per aggregate.  Tiles
//     publish it in per-tile status words and payloads; decoupled
//     look-back (a warp reading 32 earlier tiles' words at a time) gives
//     the tile its first segment id (the counts up to the nearest
//     inclusive word) and the carried fold of the open segment (the
//     payloads up to the nearest tile with a boundary): lane q loads tile
//     near - q's folds and a warp reduction folds each aggregate, so a
//     window of 32 tiles costs one round of loads (a global aggregate's
//     tiles have no boundary, and its look-backs walk back to the nearest
//     inclusive word).
//   * A segment is written once, with plain stores, by the tile that holds
//     its end: the values before the tile's last boundary fold by a
//     thread-level pass and a block-level segmented scan (the carry enters
//     at the tile's head); the values after it were the tile's published
//     fold, and become the next tiles' carry.  The segments that close in
//     a tile, and the groups that open in it, are consecutive slots: each
//     column goes through shared memory and out in contiguous stores (a
//     thread's groups lie a few slots from its neighbours', so direct
//     stores spread a warp's 8-byte writes over 32 sectors).  The last
//     tile writes the final segment from its inclusive fold.
//   * Status words, the tile counter and the done-ticket live in a
//     per-(device, stream) state buffer that the block drawing the last
//     ticket resets (common.cuh ab_last_block), so the next call needs no
//     memset.  The folds live in a second per-stream buffer that needs no
//     reset: a fold is read only after the status word that a release
//     store published behind it (an acquire load; a lane's word orders the
//     other lanes' reads through __syncwarp).  Kept apart, no call's folds
//     lie where a later call with more tiles expects zero status words.
//     The last tile writes the group count; k8_seg_fill reads it on the
//     device and writes the identities, zero keys and false mask bits of
//     the slots past it.
#include <type_traits>

#include "common.cuh"

#define SEG_MAX_KEYS 8
#define SEG_MAX_AGGS 32
#define SEG_SUM 0
#define SEG_COUNT 1
#define SEG_MIN 2
#define SEG_MAX 3

struct SegSpec {
  const void* key[SEG_MAX_KEYS];
  int key_kind[SEG_MAX_KEYS];
  void* key_out[SEG_MAX_KEYS];
  int k;
  const void* val[SEG_MAX_AGGS];
  int val_kind[SEG_MAX_AGGS];  // kind of the value and of its output; count: AB_KIND_I64
  int how[SEG_MAX_AGGS];
  void* val_out[SEG_MAX_AGGS];
  int m;
};

#define SG_THREADS 256
#define SG_WARPS (SG_THREADS / 32)
#define SG_ITEMS 8                        // rows a thread
#define SG_TILE (SG_THREADS * SG_ITEMS)   // 2,048 rows
#define SG_SMS 132
#define SG_BLOCKS 4                       // resident blocks an SM for the grid


// status word: flags in bits 63:61, the tile's (or the prefix's) boundary
// count below
#define SG_INC (1ULL << 63)
#define SG_AGG (1ULL << 62)
#define SG_LIVE (1ULL << 61)
#define SG_COUNT_MASK ((1ULL << 61) - 1)

// an aggregate's form: value type x reduction, and the count
#define SG_FORM_COUNT 12

struct SgArgs {
  SegSpec s;
  int form[SEG_MAX_AGGS];
  const uint8_t* mask;
  const int32_t* order;  // row i of the grouping is row order[i] of the columns
  long long n, cap, tiles;
  uint8_t* out_mask;
  long long* num_groups;
  // [0] done-ticket, [1] tile counter, [2, 2 + tiles) status words: zero on
  // entry and on exit
  unsigned long long* state;
  // the aggregate folds (tiles x m), then the inclusive ones (tiles x m):
  // any content on entry (a fold is read only after its status word)
  unsigned long long* payload;
};

// --------------------------------------------------------------------------
// the reductions, by value type and form
// --------------------------------------------------------------------------

template <typename T, int HOW>
__device__ __forceinline__ T sg_ident() {
  if constexpr (HOW == SEG_MIN || HOW == SEG_MAX) {
    if constexpr (std::is_same<T, float>::value)
      return __int_as_float(HOW == SEG_MIN ? 0x7f800000 : (int)0xff800000u);
    else if constexpr (std::is_same<T, double>::value)
      return __longlong_as_double(HOW == SEG_MIN ? 0x7ff0000000000000LL
                                                 : (long long)0xfff0000000000000ULL);
    else if constexpr (sizeof(T) == 4)
      return HOW == SEG_MIN ? (T)INT32_MAX : (T)INT32_MIN;
    else
      return HOW == SEG_MIN ? (T)INT64_MAX : (T)INT64_MIN;
  }
  return T(0);
}

template <typename T, int HOW>
__device__ __forceinline__ T sg_comb(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    if constexpr (HOW == SEG_SUM) {
      return a + b;
    } else {
      if (isnan(a) || isnan(b)) return isnan(a) ? a : b;  // NaN propagates
      if constexpr (HOW == SEG_MIN) return b < a ? b : a;
      else return b > a ? b : a;
    }
  } else if constexpr (HOW == SEG_SUM || HOW == SEG_COUNT) {  // wraps
    if constexpr (sizeof(T) == 4) return (T)(int32_t)((uint32_t)a + (uint32_t)b);
    else return (T)(long long)((unsigned long long)a + (unsigned long long)b);
  } else if constexpr (HOW == SEG_MIN) {
    return b < a ? b : a;
  } else {
    return b > a ? b : a;
  }
}

template <typename T, int HOW>
__device__ __forceinline__ T sg_load(const void* p, long long r) {
  if constexpr (HOW == SEG_COUNT) return T(1);
  else return __ldg((const T*)p + r);
}

// a value as the 64 bits of a payload word (4-byte types in the low half)
template <typename T>
__device__ __forceinline__ unsigned long long sg_raw(T v) {
  if constexpr (sizeof(T) == 4) {
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  } else {
    unsigned long long u;
    memcpy(&u, &v, 8);
    return u;
  }
}

template <typename T>
__device__ __forceinline__ T sg_val(unsigned long long u) {
  T v;
  if constexpr (sizeof(T) == 4) {
    const uint32_t w = (uint32_t)u;
    memcpy(&v, &w, 4);
  } else {
    memcpy(&v, &u, 8);
  }
  return v;
}

// calls F::template run<T, HOW>(args...) for an aggregate's form
template <class F, typename... A>
__device__ __forceinline__ void sg_dispatch(int form, A&&... a) {
  switch (form) {
    case 0: F::template run<int32_t, SEG_SUM>(a...); break;
    case 1: F::template run<int32_t, SEG_MIN>(a...); break;
    case 2: F::template run<int32_t, SEG_MAX>(a...); break;
    case 3: F::template run<long long, SEG_SUM>(a...); break;
    case 4: F::template run<long long, SEG_MIN>(a...); break;
    case 5: F::template run<long long, SEG_MAX>(a...); break;
    case 6: F::template run<float, SEG_SUM>(a...); break;
    case 7: F::template run<float, SEG_MIN>(a...); break;
    case 8: F::template run<float, SEG_MAX>(a...); break;
    case 9: F::template run<double, SEG_SUM>(a...); break;
    case 10: F::template run<double, SEG_MIN>(a...); break;
    case 11: F::template run<double, SEG_MAX>(a...); break;
    default: F::template run<long long, SEG_COUNT>(a...); break;
  }
}

// A status word published after the payloads that this thread wrote, and
// read before the payloads that it guards.
__device__ __forceinline__ void sg_publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long sg_observe(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// --------------------------------------------------------------------------
// keys
// --------------------------------------------------------------------------

// a key's bits, and a key written back from them
__device__ __forceinline__ unsigned long long sg_key_bits(int kind, const void* p, long long r) {
  switch (kind) {
    case AB_KIND_I32:
    case AB_KIND_F32: return (uint32_t)__ldg((const int32_t*)p + r);
    case AB_KIND_BOOL: return __ldg((const uint8_t*)p + r);
    default: return (unsigned long long)__ldg((const long long*)p + r);
  }
}

__device__ __forceinline__ void sg_store_key(int kind, void* p, long long g, unsigned long long b) {
  switch (kind) {
    case AB_KIND_I32:
    case AB_KIND_F32: ((uint32_t*)p)[g] = (uint32_t)b; break;
    case AB_KIND_BOOL: ((uint8_t*)p)[g] = (uint8_t)b; break;
    default: ((unsigned long long*)p)[g] = b; break;
  }
}

// --------------------------------------------------------------------------
// the fused kernel
// --------------------------------------------------------------------------

struct SgSmem {
  unsigned long long wpart[SEG_MAX_AGGS][SG_WARPS];  // phase 1: warp folds
  unsigned long long tile_fold[SEG_MAX_AGGS];        // the tile's trailing fold
  unsigned long long carry[SEG_MAX_AGGS];            // the open segment's fold before the tile
  unsigned long long wv[2][SG_WARPS];                // phase 2: warp scan totals
  int wf[2][SG_WARPS];
  long long tile, prefix;  // the tile; the boundaries before it
  int last;                // the tile's last boundary (tile-local row), or -1
  int done;
  // phase 3: a column of the tile's groups, staged so that a warp's stores
  // of it are contiguous (a thread closes the groups of its rows, which lie
  // a few slots apart from its neighbours'); two buffers, so that a
  // column's copy-out needs no barrier before the next column is staged
  unsigned long long stage[2][SG_TILE];
};

// what a thread knows of its rows
struct SgRows {
  int src[SG_ITEMS];                // the rows of the columns, through the order
  unsigned live, flag;              // bit j: row j is live / opens a group
  int l0;                           // the tile-local index of its first row
  unsigned before;                  // the tile's boundaries before its rows
  // the row of the keys, values and mask that row j of the thread reads
  // (a row past the last reads the last one's, so that a thread's loads
  // issue together, none behind a branch; such a row is dead)
  __device__ __forceinline__ long long row(int j) const { return src[j]; }
};

// a thread's SG_ITEMS values of an aggregate, every load issued before any
// is used
template <typename T, int HOW, class R>
__device__ __forceinline__ void sg_load_rows(const void* p, const R& r, T (&x)[SG_ITEMS]) {
#pragma unroll
  for (int j = 0; j < SG_ITEMS; ++j) x[j] = sg_load<T, HOW>(p, r.row(j));
}

// bit j: row j's key differs from the row before it (bit 0 against row
// `before`, unless the thread's first row is row 0); floats by value
// (NaN differs from itself, -0.0 equals 0.0), bools by truth
template <typename T, class R>
__device__ __forceinline__ unsigned sg_key_opens(const void* p, const R& r, long long before,
                                                 bool first) {
  T x[SG_ITEMS + 1];
  x[0] = first ? T(0) : __ldg((const T*)p + before);
#pragma unroll
  for (int j = 0; j < SG_ITEMS; ++j) x[j + 1] = __ldg((const T*)p + r.row(j));
  unsigned open = 0u;
#pragma unroll
  for (int j = 0; j < SG_ITEMS; ++j) {
    bool ne;
    if constexpr (std::is_same<T, uint8_t>::value) ne = (x[j + 1] != 0) != (x[j] != 0);
    else ne = x[j + 1] != x[j];
    open |= (unsigned)ne << j;
  }
  return open;
}

// phase 1: the fold of the thread's live rows at or after the tile's last
// boundary (all of them when the tile has none), reduced over the warp
struct SgTrailing {
  template <typename T, int HOW, class R>
  __device__ __forceinline__ static void run(const SgArgs& a, int agg, const R& r, int last,
                                             SgSmem& s) {
    T x[SG_ITEMS];
    sg_load_rows<T, HOW>(a.s.val[agg], r, x);
    T v = sg_ident<T, HOW>();
#pragma unroll
    for (int j = 0; j < SG_ITEMS; ++j)
      if (((r.live >> j) & 1u) && r.l0 + j >= last) v = sg_comb<T, HOW>(v, x[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = sg_comb<T, HOW>(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) == 0) s.wpart[agg][threadIdx.x >> 5] = sg_raw<T>(v);
  }
};

// phase 1, after the block barrier: the warps' folds of one aggregate
struct SgTileFold {
  template <typename T, int HOW>
  __device__ __forceinline__ static void run(int agg, SgSmem& s) {
    T v = sg_ident<T, HOW>();
#pragma unroll
    for (int w = 0; w < SG_WARPS; ++w) v = sg_comb<T, HOW>(v, sg_val<T>(s.wpart[agg][w]));
    s.tile_fold[agg] = sg_raw<T>(v);
  }
};

// look-back: fold a payload word into a lane's carry (far before near)
struct SgFoldRaw {
  template <typename T, int HOW>
  __device__ __forceinline__ static void run(unsigned long long far, unsigned long long& acc) {
    acc = sg_raw<T>(sg_comb<T, HOW>(sg_val<T>(far), sg_val<T>(acc)));
  }
};

// look-back: a window's folds of one aggregate (lane q holds tile near - q's,
// or the identity), reduced over the warp and folded into its lane's carry
struct SgWarpFold {
  template <typename T, int HOW>
  __device__ __forceinline__ static void run(bool in, unsigned long long x, bool own,
                                             unsigned long long& carry) {
    T v = in ? sg_val<T>(x) : sg_ident<T, HOW>();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = sg_comb<T, HOW>(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (own) carry = sg_raw<T>(sg_comb<T, HOW>(v, sg_val<T>(carry)));
  }
};

struct SgIdent {
  template <typename T, int HOW>
  __device__ __forceinline__ static void run(unsigned long long& out) {
    out = sg_raw<T>(sg_ident<T, HOW>());
  }
};

struct SgStore {
  template <typename T, int HOW>
  __device__ __forceinline__ static void run(void* out, long long slot, unsigned long long v) {
    ((T*)out)[slot] = sg_val<T>(v);
  }
};

// phase 2: the segments that end in the tile, before its last boundary.  A
// thread folds its live rows there, writing each segment that opens and
// closes inside its rows; a block-level segmented scan of (saw a boundary,
// fold after its last one) carries the open segment into the thread that
// closes it, starting from the fold carried into the tile.
struct SgSegments {
  template <typename T, int HOW, class R>
  __device__ __forceinline__ static void run(const SgArgs& a, int agg, const R& r, int last,
                                             long long prefix, int count, SgSmem& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned full = 0xffffffffu;
    void* out = a.s.val_out[agg];
    // the segments that close in the tile are prefix - 1 .. prefix + count
    // - 2: the thread stages each at its place in that run
    int g = (int)r.before;  // the stage slot of the thread's first row's segment
    const int head = g;
    T xs[SG_ITEMS];
    sg_load_rows<T, HOW>(a.s.val[agg], r, xs);
    T v = sg_ident<T, HOW>(), h = v;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < SG_ITEMS; ++j) {
      if ((r.flag >> j) & 1u) {
        if (seen) {
          s.stage[agg & 1][g] = sg_raw<T>(v);
        } else {
          h = v;
        }
        seen = true;
        v = sg_ident<T, HOW>();
        ++g;
      }
      if (((r.live >> j) & 1u) && r.l0 + j < last) v = sg_comb<T, HOW>(v, xs[j]);
    }
    if (!seen) h = v;
    // inclusive segmented scan over the warp: (f, x) after (f2, x2) is
    // (f | f2, f ? x : x2 + x)
    int f = seen ? 1 : 0;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int f2 = __shfl_up_sync(full, f, o);
      const T x2 = __shfl_up_sync(full, x, o);
      if (lane >= o) {
        if (!f) x = sg_comb<T, HOW>(x2, x);
        f |= f2;
      }
    }
    const int buf = agg & 1;  // the warp totals and the stage alternate between two buffers
    if (lane == 31) {
      s.wf[buf][warp] = f;
      s.wv[buf][warp] = sg_raw<T>(x);
    }
    int ef = __shfl_up_sync(full, f, 1);
    T ex = __shfl_up_sync(full, x, 1);
    if (lane == 0) {
      ef = 0;
      ex = sg_ident<T, HOW>();
    }
    __syncthreads();
    T c = sg_val<T>(s.carry[agg]);  // the open segment before this warp
    for (int w = 0; w < warp; ++w) {
      const T wx = sg_val<T>(s.wv[buf][w]);
      c = s.wf[buf][w] ? wx : sg_comb<T, HOW>(c, wx);
    }
    if (seen) {
      const T before = ef ? ex : sg_comb<T, HOW>(c, ex);
      s.stage[buf][head] = sg_raw<T>(sg_comb<T, HOW>(before, h));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += SG_THREADS) {
      const long long slot = prefix - 1 + i;
      if (slot >= 0 && slot < a.cap) ((T*)out)[slot] = sg_val<T>(s.stage[buf][i]);
    }
    // the next column stages into the other buffer; this one is written
    // again only past that column's barriers, which every reader passes
  }
};

__global__ void __launch_bounds__(SG_THREADS, SG_BLOCKS) k8_seg_fused(const SgArgs a) {
  __shared__ SgSmem s;
  __shared__ unsigned ws[SG_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  const int m = a.s.m, k = a.s.k;
  unsigned long long* status = a.state + 2;
  unsigned long long* agg_pay = a.payload;
  unsigned long long* inc_pay = agg_pay + a.tiles * m;
  while (true) {
    if (threadIdx.x == 0) {
      s.tile = (long long)atomicAdd(&a.state[1], 1ULL);
      s.last = -1;
    }
    __syncthreads();
    const long long tile = s.tile;
    if (tile >= a.tiles) break;
    const long long row0 = tile * SG_TILE;

    // 0. this thread's rows: their source rows, live bits and boundaries
    SgRows r;
    r.l0 = threadIdx.x * SG_ITEMS;
    const long long i0 = row0 + r.l0;
    r.live = 0u;
    r.flag = 0u;
#pragma unroll
    for (int j = 0; j < SG_ITEMS; ++j) r.src[j] = __ldg(a.order + min(i0 + j, a.n - 1));
    uint8_t lv[SG_ITEMS];
#pragma unroll
    for (int j = 0; j < SG_ITEMS; ++j) lv[j] = __ldg(a.mask + r.row(j));
#pragma unroll
    for (int j = 0; j < SG_ITEMS; ++j) r.live |= (unsigned)(lv[j] != 0 && i0 + j < a.n) << j;
    if (k > 0 && r.live) {
      const bool first = i0 == 0;  // row 0 opens a group
      const long long before = first ? 0 : __ldg(a.order + i0 - 1);
      unsigned open = first ? 1u : 0u;
      for (int kj = 0; kj < k; ++kj) {
        const void* p = a.s.key[kj];
        switch (a.s.key_kind[kj]) {
          case AB_KIND_I32: open |= sg_key_opens<int32_t>(p, r, before, first); break;
          case AB_KIND_I64: open |= sg_key_opens<long long>(p, r, before, first); break;
          case AB_KIND_BOOL: open |= sg_key_opens<uint8_t>(p, r, before, first); break;
          case AB_KIND_F32: open |= sg_key_opens<float>(p, r, before, first); break;
          default: open |= sg_key_opens<double>(p, r, before, first); break;
        }
      }
      r.flag = open & r.live;
    }
    if (r.flag) atomicMax(&s.last, r.l0 + 31 - __clz(r.flag));
    unsigned count;
    r.before = ab_block_exclusive_scan<unsigned>(__popc(r.flag), ws, &count);
    const int tile_live = __syncthreads_or(r.live != 0u);
    const int last = s.last;

    // 1. the tile's trailing fold: live rows at or after its last boundary
    for (int agg = 0; agg < m; ++agg) sg_dispatch<SgTrailing>(a.form[agg], a, agg, r, last, s);
    __syncthreads();
    if (threadIdx.x < m) sg_dispatch<SgTileFold>(a.form[threadIdx.x], (int)threadIdx.x, s);
    __syncthreads();

    // 2. publish the tile's state, then look back: the boundaries before
    //    the tile (up to the nearest inclusive word) and the fold carried
    //    into it (up to the nearest tile with a boundary, or inclusive word)
    if (warp == 0) {
      const unsigned long long own =
          (unsigned long long)count | (tile_live ? SG_LIVE : 0ULL);
      unsigned long long pre_flags = 0ULL;  // the prefix's boundaries and live bit
      unsigned long long carry = 0ULL;      // lane a: aggregate a's carried fold
      if (lane < m) sg_dispatch<SgIdent>(a.form[lane], carry);
      if (tile > 0) {
        if (lane == 0) {
          for (int g = 0; g < m; ++g) agg_pay[tile * m + g] = s.tile_fold[g];
          sg_publish(status + tile, SG_AGG | own);
        }
        bool carry_open = true;
        for (long long near = tile - 1;; near -= 32) {
          const long long t = near - lane;
          unsigned long long v = t >= 0 ? sg_observe(status + t) : SG_INC;
          while (__any_sync(full, v == 0ULL))
            if (v == 0ULL) v = sg_observe(status + t);
          __syncwarp();  // a lane reads payloads that other lanes' words publish
          const unsigned inc = __ballot_sync(full, (v & SG_INC) != 0ULL);
          const int nearest = inc ? __ffs(inc) - 1 : 32;
          unsigned long long mine = lane <= nearest ? (v & SG_COUNT_MASK) : 0ULL;
          const unsigned any_live = __ballot_sync(full, lane <= nearest && (v & SG_LIVE));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(full, mine, o);
          pre_flags += mine;
          if (any_live) pre_flags |= SG_LIVE;
          if (carry_open) {
            const unsigned stop_bits =
                __ballot_sync(full, (v & SG_INC) != 0ULL || (v & SG_COUNT_MASK) != 0ULL);
            const int stop = stop_bits ? __ffs(stop_bits) - 1 : 31;
            // lane q folds tile near - q's payload: four aggregates' loads
            // at a time, then a warp reduction each
            const bool in = lane <= stop && t >= 0;
            const unsigned long long* pay = ((v & SG_INC) ? inc_pay : agg_pay) + t * m;
            for (int g0 = 0; g0 < m; g0 += 4) {
              unsigned long long x[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) x[c] = in && g0 + c < m ? __ldcg(pay + g0 + c) : 0ULL;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (g0 + c < m)
                  sg_dispatch<SgWarpFold>(a.form[g0 + c], in, x[c], lane == g0 + c, carry);
            }
            carry_open = stop_bits == 0u;
          }
          if (inc) break;
        }
      }
      // the inclusive state: the tile's trailing fold alone when it has a
      // boundary, else the carry and the tile's fold
      unsigned long long incl = lane < m ? s.tile_fold[lane] : 0ULL;
      if (lane < m && count == 0u) {
        unsigned long long acc = incl;
        sg_dispatch<SgFoldRaw>(a.form[lane], carry, acc);
        incl = acc;
      }
      if (lane < m) s.carry[lane] = carry;
      const unsigned long long total =
          ((pre_flags & SG_COUNT_MASK) + count) | ((pre_flags | own) & SG_LIVE);
      for (int g = 0; g < m; ++g) {
        const unsigned long long x = __shfl_sync(full, incl, g);
        if (lane == 0) inc_pay[tile * m + g] = x;
      }
      if (lane == 0) {
        sg_publish(status + tile, SG_INC | total);
        s.prefix = (long long)(pre_flags & SG_COUNT_MASK);
      }
      if (tile == a.tiles - 1) {  // the final segment, from the inclusive fold
        const long long groups = k > 0 ? (long long)(total & SG_COUNT_MASK)
                                       : ((total & SG_LIVE) ? 1 : 0);
        const long long slot = groups - 1;
        if (lane < m && slot >= 0 && slot < a.cap)
          sg_dispatch<SgStore>(a.form[lane], a.s.val_out[lane], slot, incl);
        if (lane == 0) {
          *a.num_groups = groups;
          if (k == 0 && groups > 0) a.out_mask[0] = 1;
        }
      }
    }
    __syncthreads();

    // 3. the groups that open in the tile (keys, mask) and the segments
    //    that close in it (values)
    if (count > 0u) {
      const long long prefix = s.prefix;
      const int groups = (int)count;
      // the keys of the groups that open in the tile: as many key columns
      // a round as the two stage buffers hold
      const int per_round = max(1, 2 * SG_TILE / groups);
      for (int k0 = 0; k0 < k; k0 += per_round) {
        const int k1 = min(k, k0 + per_round);
        unsigned long long* st = &s.stage[0][0];
        for (int kj = k0; kj < k1; ++kj) {
          const int kind = a.s.key_kind[kj];
          int at = (kj - k0) * groups + (int)r.before;
#pragma unroll
          for (int j = 0; j < SG_ITEMS; ++j)
            if ((r.flag >> j) & 1u) st[at++] = sg_key_bits(kind, a.s.key[kj], r.row(j));
        }
        __syncthreads();
        for (int i = threadIdx.x; i < (k1 - k0) * groups; i += SG_THREADS) {
          const int kj = k0 + i / groups;
          const long long g = prefix + i % groups;
          if (g < a.cap) sg_store_key(a.s.key_kind[kj], a.s.key_out[kj], g, st[i]);
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < groups; i += SG_THREADS)
        if (prefix + i < a.cap) a.out_mask[prefix + i] = 1;
      for (int agg = 0; agg < m; ++agg)
        sg_dispatch<SgSegments>(a.form[agg], a, agg, r, last, prefix, groups, s);
    }
    __syncthreads();  // shared memory is the next tile's
  }

  // the last block to finish puts the status words, the counter and the
  // ticket back to zero for the next call on this stream
  if (threadIdx.x == 0) s.done = ab_last_block(&a.state[0]) ? 1 : 0;
  __syncthreads();
  if (s.done) {
    for (long long t = threadIdx.x; t < a.tiles; t += SG_THREADS) status[t] = 0ULL;
    if (threadIdx.x == 0) {
      a.state[1] = 0ULL;
      a.state[0] = 0ULL;
    }
  }
}

// slots [min(groups, cap), cap): zero keys, the identities, a false mask bit
struct SgFillIdent {
  template <typename T, int HOW>
  __device__ __forceinline__ static void run(void* out, long long t) {
    ((T*)out)[t] = sg_ident<T, HOW>();
  }
};

__global__ void __launch_bounds__(256) k8_seg_fill(const SgArgs a) {
  const long long groups = *a.num_groups;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (groups < a.cap ? groups : a.cap) + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       t < a.cap; t += step) {
    for (int j = 0; j < a.s.k; ++j) {
      switch (a.s.key_kind[j]) {
        case AB_KIND_I32: ((int32_t*)a.s.key_out[j])[t] = 0; break;
        case AB_KIND_I64: ((int64_t*)a.s.key_out[j])[t] = 0; break;
        case AB_KIND_BOOL: ((uint8_t*)a.s.key_out[j])[t] = 0; break;
        case AB_KIND_F32: ((float*)a.s.key_out[j])[t] = 0.0f; break;
        default: ((double*)a.s.key_out[j])[t] = 0.0; break;
      }
    }
    for (int g = 0; g < a.s.m; ++g) sg_dispatch<SgFillIdent>(a.form[g], a.s.val_out[g], t);
    a.out_mask[t] = 0;
  }
}

static inline long long sg_tiles(long long n) { return (n + SG_TILE - 1) / SG_TILE; }

// int64 words of the per-stream state a call of n rows uses, and of the
// per-stream payload a call of n rows and m aggregates uses
AB_EXPORT long long ab_seg_state_words(long long n) { return 2 + sg_tiles(n); }
AB_EXPORT long long ab_seg_payload_words(long long n, int m) {
  return 2 * sg_tiles(n) * (long long)(m > 0 ? m : 0);
}

// spec: the keys and values (read through `order`) and the outputs (cap
// slots each, allocated by the caller); mask: bool, read through `order`;
// order: int32[n], a permutation of the grouping's rows; out_mask: bool[cap];
// num_groups: int64[1]; state: ab_seg_state_words(n) int64 words, zero on
// entry and on exit; payload: ab_seg_payload_words(n, m) int64 words, any
// content.  Two launches.
AB_EXPORT int ab_grouped_on_order(const SegSpec* spec, const void* mask, const void* order,
                                  long long n, long long cap, void* out_mask, void* num_groups,
                                  void* state, void* payload, void* stream) {
  SgArgs a;
  a.s = *spec;
  SegSpec& s = a.s;
  if (order == nullptr || n < 1 || n > 0x7fffffffLL || cap < 1 || s.k < 0 || s.k > SEG_MAX_KEYS || s.m < 0 ||
      s.m > SEG_MAX_AGGS)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < s.k; ++j)
    if (s.key_kind[j] < AB_KIND_I32 || s.key_kind[j] > AB_KIND_F64)
      return (int)cudaErrorInvalidValue;
  for (int g = 0; g < s.m; ++g) {
    if (s.how[g] < SEG_SUM || s.how[g] > SEG_MAX) return (int)cudaErrorInvalidValue;
    if (s.how[g] == SEG_COUNT) {
      s.val_kind[g] = AB_KIND_I64;
      a.form[g] = SG_FORM_COUNT;
      continue;
    }
    int t;
    switch (s.val_kind[g]) {
      case AB_KIND_I32: t = 0; break;
      case AB_KIND_I64: t = 1; break;
      case AB_KIND_F32: t = 2; break;
      case AB_KIND_F64: t = 3; break;
      default: return (int)cudaErrorInvalidValue;
    }
    a.form[g] = t * 3 + (s.how[g] == SEG_SUM ? 0 : s.how[g] == SEG_MIN ? 1 : 2);
  }
  a.mask = (const uint8_t*)mask;
  a.order = (const int32_t*)order;
  a.n = n;
  a.cap = cap;
  a.tiles = sg_tiles(n);
  a.out_mask = (uint8_t*)out_mask;
  a.num_groups = (long long*)num_groups;
  a.state = (unsigned long long*)state;
  a.payload = (unsigned long long*)payload;
  cudaStream_t st = (cudaStream_t)stream;
  const long long most = (long long)SG_SMS * SG_BLOCKS;
  const unsigned blocks = (unsigned)(a.tiles < most ? a.tiles : most);
  k8_seg_fused<<<blocks, SG_THREADS, 0, st>>>(a);
  int err = ab_last_error();
  if (err) return err;
  const int threads = 256;
  k8_seg_fill<<<ab_grid(cap, threads, SG_SMS * 8), threads, 0, st>>>(a);
  return ab_last_error();
}
