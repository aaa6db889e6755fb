// K6: probe_join — match probe rows against the sorted build hashes and
// expand the matches into a fixed number of pair slots.
//
// Replaces arrow_ballista_tpu/ops/kernels.py probe_join (l.739), and the
// candidate counts of JoinExec's "join.count" and "join.wcount" programs
// (operators.py:1291, :1303).  Per probe row i the reference takes
// lo/hi = searchsorted(build, h[i], left/right) on uint64, count = hi - lo
// for live rows (else 0), inclusive offsets = cumsum(count), total =
// offsets[-1]; pair slot j < total belongs to the row whose offsets first
// exceed j, with build position lo + (j - start).  Slots at or past total
// get pair_valid = false and the clipped indices the reference's formula
// gives there (probe row n-1, its lo plus the distance from its start).
//
// Bound: bytes.  The count needs the probe hashes and mask once and, per
// live row, a few build hashes; the expansion writes 9 bytes a pair slot.
// The main path's largest call is selective (mesh4_q3: 8,388,608 probe
// rows, 38,460 of them live, the rest dead slots of padded mesh buckets,
// against an 8,388,608-row, 64 MB build, 772,545 rows live; 7,832 pairs in
// 131,072 slots), so what costs is the latency of each search's dependent
// loads, work on dead rows, intermediates written to and read back from
// device memory, and launches.
//
// Design: one fused kernel (k6_probe_fused) for search, count, scan and
// expansion, then a small fill kernel (k6_probe_fill) for the slots past
// the total: two launches, no memset, no copy, no intermediate array.
//   * Persistent blocks take tiles of 256 or 1,024 rows (by the call's
//     size: enough tiles for every SM) from an atomic counter (so a
//     look-back never waits on a tile that was not scheduled, as
//     radix.cuh's passes do).  A thread reads its 1 or 4 rows from one
//     16-byte mask word.  The rows that search are the live ones and row
//     n-1, whose lo the invalid slots need: a block scan lists them in
//     shared memory in row order, so a dead row costs no search (on
//     mesh4_q3's largest call, 38,460 of 8,388,608 probe rows are live).
//   * A warp takes a contiguous run of the list, an entry a lane.  A search
//     first finds its stride of the build in a shared-memory sample (every
//     stride-th hash, loaded once per block; the whole build when it
//     fits), then the lower bound inside that stride in device memory, both
//     by halving steps.  Then one compare, build[lo] == h: only on a match
//     does it gallop forward from lo to the end of the run (no second full
//     search).  The searches are latency-bound: what hides the latency is
//     resident warps, so the tiles are small and the blocks many.
//   * The counts are scanned within the warp by shuffles (32 zero counts
//     skip it) and across the warps in shared memory; the tile's first pair
//     slot comes from decoupled look-back over per-tile status words (flag
//     and int64 value in one word), a warp reading 32 of them at a time:
//     tiles in flight finish together, and a look-back of one word a step
//     would walk their aggregates one dependent load at a time.  The status
//     words, the tile counter and the done-ticket sit in a per-(device,
//     stream) buffer that the last block (ab_last_block) puts back to zero,
//     so the next call on the stream needs no memset.
//   * The block writes its tile's pair slots together: each thread takes
//     slots in a strided loop, finds the slot's list entry by a binary
//     search over the list's inclusive counts in shared memory (from the
//     entry of its previous slot on), and writes probe_idx, build_pos and
//     valid coalesced; a fan-out row no longer runs on one thread.  The
//     count passes take the same kernel with the expansion off: the total
//     alone, or the inclusive offsets too.
//   * The tile of row n-1 leaves the total, lo[n-1] and count[n-1] in three
//     words of the call's output, which the fill kernel reads on the
//     device: slots [total, cap) need no host sync.
#include "common.cuh"

#define PJ_THREADS 256
#define PJ_SMS 132
#define PJ_WARPS (PJ_THREADS / 32)
#define PJ_SAMPLE 2048                     // build hashes sampled into shared memory
// Rows a thread, by the call's rows: 1 (256-row tiles, four blocks an SM)
// while one wave of them covers the call, else 4 (1,024-row tiles, six
// blocks an SM).  On mesh4_q3's largest call and on q3's, 4,096-row tiles
// ran longer, and several searches interleaved in a lane gained nothing
// over more resident warps.
#define PJ_ITEMS_4_ROWS (PJ_SMS * 4LL * 256)  // above it, 4 rows a thread

// look-back status word: flag in bits 63:62, the int64 count below
#define PJ_FLAG_AGG (1ULL << 62)
#define PJ_FLAG_INC (1ULL << 63)
#define PJ_VALUE ((1ULL << 62) - 1)

// what the fused kernel writes besides the total
#define PJ_MODE_TOTAL 0
#define PJ_MODE_OFFSETS 1
#define PJ_MODE_EXPAND 2

struct PjArgs {
  const uint4* words;  // the mask's 16-byte words from its aligned base
  int shift;           // the mask's address & 15: row r is byte r + shift
  const uint64_t* ph;
  long long np;
  const uint64_t* bh;
  long long nb;
  long long stride;  // sample stride: sample[s] = bh[s * stride]
  int m;             // sampled hashes
  int mtop, gtop;    // the largest powers of two <= m and <= stride - 1 (or 0)
  long long tiles;
  int mode;
  long long cap;                 // pair slots (PJ_MODE_EXPAND)
  long long* offsets;            // int64[np] (PJ_MODE_OFFSETS)
  int32_t* probe_idx;            // int32[cap] (PJ_MODE_EXPAND)
  int32_t* build_pos;
  uint8_t* valid;
  long long* out;                // [total, lo of row np-1, count of row np-1]
  unsigned long long* state;     // [0] done-ticket, [1] tile counter, [2..] status
};

template <int TILE>
struct PjSmem {
  uint64_t sample[PJ_SAMPLE];
  long long incl[TILE];       // per list entry: the inclusive pair count over its
                              // warp's run of the list
  int lo[TILE];               // per list entry: the lower bound
  unsigned short byte[TILE];  // per list entry: its row - row0, PJ_DEAD when dead
  long long wsum[PJ_WARPS];   // warp totals, then the warps' exclusive offsets
  long long tile, prefix, total;
  int last;
};
#define PJ_DEAD 0x8000  // the list entry of a dead row n-1

__device__ __forceinline__ void pj_store(unsigned long long* p, unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}
__device__ __forceinline__ unsigned long long pj_load(const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// the largest power of two <= x, or 0 when x < 1
static inline int pj_top(long long x) {
  if (x < 1) return 0;
  int t = 0;
  while ((2LL << t) <= x) ++t;
  return 1 << t;
}

// The number of hashes below h in a[base .. base + len), by halving steps
// from `top` (the largest power of two <= any len it is given).
__device__ __forceinline__ int pj_lower_bound(const uint64_t* a, int base, int len, int top,
                                              uint64_t h) {
  int b = 0;
  for (int step = top; step > 0; step >>= 1)
    if (b + step <= len && a[base + b + step - 1] < h) b += step;
  return b;
}

// the end of the run of h that starts at lo (bh[lo] == h): gallop, then bisect
__device__ __forceinline__ long long pj_run_end(const uint64_t* __restrict__ bh, long long nb,
                                                long long lo, uint64_t h) {
  long long p = lo, d = 1;
  while (p + d < nb && bh[p + d] == h) {
    p += d;
    d <<= 1;
  }
  long long a = p + 1, b = min(p + d, nb);
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (bh[mid] == h) a = mid + 1; else b = mid;
  }
  return a;
}

// inclusive pair count of the tile's list up to entry i (a warp's run is
// `run` entries)
template <typename S>
__device__ __forceinline__ long long pj_incl(const S& s, int i, int run) {
  return s.wsum[i / run] + s.incl[i];
}

template <int ITEMS, int BLOCKS>
__global__ void __launch_bounds__(PJ_THREADS, BLOCKS) k6_probe_fused(PjArgs a) {
  constexpr int TILE = PJ_THREADS * ITEMS;
  extern __shared__ uint4 pj_raw[];
  PjSmem<TILE>& s = *reinterpret_cast<PjSmem<TILE>*>(pj_raw);
  __shared__ unsigned ws[PJ_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  for (int i = threadIdx.x; i < a.m; i += PJ_THREADS) s.sample[i] = a.bh[(long long)i * a.stride];
  unsigned long long* status = a.state + 2;
  while (true) {
    if (threadIdx.x == 0) s.tile = (long long)atomicAdd(&a.state[1], 1ULL);
    __syncthreads();  // the sample too, before the first tile
    const long long tile = s.tile;
    if (tile >= a.tiles) break;
    const long long row0 = tile * TILE - a.shift;  // the row of the tile's byte 0

    // 1. the list: this thread's rows that search (live, or row n-1), at
    //    their place in the tile's row order
    const int tb = threadIdx.x * ITEMS;  // the thread's first byte of the tile
    const long long r = row0 + tb;
    const uint4 w = ab_mask_word(a.words, (tile * TILE + tb) >> 4, row0 + (tb & ~15), a.np);
    unsigned need = 0u, dead = 0u;  // bit k: row r + k searches / is the dead row n-1
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool lv = ab_word_byte(w, (tb & 15) + k) != 0u;
      const bool last = r + k == a.np - 1;
      need |= (unsigned)(lv || last) << k;
      dead |= (unsigned)(!lv && last) << k;
    }
    unsigned listed;
    const unsigned at0 = ab_block_exclusive_scan<unsigned>(__popc(need), ws, &listed);
    unsigned at = at0;
    for (unsigned bits = need; bits; bits &= bits - 1) {
      const int k = __ffs(bits) - 1;
      s.byte[at++] = (unsigned short)(tb + k + ((dead >> k) & 1u ? PJ_DEAD : 0));
    }
    __syncthreads();
    const int n_list = (int)listed;
    // warp w takes entries [w * run, (w + 1) * run), lane l every 32nd from l
    const int run = max(32, (n_list + PJ_WARPS * 32 - 1) / (PJ_WARPS * 32) * 32);
    const int first = warp * run;

    // 2. search and count, an entry a lane; then the inclusive counts over
    //    the warp's run
    long long carry = 0;  // pairs of the warp's earlier entries
#pragma unroll 1
    for (int q0 = 0; q0 < run && first + q0 < n_list; q0 += 32) {  // warp-uniform
      const int i = first + q0 + lane;
      const bool on = i < n_list;
      const unsigned e = on ? s.byte[i] : 0u;
      const bool live = on && !(e & PJ_DEAD);
      const uint64_t h = on ? a.ph[row0 + (e & ~PJ_DEAD)] : 0ULL;
      // the sample: how many sampled hashes lie below h, which names the
      // stride of the build that holds the lower bound ...
      const long long si = pj_lower_bound(s.sample, 0, on ? a.m : 0, a.mtop, h);
      const long long lo_g = si == 0 ? 0 : (si - 1) * a.stride + 1;
      const long long hi_g = si < a.m ? si * a.stride : a.nb;
      // ... and the lower bound inside it; then one compare a live row
      const long long lo =
          lo_g + pj_lower_bound(a.bh, (int)lo_g, on ? (int)(hi_g - lo_g) : 0, a.gtop, h);
      const long long c =
          live && lo < a.nb && a.bh[lo] == h ? pj_run_end(a.bh, a.nb, lo, h) - lo : 0;
      if (on) {
        s.lo[i] = (int)lo;
        if (row0 + (e & ~PJ_DEAD) == a.np - 1) {
          a.out[1] = lo;
          a.out[2] = c;
        }
      }
      long long x = c;
      if (__ballot_sync(full, c != 0) != 0u) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const long long y = __shfl_up_sync(full, x, o);
          if (lane >= o) x += y;
        }
      }
      if (on) s.incl[i] = carry + x;
      carry += __shfl_sync(full, x, 31);
    }
    if (lane == 0) s.wsum[warp] = carry;
    __syncthreads();

    // 3. the warps' offsets, the tile's total, and its first pair slot by
    //    decoupled look-back, one warp reading 32 earlier tiles' status
    //    words at a time, nearest first: it waits until all 32 are
    //    published, adds the aggregates up to and with the nearest
    //    inclusive word (tile 0's always is one) or, with none, all 32 and
    //    goes on to the 32 before them
    if (warp == 0) {
      long long total = 0;
      if (lane == 0) {
        for (int w = 0; w < PJ_WARPS; ++w) {
          const long long v = s.wsum[w];
          s.wsum[w] = total;
          total += v;
        }
        if (tile > 0) pj_store(status + tile, PJ_FLAG_AGG | (unsigned long long)total);
      }
      total = __shfl_sync(full, total, 0);
      long long excl = 0;
      for (long long near = tile - 1; near >= 0; near -= 32) {
        const long long k = near - lane;
        unsigned long long v = k >= 0 ? pj_load(status + k) : PJ_FLAG_INC;  // none: 0
        while (__any_sync(full, v == 0ULL))
          if (v == 0ULL) v = pj_load(status + k);
        const unsigned inc = __ballot_sync(full, (v & PJ_FLAG_INC) != 0ULL);
        const int nearest = inc ? __ffs(inc) - 1 : 32;
        long long mine = lane <= nearest ? (long long)(v & PJ_VALUE) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(full, mine, o);
        excl += __shfl_sync(full, mine, 0);
        if (inc) break;
      }
      if (lane == 0) {
        pj_store(status + tile, PJ_FLAG_INC | (unsigned long long)(excl + total));
        s.prefix = excl;
        s.total = total;
        if (tile == a.tiles - 1) a.out[0] = excl + total;
      }
    }
    __syncthreads();

    // 4. the tile's inclusive offsets, or its pair slots
    const long long prefix = s.prefix;
    if (a.mode == PJ_MODE_OFFSETS) {  // this thread's rows, walking its list entries
      unsigned pos = at0;
      long long incl = at0 == 0 ? 0 : pj_incl(s, at0 - 1, run);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if ((need >> k) & 1u) incl = pj_incl(s, pos++, run);
        if (r + k >= 0 && r + k < a.np) a.offsets[r + k] = prefix + incl;
      }
    } else if (a.mode == PJ_MODE_EXPAND) {
      const long long end = min(prefix + s.total, a.cap);
      int e = 0;  // the entry of this thread's previous slot: later slots lie at or after it
      for (long long j = prefix + threadIdx.x; j < end; j += PJ_THREADS) {
        const long long local = j - prefix;
        int lo = e, hi = n_list - 1;  // the list's last inclusive count exceeds local
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (pj_incl(s, mid, run) <= local) lo = mid + 1; else hi = mid;
        }
        e = lo;
        const long long start = e == 0 ? 0 : pj_incl(s, e - 1, run);
        a.probe_idx[j] = (int32_t)(row0 + (s.byte[e] & ~PJ_DEAD));
        a.build_pos[j] = (int32_t)(s.lo[e] + (local - start));
        a.valid[j] = 1;
      }
    }
    __syncthreads();  // shared memory is the next tile's
  }

  // the last block to finish puts the status words, the counter and the
  // ticket back to zero for the next call on this stream
  if (threadIdx.x == 0) s.last = ab_last_block(&a.state[0]) ? 1 : 0;
  __syncthreads();
  if (s.last) {
    for (long long k = threadIdx.x; k < a.tiles; k += PJ_THREADS) status[k] = 0ULL;
    if (threadIdx.x == 0) {
      a.state[1] = 0ULL;
      a.state[0] = 0ULL;
    }
  }
}

// slots [total, cap): probe row np-1 and the reference's clipped position
__global__ void k6_probe_fill(const long long* __restrict__ out, long long np, long long nb,
                              long long cap, int32_t* __restrict__ probe_idx,
                              int32_t* __restrict__ build_pos, uint8_t* __restrict__ valid) {
  const long long total = out[0];
  const long long lo_last = out[1];
  const long long start_last = total - out[2];
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = max(total, 0LL) + (long long)blockIdx.x * blockDim.x + threadIdx.x; j < cap;
       j += step) {
    const long long bp = min(max(lo_last + (j - start_last), 0LL), nb - 1);
    probe_idx[j] = (int32_t)(np - 1);
    build_pos[j] = (int32_t)bp;
    valid[j] = 0;
  }
}

static inline int pj_items(long long np) { return np > PJ_ITEMS_4_ROWS ? 4 : 1; }

static inline long long pj_tiles(long long np, int shift) {
  const long long tile = (long long)PJ_THREADS * pj_items(np);
  return (np + shift + tile - 1) / tile;
}

// int64 words of the per-stream state a call of np probe rows uses
AB_EXPORT long long ab_probe_state_words(long long np) { return 2 + pj_tiles(np, 15); }

template <int ITEMS, int BLOCKS>
static int pj_launch(const PjArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(PjSmem<PJ_THREADS * ITEMS>);
  static AbSmemLimit limit;
  const int err = ab_smem_limit(k6_probe_fused<ITEMS, BLOCKS>, (int)smem, limit);
  if (err) return err;
  const long long most = (long long)PJ_SMS * BLOCKS;
  const long long blocks = a.tiles < most ? a.tiles : most;
  k6_probe_fused<ITEMS, BLOCKS><<<(unsigned)blocks, PJ_THREADS, smem, s>>>(a);
  return ab_last_error();
}

// mode: 0 the total alone, 1 also the inclusive offsets (int64[np]), 2 the
// pair slots (int32 probe_idx and build_pos, uint8 valid, each [cap]).
// out: int64[3], receives the total (then lo and count of row np-1).
// state: ab_probe_state_words(np) int64 words, zero on entry and on exit.
AB_EXPORT int ab_probe_join(const void* probe_hash, const void* mask, long long np,
                            const void* build_sorted, long long nb, int mode, long long cap,
                            void* offsets, void* probe_idx, void* build_pos, void* valid,
                            void* out, void* state, void* stream) {
  if (np < 1 || np > 0x7fffffffLL || nb < 0 || nb > 0x7fffffffLL || mode < 0 || mode > 2 ||
      cap < 0 || cap > 0x7fffffffLL || (mode == PJ_MODE_EXPAND && nb < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  PjArgs a;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  a.shift = (int)(addr & 15);
  a.words = reinterpret_cast<const uint4*>(addr - a.shift);
  a.ph = (const uint64_t*)probe_hash;
  a.np = np;
  a.bh = (const uint64_t*)build_sorted;
  a.nb = nb;
  a.stride = nb > PJ_SAMPLE ? (nb + PJ_SAMPLE - 1) / PJ_SAMPLE : 1;
  a.m = (int)((nb + a.stride - 1) / a.stride);
  a.mtop = pj_top(a.m);
  a.gtop = pj_top(a.stride - 1);
  a.tiles = pj_tiles(np, a.shift);
  a.mode = mode;
  a.cap = cap;
  a.offsets = (long long*)offsets;
  a.probe_idx = (int32_t*)probe_idx;
  a.build_pos = (int32_t*)build_pos;
  a.valid = (uint8_t*)valid;
  a.out = (long long*)out;
  a.state = (unsigned long long*)state;
  int err = pj_items(np) == 4 ? pj_launch<4, 6>(a, s) : pj_launch<1, 4>(a, s);
  if (err || mode != PJ_MODE_EXPAND || cap == 0) return err;
  const int threads = 256;
  k6_probe_fill<<<ab_grid(cap, threads, PJ_SMS * 16), threads, 0, s>>>(
      (const long long*)out, np, nb, cap, (int32_t*)probe_idx, (int32_t*)build_pos,
      (uint8_t*)valid);
  return ab_last_error();
}
