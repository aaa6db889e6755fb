// K17: dispatch_to_buckets — scatter rows into [n_dest, capacity] send
// buffers, one per column, for the mesh exchange.
//
// Replaces arrow_ballista_tpu/parallel/ici_shuffle.py dispatch_to_buckets
// (l.33).  A live row whose dest lies in [0, n_dest) goes to bucket dest;
// its rank is the number of earlier rows of that bucket (the reference's
// per-bucket cumsum, bit for bit: the order of the received rows decides
// the row order of the mesh join's output).  The row lands in slot
// dest * capacity + rank when rank < capacity.  Every slot no row fills is
// zero, as jnp.zeros(...).at[].set leaves it; counts[b] is the number of
// rows of bucket b, and *overflow = any(counts > capacity).
//
// Bound: bytes.  dest and mask are read (twice: once a launch, the second
// time mostly from L2), each column's rows once, every buffer slot and the
// send mask written once.  The buffers are sized for the worst bucket
// (parallel/distributed.py skew_factor 2), so most slots are the zero
// tail: its stores, and the scatter's, must be wide and contiguous.
//
// Two launches a call, state only in the call's own scratch:
//   1. k17_count: each block counts the buckets of AB_DISPATCH_COUNT_TILES
//      tiles of AB_DISPATCH_TILE rows (8 rows a thread and tile, as 16-byte
//      and 4-byte loads, each warp-contiguous) into the scratch,
//      [bucket][tile].  The block that draws the last
//      ticket (ab_last_block, common.cuh; the ticket is the stream's
//      accumulator word, back to zero when it is done) scans every
//      bucket's tile counts in place into each tile's first rank (four
//      buckets a block-wide scan), and writes counts and the overflow flag.
//   2. k17_scatter: the first `tiles` blocks each rank their tile's rows
//      (per-thread counts, two 16-bit fields a 32-bit word, scanned over the
//      block), then sort the tile stably by bucket in shared memory: src[p],
//      the tile row at sorted position p, and bkt[p] its bucket.  Thread p
//      then writes position p: the bucket's runs are contiguous in the
//      output, so a warp's stores are one contiguous run of slots.  Each
//      column is read through the read-only cache at the sorted rows (a
//      tile's rows are a few KB; every sector comes from device memory
//      once, prefetched into L2 while the tile is sorted), 8 loads a
//      thread in flight.  The remaining blocks each zero one chunk of
//      AB_DISPATCH_TAIL_SLOTS slots of one bucket where it lies in
//      [min(counts[b], capacity), capacity), in every buffer and the mask,
//      with 16-byte stores between the chunk's unaligned ends; a chunk that
//      is all filled exits at once.  The tail slots and the filled ones are
//      disjoint, so both kinds of block run at once.
// A dispatch of more than AB_DISPATCH_MAX_COLS columns of a width runs the
// count once and one scatter launch for each further group of columns, on
// the same scratch (ops/kernels.py); only the first writes the mask.
#include "common.cuh"

#define AB_DISPATCH_MAX_DEST 64
#define AB_DISPATCH_MAX_COLS 32
#define AB_DISPATCH_THREADS 256
#define AB_DISPATCH_ROWS 8  // rows a thread, consecutive
#define AB_DISPATCH_TILE (AB_DISPATCH_THREADS * AB_DISPATCH_ROWS)
#define AB_DISPATCH_WARPS (AB_DISPATCH_THREADS / 32)
#define AB_DISPATCH_TAIL_SLOTS 4096  // slots of one bucket a zero-tail block
#define AB_DISPATCH_SCAN_BATCH 8    // tile counts a thread loads at once in the last block
#define AB_DISPATCH_COUNT_TILES 4   // scatter tiles a count block counts
#define AB_NO_BUCKET 0xff

// the columns of one dispatch, by element width (ops/kernels.py
// _DispatchCols)
struct DispatchCols {
  const void* in8[AB_DISPATCH_MAX_COLS];
  void* out8[AB_DISPATCH_MAX_COLS];
  int n8;
  const void* in4[AB_DISPATCH_MAX_COLS];
  void* out4[AB_DISPATCH_MAX_COLS];
  int n4;
  const void* in1[AB_DISPATCH_MAX_COLS];
  void* out1[AB_DISPATCH_MAX_COLS];
  int n1;
};

// Per-bucket counts of a thread's rows, NW 32-bit words of two 16-bit
// fields (bucket b in word b / 2, bits 16 (b % 2)).  A field never
// carries into the next: a tile holds AB_DISPATCH_TILE < 2^16 rows.
template <int NW>
struct Packed {
  unsigned w[NW];
};

template <int NW>
__device__ __forceinline__ void pk_add(Packed<NW>& p, int b) {
#pragma unroll
  for (int i = 0; i < NW; ++i) p.w[i] += (b >> 1) == i ? 1u << ((b & 1) * 16) : 0u;
}

template <int NW>
__device__ __forceinline__ unsigned pk_get(const Packed<NW>& p, int b) {
  unsigned x = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) x = (b >> 1) == i ? p.w[i] : x;
  return (x >> ((b & 1) * 16)) & 0xffffu;
}

// The buckets of rows base + 8 t .. + 7 of thread t (AB_NO_BUCKET for a
// dead row, a dest outside [0, n_dest) or a row past n), from one 8-byte
// mask load and two 16-byte dest loads where the rows are all in range and
// the pointers aligned, else row by row.
__device__ __forceinline__ void dispatch_buckets(const int32_t* __restrict__ dest,
                                                 const uint8_t* __restrict__ mask, long long n,
                                                 int n_dest, long long base,
                                                 int (&b)[AB_DISPATCH_ROWS]) {
  const long long r0 = base + (long long)threadIdx.x * AB_DISPATCH_ROWS;
  if (r0 + AB_DISPATCH_ROWS <= n && (reinterpret_cast<uintptr_t>(mask + r0) & 7) == 0 &&
      (reinterpret_cast<uintptr_t>(dest + r0) & 15) == 0) {
    const uint2 m = __ldg(reinterpret_cast<const uint2*>(mask + r0));
    const int4 d0 = __ldg(reinterpret_cast<const int4*>(dest + r0));
    const int4 d1 = __ldg(reinterpret_cast<const int4*>(dest + r0 + 4));
    const int d[AB_DISPATCH_ROWS] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int r = 0; r < AB_DISPATCH_ROWS; ++r) {
      const unsigned live = ((r < 4 ? m.x : m.y) >> (8 * (r & 3))) & 0xffu;
      b[r] = live && d[r] >= 0 && d[r] < n_dest ? d[r] : AB_NO_BUCKET;
    }
  } else {
#pragma unroll
    for (int r = 0; r < AB_DISPATCH_ROWS; ++r) {
      const long long i = r0 + r;
      int x = AB_NO_BUCKET;
      if (i < n && mask[i]) {
        const int d = dest[i];
        if (d >= 0 && d < n_dest) x = d;
      }
      b[r] = x;
    }
  }
}

// Launch 1.  grid: max(ceil(tiles / AB_DISPATCH_COUNT_TILES), 1) blocks (a
// call with no rows still writes counts and the flag), each counting
// AB_DISPATCH_COUNT_TILES scatter tiles; tile_counts: int32[n_dest][tiles];
// ticket: zero between launches, back to zero when the last block is done.
template <int NW>
__global__ void __launch_bounds__(AB_DISPATCH_THREADS)
    k17_count(const int32_t* __restrict__ dest, const uint8_t* __restrict__ mask, long long n,
              int n_dest, long long capacity, long long tiles, int* __restrict__ tile_counts,
              int* __restrict__ counts, uint8_t* __restrict__ overflow,
              unsigned long long* __restrict__ ticket) {
  __shared__ unsigned wsum[AB_DISPATCH_COUNT_TILES][AB_DISPATCH_WARPS][NW];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * AB_DISPATCH_COUNT_TILES;
  // Any rows of a tile count it: here thread t takes rows 4 t .. 4 t + 3
  // and 1,024 + 4 t .. + 3 of each tile, so each load of a warp is 512
  // contiguous bytes of dest and 128 of mask, every tile's loads issued
  // before the first is used.
  constexpr int HALF = AB_DISPATCH_TILE / 2;
  int b[AB_DISPATCH_COUNT_TILES][AB_DISPATCH_ROWS];
  if ((first + AB_DISPATCH_COUNT_TILES) * AB_DISPATCH_TILE <= n &&
      (reinterpret_cast<uintptr_t>(dest) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
    int4 d[AB_DISPATCH_COUNT_TILES][2];
    unsigned m[AB_DISPATCH_COUNT_TILES][2];
#pragma unroll
    for (int u = 0; u < AB_DISPATCH_COUNT_TILES; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = (first + u) * AB_DISPATCH_TILE + h * HALF + 4 * threadIdx.x;
        d[u][h] = __ldg(reinterpret_cast<const int4*>(dest + r));
        m[u][h] = __ldg(reinterpret_cast<const unsigned*>(mask + r));
      }
#pragma unroll
    for (int u = 0; u < AB_DISPATCH_COUNT_TILES; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x[4] = {d[u][h].x, d[u][h].y, d[u][h].z, d[u][h].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool live = (m[u][h] >> (8 * q)) & 0xffu;
          b[u][4 * h + q] = live && x[q] >= 0 && x[q] < n_dest ? x[q] : AB_NO_BUCKET;
        }
      }
  } else {  // the last rows, or inputs not so aligned: row by row
#pragma unroll
    for (int u = 0; u < AB_DISPATCH_COUNT_TILES; ++u)
#pragma unroll
      for (int r = 0; r < AB_DISPATCH_ROWS; ++r) {
        const long long i =
            (first + u) * AB_DISPATCH_TILE + (r / 4) * HALF + 4 * threadIdx.x + r % 4;
        int x = AB_NO_BUCKET;
        if (i < n && mask[i]) {
          const int dd = dest[i];
          if (dd >= 0 && dd < n_dest) x = dd;
        }
        b[u][r] = x;
      }
  }
#pragma unroll
  for (int u = 0; u < AB_DISPATCH_COUNT_TILES; ++u) {
    Packed<NW> p;
#pragma unroll
    for (int i = 0; i < NW; ++i) p.w[i] = 0;
#pragma unroll
    for (int r = 0; r < AB_DISPATCH_ROWS; ++r) pk_add(p, b[u][r]);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const unsigned s = __reduce_add_sync(0xffffffffu, p.w[i]);  // fields <= 256
      if (lane == 0) wsum[u][warp][i] = s;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < AB_DISPATCH_COUNT_TILES * n_dest; k += AB_DISPATCH_THREADS) {
    const int u = k / n_dest, bb = k % n_dest;
    if (first + u < tiles) {
      unsigned c = 0;
      for (int w = 0; w < AB_DISPATCH_WARPS; ++w)
        c += (wsum[u][w][bb >> 1] >> ((bb & 1) * 16)) & 0xffffu;
      tile_counts[(long long)bb * tiles + first + u] = (int)c;
      __threadfence();  // before this block's ticket
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) last = ab_last_block(ticket);
  __syncthreads();
  if (!last) return;
  // the last block: the tile counts of four buckets at a time, packed two
  // to a 64-bit word (a 32-bit half never carries: n < 2^31), scanned over
  // the block in place (exclusive: each tile's first rank), one contiguous
  // run of tiles a thread
  const long long per = (tiles + AB_DISPATCH_THREADS - 1) / AB_DISPATCH_THREADS;
  const long long t0 = min(tiles, (long long)threadIdx.x * per), t1 = min(tiles, t0 + per);
  __shared__ unsigned long long ws[AB_DISPATCH_WARPS][2];
  bool over = false;
  for (int b0 = 0; b0 < n_dest; b0 += 4) {
    int* col[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      col[q] = b0 + q < n_dest ? tile_counts + (long long)(b0 + q) * tiles : nullptr;
    unsigned long long v[AB_DISPATCH_SCAN_BATCH][2];
    unsigned long long sum[2] = {0, 0};
    const bool held = per <= AB_DISPATCH_SCAN_BATCH;
    auto load = [&](long long t) {  // loads in flight together
#pragma unroll
      for (int j = 0; j < AB_DISPATCH_SCAN_BATCH; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in = t + j < t1;
          const int* c0 = col[2 * h];
          const int* c1 = col[2 * h + 1];
          const unsigned lo = in && c0 ? (unsigned)__ldcg(c0 + t + j) : 0u;
          const unsigned hi = in && c1 ? (unsigned)__ldcg(c1 + t + j) : 0u;
          v[j][h] = lo | ((unsigned long long)hi << 32);
        }
    };
    for (long long t = t0; t < t1; t += AB_DISPATCH_SCAN_BATCH) {
      load(t);
#pragma unroll
      for (int j = 0; j < AB_DISPATCH_SCAN_BATCH; ++j) {
        sum[0] += v[j][0];
        sum[1] += v[j][1];
      }
    }
    // exclusive scan of both words over the block: the warps', then theirs
    unsigned long long x[2] = {sum[0], sum[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, x[h], o);
        if (lane >= o) x[h] += y;
      }
    if (lane == 31) {
      ws[warp][0] = x[0];
      ws[warp][1] = x[1];
    }
    __syncthreads();
    unsigned long long run[2], total[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      run[h] = x[h] - sum[h];
      for (int w = 0; w < AB_DISPATCH_WARPS; ++w) {
        if (w < warp) run[h] += ws[w][h];
        total[h] += ws[w][h];
      }
    }
    __syncthreads();  // ws is read before the next pass writes it
    for (long long t = t0; t < t1; t += AB_DISPATCH_SCAN_BATCH) {
      if (!held) load(t);
#pragma unroll
      for (int j = 0; j < AB_DISPATCH_SCAN_BATCH; ++j) {
        if (t + j < t1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (col[2 * h]) col[2 * h][t + j] = (int)(unsigned)run[h];
            if (col[2 * h + 1]) col[2 * h + 1][t + j] = (int)(unsigned)(run[h] >> 32);
          }
        }
        run[0] += v[j][0];
        run[1] += v[j][1];
      }
    }
    if (threadIdx.x < 4 && b0 + threadIdx.x < n_dest) {
      const unsigned c = (unsigned)(total[threadIdx.x >> 1] >> (32 * (threadIdx.x & 1)));
      counts[b0 + threadIdx.x] = (int)c;
      over |= (long long)c > capacity;
    }
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    *overflow = over;
    *ticket = 0;
  }
}

// Zeroes bytes [lo, hi): the ends byte by byte, the 16-byte words between
// them by the block's threads.
__device__ __forceinline__ void dispatch_zero(uintptr_t lo, uintptr_t hi) {
  if (lo >= hi) return;
  const uintptr_t a = min(hi, (lo + 15) & ~(uintptr_t)15);
  const uintptr_t z = max(a, hi & ~(uintptr_t)15);
  if (threadIdx.x < a - lo) *reinterpret_cast<uint8_t*>(lo + threadIdx.x) = 0;
  if (threadIdx.x < hi - z) *reinterpret_cast<uint8_t*>(z + threadIdx.x) = 0;
  uint4* w = reinterpret_cast<uint4*>(a);
  const long long words = (long long)(z - a) / 16;
  for (long long j = threadIdx.x; j < words; j += AB_DISPATCH_THREADS)
    w[j] = make_uint4(0u, 0u, 0u, 0u);
}

// A zero-tail block's part of one buffer of `width`-byte elements:
// slots [lo, hi) of bucket b.
__device__ __forceinline__ void dispatch_tail(void* buf, int width, long long b, long long lo,
                                              long long hi, long long capacity) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(buf) + (uintptr_t)(b * capacity * width);
  dispatch_zero(base + (uintptr_t)(lo * width), base + (uintptr_t)(hi * width));
}

// a prefetch into L2 of the line holding p (no register, no wait)
__device__ __forceinline__ void dispatch_prefetch(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One column of a tile: each thread reads its sorted positions' rows (all
// loads in flight before the stores) and writes them to their slots.
template <typename T>
__device__ __forceinline__ void dispatch_column(const T* __restrict__ in, T* __restrict__ out,
                                                long long base,
                                                const int (&src)[AB_DISPATCH_ROWS],
                                                const long long (&slot)[AB_DISPATCH_ROWS]) {
  T v[AB_DISPATCH_ROWS];
#pragma unroll
  for (int k = 0; k < AB_DISPATCH_ROWS; ++k)
    v[k] = slot[k] >= 0 ? __ldg(in + base + src[k]) : T(0);
#pragma unroll
  for (int k = 0; k < AB_DISPATCH_ROWS; ++k)
    if (slot[k] >= 0) out[slot[k]] = v[k];
}

// Launch 2.  grid: tiles + n_dest * chunks zero-tail blocks (chunks =
// ceil(capacity / AB_DISPATCH_TAIL_SLOTS)); tile_offsets: launch 1's
// scratch, each tile's first rank in each bucket; counts: launch 1's;
// out_mask may be null (a later column group: the first wrote it).
template <int NW>
__global__ void __launch_bounds__(AB_DISPATCH_THREADS, NW <= 8 ? 4 : 2)
    k17_scatter(const int32_t* __restrict__ dest, const uint8_t* __restrict__ mask, long long n,
                int n_dest, long long capacity, long long tiles, long long chunks,
                const int* __restrict__ tile_offsets, const int* __restrict__ counts,
                DispatchCols cols, uint8_t* __restrict__ out_mask) {
  __shared__ unsigned short src_of[AB_DISPATCH_TILE];  // sorted position -> tile row
  __shared__ unsigned char bkt_of[AB_DISPATCH_TILE];   // sorted position -> bucket
  __shared__ unsigned wsum[AB_DISPATCH_WARPS][NW];
  __shared__ int start[AB_DISPATCH_MAX_DEST + 1];   // a bucket's first sorted position
  __shared__ long long sbase[AB_DISPATCH_MAX_DEST];  // slot of position p: sbase[b] + p
  __shared__ int slimit[AB_DISPATCH_MAX_DEST];       // positions below are placed
  if ((long long)blockIdx.x >= tiles) {  // a zero-tail block: chunk j of bucket b
    const long long k = (long long)blockIdx.x - tiles;
    const long long b = k / chunks, j = k % chunks;
    const long long lo = max(j * AB_DISPATCH_TAIL_SLOTS, min((long long)counts[b], capacity));
    const long long hi = min((j + 1) * AB_DISPATCH_TAIL_SLOTS, capacity);
    if (lo >= hi) return;  // a filled chunk
    if (out_mask) dispatch_tail(out_mask, 1, b, lo, hi, capacity);
    for (int c = 0; c < cols.n8; ++c) dispatch_tail(cols.out8[c], 8, b, lo, hi, capacity);
    for (int c = 0; c < cols.n4; ++c) dispatch_tail(cols.out4[c], 4, b, lo, hi, capacity);
    for (int c = 0; c < cols.n1; ++c) dispatch_tail(cols.out1[c], 1, b, lo, hi, capacity);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const long long base = tile * AB_DISPATCH_TILE;
  int b[AB_DISPATCH_ROWS];
  dispatch_buckets(dest, mask, n, n_dest, base, b);
  // warp 0: the tile's first rank in buckets lane and lane + 32, read now so
  // the load overlaps the ranking
  long long off[2] = {0, 0};
  if (warp == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < n_dest) off[h] = tile_offsets[(long long)(lane + 32 * h) * tiles + tile];
  }
  // the thread's own rows of every column into L2 while the tile is ranked
  // and sorted, so the gathers below find them there
  const long long own0 = base + (long long)threadIdx.x * AB_DISPATCH_ROWS;
  if (own0 < n) {
    for (int c = 0; c < cols.n8; ++c) dispatch_prefetch((const uint64_t*)cols.in8[c] + own0);
    for (int c = 0; c < cols.n4; ++c) dispatch_prefetch((const uint32_t*)cols.in4[c] + own0);
    for (int c = 0; c < cols.n1; ++c) dispatch_prefetch((const uint8_t*)cols.in1[c] + own0);
  }
  // each bucket's rows of the lower threads: a warp scan of the packed
  // counts, then the lower warps' totals
  Packed<NW> own, inc;
#pragma unroll
  for (int i = 0; i < NW; ++i) own.w[i] = 0;
#pragma unroll
  for (int r = 0; r < AB_DISPATCH_ROWS; ++r) pk_add(own, b[r]);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    unsigned x = own.w[i];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    inc.w[i] = x;
    if (lane == 31) wsum[warp][i] = x;
  }
  __syncthreads();
  if (warp == 0) {  // the buckets' first sorted positions: a scan of the tile's totals
    int tot[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bb = lane + 32 * h;
      unsigned c = 0;
      if (bb < n_dest)
        for (int w = 0; w < AB_DISPATCH_WARPS; ++w)
          c += (wsum[w][bb >> 1] >> ((bb & 1) * 16)) & 0xffffu;
      tot[h] = (int)c;
    }
    int carry = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int x = tot[h];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int bb = lane + 32 * h;
      const int first = carry + x - tot[h];
      if (bb < n_dest) {
        start[bb] = first;
        sbase[bb] = bb * capacity + off[h] - first;
        slimit[bb] = first + (int)max(0LL, min((long long)tot[h], capacity - off[h]));
      }
      if (bb == n_dest) start[bb] = first;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0 && n_dest == AB_DISPATCH_MAX_DEST) start[n_dest] = carry;
  }
  __syncthreads();
  // each row's sorted position: its bucket's start, the lower threads' and
  // warps' rows of the bucket, then this thread's earlier ones
  Packed<NW> pos;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    unsigned lower = inc.w[i] - own.w[i];  // fieldwise: no borrow
    for (int w = 0; w < warp; ++w) lower += wsum[w][i];
    const int b0 = 2 * i, b1 = 2 * i + 1;
    const unsigned s0 = b0 < n_dest ? (unsigned)start[b0] : 0u;
    const unsigned s1 = b1 < n_dest ? (unsigned)start[b1] : 0u;
    pos.w[i] = lower + s0 + (s1 << 16);
  }
#pragma unroll
  for (int r = 0; r < AB_DISPATCH_ROWS; ++r) {
    if (b[r] < n_dest) {
      const unsigned p = pk_get(pos, b[r]);
      pk_add(pos, b[r]);
      src_of[p] = (unsigned short)(threadIdx.x * AB_DISPATCH_ROWS + r);
      bkt_of[p] = (unsigned char)b[r];
    }
  }
  __syncthreads();
  // thread t writes sorted positions t, t + 256, ...: a warp's are one
  // run of consecutive slots inside a bucket
  const int placed = start[n_dest];
  int src[AB_DISPATCH_ROWS];
  long long slot[AB_DISPATCH_ROWS];
#pragma unroll
  for (int k = 0; k < AB_DISPATCH_ROWS; ++k) {
    const int p = k * AB_DISPATCH_THREADS + threadIdx.x;
    src[k] = 0;
    slot[k] = -1;
    if (p < placed) {
      const int bb = bkt_of[p];
      src[k] = src_of[p];
      if (p < slimit[bb]) slot[k] = sbase[bb] + p;
    }
  }
  if (out_mask) {
#pragma unroll
    for (int k = 0; k < AB_DISPATCH_ROWS; ++k)
      if (slot[k] >= 0) out_mask[slot[k]] = 1;
  }
  for (int c = 0; c < cols.n8; ++c)
    dispatch_column<unsigned long long>((const unsigned long long*)cols.in8[c],
                                        (unsigned long long*)cols.out8[c], base, src, slot);
  for (int c = 0; c < cols.n4; ++c)
    dispatch_column<uint32_t>((const uint32_t*)cols.in4[c], (uint32_t*)cols.out4[c], base, src,
                              slot);
  for (int c = 0; c < cols.n1; ++c)
    dispatch_column<uint8_t>((const uint8_t*)cols.in1[c], (uint8_t*)cols.out1[c], base, src,
                             slot);
}

static inline long long dispatch_tiles(long long n) {
  return (n + AB_DISPATCH_TILE - 1) / AB_DISPATCH_TILE;
}

// int32 scratch a call needs: one count a tile and bucket
AB_EXPORT long long ab_dispatch_scratch_ints(long long n, int n_dest) {
  return dispatch_tiles(n) * (long long)n_dest;
}

static inline int dispatch_args_ok(long long n, int n_dest, long long capacity) {
  return n >= 0 && n <= 0x7fffffffLL && n_dest >= 1 && n_dest <= AB_DISPATCH_MAX_DEST &&
         capacity >= 1;
}

// Launch 1.  dest: int32[n]; mask: bool[n]; counts: int32[n_dest];
// overflow: bool[1]; scratch: int32[ab_dispatch_scratch_ints(n, n_dest)];
// acc: the stream's accumulator, uint64[2], zero between launches (its
// second word is the ticket)
AB_EXPORT int ab_dispatch_count(const void* dest, const void* mask, long long n, int n_dest,
                                long long capacity, void* counts, void* overflow, void* scratch,
                                void* acc, void* stream) {
  if (!dispatch_args_ok(n, n_dest, capacity) || acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = dispatch_tiles(n);
  const long long blocks = (tiles + AB_DISPATCH_COUNT_TILES - 1) / AB_DISPATCH_COUNT_TILES;
  const unsigned grid = blocks > 0 ? (unsigned)blocks : 1u;
  unsigned long long* ticket = (unsigned long long*)acc + 1;
#define AB_K17_COUNT(NW)                                                                        \
  k17_count<NW><<<grid, AB_DISPATCH_THREADS, 0, s>>>(                                           \
      (const int32_t*)dest, (const uint8_t*)mask, n, n_dest, capacity, tiles, (int*)scratch,   \
      (int*)counts, (uint8_t*)overflow, ticket)
  if (n_dest <= 4) AB_K17_COUNT(2);
  else if (n_dest <= 8) AB_K17_COUNT(4);
  else if (n_dest <= 16) AB_K17_COUNT(8);
  else AB_K17_COUNT(32);
#undef AB_K17_COUNT
  return ab_last_error();
}

// Launch 2, after ab_dispatch_count on the same stream and scratch.  cols:
// a DispatchCols (host memory) whose outputs hold n_dest * capacity
// elements each; out_mask: bool[n_dest * capacity], or null to leave the
// mask alone
AB_EXPORT int ab_dispatch_scatter(const void* dest, const void* mask, long long n, int n_dest,
                                  long long capacity, const void* cols, void* out_mask,
                                  const void* counts, const void* scratch, void* stream) {
  if (!dispatch_args_ok(n, n_dest, capacity)) return (int)cudaErrorInvalidValue;
  const DispatchCols* c = (const DispatchCols*)cols;
  if (c->n8 < 0 || c->n8 > AB_DISPATCH_MAX_COLS || c->n4 < 0 || c->n4 > AB_DISPATCH_MAX_COLS ||
      c->n1 < 0 || c->n1 > AB_DISPATCH_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = dispatch_tiles(n);
  // the zero tail: one block a chunk of AB_DISPATCH_TAIL_SLOTS slots of a bucket
  const long long chunks = (capacity + AB_DISPATCH_TAIL_SLOTS - 1) / AB_DISPATCH_TAIL_SLOTS;
  const long long blocks = tiles + n_dest * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define AB_K17_SCATTER(NW)                                                                     \
  k17_scatter<NW><<<(unsigned)blocks, AB_DISPATCH_THREADS, 0, s>>>(                           \
      (const int32_t*)dest, (const uint8_t*)mask, n, n_dest, capacity, tiles, chunks,          \
      (const int*)scratch, (const int*)counts, *c, (uint8_t*)out_mask)
  if (n_dest <= 4) AB_K17_SCATTER(2);
  else if (n_dest <= 8) AB_K17_SCATTER(4);
  else if (n_dest <= 16) AB_K17_SCATTER(8);
  else AB_K17_SCATTER(32);
#undef AB_K17_SCATTER
  return ab_last_error();
}
