// K5: build_side_sort — the join's build side, hashed and sorted by hash.
//
// Replaces arrow_ballista_tpu/ops/kernels.py build_side_sort (l.728), the
// "join.prep" program of JoinExec (operators.py:1205).  The reference
// hashes the build keys (hash64), gives dead rows 0xFFFF...FFFF, and
// returns (h[order], order, live count) with order = jnp.argsort(h), which
// is stable: rows with equal hashes keep their build-row order.  The probe
// expansion's pair order depends on that, so the order here is equal bit
// for bit, not only the sorted hashes.
//
// Design: one launch hashes each row with common.cuh's ab_hash_row (the
// same function as K3, so probe and build hashes agree) and counts the
// live rows; then a stable LSD radix sort of the (uint64 hash, int32 row)
// pairs, 8-bit digits over 8 passes.  Each pass: a per-tile histogram of
// the digit (shared-memory atomics), written digit-major so that one
// device-wide exclusive scan (common.cuh, K2's scheme) gives every
// (digit, tile) its output offset; then a scatter in which each tile
// walks its rows in order, chunk by chunk, ranking equal digits within a
// warp with __match_any_sync and across warps with per-warp counts in
// shared memory, so equal digits land in row order (stable).
// Bound: bytes.  Each pass reads the keys twice and the rows once and
// writes both once (32 bytes a row), 8 passes; the one-pass minimum is
// the keys read once and the hashes and order written once.  Scatter
// writes land in up to 256 runs a tile.
#include "common.cuh"

#define RX_THREADS 256
#define RX_WARPS (RX_THREADS / 32)
#define RX_CHUNKS 16
#define RX_TILE (RX_THREADS * RX_CHUNKS)
#define RX_BINS 256
#define RX_PASSES 8

__global__ void build_hash_kernel(HashCols c, const uint8_t* __restrict__ mask, long long n,
                                  int zero, uint64_t* __restrict__ keys,
                                  int32_t* __restrict__ rows,
                                  unsigned long long* __restrict__ n_live) {
  long long step = (long long)gridDim.x * blockDim.x;
  unsigned long long live = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    bool m = mask[i] != 0;
    keys[i] = m ? (zero ? 0ULL : ab_hash_row(c, i)) : 0xFFFFFFFFFFFFFFFFULL;
    rows[i] = (int32_t)i;
    live += m;
  }
  if (live) atomicAdd(n_live, live);
}

__global__ void zero_u64(unsigned long long* p) { *p = 0ULL; }

// counts[d * num_tiles + tile] = rows of this tile whose digit is d
__global__ void radix_histogram(const uint64_t* __restrict__ keys, long long n, int shift,
                                int num_tiles, int* __restrict__ counts) {
  __shared__ int hist[RX_BINS];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RX_TILE;
#pragma unroll 4
  for (int j = 0; j < RX_CHUNKS; ++j) {
    long long i = base + (long long)j * RX_THREADS + threadIdx.x;
    if (i < n) atomicAdd(&hist[(int)((keys[i] >> shift) & 0xFF)], 1);
  }
  __syncthreads();
  counts[(long long)threadIdx.x * num_tiles + blockIdx.x] = hist[threadIdx.x];
}

// incl: inclusive scan of counts (digit-major); the tile's first row of
// digit d goes to incl - counts at [d * num_tiles + tile]
__global__ void radix_scatter(const uint64_t* __restrict__ keys_in,
                              const int32_t* __restrict__ rows_in, long long n, int shift,
                              int num_tiles, const int* __restrict__ counts,
                              const int* __restrict__ incl, uint64_t* __restrict__ keys_out,
                              int32_t* __restrict__ rows_out) {
  __shared__ int next[RX_BINS];                // next output position per digit
  __shared__ int warp_cnt[RX_WARPS][RX_BINS];  // this chunk's rows per warp and digit
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  {
    long long at = (long long)threadIdx.x * num_tiles + blockIdx.x;
    next[threadIdx.x] = incl[at] - counts[at];
    for (int w = 0; w < RX_WARPS; ++w) warp_cnt[w][threadIdx.x] = 0;
  }
  __syncthreads();
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * RX_TILE;
  for (int j = 0; j < RX_CHUNKS; ++j) {
    long long i = base + (long long)j * RX_THREADS + threadIdx.x;  // rows in order
    bool valid = i < n;
    uint64_t key = valid ? keys_in[i] : 0ULL;
    int digit = valid ? (int)((key >> shift) & 0xFF) : RX_BINS;  // tail lanes group apart
    unsigned peers = __match_any_sync(0xffffffffu, digit);
    int rank = __popc(peers & lt_mask);
    if (valid && rank == 0) warp_cnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (valid) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += warp_cnt[w][digit];
      int dest = next[digit] + before + rank;
      keys_out[dest] = key;
      rows_out[dest] = rows_in[i];
    }
    __syncthreads();
    int d = threadIdx.x;  // one thread per digit folds the chunk's counts
    int add = 0;
    for (int w = 0; w < RX_WARPS; ++w) {
      add += warp_cnt[w][d];
      warp_cnt[w][d] = 0;
    }
    next[d] += add;
    __syncthreads();
  }
}

static long long tiles_of(long long n) { return (n + RX_TILE - 1) / RX_TILE; }

// scratch layout (bytes, each part 16-byte aligned): keys u64[n], rows
// i32[n], counts i32[256 * tiles], incl i32[256 * tiles], scan tile sums
// i32[ab_scan_tiles(256 * tiles) + 1]

AB_EXPORT long long ab_build_scratch_bytes(long long n) {
  long long hist = (long long)RX_BINS * tiles_of(n);
  return ab_align16(n * 8) + ab_align16(n * 4) + 2 * ab_align16(hist * 4) +
         ab_align16((ab_scan_tiles(hist) + 1) * 4);
}

// hash_out: uint64[n] sorted (as int64 bits); order_out: int32[n];
// n_live: int64[1]; scratch: ab_build_scratch_bytes(n) bytes.
AB_EXPORT int ab_build_side_sort(const void* const* ptrs, const int* kinds, int k,
                                 const void* mask, long long n, int zero, void* hash_out,
                                 void* order_out, void* n_live, void* scratch, void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  HashCols c;
  int err = ab_fill_hash_cols(&c, ptrs, kinds, k);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = tiles_of(n);
  const long long hist = (long long)RX_BINS * tiles;
  char* p = (char*)scratch;
  uint64_t* keys_tmp = (uint64_t*)p;
  p += ab_align16(n * 8);
  int32_t* rows_tmp = (int32_t*)p;
  p += ab_align16(n * 4);
  int* counts = (int*)p;
  p += ab_align16(hist * 4);
  int* incl = (int*)p;
  p += ab_align16(hist * 4);
  int* scan_sums = (int*)p;

  // the passes ping-pong between the outputs and the scratch copies; an
  // even number of passes ends in the outputs
  uint64_t* keys[2] = {(uint64_t*)hash_out, keys_tmp};
  int32_t* rows[2] = {(int32_t*)order_out, rows_tmp};
  zero_u64<<<1, 1, 0, s>>>((unsigned long long*)n_live);
  err = ab_last_error();
  if (err) return err;
  const int threads = 256;
  build_hash_kernel<<<ab_grid(n, threads, 132 * 16), threads, 0, s>>>(
      c, (const uint8_t*)mask, n, zero, keys[0], rows[0], (unsigned long long*)n_live);
  err = ab_last_error();
  if (err) return err;
  for (int pass = 0; pass < RX_PASSES; ++pass) {
    const int src = pass & 1;
    const int shift = 8 * pass;
    radix_histogram<<<(unsigned)tiles, RX_THREADS, 0, s>>>(keys[src], n, shift, (int)tiles,
                                                           counts);
    err = ab_last_error();
    if (err) return err;
    err = ab_inclusive_scan<int, int, int>(counts, hist, incl, scan_sums, s);
    if (err) return err;
    radix_scatter<<<(unsigned)tiles, RX_THREADS, 0, s>>>(keys[src], rows[src], n, shift,
                                                         (int)tiles, counts, incl,
                                                         keys[src ^ 1], rows[src ^ 1]);
    err = ab_last_error();
    if (err) return err;
  }
  return 0;
}
