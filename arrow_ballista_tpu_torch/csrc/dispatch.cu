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
// Four launches, no atomics on the row order:
//   1. dispatch_count: each block histograms one tile of rows over the
//      buckets in shared memory -> block_counts[block][b];
//   2. dispatch_scan: block b scans column b of block_counts over the
//      blocks (exclusive, in place: the tile's first rank in bucket b) and
//      writes counts[b];
//   3. dispatch_tail: zeroes the slots past each bucket's count and
//      writes the overflow flag;
//   4. dispatch_scatter: each block walks its tile in row order, 256 rows
//      at a time; within a warp __match_any_sync groups the lanes of one
//      bucket and __popc of the lower lanes ranks them, the warps' bucket
//      counts in shared memory order the warps, and a running count per
//      bucket carries the rank across the chunks.  It writes every column
//      (8-, 4- and 1-byte ones from three pointer arrays) and the mask.
// Slot indices are 64-bit.  Bound: bytes (dest and mask read twice, each
// column read once, every buffer slot written once).
#include "common.cuh"

#define AB_DISPATCH_MAX_DEST 64
#define AB_DISPATCH_MAX_COLS 32
#define AB_DISPATCH_THREADS 256
#define AB_DISPATCH_CHUNKS 16
#define AB_DISPATCH_TILE (AB_DISPATCH_THREADS * AB_DISPATCH_CHUNKS)
#define AB_DISPATCH_WARPS (AB_DISPATCH_THREADS / 32)

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

// the bucket of row i, n_dest for a dead row or a dest outside [0, n_dest)
__device__ __forceinline__ int dispatch_bucket(const int32_t* __restrict__ dest,
                                               const uint8_t* __restrict__ mask, long long i,
                                               int n_dest) {
  if (!mask[i]) return n_dest;
  const int d = dest[i];
  return (d >= 0 && d < n_dest) ? d : n_dest;
}

__global__ void dispatch_count(const int32_t* __restrict__ dest, const uint8_t* __restrict__ mask,
                               long long n, int n_dest, int* __restrict__ block_counts) {
  __shared__ int cnt[AB_DISPATCH_MAX_DEST];
  for (int b = threadIdx.x; b < n_dest; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * AB_DISPATCH_TILE;
#pragma unroll 4
  for (int c = 0; c < AB_DISPATCH_CHUNKS; ++c) {
    const long long i = base + (long long)c * AB_DISPATCH_THREADS + threadIdx.x;
    if (i < n) {
      const int b = dispatch_bucket(dest, mask, i, n_dest);
      if (b < n_dest) atomicAdd(&cnt[b], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_dest; b += blockDim.x)
    block_counts[(long long)blockIdx.x * n_dest + b] = cnt[b];
}

// grid: n_dest blocks of AB_SCAN_TOP_THREADS
__global__ void dispatch_scan(int* __restrict__ block_counts, long long num_blocks, int n_dest,
                              int* __restrict__ counts) {
  __shared__ int ws[AB_SCAN_TOP_THREADS / 32];
  const int b = blockIdx.x;
  int carry = 0;
  for (long long start = 0; start < num_blocks; start += blockDim.x) {
    const long long t = start + threadIdx.x;
    const int v = (t < num_blocks) ? block_counts[t * n_dest + b] : 0;
    int total;
    const int ex = ab_block_exclusive_scan<int>(v, ws, &total);
    if (t < num_blocks) block_counts[t * n_dest + b] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) counts[b] = carry;
}

// grid: (x, n_dest); zeroes slots [min(counts[b], capacity), capacity) of
// bucket b in every buffer
__global__ void dispatch_tail(const int* __restrict__ counts, int n_dest, long long capacity,
                              DispatchCols cols, uint8_t* __restrict__ out_mask,
                              uint8_t* __restrict__ overflow) {
  const int b = blockIdx.y;
  if (b == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    bool o = false;
    for (int k = 0; k < n_dest; ++k) o |= (long long)counts[k] > capacity;
    *overflow = o;
  }
  const long long filled = min((long long)counts[b], capacity);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = filled + (long long)blockIdx.x * blockDim.x + threadIdx.x; j < capacity;
       j += step) {
    const long long s = (long long)b * capacity + j;
    out_mask[s] = 0;
    for (int c = 0; c < cols.n8; ++c) ((uint64_t*)cols.out8[c])[s] = 0;
    for (int c = 0; c < cols.n4; ++c) ((uint32_t*)cols.out4[c])[s] = 0;
    for (int c = 0; c < cols.n1; ++c) ((uint8_t*)cols.out1[c])[s] = 0;
  }
}

__global__ void __launch_bounds__(AB_DISPATCH_THREADS)
dispatch_scatter(const int32_t* __restrict__ dest, const uint8_t* __restrict__ mask, long long n,
                 int n_dest, long long capacity, const int* __restrict__ block_offsets,
                 DispatchCols cols, uint8_t* __restrict__ out_mask) {
  __shared__ int run[AB_DISPATCH_MAX_DEST];
  __shared__ int wc[AB_DISPATCH_WARPS][AB_DISPATCH_MAX_DEST + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int b = threadIdx.x; b < n_dest; b += blockDim.x)
    run[b] = block_offsets[(long long)blockIdx.x * n_dest + b];
  const long long base = (long long)blockIdx.x * AB_DISPATCH_TILE;
  for (int c = 0; c < AB_DISPATCH_CHUNKS; ++c) {
    const long long first = base + (long long)c * AB_DISPATCH_THREADS;
    if (first >= n) break;  // the same for every thread of the block
    for (int k = threadIdx.x; k < AB_DISPATCH_WARPS * (n_dest + 1); k += blockDim.x)
      wc[k / (n_dest + 1)][k % (n_dest + 1)] = 0;
    __syncthreads();
    const long long i = first + threadIdx.x;
    const int b = (i < n) ? dispatch_bucket(dest, mask, i, n_dest) : n_dest;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int in_warp = __popc(peers & lower);
    if (in_warp == 0) wc[warp][b] = __popc(peers);
    __syncthreads();
    if (b < n_dest) {
      long long rank = run[b] + in_warp;
      for (int w = 0; w < warp; ++w) rank += wc[w][b];
      if (rank < capacity) {
        const long long s = (long long)b * capacity + rank;
        out_mask[s] = 1;
        for (int k = 0; k < cols.n8; ++k)
          ((uint64_t*)cols.out8[k])[s] = ((const uint64_t*)cols.in8[k])[i];
        for (int k = 0; k < cols.n4; ++k)
          ((uint32_t*)cols.out4[k])[s] = ((const uint32_t*)cols.in4[k])[i];
        for (int k = 0; k < cols.n1; ++k)
          ((uint8_t*)cols.out1[k])[s] = ((const uint8_t*)cols.in1[k])[i];
      }
    }
    __syncthreads();  // every rank above has read run[]
    for (int bb = threadIdx.x; bb < n_dest; bb += blockDim.x) {
      int t = 0;
      for (int w = 0; w < AB_DISPATCH_WARPS; ++w) t += wc[w][bb];
      run[bb] += t;
    }
    __syncthreads();  // run[] is updated before the next chunk clears wc
  }
}

// int32 scratch the launch needs: one count per tile and bucket
AB_EXPORT long long ab_dispatch_scratch_ints(long long n, int n_dest) {
  return ((n + AB_DISPATCH_TILE - 1) / AB_DISPATCH_TILE) * (long long)n_dest;
}

// dest: int32[n]; mask: bool[n]; cols: a DispatchCols (host memory) whose
// outputs hold n_dest * capacity elements each; out_mask: bool[n_dest *
// capacity]; counts: int32[n_dest]; overflow: bool[1]; scratch: int32[
// ab_dispatch_scratch_ints(n, n_dest)]
AB_EXPORT int ab_dispatch_to_buckets(const void* dest, const void* mask, long long n, int n_dest,
                                     long long capacity, const void* cols, void* out_mask,
                                     void* counts, void* overflow, void* scratch, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || n_dest < 1 || n_dest > AB_DISPATCH_MAX_DEST || capacity < 1)
    return (int)cudaErrorInvalidValue;
  const DispatchCols* c = (const DispatchCols*)cols;
  if (c->n8 < 0 || c->n8 > AB_DISPATCH_MAX_COLS || c->n4 < 0 || c->n4 > AB_DISPATCH_MAX_COLS ||
      c->n1 < 0 || c->n1 > AB_DISPATCH_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long num_blocks = (n + AB_DISPATCH_TILE - 1) / AB_DISPATCH_TILE;
  int* block_counts = (int*)scratch;
  int err;
  if (num_blocks > 0) {
    dispatch_count<<<(unsigned)num_blocks, AB_DISPATCH_THREADS, 0, s>>>(
        (const int32_t*)dest, (const uint8_t*)mask, n, n_dest, block_counts);
    err = ab_last_error();
    if (err) return err;
  }
  dispatch_scan<<<n_dest, AB_SCAN_TOP_THREADS, 0, s>>>(block_counts, num_blocks, n_dest,
                                                        (int*)counts);
  err = ab_last_error();
  if (err) return err;
  const int threads = 256;
  dim3 tail_grid(ab_grid(capacity, threads, 132 * 8 / n_dest + 1), n_dest);
  dispatch_tail<<<tail_grid, threads, 0, s>>>((const int*)counts, n_dest, capacity, *c,
                                              (uint8_t*)out_mask, (uint8_t*)overflow);
  err = ab_last_error();
  if (err || num_blocks == 0) return err;
  dispatch_scatter<<<(unsigned)num_blocks, AB_DISPATCH_THREADS, 0, s>>>(
      (const int32_t*)dest, (const uint8_t*)mask, n, n_dest, capacity, block_counts, *c,
      (uint8_t*)out_mask);
  return ab_last_error();
}
