// K9-K11: the kernels of the clustered (presorted) partial aggregate, the
// grouping that q18's subquery takes over key-clustered parquet
// (scheduler/physical_planner.py _clustered_having_pushdown).
//
// K9 presorted_disorder replaces the disorder flag of
// arrow_ballista_tpu/ops/kernels.py grouped_aggregate_presorted (l.237):
//   disorder = any(live[i] & live[i-1] & k[i] < k[i-1]) over the rows in
//   K2's compaction order.  One thread a row reads k[i-1] itself, so pairs
//   that straddle block edges are seen; __syncthreads_or folds a block and
//   one thread stores the flag.
// K10 key_range_check replaces "sort.range_check"
// (arrow_ballista_tpu/ops/operators.py:632-654):
//   live = mask & (k != NULL sentinel, when the key is nullable);
//   mismatch = any(live) & (min(k over live) < lo | max(k over live) > hi).
//   Each block reduces its live min and max with warp shuffles and stores
//   the flag when its own extremes leave [lo, hi]; the OR over blocks of
//   that test is the test on the global extremes.
// K11 clustered_keep replaces "agg.clustered_keep" (operators.py:672-697):
//   keep = mask & (any_j(lo_j <= k <= hi_j) | pred); live = sum(keep).
//   The intervals sit in shared memory (tiles of 1024 pairs); each thread
//   writes one keep byte a row, and each block adds its live count with one
//   64-bit atomic.
// Keys are int32 (widened, as the reference's astype(int64)) or int64.
// The flag and the count are zeroed by cudaMemsetAsync on the stream
// before the launch; nothing synchronises.
// Bound: bytes (keys, mask and predicate read once, the keep bytes written
// once).  K11 also does n x intervals compares: at the main path's at most
// 17 intervals that stays far under the card's integer rate.
#include <limits.h>

#include "common.cuh"

#define AB_KEEP_TILE 1024

template <typename T>
__global__ void presorted_disorder(const T* __restrict__ k, const uint8_t* __restrict__ mask,
                                   long long n, uint8_t* __restrict__ flag) {
  bool bad = false;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = 1 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    bad = bad || (mask[i] && mask[i - 1] && k[i] < k[i - 1]);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

template <typename T>
__global__ void key_range_check(const T* __restrict__ k, const uint8_t* __restrict__ mask,
                                long long n, int has_sentinel, long long sentinel, long long lo,
                                long long hi, uint8_t* __restrict__ flag) {
  __shared__ long long wmin[32], wmax[32];
  __shared__ int wany[32];
  long long kmin = LLONG_MAX, kmax = LLONG_MIN;
  int any = 0;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    if (!mask[i]) continue;
    long long v = (long long)k[i];
    if (has_sentinel && v == sentinel) continue;  // NULL keys: outside every stats range
    any = 1;
    kmin = v < kmin ? v : kmin;
    kmax = v > kmax ? v : kmax;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long a = __shfl_down_sync(0xffffffffu, kmin, o);
    long long b = __shfl_down_sync(0xffffffffu, kmax, o);
    kmin = a < kmin ? a : kmin;
    kmax = b > kmax ? b : kmax;
    any |= __shfl_down_sync(0xffffffffu, any, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wmin[warp] = kmin;
    wmax[warp] = kmax;
    wany[warp] = any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      kmin = wmin[w] < kmin ? wmin[w] : kmin;
      kmax = wmax[w] > kmax ? wmax[w] : kmax;
      any |= wany[w];
    }
    if (any && (kmin < lo || kmax > hi)) *flag = 1;
  }
}

template <typename T>
__global__ void clustered_keep(const T* __restrict__ k, const uint8_t* __restrict__ mask,
                               const uint8_t* __restrict__ pred, long long n,
                               const long long* __restrict__ los,
                               const long long* __restrict__ his, int m,
                               uint8_t* __restrict__ keep, unsigned long long* __restrict__ live) {
  __shared__ long long s_lo[AB_KEEP_TILE], s_hi[AB_KEEP_TILE];
  __shared__ unsigned long long wsum[32];
  unsigned long long count = 0;
  const bool one_tile = m <= AB_KEEP_TILE;
  if (one_tile) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      s_lo[j] = los[j];
      s_hi[j] = his[j];
    }
    __syncthreads();
  }
  long long step = (long long)gridDim.x * blockDim.x;
  // the loop bound is the same for every thread of a block, so the tiled
  // form below may synchronise inside it
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += step) {
    const long long i = base + threadIdx.x;
    const bool row = i < n;
    const long long v = row ? (long long)k[i] : 0;
    bool shared = false;
    for (int t0 = 0; t0 < m; t0 += AB_KEEP_TILE) {
      const int cnt = m - t0 < AB_KEEP_TILE ? m - t0 : AB_KEEP_TILE;
      if (!one_tile) {
        __syncthreads();
        for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
          s_lo[j] = los[t0 + j];
          s_hi[j] = his[t0 + j];
        }
        __syncthreads();
      }
      for (int j = 0; j < cnt && !shared; ++j) shared = s_lo[j] <= v && v <= s_hi[j];
    }
    if (row) {
      const bool kp = mask[i] && (shared || pred[i]);
      keep[i] = kp;
      count += kp;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wsum[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) count += wsum[w];
    if (count) atomicAdd(live, count);
  }
}

static inline bool key_kind_ok(int kind) { return kind == AB_KIND_I32 || kind == AB_KIND_I64; }

// k: int32 or int64[n] (kind); mask: bool[n]; flag: bool[1]
AB_EXPORT int ab_presorted_disorder(const void* k, int kind, const void* mask, long long n,
                                    void* flag, void* stream) {
  if (n < 0 || !key_kind_ok(kind)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(flag, 0, 1, s);
  if (err || n < 2) return err;
  const int threads = 256, grid = ab_grid(n - 1, threads, 132 * 8);
  if (kind == AB_KIND_I32)
    presorted_disorder<int32_t><<<grid, threads, 0, s>>>((const int32_t*)k,
                                                         (const uint8_t*)mask, n, (uint8_t*)flag);
  else
    presorted_disorder<int64_t><<<grid, threads, 0, s>>>((const int64_t*)k,
                                                         (const uint8_t*)mask, n, (uint8_t*)flag);
  return ab_last_error();
}

// flag: bool[1]; sentinel ignored unless has_sentinel
AB_EXPORT int ab_key_range_check(const void* k, int kind, const void* mask, long long n,
                                 int has_sentinel, long long sentinel, long long lo,
                                 long long hi, void* flag, void* stream) {
  if (n < 0 || !key_kind_ok(kind)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(flag, 0, 1, s);
  if (err || n == 0) return err;
  const int threads = 256, grid = ab_grid(n, threads, 132 * 8);
  if (kind == AB_KIND_I32)
    key_range_check<int32_t><<<grid, threads, 0, s>>>((const int32_t*)k, (const uint8_t*)mask,
                                                      n, has_sentinel, sentinel, lo, hi,
                                                      (uint8_t*)flag);
  else
    key_range_check<int64_t><<<grid, threads, 0, s>>>((const int64_t*)k, (const uint8_t*)mask,
                                                      n, has_sentinel, sentinel, lo, hi,
                                                      (uint8_t*)flag);
  return ab_last_error();
}

// pred, keep: bool[n]; los, his: int64[m]; live: int64[1]
AB_EXPORT int ab_clustered_keep(const void* k, int kind, const void* mask, const void* pred,
                                long long n, const void* los, const void* his, int m,
                                void* keep, void* live, void* stream) {
  if (n < 0 || m < 0 || !key_kind_ok(kind)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(live, 0, 8, s);
  if (err || n == 0) return err;
  const int threads = 256, grid = ab_grid(n, threads, 132 * 8);
  if (kind == AB_KIND_I32)
    clustered_keep<int32_t><<<grid, threads, 0, s>>>(
        (const int32_t*)k, (const uint8_t*)mask, (const uint8_t*)pred, n, (const long long*)los,
        (const long long*)his, m, (uint8_t*)keep, (unsigned long long*)live);
  else
    clustered_keep<int64_t><<<grid, threads, 0, s>>>(
        (const int64_t*)k, (const uint8_t*)mask, (const uint8_t*)pred, n, (const long long*)los,
        (const long long*)his, m, (uint8_t*)keep, (unsigned long long*)live);
  return ab_last_error();
}
