// Shared helpers of the port's hand-written kernels.  Every source in this
// directory is built on its own by nvcc for sm_90a into a shared library
// with a plain C interface (ops/_cuda.py) and bound with ctypes: no
// PyTorch headers, so each file builds in seconds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define AB_EXPORT extern "C" __attribute__((visibility("default")))

// element kinds a wrapper may hand a kernel (ops/kernels.py _KIND)
#define AB_KIND_I32 0
#define AB_KIND_I64 1
#define AB_KIND_BOOL 2
#define AB_KIND_F32 3
#define AB_KIND_F64 4

// grid for a grid-stride loop over n items: enough blocks to fill the
// card's 132 SMs several times over, never more than the items need
static inline int ab_grid(long long n, int threads, int max_blocks) {
  long long b = (n + threads - 1) / threads;
  if (b > max_blocks) b = max_blocks;
  if (b < 1) b = 1;
  return (int)b;
}

static inline int ab_last_error() { return (int)cudaGetLastError(); }

// A kernel's dynamic shared-memory limit, raised once a device: the bytes
// already set on each device (zero at load).  The attribute call costs
// host time that a call of a few microseconds of device work would pay on
// every launch.
#define AB_MAX_DEVICES 64
struct AbSmemLimit {
  std::atomic<int> bytes[AB_MAX_DEVICES];
};

// Sets kernel's limit to at least `bytes` on the current device, unless
// `limit` says it already is.
template <typename Kernel>
static inline int ab_smem_limit(Kernel* kernel, int bytes, AbSmemLimit& limit) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const bool kept = dev >= 0 && dev < AB_MAX_DEVICES;
  if (kept && limit.bytes[dev].load(std::memory_order_acquire) >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err || !kept) return err;
  int seen = limit.bytes[dev].load(std::memory_order_relaxed);
  while (seen < bytes && !limit.bytes[dev].compare_exchange_weak(seen, bytes)) {
  }
  return 0;
}

// scratch carving: each part of a scratch buffer starts 16-byte aligned
static inline long long ab_align16(long long bytes) { return (bytes + 15) & ~15LL; }

// The last-block-done step of a one-launch reduction across blocks: a
// block's thread 0 calls it after folding its partial into an accumulator
// with atomics, and it returns true in the one block that draws the last
// ticket, which then sees every block's partial.  That block reads the
// accumulator, writes the result and puts the accumulator and *ticket
// back to their identities, so the next launch on the same stream (the
// wrappers keep one accumulator per device and stream) needs no memset.
__device__ __forceinline__ bool ab_last_block(unsigned long long* ticket) {
  __threadfence();  // this block's partial before its ticket
  const bool last = atomicAdd(ticket, 1ULL) == (unsigned long long)gridDim.x - 1;
  if (last) __threadfence();  // every other block's partial before the reads
  return last;
}

// atomic float64 min or max of the double whose bits *addr holds; NaN
// propagates (as XLA's min and max do), so a NaN slot stays NaN
__device__ __forceinline__ void ab_f64_min_max(unsigned long long* addr, double v, bool is_min) {
  unsigned long long old = *(volatile unsigned long long*)addr;
  while (true) {
    double cur = __longlong_as_double((long long)old);
    double next;
    if (isnan(cur) || isnan(v)) next = isnan(cur) ? cur : v;
    else next = is_min ? fmin(cur, v) : fmax(cur, v);
    unsigned long long nb = (unsigned long long)__double_as_longlong(next);
    if (nb == old) return;
    unsigned long long seen = atomicCAS(addr, old, nb);
    if (seen == old) return;
    old = seen;
  }
}

// --------------------------------------------------------------------------
// a bool mask as 16-byte words (K2, K6)
// --------------------------------------------------------------------------

// A mask of n bool bytes at any address is read as the 16-byte words of
// its aligned base: word w holds rows 16 w - shift .. 16 w - shift + 15,
// shift being the address's offset in its 16 bytes.  A word that holds a
// row lies inside the row's 512-byte allocation granule.  ab_mask_word
// returns word w with the bytes of rows outside [0, n) cleared; r is the
// row of its first byte, n >= 1.  The load is unconditional (a word past
// the last is read as the last, then cleared), so a thread's loads of
// several words issue together.  Torch bools are 0 or 1, so __popc of a
// word counts its live rows.
__device__ __forceinline__ uint4 ab_mask_word(const uint4* __restrict__ words, long long w,
                                              long long r, long long n) {
  uint4 v = __ldg(words + min(w, w + ((n - 1 - r) >> 4)));
  if (r < 0 || r + 16 > n) {
    unsigned q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (r + b < 0 || r + b >= n) q[b >> 2] &= ~(0xffu << (8 * (b & 3)));
    v = make_uint4(q[0], q[1], q[2], q[3]);
  }
  return v;
}

__device__ __forceinline__ unsigned ab_word_live(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// byte b (0..15) of a word
__device__ __forceinline__ unsigned ab_word_byte(const uint4& v, int b) {
  const unsigned q = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return (q >> (8 * (b & 3))) & 0xffu;
}

// --------------------------------------------------------------------------
// hashing (K3 hash64 / bucket_of, K5 build_side_sort, K6 via K3's hashes)
// --------------------------------------------------------------------------

// One column's step of the reference's hash64 (arrow_ballista_tpu/ops/
// kernels.py:62): the widened key x is mixed with splitmix64 and combined
// into h as h = h*0x9E3779B97F4A7C15 + x; h ^= h>>29, in wrapping uint64.
__device__ __forceinline__ uint64_t ab_hash_combine(uint64_t h, uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  x = x ^ (x >> 31);
  h = h * 0x9E3779B97F4A7C15ULL + x;
  return h ^ (h >> 29);
}

#define AB_MAX_HASH_COLS 16

struct HashCols {
  const void* ptr[AB_MAX_HASH_COLS];
  int kind[AB_MAX_HASH_COLS];
  int k;
};

// XLA's astype(uint64): int32 sign-extends (a -1 NULL code is
// 0xFFFF...FFFF), bool is 0/1, int64 and uint64 bits pass through
__device__ __forceinline__ uint64_t ab_widen_u64(const HashCols& c, int j, long long i) {
  switch (c.kind[j]) {
    case AB_KIND_I32:
      return (uint64_t)(int64_t)((const int32_t*)c.ptr[j])[i];
    case AB_KIND_I64:
      return (uint64_t)((const int64_t*)c.ptr[j])[i];
    default:  // AB_KIND_BOOL
      return (uint64_t)(((const uint8_t*)c.ptr[j])[i] != 0);
  }
}

__device__ __forceinline__ uint64_t ab_hash_row(const HashCols& c, long long i) {
  uint64_t h = 0ULL;
  for (int j = 0; j < c.k; ++j) h = ab_hash_combine(h, ab_widen_u64(c, j, i));
  return h;
}

static inline int ab_fill_hash_cols(HashCols* c, const void* const* ptrs, const int* kinds,
                                    int k) {
  if (k < 1 || k > AB_MAX_HASH_COLS) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < k; ++j) {
    if (kinds[j] != AB_KIND_I32 && kinds[j] != AB_KIND_I64 && kinds[j] != AB_KIND_BOOL)
      return (int)cudaErrorInvalidValue;
    c->ptr[j] = ptrs[j];
    c->kind[j] = kinds[j];
  }
  c->k = k;
  return 0;
}

// --------------------------------------------------------------------------
// block and device-wide prefix sums (K2's scheme, no library scan)
// --------------------------------------------------------------------------

// exclusive scan of v over the block; *total gets the block's sum.
// warp_sums must hold blockDim.x / 32 values.
template <typename T>
__device__ __forceinline__ T ab_block_exclusive_scan(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = (lane < nwarps) ? warp_sums[lane] : (T)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  T before = (warp > 0) ? warp_sums[warp - 1] : (T)0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return before + x - v;
}

// Device-wide inclusive scan in three launches: per-tile sums, one block
// scanning the tile sums, then each tile rescanned with its offset added.
#define AB_SCAN_THREADS 256
#define AB_SCAN_ITEMS 16
#define AB_SCAN_TILE (AB_SCAN_THREADS * AB_SCAN_ITEMS)
#define AB_SCAN_TOP_THREADS 1024

static inline long long ab_scan_tiles(long long n) {
  return (n + AB_SCAN_TILE - 1) / AB_SCAN_TILE;
}

template <typename TIn, typename TAcc>
__global__ void ab_scan_tile_sums(const TIn* __restrict__ in, long long n,
                                  TAcc* __restrict__ sums) {
  __shared__ TAcc ws[AB_SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * AB_SCAN_TILE;
  TAcc c = 0;
#pragma unroll
  for (int j = 0; j < AB_SCAN_ITEMS; ++j) {
    long long i = base + (long long)j * AB_SCAN_THREADS + threadIdx.x;  // coalesced
    if (i < n) c += (TAcc)in[i];
  }
  TAcc total;
  ab_block_exclusive_scan<TAcc>(c, ws, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// in place: tile sums -> exclusive tile offsets; sums[num_tiles] = total
template <typename TAcc>
__global__ void ab_scan_tile_offsets(TAcc* __restrict__ sums, long long num_tiles) {
  __shared__ TAcc ws[AB_SCAN_TOP_THREADS / 32];
  TAcc carry = 0;
  for (long long start = 0; start < num_tiles; start += AB_SCAN_TOP_THREADS) {
    long long t = start + threadIdx.x;
    TAcc v = (t < num_tiles) ? sums[t] : (TAcc)0;
    TAcc total;
    TAcc ex = ab_block_exclusive_scan<TAcc>(v, ws, &total);
    if (t < num_tiles) sums[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) sums[num_tiles] = carry;
}

template <typename TIn, typename TAcc, typename TOut>
__global__ void ab_scan_tile_apply(const TIn* __restrict__ in, long long n,
                                   const TAcc* __restrict__ offsets, TOut* __restrict__ out) {
  __shared__ TAcc ws[AB_SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * AB_SCAN_TILE + (long long)threadIdx.x * AB_SCAN_ITEMS;
  TAcc v[AB_SCAN_ITEMS];
  TAcc c = 0;
#pragma unroll
  for (int j = 0; j < AB_SCAN_ITEMS; ++j) {
    long long i = base + j;
    v[j] = (i < n) ? (TAcc)in[i] : (TAcc)0;
    c += v[j];
  }
  TAcc total;
  TAcc run = offsets[blockIdx.x] + ab_block_exclusive_scan<TAcc>(c, ws, &total);
#pragma unroll
  for (int j = 0; j < AB_SCAN_ITEMS; ++j) {
    long long i = base + j;
    run += v[j];
    if (i < n) out[i] = (TOut)run;
  }
}

// out[i] = in[0] + ... + in[i]; tile_sums: TAcc[ab_scan_tiles(n) + 1],
// whose last entry receives the grand total.
template <typename TIn, typename TAcc, typename TOut>
static int ab_inclusive_scan(const TIn* in, long long n, TOut* out, TAcc* tile_sums,
                             cudaStream_t s) {
  const long long tiles = ab_scan_tiles(n);
  if (tiles < 1 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ab_scan_tile_sums<TIn, TAcc><<<(unsigned)tiles, AB_SCAN_THREADS, 0, s>>>(in, n, tile_sums);
  int err = ab_last_error();
  if (err) return err;
  ab_scan_tile_offsets<TAcc><<<1, AB_SCAN_TOP_THREADS, 0, s>>>(tile_sums, tiles);
  err = ab_last_error();
  if (err) return err;
  ab_scan_tile_apply<TIn, TAcc, TOut><<<(unsigned)tiles, AB_SCAN_THREADS, 0, s>>>(
      in, n, tile_sums, out);
  return ab_last_error();
}
