// K1: dense_group_states — slot-aligned grouped aggregation over a dense
// key domain.
//
// Replaces arrow_ballista_tpu/ops/kernels.py dense_group_states (l.564)
// with grouped_sums_i64 (l.455) and grouped_minmax_i64 (l.529) as the dense
// path uses them: the grouped aggregate of HashAggregateExec
// ("agg.grouped", operators.py:885).  The fused row-major key over the
// declared (lo, hi) ranges is the slot id.  Per slot and aggregate, in the
// value's own type as XLA's segment ops compute it: int64 and int32 sums
// and counts (wrapping mod 2^64 and 2^32, order-free, so bit-exact), int64
// and int32 min / max (empty slots keep the type's max / min), float64 and
// float32 sums (atomic order varies between runs: compare at a tolerance,
// or on values whose sums are exact in any order), float min / max (NaN
// propagates), and an int32 exists count.  Rows outside the ranges add
// nothing (the reference folds them into its scratch slot, which it then
// drops) and raise the bad-rows flag.
//
// Every accumulator is one 8-byte word; a 32-bit value lives in the word's
// low half (little endian: the first four bytes) and is updated with 32-bit
// atomics, so int32 sums wrap as int32 and float32 sums round as float32.
//
// Design: one thread a row computes the slot.  When (domain) x (aggregates)
// 8-byte accumulators and the counts fit in shared memory, each block
// accumulates privately with shared-memory atomics and merges its non-empty
// slots into device memory once at the end, so the few groups a query
// fills (q1: 4 of 289 slots) see one device atomic per block and not one a
// row.  Otherwise rows go straight to device-memory atomics.
// Bound: bytes (each key and value read once).  chip_smoke.py's hot-slot
// sweep measures what same-slot atomic contention adds to that.
#include "common.cuh"

#define AB_MAX_KEYS 8
#define AB_MAX_AGGS 32
#define AB_AGG_SUM 0
#define AB_AGG_COUNT 1
#define AB_AGG_MIN 2
#define AB_AGG_MAX 3
#define AB_SHARED_LIMIT (160 * 1024)

struct DenseSpec {
  const void* key[AB_MAX_KEYS];
  int key_kind[AB_MAX_KEYS];
  int lo[AB_MAX_KEYS];
  int hi[AB_MAX_KEYS];
  int stride[AB_MAX_KEYS];
  int k;
  const void* val[AB_MAX_AGGS];
  int val_kind[AB_MAX_AGGS];  // AB_KIND_I32, _I64, _F32 or _F64; count: AB_KIND_I64
  int how[AB_MAX_AGGS];
  int m;
};

__device__ __forceinline__ unsigned long long identity_word(const DenseSpec& s, int a) {
  const int how = s.how[a];
  const int kind = s.val_kind[a];
  if (how == AB_AGG_MIN) {
    switch (kind) {
      case AB_KIND_F64: return 0x7ff0000000000000ULL;  // +inf
      case AB_KIND_F32: return 0x7f800000ULL;          // +inf in the low half
      case AB_KIND_I32: return 0x7fffffffULL;          // INT32_MAX in the low half
      default: return 0x7fffffffffffffffULL;           // INT64_MAX
    }
  }
  if (how == AB_AGG_MAX) {
    switch (kind) {
      case AB_KIND_F64: return 0xfff0000000000000ULL;  // -inf
      case AB_KIND_F32: return 0xff800000ULL;
      case AB_KIND_I32: return 0x80000000ULL;          // INT32_MIN
      default: return 0x8000000000000000ULL;           // INT64_MIN
    }
  }
  return 0ULL;  // sums and counts (0.0 has all bits clear)
}

// atomic float32 min or max of the float whose bits *addr holds; NaN propagates
__device__ __forceinline__ void f32_min_max(unsigned int* addr, float v, bool is_min) {
  unsigned int old = *(volatile unsigned int*)addr;
  while (true) {
    float cur = __uint_as_float(old);
    float next;
    if (isnan(cur) || isnan(v)) next = isnan(cur) ? cur : v;
    else next = is_min ? fminf(cur, v) : fmaxf(cur, v);
    unsigned int nb = __float_as_uint(next);
    if (nb == old) return;
    unsigned int seen = atomicCAS(addr, old, nb);
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ int key_i32(const DenseSpec& s, int j, long long i) {
  switch (s.key_kind[j]) {
    case AB_KIND_I32: return ((const int32_t*)s.key[j])[i];
    case AB_KIND_I64: return (int)((const int64_t*)s.key[j])[i];  // astype(int32) truncates
    default: return ((const uint8_t*)s.key[j])[i] != 0;
  }
}

// slot of row i, or -1 when the row is dead; *bad set when live and out of range
__device__ __forceinline__ int row_slot(const DenseSpec& s, const uint8_t* mask, long long i,
                                        bool* bad) {
  if (!mask[i]) return -1;
  int fused = 0;
  bool in_range = true;
  for (int j = 0; j < s.k; ++j) {
    int v = key_i32(s, j, i);
    in_range = in_range && v >= s.lo[j] && v <= s.hi[j];
    fused += (v - s.lo[j]) * s.stride[j];
  }
  if (!in_range) {
    *bad = true;
    return -1;
  }
  return fused;
}

// fold value word `x` (an int64, the bits of a double, or a 32-bit value
// in the low half) into accumulator `acc` for a value of `kind`
__device__ __forceinline__ void fold(unsigned long long* acc, int how, int kind,
                                     unsigned long long x) {
  unsigned int* acc32 = (unsigned int*)acc;  // the low half
  const unsigned int x32 = (unsigned int)x;
  switch (how) {
    case AB_AGG_COUNT:
      atomicAdd(acc, x);
      break;
    case AB_AGG_SUM:
      switch (kind) {
        case AB_KIND_F64: atomicAdd((double*)acc, __longlong_as_double((long long)x)); break;
        case AB_KIND_F32: atomicAdd((float*)acc32, __uint_as_float(x32)); break;
        case AB_KIND_I32: atomicAdd(acc32, x32); break;  // wraps mod 2^32
        default: atomicAdd(acc, x);
      }
      break;
    case AB_AGG_MIN:
    case AB_AGG_MAX: {
      const bool is_min = how == AB_AGG_MIN;
      switch (kind) {
        case AB_KIND_F64: ab_f64_min_max(acc, __longlong_as_double((long long)x), is_min); break;
        case AB_KIND_F32: f32_min_max(acc32, __uint_as_float(x32), is_min); break;
        case AB_KIND_I32:
          if (is_min) atomicMin((int*)acc32, (int)x32);
          else atomicMax((int*)acc32, (int)x32);
          break;
        default:
          if (is_min) atomicMin((long long*)acc, (long long)x);
          else atomicMax((long long*)acc, (long long)x);
      }
      break;
    }
  }
}

__device__ __forceinline__ unsigned long long row_word(const DenseSpec& s, int a, long long i) {
  if (s.how[a] == AB_AGG_COUNT) return 1ULL;
  if (s.val_kind[a] == AB_KIND_I32 || s.val_kind[a] == AB_KIND_F32)
    return ((const unsigned int*)s.val[a])[i];  // int32 or float bits in the low half
  return ((const unsigned long long*)s.val[a])[i];  // int64 or double bits
}

__global__ void dense_init(DenseSpec s, int domain, unsigned long long* __restrict__ acc,
                           int* __restrict__ exists, int* __restrict__ bad) {
  long long total = (long long)s.m * domain;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += step)
    acc[t] = identity_word(s, (int)(t / domain));
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < domain; t += step)
    exists[t] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *bad = 0;
}

// accumulators straight in device memory
__global__ void dense_global(DenseSpec s, const uint8_t* __restrict__ mask, long long n,
                             int domain, unsigned long long* __restrict__ acc,
                             int* __restrict__ exists, int* __restrict__ bad) {
  bool saw_bad = false;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    int slot = row_slot(s, mask, i, &saw_bad);
    if (slot < 0) continue;
    atomicAdd(&exists[slot], 1);
    for (int a = 0; a < s.m; ++a)
      fold(&acc[(long long)a * domain + slot], s.how[a], s.val_kind[a], row_word(s, a, i));
  }
  if (saw_bad) *bad = 1;
}

// per-block accumulators in shared memory, merged once per block
__global__ void dense_shared(DenseSpec s, const uint8_t* __restrict__ mask, long long n,
                             int domain, unsigned long long* __restrict__ acc,
                             int* __restrict__ exists, int* __restrict__ bad) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* sacc = smem;                       // [m][domain]
  int* sexists = (int*)(smem + (long long)s.m * domain);  // [domain]
  const int total = s.m * domain;
  for (int t = threadIdx.x; t < total; t += blockDim.x) sacc[t] = identity_word(s, t / domain);
  for (int t = threadIdx.x; t < domain; t += blockDim.x) sexists[t] = 0;
  __syncthreads();

  bool saw_bad = false;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    int slot = row_slot(s, mask, i, &saw_bad);
    if (slot < 0) continue;
    atomicAdd(&sexists[slot], 1);
    for (int a = 0; a < s.m; ++a)
      fold(&sacc[a * domain + slot], s.how[a], s.val_kind[a], row_word(s, a, i));
  }
  if (saw_bad) *bad = 1;
  __syncthreads();

  for (int slot = threadIdx.x; slot < domain; slot += blockDim.x) {
    int c = sexists[slot];
    if (c == 0) continue;
    atomicAdd(&exists[slot], c);
    for (int a = 0; a < s.m; ++a) {
      int how = s.how[a] == AB_AGG_COUNT ? AB_AGG_SUM : s.how[a];  // counts merge by adding
      fold(&acc[(long long)a * domain + slot], how, s.val_kind[a], sacc[a * domain + slot]);
    }
  }
}

// acc: uint64[m * domain] (int64 or double bits, aggregate-major);
// exists: int32[domain]; bad: int32[1].  Returns a cudaError_t.
AB_EXPORT int ab_dense_group_states(const DenseSpec* spec, const void* mask, long long n,
                                    int domain, void* acc, void* exists, void* bad,
                                    void* stream) {
  DenseSpec s = *spec;
  if (s.k < 1 || s.k > AB_MAX_KEYS || s.m < 0 || s.m > AB_MAX_AGGS || domain < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < s.m; ++a) {
    if (s.how[a] < AB_AGG_SUM || s.how[a] > AB_AGG_MAX) return (int)cudaErrorInvalidValue;
    const int kind = s.val_kind[a];
    if (s.how[a] != AB_AGG_COUNT && kind != AB_KIND_I64 && kind != AB_KIND_F64 &&
        kind != AB_KIND_I32 && kind != AB_KIND_F32)
      return (int)cudaErrorInvalidValue;
    if (s.how[a] == AB_AGG_COUNT) s.val_kind[a] = AB_KIND_I64;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  dense_init<<<ab_grid((long long)(s.m > 0 ? s.m : 1) * domain, threads, 132 * 8), threads, 0,
               st>>>(s, domain, (unsigned long long*)acc, (int*)exists, (int*)bad);
  int err = ab_last_error();
  if (err) return err;
  size_t smem = (size_t)s.m * domain * 8 + (size_t)domain * 4;
  const int grid = ab_grid(n, threads, 132 * 4);
  if (smem <= AB_SHARED_LIMIT) {
    if (smem > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(dense_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
      if (err) return err;
    }
    dense_shared<<<grid, threads, smem, st>>>(s, (const uint8_t*)mask, n, domain,
                                              (unsigned long long*)acc, (int*)exists, (int*)bad);
  } else {
    dense_global<<<grid, threads, 0, st>>>(s, (const uint8_t*)mask, n, domain,
                                           (unsigned long long*)acc, (int*)exists, (int*)bad);
  }
  return ab_last_error();
}
