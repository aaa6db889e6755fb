// K1's accumulator body as a template over a row source, shared by K1
// (csrc/dense_agg.cu: the rows come from key and value columns) and by
// K13's dense form (a generated source from compile/codegen.py: the rows
// come from the fused chain's row function, so the key and value columns
// never exist in device memory).
//
// A row source provides
//   static constexpr int KMAX, MMAX;   // bounds of the key / value arrays
//   __device__ bool row(long long i, int* keys, unsigned long long* words) const;
// which returns whether row i is live and fills its s.k key values (as
// int: an int64 key truncates, a bool is 0/1) and s.m value words (an
// int64 or the bits of a double; a 32-bit value in the low half; 1 for a
// count).  Slots, identities, the 32-bit low-half accumulators and the
// bad-rows flag are K1's, whatever the source.
#pragma once

#include "common.cuh"

#define AB_MAX_KEYS 8
#define AB_MAX_AGGS 32
#define AB_AGG_SUM 0
#define AB_AGG_COUNT 1
#define AB_AGG_MIN 2
#define AB_AGG_MAX 3
#define AB_SHARED_LIMIT (160 * 1024)

struct DenseSpec {
  const void* key[AB_MAX_KEYS];  // K1's column source only
  int key_kind[AB_MAX_KEYS];
  int lo[AB_MAX_KEYS];
  int hi[AB_MAX_KEYS];
  int stride[AB_MAX_KEYS];
  int k;
  const void* val[AB_MAX_AGGS];  // K1's column source only
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

// slot of a live row from its keys, or -1 with *bad set when a key lies
// outside its range
__device__ __forceinline__ int keys_slot(const DenseSpec& s, const int* keys, bool* bad) {
  int fused = 0;
  bool in_range = true;
  for (int j = 0; j < s.k; ++j) {
    int v = keys[j];
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

template <class Src>
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
template <class Src>
__global__ void dense_global(Src src, DenseSpec s, long long n, int domain,
                             unsigned long long* __restrict__ acc, int* __restrict__ exists,
                             int* __restrict__ bad) {
  int keys[Src::KMAX];
  unsigned long long words[Src::MMAX];
  bool saw_bad = false;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    if (!src.row(i, keys, words)) continue;
    int slot = keys_slot(s, keys, &saw_bad);
    if (slot < 0) continue;
    atomicAdd(&exists[slot], 1);
    for (int a = 0; a < s.m; ++a)
      fold(&acc[(long long)a * domain + slot], s.how[a], s.val_kind[a], words[a]);
  }
  if (saw_bad) *bad = 1;
}

// per-block accumulators in shared memory, merged once per block
template <class Src>
__global__ void dense_shared(Src src, DenseSpec s, long long n, int domain,
                             unsigned long long* __restrict__ acc, int* __restrict__ exists,
                             int* __restrict__ bad) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* sacc = smem;                       // [m][domain]
  int* sexists = (int*)(smem + (long long)s.m * domain);  // [domain]
  const int total = s.m * domain;
  for (int t = threadIdx.x; t < total; t += blockDim.x) sacc[t] = identity_word(s, t / domain);
  for (int t = threadIdx.x; t < domain; t += blockDim.x) sexists[t] = 0;
  __syncthreads();

  int keys[Src::KMAX];
  unsigned long long words[Src::MMAX];
  bool saw_bad = false;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    if (!src.row(i, keys, words)) continue;
    int slot = keys_slot(s, keys, &saw_bad);
    if (slot < 0) continue;
    atomicAdd(&sexists[slot], 1);
    for (int a = 0; a < s.m; ++a)
      fold(&sacc[a * domain + slot], s.how[a], s.val_kind[a], words[a]);
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

// validate the spec, then initialize and accumulate; acc: uint64[m *
// domain] (aggregate-major), exists: int32[domain], bad: int32[1].
// Returns a cudaError_t.
template <class Src>
static int ab_dense_run(const Src& src, DenseSpec s, long long n, int domain, void* acc,
                        void* exists, void* bad, cudaStream_t st) {
  if (s.k < 1 || s.k > AB_MAX_KEYS || s.k > Src::KMAX || s.m < 0 || s.m > AB_MAX_AGGS ||
      s.m > Src::MMAX || domain < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < s.m; ++a) {
    if (s.how[a] < AB_AGG_SUM || s.how[a] > AB_AGG_MAX) return (int)cudaErrorInvalidValue;
    const int kind = s.val_kind[a];
    if (s.how[a] != AB_AGG_COUNT && kind != AB_KIND_I64 && kind != AB_KIND_F64 &&
        kind != AB_KIND_I32 && kind != AB_KIND_F32)
      return (int)cudaErrorInvalidValue;
    if (s.how[a] == AB_AGG_COUNT) s.val_kind[a] = AB_KIND_I64;
  }
  const int threads = 256;
  dense_init<Src><<<ab_grid((long long)(s.m > 0 ? s.m : 1) * domain, threads, 132 * 8), threads,
                    0, st>>>(s, domain, (unsigned long long*)acc, (int*)exists, (int*)bad);
  int err = ab_last_error();
  if (err) return err;
  size_t smem = (size_t)s.m * domain * 8 + (size_t)domain * 4;
  const int grid = ab_grid(n, threads, 132 * 4);
  if (smem <= AB_SHARED_LIMIT) {
    if (smem > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(dense_shared<Src>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
    }
    dense_shared<Src><<<grid, threads, smem, st>>>(src, s, n, domain, (unsigned long long*)acc,
                                                   (int*)exists, (int*)bad);
  } else {
    dense_global<Src><<<grid, threads, 0, st>>>(src, s, n, domain, (unsigned long long*)acc,
                                                (int*)exists, (int*)bad);
  }
  return ab_last_error();
}
