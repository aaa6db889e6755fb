// K18: merge_rank_states — the element-wise sum, min or max of the mesh
// ranks' slot-aligned arrays.
//
// Replaces the lax.psum / pmin / pmax of
// arrow_ballista_tpu/parallel/distributed.py:136-145 (the dense reduce
// path of the mesh aggregate: the ranks' dense states, their int32
// `exists` counts and their `bad` flags).  The n rank arrays have been
// copied onto one device (parallel/collectives.py); out[d] folds slot d of
// rank 0, 1, ..., n-1 in rank order.  Integer sums wrap (as XLA's do);
// float min and max propagate NaN; a bool array merges by OR (max).
//
// One launch a column, a grid-stride loop over the slots.  Bound: bytes
// (n arrays read once, one written).
#include "common.cuh"

#define AB_MERGE_MAX_RANKS 64
#define AB_HOW_SUM 0
#define AB_HOW_MIN 2
#define AB_HOW_MAX 3

struct RankArrays {
  const void* ptr[AB_MERGE_MAX_RANKS];
  int n;
};

template <typename T>
__device__ __forceinline__ T merge_one(T a, T b, int how) {
  if (how == AB_HOW_SUM) return a + b;
  if (how == AB_HOW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// integer sums in unsigned arithmetic: they wrap
template <>
__device__ __forceinline__ int64_t merge_one<int64_t>(int64_t a, int64_t b, int how) {
  if (how == AB_HOW_SUM) return (int64_t)((uint64_t)a + (uint64_t)b);
  if (how == AB_HOW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <>
__device__ __forceinline__ int32_t merge_one<int32_t>(int32_t a, int32_t b, int how) {
  if (how == AB_HOW_SUM) return (int32_t)((uint32_t)a + (uint32_t)b);
  if (how == AB_HOW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <>
__device__ __forceinline__ double merge_one<double>(double a, double b, int how) {
  if (how == AB_HOW_SUM) return a + b;
  if (isnan(a) || isnan(b)) return isnan(a) ? a : b;
  if (how == AB_HOW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <>
__device__ __forceinline__ float merge_one<float>(float a, float b, int how) {
  if (how == AB_HOW_SUM) return a + b;
  if (isnan(a) || isnan(b)) return isnan(a) ? a : b;
  if (how == AB_HOW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <typename T>
__global__ void merge_ranks(RankArrays a, long long domain, int how, T* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x; d < domain; d += step) {
    T v = ((const T*)a.ptr[0])[d];
    for (int r = 1; r < a.n; ++r) v = merge_one<T>(v, ((const T*)a.ptr[r])[d], how);
    out[d] = v;
  }
}

// bool arrays (bytes 0/1) merge by OR
__global__ void merge_ranks_or(RankArrays a, long long domain, uint8_t* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x; d < domain; d += step) {
    uint8_t v = 0;
    for (int r = 0; r < a.n; ++r) v |= (((const uint8_t*)a.ptr[r])[d] != 0);
    out[d] = v;
  }
}

// ptrs: n device pointers (host array) to arrays of `domain` elements of
// `kind`; how: AB_HOW_SUM / MIN / MAX (a bool array takes MAX: OR)
AB_EXPORT int ab_merge_rank_states(const void* const* ptrs, int n, long long domain, int kind,
                                   int how, void* out, void* stream) {
  if (n < 1 || n > AB_MERGE_MAX_RANKS || domain < 0 ||
      (how != AB_HOW_SUM && how != AB_HOW_MIN && how != AB_HOW_MAX) ||
      (kind == AB_KIND_BOOL && how != AB_HOW_MAX))
    return (int)cudaErrorInvalidValue;
  if (domain == 0) return 0;
  RankArrays a;
  for (int r = 0; r < n; ++r) a.ptr[r] = ptrs[r];
  a.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = ab_grid(domain, threads, 132 * 16);
  switch (kind) {
    case AB_KIND_I32:
      merge_ranks<int32_t><<<blocks, threads, 0, s>>>(a, domain, how, (int32_t*)out);
      break;
    case AB_KIND_I64:
      merge_ranks<int64_t><<<blocks, threads, 0, s>>>(a, domain, how, (int64_t*)out);
      break;
    case AB_KIND_F32:
      merge_ranks<float><<<blocks, threads, 0, s>>>(a, domain, how, (float*)out);
      break;
    case AB_KIND_F64:
      merge_ranks<double><<<blocks, threads, 0, s>>>(a, domain, how, (double*)out);
      break;
    case AB_KIND_BOOL:
      merge_ranks_or<<<blocks, threads, 0, s>>>(a, domain, (uint8_t*)out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return ab_last_error();
}
