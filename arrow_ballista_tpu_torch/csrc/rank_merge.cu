// K18: merge_rank_columns — every column of the mesh's dense merge, the
// element-wise sum, min or max of the ranks' slot-aligned arrays, in one
// launch.
//
// Replaces the lax.psum / pmin / pmax of
// arrow_ballista_tpu/parallel/distributed.py:136-145 (the dense reduce
// path of the mesh aggregate): one collective a dense aggregate state,
// `lax.psum(exists_cnt) > 0` and `lax.psum(bad) > 0`.  The ranks' arrays
// have been copied onto one device (parallel/collectives.py); out[d] folds
// slot d of rank 0, 1, ..., n-1 in rank order.  Integer sums wrap (as
// XLA's do); float min and max propagate NaN; a bool column merges by OR;
// an `exists` column is the wrapped integer sum written as the bool
// `sum > 0`, which equals the reference's psum then compare bit for bit.
//
// Bound: launches.  A dense merge is a few columns of a dozen slots
// (mesh_q1: the aggregate states, the exists counts and the bad flag), so
// one launch a column paid a ctypes call, an allocation and a launch for
// almost no bytes.  Here the column table (each column's kind, how, slot
// range, output and rank pointers) travels in the kernel's parameters (816
// bytes: 16 columns, 64 rank arrays, enough for mesh_q1's and mesh4_q1's 11
// columns), and the threads walk one flattened index over every column's
// slots, a binary search over the table's slot starts finding a slot's
// column.  A merge whose table does not fit takes one launch a group of
// whole columns (ops/kernels.py merge_rank_columns).
#include <type_traits>

#include "common.cuh"

#define AB_MERGE_MAX_RANKS 64
#define AB_MERGE_MAX_COLS 16
#define AB_MERGE_MAX_PTRS 64
#define AB_HOW_SUM 0
#define AB_HOW_MIN 2
#define AB_HOW_MAX 3
#define AB_HOW_EXISTS 5

// column c's slots are the flat indices [start[c], start[c + 1]); its
// rank r's array is src[c * n_ranks + r]
struct MergeSpec {
  long long start[AB_MERGE_MAX_COLS + 1];
  void* out[AB_MERGE_MAX_COLS];
  const void* src[AB_MERGE_MAX_PTRS];
  int n_cols;
  int n_ranks;
  unsigned char kind[AB_MERGE_MAX_COLS];
  unsigned char how[AB_MERGE_MAX_COLS];
};

template <typename T>
__device__ __forceinline__ T merge_one(T a, T b, int how) {
  if (how == AB_HOW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// floats: NaN propagates, the first NaN in rank order kept
template <typename T>
__device__ __forceinline__ T merge_float(T a, T b, int how) {
  if (how == AB_HOW_SUM) return a + b;
  if (isnan(a) || isnan(b)) return isnan(a) ? a : b;
  return merge_one<T>(a, b, how);
}

// integers: sums (and exists counts) in unsigned arithmetic, so they wrap
template <typename T, typename U>
__device__ __forceinline__ T merge_int(T a, T b, int how) {
  if (how == AB_HOW_SUM || how == AB_HOW_EXISTS) return (T)((U)a + (U)b);
  return merge_one<T>(a, b, how);
}

template <typename T>
__device__ __forceinline__ T fold_ranks(const MergeSpec& spec, int c, long long d, int how) {
  const void* const* src = spec.src + (long long)c * spec.n_ranks;
  T v = ((const T*)src[0])[d];
  for (int r = 1; r < spec.n_ranks; ++r) {
    const T b = ((const T*)src[r])[d];
    if constexpr (std::is_floating_point<T>::value) v = merge_float<T>(v, b, how);
    else if constexpr (sizeof(T) == 8) v = merge_int<T, uint64_t>(v, b, how);
    else v = merge_int<T, uint32_t>(v, b, how);
  }
  return v;
}

__device__ __forceinline__ void merge_slot(const MergeSpec& spec, int c, long long d) {
  const int how = spec.how[c];
  void* out = spec.out[c];
  switch (spec.kind[c]) {
    case AB_KIND_I32: {
      const int32_t v = fold_ranks<int32_t>(spec, c, d, how);
      if (how == AB_HOW_EXISTS) ((uint8_t*)out)[d] = v > 0;
      else ((int32_t*)out)[d] = v;
      break;
    }
    case AB_KIND_I64: {
      const int64_t v = fold_ranks<int64_t>(spec, c, d, how);
      if (how == AB_HOW_EXISTS) ((uint8_t*)out)[d] = v > 0;
      else ((int64_t*)out)[d] = v;
      break;
    }
    case AB_KIND_F32:
      ((float*)out)[d] = fold_ranks<float>(spec, c, d, how);
      break;
    case AB_KIND_F64:
      ((double*)out)[d] = fold_ranks<double>(spec, c, d, how);
      break;
    default: {  // bool (bytes 0/1): OR
      const void* const* src = spec.src + (long long)c * spec.n_ranks;
      uint8_t v = 0;
      for (int r = 0; r < spec.n_ranks; ++r) v |= (((const uint8_t*)src[r])[d] != 0);
      ((uint8_t*)out)[d] = v;
    }
  }
}

// the table is a grid constant: read in place by address, never copied to a
// thread's stack
__global__ void __launch_bounds__(256) k18_merge(const __grid_constant__ MergeSpec spec) {
  const long long total = spec.start[spec.n_cols];
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    int lo = 0, hi = spec.n_cols - 1;  // the last column whose slots start at or before i
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (spec.start[mid] <= i) lo = mid;
      else hi = mid - 1;
    }
    merge_slot(spec, lo, i - spec.start[lo]);
  }
}

static bool ab_merge_pair_ok(int kind, int how) {
  switch (kind) {
    case AB_KIND_I32:
    case AB_KIND_I64:
      return how == AB_HOW_SUM || how == AB_HOW_MIN || how == AB_HOW_MAX || how == AB_HOW_EXISTS;
    case AB_KIND_F32:
    case AB_KIND_F64:
      return how == AB_HOW_SUM || how == AB_HOW_MIN || how == AB_HOW_MAX;
    case AB_KIND_BOOL:
      return how == AB_HOW_MAX;
    default:
      return false;
  }
}

// spec: a MergeSpec in host memory
AB_EXPORT int ab_merge_columns(const void* spec, void* stream) {
  const MergeSpec* s = (const MergeSpec*)spec;
  if (s->n_cols < 1 || s->n_cols > AB_MERGE_MAX_COLS || s->n_ranks < 1 ||
      s->n_ranks > AB_MERGE_MAX_RANKS || s->n_cols * s->n_ranks > AB_MERGE_MAX_PTRS ||
      s->start[0] != 0)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < s->n_cols; ++c)
    if (s->start[c + 1] < s->start[c] || !ab_merge_pair_ok(s->kind[c], s->how[c]))
      return (int)cudaErrorInvalidValue;
  const long long total = s->start[s->n_cols];
  if (total == 0) return 0;
  const int threads = 256;
  k18_merge<<<ab_grid(total, threads, 132 * 16), threads, 0, (cudaStream_t)stream>>>(*s);
  return ab_last_error();
}

AB_EXPORT int ab_merge_spec_bytes() { return (int)sizeof(MergeSpec); }
