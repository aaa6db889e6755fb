// K8: grouped_on_order — grouped aggregation over rows already in group
// order (the sort path of grouped_aggregate).
//
// Replaces arrow_ballista_tpu/ops/kernels.py _grouped_aggregate_on_order
// (l.314), which grouped_aggregate (l.266) runs after the K4 sort order (or
// the K2 compaction order when there are no keys): the "agg.grouped"
// program of HashAggregateExec for keys without a dense domain and for
// every global aggregate.  Per the reference:
//   boundary[i] = live[i] & (i == 0 | any key differs from row i-1), or,
//   with no keys, (i == 0) & any(live);
//   seg = cumsum(boundary) - 1; num_groups = sum(boundary);
//   a row adds to slot seg when it is live and 0 <= seg < out_capacity;
//   sums and counts start at 0, min at the type's max, max at its min;
//   each group's first row writes its keys; out_mask = slot <
//   min(num_groups, out_capacity).
// int64 sums and counts wrap mod 2^64 and int32 sums mod 2^32 (as XLA's
// segment_sum does), so they are exact in any order; float sums are
// atomic adds whose order varies between runs.
//
// Design: init launch (identities), boundary launch, common.cuh's
// device-wide scan of the flags into inclusive segment counts, then one
// thread a row folds its values into its slot with device atomics
// (64- and 32-bit add/min/max; a CAS loop for float min and max) and
// scatters its keys when it opens a group; a last launch writes the mask.
// Bound: bytes (keys and values read once, the slots written once).  The
// input is sorted, so a group's rows are neighbours and hit one address:
// same-address atomics serialize, which costs little at q3's few rows a
// group and most on a single large group (a global aggregate).  A
// warp-level pre-reduction of equal segments is the later fast form.
#include "common.cuh"

#define SEG_MAX_KEYS 8
#define SEG_MAX_AGGS 32
#define SEG_SUM 0
#define SEG_COUNT 1
#define SEG_MIN 2
#define SEG_MAX 3

struct SegSpec {
  const void* key[SEG_MAX_KEYS];
  int key_kind[SEG_MAX_KEYS];
  void* key_out[SEG_MAX_KEYS];
  int k;
  const void* val[SEG_MAX_AGGS];
  int val_kind[SEG_MAX_AGGS];  // kind of the value and of its output; count: AB_KIND_I64
  int how[SEG_MAX_AGGS];
  void* val_out[SEG_MAX_AGGS];
  int m;
};

__device__ __forceinline__ bool key_differs(const SegSpec& s, int j, long long a, long long b) {
  const void* p = s.key[j];
  switch (s.key_kind[j]) {
    case AB_KIND_I32: return ((const int32_t*)p)[a] != ((const int32_t*)p)[b];
    case AB_KIND_I64: return ((const int64_t*)p)[a] != ((const int64_t*)p)[b];
    case AB_KIND_BOOL: return (((const uint8_t*)p)[a] != 0) != (((const uint8_t*)p)[b] != 0);
    case AB_KIND_F32: return ((const float*)p)[a] != ((const float*)p)[b];  // NaN differs
    default: return ((const double*)p)[a] != ((const double*)p)[b];
  }
}

__device__ __forceinline__ void copy_key(const SegSpec& s, int j, long long from, long long to) {
  switch (s.key_kind[j]) {
    case AB_KIND_I32: ((int32_t*)s.key_out[j])[to] = ((const int32_t*)s.key[j])[from]; break;
    case AB_KIND_I64: ((int64_t*)s.key_out[j])[to] = ((const int64_t*)s.key[j])[from]; break;
    case AB_KIND_BOOL: ((uint8_t*)s.key_out[j])[to] = ((const uint8_t*)s.key[j])[from]; break;
    case AB_KIND_F32: ((float*)s.key_out[j])[to] = ((const float*)s.key[j])[from]; break;
    default: ((double*)s.key_out[j])[to] = ((const double*)s.key[j])[from]; break;
  }
}

__global__ void seg_init(SegSpec s, long long cap, int* __restrict__ any_live) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *any_live = 0;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < cap; t += step) {
    for (int j = 0; j < s.k; ++j) {
      switch (s.key_kind[j]) {
        case AB_KIND_I32: ((int32_t*)s.key_out[j])[t] = 0; break;
        case AB_KIND_I64: ((int64_t*)s.key_out[j])[t] = 0; break;
        case AB_KIND_BOOL: ((uint8_t*)s.key_out[j])[t] = 0; break;
        case AB_KIND_F32: ((float*)s.key_out[j])[t] = 0.0f; break;
        default: ((double*)s.key_out[j])[t] = 0.0; break;
      }
    }
    for (int a = 0; a < s.m; ++a) {
      const int how = s.how[a];
      void* o = s.val_out[a];
      switch (s.val_kind[a]) {
        case AB_KIND_I32:
          ((int32_t*)o)[t] = how == SEG_MIN ? INT32_MAX : how == SEG_MAX ? INT32_MIN : 0;
          break;
        case AB_KIND_I64:
          ((int64_t*)o)[t] = how == SEG_MIN ? INT64_MAX : how == SEG_MAX ? INT64_MIN : 0;
          break;
        case AB_KIND_F32:
          ((float*)o)[t] = how == SEG_MIN ? __uint_as_float(0x7f800000u)
                           : how == SEG_MAX ? __uint_as_float(0xff800000u) : 0.0f;
          break;
        default:
          ((double*)o)[t] = how == SEG_MIN ? __longlong_as_double(0x7ff0000000000000LL)
                            : how == SEG_MAX ? __longlong_as_double((long long)0xfff0000000000000ULL)
                            : 0.0;
          break;
      }
    }
  }
}

__global__ void seg_boundary(SegSpec s, const uint8_t* __restrict__ mask, long long n,
                             uint8_t* __restrict__ flags, int* __restrict__ any_live) {
  long long step = (long long)gridDim.x * blockDim.x;
  bool saw_live = false;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const bool live = mask[i] != 0;
    if (s.k == 0) {
      saw_live = saw_live || live;
      flags[i] = 0;  // row 0 is set after every block has looked
      continue;
    }
    bool open = (i == 0);
    for (int j = 0; j < s.k && !open; ++j) open = key_differs(s, j, i, i - 1);
    flags[i] = live && open;
  }
  if (saw_live) *any_live = 1;  // racing writers store the same value
}

__global__ void seg_keyless_first(uint8_t* __restrict__ flags, const int* __restrict__ any_live) {
  flags[0] = *any_live != 0;
}

__device__ __forceinline__ void f32_min_max(float* addr, float v, bool is_min) {
  unsigned int* a = (unsigned int*)addr;
  unsigned int old = *(volatile unsigned int*)a;
  while (true) {
    float cur = __uint_as_float(old);
    float next;
    if (isnan(cur) || isnan(v)) next = isnan(cur) ? cur : v;  // NaN propagates
    else next = is_min ? fminf(cur, v) : fmaxf(cur, v);
    unsigned int nb = __float_as_uint(next);
    if (nb == old) return;
    unsigned int seen = atomicCAS(a, old, nb);
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void fold(const SegSpec& s, int a, long long i, long long slot) {
  const int how = s.how[a];
  void* o = s.val_out[a];
  if (how == SEG_COUNT) {
    atomicAdd((unsigned long long*)o + slot, 1ULL);
    return;
  }
  const void* v = s.val[a];
  switch (s.val_kind[a]) {
    case AB_KIND_I32: {
      int x = ((const int32_t*)v)[i];
      int* p = (int*)o + slot;
      if (how == SEG_SUM) atomicAdd((unsigned int*)p, (unsigned int)x);  // wraps mod 2^32
      else if (how == SEG_MIN) atomicMin(p, x);
      else atomicMax(p, x);
      break;
    }
    case AB_KIND_I64: {
      long long x = ((const long long*)v)[i];
      long long* p = (long long*)o + slot;
      if (how == SEG_SUM) atomicAdd((unsigned long long*)p, (unsigned long long)x);
      else if (how == SEG_MIN) atomicMin(p, x);
      else atomicMax(p, x);
      break;
    }
    case AB_KIND_F32: {
      float x = ((const float*)v)[i];
      float* p = (float*)o + slot;
      if (how == SEG_SUM) atomicAdd(p, x);
      else f32_min_max(p, x, how == SEG_MIN);
      break;
    }
    default: {
      double x = ((const double*)v)[i];
      double* p = (double*)o + slot;
      if (how == SEG_SUM) atomicAdd(p, x);
      else ab_f64_min_max((unsigned long long*)p, x, how == SEG_MIN);
      break;
    }
  }
}

// incl[i] = boundaries in rows 0..i, so row i belongs to segment incl[i] - 1
__global__ void seg_accumulate(SegSpec s, const uint8_t* __restrict__ mask, long long n,
                               const uint8_t* __restrict__ flags, const int32_t* __restrict__ incl,
                               long long cap) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    long long seg = (long long)incl[i] - 1;
    if (!mask[i] || seg < 0 || seg >= cap) continue;
    for (int a = 0; a < s.m; ++a) fold(s, a, i, seg);
    if (flags[i])
      for (int j = 0; j < s.k; ++j) copy_key(s, j, i, seg);
  }
}

__global__ void seg_finish(const int* __restrict__ num_groups, long long cap,
                           uint8_t* __restrict__ out_mask, long long* __restrict__ groups_out) {
  const long long g = *num_groups;
  if (blockIdx.x == 0 && threadIdx.x == 0) *groups_out = g;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < cap; t += step)
    out_mask[t] = t < g;
}

// flags u8[n], incl i32[n], scan tile sums i32[tiles + 1], any_live i32
AB_EXPORT long long ab_seg_scratch_bytes(long long n) {
  return ab_align16(n) + ab_align16(n * 4) + ab_align16((ab_scan_tiles(n) + 1) * 4) + 16;
}

// spec: keys and values in group order (n rows each) and the outputs
// (cap slots each, allocated by the caller); out_mask: bool[cap];
// num_groups: int64[1]; scratch: ab_seg_scratch_bytes(n) bytes.
AB_EXPORT int ab_grouped_on_order(const SegSpec* spec, const void* mask, long long n,
                                  long long cap, void* out_mask, void* num_groups,
                                  void* scratch, void* stream) {
  SegSpec s = *spec;
  if (n < 1 || n > 0x7fffffffLL || cap < 1 || s.k < 0 || s.k > SEG_MAX_KEYS || s.m < 0 ||
      s.m > SEG_MAX_AGGS)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < s.k; ++j)
    if (s.key_kind[j] < AB_KIND_I32 || s.key_kind[j] > AB_KIND_F64)
      return (int)cudaErrorInvalidValue;
  for (int a = 0; a < s.m; ++a) {
    if (s.how[a] < SEG_SUM || s.how[a] > SEG_MAX) return (int)cudaErrorInvalidValue;
    if (s.how[a] == SEG_COUNT) s.val_kind[a] = AB_KIND_I64;
    else if (s.val_kind[a] == AB_KIND_BOOL || s.val_kind[a] < AB_KIND_I32 ||
             s.val_kind[a] > AB_KIND_F64)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  char* p = (char*)scratch;
  uint8_t* flags = (uint8_t*)p;
  p += ab_align16(n);
  int32_t* incl = (int32_t*)p;
  p += ab_align16(n * 4);
  int* sums = (int*)p;
  p += ab_align16((ab_scan_tiles(n) + 1) * 4);
  int* any_live = (int*)p;
  const int threads = 256;
  seg_init<<<ab_grid(cap, threads, 132 * 8), threads, 0, st>>>(s, cap, any_live);
  int err = ab_last_error();
  if (err) return err;
  seg_boundary<<<ab_grid(n, threads, 132 * 16), threads, 0, st>>>(s, (const uint8_t*)mask, n,
                                                                  flags, any_live);
  err = ab_last_error();
  if (err) return err;
  if (s.k == 0) {
    seg_keyless_first<<<1, 1, 0, st>>>(flags, any_live);
    err = ab_last_error();
    if (err) return err;
  }
  err = ab_inclusive_scan<uint8_t, int, int32_t>(flags, n, incl, sums, st);
  if (err) return err;
  seg_accumulate<<<ab_grid(n, threads, 132 * 16), threads, 0, st>>>(
      s, (const uint8_t*)mask, n, flags, incl, cap);
  err = ab_last_error();
  if (err) return err;
  seg_finish<<<ab_grid(cap, threads, 132 * 8), threads, 0, st>>>(
      sums + ab_scan_tiles(n), cap, (uint8_t*)out_mask, (long long*)num_groups);
  return ab_last_error();
}
