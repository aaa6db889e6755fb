// K7: segment_any — per-segment logical OR.
//
// Replaces arrow_ballista_tpu/ops/kernels.py segment_any (l.772):
// segment_max(values.astype(int32), seg, num_segments) > 0, the verdict
// reduction of the semi, anti, left and full joins (operators.py:1242,
// :1254, :1270).  Segment ids outside [0, num_segments) are dropped, as
// XLA's scatter drops them.
//
// Design: one launch clears hit[num_segments], a second stores 1 to
// hit[seg[j]] for every value above 0 (true).  Writers race only to store the same
// byte, so no atomics are needed.
// Bound: bytes (values and ids read once, the flags written once).
#include "common.cuh"

__global__ void clear_u8(uint8_t* __restrict__ p, long long n) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) p[i] = 0;
}

template <typename T>
__global__ void mark_segments(const T* __restrict__ values, const int32_t* __restrict__ seg,
                              long long n, long long num_segments, uint8_t* __restrict__ hit) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    if (!(values[i] > 0)) continue;  // max(...) > 0: negative int32 values are false
    long long s = seg[i];
    if (s >= 0 && s < num_segments) hit[s] = 1;
  }
}

// values: bool (AB_KIND_BOOL) or int32 (AB_KIND_I32)[n]; seg: int32[n];
// hit: bool[num_segments]
AB_EXPORT int ab_segment_any(const void* values, int kind, const void* seg, long long n,
                             long long num_segments, void* hit, void* stream) {
  if (n < 0 || num_segments < 1 || (kind != AB_KIND_BOOL && kind != AB_KIND_I32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  clear_u8<<<ab_grid(num_segments, threads, 132 * 8), threads, 0, s>>>((uint8_t*)hit,
                                                                       num_segments);
  int err = ab_last_error();
  if (err || n == 0) return err;
  if (kind == AB_KIND_BOOL)
    mark_segments<uint8_t><<<ab_grid(n, threads, 132 * 16), threads, 0, s>>>(
        (const uint8_t*)values, (const int32_t*)seg, n, num_segments, (uint8_t*)hit);
  else
    mark_segments<int32_t><<<ab_grid(n, threads, 132 * 16), threads, 0, s>>>(
        (const int32_t*)values, (const int32_t*)seg, n, num_segments, (uint8_t*)hit);
  return ab_last_error();
}
