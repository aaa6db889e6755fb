// K6: probe_join — match probe rows against the sorted build hashes and
// expand the matches into a fixed number of pair slots.
//
// Replaces arrow_ballista_tpu/ops/kernels.py probe_join (l.739), and the
// candidate counts of JoinExec's "join.count" and "join.wcount" programs
// (operators.py:1291, :1303).  Per probe row i the reference takes
// lo/hi = searchsorted(build, h[i], left/right) on uint64, count = hi - lo
// for live rows (else 0), inclusive offsets = cumsum(count), total =
// offsets[-1]; pair slot j < total belongs to the row whose offsets first
// exceed j, with build position lo + (j - start).  Slots at or past total
// get pair_valid = false and the clipped indices the reference's formula
// gives there (probe row n-1, its lo plus the distance from its start).
//
// Design, three steps:
//   1. probe_bounds: one thread a probe row, two binary searches with
//      unsigned compares (lower and upper bound), writes lo and count;
//   2. common.cuh's device-wide scan turns counts into int64 inclusive
//      offsets and the total (JoinExec's count passes stop here: the
//      total, and per-window counts as differences of the offsets at the
//      window edges);
//   3. probe_expand: each probe row writes its own pair slots
//      [start, min(start + count, out_cap)); probe_fill writes the slots
//      from the total up to out_cap.
// Bound: bytes at the join's sizes.  The binary searches read about
// log2(n_build) build hashes a row, mostly from L2 (a 147k-row build is
// 1.2 MB); the expansion writes 9 bytes a pair.  A row with a large
// fan-out writes its pairs alone, one thread: skewed joins serialize there.
#include "common.cuh"

__device__ __forceinline__ long long lower_bound_u64(const uint64_t* __restrict__ a, long long n,
                                                     uint64_t x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long m = (lo + hi) >> 1;
    if (a[m] < x) lo = m + 1; else hi = m;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound_u64(const uint64_t* __restrict__ a, long long n,
                                                     uint64_t x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long m = (lo + hi) >> 1;
    if (a[m] <= x) lo = m + 1; else hi = m;
  }
  return lo;
}

__global__ void probe_bounds(const uint64_t* __restrict__ ph, const uint8_t* __restrict__ mask,
                             long long np, const uint64_t* __restrict__ bh, long long nb,
                             int32_t* __restrict__ lo_out, long long* __restrict__ count_out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += step) {
    uint64_t h = ph[i];
    long long lo = lower_bound_u64(bh, nb, h);
    long long hi = mask[i] ? upper_bound_u64(bh + lo, nb - lo, h) + lo : lo;
    lo_out[i] = (int32_t)lo;
    count_out[i] = hi - lo;
  }
}

__global__ void probe_expand(const int32_t* __restrict__ lo, const long long* __restrict__ count,
                             const long long* __restrict__ offsets, long long np,
                             long long out_cap, int32_t* __restrict__ probe_idx,
                             int32_t* __restrict__ build_pos, uint8_t* __restrict__ valid) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += step) {
    long long c = count[i];
    if (c == 0) continue;
    long long start = offsets[i] - c;
    long long end = min(start + c, out_cap);
    long long b = lo[i];
    for (long long j = start; j < end; ++j) {
      probe_idx[j] = (int32_t)i;
      build_pos[j] = (int32_t)(b + (j - start));
      valid[j] = 1;
    }
  }
}

__global__ void probe_fill(const int32_t* __restrict__ lo, const long long* __restrict__ count,
                           const long long* __restrict__ offsets,
                           const long long* __restrict__ total, long long np, long long nb,
                           long long out_cap, int32_t* __restrict__ probe_idx,
                           int32_t* __restrict__ build_pos, uint8_t* __restrict__ valid) {
  const long long t = *total;
  const long long last = np - 1;
  const long long last_start = offsets[last] - count[last];
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = max(t, 0LL) + (long long)blockIdx.x * blockDim.x + threadIdx.x; j < out_cap;
       j += step) {
    long long bp = lo[last] + (j - last_start);
    bp = min(max(bp, 0LL), nb - 1);
    probe_idx[j] = (int32_t)last;
    build_pos[j] = (int32_t)bp;
    valid[j] = 0;
  }
}

AB_EXPORT long long ab_probe_scratch_bytes(long long np) {
  return (ab_scan_tiles(np) + 1) * 8;
}

// Counts only.  lo: int32[np]; count: int64[np]; offsets: int64[np]
// (inclusive); total: int64[1]; scratch: ab_probe_scratch_bytes(np) bytes.
AB_EXPORT int ab_probe_counts(const void* probe_hash, const void* mask, long long np,
                              const void* build_sorted, long long nb, void* lo, void* count,
                              void* offsets, void* total, void* scratch, void* stream) {
  if (np < 1 || np > 0x7fffffffLL || nb < 0 || nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  probe_bounds<<<ab_grid(np, threads, 132 * 16), threads, 0, s>>>(
      (const uint64_t*)probe_hash, (const uint8_t*)mask, np, (const uint64_t*)build_sorted, nb,
      (int32_t*)lo, (long long*)count);
  int err = ab_last_error();
  if (err) return err;
  long long* sums = (long long*)scratch;
  err = ab_inclusive_scan<long long, long long, long long>((const long long*)count, np,
                                                           (long long*)offsets, sums, s);
  if (err) return err;
  // the grand total sits after the tile sums; copy it out on the stream
  return (int)cudaMemcpyAsync(total, sums + ab_scan_tiles(np), 8, cudaMemcpyDeviceToDevice, s);
}

// The pair slots, after ab_probe_counts on the same inputs.  probe_idx,
// build_pos: int32[out_cap]; valid: uint8[out_cap].
AB_EXPORT int ab_probe_expand(const void* lo, const void* count, const void* offsets,
                              const void* total, long long np, long long nb, long long out_cap,
                              void* probe_idx, void* build_pos, void* valid, void* stream) {
  if (np < 1 || nb < 1 || out_cap < 0 || out_cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (out_cap == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  probe_expand<<<ab_grid(np, threads, 132 * 16), threads, 0, s>>>(
      (const int32_t*)lo, (const long long*)count, (const long long*)offsets, np, out_cap,
      (int32_t*)probe_idx, (int32_t*)build_pos, (uint8_t*)valid);
  int err = ab_last_error();
  if (err) return err;
  probe_fill<<<ab_grid(out_cap, threads, 132 * 16), threads, 0, s>>>(
      (const int32_t*)lo, (const long long*)count, (const long long*)offsets,
      (const long long*)total, np, nb, out_cap, (int32_t*)probe_idx, (int32_t*)build_pos,
      (uint8_t*)valid);
  return ab_last_error();
}
