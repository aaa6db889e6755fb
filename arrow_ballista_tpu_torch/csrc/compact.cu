// K2: compaction_order — stable permutation that moves live rows first.
//
// Replaces arrow_ballista_tpu/ops/kernels.py compaction_order (l.88), which
// ColumnBatch.shrink ("batch.shrink"), pack_for_host and the stable
// argsort(~exists) of compact_dense_states use.  A live row's destination
// is the number of live rows before it; a dead row's is n_live plus the
// number of dead rows before it; perm[dest] = i.
//
// Three launches, no library scan:
//   1. ab_scan_tile_sums (common.cuh): each block counts the live flags of
//      one tile of AB_SCAN_TILE rows;
//   2. ab_scan_tile_offsets (common.cuh): one block turns the tile counts
//      into exclusive offsets, in place, and writes the number of live rows
//      after them;
//   3. tile_scatter: each block rescans its tile (warp shuffles, then the
//      warp totals in shared memory), adds the tile's offset and scatters.
// Bound: bytes.  The flags are read twice (1 byte a row each time) and the
// permutation written once (4 bytes a row); the minimum is 5 bytes a row.
#include "common.cuh"

__global__ void tile_scatter(const uint8_t* __restrict__ mask, long long n,
                             const int* __restrict__ offsets, const int* __restrict__ n_live,
                             int32_t* __restrict__ perm) {
  __shared__ int warp_sums[AB_SCAN_THREADS / 32];
  const long long base =
      (long long)blockIdx.x * AB_SCAN_TILE + (long long)threadIdx.x * AB_SCAN_ITEMS;
  uint8_t f[AB_SCAN_ITEMS];
  int c = 0;
#pragma unroll
  for (int j = 0; j < AB_SCAN_ITEMS; ++j) {
    long long i = base + j;
    f[j] = (i < n) ? (mask[i] != 0) : 0;
    c += f[j];
  }
  int total;
  int ex = ab_block_exclusive_scan<int>(c, warp_sums, &total);
  long long live_before = (long long)offsets[blockIdx.x] + ex;  // live rows before `base`
  const long long live_total = *n_live;
#pragma unroll
  for (int j = 0; j < AB_SCAN_ITEMS; ++j) {
    long long i = base + j;
    if (i >= n) break;
    long long dest;
    if (f[j]) {
      dest = live_before;
      ++live_before;
    } else {
      dest = live_total + (i - live_before);  // dead rows before i
    }
    perm[dest] = (int32_t)i;
  }
}

// perm: int32[n]; scratch: int32[num_tiles + 1] with
// num_tiles = ceil(n / ab_compact_tile()); scratch[num_tiles] receives the
// number of live rows.
AB_EXPORT int ab_compact_tile() { return AB_SCAN_TILE; }

AB_EXPORT int ab_compaction_order(const void* mask, long long n, void* perm, void* scratch,
                                  void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long num_tiles = ab_scan_tiles(n);
  int* offsets = (int*)scratch;
  // the flags are 0 or 1 (torch bool), so their sum is the live count
  ab_scan_tile_sums<uint8_t, int><<<(unsigned)num_tiles, AB_SCAN_THREADS, 0, s>>>(
      (const uint8_t*)mask, n, offsets);
  int err = ab_last_error();
  if (err) return err;
  ab_scan_tile_offsets<int><<<1, AB_SCAN_TOP_THREADS, 0, s>>>(offsets, num_tiles);
  err = ab_last_error();
  if (err) return err;
  tile_scatter<<<(unsigned)num_tiles, AB_SCAN_THREADS, 0, s>>>(
      (const uint8_t*)mask, n, offsets, offsets + num_tiles, (int32_t*)perm);
  return ab_last_error();
}
