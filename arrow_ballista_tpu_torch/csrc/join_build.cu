// K5: build_side_sort — the join's build side, hashed and sorted by hash.
//
// Replaces arrow_ballista_tpu/ops/kernels.py build_side_sort (l.728), the
// "join.prep" program of JoinExec (operators.py:1205).  The reference
// hashes the build keys (hash64), gives dead rows 0xFFFF...FFFF, and
// returns (h[order], order, live count) with order = jnp.argsort(h), which
// is stable: rows with equal hashes keep their build-row order.  The probe
// expansion's pair order depends on that, so the order here is equal bit
// for bit, not only the sorted hashes.
//
// Design: the stable LSD radix core of radix.cuh over the (uint64 hash,
// int32 row) pairs.  The upfront pass is the hashing pass: it hashes each
// row with common.cuh's ab_hash_row (the same function as K3, so probe and
// build hashes agree), sets dead rows to all ones, counts the live rows and
// builds every digit position's histogram while the hash is in registers,
// so the keys are read once for both; rx_bases turns the histograms into
// the digit bases (the dead rows, whose keys are all ones, are counted
// there, not by shared atomics on one digit; it sums the live count into
// n_live, on the device, no host sync); then one onesweep pass a digit (8
// of 8 bits), each ranking a 4,096- or 8,192-row tile in shared memory,
// taking its offsets by decoupled look-back and writing each digit's run
// coalesced.  Launches: 2 + passes; a build that fits one block (8,192
// rows) sorts in one launch (radix.cuh's bitonic network over (hash, row)).
// Bound: bytes.  The one-pass minimum reads the keys once and writes the
// hashes and the order once; a pass reads and writes 12 bytes a row
// (8 in the first pass's reads: the row index is implicit), so the sort
// moves about 24 * passes bytes a row beyond the minimum.
#define RX_NS k5_radix
#include "radix.cuh"

using namespace k5_radix;

#define BUILD_ROWS 4  // rows an upfront thread loads before it hashes them

__global__ void __launch_bounds__(RX_UP_THREADS)
    build_upfront(HashCols c, const uint8_t* __restrict__ mask, long long n, int zero, int P,
                  uint64_t* __restrict__ keys, unsigned* __restrict__ hist_blk,
                  unsigned long long* __restrict__ live_blk, unsigned* status0,
                  long long status_words, unsigned* counters) {
  extern __shared__ uint64_t rx_smem[];
  __shared__ unsigned long long ws[RX_UP_THREADS / 32];
  unsigned* hist = reinterpret_cast<unsigned*>(rx_smem);
  const int hist_len = P * RX_BINS;
  rx_up_begin(hist, hist_len, status0, status_words, counters, P);
  unsigned long long live = 0ULL;
  // BUILD_ROWS rows a thread at a time, each column's loads issued for all
  // of them before the hash uses them: ab_hash_row's steps, column by column
  const long long step = (long long)gridDim.x * blockDim.x * BUILD_ROWS;
  for (long long i0 = (long long)blockIdx.x * blockDim.x * BUILD_ROWS + threadIdx.x; i0 < n;
       i0 += step) {
    uint64_t h[BUILD_ROWS];
    bool m[BUILD_ROWS];
#pragma unroll
    for (int u = 0; u < BUILD_ROWS; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      m[u] = i < n && mask[i] != 0;
      h[u] = 0ULL;
    }
    for (int j = 0; j < c.k; ++j) {
      uint64_t x[BUILD_ROWS];
#pragma unroll
      for (int u = 0; u < BUILD_ROWS; ++u) {
        const long long i = i0 + (long long)u * blockDim.x;
        x[u] = i < n ? ab_widen_u64(c, j, i) : 0ULL;
      }
#pragma unroll
      for (int u = 0; u < BUILD_ROWS; ++u) h[u] = ab_hash_combine(h[u], x[u]);
    }
#pragma unroll
    for (int u = 0; u < BUILD_ROWS; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      if (i < n) {
        const uint64_t hv = m[u] ? (zero ? 0ULL : h[u]) : 0xFFFFFFFFFFFFFFFFULL;
        keys[i] = hv;
        live += m[u];
        if (m[u]) {  // dead rows' digits are all ones: rx_bases adds them
          int p = 0;
          rx_count_limb(hist, P, 0ULL, hv, 0, 1, p);
        }
      }
    }
  }
  unsigned long long total;
  ab_block_exclusive_scan<unsigned long long>(live, ws, &total);
  if (threadIdx.x == 0) live_blk[blockIdx.x] = total;
  rx_up_end(hist, hist_len, hist_blk);
}

// the single-block form: hash, count, the bitonic network and the outputs
// in one launch
__global__ void __launch_bounds__(RX_SB_THREADS)
    build_block(HashCols c, const uint8_t* __restrict__ mask, int n, int zero,
                uint64_t* __restrict__ hash_out, int32_t* __restrict__ order_out,
                long long* __restrict__ n_live) {
  extern __shared__ uint64_t rx_smem[];
  __shared__ unsigned long long ws[RX_SB_THREADS / 32];
  RxBlockParts q = rx_block_parts(rx_smem, n, 1);
  unsigned long long live = 0ULL;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool m = mask[i] != 0;
    q.keys[i] = m ? (zero ? 0ULL : ab_hash_row(c, i)) : 0xFFFFFFFFFFFFFFFFULL;
    live += m;
  }
  unsigned long long total;
  ab_block_exclusive_scan<unsigned long long>(live, ws, &total);  // syncs the block
  if (threadIdx.x == 0) *n_live = (long long)total;
  rx_block_sort(q.keys, n, 1, q.idx);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = q.idx[i];
    hash_out[i] = q.keys[r];
    order_out[i] = r;
  }
}

static bool build_is_block(long long n) { return rx_block_bytes(n, 1) > 0; }

// 1 where a build of n rows takes the single-block form
AB_EXPORT int ab_build_is_block(long long n) { return build_is_block(n) ? 1 : 0; }

// scratch layout (bytes, each part 16-byte aligned): keys u64[n], rows
// i32[n], then radix.cuh's control (rx_control_bytes); none for one block
AB_EXPORT long long ab_build_scratch_bytes(long long n) {
  if (build_is_block(n)) return 16;
  return ab_align16(n * 8) + ab_align16(n * 4) + rx_control_bytes(n, rx_passes(64));
}

static int build_onesweep(const HashCols& c, const uint8_t* mask, long long n, int zero,
                          uint64_t* hash_out, int32_t* order_out, long long* n_live,
                          char* scratch, cudaStream_t st) {
  const int P = rx_passes(64);
  uint64_t* keys_tmp = (uint64_t*)scratch;
  char* p = scratch + ab_align16(n * 8);
  int32_t* rows_tmp = (int32_t*)p;
  p += ab_align16(n * 4);
  const RxScratch sc = rx_carve(p, n, P);
  // the passes ping-pong between the outputs and the scratch copies; the
  // last pass writes index P & 1, and the upfront pass writes keys[0]
  uint64_t* keys[2];
  int32_t* rows[2];
  keys[P & 1] = hash_out;
  keys[(P + 1) & 1] = keys_tmp;
  rows[P & 1] = order_out;
  rows[(P + 1) & 1] = rows_tmp;
  const int G = rx_up_blocks(n);
  const size_t hist_bytes = (size_t)P * RX_BINS * 4;
  int err = rx_allow_smem(build_upfront, hist_bytes);
  if (err) return err;
  build_upfront<<<G, RX_UP_THREADS, hist_bytes, st>>>(c, mask, n, zero, P, keys[0], sc.hist_blk,
                                                      sc.live_blk, sc.status, sc.status_words,
                                                      sc.counters);
  err = ab_last_error();
  if (err) return err;
  return rx_onesweep_passes(keys, rows, n, 1, P, 1, sc, G, n_live, st);
}

// hash_out: uint64[n] sorted (as int64 bits); order_out: int32[n];
// n_live: int64[1]; scratch: ab_build_scratch_bytes(n) bytes.
AB_EXPORT int ab_build_side_sort(const void* const* ptrs, const int* kinds, int k,
                                 const void* mask, long long n, int zero, void* hash_out,
                                 void* order_out, void* n_live, void* scratch, void* stream) {
  if (n < 1 || n >= RX_MAX_ROWS) return (int)cudaErrorInvalidValue;
  HashCols c;
  int err = ab_fill_hash_cols(&c, ptrs, kinds, k);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (build_is_block(n)) {
    const long long smem = rx_block_bytes(n, 1);
    err = rx_allow_smem(build_block, (size_t)smem);
    if (err) return err;
    build_block<<<1, RX_SB_THREADS, (size_t)smem, st>>>(c, (const uint8_t*)mask, (int)n, zero,
                                                        (uint64_t*)hash_out, (int32_t*)order_out,
                                                        (long long*)n_live);
    return ab_last_error();
  }
  return build_onesweep(c, (const uint8_t*)mask, n, zero, (uint64_t*)hash_out,
                        (int32_t*)order_out, (long long*)n_live, (char*)scratch, st);
}
