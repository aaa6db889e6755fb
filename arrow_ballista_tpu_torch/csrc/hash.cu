// K3: hash64 / bucket_of — shuffle partition ids per row; and K16's first
// form, spill_partition — the spilled join's build partition of each row
// (the spilled join now calls K16's second form, spill_order in
// compact.cu, which also orders the rows by partition for the pack).
//
// Replaces arrow_ballista_tpu/ops/kernels.py hash64 (l.62) and bucket_of
// (l.77), used by the repartition bucketing program (ops/shuffle.py:499).
// Bit-identical to the JAX function: each key column is widened to uint64
// as XLA's astype(uint64) does (int32 sign-extends, so a -1 NULL code is
// 0xFFFF...FFFF; bool is 0/1; int64 and uint64 bits pass through), mixed
// with splitmix64, and combined h = h*0x9E3779B97F4A7C15 + x; h ^= h>>29 in
// wrapping uint64.  bucket_of is that hash % n as int32.
//
// The widening and the mix-and-combine step live in common.cuh
// (ab_hash_row), which K5 shares.
//
// K16 replaces the reference's "join.spill_part" program
// (arrow_ballista_tpu/ops/operators.py:1512, part_fn): the top ``bits``
// bits of hash64 over the build keys, (h >> (64 - bits)) & (2^bits - 1),
// as int32.  It runs K3's widening and combine in registers, so the 64-bit
// hash never goes through device memory: 4 bytes a row are written where
// hash64 + a shift would write 8 and read them back.  Forced collisions
// (every hash 0) put every row in partition 0, as in the reference.
//
// Bound: bytes.  One pass reads each key once and writes 4 or 8 bytes a
// row; the few integer multiplies a row are far below the card's rate.  One
// thread a row, grid-stride, neighbouring threads on neighbouring rows.
#include "common.cuh"

__global__ void hash64_kernel(HashCols c, long long n, int zero, uint64_t* out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    out[i] = zero ? 0ULL : ab_hash_row(c, i);
  }
}

__global__ void bucket_kernel(HashCols c, long long n, int zero, uint64_t buckets, int32_t* out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint64_t h = zero ? 0ULL : ab_hash_row(c, i);
    out[i] = (int32_t)(h % buckets);
  }
}

// out: uint64[n] (handed over as int64 bits)
AB_EXPORT int ab_hash64(const void* const* ptrs, const int* kinds, int k, long long n,
                        int zero, void* out, void* stream) {
  HashCols c;
  int err = ab_fill_hash_cols(&c, ptrs, kinds, k);
  if (err) return err;
  const int threads = 256;
  hash64_kernel<<<ab_grid(n, threads, 132 * 16), threads, 0, (cudaStream_t)stream>>>(
      c, n, zero, (uint64_t*)out);
  return ab_last_error();
}

// out: int32[n]
AB_EXPORT int ab_bucket_of(const void* const* ptrs, const int* kinds, int k, long long n,
                           int zero, int num_buckets, void* out, void* stream) {
  HashCols c;
  int err = ab_fill_hash_cols(&c, ptrs, kinds, k);
  if (err) return err;
  if (num_buckets < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  bucket_kernel<<<ab_grid(n, threads, 132 * 16), threads, 0, (cudaStream_t)stream>>>(
      c, n, zero, (uint64_t)num_buckets, (int32_t*)out);
  return ab_last_error();
}

__global__ void spill_part_kernel(HashCols c, long long n, int zero, int bits, int32_t* out) {
  const uint64_t top = (1ULL << bits) - 1ULL;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    uint64_t h = zero ? 0ULL : ab_hash_row(c, i);
    out[i] = (int32_t)((h >> (64 - bits)) & top);
  }
}

// out: int32[n], each in [0, 2^bits)
AB_EXPORT int ab_spill_partition(const void* const* ptrs, const int* kinds, int k, long long n,
                                 int zero, int bits, void* out, void* stream) {
  HashCols c;
  int err = ab_fill_hash_cols(&c, ptrs, kinds, k);
  if (err) return err;
  if (bits < 1 || bits > 30) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  spill_part_kernel<<<ab_grid(n, threads, 132 * 16), threads, 0, (cudaStream_t)stream>>>(
      c, n, zero, bits, (int32_t*)out);
  return ab_last_error();
}
