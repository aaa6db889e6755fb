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
// row.  Otherwise rows go straight to device-memory atomics.  The body is
// the template of dense_agg.cuh over a row source that reads the key and
// value columns; K13 instantiates it over a generated row function.
// Bound: bytes (each key and value read once).  chip_smoke.py's hot-slot
// sweep measures what same-slot atomic contention adds to that.
#include "dense_agg.cuh"

// rows from the key and value columns of the spec
struct ColumnSource {
  static constexpr int KMAX = AB_MAX_KEYS;
  static constexpr int MMAX = AB_MAX_AGGS;
  DenseSpec s;
  const uint8_t* mask;

  __device__ __forceinline__ bool row(long long i, int* keys, unsigned long long* words) const {
    if (!mask[i]) return false;
    for (int j = 0; j < s.k; ++j) {
      switch (s.key_kind[j]) {
        case AB_KIND_I32: keys[j] = ((const int32_t*)s.key[j])[i]; break;
        case AB_KIND_I64: keys[j] = (int)((const int64_t*)s.key[j])[i]; break;  // truncates
        default: keys[j] = ((const uint8_t*)s.key[j])[i] != 0;
      }
    }
    for (int a = 0; a < s.m; ++a) {
      if (s.how[a] == AB_AGG_COUNT) words[a] = 1ULL;
      else if (s.val_kind[a] == AB_KIND_I32 || s.val_kind[a] == AB_KIND_F32)
        words[a] = ((const unsigned int*)s.val[a])[i];  // int32 or float bits in the low half
      else
        words[a] = ((const unsigned long long*)s.val[a])[i];  // int64 or double bits
    }
    return true;
  }
};

// acc: uint64[m * domain] (int64 or double bits, aggregate-major);
// exists: int32[domain]; bad: int32[1].  Returns a cudaError_t.
AB_EXPORT int ab_dense_group_states(const DenseSpec* spec, const void* mask, long long n,
                                    int domain, void* acc, void* exists, void* bad,
                                    void* stream) {
  ColumnSource src{*spec, (const uint8_t*)mask};
  return ab_dense_run(src, *spec, n, domain, acc, exists, bad, (cudaStream_t)stream);
}
