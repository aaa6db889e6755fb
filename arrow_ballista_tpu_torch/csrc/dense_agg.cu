// K1: dense grouped aggregation over a dense key domain, in one launch a
// call: either grouped_aggregate's compacted groups or slot-aligned states.
//
// Replaces arrow_ballista_tpu/ops/kernels.py dense_group_states (l.564)
// with grouped_sums_i64 (l.455) and grouped_minmax_i64 (l.529) as the dense
// path uses them, and the compaction after them (l.638, l.677): the grouped
// aggregate of HashAggregateExec ("agg.grouped", operators.py:885).  The
// fused row-major key over the declared (lo, hi) ranges is the slot id.
// Per slot and aggregate, in the value's own type as XLA's segment ops
// compute it: int64 and int32 sums and counts (wrapping mod 2^64 and 2^32,
// order-free, so bit-exact), int64 and int32 min / max (empty slots keep
// the type's max / min), float64 and float32 sums (the order of additions
// varies between runs: compare at a tolerance, or on values whose sums are
// exact in any order), float min / max (NaN propagates), and an exists
// count.  Rows outside the ranges add nothing (the reference folds them
// into its scratch slot, which it then drops) and raise the bad-rows flag.
//
// Forms (DenseSpec.form): AB_DENSE_COMPACT writes what the reference's
// compaction gives, the groups in ascending slot order, then the empty
// slots, keys decoded from the slot, cut or zero-padded to out_capacity,
// and overflow | bad rows where the domain exceeds out_capacity (the K2
// launch and the torch glue of the parent's finish are gone).
// AB_DENSE_SLOTS writes slot-aligned values, exists counts and the flag,
// which the mesh merges across ranks (K18) before one compaction.
//
// Design: the core of dense_agg.cuh (one launch; zero-identity words in a
// per-stream state the last block resets; a warp's lanes grouped by slot
// and combined by shuffles before one atomic a group and aggregate).  Here
// the plan arrives at run time: a thread takes ColumnSource::ROWS rows a
// pass, finds their slots and groups once, then loops over the aggregates
// outside the rows, so each fold's branch is the same for the whole warp
// and each value column is read straight into a register.
// Bound: bytes (each key, value and mask byte read once, the result
// written once).  chip_smoke.py's hot-slot sweep measures what a few hot
// slots add to that.
#include "dense_agg.cuh"

// rows from the key and value columns of the spec
struct ColumnSource {
  static constexpr int THREADS = 1024;  // the last block's finish, spread over more threads
  static constexpr int ROWS = 4;

  // the pass's slots: -1 for a dead row, and for a live one with a key
  // outside its range (then *bad is set); a key is read for every row, so
  // the loads of a key's rows issue together
  static __device__ __forceinline__ void slots_of(const DenseSpec& s, long long base,
                                                  int (&slot)[ROWS], bool* bad) {
    unsigned fused[ROWS];
    bool live[ROWS], in_range[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const long long i = dense_row(base, j);
      live[j] = i < s.n && __ldg((const unsigned char*)s.mask + i);
      fused[j] = 0;
      in_range[j] = true;
    }
    for (int k = 0; k < s.k; ++k) {
      int v[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const long long i = dense_row(base, j) < s.n ? dense_row(base, j) : 0;
        switch (s.key_kind[k]) {
          case AB_KIND_I32: v[j] = __ldg((const int*)s.key[k] + i); break;
          case AB_KIND_I64: v[j] = (int)__ldg((const long long*)s.key[k] + i); break;  // truncates
          default: v[j] = __ldg((const unsigned char*)s.key[k] + i) != 0;
        }
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) dense_key(s, k, v[j], &fused[j], &in_range[j]);
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      slot[j] = live[j] && in_range[j] ? (int)fused[j] : -1;
      *bad |= live[j] && !in_range[j];
    }
  }

  template <class F, bool SMEM>
  static __device__ __forceinline__ void fold_column(const DenseSpec& s, const void* col,
                                                     long long base, const int (&slot)[ROWS],
                                                     const DenseGroup (&g)[ROWS],
                                                     unsigned long long* acc) {
    using W = typename F::W;
    W x[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const long long i = dense_row(base, j);
      x[j] = (!F::COUNT && i < s.n) ? __ldg((const W*)col + i) : (W)0;
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) dense_fold<F, SMEM>(g[j], slot[j], x[j], acc);
  }

  template <bool SMEM>
  __device__ __forceinline__ void fold_tile(const DenseSpec& s, long long base,
                                            const DenseAcc& acc, bool* bad) const {
    int slot[ROWS];
    DenseGroup g[ROWS];
    slots_of(s, base, slot, bad);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      g[j] = dense_group(slot[j]);
      dense_count(g[j], slot[j], acc.exists);
    }
    for (int a = 0; a < s.m; ++a) {  // the same branch on every lane
      unsigned long long* w = acc.acc + (long long)a * s.domain;
      switch (dense_code(s.how[a], s.val_kind[a])) {
#define AB_COLUMN_CASE(H, K)                                           \
  case dense_code(H, K):                                               \
    fold_column<DenseFold<H, K>, SMEM>(s, s.val[a], base, slot, g, w); \
    break;
        AB_DENSE_FOLDS(AB_COLUMN_CASE)
#undef AB_COLUMN_CASE
      }
    }
  }
};

AB_EXPORT long long ab_dense_state_words(int m, int domain) { return ab_dense_words(m, domain); }

// spec: the keys, values, mask, form and outputs (see DenseSpec); spec->state
// holds ab_dense_state_words(m, domain) words, zero between calls.
// Returns a cudaError_t.
AB_EXPORT int ab_dense_group_states(const DenseSpec* spec, void* stream) {
  DenseSpec s = *spec;
  if (s.n > 0 && s.mask == nullptr) return (int)cudaErrorInvalidValue;
  return ab_dense_launch(ColumnSource{}, s, (cudaStream_t)stream);
}
