// K12 fused_rows and K13 fused_agg: the frame around the row function that
// compile/codegen.py generates for one fused operator chain.
//
// Replaces arrow_ballista_tpu/compile/fused.py:188 fused_rows and :204
// fused_agg.  The generated source defines
//
//   struct AbRow {
//     // every output column and the mask of row i (K12, and the key and
//     // value columns of K13's sort path)
//     static AB_HD void rows(const AbFusedIn& in, const AbFusedOut& out, long long i);
//     // agg chains: row i's live flag, key values and value words (K13 dense)
//     static AB_HD bool keys_words(const AbFusedIn& in, long long i, int* keys,
//                                  unsigned long long* words);
//   };
//
// then expands AB_FUSED_ROWS_ENTRY(AbRow) and, for an agg chain,
//
//   using AbFoldList = AbFolds<AbFold<how, kind>, ...>;  // one per value word
//   AB_FUSED_AGG_ENTRY(AbRow, K, M)
//
// Under nvcc these are the kernels and their plain-C launchers (K13's
// dense form is K1's core, csrc/dense_agg.cuh, with each aggregate's fold
// fixed at compile time: the value words stay in registers and no per-row
// switch is left); under a host compiler (g++, no __CUDACC__) they are
// host loops over the same row function, which is how the tests check the
// generated C where no nvcc exists.
//
// The row function is straight-line code over the chain's expression
// closures traced symbolically: integer arithmetic wraps (it is emitted on
// unsigned types), % and // take the divisor's sign as torch's do, NaN
// compares as torch's does, and a lookup-table gather clamps its index
// into the table as TorchOps.take does.  Build with contraction off
// (--fmad=false, -ffp-contract=off): a fused multiply-add would round
// differently from the interpreted chain.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "civil.cuh"  // EXTRACT (K14's row function)

#ifdef __CUDACC__
#define AB_HD __host__ __device__ __forceinline__
#else
#define AB_HD inline
#endif

// K13's dense form: the fold of each value word (how: csrc/dense_agg.cuh
// AB_AGG_*, kind: common.cuh AB_KIND_*), in value-word order
template <int HOW, int KIND>
struct AbFold {
  static constexpr int how = HOW;
  static constexpr int kind = KIND;
};

template <class... F>
struct AbFolds {
  static constexpr int size = sizeof...(F);
};

#define AB_FUSED_MAX_IN 64
#define AB_FUSED_MAX_OUT 64
#define AB_FUSED_MAX_AUX 32

struct AbFusedIn {
  const void* col[AB_FUSED_MAX_IN];  // the input columns the chain reads
  const bool* mask;
  const void* aux[AB_FUSED_MAX_AUX];  // lookup tables (dictionary LUTs, remaps)
  long long aux_len[AB_FUSED_MAX_AUX];
};

struct AbFusedOut {
  void* col[AB_FUSED_MAX_OUT];  // fresh output columns
  bool* mask;
};

AB_HD long long ab_clamp_idx(long long c, long long len) {
  return c < 0 ? 0 : (c >= len ? len - 1 : c);
}

AB_HD double ab_f64(unsigned long long bits) {
  double d;
  memcpy(&d, &bits, 8);
  return d;
}

AB_HD float ab_f32(unsigned int bits) {
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

AB_HD unsigned long long ab_f64_bits(double d) {
  unsigned long long b;
  memcpy(&b, &d, 8);
  return b;
}

AB_HD unsigned int ab_f32_bits(float f) {
  unsigned int b;
  memcpy(&b, &f, 4);
  return b;
}

// Python-style remainder and floor division (the divisor's sign), as
// torch's % and // on integers; a zero divisor (and the one overflowing
// quotient) gives 0 where C has no defined result
AB_HD long long ab_mod_i64(long long a, long long b) {
  if (b == 0 || b == -1) return 0;
  long long r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

AB_HD int ab_mod_i32(int a, int b) {
  if (b == 0 || b == -1) return 0;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

AB_HD long long ab_floordiv_i64(long long a, long long b) {
  if (b == 0) return 0;
  if (b == -1) return (long long)(0ULL - (unsigned long long)a);
  long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

AB_HD int ab_floordiv_i32(int a, int b) {
  if (b == 0) return 0;
  if (b == -1) return (int)(0U - (unsigned int)a);
  int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

AB_HD double ab_mod_f64(double a, double b) {
  double m = fmod(a, b);
  return (m != 0 && ((b < 0) != (m < 0))) ? m + b : m;
}

AB_HD float ab_mod_f32(float a, float b) {
  float m = fmodf(a, b);
  return (m != 0 && ((b < 0) != (m < 0))) ? m + b : m;
}

AB_HD double ab_floordiv_f64(double a, double b) { return floor(a / b); }

AB_HD float ab_floordiv_f32(float a, float b) { return floorf(a / b); }

// torch.clamp: NaN stays NaN
template <typename T>
AB_HD T ab_clamp(T x, T lo, T hi) {
  if (x != x) return x;
  T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

#ifdef __CUDACC__
#include "dense_agg.cuh"

#define AB_FUSED_ROWS_ENTRY(ROW)                                                          \
  __global__ void ab_fused_rows_kernel(AbFusedIn in, AbFusedOut out, long long n) {      \
    long long step = (long long)gridDim.x * blockDim.x;                                   \
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) \
      ROW::rows(in, out, i);                                                              \
  }                                                                                       \
  AB_EXPORT int ab_fused_rows(const AbFusedIn* in, const AbFusedOut* out, long long n,   \
                              void* stream) {                                             \
    if (n < 1) return (int)cudaErrorInvalidValue;                                         \
    const int threads = 256;                                                              \
    ab_fused_rows_kernel<<<ab_grid(n, threads, 132 * 8), threads, 0,                      \
                           (cudaStream_t)stream>>>(*in, *out, n);                         \
    return ab_last_error();                                                               \
  }

// the row source of K13's dense form: row i's keys and value words from
// the generated row function, each word folded by its compile-time fold
template <class ROW, int K, class... F>
struct AbGenSource {
  static constexpr int THREADS = 512;
  static constexpr int ROWS = 2;
  static constexpr int M = sizeof...(F);
  AbFusedIn in;

  template <bool SMEM, size_t... A>
  static __device__ __forceinline__ void fold_words(const unsigned long long* words, int slot,
                                                    const DenseGroup& g, unsigned long long* acc,
                                                    int domain, std::index_sequence<A...>) {
    (dense_fold<DenseFold<F::how, F::kind>, SMEM>(
         g, slot, (typename DenseFold<F::how, F::kind>::W)words[A], acc + (long long)A * domain),
     ...);
  }

  template <bool SMEM>
  __device__ __forceinline__ void fold_tile(const DenseSpec& s, long long base,
                                            const DenseAcc& acc, bool* bad) const {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const long long i = dense_row(base, j);
      int keys[K];
      unsigned long long words[M > 0 ? M : 1];
      int slot = -1;
      if (i < s.n && ROW::keys_words(in, i, keys, words)) {
        unsigned fused = 0;
        bool in_range = true;
#pragma unroll
        for (int k = 0; k < K; ++k) dense_key(s, k, keys[k], &fused, &in_range);
        if (in_range) slot = (int)fused;
        else *bad = true;
      }
      const DenseGroup g = dense_group(slot);
      dense_count(g, slot, acc.exists);
      fold_words<SMEM>(words, slot, g, acc.acc, s.domain, std::index_sequence_for<F...>{});
    }
  }
};

template <class ROW, int K, class... F>
static int ab_fused_dense_run(const AbFusedIn& in, const DenseSpec& spec, AbFolds<F...>,
                              cudaStream_t st) {
  // the run-time plan (the finish reads it) must be the compiled one
  const int how[] = {F::how..., 0}, kind[] = {F::kind..., 0};
  if (spec.k != K || spec.m != (int)sizeof...(F)) return (int)cudaErrorInvalidValue;
  for (int a = 0; a < spec.m; ++a)
    if (spec.how[a] != how[a] || (how[a] != AB_AGG_COUNT && spec.val_kind[a] != kind[a]))
      return (int)cudaErrorInvalidValue;
  return ab_dense_launch(AbGenSource<ROW, K, F...>{in}, spec, st);
}

// K13's dense form: spec as for K1 (csrc/dense_agg.cu) without the key,
// value and mask pointers
#define AB_FUSED_AGG_ENTRY(ROW, K, M)                                                     \
  static_assert(AbFoldList::size == (M), "one fold a value word");                        \
  AB_EXPORT int ab_fused_dense(const AbFusedIn* in, const DenseSpec* spec, void* stream) { \
    return ab_fused_dense_run<ROW, K>(*in, *spec, AbFoldList{}, (cudaStream_t)stream);     \
  }

#else  // host compiler: loops over the same row function

#define AB_FUSED_EXPORT extern "C" __attribute__((visibility("default")))

#define AB_FUSED_ROWS_ENTRY(ROW)                                                          \
  AB_FUSED_EXPORT void ab_fused_rows_host(const AbFusedIn* in, const AbFusedOut* out,    \
                                          long long n) {                                  \
    for (long long i = 0; i < n; ++i) ROW::rows(*in, *out, i);                            \
  }

// live flags, keys (row-major [n][K]) and value words ([n][M]) of every row
#define AB_FUSED_AGG_ENTRY(ROW, K, M)                                                     \
  AB_FUSED_EXPORT void ab_fused_keys_words_host(const AbFusedIn* in, long long n,        \
                                                bool* live, int* keys,                   \
                                                unsigned long long* words) {             \
    for (long long i = 0; i < n; ++i)                                                     \
      live[i] = ROW::keys_words(*in, i, keys + i * (K), words + i * ((M) > 0 ? (M) : 1)); \
  }

#endif
