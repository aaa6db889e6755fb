// K1's accumulator core, shared by K1 (csrc/dense_agg.cu: rows from key and
// value columns, the aggregate plan read at run time) and K13's dense form
// (a generated source from compile/codegen.py: rows from the fused chain's
// row function, the plan fixed when the source is generated, so the key
// and value columns never exist in device memory).
//
// One launch a call, no init kernel and no memset.  Every accumulator word
// holds its value encoded so that the all-zero word is the fold's
// identity, and every fold is an add or an unsigned max (DenseFold).  A
// per-(device, stream) state buffer (ticket, bad-rows word, exists counts,
// accumulators) is all zero between calls: blocks fold into it, the block
// that draws the last ticket (ab_last_block) writes the result and puts
// back to zero the words the call touched (only live slots' words are ever
// touched), so whatever domain, aggregate count or capacity the next call
// on the stream has, it finds zeros.
//
// Within a block, a warp groups its lanes by slot (__match_any_sync), the
// peers' words are combined by shuffles along a tree computed once per
// row step (DenseGroup: at most five levels, each lane's source lane per
// level packed into one word), and the group's leader makes one atomic per
// aggregate: q1's four live slots cost at most four atomics a warp, not 32
// same-address ones.  The exists count adds the group's size; a count
// aggregate is the exists count, written by the finish, and folds nothing.
// Where m x domain x 8 + domain x 4 bytes fit AB_SHARED_LIMIT, the atomics
// go to block-private shared accumulators that each block merges into the
// state once (its live slots only); otherwise straight into the state.
//
// A row source provides THREADS (a block's), ROWS (rows a thread takes
// per pass) and
//   template <bool SMEM> __device__ void fold_tile(const DenseSpec&, long long base,
//                                                  const DenseAcc&, bool* bad) const;
// which folds the pass's rows base + j * THREADS + threadIdx.x.
#pragma once

#include <type_traits>
#include <utility>

#include "common.cuh"

#define AB_MAX_KEYS 8
#define AB_MAX_AGGS 32
#define AB_AGG_SUM 0
#define AB_AGG_COUNT 1
#define AB_AGG_MIN 2
#define AB_AGG_MAX 3
#define AB_SHARED_LIMIT (160 * 1024)
#define AB_DENSE_SLOTS 0    // form: slot-aligned states (the mesh's dense reduce)
#define AB_DENSE_COMPACT 1  // form: grouped_aggregate's compacted groups
#define AB_DENSE_FINISH_SLOTS 4  // slots a thread per step of the compacted finish

struct DenseSpec {
  const void* key[AB_MAX_KEYS];  // K1's column source only
  int key_kind[AB_MAX_KEYS];     // the key's dtype (K1's column, and the output's)
  int lo[AB_MAX_KEYS];
  int hi[AB_MAX_KEYS];
  int stride[AB_MAX_KEYS];
  int k;
  const void* val[AB_MAX_AGGS];  // K1's column source only
  int val_kind[AB_MAX_AGGS];     // AB_KIND_I32, _I64, _F32 or _F64; count: AB_KIND_I64
  int how[AB_MAX_AGGS];
  int m;
  const void* mask;  // K1's column source only (K13's row function gives liveness)
  long long n;
  int domain;
  int form;
  int out_capacity;              // the compacted form's rows
  void* out_key[AB_MAX_KEYS];    // compacted: out_capacity keys in key_kind
  void* out_val[AB_MAX_AGGS];    // compacted: out_capacity values; slot-aligned: domain
  void* out_mask;                // compacted: bool[out_capacity]
  void* out_exists;              // slot-aligned: int32[domain]
  void* out_flag;                // bool[1]: slot-aligned: bad rows; compacted (domain >
                                 // out_capacity only): overflow | bad rows
  unsigned long long* state;     // ab_dense_state_words(m, domain) words, zero between calls
};

// The state: [0] ticket, [1] bad rows, then uint32 exists[domain], then
// the accumulators, [m][domain] words (a 32-bit value in the low half).
static inline long long ab_dense_words(int m, int domain) {
  return 2 + (domain + 1) / 2 + (long long)m * domain;
}

__device__ __forceinline__ unsigned* dense_exists(unsigned long long* state) {
  return (unsigned*)(state + 2);
}

__device__ __forceinline__ unsigned long long* dense_accs(unsigned long long* state, int domain) {
  return state + 2 + (domain + 1) / 2;
}

// where a block's atomics go: shared memory or the state
struct DenseAcc {
  unsigned long long* acc;  // [m][domain]
  unsigned* exists;         // [domain]
};

// ---------------------------------------------------------------------------
// folds: encoded so that zero is the identity and the fold is + or max
// ---------------------------------------------------------------------------

// a float's bits as an unsigned key in the float's order (NaN excluded)
__device__ __forceinline__ unsigned long long dense_order64(unsigned long long b) {
  return (b >> 63) ? ~b : b | (1ULL << 63);
}

__device__ __forceinline__ unsigned dense_order32(unsigned b) {
  return (b >> 31) ? ~b : b | (1u << 31);
}

template <int HOW, int KIND>
struct DenseFold {
  static constexpr bool COUNT = HOW == AB_AGG_COUNT;
  static constexpr bool WIDE = COUNT || KIND == AB_KIND_I64 || KIND == AB_KIND_F64;
  static constexpr bool MAX = HOW == AB_AGG_MIN || HOW == AB_AGG_MAX;  // else +
  static constexpr bool FLOAT = KIND == AB_KIND_F32 || KIND == AB_KIND_F64;
  using W = typename std::conditional<WIDE, unsigned long long, unsigned>::type;
  static constexpr W SIGN = (W)1 << (8 * sizeof(W) - 1);

  // a value's bits (an int64 or a double; a 32-bit value) -> its word
  static __device__ __forceinline__ W encode(W x) {
    if constexpr (!MAX) {
      return x;  // sums: the value; + wraps for integers, rounds for floats
    } else if constexpr (FLOAT) {  // NaN above everything, for min and max
      W key;
      if constexpr (WIDE) {
        if ((x & ~SIGN) > 0x7ff0000000000000ULL) return ~(W)0;
        key = dense_order64(x);
      } else {
        if ((x & ~SIGN) > 0x7f800000u) return ~(W)0;
        key = dense_order32(x);
      }
      return HOW == AB_AGG_MAX ? key : ~key;
    } else {
      return HOW == AB_AGG_MAX ? x ^ SIGN : ~(x ^ SIGN);
    }
  }

  static __device__ __forceinline__ W combine(W a, W b) {
    if constexpr (MAX) {
      return a > b ? a : b;
    } else if constexpr (KIND == AB_KIND_F64 && !COUNT) {
      return (W)__double_as_longlong(__longlong_as_double((long long)a) +
                                     __longlong_as_double((long long)b));
    } else if constexpr (KIND == AB_KIND_F32) {
      return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
    } else {
      return a + b;
    }
  }

  // SMEM: p lies in shared memory, where a 64-bit add is a compare-and-
  // swap loop on the H100: an integer one is two native 32-bit adds there
  // (the low word's carry, exact from the value it replaced, goes into the
  // high word; only the block's final words are read)
  template <bool SMEM = false>
  static __device__ __forceinline__ void atomic(W* p, W v) {
    if constexpr (SMEM && WIDE && !MAX && !FLOAT) {
      unsigned* p32 = (unsigned*)p;
      const unsigned lo = (unsigned)v;
      const unsigned hi = (unsigned)(v >> 32) + (atomicAdd(p32, lo) + lo < lo ? 1u : 0u);
      if (hi) atomicAdd(p32 + 1, hi);
    } else if constexpr (MAX) {
      atomicMax(p, v);
    } else if constexpr (KIND == AB_KIND_F64 && !COUNT) {
      atomicAdd((double*)p, __longlong_as_double((long long)v));
    } else if constexpr (KIND == AB_KIND_F32) {
      atomicAdd((float*)p, __uint_as_float(v));
    } else {
      atomicAdd(p, v);
    }
  }
};

// a fold's code for a run-time switch; counts fold as int64
__host__ __device__ constexpr int dense_code(int how, int kind) { return how * 8 + kind; }

#define AB_DENSE_FOLDS(X)                                                                   \
  X(AB_AGG_SUM, AB_KIND_I64) X(AB_AGG_SUM, AB_KIND_I32) X(AB_AGG_SUM, AB_KIND_F64)          \
  X(AB_AGG_SUM, AB_KIND_F32) X(AB_AGG_COUNT, AB_KIND_I64) X(AB_AGG_MIN, AB_KIND_I64)        \
  X(AB_AGG_MIN, AB_KIND_I32) X(AB_AGG_MIN, AB_KIND_F64) X(AB_AGG_MIN, AB_KIND_F32)          \
  X(AB_AGG_MAX, AB_KIND_I64) X(AB_AGG_MAX, AB_KIND_I32) X(AB_AGG_MAX, AB_KIND_F64)          \
  X(AB_AGG_MAX, AB_KIND_F32)

// a word -> the value's bits in its dtype's width (the identity for zero)
__device__ __forceinline__ unsigned long long dense_decode(int how, int kind,
                                                           unsigned long long w) {
  const bool wide = how == AB_AGG_COUNT || kind == AB_KIND_I64 || kind == AB_KIND_F64;
  if (how == AB_AGG_SUM || how == AB_AGG_COUNT) return wide ? w : (unsigned)w;
  const bool is_max = how == AB_AGG_MAX;
  if (kind == AB_KIND_I64) return is_max ? w ^ (1ULL << 63) : ~w ^ (1ULL << 63);
  if (kind == AB_KIND_I32) {
    const unsigned x = (unsigned)w;
    return is_max ? x ^ (1u << 31) : ~x ^ (1u << 31);
  }
  if (kind == AB_KIND_F64) {
    if (w == 0) return is_max ? 0xfff0000000000000ULL : 0x7ff0000000000000ULL;  // -+inf
    if (w == ~0ULL) return 0x7ff8000000000000ULL;                              // NaN
    const unsigned long long key = is_max ? w : ~w;
    return (key >> 63) ? key ^ (1ULL << 63) : ~key;
  }
  const unsigned x = (unsigned)w;  // float32
  if (x == 0) return is_max ? 0xff800000u : 0x7f800000u;
  if (x == ~0u) return 0x7fc00000u;
  const unsigned key = is_max ? x : ~x;
  return (key >> 31) ? key ^ (1u << 31) : ~key;
}

// fold a block's shared word into the state's (counts and sums add)
__device__ __forceinline__ void dense_merge(int how, int kind, unsigned long long* g,
                                            unsigned long long w) {
  switch (dense_code(how, kind)) {
#define AB_MERGE_CASE(H, K)                                          \
  case dense_code(H, K): {                                           \
    using F = DenseFold<H, K>;                                       \
    F::atomic((typename F::W*)g, (typename F::W)w);                  \
    break;                                                           \
  }
    AB_DENSE_FOLDS(AB_MERGE_CASE)
#undef AB_MERGE_CASE
  }
}

// ---------------------------------------------------------------------------
// the warp's groups
// ---------------------------------------------------------------------------

// The lanes of a warp that share a slot, and a tree that combines their
// words at the lowest of them: at level l, a lane adds the word of the
// next higher peer still in the tree, and the peers whose rank has bit l
// set leave it (Westphal's reduce_peers; the levels are the same for every
// aggregate, so they are found once).  levels is the same on every lane.
// (A warp reduction over each group's mask, redux.sync, serializes over
// the warp's groups: slower than the tree from four groups a warp, as
// q1's, and 5x slower at 289 slots on the H100.)
struct DenseGroup {
  unsigned peers;
  unsigned sched;  // per level l, bits 6l..6l+5: 1 + the source lane, 0 for none
  int levels;
  bool leader;     // the lowest lane of its peers
};

__device__ __forceinline__ DenseGroup dense_group(int slot) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  DenseGroup g;
  g.peers = __match_any_sync(0xffffffffu, slot);
  g.leader = (g.peers & below) == 0;
  g.sched = 0;
  g.levels = 0;
  if (__all_sync(0xffffffffu, g.peers == (1u << lane))) return g;  // every slot distinct
  unsigned rest = g.peers & ~((2u << lane) - 1u);  // the higher peers
  unsigned rank = __popc(g.peers & below);
  while (__any_sync(0xffffffffu, rest != 0)) {
    g.sched |= (unsigned)__ffs(rest) << (6 * g.levels);
    ++g.levels;
    rest &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  return g;
}

// the group's combined word, at its leader
template <class F>
__device__ __forceinline__ typename F::W dense_reduce(const DenseGroup& g, typename F::W x) {
  for (int l = 0; l < g.levels; ++l) {
    const unsigned src = (g.sched >> (6 * l)) & 63u;
    const typename F::W t = __shfl_sync(0xffffffffu, x, (int)((src - 1u) & 31u));
    if (src) x = F::combine(x, t);
  }
  return x;
}

// one aggregate of one row step: the group's value folded into its slot's
// word; x is the row's value bits; slot -1: no row.  A count folds
// nothing: it is the slot's exists count, which the finish writes.
template <class F, bool SMEM>
__device__ __forceinline__ void dense_fold(const DenseGroup& g, int slot, typename F::W x,
                                           unsigned long long* acc) {
  if constexpr (!F::COUNT) {
    x = dense_reduce<F>(g, F::encode(x));
    if (g.leader && slot >= 0) F::template atomic<SMEM>((typename F::W*)(acc + slot), x);
  }
}

__device__ __forceinline__ void dense_count(const DenseGroup& g, int slot, unsigned* exists) {
  if (g.leader && slot >= 0) atomicAdd(exists + slot, (unsigned)__popc(g.peers));
}

__device__ __forceinline__ long long dense_row(long long base, int j) {
  return base + (long long)j * blockDim.x + threadIdx.x;
}

// key j's step of a row's slot: its value v checked against its range and
// added into the row-major fused key (wrapping where it lies outside)
__device__ __forceinline__ void dense_key(const DenseSpec& s, int j, int v, unsigned* fused,
                                          bool* in_range) {
  *in_range = *in_range && v >= s.lo[j] && v <= s.hi[j];
  *fused += ((unsigned)v - (unsigned)s.lo[j]) * (unsigned)s.stride[j];
}

// ---------------------------------------------------------------------------
// the end of a block: merge, ticket, and the last block's result
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dense_store(void* out, int kind, long long r,
                                            unsigned long long bits) {
  if (kind == AB_KIND_I32 || kind == AB_KIND_F32) ((unsigned*)out)[r] = (unsigned)bits;
  else ((unsigned long long*)out)[r] = bits;
}

__device__ __forceinline__ void dense_store_key(const DenseSpec& s, int j, long long r, int v) {
  switch (s.key_kind[j]) {
    case AB_KIND_I32: ((int*)s.out_key[j])[r] = v; break;
    case AB_KIND_I64: ((long long*)s.out_key[j])[r] = v; break;
    default: ((uint8_t*)s.out_key[j])[r] = v != 0;
  }
}

// aggregate a's value at slot, whose exists count is c (0: an empty slot,
// whose words were never touched)
__device__ __forceinline__ unsigned long long dense_value(const DenseSpec& s,
                                                          unsigned long long* acc, int a,
                                                          int slot, unsigned c) {
  if (s.how[a] == AB_AGG_COUNT) return c;
  const unsigned long long w = c ? __ldcg(acc + (long long)a * s.domain + slot) : 0ULL;
  return dense_decode(s.how[a], s.val_kind[a], w);
}

// the compacted form's row r from slot, whose exists count is c
__device__ __forceinline__ void dense_write_row(const DenseSpec& s, unsigned long long* acc,
                                                int slot, unsigned c, long long r) {
  ((uint8_t*)s.out_mask)[r] = c != 0u;
  for (int j = 0; j < s.k; ++j)
    dense_store_key(s, j, r, s.lo[j] + (slot / s.stride[j]) % (s.hi[j] - s.lo[j] + 1));
  for (int a = 0; a < s.m; ++a)
    dense_store(s.out_val[a], s.val_kind[a], r, dense_value(s, acc, a, slot, c));
}

// a live slot's words back to zero
__device__ __forceinline__ void dense_clear(const DenseSpec& s, unsigned long long* acc,
                                            unsigned* exists, int slot) {
  exists[slot] = 0;
  for (int a = 0; a < s.m; ++a)
    if (s.how[a] != AB_AGG_COUNT) acc[(long long)a * s.domain + slot] = 0ULL;
}

// The last block: every other block's atomics are in the state.
__device__ __noinline__ void dense_finish(const DenseSpec& s) {
  unsigned long long* state = s.state;
  const int D = s.domain;
  unsigned* exists = dense_exists(state);
  unsigned long long* acc = dense_accs(state, D);
  const bool bad = __ldcg(state + 1) != 0ULL;
  if (s.form == AB_DENSE_SLOTS) {
    for (int slot = threadIdx.x; slot < D; slot += blockDim.x) {
      const unsigned c = __ldcg(exists + slot);
      ((int*)s.out_exists)[slot] = (int)c;
      for (int a = 0; a < s.m; ++a)
        dense_store(s.out_val[a], s.val_kind[a], slot, dense_value(s, acc, a, slot, c));
      if (c) dense_clear(s, acc, exists, slot);
    }
    if (threadIdx.x == 0) *(uint8_t*)s.out_flag = bad;
  } else {
    // groups in ascending slot order, then the empty slots in ascending
    // order (K2's live-first order over exists), cut or padded to out_capacity
    __shared__ unsigned ws[32];
    unsigned mine = 0;
    for (int slot = threadIdx.x; slot < D; slot += blockDim.x) mine += __ldcg(exists + slot) != 0u;
    unsigned groups;
    ab_block_exclusive_scan<unsigned>(mine, ws, &groups);
    const unsigned rows = (unsigned)(D < s.out_capacity ? D : s.out_capacity);
    unsigned before = 0;  // live slots before this step
    constexpr int S = AB_DENSE_FINISH_SLOTS;
    for (int base = 0; base < D; base += (int)blockDim.x * S) {
      const int s0 = base + threadIdx.x * S;
      unsigned c[S], live = 0;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        c[q] = s0 + q < D ? __ldcg(exists + s0 + q) : 0u;
        live |= (c[q] != 0u ? 1u : 0u) << q;
      }
      unsigned total;
      unsigned r = before + ab_block_exclusive_scan<unsigned>(__popc(live), ws, &total);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int slot = s0 + q;
        if (slot >= D) break;
        const bool lv = (live >> q) & 1u;
        const unsigned pos = lv ? r : groups + ((unsigned)slot - r);
        r += lv;
        if (pos < rows) dense_write_row(s, acc, slot, c[q], pos);
        if (lv) dense_clear(s, acc, exists, slot);
      }
      before += total;
    }
    for (int r = D + threadIdx.x; r < s.out_capacity; r += blockDim.x) {  // padding
      ((uint8_t*)s.out_mask)[r] = 0;
      for (int j = 0; j < s.k; ++j) dense_store_key(s, j, r, 0);
      for (int a = 0; a < s.m; ++a) dense_store(s.out_val[a], s.val_kind[a], r, 0ULL);
    }
    if (threadIdx.x == 0 && D > s.out_capacity)
      *(uint8_t*)s.out_flag = groups > (unsigned)s.out_capacity || bad;
  }
  __syncthreads();  // every read of the bad-rows word before its reset
  if (threadIdx.x == 0) {
    state[1] = 0ULL;
    state[0] = 0ULL;  // the ticket
  }
}

template <bool SMEM>
__device__ __forceinline__ void dense_block_end(const DenseSpec& s, const DenseAcc& local,
                                                bool saw_bad) {
  unsigned long long* state = s.state;
  const int D = s.domain;
  if (SMEM) {  // the block's live slots into the state
    __syncthreads();
    unsigned* exists = dense_exists(state);
    unsigned long long* acc = dense_accs(state, D);
    for (int slot = threadIdx.x; slot < D; slot += blockDim.x) {
      const unsigned c = local.exists[slot];
      if (c == 0u) continue;
      atomicAdd(exists + slot, c);
      for (int a = 0; a < s.m; ++a)
        if (s.how[a] != AB_AGG_COUNT)
          dense_merge(s.how[a], s.val_kind[a], acc + (long long)a * D + slot,
                      local.acc[a * D + slot]);
    }
  }
  __threadfence();  // this thread's atomics before the block's ticket
  const bool bad = __syncthreads_or(saw_bad);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (bad) atomicOr(state + 1, 1ULL);
    last = ab_last_block(state);
  }
  __syncthreads();
  if (last) dense_finish(s);
}

// ---------------------------------------------------------------------------
// the kernel and its launch
// ---------------------------------------------------------------------------

template <class Src, bool SMEM>
__global__ void __launch_bounds__(Src::THREADS)
    k1_dense(const __grid_constant__ Src src, const __grid_constant__ DenseSpec s) {
  extern __shared__ unsigned long long smem[];
  DenseAcc acc;
  if (SMEM) {
    acc.acc = smem;
    acc.exists = (unsigned*)(smem + (long long)s.m * s.domain);
    const int words = s.m * s.domain + (s.domain + 1) / 2;
    for (int t = threadIdx.x; t < words; t += blockDim.x) smem[t] = 0ULL;
    __syncthreads();
  } else {
    acc.acc = dense_accs(s.state, s.domain);
    acc.exists = dense_exists(s.state);
  }
  bool saw_bad = false;
  const long long tile = (long long)Src::THREADS * Src::ROWS;
  const long long step = (long long)gridDim.x * tile;
  for (long long base = (long long)blockIdx.x * tile; base < s.n; base += step)
    src.template fold_tile<SMEM>(s, base, acc, &saw_bad);
  dense_block_end<SMEM>(s, acc, saw_bad);
}

// validates the spec (counts become int64 folds); 0 or a cudaError_t
static inline int ab_dense_check(DenseSpec* s) {
  if (s->k < 1 || s->k > AB_MAX_KEYS || s->m < 0 || s->m > AB_MAX_AGGS || s->domain < 1 ||
      s->n < 0 || s->state == nullptr || s->out_flag == nullptr ||
      (s->form != AB_DENSE_SLOTS && s->form != AB_DENSE_COMPACT))
    return (int)cudaErrorInvalidValue;
  if (s->form == AB_DENSE_SLOTS ? s->out_exists == nullptr
                                : (s->out_capacity < 0 || s->out_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < s->k; ++j) {
    const int kind = s->key_kind[j];
    if ((kind != AB_KIND_I32 && kind != AB_KIND_I64 && kind != AB_KIND_BOOL) ||
        s->hi[j] < s->lo[j] || s->stride[j] < 1)
      return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < s->m; ++a) {
    if (s->how[a] < AB_AGG_SUM || s->how[a] > AB_AGG_MAX) return (int)cudaErrorInvalidValue;
    if (s->how[a] == AB_AGG_COUNT) {
      s->val_kind[a] = AB_KIND_I64;
      continue;
    }
    const int kind = s->val_kind[a];
    if (kind != AB_KIND_I64 && kind != AB_KIND_F64 && kind != AB_KIND_I32 && kind != AB_KIND_F32)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// One launch: block-private shared accumulators where they fit (1,024
// threads an SM, fewer blocks as the shared memory a block takes grows),
// else the state's; a grid no larger than the rows need, and one block
// when there are none (it writes the identities).
template <class Src>
static int ab_dense_launch(const Src& src, DenseSpec s, cudaStream_t st) {
  static AbSmemLimit limit;
  int err = ab_dense_check(&s);
  if (err) return err;
  const long long tile = (long long)Src::THREADS * Src::ROWS;
  long long grid = (s.n + tile - 1) / tile;
  if (grid < 1) grid = 1;
  const size_t smem = ((size_t)s.m * s.domain + (s.domain + 1) / 2) * 8;
  const long long per_sm = 1024 / Src::THREADS;  // 1,024 threads an SM
  if (smem <= AB_SHARED_LIMIT) {
    long long fit = (long long)(232448 / (smem + 1024));
    fit = fit < 1 ? 1 : (fit > per_sm ? per_sm : fit);
    if (grid > 132 * fit) grid = 132 * fit;
    if (smem > 48 * 1024) {
      err = ab_smem_limit(k1_dense<Src, true>, (int)smem, limit);
      if (err) return err;
    }
    k1_dense<Src, true><<<(unsigned)grid, Src::THREADS, smem, st>>>(src, s);
  } else {
    if (grid > 132 * per_sm) grid = 132 * per_sm;
    k1_dense<Src, false><<<(unsigned)grid, Src::THREADS, 0, st>>>(src, s);
  }
  return ab_last_error();
}
