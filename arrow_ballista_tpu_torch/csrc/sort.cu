// K4: sort_order — stable multi-key sort permutation, dead rows last.
//
// Replaces arrow_ballista_tpu/ops/kernels.py sort_order (l.195), the
// ORDER BY permutation of SortExec ("sort.order", operators.py:1794) and
// the sort-path aggregate's order.  The reference lexsorts with ~mask as
// the primary key and each key transformed for its direction: desc ints
// negated in int64 (wrapping, so INT64_MIN stays put), desc bools
// inverted, desc floats negated; floats compare as XLA's sort does (-0.0
// equals +0.0, every NaN sorts greatest).
//
// Design: each row's sort words (the dead flag first, then each key mapped
// so that signed int64 order is the reference's order: sort_value) are
// compressed into one composite unsigned key and sorted by the stable LSD
// radix core of radix.cuh.  A reduction (sort_minmax) finds each word's
// min and max over all rows, dead rows included (lexsort orders the dead
// rows by their keys too); the wrapper reads them back (one small D2H, one
// sync a call) and lays the words out (ops/kernels.py sort_layout): a word
// keeps the bit length of max - min taken as uint64 (a constant word drops
// out) and is packed MSB-first, dead flag first, as (word - min) unsigned,
// into W = ceil(bits / 64) limbs; a field may straddle two limbs.  Then the
// upfront pass (sort_pack) writes the limbs and every digit position's
// histogram, rx_bases the digit bases, and ceil(bits / 8) onesweep
// passes, the last writing only the permutation.  q18's orderkey with the
// dead flag takes 24 bits: 3 passes of 8 bits.  Launches: 3 + passes (2
// when every word is constant: the identity).  Rows that fit one block
// (rx_block_bytes) take the single-block form: the reduction, the layout
// (sort_layout's arithmetic on the device, written out so that the card
// tests hold it against sort_layout), the packing and radix.cuh's bitonic
// network in one launch.
// Bound: bytes.  The one-pass minimum reads the keys and the mask once and
// writes the permutation once.  This design reads them twice (the
// reduction, the packing), writes the limbs once, and each pass reads and
// writes a row's limbs still needed and its index (the first pass reads no
// index, the last writes no limbs): at one limb about 2 + passes times the
// minimum.  Scratch: 2 * W * 8 + 4 bytes a row plus the histograms and the
// look-back words (the merge sort it replaces took 2 * (k + 1) * 8).
#define RX_NS k4_radix
#include "radix.cuh"

using namespace k4_radix;

#define AB_MAX_SORT_KEYS 8
#define SORT_FIELDS (AB_MAX_SORT_KEYS + 1)  // the dead flag and the keys
#define SORT_MINMAX_THREADS 256
#define SORT_MINMAX_ROWS 4  // rows a thread loads before it reduces them
#define SORT_PACK_ROWS 2    // rows an upfront thread loads before it packs them

struct SortKeys {
  const void* ptr[AB_MAX_SORT_KEYS];
  int kind[AB_MAX_SORT_KEYS];
  int desc[AB_MAX_SORT_KEYS];
  int k;
};

// XLA's float sort order: -0.0 equals +0.0 and every NaN sorts greatest;
// desc negates first.  Mapped to a signed int64 with the same order.
__device__ __forceinline__ int64_t float_word(double v, int desc) {
  if (desc) v = -v;
  if (isnan(v)) return 0x7ff8000000000000LL;
  if (v == 0.0) return 0;
  int64_t t = __double_as_longlong(v);
  return t ^ (int64_t)((uint64_t)(t >> 63) & 0x7fffffffffffffffULL);
}

// Field j of row i in two steps, so that a thread can issue the loads of
// several rows before it uses them: sort_raw loads the bits (field 0 the
// live flag, field j >= 1 key j - 1), sort_value maps them to an int64
// whose signed order is the reference's order (field 0: the dead flag).
__device__ __forceinline__ uint64_t sort_raw(const SortKeys& s, const uint8_t* mask, int j,
                                             long long i) {
  if (j == 0) return mask[i];
  const void* p = s.ptr[j - 1];
  switch (s.kind[j - 1]) {
    case AB_KIND_I32:
      return (uint32_t)((const int32_t*)p)[i];
    case AB_KIND_I64:
      return (uint64_t)((const int64_t*)p)[i];
    case AB_KIND_BOOL:
      return ((const uint8_t*)p)[i];
    case AB_KIND_F32:
      return __float_as_uint(((const float*)p)[i]);
    default:  // AB_KIND_F64
      return (uint64_t)__double_as_longlong(((const double*)p)[i]);
  }
}

__device__ __forceinline__ int64_t sort_value(const SortKeys& s, int j, uint64_t raw) {
  if (j == 0) return raw ? 0 : 1;
  const int desc = s.desc[j - 1];
  switch (s.kind[j - 1]) {
    case AB_KIND_I32: {
      int64_t v = (int64_t)(int32_t)(uint32_t)raw;
      return desc ? -v : v;
    }
    case AB_KIND_I64:
      return (int64_t)(desc ? (0ULL - raw) : raw);  // wrapping negation
    case AB_KIND_BOOL: {
      int64_t v = raw != 0;
      return desc ? 1 - v : v;
    }
    case AB_KIND_F32:
      return float_word((double)__uint_as_float((unsigned)raw), desc);  // exact widening
    default:  // AB_KIND_F64
      return float_word(__longlong_as_double((long long)raw), desc);
  }
}

__device__ __forceinline__ int64_t sort_field(const SortKeys& s, const uint8_t* mask, int j,
                                              long long i) {
  return sort_value(s, j, sort_raw(s, mask, j, i));
}

// The composite key's layout: field j is (word - lo[j]) as uint64, bits[j]
// wide, at bit off[j] of the composite (fields MSB-first); W limbs.
struct SortPlan {
  long long lo[SORT_FIELDS];
  int bits[SORT_FIELDS];
  int off[SORT_FIELDS];
  int nf;  // k + 1
  int W;
  int total;
};

__device__ __forceinline__ void sort_fields(const SortKeys& s, const uint8_t* mask,
                                            const SortPlan& pl, long long i,
                                            uint64_t (&f)[SORT_FIELDS]) {
#pragma unroll
  for (int j = 0; j < SORT_FIELDS; ++j)
    f[j] = (j < pl.nf && pl.bits[j] > 0)
               ? (uint64_t)sort_field(s, mask, j, i) - (uint64_t)pl.lo[j]
               : 0ULL;
}

// limb m of the composite: the parts of the fields that overlap its bits
__device__ __forceinline__ uint64_t sort_limb(const uint64_t (&f)[SORT_FIELDS],
                                              const SortPlan& pl, int m) {
  uint64_t v = 0ULL;
  const int base = 64 * m;
#pragma unroll
  for (int j = 0; j < SORT_FIELDS; ++j) {
    if (j < pl.nf && pl.bits[j] > 0) {
      const int off = pl.off[j];
      if (off < base + 64 && off + pl.bits[j] > base)
        v |= off >= base ? f[j] << (off - base) : f[j] >> (base - off);
    }
  }
  return v;
}

// each field's min and max over all rows: partial[block][j] = {min, max}
__global__ void __launch_bounds__(SORT_MINMAX_THREADS)
    sort_minmax(SortKeys s, const uint8_t* __restrict__ mask, long long n,
                long long* __restrict__ partial) {
  __shared__ long long wlo[SORT_MINMAX_THREADS / 32][SORT_FIELDS];
  __shared__ long long whi[SORT_MINMAX_THREADS / 32][SORT_FIELDS];
  const int nf = s.k + 1;
  long long lo[SORT_FIELDS], hi[SORT_FIELDS];
#pragma unroll
  for (int j = 0; j < SORT_FIELDS; ++j) {
    lo[j] = 0x7fffffffffffffffLL;
    hi[j] = (long long)0x8000000000000000ULL;
  }
  // SORT_MINMAX_ROWS rows a thread at a time: their loads first
  const long long step = (long long)gridDim.x * blockDim.x * SORT_MINMAX_ROWS;
  for (long long i0 = (long long)blockIdx.x * blockDim.x * SORT_MINMAX_ROWS + threadIdx.x; i0 < n;
       i0 += step) {
#pragma unroll
    for (int j = 0; j < SORT_FIELDS; ++j) {
      if (j < nf) {
        uint64_t raw[SORT_MINMAX_ROWS];
#pragma unroll
        for (int u = 0; u < SORT_MINMAX_ROWS; ++u) {
          const long long i = i0 + (long long)u * blockDim.x;
          raw[u] = i < n ? sort_raw(s, mask, j, i) : 0ULL;
        }
#pragma unroll
        for (int u = 0; u < SORT_MINMAX_ROWS; ++u) {
          if (i0 + (long long)u * blockDim.x < n) {
            const long long w = sort_value(s, j, raw[u]);
            lo[j] = min(lo[j], w);
            hi[j] = max(hi[j], w);
          }
        }
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < SORT_FIELDS; ++j) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[j] = min(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], o));
      hi[j] = max(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], o));
    }
    if (lane == 0) {
      wlo[warp][j] = lo[j];
      whi[warp][j] = hi[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < nf) {
    const int j = threadIdx.x;
    long long a = wlo[0][j], b = whi[0][j];
    for (int w = 1; w < SORT_MINMAX_THREADS / 32; ++w) {
      a = min(a, wlo[w][j]);
      b = max(b, whi[w][j]);
    }
    partial[((long long)blockIdx.x * nf + j) * 2] = a;
    partial[((long long)blockIdx.x * nf + j) * 2 + 1] = b;
  }
}

// the upfront pass: the composite limbs of every row and every digit
// position's histogram
__global__ void __launch_bounds__(RX_UP_THREADS)
    sort_pack(SortKeys s, SortPlan pl, const uint8_t* __restrict__ mask, long long n, int P,
              uint64_t* __restrict__ keys, unsigned* __restrict__ hist_blk, unsigned* status0,
              long long status_words, unsigned* counters) {
  extern __shared__ uint64_t rx_smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(rx_smem);
  const int hist_len = P * RX_BINS;
  rx_up_begin(hist, hist_len, status0, status_words, counters, P);
  // SORT_PACK_ROWS rows a thread at a time: each field's loads first
  const long long step = (long long)gridDim.x * blockDim.x * SORT_PACK_ROWS;
  for (long long i0 = (long long)blockIdx.x * blockDim.x * SORT_PACK_ROWS + threadIdx.x; i0 < n;
       i0 += step) {
    uint64_t f[SORT_PACK_ROWS][SORT_FIELDS];
#pragma unroll
    for (int j = 0; j < SORT_FIELDS; ++j) {
      uint64_t raw[SORT_PACK_ROWS];
#pragma unroll
      for (int u = 0; u < SORT_PACK_ROWS; ++u) {
        const long long i = i0 + (long long)u * blockDim.x;
        raw[u] = (j < pl.nf && pl.bits[j] > 0 && i < n) ? sort_raw(s, mask, j, i) : 0ULL;
      }
#pragma unroll
      for (int u = 0; u < SORT_PACK_ROWS; ++u)
        f[u][j] = (j < pl.nf && pl.bits[j] > 0)
                      ? (uint64_t)sort_value(s, j, raw[u]) - (uint64_t)pl.lo[j]
                      : 0ULL;
    }
#pragma unroll
    for (int u = 0; u < SORT_PACK_ROWS; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      if (i < n) {
        uint64_t prev = 0ULL;
        int p = 0;
        for (int m = 0; m < pl.W; ++m) {
          const uint64_t cur = sort_limb(f[u], pl, m);
          keys[(long long)m * n + i] = cur;
          rx_count_limb(hist, P, prev, cur, m, pl.W, p);
          prev = cur;
        }
      }
    }
  }
  rx_up_end(hist, hist_len, hist_blk);
}

__global__ void sort_identity(long long n, int32_t* __restrict__ perm) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    perm[i] = (int32_t)i;
}

// the single-block form: reduction, layout, packing and the bitonic
// network in one launch; layout_out gets the layout (ab_sort_order_block)
__global__ void __launch_bounds__(RX_SB_THREADS)
    sort_block(SortKeys s, const uint8_t* __restrict__ mask, int n, int wmax,
               int32_t* __restrict__ perm, long long* __restrict__ layout_out) {
  extern __shared__ uint64_t rx_smem[];
  __shared__ long long wlo[RX_SB_THREADS / 32][SORT_FIELDS];
  __shared__ long long whi[RX_SB_THREADS / 32][SORT_FIELDS];
  __shared__ SortPlan pl;
  const int nf = s.k + 1;
  long long lo[SORT_FIELDS], hi[SORT_FIELDS];
#pragma unroll
  for (int j = 0; j < SORT_FIELDS; ++j) {
    lo[j] = 0x7fffffffffffffffLL;
    hi[j] = (long long)0x8000000000000000ULL;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < SORT_FIELDS; ++j) {
      if (j < nf) {
        const long long w = sort_field(s, mask, j, i);
        lo[j] = min(lo[j], w);
        hi[j] = max(hi[j], w);
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < SORT_FIELDS; ++j) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[j] = min(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], o));
      hi[j] = max(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], o));
    }
    if (lane == 0) {
      wlo[warp][j] = lo[j];
      whi[warp][j] = hi[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < SORT_FIELDS) {  // field j's min over the warps, and its width
    const int j = threadIdx.x;
    pl.bits[j] = 0;
    pl.lo[j] = 0;
    if (j < nf) {
      long long a = wlo[0][j], b = whi[0][j];
      for (int w = 1; w < RX_SB_THREADS / 32; ++w) {
        a = min(a, wlo[w][j]);
        b = max(b, whi[w][j]);
      }
      const unsigned long long span = (unsigned long long)b - (unsigned long long)a;
      pl.lo[j] = a;
      pl.bits[j] = span ? 64 - __clzll((long long)span) : 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the layout, as ops/kernels.py sort_layout computes it
    int total = 0;
    for (int j = 0; j < SORT_FIELDS; ++j) total += pl.bits[j];
    int off = total;
    for (int j = 0; j < SORT_FIELDS; ++j) {
      off -= pl.bits[j];
      pl.off[j] = off;
    }
    pl.nf = nf;
    pl.total = total;
    pl.W = (total + 63) / 64;
    for (int j = 0; j < nf; ++j) {
      layout_out[j] = pl.lo[j];
      layout_out[nf + j] = pl.bits[j];
      layout_out[2 * nf + j] = pl.off[j];
    }
    layout_out[3 * nf] = total;
  }
  __syncthreads();
  RxBlockParts q = rx_block_parts(rx_smem, n, wmax);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint64_t f[SORT_FIELDS];
    sort_fields(s, mask, pl, i, f);
    for (int m = 0; m < pl.W; ++m) q.keys[(long long)m * n + i] = sort_limb(f, pl, m);
  }
  __syncthreads();
  rx_block_sort(q.keys, n, pl.W, q.idx);
  for (int i = threadIdx.x; i < n; i += blockDim.x) perm[i] = q.idx[i];
}

static int fill_sort_keys(SortKeys* s, const void* const* ptrs, const int* kinds, const int* desc,
                          int k) {
  if (k < 0 || k > AB_MAX_SORT_KEYS) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < k; ++j) {
    if (kinds[j] < AB_KIND_I32 || kinds[j] > AB_KIND_F64) return (int)cudaErrorInvalidValue;
    s->ptr[j] = ptrs[j];
    s->kind[j] = kinds[j];
    s->desc[j] = desc[j];
  }
  s->k = k;
  return 0;
}

// blocks of sort_minmax (each thread takes SORT_MINMAX_ROWS rows a step)
AB_EXPORT int ab_sort_minmax_blocks(long long n) {
  return ab_grid((n + SORT_MINMAX_ROWS - 1) / SORT_MINMAX_ROWS, SORT_MINMAX_THREADS, 132 * 4);
}

// partial: int64[ab_sort_minmax_blocks(n)][k + 1][2]
AB_EXPORT int ab_sort_minmax(const void* const* ptrs, const int* kinds, const int* desc, int k,
                             const void* mask, long long n, void* partial, void* stream) {
  if (n < 1 || n >= RX_MAX_ROWS) return (int)cudaErrorInvalidValue;
  SortKeys s;
  int err = fill_sort_keys(&s, ptrs, kinds, desc, k);
  if (err) return err;
  sort_minmax<<<ab_sort_minmax_blocks(n), SORT_MINMAX_THREADS, 0, (cudaStream_t)stream>>>(
      s, (const uint8_t*)mask, n, (long long*)partial);
  return ab_last_error();
}

// scratch of the onesweep form: the limbs twice, the rows once, control
AB_EXPORT long long ab_sort_scratch_bytes(long long n, int total_bits) {
  const int W = (total_bits + 63) / 64;
  return ab_align16(2 * (long long)W * n * 8) + ab_align16(n * 4) +
         rx_control_bytes(n, rx_passes(total_bits));
}

static int sort_onesweep(const SortKeys& s, const SortPlan& pl, const uint8_t* mask, long long n,
                         char* scratch, int32_t* perm, cudaStream_t st) {
  const int P = rx_passes(pl.total);
  const size_t hist_bytes = (size_t)P * RX_BINS * 4;
  if (hist_bytes > RX_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  uint64_t* keys0 = (uint64_t*)scratch;
  uint64_t* keys1 = keys0 + (long long)pl.W * n;
  char* p = scratch + ab_align16(2 * (long long)pl.W * n * 8);
  int32_t* rows_tmp = (int32_t*)p;
  p += ab_align16(n * 4);
  const RxScratch sc = rx_carve(p, n, P);
  const int G = rx_up_blocks(n);
  int err = rx_allow_smem(sort_pack, hist_bytes);
  if (err) return err;
  sort_pack<<<G, RX_UP_THREADS, hist_bytes, st>>>(s, pl, mask, n, P, keys0, sc.hist_blk,
                                                  sc.status, sc.status_words, sc.counters);
  err = ab_last_error();
  if (err) return err;
  uint64_t* keys[2] = {keys0, keys1};
  int32_t* rows[2];
  rows[P & 1] = perm;  // the last pass writes rows[P & 1]
  rows[(P + 1) & 1] = rows_tmp;
  return rx_onesweep_passes(keys, rows, n, pl.W, P, 0, sc, G, nullptr, st);
}

// The onesweep form.  lo, bits, off: the layout of ops/kernels.py
// sort_layout for the k + 1 fields (the dead flag first); total_bits their
// sum; scratch: ab_sort_scratch_bytes bytes; perm_out: int32[n].
AB_EXPORT int ab_sort_order(const void* const* ptrs, const int* kinds, const int* desc, int k,
                            const void* mask, long long n, const long long* lo, const int* bits,
                            const int* off, int total_bits, void* scratch, void* perm_out,
                            void* stream) {
  if (n < 1 || n >= RX_MAX_ROWS) return (int)cudaErrorInvalidValue;
  SortKeys s;
  int err = fill_sort_keys(&s, ptrs, kinds, desc, k);
  if (err) return err;
  SortPlan pl;
  int sum = 0;
  for (int j = 0; j < SORT_FIELDS; ++j) {
    const bool field = j <= k;
    pl.lo[j] = field ? lo[j] : 0;
    pl.bits[j] = field ? bits[j] : 0;
    pl.off[j] = field ? off[j] : 0;
    if (pl.bits[j] < 0 || pl.bits[j] > 64 || pl.off[j] < 0) return (int)cudaErrorInvalidValue;
    sum += pl.bits[j];
  }
  if (sum != total_bits) return (int)cudaErrorInvalidValue;
  pl.nf = k + 1;
  pl.total = total_bits;
  pl.W = (total_bits + 63) / 64;
  cudaStream_t st = (cudaStream_t)stream;
  if (total_bits == 0) {  // every word constant: the identity
    sort_identity<<<ab_grid(n, 256, 132 * 8), 256, 0, st>>>(n, (int32_t*)perm_out);
    return ab_last_error();
  }
  return sort_onesweep(s, pl, (const uint8_t*)mask, n, (char*)scratch, (int32_t*)perm_out, st);
}

// dynamic shared bytes of the single-block form for n rows whose
// composite takes at most wmax limbs, or -1 where they do not fit
AB_EXPORT long long ab_sort_block_bytes(long long n, int wmax) { return rx_block_bytes(n, wmax); }

// The single-block form.  layout_out: int64[3 (k + 1) + 1] gets the
// layout it computed on the device: lo, bits and off of the k + 1 fields,
// then the composite's bits (what ops/kernels.py sort_layout gives for the
// same words).
AB_EXPORT int ab_sort_order_block(const void* const* ptrs, const int* kinds, const int* desc,
                                  int k, const void* mask, long long n, int wmax, void* perm_out,
                                  void* layout_out, void* stream) {
  const long long smem = rx_block_bytes(n, wmax);
  if (smem < 0 || wmax < 1 || wmax > SORT_FIELDS) return (int)cudaErrorInvalidValue;
  SortKeys s;
  int err = fill_sort_keys(&s, ptrs, kinds, desc, k);
  if (err) return err;
  err = rx_allow_smem(sort_block, (size_t)smem);
  if (err) return err;
  sort_block<<<1, RX_SB_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      s, (const uint8_t*)mask, (int)n, wmax, (int32_t*)perm_out, (long long*)layout_out);
  return ab_last_error();
}
