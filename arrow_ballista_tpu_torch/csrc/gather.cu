// K20 concat_columns, K21 gather_columns and K22 mask_ops: the data
// movement and mask glue of the batches, the packed copy and the join.
//
// K20 replaces arrow_ballista_tpu/models/batch.py:435 "batch.concat"
// (_concat_impl: a padded concatenation of N batches' columns and masks).
// One launch writes every column of a group of sources: a grid of (blocks
// per source, columns, sources + the pad).  A block knows its source and
// column from its index, so no thread searches for its source; it copies
// its slice of that source's bytes in 16-byte words where both ends are
// 16-byte aligned (else in 8-, 4- or 1-byte words), and the pad's blocks
// write zeros.  The pointer table is the kernel's parameter struct, so no
// table is uploaded per call, and it is sized to the call: the first of
// three forms that holds it, up to 16 sources x 16 columns (2,392 bytes),
// 64 x 8 (4,728 bytes) or 64 x 48 (25,688 bytes; CUDA 12.1 allows up to
// 32,764); more sources or columns than the last holds go through further
// launches over disjoint destination rows or columns.  Bound: bytes (every source element read once, every
// destination element written once).
//
// K21 replaces the gathers of models/batch.py:439 "batch.shrink", of
// ops/kernels.py:122 pack_for_host and of the sort permutation and the
// join's pair expansion: one int32 index, C columns, one launch.  A thread
// reads its row's index once and copies that row of every column; 1-byte
// columns may widen to int32 (pack_for_host's 32-bit section) and int32
// ones to int64 (an int32 column packed where its schema says int64, as
// the reference's concatenate promotes it), and the
// destinations may be slices of one preallocated buffer (the packed copy's
// int64 buffer and float64 stack), so nothing is concatenated or stacked
// afterwards.  Optionally block 0 also copies K2's live count into the
// packed buffer's first word and zeroes its pad word.  Bound: bytes (the
// index read once, each gathered element read and written once).
//
// K22 replaces arrow_ballista_tpu/ops/operators.py:1029 "join.window_mask",
// :1037 "join.mask_or" and :1040 "join.mask_and": out = a AND lo <= i < hi,
// a OR b, a AND b over bool bytes; with the same pass, a AND NOT b (a semi
// or anti join's verdict over the probe mask).  The op is a template
// parameter; where every pointer is 16-byte aligned a thread takes 16 rows
// in vector loads and one 16-byte store, in blocks small enough that the
// call spreads over every SM.  Bound: bytes; at the local engine's batch
// a call is a few microseconds, about the launch of an empty kernel.
//
// K22's bucket form replaces arrow_ballista_tpu/ops/shuffle.py:493-497
// "repartition.bucket": the masks mask AND bucket == q of every output
// partition q of a batch, in one launch (a launch a partition would read
// the mask and the buckets again each time).  A thread
// reads a 16-byte word of the mask and the 64 bytes of its rows' int32
// buckets once, packs each row's bucket into a byte (0xFF for a dead row or
// a bucket outside [0, num_out)), and writes one 16-byte word to each
// partition's row of the [num_out, stride] output: four __vcmpeq4 a word.
// The partitions of a thread are all of them, or a slice of them per
// blockIdx.y (q_per_y).  Unaligned inputs and the rows past the last whole
// word go row by row; more than 255 partitions compare ints.  Bound: bytes,
// 5 read and num_out written a row.
#include "common.cuh"

#define AB_GATHER_MAX_COLS 64

// ops/kernels.py _cat_spec(MAX_SRC, MAX_COLS), one struct per form
template <int MAX_SRC, int MAX_COLS>
struct CatSpecT {
  long long off[MAX_SRC + 1];  // destination row of each source's first row;
                               // off[n_src] ends the sources
  long long end;               // rows [off[n_src], end) are the pad: zero
  int n_src;
  int n_cols;
  int width[MAX_COLS];         // element bytes: 1, 4 or 8
  void* dst[MAX_COLS];
  const void* src[MAX_SRC * MAX_COLS];  // [s * n_cols + c]
};
typedef CatSpecT<16, 16> CatSpec0;
typedef CatSpecT<64, 8> CatSpec1;
typedef CatSpecT<64, 48> CatSpec2;

// ops/kernels.py _GatherSpec
struct GatherSpec {
  int n_cols;
  int width[AB_GATHER_MAX_COLS];  // source element bytes: 1, 4 or 8
  int widen[AB_GATHER_MAX_COLS];  // 1: a 1-byte source written as int32;
                                  // 2: an int32 source sign-extended to int64
  const void* src[AB_GATHER_MAX_COLS];
  void* dst[AB_GATHER_MAX_COLS];
  const int* count_src;  // optional: *count_dst = *count_src (int32 -> int64)
  long long* count_dst;
  int* zero_dst;         // optional: one int32 word set to 0
};

__device__ __forceinline__ void ab_copy_elem(void* dst, long long di, const void* src,
                                             long long si, int width) {
  switch (width) {
    case 8:
      ((uint64_t*)dst)[di] = ((const uint64_t*)src)[si];
      break;
    case 4:
      ((uint32_t*)dst)[di] = ((const uint32_t*)src)[si];
      break;
    default:
      ((uint8_t*)dst)[di] = ((const uint8_t*)src)[si];
  }
}

__device__ __forceinline__ void ab_zero_elem(void* dst, long long di, int width) {
  switch (width) {
    case 8:
      ((uint64_t*)dst)[di] = 0;
      break;
    case 4:
      ((uint32_t*)dst)[di] = 0;
      break;
    default:
      ((uint8_t*)dst)[di] = 0;
  }
}

// bytes [0, nb) of src (or zeros where src is null) to dst, in words of T
// over the block's share of a grid-stride loop on gridDim.x
template <typename T>
__device__ __forceinline__ void ab_copy_words(char* dst, const char* src, long long nb) {
  const long long nw = nb / (long long)sizeof(T);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T* d = (T*)dst;
  const T* s = (const T*)src;
  for (long long i = t; i < nw; i += step) {
    if (s != nullptr) d[i] = s[i];
    else d[i] = T{};
  }
  for (long long i = nw * (long long)sizeof(T) + t; i < nb; i += step)
    dst[i] = src != nullptr ? src[i] : 0;
}

template <class Spec>
__global__ void __launch_bounds__(256) concat_kernel(const Spec spec) {
  const int c = blockIdx.y;
  const int s = blockIdx.z;  // a source, or n_src: the pad
  const int w = spec.width[c];
  const long long r0 = spec.off[s];
  const long long r1 = s < spec.n_src ? spec.off[s + 1] : spec.end;
  if (r1 <= r0) return;
  char* dst = (char*)spec.dst[c] + r0 * w;
  const char* src = s < spec.n_src ? (const char*)spec.src[s * spec.n_cols + c] : nullptr;
  const long long nb = (r1 - r0) * w;
  const unsigned long long a = (unsigned long long)dst | (unsigned long long)src;
  if ((a & 15) == 0) ab_copy_words<uint4>(dst, src, nb);
  else if ((a & 7) == 0) ab_copy_words<uint64_t>(dst, src, nb);
  else if ((a & 3) == 0) ab_copy_words<uint32_t>(dst, src, nb);
  else ab_copy_words<uint8_t>(dst, src, nb);
}

__global__ void __launch_bounds__(256) gather_kernel(const int32_t* __restrict__ idx,
                                                     long long m, const GatherSpec spec) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (spec.count_dst != nullptr) *spec.count_dst = (long long)*spec.count_src;
    if (spec.zero_dst != nullptr) *spec.zero_dst = 0;
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m; j += step) {
    const long long r = idx[j];
    for (int c = 0; c < spec.n_cols; ++c) {
      if (spec.widen[c] == 1) ((int32_t*)spec.dst[c])[j] = ((const uint8_t*)spec.src[c])[r];
      else if (spec.widen[c] == 2)
        ((int64_t*)spec.dst[c])[j] = (int64_t)((const int32_t*)spec.src[c])[r];
      else ab_copy_elem(spec.dst[c], j, spec.src[c], r, spec.width[c]);
    }
  }
}

#define AB_MASK_WINDOW 0
#define AB_MASK_OR 1
#define AB_MASK_AND 2
#define AB_MASK_ANDNOT 3

template <int OP>
__device__ __forceinline__ bool ab_mask_one(bool x, long long i, uint8_t bb, long long lo,
                                            long long hi) {
  if (OP == AB_MASK_WINDOW) return x && i >= lo && i < hi;
  if (OP == AB_MASK_OR) return x || bb != 0;
  if (OP == AB_MASK_AND) return x && bb != 0;
  return x && bb == 0;
}

// four bool bytes of a word as 0 / 1 bytes
__device__ __forceinline__ unsigned ab_bools4(unsigned x) { return __vcmpne4(x, 0u) & 0x01010101u; }

// a 16-byte word as four 32-bit lanes: or, and and and-not lane by lane on
// the bytes' truth (four rows a lane), the window byte by byte
template <int OP>
__device__ __forceinline__ void ab_mask_word_op(const unsigned (&a)[4], const unsigned (&b)[4],
                                                long long r0, long long lo, long long hi,
                                                unsigned (&o)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (OP == AB_MASK_OR) {
      o[k] = ab_bools4(a[k] | b[k]);
    } else if (OP == AB_MASK_AND) {
      o[k] = ab_bools4(a[k]) & ab_bools4(b[k]);
    } else if (OP == AB_MASK_ANDNOT) {
      o[k] = ab_bools4(a[k]) & ~ab_bools4(b[k]) & 0x01010101u;
    } else {
      unsigned x = ab_bools4(a[k]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long i = r0 + 4 * k + c;
        if (i < lo || i >= hi) x &= ~(0xffu << (8 * c));
      }
      o[k] = x;
    }
  }
}

// vec: every pointer is 16-byte aligned, so a thread takes a chunk of 16
// rows in one vector load of each input and one 16-byte store; the rows
// past the last whole chunk go one by one
template <int OP>
__global__ void __launch_bounds__(256) mask_kernel(const uint8_t* __restrict__ a,
                                                   const uint8_t* __restrict__ b, long long n,
                                                   long long lo, long long hi,
                                                   uint8_t* __restrict__ out, int vec) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n >> 4;
    for (long long v = t; v < nv; v += step) {
      union {
        uint4 q;
        unsigned u[4];
      } av, bv, rv;
      av.q = ((const uint4*)a)[v];
      if (OP != AB_MASK_WINDOW) bv.q = ((const uint4*)b)[v];
      ab_mask_word_op<OP>(av.u, bv.u, v * 16, lo, hi, rv.u);
      ((uint4*)out)[v] = rv.q;
    }
    done = nv << 4;
  }
  for (long long i = done + t; i < n; i += step)
    out[i] = ab_mask_one<OP>(a[i] != 0, i, OP == AB_MASK_WINDOW ? 0 : b[i], lo, hi);
}

// the bucket form: rows [0, n) of the mask and the buckets; out: num_out
// rows of `stride` bytes (stride a multiple of 16); this block's partitions
// are [blockIdx.y * q_per_y, + q_per_y)
__device__ __forceinline__ int ab_bucket_code(uint8_t live, int32_t b, int num_out) {
  return live && b >= 0 && b < num_out ? b : -1;
}

__global__ void __launch_bounds__(256) bucket_masks_kernel(const uint8_t* __restrict__ mask,
                                                           const int32_t* __restrict__ bucket,
                                                           long long n, int num_out,
                                                           long long stride, int q_per_y,
                                                           uint8_t* __restrict__ out, int vec) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q0 = blockIdx.y * q_per_y;
  const int q1 = min(q0 + q_per_y, num_out);
  long long done = 0;
  if (vec) {
    const long long nv = n >> 4;
    for (long long v = t; v < nv; v += step) {
      union {
        uint4 q;
        uint8_t c[16];
      } mv;
      union {
        uint4 q[4];
        int32_t w[16];
      } bk;
      mv.q = __ldg((const uint4*)mask + v);
#pragma unroll
      for (int k = 0; k < 4; ++k) bk.q[k] = __ldg((const uint4*)bucket + 4 * v + k);
      uint8_t* o = out + v * 16;
      if (num_out <= 255) {  // a row's partition as a byte, four rows a word
        unsigned c4[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          c4[k] = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            c4[k] |= (unsigned)(ab_bucket_code(mv.c[4 * k + b], bk.w[4 * k + b], num_out) & 0xff)
                     << (8 * b);
        }
        for (int q = q0; q < q1; ++q) {
          const unsigned qq = (unsigned)q * 0x01010101u;
          ((uint4*)(o + q * stride))[0] =
              make_uint4(__vcmpeq4(c4[0], qq) & 0x01010101u, __vcmpeq4(c4[1], qq) & 0x01010101u,
                         __vcmpeq4(c4[2], qq) & 0x01010101u, __vcmpeq4(c4[3], qq) & 0x01010101u);
        }
      } else {
        int code[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) code[j] = ab_bucket_code(mv.c[j], bk.w[j], num_out);
        for (int q = q0; q < q1; ++q) {
          union {
            uint4 q;
            uint8_t c[16];
          } rv;
#pragma unroll
          for (int j = 0; j < 16; ++j) rv.c[j] = code[j] == q;
          ((uint4*)(o + q * stride))[0] = rv.q;
        }
      }
    }
    done = nv << 4;
  }
  for (long long i = done + t; i < n; i += step) {
    const int code = ab_bucket_code(mask[i], bucket[i], num_out);
    for (int q = q0; q < q1; ++q) out[q * stride + i] = code == q;
  }
}

template <int OP>
static void ab_mask_launch(const uint8_t* a, const uint8_t* b, long long n, long long lo,
                           long long hi, uint8_t* out, cudaStream_t stream) {
  const int vec = (((unsigned long long)a | (unsigned long long)b | (unsigned long long)out) &
                   15) == 0;
  // smaller blocks where 256-thread ones would leave SMs idle: at least two
  // blocks an SM (131,072 rows are 8,192 16-byte words: 256 blocks of 32
  // threads, not 32 of 256)
  const long long items = vec ? (n + 15) / 16 : n;
  int threads = 256;
  while (threads > 32 && items / threads < 132 * 2) threads >>= 1;
  mask_kernel<OP><<<ab_grid(items, threads, 132 * 16), threads, 0, stream>>>(a, b, n, lo, hi,
                                                                             out, vec);
}

static bool ab_width_ok(int w) { return w == 1 || w == 4 || w == 8; }

template <class Spec, int MAX_SRC, int MAX_COLS>
static int ab_concat_launch(const Spec* s, cudaStream_t stream) {
  if (s->n_src < 1 || s->n_src > MAX_SRC || s->n_cols < 1 || s->n_cols > MAX_COLS ||
      s->end < s->off[s->n_src] || s->off[0] < 0)
    return (int)cudaErrorInvalidValue;
  long long most = s->end - s->off[s->n_src];  // the widest range, in rows
  for (int i = 0; i < s->n_src; ++i) {
    const long long r = s->off[i + 1] - s->off[i];
    if (r < 0) return (int)cudaErrorInvalidValue;
    if (r > most) most = r;
  }
  int wmax = 1;
  for (int c = 0; c < s->n_cols; ++c) {
    if (!ab_width_ok(s->width[c])) return (int)cudaErrorInvalidValue;
    if (s->width[c] > wmax) wmax = s->width[c];
  }
  if (s->end <= s->off[0]) return 0;
  const int threads = 256;
  // four 16-byte words a thread over the widest range
  dim3 grid(ab_grid(most * wmax, threads * 64, 1024), s->n_cols,
            s->n_src + (s->end > s->off[s->n_src] ? 1 : 0));
  concat_kernel<Spec><<<grid, threads, 0, stream>>>(*s);
  return ab_last_error();
}

// spec: a CatSpec<form> in host memory (form 0, 1 or 2); its sources
// cover destination rows [off[0], off[n_src]) and its pad [off[n_src], end)
AB_EXPORT int ab_concat_columns(const void* spec, int form, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case 0:
      return ab_concat_launch<CatSpec0, 16, 16>((const CatSpec0*)spec, st);
    case 1:
      return ab_concat_launch<CatSpec1, 64, 8>((const CatSpec1*)spec, st);
    case 2:
      return ab_concat_launch<CatSpec2, 64, 48>((const CatSpec2*)spec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

AB_EXPORT int ab_concat_spec_bytes(int form) {
  switch (form) {
    case 0:
      return (int)sizeof(CatSpec0);
    case 1:
      return (int)sizeof(CatSpec1);
    case 2:
      return (int)sizeof(CatSpec2);
    default:
      return -1;
  }
}

// idx: int32[m]; spec: a GatherSpec in host memory whose destinations hold
// m elements each (int32 where widened)
AB_EXPORT int ab_gather_columns(const void* idx, long long m, const void* spec, void* stream) {
  const GatherSpec* s = (const GatherSpec*)spec;
  if (m < 0 || s->n_cols < 0 || s->n_cols > AB_GATHER_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < s->n_cols; ++c)
    if (!ab_width_ok(s->width[c]) || s->widen[c] < 0 || s->widen[c] > 2 ||
        (s->widen[c] == 1 && s->width[c] != 1) || (s->widen[c] == 2 && s->width[c] != 4))
      return (int)cudaErrorInvalidValue;
  const int threads = 256;
  gather_kernel<<<ab_grid(m, threads, 132 * 16), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, m, *s);
  return ab_last_error();
}

// a, out: bool[n]; b: bool[n] (unused by the window); op: AB_MASK_*
AB_EXPORT int ab_mask_ops(int op, const void* a, const void* b, long long n, long long lo,
                          long long hi, void* out, void* stream) {
  const uint8_t* pa = (const uint8_t*)a;
  const uint8_t* pb = (const uint8_t*)b;
  uint8_t* po = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (op) {
    case AB_MASK_WINDOW:
      ab_mask_launch<AB_MASK_WINDOW>(pa, pb, n, lo, hi, po, st);
      break;
    case AB_MASK_OR:
      ab_mask_launch<AB_MASK_OR>(pa, pb, n, lo, hi, po, st);
      break;
    case AB_MASK_AND:
      ab_mask_launch<AB_MASK_AND>(pa, pb, n, lo, hi, po, st);
      break;
    case AB_MASK_ANDNOT:
      ab_mask_launch<AB_MASK_ANDNOT>(pa, pb, n, lo, hi, po, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return ab_last_error();
}

// mask: bool[n]; bucket: int32[n]; out: num_out rows of `stride` bytes, a
// multiple of 16 and at least n, of which each row's first n are written;
// a block takes all the partitions where the rows alone give a block an
// SM, else blockIdx.y slices them enough for that (131,072 rows give 32
// blocks of 256 threads a word each: 16 partitions then go four a block;
// on the H100 this slicing beat one partition a block and all of them a
// block, PERF.md row 10f)
AB_EXPORT int ab_bucket_masks(const void* mask, const void* bucket, long long n, int num_out,
                              long long stride, void* out, void* stream) {
  if (n < 1 || num_out < 1 || stride < n || (stride & 15)) return (int)cudaErrorInvalidValue;
  const int vec = (((unsigned long long)mask | (unsigned long long)bucket |
                    (unsigned long long)out) & 15) == 0;
  const int threads = 256;
  const int bx = ab_grid(vec ? (n + 15) / 16 : n, threads, 132 * 16);
  const int want = 132;
  const int slices = bx >= want ? 1 : min(num_out, (want + bx - 1) / bx);
  const int q_per_y = (num_out + slices - 1) / slices;
  dim3 grid(bx, (num_out + q_per_y - 1) / q_per_y);
  bucket_masks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int32_t*)bucket, n, num_out, stride, q_per_y, (uint8_t*)out,
      vec);
  return ab_last_error();
}
