// K7: segment_any — per-segment logical OR, with the join's mask folded in.
//
// Replaces arrow_ballista_tpu/ops/kernels.py segment_any (l.772):
// segment_max(values.astype(int32), seg, num_segments) > 0, the verdict
// reduction of the semi, anti, left and full joins, and the mask the
// reference's join program applies to it in the same XLA program
// (arrow_ballista_tpu/ops/operators.py:1319): out[s] = within[s] & (hit[s]
// ^ negate), within all ones when absent.  Segment ids outside [0,
// num_segments) are dropped, as XLA's scatter drops them.
//
// Bound: bytes.  The values read once (1 or 4 bytes a pair), the id of
// each true value, within read and the verdicts written once (1 byte a
// segment each).
//
// Design: two launches over a per-(device, stream) array of one byte a
// segment that is all zero between calls, so nothing clears before a call
// and no mask kernel runs after it.
// * k7_mark: a lane reads 8 pairs as one 8-byte word and their ids as two
//   16-byte words, and stores 1 at the byte of each true pair's segment,
//   once a run of equal ids (K6's probe index is non-decreasing, so a lane
//   stores about once a probe row).  Lanes race only to store the same
//   byte.
// * k7_verdict: 16 segments a lane, one 16-byte word each of the hit
//   bytes, within and the verdicts, within and negate applied; the hit
//   bytes it read are put back to zero.
// The launch boundary orders the two, and a call's two launches must
// follow each other on the stream with no other call's between them (the
// wrapper holds a lock while it queues them).  Blocks are small and a
// lane's work little: at the local engine's sizes the time is a few
// latencies, so the work is spread over every SM.  One launch with the
// verdict written behind a wait on every marking block took 0.0107-0.0118 ms
// where the parent's clear, mark and mask kernels took 0.0053-0.0110
// (131,072 to 2,097,152 pairs, tools/spill_segment_timing.py on an H100
// 80GB HBM3 at 700 W).
#include "common.cuh"

#define SA_THREADS 128
#define SA_PAIRS 8                                // pairs a thread of k7_mark
#define SA_TILE_PAIRS (SA_THREADS * SA_PAIRS)     // 1,024 pairs
#define SA_TILE_SEGS (SA_THREADS * 16)            // 2,048 segments a block of k7_verdict

struct SaArgs {
  const void* values;     // bool bytes or int32, n
  const int32_t* seg;     // n segment ids
  long long n, ns;        // pairs, segments
  const uint8_t* within;  // ns bool bytes, or null (all ones)
  unsigned negate;        // 0 or 1
  uint8_t* out;           // ns verdict bytes, 16-byte aligned, rounded up to 16
  uint8_t* hit;           // the per-stream hit bytes, as out; zero between calls
};

// 16 bytes p[i .. i + 15] (bytes at or past `limit` cleared): one 16-byte
// load where aligned and whole, else byte loads
__device__ __forceinline__ uint4 sa_bytes16(const uint8_t* __restrict__ p, long long i,
                                            long long limit) {
  if ((((uintptr_t)(p + i)) & 15) == 0 && i + 16 <= limit)
    return __ldg(reinterpret_cast<const uint4*>(p + i));
  unsigned q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (i + b < limit) q[b >> 2] |= (unsigned)__ldg(p + i + b) << (8 * (b & 3));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// bit b set when pair j0 + b (b < 8, j0 + b < n) holds a true value
// (max(value, 0) > 0: negative int32 values are false): one load where
// aligned and whole, else one a pair
template <typename T>
__device__ __forceinline__ unsigned sa_true_bits(const void* values, long long j0, long long n);

template <>
__device__ __forceinline__ unsigned sa_true_bits<uint8_t>(const void* values, long long j0,
                                                          long long n) {
  const uint8_t* v = (const uint8_t*)values + j0;
  unsigned bits = 0u;
  if ((reinterpret_cast<uintptr_t>(v) & 7) == 0 && j0 + 8 <= n) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(v));
#pragma unroll
    for (int b = 0; b < 8; ++b)
      bits |= ((((b < 4 ? w.x : w.y) >> (8 * (b & 3))) & 0xffu) != 0u ? 1u : 0u) << b;
    return bits;
  }
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (j0 + b < n && __ldg(v + b) != 0) bits |= 1u << b;
  return bits;
}

template <>
__device__ __forceinline__ unsigned sa_true_bits<int32_t>(const void* values, long long j0,
                                                          long long n) {
  const int32_t* v = (const int32_t*)values + j0;
  unsigned bits = 0u;
  if ((reinterpret_cast<uintptr_t>(v) & 15) == 0 && j0 + 8 <= n) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(v) + k);
      bits |= ((q.x > 0) | (q.y > 0) << 1 | (q.z > 0) << 2 | (q.w > 0) << 3) << (4 * k);
    }
    return bits;
  }
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (j0 + b < n && __ldg(v + b) > 0) bits |= 1u << b;
  return bits;
}

// the ids of pairs j0 .. j0 + 7 (-1 past n): 16-byte words where aligned
__device__ __forceinline__ void sa_ids8(const int32_t* __restrict__ seg, long long j0,
                                        long long n, int (&sid)[8]) {
  if (j0 + 8 <= n && (reinterpret_cast<uintptr_t>(seg + j0) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(seg + j0) + k);
      sid[4 * k] = q.x;
      sid[4 * k + 1] = q.y;
      sid[4 * k + 2] = q.z;
      sid[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) sid[k] = j0 + k < n ? __ldg(seg + j0 + k) : -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(SA_THREADS) k7_mark(SaArgs a) {
  const long long j0 = ((long long)blockIdx.x * SA_THREADS + threadIdx.x) * SA_PAIRS;
  if (j0 >= a.n) return;
  const unsigned tb = sa_true_bits<T>(a.values, j0, a.n);
  int sid[SA_PAIRS];
  sa_ids8(a.seg, j0, a.n, sid);
  int last = -1;
#pragma unroll
  for (int b = 0; b < SA_PAIRS; ++b) {
    const int s = sid[b];
    if (!((tb >> b) & 1u) || s < 0 || s >= a.ns || s == last) continue;
    a.hit[s] = 1;
    last = s;
  }
}

__global__ void __launch_bounds__(SA_THREADS) k7_verdict(SaArgs a) {
  const long long s0 = 16 * ((long long)blockIdx.x * SA_THREADS + threadIdx.x);
  if (s0 >= a.ns) return;
  const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  const unsigned neg = a.negate ? 0x01010101u : 0u;
  const uint4 h = __ldcg(reinterpret_cast<const uint4*>(a.hit + s0));
  const uint4 m = a.within != nullptr ? sa_bytes16(a.within, s0, a.ns) : ones;
  *reinterpret_cast<uint4*>(a.out + s0) = make_uint4((h.x ^ neg) & m.x, (h.y ^ neg) & m.y,
                                                     (h.z ^ neg) & m.z, (h.w ^ neg) & m.w);
  if (h.x | h.y | h.z | h.w)  // zero for the next call
    *reinterpret_cast<uint4*>(a.hit + s0) = make_uint4(0u, 0u, 0u, 0u);
}

// --------------------------------------------------------------------------
// the C interface
// --------------------------------------------------------------------------

// int64 words of the per-stream hit bytes a call over ns segments needs
AB_EXPORT long long ab_segment_state_words(long long ns) { return 2 * ((ns + 15) / 16); }

// values: bool (AB_KIND_BOOL) or int32 (AB_KIND_I32)[n]; seg: int32[n];
// within: bool[ns] or null; out: bool[ns rounded up to 16], 16-byte
// aligned; state: the per-stream uint64[ab_segment_state_words(ns)],
// 16-byte aligned, zero on entry and on exit.  Two launches.
AB_EXPORT int ab_segment_any(const void* values, int kind, const void* seg, long long n,
                             long long ns, const void* within, int negate, void* out,
                             void* state, void* stream) {
  if (n < 0 || ns < 1 || (kind != AB_KIND_BOOL && kind != AB_KIND_I32) || state == nullptr ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(state) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  SaArgs a;
  a.values = values;
  a.seg = (const int32_t*)seg;
  a.n = n;
  a.ns = ns;
  a.within = (const uint8_t*)within;
  a.negate = negate ? 1u : 0u;
  a.out = (uint8_t*)out;
  a.hit = (uint8_t*)state;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned marks = (unsigned)((n + SA_TILE_PAIRS - 1) / SA_TILE_PAIRS);
  if (marks > 0) {
    if (kind == AB_KIND_BOOL)
      k7_mark<uint8_t><<<marks, SA_THREADS, 0, s>>>(a);
    else
      k7_mark<int32_t><<<marks, SA_THREADS, 0, s>>>(a);
    const int err = ab_last_error();
    if (err) return err;
  }
  k7_verdict<<<(unsigned)((ns + SA_TILE_SEGS - 1) / SA_TILE_SEGS), SA_THREADS, 0, s>>>(a);
  return ab_last_error();
}
