// K14: extract_field — EXTRACT(YEAR | MONTH | DAY FROM date32).
//
// Replaces arrow_ballista_tpu/ops/kernels.py extract_field (l.800) over
// civil_from_days (l.782), the device branch of the E.Extract expression
// (ops/expressions.py:484 in the reference).  The arithmetic is
// csrc/civil.cuh, shared with the generated fused chains (K12 / K13 / K19).
//
// Bound: the rows' 8 bytes each (4 read, 4 written) at device-memory rate,
// once the civil core is cheap enough (32-bit arithmetic after the era:
// csrc/civil.cuh).  One thread a row, grid-stride, neighbouring threads on
// neighbouring rows.
#include "common.cuh"
#include "civil.cuh"

__global__ void __launch_bounds__(256) extract_rows(const int32_t* __restrict__ days, long long n,
                                                    int field, int32_t* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    out[i] = ab_civil_field(__ldg(days + i), field);
}

// days: int32[n], out: int32[n]
AB_EXPORT int ab_extract_field(const void* days, long long n, int field, void* out,
                               void* stream) {
  if (n < 1 || field < AB_EXTRACT_YEAR || field > AB_EXTRACT_DAY)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  extract_rows<<<ab_grid(n, threads, 132 * 16), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)days, n, field, (int32_t*)out);
  return ab_last_error();
}
