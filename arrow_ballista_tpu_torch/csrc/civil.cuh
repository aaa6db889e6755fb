// K14's row function: epoch days -> civil year, month or day.
//
// Replaces arrow_ballista_tpu/ops/kernels.py civil_from_days (l.782) and
// extract_field (l.800): Howard Hinnant's days_from_civil inverse in pure
// integer arithmetic, as the reference writes it.  One C body serves the
// interpreted EXTRACT (csrc/extract.cu) and the fused chains
// (csrc/fused_rows.cuh includes this header, and compile/codegen.py emits
// ab_civil_field calls), so the two cannot drift apart.
//
// The era is a FLOOR division: C's / truncates toward zero, and a NULL
// date is the int32 minimum (models/schema.py), whose z is negative.  The
// reference's garbage year for it (-5877641) flows into group keys of
// outer-join rows, so it must come out bit for bit.  Every later division
// has a non-negative dividend (doe is in [0, 146096]), where truncation and
// floor agree.  The year is computed in 64 bits and narrowed to int32, as
// the reference's astype("int32").
//
// Under a host compiler (no __CUDACC__) the functions are plain inline C,
// which is how the tests check the generated fused sources with g++.
#pragma once

#ifdef __CUDACC__
#define AB_CIVIL_HD __host__ __device__ __forceinline__
#else
#define AB_CIVIL_HD inline
#endif

// the EXTRACT fields (ops/kernels.py EXTRACT_FIELDS)
#define AB_EXTRACT_YEAR 0
#define AB_EXTRACT_MONTH 1
#define AB_EXTRACT_DAY 2

AB_CIVIL_HD long long ab_civil_floordiv(long long a, long long b) {
  long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

AB_CIVIL_HD void ab_civil_from_days(int days, int* year, int* month, int* day) {
  const long long z = (long long)days + 719468;
  const long long era = ab_civil_floordiv(z, 146097);
  const long long doe = z - era * 146097;
  const long long yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const long long doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const long long mp = (5 * doy + 2) / 153;
  const long long d = doy - (153 * mp + 2) / 5 + 1;
  const long long m = mp + (mp < 10 ? 3 : -9);
  const long long y = yoe + era * 400 + (m <= 2 ? 1 : 0);
  *year = (int)(unsigned int)(unsigned long long)y;
  *month = (int)m;
  *day = (int)d;
}

AB_CIVIL_HD int ab_civil_field(int days, int field) {
  int y, m, d;
  ab_civil_from_days(days, &y, &m, &d);
  return field == AB_EXTRACT_YEAR ? y : (field == AB_EXTRACT_MONTH ? m : d);
}
