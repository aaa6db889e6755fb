// K14's row function: epoch days -> civil year, month or day.
//
// Replaces arrow_ballista_tpu/ops/kernels.py civil_from_days (l.782) and
// extract_field (l.800): Howard Hinnant's days_from_civil inverse in pure
// integer arithmetic, as the reference writes it.  One C body serves the
// interpreted EXTRACT (csrc/extract.cu) and the fused chains
// (csrc/fused_rows.cuh includes this header, and compile/codegen.py emits
// ab_civil_field calls), so the two cannot drift apart.
//
// Bound: instructions.  A row moves 8 bytes and does nine divisions by
// constants, each a multiply-high and a shift.  Hopper has no 64-bit
// multiply-high instruction: a 64-bit division by a constant is a chain of
// 32-bit multiply-adds.  So only the era, the one step whose dividend
// needs more than 32 bits, divides in 64 bits; everything after it is
// 32-bit unsigned arithmetic (doe lies in [0, 146096], and every quantity
// derived from it fits).
//
// The era is a FLOOR division: a NULL date is the int32 minimum
// (models/schema.py), whose z is negative, and the reference's garbage
// year for it (-5877641) flows into group keys of outer-join rows, so it
// must come out bit for bit.  z is shifted by 14695 eras, which makes it
// non-negative for every int32 day (131,235 at the minimum), so one
// unsigned division floors; the shift comes off the quotient.  The era
// then lies in [-14695, 14703], so the year, yoe + era * 400 + (m <= 2),
// fits int32 without wrapping, as the reference's astype("int32") of its
// int64 year gives it.
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

// days in an era of 400 years, and the eras that shift every int32 day's
// z = days + 719468 to a non-negative value
#define AB_CIVIL_ERA_DAYS 146097u
#define AB_CIVIL_ERA_SHIFT 14695

AB_CIVIL_HD void ab_civil_from_days(int days, int* year, int* month, int* day) {
  const unsigned long long zs = (unsigned long long)((long long)days + 719468 +
                                                     (long long)AB_CIVIL_ERA_DAYS *
                                                         AB_CIVIL_ERA_SHIFT);
  const unsigned long long q = zs / AB_CIVIL_ERA_DAYS;
  const int era = (int)q - AB_CIVIL_ERA_SHIFT;
  const unsigned int doe = (unsigned int)zs - (unsigned int)q * AB_CIVIL_ERA_DAYS;
  const unsigned int yoe = (doe - doe / 1460u + doe / 36524u - doe / 146096u) / 365u;
  const unsigned int doy = doe - (365u * yoe + yoe / 4u - yoe / 100u);
  const unsigned int mp = (5u * doy + 2u) / 153u;
  const unsigned int d = doy - (153u * mp + 2u) / 5u + 1u;
  const unsigned int m = mp < 10u ? mp + 3u : mp - 9u;
  *year = (int)yoe + era * 400 + (m <= 2u ? 1 : 0);
  *month = (int)m;
  *day = (int)d;
}

AB_CIVIL_HD int ab_civil_field(int days, int field) {
  int y, m, d;
  ab_civil_from_days(days, &y, &m, &d);
  return field == AB_EXTRACT_YEAR ? y : (field == AB_EXTRACT_MONTH ? m : d);
}
