// Device helpers shared by the NTC lattice kernels (ntc_lattice.cu,
// ntc_train.cu): the state and transition indices, the emission score and
// the term-list logsumexp, each rounding as the plain versions in
// ops/ntc_batch.py round (built with -fmad=false, no fast math).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "nt_banded_common.cuh"

namespace dynamont {

constexpr int NTC_MAX_THREADS = 512;
constexpr int MAX_A = 4;
enum { ST_A, ST_P, ST_S, ST_E, ST_I };
// log transitions, in ops/ntc_batch.TL_KEYS order
enum { TA1, TA2, TP1, TP2, TP3, TS1, TS2, TS3, TE2, TE3, TE4, TI1, TI2, NTL };

template <typename S>
__device__ __forceinline__ S sc_(S x, S mu, S c1, S c2) {
  const S d = x - mu;
  const S c2d = c2 * d;
  return c1 - c2d * d;
}

// logsumexp of a term list: max, exp summed in list order, log(sum) + max.
template <typename S, int N>
__device__ __forceinline__ S lse(const S (&v)[N]) {
  S m = v[0];
#pragma unroll
  for (int q = 1; q < N; ++q) m = max_nan(m, v[q]);
  if (!isfinite(m)) return m;
  S s = exp_(v[0] - m);
#pragma unroll
  for (int q = 1; q < N; ++q) s = s + exp_(v[q] - m);
  return log_(s) + m;
}

// state st of a column (5, CN, CK) at (row, col); -inf where either is -1.
template <typename S>
__device__ __forceinline__ S gat(const S* colp, int st, int row, int col,
                                 int CN, int CK) {
  if (row < 0 || col < 0) return neg_inf<S>();
  return colp[((size_t)st * CN + row) * CK + col];
}

}  // namespace dynamont
