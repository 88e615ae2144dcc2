// Device helpers shared by the banded NT kernels (nt_banded.cu,
// nt_banded_train.cu). Every helper rounds as the plain-torch versions in
// ops/nt_banded_batch.py round: the library is built with -fmad=false and
// without fast math, so no product is fused into a sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dynamont {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }

template <typename S>
__device__ __forceinline__ S neg_inf() { return -static_cast<S>(INFINITY); }

// torch.logaddexp: the shared infinity when both are the same infinity
// (so (-inf, -inf) -> -inf), else m + log1p(exp(-|a-b|)).
template <typename S>
__device__ __forceinline__ S logaddexp(S a, S b) {
  if (isinf(a) && a == b) return a;
  const S m = fmax_(a, b);
  return m + log1p_(exp_(-fabs_(a - b)));
}

// torch.maximum: NaN-propagating.
template <typename S>
__device__ __forceinline__ S max_nan(S a, S b) {
  return (isnan(a) || a > b) ? a : b;
}

// log N(x; mu, sd) = c1 - c2 * d * d, rounded as (c2*d)*d.
template <typename S>
__device__ __forceinline__ S score(S x, const S* mu, const S* c1,
                                   const S* c2, int i) {
  const S d = x - mu[i];
  const S c2d = c2[i] * d;
  return c1[i] - c2d * d;
}

// Band cell j of a row starting at bs is live for n in [max(bs, lower),
// min(bs + 2bw + 1, N)).
__device__ __forceinline__ bool in_band(int j, int bs, int bw, int N,
                                        int lower) {
  const int ns = bs > lower ? bs : lower;
  const int ne = (bs + 2 * bw + 1) < N ? (bs + 2 * bw + 1) : N;
  return j >= ns - bs + 1 && j < ne - bs + 1;
}

}  // namespace dynamont
