// Banded NT Baum-Welch kernels for Hopper (sm_90a): the two kernels of
// the basic-mode training path, templated on float and double.
//
//   banded_fwd        replaces dynamont_tpu/ops/nt_banded_pallas.py::_fwd_kernel
//   banded_bwd_train  replaces dynamont_tpu/ops/nt_banded_train.py::_bwd_train_kernel
//
// Plain-torch versions live in ops/nt_banded_batch.py (forward,
// backward_train); the wrappers in ops/nt_banded_kernels.py launch these
// through the extern "C" entry points at the end of the file.
//
// Layout and design are those of nt_banded.cu: read-major (R, T_pad, B)
// band rows, one thread block per read, one thread per band column
// (blockDim = B, a multiple of 32), the t-loop inside the kernel, the
// previous row double-buffered in shared memory (one __syncthreads() per
// row), emission parameters read straight from mu[bstart[t] + j - 2 + pad].
// The TPU kernels' read groups, row sub-accumulators, packed row lanes and
// T-major chunks do not exist here.
//
// banded_fwd is the forward half of banded_fwd_vit: it stores fM and fE for
// every row and computes no posteriors. Row 0 is M = -inf, E = 0 at column
// bw+1; rows t >= T are -inf (the TPU kernel runs on over the zero padding
// past each read's end; here, as in banded_fwd_vit, those rows are defined).
//
// banded_bwd_train is banded_bwd's recurrence, unchanged, fused with the
// Baum-Welch transition numerators (ref: NT_banded.cpp:303-371). At row
// t < T-1 the block holds backward row t+1 in shared memory and has just
// computed sc_a and sc_b, so each thread forms
//     m1_t = ((fE + log_m1) + sc_a) + bMq   where n + 1 < N
//     e2_t = ((fE + log_e2) + sc_b) + bEq   where n > 0
// and folds it into its column's running (max, exp-sum). bMq/bEq read row
// t+1 under the QUIRKED next shift: bstart[t+1] != bstart[t], except at
// t = T-2 where it is bstart[T-2] != bstart[0] (the reference's tracker
// bug, NT_banded.cpp:309); the recurrence keeps the true shift. After the
// loop one reduction across the band gives rawM1/rawE2 per read: max, then
// a fixed pairwise tree sum of exp(acc - max) over the band padded with
// zeros to a power of two, then log + max. The plain version reduces in the
// same order, so both agree bit for bit.
//
// What bounds them: as in nt_banded.cu, the chain of T dependent rows
// (shared-memory exchange, barrier, exp/log1p latency) with R blocks on
// 132 SMs; the bytes (banded_fwd writes two (T, B) rows per read,
// banded_bwd_train reads one and writes two) are far below what the memory
// system carries in the same time. fE is read once per cell, and loaded
// one row ahead so that it stays memory traffic and adds no DRAM latency
// to the chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nt_banded_common.cuh"

namespace {

using namespace dynamont;

// ---------------------------------------------------------------------------
// banded_fwd: forward M/E recurrence, every row stored
// (ref: NT_banded.cpp:23-62)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void banded_fwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    S* __restrict__ fM, S* __restrict__ fE, int T_pad, int N_pad, int B,
    int pad, S log_m1, S log_e2) {
  extern __shared__ unsigned char smem[];
  S* Ms = reinterpret_cast<S*>(smem);  // [2][B]
  S* Es = Ms + 2 * B;                  // [2][B]
  const int r = blockIdx.x;
  const int j = threadIdx.x;
  const S NEG = neg_inf<S>();
  const int T = T_arr[r], N = N_arr[r], bw = bw_arr[r];
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S* mu_r = mu + (size_t)r * N_pad;
  const S* c1_r = c1 + (size_t)r * N_pad;
  const S* c2_r = c2 + (size_t)r * N_pad;
  const int* bs_r = bstart + (size_t)r * T_pad;
  S* fM_r = fM + (size_t)r * T_pad * B;
  S* fE_r = fE + (size_t)r * T_pad * B;

  for (int t = T; t < T_pad; ++t) {  // rows past the read: defined fill
    fM_r[(size_t)t * B + j] = NEG;
    fE_r[(size_t)t * B + j] = NEG;
  }
  const S m0 = NEG;
  const S e0 = (j == bw + 1) ? S(0) : NEG;
  fM_r[j] = m0;
  fE_r[j] = e0;
  int cur = 0;
  Ms[j] = m0;
  Es[j] = e0;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const int o = cur * B;
    const int bs = bs_r[t];
    const bool s1 = bs != bs_r[t - 1];
    const S x = sig_r[t - 1];
    const S sc_b = score(x, mu_r, c1_r, c2_r, bs + j - 2 + pad);
    const int jl = j + 1 < B ? j + 1 : -1;  // left shift source
    const S E_m = s1 ? Es[o + j] : (j > 0 ? Es[o + j - 1] : NEG);
    const S M_e = s1 ? (jl >= 0 ? Ms[o + jl] : NEG) : Ms[o + j];
    const S E_e = s1 ? (jl >= 0 ? Es[o + jl] : NEG) : Es[o + j];
    S M_new = NEG, E_new = NEG;
    if (in_band(j, bs, bw, N, 1)) {
      M_new = (E_m + sc_b) + log_m1;
      E_new = logaddexp(M_e + sc_b, (E_e + sc_b) + log_e2);
    }
    fM_r[(size_t)t * B + j] = M_new;
    fE_r[(size_t)t * B + j] = E_new;
    cur ^= 1;
    Ms[cur * B + j] = M_new;
    Es[cur * B + j] = E_new;
    __syncthreads();
  }
}

// Fold x into the online log-sum (m, s): value = m + log(s).
template <typename S>
__device__ __forceinline__ void online_add(S& m, S& s, S x) {
  const S m_new = max_nan(m, x);
  if (m_new > neg_inf<S>()) s = s * exp_(m - m_new) + exp_(x - m_new);
  m = m_new;
}

// log(sum_j exp(acc_j)) over the block's B columns: max, then the pairwise
// tree over red[0..P) (P = B rounded up to a power of two, zero padded).
// Every thread returns the same value.
template <typename S>
__device__ S band_lse(S acc, S* red, int j, int B, int P) {
  const S NEG = neg_inf<S>();
  red[j] = acc;
  if (j + B < P) red[j + B] = NEG;
  __syncthreads();
  for (int h = P / 2; h > 0; h >>= 1) {
    if (j < h) red[j] = max_nan(red[j], red[j + h]);
    __syncthreads();
  }
  const S m = red[0];
  __syncthreads();
  if (!(m > NEG)) return m;  // no finite term in the read: -inf
  red[j] = exp_(acc - m);
  if (j + B < P) red[j + B] = S(0);
  __syncthreads();
  for (int h = P / 2; h > 0; h >>= 1) {
    if (j < h) red[j] = red[j] + red[j + h];
    __syncthreads();
  }
  const S total = red[0];
  __syncthreads();
  return log_(total) + m;
}

// ---------------------------------------------------------------------------
// banded_bwd_train: backward recurrence + m1/e2 numerators
// (ref: NT_banded.cpp:64-123 backward, 303-371 transitions)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void banded_bwd_train_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    const S* __restrict__ fE, S* __restrict__ bM, S* __restrict__ bE,
    S* __restrict__ rawM1, S* __restrict__ rawE2, int T_pad, int N_pad,
    int B, int P, int pad, S log_m1, S log_e2) {
  extern __shared__ unsigned char smem[];
  S* Ms = reinterpret_cast<S*>(smem);  // [2][B]
  S* Es = Ms + 2 * B;                  // [2][B]
  S* red = Es + 2 * B;                 // [P] band reduction
  const int r = blockIdx.x;
  const int j = threadIdx.x;
  const S NEG = neg_inf<S>();
  const int T = T_arr[r], N = N_arr[r], bw = bw_arr[r];
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S* mu_r = mu + (size_t)r * N_pad;
  const S* c1_r = c1 + (size_t)r * N_pad;
  const S* c2_r = c2 + (size_t)r * N_pad;
  const int* bs_r = bstart + (size_t)r * T_pad;
  const S* fE_r = fE + (size_t)r * T_pad * B;
  S* bM_r = bM + (size_t)r * T_pad * B;
  S* bE_r = bE + (size_t)r * T_pad * B;

  for (int t = T; t < T_pad; ++t) {  // dead rows above the terminal row
    bM_r[(size_t)t * B + j] = NEG;
    bE_r[(size_t)t * B + j] = NEG;
  }
  S m = NEG;
  S e = (j == bw + 1) ? S(0) : NEG;
  bM_r[(size_t)(T - 1) * B + j] = m;
  bE_r[(size_t)(T - 1) * B + j] = e;
  int cur = 0;
  Ms[j] = m;
  Es[j] = e;
  __syncthreads();
  S m1_max = NEG, m1_sum = S(0), e2_max = NEG, e2_sum = S(0);
  const int bs0 = bs_r[0];
  // fE is streamed once and never cached: each row's value is loaded one
  // row ahead, so its latency overlaps the previous row's work
  S fe_next = T >= 2 ? fE_r[(size_t)(T - 2) * B + j] : S(0);
  for (int t = T - 2; t >= 0; --t) {
    const S fe = fe_next;
    if (t > 0) fe_next = fE_r[(size_t)(t - 1) * B + j];
    const S* Mn = Ms + cur * B;  // backward row t+1
    const S* En = Es + cur * B;
    const int bs = bs_r[t];
    const bool sb = bs_r[t + 1] != bs;
    const bool snq = (t == T - 2) ? (bs != bs0) : sb;  // quirked shift
    const S x = sig_r[t];
    const int ib = bs + j - 2 + pad;
    const S sc_b = score(x, mu_r, c1_r, c2_r, ib);      // k-mer position n-1
    const S sc_a = score(x, mu_r, c1_r, c2_r, ib + 1);  // k-mer position n
    const int n = bs + j - 1;
    // transition numerators over row t+1
    const S bMq = snq ? Mn[j] : (j + 1 < B ? Mn[j + 1] : NEG);
    const S bEq = snq ? (j > 0 ? En[j - 1] : NEG) : En[j];
    online_add(m1_max, m1_sum, (n + 1 < N) ? ((fe + log_m1) + sc_a) + bMq : NEG);
    online_add(e2_max, e2_sum, (n > 0) ? ((fe + log_e2) + sc_b) + bEq : NEG);
    // backward recurrence (banded_bwd)
    const S E_n = sb ? (j > 0 ? En[j - 1] : NEG) : En[j];
    const S M_n = sb ? Mn[j] : (j + 1 < B ? Mn[j + 1] : NEG);
    S ext = (n + 1 < N) ? (M_n + sc_a) + log_m1 : NEG;
    S M_new = NEG;
    if (n > 0) {
      M_new = E_n + sc_b;
      ext = logaddexp(ext, (E_n + sc_b) + log_e2);
    }
    if (!in_band(j, bs, bw, N, 0)) {
      M_new = NEG;
      ext = NEG;
    }
    bM_r[(size_t)t * B + j] = M_new;
    bE_r[(size_t)t * B + j] = ext;
    cur ^= 1;
    Ms[cur * B + j] = M_new;
    Es[cur * B + j] = ext;
    __syncthreads();
  }
  const S acc_m1 = m1_sum > S(0) ? m1_max + log_(m1_sum) : NEG;
  const S acc_e2 = e2_sum > S(0) ? e2_max + log_(e2_sum) : NEG;
  const S raw_m1 = band_lse(acc_m1, red, j, B, P);
  const S raw_e2 = band_lse(acc_e2, red, j, B, P);
  if (j == 0) {
    rawM1[r] = raw_m1;
    rawE2[r] = raw_e2;
  }
}

template <typename S>
int launch_fwd(const S* sig, const S* mu, const S* c1, const S* c2,
               const int* bstart, const int* T, const int* N, const int* bw,
               S* fM, S* fE, int R, int T_pad, int N_pad, int B, int pad,
               double log_m1, double log_e2, void* stream) {
  const size_t smem = 4 * (size_t)B * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      banded_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_fwd_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, fM, fE, T_pad, N_pad, B, pad,
      static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_bwd_train(const S* sig, const S* mu, const S* c1, const S* c2,
                     const int* bstart, const int* T, const int* N,
                     const int* bw, const S* fE, S* bM, S* bE, S* rawM1,
                     S* rawE2, int R, int T_pad, int N_pad, int B, int pad,
                     double log_m1, double log_e2, void* stream) {
  int P = 1;
  while (P < B) P <<= 1;
  const size_t smem = (4 * (size_t)B + P) * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      banded_bwd_train_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_bwd_train_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, fE, bM, bE, rawM1, rawE2, T_pad,
      N_pad, B, P, pad, static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

}  // namespace

// extern "C" entry points: pointers and the stream arrive as void* from
// ctypes; each returns cudaGetLastError() after its launch (0 = success).
#define DEFINE_TRAIN_ENTRY_POINTS(S, SUFFIX)                                  \
  extern "C" int nt_banded_fwd_##SUFFIX(                                      \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      void* fM, void* fE, int R, int T_pad, int N_pad, int B, int pad,       \
      double log_m1, double log_e2, void* stream) {                          \
    return launch_fwd<S>((const S*)sig, (const S*)mu, (const S*)c1,          \
                         (const S*)c2, (const int*)bstart, (const int*)T,    \
                         (const int*)N, (const int*)bw, (S*)fM, (S*)fE, R,   \
                         T_pad, N_pad, B, pad, log_m1, log_e2, stream);      \
  }                                                                           \
  extern "C" int nt_banded_bwd_train_##SUFFIX(                                \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      const void* fE, void* bM, void* bE, void* rawM1, void* rawE2, int R,   \
      int T_pad, int N_pad, int B, int pad, double log_m1, double log_e2,    \
      void* stream) {                                                        \
    return launch_bwd_train<S>(                                               \
        (const S*)sig, (const S*)mu, (const S*)c1, (const S*)c2,             \
        (const int*)bstart, (const int*)T, (const int*)N, (const int*)bw,    \
        (const S*)fE, (S*)bM, (S*)bE, (S*)rawM1, (S*)rawE2, R, T_pad, N_pad, \
        B, pad, log_m1, log_e2, stream);                                      \
  }

DEFINE_TRAIN_ENTRY_POINTS(float, f32)
DEFINE_TRAIN_ENTRY_POINTS(double, f64)
