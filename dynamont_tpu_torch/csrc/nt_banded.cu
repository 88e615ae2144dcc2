// Banded NT pair-HMM kernels for Hopper (sm_90a): the three kernels of the
// basic-mode segmentation path and the posterior + Viterbi pass of the
// matrix route, templated on float and double.
//
//   banded_bwd      replaces dynamont_tpu/ops/nt_banded_pallas.py::_bwd_kernel
//   banded_fwd_vit  replaces dynamont_tpu/ops/nt_banded_pallas.py::_fwd_vit_kernel
//   banded_walk     replaces dynamont_tpu/ops/nt_banded_pallas.py::_walk_kernel
//   banded_vit      replaces dynamont_tpu/ops/nt_banded_pallas.py::_vit_kernel
//
// Plain-torch versions of all four live in ops/nt_banded_batch.py
// (backward, fwd_vit, walk, viterbi_post); the wrappers in
// ops/nt_banded_kernels.py launch these through the extern "C" entry
// points at the end of the file.
//
// Layout (read-major, row-contiguous):
//   sig                 (R, T_pad-1)   normalized signal; row t uses sig[t-1]
//                                      (forward) or sig[t] (backward)
//   mu/c1/c2            (R, N_pad)     per-position emission parameters,
//                                      k-mer position k at index k + pad
//   bstart              (R, T_pad)     int32 band start per row; band column
//                                      j of row t is base n = bstart[t]+j-1
//   T, N, bw            (R,)           int32 per-read true sizes
//   fM, fE, bM, bE,     (R, T_pad, B)  band rows
//   LPM, LPE
//   ch                  (R, T_pad, B)  uint8 Viterbi choice bit
//
// Design: one thread block per read and one thread per band column
// (blockDim = B, a multiple of 32). The t-loop runs inside the kernel; the
// previous row lives in shared memory, double-buffered, so each row costs
// one __syncthreads(). Emission parameters are read straight from
// mu[bstart[t] + j - 2 + pad]: the TPU kernel's sliding window and its
// entering-element gathers do not exist here, nor its (G, B) read groups,
// packed row lanes or T-major layout.
//
// What bounds them: the t-loop is a chain of T dependent rows, each a few
// hundred cycles of shared-memory exchange, barrier and latency; a bucket
// of R reads fills only R of the card's 132 SMs. Bytes moved (two (T, B)
// fp32 tensors written by banded_bwd, two read and three written by
// banded_fwd_vit) are far below what the memory system could carry in the
// same time. Packing several reads per block and filling the SMs is later
// work. banded_vit has no recurrence besides the Viterbi step: it streams
// four stored (T, B) tensors in and writes three, 25 bytes per band cell
// in fp32 (a 2.0 ms bound at (32, 16384, 512)), so of the four its chain
// comes nearest its bytes; it loads row t+1 of its inputs while row t's
// step waits on the barrier.
//
// Exactness: every expression rounds as the plain-torch version does, op
// by op: c1 - (c2*d)*d, (E_m + sc_b) + log_m1, logaddexp as
// m + log1p(exp(-|a-b|)) (what torch.logaddexp computes), max-then-add in
// the Viterbi step, and the choice bit as the float equality
// vE_new == vM_e + lpe. The library is built with -fmad=false and without
// fast math so no product is fused into a sum. banded_fwd_vit and
// banded_vit take the Viterbi step in one function (viterbi_step), so the
// matrix route's choices equal the fused path's wherever its stored
// forward rows equal the fused kernel's.
//
// Traps: (1) B is the padded band width the JAX package computes; columns
// j >= 2*bw+3 are always -inf and the Z gate counts T*B cells with that B.
// (2) Backward rows above a read's T-1 are -inf and leave the carry
// untouched; reads of different T share one bucket. (3) Forward rows past
// T are never computed: banded_fwd_vit and banded_vit write LPM = LPE =
// -inf and ch = 0 there, as the plain versions do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nt_banded_common.cuh"

namespace {

using namespace dynamont;

// One Viterbi step of band column j over the posteriors (lpm, lpe) of row t
// (ref: NT_banded.cpp:139-189): the previous Viterbi row at VMs/VEs, the
// band shift s1 between rows t-1 and t, max-then-add. Writes the new cell
// and returns the choice bit vE_new == vM_e + lpe, taken after masking.
template <typename S>
__device__ __forceinline__ uint8_t viterbi_step(const S* VMs, const S* VEs,
                                                int j, int B, bool s1,
                                                bool valid, S lpm, S lpe,
                                                S& vM_new, S& vE_new) {
  const S NEG = neg_inf<S>();
  const int jl = j + 1 < B ? j + 1 : -1;  // left shift source
  const S vE_m = s1 ? VEs[j] : (j > 0 ? VEs[j - 1] : NEG);
  const S vM_e = s1 ? (jl >= 0 ? VMs[jl] : NEG) : VMs[j];
  const S vE_e = s1 ? (jl >= 0 ? VEs[jl] : NEG) : VEs[j];
  vM_new = valid ? vE_m + lpm : NEG;
  vE_new = valid ? max_nan(vM_e, vE_e) + lpe : NEG;
  return (vE_new == vM_e + lpe) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// banded_bwd: backward M/E recurrence in reverse t (ref: NT_banded.cpp:64-123)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void banded_bwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    S* __restrict__ bM, S* __restrict__ bE, int T_pad, int N_pad, int B,
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
  for (int t = T - 2; t >= 0; --t) {
    const S* Mn = Ms + cur * B;
    const S* En = Es + cur * B;
    const int bs = bs_r[t];
    const bool sb = bs_r[t + 1] != bs;
    const S x = sig_r[t];
    const int ib = bs + j - 2 + pad;
    const S sc_b = score(x, mu_r, c1_r, c2_r, ib);      // k-mer position n-1
    const S sc_a = score(x, mu_r, c1_r, c2_r, ib + 1);  // k-mer position n
    const int n = bs + j - 1;
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
}

// ---------------------------------------------------------------------------
// banded_fwd_vit: forward recurrence + log posteriors + Viterbi, one pass
// (ref: NT_banded.cpp:23-62 forward, 139-189 Viterbi)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void banded_fwd_vit_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    const S* __restrict__ bM, const S* __restrict__ bE,
    const S* __restrict__ Zb, uint8_t* __restrict__ ch,
    S* __restrict__ LPM, S* __restrict__ LPE, S* __restrict__ Zf, int T_pad,
    int N_pad, int B, int pad, S log_m1, S log_e2) {
  extern __shared__ unsigned char smem[];
  S* Ms = reinterpret_cast<S*>(smem);  // forward rows   [2][B]
  S* Es = Ms + 2 * B;
  S* VMs = Es + 2 * B;                 // Viterbi rows   [2][B]
  S* VEs = VMs + 2 * B;
  const int r = blockIdx.x;
  const int j = threadIdx.x;
  const S NEG = neg_inf<S>();
  const int T = T_arr[r], N = N_arr[r], bw = bw_arr[r];
  const S zb = Zb[r];
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S* mu_r = mu + (size_t)r * N_pad;
  const S* c1_r = c1 + (size_t)r * N_pad;
  const S* c2_r = c2 + (size_t)r * N_pad;
  const int* bs_r = bstart + (size_t)r * T_pad;
  const size_t base = (size_t)r * T_pad * B;

  for (int t = T; t < T_pad; ++t) {  // rows past the read: defined fill
    LPM[base + (size_t)t * B + j] = NEG;
    LPE[base + (size_t)t * B + j] = NEG;
    ch[base + (size_t)t * B + j] = 0;
  }
  const S m0 = NEG;
  const S e0 = (j == bw + 1) ? S(0) : NEG;
  LPM[base + j] = (m0 + bM[base + j]) - zb;
  LPE[base + j] = (e0 + bE[base + j]) - zb;
  ch[base + j] = 0;
  int cur = 0;
  Ms[j] = m0;
  Es[j] = e0;
  VMs[j] = m0;
  VEs[j] = e0;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const int o = cur * B;
    const int bs = bs_r[t];
    const bool s1 = bs != bs_r[t - 1];
    const S x = sig_r[t - 1];
    const S sc_b = score(x, mu_r, c1_r, c2_r, bs + j - 2 + pad);
    const bool valid = in_band(j, bs, bw, N, 1);
    const int jl = j + 1 < B ? j + 1 : -1;  // left shift source
    // forward row
    const S E_m = s1 ? Es[o + j] : (j > 0 ? Es[o + j - 1] : NEG);
    const S M_e = s1 ? (jl >= 0 ? Ms[o + jl] : NEG) : Ms[o + j];
    const S E_e = s1 ? (jl >= 0 ? Es[o + jl] : NEG) : Es[o + j];
    S M_new = NEG, E_new = NEG;
    if (valid) {
      M_new = (E_m + sc_b) + log_m1;
      E_new = logaddexp(M_e + sc_b, (E_e + sc_b) + log_e2);
    }
    if (t == T - 1 && j == bw + 1) Zf[r] = E_new;
    // log posteriors
    const size_t cell = base + (size_t)t * B + j;
    const S lpm = (M_new + bM[cell]) - zb;
    const S lpe = (E_new + bE[cell]) - zb;
    LPM[cell] = lpm;
    LPE[cell] = lpe;
    // Viterbi row
    S vM_new, vE_new;
    ch[cell] = viterbi_step(VMs + o, VEs + o, j, B, s1, valid, lpm, lpe,
                            vM_new, vE_new);
    cur ^= 1;
    const int n_o = cur * B;
    Ms[n_o + j] = M_new;
    Es[n_o + j] = E_new;
    VMs[n_o + j] = vM_new;
    VEs[n_o + j] = vE_new;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// banded_vit: log posteriors + Viterbi over stored forward and backward rows
// (the matrix route; ref: NT_banded.cpp:139-189)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void banded_vit_kernel(
    const S* __restrict__ fM, const S* __restrict__ fE,
    const S* __restrict__ bM, const S* __restrict__ bE,
    const S* __restrict__ Zb, const int* __restrict__ bstart,
    const int* __restrict__ T_arr, const int* __restrict__ N_arr,
    const int* __restrict__ bw_arr, uint8_t* __restrict__ ch,
    S* __restrict__ LPM, S* __restrict__ LPE, int T_pad, int B) {
  extern __shared__ unsigned char smem[];
  S* VMs = reinterpret_cast<S*>(smem);  // Viterbi rows [2][B]
  S* VEs = VMs + 2 * B;
  const int r = blockIdx.x;
  const int j = threadIdx.x;
  const S NEG = neg_inf<S>();
  const int T = T_arr[r], N = N_arr[r], bw = bw_arr[r];
  const S zb = Zb[r];
  const int* bs_r = bstart + (size_t)r * T_pad;
  const size_t base = (size_t)r * T_pad * B;

  for (int t = T; t < T_pad; ++t) {  // rows past the read: defined fill
    LPM[base + (size_t)t * B + j] = NEG;
    LPE[base + (size_t)t * B + j] = NEG;
    ch[base + (size_t)t * B + j] = 0;
  }
  LPM[base + j] = (fM[base + j] + bM[base + j]) - zb;
  LPE[base + j] = (fE[base + j] + bE[base + j]) - zb;
  ch[base + j] = 0;
  int cur = 0;
  VMs[j] = NEG;
  VEs[j] = (j == bw + 1) ? S(0) : NEG;
  // row t's four inputs, loaded one row ahead
  S fm = NEG, fe = NEG, bm = NEG, be = NEG;
  if (T > 1) {
    const size_t c1 = base + B + j;
    fm = fM[c1];
    fe = fE[c1];
    bm = bM[c1];
    be = bE[c1];
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const size_t cell = base + (size_t)t * B + j;
    const S lpm = (fm + bm) - zb;
    const S lpe = (fe + be) - zb;
    if (t + 1 < T) {
      fm = fM[cell + B];
      fe = fE[cell + B];
      bm = bM[cell + B];
      be = bE[cell + B];
    }
    const int bs = bs_r[t];
    const bool s1 = bs != bs_r[t - 1];
    const bool valid = in_band(j, bs, bw, N, 1);
    LPM[cell] = lpm;
    LPE[cell] = lpe;
    S vM_new, vE_new;
    ch[cell] = viterbi_step(VMs + cur * B, VEs + cur * B, j, B, s1, valid,
                            lpm, lpe, vM_new, vE_new);
    cur ^= 1;
    VMs[cur * B + j] = vM_new;
    VEs[cur * B + j] = vE_new;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// banded_walk: reverse MAP traceback, one thread per read
// (ref: NT_banded.cpp:204-250)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void banded_walk_kernel(
    const S* __restrict__ LPM, const S* __restrict__ LPE,
    const uint8_t* __restrict__ ch, const int* __restrict__ bstart,
    const int* __restrict__ T_arr, const int* __restrict__ N_arr,
    const int* __restrict__ bw_arr, int* __restrict__ path_n,
    S* __restrict__ prob, uint8_t* __restrict__ close, int R, int T_pad,
    int B, int N_max) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int T = T_arr[r];
  const int* bs_r = bstart + (size_t)r * T_pad;
  const size_t base = (size_t)r * T_pad * B;
  int* pn_r = path_n + (size_t)r * (T_pad - 1);
  S* pr_r = prob + (size_t)r * (T_pad - 1);
  uint8_t* cl_r = close + (size_t)r * (T_pad - 1);
  int n = N_arr[r] - 1;
  int j = bw_arr[r] + 1;
  bool is_m = false;
  for (int t = T_pad - 1; t >= 1; --t) {
    const bool active = t <= T - 1 && n >= 1;
    if (!active) {
      pn_r[t - 1] = N_max;
      pr_r[t - 1] = S(0);
      cl_r[t - 1] = 0;
      continue;  // an inactive row leaves (n, j, is_m) untouched
    }
    const int s = bs_r[t] != bs_r[t - 1] ? 1 : 0;
    S lp = S(0);
    bool c = false;
    if (j >= 0 && j < B) {  // columns outside the band array read 0 / no
      const size_t cell = base + (size_t)t * B + j;
      lp = is_m ? LPM[cell] : LPE[cell];
      c = ch[cell] != 0;
    }
    S p = exp_(isnan(lp) ? lp : (lp < S(0) ? lp : S(0)));
    if (isnan(p)) p = S(0);
    pn_r[t - 1] = n;
    pr_r[t - 1] = p;
    cl_r[t - 1] = is_m ? 1 : 0;
    if (is_m) {  // close the segment of base n
      n -= 1;
      j = j - 1 + s;
      is_m = false;
    } else {
      j = j + s;
      is_m = c;
    }
  }
}

template <typename S>
int launch_bwd(const S* sig, const S* mu, const S* c1, const S* c2,
               const int* bstart, const int* T, const int* N, const int* bw,
               S* bM, S* bE, int R, int T_pad, int N_pad, int B, int pad,
               double log_m1, double log_e2, void* stream) {
  const size_t smem = 4 * (size_t)B * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      banded_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_bwd_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, bM, bE, T_pad, N_pad, B, pad,
      static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_fwd_vit(const S* sig, const S* mu, const S* c1, const S* c2,
                   const int* bstart, const int* T, const int* N,
                   const int* bw, const S* bM, const S* bE, const S* Zb,
                   uint8_t* ch, S* LPM, S* LPE, S* Zf, int R, int T_pad,
                   int N_pad, int B, int pad, double log_m1, double log_e2,
                   void* stream) {
  const size_t smem = 8 * (size_t)B * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      banded_fwd_vit_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_fwd_vit_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, bM, bE, Zb, ch, LPM, LPE, Zf, T_pad,
      N_pad, B, pad, static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_walk(const S* LPM, const S* LPE, const uint8_t* ch,
                const int* bstart, const int* T, const int* N, const int* bw,
                int* path_n, S* prob, uint8_t* close, int R, int T_pad, int B,
                int N_max, void* stream) {
  const int threads = 32;
  banded_walk_kernel<S><<<(R + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      LPM, LPE, ch, bstart, T, N, bw, path_n, prob, close, R, T_pad, B,
      N_max);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_vit(const S* fM, const S* fE, const S* bM, const S* bE,
               const S* Zb, const int* bstart, const int* T, const int* N,
               const int* bw, uint8_t* ch, S* LPM, S* LPE, int R, int T_pad,
               int B, void* stream) {
  const size_t smem = 4 * (size_t)B * sizeof(S);
  banded_vit_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      fM, fE, bM, bE, Zb, bstart, T, N, bw, ch, LPM, LPE, T_pad, B);
  return (int)cudaGetLastError();
}

}  // namespace

// extern "C" entry points: pointers and the stream arrive as void* from
// ctypes; each returns cudaGetLastError() after its launch (0 = success).
#define DEFINE_ENTRY_POINTS(S, SUFFIX)                                        \
  extern "C" int nt_banded_bwd_##SUFFIX(                                      \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      void* bM, void* bE, int R, int T_pad, int N_pad, int B, int pad,       \
      double log_m1, double log_e2, void* stream) {                          \
    return launch_bwd<S>((const S*)sig, (const S*)mu, (const S*)c1,          \
                         (const S*)c2, (const int*)bstart, (const int*)T,    \
                         (const int*)N, (const int*)bw, (S*)bM, (S*)bE, R,   \
                         T_pad, N_pad, B, pad, log_m1, log_e2, stream);      \
  }                                                                           \
  extern "C" int nt_banded_fwd_vit_##SUFFIX(                                  \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      const void* bM, const void* bE, const void* Zb, void* ch, void* LPM,   \
      void* LPE, void* Zf, int R, int T_pad, int N_pad, int B, int pad,      \
      double log_m1, double log_e2, void* stream) {                          \
    return launch_fwd_vit<S>(                                                 \
        (const S*)sig, (const S*)mu, (const S*)c1, (const S*)c2,             \
        (const int*)bstart, (const int*)T, (const int*)N, (const int*)bw,    \
        (const S*)bM, (const S*)bE, (const S*)Zb, (uint8_t*)ch, (S*)LPM,     \
        (S*)LPE, (S*)Zf, R, T_pad, N_pad, B, pad, log_m1, log_e2, stream);   \
  }                                                                           \
  extern "C" int nt_banded_walk_##SUFFIX(                                     \
      const void* LPM, const void* LPE, const void* ch, const void* bstart,  \
      const void* T, const void* N, const void* bw, void* path_n,            \
      void* prob, void* close, int R, int T_pad, int B, int N_max,           \
      void* stream) {                                                        \
    return launch_walk<S>((const S*)LPM, (const S*)LPE, (const uint8_t*)ch,  \
                          (const int*)bstart, (const int*)T, (const int*)N,  \
                          (const int*)bw, (int*)path_n, (S*)prob,            \
                          (uint8_t*)close, R, T_pad, B, N_max, stream);      \
  }                                                                           \
  extern "C" int nt_banded_vit_##SUFFIX(                                      \
      const void* fM, const void* fE, const void* bM, const void* bE,        \
      const void* Zb, const void* bstart, const void* T, const void* N,      \
      const void* bw, void* ch, void* LPM, void* LPE, int R, int T_pad,      \
      int B, void* stream) {                                                 \
    return launch_vit<S>((const S*)fM, (const S*)fE, (const S*)bM,          \
                         (const S*)bE, (const S*)Zb, (const int*)bstart,     \
                         (const int*)T, (const int*)N, (const int*)bw,       \
                         (uint8_t*)ch, (S*)LPM, (S*)LPE, R, T_pad, B,        \
                         stream);                                            \
  }

DEFINE_ENTRY_POINTS(float, f32)
DEFINE_ENTRY_POINTS(double, f64)
