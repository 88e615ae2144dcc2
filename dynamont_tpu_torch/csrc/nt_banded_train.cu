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
// Layout as in nt_banded.cu: read-major (R, T_pad, B) band rows, one
// thread block per read, one thread per band column (blockDim = B, a
// multiple of 32), the t-loop inside the kernel, the previous row
// double-buffered in shared memory (one __syncthreads() per row). The TPU
// kernels' read groups, row sub-accumulators, packed row lanes and T-major
// chunks do not exist here.
//
// banded_fwd is the forward half of banded_fwd_vit: it stores fM and fE for
// every row and computes no posteriors. Row 0 is M = -inf, E = 0 at column
// bw+1; rows t >= T are -inf (the TPU kernel runs on over the zero padding
// past each read's end; here, as in banded_fwd_vit, those rows are defined).
// Its rows' inputs are staged as banded_fwd_vit stages them, without the
// band rows: chunks of C rows from the bottom up, copied into shared memory
// (cp.async) one chunk ahead of the chain, each stage holding bstart and
// sig of its rows and a window of C + B entries of mu/c1/c2 from the band
// start below the chunk. No band row is staged, so the chunks are long
// (up to 256 rows, as banded_bwd's).
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
// same order, so both agree bit for bit. Its rows' inputs are staged as
// banded_bwd stages them (chunks of C rows from the top down, one chunk
// ahead), and each stage also holds the chunk's fE rows, as banded_fwd_vit
// stages bM and bE: the fE rows set C (ops/nt_banded_kernels.train_staging).
//
// What bounds them: the chain of T dependent rows with R blocks on 132
// SMs; the bytes (banded_fwd writes two (T, B) rows per read,
// banded_bwd_train reads one and writes two) are far below what the memory
// system carries in the same time. A row's own work is issued by the B/32
// warps of one SM, so every instruction a cell saves shortens the row:
//   * the row inputs (bstart, sig, the emission window, fE) come from the
//     stage: no row waits on a load from device memory;
//   * the recurrence's logaddexp is a select (train_logaddexp), so the
//     threads of a warp never split around it; nt_banded_common.cuh's
//     branchy logaddexp stays as the kernels of nt_banded.cu use it;
//   * a numerator fold takes one exp (fold, below), not two;
//   * a cell outside the band skips the recurrence's arithmetic (it is
//     -inf whatever its terms).
// Two columns a thread (fewer warps, fewer instructions a cell) lost 30-48 %
// on the card: the 16 warps of one column a thread hide a row's exp and
// log1p latency better. What is left: the recurrence's exp and log1p
// (about a third of banded_fwd in fp32, two thirds in fp64) and, in
// banded_bwd_train, the two numerator folds (about 30 %; PERF.md §6).
// banded_bwd_train wants 79 (fp32) and 96 (fp64) registers, more than
// 1024 threads may hold, so bands wider than 512 columns run an instance
// with a launch bound (banded_bwd_train_wide_kernel); a bound on the main
// instance cost it 3-6 %.
//
// Band starts: going down bstart falls by 0 or 1 a row, going up it climbs
// by 0 or 1 (the input contract of banded_bwd and banded_fwd_vit). A row
// whose band start leaves its chunk's window (bstart moving faster) turns
// banded_bwd_train's row 0 of bM and bE into NaN, so Zb is NaN, and
// banded_fwd's row T-1 of fE into NaN, so Zf is NaN: every Z gate then
// leaves the read out. Every row reads its chunk's stage through one
// struct of shared pointers a kernel (FwdStage, BwdTrainStage): no pointer
// is shared memory on one path and device memory on another (nvcc 12.9
// miscompiled such a view, tools/staged_view_repro.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nt_banded_common.cuh"

namespace {

using namespace dynamont;

// torch.logaddexp (nt_banded_common.cuh's logaddexp, the same values) as a
// select: both sides computed, the shared infinity picked after.
template <typename S>
__device__ __forceinline__ S train_logaddexp(S a, S b) {
  const S m = fmax_(a, b);
  const S r = m + log1p_(exp_(-fabs_(a - b)));
  return (isinf(a) && a == b) ? a : r;
}

// ---------------------------------------------------------------------------
// banded_fwd: forward M/E recurrence, every row stored
// (ref: NT_banded.cpp:23-62)
// ---------------------------------------------------------------------------
// Chunk k holds rows t0 = k*C .. t0 + n - 1; its stage holds bstart and sig
// of rows t0 - 1 .. t0 + C - 1 and C + B entries of mu/c1/c2 from index
// bstart[t0 - 1] - 2 + pad (bstart[0] for chunk 0). A row's band start
// exceeds the window's by at most C when bstart climbs by 0 or 1 a row.
template <typename S>
struct FwdStage {
  S* mu;    // [B + C] emission window
  S* c1;
  S* c2;
  S* sig;   // [C] sig[t0 - 1 + i], the sample of row t0 + i
  int* bs;  // [C + 1] bstart[t0 - 1 + i]
};

// Shared memory of banded_fwd at band width B, C rows per chunk and element
// size es: the two previous rows [2][B] of M and E, two stages of S arrays
// (the window of mu/c1/c2, sig), then two stages of bstart.
// ops/nt_banded_kernels.train_staging repeats the sum.
__host__ __device__ inline size_t fwd_stage_elems(int B, int C) {
  return 3 * (size_t)(B + C) + C;
}
__host__ __device__ inline size_t fwd_smem_bytes(int B, int C, int es) {
  return (4 * (size_t)B + 2 * fwd_stage_elems(B, C)) * es +
         2 * (size_t)(C + 1) * sizeof(int);
}

template <typename S>
__device__ __forceinline__ FwdStage<S> fwd_stage(unsigned char* smem, int B,
                                                 int C, int st) {
  S* w = reinterpret_cast<S*>(smem) + 4 * (size_t)B +
         st * fwd_stage_elems(B, C);
  int* bs = reinterpret_cast<int*>(reinterpret_cast<S*>(smem) + 4 * (size_t)B +
                                   2 * fwd_stage_elems(B, C)) +
            st * (C + 1);
  return {w, w + (B + C), w + 2 * (B + C), w + 3 * (B + C), bs};
}

template <typename S>
__global__ void banded_fwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    S* __restrict__ fM, S* __restrict__ fE, int T_pad, int N_pad, int B,
    int pad, int C, S log_m1, S log_e2) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int nchunks = (T + C - 1) / C;

  // start the copies of chunk k (rows k*C .. k*C + n - 1) into its stage,
  // the emission window taken from band start wbs
  auto issue = [&](int k, int wbs) {
    const FwdStage<S> s = fwd_stage<S>(smem, B, C, k & 1);
    const int t0 = k * C;
    const int n = T - t0 < C ? T - t0 : C;
    const int lo = k == 0 ? 1 : 0;  // chunk 0 has no row -1
    cp_async_elems(s.bs + lo, bs_r + t0 - 1 + lo, n + 1 - lo, j, B);
    cp_async_elems(s.sig + lo, sig_r + t0 - 1 + lo, n - lo, j, B);
    const int w0 = wbs - 2 + pad;
    const int nw = N_pad - w0 < B + C ? N_pad - w0 : B + C;
    cp_async_elems(s.mu, mu_r + w0, nw, j, B);
    cp_async_elems(s.c1, c1_r + w0, nw, j, B);
    cp_async_elems(s.c2, c2_r + w0, nw, j, B);
    cp_async_commit();
  };

  for (int t = T; t < T_pad; ++t) {  // rows past the read: defined fill
    fM_r[(size_t)t * B + j] = NEG;
    fE_r[(size_t)t * B + j] = NEG;
  }
  int wbs = bs_r[0];
  issue(0, wbs);
  const S m0 = NEG;
  const S e0 = (j == bw + 1) ? S(0) : NEG;
  fM_r[j] = m0;
  fE_r[j] = e0;
  int cur = 0;
  Ms[j] = m0;
  Es[j] = e0;
  cp_async_wait_all();
  __syncthreads();
  bool outside = false;  // a row's band left the staged window
  S* fM_t = fM_r + j;    // this thread's cell of row t, walking up
  S* fE_t = fE_r + j;
  for (int k = 0; k < nchunks; ++k) {
    const FwdStage<S> s = fwd_stage<S>(smem, B, C, k & 1);
    const int t0 = k * C;
    const int n = T - t0 < C ? T - t0 : C;
    const int wk = wbs;
    // chunk k is whole: its last band start opens chunk k + 1's window
    if (k + 1 < nchunks) {
      wbs = s.bs[C];
      issue(k + 1, wbs);
    }
    for (int i = k == 0 ? 1 : 0; i < n; ++i) {
      const int o = cur * B;
      const int bs = s.bs[i + 1];
      int off = bs - wk;
      if (off < 0 || off > C) {
        outside = true;
        off = 0;
      }
      // a cell outside the band is -inf whatever its terms: its thread
      // skips them
      S M_new = NEG, E_new = NEG;
      if (in_band(j, bs, bw, N, 1)) {
        const bool s1 = bs != s.bs[i];
        const S sc_b = score(s.sig[i], s.mu, s.c1, s.c2, off + j);
        const int jl = j + 1 < B ? j + 1 : -1;  // left shift source
        const S E_m = s1 ? Es[o + j] : (j > 0 ? Es[o + j - 1] : NEG);
        const S M_e = s1 ? (jl >= 0 ? Ms[o + jl] : NEG) : Ms[o + j];
        const S E_e = s1 ? (jl >= 0 ? Es[o + jl] : NEG) : Es[o + j];
        M_new = (E_m + sc_b) + log_m1;
        E_new = train_logaddexp(M_e + sc_b, (E_e + sc_b) + log_e2);
      }
      fM_t += B;
      fE_t += B;
      *fM_t = M_new;
      *fE_t = E_new;
      cur ^= 1;
      Ms[cur * B + j] = M_new;
      Es[cur * B + j] = E_new;
      __syncthreads();
    }
    cp_async_wait_all();  // chunk k + 1 has landed
    __syncthreads();
  }
  if (__syncthreads_or(outside))  // Zf = fE[T - 1, bw + 1] is then NaN
    fE_r[(size_t)(T - 1) * B + j] = static_cast<S>(NAN);
}

// Fold x into the online log-sum (m, s), value m + log(s), with the values
// of ops/nt_banded_batch._online_add, which computes
//     m_new = max_nan(m, x);  s = s * exp(m - m_new) + exp(x - m_new)
// where m_new > -inf. One of the two exp arguments is d - d for d = x or
// d = m (the one m_new was taken from, or equal to it): +-0, or NaN where
// d is infinite, and exp of those is exactly 1 + (d - d). So one exp
// serves, picked by x > m with selects (no branch for the warp to split
// around). A term of -inf leaves (m, s) as it is, as the plain fold does.
template <typename S>
__device__ __forceinline__ void fold(S& m, S& s, S x) {
  const S m_new = max_nan(m, x);
  const bool up = x > m;
  const S e = exp_(up ? m - m_new : x - m_new);
  const S one = S(1) + (up ? x - m_new : m - m_new);
  const S s_new = up ? s * e + one : s * one + e;
  s = m_new > neg_inf<S>() ? s_new : s;
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
// Chunk k holds rows hi = T-2 - k*C down to lo = max(0, hi - C + 1); its
// stage holds the fE rows lo .. hi, bstart and sig of rows lo .. hi,
// bstart of row hi + 1, and C + B + 2 entries of mu/c1/c2 from index
// bstart[hi + 1] - C - 2 + pad (clamped at 0), as banded_bwd's.
template <typename S>
struct BwdTrainStage {
  S* fE;    // [C][B] rows lo .. hi
  S* mu;    // [C + B + 2] emission window
  S* c1;
  S* c2;
  S* sig;   // [C] sig[lo + i]
  int* bs;  // [C + 1] bstart[lo + i]
};

// Shared memory of banded_bwd_train at band width B, C rows per chunk, P
// (B rounded up to a power of two) and element size es: the two previous
// rows [2][B] of M and E, two stages of fE rows [C][B] (each 16-byte
// aligned: B is a multiple of 32), two stages of the window of mu/c1/c2
// and sig, two stages of bstart, then the band reduction [P] (8-byte
// aligned: the band starts take 8 (C + 1) bytes).
// ops/nt_banded_kernels.train_staging repeats the sum.
__host__ __device__ inline size_t bwd_train_window(int B, int C) {
  return (size_t)C + B + 2;
}
__host__ __device__ inline size_t bwd_train_stage_elems(int B, int C) {
  return 3 * bwd_train_window(B, C) + C;
}
__host__ __device__ inline size_t bwd_train_smem_bytes(int B, int C, int P,
                                                       int es) {
  return (4 * (size_t)B + 2 * (size_t)C * B + 2 * bwd_train_stage_elems(B, C) +
          P) * es +
         2 * (size_t)(C + 1) * sizeof(int);  // the band starts before red
}

template <typename S>
__device__ __forceinline__ BwdTrainStage<S> bwd_train_stage(
    unsigned char* smem, int B, int C, int st) {
  S* base = reinterpret_cast<S*>(smem) + 4 * (size_t)B;
  S* rows = base + st * (size_t)C * B;
  S* w = base + 2 * (size_t)C * B + st * bwd_train_stage_elems(B, C);
  const size_t nw = bwd_train_window(B, C);
  return {rows, w, w + nw, w + 2 * nw, w + 3 * nw,
          reinterpret_cast<int*>(base + 2 * (size_t)C * B +
                                 2 * bwd_train_stage_elems(B, C)) +
              st * (C + 1)};
}

// First index of the emission window anchored at band start abs.
__device__ __forceinline__ int bwd_train_window_start(int abs, int C, int pad) {
  const int w0 = abs - C - 2 + pad;
  return w0 > 0 ? w0 : 0;
}

// The block's work, shared by the two kernels below.
template <typename S>
__device__ __forceinline__ void bwd_train_block(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    const S* __restrict__ fE, S* __restrict__ bM, S* __restrict__ bE,
    S* __restrict__ rawM1, S* __restrict__ rawE2, int T_pad, int N_pad,
    int B, int P, int pad, int C, S log_m1, S log_e2) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* Ms = reinterpret_cast<S*>(smem);  // [2][B]
  S* Es = Ms + 2 * B;                  // [2][B]
  // [P] band reduction, after both stages' band starts
  S* red = reinterpret_cast<S*>(bwd_train_stage<S>(smem, B, C, 1).bs + C + 1);
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
  const int nchunks = (T - 1 + C - 1) / C;  // rows T-2 .. 0
  auto hi_of = [&](int k) { return T - 2 - k * C; };
  auto lo_of = [&](int k) { return hi_of(k) >= C ? hi_of(k) - C + 1 : 0; };
  const int W = (int)bwd_train_window(B, C);

  // start the copies of chunk k into its stage, the emission window
  // anchored at band start abs (that of row hi + 1)
  auto issue = [&](int k, int abs) {
    const BwdTrainStage<S> s = bwd_train_stage<S>(smem, B, C, k & 1);
    const int hi = hi_of(k), lo = lo_of(k);
    cp_async_rows(s.fE, fE_r + (size_t)lo * B, (size_t)(hi - lo + 1) * B, j, B);
    cp_async_elems(s.bs, bs_r + lo, hi - lo + 2, j, B);
    cp_async_elems(s.sig, sig_r + lo, hi - lo + 1, j, B);
    const int w0 = bwd_train_window_start(abs, C, pad);
    const int nw = N_pad - w0 < W ? N_pad - w0 : W;
    cp_async_elems(s.mu, mu_r + w0, nw, j, B);
    cp_async_elems(s.c1, c1_r + w0, nw, j, B);
    cp_async_elems(s.c2, c2_r + w0, nw, j, B);
    cp_async_commit();
  };

  for (int t = T; t < T_pad; ++t) {  // dead rows above the terminal row
    bM_r[(size_t)t * B + j] = NEG;
    bE_r[(size_t)t * B + j] = NEG;
  }
  int abs = bs_r[T - 1];
  if (nchunks > 0) issue(0, abs);
  const int bs0 = bs_r[0];
  S m = NEG;
  S e = (j == bw + 1) ? S(0) : NEG;
  bM_r[(size_t)(T - 1) * B + j] = m;
  bE_r[(size_t)(T - 1) * B + j] = e;
  int cur = 0;
  Ms[j] = m;
  Es[j] = e;
  cp_async_wait_all();
  __syncthreads();
  S m1_max = NEG, m1_sum = S(0), e2_max = NEG, e2_sum = S(0);
  bool outside = false;  // a row's band left the staged window
  const size_t top = nchunks > 0 ? (size_t)(T - 2) * B + j : j;
  S* bM_t = bM_r + top;  // this thread's cell of row t, walking down
  S* bE_t = bE_r + top;
  for (int k = 0; k < nchunks; ++k) {
    const BwdTrainStage<S> s = bwd_train_stage<S>(smem, B, C, k & 1);
    const int hi = hi_of(k), lo = lo_of(k);
    const int w0 = bwd_train_window_start(abs, C, pad);
    // chunk k's lowest band start anchors chunk k + 1's window
    if (k + 1 < nchunks) {
      abs = s.bs[0];
      issue(k + 1, abs);
    }
    for (int t = hi; t >= lo; --t) {
      const int i = t - lo;
      const S* Mn = Ms + cur * B;  // backward row t+1
      const S* En = Es + cur * B;
      const int bs = s.bs[i];
      int off = bs - 2 + pad - w0;
      if (off < 0 || off > C + 1) {
        outside = true;
        off = 0;
      }
      const bool sb = s.bs[i + 1] != bs;
      const bool snq = (t == T - 2) ? (bs != bs0) : sb;  // quirked shift
      const S x = s.sig[i];
      const S sc_b = score(x, s.mu, s.c1, s.c2, off + j);      // k-mer position n-1
      const S sc_a = score(x, s.mu, s.c1, s.c2, off + j + 1);  // k-mer position n
      const S fe = s.fE[i * B + j];
      const int n = bs + j - 1;
      // transition numerators over row t+1
      const S bMq = snq ? Mn[j] : (j + 1 < B ? Mn[j + 1] : NEG);
      const S bEq = snq ? (j > 0 ? En[j - 1] : NEG) : En[j];
      fold(m1_max, m1_sum, (n + 1 < N) ? ((fe + log_m1) + sc_a) + bMq : NEG);
      fold(e2_max, e2_sum, (n > 0) ? ((fe + log_e2) + sc_b) + bEq : NEG);
      // backward recurrence (banded_bwd); a cell outside the band is -inf
      // whatever its terms
      S M_new = NEG, ext = NEG;
      if (in_band(j, bs, bw, N, 0)) {
        const S E_n = sb ? (j > 0 ? En[j - 1] : NEG) : En[j];
        const S M_n = sb ? Mn[j] : (j + 1 < B ? Mn[j + 1] : NEG);
        ext = (n + 1 < N) ? (M_n + sc_a) + log_m1 : NEG;
        if (n > 0) {
          M_new = E_n + sc_b;
          ext = train_logaddexp(ext, (E_n + sc_b) + log_e2);
        }
      }
      *bM_t = M_new;
      *bE_t = ext;
      bM_t -= B;
      bE_t -= B;
      cur ^= 1;
      Ms[cur * B + j] = M_new;
      Es[cur * B + j] = ext;
      __syncthreads();
    }
    cp_async_wait_all();  // chunk k + 1 has landed
    __syncthreads();
  }
  if (__syncthreads_or(outside)) {  // Zb = bE[0, bw + 1] is then NaN
    bM_r[j] = static_cast<S>(NAN);
    bE_r[j] = static_cast<S>(NAN);
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

// Up to 512 columns (the trainer's bands): the registers the block wants.
template <typename S>
__global__ void banded_bwd_train_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    const S* __restrict__ fE, S* __restrict__ bM, S* __restrict__ bE,
    S* __restrict__ rawM1, S* __restrict__ rawE2, int T_pad, int N_pad,
    int B, int P, int pad, int C, S log_m1, S log_e2) {
  bwd_train_block(sig, mu, c1, c2, bstart, T_arr, N_arr, bw_arr, fE, bM, bE,
                  rawM1, rawE2, T_pad, N_pad, B, P, pad, C, log_m1, log_e2);
}

// Wider bands (-b 510 and above): 1024 threads' registers fit an SM only at
// 64 a thread, which a launch bound makes the compiler keep.
template <typename S>
__global__ void __launch_bounds__(1024) banded_bwd_train_wide_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    const S* __restrict__ fE, S* __restrict__ bM, S* __restrict__ bE,
    S* __restrict__ rawM1, S* __restrict__ rawE2, int T_pad, int N_pad,
    int B, int P, int pad, int C, S log_m1, S log_e2) {
  bwd_train_block(sig, mu, c1, c2, bstart, T_arr, N_arr, bw_arr, fE, bM, bE,
                  rawM1, rawE2, T_pad, N_pad, B, P, pad, C, log_m1, log_e2);
}

template <typename S>
int launch_fwd(const S* sig, const S* mu, const S* c1, const S* c2,
               const int* bstart, const int* T, const int* N, const int* bw,
               S* fM, S* fE, int R, int T_pad, int N_pad, int B, int pad,
               int C, double log_m1, double log_e2, void* stream) {
  const size_t smem = fwd_smem_bytes(B, C, sizeof(S));
  cudaError_t err = launch_smem(banded_fwd_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  banded_fwd_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, fM, fE, T_pad, N_pad, B, pad, C,
      static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_bwd_train(const S* sig, const S* mu, const S* c1, const S* c2,
                     const int* bstart, const int* T, const int* N,
                     const int* bw, const S* fE, S* bM, S* bE, S* rawM1,
                     S* rawE2, int R, int T_pad, int N_pad, int B, int pad,
                     int C, double log_m1, double log_e2, void* stream) {
  int P = 1;
  while (P < B) P <<= 1;
  const size_t smem = bwd_train_smem_bytes(B, C, P, sizeof(S));
  auto kernel = B <= 512 ? banded_bwd_train_kernel<S> : banded_bwd_train_wide_kernel<S>;
  cudaError_t err = launch_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, fE, bM, bE, rawM1, rawE2, T_pad,
      N_pad, B, P, pad, C, static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

}  // namespace

// extern "C" entry points: pointers and the stream arrive as void* from
// ctypes; each returns cudaGetLastError() after its launch (0 = success).
// C is the rows a staged chunk (ops/nt_banded_kernels.train_staging).
#define DEFINE_TRAIN_ENTRY_POINTS(S, SUFFIX)                                  \
  extern "C" int nt_banded_fwd_##SUFFIX(                                      \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      void* fM, void* fE, int R, int T_pad, int N_pad, int B, int pad,       \
      int C, double log_m1, double log_e2, void* stream) {                   \
    return launch_fwd<S>((const S*)sig, (const S*)mu, (const S*)c1,          \
                         (const S*)c2, (const int*)bstart, (const int*)T,    \
                         (const int*)N, (const int*)bw, (S*)fM, (S*)fE, R,   \
                         T_pad, N_pad, B, pad, C, log_m1, log_e2, stream);   \
  }                                                                           \
  extern "C" int nt_banded_bwd_train_##SUFFIX(                                \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      const void* fE, void* bM, void* bE, void* rawM1, void* rawE2, int R,   \
      int T_pad, int N_pad, int B, int pad, int C, double log_m1,            \
      double log_e2, void* stream) {                                         \
    return launch_bwd_train<S>(                                               \
        (const S*)sig, (const S*)mu, (const S*)c1, (const S*)c2,             \
        (const int*)bstart, (const int*)T, (const int*)N, (const int*)bw,    \
        (const S*)fE, (S*)bM, (S*)bE, (S*)rawM1, (S*)rawE2, R, T_pad, N_pad, \
        B, pad, C, log_m1, log_e2, stream);                                   \
  }

DEFINE_TRAIN_ENTRY_POINTS(float, f32)
DEFINE_TRAIN_ENTRY_POINTS(double, f64)
