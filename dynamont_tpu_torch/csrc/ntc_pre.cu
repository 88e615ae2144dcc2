// NTC pre-pass kernels for Hopper (sm_90a): the TN and TK 2-state passes of
// the batched resquiggle pre-pass, templated on float and double.
//
//   ntc_tn_fwd      replaces dynamont_tpu/ops/ntc_pre_pallas.py::_tn_fwd_kernel
//   ntc_tn_bwd_sel  replaces dynamont_tpu/ops/ntc_pre_pallas.py::_tn_bwd_kernel
//   ntc_tk_bwd      replaces dynamont_tpu/ops/ntc_pre_pallas.py::_tk_bwd_kernel
//   ntc_tk_fwd_u    replaces dynamont_tpu/ops/ntc_pre_pallas.py::_tk_fwd_kernel
//
// Plain-torch versions of all four, and the layouts of every argument, are
// in ops/ntc_pre_kernels.py; the wrappers there launch these through the
// extern "C" entry points at the end of the file.
//
// Design (as csrc/nt_banded.cu): one thread block per read, the t-loop inside the
// kernel. A block of B threads owns a row of W columns (W = N2 for TN, K
// for TK; B = the largest power of two dividing W, at most 512); thread b
// owns columns b, b+B, ... (at most 8), whose M/E carries stay in
// registers. Only what a column reads from other columns goes through
// shared memory, double-buffered so that each row costs one barrier: the
// neighbour E[n-1] (TN forward), M[n+1] (TN backward), the four successor
// values of the adjacent-4 group (TK backward) and the four predecessor E
// of the stride-K/4 class (TK forward). The TPU kernels' lane rotations and
// one-hot MXU permutations (p4, p2) become this indexing.
//
// ntc_tn_bwd_sel is two kernels. (a) tn_bwd_u_kernel, the chain: the TN
// backward as above, each row's u = logaddexp(fwd_M + M, fwd_E + E) stored
// into a u store of its own (T_pad, R, N2; fwd is not overwritten, its
// callers read it again), E0 at the end: one barrier a row, as K7. (b)
// tn_sel_kernel, the per-column top-cap and mass: no later row depends on
// a row's selection, so it runs after the chain over all T_pad * R rows at
// once, one warp per row, warp shuffles only. The fused kernel it replaces
// ran cap block-wide arg-max reductions and a block sum on the chain, cap
// + 1 barriers a row on 16 SMs, 9x K7's time.
//
// What bounds them: the t-loop is a chain of T_pad dependent rows, each a
// shared-memory exchange and a barrier; a bucket of 16 reads fills 16 of
// 132 SMs. The stores (the TN forward and TK backward lattices, U, K8's u
// store) are GB-sized but written once, coalesced along the row, and read
// once by the opposite pass (the u store by the selection, which fills
// every SM and is bound by those bytes and its scans of each row).
//
// Exactness: every expression rounds as the plain version does, op by op:
// the TN score -0.5*((LOG_2PI + l2s) + d*d) with d = (x - mu)*sinv, the TK
// score c1 - (c2*d)*d, (a + sc) + log_t, torch.logaddexp, and the grouped
// logsumexps as max, exp, ascending sum, log. Built with -fmad=false and
// without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nt_banded_common.cuh"

namespace {

using namespace dynamont;

// threads per block and columns per thread (ops/ntc_pre_kernels.py): at 512
// threads ptxas may give each thread 128 registers, room for the fp64
// carries of 8 columns
constexpr int MAX_THREADS = 512;
constexpr int MAX_COLS = 8;
constexpr double LOG_2PI = 1.8378770664093453;

// TN emission of k-mer position j: -inf past the read (j >= N_r - 1, which
// also covers the padded column N2 - 1) and before it (j < 0).
template <typename S>
__device__ __forceinline__ S tn_score(S x, const S* mu, const S* sinv,
                                      const S* l2s, int j, int nm1) {
  if (j < 0 || j >= nm1) return neg_inf<S>();
  const S d = (x - mu[j]) * sinv[j];
  const S dd = d * d;
  return S(-0.5) * ((S(LOG_2PI) + l2s[j]) + dd);
}

// TK emission c1 - (c2*d)*d of k-mer k.
template <typename S>
__device__ __forceinline__ S tk_score(S x, const S* mu, const S* c1,
                                      const S* c2, int k) {
  const S d = x - mu[k];
  const S c2d = c2[k] * d;
  return c1[k] - c2d * d;
}

// logsumexp of v[base + j*stride], j = 0..A-1: the max, exp, the sum in
// ascending j, log; -inf for an all--inf group.
template <typename S>
__device__ __forceinline__ S group_lse(const S* v, int base, int stride,
                                       int A) {
  S m = v[base];
  for (int j = 1; j < A; ++j) m = max_nan(m, v[base + j * stride]);
  if (!isfinite(m)) return neg_inf<S>();
  S s = exp_(v[base] - m);
  for (int j = 1; j < A; ++j) s = s + exp_(v[base + j * stride] - m);
  return log_(s) + m;
}

// (v, i) takes (ov, oi) if ov is larger, or equal at a lower index.
template <typename S>
__device__ __forceinline__ void arg_max(S& v, int& i, S ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// ---------------------------------------------------------------------------
// ntc_tn_fwd: TN forward, every row stored (ref: NTC.cpp:80-132)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
tn_fwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ tab,
    const int* __restrict__ N_r, S* __restrict__ fwd, int R, int T_pad, int N2,
    S log_m1, S log_e2) {
  extern __shared__ unsigned char smem[];
  S* Es = reinterpret_cast<S*>(smem);  // [2][N2] previous E row
  const int r = blockIdx.x, tid = threadIdx.x, B = blockDim.x;
  const int J = N2 / B;
  const int nm1 = N_r[r] - 1;
  const size_t W = (size_t)N2 - 1;
  const S* mu = tab + (size_t)r * W;
  const S* sinv = tab + ((size_t)R + r) * W;
  const S* l2s = tab + ((size_t)2 * R + r) * W;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * N2;  // one (state, t) row of fwd
  S* out = fwd + (size_t)r * N2;

  S M[MAX_COLS], E[MAX_COLS];
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (k >= J) break;
    const int n = tid + k * B;
    M[k] = NEG;
    E[k] = n == 0 ? S(0) : NEG;
    out[n] = M[k];
    out[row + n] = E[k];
    Es[n] = E[k];
  }
  int cur = 0;
  __syncthreads();
  for (int t = 1; t < T_pad; ++t) {
    const S x = sig_r[t - 1];
    const S* Ep = Es + cur * N2;
    S* En = Es + (cur ^ 1) * N2;
    S* o = out + (size_t)t * 2 * row;
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      if (k >= J) break;
      const int n = tid + k * B;
      S m_new = NEG, e_new = NEG;
      if (n > 0) {
        const S sc = tn_score(x, mu, sinv, l2s, n - 1, nm1);
        m_new = (Ep[n - 1] + sc) + log_m1;
        e_new = logaddexp(M[k] + sc, (E[k] + sc) + log_e2);
      }
      M[k] = m_new;
      E[k] = e_new;
      En[n] = e_new;
      o[n] = m_new;
      o[row + n] = e_new;
    }
    cur ^= 1;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// ntc_tn_bwd_sel, (a) the chain: TN backward (ref: NTC.cpp:189-217), each
// row's u = logaddexp(fwd_M + M, fwd_E + E) into its own store U
// (T_pad, R, N2), and E0 after row 0
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
tn_bwd_u_kernel(
    const S* __restrict__ sig, const S* __restrict__ tab,
    const int* __restrict__ N_r, const int* __restrict__ T_r,
    const S* __restrict__ fwd, S* __restrict__ U, S* __restrict__ E0, int R,
    int T_pad, int N2, S log_m1, S log_e2) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, B = blockDim.x;
  S* Ms = reinterpret_cast<S*>(smem);  // [2][N2] next M row
  const int J = N2 / B;
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const size_t W = (size_t)N2 - 1;
  const S* mu = tab + (size_t)r * W;
  const S* sinv = tab + ((size_t)R + r) * W;
  const S* l2s = tab + ((size_t)2 * R + r) * W;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * N2;

  S M[MAX_COLS], E[MAX_COLS];
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (k >= J) break;
    M[k] = NEG;
    E[k] = NEG;
    Ms[tid + k * B] = NEG;
  }
  int cur = 0;
  __syncthreads();
  for (int t = T_pad - 1; t >= 0; --t) {
    const S x = t < T_pad - 1 ? sig_r[t] : S(0);
    const bool term = t == tm1, dead = t > tm1;
    const S* Mn = Ms + cur * N2;
    S* Mo = Ms + (cur ^ 1) * N2;
    const S* f = fwd + (size_t)t * 2 * row + (size_t)r * N2;
    S* u = U + ((size_t)t * R + r) * N2;
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      if (k >= J) break;
      const int n = tid + k * B;
      // ext[n] = M[t+1, n+1] + sc(n) + m1; the n >= 1 terms use sc(n-1)
      S ext = NEG;
      if (n < N2 - 1) ext = (Mn[n + 1] + tn_score(x, mu, sinv, l2s, n, nm1)) + log_m1;
      S m_new = NEG;
      if (n > 0) {
        const S sc = tn_score(x, mu, sinv, l2s, n - 1, nm1);
        m_new = E[k] + sc;
        ext = logaddexp(ext, (E[k] + sc) + log_e2);
      }
      S m_out, e_out;
      if (term) {
        m_out = NEG;
        e_out = n == nm1 ? S(0) : NEG;
      } else if (dead) {
        m_out = NEG;
        e_out = NEG;
      } else {
        m_out = m_new;
        e_out = ext;
      }
      M[k] = m_out;
      E[k] = e_out;
      Mo[n] = m_out;
      u[n] = logaddexp(f[n] + m_out, f[row + n] + e_out);
    }
    cur ^= 1;
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (k >= J) break;
    E0[(size_t)r * N2 + tid + k * B] = E[k];
  }
}

// ---------------------------------------------------------------------------
// ntc_tn_bwd_sel, (b) the selection (ref: NTC.cpp:229-280): one warp per
// row of U (rows q = t*R + r, any order), SEL_WARPS warps a block, each
// row copied into the warp's slice of shared memory first (cp.async). Lane
// l scans columns l, l + 32, ... . Round j of the top-cap takes the largest
// (value, lowest index) strictly after round j-1's pick in that order,
// which is the plain version's max-and-mask without a mask; a round whose
// best is -inf (nothing finite left) writes (-inf, 0), as the masked row
// then gives, and so do all later rounds. The mass repeats
// ntc_pre_kernels._tree_sum at B = threads(N2): slot b sums columns b,
// b + B, ... in order (for B >= 32 lane l holds slots l + 32w, w < B/32),
// then a pairwise tree over each warp of 32 slots (a butterfly: lane 0
// adds as the plain tree adds), then one over the B/32 warp sums; for
// B < 32 lanes l < B hold the slots and one tree adds them.
// ---------------------------------------------------------------------------
constexpr int SEL_WARPS = 4;

template <typename S>
__global__ void __launch_bounds__(SEL_WARPS * 32)
tn_sel_kernel(const S* __restrict__ U, const int* __restrict__ kid,
              S* __restrict__ pack, int rows, int R, int N2, int B, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S* w = reinterpret_cast<S*>(smem) + (size_t)warp * N2;
  const S NEG = neg_inf<S>();
  const int PW = 4 * cap + 2;
  const bool rows16 = ((size_t)N2 * sizeof(S)) % 16 == 0;
  constexpr int MAX_G = MAX_THREADS / 32;
  for (int q = blockIdx.x * SEL_WARPS + warp; q < rows; q += gridDim.x * SEL_WARPS) {
    const S* u = U + (size_t)q * N2;
    if (rows16) {
      cp_async_rows(w, u, N2, lane, 32);
    } else {
      cp_async_elems(w, u, N2, lane, 32);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    const int* kid_r = kid + (size_t)(q % R) * (N2 - 1);
    S* p = pack + (size_t)q * PW;
    S tv = NEG, m0 = NEG;
    int ti = -1;
    bool done = false;
    for (int j = 0; j < cap; ++j) {
      S bv = NEG;
      int bi = N2;  // no candidate
      if (!done) {
        for (int c = lane; c < N2; c += 32) {
          const S v = w[c];
          const bool after = ti < 0 || v < tv || (v == tv && c > ti);
          if (after && (bi == N2 || v > bv)) {
            bv = v;
            bi = c;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const S ov = __shfl_xor_sync(FULL_MASK, bv, off);
          const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
          arg_max(bv, bi, ov, oi);
        }
        if (bv == NEG) {
          done = true;
        } else {
          tv = bv;
          ti = bi;
        }
      }
      if (done) {
        bv = NEG;
        bi = 0;
      }
      if (j == 0) m0 = bv;
      if (lane == (j & 31)) {
        const int i1 = bi - 1 < 0 ? 0 : (bi - 1 > N2 - 2 ? N2 - 2 : bi - 1);
        const int i2 = bi > N2 - 2 ? N2 - 2 : bi;
        p[j] = bv;
        p[cap + j] = S(bi);
        p[2 * cap + j] = S(kid_r[i1]);
        p[3 * cap + j] = S(kid_r[i2]);
      }
    }
    // the column's mass relative to its max, over the unmasked row
    const S m0s = isfinite(m0) ? m0 : S(0);
    S s;
    if (B >= 32) {
      const int G = B >> 5, J = N2 / B;
      S a[MAX_G];
      for (int k = 0; k < J; ++k) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g >= G) break;
          const S e = exp_(w[k * B + g * 32 + lane] - m0s);
          a[g] = k == 0 ? e : a[g] + e;
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a[g] = a[g] + __shfl_xor_sync(FULL_MASK, a[g], off);
      }
#pragma unroll
      for (int h = MAX_G / 2; h > 0; h >>= 1) {
        if (h < G) {
#pragma unroll
          for (int g = 0; g < MAX_G / 2; ++g) {
            if (g < h) a[g] = a[g] + a[g + h];
          }
        }
      }
      s = a[0];
    } else {
      s = S(0);
      if (lane < B) {
        s = exp_(w[lane] - m0s);
        for (int c = lane + B; c < N2; c += B) s = s + exp_(w[c] - m0s);
      }
      for (int off = B >> 1; off > 0; off >>= 1)
        s = s + __shfl_xor_sync(FULL_MASK, s, off);
    }
    if (lane == 0) {
      p[4 * cap] = m0;
      p[4 * cap + 1] = s;
    }
    __syncwarp();  // the row's shared copy is read before the next lands
  }
}

// ---------------------------------------------------------------------------
// ntc_tk_bwd: TK backward, every row stored (ref: NTC.cpp:189-217)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
tk_bwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ tabk,
    const int* __restrict__ T_r, S* __restrict__ bwd, int R, int T_pad, int K,
    int A, S log_m1, S log_e2) {
  extern __shared__ unsigned char smem[];
  S* V = reinterpret_cast<S*>(smem);  // [2][K] (M_next + sc) + m1
  const int r = blockIdx.x, tid = threadIdx.x, B = blockDim.x;
  const int J = K / B, step = K / A;
  const int tm1 = T_r[r] - 1;
  const S* mu = tabk;
  const S* c1 = tabk + K;
  const S* c2 = tabk + 2 * (size_t)K;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * K;

  S M[MAX_COLS], E[MAX_COLS];
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (k >= J) break;
    M[k] = NEG;
    E[k] = NEG;
  }
  int cur = 0;
  for (int t = T_pad - 1; t >= 0; --t) {
    const S x = t < T_pad - 1 ? sig_r[t] : S(0);
    const bool term = t == tm1, dead = t > tm1;
    S* Vc = V + cur * K;
    S sc[MAX_COLS];
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      if (k >= J) break;
      const int kk = tid + k * B;
      sc[k] = tk_score(x, mu, c1, c2, kk);
      Vc[kk] = (M[k] + sc[k]) + log_m1;
    }
    __syncthreads();
    S* o = bwd + (size_t)t * 2 * row + (size_t)r * K;
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      if (k >= J) break;
      const int kk = tid + k * B;
      // successors of kk: the adjacent group (kk % step)*A + j
      const S y = group_lse(Vc, (kk % step) * A, 1, A);
      const S m_new = E[k] + sc[k];
      const S e_new = logaddexp(y, (E[k] + sc[k]) + log_e2);
      M[k] = (term || dead) ? NEG : m_new;
      E[k] = term ? S(0) : (dead ? NEG : e_new);
      o[kk] = M[k];
      o[row + kk] = E[k];
    }
    cur ^= 1;
  }
}

// ---------------------------------------------------------------------------
// ntc_tk_fwd_u: TK forward + U = lse(bM + M, bE + E) + finalE (ref:
// NTC.cpp:145-169 for the recurrence, 291-349 for the posteriors)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
tk_fwd_u_kernel(
    const S* __restrict__ sig, const S* __restrict__ tabk,
    const int* __restrict__ T_r, const S* __restrict__ bwd, S* __restrict__ U,
    S* __restrict__ finalE, int R, int T_pad, int K, int A, S log_m1,
    S log_e2) {
  extern __shared__ unsigned char smem[];
  S* Es = reinterpret_cast<S*>(smem);  // [2][K] previous E row
  const int r = blockIdx.x, tid = threadIdx.x, B = blockDim.x;
  const int J = K / B, step = K / A;
  const int tm1 = T_r[r] - 1;
  const S* mu = tabk;
  const S* c1 = tabk + K;
  const S* c2 = tabk + 2 * (size_t)K;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * K;

  S M[MAX_COLS], E[MAX_COLS], F[MAX_COLS];
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (k >= J) break;
    M[k] = NEG;
    E[k] = S(0);
    F[k] = NEG;
    Es[tid + k * B] = S(0);
  }
  int cur = 0;
  __syncthreads();
  for (int t = 0; t < T_pad; ++t) {
    const S x = t > 0 ? sig_r[t - 1] : S(0);
    const bool first = t == 0, dead = t > tm1;
    const S* Ep = Es + cur * K;
    S* En = Es + (cur ^ 1) * K;
    const S* b = bwd + (size_t)t * 2 * row + (size_t)r * K;
    S* o = U + (size_t)t * row + (size_t)r * K;
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      if (k >= J) break;
      const int kk = tid + k * B;
      const S sc = tk_score(x, mu, c1, c2, kk);
      // predecessors of kk: the class kk/A + j*step
      const S X = group_lse(Ep, kk / A, step, A);
      const S m_new = (X + sc) + log_m1;
      const S e_new = logaddexp(M[k] + sc, (E[k] + sc) + log_e2);
      M[k] = (first || dead) ? NEG : m_new;
      E[k] = first ? S(0) : (dead ? NEG : e_new);
      if (t == tm1) F[k] = E[k];
      En[kk] = E[k];
      o[kk] = logaddexp(b[kk] + M[k], b[row + kk] + E[k]);
    }
    cur ^= 1;
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (k >= J) break;
    finalE[(size_t)r * K + tid + k * B] = F[k];
  }
}

template <typename S>
int tn_fwd(const S* sig, const S* tab, const int* N_r, S* fwd, int R,
           int T_pad, int N2, int B, double log_m1, double log_e2,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)N2 * sizeof(S);
  cudaError_t err = launch_smem(tn_fwd_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  tn_fwd_kernel<S><<<R, B, smem, stream>>>(sig, tab, N_r, fwd, R, T_pad, N2,
                                           S(log_m1), S(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int tn_bwd_u(const S* sig, const S* tab, const int* N_r, const int* T_r,
             const S* fwd, S* U, S* E0, int R, int T_pad, int N2, int B,
             double log_m1, double log_e2, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)N2 * sizeof(S);
  cudaError_t err = launch_smem(tn_bwd_u_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  tn_bwd_u_kernel<S><<<R, B, smem, stream>>>(sig, tab, N_r, T_r, fwd, U, E0, R,
                                             T_pad, N2, S(log_m1), S(log_e2));
  return (int)cudaGetLastError();
}

// One block of SEL_WARPS warps on each row group; the grid holds as many
// blocks as the card keeps resident at once, each walking the rows.
template <typename S>
int tn_sel(const S* U, const int* kid, S* pack, int rows, int R, int N2,
           int B, int cap, cudaStream_t stream) {
  const size_t smem = SEL_WARPS * (size_t)N2 * sizeof(S);
  cudaError_t err = launch_smem(tn_sel_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, tn_sel_kernel<S>, SEL_WARPS * 32, smem)) != cudaSuccess)
    return (int)err;
  const long want = (rows + SEL_WARPS - 1) / SEL_WARPS;
  const long most = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < most ? want : most);
  tn_sel_kernel<S><<<blocks, SEL_WARPS * 32, smem, stream>>>(U, kid, pack, rows, R,
                                                             N2, B, cap);
  return (int)cudaGetLastError();
}

template <typename S>
int tk_bwd(const S* sig, const S* tabk, const int* T_r, S* bwd, int R,
           int T_pad, int K, int A, int B, double log_m1, double log_e2,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)K * sizeof(S);
  cudaError_t err = launch_smem(tk_bwd_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  tk_bwd_kernel<S><<<R, B, smem, stream>>>(sig, tabk, T_r, bwd, R, T_pad, K,
                                           A, S(log_m1), S(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int tk_fwd_u(const S* sig, const S* tabk, const int* T_r, const S* bwd,
             S* U, S* finalE, int R, int T_pad, int K, int A, int B,
             double log_m1, double log_e2, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)K * sizeof(S);
  cudaError_t err = launch_smem(tk_fwd_u_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  tk_fwd_u_kernel<S><<<R, B, smem, stream>>>(sig, tabk, T_r, bwd, U, finalE,
                                             R, T_pad, K, A, S(log_m1),
                                             S(log_e2));
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// extern "C" entry points (ctypes); each returns cudaGetLastError() after the
// launch (0 = launched). Pointers are device pointers; stream is a
// cudaStream_t.
// ---------------------------------------------------------------------------
#define NTC_PRE_ENTRIES(S, SUF)                                               \
  extern "C" int ntc_tn_fwd_##SUF(const S* sig, const S* tab, const int* N_r,  \
                                  S* fwd, int R, int T_pad, int N2, int B,     \
                                  double log_m1, double log_e2,                \
                                  void* stream) {                              \
    return tn_fwd<S>(sig, tab, N_r, fwd, R, T_pad, N2, B, log_m1, log_e2,     \
                     (cudaStream_t)stream);                                    \
  }                                                                            \
  extern "C" int ntc_tn_bwd_u_##SUF(                                           \
      const S* sig, const S* tab, const int* N_r, const int* T_r,             \
      const S* fwd, S* U, S* E0, int R, int T_pad, int N2, int B,             \
      double log_m1, double log_e2, void* stream) {                           \
    return tn_bwd_u<S>(sig, tab, N_r, T_r, fwd, U, E0, R, T_pad, N2, B,       \
                       log_m1, log_e2, (cudaStream_t)stream);                  \
  }                                                                            \
  extern "C" int ntc_tn_sel_##SUF(const S* U, const int* kid, S* pack,        \
                                  int rows, int R, int N2, int B, int cap,     \
                                  void* stream) {                              \
    return tn_sel<S>(U, kid, pack, rows, R, N2, B, cap, (cudaStream_t)stream); \
  }                                                                            \
  extern "C" int ntc_tk_bwd_##SUF(const S* sig, const S* tabk, const int* T_r, \
                                  S* bwd, int R, int T_pad, int K, int A,      \
                                  int B, double log_m1, double log_e2,         \
                                  void* stream) {                              \
    return tk_bwd<S>(sig, tabk, T_r, bwd, R, T_pad, K, A, B, log_m1, log_e2,  \
                     (cudaStream_t)stream);                                    \
  }                                                                            \
  extern "C" int ntc_tk_fwd_u_##SUF(                                           \
      const S* sig, const S* tabk, const int* T_r, const S* bwd, S* U,        \
      S* finalE, int R, int T_pad, int K, int A, int B, double log_m1,        \
      double log_e2, void* stream) {                                           \
    return tk_fwd_u<S>(sig, tabk, T_r, bwd, U, finalE, R, T_pad, K, A, B,     \
                       log_m1, log_e2, (cudaStream_t)stream);                  \
  }

NTC_PRE_ENTRIES(float, f32)
NTC_PRE_ENTRIES(double, f64)
