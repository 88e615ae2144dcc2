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
// kernel. K8's chain: a block of B threads owns a row of W = N2 columns (B
// = the largest power of two dividing W, at most 512); thread b owns
// columns b, b+B, ... (at most 8), whose M/E carries stay in registers.
// Only what a column reads from other columns goes through shared memory,
// double-buffered so that each row costs one barrier: the neighbour
// M[n+1]. K7: 4 (or 8) columns a thread, contiguous in fp32 (the
// neighbour E[n-1] in the thread's registers, or from the lane or warp
// before) and strided in fp64 (through shared memory); its table, signal
// and logaddexp as the TK kernels' (the section "ntc_tn_fwd" below). TK
// (K9, K10): a thread owns one k-mer group, the A columns that share one
// successor group (K9) or one predecessor class (K10), so each group's
// logsumexp is computed once a row; the group's A values come through shared memory
// (the section "The TK kernels" below). The TPU kernels' lane rotations
// and one-hot MXU permutations (p4, p2) become this indexing.
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
// 132 SMs; K7's row is issue-bound on its SM, its exp and log1p half of
// that (its 16 KiB of stores a row cost 5-10 %). The stores (the TN
// forward and TK backward lattices, U, K8's u store) are GB-sized but
// written once, coalesced along the row, and read
// once by the opposite pass (the u store by the selection, which fills
// every SM and is bound by those bytes and its scans of each row).
//
// Exactness: every expression rounds as the plain version does, op by op:
// the TN score -0.5*((LOG_2PI + l2s) + d*d) with d = (x - mu)*sinv, the TK
// score c1 - (c2*d)*d (nt_banded_common.cuh's score), (a + sc) + log_t, torch.logaddexp, and the grouped
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

// (v, i) takes (ov, oi) if ov is larger, or equal at a lower index.
template <typename S>
__device__ __forceinline__ void arg_max(S& v, int& i, S ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
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
// The TK kernels, K9 and K10: one k-mer group a thread
// ---------------------------------------------------------------------------
// A k-mer's M state sums over a group of ALPHA k-mers: its successors
// (kk % step)*A + j in the backward pass, its predecessors kk/A + j*step in
// the forward pass (step = K/A, j < A). The A columns that share a group
// share its logsumexp, so thread i owns group i, A columns, and computes
// the group's sum once a row: step threads, up to TK_MAX_THREADS
// (ops/ntc_pre_kernels.tk_geometry). Above MAX_THREADS the kernels are
// built for TK_MAX_THREADS threads (64 registers a thread): at K = 4096
// that beat 512 threads of two groups each by 4-15 % in both dtypes.
//   K9: thread i owns successor group i; its columns are i + j*step, and
//       the group's values V[iA .. iA + A-1] are one vector load from
//       shared memory.
//   K10: thread i owns predecessor class i; its columns are iA + j,
//       contiguous (one vector store of its E row and of U each), and its
//       group's values E[i + j*step] are A conflict-free loads.
// mu, c1 and c2 of a thread's columns stay in registers for the whole
// t-loop. The signal arrives in stages of TK_CHUNK samples, copied into
// shared memory (cp.async) one chunk ahead of the rows that read it, as
// in nt_banded.cu. K10's backward rows arrive in a ring of `ring` rows of
// bM and bE (TK_RING, fewer where shared memory runs out): each thread
// copies its own 2*A values ring - 1 rows ahead and waits for its own
// copies only, so U's logaddexp reads shared memory and no row waits on
// device memory. Both keep one barrier a row (K9's V and K10's E row
// double-buffered) and one more a chunk.
constexpr int ALPHA = 4;
constexpr int TK_MAX_THREADS = 1024;
constexpr int TK_CHUNK = 512;
constexpr int TK_RING = 4;

// logsumexp of a group: the max, exp, the sum in ascending j, log; -inf
// for a group whose max is not finite (ntc_pre._group_lse). Written as
// selects, like tk_logaddexp below: without a branch around each sum the
// compiler interleaves a thread's independent chains (K9 12.2 -> 9.3 ms,
// K10 21.9 -> 16.7 ms in fp32 on the (16, 16384) bucket).
template <typename S>
__device__ __forceinline__ S group_lse(const S (&v)[ALPHA]) {
  S m = v[0];
#pragma unroll
  for (int j = 1; j < ALPHA; ++j) m = max_nan(m, v[j]);
  const bool fin = isfinite(m);
  const S ms = fin ? m : S(0);
  S s = exp_(v[0] - ms);
#pragma unroll
  for (int j = 1; j < ALPHA; ++j) s = s + exp_(v[j] - ms);
  const S r = log_(s) + ms;
  return fin ? r : neg_inf<S>();
}

// torch.logaddexp (nt_banded_common.cuh's logaddexp, the same values) as
// a select: both sides computed, the shared infinity picked after. Kept
// apart from the shared one, whose other kernels keep their code.
template <typename S>
__device__ __forceinline__ S tk_logaddexp(S a, S b) {
  const S m = fmax_(a, b);
  const S r = m + log1p_(exp_(-fabs_(a - b)));
  return (isinf(a) && a == b) ? a : r;
}

// A = 4 contiguous values, 16-byte aligned, as vector loads and stores.
__device__ __forceinline__ void ld4(const float* p, float (&v)[ALPHA]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[ALPHA]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[ALPHA]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[ALPHA]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Blocks until at most `pending` (1-3) of the thread's committed copy
// groups are still in flight; all of them for any other value.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    default: cp_async_wait_all();
  }
}

// Shared memory of K9 (ring 0) and K10 at element size es: the
// double-buffered row [2][K] (K9's V, K10's E), two signal stages
// [2][TK_CHUNK], then K10's ring [ring][2][K] of backward rows (bM, bE).
// ops/ntc_pre_kernels.tk_geometry repeats the sum.
__host__ __device__ inline size_t tk_smem_bytes(int K, int ring, int es) {
  return (2 * (size_t)K + 2 * TK_CHUNK + 2 * (size_t)ring * K) * es;
}

// The signal stage of chunk k (samples [lo, hi]) starts to copy.
template <typename S>
__device__ __forceinline__ void tk_issue_signal(S* xs, const S* sig_r, int k,
                                                int lo, int hi, int tid,
                                                int nt) {
  cp_async_elems(xs + (k & 1) * TK_CHUNK, sig_r + lo, hi - lo + 1, tid, nt);
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// ntc_tk_bwd: TK backward, every row stored (ref: NTC.cpp:189-217)
// ---------------------------------------------------------------------------
// Rows run from T_pad - 1 (x = 0) down; chunk k holds the samples of rows
// hi = T_pad - 2 - k*TK_CHUNK down to lo = max(0, hi - TK_CHUNK + 1).
template <typename S, int MAXT>
__global__ void __launch_bounds__(MAXT)
tk_bwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ tabk,
    const int* __restrict__ T_r, S* __restrict__ bwd, int R, int T_pad, int K,
    S log_m1, S log_e2) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* V = reinterpret_cast<S*>(smem);  // [2][K] (M_next + sc) + m1
  S* xs = V + 2 * (size_t)K;          // [2][TK_CHUNK] signal stages
  const int r = blockIdx.x, q = threadIdx.x, NT = blockDim.x;
  const int step = K / ALPHA, Tm1 = T_pad - 1;
  const int tm1 = T_r[r] - 1;
  const S* sig_r = sig + (size_t)r * Tm1;
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * K;

  S mu[ALPHA], c1[ALPHA], c2[ALPHA], M[ALPHA], E[ALPHA];
#pragma unroll
  for (int j = 0; j < ALPHA; ++j) {
    const int kk = q + j * step;
    mu[j] = tabk[kk];
    c1[j] = tabk[K + kk];
    c2[j] = tabk[2 * (size_t)K + kk];
    M[j] = NEG;
    E[j] = NEG;
  }
  const int nchunks = (Tm1 + TK_CHUNK - 1) / TK_CHUNK;
  auto hi_of = [&](int k) { return Tm1 - 1 - k * TK_CHUNK; };
  auto lo_of = [&](int k) {
    const int lo = hi_of(k) - TK_CHUNK + 1;
    return lo > 0 ? lo : 0;
  };
  int cur = 0;
  // row t from row t + 1 (M, E in registers, V[cur] the exchange)
  auto step_row = [&](int t, S x) {
    const bool term = t == tm1, dead = t > tm1;
    S* Vc = V + cur * K;
    S em[ALPHA];  // E[t+1] + sc: M's new value, E's own-state term
#pragma unroll
    for (int j = 0; j < ALPHA; ++j) {
      const S sc = score(x, mu, c1, c2, j);
      Vc[q + j * step] = (M[j] + sc) + log_m1;
      em[j] = E[j] + sc;
    }
    __syncthreads();
    S* o = bwd + (size_t)t * 2 * row + (size_t)r * K;
    S v[ALPHA];
    ld4(Vc + q * ALPHA, v);
    const S y = group_lse(v);  // the successors' sum, once for A columns
#pragma unroll
    for (int j = 0; j < ALPHA; ++j) {
      const int kk = q + j * step;
      const S e_new = tk_logaddexp(y, em[j] + log_e2);
      M[j] = (term || dead) ? NEG : em[j];
      E[j] = term ? S(0) : (dead ? NEG : e_new);
      o[kk] = M[j];
      o[row + kk] = E[j];
    }
    cur ^= 1;
  };

  if (nchunks > 0) tk_issue_signal(xs, sig_r, 0, lo_of(0), hi_of(0), q, NT);
  step_row(Tm1, S(0));
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nchunks; ++k) {
    const S* xk = xs + (k & 1) * TK_CHUNK;
    const int hi = hi_of(k), lo = lo_of(k);
    if (k + 1 < nchunks)
      tk_issue_signal(xs, sig_r, k + 1, lo_of(k + 1), hi_of(k + 1), q, NT);
    for (int t = hi; t >= lo; --t) step_row(t, xk[t - lo]);
    cp_async_wait_all();  // chunk k + 1 has landed
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// ntc_tk_fwd_u: TK forward + U = lse(bM + M, bE + E) + finalE (ref:
// NTC.cpp:145-169 for the recurrence, 291-349 for the posteriors)
// ---------------------------------------------------------------------------
// Row 0 is M = -inf, E = 0; chunk k holds the samples k*TK_CHUNK ..
// of rows 1 + k*TK_CHUNK .. (row t reads sample t - 1).
template <typename S, int MAXT>
__global__ void __launch_bounds__(MAXT)
tk_fwd_u_kernel(
    const S* __restrict__ sig, const S* __restrict__ tabk,
    const int* __restrict__ T_r, const S* __restrict__ bwd, S* __restrict__ U,
    S* __restrict__ finalE, int R, int T_pad, int K, int ring, S log_m1,
    S log_e2) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* Es = reinterpret_cast<S*>(smem);  // [2][K] previous E row
  S* xs = Es + 2 * (size_t)K;          // [2][TK_CHUNK] signal stages
  S* bs = xs + 2 * TK_CHUNK;           // [ring][2][K] backward rows
  const int r = blockIdx.x, c = threadIdx.x, NT = blockDim.x;
  const int step = K / ALPHA, Tm1 = T_pad - 1, c0 = c * ALPHA;
  const int tm1 = T_r[r] - 1;
  const S* sig_r = sig + (size_t)r * Tm1;
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * K;
  S* fin = finalE + (size_t)r * K + c0;
  constexpr int PIECE = 16 / (int)sizeof(S);  // elements a 16-byte copy

  S mu[ALPHA], c1[ALPHA], c2[ALPHA], M[ALPHA], E[ALPHA];
#pragma unroll
  for (int j = 0; j < ALPHA; ++j) {
    mu[j] = tabk[c0 + j];
    c1[j] = tabk[K + c0 + j];
    c2[j] = tabk[2 * (size_t)K + c0 + j];
    M[j] = NEG;
    E[j] = S(0);
  }
  st4(Es + c0, E);
  {
    const S none[ALPHA] = {NEG, NEG, NEG, NEG};
    st4(fin, none);
  }
  // this thread's bM and bE of row t into ring slot t % ring (an empty
  // group past the last row), one commit group a row
  auto issue_row = [&](int t) {
    if (t < T_pad) {
      const S* b = bwd + (size_t)t * 2 * row + (size_t)r * K + c0;
      S* s = bs + (size_t)(t % ring) * 2 * K + c0;
#pragma unroll
      for (int p = 0; p < ALPHA; p += PIECE) {
        cp_async16(s + p, b + p);
        cp_async16(s + K + p, b + row + p);
      }
    }
    cp_async_commit();
  };
  // U and finalE of row t from M and E, the backward values from the ring
  auto out_row = [&](int t) {
    cp_async_wait_pending(ring - 1);  // this thread's copies of row t landed
    const S* s = bs + (size_t)(t % ring) * 2 * K + c0;
    S bm[ALPHA], be[ALPHA], u[ALPHA];
    ld4(s, bm);
    ld4(s + K, be);
#pragma unroll
    for (int j = 0; j < ALPHA; ++j) u[j] = tk_logaddexp(bm[j] + M[j], be[j] + E[j]);
    st4(U + (size_t)t * row + (size_t)r * K + c0, u);
    if (t == tm1) st4(fin, E);
  };
  const int nchunks = (Tm1 + TK_CHUNK - 1) / TK_CHUNK;
  auto hi_of = [&](int k) {  // last sample of chunk k
    const int hi = (k + 1) * TK_CHUNK - 1;
    return hi < Tm1 - 1 ? hi : Tm1 - 1;
  };

  if (nchunks > 0) tk_issue_signal(xs, sig_r, 0, 0, hi_of(0), c, NT);
  for (int t = 0; t < ring; ++t) issue_row(t);
  out_row(0);
  int cur = 0;
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nchunks; ++k) {
    const S* xk = xs + (k & 1) * TK_CHUNK;
    const int lo = k * TK_CHUNK, hi = hi_of(k);
    if (k + 1 < nchunks)
      tk_issue_signal(xs, sig_r, k + 1, lo + TK_CHUNK, hi_of(k + 1), c, NT);
    for (int t = lo + 1; t <= hi + 1; ++t) {
      issue_row(t + ring - 1);
      const S x = xk[t - 1 - lo];
      const bool dead = t > tm1;
      const S* Ep = Es + cur * K;
      S ep[ALPHA];
#pragma unroll
      for (int j = 0; j < ALPHA; ++j) ep[j] = Ep[c + j * step];
      const S X = group_lse(ep);  // the predecessors' sum, once for A columns
#pragma unroll
      for (int j = 0; j < ALPHA; ++j) {
        const S sc = score(x, mu, c1, c2, j);
        const S m_new = (X + sc) + log_m1;
        const S e_new = tk_logaddexp(M[j] + sc, (E[j] + sc) + log_e2);
        M[j] = dead ? NEG : m_new;
        E[j] = dead ? NEG : e_new;
      }
      st4(Es + (cur ^ 1) * K + c0, E);
      out_row(t);
      cur ^= 1;
      __syncthreads();
    }
    cp_async_wait_all();  // chunk k + 1 has landed
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// ntc_tn_fwd: TN forward, every row stored (ref: NTC.cpp:80-132)
// ---------------------------------------------------------------------------
// A block of NT threads (a whole number of warps, ceil(N2 / J) rounded up;
// J = 4 up to N2 = 4*MAX_THREADS, else 8: ops/ntc_pre_kernels
// .tn_fwd_geometry) owns the row, each thread J columns, the threads and
// columns past the row idle. mu, 1/sd and LOG_2PI + 2 log sd of a thread's
// columns stay in registers and each column's liveness is a predicate, so
// the score is a select; the signal arrives in stages of TK_CHUNK samples,
// copied a chunk ahead (cp.async; row t reads sample t - 1, chunk k holds
// samples k*TK_CHUNK ..); the logaddexp is tk_logaddexp's select, so a
// thread's J chains interleave. Each column's arithmetic is the plain
// version's, op by op. Column n's M reads the previous row's E[n-1]; the
// two layouts, one a dtype (tn_fwd_layout), fetch it differently:
//   contiguous (fp32): thread q owns columns q*J + j; E[n-1] is its own
//     E[j-1] in registers, for j = 0 lane q-1's E[J-1] (__shfl_up_sync),
//     at a warp's lane 0 warp w-1's lane 31 through shared memory; M and
//     E go out as vector stores of four columns.
//   strided (fp64): thread q owns columns q + j*NT, E[n-1] through a
//     shared copy of the row. A warp's lanes then hold 32 adjacent
//     columns in each of a thread's J slots, so the one warp a row where
//     the live columns end (-inf beside finite values: libdevice's fp64
//     exp and log1p branch on such arguments) diverges in one slot rather
//     than in all J; fp64 is bound by those functions (41.6 against 47.3
//     ms on the (16, 16384) bucket), fp32 by the row's issue (11.8
//     against 13.5 ms for strided).
// Both double-buffer what crosses threads, so a row costs one barrier.
template <typename S, int J, bool STRIDED>
__global__ void __launch_bounds__(MAX_THREADS)
tn_fwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ tab,
    const int* __restrict__ N_r, S* __restrict__ fwd, int R, int T_pad, int N2,
    S log_m1, S log_e2) {
  static_assert(J % ALPHA == 0, "M and E go out in vectors of four columns");
  __shared__ __align__(16) S xs[2 * TK_CHUNK];   // signal stages
  __shared__ S edge[2][MAX_THREADS / 32];        // contiguous: each warp's last E
  extern __shared__ __align__(16) unsigned char smem[];
  S* Es = reinterpret_cast<S*>(smem);            // strided: [2][NT * J] E rows
  const int r = blockIdx.x, q = threadIdx.x, NT = blockDim.x;
  const int lane = q & 31, warp = q >> 5, Tm1 = T_pad - 1;
  const int nm1 = N_r[r] - 1;
  const size_t W = (size_t)N2 - 1;
  const S* mu_r = tab + (size_t)r * W;
  const S* sinv_r = tab + ((size_t)R + r) * W;
  const S* l2s_r = tab + ((size_t)2 * R + r) * W;
  const S* sig_r = sig + (size_t)r * Tm1;
  const S NEG = neg_inf<S>();
  const size_t row = (size_t)R * N2;  // one (state, t) row of fwd
  S* out = fwd + (size_t)r * N2;
  auto col = [&](int j) { return STRIDED ? q + j * NT : q * J + j; };

  // column n's emission reads k-mer position n - 1 (-inf outside [0, nm1))
  S mu[J], sinv[J], lc[J], M[J], E[J];
  bool live[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int n = col(j);
    const bool tab_col = n >= 1 && n < N2;
    mu[j] = tab_col ? mu_r[n - 1] : S(0);
    sinv[j] = tab_col ? sinv_r[n - 1] : S(0);
    lc[j] = tab_col ? S(LOG_2PI) + l2s_r[n - 1] : S(0);
    live[j] = n >= 1 && n - 1 < nm1;
    M[j] = NEG;
    E[j] = n == 0 ? S(0) : NEG;
  }
  const bool col0 = q == 0;  // owns column 0 (as j = 0), -inf after row 0
  // this thread's M and E of row t, and what the next row reads of them
  auto store_row = [&](int t, int to) {
    S* o = out + (size_t)t * 2 * row;
    if constexpr (STRIDED) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = col(j);
        Es[to * NT * J + n] = E[j];
        if (n < N2) {
          o[n] = M[j];
          o[row + n] = E[j];
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < J; g += ALPHA) {
        if (col(g) < N2) {
          const S m4[ALPHA] = {M[g], M[g + 1], M[g + 2], M[g + 3]};
          const S e4[ALPHA] = {E[g], E[g + 1], E[g + 2], E[g + 3]};
          st4(o + col(g), m4);
          st4(o + row + col(g), e4);
        }
      }
      if (lane == 31) edge[to][warp] = E[J - 1];
    }
  };
  const int nchunks = (Tm1 + TK_CHUNK - 1) / TK_CHUNK;
  auto hi_of = [&](int k) {  // last sample of chunk k
    const int hi = (k + 1) * TK_CHUNK - 1;
    return hi < Tm1 - 1 ? hi : Tm1 - 1;
  };

  if (nchunks > 0) tk_issue_signal(xs, sig_r, 0, 0, hi_of(0), q, NT);
  store_row(0, 0);
  int cur = 0;
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nchunks; ++k) {
    const S* xk = xs + (k & 1) * TK_CHUNK;
    const int lo = k * TK_CHUNK, hi = hi_of(k);
    if (k + 1 < nchunks)
      tk_issue_signal(xs, sig_r, k + 1, lo + TK_CHUNK, hi_of(k + 1), q, NT);
    for (int t = lo + 1; t <= hi + 1; ++t) {
      const S x = xk[t - 1 - lo];
      S Ep[J];  // E[n-1] of the previous row
      if constexpr (STRIDED) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int n = col(j);
          Ep[j] = n > 0 ? Es[cur * NT * J + n - 1] : NEG;
        }
      } else {
        S left = __shfl_up_sync(FULL_MASK, E[J - 1], 1);
        if (lane == 0) left = warp > 0 ? edge[cur][warp - 1] : NEG;
#pragma unroll
        for (int j = 0; j < J; ++j) Ep[j] = j == 0 ? left : E[j - 1];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const S d = (x - mu[j]) * sinv[j];
        const S dd = d * d;
        const S sc = live[j] ? S(-0.5) * (lc[j] + dd) : NEG;
        const S m_new = (Ep[j] + sc) + log_m1;
        const S e_new = tk_logaddexp(M[j] + sc, (E[j] + sc) + log_e2);
        const bool none = j == 0 && col0;
        M[j] = none ? NEG : m_new;
        E[j] = none ? NEG : e_new;
      }
      store_row(t, cur ^ 1);
      cur ^= 1;
      __syncthreads();
    }
    cp_async_wait_all();  // chunk k + 1 has landed
    __syncthreads();
  }
}

// K7's columns a thread at width N2 (0: a width it does not take), and its
// block: ceil(N2 / J) threads rounded up to a warp.
inline int tn_fwd_cols(int N2) {
  if (N2 < ALPHA || N2 % ALPHA != 0 || N2 > 2 * ALPHA * MAX_THREADS) return 0;
  return N2 <= ALPHA * MAX_THREADS ? ALPHA : 2 * ALPHA;
}

template <typename S, int J>
int tn_fwd_launch(const S* sig, const S* tab, const int* N_r, S* fwd, int R, int T_pad,
                  int N2, int B, double log_m1, double log_e2, cudaStream_t stream) {
  constexpr bool STRIDED = sizeof(S) == 8;  // tn_fwd_layout
  const size_t smem = STRIDED ? 2 * (size_t)B * J * sizeof(S) : 0;
  cudaError_t err = launch_smem(tn_fwd_kernel<S, J, STRIDED>, smem);
  if (err != cudaSuccess) return (int)err;
  tn_fwd_kernel<S, J, STRIDED><<<R, B, smem, stream>>>(sig, tab, N_r, fwd, R, T_pad, N2,
                                                       S(log_m1), S(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int tn_fwd(const S* sig, const S* tab, const int* N_r, S* fwd, int R,
           int T_pad, int N2, int B, double log_m1, double log_e2,
           cudaStream_t stream) {
  const int J = tn_fwd_cols(N2);
  if (J == 0 || B != (N2 / J + (N2 % J != 0) + 31) / 32 * 32)
    return (int)cudaErrorInvalidValue;
  return J == ALPHA ? tn_fwd_launch<S, ALPHA>(sig, tab, N_r, fwd, R, T_pad, N2, B, log_m1,
                                              log_e2, stream)
                    : tn_fwd_launch<S, 2 * ALPHA>(sig, tab, N_r, fwd, R, T_pad, N2, B,
                                                  log_m1, log_e2, stream);
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

// K9 and K10 take A = ALPHA and K/A threads, at most TK_MAX_THREADS
// (built for MAX_THREADS threads up to it, for TK_MAX_THREADS above); K10
// a ring of at least one row.
inline bool tk_shape_ok(int K, int A) {
  return A == ALPHA && K > 0 && K % A == 0 && K / A <= TK_MAX_THREADS;
}

template <typename S, int MAXT>
int tk_bwd_launch(const S* sig, const S* tabk, const int* T_r, S* bwd, int R,
                  int T_pad, int K, double log_m1, double log_e2,
                  cudaStream_t stream) {
  const size_t smem = tk_smem_bytes(K, 0, sizeof(S));
  cudaError_t err = launch_smem(tk_bwd_kernel<S, MAXT>, smem);
  if (err != cudaSuccess) return (int)err;
  tk_bwd_kernel<S, MAXT><<<R, K / ALPHA, smem, stream>>>(
      sig, tabk, T_r, bwd, R, T_pad, K, S(log_m1), S(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int tk_bwd(const S* sig, const S* tabk, const int* T_r, S* bwd, int R,
           int T_pad, int K, int A, double log_m1, double log_e2,
           cudaStream_t stream) {
  if (!tk_shape_ok(K, A)) return (int)cudaErrorInvalidValue;
  return K / A <= MAX_THREADS
             ? tk_bwd_launch<S, MAX_THREADS>(sig, tabk, T_r, bwd, R, T_pad, K,
                                             log_m1, log_e2, stream)
             : tk_bwd_launch<S, TK_MAX_THREADS>(sig, tabk, T_r, bwd, R, T_pad,
                                                K, log_m1, log_e2, stream);
}

template <typename S, int MAXT>
int tk_fwd_u_launch(const S* sig, const S* tabk, const int* T_r, const S* bwd,
                    S* U, S* finalE, int R, int T_pad, int K, int ring,
                    double log_m1, double log_e2, cudaStream_t stream) {
  const size_t smem = tk_smem_bytes(K, ring, sizeof(S));
  cudaError_t err = launch_smem(tk_fwd_u_kernel<S, MAXT>, smem);
  if (err != cudaSuccess) return (int)err;
  tk_fwd_u_kernel<S, MAXT><<<R, K / ALPHA, smem, stream>>>(
      sig, tabk, T_r, bwd, U, finalE, R, T_pad, K, ring, S(log_m1), S(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int tk_fwd_u(const S* sig, const S* tabk, const int* T_r, const S* bwd,
             S* U, S* finalE, int R, int T_pad, int K, int A, int ring,
             double log_m1, double log_e2, cudaStream_t stream) {
  if (!tk_shape_ok(K, A) || ring < 1) return (int)cudaErrorInvalidValue;
  return K / A <= MAX_THREADS
             ? tk_fwd_u_launch<S, MAX_THREADS>(sig, tabk, T_r, bwd, U, finalE,
                                               R, T_pad, K, ring, log_m1,
                                               log_e2, stream)
             : tk_fwd_u_launch<S, TK_MAX_THREADS>(sig, tabk, T_r, bwd, U,
                                                  finalE, R, T_pad, K, ring,
                                                  log_m1, log_e2, stream);
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
                                  double log_m1, double log_e2,                \
                                  void* stream) {                              \
    return tk_bwd<S>(sig, tabk, T_r, bwd, R, T_pad, K, A, log_m1, log_e2,     \
                     (cudaStream_t)stream);                                    \
  }                                                                            \
  extern "C" int ntc_tk_fwd_u_##SUF(                                           \
      const S* sig, const S* tabk, const int* T_r, const S* bwd, S* U,        \
      S* finalE, int R, int T_pad, int K, int A, int ring, double log_m1,     \
      double log_e2, void* stream) {                                           \
    return tk_fwd_u<S>(sig, tabk, T_r, bwd, U, finalE, R, T_pad, K, A, ring,  \
                       log_m1, log_e2, (cudaStream_t)stream);                  \
  }

NTC_PRE_ENTRIES(float, f32)
NTC_PRE_ENTRIES(double, f64)
