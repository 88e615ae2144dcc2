// NTC lattice kernels for Hopper (sm_90a): the 5-state APSEI lattice of the
// batched resquiggle engine, templated on float and double.
//
//   ntc_tab_gather  replaces dynamont_tpu/ops/ntc_pallas.py::_tab_gather_packs_kernel
//   ntc_table_gather replaces dynamont_tpu/ops/ntc_pallas.py::_tab_gather_kernel
//   ntc_bwd         replaces dynamont_tpu/ops/ntc_pallas.py::_bwd_kernel
//   ntc_bwd_ckpt    replaces dynamont_tpu/ops/ntc_pallas.py::_bwd_ckpt_kernel
//   ntc_pv          replaces dynamont_tpu/ops/ntc_pallas.py::_pv_kernel
//   ntc_pv_ckpt     _pv_kernel's checkpoint branch (ckpt=True)
//   ntc_walk        replaces dynamont_tpu/ops/ntc_pallas.py::_walk_kernel
//   ntc_bwd_variant replaces scripts/probe_ntc_bwd_synth.py::variant_bwd and
//                   scripts/probe_ntc_bwd_variants.py::variant_bwd (probes)
//
// Plain-torch versions of all of them and the layouts of every argument are in
// ops/ntc_kernels.py (ops/ntc_batch.py and ops/ntc_walk.py hold the plain
// lattice); the wrappers there launch these through the extern "C" entries.
//
// Design. A bucket holds R reads; per (t, read) a column of CN n-slots x CK
// k-slots x 5 states. The TPU kernels lay reads x n-slots on sublanes and
// gather by one-hot MXU matmuls; here gathers index, and CN, CK, R are
// arguments, so the main rung (8, 128) and the wide rung (16, 256) run the
// same code.
//
// ntc_bwd and ntc_pv: one block per read, the t-loop inside the kernel,
// NT = threads(CN*CK) threads; thread b owns cells c = b, b+NT, ... (cell
// c = i*CK + j). A step has two phases. Phase 1: every cell's recurrence
// except the in-column I chain, reading the neighbouring column through
// the slot maps. Phase 2: one thread per k-slot j folds the I chain over
// the n-slots of its column, sequentially (ascending in the forward,
// descending in the backward) — the association order the plain version
// uses; the JAX scan runs the same maps as an associative scan. ntc_bwd at
// the main rung (bwd_shared_kernel) keeps rows t + 1 and t and a stage of
// row inputs, prefetched a row ahead, in shared memory; at the wide rung
// (bwd_kernel) it reads row t + 1 back from device memory (the backward
// store itself, written by the same block one step before);
// ops/ntc_kernels.bwd_instance picks the instance from the shape. ntc_pv keeps
// four columns (the previous and current forward and Viterbi columns): at
// the main rung (8, 128) they are 80 KB in fp32 and 160 KB in fp64, and
// its shared-column instance (pv_shared_kernel) holds them in shared
// memory with the backward column and its row inputs staged one row ahead;
// at the wide rung (16, 256) they are 320 KB in fp32, more than a block's
// 227 KB, and pv_kernel keeps them in a per-read device-memory double
// buffer (`scratch`), shared memory holding only what phase 2 needs from
// phase 1. ops/ntc_kernels.pv_instance picks the instance from the shape.
//
// The checkpointed route (the engine's wide rung, CK > 128): ntc_bwd_ckpt
// runs ntc_bwd's recurrence but keeps only the column entering each chunk
// of C = 8 rows and row 0 (1/8 of the store), the rows in between in a
// per-read double buffer; ntc_pv_ckpt re-derives each chunk's rows from
// its checkpoint before the chunk's forward. All three call one
// bwd_column, so the re-derived rows equal the full store's bit for bit;
// lp then goes to a buffer of its own, in the working dtype. These two
// one-block kernels are the route's "device" instances; its "cluster"
// instances (bwd_ckpt_cluster_kernel, pv_ckpt_cluster_kernel) split one
// read over a thread block cluster of G CTAs, each holding its slice of
// k-slots of every column in shared memory and gathering its peers'
// through distributed shared memory (their note below);
// ops/ntc_kernels.bwd_ckpt_instance and pv_ckpt_instance pick by shape.
//
// ntc_pv writes lp over the backward store when the wrapper passes the same
// buffer for both: each cell of row t is read (bwd) before it is written
// (lp), by the same thread or after a barrier. In fp32, lp is normalized
// by the column's own logsumexp: a block max, then the sum of exp(ap - max)
// in ntc_pre_kernels._tree_sum's order (block_sum), which the plain version
// repeats.
//
// ntc_walk: one block of two warps per read replays the traceback over the
// stored choices and predecessor slots, N_MICRO micro-steps per column:
// thread 0 walks rows staged in shared memory by warp 1, which also
// gathers lp and writes the records one chunk behind.
// ntc_tab_gather: one thread per k-mer index, writing every table row that
// index feeds. ntc_table_gather is the same gather without the pack layout:
// the 16 stacked rows of ops/ntc_batch.combined_tablesT at each index, in
// float32 (the TPU kernel splits the table into three bf16 terms for its
// one-hot matmul and recombines every value exactly; here a load is the
// value).
//
// What bounds them: ntc_bwd and ntc_pv are chains of T_pad dependent steps,
// each two or more block barriers and ~40 transcendental functions per cell
// (exp and log1p of every logaddexp); a bucket of 16 reads fills 16 of 132
// SMs. The operation count over the card's rate, and the stores written
// once over the memory rate, are both far below the chain's latency.
// ntc_pv_ckpt adds ntc_bwd's operations to ntc_pv's (the re-derivation)
// for 1/8 of the backward bytes.
// ntc_walk is its chain thread's dependent decode, a few hundred cycles a
// row, and at the wide rung the staged rows (24.7 KB a row at (16, 256))
// through the read's one SM. ntc_tab_gather and
// ntc_table_gather move bytes: 64 bytes written per index, coalesced along
// j; the table (64 KB at K = 1024) stays in L1/L2.
//
// Exactness: every expression rounds as the plain version does, op by op
// (built with -fmad=false, no fast math): scores c1 - (c2*d)*d,
// left-to-right sums, torch.logaddexp, the term-list logsumexps as max,
// exp summed in list order, log(sum) + max.

#include <cuda.h>  // CUtensorMap: ntc_walk's tensor copies
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntc_lattice_common.cuh"

namespace {

using namespace dynamont;

constexpr int MAX_THREADS = NTC_MAX_THREADS;
constexpr int NREC = 8;

// max and the first index attaining it over an ordered candidate list.
template <typename S, int N>
__device__ __forceinline__ S first_match(const S (&v)[N], int& code) {
  S m = v[0];
  code = 0;
#pragma unroll
  for (int q = 1; q < N; ++q) {
    if (v[q] > m) code = q;
    m = max_nan(m, v[q]);
  }
  return m;
}

// Block-wide max (exact in any order): warp butterflies, then the warps.
template <typename S>
__device__ S block_max(S v, S* red, int tid, int B) {
  if (B <= 32) {
    red[tid] = v;
    __syncthreads();
    S m = red[0];
    for (int w = 1; w < B; ++w) m = max_nan(m, red[w]);
    __syncthreads();
    return m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max_nan(v, __shfl_xor_sync(FULL_MASK, v, off));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  S m = red[0];
  for (int w = 1; w < (B >> 5); ++w) m = max_nan(m, red[w]);
  __syncthreads();
  return m;
}

// ---------------------------------------------------------------------------
// ntc_tab_gather: model parameters into the plan's slots (K11)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void tab_gather_kernel(const int* __restrict__ ks,
                                  const S* __restrict__ tab,
                                  S* __restrict__ mu_k, S* __restrict__ c1_k,
                                  S* __restrict__ c2_k, S* __restrict__ suc,
                                  S* __restrict__ nsl, int T, int R, int CN,
                                  int CK, int A, int K) {
  const int RCK = R * CK, RC2 = 2 * R * CN, J = RCK + RC2;
  const size_t total = (size_t)T * J;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(g / J), jj = (int)(g % J);
    const int v = ks[g];
    const bool live = v >= 0 && v < K;
    if (jj < RCK) {
      const int r = jj / CK, j = jj % CK;
      const size_t o = ((size_t)t * R + r) * CK + j;
      mu_k[o] = live ? tab[v] : S(0);
      c1_k[o] = live ? tab[(size_t)K + v] : S(0);
      c2_k[o] = live ? tab[2 * (size_t)K + v] : S(0);
      for (int s = 0; s < 3; ++s) {
        for (int a = 0; a < A; ++a) {
          const size_t os = (((size_t)t * 3 + s) * R + r) * A * CK + a * CK + j;
          suc[os] = live ? tab[(size_t)(3 + s * A + a) * K + v] : S(0);
        }
      }
    } else {
      const int q = jj - RCK;
      for (int s = 0; s < 3; ++s)
        nsl[((size_t)t * 3 + s) * RC2 + q] = live ? tab[(size_t)s * K + v] : S(0);
    }
  }
}

// ---------------------------------------------------------------------------
// ntc_table_gather: out[t, s, j] = tab[s, ks[t, j]] for the TG_ROWS stacked
// rows, 0 where ks[t, j] is outside [0, K) (#12)
// ---------------------------------------------------------------------------
constexpr int TG_ROWS = 16;

__global__ void table_gather_kernel(const int* __restrict__ ks,
                                    const float* __restrict__ tab,
                                    float* __restrict__ out, int T, int J,
                                    int K) {
  const size_t total = (size_t)T * J;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += (size_t)gridDim.x * blockDim.x) {
    const size_t t = g / J, j = g % J;
    const int v = ks[g];
    const bool live = v >= 0 && v < K;
    float* o = out + t * TG_ROWS * J + j;
#pragma unroll
    for (int s = 0; s < TG_ROWS; ++s)
      o[(size_t)s * J] = live ? tab[(size_t)s * K + v] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the backward column (ref: NTC.cpp:500-578), shared by ntc_bwd, ntc_bwd_ckpt
// and ntc_pv's checkpoint mode, so that all three round alike
// ---------------------------------------------------------------------------

// What the threads left out of bwd_column's phase 2 do meanwhile: nothing,
// or the caller's work, idle(i, n) on thread i of n.
struct NoIdle {
  __device__ void operator()(int, int) const {}
};

// Column t of read r into `o` (5, CN, CK) from column t + 1 at `nx`; the
// terminal column at t = T_r-1 and -inf past it (nx is then not read).
// Ends with a block barrier, so `o` is visible to the whole block.
// `in`'s arrays are read at row ti of read ri: (t, r) itself, or a staged
// copy of the read's rows (ntc_bwd_variant: R = 1, ti the row within the
// chunk, sig[ti - 1] the sample before it); t stays the global row.
// `idle` runs once a column before its last barrier: on the NT - CK
// threads that phase 2's I chains leave free (on all NT when there are
// none, and in a terminal or dead column).
template <typename S, typename Idle = NoIdle>
__device__ __forceinline__ void bwd_column_at(const BwdIn<S>& in, const S (&tl)[NTL],
                                              int t, int ti, int ri, int nm1, int tm1,
                                              const S* nx, S* o, unsigned char* smem,
                                              const Idle& idle = Idle()) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, CN = in.CN, CK = in.CK, A = in.A;
  const int NC = CN * CK, RC = R * CN;
  S* sE = reinterpret_cast<S*>(smem);
  S* sI = sE + NC;
  S* sB = sI + NC;
  S* sX = sB + NC;
  unsigned char* sOk = reinterpret_cast<unsigned char*>(sX + NC);
  const S NEG = neg_inf<S>();
  const size_t rt = (size_t)ti * R + ri;
  const unsigned char* al = in.allowed + rt * NC;
  const int* cn_t = in.cand_n + rt * CN;
  if (t >= tm1) {  // the terminal column, then dead rows
    for (int c = tid; c < NC; c += NT) {
      const S e = (t == tm1 && al[c] && cn_t[c / CK] == nm1) ? S(0) : NEG;
      for (int st = 0; st < 5; ++st) o[st * (size_t)NC + c] = st == ST_E ? e : NEG;
    }
    idle(tid, NT);
    __syncthreads();
    return;
  }
  const S* sig_r = in.sig + (size_t)ri * (in.T_pad - 1);
  const S x = sig_r[ti];
  const S xm = t > 0 ? sig_r[ti - 1] : S(0);
  const S* ns = in.nsl + (size_t)ti * 3 * 2 * RC;
  const S* sk = in.suc + (size_t)ti * 3 * R * A * CK;
  for (int c = tid; c < NC; c += NT) {
    const int i = c / CK, j = c % CK;
    const int cn = cn_t[i];
    const bool n_pos = cn >= 1, n_lt = cn < nm1;
    const int h = (int)in.hd[rt * NC + c];
    const S hd1 = S(-2.0) * S(h & 15), hd2 = S(-2.0) * S((h >> 4) & 15);
    const S hd1s = S((h >> 8) & 15), hd2s = S((h >> 12) & 15);
    const int q = ri * CN + i;
    const S mun2 = ns[RC + q], c1n2 = ns[2 * RC + RC + q], c2n2 = ns[4 * RC + RC + q];
    const S scn = sc_(x, ns[q], ns[2 * RC + q], ns[4 * RC + q]);
    const S scn2 = sc_(x, mun2, c1n2, c2n2);
    const size_t kj = rt * CK + j;
    const S muk = in.mu_k[kj], c1k = in.c1_k[kj], c2k = in.c2_k[kj];
    const S sck = sc_(x, muk, c1k, c2k);
    const S sc1 = (scn + sck) + hd1;
    const S sc2 = (scn2 + sck) + hd2;
    const int bs = in.brow_same[rt * CN + i], bn = in.brow_next[rt * CN + i];
    const int cs = in.bcol_same[kj];
    const S gskE = gat(nx, ST_E, bs, cs, CN, CK);
    const S gnkS = gat(nx, ST_S, bn, cs, CN, CK);
    const S a_new = n_pos ? gskE + sc1 : NEG;
    const S p_new = logaddexp(n_pos ? (gskE + tl[TE2]) + sc1 : NEG,
                              n_lt ? (gnkS + tl[TS1]) + sc2 : NEG);
    S s_t[1 + MAX_A], e_t[2 + 2 * MAX_A], i_t[1 + 2 * MAX_A];
    s_t[0] = n_pos ? (gskE + tl[TE3]) + sc1 : NEG;
    e_t[0] = n_pos ? (gskE + tl[TE4]) + sc1 : NEG;
    const int dd1 = in.d01[rt * CN + i], dd2 = in.d02[rt * CN + i];
#pragma unroll
    for (int ai = 0; ai < MAX_A; ++ai) {
      const int cu = in.bcol_suc[(rt * A + ai) * CK + j];
      const size_t so = (size_t)ri * A * CK + ai * CK + j;
      const S scs = sc_(x, sk[so], sk[(size_t)R * A * CK + so],
                        sk[2 * (size_t)R * A * CK + so]);
      const S m1 = dd1 != ai ? S(1) : S(0);
      const S m2 = dd2 != ai ? S(1) : S(0);
      const S sc1s = (scn + scs) - S(2.0) * (hd1s + m1);
      const S sc2s = (scn2 + scs) - S(2.0) * (hd2s + m2);
      const S gspP = n_pos ? gat(nx, ST_P, bs, cu, CN, CK) + sc1s : NEG;
      const S gnaA = n_lt ? gat(nx, ST_A, bn, cu, CN, CK) + sc2s : NEG;
      s_t[1 + ai] = gspP + tl[TP1];
      e_t[1 + 2 * ai] = gspP + tl[TP2];
      e_t[2 + 2 * ai] = gnaA + tl[TA1];
      i_t[2 * ai] = gspP + tl[TP3];
      i_t[2 * ai + 1] = gnaA + tl[TA2];
    }
    const S gnkS2 = gnkS + sc2;
    e_t[1 + 2 * MAX_A] = n_lt ? gnkS2 + tl[TS2] : NEG;
    i_t[2 * MAX_A] = n_lt ? gnkS2 + tl[TS3] : NEG;
    // same-t I chain coefficients (ref: NTC.cpp:565-572)
    const S sc_i = (sc_(xm, mun2, c1n2, c2n2) + sc_(xm, muk, c1k, c2k)) + hd2;
    const bool ok_i = t > 0 && i < CN - 1 && cn_t[i + 1] == cn + 1 && cn < nm1;
    const bool a = al[c];
    o[ST_A * (size_t)NC + c] = a ? a_new : NEG;
    o[ST_P * (size_t)NC + c] = a ? p_new : NEG;
    o[ST_S * (size_t)NC + c] = a ? lse(s_t) : NEG;
    sE[c] = lse(e_t);
    sI[c] = lse(i_t);
    sB[c] = ok_i ? tl[TI2] + sc_i : NEG;
    sX[c] = sc_i;
    sOk[c] = ok_i;
  }
  __syncthreads();
  // phase 2: the I chain of column j, from the last n-slot down; the E of
  // slot i adds the UPDATED I of slot i + 1
  for (int j = tid; j < CK; j += NT) {
    int c = (CN - 1) * CK + j;
    S below = sI[c];
    o[ST_I * (size_t)NC + c] = al[c] ? below : NEG;
    o[ST_E * (size_t)NC + c] = al[c] ? sE[c] : NEG;
    for (int i = CN - 2; i >= 0; --i) {
      c = i * CK + j;
      const S inew = logaddexp(sI[c], below + sB[c]);
      S e = sE[c];
      if (sOk[c]) e = logaddexp(e, (below + tl[TI1]) + sX[c]);
      o[ST_I * (size_t)NC + c] = al[c] ? inew : NEG;
      o[ST_E * (size_t)NC + c] = al[c] ? e : NEG;
      below = inew;
    }
  }
  if (NT <= CK) {
    idle(tid, NT);
  } else if (tid >= CK) {
    idle(tid - CK, NT - CK);
  }
  __syncthreads();
}

template <typename S>
__device__ __forceinline__ void bwd_column(const BwdIn<S>& in, const S (&tl)[NTL],
                                           int t, int r, int nm1, int tm1,
                                           const S* nx, S* o, unsigned char* smem) {
  bwd_column_at(in, tl, t, t, r, nm1, tm1, nx, o, smem);
}

template <typename S>
__device__ __forceinline__ void load_tl(S (&tl)[NTL], const S* tlog) {
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
}

// ---------------------------------------------------------------------------
// ntc_bwd: the backward lattice, every row stored; row t reads row t + 1 of
// the store, written by the same block one step before
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
bwd_kernel(BwdIn<S> in, const S* __restrict__ tlog, const int* __restrict__ N_r,
           const int* __restrict__ T_r, S* out) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x;
  S tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const size_t col = 5 * (size_t)in.CN * in.CK;
  for (int t = in.T_pad - 1; t >= 0; --t) {
    const size_t rt = (size_t)t * in.R + r;
    bwd_column(in, tl, t, r, nm1, tm1, out + (rt + in.R) * col, out + rt * col, smem);
  }
}

// ---------------------------------------------------------------------------
// ntc_bwd_ckpt: the backward lattice storing only the column that enters
// each chunk of C rows, ckpt[c] = row (c + 1) * C (-inf for the last chunk),
// and row 0; the rows between go through a per-read double buffer
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
bwd_ckpt_kernel(BwdIn<S> in, const S* __restrict__ tlog,
                const int* __restrict__ N_r, const int* __restrict__ T_r,
                S* ckpt, S* row0, S* scratch, int C) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  S tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const int R = in.R, nc = in.T_pad / C;
  const size_t col = 5 * (size_t)in.CN * in.CK;
  S* buf = scratch + (size_t)r * 2 * col;
  // nothing follows row T_pad - 1 (terminal or dead: `nx` is not read there)
  const S* nx = ckpt + ((size_t)(nc - 1) * R + r) * col;
  for (size_t c = tid; c < col; c += NT) ckpt[((size_t)(nc - 1) * R + r) * col + c] = neg_inf<S>();
  for (int t = in.T_pad - 1; t >= 0; --t) {
    S* o = t == 0          ? row0 + (size_t)r * col
           : t % C == 0    ? ckpt + ((size_t)(t / C - 1) * R + r) * col
                           : buf + (size_t)(t & 1) * col;
    bwd_column(in, tl, t, r, nm1, tm1, nx, o, smem);
    nx = o;
  }
}

// ---------------------------------------------------------------------------
// ntc_bwd_variant: K13's recurrence under the axes of the TPU probes
// scripts/probe_ntc_bwd_synth.py and probe_ntc_bwd_variants.py (#19, #20),
// for timing only: chunks of C rows, each staged into shared memory first
// (stage) or read from device memory as K13 reads them; chunks descending
// (reverse, K13's order) or ascending with the rows of a chunk descending
// (each row then reads the row visited just before it: wrong values, the
// TPU forward grid's access pattern); every row stored (full) or only row
// 0, the rows between in a per-read double buffer as in ntc_bwd_ckpt.
// Every row goes through bwd_column, so the reverse-order variants equal
// ntc_bwd bit for bit. Threads per read are the launch's (128-1024). The
// staged and the unstaged path each pass bwd_column_at a struct of their
// own (one instance each, STAGE). Do not merge them into one view that is
// either the kernel's input or the staged rows: nvcc 12.9 compiled that
// form so that the samples x and xm were read through the kernel
// parameter's sig pointer on both paths, and every staged row read the
// wrong samples (tools/staged_view_repro.py shows it).
// What bounds it: K13's chain of dependent columns; the probe measures how
// the chain's time moves with each axis.
// ---------------------------------------------------------------------------
// Copies rows t0 .. t0 + C - 1 of read r into `st` and returns the BwdIn
// view of them (R = 1, row ti = t - t0; sig[-1] is the sample before).
template <typename S>
__device__ __forceinline__ BwdIn<S> stage_rows(const BwdIn<S>& in, int r, int t0, int C,
                                               unsigned char* st) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, CN = in.CN, CK = in.CK, A = in.A;
  const int NC = CN * CK, RC = R * CN, ACK = A * CK;
  const StagePtrs<S> p = stage_ptrs<S>(st, C, CN, CK, A);
  const S* sig_r = in.sig + (size_t)r * (in.T_pad - 1);
  for (int i = tid; i <= C; i += NT) {  // sig[t0 - 1 + i]; none past T_pad - 2
    const int t = t0 - 1 + i;
    p.sig[i] = (t >= 0 && t < in.T_pad - 1) ? sig_r[t] : S(0);
  }
  for (int e = tid; e < C * CK; e += NT) {
    const int i = e / CK, j = e % CK;
    const size_t g = ((size_t)(t0 + i) * R + r) * CK + j;
    p.mu_k[e] = in.mu_k[g];
    p.c1_k[e] = in.c1_k[g];
    p.c2_k[e] = in.c2_k[g];
    p.bcol_same[e] = in.bcol_same[g];
  }
  for (int e = tid; e < C * 3 * ACK; e += NT) {
    const int i = e / (3 * ACK), s = (e / ACK) % 3, w = e % ACK;
    p.suc[e] = in.suc[(((size_t)(t0 + i) * 3 + s) * R + r) * ACK + w];
  }
  for (int e = tid; e < C * ACK; e += NT) {
    const int i = e / ACK, w = e % ACK;
    p.bcol_suc[e] = in.bcol_suc[((size_t)(t0 + i) * R + r) * ACK + w];
  }
  for (int e = tid; e < C * 6 * CN; e += NT) {
    const int i = e / (6 * CN), s = (e / (2 * CN)) % 3, o = (e / CN) % 2, n = e % CN;
    p.nsl[e] = in.nsl[((size_t)(t0 + i) * 3 + s) * 2 * RC + o * RC + r * CN + n];
  }
  for (int e = tid; e < C * CN; e += NT) {
    const int i = e / CN, n = e % CN;
    const size_t g = ((size_t)(t0 + i) * R + r) * CN + n;
    p.cand_n[e] = in.cand_n[g];
    p.brow_same[e] = in.brow_same[g];
    p.brow_next[e] = in.brow_next[g];
    p.d01[e] = in.d01[g];
    p.d02[e] = in.d02[g];
  }
  for (int e = tid; e < C * NC; e += NT) {
    const int i = e / NC, c = e % NC;
    const size_t g = ((size_t)(t0 + i) * R + r) * NC + c;
    p.hd[e] = in.hd[g];
    p.allowed[e] = in.allowed[g];
  }
  return stage_in(p, in.T_pad, CN, CK, A);
}

template <typename S, int MAXT, bool STAGE>
__global__ void __launch_bounds__(MAXT)
bwd_variant_kernel(BwdIn<S> in, const S* __restrict__ tlog,
                   const int* __restrict__ N_r, const int* __restrict__ T_r,
                   S* out, S* row0, S* scratch, int C, int reverse, int full) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  S tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const int R = in.R, nc = in.T_pad / C;
  const size_t col = 5 * (size_t)in.CN * in.CK;
  unsigned char* st = smem;
  unsigned char* csm = smem + (STAGE ? stage_bytes<S>(C, in.CN, in.CK, in.A) : 0);
  S* buf = scratch + (size_t)r * 2 * col;
  for (size_t c = tid; c < col; c += NT) buf[col + c] = neg_inf<S>();
  __syncthreads();
  const S* nx = buf + col;  // what the first row visited reads: -inf
  int k = 0;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = (reverse ? nc - 1 - ci : ci) * C;
    if constexpr (STAGE) {
      const BwdIn<S> view = stage_rows(in, r, t0, C, st);
      __syncthreads();
      for (int i = C - 1; i >= 0; --i, ++k) {
        const int t = t0 + i;
        S* o = full ? out + ((size_t)t * R + r) * col
               : t == 0 ? row0 + (size_t)r * col
                        : buf + (size_t)(k & 1) * col;
        bwd_column_at(view, tl, t, i, 0, nm1, tm1, nx, o, csm);
        nx = o;
      }
    } else {
      for (int i = C - 1; i >= 0; --i, ++k) {
        const int t = t0 + i;
        S* o = full ? out + ((size_t)t * R + r) * col
               : t == 0 ? row0 + (size_t)r * col
                        : buf + (size_t)(k & 1) * col;
        bwd_column(in, tl, t, r, nm1, tm1, nx, o, csm);
        nx = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ntc_bwd's shared-column instance (bwd_shared_kernel): the full store where
// its columns fit one block's shared memory, the main rung (CK <= 128, NC
// 1024) in fp32 and fp64. The same column function as bwd_kernel
// (bwd_column_at: the same arithmetic, the same store), with every operand
// of the chain in shared memory:
//   - rows t + 1 and t as two columns (2 x 5 x NC), so phase 1's gathers of
//     row t + 1 read shared memory; row t is written there;
//   - row t's plan inputs, parameters and samples (one staged row in
//     stage_bytes' layout) in one of two stages;
//   - bwd_column's phase 1 -> 2 scratch, as bwd_smem lays it out.
// Phase 2's I chains take CK of the NT threads; the other NT - CK copy row
// t + 1 to the device store (which K15 reads) and issue row t - 1's inputs
// (cp.async, 16-byte pieces; d01 and d02 in 4-byte ones) meanwhile, so
// neither costs the chain an instruction.
// 85632 bytes in fp32, 158720 in fp64 at (8, 128); bwd_shared_bytes counts
// them, ops/ntc_kernels.bwd_instance repeats the sum and picks this
// instance where it fits and NC % 16, CN % 4 and CK % 4 are 0 (the copies'
// sizes and alignment). At the wide rung (CK 256) the two columns alone are
// 160 KB in fp32, and bwd_kernel runs. The column function reads a BwdIn
// view built here from the stage's own shared pointers, never one that is
// the kernel's parameter on another path (see ntc_bwd_variant).
// ---------------------------------------------------------------------------
template <typename S>
__host__ __device__ inline size_t bwd_shared_bytes(int CN, int CK, int A) {
  const size_t NC = (size_t)CN * CK;
  return 2 * 5 * NC * sizeof(S) + al16(bwd_smem<S>((int)NC)) +
         2 * stage_bytes<S>(1, CN, CK, A);
}

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
bwd_shared_kernel(BwdIn<S> in, const S* __restrict__ tlog, const int* __restrict__ N_r,
                  const int* __restrict__ T_r, S* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, T_pad = in.T_pad, CN = in.CN, CK = in.CK, A = in.A;
  const int NC = CN * CK, RC = R * CN, ACK = A * CK;
  const size_t col = 5 * (size_t)NC;
  S* cols = reinterpret_cast<S*>(smem);  // [2][5][NC]: row t at cols + (t & 1) * col
  unsigned char* csm = smem + 2 * col * sizeof(S);
  unsigned char* stages = csm + al16(bwd_smem<S>(NC));
  const size_t stb = stage_bytes<S>(1, CN, CK, A);
  S tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const S* sig_r = in.sig + (size_t)r * (T_pad - 1);

  // row t's inputs into stage t & 1, on thread i of n: one group
  auto issue_row = [&](int t, int i, int n) {
    const StagePtrs<S> p = stage_ptrs<S>(stages + (t & 1) * stb, 1, CN, CK, A);
    const size_t rt = (size_t)t * R + r;
    if (i == 0) {  // sig[t - 1], sig[t]; a row that reads neither gets 0
      if (t > 0) {
        cp_async_elem(p.sig, sig_r + t - 1);
      } else {
        p.sig[0] = S(0);
      }
      if (t < T_pad - 1) {
        cp_async_elem(p.sig + 1, sig_r + t);
      } else {
        p.sig[1] = S(0);
      }
    }
    cp_async_rows(p.mu_k, in.mu_k + rt * CK, CK, i, n);
    cp_async_rows(p.c1_k, in.c1_k + rt * CK, CK, i, n);
    cp_async_rows(p.c2_k, in.c2_k + rt * CK, CK, i, n);
    for (int q = 0; q < 3; ++q)
      cp_async_rows(p.suc + q * ACK, in.suc + (((size_t)t * 3 + q) * R + r) * ACK, ACK, i,
                    n);
    for (int q = 0; q < 6; ++q)  // [mu, c1, c2][n, n2]
      cp_async_rows(p.nsl + q * CN,
                    in.nsl + (size_t)t * 6 * RC + (size_t)q * RC + (size_t)r * CN, CN, i,
                    n);
    cp_async_rows(p.cand_n, in.cand_n + rt * CN, CN, i, n);
    cp_async_rows(p.brow_same, in.brow_same + rt * CN, CN, i, n);
    cp_async_rows(p.brow_next, in.brow_next + rt * CN, CN, i, n);
    cp_async_rows(p.bcol_same, in.bcol_same + rt * CK, CK, i, n);
    cp_async_rows(p.bcol_suc, in.bcol_suc + rt * ACK, ACK, i, n);
    cp_async_rows(p.hd, in.hd + rt * NC, NC, i, n);
    cp_async_rows(p.allowed, in.allowed + rt * NC, NC, i, n);
    cp_async_elems(reinterpret_cast<int*>(p.d01),
                   reinterpret_cast<const int*>(in.d01 + rt * CN), CN / 4, i, n);
    cp_async_elems(reinterpret_cast<int*>(p.d02),
                   reinterpret_cast<const int*>(in.d02 + rt * CN), CN / 4, i, n);
    cp_async_commit();
  };
  // row t's column to the device store, on thread i of n
  auto copy_out = [&](int t, int i, int n) {
    const int4* src = reinterpret_cast<const int4*>(cols + (t & 1) * col);
    int4* dst = reinterpret_cast<int4*>(out + ((size_t)t * R + r) * col);
    for (size_t q = i; q < col * sizeof(S) / 16; q += n) dst[q] = src[q];
  };

  issue_row(T_pad - 1, tid, NT);
  for (int t = T_pad - 1; t >= 0; --t) {
    cp_async_wait_all();  // row t's inputs
    __syncthreads();      // visible to all; column t & 1 free (row t + 2 is stored)
    const BwdIn<S> view =
        stage_in(stage_ptrs<S>(stages + (t & 1) * stb, 1, CN, CK, A), T_pad, CN, CK, A);
    // row T_pad - 1 is terminal or dead, so the other column is not read
    // there; while phase 2 runs, the threads it leaves free prefetch row
    // t - 1's inputs (into the stage row t + 1 used) and store row t + 1
    bwd_column_at(view, tl, t, 0, 0, nm1, tm1, cols + ((t + 1) & 1) * col,
                  cols + (t & 1) * col, csm, [&](int i, int n) {
                    if (t > 0) issue_row(t - 1, i, n);
                    if (t + 1 < T_pad) copy_out(t + 1, i, n);
                  });
  }
  copy_out(0, tid, NT);
}

// ---------------------------------------------------------------------------
// one cell of K15's step at t > 0, phase 1 (ref: NTC.cpp:595-669): the
// forward states A, P, S, E (-inf where !ok) into f and the Viterbi states
// over fwd + bwd - Z into v, from the previous forward and Viterbi columns
// Fp and Vp through the slot maps (n-slots rs, rp; k-slots cs, cp), with
// the cell's score sc and backward values bwv (A, P, S, E); returns the
// choice word of A, P, S and E (first match on ties). Every instance of
// ntc_pv calls it, so they round alike.
// ---------------------------------------------------------------------------
template <typename S>
__device__ __forceinline__ int pv_cell(const S* Fp, const S* Vp, const S (&tl)[NTL],
                                       int rs, int rp, int cs, const int (&cp)[MAX_A],
                                       S sc, bool ok, const S (&bwv)[4], S Zr, int CN,
                                       int CK, S (&f)[4], S (&v)[4]) {
  const S NEG = neg_inf<S>();
  {
    S a_t[2 * MAX_A], p_t[3 * MAX_A];
#pragma unroll
    for (int a = 0; a < MAX_A; ++a) {
      a_t[2 * a] = gat(Fp, ST_E, rp, cp[a], CN, CK) + tl[TA1];
      a_t[2 * a + 1] = gat(Fp, ST_I, rp, cp[a], CN, CK) + tl[TA2];
      p_t[3 * a] = gat(Fp, ST_S, rs, cp[a], CN, CK) + tl[TP1];
      p_t[3 * a + 1] = gat(Fp, ST_E, rs, cp[a], CN, CK) + tl[TP2];
      p_t[3 * a + 2] = gat(Fp, ST_I, rs, cp[a], CN, CK) + tl[TP3];
    }
    const S s_t[3] = {gat(Fp, ST_P, rp, cs, CN, CK) + tl[TS1],
                      gat(Fp, ST_E, rp, cs, CN, CK) + tl[TS2],
                      gat(Fp, ST_I, rp, cs, CN, CK) + tl[TS3]};
    const S e_t[4] = {gat(Fp, ST_A, rs, cs, CN, CK),
                      gat(Fp, ST_P, rs, cs, CN, CK) + tl[TE2],
                      gat(Fp, ST_S, rs, cs, CN, CK) + tl[TE3],
                      gat(Fp, ST_E, rs, cs, CN, CK) + tl[TE4]};
    f[ST_A] = ok ? lse(a_t) + sc : NEG;
    f[ST_P] = ok ? lse(p_t) + sc : NEG;
    f[ST_S] = ok ? lse(s_t) + sc : NEG;
    f[ST_E] = ok ? lse(e_t) + sc : NEG;
  }
  // Viterbi over fwd + bwd - Z, first-match choices
  S ac[2 * MAX_A], pc[3 * MAX_A];
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
    ac[2 * a] = gat(Vp, ST_E, rp, cp[a], CN, CK);
    ac[2 * a + 1] = gat(Vp, ST_I, rp, cp[a], CN, CK);
    pc[3 * a] = gat(Vp, ST_E, rs, cp[a], CN, CK);
    pc[3 * a + 1] = gat(Vp, ST_S, rs, cp[a], CN, CK);
    pc[3 * a + 2] = gat(Vp, ST_I, rs, cp[a], CN, CK);
  }
  const S scand[3] = {gat(Vp, ST_E, rp, cs, CN, CK),
                      gat(Vp, ST_P, rp, cs, CN, CK),
                      gat(Vp, ST_I, rp, cs, CN, CK)};
  const S ecand[4] = {gat(Vp, ST_E, rs, cs, CN, CK),
                      gat(Vp, ST_A, rs, cs, CN, CK),
                      gat(Vp, ST_S, rs, cs, CN, CK),
                      gat(Vp, ST_P, rs, cs, CN, CK)};
  int ch_a, ch_p, ch_s, ch_e;
  const S mx[4] = {first_match(ac, ch_a), first_match(pc, ch_p),
                   first_match(scand, ch_s), first_match(ecand, ch_e)};
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const S lpst = (f[st] + bwv[st]) - Zr;
    v[st] = ok ? mx[st] + lpst : NEG;
  }
  return ch_e | (ch_a << 2) | (ch_p << 5) | (ch_s << 9);
}

// ---------------------------------------------------------------------------
// ntc_pv: forward, posteriors and the 5-state Viterbi (ref: NTC.cpp:595-669).
// CKPT (ntc_pv_ckpt): the backward rows come from ntc_bwd_ckpt's
// checkpoints instead of a full store: at the first row of each chunk of C
// rows the block re-derives the chunk's C rows from ckpt[chunk] with
// bwd_column into its own buffer `bbuf` (C, 5, CN, CK), from the last row
// down, so they equal ntc_bwd's rows bit for bit; bwd_column's shared
// memory aliases this kernel's (they are used one after the other).
// ---------------------------------------------------------------------------
template <typename S, bool CKPT>
__global__ void __launch_bounds__(MAX_THREADS)
pv_kernel(const S* __restrict__ sig, const int* __restrict__ cand_n,
          const unsigned char* __restrict__ allowed,
          const short* __restrict__ hd, const int* __restrict__ row_same,
          const int* __restrict__ row_prev, const int* __restrict__ col_same,
          const int* __restrict__ col_prec, const S* __restrict__ mu_k,
          const S* __restrict__ c1_k, const S* __restrict__ c2_k,
          const S* __restrict__ nsl, const S* __restrict__ tlog,
          const S* __restrict__ Z, const int* __restrict__ T_r,
          const S* bwd, S* lp, short* __restrict__ choices,
          int* __restrict__ slots, S* __restrict__ apEf,
          S* __restrict__ fwdEf, S* scratch, int R, int T_pad, int CN, int CK,
          int A, int slb, int normalize, BwdIn<S> bin,
          const int* __restrict__ N_r, const S* __restrict__ ckpt, S* bbuf,
          int C) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int NC = CN * CK, RC = R * CN;
  S* sF = reinterpret_cast<S*>(smem);  // forward E (masked), per cell
  S* sSc = sF + NC;                    // the cell's score
  S* sV = sSc + NC;                    // Viterbi E (masked)
  S* red = sV + NC;                    // [32] block max, [NT] block sum
  S* reds = red + 32;
  short* sCh = reinterpret_cast<short*>(reds + NT);  // choices of A, P, S, E
  unsigned char* sCond = reinterpret_cast<unsigned char*>(sCh + NC);
  unsigned char* sChI = sCond + NC;
  const S NEG = neg_inf<S>();
  S tl[NTL];
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
  const int tm1 = T_r[r] - 1;
  const S Zr = Z[r];
  const size_t col = 5 * (size_t)NC;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  S* buf = scratch + (size_t)r * 4 * col;  // [cur][forward | Viterbi]
  for (int c = tid; c < NC; c += NT) {
    apEf[(size_t)r * NC + c] = NEG;
    fwdEf[(size_t)r * NC + c] = NEG;
  }

  int nm1 = 0;
  S* bb = nullptr;
  if constexpr (CKPT) {
    nm1 = N_r[r] - 1;
    bb = bbuf + (size_t)r * C * col;
  }

  for (int t = 0; t < T_pad; ++t) {
    const int cur = t & 1;
    S* Fc = buf + (2 * cur) * col;
    S* Vc = Fc + col;
    const S* Fp = buf + (2 * (cur ^ 1)) * col;
    const S* Vp = Fp + col;
    const size_t rt = (size_t)t * R + r;
    const S* bw;
    if constexpr (CKPT) {
      if (t % C == 0) {
        __syncthreads();  // the last row's shared memory is free again
        const S* nx = ckpt + ((size_t)(t / C) * R + r) * col;
        for (int i = C - 1; i >= 0; --i) {
          bwd_column(bin, tl, t + i, r, nm1, tm1, nx, bb + (size_t)i * col, smem);
          nx = bb + (size_t)i * col;
        }
      }
      bw = bb + (size_t)(t % C) * col;
    } else {
      bw = bwd + rt * col;
    }
    S* lo = lp + rt * col;
    const unsigned char* al = allowed + rt * NC;
    const int* cn_t = cand_n + rt * CN;
    const S x = t > 0 ? sig_r[t - 1] : S(0);
    const S* ns = nsl + (size_t)t * 3 * 2 * RC;
    for (int c = tid; c < NC; c += NT) {
      const int i = c / CK, j = c % CK;
      const int cn = cn_t[i];
      const bool ok = al[c] && cn >= 1;
      const bool cond = ok && i > 0 && cn_t[i - 1] == cn - 1;
      S f[4], v[4], bwv[4];
#pragma unroll
      for (int st = 0; st < 4; ++st) bwv[st] = bw[st * (size_t)NC + c];
      S sc = S(0);
      int chp = 0;
      if (t == 0) {
        f[ST_A] = f[ST_P] = f[ST_S] = NEG;
        f[ST_E] = (cn == 0 && al[c]) ? S(0) : NEG;
      } else {
        const int q = r * CN + i;
        const size_t kj = rt * CK + j;
        sc = (sc_(x, ns[q], ns[2 * RC + q], ns[4 * RC + q])
              + sc_(x, mu_k[kj], c1_k[kj], c2_k[kj]))
             + S(-2.0) * S((int)hd[rt * NC + c] & 15);
        int cp[MAX_A];
#pragma unroll
        for (int a = 0; a < MAX_A; ++a) cp[a] = col_prec[(rt * A + a) * CK + j];
        chp = pv_cell(Fp, Vp, tl, row_same[rt * CN + i], row_prev[rt * CN + i],
                      col_same[kj], cp, sc, ok, bwv, Zr, CN, CK, f, v);
      }
      if (t == 0) {
#pragma unroll
        for (int st = 0; st < 4; ++st) v[st] = f[st];
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const S ap = f[st] + bwv[st];
        lo[st * (size_t)NC + c] = normalize ? ap : ap - Zr;
        Fc[st * (size_t)NC + c] = f[st];
        Vc[st * (size_t)NC + c] = v[st];
      }
      sF[c] = f[ST_E];
      sSc[c] = sc;
      sV[c] = v[ST_E];
      sCond[c] = cond;
      sCh[c] = (short)chp;
      if (t == tm1) {
        apEf[(size_t)r * NC + c] = v[ST_E];
        fwdEf[(size_t)r * NC + c] = f[ST_E];
      }
    }
    __syncthreads();
    // phase 2: the I chains of column j, ascending over the n-slots
    // (ref: NTC.cpp:474-477), forward then Viterbi
    for (int j = tid; j < CK; j += NT) {
      S fi = NEG, vi = NEG;
      for (int i = 0; i < CN; ++i) {
        const int c = i * CK + j;
        S fI = NEG, vI = NEG;
        int chi = 0;
        if (t > 0 && i > 0) {
          const bool cond = sCond[c];
          const S sc = sSc[c];
          const S iA = cond ? (sF[c - CK] + tl[TI1]) + sc : NEG;
          const S iB = cond ? tl[TI2] + sc : NEG;
          fI = logaddexp(iA, fi + iB);
        }
        const S apI = fI + bw[ST_I * (size_t)NC + c];
        const S lpI = apI - Zr;
        if (t > 0 && i > 0) {
          const bool cond = sCond[c];
          const S ve = sV[c - CK];
          chi = ve >= vi ? 0 : 1;  // E overrides I on ties (ref: NTC.cpp:884-893)
          const S viA = cond ? ve + lpI : NEG;
          const S viB = cond ? lpI : NEG;
          vI = max_nan(viA, vi + viB);
        }
        Fc[ST_I * (size_t)NC + c] = fI;
        Vc[ST_I * (size_t)NC + c] = vI;
        lo[ST_I * (size_t)NC + c] = normalize ? apI : lpI;
        sChI[c] = (unsigned char)chi;
        fi = fI;
        vi = vI;
      }
    }
    __syncthreads();
    // phase 3: fp32 columns normalized by their own logsumexp; the choice
    // and predecessor-slot words
    if (normalize) {
      S m = NEG;
      for (int st = 0; st < 5; ++st)
        for (int c = tid; c < NC; c += NT) m = max_nan(m, lo[st * (size_t)NC + c]);
      m = block_max(m, red, tid, NT);
      const bool fin = isfinite(m);
      const S ms = fin ? m : S(0);
      S acc = S(0);
      bool first = true;
      for (int st = 0; st < 5; ++st) {
        for (int c = tid; c < NC; c += NT) {
          const S e = exp_(lo[st * (size_t)NC + c] - ms);
          acc = first ? e : acc + e;
          first = false;
        }
      }
      const S tot = block_sum<MAX_THREADS>(acc, reds, tid, NT);
      const S colZ = ms + log_(tot);
      for (int st = 0; st < 5; ++st) {
        for (int c = tid; c < NC; c += NT) {
          const size_t o = st * (size_t)NC + c;
          lo[o] = fin ? lo[o] - colZ : NEG;
        }
      }
    }
    for (int c = tid; c < NC; c += NT) {
      const int j = c % CK;
      const int packed = (int)sCh[c] | ((int)sChI[c] << 11);
      choices[rt * NC + c] = (short)packed;
      const int ai_a = (packed >> 3) & 3, ai_p = ((packed >> 5) & 15) / 3;
      const size_t kj = rt * CK + j;
      slots[rt * NC + c] = (col_same[kj] + 1)
                           | ((col_prec[(rt * A + ai_a) * CK + j] + 1) << slb)
                           | ((col_prec[(rt * A + ai_p) * CK + j] + 1) << (2 * slb));
    }
  }
}

// ---------------------------------------------------------------------------
// ntc_pv's shared-column instance (pv_shared_kernel): the full-store mode
// where its columns fit one block's shared memory, the main rung (CK <= 128,
// NC 1024) in fp32 and fp64. The same step as pv_kernel<S, false>, the same
// arithmetic through pv_cell, with every operand of the chain in shared
// memory:
//   - the previous and current forward and Viterbi columns (4 x 5 x NC), so
//     phase 1's 54 gathers a cell and phase 2's I chain read shared memory;
//   - row t's plan inputs (cand_n, allowed, hd, row_same, row_prev,
//     col_same, col_prec, mu_k/c1_k/c2_k, the n-slots' parameters and the
//     sample) in one of two stages, PvStage; row t + 1's are copied in
//     (cp.async) while row t's phase 2, normalization and epilogue run;
//   - row t's backward column in one buffer: states A, P, S, E of row t + 1
//     are copied in once phase 1 of row t has read them (they land during
//     phase 2), state I once phase 2 has (it lands during the next phase 1);
//   - in fp32, the column's lp until it is normalized, then written once.
// The cell's score is recomputed in phase 2 from the stage instead of kept
// (the same expression, so the same value), and the I choice bit joins the
// choice word in place: the fp64 instance then fits (224864 of 232448
// bytes; fp32 141856). pv_shared_bytes counts the bytes;
// ops/ntc_kernels.pv_instance repeats it and picks this instance where it
// fits and NC is a multiple of 16 (the 16-byte copies of hd, allowed and
// the backward column). Every row reads the stage and the columns through
// this kernel's own shared pointers, never a pointer that is device memory
// on another path (nvcc 12.9 miscompiled such a view, see ntc_bwd_variant).
// ---------------------------------------------------------------------------
// Shared memory of pv_shared_kernel: the four columns [2][F | V][5][NC],
// the backward column [5][NC], in fp32 lp [5][NC] and the block reduction's
// [32 + NT], the choice words [NC], two stages.
template <typename S>
__host__ __device__ inline size_t pv_shared_bytes(int CN, int CK, int A, int NT) {
  const size_t col = 5 * (size_t)CN * CK;
  const size_t norm = sizeof(S) == 4 ? col * sizeof(S) + al16((32 + (size_t)NT) * sizeof(S)) : 0;
  return 5 * col * sizeof(S) + norm + al16((size_t)CN * CK * sizeof(short)) +
         2 * pv_stage_bytes<S>(CN, CK, A);
}

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
pv_shared_kernel(const S* __restrict__ sig, const int* __restrict__ cand_n,
                 const unsigned char* __restrict__ allowed,
                 const short* __restrict__ hd, const int* __restrict__ row_same,
                 const int* __restrict__ row_prev, const int* __restrict__ col_same,
                 const int* __restrict__ col_prec, const S* __restrict__ mu_k,
                 const S* __restrict__ c1_k, const S* __restrict__ c2_k,
                 const S* __restrict__ nsl, const S* __restrict__ tlog,
                 const S* __restrict__ Z, const int* __restrict__ T_r,
                 const S* bwd, S* lp, short* __restrict__ choices,
                 int* __restrict__ slots, S* __restrict__ apEf,
                 S* __restrict__ fwdEf, int R, int T_pad, int CN, int CK, int A,
                 int slb) {
  constexpr bool NORM = sizeof(S) == 4;  // fp32 columns are normalized
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int NC = CN * CK, RC = R * CN;
  const size_t col = 5 * (size_t)NC;
  S* cols = reinterpret_cast<S*>(smem);  // [2][forward | Viterbi][5][NC]
  S* bws = cols + 4 * col;                // the backward column [5][NC]
  S* lps = bws + col;                     // fp32: lp before normalization
  S* red = lps + (NORM ? col : 0);        // fp32: [32] block max, [NT] block sum
  short* sCh = reinterpret_cast<short*>(
      reinterpret_cast<unsigned char*>(red) + (NORM ? al16((32 + (size_t)NT) * sizeof(S)) : 0));
  unsigned char* stages = reinterpret_cast<unsigned char*>(sCh) + al16(NC * sizeof(short));
  const size_t stb = pv_stage_bytes<S>(CN, CK, A);
  const S NEG = neg_inf<S>();
  S tl[NTL];
  load_tl(tl, tlog);
  const int tm1 = T_r[r] - 1;
  const S Zr = Z[r];
  const S* sig_r = sig + (size_t)r * (T_pad - 1);

  // row t's plan inputs into stage t & 1 and its backward states A, P, S, E
  // into the buffer: one group
  auto issue_row = [&](int t) {
    const PvStage<S> s = pv_stage<S>(stages + (t & 1) * stb, CN, CK, A);
    const size_t rt = (size_t)t * R + r;
    cp_async_elems(s.cand_n, cand_n + rt * CN, CN, tid, NT);
    cp_async_elems(s.row_same, row_same + rt * CN, CN, tid, NT);
    cp_async_elems(s.row_prev, row_prev + rt * CN, CN, tid, NT);
    cp_async_elems(s.col_same, col_same + rt * CK, CK, tid, NT);
    cp_async_elems(s.col_prec, col_prec + rt * A * CK, A * CK, tid, NT);
    cp_async_rows(s.hd, hd + rt * NC, NC, tid, NT);
    cp_async_rows(s.allowed, allowed + rt * NC, NC, tid, NT);
    cp_async_elems(s.mu_k, mu_k + rt * CK, CK, tid, NT);
    cp_async_elems(s.c1_k, c1_k + rt * CK, CK, tid, NT);
    cp_async_elems(s.c2_k, c2_k + rt * CK, CK, tid, NT);
    const S* ns = nsl + (size_t)t * 6 * RC + (size_t)r * CN;
    for (int q = 0; q < 3; ++q)
      cp_async_elems(s.nsl + q * CN, ns + 2 * (size_t)q * RC, CN, tid, NT);
    if (tid == 0 && t > 0) cp_async_elem(s.x, sig_r + t - 1);
    cp_async_rows(bws, bwd + rt * col, 4 * (size_t)NC, tid, NT);
    cp_async_commit();
  };
  // row t's backward state I into the buffer: one group
  auto issue_bw_i = [&](int t) {
    cp_async_rows(bws + ST_I * (size_t)NC, bwd + ((size_t)t * R + r) * col + ST_I * (size_t)NC,
                  NC, tid, NT);
    cp_async_commit();
  };

  for (int c = tid; c < NC; c += NT) {
    apEf[(size_t)r * NC + c] = NEG;
    fwdEf[(size_t)r * NC + c] = NEG;
  }
  issue_row(0);
  issue_bw_i(0);
  for (int t = 0; t < T_pad; ++t) {
    const PvStage<S> s = pv_stage<S>(stages + (t & 1) * stb, CN, CK, A);
    S* Fc = cols + (2 * (t & 1)) * col;
    S* Vc = Fc + col;
    const S* Fp = cols + (2 * ((t & 1) ^ 1)) * col;
    const S* Vp = Fp + col;
    const size_t rt = (size_t)t * R + r;
    S* lo = lp + rt * col;
    cp_async_wait_group<1>();  // row t's group (its state I may still fly)
    __syncthreads();
    const S x = t > 0 ? s.x[0] : S(0);
    // phase 1: every cell but the I chain
    for (int c = tid; c < NC; c += NT) {
      const int i = c / CK, j = c % CK;
      const int cn = s.cand_n[i];
      const bool al = s.allowed[c];
      const bool ok = al && cn >= 1;
      S f[4], v[4], bwv[4];
#pragma unroll
      for (int st = 0; st < 4; ++st) bwv[st] = bws[st * (size_t)NC + c];
      int chp = 0;
      if (t == 0) {
        f[ST_A] = f[ST_P] = f[ST_S] = NEG;
        f[ST_E] = (cn == 0 && al) ? S(0) : NEG;
#pragma unroll
        for (int st = 0; st < 4; ++st) v[st] = f[st];
      } else {
        const S sc = (sc_(x, s.nsl[i], s.nsl[CN + i], s.nsl[2 * CN + i])
                      + sc_(x, s.mu_k[j], s.c1_k[j], s.c2_k[j]))
                     + S(-2.0) * S((int)s.hd[c] & 15);
        int cp[MAX_A];
#pragma unroll
        for (int a = 0; a < MAX_A; ++a) cp[a] = s.col_prec[a * CK + j];
        chp = pv_cell(Fp, Vp, tl, s.row_same[i], s.row_prev[i], s.col_same[j], cp,
                      sc, ok, bwv, Zr, CN, CK, f, v);
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const S ap = f[st] + bwv[st];
        if constexpr (NORM) {
          lps[st * (size_t)NC + c] = ap;
        } else {
          lo[st * (size_t)NC + c] = ap - Zr;
        }
        Fc[st * (size_t)NC + c] = f[st];
        Vc[st * (size_t)NC + c] = v[st];
      }
      sCh[c] = (short)chp;
      if (t == tm1) {
        apEf[(size_t)r * NC + c] = v[ST_E];
        fwdEf[(size_t)r * NC + c] = f[ST_E];
      }
    }
    cp_async_wait_group<0>();  // row t's state I
    __syncthreads();
    if (t + 1 < T_pad) issue_row(t + 1);
    // phase 2: the I chains of column j, ascending over the n-slots
    // (ref: NTC.cpp:474-477), forward then Viterbi
    for (int j = tid; j < CK; j += NT) {
      S fi = NEG, vi = NEG;
      for (int i = 0; i < CN; ++i) {
        const int c = i * CK + j;
        S fI = NEG, vI = NEG;
        int chi = 0;
        bool cond = false;
        if (t > 0 && i > 0) {
          const int cn = s.cand_n[i];
          cond = s.allowed[c] && cn >= 1 && s.cand_n[i - 1] == cn - 1;
          const S sc = (sc_(x, s.nsl[i], s.nsl[CN + i], s.nsl[2 * CN + i])
                        + sc_(x, s.mu_k[j], s.c1_k[j], s.c2_k[j]))
                       + S(-2.0) * S((int)s.hd[c] & 15);
          const S iA = cond ? (Fc[ST_E * (size_t)NC + c - CK] + tl[TI1]) + sc : NEG;
          const S iB = cond ? tl[TI2] + sc : NEG;
          fI = logaddexp(iA, fi + iB);
        }
        const S apI = fI + bws[ST_I * (size_t)NC + c];
        const S lpI = apI - Zr;
        if (t > 0 && i > 0) {
          const S ve = Vc[ST_E * (size_t)NC + c - CK];
          chi = ve >= vi ? 0 : 1;  // E overrides I on ties (ref: NTC.cpp:884-893)
          const S viA = cond ? ve + lpI : NEG;
          const S viB = cond ? lpI : NEG;
          vI = max_nan(viA, vi + viB);
        }
        Fc[ST_I * (size_t)NC + c] = fI;
        Vc[ST_I * (size_t)NC + c] = vI;
        if constexpr (NORM) {
          lps[ST_I * (size_t)NC + c] = apI;
        } else {
          lo[ST_I * (size_t)NC + c] = lpI;
        }
        sCh[c] = (short)((int)sCh[c] | (chi << 11));
        fi = fI;
        vi = vI;
      }
    }
    __syncthreads();
    if (t + 1 < T_pad) issue_bw_i(t + 1);
    // phase 3: fp32 columns normalized by their own logsumexp, written once
    if constexpr (NORM) {
      S m = NEG;
      for (int st = 0; st < 5; ++st)
        for (int c = tid; c < NC; c += NT) m = max_nan(m, lps[st * (size_t)NC + c]);
      m = block_max(m, red, tid, NT);
      const bool fin = isfinite(m);
      const S ms = fin ? m : S(0);
      S acc = S(0);
      bool first = true;
      for (int st = 0; st < 5; ++st) {
        for (int c = tid; c < NC; c += NT) {
          const S e = exp_(lps[st * (size_t)NC + c] - ms);
          acc = first ? e : acc + e;
          first = false;
        }
      }
      const S tot = block_sum<MAX_THREADS>(acc, red + 32, tid, NT);
      const S colZ = ms + log_(tot);
      for (int st = 0; st < 5; ++st) {
        for (int c = tid; c < NC; c += NT) {
          const size_t o = st * (size_t)NC + c;
          lo[o] = fin ? lps[o] - colZ : NEG;
        }
      }
    }
    // the choice and predecessor-slot words
    for (int c = tid; c < NC; c += NT) {
      const int j = c % CK;
      const int packed = (int)sCh[c];
      choices[rt * NC + c] = (short)packed;
      const int ai_a = (packed >> 3) & 3, ai_p = ((packed >> 5) & 15) / 3;
      slots[rt * NC + c] = (s.col_same[j] + 1)
                           | ((s.col_prec[ai_a * CK + j] + 1) << slb)
                           | ((s.col_prec[ai_p * CK + j] + 1) << (2 * slb));
    }
  }
}

// ---------------------------------------------------------------------------
// The checkpointed route's cluster instances (the engine's wide rung):
// bwd_ckpt_cluster_kernel (K14) and pv_ckpt_cluster_kernel (K15's
// checkpoint mode). One read runs on a thread block cluster of G CTAs on
// neighbouring SMs (grid R * G, cluster (G, 1, 1)); CTA g owns the k-slots
// [g*KS, (g+1)*KS), KS = CK / G, over all CN n-slots, and keeps its slice
// [5][CN][KS] of each column in its own shared memory. Phase 2's I chains
// run over the n-slots of one k-slot, so they stay inside one CTA; phase
// 1's gathers at any k-slot (10 a cell in the backward, 54 in the forward)
// read the owner's slice through distributed shared memory (mapa). One
// cluster barrier (barrier.cluster arrive.release / wait.acquire) ends
// each column: it publishes the column before any CTA reads it and frees
// the buffer the next-but-one column overwrites. Both kernels end with a
// cluster barrier, so no CTA exits while a peer reads its slice.
//
// What bounds them: the same chain of T_pad dependent columns as the
// one-block instances, whose column of CN x CK = 16 x 256 cells at the wide
// rung ran on one SM (~40 transcendental functions a cell); here G SMs
// share it, a cell a thread at G = 8, and the cluster barrier and remote
// gathers join the chain. A wide bucket of 8 reads fills 8 G SMs.
//
// Exactness: bwd_column_slice and pv_cell_cl repeat bwd_column_at's and
// pv_cell's arithmetic op for op (only the cell's slot and the gathers'
// address differ), so every cell rounds as the one-block instances and
// the plain versions; the other callers of bwd_column_at and pv_cell are
// untouched. K15's fp32 normalization keeps block_sum's order over
// threads(CN*CK) = B virtual threads: virtual thread b sums the flat
// column's elements b, b + B, ... in order; where CK divides B and KS is a
// multiple of 32, all of b's cells lie in k-slot b mod CK and each virtual
// warp in one CTA, so each CTA forms its virtual warps' sums in exactly
// the plain order and only the tree over the B/32 warp sums crosses the
// cluster (ops/ntc_kernels.pv_ckpt_instance keeps pv_kernel<S, true>
// where that fails, e.g. CK 272). The block max is order-free.
//
// Memory: K14 keeps rows t + 1 and t of its slice and bwd_column's
// scratch (29184 bytes in fp32, 57856 in fp64 at (16, 256), G = 8); the
// device double buffer of bwd_ckpt_kernel is gone, and the slice's
// checkpoint rows and row 0 are copied out by their owner. K15 keeps the
// four forward and Viterbi columns, the chunk's C re-derived backward rows
// and its checkpoint (C + 1 rows), in fp32 the column's lp before it is
// normalized, and bwd_column's scratch, which phase 1 -> 2's score, flags
// and choice words alias: 152320 bytes in fp32 at G = 8, 142080 in fp64 at
// G = 16 (at G = 8 the fp64 chunk alone is 180 KB). The chunk's rows are
// re-derived by bwd_column_slice, K14's column function, so they equal
// K14's rows bit for bit. ops/ntc_kernels.bwd_ckpt_instance and
// pv_ckpt_instance repeat the byte counts (bwd_ckpt_cluster_bytes,
// pv_ckpt_cluster_bytes) and pick G; each launch asks
// cudaOccupancyMaxActiveClusters whether one cluster of G CTAs with this
// shared memory fits the card and refuses the launch
// (cudaErrorInvalidClusterSize) where none does. Every column lives in
// shared memory on every path of these kernels, read through their own
// shared pointers or their peers' (never a view that is device memory on
// another path: the nvcc merged-view hazard, see ntc_bwd_variant).
// ---------------------------------------------------------------------------

// This CTA's place in its cluster: its k-slots [j0, j0 + KS); div is x /
// KS by umulhi with kdiv = ceil(2^32 / KS), exact for x below 2^16 (so is
// k-slot j's owner div(j) and slice cell lc's n-slot div(lc)).
struct Slice {
  int KS, j0, CN, CK;
  unsigned kdiv;
  __device__ int div(int x) const { return (int)__umulhi((unsigned)x, kdiv); }
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ Slice slice_of(int CN, int CK, unsigned kdiv) {
  const int KS = CK / (int)cluster_size();
  return Slice{KS, (int)cluster_rank() * KS, CN, CK, kdiv};
}

// Every thread of every CTA of the cluster arrives; what each wrote before
// is visible to all after (release / acquire at cluster scope). Also a
// block barrier.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster (every CTA lays its shared memory out alike).
template <typename S>
__device__ __forceinline__ const S* peer(const S* p, int rank) {
  unsigned long long q;
  asm("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(p), "r"(rank));
  return reinterpret_cast<const S*>(q);
}

// gat() over a column held as slices: state st at (row, col) from the
// slice of col's owner; -inf where either is -1.
template <typename S>
__device__ __forceinline__ S gat_cl(const S* colp, int st, int row, int col,
                                    const Slice& sl) {
  if (row < 0 || col < 0) return neg_inf<S>();
  const int g = sl.div(col);
  return *peer(colp + ((size_t)st * sl.CN + row) * sl.KS + (col - g * sl.KS), g);
}

// Slice cell lc = i * KS + jl is column cell c = i * CK + j0 + jl.
__device__ __forceinline__ int slice_cell(const Slice& sl, int lc) {
  const int i = sl.div(lc);
  return i * sl.CK + sl.j0 + (lc - i * sl.KS);
}

// Row t's inputs for one CTA's slice, staged in its shared memory: the
// k-slot arrays at its KS k-slots, the n-slot arrays at all CN. The
// backward reads all but row_same, row_prev, col_same and col_prec, which
// only K15's forward reads (K14 stages them as absent).
template <typename S>
struct SliceRow {
  S* sig;                  // [2] sig[t - 1], sig[t]; 0 where the row has none
  S* mu_k;                 // [KS]
  S* c1_k;                 // [KS]
  S* c2_k;                 // [KS]
  S* suc;                  // [3][A][KS]
  S* nsl;                  // [6][CN]: [mu, c1, c2][n, n2]
  int* cand_n;             // [CN]
  int* brow_same;          // [CN]
  int* brow_next;          // [CN]
  int* row_same;           // [CN]
  int* row_prev;           // [CN]
  int* bcol_same;          // [KS]
  int* col_same;           // [KS]
  int* bcol_suc;           // [A][KS]
  int* col_prec;           // [A][KS]
  short* hd;               // [CN][KS]
  unsigned char* allowed;  // [CN][KS]
  signed char* d01;        // [CN]
  signed char* d02;        // [CN]
};

template <typename S>
__host__ __device__ inline size_t slice_row_bytes(int CN, int KS, int A) {
  return al16((2 + 3 * (size_t)KS + 3 * (size_t)A * KS + 6 * (size_t)CN) * sizeof(S)) +
         al16((5 * (size_t)CN + 2 * (size_t)KS + 2 * (size_t)A * KS) * sizeof(int)) +
         al16((size_t)CN * KS * sizeof(short)) + al16((size_t)CN * KS + 2 * (size_t)CN);
}

template <typename S>
__device__ __forceinline__ SliceRow<S> slice_row(unsigned char* base, int CN, int KS, int A) {
  SliceRow<S> p;
  p.sig = reinterpret_cast<S*>(base);
  p.mu_k = p.sig + 2;
  p.c1_k = p.mu_k + KS;
  p.c2_k = p.c1_k + KS;
  p.suc = p.c2_k + KS;
  p.nsl = p.suc + 3 * A * KS;
  p.cand_n = reinterpret_cast<int*>(
      base + al16((2 + 3 * (size_t)KS + 3 * (size_t)A * KS + 6 * (size_t)CN) * sizeof(S)));
  p.brow_same = p.cand_n + CN;
  p.brow_next = p.brow_same + CN;
  p.row_same = p.brow_next + CN;
  p.row_prev = p.row_same + CN;
  p.bcol_same = p.row_prev + CN;
  p.col_same = p.bcol_same + KS;
  p.bcol_suc = p.col_same + KS;
  p.col_prec = p.bcol_suc + A * KS;
  p.hd = reinterpret_cast<short*>(reinterpret_cast<unsigned char*>(p.cand_n) +
                                  al16((5 * (size_t)CN + 2 * (size_t)KS + 2 * (size_t)A * KS) *
                                       sizeof(int)));
  p.allowed = reinterpret_cast<unsigned char*>(p.hd) + al16((size_t)CN * KS * sizeof(short));
  p.d01 = reinterpret_cast<signed char*>(p.allowed + (size_t)CN * KS);
  p.d02 = p.d01 + CN;
  return p;
}

// Row t's inputs of read r for the slice into `d`, on thread i of n, as
// cp.async copies of 4 or 8 bytes that the thread commits as one group and
// waits for before the barrier that publishes them; hd and allowed as
// 4-byte words where the slice's rows are whole words (KS even, KS a
// multiple of 4), else one load and store at a time. The forward's maps
// only where `fwd` gives them (K15: row_same, row_prev, col_same,
// col_prec).
template <typename S>
__device__ __forceinline__ void stage_slice_row(const BwdIn<S>& in, const int* const (&fwd)[4],
                                                int t, int r, const Slice& sl,
                                                const SliceRow<S>& d, int i, int n) {
  const int R = in.R, CN = in.CN, CK = in.CK, A = in.A, KS = sl.KS, j0 = sl.j0;
  const int NC = CN * CK, RC = R * CN;
  const size_t rt = (size_t)t * R + r;
  if (i == 0) {
    const S* sig_r = in.sig + (size_t)r * (in.T_pad - 1);
    if (t > 0) {
      cp_async_elem(d.sig, sig_r + t - 1);
    } else {
      d.sig[0] = S(0);
    }
    if (t < in.T_pad - 1) {
      cp_async_elem(d.sig + 1, sig_r + t);
    } else {
      d.sig[1] = S(0);
    }
  }
  for (int e = i; e < KS; e += n) {
    const size_t kj = rt * CK + j0 + e;
    cp_async_elem(d.mu_k + e, in.mu_k + kj);
    cp_async_elem(d.c1_k + e, in.c1_k + kj);
    cp_async_elem(d.c2_k + e, in.c2_k + kj);
    cp_async_elem(d.bcol_same + e, in.bcol_same + kj);
    if (fwd[2]) cp_async_elem(d.col_same + e, fwd[2] + kj);
  }
  for (int e = i; e < 3 * A * KS; e += n) {  // suc[s][a][jl]
    const int sa = sl.div(e);
    cp_async_elem(d.suc + e, in.suc + (((size_t)t * 3 + sa / A) * R + r) * A * CK +
                                 (sa % A) * CK + j0 + (e - sa * KS));
  }
  for (int e = i; e < A * KS; e += n) {
    const int a = sl.div(e);
    const size_t g = (rt * A + a) * CK + j0 + (e - a * KS);
    cp_async_elem(d.bcol_suc + e, in.bcol_suc + g);
    if (fwd[3]) cp_async_elem(d.col_prec + e, fwd[3] + g);
  }
  for (int e = i; e < 6 * CN; e += n) {  // [mu, c1, c2][n, n2]
    const int k = e / CN;
    cp_async_elem(d.nsl + e, in.nsl + (size_t)t * 6 * RC + (size_t)k * RC + (size_t)r * CN +
                                 (e - k * CN));
  }
  for (int e = i; e < CN; e += n) {
    const size_t g = rt * CN + e;
    cp_async_elem(d.cand_n + e, in.cand_n + g);
    cp_async_elem(d.brow_same + e, in.brow_same + g);
    cp_async_elem(d.brow_next + e, in.brow_next + g);
    if (fwd[0]) cp_async_elem(d.row_same + e, fwd[0] + g);
    if (fwd[1]) cp_async_elem(d.row_prev + e, fwd[1] + g);
  }
  if (CN % 4 == 0) {  // d01, d02: CN bytes a row, whole words
    for (int e = i; e < CN / 4; e += n) {
      cp_async_elem(reinterpret_cast<int*>(d.d01) + e,
                    reinterpret_cast<const int*>(in.d01 + rt * CN) + e);
      cp_async_elem(reinterpret_cast<int*>(d.d02) + e,
                    reinterpret_cast<const int*>(in.d02 + rt * CN) + e);
    }
  } else {
    for (int e = i; e < CN; e += n) {
      d.d01[e] = in.d01[rt * CN + e];
      d.d02[e] = in.d02[rt * CN + e];
    }
  }
  const short* hd = in.hd + rt * NC + j0;
  const unsigned char* al = in.allowed + rt * NC + j0;
  if (KS % 2 == 0) {  // hd: KS / 2 words a row
    for (int e = i; e < CN * KS / 2; e += n) {
      const int q = sl.div(2 * e);
      cp_async_elem(reinterpret_cast<int*>(d.hd) + e,
                    reinterpret_cast<const int*>(hd + (size_t)q * CK) + (e - q * KS / 2));
    }
  } else {
    for (int e = i; e < CN * KS; e += n) {
      const int q = sl.div(e);
      d.hd[e] = hd[(size_t)q * CK + (e - q * KS)];
    }
  }
  if (KS % 4 == 0) {  // allowed: KS / 4 words a row
    for (int e = i; e < CN * KS / 4; e += n) {
      const int q = sl.div(4 * e);
      cp_async_elem(reinterpret_cast<int*>(d.allowed) + e,
                    reinterpret_cast<const int*>(al + (size_t)q * CK) + (e - q * KS / 4));
    }
  } else {
    for (int e = i; e < CN * KS; e += n) {
      const int q = sl.div(e);
      d.allowed[e] = al[(size_t)q * CK + (e - q * KS)];
    }
  }
  cp_async_commit();
}

// bwd_column_at for the CTA's slice: column t into the slice `o`
// [5][CN][KS] from column t + 1, whose slices lie at `nx` in every CTA,
// with row t's inputs staged in `in` (stage_slice_row); the same
// arithmetic op for op, the cells and the scratch (bwd_smem(CN * KS))
// indexed by slice cell. `idle` as bwd_column_at's, on the NT - KS
// threads phase 2 leaves free. Ends with a cluster barrier.
template <typename S, typename Idle>
__device__ __forceinline__ void bwd_column_slice(const SliceRow<S>& in, int CN, int A,
                                                 const S (&tl)[NTL], int t, int nm1, int tm1,
                                                 const Slice& sl, const S* nx, S* o,
                                                 unsigned char* smem, const Idle& idle) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int KS = sl.KS, LNC = CN * KS;
  S* sE = reinterpret_cast<S*>(smem);
  S* sI = sE + LNC;
  S* sB = sI + LNC;
  S* sX = sB + LNC;
  unsigned char* sOk = reinterpret_cast<unsigned char*>(sX + LNC);
  const S NEG = neg_inf<S>();
  const unsigned char* al = in.allowed;
  const int* cn_t = in.cand_n;
  if (t >= tm1) {  // the terminal column, then dead rows
    for (int lc = tid; lc < LNC; lc += NT) {
      const S e = (t == tm1 && al[lc] && cn_t[sl.div(lc)] == nm1) ? S(0) : NEG;
      for (int st = 0; st < 5; ++st) o[st * (size_t)LNC + lc] = st == ST_E ? e : NEG;
    }
    idle(tid, NT);
    cluster_sync();
    return;
  }
  const S x = in.sig[1];
  const S xm = t > 0 ? in.sig[0] : S(0);
  const S* ns = in.nsl;
  const S* sk = in.suc;
  for (int lc = tid; lc < LNC; lc += NT) {
    const int i = sl.div(lc), jl = lc - i * KS;
    const int cn = cn_t[i];
    const bool n_pos = cn >= 1, n_lt = cn < nm1;
    const int h = (int)in.hd[lc];
    const S hd1 = S(-2.0) * S(h & 15), hd2 = S(-2.0) * S((h >> 4) & 15);
    const S hd1s = S((h >> 8) & 15), hd2s = S((h >> 12) & 15);
    const S mun2 = ns[CN + i], c1n2 = ns[3 * CN + i], c2n2 = ns[5 * CN + i];
    const S scn = sc_(x, ns[i], ns[2 * CN + i], ns[4 * CN + i]);
    const S scn2 = sc_(x, mun2, c1n2, c2n2);
    const S muk = in.mu_k[jl], c1k = in.c1_k[jl], c2k = in.c2_k[jl];
    const S sck = sc_(x, muk, c1k, c2k);
    const S sc1 = (scn + sck) + hd1;
    const S sc2 = (scn2 + sck) + hd2;
    const int bs = in.brow_same[i], bn = in.brow_next[i];
    const int cs = in.bcol_same[jl];
    const S gskE = gat_cl(nx, ST_E, bs, cs, sl);
    const S gnkS = gat_cl(nx, ST_S, bn, cs, sl);
    const S a_new = n_pos ? gskE + sc1 : NEG;
    const S p_new = logaddexp(n_pos ? (gskE + tl[TE2]) + sc1 : NEG,
                              n_lt ? (gnkS + tl[TS1]) + sc2 : NEG);
    S s_t[1 + MAX_A], e_t[2 + 2 * MAX_A], i_t[1 + 2 * MAX_A];
    s_t[0] = n_pos ? (gskE + tl[TE3]) + sc1 : NEG;
    e_t[0] = n_pos ? (gskE + tl[TE4]) + sc1 : NEG;
    const int dd1 = in.d01[i], dd2 = in.d02[i];
#pragma unroll
    for (int ai = 0; ai < MAX_A; ++ai) {
      const int cu = in.bcol_suc[ai * KS + jl];
      const int so = ai * KS + jl;
      const S scs = sc_(x, sk[so], sk[A * KS + so], sk[2 * A * KS + so]);
      const S m1 = dd1 != ai ? S(1) : S(0);
      const S m2 = dd2 != ai ? S(1) : S(0);
      const S sc1s = (scn + scs) - S(2.0) * (hd1s + m1);
      const S sc2s = (scn2 + scs) - S(2.0) * (hd2s + m2);
      const S gspP = n_pos ? gat_cl(nx, ST_P, bs, cu, sl) + sc1s : NEG;
      const S gnaA = n_lt ? gat_cl(nx, ST_A, bn, cu, sl) + sc2s : NEG;
      s_t[1 + ai] = gspP + tl[TP1];
      e_t[1 + 2 * ai] = gspP + tl[TP2];
      e_t[2 + 2 * ai] = gnaA + tl[TA1];
      i_t[2 * ai] = gspP + tl[TP3];
      i_t[2 * ai + 1] = gnaA + tl[TA2];
    }
    const S gnkS2 = gnkS + sc2;
    e_t[1 + 2 * MAX_A] = n_lt ? gnkS2 + tl[TS2] : NEG;
    i_t[2 * MAX_A] = n_lt ? gnkS2 + tl[TS3] : NEG;
    // same-t I chain coefficients (ref: NTC.cpp:565-572)
    const S sc_i = (sc_(xm, mun2, c1n2, c2n2) + sc_(xm, muk, c1k, c2k)) + hd2;
    const bool ok_i = t > 0 && i < CN - 1 && cn_t[i + 1] == cn + 1 && cn < nm1;
    const bool a = al[lc];
    o[ST_A * (size_t)LNC + lc] = a ? a_new : NEG;
    o[ST_P * (size_t)LNC + lc] = a ? p_new : NEG;
    o[ST_S * (size_t)LNC + lc] = a ? lse(s_t) : NEG;
    sE[lc] = lse(e_t);
    sI[lc] = lse(i_t);
    sB[lc] = ok_i ? tl[TI2] + sc_i : NEG;
    sX[lc] = sc_i;
    sOk[lc] = ok_i;
  }
  __syncthreads();
  // phase 2: the I chain of k-slot j, from the last n-slot down; the E of
  // slot i adds the UPDATED I of slot i + 1
  for (int jl = tid; jl < KS; jl += NT) {
    int lc = (CN - 1) * KS + jl;
    S below = sI[lc];
    o[ST_I * (size_t)LNC + lc] = al[lc] ? below : NEG;
    o[ST_E * (size_t)LNC + lc] = al[lc] ? sE[lc] : NEG;
    for (int i = CN - 2; i >= 0; --i) {
      lc = i * KS + jl;
      const S inew = logaddexp(sI[lc], below + sB[lc]);
      S e = sE[lc];
      if (sOk[lc]) e = logaddexp(e, (below + tl[TI1]) + sX[lc]);
      o[ST_I * (size_t)LNC + lc] = al[lc] ? inew : NEG;
      o[ST_E * (size_t)LNC + lc] = al[lc] ? e : NEG;
      below = inew;
    }
  }
  if (NT <= KS) {
    idle(tid, NT);
  } else if (tid >= KS) {
    idle(tid - KS, NT - KS);
  }
  cluster_sync();
}

// The slice `src` [5][CN][KS] into the device column `dst` (5, CN, CK).
template <typename S>
__device__ __forceinline__ void store_slice(const Slice& sl, const S* src, S* dst) {
  const int LNC = sl.CN * sl.KS;
  for (int lc = threadIdx.x; lc < LNC; lc += blockDim.x) {
    const int c = slice_cell(sl, lc);
    for (int st = 0; st < 5; ++st) dst[(size_t)st * sl.CN * sl.CK + c] = src[st * LNC + lc];
  }
}

// Shared memory of bwd_ckpt_cluster_kernel: rows t + 1 and t of the slice
// ([2][5][CN * KS]), bwd_column_slice's scratch and two staged rows.
template <typename S>
__host__ __device__ inline size_t bwd_ckpt_cluster_bytes(int CN, int KS, int A) {
  const size_t LNC = (size_t)CN * KS;
  return al16(2 * 5 * LNC * sizeof(S)) + al16(bwd_smem<S>((int)LNC)) +
         2 * slice_row_bytes<S>(CN, KS, A);
}

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
bwd_ckpt_cluster_kernel(BwdIn<S> in, const S* __restrict__ tlog,
                        const int* __restrict__ N_r, const int* __restrict__ T_r,
                        S* ckpt, S* row0, int C, unsigned kdiv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice sl = slice_of(in.CN, in.CK, kdiv);
  const int r = (int)cluster_index(), tid = threadIdx.x, NT = blockDim.x;
  const int CN = in.CN, A = in.A, LNC = CN * sl.KS;
  const size_t lcol = 5 * (size_t)LNC, col = 5 * (size_t)CN * in.CK;
  S* rows = reinterpret_cast<S*>(smem);  // row t at rows + (t & 1) * lcol
  unsigned char* csm = smem + al16(2 * lcol * sizeof(S));
  unsigned char* stages = csm + al16(bwd_smem<S>(LNC));  // row t's inputs in stage t & 1
  const size_t stb = slice_row_bytes<S>(CN, sl.KS, A);
  const int* const none[4] = {nullptr, nullptr, nullptr, nullptr};
  S tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const int R = in.R, T_pad = in.T_pad, nc = T_pad / C;
  S* last = ckpt + ((size_t)(nc - 1) * R + r) * col;  // nothing follows the last chunk
  for (int lc = tid; lc < LNC; lc += NT) {
    const int c = slice_cell(sl, lc);
    for (int st = 0; st < 5; ++st) last[(size_t)st * CN * in.CK + c] = neg_inf<S>();
  }
  auto stage = [&](int t) { return slice_row<S>(stages + (t & 1) * stb, CN, sl.KS, A); };
  stage_slice_row(in, none, T_pad - 1, r, sl, stage(T_pad - 1), tid, NT);
  cp_async_wait_all();
  __syncthreads();
  // row T_pad - 1 is terminal or dead, so the other buffer is not read
  // there; while phase 2 runs, the threads it leaves free stage row t - 1
  for (int t = T_pad - 1; t >= 0; --t) {
    S* o = rows + (t & 1) * lcol;
    bwd_column_slice(stage(t), CN, A, tl, t, nm1, tm1, sl, rows + ((t + 1) & 1) * lcol, o,
                     csm, [&](int i, int n) {
                       if (t > 0) {
                         stage_slice_row(in, none, t - 1, r, sl, stage(t - 1), i, n);
                         cp_async_wait_all();
                       }
                     });
    if (t == 0) {
      store_slice(sl, o, row0 + (size_t)r * col);
    } else if (t % C == 0) {
      store_slice(sl, o, ckpt + ((size_t)(t / C - 1) * R + r) * col);
    }
  }
  cluster_sync();  // no CTA leaves while a peer may read its slice
}

// The address, in the owner's shared memory, of state 0 of cell (row,
// col) of a column whose slices lie at `colp` in every CTA; null where
// either is -1.
template <typename S>
__device__ __forceinline__ const S* cell_cl(const S* colp, int row, int col,
                                            const Slice& sl) {
  if (row < 0 || col < 0) return nullptr;
  const int g = sl.div(col);
  return peer(colp + (size_t)row * sl.KS + (col - g * sl.KS), g);
}

// pv_cell over slices: the previous forward and Viterbi columns' slices
// at Fp and Vp = Fp + vo in every CTA, each of the cell's 10 (row, col)
// predecessors mapped once (cell_cl) and its states read from there;
// otherwise pv_cell op for op.
template <typename S>
__device__ __forceinline__ int pv_cell_cl(const S* Fp, size_t vo, const S (&tl)[NTL],
                                          int rs, int rp, int cs, const int (&cp)[MAX_A],
                                          S sc, bool ok, const S (&bwv)[4], S Zr,
                                          const Slice& sl, S (&f)[4], S (&v)[4]) {
  const S NEG = neg_inf<S>();
  const size_t ss = (size_t)sl.CN * sl.KS;  // one state of a slice
  const S* ps[MAX_A];  // (rs, cp[a])
  const S* pp[MAX_A];  // (rp, cp[a])
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
    ps[a] = cell_cl(Fp, rs, cp[a], sl);
    pp[a] = cell_cl(Fp, rp, cp[a], sl);
  }
  const S* qs = cell_cl(Fp, rs, cs, sl);
  const S* qp = cell_cl(Fp, rp, cs, sl);
  auto F = [&](const S* q, int st) { return q ? q[st * ss] : NEG; };
  auto V = [&](const S* q, int st) { return q ? q[vo + st * ss] : NEG; };
  {
    S a_t[2 * MAX_A], p_t[3 * MAX_A];
#pragma unroll
    for (int a = 0; a < MAX_A; ++a) {
      a_t[2 * a] = F(pp[a], ST_E) + tl[TA1];
      a_t[2 * a + 1] = F(pp[a], ST_I) + tl[TA2];
      p_t[3 * a] = F(ps[a], ST_S) + tl[TP1];
      p_t[3 * a + 1] = F(ps[a], ST_E) + tl[TP2];
      p_t[3 * a + 2] = F(ps[a], ST_I) + tl[TP3];
    }
    const S s_t[3] = {F(qp, ST_P) + tl[TS1], F(qp, ST_E) + tl[TS2], F(qp, ST_I) + tl[TS3]};
    const S e_t[4] = {F(qs, ST_A), F(qs, ST_P) + tl[TE2], F(qs, ST_S) + tl[TE3],
                      F(qs, ST_E) + tl[TE4]};
    f[ST_A] = ok ? lse(a_t) + sc : NEG;
    f[ST_P] = ok ? lse(p_t) + sc : NEG;
    f[ST_S] = ok ? lse(s_t) + sc : NEG;
    f[ST_E] = ok ? lse(e_t) + sc : NEG;
  }
  // Viterbi over fwd + bwd - Z, first-match choices
  S ac[2 * MAX_A], pc[3 * MAX_A];
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
    ac[2 * a] = V(pp[a], ST_E);
    ac[2 * a + 1] = V(pp[a], ST_I);
    pc[3 * a] = V(ps[a], ST_E);
    pc[3 * a + 1] = V(ps[a], ST_S);
    pc[3 * a + 2] = V(ps[a], ST_I);
  }
  const S scand[3] = {V(qp, ST_E), V(qp, ST_P), V(qp, ST_I)};
  const S ecand[4] = {V(qs, ST_E), V(qs, ST_A), V(qs, ST_S), V(qs, ST_P)};
  int ch_a, ch_p, ch_s, ch_e;
  const S mx[4] = {first_match(ac, ch_a), first_match(pc, ch_p),
                   first_match(scand, ch_s), first_match(ecand, ch_e)};
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const S lpst = (f[st] + bwv[st]) - Zr;
    v[st] = ok ? mx[st] + lpst : NEG;
  }
  return ch_e | (ch_a << 2) | (ch_p << 5) | (ch_s << 9);
}

// pv_ckpt_cluster_kernel's reduction area (fp32), by row parity p: the
// CTA's max [2] and warp sums [2][16], the column's max (0 where none is
// finite) and finiteness [2]; then the logsumexp, and the idle warps' maxes
// [16].
constexpr int RED_L = 0, RED_W = 2, RED_MS = RED_W + 2 * 16, RED_FIN = RED_MS + 2;
constexpr int RED_Z = RED_FIN + 2, RED_WMAX = RED_Z + 1, RED_VALS = RED_WMAX + 16;

// Shared memory of pv_ckpt_cluster_kernel: the four columns' slices
// [2][F | V][5][LNC], the chunk [C + 1][5][LNC], in fp32 four rows' lp
// [4][5][LNC] (a row is normalized over the three rows after it), the
// reduction area, bwd_column_slice's scratch or, aliasing it, phase 1 ->
// 2's score [LNC], choice words [LNC] and I-chain flags [LNC], and the
// chunk's C staged rows.
template <typename S>
__host__ __device__ inline size_t pv_ckpt_cluster_bytes(int CN, int KS, int A, int C) {
  const size_t LNC = (size_t)CN * KS, lcol = 5 * LNC;
  const size_t norm = sizeof(S) == 4 ? 4 * lcol * sizeof(S) : 0;
  const size_t bwd = bwd_smem<S>((int)LNC), fwd = LNC * (sizeof(S) + sizeof(short) + 1);
  return (4 + (size_t)C + 1) * lcol * sizeof(S) + norm + al16(RED_VALS * sizeof(S)) +
         al16(bwd > fwd ? bwd : fwd) + (size_t)C * slice_row_bytes<S>(CN, KS, A);
}

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
pv_ckpt_cluster_kernel(BwdIn<S> bin, const int* __restrict__ row_same,
                       const int* __restrict__ row_prev, const int* __restrict__ col_same,
                       const int* __restrict__ col_prec, const S* __restrict__ tlog,
                       const S* __restrict__ Z, const int* __restrict__ N_r,
                       const int* __restrict__ T_r, const S* __restrict__ ckpt, S* lp,
                       short* __restrict__ choices, int* __restrict__ slots,
                       S* __restrict__ apEf, S* __restrict__ fwdEf, int slb, int C,
                       unsigned kdiv) {
  constexpr bool NORM = sizeof(S) == 4;  // fp32 columns are normalized
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice sl = slice_of(bin.CN, bin.CK, kdiv);
  const int r = (int)cluster_index(), tid = threadIdx.x, NT = blockDim.x;
  const int R = bin.R, T_pad = bin.T_pad, CN = bin.CN, CK = bin.CK, A = bin.A;
  const int NC = CN * CK, KS = sl.KS, LNC = CN * KS;
  const size_t lcol = 5 * (size_t)LNC, col = 5 * (size_t)NC;
  S* cols = reinterpret_cast<S*>(smem);  // [2][forward | Viterbi][5][LNC]
  S* chunk = cols + 4 * lcol;            // rows t0 .. t0 + C - 1, then row t0 + C
  S* lpr = chunk + (C + 1) * lcol;       // fp32: row u's lp before normalization at u & 3
  S* red = lpr + (NORM ? 4 * lcol : 0);
  unsigned char* csm = reinterpret_cast<unsigned char*>(red) + al16(RED_VALS * sizeof(S));
  S* sSc = reinterpret_cast<S*>(csm);  // the cell's score
  short* sCh = reinterpret_cast<short*>(sSc + LNC);  // choice words
  unsigned char* sCond = reinterpret_cast<unsigned char*>(sCh + LNC);
  const size_t fwd_scratch = (size_t)LNC * (sizeof(S) + sizeof(short) + 1);
  unsigned char* stages = csm + al16(bwd_smem<S>(LNC) > fwd_scratch ? bwd_smem<S>(LNC)
                                                                    : fwd_scratch);
  const size_t stb = slice_row_bytes<S>(CN, KS, A);
  const int* const maps[4] = {row_same, row_prev, col_same, col_prec};
  const S NEG = neg_inf<S>();
  S tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const S Zr = Z[r];
  // fp32: block_sum's B virtual threads; here nv of them, virtual thread
  // q * CK + j0 + l as v = q * KS + l, whose cells are slice cells v,
  // v + nv, ... (see the note above)
  const int B = (NC & -NC) < MAX_THREADS ? (NC & -NC) : MAX_THREADS, nv = B / CK * KS;
  // fp32: the normalization of each row runs off the chain, a stage a row
  // on the threads phase 2 leaves free (idle thread i of n), each stage
  // published by the row's cluster barrier: in row t's phase 2, the tree
  // over row t - 3's warp sums and its lp; row t - 1's max over the slice;
  // row t - 2's sums (idle thread i < nv is virtual thread v = i)
  auto norm = [&](int t, int i, int n) {
    if (t >= 3 && t - 3 < T_pad) {
      const int u = t - 3, p = u & 1, nw = B / 32;
      if (i < 32) {
        // virtual warp w (threads 32w ..) is local warp ((32w / CK) * KS +
        // jw - j0) / 32 of the CTA owning k-slot jw = 32w mod CK
        S a = S(0);
        if (i < nw) {
          const int jw = (32 * i) % CK, g = sl.div(jw);
          a = *peer(red + RED_W + p * 16 + ((32 * i / CK) * KS + jw - g * KS) / 32, g);
        }
        for (int h = nw >> 1; h > 0; h >>= 1) a = a + __shfl_down_sync(FULL_MASK, a, h);
        if (i == 0) red[RED_Z] = red[RED_MS + p] + log_(a);
      }
      idle_sync(n);
      const S colZ = red[RED_Z];
      const bool fin = red[RED_FIN + p] != S(0);
      const S* lq = lpr + (u & 3) * lcol;
      S* lo = lp + ((size_t)u * R + r) * col;
      for (int lc = i; lc < LNC; lc += n) {
        const int c = slice_cell(sl, lc);
        for (int st = 0; st < 5; ++st)
          lo[(size_t)st * NC + c] = fin ? lq[st * LNC + lc] - colZ : NEG;
      }
    }
    if (t >= 1 && t - 1 < T_pad) {
      const S* lq = lpr + ((t - 1) & 3) * lcol;
      S m = NEG;
      for (int e = i; e < (int)lcol; e += n) m = max_nan(m, lq[e]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(FULL_MASK, m, off));
      if ((i & 31) == 0) red[RED_WMAX + i / 32] = m;
      idle_sync(n);
      if (i == 0) {
        for (int w = 1; w < n / 32; ++w) m = max_nan(m, red[RED_WMAX + w]);
        red[RED_L + ((t - 1) & 1)] = m;
      }
    }
    if (t >= 2 && t - 2 < T_pad && i < nv) {
      const int u = t - 2, p = u & 1;
      S mm = (i & 31) < (int)cluster_size() ? *peer(red + RED_L + p, i & 31) : NEG;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mm = max_nan(mm, __shfl_xor_sync(FULL_MASK, mm, off));
      const bool fin = isfinite(mm);
      const S ms = fin ? mm : S(0);
      if (i == 0) {
        red[RED_MS + p] = ms;
        red[RED_FIN + p] = fin ? S(1) : S(0);
      }
      const S* lq = lpr + (u & 3) * lcol;
      S acc = exp_(lq[i] - ms);
      for (int e = i + nv; e < (int)lcol; e += nv) acc = acc + exp_(lq[e] - ms);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc = acc + __shfl_down_sync(FULL_MASK, acc, off);
      if ((i & 31) == 0) red[RED_W + p * 16 + i / 32] = acc;
    }
  };
  for (int lc = tid; lc < LNC; lc += NT) {
    const int c = slice_cell(sl, lc);
    apEf[(size_t)r * NC + c] = NEG;
    fwdEf[(size_t)r * NC + c] = NEG;
  }
  // row t's inputs in stage t mod C, staged by the chunk's re-derivation
  auto stage = [&](int t) { return slice_row<S>(stages + (t % C) * stb, CN, KS, A); };

  for (int t = 0; t < T_pad; ++t) {
    const int cur = t & 1;
    S* Fc = cols + (2 * cur) * lcol;
    S* Vc = Fc + lcol;
    const S* Fp = cols + (2 * (cur ^ 1)) * lcol;  // Viterbi's at Fp + lcol
    if (t % C == 0) {
      // the chunk's rows from the checkpoint (row t + C), the last row
      // down, each staging the row below it on the threads phase 2 leaves
      // free; the forward then reads the same stages
      __syncthreads();  // the last row's stage and scratch are free
      const S* ck = ckpt + ((size_t)(t / C) * R + r) * col;
      stage_slice_row(bin, maps, t + C - 1, r, sl, stage(t + C - 1), tid, NT);
      for (int lc = tid; lc < LNC; lc += NT) {
        const int c = slice_cell(sl, lc);
        for (int st = 0; st < 5; ++st) chunk[C * lcol + st * LNC + lc] = ck[(size_t)st * NC + c];
      }
      cp_async_wait_all();
      cluster_sync();
      for (int i = C - 1; i >= 0; --i)
        bwd_column_slice(stage(t + i), CN, A, tl, t + i, nm1, tm1, sl, chunk + (i + 1) * lcol,
                         chunk + i * lcol, csm, [&](int q, int n) {
                           if (i > 0) {
                             stage_slice_row(bin, maps, t + i - 1, r, sl, stage(t + i - 1),
                                             q, n);
                             cp_async_wait_all();
                           }
                         });
    }
    const SliceRow<S> in = stage(t);
    const S* bw = chunk + (t % C) * lcol;
    const size_t rt = (size_t)t * R + r;
    S* lo = lp + rt * col;
    S* lps = lpr + (t & 3) * lcol;
    const int* cn_t = in.cand_n;
    const S x = in.sig[0];  // sig[t - 1]
    // phase 1: every cell but the I chain
    for (int lc = tid; lc < LNC; lc += NT) {
      const int i = sl.div(lc), jl = lc - i * KS;
      const int c = i * CK + sl.j0 + jl;
      const int cn = cn_t[i];
      const bool al = in.allowed[lc];
      const bool ok = al && cn >= 1;
      const bool cond = ok && i > 0 && cn_t[i - 1] == cn - 1;
      S f[4], v[4], bwv[4];
#pragma unroll
      for (int st = 0; st < 4; ++st) bwv[st] = bw[st * (size_t)LNC + lc];
      S sc = S(0);
      int chp = 0;
      if (t == 0) {
        f[ST_A] = f[ST_P] = f[ST_S] = NEG;
        f[ST_E] = (cn == 0 && al) ? S(0) : NEG;
      } else {
        sc = (sc_(x, in.nsl[i], in.nsl[2 * CN + i], in.nsl[4 * CN + i])
              + sc_(x, in.mu_k[jl], in.c1_k[jl], in.c2_k[jl]))
             + S(-2.0) * S((int)in.hd[lc] & 15);
        int cp[MAX_A];
#pragma unroll
        for (int a = 0; a < MAX_A; ++a) cp[a] = in.col_prec[a * KS + jl];
        chp = pv_cell_cl(Fp, lcol, tl, in.row_same[i], in.row_prev[i], in.col_same[jl], cp,
                         sc, ok, bwv, Zr, sl, f, v);
      }
      if (t == 0) {
#pragma unroll
        for (int st = 0; st < 4; ++st) v[st] = f[st];
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const S ap = f[st] + bwv[st];
        if constexpr (NORM) {
          lps[st * (size_t)LNC + lc] = ap;
        } else {
          lo[st * (size_t)NC + c] = ap - Zr;
        }
        Fc[st * (size_t)LNC + lc] = f[st];
        Vc[st * (size_t)LNC + lc] = v[st];
      }
      sSc[lc] = sc;
      sCond[lc] = cond;
      sCh[lc] = (short)chp;
      if (t == tm1) {
        apEf[(size_t)r * NC + c] = v[ST_E];
        fwdEf[(size_t)r * NC + c] = f[ST_E];
      }
    }
    __syncthreads();
    // phase 2: the I chains of k-slot j, ascending over the n-slots
    // (ref: NTC.cpp:474-477), forward then Viterbi
    for (int jl = tid; jl < KS; jl += NT) {
      S fi = NEG, vi = NEG;
      for (int i = 0; i < CN; ++i) {
        const int lc = i * KS + jl;
        S fI = NEG, vI = NEG;
        int chi = 0;
        if (t > 0 && i > 0) {
          const bool cond = sCond[lc];
          const S sc = sSc[lc];
          const S iA = cond ? (Fc[ST_E * (size_t)LNC + lc - KS] + tl[TI1]) + sc : NEG;
          const S iB = cond ? tl[TI2] + sc : NEG;
          fI = logaddexp(iA, fi + iB);
        }
        const S apI = fI + bw[ST_I * (size_t)LNC + lc];
        const S lpI = apI - Zr;
        if (t > 0 && i > 0) {
          const bool cond = sCond[lc];
          const S ve = Vc[ST_E * (size_t)LNC + lc - KS];
          chi = ve >= vi ? 0 : 1;  // E overrides I on ties (ref: NTC.cpp:884-893)
          const S viA = cond ? ve + lpI : NEG;
          const S viB = cond ? lpI : NEG;
          vI = max_nan(viA, vi + viB);
        }
        Fc[ST_I * (size_t)LNC + lc] = fI;
        Vc[ST_I * (size_t)LNC + lc] = vI;
        if constexpr (NORM) {
          lps[ST_I * (size_t)LNC + lc] = apI;
        } else {
          lo[ST_I * (size_t)NC + i * CK + sl.j0 + jl] = lpI;
        }
        sCh[lc] = (short)((int)sCh[lc] | (chi << 11));
        fi = fI;
        vi = vI;
      }
    }
    if constexpr (NORM) {
      if (tid >= KS) norm(t, tid - KS, NT - KS);
    }
    cluster_sync();  // column t complete in every CTA, the normalization's stages too
    // the choice and predecessor-slot words
    for (int lc = tid; lc < LNC; lc += NT) {
      const int i = sl.div(lc), jl = lc - i * KS, c = i * CK + sl.j0 + jl;
      const int packed = (int)sCh[lc];
      choices[rt * NC + c] = (short)packed;
      const int ai_a = (packed >> 3) & 3, ai_p = ((packed >> 5) & 15) / 3;
      slots[rt * NC + c] = (in.col_same[jl] + 1)
                           | ((in.col_prec[ai_a * KS + jl] + 1) << slb)
                           | ((in.col_prec[ai_p * KS + jl] + 1) << (2 * slb));
    }
  }
  if constexpr (NORM) {  // the last three rows' normalization
    for (int t = T_pad; t < T_pad + 3; ++t) {
      if (tid >= KS) norm(t, tid - KS, NT - KS);
      cluster_sync();
    }
  }
  cluster_sync();  // no CTA leaves while a peer may read its slice
}

// ---------------------------------------------------------------------------
// ntc_walk: the traceback (ref: NTC.cpp:691-904), one block of two warps
// per read
// ---------------------------------------------------------------------------
// A micro-step reads choices and slots at the walk's cell and row_same or
// row_prev at its n-slot, and the next cell depends on them: thread 0
// walks that chain over rows staged in shared memory, reverse chunks of C
// rows (walk_rows), and records each step's (state, cell, flags) and the
// record's chain fields (seg, n, k). Warp 1 stages chunk k + 1 and, for
// chunk k - 1's records, gathers lp at the cells of the steps that moved,
// takes exp_, and writes the records, while thread 0 walks chunk k (the
// split of banded_walk, csrc/nt_banded.cu). Chunk k holds rows hi =
// T_pad-1 - k*C down to lo = max(0, hi - C + 1), row t at index t - lo of
// each of its four arrays: choices (NC int16), slots (NC int32), row_same
// and row_prev (CN int32 each), each array's C rows one 128-byte aligned
// block. A micro-step that cannot move (the read inactive, t = 0, or
// did_t set outside I) loads nothing: every value it records is in
// registers, and no state changes; one that can moves by its state's case
// alone.
// Two instances stage the chunks (ops/ntc_kernels.walk_geometry's
// instance, by shape):
//   TMA: one tensor copy of each array a chunk (cp.async.bulk.tensor, a
//        box of C rows, counted on the stage's mbarrier), issued by one
//        lane: 4 requests a chunk. A warp of cp.async copies moves about
//        9 GB/s on one SM, a row of (8, 128) 6.2 KB: the copies, not the
//        chain, took the kernel's time.
//   copy: cp.async by warp 1's lanes, for shapes the tensor copies do not
//        take (rows of other than whole 16-byte pieces; only the rows the
//        walk can load, t <= T_r - 1 of a valid read).
constexpr int NTC_WALK_THREADS = 64;
constexpr int NTC_WALK_MAX_ROWS = 64;
constexpr size_t NTC_SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
// a step's record word: the state in bits 0-2, these flags, the cell above
constexpr int WALK_MOVED = 8, WALK_EMIT = 16, WALK_BREAK = 32, WALK_CELL_SHIFT = 6;

__host__ __device__ inline size_t al128(size_t b) { return (b + 127) & ~(size_t)127; }

// A stage of C rows: the offsets of its slots, row_same and row_prev
// blocks (choices at 0) and its bytes.
struct WalkStage {
  size_t sl, rs, rp, bytes;
};
__host__ __device__ inline WalkStage walk_stage(int CN, int CK, int C) {
  const size_t NC = (size_t)CN * CK, ch = al128(C * NC * sizeof(short));
  const size_t sl = al128(C * NC * sizeof(int)), m = al128((size_t)C * CN * sizeof(int));
  return {ch, ch + sl, ch + sl + m, ch + sl + 2 * m};
}
// two stages, two chunks of records [C][NM] (int4), the stages' mbarriers
__host__ __device__ inline size_t walk_smem_bytes(int CN, int CK, int NM, int C) {
  return 2 * walk_stage(CN, CK, C).bytes + 2 * (size_t)C * NM * sizeof(int4) +
         2 * sizeof(uint64_t);
}
// C: the most rows whose two stages fit, at most NTC_WALK_MAX_ROWS; 0 where
// not one does. ops/ntc_kernels.walk_geometry repeats it.
inline int walk_rows(int CN, int CK, int NM) {
  for (int C = NTC_WALK_MAX_ROWS; C > 0; --C)
    if (walk_smem_bytes(CN, CK, NM, C) <= NTC_SMEM_LIMIT) return C;
  return 0;
}
// The tensor copies take each array's row as whole 16-byte pieces, at most
// 256 eight-byte elements or a multiple of 256 (walk_map); ops/ntc_kernels
// .walk_geometry repeats the test.
inline bool walk_row_tma(size_t row_bytes) {
  const size_t w = row_bytes / 8;
  return row_bytes % 16 == 0 && (w <= 256 || w % 256 == 0);
}
inline bool walk_tma(int CN, int CK) {
  const size_t NC = (size_t)CN * CK;
  return walk_row_tma(NC * sizeof(short)) && walk_row_tma(NC * sizeof(int)) &&
         walk_row_tma((size_t)CN * sizeof(int));
}

// The tensor maps of the TMA instance, one an array (kernel parameter).
struct WalkMaps {
  CUtensorMap ch, sl, rs, rp;
};

// chunk rows [t0, t0 + C) of read r of the array of `m` into dst, counted
// on bar (coordinates: element, panel, read, row; walk_map)
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* m, int r, int t0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(m)), "r"(0), "r"(0), "r"(r),
        "r"(t0), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (even) from device to shared memory by the 32 lanes of a warp:
// 16-byte pieces where both ends and the size allow them, else 4-byte
// ones, else 2-byte loads and stores (choices rows of an odd NC).
__device__ __forceinline__ void walk_copy(unsigned char* dst, const void* src,
                                          size_t bytes, int lane) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const uintptr_t al = reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(s) | bytes;
  if ((al & 15) == 0) {
    for (size_t p = 16 * (size_t)lane; p < bytes; p += 16 * 32) cp_async16(dst + p, s + p);
  } else if ((al & 3) == 0) {
    for (size_t p = 4 * (size_t)lane; p < bytes; p += 4 * 32)
      cp_async_elem(reinterpret_cast<int*>(dst + p), reinterpret_cast<const int*>(s + p));
  } else {
    for (size_t p = 2 * (size_t)lane; p < bytes; p += 2 * 32)
      *reinterpret_cast<short*>(dst + p) = *reinterpret_cast<const short*>(s + p);
  }
}

// one record's NREC values, 32 (fp32) or 64 (fp64) aligned bytes
__device__ __forceinline__ void st_rec(float* p, const float (&o)[NREC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void st_rec(double* p, const double (&o)[NREC]) {
#pragma unroll
  for (int q = 0; q < NREC / 2; ++q)
    reinterpret_cast<double2*>(p)[q] = make_double2(o[2 * q], o[2 * q + 1]);
}

template <typename S, bool TMA>
__global__ void __launch_bounds__(NTC_WALK_THREADS)
walk_kernel(const S* __restrict__ lp, const short* __restrict__ choices,
            const int* __restrict__ slots, const int* __restrict__ row_same,
            const int* __restrict__ row_prev, const int* __restrict__ i0,
            const int* __restrict__ j0, const int* __restrict__ k0,
            const unsigned char* __restrict__ valid, const int* __restrict__ N_r,
            const int* __restrict__ T_r, S* __restrict__ rec, int* __restrict__ fin,
            int R, int T_pad, int CN, int CK, int K, int half, int S_max, int NM,
            int slb, int C, const __grid_constant__ WalkMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int h = tid - 32;  // lane in warp 1
  const int NC = CN * CK, SLM = (1 << slb) - 1, Kdiv = K >> 2;  // K / A, A = 4
  const WalkStage g = walk_stage(CN, CK, C);
  int4* recs = reinterpret_cast<int4*>(smem + 2 * g.bytes);  // [2][C * NM]
  uint64_t* bars = reinterpret_cast<uint64_t*>(recs + 2 * (size_t)C * NM);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const bool val = valid[r];
  const int last = val ? tm1 : -1;  // the walk loads rows t <= last only
  const int nchunks = (T_pad + C - 1) / C;
  auto hi_of = [&](int k) { return T_pad - 1 - k * C; };
  auto lo_of = [&](int k) { return hi_of(k) >= C ? hi_of(k) - C + 1 : 0; };

  auto issue = [&](int k) {  // warp 1: chunk k into stage k & 1
    const int hi = hi_of(k), lo = lo_of(k);
    unsigned char* st = smem + (k & 1) * g.bytes;
    if constexpr (TMA) {
      if (h == 0) {
        uint64_t* bar = bars + (k & 1);
        fence_proxy_async();
        mbar_expect(bar, (unsigned)(C * ((size_t)NC * (sizeof(short) + sizeof(int)) +
                                          2 * (size_t)CN * sizeof(int))));
        tma_rows(st, &maps.ch, r, lo, bar);
        tma_rows(st + g.sl, &maps.sl, r, lo, bar);
        tma_rows(st + g.rs, &maps.rs, r, lo, bar);
        tma_rows(st + g.rp, &maps.rp, r, lo, bar);
      }
    } else {
      for (int t = hi < last ? hi : last; t >= lo; --t) {
        const int q = t - lo;
        const size_t rt = (size_t)t * R + r;
        walk_copy(st + (size_t)q * NC * sizeof(short), choices + rt * NC,
                  (size_t)NC * sizeof(short), h);
        walk_copy(st + g.sl + (size_t)q * NC * sizeof(int), slots + rt * NC,
                  (size_t)NC * sizeof(int), h);
        walk_copy(st + g.rs + (size_t)q * CN * sizeof(int), row_same + rt * CN,
                  (size_t)CN * sizeof(int), h);
        walk_copy(st + g.rp + (size_t)q * CN * sizeof(int), row_prev + rt * CN,
                  (size_t)CN * sizeof(int), h);
      }
      cp_async_commit();
    }
  };
  auto emit_chunk = [&](int k) {  // warp 1: chunk k's records, lp gathered
    const int hi = hi_of(k), lo = lo_of(k);
    const int4* rc = recs + (size_t)(k & 1) * C * NM;
    for (int e = h; e < (hi - lo + 1) * NM; e += 32) {
      const int q = e / NM, m = e - q * NM, t = hi - q;
      const int4 v = rc[e];
      const int st = v.x & 7;
      const bool moved = v.x & WALK_MOVED, emit_ = v.x & WALK_EMIT;
      const bool emit_break = v.x & WALK_BREAK;
      S p = S(0);
      if (moved) p = exp_(lp[(((size_t)t * R + r) * 5 + st) * NC + (v.x >> WALK_CELL_SHIFT)]);
      const S o[NREC] = {p,
                         S(moved ? v.y : S_max),
                         S(emit_ ? 1 : 0),
                         S(st == ST_P ? 1 : 0),
                         S(emit_break ? half : v.z - 1 + half),
                         S(emit_break ? 0 : t - 1),
                         S(v.w),
                         S(emit_ ? v.y : S_max)};
      st_rec(rec + (((size_t)t * NM + m) * R + r) * NREC, o);
    }
  };

  if (h >= 0) {
    if constexpr (TMA) {
      if (h == 0) {
        mbar_init(bars);
        mbar_init(bars + 1);
        mbar_fence_init();
      }
      __syncwarp();
    }
    issue(0);
    if constexpr (!TMA) cp_async_wait_all();
  }
  __syncthreads();
  // thread 0's walk state and the read's start
  bool active = false, stuck = false;
  int state = 0, i = 0, j = 0, kw = 0, n = 0, seg = 0;
  const int i_start = i0[r], j_start = j0[r], k_start = k0[r];
  for (int k = 0; k <= nchunks; ++k) {
    if (h >= 0) {
      if (k + 1 < nchunks) issue(k + 1);
      if (k > 0) emit_chunk(k - 1);
      if constexpr (!TMA) cp_async_wait_all();
    } else if (tid == 0 && k < nchunks) {
      const int hi = hi_of(k), lo = lo_of(k);
      const unsigned char* st = smem + (k & 1) * g.bytes;
      if constexpr (TMA) mbar_wait(bars + (k & 1), (k >> 1) & 1);  // the chunk's rows
      int4* rc = recs + (size_t)(k & 1) * C * NM;
      for (int t = hi; t >= lo; --t) {
        const int q = hi - t;
        const short* ch_s = reinterpret_cast<const short*>(st) + (size_t)(t - lo) * NC;
        const int* sl_s = reinterpret_cast<const int*>(st + g.sl) + (size_t)(t - lo) * NC;
        const int* rs_s = reinterpret_cast<const int*>(st + g.rs) + (t - lo) * CN;
        const int* rp_s = reinterpret_cast<const int*>(st + g.rp) + (t - lo) * CN;
        if (t == tm1 && val) {
          active = true;
          state = ST_E;
          i = i_start;
          j = j_start;
          kw = k_start;
          n = nm1;
          seg = 0;
        }
        bool did_t = false;
        const bool t_pos = t >= 1;
        int m = 0;
        // the micro-steps that can move: active, t >= 1, and state I or no
        // t-step yet in this row; once one cannot, none after it can
        for (; m < NM && active && t_pos && (state == ST_I || !did_t); ++m) {
          int w = state;  // the record: the state before the step, its flags
          const int seg0 = seg, n0 = n, k0w = kw;
          const int c = i * CK + j;
          const int ch = (int)ch_s[c];
          const int slv = sl_s[c];
          const int row_i = (state == ST_E || state == ST_P ? rs_s : rp_s)[i];
          w |= c << WALK_CELL_SHIFT;
          const bool brk_row = t == 1;  // a t-step at row 1 breaks (closes the walk)
          auto clamp_i = [&](int v) { return v < 0 ? 0 : v > CN - 1 ? CN - 1 : v; };
          auto clamp_j = [&](int v) { return v < 0 ? 0 : v > CK - 1 ? CK - 1 : v; };
          // one case a state, the commonest first (a thread alone: no warp
          // to diverge; an if chain, not a jump table)
          if (state == ST_E) {
            if (brk_row) {
              w |= WALK_EMIT | WALK_BREAK;
              seg += 1;
              active = false;
            } else {
              const int chE = ch & 3;
              w |= WALK_MOVED;
              state = chE == 0 ? ST_E : chE == 1 ? ST_A : chE == 2 ? ST_S : ST_P;
              i = clamp_i(row_i);
              j = clamp_j((slv & SLM) - 1);
            }
            did_t = true;
          } else if (state == ST_A) {
            w |= WALK_EMIT;
            seg += 1;
            if (brk_row && n == 1) {
              w |= WALK_BREAK;
              active = false;
            } else {
              const int chA = (ch >> 2) & 7;
              w |= WALK_MOVED;
              state = (chA & 1) == 0 ? ST_E : ST_I;
              i = clamp_i(row_i);
              j = clamp_j(((slv >> slb) & SLM) - 1);
              kw = (kw >> 2) + (chA >> 1) * Kdiv;  // k / A, A = 4, k >= 0
              n -= 1;
            }
            did_t = true;
          } else if (state == ST_P) {
            w |= WALK_EMIT;
            seg += 1;
            if (brk_row) {
              w |= WALK_BREAK;
              active = false;
            } else {
              const int chP = (ch >> 5) & 15, ai = chP / 3, m3 = chP - ai * 3;
              w |= WALK_MOVED;
              state = m3 == 0 ? ST_E : m3 == 1 ? ST_S : ST_I;
              i = clamp_i(row_i);
              j = clamp_j(((slv >> (2 * slb)) & SLM) - 1);
              kw = (kw >> 2) + ai * Kdiv;
            }
            did_t = true;
          } else if (state == ST_I) {  // an in-column step, or the end at n = 1
            if (n == 1) {
              active = false;
            } else {
              w |= WALK_MOVED;
              state = ((ch >> 11) & 1) == 0 ? ST_E : ST_I;
              i = clamp_i(i - 1);
              n -= 1;
            }
          } else {  // ST_S: its break emits nothing
            if (brk_row && n == 1) {
              active = false;
            } else {
              const int chS = (ch >> 9) & 3;
              w |= WALK_MOVED;
              state = chS == 0 ? ST_E : chS == 1 ? ST_P : ST_I;
              i = clamp_i(row_i);
              j = clamp_j((slv & SLM) - 1);
              n -= 1;
            }
            did_t = true;
          }
          rc[q * NM + m] = make_int4(w, seg0, n0, k0w);
        }
        // the rest load nothing (NM <= 3: predicated stores, no loop)
        const int4 rest = make_int4(state, seg, n, kw);
        if (m < 1 && NM > 0) rc[q * NM] = rest;
        if (m < 2 && NM > 1) rc[q * NM + 1] = rest;
        if (m < 3 && NM > 2) rc[q * NM + 2] = rest;
        if (active && !did_t && t_pos) stuck = true;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    fin[2 * r] = seg;
    fin[2 * r + 1] = stuck ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------
template <typename S>
int tab_gather(const int* ks, const S* tab, S* mu_k, S* c1_k, S* c2_k, S* suc,
               S* nsl, int T, int R, int CN, int CK, int A, int K,
               cudaStream_t stream) {
  const size_t total = (size_t)T * (R * CK + 2 * R * CN);
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  tab_gather_kernel<S><<<blocks, threads, 0, stream>>>(
      ks, tab, mu_k, c1_k, c2_k, suc, nsl, T, R, CN, CK, A, K);
  return (int)cudaGetLastError();
}

int table_gather(const int* ks, const float* tab, float* out, int T, int J,
                 int K, cudaStream_t stream) {
  const size_t total = (size_t)T * J;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  table_gather_kernel<<<blocks, threads, 0, stream>>>(ks, tab, out, T, J, K);
  return (int)cudaGetLastError();
}

template <typename S>
int bwd(const BwdIn<S>& in, const S* tlog, const int* N_r, const int* T_r,
        S* out, int NT, int shared, cudaStream_t stream) {
  if (shared) {
    const size_t smem = bwd_shared_bytes<S>(in.CN, in.CK, in.A);
    cudaError_t err = launch_smem(bwd_shared_kernel<S>, smem);
    if (err != cudaSuccess) return (int)err;
    bwd_shared_kernel<S><<<in.R, NT, smem, stream>>>(in, tlog, N_r, T_r, out);
    return (int)cudaGetLastError();
  }
  const size_t smem = bwd_smem<S>(in.CN * in.CK);
  cudaError_t err = launch_smem(bwd_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<S><<<in.R, NT, smem, stream>>>(in, tlog, N_r, T_r, out);
  return (int)cudaGetLastError();
}

template <typename S>
int bwd_ckpt(const BwdIn<S>& in, const S* tlog, const int* N_r, const int* T_r,
             S* ckpt, S* row0, S* scratch, int NT, int C, cudaStream_t stream) {
  const size_t smem = bwd_smem<S>(in.CN * in.CK);
  cudaError_t err = launch_smem(bwd_ckpt_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_ckpt_kernel<S><<<in.R, NT, smem, stream>>>(in, tlog, N_r, T_r, ckpt, row0,
                                                 scratch, C);
  return (int)cudaGetLastError();
}

template <int MAXT, bool STAGE>
int bwd_variant_launch(const BwdIn<float>& in, const float* tlog, const int* N_r,
                       const int* T_r, float* out, float* row0, float* scratch,
                       int NT, int C, int reverse, int full, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err = launch_smem(bwd_variant_kernel<float, MAXT, STAGE>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_variant_kernel<float, MAXT, STAGE><<<in.R, NT, smem, stream>>>(
      in, tlog, N_r, T_r, out, row0, scratch, C, reverse, full);
  return (int)cudaGetLastError();
}

int bwd_variant(const BwdIn<float>& in, const float* tlog, const int* N_r,
                const int* T_r, float* out, float* row0, float* scratch, int NT,
                int C, int stage, int reverse, int full, cudaStream_t stream) {
  const size_t smem = (stage ? stage_bytes<float>(C, in.CN, in.CK, in.A) : 0) +
                      bwd_smem<float>(in.CN * in.CK);
  auto go = [&](auto launch) {
    return launch(in, tlog, N_r, T_r, out, row0, scratch, NT, C, reverse, full, smem, stream);
  };
  if (NT > 512)
    return stage ? go(bwd_variant_launch<1024, true>) : go(bwd_variant_launch<1024, false>);
  return stage ? go(bwd_variant_launch<512, true>) : go(bwd_variant_launch<512, false>);
}

template <typename S>
size_t pv_smem(int CN, int CK, int NT) {
  const size_t NC = (size_t)CN * CK;
  return (3 * NC + 32 + NT) * sizeof(S) + NC * sizeof(short) + 2 * NC;
}

template <typename S>
int pv(const S* sig, const int* cand_n, const unsigned char* allowed,
       const short* hd, const int* row_same, const int* row_prev,
       const int* col_same, const int* col_prec, const S* mu_k, const S* c1_k,
       const S* c2_k, const S* nsl, const S* tlog, const S* Z, const int* T_r,
       const S* bwd_in, S* lp, short* choices, int* slots, S* apEf, S* fwdEf,
       S* scratch, int R, int T_pad, int CN, int CK, int A, int NT, int slb,
       int shared, cudaStream_t stream) {
  if (shared) {
    const size_t smem = pv_shared_bytes<S>(CN, CK, A, NT);
    cudaError_t err = launch_smem(pv_shared_kernel<S>, smem);
    if (err != cudaSuccess) return (int)err;
    pv_shared_kernel<S><<<R, NT, smem, stream>>>(
        sig, cand_n, allowed, hd, row_same, row_prev, col_same, col_prec, mu_k,
        c1_k, c2_k, nsl, tlog, Z, T_r, bwd_in, lp, choices, slots, apEf, fwdEf,
        R, T_pad, CN, CK, A, slb);
    return (int)cudaGetLastError();
  }
  const size_t smem = pv_smem<S>(CN, CK, NT);
  cudaError_t err = launch_smem(pv_kernel<S, false>, smem);
  if (err != cudaSuccess) return (int)err;
  pv_kernel<S, false><<<R, NT, smem, stream>>>(
      sig, cand_n, allowed, hd, row_same, row_prev, col_same, col_prec, mu_k,
      c1_k, c2_k, nsl, tlog, Z, T_r, bwd_in, lp, choices, slots, apEf, fwdEf,
      scratch, R, T_pad, CN, CK, A, slb, sizeof(S) == 4 ? 1 : 0, BwdIn<S>{},
      nullptr, nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

template <typename S>
int pv_ckpt(const BwdIn<S>& bin, const int* row_same, const int* row_prev,
            const int* col_same, const int* col_prec, const S* tlog, const S* Z,
            const int* N_r, const int* T_r, const S* ckpt, S* lp, short* choices,
            int* slots, S* apEf, S* fwdEf, S* scratch, S* bbuf, int NT, int slb,
            int C, cudaStream_t stream) {
  const size_t a = pv_smem<S>(bin.CN, bin.CK, NT), b = bwd_smem<S>(bin.CN * bin.CK);
  const size_t smem = a > b ? a : b;
  cudaError_t err = launch_smem(pv_kernel<S, true>, smem);
  if (err != cudaSuccess) return (int)err;
  pv_kernel<S, true><<<bin.R, NT, smem, stream>>>(
      bin.sig, bin.cand_n, bin.allowed, bin.hd, row_same, row_prev, col_same,
      col_prec, bin.mu_k, bin.c1_k, bin.c2_k, bin.nsl, tlog, Z, T_r, nullptr, lp,
      choices, slots, apEf, fwdEf, scratch, bin.R, bin.T_pad, bin.CN, bin.CK,
      bin.A, slb, sizeof(S) == 4 ? 1 : 0, bin, N_r, ckpt, bbuf, C);
  return (int)cudaGetLastError();
}

// A cluster launch of `kernel`: R clusters of G CTAs of NT threads with
// `smem` bytes each, once cudaOccupancyMaxActiveClusters finds that such a
// cluster fits the card (cudaErrorInvalidClusterSize where none does).
// fit, when given, receives that count and nothing is launched.
template <typename... P, typename... Args>
int launch_cluster(void (*kernel)(P...), int R, int G, int NT, size_t smem,
                   cudaStream_t stream, int* fit, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && G > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * G);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit) {
    *fit = n;
    return 0;
  }
  if (n < 1) return (int)cudaErrorInvalidClusterSize;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ceil(2^32 / KS), Slice's divisor
inline unsigned slice_kdiv(int KS) {
  return (unsigned)((((unsigned long long)1 << 32) + KS - 1) / KS);
}

template <typename S>
int bwd_ckpt_cluster(const BwdIn<S>& in, const S* tlog, const int* N_r, const int* T_r,
                     S* ckpt, S* row0, int G, int NT, int C, cudaStream_t stream,
                     int* fit = nullptr) {
  const int KS = in.CK / G;
  return launch_cluster(bwd_ckpt_cluster_kernel<S>, in.R, G, NT,
                        bwd_ckpt_cluster_bytes<S>(in.CN, KS, in.A), stream, fit, in, tlog, N_r,
                        T_r, ckpt, row0, C, slice_kdiv(KS));
}

template <typename S>
int pv_ckpt_cluster(const BwdIn<S>& bin, const int* row_same, const int* row_prev,
                    const int* col_same, const int* col_prec, const S* tlog, const S* Z,
                    const int* N_r, const int* T_r, const S* ckpt, S* lp, short* choices,
                    int* slots, S* apEf, S* fwdEf, int G, int NT, int slb, int C,
                    cudaStream_t stream, int* fit = nullptr) {
  const int KS = bin.CK / G;
  return launch_cluster(pv_ckpt_cluster_kernel<S>, bin.R, G, NT,
                        pv_ckpt_cluster_bytes<S>(bin.CN, KS, bin.A, C), stream, fit, bin,
                        row_same, row_prev, col_same, col_prec, tlog, Z, N_r, T_r, ckpt,
                        lp, choices, slots, apEf, fwdEf, slb, C, slice_kdiv(KS));
}

// The TMA instance's map of an array of `row_bytes` bytes a (t, r), rows
// of C (t, r) a box: a row as (w, 1) or, above 256, (256, w / 256)
// eight-byte elements, then the reads, then the rows.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
cudaError_t walk_map(CUtensorMap* m, const void* base, size_t row_bytes, int R, int T_pad,
                     int C) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                              reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return cudaErrorNotSupported;
    }
  }
  const cuuint64_t w = row_bytes / 8, inner = w <= 256 ? w : 256;
  const cuuint64_t dims[4] = {inner, w / inner, (cuuint64_t)R, (cuuint64_t)T_pad};
  const cuuint64_t strides[3] = {inner * 8, row_bytes, (cuuint64_t)R * row_bytes};
  const cuuint32_t box[4] = {(cuuint32_t)inner, (cuuint32_t)(w / inner), 1, (cuuint32_t)C};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename S>
int walk(const S* lp, const short* choices, const int* slots,
         const int* row_same, const int* row_prev, const int* i0,
         const int* j0, const int* k0, const unsigned char* valid,
         const int* N_r, const int* T_r, S* rec, int* fin, int R, int T_pad,
         int CN, int CK, int A, int K, int half, int S_max, int NM, int slb,
         cudaStream_t stream) {
  const int C = walk_rows(CN, CK, NM);
  if (C < 1 || A != 4 || NM < 1 || NM > 3) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem_bytes(CN, CK, NM, C), NC = (size_t)CN * CK;
  WalkMaps maps = {};
  cudaError_t err;
  if (walk_tma(CN, CK)) {
    const uintptr_t al = reinterpret_cast<uintptr_t>(choices) |
                         reinterpret_cast<uintptr_t>(slots) |
                         reinterpret_cast<uintptr_t>(row_same) |
                         reinterpret_cast<uintptr_t>(row_prev);
    if (al & 15) return (int)cudaErrorMisalignedAddress;
    if ((err = walk_map(&maps.ch, choices, NC * sizeof(short), R, T_pad, C)) != cudaSuccess ||
        (err = walk_map(&maps.sl, slots, NC * sizeof(int), R, T_pad, C)) != cudaSuccess ||
        (err = walk_map(&maps.rs, row_same, CN * sizeof(int), R, T_pad, C)) != cudaSuccess ||
        (err = walk_map(&maps.rp, row_prev, CN * sizeof(int), R, T_pad, C)) != cudaSuccess)
      return (int)err;
    if ((err = launch_smem(walk_kernel<S, true>, smem)) != cudaSuccess) return (int)err;
    walk_kernel<S, true><<<R, NTC_WALK_THREADS, smem, stream>>>(
        lp, choices, slots, row_same, row_prev, i0, j0, k0, valid, N_r, T_r, rec, fin, R,
        T_pad, CN, CK, K, half, S_max, NM, slb, C, maps);
  } else {
    if ((err = launch_smem(walk_kernel<S, false>, smem)) != cudaSuccess) return (int)err;
    walk_kernel<S, false><<<R, NTC_WALK_THREADS, smem, stream>>>(
        lp, choices, slots, row_same, row_prev, i0, j0, k0, valid, N_r, T_r, rec, fin, R,
        T_pad, CN, CK, K, half, S_max, NM, slb, C, maps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// extern "C" entry points (ctypes); each returns cudaGetLastError() after the
// launch (0 = launched). Pointers are device pointers; stream is a
// cudaStream_t.
// ---------------------------------------------------------------------------
#define NTC_LATTICE_ENTRIES(S, SUF)                                           \
  extern "C" int ntc_tab_gather_##SUF(const int* ks, const S* tab, S* mu_k,   \
                                      S* c1_k, S* c2_k, S* suc, S* nsl, int T, \
                                      int R, int CN, int CK, int A, int K,     \
                                      void* stream) {                          \
    return tab_gather<S>(ks, tab, mu_k, c1_k, c2_k, suc, nsl, T, R, CN, CK, A, \
                         K, (cudaStream_t)stream);                             \
  }                                                                            \
  extern "C" int ntc_bwd_##SUF(                                                \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const S* mu_k, const S* c1_k, const S* c2_k,       \
      const S* suc, const S* nsl, const S* tlog, const int* N_r,              \
      const int* T_r, S* out, int R, int T_pad, int CN, int CK, int A, int NT, \
      int shared, void* stream) {                                              \
    const BwdIn<S> in{sig, cand_n, allowed, hd, d01, d02, brow_same,          \
                      brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,  \
                      nsl, R, T_pad, CN, CK, A};                              \
    return bwd<S>(in, tlog, N_r, T_r, out, NT, shared, (cudaStream_t)stream); \
  }                                                                            \
  extern "C" int ntc_bwd_ckpt_##SUF(                                           \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const S* mu_k, const S* c1_k, const S* c2_k,       \
      const S* suc, const S* nsl, const S* tlog, const int* N_r,              \
      const int* T_r, S* ckpt, S* row0, S* scratch, int R, int T_pad, int CN, \
      int CK, int A, int NT, int C, void* stream) {                           \
    const BwdIn<S> in{sig, cand_n, allowed, hd, d01, d02, brow_same,          \
                      brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,  \
                      nsl, R, T_pad, CN, CK, A};                              \
    return bwd_ckpt<S>(in, tlog, N_r, T_r, ckpt, row0, scratch, NT, C,        \
                       (cudaStream_t)stream);                                  \
  }                                                                            \
  extern "C" int ntc_pv_##SUF(                                                 \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const int* row_same, const int* row_prev,              \
      const int* col_same, const int* col_prec, const S* mu_k, const S* c1_k, \
      const S* c2_k, const S* nsl, const S* tlog, const S* Z, const int* T_r, \
      const S* bwd_in, S* lp, short* choices, int* slots, S* apEf, S* fwdEf,  \
      S* scratch, int R, int T_pad, int CN, int CK, int A, int NT, int slb,   \
      int shared, void* stream) {                                              \
    return pv<S>(sig, cand_n, allowed, hd, row_same, row_prev, col_same,      \
                 col_prec, mu_k, c1_k, c2_k, nsl, tlog, Z, T_r, bwd_in, lp,   \
                 choices, slots, apEf, fwdEf, scratch, R, T_pad, CN, CK, A,   \
                 NT, slb, shared, (cudaStream_t)stream);                       \
  }                                                                            \
  extern "C" int ntc_pv_ckpt_##SUF(                                            \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const S* mu_k, const S* c1_k, const S* c2_k,       \
      const S* suc, const S* nsl, const int* row_same, const int* row_prev,   \
      const int* col_same, const int* col_prec, const S* tlog, const S* Z,    \
      const int* N_r, const int* T_r, const S* ckpt, S* lp, short* choices,   \
      int* slots, S* apEf, S* fwdEf, S* scratch, S* bbuf, int R, int T_pad,   \
      int CN, int CK, int A, int NT, int slb, int C, void* stream) {          \
    const BwdIn<S> in{sig, cand_n, allowed, hd, d01, d02, brow_same,          \
                      brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,  \
                      nsl, R, T_pad, CN, CK, A};                              \
    return pv_ckpt<S>(in, row_same, row_prev, col_same, col_prec, tlog, Z,    \
                      N_r, T_r, ckpt, lp, choices, slots, apEf, fwdEf,        \
                      scratch, bbuf, NT, slb, C, (cudaStream_t)stream);        \
  }                                                                            \
  extern "C" int ntc_bwd_ckpt_cluster_##SUF(                                   \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const S* mu_k, const S* c1_k, const S* c2_k,       \
      const S* suc, const S* nsl, const S* tlog, const int* N_r,              \
      const int* T_r, S* ckpt, S* row0, int R, int T_pad, int CN, int CK,     \
      int A, int G, int NT, int C, void* stream) {                             \
    const BwdIn<S> in{sig, cand_n, allowed, hd, d01, d02, brow_same,          \
                      brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,  \
                      nsl, R, T_pad, CN, CK, A};                              \
    return bwd_ckpt_cluster<S>(in, tlog, N_r, T_r, ckpt, row0, G, NT, C,      \
                               (cudaStream_t)stream);                          \
  }                                                                            \
  extern "C" int ntc_pv_ckpt_cluster_##SUF(                                    \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const S* mu_k, const S* c1_k, const S* c2_k,       \
      const S* suc, const S* nsl, const int* row_same, const int* row_prev,   \
      const int* col_same, const int* col_prec, const S* tlog, const S* Z,    \
      const int* N_r, const int* T_r, const S* ckpt, S* lp, short* choices,   \
      int* slots, S* apEf, S* fwdEf, int R, int T_pad, int CN, int CK, int A, \
      int G, int NT, int slb, int C, void* stream) {                          \
    const BwdIn<S> in{sig, cand_n, allowed, hd, d01, d02, brow_same,          \
                      brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,  \
                      nsl, R, T_pad, CN, CK, A};                              \
    return pv_ckpt_cluster<S>(in, row_same, row_prev, col_same, col_prec,     \
                              tlog, Z, N_r, T_r, ckpt, lp, choices, slots,    \
                              apEf, fwdEf, G, NT, slb, C,                     \
                              (cudaStream_t)stream);                           \
  }                                                                            \
  /* into *fit: how many clusters of G CTAs of K14's (pv 0) or K15's        \
     checkpoint mode's (pv 1) cluster instance fit the card at once */       \
  extern "C" int ntc_ckpt_cluster_fit_##SUF(int pv, int CN, int CK, int A,   \
                                            int G, int NT, int C, int* fit) { \
    BwdIn<S> in{};                                                             \
    in.R = 1;                                                                  \
    in.CN = CN;                                                                \
    in.CK = CK;                                                                \
    in.A = A;                                                                  \
    if (pv)                                                                    \
      return pv_ckpt_cluster<S>(in, nullptr, nullptr, nullptr, nullptr,       \
                                nullptr, nullptr, nullptr, nullptr, nullptr,  \
                                nullptr, nullptr, nullptr, nullptr, nullptr,  \
                                G, NT, 0, C, 0, fit);                          \
    return bwd_ckpt_cluster<S>(in, nullptr, nullptr, nullptr, nullptr,        \
                               nullptr, G, NT, C, 0, fit);                     \
  }                                                                            \
  extern "C" int ntc_walk_##SUF(                                               \
      const S* lp, const short* choices, const int* slots,                    \
      const int* row_same, const int* row_prev, const int* i0, const int* j0, \
      const int* k0, const unsigned char* valid, const int* N_r,              \
      const int* T_r, S* rec, int* fin, int R, int T_pad, int CN, int CK,     \
      int A, int K, int half, int S_max, int NM, int slb, void* stream) {     \
    return walk<S>(lp, choices, slots, row_same, row_prev, i0, j0, k0, valid, \
                   N_r, T_r, rec, fin, R, T_pad, CN, CK, A, K, half, S_max,   \
                   NM, slb, (cudaStream_t)stream);                             \
  }

NTC_LATTICE_ENTRIES(float, f32)
NTC_LATTICE_ENTRIES(double, f64)

extern "C" int ntc_bwd_variant_f32(
    const float* sig, const int* cand_n, const unsigned char* allowed,
    const short* hd, const signed char* d01, const signed char* d02,
    const int* brow_same, const int* brow_next, const int* bcol_same,
    const int* bcol_suc, const float* mu_k, const float* c1_k, const float* c2_k,
    const float* suc, const float* nsl, const float* tlog, const int* N_r,
    const int* T_r, float* out, float* row0, float* scratch, int R, int T_pad,
    int CN, int CK, int A, int NT, int C, int stage, int reverse, int full,
    void* stream) {
  const BwdIn<float> in{sig, cand_n, allowed, hd, d01, d02, brow_same,
                        brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,
                        nsl, R, T_pad, CN, CK, A};
  return bwd_variant(in, tlog, N_r, T_r, out, row0, scratch, NT, C, stage,
                     reverse, full, (cudaStream_t)stream);
}

extern "C" int ntc_table_gather_f32(const int* ks, const float* tab,
                                    float* out, int T, int J, int K,
                                    void* stream) {
  return table_gather(ks, tab, out, T, J, K, (cudaStream_t)stream);
}
