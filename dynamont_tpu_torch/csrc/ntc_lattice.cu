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
// uses; the JAX scan runs the same maps as an associative scan. The
// neighbouring column is read from device memory: the backward store
// itself in ntc_bwd (row t+1, written by the same block one step before),
// a per-read double buffer in ntc_pv (`scratch`). A column is 20 KB in
// fp32 at (8, 128) but 160 KB in fp64 at (16, 256), and ntc_pv needs two
// (forward and Viterbi): they would not fit next to the chain scratch in
// 227 KB of shared memory, while L1 holds the recently written rows. Shared
// memory holds only what phase 2 needs from phase 1.
//
// The checkpointed route (the engine's wide rung, CK > 128): ntc_bwd_ckpt
// runs ntc_bwd's recurrence but keeps only the column entering each chunk
// of C = 8 rows and row 0 (1/8 of the store), the rows in between in a
// per-read double buffer; ntc_pv_ckpt re-derives each chunk's rows from
// its checkpoint before the chunk's forward. All three call one
// bwd_column, so the re-derived rows equal the full store's bit for bit;
// lp then goes to a buffer of its own, in the working dtype.
//
// ntc_pv writes lp over the backward store when the wrapper passes the same
// buffer for both: each cell of row t is read (bwd) before it is written
// (lp), by the same thread or after a barrier. In fp32, lp is normalized
// by the column's own logsumexp: a block max, then the sum of exp(ap - max)
// in ntc_pre_kernels._tree_sum's order (block_sum), which the plain version
// repeats.
//
// ntc_walk: one block of one thread per read replays the traceback over the
// stored choices and predecessor slots, N_MICRO micro-steps per column.
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
// ntc_walk is one thread's dependent loads. ntc_tab_gather and
// ntc_table_gather move bytes: 64 bytes written per index, coalesced along
// j; the table (64 KB at K = 1024) stays in L1/L2.
//
// Exactness: every expression rounds as the plain version does, op by op
// (built with -fmad=false, no fast math): scores c1 - (c2*d)*d,
// left-to-right sums, torch.logaddexp, the term-list logsumexps as max,
// exp summed in list order, log(sum) + max.

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

// What the backward column reads besides the neighbouring column: the plan's
// backward maps, K11's parameters, the signal and the read's sizes.
template <typename S>
struct BwdIn {
  const S* sig;
  const int* cand_n;
  const unsigned char* allowed;
  const short* hd;
  const signed char* d01;
  const signed char* d02;
  const int* brow_same;
  const int* brow_next;
  const int* bcol_same;
  const int* bcol_suc;
  const S* mu_k;
  const S* c1_k;
  const S* c2_k;
  const S* suc;
  const S* nsl;
  int R, T_pad, CN, CK, A;
};

// Shared memory bwd_column uses: phase 1 -> 2, E and I before the chain,
// the chain's I coefficient, sc_i and the chain mask.
template <typename S>
__host__ __device__ inline size_t bwd_smem(int NC) {
  return 4 * (size_t)NC * sizeof(S) + (size_t)NC;
}

// Column t of read r into `o` (5, CN, CK) from column t + 1 at `nx`; the
// terminal column at t = T_r-1 and -inf past it (nx is then not read).
// Ends with a block barrier, so `o` is visible to the whole block.
// `in`'s arrays are read at row ti of read ri: (t, r) itself, or a staged
// copy of the read's rows (ntc_bwd_variant: R = 1, ti the row within the
// chunk, sig[ti - 1] the sample before it); t stays the global row.
template <typename S>
__device__ __forceinline__ void bwd_column_at(const BwdIn<S>& in, const S (&tl)[NTL],
                                              int t, int ti, int ri, int nm1, int tm1,
                                              const S* nx, S* o, unsigned char* smem) {
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
__host__ __device__ inline size_t al16(size_t b) { return (b + 15) & ~(size_t)15; }

// Bytes of C staged rows of one read: the float parameters and C + 1
// samples, the int maps, hd, then allowed, d01 and d02 (each region
// 16-byte aligned); ops/ntc_probe_kernels.stage_bytes repeats the sum.
template <typename S>
__host__ __device__ inline size_t stage_bytes(int C, int CN, int CK, int A) {
  const size_t NC = (size_t)CN * CK;
  return al16(((size_t)C * (3 * CK + 3 * A * CK + 6 * CN) + C + 1) * sizeof(S)) +
         al16((size_t)C * (3 * CN + CK + A * CK) * sizeof(int)) +
         al16((size_t)C * NC * sizeof(short)) + al16((size_t)C * (NC + 2 * CN));
}

// Copies rows t0 .. t0 + C - 1 of read r into `st` and returns the BwdIn
// view of them (R = 1, row ti = t - t0; sig[-1] is the sample before).
template <typename S>
__device__ __forceinline__ BwdIn<S> stage_rows(const BwdIn<S>& in, int r, int t0, int C,
                                               unsigned char* st) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, CN = in.CN, CK = in.CK, A = in.A;
  const int NC = CN * CK, RC = R * CN, ACK = A * CK;
  S* mu_k = reinterpret_cast<S*>(st);
  S* c1_k = mu_k + (size_t)C * CK;
  S* c2_k = c1_k + (size_t)C * CK;
  S* suc = c2_k + (size_t)C * CK;
  S* nsl = suc + (size_t)C * 3 * ACK;
  S* sig = nsl + (size_t)C * 6 * CN;
  int* cand_n = reinterpret_cast<int*>(
      st + al16(((size_t)C * (3 * CK + 3 * ACK + 6 * CN) + C + 1) * sizeof(S)));
  int* brow_same = cand_n + (size_t)C * CN;
  int* brow_next = brow_same + (size_t)C * CN;
  int* bcol_same = brow_next + (size_t)C * CN;
  int* bcol_suc = bcol_same + (size_t)C * CK;
  short* hd = reinterpret_cast<short*>(
      reinterpret_cast<unsigned char*>(cand_n) + al16((size_t)C * (3 * CN + CK + ACK) * sizeof(int)));
  unsigned char* allowed = reinterpret_cast<unsigned char*>(hd) + al16((size_t)C * NC * sizeof(short));
  signed char* d01 = reinterpret_cast<signed char*>(allowed + (size_t)C * NC);
  signed char* d02 = d01 + (size_t)C * CN;
  const S* sig_r = in.sig + (size_t)r * (in.T_pad - 1);
  for (int i = tid; i <= C; i += NT) {  // sig[t0 - 1 + i]; none past T_pad - 2
    const int t = t0 - 1 + i;
    sig[i] = (t >= 0 && t < in.T_pad - 1) ? sig_r[t] : S(0);
  }
  for (int e = tid; e < C * CK; e += NT) {
    const int i = e / CK, j = e % CK;
    const size_t g = ((size_t)(t0 + i) * R + r) * CK + j;
    mu_k[e] = in.mu_k[g];
    c1_k[e] = in.c1_k[g];
    c2_k[e] = in.c2_k[g];
    bcol_same[e] = in.bcol_same[g];
  }
  for (int e = tid; e < C * 3 * ACK; e += NT) {
    const int i = e / (3 * ACK), s = (e / ACK) % 3, w = e % ACK;
    suc[e] = in.suc[(((size_t)(t0 + i) * 3 + s) * R + r) * ACK + w];
  }
  for (int e = tid; e < C * ACK; e += NT) {
    const int i = e / ACK, w = e % ACK;
    bcol_suc[e] = in.bcol_suc[((size_t)(t0 + i) * R + r) * ACK + w];
  }
  for (int e = tid; e < C * 6 * CN; e += NT) {
    const int i = e / (6 * CN), s = (e / (2 * CN)) % 3, o = (e / CN) % 2, n = e % CN;
    nsl[e] = in.nsl[((size_t)(t0 + i) * 3 + s) * 2 * RC + o * RC + r * CN + n];
  }
  for (int e = tid; e < C * CN; e += NT) {
    const int i = e / CN, n = e % CN;
    const size_t g = ((size_t)(t0 + i) * R + r) * CN + n;
    cand_n[e] = in.cand_n[g];
    brow_same[e] = in.brow_same[g];
    brow_next[e] = in.brow_next[g];
    d01[e] = in.d01[g];
    d02[e] = in.d02[g];
  }
  for (int e = tid; e < C * NC; e += NT) {
    const int i = e / NC, c = e % NC;
    const size_t g = ((size_t)(t0 + i) * R + r) * NC + c;
    hd[e] = in.hd[g];
    allowed[e] = in.allowed[g];
  }
  return BwdIn<S>{sig + 1, cand_n, allowed, hd, d01, d02, brow_same, brow_next,
                  bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc, nsl, 1, in.T_pad,
                  CN, CK, A};
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
      S f[4], v[4];
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
        const int rs = row_same[rt * CN + i], rp = row_prev[rt * CN + i];
        const int cs = col_same[kj];
        int cp[MAX_A];
#pragma unroll
        for (int a = 0; a < MAX_A; ++a) cp[a] = col_prec[(rt * A + a) * CK + j];
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
        const S a_max = first_match(ac, ch_a);
        const S p_max = first_match(pc, ch_p);
        const S s_max = first_match(scand, ch_s);
        const S e_max = first_match(ecand, ch_e);
        const S mx[4] = {a_max, p_max, s_max, e_max};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const S lpst = (f[st] + bw[st * (size_t)NC + c]) - Zr;
          v[st] = ok ? mx[st] + lpst : NEG;
        }
        chp = ch_e | (ch_a << 2) | (ch_p << 5) | (ch_s << 9);
      }
      if (t == 0) {
#pragma unroll
        for (int st = 0; st < 4; ++st) v[st] = f[st];
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const S ap = f[st] + bw[st * (size_t)NC + c];
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
// ntc_walk: the traceback (ref: NTC.cpp:691-904)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void walk_kernel(const S* __restrict__ lp,
                            const short* __restrict__ choices,
                            const int* __restrict__ slots,
                            const int* __restrict__ row_same,
                            const int* __restrict__ row_prev,
                            const int* __restrict__ i0, const int* __restrict__ j0,
                            const int* __restrict__ k0,
                            const unsigned char* __restrict__ valid,
                            const int* __restrict__ N_r,
                            const int* __restrict__ T_r, S* __restrict__ rec,
                            int* __restrict__ fin, int R, int T_pad, int CN,
                            int CK, int A, int K, int half, int S_max, int NM,
                            int slb) {
  const int r = blockIdx.x;
  const int NC = CN * CK, SLM = (1 << slb) - 1, Kdiv = K / A;
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const bool val = valid[r];
  bool active = false, stuck = false;
  int state = 0, i = 0, j = 0, k = 0, n = 0, seg = 0;
  for (int t = T_pad - 1; t >= 0; --t) {
    if (t == tm1 && val) {
      active = true;
      state = ST_E;
      i = i0[r];
      j = j0[r];
      k = k0[r];
      n = nm1;
      seg = 0;
    }
    bool did_t = false;
    const bool t_pos = t >= 1;
    const size_t rt = (size_t)t * R + r;
    for (int m = 0; m < NM; ++m) {
      const int c = i * CK + j;
      const int ch = (int)choices[rt * NC + c];
      const S lps = lp[(rt * 5 + state) * NC + c];
      const int slv = slots[rt * NC + c];
      const bool is_I = active && state == ST_I && t_pos;
      const bool i_break = is_I && n == 1;
      const bool i_go = is_I && !i_break;
      const bool tstep = active && state != ST_I && !did_t && t_pos;
      const bool is_A = state == ST_A, is_P = state == ST_P;
      const bool is_S = state == ST_S, is_E = state == ST_E;
      const bool brk = tstep && t == 1 && (is_E || is_P || ((is_A || is_S) && n == 1));
      const bool go = tstep && !brk;
      const bool emit_break = brk && (is_E || is_A || is_P);  // an S break emits nothing
      const bool emit = emit_break || (go && (is_A || is_P));
      const bool moved = i_go || go;
      S* o = rec + (((size_t)t * NM + m) * R + r) * NREC;
      o[0] = moved ? exp_(lps) : S(0);
      o[1] = S(moved ? seg : S_max);
      o[2] = S(emit ? 1 : 0);
      o[3] = S(is_P ? 1 : 0);
      o[4] = S(emit_break ? half : n - 1 + half);
      o[5] = S(emit_break ? 0 : t - 1);
      o[6] = S(k);
      o[7] = S(emit ? seg : S_max);

      const int chE = ch & 3, chA = (ch >> 2) & 7, chP = (ch >> 5) & 15;
      const int chS = (ch >> 9) & 3, chI = (ch >> 11) & 1;
      const int ai = is_A ? chA >> 1 : chP / 3;
      const int cs = (slv & SLM) - 1;
      const int cpa = (is_A ? (slv >> slb) & SLM : (slv >> (2 * slb)) & SLM) - 1;
      const int stE = chE == 0 ? ST_E : chE == 1 ? ST_A : chE == 2 ? ST_S : ST_P;
      const int stA = (chA & 1) == 0 ? ST_E : ST_I;
      const int m3 = chP - ai * 3;
      const int stP = m3 == 0 ? ST_E : m3 == 1 ? ST_S : ST_I;
      const int stS = chS == 0 ? ST_E : chS == 1 ? ST_P : ST_I;
      const int stI = chI == 0 ? ST_E : ST_I;
      const int st_go = is_E ? stE : is_A ? stA : is_P ? stP : stS;
      const int i_go_slot = (is_E || is_P) ? row_same[rt * CN + i] : row_prev[rt * CN + i];
      const int j_go_slot = (is_E || is_S) ? cs : cpa;
      const int k_go = (is_A || is_P) ? k / A + ai * Kdiv : k;
      const int n_go = (is_A || is_S) ? n - 1 : n;

      state = i_go ? stI : go ? st_go : state;
      int ni = i_go ? i - 1 : go ? i_go_slot : i;
      i = ni < 0 ? 0 : ni > CN - 1 ? CN - 1 : ni;
      int nj = go ? j_go_slot : j;
      j = nj < 0 ? 0 : nj > CK - 1 ? CK - 1 : nj;
      k = go ? k_go : k;
      n = i_go ? n - 1 : go ? n_go : n;
      seg += emit ? 1 : 0;
      active = active && !(i_break || brk);
      did_t = did_t || go || brk;
    }
    if (active && !did_t && t_pos) stuck = true;
  }
  fin[2 * r] = seg;
  fin[2 * r + 1] = stuck ? 1 : 0;
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
        S* out, int NT, cudaStream_t stream) {
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
       cudaStream_t stream) {
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

template <typename S>
int walk(const S* lp, const short* choices, const int* slots,
         const int* row_same, const int* row_prev, const int* i0,
         const int* j0, const int* k0, const unsigned char* valid,
         const int* N_r, const int* T_r, S* rec, int* fin, int R, int T_pad,
         int CN, int CK, int A, int K, int half, int S_max, int NM, int slb,
         cudaStream_t stream) {
  walk_kernel<S><<<R, 1, 0, stream>>>(lp, choices, slots, row_same, row_prev,
                                      i0, j0, k0, valid, N_r, T_r, rec, fin, R,
                                      T_pad, CN, CK, A, K, half, S_max, NM, slb);
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
      void* stream) {                                                          \
    const BwdIn<S> in{sig, cand_n, allowed, hd, d01, d02, brow_same,          \
                      brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,  \
                      nsl, R, T_pad, CN, CK, A};                              \
    return bwd<S>(in, tlog, N_r, T_r, out, NT, (cudaStream_t)stream);         \
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
      void* stream) {                                                          \
    return pv<S>(sig, cand_n, allowed, hd, row_same, row_prev, col_same,      \
                 col_prec, mu_k, c1_k, c2_k, nsl, tlog, Z, T_r, bwd_in, lp,   \
                 choices, slots, apEf, fwdEf, scratch, R, T_pad, CN, CK, A,   \
                 NT, slb, (cudaStream_t)stream);                               \
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
