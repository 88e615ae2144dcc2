// NTC Baum-Welch training kernels for Hopper (sm_90a), templated on float
// and double:
//
//   ntc_fwd_store  replaces dynamont_tpu/ops/ntc_pallas.py::_fwd_kernel
//   ntc_train      replaces dynamont_tpu/ops/ntc_pallas.py::_train_kernel
//
// Plain-torch versions and the layouts of every argument are in
// ops/ntc_train_kernels.py (the plain lattice is ops/ntc_batch.py:
// ntc_forward_store_batch, ntc_train_batch); the wrappers there launch
// these through the extern "C" entries.
//
// Design. The geometry of ntc_bwd and ntc_pv (ntc_lattice.cu): one block
// per read, the t-loop inside the kernel, NT = threads(CN*CK) threads,
// thread b owning cells c = b, b+NT, ... (c = i*CK + j); R, T_pad, CN and CK
// are arguments, so the caps (8, 120) and (16, 240) run the same code.
// Each kernel has two instances, picked by shape in ops/ntc_train_kernels
// (fwd_store_instance, train_instance): a shared-column one for the main
// rung, whose columns fit one block's shared memory, and a device-memory
// one for the shapes that do not fit (the wide caps).
//
// ntc_fwd_store is ntc_pv's forward half, written op for op as ntc_pv
// writes it, so its row T_r-1, state E, is bit for bit ntc_pv's fwdEf. It
// stores every row of the (T_pad, R, 5, CN, CK) forward lattice.
// fwd_store_shared_kernel keeps the previous and the current column in
// shared memory, as pv_shared_kernel does, with row t's plan inputs staged
// (cp.async, a row ahead) and each finished row copied out to the store by
// the threads phase 2's I chains leave idle; fwd_store_kernel reads the
// previous row back from its own store.
//
// ntc_train is ntc_bwd's recurrence, op for op (train_column repeats
// bwd_column_at's arithmetic, so its b0 is bit for bit ntc_bwd's row 0),
// with, per row t < T_r-1:
//   * the 13 transition terms (TERMS order of ops/ntc_batch.py), each the
//     forward of t + transition + score + the backward gathered from t+1,
//     logaddexp'ed into a per-cell accumulator. Phase 1 adds the 11 terms
//     of the successor gathers; phase 2, the thread that folds column j's I
//     chain, adds i1 and i2, which pair E and I of slot i with the stored I
//     of slot i+1. Each accumulator is folded in descending t by the
//     thread that owns the cell;
//   * the k-mer moments at rows 1..T_r-1: the k-slot j's sums of w, w*d,
//     w*d*d over the slot's CN cells in n order, w = exp(logaddexp over the
//     states of fwd + bwd - Z), d = sig[t-1] - mu_k, each added to the
//     slot's k-mer bin of the read's (3, K) array in the output. Live slots
//     of a column hold distinct k-mers (build_plan_batch drops repeats), so
//     no two threads share a bin in a row, and rows are a barrier apart: no
//     atomics, and the sums are deterministic. A dead slot is skipped (its
//     cells have w = 0 but its k-mer may repeat a live slot's).
// Rows past T_r-1 are dead (-inf backward): their terms are -inf and their
// w are 0, which add nothing, so the kernel starts at the terminal row. A
// term of -inf is skipped: logaddexp(a, -inf) is a, exactly.
// train_shared_kernel (the main rung) holds rows t + 1 and t in shared
// memory, as bwd_shared_kernel does, stages each row's inputs (and in fp32
// its forward row) a row ahead, and takes the moments off the chain: while
// row t's I chains run, the threads they leave idle compute row t + 1's w
// cell by cell, then each slot's sums and bins (row t + 1's backward column
// and slot are still in shared memory, and the row's barrier publishes the
// bins). train_kernel keeps column t + 1 in a per-read double buffer in
// device memory (`scratch`) and sums the moments after the chain, one
// thread a k-slot.
//
// What bounds them: as ntc_bwd and ntc_pv, chains of T_pad dependent
// steps, each two block barriers and ~40-90 transcendental functions per
// cell, one block per read on R of 132 SMs. ntc_fwd_store writes a 5.37 GB
// store at (16, 16384, 8, 128) fp32 (1.6 ms at the H100's 3.35 TB/s);
// ntc_train reads it back; both far below the chain's latency. ntc_train's
// phase 1 (the column and 11 term folds, ~30 logaddexps a cell) is most of
// its row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntc_lattice_common.cuh"

namespace {

using namespace dynamont;

constexpr int MAX_THREADS = NTC_MAX_THREADS;
constexpr int NTERMS = 13;
constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
// accumulator index of each term, in ops/ntc_batch.TERMS order
enum { QE2, QE3, QE4, QS1, QS2, QS3, QP1, QP2, QP3, QA1, QA2, QI1, QI2 };

template <typename S>
__device__ __forceinline__ void acc_add(S* a, S v) {
  if (v != neg_inf<S>()) *a = logaddexp(*a, v);
}

// step ai of a fold that starts at -inf: logaddexp(-inf, v) is v + 0
// exactly (v for every v but -0, which both make +0; -inf, +inf and NaN
// pass through), so the first step is that add
template <typename S>
__device__ __forceinline__ S fold(int ai, S a, S v) {
  return ai == 0 ? v + S(0) : logaddexp(a, v);
}

// ---------------------------------------------------------------------------
// ntc_fwd_store: the forward lattice, every row (ref: NTC.cpp:430-495)
// ---------------------------------------------------------------------------
// The forward states A, P, S, E of one cell at t > 0 (-inf where !ok) from
// the previous column Fp through the slot maps (n-slots rs, rp; k-slots
// cs, cp) and the cell's score sc: pv_cell's forward half, op for op, for
// both instances of ntc_fwd_store.
template <typename S>
__device__ __forceinline__ void fwd_cell(const S* Fp, const S (&tl)[NTL], int rs, int rp,
                                         int cs, const int (&cp)[MAX_A], S sc, bool ok,
                                         int CN, int CK, S (&f)[4]) {
  const S NEG = neg_inf<S>();
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

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_store_kernel(const S* __restrict__ sig, const int* __restrict__ cand_n,
                 const unsigned char* __restrict__ allowed,
                 const short* __restrict__ hd, const int* __restrict__ row_same,
                 const int* __restrict__ row_prev,
                 const int* __restrict__ col_same,
                 const int* __restrict__ col_prec, const S* __restrict__ mu_k,
                 const S* __restrict__ c1_k, const S* __restrict__ c2_k,
                 const S* __restrict__ nsl, const S* __restrict__ tlog, S* out,
                 int R, int T_pad, int CN, int CK, int A) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int NC = CN * CK, RC = R * CN;
  S* sF = reinterpret_cast<S*>(smem);  // forward E (masked), per cell
  S* sSc = sF + NC;                    // the cell's score
  unsigned char* sCond = reinterpret_cast<unsigned char*>(sSc + NC);
  const S NEG = neg_inf<S>();
  S tl[NTL];
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
  const size_t col = 5 * (size_t)NC;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);

  for (int t = 0; t < T_pad; ++t) {
    const size_t rt = (size_t)t * R + r;
    S* Fc = out + rt * col;
    const S* Fp = t > 0 ? out + (rt - R) * col : out;  // row t - 1
    const unsigned char* al = allowed + rt * NC;
    const int* cn_t = cand_n + rt * CN;
    const S x = t > 0 ? sig_r[t - 1] : S(0);
    const S* ns = nsl + (size_t)t * 3 * 2 * RC;
    for (int c = tid; c < NC; c += NT) {
      const int i = c / CK, j = c % CK;
      const int cn = cn_t[i];
      const bool ok = al[c] && cn >= 1;
      const bool cond = ok && i > 0 && cn_t[i - 1] == cn - 1;
      S f[4];
      S sc = S(0);
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
        fwd_cell(Fp, tl, row_same[rt * CN + i], row_prev[rt * CN + i], col_same[kj], cp, sc,
                 ok, CN, CK, f);
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) Fc[st * (size_t)NC + c] = f[st];
      sF[c] = f[ST_E];
      sSc[c] = sc;
      sCond[c] = cond;
    }
    __syncthreads();
    // phase 2: the I chain of column j, ascending over the n-slots
    // (ref: NTC.cpp:474-477)
    for (int j = tid; j < CK; j += NT) {
      S fi = NEG;
      for (int i = 0; i < CN; ++i) {
        const int c = i * CK + j;
        S fI = NEG;
        if (t > 0 && i > 0) {
          const bool cond = sCond[c];
          const S sc = sSc[c];
          const S iA = cond ? (sF[c - CK] + tl[TI1]) + sc : NEG;
          const S iB = cond ? tl[TI2] + sc : NEG;
          fI = logaddexp(iA, fi + iB);
        }
        Fc[ST_I * (size_t)NC + c] = fI;
        fi = fI;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// ntc_fwd_store's shared-column instance (fwd_store_shared_kernel): the main
// rung (8, 128) in fp32 and fp64, and (16, 256) in fp32. fwd_store_kernel's
// step through the same fwd_cell, with every operand of the chain in shared
// memory:
//   - the previous and current columns (2 x 5 x NC), so phase 1's 27
//     gathers a cell and phase 2's I chain read shared memory;
//   - row t's plan inputs (pv_shared_kernel's PvStage) in one of two
//     stages;
//   - phase 1 -> 2's score and I-chain flag of each cell.
// Phase 2's I chains take CK of the NT threads; the other NT - CK issue row
// t + 1's inputs (cp.async, 16-byte pieces) and copy row t - 1, finished
// and read, to the store meanwhile. 60832 bytes in fp32, 109152 in fp64 at
// (8, 128), 226080 in fp32 at (16, 256); fwd_store_shared_bytes counts them and
// ops/ntc_train_kernels.fwd_store_instance repeats the sum, picking this
// instance where NC % 16, CN % 4 and CK % 4 are 0 (the copies' sizes and
// alignment) and phase 2 leaves threads idle (NT > CK).
// ---------------------------------------------------------------------------
template <typename S>
__host__ __device__ inline size_t fwd_store_shared_bytes(int CN, int CK, int A) {
  const size_t NC = (size_t)CN * CK;
  return 11 * NC * sizeof(S) + al16(NC) + 2 * pv_stage_bytes<S>(CN, CK, A);
}

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_store_shared_kernel(const S* __restrict__ sig, const int* __restrict__ cand_n,
                        const unsigned char* __restrict__ allowed,
                        const short* __restrict__ hd, const int* __restrict__ row_same,
                        const int* __restrict__ row_prev, const int* __restrict__ col_same,
                        const int* __restrict__ col_prec, const S* __restrict__ mu_k,
                        const S* __restrict__ c1_k, const S* __restrict__ c2_k,
                        const S* __restrict__ nsl, const S* __restrict__ tlog, S* out,
                        int R, int T_pad, int CN, int CK, int A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int NC = CN * CK, RC = R * CN;
  const size_t col = 5 * (size_t)NC;
  S* cols = reinterpret_cast<S*>(smem);  // [2][5][NC]: row t at cols + (t & 1) * col
  S* sSc = cols + 2 * col;               // the cell's score
  unsigned char* sCond = reinterpret_cast<unsigned char*>(sSc + NC);
  unsigned char* stages = sCond + al16(NC);
  const size_t stb = pv_stage_bytes<S>(CN, CK, A);
  const S NEG = neg_inf<S>();
  S tl[NTL];
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
  const S* sig_r = sig + (size_t)r * (T_pad - 1);

  // row t's plan inputs into stage t & 1, on thread i of n: one group
  auto issue_row = [&](int t, int i, int n) {
    const PvStage<S> s = pv_stage<S>(stages + (t & 1) * stb, CN, CK, A);
    const size_t rt = (size_t)t * R + r;
    cp_async_rows(s.cand_n, cand_n + rt * CN, CN, i, n);
    cp_async_rows(s.row_same, row_same + rt * CN, CN, i, n);
    cp_async_rows(s.row_prev, row_prev + rt * CN, CN, i, n);
    cp_async_rows(s.col_same, col_same + rt * CK, CK, i, n);
    cp_async_rows(s.col_prec, col_prec + rt * A * CK, (size_t)A * CK, i, n);
    cp_async_rows(s.hd, hd + rt * NC, NC, i, n);
    cp_async_rows(s.allowed, allowed + rt * NC, NC, i, n);
    cp_async_rows(s.mu_k, mu_k + rt * CK, CK, i, n);
    cp_async_rows(s.c1_k, c1_k + rt * CK, CK, i, n);
    cp_async_rows(s.c2_k, c2_k + rt * CK, CK, i, n);
    const S* ns = nsl + (size_t)t * 6 * RC + (size_t)r * CN;
    for (int q = 0; q < 3; ++q)  // [mu, c1, c2] of the n-slots
      cp_async_rows(s.nsl + q * CN, ns + 2 * (size_t)q * RC, CN, i, n);
    if (i == 0 && t > 0) cp_async_elem(s.x, sig_r + t - 1);
    cp_async_commit();
  };
  // row t's column to the store, on thread i of n
  auto copy_out = [&](int t, int i, int n) {
    const int4* src = reinterpret_cast<const int4*>(cols + (t & 1) * col);
    int4* dst = reinterpret_cast<int4*>(out + ((size_t)t * R + r) * col);
    for (size_t q = i; q < col * sizeof(S) / 16; q += n) dst[q] = src[q];
  };

  issue_row(0, tid, NT);
  for (int t = 0; t < T_pad; ++t) {
    const PvStage<S> s = pv_stage<S>(stages + (t & 1) * stb, CN, CK, A);
    S* Fc = cols + (t & 1) * col;
    const S* Fp = cols + ((t & 1) ^ 1) * col;  // row t - 1 (not read at t = 0)
    cp_async_wait_all();  // row t's inputs
    __syncthreads();      // visible to all; row t - 1 complete, column t & 1 stored
    const S x = t > 0 ? s.x[0] : S(0);
    // phase 1: every cell but the I chain
    for (int c = tid; c < NC; c += NT) {
      const int i = c / CK, j = c % CK;
      const int cn = s.cand_n[i];
      const bool al = s.allowed[c];
      const bool ok = al && cn >= 1;
      const bool cond = ok && i > 0 && s.cand_n[i - 1] == cn - 1;
      S f[4];
      S sc = S(0);
      if (t == 0) {
        f[ST_A] = f[ST_P] = f[ST_S] = NEG;
        f[ST_E] = (cn == 0 && al) ? S(0) : NEG;
      } else {
        sc = (sc_(x, s.nsl[i], s.nsl[CN + i], s.nsl[2 * CN + i])
              + sc_(x, s.mu_k[j], s.c1_k[j], s.c2_k[j]))
             + S(-2.0) * S((int)s.hd[c] & 15);
        int cp[MAX_A];
#pragma unroll
        for (int a = 0; a < MAX_A; ++a) cp[a] = s.col_prec[a * CK + j];
        fwd_cell(Fp, tl, s.row_same[i], s.row_prev[i], s.col_same[j], cp, sc, ok, CN, CK, f);
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) Fc[st * (size_t)NC + c] = f[st];
      sSc[c] = sc;
      sCond[c] = cond;
    }
    __syncthreads();
    // phase 2: the I chain of column j, ascending over the n-slots
    // (ref: NTC.cpp:474-477); the E of slot i - 1 is phase 1's
    for (int j = tid; j < CK; j += NT) {
      S fi = NEG;
      for (int i = 0; i < CN; ++i) {
        const int c = i * CK + j;
        S fI = NEG;
        if (t > 0 && i > 0) {
          const bool cond = sCond[c];
          const S sc = sSc[c];
          const S iA = cond ? (Fc[ST_E * (size_t)NC + c - CK] + tl[TI1]) + sc : NEG;
          const S iB = cond ? tl[TI2] + sc : NEG;
          fI = logaddexp(iA, fi + iB);
        }
        Fc[ST_I * (size_t)NC + c] = fI;
        fi = fI;
      }
    }
    // meanwhile, the threads the chains leave free prefetch row t + 1 (into
    // the stage row t - 1 used) and store row t - 1
    if (tid >= CK) {
      if (t + 1 < T_pad) issue_row(t + 1, tid - CK, NT - CK);
      if (t > 0) copy_out(t - 1, tid - CK, NT - CK);
    }
  }
  __syncthreads();
  copy_out(T_pad - 1, tid, NT);
}

// ---------------------------------------------------------------------------
// ntc_train's column (ref: NTC.cpp:500-578 and 923-999): column t of the
// backward into `o` (5, CN, CK) from column t + 1 at `nx`, bwd_column_at's
// arithmetic op for op, with the 13 terms of the forward column `f` of row
// t (5, CN, CK) folded into `acc` (term q of cell c at acc[q * astride +
// c]); the terminal column at t = T_r-1 (no terms; nx is not read). `in`'s
// arrays are read at row ti of read ri: (t, r) itself (train_kernel) or a
// staged row (train_shared_kernel: R = 1, ti = 0). FSH: `f` is in shared
// memory, where phase 2 reads its E and I; else phase 1 copies them to
// `smem` for phase 2. `idle` runs once a column before its last barrier, on
// the NT - CK threads that phase 2's I chains leave free (on all NT in the
// terminal column, or when there are none). Ends with a block barrier.
// ---------------------------------------------------------------------------

// Shared memory train_column uses: bwd_column's phase 1 -> 2 scratch, then
// (!FSH) the forward E and I of the column's cells [2][NC].
template <typename S, bool FSH>
__host__ __device__ inline size_t train_col_smem(int NC) {
  return al16(bwd_smem<S>(NC)) + (FSH ? 0 : 2 * (size_t)NC * sizeof(S));
}

template <typename S, bool FSH, typename Idle>
__device__ __forceinline__ void train_column(const BwdIn<S>& in, const S (&tl)[NTL], int t,
                                             int ti, int ri, int nm1, int tm1, const S* nx,
                                             S* o, const S* f, S* acc, size_t astride,
                                             unsigned char* smem, const Idle& idle) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, CN = in.CN, CK = in.CK, A = in.A;
  const int NC = CN * CK, RC = R * CN;
  S* sE = reinterpret_cast<S*>(smem);
  S* sI = sE + NC;
  S* sB = sI + NC;
  S* sX = sB + NC;
  unsigned char* sOk = reinterpret_cast<unsigned char*>(sX + NC);
  S* sF = reinterpret_cast<S*>(smem + al16(bwd_smem<S>(NC)));  // !FSH: [E | I][NC]
  const S* fE_ = FSH ? f + ST_E * (size_t)NC : sF;
  const S* fI_ = FSH ? f + ST_I * (size_t)NC : sF + NC;
  const S NEG = neg_inf<S>();
  const size_t rt = (size_t)ti * R + ri;
  const unsigned char* al = in.allowed + rt * NC;
  const int* cn_t = in.cand_n + rt * CN;
  if (t == tm1) {  // the terminal column: no terms
    for (int c = tid; c < NC; c += NT) {
      const S e = (al[c] && cn_t[c / CK] == nm1) ? S(0) : NEG;
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
    const S fP = f[ST_P * (size_t)NC + c], fS = f[ST_S * (size_t)NC + c];
    const S fE = f[ST_E * (size_t)NC + c], fI = f[ST_I * (size_t)NC + c];
    if constexpr (!FSH) {
      sF[c] = fE;
      sF[NC + c] = fI;
    }
    S tp1 = NEG, tp2 = NEG, tp3 = NEG, ta1 = NEG, ta2 = NEG;
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
      tp1 = fold(ai, tp1, (fS + tl[TP1]) + gspP);
      tp2 = fold(ai, tp2, (fE + tl[TP2]) + gspP);
      tp3 = fold(ai, tp3, (fI + tl[TP3]) + gspP);
      ta1 = fold(ai, ta1, (fE + tl[TA1]) + gnaA);
      ta2 = fold(ai, ta2, (fI + tl[TA2]) + gnaA);
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
    // the terms of the successor gathers (ref: NTC.cpp:935-989)
    S* ac = acc + c;
    acc_add(ac + QE2 * astride, n_pos ? ((fP + tl[TE2]) + sc1) + gskE : NEG);
    acc_add(ac + QE3 * astride, n_pos ? ((fS + tl[TE3]) + sc1) + gskE : NEG);
    acc_add(ac + QE4 * astride, n_pos ? ((fE + tl[TE4]) + sc1) + gskE : NEG);
    acc_add(ac + QS1 * astride, n_lt ? ((fP + tl[TS1]) + sc2) + gnkS : NEG);
    acc_add(ac + QS2 * astride, n_lt ? ((fE + tl[TS2]) + sc2) + gnkS : NEG);
    acc_add(ac + QS3 * astride, n_lt ? ((fI + tl[TS3]) + sc2) + gnkS : NEG);
    acc_add(ac + QP1 * astride, tp1);
    acc_add(ac + QP2 * astride, tp2);
    acc_add(ac + QP3 * astride, tp3);
    acc_add(ac + QA1 * astride, ta1);
    acc_add(ac + QA2 * astride, ta2);
  }
  __syncthreads();
  // phase 2: the I chain of column j, from the last n-slot down; the E of
  // slot i adds the UPDATED I of slot i + 1, and i1/i2 pair E and I of slot
  // i with the STORED I of slot i + 1 (ref: NTC.cpp:990-999)
  for (int j = tid; j < CK; j += NT) {
    int c = (CN - 1) * CK + j;
    S below = sI[c];
    S stored = al[c] ? below : NEG;
    o[ST_I * (size_t)NC + c] = stored;
    o[ST_E * (size_t)NC + c] = al[c] ? sE[c] : NEG;
    for (int i = CN - 2; i >= 0; --i) {
      c = i * CK + j;
      const S inew = logaddexp(sI[c], below + sB[c]);
      S e = sE[c];
      if (sOk[c]) {
        e = logaddexp(e, (below + tl[TI1]) + sX[c]);
        acc_add(acc + QI1 * astride + c, ((fE_[c] + tl[TI1]) + sX[c]) + stored);
        acc_add(acc + QI2 * astride + c, ((fI_[c] + tl[TI2]) + sX[c]) + stored);
      }
      stored = al[c] ? inew : NEG;
      o[ST_I * (size_t)NC + c] = stored;
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

// w of cell c of a row (ref: NTC.cpp:1059-1130): exp of the logaddexp, in
// state order, of fwd + bwd - Z over the five states of the forward column
// f and the backward column o; 0 where the cell is not allowed.
template <typename S>
__device__ __forceinline__ S cell_w(const S* f, const S* o, int c, size_t NC, S Zr, bool al) {
  S lw = (f[c] + o[c]) - Zr;
  for (int st = 1; st < 5; ++st) {
    const size_t sc = st * NC + c;
    lw = logaddexp(lw, (f[sc] + o[sc]) - Zr);
  }
  return al ? exp_(lw) : S(0);
}

// ---------------------------------------------------------------------------
// ntc_train's device-memory instance (train_kernel): the backward recurrence
// with the training sums, column t + 1 in a per-read double buffer in
// device memory, the moments after the chain one thread a k-slot. The 13
// accumulators live in shared memory where they fit (13 * CN*CK values:
// 52 KB in fp32, 104 KB in fp64 at (8, 128)), else in the output itself,
// each cell read and written by one thread per phase.
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
train_kernel(BwdIn<S> in, const unsigned char* __restrict__ live,
             const int* __restrict__ ks, const S* __restrict__ tlog,
             const int* __restrict__ N_r, const int* __restrict__ T_r,
             const S* __restrict__ fwd, const S* __restrict__ Z, S* tacc, S* em,
             S* __restrict__ b0, S* scratch, int K, int acc_shared) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, T_pad = in.T_pad, CK = in.CK;
  const int NC = in.CN * CK;
  S* sAcc = reinterpret_cast<S*>(smem);  // [NTERMS][NC] when acc_shared
  unsigned char* csm = reinterpret_cast<unsigned char*>(
      sAcc + (acc_shared ? NTERMS * (size_t)NC : 0));
  // term q of cell c is acc[q * astride + c]
  S* acc = acc_shared ? sAcc : tacc + (size_t)r * NC;
  const size_t astride = acc_shared ? (size_t)NC : (size_t)R * NC;
  S* em_r = em + (size_t)r * 3 * K;
  S tl[NTL];
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const S Zr = Z[r];
  const size_t col = 5 * (size_t)NC;
  const S* sig_r = in.sig + (size_t)r * (T_pad - 1);
  S* buf = scratch + (size_t)r * 2 * col;  // columns t (t & 1) and t + 1
  for (int q = 0; q < NTERMS; ++q)
    for (int c = tid; c < NC; c += NT) acc[q * astride + c] = neg_inf<S>();
  for (int k = tid; k < 3 * K; k += NT) em_r[k] = S(0);
  __syncthreads();

  for (int t = tm1 < T_pad - 1 ? tm1 : T_pad - 1; t >= 0; --t) {
    const size_t rt = (size_t)t * R + r;
    S* o = buf + (size_t)(t & 1) * col;
    const S* f = fwd + rt * col;
    train_column<S, false>(in, tl, t, t, r, nm1, tm1, buf + (size_t)((t + 1) & 1) * col, o,
                           f, acc, astride, csm, [](int, int) {});
    // the k-mer moments of row t >= 1, one thread per live k-slot
    if (t >= 1) {
      const unsigned char* al = in.allowed + rt * NC;
      const S xm = sig_r[t - 1];
      for (int j = tid; j < CK; j += NT) {
        const size_t kj = rt * CK + j;
        if (!live[kj]) continue;
        const S d = xm - in.mu_k[kj];
        S sw = S(0), swd = S(0), swdd = S(0);
        for (int i = 0; i < in.CN; ++i) {
          const int c = i * CK + j;
          const S w = cell_w(f, o, c, NC, Zr, al[c]);
          const S wd = w * d;
          const S wdd = wd * d;
          sw = i == 0 ? w : sw + w;
          swd = i == 0 ? wd : swd + wd;
          swdd = i == 0 ? wdd : swdd + wdd;
        }
        const int k = ks[kj];
        em_r[k] = em_r[k] + sw;
        em_r[K + k] = em_r[K + k] + swd;
        em_r[2 * K + k] = em_r[2 * K + k] + swdd;
      }
    }
    __syncthreads();
  }
  // outputs: backward row 0 and, from shared memory, the accumulators
  const S* o0 = buf;
  for (int c = tid; c < 5 * NC; c += NT) b0[(size_t)r * 5 * NC + c] = o0[c];
  if (acc_shared) {
    for (int q = 0; q < NTERMS; ++q)
      for (int c = tid; c < NC; c += NT)
        tacc[((size_t)q * R + r) * NC + c] = sAcc[q * (size_t)NC + c];
  }
}

// ---------------------------------------------------------------------------
// ntc_train's shared-column instance (train_shared_kernel): the main rung
// (CK <= 128, NC 1024). train_kernel's sums through the same train_column,
// with the chain's operands in shared memory:
//   - rows t + 1 and t as two columns (2 x 5 x NC), as bwd_shared_kernel;
//   - each row's inputs in a slot of a ring of three: one staged row in
//     stage_bytes' layout, then the row's live and ks, and with FSH its
//     forward column (5 x NC, read by phase 1, phase 2's i1/i2 and the
//     moments); row t - 1's slot fills during row t (the ring keeps row
//     t + 1's for the moments);
//   - with FSH the 13 accumulators (13 x NC), else in the output (tacc);
//   - train_column's scratch, the moments' w (NC) and the slots' mbarriers.
// Warp 0 fills row t - 1's slot at row t's start with bulk copies (the
// TMA unit: one instruction a region, counted on the slot's mbarrier,
// which every thread waits on at row t - 1's start). The TMA unit takes
// the ~22 requests one after another, ~170 cycles each whatever their
// size, so warp 0 starts phase 1 ~4.4k cycles late (fp32); as cp.async
// pieces the same copy cost 2-4k cycles on every thread (13-17k in fp64),
// on the idle threads it outlasted the I chains, and requests spread over
// all warps stalled them all (PERF.md section 6).
// The moments of row t + 1 run on the idle threads during row t's phase
// 2, reading row t + 1's backward column (still in shared memory), its
// slot and its forward column: first every cell's w (the cells spread over
// the idle threads), then, after a barrier of those threads, each live
// k-slot's sums over its n-slots in n order into the slot's bin, whose
// three values were loaded before the w pass. Row t's barrier publishes
// the bins before row t - 1 adds to them, so each bin takes its rows in
// descending t as train_kernel adds them.
// fp32 at (8, 128) takes 220000 bytes with FSH; fp64 206752 without (the
// forward rows and accumulators in device memory: with them 525 KB).
// train_shared_bytes counts the bytes; ops/ntc_train_kernels.
// train_instance repeats the sum and picks this instance where it fits,
// NC % 16, CN % 4 and CK % 16 are 0 (the copies' sizes and alignment), CK
// is a multiple of 32 and phase 2 leaves at least CK threads idle. As in
// bwd_shared_kernel, the column function reads a BwdIn view built from the
// slot's own shared pointers.
// ---------------------------------------------------------------------------
template <typename S, bool FSH>
__host__ __device__ inline size_t train_slot_bytes(int CN, int CK, int A) {
  return stage_bytes<S>(1, CN, CK, A) + al16(CK) + al16((size_t)CK * sizeof(int)) +
         (FSH ? 5 * (size_t)CN * CK * sizeof(S) : 0);
}

template <typename S, bool FSH>
__host__ __device__ inline size_t train_shared_bytes(int CN, int CK, int A) {
  const size_t NC = (size_t)CN * CK;
  return 10 * NC * sizeof(S) + train_col_smem<S, FSH>((int)NC) +
         (FSH ? NTERMS * NC * sizeof(S) : 0) + NC * sizeof(S) +
         3 * train_slot_bytes<S, FSH>(CN, CK, A) + al16(3 * sizeof(uint64_t));
}

template <typename S, bool FSH>
__global__ void __launch_bounds__(MAX_THREADS)
train_shared_kernel(BwdIn<S> in, const unsigned char* __restrict__ live,
                    const int* __restrict__ ks, const S* __restrict__ tlog,
                    const int* __restrict__ N_r, const int* __restrict__ T_r,
                    const S* __restrict__ fwd, const S* __restrict__ Z, S* tacc, S* em,
                    S* __restrict__ b0, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int R = in.R, T_pad = in.T_pad, CN = in.CN, CK = in.CK, A = in.A;
  const int NC = CN * CK, RC = R * CN, ACK = A * CK;
  const size_t col = 5 * (size_t)NC;
  S* cols = reinterpret_cast<S*>(smem);  // [2][5][NC]: row t at cols + (t & 1) * col
  unsigned char* csm = smem + 2 * col * sizeof(S);
  S* sAcc = reinterpret_cast<S*>(csm + train_col_smem<S, FSH>(NC));  // FSH: [NTERMS][NC]
  S* sW = sAcc + (FSH ? NTERMS * (size_t)NC : 0);                    // the moments' w
  unsigned char* slots = reinterpret_cast<unsigned char*>(sW + NC);
  const size_t stb = stage_bytes<S>(1, CN, CK, A), slb = train_slot_bytes<S, FSH>(CN, CK, A);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + 3 * slb);  // a slot's bulk copies
  S* acc = FSH ? sAcc : tacc + (size_t)r * NC;
  const size_t astride = FSH ? (size_t)NC : (size_t)R * NC;
  S* em_r = em + (size_t)r * 3 * K;
  S tl[NTL];
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const S Zr = Z[r];
  const S* sig_r = in.sig + (size_t)r * (T_pad - 1);
  const int t0 = tm1 < T_pad - 1 ? tm1 : T_pad - 1;
  // row t's slot: the staged row, live [CK], ks [CK], FSH: forward [5][NC]
  auto slot = [&](int t) { return slots + (t % 3) * slb; };
  auto slot_live = [&](int t) { return slot(t) + stb; };
  auto slot_ks = [&](int t) { return reinterpret_cast<int*>(slot_live(t) + al16(CK)); };
  auto slot_fwd = [&](int t) {
    return reinterpret_cast<S*>(reinterpret_cast<unsigned char*>(slot_ks(t)) +
                                al16((size_t)CK * sizeof(int)));
  };

  // bytes of a slot's bulk copies: every region but the samples, d01, d02
  const unsigned slot_tx =
      (unsigned)((3 * (size_t)CK + 3 * (size_t)ACK + 6 * (size_t)CN) * sizeof(S) +
                 (3 * (size_t)CN + CK + ACK + CK) * sizeof(int) + (size_t)NC * sizeof(short) +
                 NC + CK + (FSH ? col * sizeof(S) : 0));
  // row t's inputs into its slot, on warp 0 (the regions of
  // bwd_shared_kernel's issue_row, then live, ks and the forward row): lane
  // 0 expects the slot's bytes on its mbarrier, the lanes take the bulk
  // copies in turn, and lane 31 copies the samples, d01 and d02 (cp.async:
  // too short for a bulk copy) as one group
  auto issue_row = [&](int t) {
    const int lane = tid & 31;
    const StagePtrs<S> p = stage_ptrs<S>(slot(t), 1, CN, CK, A);
    const size_t rt = (size_t)t * R + r;
    uint64_t* bar = bars + t % 3;
    // no proxy fence: the slot's last reads ended before the barrier that
    // precedes this rewrite (as in CUTLASS's TMA pipelines)
    if (lane == 0) mbar_expect(bar, slot_tx);
    __syncwarp();
    int k = 0;
    auto bulk = [&](void* dst, const void* src, size_t bytes) {
      if (lane == (k++ & 31)) bulk_g2s(dst, src, (unsigned)bytes, bar);
    };
    bulk(p.mu_k, in.mu_k + rt * CK, CK * sizeof(S));
    bulk(p.c1_k, in.c1_k + rt * CK, CK * sizeof(S));
    bulk(p.c2_k, in.c2_k + rt * CK, CK * sizeof(S));
    for (int q = 0; q < 3; ++q)
      bulk(p.suc + q * ACK, in.suc + (((size_t)t * 3 + q) * R + r) * ACK, ACK * sizeof(S));
    for (int q = 0; q < 6; ++q)  // [mu, c1, c2][n, n2]
      bulk(p.nsl + q * CN, in.nsl + (size_t)t * 6 * RC + (size_t)q * RC + (size_t)r * CN,
           CN * sizeof(S));
    bulk(p.cand_n, in.cand_n + rt * CN, CN * sizeof(int));
    bulk(p.brow_same, in.brow_same + rt * CN, CN * sizeof(int));
    bulk(p.brow_next, in.brow_next + rt * CN, CN * sizeof(int));
    bulk(p.bcol_same, in.bcol_same + rt * CK, CK * sizeof(int));
    bulk(p.bcol_suc, in.bcol_suc + rt * ACK, ACK * sizeof(int));
    bulk(p.hd, in.hd + rt * NC, NC * sizeof(short));
    bulk(p.allowed, in.allowed + rt * NC, NC);
    bulk(slot_live(t), live + rt * CK, CK);
    bulk(slot_ks(t), ks + rt * CK, CK * sizeof(int));
    if constexpr (FSH) bulk(slot_fwd(t), fwd + rt * col, col * sizeof(S));
    if (lane == 31) {  // sig[t - 1], sig[t]; a row that reads neither gets 0
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
      cp_async_elems(reinterpret_cast<int*>(p.d01),
                     reinterpret_cast<const int*>(in.d01 + rt * CN), CN / 4, 0, 1);
      cp_async_elems(reinterpret_cast<int*>(p.d02),
                     reinterpret_cast<const int*>(in.d02 + rt * CN), CN / 4, 0, 1);
      cp_async_commit();
    }
  };
  // the k-mer moments of row u >= 1 (ref: NTC.cpp:1059-1130), on thread i
  // of the n >= CK idle threads (n a multiple of 32)
  auto moments = [&](int u, int i, int n) {
    const StagePtrs<S> p = stage_ptrs<S>(slot(u), 1, CN, CK, A);
    const unsigned char* lv = slot_live(u);
    const S* fu = FSH ? slot_fwd(u) : fwd + ((size_t)u * R + r) * col;
    const S* ou = cols + (u & 1) * col;
    int k = -1;
    S e0 = S(0), e1 = S(0), e2 = S(0);
    if (i < CK && lv[i]) {  // slot i's bin, loaded before the w pass
      k = slot_ks(u)[i];
      e0 = em_r[k];
      e1 = em_r[K + k];
      e2 = em_r[2 * K + k];
    }
    for (int c = i; c < NC; c += n) sW[c] = cell_w(fu, ou, c, NC, Zr, p.allowed[c]);
    idle_sync(n);
    if (k >= 0) {
      const S d = p.sig[0] - p.mu_k[i];  // sig[u - 1] - mu_k
      S sw = S(0), swd = S(0), swdd = S(0);
      for (int ii = 0; ii < CN; ++ii) {
        const S w = sW[ii * CK + i];
        const S wd = w * d;
        const S wdd = wd * d;
        sw = ii == 0 ? w : sw + w;
        swd = ii == 0 ? wd : swd + wd;
        swdd = ii == 0 ? wdd : swdd + wdd;
      }
      em_r[k] = e0 + sw;
      em_r[K + k] = e1 + swd;
      em_r[2 * K + k] = e2 + swdd;
    }
  };

  for (int q = 0; q < NTERMS; ++q)
    for (int c = tid; c < NC; c += NT) acc[q * astride + c] = neg_inf<S>();
  for (int k = tid; k < 3 * K; k += NT) em_r[k] = S(0);
  if (tid == 0) {
    for (int q = 0; q < 3; ++q) mbar_init(bars + q);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) issue_row(t0);
  unsigned parity = 0;  // bit q: the parity of slot q's next phase
  for (int t = t0; t >= 0; --t) {
    cp_async_wait_all();  // row t's slot: the samples, d01, d02
    mbar_wait(bars + t % 3, (parity >> (t % 3)) & 1);  // and its bulk copies
    parity ^= 1u << (t % 3);
    __syncthreads();  // visible to all; row t + 1 complete; row t + 2's bins added
    const BwdIn<S> view =
        stage_in(stage_ptrs<S>(slot(t), 1, CN, CK, A), T_pad, CN, CK, A);
    const S* f;
    if constexpr (FSH) {
      f = slot_fwd(t);
    } else {
      f = fwd + ((size_t)t * R + r) * col;
    }
    // row t - 1's slot (the one row t + 2 used) fills during row t; row t0
    // is terminal, so the other column is not read there; while phase 2
    // runs, the threads it leaves free add row t + 1's moments
    if (t > 0 && tid < 32) issue_row(t - 1);
    train_column<S, FSH>(view, tl, t, 0, 0, nm1, tm1, cols + ((t + 1) & 1) * col,
                         cols + (t & 1) * col, f, acc, astride, csm, [&](int i, int n) {
                           if (t < t0) moments(t + 1, i, n);
                         });
  }
  // outputs: backward row 0 and, with FSH, the accumulators
  for (int c = tid; c < 5 * NC; c += NT) b0[(size_t)r * 5 * NC + c] = cols[c];
  if constexpr (FSH) {
    for (int q = 0; q < NTERMS; ++q)
      for (int c = tid; c < NC; c += NT)
        tacc[((size_t)q * R + r) * NC + c] = sAcc[q * (size_t)NC + c];
  }
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------
template <typename S>
int fwd_store(const S* sig, const int* cand_n, const unsigned char* allowed,
              const short* hd, const int* row_same, const int* row_prev,
              const int* col_same, const int* col_prec, const S* mu_k,
              const S* c1_k, const S* c2_k, const S* nsl, const S* tlog, S* out,
              int R, int T_pad, int CN, int CK, int A, int NT, int shared,
              cudaStream_t stream) {
  const size_t NC = (size_t)CN * CK;
  auto go = [&](auto kernel, size_t smem) {
    cudaError_t err = launch_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<R, NT, smem, stream>>>(sig, cand_n, allowed, hd, row_same, row_prev, col_same,
                                    col_prec, mu_k, c1_k, c2_k, nsl, tlog, out, R, T_pad, CN,
                                    CK, A);
    return (int)cudaGetLastError();
  };
  if (shared) return go(fwd_store_shared_kernel<S>, fwd_store_shared_bytes<S>(CN, CK, A));
  return go(fwd_store_kernel<S>, 2 * NC * sizeof(S) + NC);
}

template <typename S>
int train(const BwdIn<S>& in, const unsigned char* live, const int* ks, const S* tlog,
          const int* N_r, const int* T_r, const S* fwd, const S* Z, S* tacc, S* em,
          S* b0, S* scratch, int K, int NT, int shared, cudaStream_t stream) {
  const int CN = in.CN, CK = in.CK, A = in.A;
  auto go = [&](auto kernel, size_t smem, auto... extra) {
    cudaError_t err = launch_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<in.R, NT, smem, stream>>>(in, live, ks, tlog, N_r, T_r, fwd, Z, tacc, em, b0,
                                       extra...);
    return (int)cudaGetLastError();
  };
  if (shared) {
    if (train_shared_bytes<S, true>(CN, CK, A) <= SMEM_LIMIT)
      return go(train_shared_kernel<S, true>, train_shared_bytes<S, true>(CN, CK, A), K);
    return go(train_shared_kernel<S, false>, train_shared_bytes<S, false>(CN, CK, A), K);
  }
  const size_t NC = (size_t)CN * CK;
  const size_t base = train_col_smem<S, false>((int)NC);
  const size_t with_acc = base + NTERMS * NC * sizeof(S);
  const int acc_shared = with_acc <= SMEM_LIMIT ? 1 : 0;
  return go(train_kernel<S>, acc_shared ? with_acc : base, scratch, K, acc_shared);
}

}  // namespace

// ---------------------------------------------------------------------------
// extern "C" entry points (ctypes); each returns cudaGetLastError() after the
// launch (0 = launched). Pointers are device pointers; stream is a
// cudaStream_t; `shared` picks the shared-column instance.
// ---------------------------------------------------------------------------
#define NTC_TRAIN_ENTRIES(S, SUF)                                              \
  extern "C" int ntc_fwd_store_##SUF(                                          \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const int* row_same, const int* row_prev,              \
      const int* col_same, const int* col_prec, const S* mu_k, const S* c1_k, \
      const S* c2_k, const S* nsl, const S* tlog, S* out, int R, int T_pad,   \
      int CN, int CK, int A, int NT, int shared, void* stream) {               \
    return fwd_store<S>(sig, cand_n, allowed, hd, row_same, row_prev,         \
                        col_same, col_prec, mu_k, c1_k, c2_k, nsl, tlog, out, \
                        R, T_pad, CN, CK, A, NT, shared, (cudaStream_t)stream); \
  }                                                                            \
  extern "C" int ntc_train_##SUF(                                              \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const unsigned char* live, const int* ks,          \
      const S* mu_k, const S* c1_k, const S* c2_k, const S* suc,              \
      const S* nsl, const S* tlog, const int* N_r, const int* T_r,            \
      const S* fwd, const S* Z, S* tacc, S* em, S* b0, S* scratch, int R,     \
      int T_pad, int CN, int CK, int A, int K, int NT, int shared,            \
      void* stream) {                                                          \
    const BwdIn<S> in{sig,       cand_n,    allowed,   hd,   d01,  d02, brow_same, \
                      brow_next, bcol_same, bcol_suc,  mu_k, c1_k, c2_k, suc,      \
                      nsl,       R,         T_pad,     CN,   CK,   A};             \
    return train<S>(in, live, ks, tlog, N_r, T_r, fwd, Z, tacc, em, b0,       \
                    scratch, K, NT, shared, (cudaStream_t)stream);             \
  }

NTC_TRAIN_ENTRIES(float, f32)
NTC_TRAIN_ENTRIES(double, f64)
