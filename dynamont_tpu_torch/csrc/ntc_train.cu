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
//
// ntc_fwd_store is ntc_pv's forward half, written op for op as ntc_pv
// writes it, so its row T_r-1, state E, is bit for bit ntc_pv's fwdEf. It
// stores every row of the (T_pad, R, 5, CN, CK) forward lattice and reads
// the previous row back from the store, as ntc_bwd does.
//
// ntc_train is ntc_bwd's recurrence, op for op (its b0 is bit for bit
// ntc_bwd's row 0), holding column t+1 in a per-read double buffer in
// device memory (`scratch`) instead of a store, with, per row t < T_r-1:
//   * the 13 transition terms (TERMS order of ops/ntc_batch.py), each the
//     forward of t (read from the forward store) + transition + score +
//     the backward gathered from t+1, logaddexp'ed into a per-cell
//     accumulator. Phase 1 adds the 11 terms of the successor gathers;
//     phase 2, the thread that folds column j's I chain, adds i1 and i2,
//     which pair E and I of slot i with the stored I of slot i+1. The 13
//     accumulators live in shared memory where they fit (13 * CN*CK
//     values: 52 KB in fp32, 104 KB in fp64 at (8, 128)), else in the
//     output itself, each cell read and written by one thread per phase;
//   * the k-mer moments at rows 1..T_r-1: after its chain, the thread of
//     k-slot j sums w, w*d, w*d*d over the slot's CN cells in n order, w =
//     exp(logaddexp over the states of fwd + bwd - Z), d = sig[t-1] -
//     mu_k, and adds each sum to the slot's k-mer bin of the read's (3, K)
//     array in the output. Live slots of a column hold distinct k-mers
//     (build_plan_batch drops repeats), so no two threads share a bin in a
//     row, and rows are a barrier apart: no atomics, and the sums are
//     deterministic. A dead slot is skipped (its cells have w = 0 but its
//     k-mer may repeat a live slot's).
// Rows past T_r-1 are dead (-inf backward): their terms are -inf and their
// w are 0, which add nothing, so the kernel starts at the terminal row. A
// term of -inf is skipped: logaddexp(a, -inf) is a, exactly.
//
// What bounds them: as ntc_bwd and ntc_pv, chains of T_pad dependent
// steps, each two block barriers and ~40-90 transcendental functions per
// cell, one block per read on R of 132 SMs. ntc_fwd_store writes a 5.37 GB
// store at (16, 16384, 8, 128) fp32 (1.6 ms at the H100's 3.35 TB/s);
// ntc_train reads it back; both far below the chain's latency.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntc_lattice_common.cuh"

namespace {

using namespace dynamont;

constexpr int MAX_THREADS = NTC_MAX_THREADS;
constexpr int NTERMS = 13;
// accumulator index of each term, in ops/ntc_batch.TERMS order
enum { QE2, QE3, QE4, QS1, QS2, QS3, QP1, QP2, QP3, QA1, QA2, QI1, QI2 };

template <typename S>
__device__ __forceinline__ void acc_add(S* a, S v) {
  if (v != neg_inf<S>()) *a = logaddexp(*a, v);
}

// ---------------------------------------------------------------------------
// ntc_fwd_store: the forward lattice, every row (ref: NTC.cpp:430-495)
// ---------------------------------------------------------------------------
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
// ntc_train: the backward recurrence with the training sums
// (ref: NTC.cpp:923-1130)
// ---------------------------------------------------------------------------
template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
train_kernel(const S* __restrict__ sig, const int* __restrict__ cand_n,
             const unsigned char* __restrict__ allowed,
             const short* __restrict__ hd, const signed char* __restrict__ d01,
             const signed char* __restrict__ d02,
             const int* __restrict__ brow_same, const int* __restrict__ brow_next,
             const int* __restrict__ bcol_same, const int* __restrict__ bcol_suc,
             const unsigned char* __restrict__ live, const int* __restrict__ ks,
             const S* __restrict__ mu_k, const S* __restrict__ c1_k,
             const S* __restrict__ c2_k, const S* __restrict__ suc,
             const S* __restrict__ nsl, const S* __restrict__ tlog,
             const int* __restrict__ N_r, const int* __restrict__ T_r,
             const S* __restrict__ fwd, const S* __restrict__ Z, S* tacc, S* em,
             S* __restrict__ b0, S* scratch, int R, int T_pad, int CN, int CK,
             int A, int K, int acc_shared) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int NC = CN * CK, RC = R * CN;
  S* sAcc = reinterpret_cast<S*>(smem);  // [NTERMS][NC] when acc_shared
  S* sE = sAcc + (acc_shared ? NTERMS * (size_t)NC : 0);
  S* sI = sE + NC;  // phase 1 -> 2: E and I before the chain,
  S* sB = sI + NC;  // the chain's I coefficient and sc_i
  S* sX = sB + NC;
  unsigned char* sOk = reinterpret_cast<unsigned char*>(sX + NC);
  // term q of cell c is acc[q * astride + c]
  S* acc = acc_shared ? sAcc : tacc + (size_t)r * NC;
  const size_t astride = acc_shared ? (size_t)NC : (size_t)R * NC;
  S* em_r = em + (size_t)r * 3 * K;
  const S NEG = neg_inf<S>();
  S tl[NTL];
#pragma unroll
  for (int q = 0; q < NTL; ++q) tl[q] = tlog[q];
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const S Zr = Z[r];
  const size_t col = 5 * (size_t)NC;
  const S* sig_r = sig + (size_t)r * (T_pad - 1);
  S* buf = scratch + (size_t)r * 2 * col;  // columns t (t & 1) and t + 1
  for (int q = 0; q < NTERMS; ++q)
    for (int c = tid; c < NC; c += NT) acc[q * astride + c] = NEG;
  for (int k = tid; k < 3 * K; k += NT) em_r[k] = S(0);
  __syncthreads();

  for (int t = tm1 < T_pad - 1 ? tm1 : T_pad - 1; t >= 0; --t) {
    const size_t rt = (size_t)t * R + r;
    S* o = buf + (size_t)(t & 1) * col;
    const S* nx = buf + (size_t)((t + 1) & 1) * col;  // row t + 1
    const S* f = fwd + rt * col;
    const unsigned char* al = allowed + rt * NC;
    const int* cn_t = cand_n + rt * CN;
    const S xm = t > 0 ? sig_r[t - 1] : S(0);
    if (t == tm1) {  // the terminal column: no terms
      for (int c = tid; c < NC; c += NT) {
        const S e = (al[c] && cn_t[c / CK] == nm1) ? S(0) : NEG;
        for (int st = 0; st < 5; ++st) o[st * (size_t)NC + c] = st == ST_E ? e : NEG;
      }
    } else {
      const S x = sig_r[t];
      const S* ns = nsl + (size_t)t * 3 * 2 * RC;
      const S* sk = suc + (size_t)t * 3 * R * A * CK;
      for (int c = tid; c < NC; c += NT) {
        const int i = c / CK, j = c % CK;
        const int cn = cn_t[i];
        const bool n_pos = cn >= 1, n_lt = cn < nm1;
        const int h = (int)hd[rt * NC + c];
        const S hd1 = S(-2.0) * S(h & 15), hd2 = S(-2.0) * S((h >> 4) & 15);
        const S hd1s = S((h >> 8) & 15), hd2s = S((h >> 12) & 15);
        const int q = r * CN + i;
        const S mun2 = ns[RC + q], c1n2 = ns[2 * RC + RC + q], c2n2 = ns[4 * RC + RC + q];
        const S scn = sc_(x, ns[q], ns[2 * RC + q], ns[4 * RC + q]);
        const S scn2 = sc_(x, mun2, c1n2, c2n2);
        const size_t kj = rt * CK + j;
        const S muk = mu_k[kj], c1k = c1_k[kj], c2k = c2_k[kj];
        const S sck = sc_(x, muk, c1k, c2k);
        const S sc1 = (scn + sck) + hd1;
        const S sc2 = (scn2 + sck) + hd2;
        const int bs = brow_same[rt * CN + i], bn = brow_next[rt * CN + i];
        const int cs = bcol_same[kj];
        const S gskE = gat(nx, ST_E, bs, cs, CN, CK);
        const S gnkS = gat(nx, ST_S, bn, cs, CN, CK);
        const S a_new = n_pos ? gskE + sc1 : NEG;
        const S p_new = logaddexp(n_pos ? (gskE + tl[TE2]) + sc1 : NEG,
                                  n_lt ? (gnkS + tl[TS1]) + sc2 : NEG);
        const S fP = f[ST_P * (size_t)NC + c], fS = f[ST_S * (size_t)NC + c];
        const S fE = f[ST_E * (size_t)NC + c], fI = f[ST_I * (size_t)NC + c];
        S tp1 = NEG, tp2 = NEG, tp3 = NEG, ta1 = NEG, ta2 = NEG;
        S s_t[1 + MAX_A], e_t[2 + 2 * MAX_A], i_t[1 + 2 * MAX_A];
        s_t[0] = n_pos ? (gskE + tl[TE3]) + sc1 : NEG;
        e_t[0] = n_pos ? (gskE + tl[TE4]) + sc1 : NEG;
        const int dd1 = d01[rt * CN + i], dd2 = d02[rt * CN + i];
#pragma unroll
        for (int ai = 0; ai < MAX_A; ++ai) {
          const int cu = bcol_suc[(rt * A + ai) * CK + j];
          const size_t so = (size_t)r * A * CK + ai * CK + j;
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
          tp1 = logaddexp(tp1, (fS + tl[TP1]) + gspP);
          tp2 = logaddexp(tp2, (fE + tl[TP2]) + gspP);
          tp3 = logaddexp(tp3, (fI + tl[TP3]) + gspP);
          ta1 = logaddexp(ta1, (fE + tl[TA1]) + gnaA);
          ta2 = logaddexp(ta2, (fI + tl[TA2]) + gnaA);
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
      // phase 2: the I chain of column j, from the last n-slot down; the E
      // of slot i adds the UPDATED I of slot i + 1, and i1/i2 pair E and I
      // of slot i with the STORED I of slot i + 1 (ref: NTC.cpp:990-999)
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
            const S fE = f[ST_E * (size_t)NC + c], fI = f[ST_I * (size_t)NC + c];
            acc_add(acc + QI1 * astride + c, ((fE + tl[TI1]) + sX[c]) + stored);
            acc_add(acc + QI2 * astride + c, ((fI + tl[TI2]) + sX[c]) + stored);
          }
          stored = al[c] ? inew : NEG;
          o[ST_I * (size_t)NC + c] = stored;
          o[ST_E * (size_t)NC + c] = al[c] ? e : NEG;
          below = inew;
        }
      }
    }
    __syncthreads();
    // the k-mer moments of row t >= 1, one thread per live k-slot
    // (ref: NTC.cpp:1059-1130)
    if (t >= 1) {
      for (int j = tid; j < CK; j += NT) {
        const size_t kj = rt * CK + j;
        if (!live[kj]) continue;
        const S d = xm - mu_k[kj];
        S sw = S(0), swd = S(0), swdd = S(0);
        for (int i = 0; i < CN; ++i) {
          const int c = i * CK + j;
          S lw = (f[c] + o[c]) - Zr;
          for (int st = 1; st < 5; ++st) {
            const size_t sc = st * (size_t)NC + c;
            lw = logaddexp(lw, (f[sc] + o[sc]) - Zr);
          }
          const S w = al[c] ? exp_(lw) : S(0);
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
// host launchers
// ---------------------------------------------------------------------------
template <typename S>
int fwd_store(const S* sig, const int* cand_n, const unsigned char* allowed,
              const short* hd, const int* row_same, const int* row_prev,
              const int* col_same, const int* col_prec, const S* mu_k,
              const S* c1_k, const S* c2_k, const S* nsl, const S* tlog, S* out,
              int R, int T_pad, int CN, int CK, int A, int NT,
              cudaStream_t stream) {
  const size_t NC = (size_t)CN * CK;
  const size_t smem = 2 * NC * sizeof(S) + NC;
  cudaError_t err = launch_smem(fwd_store_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_store_kernel<S><<<R, NT, smem, stream>>>(
      sig, cand_n, allowed, hd, row_same, row_prev, col_same, col_prec, mu_k,
      c1_k, c2_k, nsl, tlog, out, R, T_pad, CN, CK, A);
  return (int)cudaGetLastError();
}

constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on sm_90

template <typename S>
int train(const S* sig, const int* cand_n, const unsigned char* allowed,
          const short* hd, const signed char* d01, const signed char* d02,
          const int* brow_same, const int* brow_next, const int* bcol_same,
          const int* bcol_suc, const unsigned char* live, const int* ks,
          const S* mu_k, const S* c1_k, const S* c2_k, const S* suc,
          const S* nsl, const S* tlog, const int* N_r, const int* T_r,
          const S* fwd, const S* Z, S* tacc, S* em, S* b0, S* scratch, int R,
          int T_pad, int CN, int CK, int A, int K, int NT,
          cudaStream_t stream) {
  const size_t NC = (size_t)CN * CK;
  const size_t base = 4 * NC * sizeof(S) + NC;
  const size_t with_acc = base + NTERMS * NC * sizeof(S);
  const int acc_shared = with_acc <= SMEM_LIMIT ? 1 : 0;
  const size_t smem = acc_shared ? with_acc : base;
  cudaError_t err = launch_smem(train_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  train_kernel<S><<<R, NT, smem, stream>>>(
      sig, cand_n, allowed, hd, d01, d02, brow_same, brow_next, bcol_same,
      bcol_suc, live, ks, mu_k, c1_k, c2_k, suc, nsl, tlog, N_r, T_r, fwd, Z,
      tacc, em, b0, scratch, R, T_pad, CN, CK, A, K, acc_shared);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// extern "C" entry points (ctypes); each returns cudaGetLastError() after the
// launch (0 = launched). Pointers are device pointers; stream is a
// cudaStream_t.
// ---------------------------------------------------------------------------
#define NTC_TRAIN_ENTRIES(S, SUF)                                              \
  extern "C" int ntc_fwd_store_##SUF(                                          \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const int* row_same, const int* row_prev,              \
      const int* col_same, const int* col_prec, const S* mu_k, const S* c1_k, \
      const S* c2_k, const S* nsl, const S* tlog, S* out, int R, int T_pad,   \
      int CN, int CK, int A, int NT, void* stream) {                           \
    return fwd_store<S>(sig, cand_n, allowed, hd, row_same, row_prev,         \
                        col_same, col_prec, mu_k, c1_k, c2_k, nsl, tlog, out, \
                        R, T_pad, CN, CK, A, NT, (cudaStream_t)stream);        \
  }                                                                            \
  extern "C" int ntc_train_##SUF(                                              \
      const S* sig, const int* cand_n, const unsigned char* allowed,          \
      const short* hd, const signed char* d01, const signed char* d02,        \
      const int* brow_same, const int* brow_next, const int* bcol_same,       \
      const int* bcol_suc, const unsigned char* live, const int* ks,          \
      const S* mu_k, const S* c1_k, const S* c2_k, const S* suc,              \
      const S* nsl, const S* tlog, const int* N_r, const int* T_r,            \
      const S* fwd, const S* Z, S* tacc, S* em, S* b0, S* scratch, int R,     \
      int T_pad, int CN, int CK, int A, int K, int NT, void* stream) {         \
    return train<S>(sig, cand_n, allowed, hd, d01, d02, brow_same, brow_next, \
                    bcol_same, bcol_suc, live, ks, mu_k, c1_k, c2_k, suc,     \
                    nsl, tlog, N_r, T_r, fwd, Z, tacc, em, b0, scratch, R,    \
                    T_pad, CN, CK, A, K, NT, (cudaStream_t)stream);            \
  }

NTC_TRAIN_ENTRIES(float, f32)
NTC_TRAIN_ENTRIES(double, f64)
