// Device helpers shared by the NTC lattice kernels (ntc_lattice.cu,
// ntc_train.cu): the state and transition indices, the emission score and
// the term-list logsumexp, each rounding as the plain versions in
// ops/ntc_batch.py round (built with -fmad=false, no fast math); the row
// stages (the mbarrier and bulk-copy helpers are nt_banded_common.cuh's).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nt_banded_common.cuh"

namespace dynamont {

constexpr int NTC_MAX_THREADS = 512;
constexpr int MAX_A = 4;
enum { ST_A, ST_P, ST_S, ST_E, ST_I };
// log transitions, in ops/ntc_batch.TL_KEYS order
enum { TA1, TA2, TP1, TP2, TP3, TS1, TS2, TS3, TE2, TE3, TE4, TI1, TI2, NTL };

template <typename S>
__device__ __forceinline__ S sc_(S x, S mu, S c1, S c2) {
  const S d = x - mu;
  const S c2d = c2 * d;
  return c1 - c2d * d;
}

// logsumexp of a term list: max, exp summed in list order, log(sum) + max.
template <typename S, int N>
__device__ __forceinline__ S lse(const S (&v)[N]) {
  S m = v[0];
#pragma unroll
  for (int q = 1; q < N; ++q) m = max_nan(m, v[q]);
  if (!isfinite(m)) return m;
  S s = exp_(v[0] - m);
#pragma unroll
  for (int q = 1; q < N; ++q) s = s + exp_(v[q] - m);
  return log_(s) + m;
}

// state st of a column (5, CN, CK) at (row, col); -inf where either is -1.
template <typename S>
__device__ __forceinline__ S gat(const S* colp, int st, int row, int col,
                                 int CN, int CK) {
  if (row < 0 || col < 0) return neg_inf<S>();
  return colp[((size_t)st * CN + row) * CK + col];
}

// ---------------------------------------------------------------------------
// Row inputs and their shared-memory stages, used by the lattice kernels
// (ntc_lattice.cu) and the training kernels (ntc_train.cu)
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

// Where C staged rows of one read lie in `st` (stage_bytes' regions).
template <typename S>
struct StagePtrs {
  S *mu_k, *c1_k, *c2_k, *suc, *nsl, *sig;
  int *cand_n, *brow_same, *brow_next, *bcol_same, *bcol_suc;
  short* hd;
  unsigned char* allowed;
  signed char *d01, *d02;
};

template <typename S>
__device__ __forceinline__ StagePtrs<S> stage_ptrs(unsigned char* st, int C, int CN,
                                                   int CK, int A) {
  const size_t NC = (size_t)CN * CK, ACK = (size_t)A * CK;
  StagePtrs<S> p;
  p.mu_k = reinterpret_cast<S*>(st);
  p.c1_k = p.mu_k + (size_t)C * CK;
  p.c2_k = p.c1_k + (size_t)C * CK;
  p.suc = p.c2_k + (size_t)C * CK;
  p.nsl = p.suc + (size_t)C * 3 * ACK;
  p.sig = p.nsl + (size_t)C * 6 * CN;
  p.cand_n = reinterpret_cast<int*>(
      st + al16(((size_t)C * (3 * CK + 3 * ACK + 6 * CN) + C + 1) * sizeof(S)));
  p.brow_same = p.cand_n + (size_t)C * CN;
  p.brow_next = p.brow_same + (size_t)C * CN;
  p.bcol_same = p.brow_next + (size_t)C * CN;
  p.bcol_suc = p.bcol_same + (size_t)C * CK;
  p.hd = reinterpret_cast<short*>(
      reinterpret_cast<unsigned char*>(p.cand_n) + al16((size_t)C * (3 * CN + CK + ACK) * sizeof(int)));
  p.allowed = reinterpret_cast<unsigned char*>(p.hd) + al16((size_t)C * NC * sizeof(short));
  p.d01 = reinterpret_cast<signed char*>(p.allowed + (size_t)C * NC);
  p.d02 = p.d01 + (size_t)C * CN;
  return p;
}

// The BwdIn view of staged rows: R = 1, row ti of the stage; sig[-1] is
// the sample before its first row.
template <typename S>
__device__ __forceinline__ BwdIn<S> stage_in(const StagePtrs<S>& p, int T_pad, int CN,
                                             int CK, int A) {
  return BwdIn<S>{p.sig + 1, p.cand_n, p.allowed, p.hd, p.d01, p.d02, p.brow_same,
                  p.brow_next, p.bcol_same, p.bcol_suc, p.mu_k, p.c1_k, p.c2_k, p.suc,
                  p.nsl, 1, T_pad, CN, CK, A};
}

template <typename S>
struct PvStage {           // row t's plan inputs
  int* cand_n;             // [CN]
  int* row_same;           // [CN]
  int* row_prev;           // [CN]
  int* col_same;           // [CK]
  int* col_prec;           // [A][CK]
  short* hd;               // [NC]
  unsigned char* allowed;  // [NC]
  S* mu_k;                 // [CK]
  S* c1_k;                 // [CK]
  S* c2_k;                 // [CK]
  S* nsl;                  // [3][CN] the n-slots' mu, c1, c2
  S* x;                    // [1] sig[t - 1]
};

// Bytes of one PvStage (each region 16-byte aligned).
template <typename S>
__host__ __device__ inline size_t pv_stage_bytes(int CN, int CK, int A) {
  const size_t NC = (size_t)CN * CK;
  return al16((3 * (size_t)CN + CK + (size_t)A * CK) * sizeof(int)) +
         al16(NC * sizeof(short)) + al16(NC) +
         al16((3 * (size_t)CK + 3 * (size_t)CN + 1) * sizeof(S));
}

template <typename S>
__device__ __forceinline__ PvStage<S> pv_stage(unsigned char* base, int CN, int CK,
                                               int A) {
  const size_t NC = (size_t)CN * CK;
  int* cand_n = reinterpret_cast<int*>(base);
  int* col_same = cand_n + 3 * CN;
  short* hd = reinterpret_cast<short*>(
      base + al16((3 * (size_t)CN + CK + (size_t)A * CK) * sizeof(int)));
  unsigned char* allowed = reinterpret_cast<unsigned char*>(hd) + al16(NC * sizeof(short));
  S* mu_k = reinterpret_cast<S*>(allowed + al16(NC));
  return {cand_n,    cand_n + CN, cand_n + 2 * CN, col_same,       col_same + CK,
          hd,        allowed,     mu_k,            mu_k + CK,      mu_k + 2 * CK,
          mu_k + 3 * CK, mu_k + 3 * CK + 3 * CN};
}

// A barrier of the n threads (a multiple of 32) that run the idle work.
__device__ __forceinline__ void idle_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

}  // namespace dynamont
