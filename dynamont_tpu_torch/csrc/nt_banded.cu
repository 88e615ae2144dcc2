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
// Design: one thread block per read. banded_bwd, banded_fwd_vit and
// banded_vit run one thread per band column (blockDim = B, a multiple of
// 32); the t-loop runs inside the kernel; the previous row lives in shared
// memory, double-buffered, so each row costs one __syncthreads(). The TPU
// kernels' (G, B) read groups, packed row lanes and T-major layout do not
// exist here. banded_bwd copies its rows' inputs (bstart, sig and a
// window of the emission parameters) into shared memory in chunks of C
// rows, from the top down, one chunk ahead of the chain; banded_fwd_vit
// does the same from the bottom up and adds the chunk's bM and bE rows,
// as the TPU kernels streamed them into VMEM; banded_vit stages its four
// stored rows the same way. banded_walk runs two warps per read:
// thread 0 walks choice rows staged in shared memory, and warp 1 copies
// the next chunk in and gathers the recorded cells' posteriors.
//
// What bounds them: the t-loop is a chain of T dependent rows, each a few
// hundred cycles of shared-memory exchange, barrier and latency; a bucket
// of R reads fills only R of the card's 132 SMs. Bytes moved (two (T, B)
// fp32 tensors written by banded_bwd, two read and three written by
// banded_fwd_vit) are far below what the memory system could carry in the
// same time. Where a row waited on its own loads from device memory
// (banded_bwd's and banded_fwd_vit's gathers from bstart[t],
// banded_fwd_vit's bM/bE, one round trip each; banded_walk's one load per
// step at an address the previous step chose), staging takes them off the
// chain: what is left is the row's arithmetic and barrier, and the walk's
// one shared-memory load per step. banded_bwd's stage holds no band rows,
// so its chunks are long (up to 256 rows) and their handovers few.
// Packing several reads per block and filling the SMs is later work.
// banded_vit has no recurrence besides the Viterbi step: it streams four
// stored (T, B) tensors in and writes three, 25 bytes per band cell in
// fp32 (a 2.0 ms bound at (32, 16384, 512) over the whole card), and all
// of a read's bytes go through its one SM: 12.5 KB a row (fp32, B 512).
// Loaded one row ahead, each row waited about a round trip to device
// memory, and its chain also formed and stored the row's posteriors a
// cell at a time. It now moves its four rows into shared memory a chunk
// of C rows ahead by bulk copies (the TMA unit), forms a chunk's
// posteriors there before its rows run and stores them by bulk copies,
// and takes two columns a thread: a row is left with the Viterbi step,
// its shared-memory exchange and its barrier. What bounds it now is the
// SM's traffic: without the Viterbi step the copies in and out alone take
// about as long (~50 GB/s an SM; PERF.md §6), and more rows in flight (C)
// is what shortens it.
//
// Exactness: every expression rounds as the plain-torch version does, op
// by op: c1 - (c2*d)*d, (E_m + sc_b) + log_m1, logaddexp as
// m + log1p(exp(-|a-b|)) (what torch.logaddexp computes), max-then-add in
// the Viterbi step, and the choice bit as the float equality
// vE_new == vM_e + lpe. The library is built with -fmad=false and without
// fast math so no product is fused into a sum. banded_fwd_vit takes the
// Viterbi step in viterbi_step and banded_vit in vit_step, which forms the
// same values in the same order, so the matrix route's choices equal the
// fused path's wherever its stored forward rows equal the fused kernel's.
//
// Traps: (1) B is the padded band width the JAX package computes; columns
// j >= 2*bw+3 are always -inf and the Z gate counts T*B cells with that B.
// (2) Backward rows above a read's T-1 are -inf and leave the carry
// untouched; reads of different T share one bucket. (3) Forward rows past
// T are never computed: banded_fwd_vit and banded_vit write LPM = LPE =
// -inf and ch = 0 there, as the plain versions do. (4) banded_fwd_vit's
// bM/bE, banded_vit's fM/fE/bM/bE and banded_walk's ch are copied in
// 16-byte pieces: the wrappers refuse a tensor that does not start
// 16-byte aligned.

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
// The rows' inputs arrive in chunks of C rows, from the top down, copied
// into shared memory (cp.async) one chunk ahead of the chain: chunk k + 1
// is in flight while chunk k's rows run. Chunk k holds rows hi = T-2 - k*C
// down to lo = max(0, hi - C + 1); its stage holds bstart and sig of those
// rows, bstart of row hi + 1, and the window of the emission parameters
// the chunk's rows gather: C + B + 2 entries of mu/c1/c2 from index
// bstart[hi + 1] - C - 2 + pad (clamped at 0). Going down, bstart falls by
// 0 or 1 a row (the input contract banded_fwd_vit relies on), so every row
// of the chunk gathers inside the window. A row whose band start leaves it
// (bstart climbing faster) turns row 0 of bM and bE into NaN, so Zb is NaN
// and every Z gate rejects the read. The window of chunk k + 1 is anchored
// at chunk k's lowest band start, which has landed when k + 1 is issued.
// Every row reads the staged copy (one struct of shared pointers, BwdStage:
// no pointer is shared memory on one path and device memory on another).
template <typename S>
struct BwdStage {
  S* mu;    // [C + B + 2] emission window
  S* c1;
  S* c2;
  S* sig;   // [C] sig[lo + i]
  int* bs;  // [C + 1] bstart[lo + i]
};

// Shared memory of banded_bwd at band width B, C rows per chunk and element
// size es: the two previous rows [2][B] of M and E, two stages of S arrays
// (the window of mu/c1/c2, sig), then two stages of bstart.
// ops/nt_banded_kernels.staging repeats the sum.
__host__ __device__ inline size_t bwd_window(int B, int C) {
  return (size_t)C + B + 2;
}
__host__ __device__ inline size_t bwd_stage_elems(int B, int C) {
  return 3 * bwd_window(B, C) + C;
}
__host__ __device__ inline size_t bwd_smem_bytes(int B, int C, int es) {
  return (4 * (size_t)B + 2 * bwd_stage_elems(B, C)) * es +
         2 * (size_t)(C + 1) * sizeof(int);
}

template <typename S>
__device__ __forceinline__ BwdStage<S> bwd_stage(unsigned char* smem, int B,
                                                 int C, int st) {
  S* w = reinterpret_cast<S*>(smem) + 4 * (size_t)B +
         st * bwd_stage_elems(B, C);
  const size_t nw = bwd_window(B, C);
  int* bs = reinterpret_cast<int*>(reinterpret_cast<S*>(smem) + 4 * (size_t)B +
                                   2 * bwd_stage_elems(B, C)) +
            st * (C + 1);
  return {w, w + nw, w + 2 * nw, w + 3 * nw, bs};
}

// First index of the emission window anchored at band start abs.
__device__ __forceinline__ int bwd_window_start(int abs, int C, int pad) {
  const int w0 = abs - C - 2 + pad;
  return w0 > 0 ? w0 : 0;
}

template <typename S>
__global__ void banded_bwd_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    S* __restrict__ bM, S* __restrict__ bE, int T_pad, int N_pad, int B,
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
  S* bM_r = bM + (size_t)r * T_pad * B;
  S* bE_r = bE + (size_t)r * T_pad * B;
  const int nchunks = (T - 1 + C - 1) / C;  // rows T-2 .. 0
  auto hi_of = [&](int k) { return T - 2 - k * C; };
  auto lo_of = [&](int k) { return hi_of(k) >= C ? hi_of(k) - C + 1 : 0; };
  const int W = (int)bwd_window(B, C);

  // start the copies of chunk k into its stage, the emission window
  // anchored at band start abs (that of row hi + 1)
  auto issue = [&](int k, int abs) {
    const BwdStage<S> s = bwd_stage<S>(smem, B, C, k & 1);
    const int hi = hi_of(k), lo = lo_of(k);
    cp_async_elems(s.bs, bs_r + lo, hi - lo + 2, j, B);
    cp_async_elems(s.sig, sig_r + lo, hi - lo + 1, j, B);
    const int w0 = bwd_window_start(abs, C, pad);
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
  S m = NEG;
  S e = (j == bw + 1) ? S(0) : NEG;
  bM_r[(size_t)(T - 1) * B + j] = m;
  bE_r[(size_t)(T - 1) * B + j] = e;
  int cur = 0;
  Ms[j] = m;
  Es[j] = e;
  int abs = bs_r[T - 1];
  if (nchunks > 0) {
    issue(0, abs);
    cp_async_wait_all();
  }
  __syncthreads();
  bool outside = false;  // a row's band left the staged window
  const size_t top = nchunks > 0 ? (size_t)(T - 2) * B + j : j;
  S* bM_t = bM_r + top;  // this thread's cell of row t, walking down
  S* bE_t = bE_r + top;
  for (int k = 0; k < nchunks; ++k) {
    const BwdStage<S> s = bwd_stage<S>(smem, B, C, k & 1);
    const int hi = hi_of(k), lo = lo_of(k);
    const int w0 = bwd_window_start(abs, C, pad);
    // chunk k's lowest band start anchors chunk k + 1's window
    if (k + 1 < nchunks) {
      abs = s.bs[0];
      issue(k + 1, abs);
    }
    for (int t = hi; t >= lo; --t) {
      const int i = t - lo;
      const S* Mn = Ms + cur * B;
      const S* En = Es + cur * B;
      const int bs = s.bs[i];
      int off = bs - 2 + pad - w0;
      if (off < 0 || off > C + 1) {
        outside = true;
        off = 0;
      }
      // a cell outside the band is -inf whatever its terms: its thread
      // skips them (columns j >= 2*bw + 2 never enter the band)
      S M_new = NEG, ext = NEG;
      if (in_band(j, bs, bw, N, 0)) {
        const bool sb = s.bs[i + 1] != bs;
        const S x = s.sig[i];
        const S sc_b = score(x, s.mu, s.c1, s.c2, off + j);      // k-mer position n-1
        const S sc_a = score(x, s.mu, s.c1, s.c2, off + j + 1);  // k-mer position n
        const int n = bs + j - 1;
        const S E_n = sb ? (j > 0 ? En[j - 1] : NEG) : En[j];
        const S M_n = sb ? Mn[j] : (j + 1 < B ? Mn[j + 1] : NEG);
        ext = (n + 1 < N) ? (M_n + sc_a) + log_m1 : NEG;
        if (n > 0) {
          M_new = E_n + sc_b;
          ext = logaddexp(ext, (E_n + sc_b) + log_e2);
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
}

// ---------------------------------------------------------------------------
// banded_fwd_vit: forward recurrence + log posteriors + Viterbi, one pass
// (ref: NT_banded.cpp:23-62 forward, 139-189 Viterbi)
// ---------------------------------------------------------------------------
// The rows' inputs arrive in chunks of C rows, copied into shared memory
// (cp.async) one chunk ahead of the chain: chunk k + 1 is in flight while
// chunk k's rows run. A stage holds the chunk's bM and bE rows, bstart and
// sig of rows t0 - 1 .. t0 + C - 1, and the window of the emission
// parameters the chunk's rows gather: C + B entries of mu/c1/c2 from
// index bstart[t0 - 1] - 2 + pad (bstart[0] for chunk 0). bstart steps by
// 0 or 1 between rows (the wire's shift bits; the host geometry whenever
// N <= T, which the CLIs' input contract guarantees), so a row's band
// start exceeds the window's by at most C. A row beyond that (bstart
// climbing faster) sets Zf to NaN, which every Z gate rejects. Every row
// reads the staged copy: no pointer is shared memory on one path and
// device memory on another.
template <typename S>
struct FwdVitStage {
  S* bM;   // [C][B] rows t0 .. t0 + C - 1
  S* bE;   // [C][B]
  S* mu;   // [B + C] emission window
  S* c1;
  S* c2;
  S* sig;  // [C] sig[t0 - 1 + i], the sample of row t0 + i
  int* bs; // [C + 1] bstart[t0 - 1 + i]
};

// Shared memory of banded_fwd_vit at band width B, C rows per chunk and
// element size es: the four previous rows [2][B], two stages of S arrays
// (bM, bE, the window, sig), then two stages of bstart. Every stage's bM
// starts 16-byte aligned (B is a multiple of 32).
// ops/nt_banded_kernels.staging repeats the sum.
__host__ __device__ inline size_t fwd_vit_stage_elems(int B, int C) {
  return 2 * (size_t)C * B + 3 * (size_t)(B + C) + C;
}
__host__ __device__ inline size_t fwd_vit_smem_bytes(int B, int C, int es) {
  return (8 * (size_t)B + 2 * fwd_vit_stage_elems(B, C)) * es +
         2 * (size_t)(C + 1) * sizeof(int);
}

template <typename S>
__device__ __forceinline__ FwdVitStage<S> fwd_vit_stage(unsigned char* smem,
                                                        int B, int C, int st) {
  S* a = reinterpret_cast<S*>(smem) + 8 * (size_t)B +
         st * fwd_vit_stage_elems(B, C);
  int* bs = reinterpret_cast<int*>(reinterpret_cast<S*>(smem) + 8 * (size_t)B +
                                   2 * fwd_vit_stage_elems(B, C)) +
            st * (C + 1);
  S* w = a + 2 * (size_t)C * B;
  return {a, a + (size_t)C * B, w, w + (B + C), w + 2 * (B + C),
          w + 3 * (B + C), bs};
}

template <typename S>
__global__ void banded_fwd_vit_kernel(
    const S* __restrict__ sig, const S* __restrict__ mu,
    const S* __restrict__ c1, const S* __restrict__ c2,
    const int* __restrict__ bstart, const int* __restrict__ T_arr,
    const int* __restrict__ N_arr, const int* __restrict__ bw_arr,
    const S* __restrict__ bM, const S* __restrict__ bE,
    const S* __restrict__ Zb, uint8_t* __restrict__ ch,
    S* __restrict__ LPM, S* __restrict__ LPE, S* __restrict__ Zf, int T_pad,
    int N_pad, int B, int pad, int C, S log_m1, S log_e2) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int nchunks = (T + C - 1) / C;

  // start the copies of chunk k (rows k*C .. k*C + n - 1) into its stage,
  // the emission window taken from band start wbs
  auto issue = [&](int k, int wbs) {
    const FwdVitStage<S> s = fwd_vit_stage<S>(smem, B, C, k & 1);
    const int t0 = k * C;
    const int n = T - t0 < C ? T - t0 : C;
    const int lo = k == 0 ? 1 : 0;  // chunk 0 has no row -1
    cp_async_rows(s.bM, bM + base + (size_t)t0 * B, (size_t)n * B, j, B);
    cp_async_rows(s.bE, bE + base + (size_t)t0 * B, (size_t)n * B, j, B);
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
    LPM[base + (size_t)t * B + j] = NEG;
    LPE[base + (size_t)t * B + j] = NEG;
    ch[base + (size_t)t * B + j] = 0;
  }
  int wbs = bs_r[0];
  issue(0, wbs);
  cp_async_wait_all();
  __syncthreads();
  {  // row 0, from chunk 0's stage
    const FwdVitStage<S> s = fwd_vit_stage<S>(smem, B, C, 0);
    const S m0 = NEG;
    const S e0 = (j == bw + 1) ? S(0) : NEG;
    LPM[base + j] = (m0 + s.bM[j]) - zb;
    LPE[base + j] = (e0 + s.bE[j]) - zb;
    ch[base + j] = 0;
    Ms[j] = m0;
    Es[j] = e0;
    VMs[j] = m0;
    VEs[j] = e0;
  }
  __syncthreads();
  int cur = 0;
  bool outside = false;  // a row's band left the staged window
  for (int k = 0; k < nchunks; ++k) {
    const FwdVitStage<S> s = fwd_vit_stage<S>(smem, B, C, k & 1);
    const int t0 = k * C;
    const int n = T - t0 < C ? T - t0 : C;
    const int wk = wbs;
    // chunk k is whole: its last band start opens chunk k + 1's window
    if (k + 1 < nchunks) {
      wbs = s.bs[C];
      issue(k + 1, wbs);
    }
    for (int i = k == 0 ? 1 : 0; i < n; ++i) {
      const int t = t0 + i;
      const int o = cur * B;
      const int bs = s.bs[i + 1];
      const bool s1 = bs != s.bs[i];
      const S x = s.sig[i];
      int off = bs - wk;
      if (off < 0 || off > C) {
        outside = true;
        off = 0;
      }
      const S sc_b = score(x, s.mu, s.c1, s.c2, off + j);
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
      const S lpm = (M_new + s.bM[i * B + j]) - zb;
      const S lpe = (E_new + s.bE[i * B + j]) - zb;
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
    cp_async_wait_all();  // chunk k + 1 has landed
    __syncthreads();
  }
  if (__syncthreads_or(outside) && j == 0) Zf[r] = static_cast<S>(NAN);
}

// ---------------------------------------------------------------------------
// banded_vit: log posteriors + Viterbi over stored forward and backward rows
// (the matrix route; ref: NT_banded.cpp:139-189)
// ---------------------------------------------------------------------------
// The four stored rows arrive in chunks of C rows one chunk ahead of the
// chain, double-buffered: thread 0 moves a chunk's rows of each tensor
// (contiguous in the read's (T_pad, B) block) by one bulk copy into its
// stage, counted on the stage's mbarrier, and the threads copy bstart of
// rows t0 - 1 .. t0 + C - 1 (cp.async). Once a chunk has landed, the block
// forms its posteriors piece by piece, lpm = (fM + bM) - Zb over the
// stage's fM rows and lpe = (fE + bE) - Zb over its fE rows, thread 0
// stores those rows to LPM and LPE by two bulk copies, and each row's two
// band starts become its band shift and live columns (VitRow). The chain
// then reads a row's lpm, lpe and VitRow from shared memory and stores its
// choice bits a row at a time. No emission parameter is gathered, so there
// is no window a band start could leave and no exit case. Measured on the
// card (PERF.md §6): the threads' cp.async and 16-byte stores, a ring
// of more, shorter chunks, a bulk copy a row, choice rows written out a
// chunk at a time, an L2 prefetch, and one or four columns a thread were
// each as fast or slower.
template <typename S>
struct VitStage {
  S* fM;    // [C][B] rows t0 .. t0 + C - 1; lpm once formed
  S* fE;    // [C][B]; lpe once formed
  S* bM;    // [C][B]
  S* bE;    // [C][B]
  int* bs;  // [C + 1] bstart[t0 - 1 + i]
};

// A row's band shift s1 (0 or 1) and its live columns [lo, hi): in_band's
// bounds with lower 1.
struct __align__(16) VitRow {
  int lo, hi, s1, unused;
};

// Columns a thread of banded_vit takes: two adjacent band columns, so a
// row's record, loop and barrier are paid once for two cells and B / 2
// threads (whole or half warps) share the barrier.
constexpr int VIT_COLS = 2;

// Shared memory of banded_vit at band width B, C rows per chunk and element
// size es: two stages of the four stored rows [4][C][B], the Viterbi rows
// [2][B + 4] of M and E (column c at c + 2, -inf at -1 and B), the chunk's
// VitRows [C], the stages' two mbarriers, then two stages of bstart. The
// stages, the Viterbi rows, the VitRows and the mbarriers start 16-byte
// aligned (B is a multiple of 32). ops/nt_banded_kernels.staging repeats
// the sum.
__host__ __device__ inline size_t vit_stage_elems(int B, int C) {
  return 4 * (size_t)C * B;
}
__host__ __device__ inline size_t vit_smem_bytes(int B, int C, int es) {
  return (2 * vit_stage_elems(B, C) + 4 * (size_t)(B + 4)) * es +
         (size_t)C * sizeof(VitRow) + 2 * sizeof(uint64_t) +
         2 * (size_t)(C + 1) * sizeof(int);
}

template <typename S>
__device__ __forceinline__ VitStage<S> vit_stage(unsigned char* smem, int B,
                                                 int C, int st) {
  const size_t rows = (size_t)C * B;
  S* a = reinterpret_cast<S*>(smem) + st * vit_stage_elems(B, C);
  int* bs = reinterpret_cast<int*>(
                smem + (2 * vit_stage_elems(B, C) + 4 * (size_t)(B + 4)) * sizeof(S) +
                (size_t)C * sizeof(VitRow) + 2 * sizeof(uint64_t)) +
            st * (C + 1);
  return {a, a + rows, a + 2 * rows, a + 3 * rows, bs};
}

// 16 bytes as one vector move and as elements of S.
template <typename S>
union Piece {
  uint4 u;
  S v[16 / sizeof(S)];
};

// A thread's VIT_COLS adjacent cells as one vector move.
template <typename S>
struct alignas(VIT_COLS * sizeof(S)) Cols {
  S v[VIT_COLS];
};
// and their choice bytes as one store
using ChoiceBytes = uint16_t;
static_assert(sizeof(ChoiceBytes) == VIT_COLS, "a choice byte a column");

// viterbi_step's values for adjacent columns c .. c + VIT_COLS - 1 over
// Viterbi rows with a -inf cell at each end (vm[-1] = vm[B] = -inf): the
// shift picks the source columns by index, c - 1 + s1 for vE_m and c + s1
// for vM_e and vE_e, with no select and no edge test. The same values in
// the same order, so the same choice bits (cell u's in byte u). vm and ve
// point at column c of the previous row.
template <typename S>
__device__ __forceinline__ ChoiceBytes vit_step(const S* vm, const S* ve, int s1,
                                                const bool (&valid)[VIT_COLS],
                                                const Cols<S>& lpm, const Cols<S>& lpe,
                                                Cols<S>& vM_new, Cols<S>& vE_new) {
  constexpr int J = VIT_COLS;
  const S NEG = neg_inf<S>();
  S e[J + 1], m[J];
#pragma unroll
  for (int u = 0; u <= J; ++u) e[u] = ve[u - 1 + s1];
#pragma unroll
  for (int u = 0; u < J; ++u) m[u] = vm[u + s1];
  ChoiceBytes bits = 0;
#pragma unroll
  for (int u = 0; u < J; ++u) {
    vM_new.v[u] = valid[u] ? e[u] + lpm.v[u] : NEG;
    vE_new.v[u] = valid[u] ? max_nan(m[u], e[u + 1]) + lpe.v[u] : NEG;
    if (vE_new.v[u] == m[u] + lpe.v[u]) bits |= 1 << (8 * u);
  }
  return bits;
}

template <typename S>
__global__ void __launch_bounds__(1024 / VIT_COLS) banded_vit_kernel(
    const S* __restrict__ fM, const S* __restrict__ fE,
    const S* __restrict__ bM, const S* __restrict__ bE,
    const S* __restrict__ Zb, const int* __restrict__ bstart,
    const int* __restrict__ T_arr, const int* __restrict__ N_arr,
    const int* __restrict__ bw_arr, uint8_t* __restrict__ ch,
    S* __restrict__ LPM, S* __restrict__ LPE, int T_pad, int B, int C) {
  constexpr int J = VIT_COLS;
  constexpr int E = 16 / sizeof(S);  // elements of a 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = threadIdx.x;
  const int NT = B / J;   // threads
  const int c0 = J * q;   // this thread's first column
  // the Viterbi rows [2][B + 4], at this thread's first column of row buffer 0
  S* vm_c = reinterpret_cast<S*>(smem) + 2 * vit_stage_elems(B, C) + 2 + c0;
  S* ve_c = vm_c + 2 * (B + 4);
  VitRow* rows_s = reinterpret_cast<VitRow*>(
      reinterpret_cast<S*>(smem) + 2 * vit_stage_elems(B, C) + 4 * (B + 4));  // [C]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + C);  // [2], one a stage
  const int r = blockIdx.x;
  const S NEG = neg_inf<S>();
  const int T = T_arr[r], N = N_arr[r], bw = bw_arr[r];
  const S zb = Zb[r];
  const int* bs_r = bstart + (size_t)r * T_pad;
  const size_t base = (size_t)r * T_pad * B;
  const int nchunks = (T + C - 1) / C;
  auto rows_of = [&](int k) { return T - k * C < C ? T - k * C : C; };

  // start the copies of chunk k (rows k*C .. k*C + n - 1) into its stage,
  // once the bulk stores that read the stage (chunk k - 2's) are done
  auto issue = [&](int k) {
    const VitStage<S> s = vit_stage<S>(smem, B, C, k & 1);
    const int t0 = k * C, n = rows_of(k);
    if (q == 0) {
      const size_t o = base + (size_t)t0 * B;
      const unsigned bytes = (unsigned)(n * B * sizeof(S));
      bulk_wait_read<1>();
      fence_proxy_async();  // the stage's last reads, before its rewrite
      mbar_expect(bars + (k & 1), 4 * bytes);
      bulk_g2s(s.fM, fM + o, bytes, bars + (k & 1));
      bulk_g2s(s.fE, fE + o, bytes, bars + (k & 1));
      bulk_g2s(s.bM, bM + o, bytes, bars + (k & 1));
      bulk_g2s(s.bE, bE + o, bytes, bars + (k & 1));
    }
    const int lo = k == 0 ? 1 : 0;  // chunk 0 has no row -1
    cp_async_elems(s.bs + lo, bs_r + t0 - 1 + lo, n + 1 - lo, q, NT);
    cp_async_commit();
  };
  // blocks until chunk k has landed
  auto wait = [&](int k) {
    cp_async_wait_all();
    mbar_wait(bars + (k & 1), (k >> 1) & 1);
    __syncthreads();
  };
  // chunk k's posteriors, formed over its stage's fM and fE rows a 16-byte
  // piece at a time and stored to LPM and LPE by thread 0, and its VitRows
  auto post = [&](int k) {
    const VitStage<S> s = vit_stage<S>(smem, B, C, k & 1);
    const int n = rows_of(k);
    for (int p = q; p < n * B / E; p += NT) {
      Piece<S> m, e, bm, be;
      m.u = reinterpret_cast<const uint4*>(s.fM)[p];
      e.u = reinterpret_cast<const uint4*>(s.fE)[p];
      bm.u = reinterpret_cast<const uint4*>(s.bM)[p];
      be.u = reinterpret_cast<const uint4*>(s.bE)[p];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        m.v[i] = (m.v[i] + bm.v[i]) - zb;
        e.v[i] = (e.v[i] + be.v[i]) - zb;
      }
      reinterpret_cast<uint4*>(s.fM)[p] = m.u;
      reinterpret_cast<uint4*>(s.fE)[p] = e.u;
    }
    for (int i = q; i < n; i += NT) {  // chunk 0's row 0 takes no step
      const int bs = s.bs[i + 1];
      const int ns = bs > 1 ? bs : 1;
      const int ne = (bs + 2 * bw + 1) < N ? (bs + 2 * bw + 1) : N;
      rows_s[i] = {ns - bs + 1, ne - bs + 1, bs != s.bs[i] ? 1 : 0, 0};
    }
    fence_proxy_async();  // the rows just written, before the bulk stores
    __syncthreads();
    if (q == 0) {
      const size_t o = base + (size_t)k * C * B;
      const unsigned bytes = (unsigned)(n * B * sizeof(S));
      bulk_s2g(LPM + o, s.fM, bytes);
      bulk_s2g(LPE + o, s.fE, bytes);
      bulk_commit();
    }
  };

  {  // rows past the read: defined fill
    const size_t o = base + (size_t)T * B;
    const size_t cells = (size_t)(T_pad - T) * B;
    Piece<S> neg;
#pragma unroll
    for (int i = 0; i < E; ++i) neg.v[i] = NEG;
    for (size_t p = q; p < cells / E; p += NT) {
      reinterpret_cast<uint4*>(LPM + o)[p] = neg.u;
      reinterpret_cast<uint4*>(LPE + o)[p] = neg.u;
    }
    for (size_t p = q; p < cells / 16; p += NT)
      reinterpret_cast<uint4*>(ch + o)[p] = make_uint4(0, 0, 0, 0);
  }
  if (q == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_fence_init();
  }
  __syncthreads();
  issue(0);
#pragma unroll
  for (int u = 0; u < J; ++u) {
    vm_c[u] = NEG;
    ve_c[u] = (c0 + u == bw + 1) ? S(0) : NEG;
  }
  if (q < 2) {  // the -inf cells at both ends of both rows
    S* vm = vm_c - c0 + q * (B + 4);  // column 0 of row buffer q
    vm[-1] = vm[B] = NEG;
    vm[2 * (B + 4) - 1] = vm[2 * (B + 4) + B] = NEG;
  }
  *reinterpret_cast<ChoiceBytes*>(ch + base + c0) = 0;  // row 0 takes no step
  wait(0);
  post(0);
  int o = 0;  // the previous row's buffer: 0 or B + 4
  for (int k = 0; k < nchunks; ++k) {
    const VitStage<S> s = vit_stage<S>(smem, B, C, k & 1);
    if (k + 1 < nchunks) issue(k + 1);
    const int i0 = k == 0 ? 1 : 0, n = rows_of(k);
    const S* lm = s.fM + i0 * B + c0;
    const S* le = s.fE + i0 * B + c0;
    ChoiceBytes* ch_t = reinterpret_cast<ChoiceBytes*>(ch + base + (size_t)(k * C + i0) * B + c0);
    for (int i = i0; i < n; ++i, lm += B, le += B, ch_t += B / J) {
      const VitRow w = rows_s[i];
      bool valid[J];
#pragma unroll
      for (int u = 0; u < J; ++u) valid[u] = c0 + u >= w.lo && c0 + u < w.hi;
      Cols<S> vM_new, vE_new;
      *ch_t = vit_step(vm_c + o, ve_c + o, w.s1, valid, *reinterpret_cast<const Cols<S>*>(lm),
                       *reinterpret_cast<const Cols<S>*>(le), vM_new, vE_new);
      o = (B + 4) - o;
      *reinterpret_cast<Cols<S>*>(vm_c + o) = vM_new;
      *reinterpret_cast<Cols<S>*>(ve_c + o) = vE_new;
      __syncthreads();
    }
    if (k + 1 < nchunks) {
      wait(k + 1);
      post(k + 1);
    }
  }
  if (q == 0) bulk_wait<0>();  // the last bulk stores have landed
}

// ---------------------------------------------------------------------------
// banded_walk: reverse MAP traceback (ref: NT_banded.cpp:204-250), one
// block of two warps per read
// ---------------------------------------------------------------------------
// The chain of T steps needs only ch[t, j] and bstart: thread 0 walks it
// over choice rows staged in shared memory, reverse chunks of
// C = WALK_ROWS rows, and records (n, j, flags) per row. Warp 1 copies
// chunk k + 1 in (cp.async)
// and, for chunk k - 1's records, gathers LPM/LPE at the recorded cells
// and writes path_n, prob and close, while thread 0 walks chunk k. Chunk k
// holds rows hi = T-1 - k*C down to lo = max(1, hi - C + 1), and bstart of
// rows lo - 1 .. hi.
constexpr int WALK_THREADS = 64;
constexpr int WALK_ROWS = 64;  // C, the rows of one chunk
constexpr uint8_t WALK_ACTIVE = 1, WALK_IN_M = 2, WALK_IN_BAND = 4;

// Shared memory of banded_walk: two stages of C choice rows [C][B] (uint8)
// and of bstart [C + 1], then two chunks of records: n and j [C] (int),
// flags [C] (uint8).
__host__ __device__ inline size_t walk_smem_bytes(int B) {
  constexpr int C = WALK_ROWS;
  return 2 * (size_t)C * B + 2 * (size_t)(C + 1) * sizeof(int) +
         2 * (size_t)C * (2 * sizeof(int) + 1);
}

template <typename S>
__global__ void banded_walk_kernel(
    const S* __restrict__ LPM, const S* __restrict__ LPE,
    const uint8_t* __restrict__ ch, const int* __restrict__ bstart,
    const int* __restrict__ T_arr, const int* __restrict__ N_arr,
    const int* __restrict__ bw_arr, int* __restrict__ path_n,
    S* __restrict__ prob, uint8_t* __restrict__ close, int T_pad, int B,
    int N_max) {
  constexpr int C = WALK_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* chs = smem;                                          // [2][C][B]
  int* bss = reinterpret_cast<int*>(smem + 2 * (size_t)C * B);  // [2][C+1]
  int* rec_n = bss + 2 * (C + 1);                               // [2][C]
  int* rec_j = rec_n + 2 * C;                                   // [2][C]
  uint8_t* rec_f = reinterpret_cast<uint8_t*>(rec_j + 2 * C);   // [2][C]
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int h = tid - 32;  // lane in warp 1
  const int T = T_arr[r];
  const int* bs_r = bstart + (size_t)r * T_pad;
  const size_t base = (size_t)r * T_pad * B;
  int* pn_r = path_n + (size_t)r * (T_pad - 1);
  S* pr_r = prob + (size_t)r * (T_pad - 1);
  uint8_t* cl_r = close + (size_t)r * (T_pad - 1);
  const int nchunks = T > 1 ? (T - 1 + C - 1) / C : 0;
  auto hi_of = [&](int k) { return T - 1 - k * C; };
  auto lo_of = [&](int k) { return hi_of(k) > C ? hi_of(k) - C + 1 : 1; };

  auto issue = [&](int k) {  // warp 1: chunk k into its stage
    const int hi = hi_of(k), lo = lo_of(k), st = k & 1;
    cp_async_rows(chs + (size_t)st * C * B, ch + base + (size_t)lo * B,
                  (size_t)(hi - lo + 1) * B, h, 32);
    cp_async_elems(bss + st * (C + 1), bs_r + lo - 1, hi - lo + 2, h, 32);
    cp_async_commit();
  };
  auto emit = [&](int k) {  // warp 1: chunk k's outputs from its records
    const int hi = hi_of(k), lo = lo_of(k), st = k & 1;
    for (int i = h; i < hi - lo + 1; i += 32) {
      const int t = hi - i;
      const uint8_t f = rec_f[st * C + i];
      int pn = N_max;
      S p = S(0);
      uint8_t cl = 0;
      if (f & WALK_ACTIVE) {
        S lp = S(0);  // columns outside the band array read 0 / no
        if (f & WALK_IN_BAND) {
          const size_t cell = base + (size_t)t * B + rec_j[st * C + i];
          lp = (f & WALK_IN_M) ? LPM[cell] : LPE[cell];
        }
        p = exp_(isnan(lp) ? lp : (lp < S(0) ? lp : S(0)));
        if (isnan(p)) p = S(0);
        pn = rec_n[st * C + i];
        cl = (f & WALK_IN_M) ? 1 : 0;
      }
      pn_r[t - 1] = pn;
      pr_r[t - 1] = p;
      cl_r[t - 1] = cl;
    }
  };

  // rows past the read are inactive: no chain
  for (int t = (T > 1 ? T : 1) + tid; t < T_pad; t += WALK_THREADS) {
    pn_r[t - 1] = N_max;
    pr_r[t - 1] = S(0);
    cl_r[t - 1] = 0;
  }
  if (h >= 0 && nchunks > 0) {
    issue(0);
    cp_async_wait_all();
  }
  __syncthreads();
  int n = N_arr[r] - 1;  // thread 0's walk state
  int j = bw_arr[r] + 1;
  bool is_m = false;
  for (int k = 0; k <= nchunks; ++k) {
    if (h >= 0) {
      if (k + 1 < nchunks) issue(k + 1);
      if (k > 0) emit(k - 1);
      cp_async_wait_all();
    } else if (tid == 0 && k < nchunks) {
      const int hi = hi_of(k), lo = lo_of(k), st = k & 1;
      const uint8_t* c_s = chs + (size_t)st * C * B;
      const int* b_s = bss + st * (C + 1);  // b_s[t - lo + 1] = bstart[t]
      for (int t = hi; t >= lo; --t) {
        const int i = hi - t;
        if (n < 1) {  // an inactive row leaves (n, j, is_m) untouched
          rec_f[st * C + i] = 0;
          continue;
        }
        const int row = t - lo;
        const int s = b_s[row + 1] != b_s[row] ? 1 : 0;
        const bool inb = j >= 0 && j < B;
        const bool c = inb && c_s[(size_t)row * B + j] != 0;
        rec_n[st * C + i] = n;
        rec_j[st * C + i] = j;
        rec_f[st * C + i] = WALK_ACTIVE | (is_m ? WALK_IN_M : 0) |
                            (inb ? WALK_IN_BAND : 0);
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
    __syncthreads();
  }
}

template <typename S>
int launch_bwd(const S* sig, const S* mu, const S* c1, const S* c2,
               const int* bstart, const int* T, const int* N, const int* bw,
               S* bM, S* bE, int R, int T_pad, int N_pad, int B, int pad,
               int C, double log_m1, double log_e2, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(B, C, sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(
      banded_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_bwd_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, bM, bE, T_pad, N_pad, B, pad, C,
      static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_fwd_vit(const S* sig, const S* mu, const S* c1, const S* c2,
                   const int* bstart, const int* T, const int* N,
                   const int* bw, const S* bM, const S* bE, const S* Zb,
                   uint8_t* ch, S* LPM, S* LPE, S* Zf, int R, int T_pad,
                   int N_pad, int B, int pad, int C, double log_m1,
                   double log_e2, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_vit_smem_bytes(B, C, sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(
      banded_fwd_vit_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_fwd_vit_kernel<S><<<R, B, smem, (cudaStream_t)stream>>>(
      sig, mu, c1, c2, bstart, T, N, bw, bM, bE, Zb, ch, LPM, LPE, Zf, T_pad,
      N_pad, B, pad, C, static_cast<S>(log_m1), static_cast<S>(log_e2));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_walk(const S* LPM, const S* LPE, const uint8_t* ch,
                const int* bstart, const int* T, const int* N, const int* bw,
                int* path_n, S* prob, uint8_t* close, int R, int T_pad, int B,
                int N_max, void* stream) {
  const size_t smem = walk_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      banded_walk_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_walk_kernel<S><<<R, WALK_THREADS, smem, (cudaStream_t)stream>>>(
      LPM, LPE, ch, bstart, T, N, bw, path_n, prob, close, T_pad, B, N_max);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_vit(const S* fM, const S* fE, const S* bM, const S* bE,
               const S* Zb, const int* bstart, const int* T, const int* N,
               const int* bw, uint8_t* ch, S* LPM, S* LPE, int R, int T_pad,
               int B, int C, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = vit_smem_bytes(B, C, sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(
      banded_vit_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_vit_kernel<S><<<R, B / VIT_COLS, smem, (cudaStream_t)stream>>>(
      fM, fE, bM, bE, Zb, bstart, T, N, bw, ch, LPM, LPE, T_pad, B, C);
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
      int C, double log_m1, double log_e2, void* stream) {                   \
    return launch_bwd<S>((const S*)sig, (const S*)mu, (const S*)c1,          \
                         (const S*)c2, (const int*)bstart, (const int*)T,    \
                         (const int*)N, (const int*)bw, (S*)bM, (S*)bE, R,   \
                         T_pad, N_pad, B, pad, C, log_m1, log_e2, stream);   \
  }                                                                           \
  extern "C" int nt_banded_fwd_vit_##SUFFIX(                                  \
      const void* sig, const void* mu, const void* c1, const void* c2,       \
      const void* bstart, const void* T, const void* N, const void* bw,      \
      const void* bM, const void* bE, const void* Zb, void* ch, void* LPM,   \
      void* LPE, void* Zf, int R, int T_pad, int N_pad, int B, int pad,      \
      int C, double log_m1, double log_e2, void* stream) {                   \
    return launch_fwd_vit<S>(                                                 \
        (const S*)sig, (const S*)mu, (const S*)c1, (const S*)c2,             \
        (const int*)bstart, (const int*)T, (const int*)N, (const int*)bw,    \
        (const S*)bM, (const S*)bE, (const S*)Zb, (uint8_t*)ch, (S*)LPM,     \
        (S*)LPE, (S*)Zf, R, T_pad, N_pad, B, pad, C, log_m1, log_e2,         \
        stream);                                                             \
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
      int B, int C, void* stream) {                                          \
    return launch_vit<S>((const S*)fM, (const S*)fE, (const S*)bM,          \
                         (const S*)bE, (const S*)Zb, (const int*)bstart,     \
                         (const int*)T, (const int*)N, (const int*)bw,       \
                         (uint8_t*)ch, (S*)LPM, (S*)LPE, R, T_pad, B, C,     \
                         stream);                                            \
  }

DEFINE_ENTRY_POINTS(float, f32)
DEFINE_ENTRY_POINTS(double, f64)
