// Device helpers shared by the banded NT kernels (nt_banded.cu,
// nt_banded_train.cu) and, through ntc_lattice_common.cuh, the NTC
// kernels. Every helper rounds as the plain-torch versions in
// ops/nt_banded_batch.py round: the library is built with -fmad=false and
// without fast math, so no product is fused into a sum. Besides the
// arithmetic: cp.async copies, mbarriers and bulk copies (the TMA unit).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dynamont {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }

template <typename S>
__device__ __forceinline__ S neg_inf() { return -static_cast<S>(INFINITY); }

// torch.logaddexp: the shared infinity when both are the same infinity
// (so (-inf, -inf) -> -inf), else m + log1p(exp(-|a-b|)).
template <typename S>
__device__ __forceinline__ S logaddexp(S a, S b) {
  if (isinf(a) && a == b) return a;
  const S m = fmax_(a, b);
  return m + log1p_(exp_(-fabs_(a - b)));
}

// torch.maximum: NaN-propagating.
template <typename S>
__device__ __forceinline__ S max_nan(S a, S b) {
  return (isnan(a) || a > b) ? a : b;
}

// log N(x; mu, sd) = c1 - c2 * d * d, rounded as (c2*d)*d.
template <typename S>
__device__ __forceinline__ S score(S x, const S* mu, const S* c1,
                                   const S* c2, int i) {
  const S d = x - mu[i];
  const S c2d = c2[i] * d;
  return c1[i] - c2d * d;
}

// Band cell j of a row starting at bs is live for n in [max(bs, lower),
// min(bs + 2bw + 1, N)).
__device__ __forceinline__ bool in_band(int j, int bs, int bw, int N,
                                        int lower) {
  const int ns = bs > lower ? bs : lower;
  const int ne = (bs + 2 * bw + 1) < N ? (bs + 2 * bw + 1) : N;
  return j >= ns - bs + 1 && j < ne - bs + 1;
}

constexpr unsigned FULL_MASK = 0xffffffffu;

// Sum over the B threads' values in a fixed order: pairwise within each
// warp (lane i gets lane i + h for h = 16, ..., 1, as __shfl_down_sync
// gives it), then pairwise over the warp sums in the same way (B <= MAXT).
// A block of at most 32 threads (one warp, possibly partial, so block
// barriers) is one pairwise tree over its B lanes. The plain version
// (ops/ntc_pre_kernels._tree_sum) adds in the same order. Every thread
// gets the total; red holds B values.
template <int MAXT, typename S>
__device__ S block_sum(S v, S* red, int tid, int B) {
  if (B <= 32) {
    red[tid] = v;
    __syncthreads();
    for (int h = B >> 1; h > 0; h >>= 1) {
      if (tid < h) red[tid] = red[tid] + red[tid + h];
      __syncthreads();
    }
    return red[0];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(FULL_MASK, v, off);
  const int nw = B >> 5;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  S a[MAXT / 32];
#pragma unroll
  for (int w = 0; w < MAXT / 32; ++w) a[w] = w < nw ? red[w] : S(0);
#pragma unroll
  for (int h = MAXT / 64; h > 0; h >>= 1) {
    if (h < nw) {
#pragma unroll
      for (int w = 0; w < MAXT / 64; ++w) {
        if (w < h) a[w] = a[w] + a[w + h];
      }
    }
  }
  return a[0];
}

// Asynchronous copies from device to shared memory (cp.async, sm_80+):
// each thread's copies join a group at commit; wait_all blocks the thread
// until its own groups have landed, and a barrier after it publishes them
// to the block. `gmem` and `smem` of a 16-byte copy are 16-byte aligned.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
// one element of 4 or 8 bytes
template <typename V>
__device__ __forceinline__ void cp_async_elem(V* smem, const V* gmem) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8,
                "cp.async takes 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               ::"r"(smem_addr(smem)), "l"(gmem), "n"(sizeof(V))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// blocks until at most the N groups committed last are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n elements (n * sizeof(V) bytes, a multiple of 16, both ends
// 16-byte aligned) as 16-byte pieces, piece p by thread p mod nt.
template <typename V>
__device__ __forceinline__ void cp_async_rows(V* smem, const V* gmem, size_t n,
                                              int tid, int nt) {
  const size_t pieces = n * sizeof(V) / 16;
  for (size_t p = tid; p < pieces; p += nt)
    cp_async16(reinterpret_cast<unsigned char*>(smem) + 16 * p,
               reinterpret_cast<const unsigned char*>(gmem) + 16 * p);
}
// Copy n elements one by one, element i by thread i mod nt.
template <typename V>
__device__ __forceinline__ void cp_async_elems(V* smem, const V* gmem, int n,
                                               int tid, int nt) {
  for (int i = tid; i < n; i += nt) cp_async_elem(smem + i, gmem + i);
}

// Hopper's bulk copies (cp.async.bulk, the TMA unit): one instruction moves
// a 16-byte-aligned run of bytes from device to shared memory and counts
// them on an mbarrier in shared memory, whose phase completes once its one
// arrival (mbar_expect, with the bytes to come) and all those bytes are in.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
// blocks until the phase of parity `parity` has completed; a phase that
// never completes (bytes that never come) stops the kernel with an error
// after ~2 s instead of hanging it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  while (!mbar_done(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Bulk copies from shared to device memory: each issuing thread's copies
// join a group at bulk_commit; bulk_wait_read<N> blocks it until at most
// its N groups committed last still read their shared memory, bulk_wait<N>
// until at most N are still writing.
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders the generic proxy's accesses of shared memory before the bulk or
// tensor copies that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Dynamic shared memory above the 48 KB default needs the attribute.
template <typename F>
cudaError_t launch_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace dynamont
