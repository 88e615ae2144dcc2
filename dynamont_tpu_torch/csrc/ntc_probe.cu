// Micro-probe kernel for Hopper (sm_90a): the building blocks of the NTC
// backward kernel, each applied ITERS times to one (128, 128) float32 tile.
//
//   ntc_microop replaces scripts/probe_ntc_microops.py::run_block (#21)
//
// The TPU probe runs one block of dynamont_tpu/ops/ntc_pallas.py's K13
// (_bwd_kernel) in a fori_loop, y = body(y, aux) * 0.999, on the TPU's
// (RC, CK) = (128, 128) state tile: 16 reads x 8 n-slots on the rows, 128
// k-slots on the lanes. Here one block of 1024 threads holds the tile (y
// and aux, 64 KB each) in shared memory; thread b owns lane j = b % 128 of
// the read groups b / 128 and b / 128 + 8 (16 cells), in registers. Blocks
// that read other threads' cells (the rolls, the row and column gathers,
// gat) write the new tile back between two barriers; the others stay in
// registers. Each block computes the values of its plain version in
// ops/ntc_probe_kernels.py, op by op (built with -fmad=false, no fast
// math), which holds them against the TPU block:
//
//   TPU blocks  noop; roll of the rows by 1, 4, 127, 124 and of the lanes by
//               1; _affine_chain up and down (log2(8) doubling steps within
//               each read's 8 rows); _row_gather of 2 and 5 blocks (the row
//               base + aux[m, 0] of the tile, 0 where no row is that, -inf
//               where aux[m, 0] < 0); _col_gather of 4 and 16 blocks by
//               k-mer value equality (the first source slot s of the read
//               whose value |aux[s, r] * 100| mod 1024 equals the target,
//               the targets _dst_vals' 'same', 'suc' and 'prec' of aux[r, j]
//               mod 1024; only the gathers the block returns are formed,
//               with the matched slot for the 16-block one); the 13-term
//               _lse; _unpack_hd of aux as int16; the (24, 128) transpose-sum.
//   card forms  how K13 (ntc_lattice.cu, bwd_column) does the same jobs: a
//               gather through a slot map computed once (gat), the
//               sequential I-chain fold of its phase 2, the emission score
//               sc_, and a bare pair of block barriers.
//
// What bounds it: nothing the card's rates give. Three 64 KB tiles move once
// and each block does a handful of operations per cell and iteration; its
// time per iteration is the dependent chain of one iteration (plus the
// barriers), which is what the probe measures.

#include <cuda_runtime.h>
#include <math.h>

#include "ntc_lattice_common.cuh"

namespace {

using namespace dynamont;

constexpr int RC = 128, CK = 128, NR = 16, CN = 8, NA = 4;
constexpr int TILE = RC * CK;
constexpr int NT = 1024;  // threads: 8 slabs of 128 lanes, 2 read groups each
constexpr float DECAY = (float)0.999;
constexpr float NEG_BIG = (float)-1e30;  // the TPU kernels' finite -inf proxy
constexpr float NEG_THR = (float)-5e29;
constexpr float KMERS = 1024.0f, STEP = 256.0f;  // K and K / A of the probe
constexpr float SC_C1 = (float)-0.5, SC_C2 = (float)0.01;

enum {
  NOOP, ROLL_UP_1, ROLL_UP_4, ROLL_DOWN_127, ROLL_DOWN_124, ROLL_LANE_1,
  AFFINE_UP, AFFINE_DOWN, ROW_GATHER_2, ROW_GATHER_5, COL_GATHER_4,
  COL_GATHER_16, LSE_13, UNPACK_HD, TRANSPOSE_24, GAT, FOLD, SC, SYNC_PAIR,
  NBLOCKS
};

__host__ __device__ constexpr bool crosses(int b) {
  return (b >= ROLL_UP_1 && b <= ROLL_LANE_1) || b == ROW_GATHER_2 ||
         b == ROW_GATHER_5 || b == COL_GATHER_4 || b == COL_GATHER_16 || b == GAT;
}

// torch.remainder (and jnp's %) of floats: fmod, moved to the divisor's sign.
__device__ __forceinline__ float rem_(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = m + b;
  return m;
}

// A gathered source value as the TPU's one-hot matmul returns it: clamped
// to NEG_BIG on the way in, -inf again below NEG_THR.
__device__ __forceinline__ float gathered(float v) {
  const float g = max_nan(v, NEG_BIG);
  return g <= NEG_THR ? neg_inf<float>() : g;
}

// Source value of slot s of read r (_col_gather's ksT), -1 for a dead slot.
__device__ __forceinline__ float src_val(const float* as, int s, int r) {
  const float a = as[s * CK + r];
  return a > -1.0f ? rem_(fabsf(a * 100.0f), KMERS) : -1.0f;
}

// First source slot of read r holding value v, -1 where none does.
__device__ __forceinline__ int first_slot(const float* as, int r, float v) {
  for (int s = 0; s < CK; ++s)
    if (src_val(as, s, r) == v) return s;
  return -1;
}

// Row m's value of a row-crossing block at lane j, from the tile ys.
template <int B>
__device__ __forceinline__ float cross_cell(const float* ys, const float* as,
                                            const int* rmap, const int* cmap,
                                            int m, int j) {
  const float NEG = neg_inf<float>();
  if constexpr (B == ROLL_UP_1) return ys[((m - 1) & (RC - 1)) * CK + j];
  if constexpr (B == ROLL_UP_4) return ys[((m - 4) & (RC - 1)) * CK + j];
  if constexpr (B == ROLL_DOWN_127) return ys[((m - 127) & (RC - 1)) * CK + j];
  if constexpr (B == ROLL_DOWN_124) return ys[((m - 124) & (RC - 1)) * CK + j];
  if constexpr (B == ROLL_LANE_1) return ys[m * CK + ((j - 1) & (CK - 1))];
  if constexpr (B == ROW_GATHER_2 || B == ROW_GATHER_5) {
    const float idx = as[m * CK];
    const float tgt = (float)((m / CN) * CN) + idx;
    const bool hit = tgt >= 0.0f && tgt < (float)RC && floorf(tgt) == tgt;
    const float v = hit ? ys[(int)tgt * CK + j] : 0.0f;
    float g0 = hit ? max_nan(v, NEG_BIG) : 0.0f;
    g0 = g0 <= NEG_THR ? NEG : g0;
    g0 = idx >= 0.0f ? g0 : NEG;
    if constexpr (B == ROW_GATHER_2) {
      float g1 = hit ? max_nan(v * 0.5f, NEG_BIG) : 0.0f;
      g1 = g1 <= NEG_THR ? NEG : g1;
      g1 = idx >= 0.0f ? g1 : NEG;
      return g0 + g1;
    } else {
      float s = 0.0f + g0;
      for (int q = 1; q < 5; ++q) s = s + g0;
      return s;
    }
  }
  if constexpr (B == GAT) {
    const int r = m / CN;
    return gat(ys + r * CN * CK, 0, rmap[m], cmap[r * CK + j], CN, CK);
  }
  return 0.0f;
}

// The column gathers of read r at lane j into rows r*8 .. r*8+7 of n.
template <int B>
__device__ __forceinline__ void col_gather(const float* ys, const float* as, int r,
                                           int j, float* n) {
  const float ks = rem_(as[r * CK + j], KMERS);  // the read's own value
  const bool ok = ks >= 0.0f;
  const float same = ok ? ks : -2.0f;
  float tgt;
  if constexpr (B == COL_GATHER_4)  // 'suc', digit 0
    tgt = ok ? (ks - STEP * floorf(ks / STEP)) * (float)NA + 0.0f : -2.0f;
  else  // 'prec', digit 0
    tgt = ok ? floorf(ks / (float)NA) + 0.0f * STEP : -2.0f;
  const int s1 = first_slot(as, r, same), s2 = first_slot(as, r, tgt);
  const float c1 = B == COL_GATHER_4 ? 1.0f : (float)0.9;
  const float c2 = B == COL_GATHER_4 ? 2.0f : (float)(0.9 + 0.01 * 15);
  for (int i = 0; i < CN; ++i) {
    const int m = r * CN + i;
    const float a = s1 >= 0 ? gathered(B == COL_GATHER_4 ? ys[m * CK + s1]
                                                         : ys[m * CK + s1] * c1)
                            : neg_inf<float>();
    const float b = s2 >= 0 ? gathered(ys[m * CK + s2] * c2) : neg_inf<float>();
    float v = a + b;
    if constexpr (B == COL_GATHER_16) v = v + (float)s1;
    n[i] = v;
  }
}

// _affine_chain over one read's 8 rows (log-affine maps a -> lse(a, a' + b)).
template <bool UP>
__device__ __forceinline__ void affine_chain(float (&a)[CN], float (&b)[CN]) {
  const float NEG = neg_inf<float>();
#pragma unroll
  for (int sh = 1; sh < CN; sh <<= 1) {
    float an[CN], bn[CN];
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const bool ok = UP ? i >= sh : i < CN - sh;
      const int k = UP ? i - sh : i + sh;
      const float ai = ok ? a[k] : NEG, bi = ok ? b[k] : 0.0f;
      an[i] = logaddexp(a[i], ai + b[i]);
      bn[i] = b[i] + bi;
    }
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      a[i] = an[i];
      b[i] = bn[i];
    }
  }
}

template <int B>
__global__ void __launch_bounds__(NT)
microop_kernel(const float* __restrict__ x, const float* __restrict__ aux,
               float* __restrict__ out, int iters) {
  extern __shared__ float sm[];
  float* ys = sm;
  float* as = sm + TILE;
  int* rmap = reinterpret_cast<int*>(as + TILE);  // GAT's slot maps
  int* cmap = rmap + RC;
  const int tid = threadIdx.x, j = tid % CK, q = tid / CK;
  for (int e = tid; e < TILE; e += NT) {
    ys[e] = x[e];
    as[e] = aux[e];
  }
  if constexpr (B == GAT) {
    for (int m = tid; m < RC; m += NT)
      rmap[m] = (int)fminf(fmaxf(floorf(aux[m * CK]), -1.0f), (float)(CN - 1));
    for (int e = tid; e < NR * CK; e += NT)
      cmap[e] = (int)fminf(fmaxf(floorf(aux[e] * 16.0f), -1.0f), (float)(CK - 1));
  }
  __syncthreads();
  float y[2 * CN];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < CN; ++i) y[g * CN + i] = ys[((q + 8 * g) * CN + i) * CK + j];

  for (int it = 0; it < iters; ++it) {
    if constexpr (crosses(B)) {
      float n[2 * CN];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int r = q + 8 * g;
        if constexpr (B == COL_GATHER_4 || B == COL_GATHER_16) {
          col_gather<B>(ys, as, r, j, n + g * CN);
        } else {
#pragma unroll
          for (int i = 0; i < CN; ++i)
            n[g * CN + i] = cross_cell<B>(ys, as, rmap, cmap, r * CN + i, j);
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int i = 0; i < CN; ++i) {
          y[g * CN + i] = n[g * CN + i] * DECAY;
          ys[((q + 8 * g) * CN + i) * CK + j] = y[g * CN + i];
        }
      __syncthreads();
    } else {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int r = q + 8 * g;
        float* v = y + g * CN;
        if constexpr (B == AFFINE_UP || B == AFFINE_DOWN || B == FOLD) {
          float bb[CN];
#pragma unroll
          for (int i = 0; i < CN; ++i) bb[i] = as[(r * CN + i) * CK + j];
          if constexpr (B == FOLD) {
            // K13's phase 2: from the last n-slot down, slot i adds the
            // updated slot i + 1
#pragma unroll
            for (int i = CN - 2; i >= 0; --i) v[i] = logaddexp(v[i], v[i + 1] + bb[i]);
          } else {
            float a[CN];
#pragma unroll
            for (int i = 0; i < CN; ++i) a[i] = v[i];
            affine_chain<B == AFFINE_UP>(a, bb);
#pragma unroll
            for (int i = 0; i < CN; ++i) v[i] = a[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < CN; ++i) {
            const int m = r * CN + i;
            const float a = as[m * CK + j];
            if constexpr (B == LSE_13) {
              float t[13];
#pragma unroll
              for (int k = 0; k < 13; ++k) t[k] = v[i] + (float)(0.01 * k);
              float mx = t[0];
#pragma unroll
              for (int k = 1; k < 13; ++k) mx = max_nan(mx, t[k]);
              const bool fin = mx > NEG_THR;
              const float ms = fin ? mx : 0.0f;
              float s = expf(t[0] - ms);
#pragma unroll
              for (int k = 1; k < 13; ++k) s = s + expf(t[k] - ms);
              v[i] = fin ? ms + logf(s) : mx;
            } else if constexpr (B == UNPACK_HD) {
              const int h = (int)(short)(int)a;
              v[i] = v[i] + (float)(h & 15) + (float)((h >> 4) & 15) +
                     (float)((h >> 8) & 15) + (float)((h >> 12) & 15);
            } else if constexpr (B == TRANSPOSE_24) {
              // the sum depends on aux alone; read through volatile, it is
              // redone every iteration, as the TPU kernel reads aux_ref
              const volatile float* av = as;
              float acc = av[m];
              for (int s = 1; s < 24; ++s) acc = acc + av[s * CK + m];
              v[i] = v[i] + acc;
            } else if constexpr (B == SC) {
              v[i] = sc_(v[i], a, SC_C1, SC_C2);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < CN; ++i) v[i] = v[i] * DECAY;
      }
      if constexpr (B == SYNC_PAIR) {
        __syncthreads();
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < CN; ++i) out[((q + 8 * g) * CN + i) * CK + j] = y[g * CN + i];
}

template <int B>
int launch(const float* x, const float* aux, float* out, int iters, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)TILE * sizeof(float) + (RC + NR * CK) * sizeof(int);
  cudaError_t err = launch_smem(microop_kernel<B>, smem);
  if (err != cudaSuccess) return (int)err;
  microop_kernel<B><<<1, NT, smem, stream>>>(x, aux, out, iters);
  return (int)cudaGetLastError();
}

template <int B>
int dispatch(int block, const float* x, const float* aux, float* out, int iters,
             cudaStream_t stream) {
  if constexpr (B == NBLOCKS) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (block == B) return launch<B>(x, aux, out, iters, stream);
    return dispatch<B + 1>(block, x, aux, out, iters, stream);
  }
}

}  // namespace

// block: the index of ops/ntc_probe_kernels.MICRO_BLOCKS; x, aux and out
// (128, 128) float32 on the card. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int ntc_microop_f32(int block, const float* x, const float* aux,
                               float* out, int iters, void* stream) {
  return dispatch<0>(block, x, aux, out, iters, (cudaStream_t)stream);
}
