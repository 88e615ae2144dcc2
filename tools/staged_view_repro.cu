// ntc_bwd_variant's chunk loop in one kernel instance for both paths, in
// the two forms tools/staged_view_repro.py compares (csrc/ntc_lattice.cu's
// kernel keeps one instance per path, STAGE):
//   form 0  the staged and the unstaged path as two branches, each calling
//           bwd_column_at with a struct of its own;
//   form 1  one call through a view that is either the kernel's input or
//           the staged rows.
// Built with csrc/ on the include path; its own library, no caller in the
// package.
#include "ntc_lattice.cu"

namespace {
using namespace dynamont;

template <int FORM>
__global__ void __launch_bounds__(512)
repro_kernel(BwdIn<float> in, const float* __restrict__ tlog, const int* __restrict__ N_r,
             const int* __restrict__ T_r, float* out, float* scratch, int C, int stage) {
  extern __shared__ unsigned char smem[];
  const int r = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  float tl[NTL];
  load_tl(tl, tlog);
  const int nm1 = N_r[r] - 1, tm1 = T_r[r] - 1;
  const int R = in.R, nc = in.T_pad / C;
  const size_t col = 5 * (size_t)in.CN * in.CK;
  unsigned char* csm = smem + (stage ? stage_bytes<float>(C, in.CN, in.CK, in.A) : 0);
  float* buf = scratch + (size_t)r * col;
  for (size_t c = tid; c < col; c += NT) buf[c] = neg_inf<float>();
  __syncthreads();
  const float* nx = buf;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * C;
    if constexpr (FORM == 0) {
      if (stage) {
        const BwdIn<float> view = stage_rows(in, r, t0, C, smem);
        __syncthreads();
        for (int i = C - 1; i >= 0; --i) {
          float* o = out + ((size_t)(t0 + i) * R + r) * col;
          bwd_column_at(view, tl, t0 + i, i, 0, nm1, tm1, nx, o, csm);
          nx = o;
        }
      } else {
        for (int i = C - 1; i >= 0; --i) {
          float* o = out + ((size_t)(t0 + i) * R + r) * col;
          bwd_column(in, tl, t0 + i, r, nm1, tm1, nx, o, csm);
          nx = o;
        }
      }
    } else {
      BwdIn<float> v = in;
      int base = 0, rr = r;
      if (stage) {
        v = stage_rows(in, r, t0, C, smem);
        __syncthreads();
        base = t0;
        rr = 0;
      }
      for (int i = C - 1; i >= 0; --i) {
        float* o = out + ((size_t)(t0 + i) * R + r) * col;
        bwd_column_at(v, tl, t0 + i, t0 + i - base, rr, nm1, tm1, nx, o, csm);
        nx = o;
      }
    }
  }
}
}  // namespace

// The full store (T_pad, R, 5, CN, CK) of the reverse order; arguments as
// ntc_bwd_variant_f32's, scratch (R, 5, CN, CK).
extern "C" int staged_view_repro_f32(
    int form, const float* sig, const int* cand_n, const unsigned char* allowed,
    const short* hd, const signed char* d01, const signed char* d02,
    const int* brow_same, const int* brow_next, const int* bcol_same,
    const int* bcol_suc, const float* mu_k, const float* c1_k, const float* c2_k,
    const float* suc, const float* nsl, const float* tlog, const int* N_r,
    const int* T_r, float* out, float* scratch, int R, int T_pad, int CN, int CK,
    int A, int C, int stage, void* stream) {
  const BwdIn<float> in{sig, cand_n, allowed, hd, d01, d02, brow_same,
                        brow_next, bcol_same, bcol_suc, mu_k, c1_k, c2_k, suc,
                        nsl, R, T_pad, CN, CK, A};
  const size_t smem = (stage ? stage_bytes<float>(C, CN, CK, A) : 0) +
                      bwd_smem<float>(CN * CK);
  auto kern = form == 0 ? repro_kernel<0> : repro_kernel<1>;
  cudaError_t err = launch_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<R, 512, smem, (cudaStream_t)stream>>>(in, tlog, N_r, T_r, out, scratch, C, stage);
  return (int)cudaGetLastError();
}
