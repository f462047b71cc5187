// K1: panel-column factorization, GEQRT on tile (k, k) plus the TSQRT head
// couples [R; A(k+i, k)], R carried between them.
//
// Replaces tileqr/kernels/panel.py:panel_factor (_mk_panel_kernel), whose
// TPU grid of 1 + n_couples sequential steps becomes a loop inside ONE
// thread block here: blocks of a CUDA grid run in no order, and each step
// needs the R of the step before. Each step stages its couple transposed
// into a global workspace, runs geqrt_couple (geqrt.cuh) and writes the
// step's outputs.
//
// What bounds it on the H100: latency of the serial Householder column loop
// (see geqrt.cuh), on one SM. The design keeps R and the couple in the
// workspace (L2-resident) between steps instead of round-tripping through
// the host or separate launches: one launch per panel.
#include "geqrt.cuh"

namespace {

__global__ void __launch_bounds__(GEQRT_THREADS)
panel_factor_kernel(const float* __restrict__ a, long long lda, int k, int nb, int ib,
                    int n_couples, float* r_out, float* v_stack, float* t_geqrt,
                    float* t2_stack, float* work) {
  extern __shared__ float v_sh[];
  const int tid = threadIdx.x, bd = blockDim.x;
  const long long tile2 = (long long)nb * nb;
  float* at = work;
  float* tt = at + (long long)nb * 2 * nb;
  float* ws = tt + tile2;
  for (int i = 0; i <= n_couples; ++i) {
    const float* tile = a + (long long)(k + i) * nb * lda + (long long)k * nb;
    // step 0 factors the diagonal tile alone (m = nb); a couple step
    // stacks R on top of the sub-diagonal tile (m = 2nb)
    const int m = (i == 0) ? nb : 2 * nb;
    for (long long idx = tid; idx < tile2; idx += bd) {
      const int r = (int)(idx / nb), c = (int)(idx % nb);
      if (i == 0) {
        at[(long long)c * m + r] = tile[r * lda + c];
      } else {
        at[(long long)c * m + r] = r_out[(long long)r * nb + c];
        at[(long long)c * m + nb + r] = tile[r * lda + c];
      }
      tt[idx] = 0.f;
    }
    __syncthreads();
    geqrt_couple(at, nb, m, tt, ib, ws, v_sh, nb);
    float* v_out = v_stack + i * tile2;
    float* t_out = (i == 0) ? t_geqrt : t2_stack + i * tile2;
    for (long long idx = tid; idx < tile2; idx += bd) {
      const int r = (int)(idx / nb), c = (int)(idx % nb);
      const float top = at[(long long)c * m + r];
      r_out[idx] = (r <= c) ? top : 0.f;
      v_out[idx] = (i == 0) ? top : at[(long long)c * m + nb + r];
      t_out[idx] = tt[(long long)c * nb + r];
      if (i == 0) t2_stack[idx] = 0.f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* tq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int tq_geqrt_work_floats(int nb, int rows, int ib) {
  return static_cast<int>(couple_work_floats(nb, rows, ib));
}

extern "C" int tq_panel_factor(const float* a, long long lda, int k, int nb, int ib,
                               int n_couples, float* r_out, float* v_stack,
                               float* t_geqrt, float* t2_stack, float* work,
                               void* stream) {
  const size_t smem = sizeof(float) * 2 * nb;
  cudaError_t e = cudaFuncSetAttribute(
      panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  panel_factor_kernel<<<1, GEQRT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, lda, k, nb, ib, n_couples, r_out, v_stack, t_geqrt, t2_stack, work);
  return (int)cudaGetLastError();
}
