// B8: modified LU of the hr panel's top block, Q_top - diag(d) = L1 U, with
// d_j = -sign(pivot) chosen at step j (+1 for a zero pivot), no pivoting.
//
// Replaces tileqr/kernels/modlu.py:modified_lu (_mk_modlu_kernel), whose
// fori_loop of nb masked rank-1 steps on a VMEM-resident block becomes a
// loop inside ONE thread block here. Each step, as the JAX body:
//   piv0 = lu[j][j]; dj = piv0 > 0 ? -1 : +1; piv = piv0 - dj;
//   lcol = lu[j+1:, j] / piv; lu[j+1:, j+1:] -= lcol * lu[j, j+1:];
//   lu[j][j] = piv; lu[j+1:, j] = lcol; d[j] = dj.
//
// What bounds it on the H100: latency. nb = 256 serial steps, each a
// block-wide rank-1 update followed by a barrier; its 2/3 nb^3 = 11 MFLOP
// and 0.5 MB would take well under a microsecond at the card's rates. The
// 256 KiB block does not fit one SM's 227 KB of shared memory, so it is
// updated in place in global memory (the `lu` output, which stays in the
// 50 MB L2); row j and column j are broadcast through shared memory at each
// step, and neighbouring threads update neighbouring columns (coalesced).
// Division is IEEE (no fast math). Faster designs (a cluster holding the
// block in distributed shared memory, or registers) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int MODLU_THREADS = 1024;

__global__ void __launch_bounds__(MODLU_THREADS)
modlu_kernel(float* lu, int n, float* d) {
  extern __shared__ float sh[];
  float* rowj = sh;      // lu[j][l], l > j
  float* lcol = sh + n;  // lu[i][j] / piv, i > j
  const int tid = threadIdx.x, bd = blockDim.x;
  for (int j = 0; j < n; ++j) {
    const float piv0 = lu[(long long)j * n + j];
    const float dj = piv0 > 0.f ? -1.f : 1.f;
    const float piv = piv0 - dj;
    for (int i = j + 1 + tid; i < n; i += bd) {
      rowj[i] = lu[(long long)j * n + i];
      const float l = lu[(long long)i * n + j] / piv;
      lcol[i] = l;
      lu[(long long)i * n + j] = l;
    }
    __syncthreads();
    if (tid == 0) {
      lu[(long long)j * n + j] = piv;
      d[j] = dj;
    }
    const int w = n - j - 1;
    for (int idx = tid; idx < w * w; idx += bd) {
      const int i = j + 1 + idx / w, l = j + 1 + idx % w;
      float* x = lu + (long long)i * n + l;
      *x = *x - lcol[i] * rowj[l];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tq_modified_lu(float* lu, int n, float* d, void* stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)n;
  cudaError_t e = cudaFuncSetAttribute(
      modlu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  modlu_kernel<<<1, MODLU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(lu, n, d);
  return (int)cudaGetLastError();
}
