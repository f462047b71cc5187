// B9: batched upper Cholesky R^T R = G, one thread block per matrix.
//
// Replaces tileqr/drivers/cholqr.py:potrf_batched (_mk_potrf_kernel). The
// TPU kernel keeps a group of (n x n) matrices in VMEM and works in bp-row
// panels: row step j scales row j by rsqrt(max(d2, 1e-30)) (the clamp turns
// a breakdown into a NaN or huge health value, not an exception) and
// rank-1-updates the panel rows below it on the lanes right of j, which is
// the panel TRSM folded in; after the panel, one SYRK
// G[e:, e:] -= R12^T R12 updates the trailing matrix. This kernel does the
// same steps in the same order. The pivot is 1 / sqrtf(max(d2, 1e-30)),
// IEEE sqrt and division.
//
// What bounds it on the H100: latency. n = 256 serial row steps, each a
// barrier; the n^3/3 = 5.6 MFLOP and 0.5 MB of one hr panel take well under
// a microsecond at the card's rates. The (n x n) matrix (256 KiB at n = 256)
// does not fit shared memory, so it lives in the output buffer in global
// memory (L2-resident) and only the current bp-row panel (16 KiB at
// bp = 16) is held in shared memory: the row steps run entirely there, and
// the SYRK reads its operands from there (broadcast on the row index,
// consecutive on the column index). One block per matrix of the batch.
#include <cuda_runtime.h>

namespace {

constexpr int POTRF_THREADS = 1024;

__global__ void __launch_bounds__(POTRF_THREADS)
potrf_kernel(float* r_all, int n, int bp) {
  extern __shared__ float slab[];  // bp x n: the current panel rows
  float* r = r_all + (long long)blockIdx.x * n * n;
  const int tid = threadIdx.x, bd = blockDim.x;
  for (int s = 0; s < n; s += bp) {
    const int e = min(s + bp, n), bpe = e - s;
    for (int idx = tid; idx < bpe * n; idx += bd) slab[idx] = r[(long long)s * n + idx];
    __syncthreads();
    for (int jj = 0; jj < bpe; ++jj) {
      const int j = s + jj;
      const float rinv = 1.f / sqrtf(fmaxf(slab[jj * n + j], 1e-30f));
      const int rows = bpe - jj - 1, w = n - j - 1;
      for (int idx = tid; idx < rows * w; idx += bd) {
        const int i = jj + 1 + idx / w, l = j + 1 + idx % w;
        const float upd = (slab[i * n + j] * rinv) * (slab[jj * n + l] * rinv);
        slab[i * n + l] = slab[i * n + l] - upd;
      }
      __syncthreads();
      for (int l = tid; l < n; l += bd)
        slab[jj * n + l] = l >= j ? slab[jj * n + l] * rinv : 0.f;
      __syncthreads();
    }
    for (int idx = tid; idx < bpe * n; idx += bd) r[(long long)s * n + idx] = slab[idx];
    if (e < n) {
      const int w = n - e;
      for (int idx = tid; idx < w * w; idx += bd) {
        const int i = e + idx / w, l = e + idx % w;
        float acc = 0.f;
        for (int t = 0; t < bpe; ++t) acc = fmaf(slab[t * n + i], slab[t * n + l], acc);
        float* x = r + (long long)i * n + l;
        *x = *x - acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tq_potrf_batched(float* r, int batch, int n, int bp, void* stream) {
  bp = bp < n ? bp : n;
  const size_t smem = sizeof(float) * (size_t)bp * n;
  cudaError_t e = cudaFuncSetAttribute(
      potrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  potrf_kernel<<<batch, POTRF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(r, n, bp);
  return (int)cudaGetLastError();
}
