// TTQRT: QR of the couple [R1; R2] of two upper-triangular nb x nb tiles,
// the combine step of the sharded driver's tree over mesh rows.
//
// Replaces tileqr/kernels/ttqrt.py:ttqrt (_ttqrt_kernel): outputs R (upper
// triangular), V2 (upper triangular: reflector j lives on rows {j} and
// {nb..nb+j} of the couple) and T2, the compact-WY T of the nb reflectors.
//
// What bounds it on the H100: latency, as every kernel built on
// geqrt_couple (geqrt.cuh). The work itself is small: LAPACK's count for a
// triangle-on-triangle couple is about 2 nb^3 / 3 flops (11 MFLOP at
// nb = 256) and the tiles in and out are 5 nb^2 floats (1.25 MiB), a bound
// of about 0.4 us set by the bytes; but the Householder column loop is a
// chain of nb block-wide reductions on ONE SM.
// What the design does about it: the TPU kernel confines its lanes to a
// 128-aligned window n + e while it eliminates the column block [s, e);
// here geqrt_couple takes the same structure as a per-block live row count
// nb + e (tri_bottom), which drops the norms, rank-1 updates, block apply
// and T build over the rows of R2's zero lower triangle past the block (at
// nb = 256, ib = 128: 384 of the 512 rows while the first block is
// eliminated, all 512 for the second). One block of GEQRT_THREADS threads;
// the couple (512 KiB at nb = 256, past the 227 KB of shared memory) sits
// in an L2-resident global workspace, as in K1/K2. The rows past the
// window hold exact zeros, so the outputs equal the K2 TSQRT of the same
// couple (panel_chain with one nb-row couple) bitwise up to the sign of
// zero. Faster designs (several couples of one tree level per launch, or
// the couple in a cluster's distributed shared memory) are later work.
#include "geqrt.cuh"

namespace {

__global__ void __launch_bounds__(GEQRT_THREADS)
ttqrt_kernel(const float* __restrict__ r1, const float* __restrict__ r2, int nb, int ib,
             float* r_out, float* v2, float* t2, float* work) {
  extern __shared__ float v_sh[];
  const int tid = threadIdx.x, bd = blockDim.x;
  const int m = 2 * nb;
  const long long tile2 = (long long)nb * nb;
  float* at = work;
  float* tt = at + (long long)nb * m;
  float* ws = tt + tile2;
  for (long long idx = tid; idx < tile2; idx += bd) {
    const int r = (int)(idx / nb), c = (int)(idx % nb);
    at[(long long)c * m + r] = r1[idx];
    at[(long long)c * m + nb + r] = r2[idx];
    tt[idx] = 0.f;
  }
  __syncthreads();
  geqrt_couple(at, nb, m, tt, ib, ws, v_sh, nb, true);
  for (long long idx = tid; idx < tile2; idx += bd) {
    const int r = (int)(idx / nb), c = (int)(idx % nb);
    r_out[idx] = at[(long long)c * m + r];
    v2[idx] = at[(long long)c * m + nb + r];
    t2[idx] = tt[(long long)c * nb + r];
  }
}

}  // namespace

// workspace floats of one geqrt_couple couple of nb + rows rows
extern "C" int tq_geqrt_work_floats(int nb, int rows, int ib) {
  return static_cast<int>(couple_work_floats(nb, rows, ib));
}

// r1, r2: (nb x nb) upper triangular, contiguous; work:
// tq_geqrt_work_floats(nb, nb, ib) floats.
extern "C" int tq_ttqrt(const float* r1, const float* r2, int nb, int ib, float* r_out,
                        float* v2, float* t2, float* work, void* stream) {
  const size_t smem = sizeof(float) * 2 * nb;
  cudaError_t e = cudaFuncSetAttribute(
      ttqrt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ttqrt_kernel<<<1, GEQRT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      r1, r2, nb, ib, r_out, v2, t2, work);
  return (int)cudaGetLastError();
}
