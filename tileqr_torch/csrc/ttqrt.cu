// TTQRT: QR of the couple [R1; R2] of two upper-triangular nb x nb tiles,
// the combine step of the sharded driver's tree over mesh rows.
//
// Replaces tileqr/kernels/ttqrt.py:ttqrt (_ttqrt_kernel): outputs R (upper
// triangular), V2 (upper triangular: reflector j lives on rows {j} and
// {nb..nb+j} of the couple) and T2, the compact-WY T of the nb reflectors.
//
// What bounds it on the H100: latency. The work is small: LAPACK's count
// for a triangle-on-triangle couple is about 2 nb^3 / 3 flops (11 MFLOP at
// nb = 256) and the tiles in and out are 5 nb^2 floats (1.25 MiB), a bound
// of about 0.4 us set by the bytes; but the Householder column loop is a
// chain of nb dependent reductions.
// What the design does about it: the TPU kernel confines its lanes to a
// window while it eliminates the column block [s, e); here the couple runs
// on the cluster routine of K1/K2 (geqrt_cluster.cuh, geqrt_couple_cluster
// with the TriRows row set), whose blocks walk only their live rows: R1's
// rows [s, e) and R2's rows [0, e). At nb = 256, ib = 128 that is 256 rows
// for the first block and 384 for the second, against the 512 of the full
// couple (tsqrt, K2). Inside a block, column j's norm, dots and rank-1
// update run over its reflector's support only, R1's row j and R2's rows
// [0, j] (the per-column window). Every other row holds exact zeros in the
// columns concerned or is a final R row, so the outputs equal those of the
// full couple up to the order of additions of exact zeros and the sum
// order. The live rows of each block are dealt out cyclically over the
// cluster's C CTAs (C from kernels/panel.py:ttqrt_plan; CTA q holds live
// rows q, q + C, ...), so each column's window is spread over all of them;
// the active block of them sits in shared memory, each column's partials
// exchanged by st.async (no cluster barrier) and added in rank order (the
// same bits on every CTA, no atomics). As a row changes CTA from one block to the next, a
// block starts with a cluster barrier. The columns right of the block stay
// in the outputs (L2) between blocks. R1 and R2 are read from the inputs
// and R, V2, T2 written straight to the outputs: there is no copy of the
// couple. The global workspace holds only the reduced P of the block
// product (and, where C is too small for shared memory, the slab). The
// entries of R and V2 that no block writes (row g, columns left of g's
// block) are zeroed here: both outputs are upper triangular.
// Arithmetic: IEEE fp32 FMA on the CUDA cores, LARFG with no rescaling,
// T by the doubling recurrence, as in K2: deterministic.
// What bounds it now (PERF.md, utils/cluster_stages.py): the column loop,
// nb dependent steps, each with its exchange of partials, as in K2.
#include "geqrt_cluster.cuh"

namespace {

template <bool RES>
__global__ void __launch_bounds__(cl::CL_THREADS)
ttqrt_kernel(const float* __restrict__ r1, const float* __restrict__ r2, int nb, int ib,
             float* r_out, float* v2, float* t2, float* work) {
  extern __shared__ __align__(16) float smem[];
  const cl::Cta w = cl::carve<RES>(smem, work, nb, cl::tri_rows_max(nb, ib), ib);
  // row g of R and V2 is first written by the block that holds column g;
  // the entries left of that block (all below the diagonal) are zero
  // (a warp a row, the rows dealt out over the CTAs)
  const int lane = threadIdx.x & 31, warps = cl::CL_THREADS / 32;
  for (int g = w.rank * warps + (threadIdx.x >> 5); g < nb; g += w.ctas * warps) {
    const long long row = (long long)g * nb;
    for (int c = lane; c < g / ib * ib; c += 32) {
      r_out[row + c] = 0.f;
      v2[row + c] = 0.f;
    }
  }
  cl::Couple cp;
  cp.nb = nb;
  cp.m = 2 * nb;
  cp.r_rows = nb;
  cp.r_src = r1;
  cp.r_home = r_out;
  cp.b_src = r2;
  cp.ldb = nb;
  cp.b_home = v2;
  cp.t_out = t2;
  cl::geqrt_couple_cluster<RES, cl::TriRows>(cp, w);
  cl::cluster_sync_global();
}

}  // namespace

// r1, r2: (nb x nb) upper triangular, contiguous; work:
// tq_cluster_work_floats(nb, nb + min(ib, nb), ib, ctas, resident) floats;
// ctas, smem, resident: kernels/panel.py:ttqrt_plan(nb, ib).
extern "C" int tq_ttqrt(const float* r1, const float* r2, int nb, int ib, float* r_out,
                        float* v2, float* t2, float* work, int ctas, long long smem,
                        int resident, void* stream) {
  if (nb < 1 || ib < 1 || ib > nb) return (int)cudaErrorInvalidValue;
  if (!cl::smem_matches(nb, cl::tri_rows_max(nb, ib), ib, ctas, resident, smem))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return cl::launch_cluster(ttqrt_kernel<true>, ctas, (size_t)smem, st, r1, r2, nb, ib, r_out,
                              v2, t2, work);
  return cl::launch_cluster(ttqrt_kernel<false>, ctas, (size_t)smem, st, r1, r2, nb, ib, r_out,
                            v2, t2, work);
}

#ifdef TQ_CL_STAGES
extern "C" int tq_cl_stages_ttqrt(unsigned long long* out) { return cl::read_stages(out); }
#endif
