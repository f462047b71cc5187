// K2 (panel_chain).
//
// K2 replaces tileqr/kernels/chain.py:panel_chain (_chain_kernel_factory):
// TSQRT on n_chunks couples [R; B], B of block_rows rows, R carried; B15's
// tsqrt (kernels/tsqrt.py) is K2 with one couple. As in K1 (panel.cu) the
// sequential TPU grid becomes a loop inside ONE thread-block cluster around
// geqrt_couple_cluster (geqrt_cluster.cuh): each couple's m = nb +
// block_rows rows (1280 at the defaults) are split over C CTAs (16 at the
// defaults, 80 rows each; 16 for the tsqr chain's 2560 rows at nb = 512,
// 160 each), each holding its rows of the active ib block in shared memory.
// B's rows live in their V output between blocks, R's in r_out (seeded
// from r_in), both in L2. Bound: latency of the column loop, now one
// exchange of partials (st.async into the peers' mbarriers) and a pass
// over rpc = m / C shared-memory rows a column
// (geqrt.cuh's single-block design walks m rows through L2 on one SM).
//
// r_in is upper triangular (its wrapper, kernels/chain.py, passes r_in's
// upper triangle). A launch of two or more couples runs them pipelined by
// ib block instead (panel.cu: tq_panel_pipe, panel_pipe.cuh); the loop here
// stays for one couple (B15's tsqrt) and for q = 1. The hh driver runs its
// panels' K2 couples inside K1's pipelined launch
// (kernels/chain.py:panel_column).
//
// K3 (couple_strip) and K4 (larfb_strip), the strip apply, are in
// strip.cu.
#include "geqrt_cluster.cuh"

namespace {

template <bool RES>
__global__ void __launch_bounds__(cl::CL_THREADS)
panel_chain_kernel(const float* __restrict__ a, long long lda, const float* r_in, int k,
                   int nb, int base_block, int n_chunks, int block_rows, int ib,
                   float* r_out, float* v_chunks, float* t2, float* work) {
  extern __shared__ __align__(16) float smem[];
  const cl::Cta w = cl::carve<RES>(smem, work, nb, nb + block_rows, ib);
  for (int i = 0; i < n_chunks; ++i) {
    cl::Couple cp;
    cp.nb = nb;
    cp.m = nb + block_rows;
    cp.r_rows = nb;
    cp.r_src = i == 0 ? r_in : r_out;
    cp.r_home = r_out;
    cp.b_src = a + (long long)(base_block + i) * block_rows * lda + (long long)k * nb;
    cp.ldb = lda;
    cp.b_home = v_chunks + (long long)i * block_rows * nb;
    cp.t_out = t2 + (long long)i * nb * nb;
    cl::geqrt_couple_cluster<RES>(cp, w);
    cl::cluster_sync_global();
  }
}

}  // namespace

// ctas, smem, resident: kernels/panel.py:cluster_plan(nb, nb + block_rows, ib)
extern "C" int tq_panel_chain(const float* a, long long lda, const float* r_in, int k,
                              int nb, int base_block, int n_chunks, int block_rows, int ib,
                              float* r_out, float* v_chunks, float* t2, float* work, int ctas,
                              long long smem, int resident, void* stream) {
  const int rows = nb + block_rows;
  if (!cl::smem_matches(nb, rows, ib, ctas, resident, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return cl::launch_cluster(panel_chain_kernel<true>, ctas, (size_t)smem, st, a, lda, r_in, k,
                              nb, base_block, n_chunks, block_rows, ib, r_out, v_chunks, t2,
                              work);
  return cl::launch_cluster(panel_chain_kernel<false>, ctas, (size_t)smem, st, a, lda, r_in, k,
                            nb, base_block, n_chunks, block_rows, ib, r_out, v_chunks, t2, work);
}

#ifdef TQ_CL_STAGES
extern "C" int tq_cl_stages_chain(unsigned long long* out) { return cl::read_stages(out); }
#endif
