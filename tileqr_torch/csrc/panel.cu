// K1: panel-column factorization, GEQRT on tile (k, k) plus the TSQRT head
// couples [R; A(k+i, k)], R carried between them.
//
// Replaces tileqr/kernels/panel.py:panel_factor (_mk_panel_kernel), whose
// TPU grid of 1 + n_couples sequential steps becomes a loop inside ONE
// thread-block cluster here: each step needs the R of the step before.
// Each step runs geqrt_couple_cluster (geqrt_cluster.cuh) on its couple:
// step 0 on the diagonal tile alone (m = nb rows, its home the GEQRT slot
// of v_stack), step i on [R; A(k+i, k)] (m = 2 nb, R's home r_out, B's
// the V2 slot i), then writes R as the upper triangle of the couple's top.
// B13 (panel.py:panel_head) is this kernel on a row view.
//
// What bounds it on the H100: latency of the serial Householder column
// loop (1 + n_couples couples of nb columns each). The design spreads each
// couple's rows over a cluster of C CTAs (C from cluster_plan at m = 2 nb:
// 8 at nb = 256), so a column costs one exchange of partials between the
// CTAs (st.async into the peers' mbarriers, no cluster barrier) and a pass
// over rpc = m / C rows of shared memory per CTA instead of a pass over m rows
// through L2 on one SM (geqrt.cuh's one-block design). One launch per panel;
// R crosses from step to step through r_out (L2), with a cluster barrier
// between steps because step 0's row split differs from the couples'.
//
// A launch of two or more steps runs them pipelined instead (tq_panel_pipe,
// panel_pipe.cuh): nb / ib clusters, block s of each couple on cluster s,
// beside block s - 1 of the next; the hh driver's launch also runs the
// panel's K2 couples after K1's (kernels/chain.py:panel_column), the
// pipeline carried across, and K2 alone pipelines through the same entry.
// The serial loop stays for one step (K1 with no couple) and for q = 1.
#include "panel_pipe.cuh"

namespace {

template <bool RES>
__global__ void __launch_bounds__(cl::CL_THREADS)
panel_factor_kernel(const float* __restrict__ a, long long lda, int k, int nb, int ib,
                    int n_couples, float* r_out, float* v_stack, float* t_geqrt,
                    float* t2_stack, float* work) {
  extern __shared__ __align__(16) float smem[];
  const int rows = n_couples > 0 ? 2 * nb : nb;
  const cl::Cta w = cl::carve<RES>(smem, work, nb, rows, ib);
  const long long tile2 = (long long)nb * nb;
  for (int i = 0; i <= n_couples; ++i) {
    cl::Couple cp;
    cp.nb = nb;
    cp.r_rows = i == 0 ? 0 : nb;
    cp.m = cp.r_rows + nb;
    cp.r_src = r_out;
    cp.r_home = r_out;
    cp.b_src = a + (long long)(k + i) * nb * lda + (long long)k * nb;
    cp.ldb = lda;
    cp.b_home = v_stack + i * tile2;
    cp.t_out = i == 0 ? t_geqrt : t2_stack + i * tile2;
    cl::geqrt_couple_cluster<RES>(cp, w);
    // R = the upper triangle of the couple's top nb rows, on own rows
    const int rpc = cl::ceil_div(cp.m, w.ctas), r0 = w.rank * rpc;
    const int r1 = min(min(nb, cp.m), r0 + rpc);
    for (long long idx = (long long)r0 * nb + threadIdx.x; idx < (long long)r1 * nb;
         idx += cl::CL_THREADS) {
      const int r = (int)(idx / nb), c = (int)(idx % nb);
      if (i == 0) r_out[idx] = c >= r ? __ldcg(v_stack + idx) : 0.f;
      else if (c < r) r_out[idx] = 0.f;
    }
    if (i == 0) {
      const long long sh = (tile2 + w.ctas - 1) / w.ctas;
      for (long long idx = w.rank * sh + threadIdx.x; idx < min(tile2, (w.rank + 1) * sh);
           idx += cl::CL_THREADS)
        t2_stack[idx] = 0.f;
    }
    cl::cluster_sync_global();
  }
}

}  // namespace

extern "C" const char* tq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// global workspace floats of a K1/K2 cluster launch over couples of `rows`
// rows (K1: 2 nb, or nb without couples; K2: nb + block_rows)
extern "C" long long tq_cluster_work_floats(int nb, int rows, int ib, int ctas, int resident) {
  return cl::ws_floats(nb, rows, ib, ctas, resident != 0);
}

// ctas, smem, resident: kernels/panel.py:cluster_plan(nb, rows, ib)
extern "C" int tq_panel_factor(const float* a, long long lda, int k, int nb, int ib,
                               int n_couples, float* r_out, float* v_stack,
                               float* t_geqrt, float* t2_stack, float* work, int ctas,
                               long long smem, int resident, void* stream) {
  const int rows = n_couples > 0 ? 2 * nb : nb;
  if (!cl::smem_matches(nb, rows, ib, ctas, resident, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return cl::launch_cluster(panel_factor_kernel<true>, ctas, (size_t)smem, st, a, lda, k, nb,
                              ib, n_couples, r_out, v_stack, t_geqrt, t2_stack, work);
  return cl::launch_cluster(panel_factor_kernel<false>, ctas, (size_t)smem, st, a, lda, k, nb,
                            ib, n_couples, r_out, v_stack, t_geqrt, t2_stack, work);
}

// A chain of couples pipelined by ib block (panel_pipe.cuh: PipeArgs, in
// its order), then the launch's: `stages` clusters of `ctas` CTAs, smem and
// resident (kernels/panel.py:pipeline_plan; `rows`, the largest a stage
// walks, is its cluster's); work: stages x tq_cluster_work_floats(nb, rows,
// ib, ctas, resident) floats; sync: the hand-off buffer (1 + steps x stages
// words); epoch: this launch's number. geqrt = 1: K1's GEQRT, n_head head
// couples, then n_chunks chunk couples (K1, or a panel's K1 and K2); geqrt
// = 0: K2's n_chunks chunk couples after r_in.
extern "C" int tq_panel_pipe(const float* a, long long lda, int k, int nb, int ib, int rows,
                             int geqrt, int n_head, int n_chunks, int block_rows,
                             long long chunk_row0, const float* r_in, float* r_out,
                             float* v_stack, float* t_geqrt, float* t2_stack, float* v_chunks,
                             float* t2_chunks, float* work, unsigned long long* sync,
                             long long epoch, int stages, int ctas, long long smem, int resident,
                             void* stream) {
  const cl::PipeArgs p{a, lda, k, nb, ib, rows, geqrt, n_head, n_chunks, block_rows, chunk_row0,
                       r_in, r_out, v_stack, t_geqrt, t2_stack, v_chunks, t2_chunks, work, sync,
                       (unsigned long long)epoch};
  return cl::launch_pipe(p, stages, ctas, smem, resident, static_cast<cudaStream_t>(stream));
}

#ifdef TQ_CL_STAGES
extern "C" int tq_cl_stages_panel(unsigned long long* out) { return cl::read_stages(out); }
#endif
