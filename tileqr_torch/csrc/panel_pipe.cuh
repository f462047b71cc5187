// A panel's couple chain (K1's GEQRT and head couples, K2's chunk couples,
// or both in one launch) pipelined by ib block: q = ceil(nb / ib) clusters
// in one launch, cluster s running block s of every couple in turn, so that
// block s + 1 of couple i runs beside block s of couple i + 1.
//
// Why it holds: in a TS couple [R; B] reflector j acts only on R's row j and
// on B's rows, so block s of couple i touches R's rows [s ib, s ib + ibk)
// and B_i's columns from s ib on (PipeRows, geqrt_cluster.cuh), and needs
//   - block s - 1 of couple i (B_i's columns right of it, V and T of the
//     blocks before it): a hand-off flag in L2;
//   - block s of couple i - 1 (R's rows of the block): the same cluster,
//     one couple earlier.
// Two stages that run at once, (i + 1, s) and (i, s + 1), share no memory:
// other R rows, other B tiles, other T. The GEQRT step's block s touches
// the tile's rows [s ib, nb) only, and the tile's rows of block s are final
// once it is done; the first couple of a K2 launch walks every row from s ib
// on (its block 0 all of them, so that the R rows of later blocks reach
// r_out), r_in being upper triangular (K2's wrapper passes r_in's upper
// triangle, kernels/chain.py). After its block, each stage writes its R rows
// to r_out with their strict lower part zero (the GEQRT step: the tile's
// upper triangle), as K1's serial loop does, so the R a couple carries is
// always upper triangular.
//
// The hand-off: stage s releases flag (i, s) in the sync buffer once block
// s of couple i is stored (every CTA's __threadfence, a cluster barrier,
// then st.release.gpu of the launch's epoch by CTA 0); stage s + 1's CTAs
// wait for it with ld.acquire.gpu and read the couple through L2 (__ldcg)
// as before. The flags of a launch hold its epoch, a number the host
// raises every launch, so the buffer is never cleared; a launch is never
// captured in a CUDA graph, whose replays would reuse the epoch
// (kernels/panel.py:_pipelined). Each cluster takes its stage from a ticket
// in the same buffer, in the order the clusters start: a stage waits only
// on stages that are already running, so no schedule of the clusters
// deadlocks, however few of them the card holds at once, and stage 0 never
// waits. Each stage has its own workspace (P's reduction, and the slab, Tb
// and work buffer where they are not resident). Every sum is in fixed rank
// order, as in the serial loop: reruns are bitwise equal.
//
// The host (kernels/panel.py:pipeline_plan) takes the serial loop instead
// (panel.cu, chain.cu) for one step and for q = 1, and inside a CUDA graph.
#pragma once

#include "geqrt_cluster.cuh"

namespace {
namespace cl {

// One launch's steps: [the GEQRT of tile (k, k)], n_head TS couples of the
// tiles below it (geqrt = 1), n_chunks TS couples of block_rows rows from row
// chunk_row0, all in column block k. Without the GEQRT step the first couple
// carries r_in (K2, upper triangular). The outputs are K1's (r_out, v_stack, t_geqrt,
// t2_stack: slot i the step i) and K2's (v_chunks, t2_chunks).
struct PipeArgs {
  const float* a;
  long long lda;
  int k, nb, ib;
  int rows;  // the most rows a stage walks (the workspace's and smem's size)
  int geqrt, n_head, n_chunks, block_rows;
  long long chunk_row0;
  const float* r_in;
  float *r_out, *v_stack, *t_geqrt, *t2_stack, *v_chunks, *t2_chunks;
  float* work;                  // q x ws_floats(nb, rows, ib, C, RES)
  unsigned long long* sync;     // [0] the ticket, [1 + i q + s] flag (i, s)
  unsigned long long epoch;     // 1 <= epoch < 2^31
};

__host__ __device__ inline int pipe_steps(const PipeArgs& p) {
  return p.geqrt + p.n_head + p.n_chunks;
}

// step i's couple; `full`: whether block s walks every row from s on
__device__ inline Couple pipe_couple(const PipeArgs& p, int i, bool& full) {
  Couple cp;
  const long long tile2 = (long long)p.nb * p.nb, col = (long long)p.k * p.nb;
  cp.nb = p.nb;
  cp.ldb = p.lda;
  cp.r_home = p.r_out;
  cp.r_src = (i == 0 && !p.geqrt) ? p.r_in : p.r_out;
  full = i == 0;
  if (i < p.geqrt + p.n_head) {  // K1: tile (k + i, k); step 0 the GEQRT
    cp.r_rows = i == 0 ? 0 : p.nb;
    cp.b_src = p.a + (long long)(p.k + i) * p.nb * p.lda + col;
    cp.b_home = p.v_stack + i * tile2;
    cp.t_out = i == 0 ? p.t_geqrt : p.t2_stack + i * tile2;
    cp.m = cp.r_rows + p.nb;
  } else {  // K2: chunk c
    const int c = i - p.geqrt - p.n_head;
    cp.r_rows = p.nb;
    cp.b_src = p.a + (p.chunk_row0 + (long long)c * p.block_rows) * p.lda + col;
    cp.b_home = p.v_chunks + (long long)c * p.block_rows * p.nb;
    cp.t_out = p.t2_chunks + c * tile2;
    cp.m = p.nb + p.block_rows;
  }
  return cp;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* f) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(f) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* f, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(f), "l"(v) : "memory");
}

// This cluster's stage: the number of clusters of this launch that took a
// ticket before it (the ticket word holds the epoch above 32 bits).
__device__ int take_ticket(unsigned long long* word, unsigned long long epoch) {
  unsigned long long cur = *(volatile unsigned long long*)word;
  while (true) {
    const bool ours = (cur >> 32) == epoch;
    const unsigned long long want = ours ? cur + 1 : (epoch << 32) | 1ull;
    const unsigned long long got = atomicCAS(word, cur, want);
    if (got == cur) return ours ? (int)(cur & 0xffffffffull) : 0;
    cur = got;
  }
}

// The pipelined chain, called by every thread of every CTA of the launch.
template <bool RES>
__device__ void panel_pipeline(const PipeArgs& p, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  // the ticket passes through the first word of every CTA's shared memory,
  // before anything else is kept there
  int* ticket = reinterpret_cast<int*>(smem);
  if (tid == 0 && rank == 0) {
    const int t = take_ticket(p.sync, p.epoch);
    for (int r = 0; r < C; ++r) *cluster.map_shared_rank(ticket, r) = t;
  }
  cluster.sync();
  const int stage = *ticket, stages = (int)(gridDim.x / C);
  if (stage >= stages) __trap();  // a ticket past the launch: its epoch was reused
  __syncthreads();
  const long long ws = ws_floats(p.nb, p.rows, p.ib, C, RES);
  const Cta w = carve<RES>(smem, p.work + stage * ws, p.nb, p.rows, p.ib, stage);
  const int s = stage * p.ib, ibk = min(p.ib, p.nb - s), nb = p.nb;
  const int steps = pipe_steps(p);
  for (int i = 0; i < steps; ++i) {
    if (stage > 0) {
      if (tid == 0)
        while (ld_acquire(p.sync + 1 + (long long)i * stages + stage - 1) != p.epoch) {
        }
      __syncthreads();
      CL_STAGE(8);
    }
    bool full;
    const Couple cp = pipe_couple(p, i, full);
    couple_block<RES>(cp, w, PipeRows(cp, s, ibk, full), s, ibk);
    cluster_sync_global();
    // R's rows [s, s + ibk) into r_out: the GEQRT tile's upper triangle, or
    // the couple's R rows with their strict lower part zero
    const int e_all = ibk * nb, share = ceil_div(e_all, C);
    for (int e = rank * share + tid; e < min(e_all, (rank + 1) * share); e += CL_THREADS) {
      const int gl = div_small(e, nb), g = s + gl, c = e - gl * nb;
      float* dst = p.r_out + (long long)g * nb + c;
      if (cp.r_rows == 0) *dst = c >= g ? ldcg(cp.b_home + (long long)g * nb + c) : 0.f;
      else if (c < g) *dst = 0.f;
    }
    if (cp.r_rows == 0 && stage == 0) {  // the GEQRT slot of t2_stack
      const long long t_all = (long long)nb * nb, tsh = (t_all + C - 1) / C;
      for (long long e = rank * tsh + tid; e < min(t_all, (rank + 1) * tsh); e += CL_THREADS)
        p.t2_stack[e] = 0.f;
    }
    cluster_sync_global();
    if (stage + 1 < stages && tid == 0 && rank == 0)
      st_release(p.sync + 1 + (long long)i * stages + stage, p.epoch);
    CL_STAGE(0);
  }
}

// The kernels: one a launch's kind, for the profile's grouping by name (K1,
// or K1 and K2: geqrt = 1; K2 alone: geqrt = 0)
template <bool RES>
__global__ void __launch_bounds__(CL_THREADS) panel_factor_kernel_pipelined(const PipeArgs p) {
  extern __shared__ __align__(16) float smem[];
  panel_pipeline<RES>(p, smem);
}

template <bool RES>
__global__ void __launch_bounds__(CL_THREADS) panel_chain_kernel_pipelined(const PipeArgs p) {
  extern __shared__ __align__(16) float smem[];
  panel_pipeline<RES>(p, smem);
}

// Validate and launch a pipelined chain: `stages` = ceil(nb / ib) clusters
// of `ctas` CTAs (kernels/panel.py:pipeline_plan), the resident or
// global-workspace instantiation of the launch's kernel.
inline int launch_pipe(const PipeArgs& p, int stages, int ctas, long long smem, int resident,
                       cudaStream_t stream) {
  const int steps = pipe_steps(p);
  if (p.nb < 1 || p.ib < 1 || stages < 2 || stages != ceil_div(p.nb, p.ib) || steps < 2 ||
      p.geqrt < 0 || p.geqrt > 1 || (p.n_head > 0 && !p.geqrt) || p.n_head < 0 ||
      p.n_chunks < 0 || (!p.geqrt && p.r_in == nullptr) || p.epoch < 1 ||
      p.epoch >= (1ull << 31) || !smem_matches(p.nb, p.rows, p.ib, ctas, resident, smem))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const PipeArgs) = panel_chain_kernel_pipelined<false>;
  if (p.geqrt && resident) kernel = panel_factor_kernel_pipelined<true>;
  else if (p.geqrt) kernel = panel_factor_kernel_pipelined<false>;
  else if (resident) kernel = panel_chain_kernel_pipelined<true>;
  return launch_clusters(kernel, stages, ctas, (size_t)smem, stream, p);
}

}  // namespace cl
}  // namespace
