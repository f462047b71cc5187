// B8: modified LU of the hr panel's top block, Q_top - diag(d) = L1 U, with
// d_j = -sign(pivot) chosen at step j (+1 for a zero pivot), no pivoting.
//
// Replaces tileqr/kernels/modlu.py:modified_lu (_mk_modlu_kernel), a
// fori_loop of nb masked rank-1 steps on a VMEM-resident block. Each step,
// as the JAX body:
//   piv0 = lu[j][j]; dj = piv0 > 0 ? -1 : +1; piv = piv0 - dj;
//   lcol = lu[j+1:, j] / piv; lu[j+1:, j+1:] -= lcol * lu[j, j+1:];
//   lu[j][j] = piv; lu[j+1:, j] = lcol; d[j] = dj.
//
// What bounds it on the H100: latency. Its 2/3 nb^3 flops (11 MFLOP at
// nb = 256) and 0.5 MB would take well under a microsecond at the card's
// rates, but step j needs step j - 1's pivot. The block (256 KiB at nb =
// 256, 1 MiB at 512) does not fit one SM's 227 KB of shared memory.
//
// The design: a blocked right-looking LU on one thread-block cluster of C
// CTAs (kernels/modlu.py:modlu_plan picks C and the shared bytes), the block
// in the CTAs' shared memory, in panels of ib = min(IB, cpc) columns (IB =
// 16 ran nb = 256 and 512 faster than 32 and 64 on the H100, PERF.md). No
// pivoting makes the blocking exact, and the signs stay exact: d only
// touches diagonal entries, each fully updated by the time its panel is
// factored.
//   - The split: CTA q owns a contiguous slab of columns [q*cpc, (q+1)*cpc),
//     cpc = ceil(nb / C), all rows, in its shared memory (row stride cpc + 1).
//     The panels are the ib-column pieces of the slabs, in column order, so
//     one CTA holds each whole panel and its column loop needs block
//     barriers only (a row split would need a cluster barrier a column).
//   - A panel [s, e), on its owner: for each column j, every thread reads
//     the pivot and chooses d_j (the same bits on each), then the rows
//     below are scaled and given the rank-1 update of the panel's columns
//     right of j, a row a thread, held in registers; one __syncthreads a
//     column.
//   - One cluster barrier a panel publishes it. Every CTA with columns right
//     of the panel copies L's panel (rows [s, nb)) from the owner's shared
//     memory (cluster.map_shared_rank) into its own, solves U12 = L11^-1 A12
//     on its columns (the rank-1 steps restricted to the panel's rows) and
//     updates A22 -= L21 U12 as a tile product out of shared memory (each
//     thread a 4 x 4 tile of outputs). nb/ib cluster barriers in all, in
//     place of nb passes over the block in L2.
//   - lu and d are written to their outputs at the end (d by the panel's
//     owner as each sign is chosen). No lookahead: the other CTAs wait at
//     the barrier while a panel is factored (a version whose next owner
//     updated and factored its panel before its other columns, with the
//     barrier split into arrive and wait, ran slower on the H100).
//   - Arithmetic: IEEE fp32 FMA on the CUDA cores, IEEE division, no TF32,
//     no tensor cores, no atomics. Every entry receives its updates in the
//     unblocked order, one FMA each (a - l u, rounded once), so the kernel
//     computes the same bits as an unblocked loop of FMA rank-1 steps and is
//     bitwise deterministic, which the sharded hr path needs: B8 is
//     replicated on every rank there.
// Where the block does not fit C = 16 CTAs' shared memory (nb of about 700
// and up), the same code runs on the lu output in global memory (template
// RES = false), reading the owner's panel through L2.
#include "geqrt_cluster.cuh"

namespace {
namespace lu {

namespace cg = cooperative_groups;

constexpr int THREADS = cl::CL_THREADS;
constexpr int IB = 16;  // the panel width, a panel row held in registers

__host__ __device__ inline int cols_per_cta(int n, int ctas) { return cl::ceil_div(n, ctas); }

// the panel width: IB, or a CTA's columns where it holds fewer
__host__ __device__ inline int panel_width(int n, int ctas) {
  const int cpc = cols_per_cta(n, ctas);
  return cpc < IB ? cpc : IB;
}

// shared floats per CTA: row j of the panel's column loop (two parities of
// IB), then, when resident, the slab (n x (cpc + 1)) and the copy of L's
// panel (n x (ib + 1)); kernels/modlu.py:modlu_smem_bytes mirrors it
__host__ __device__ inline long long smem_floats(int n, int ctas, bool res) {
  const long long big =
      (long long)n * (cols_per_cta(n, ctas) + 1) + (long long)n * (panel_width(n, ctas) + 1);
  return 2 * IB + (res ? big : 0);
}

// Stage timer, compiled only with TQ_CL_STAGES (utils/cluster_stages.py):
// thread 0 of every CTA adds each stage's globaltimer nanoseconds to
// lu_stage_ns[rank]: 0 the block's load and store, 1 factoring its own
// panels, 2 the cluster barrier (with the wait for the panel's owner), 3
// the copy of L's panel, 4 U12, 5 the trailing product.
constexpr int LU_STAGES = 6;
#ifdef TQ_CL_STAGES
__device__ unsigned long long lu_stage_ns[16][LU_STAGES];
#define LU_STAGE(i)                                                              \
  do {                                                                           \
    if (threadIdx.x == 0) {                                                      \
      unsigned long long t_;                                                     \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                     \
      if ((i) >= 0) lu_stage_ns[rank][(i) < 0 ? 0 : (i)] += t_ - lu_last;        \
      lu_last = t_;                                                              \
    }                                                                            \
  } while (0)
#else
#define LU_STAGE(i) \
  do {              \
  } while (0)
#endif

template <bool RES>
__device__ __forceinline__ float peer(const float* p) {
  return RES ? *p : __ldcg(p);
}

// x[c] = a * y[c] + x[c] for c in [c, hi), one FMA each; four columns'
// loads issued before their FMAs
__device__ __forceinline__ void axpy_row(float* x, const float* y, float a, int c, int hi) {
  for (; c + 4 <= hi; c += 4) {
    float xv[4], yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = x[c + u];
      yv[u] = y[c + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) x[c + u] = fmaf(a, yv[u], xv[u]);
  }
  for (; c < hi; ++c) x[c] = fmaf(a, y[c], x[c]);
}

// The column loop of panel [s, s + ibk) on its owner: the panel is the
// slab's local columns [pc, pc + ibk), global row j at slab[j * ld]. Each
// column: every thread reads the pivot and chooses d_j, the rows below are
// scaled and updated, one __syncthreads.
// REG (rows n - s <= THREADS): thread t holds row s + t of the panel in
// registers; row j goes to every thread through rowbuf (two parities: the
// owner of row j + 2 writes one only after the barrier that ends every read
// of row j). Otherwise (more rows than threads, nb > 512) the rows stay in
// the slab, a row a thread at a time.
template <bool REG>
__device__ void panel(float* slab, int ld, int n, int s, int pc, int ibk, float* d,
                      float* rowbuf) {
  const int tid = threadIdx.x;
  if constexpr (REG) {
    const bool mine = s + tid < n;
    float* ri = slab + (long long)(s + tid) * ld + pc;
    float a[IB];
#pragma unroll
    for (int c = 0; c < IB; ++c) a[c] = (mine && c < ibk) ? ri[c] : 0.f;
#pragma unroll
    for (int jj = 0; jj < IB; ++jj) {
      if (jj < ibk) {
        float* rb = rowbuf + (jj & 1) * IB;
        if (tid == jj) {
#pragma unroll
          for (int c = jj; c < IB; ++c) rb[c] = a[c];
        }
        __syncthreads();
        const float piv0 = rb[jj];
        const float dj = piv0 > 0.f ? -1.f : 1.f;
        const float piv = piv0 - dj;
        if (tid > jj && mine) {
          const float l = a[jj] / piv;
          a[jj] = l;
#pragma unroll
          for (int c = jj + 1; c < IB; ++c) a[c] = fmaf(-l, rb[c], a[c]);
        }
        if (tid == jj) {
          a[jj] = piv;
          d[s + jj] = dj;
        }
      }
    }
    if (mine) {
#pragma unroll
      for (int c = 0; c < IB; ++c)
        if (c < ibk) ri[c] = a[c];
    }
  } else {
    float pend = 0.f;  // thread 0: the previous column's pivot, stored after the barrier
    for (int jj = 0; jj < ibk; ++jj) {
      const int j = s + jj;
      const float* rj = slab + (long long)j * ld + pc;
      // (j, jj) is read by every thread below, so the pivot goes there only
      // in the next step; (j - 1, jj - 1) is read by nobody now
      if (tid == 0 && jj > 0) slab[(long long)(j - 1) * ld + pc + jj - 1] = pend;
      const float piv0 = rj[jj];
      const float dj = piv0 > 0.f ? -1.f : 1.f;
      const float piv = piv0 - dj;
      for (int i = j + 1 + tid; i < n; i += THREADS) {
        float* ri = slab + (long long)i * ld + pc;
        const float l = ri[jj] / piv;
        ri[jj] = l;
        axpy_row(ri, rj, -l, jj + 1, ibk);
      }
      if (tid == 0) {
        pend = piv;
        d[j] = dj;
      }
      __syncthreads();
    }
    if (tid == 0) slab[(long long)(s + ibk - 1) * ld + pc + ibk - 1] = pend;
  }
}

// U12 = L11^-1 A12 on the slab's local columns [c0, c1), rows [s, s + ibk):
// row s + jj takes the rank-1 steps k < jj in order, a column a thread,
// its ibk values in registers. L(i, k) = lp[(i - s) * lld + k].
template <bool RES>
__device__ void solve(float* slab, int ld, int s, int ibk, int c0, int c1, const float* lp,
                      int lld) {
  for (int c = c0 + threadIdx.x; c < c1; c += THREADS) {
    float* col = slab + (long long)s * ld + c;
    float x[IB];
#pragma unroll
    for (int jj = 0; jj < IB; ++jj) x[jj] = jj < ibk ? col[(long long)jj * ld] : 0.f;
#pragma unroll
    for (int k = 0; k < IB; ++k) {
#pragma unroll
      for (int jj = k + 1; jj < IB; ++jj)
        if (jj < ibk) x[jj] = fmaf(-peer<RES>(lp + (long long)jj * lld + k), x[k], x[jj]);
    }
#pragma unroll
    for (int jj = 1; jj < IB; ++jj)
      if (jj < ibk) col[(long long)jj * ld] = x[jj];
  }
}

// A22 -= L21 U12 on rows [e, n) and the slab's local columns [c0, c1), K =
// ibk: each output takes its ibk steps in order, one FMA each. Thread tile
// 4 x 4: rows ty + 32h of a 128-row tile, columns tx + 16q of a 64-column
// tile. L(i, k) = lp[(i - s) * lld + k], U(k, c) = slab[(s + k) * ld + c].
template <bool RES>
__device__ void trailing(float* slab, int ld, int n, int s, int ibk, int c0, int c1,
                         const float* lp, int lld) {
  const int e = s + ibk, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int i0 = e; i0 < n; i0 += 128) {
    for (int j0 = c0; j0 < c1; j0 += 64) {
      float acc[4][4];
      bool rok[4], cok[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) rok[h] = i0 + ty + 32 * h < n;
#pragma unroll
      for (int q = 0; q < 4; ++q) cok[q] = j0 + tx + 16 * q < c1;
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[h][q] = (rok[h] && cok[q])
                          ? slab[(long long)(i0 + ty + 32 * h) * ld + j0 + tx + 16 * q]
                          : 0.f;
      for (int k = 0; k < ibk; ++k) {
        float lv[4], uv[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          lv[h] = rok[h] ? -peer<RES>(lp + (long long)(i0 + ty + 32 * h - s) * lld + k) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          uv[q] = cok[q] ? slab[(long long)(s + k) * ld + j0 + tx + 16 * q] : 0.f;
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(lv[h], uv[q], acc[h][q]);
      }
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (rok[h] && cok[q]) slab[(long long)(i0 + ty + 32 * h) * ld + j0 + tx + 16 * q] = acc[h][q];
    }
  }
}

// L's panel (rows [s, n): `rows` rows, ibk columns of src, row stride ld)
// into dst (row stride ldl): thread t copies column t % IB of every
// (THREADS / IB)-th row, eight loads in flight before their stores.
__device__ void copy_panel(float* dst, int ldl, const float* src, int ld, int rows, int ibk) {
  constexpr int RS = THREADS / IB;
  const int k = threadIdx.x % IB;
  if (k >= ibk) return;
  for (int r = threadIdx.x / IB; r < rows; r += 8 * RS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (r + u * RS < rows) v[u] = src[(long long)(r + u * RS) * ld + k];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (r + u * RS < rows) dst[(r + u * RS) * ldl + k] = v[u];
  }
}

template <bool RES>
__global__ void __launch_bounds__(THREADS)
modlu_kernel(const float* __restrict__ q, float* lu, int n, float* d) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int cpc = cols_per_cta(n, C);
  const int c0 = rank * cpc, w = max(0, min(cpc, n - c0));  // own columns [c0, c0 + w)
  float* rowbuf = smem;
  float* slab = RES ? smem + 2 * IB : lu + c0;
  const int ld = RES ? cpc + 1 : n;
  float* lbuf = smem + 2 * IB + (long long)n * (cpc + 1);  // RES: L's panel, rows [s, n)
  const int ib = panel_width(n, C), ldl = ib + 1;
#ifdef TQ_CL_STAGES
  unsigned long long lu_last = 0;
#endif
  LU_STAGE(-1);

  // a warp a row, a lane a column
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < n; r += THREADS / 32)
    for (int c = lane; c < w; c += 32) slab[(long long)r * ld + c] = q[(long long)r * n + c0 + c];
  __syncthreads();
  LU_STAGE(0);

  for (int o = 0; o < C; ++o) {
    const int o0 = o * cpc, o1 = min(n, o0 + cpc);
    for (int s = o0; s < o1; s += ib) {
      const int ibk = min(ib, o1 - s), e = s + ibk;
      if (rank == o) {
        if (n - s <= THREADS) panel<true>(slab, ld, n, s, s - c0, ibk, d, rowbuf);
        else panel<false>(slab, ld, n, s, s - c0, ibk, d, rowbuf);
        LU_STAGE(1);
      }
      if (RES) cluster.sync();
      else cl::cluster_sync_global();
      LU_STAGE(2);
      const int cr = max(e, c0) - c0;  // own columns right of the panel: [cr, w)
      if (cr < w) {
        const float* lp;
        int lld;
        if (RES) {
          copy_panel(lbuf, ldl, cluster.map_shared_rank(slab, o) + (long long)s * ld + (s - o0),
                         ld, n - s, ibk);
          __syncthreads();
          lp = lbuf;
          lld = ldl;
        } else {
          lp = lu + (long long)s * n + s;
          lld = n;
        }
        LU_STAGE(3);
        solve<RES>(slab, ld, s, ibk, cr, w, lp, lld);
        __syncthreads();
        LU_STAGE(4);
        trailing<RES>(slab, ld, n, s, ibk, cr, w, lp, lld);
        __syncthreads();
        LU_STAGE(5);
      }
    }
  }

  if (RES) {
    for (int r = warp; r < n; r += THREADS / 32)
      for (int c = lane; c < w; c += 32) lu[(long long)r * n + c0 + c] = slab[(long long)r * ld + c];
  }
  LU_STAGE(0);
  // no CTA leaves while a peer may still read its shared memory
  cluster.sync();
}

}  // namespace lu
}  // namespace

// q: (n x n) contiguous, read only; lu: (n x n) output; d: (n) output.
// ctas, smem, resident: kernels/modlu.py:modlu_plan(n); a launch whose
// shared bytes disagree with this layout is refused.
extern "C" int tq_modified_lu(const float* q, float* lu, int n, float* d, int ctas,
                              long long smem, int resident, void* stream) {
  if (n < 1 || ctas < 1 || smem != (long long)sizeof(float) * lu::smem_floats(n, ctas, resident))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = resident ? lu::modlu_kernel<true> : lu::modlu_kernel<false>;
  return cl::launch_cluster(kernel, ctas, (size_t)smem, st, q, lu, n, d);
}

#ifdef TQ_CL_STAGES
// copy every CTA's stage nanoseconds to `out` (16 x 6 values) and zero them
extern "C" int tq_lu_stages(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, lu::lu_stage_ns, sizeof(lu::lu_stage_ns));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[16 * lu::LU_STAGES] = {};
  return (int)cudaMemcpyToSymbol(lu::lu_stage_ns, zero, sizeof(zero));
}
#endif
