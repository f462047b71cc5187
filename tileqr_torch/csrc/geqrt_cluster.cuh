// GEQRT of a sequence of stacked couples by ONE thread-block cluster: the
// device routine of K1 (panel.cu), K2 (chain.cu), TTQRT (ttqrt.cu) and the
// batched GEQRT's cluster route (geqrt_batched.cu, one cluster a matrix).
//
// Replaces, for those kernels, tileqr/kernels/geqrt.py:geqrt_in_refs, the
// Householder column loop inside tileqr/kernels/panel.py:panel_factor,
// tileqr/kernels/chain.py:panel_chain and tileqr/kernels/ttqrt.py:ttqrt. The algebra is the one of
// geqrt.cuh and of the plain version (tileqr_torch/kernels/geqrt.py:
// geqrt_in_place): LARFG with no rescaling, rank-1 updates inside the
// ib-column block, the block's T by the doubling recurrence
// T <- T - T (G o M) T from G = Vb^T Vb, one block-reflector apply to the
// columns right of the block, the off-diagonal T as -T1 (V1^T Vb) Tb.
//
// What bounds it on the H100: latency. Each column depends on the one
// before it, and a couple (m = nb + rows fp32 rows: 1280 x 256 = 1.25 MiB
// in K2 at the defaults, 2560 x 512 = 5 MiB in the tsqr chain at nb = 512)
// is larger than one SM's 227 KB of shared memory. The single-block design
// (geqrt.cuh) streamed it from L2 on one SM.
//
// The design: one cluster of C CTAs (C in {1, 2, 4, 8, 16}, CL_THREADS
// threads each, chosen by kernels/panel.py:cluster_plan from nb, m and
// ib) holds the couple's rows. Which rows a block walks and how the CTAs
// split them is the block's row set (FullRows, PipeRows, TriRows below).
// K1/K2's serial loop (FullRows): every row, split contiguously: CTA q owns
// couple rows [q*rpc, (q+1)*rpc), rpc = ceil(m / C), so the carried R (the
// top nb rows) sits on the first CTAs. Every row is walked, R's zero rows
// too, as the plain version walks them (K2 takes any r_in), so the split is
// balanced. K1/K2 pipelined by ib block (PipeRows, panel_pipe.cuh: one
// cluster a block, couple_block on one block of each couple in turn): the
// rows the block can change, split contiguously. TTQRT (TriRows, sized by panel.py:ttqrt_plan): only the block's live
// rows, dealt out cyclically, each column's dots and update over its
// reflector's support only.
//   - While ib-block [s, s+ibk) is eliminated, each CTA holds its rows of
//     that block in its own shared memory (the slab, row stride ib + 1).
//     The columns right of the block stay in global memory (L2): only the
//     block apply reads and writes them, once per block; the next block is
//     loaded from there when its turn comes. The outputs are the homes of
//     the couple between blocks: the B rows live in the V output, the R
//     rows in r_out, which also carries R from one couple to the next
//     (L2-resident; the slab buffer is reused by every block, so R is not
//     kept in shared memory across couples).
//   - The column loop, with NO cluster barrier per column: each CTA
//     reduces over its rows the tail norm of column j and the raw dots
//     y_c . x of the block's remaining columns with x = column j below the
//     diagonal (each active column's rows split over up to GRP_MAX threads,
//     their partials added in group order). The exchange is point to point:
//     each CTA writes these partials, and the owner of row j that row's
//     values (alpha and y_c[j]), into EVERY CTA's shared memory, its own
//     included, by st.async (part, double-buffered by the parity of a
//     running column count), each store completing its bytes on the
//     receiver's mbarrier for that buffer. Each CTA arms its own barrier
//     with the bytes it expects, (C + 1) x (ibk - jj) floats (C partial
//     vectors and row j), and waits on the barrier's phase: it waits for the
//     data that goes into its sums and for nothing else, where a cluster
//     barrier would also wait for every CTA's arrival and fence all of its
//     memory operations. It then adds the C partials in rank order 0..C-1
//     from its own shared memory, so every CTA holds the same bits, with no
//     atomics. Then y_c . v = y_c[j] + scale * sum_{r>j} y_c[r] x[r] (the
//     plain version rounds v = x*scale first: an O(eps) difference, held to
//     the kernel tolerance), and the rank-1 update is local to each CTA's
//     rows.
//     Reuse of a parity buffer needs no barrier: CTA p writes column k + 2
//     into CTA q's buffer only after its own wait for column k + 1, which
//     needs q's column k + 1 stores, which q makes after it has read column
//     k from that buffer (and after its barrier's phase for column k has
//     completed, so the new bytes count towards the next phase). The
//     barriers are set up once a launch (carve: mbarrier.init, then
//     fence.mbarrier_init and a cluster barrier before any store reaches
//     them), and their phases follow the running column count, which goes
//     on across blocks, couples and pipeline stages. A CTA never leaves
//     while a peer may still write into it: it waits for every store
//     addressed to it, and the block's P reduction that follows each column
//     loop is a cluster barrier.
//   - Block T and the apply: P = Vb^T [V_prev | Vb | A_rest] (ibk x n: the
//     off-diagonal T's Z^T, G and W in one product) is a partial per CTA
//     over its rows, computed in column chunks of CL_CW into shared memory
//     and reduced the same way (each CTA sums its share of the chunk's
//     entries over the ranks in order and writes it to an L2 buffer that
//     all CTAs read). Every CTA then builds Tb from G (the same bits on
//     each; G sits in the slab's place meanwhile, Vb being in its home),
//     reloads Vb, computes W2 = Tb^T W chunk by chunk and applies
//     A_rest -= Vb W2 to its own rows. The off-diagonal T's rows are dealt
//     out over the CTAs. The products run through cta_gemm (128 x 64
//     tiles, 4 x 4 outputs a thread, the next step's operands loaded
//     before this step's FMAs).
//   - Arithmetic is IEEE fp32 FMA on the CUDA cores in every precision
//     mode: no TF32, no tensor cores.
//   - No prefetch of the next couple's tile (cp.async.bulk / TMA): not
//     done in this version; each block is loaded when its turn comes.
//   - The index math of the column loop and the block steps uses no
//     integer division (div_small, shifts): a division is a ~20-instruction
//     sequence, and several stood on each column's critical path.
// On the H100 (PERF.md, utils/cluster_stages.py) the column loop is still
// most of the time; its exchange stage (the stores and the wait for the
// slowest CTA's partials) is the largest part of it, the rest short
// latency-bound loops over shared memory. C = 16 is a non-portable cluster
// size, allowed on the function and checked with
// cudaOccupancyMaxActiveClusters before the launch.
// Where the slab, Tb and the work buffer do not fit 227 KB at any C (ib
// = 256 and up, or very long couples), the same code runs with them in a
// per-CTA global workspace (template RES = false); only the column
// partials then stay in shared memory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {
namespace cl {

namespace cg = cooperative_groups;

constexpr int CL_THREADS = 512;
constexpr int CL_CW = 64;     // columns of a P or W2 chunk
constexpr int GI = 128;       // cta_gemm output tile: GI rows x GJ columns
constexpr int GJ = 64;
constexpr int GK = 16;        // cta_gemm contraction step
constexpr int GRP_MAX = 32;   // threads a column's rows are split over, at most

// Float counts of one CTA's buffers (kernels/geqrt.py:cluster_smem_bytes
// mirrors them): slab, Tb, work buffer (P chunk, W2 chunk, the doubling's X, the
// off-diagonal rows), staging, column partials, group partials, taus.
struct Sizes {
  long long slab, tb, ybuf;
  int stage, part, red, tau;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline Sizes sizes(int nb, int rows, int ib, int ctas) {
  Sizes z;
  const int rpc = ceil_div(rows, ctas);
  int pow2 = 1;  // the doubling's widest half block
  while (2 * pow2 < ib) pow2 *= 2;
  int ycols = CL_CW;
  if (pow2 > ycols) ycols = pow2;
  if (ceil_div(nb, ctas) > ycols) ycols = ceil_div(nb, ctas);
  // the slab also holds G (ib x (ib + 1)) while Tb is built
  z.slab = (long long)(rpc > ib ? rpc : ib) * (ib + 1);
  z.tb = (long long)ib * (ib + 1);
  z.ybuf = (long long)ib * ycols;
  z.stage = GK * (GI + GJ);
  z.part = 2 * (ctas + 1) * ib;
  z.red = ib > CL_THREADS ? ib : CL_THREADS;
  z.tau = ib + 2;
  return z;
}

// The exchange's words, after the buffers at an even float offset (8-byte
// aligned): an mbarrier (8 bytes) per parity buffer of the partials, then
// the count of columns exchanged (4 bytes), in floats with padding.
constexpr int XCH_FLOATS = 6;

__host__ __device__ inline long long xch_offset(const Sizes& z, bool res) {
  const long long small = (long long)z.stage + z.part + z.red + z.tau;
  return ((res ? z.slab + z.tb + z.ybuf + small : small) + 1) & ~1LL;
}

__host__ __device__ inline long long smem_floats(const Sizes& z, bool res) {
  return xch_offset(z, res) + XCH_FLOATS;
}

// global floats: the reduced P (ib x nb), then per CTA the slab, Tb and
// work buffer where they are not resident
__host__ __device__ inline long long ws_floats(int nb, int rows, int ib, int ctas, bool res) {
  const Sizes z = sizes(nb, rows, ib, ctas);
  return (long long)ib * nb + (res ? 0 : (long long)ctas * (z.slab + z.tb + z.ybuf));
}

// One CTA's view of its buffers.
struct Cta {
  float* slab;   // rpc x (ib + 1): its rows of the active block
  float* tb;     // ibk x (ib + 1): Tb^T (lower triangular)
  float* ybuf;   // work buffer
  float* stage;  // cta_gemm staging
  float* part;   // 2 x (C + 1) x ib: every CTA's column partials and row j,
                 // by the parity of the running column count
  float* red;    // group partials of the column loop
  float* tau;    // the block's taus
  float* sc;     // scale and beta of the column just eliminated
  float* pred;   // global: reduced P, ib x nb
  long long ypeer;  // floats between two CTAs' work buffers (RES = false)
  int ld;        // ib + 1
  int ib;
  int rank, ctas;
  int slot;      // the stage timer's row: 0, or a pipeline stage's (panel_pipe.cuh)
};

// The couple's rows: R (r_rows rows, 0 or nb) on top of B. Before the first
// block of a couple the rows are read from their sources, afterwards from
// their homes (which are outputs).
struct Couple {
  int m, r_rows, nb;
  const float* r_src;  // R rows at block 0 (row stride nb)
  float* r_home;       // R rows' home (row stride nb)
  const float* b_src;  // B rows at block 0 (row stride ldb)
  long long ldb;
  float* b_home;       // B rows' home (row stride nb)
  float* t_out;        // T (nb x nb, row-major, upper triangular)
};

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// Stage timer, compiled only with TQ_CL_STAGES (utils/cluster_stages.py
// builds the kernels so and prints the split): thread 0 of CTA 0 adds each
// stage's globaltimer nanoseconds to its row w.slot of cl_stage_ns (0; a
// pipelined panel launch's stage s, panel_pipe.cuh, its own row s, stages
// from CL_SLOTS on untimed): 0 the slab's load and store, 1 P and its
// reduction, 2 Tb, 3 the off-diagonal T, 4 the apply; in the column loop 5
// the dots, 6 the partials' exchange and its wait, 7 LARFG and
// the rank-1 update; 8 a pipeline stage's wait on the hand-off flag of the
// stage before it.
#ifdef TQ_CL_STAGES
constexpr int CL_SLOTS = 8, CL_NSTAGES = 9;
__device__ unsigned long long cl_stage_ns[CL_SLOTS][CL_NSTAGES];
__device__ unsigned long long cl_stage_last[CL_SLOTS];
#define CL_STAGE(i)                                                                 \
  do {                                                                              \
    if (threadIdx.x == 0 && cg::this_cluster().block_rank() == 0 && w.slot < CL_SLOTS) { \
      unsigned long long t_;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                        \
      if ((i) >= 0) cl_stage_ns[w.slot][(i) < 0 ? 0 : (i)] += t_ - cl_stage_last[w.slot]; \
      cl_stage_last[w.slot] = t_;                                                   \
    }                                                                               \
  } while (0)
#else
#define CL_STAGE(i) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ float src_at(const Couple& cp, int g, int c, bool first) {
  if (g < cp.r_rows)
    return ldcg((first ? cp.r_src : cp.r_home) + (long long)g * cp.nb + c);
  const int b = g - cp.r_rows;
  return first ? ldcg(cp.b_src + b * cp.ldb + c) : ldcg(cp.b_home + (long long)b * cp.nb + c);
}

__device__ __forceinline__ float* home_at(const Couple& cp, int g, int c) {
  return g < cp.r_rows ? cp.r_home + (long long)g * cp.nb + c
                       : cp.b_home + (long long)(g - cp.r_rows) * cp.nb + c;
}

// reflector element: V(g, c) = 1 on the diagonal, 0 above, the packed value below
__device__ __forceinline__ float vmask(int g, int c, float packed) {
  return g == c ? 1.f : (g < c ? 0.f : packed);
}

// A barrier of the whole cluster that also publishes global writes to the
// other CTAs (their reads go through L2, ldcg).
__device__ __forceinline__ void cluster_sync_global() {
  __threadfence();
  cg::this_cluster().sync();
}

// Out (I x J) = sum_k a(k, i) b(k, j), k ascending in each output's one
// sequential sum; store(i, j, value). By the whole CTA (CL_THREADS): GI x
// GJ output tiles, each thread 4 x 4 outputs (rows ty + 32h, columns tx +
// 16q), K in steps of GK staged in shared memory.
template <class FA, class FB, class FS>
__device__ void cta_gemm(int I, int J, int K, FA a, FB b, FS store, float* stage) {
  float* As = stage;            // GK x GI: As[kk][ii] = a(k0 + kk, i0 + ii)
  float* Bs = stage + GK * GI;  // GK x GJ: Bs[kk][jj] = b(k0 + kk, j0 + jj)
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  constexpr int SA = GK * GI / CL_THREADS, SB = GK * GJ / CL_THREADS;
  for (int i0 = 0; i0 < I; i0 += GI) {
    for (int j0 = 0; j0 < J; j0 += GJ) {
      float acc[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][q] = 0.f;
      // the next step's operands are loaded into registers before this
      // step's products, so their latency (L2 for the global operands)
      // overlaps the FMAs
      float ra[SA], rb[SB];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int h = 0; h < SA; ++h) {
          const int idx = tid + h * CL_THREADS, kk = idx / GI, e = idx % GI;
          ra[h] = (k0 + kk < K && i0 + e < I) ? a(k0 + kk, i0 + e) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < SB; ++h) {
          const int idx = tid + h * CL_THREADS, kk = idx / GJ, e = idx % GJ;
          rb[h] = (k0 + kk < K && j0 + e < J) ? b(k0 + kk, j0 + e) : 0.f;
        }
      };
      if (K > 0) fetch(0);
      for (int k0 = 0; k0 < K; k0 += GK) {
#pragma unroll
        for (int h = 0; h < SA; ++h) As[tid + h * CL_THREADS] = ra[h];
#pragma unroll
        for (int h = 0; h < SB; ++h) Bs[tid + h * CL_THREADS] = rb[h];
        __syncthreads();
        if (k0 + GK < K) fetch(k0 + GK);
        const int kend = min(GK, K - k0);
        for (int kk = 0; kk < kend; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) av[h] = As[kk * GI + ty + 32 * h];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Bs[kk * GJ + tx + 16 * q];
#pragma unroll
          for (int h = 0; h < 4; ++h)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(av[h], bv[q], acc[h][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = i0 + ty + 32 * h;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx + 16 * q;
          if (i < I && j < J) store(i, j, acc[h][q]);
        }
      }
    }
  }
  __syncthreads();
}

// ---- the column exchange's PTX: 32-bit shared addresses, a peer's copy of
// one, st.async completing on the receiver's mbarrier, the barrier's arming
// and wait ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of this CTA's shared address `a` in CTA `rank`
__device__ __forceinline__ unsigned peer_u32(unsigned a, int rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// store v at shared::cluster address a, its 4 bytes completing on the
// mbarrier at shared::cluster address bar (in the same CTA as a)
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(a), "f"(v), "r"(bar) : "memory");
}

// the one arrival of the barrier's phase, which then waits for `bytes`
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; the
// stores it counted (from any CTA of the cluster) are visible after it
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The exchange's words: the two mbarriers, then the column count, at the
// first 8-byte boundary after the buffers (whose last are the two scalars
// w.sc): smem_floats' xch_offset, the shared memory being 16-byte aligned
__device__ __forceinline__ unsigned long long* xch_bars(const Cta& w) {
  return reinterpret_cast<unsigned long long*>(
      (reinterpret_cast<unsigned long long>(w.sc + 2) + 7) & ~7ull);
}

__device__ __forceinline__ unsigned* xch_cols(const Cta& w) {
  return reinterpret_cast<unsigned*>(xch_bars(w) + 2);
}

// Split the kernel's buffers: `smem` is the dynamic shared memory, `work`
// the global workspace of ws_floats(nb, rows, ib, C, RES) floats. Sets up
// the column exchange's barriers and ends with a cluster barrier, so that
// no peer's store reaches them before they are set up: called once a
// launch by every thread of every CTA.
template <bool RES>
__device__ Cta carve(float* smem, float* work, int nb, int rows, int ib, int slot = 0) {
  cg::cluster_group cluster = cg::this_cluster();
  Cta w;
  w.rank = (int)cluster.block_rank();
  w.ctas = (int)cluster.num_blocks();
  w.ld = ib + 1;
  w.ib = ib;
  w.slot = slot;
  const Sizes z = sizes(nb, rows, ib, w.ctas);
  CL_STAGE(-1);
  w.pred = work;
  float* p = smem;
  w.ypeer = z.slab + z.tb + z.ybuf;
  float* big = RES ? smem : work + (long long)ib * nb + w.rank * w.ypeer;
  w.slab = big;
  w.tb = w.slab + z.slab;
  w.ybuf = w.tb + z.tb;
  if (RES) p += w.ypeer;
  w.stage = p;
  w.part = w.stage + z.stage;
  w.red = w.part + z.part;
  w.tau = w.red + z.red;
  w.sc = w.tau + ib;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(xch_bars(w) + b))
                   : "memory");
    *xch_cols(w) = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  return w;
}

// entry e of every CTA's work buffer, summed in rank order (the loads
// issued together, then added)
template <bool RES>
__device__ __forceinline__ float sum_ranks(const Cta& w, int e) {
  float v[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    if (p < w.ctas) {
      if constexpr (RES) v[p] = cg::this_cluster().map_shared_rank(w.ybuf, p)[e];
      else v[p] = ldcg(w.ybuf + (long long)(p - w.rank) * w.ypeer + e);
    }
  }
  float t = 0.f;
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if (p < w.ctas) t += v[p];
  return t;
}

// sum_{r in [r, hi)} y[r] x[r] into acc, rows in order; four rows' loads
// are issued before their FMAs (the same sequential sum)
__device__ __forceinline__ float dot_rows(const float* slab, int ld, int c, int jj, int r,
                                          int hi, float acc) {
  for (; r + 4 <= hi; r += 4) {
    float y[4], x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = slab[(r + i) * ld + c];
      x[i] = slab[(r + i) * ld + jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(y[i], x[i], acc);
  }
  for (; r < hi; ++r) acc = fmaf(slab[r * ld + c], slab[r * ld + jj], acc);
  return acc;
}

// y[r] -= tw * (x[r] * scale) over rows [r, hi), four rows a step
__device__ __forceinline__ void update_rows(float* slab, int ld, int c, int jj, int r, int hi,
                                            float tw, float scale) {
  for (; r + 4 <= hi; r += 4) {
    float y[4], x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = slab[(r + i) * ld + c];
      x[i] = slab[(r + i) * ld + jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) slab[(r + i) * ld + c] = y[i] - tw * (x[i] * scale);
  }
  for (; r < hi; ++r) slab[r * ld + c] = slab[r * ld + c] - tw * (slab[r * ld + jj] * scale);
}

// floor(x / d) for 0 <= x < 2^20 and 1 <= d < 2^20, without an integer
// division (a ~20-instruction sequence on the column loop's critical path):
// the float quotient is within one of it, and one step corrects it
__device__ __forceinline__ int div_small(int x, int d) {
  int q = __float2int_rz(__fdividef((float)x, (float)d));
  if ((q + 1) * d <= x) ++q;
  else if (q * d > x) --q;
  return q;
}

// threads per active column in the column loop
__device__ __forceinline__ int groups_of(int na) {
  return min(GRP_MAX, max(1, div_small(CL_THREADS, na)));
}

// This CTA's rows of a block's row set (Rows below): slab row r holds live
// index li(r) = li0 + (r << sh), r < nr, in increasing order (the step is a
// power of two: 1, or the cluster size).
struct Mine {
  int li0, sh, nr;
  __device__ int li(int r) const { return li0 + (r << sh); }
  // the first slab row whose live index is >= x (nr if none)
  __device__ int from(int x) const {
    return x <= li0 ? 0 : min(nr, (x - li0 + (1 << sh) - 1) >> sh);
  }
  // the slab row of live index x, or -1 when another CTA holds it
  __device__ int at(int x) const {
    const int d = x - li0;
    return (d >= 0 && (d & ((1 << sh) - 1)) == 0 && (d >> sh) < nr) ? d >> sh : -1;
  }
};

// The rows a block [s, s + ibk) of a couple walks: its row set, in the
// order of the slab (a row's index in it is its "live index" li). Each set
// says
//   n      how many rows it has;
//   d0     the live index of column s's diagonal row (column s + jj's is
//          d0 + jj; the rows after it in the set are below the diagonal);
//   mine   which of them CTA q of C holds;
//   tail   the live indices [lo, hi) after column jj's diagonal where its
//          reflector can be non-zero (the other rows after it hold exact
//          zeros in that column);
//   split_tail  whether the column loop deals the tail's rows (rather
//          than all the CTA's rows) out to the thread groups of a column;
//   row    the couple row of a live index;
//   fresh  whether the row was in no earlier block's set (its block
//          columns and those right of it are read from the source, not
//          its home);
//   vprev  the reflector element V(row, c) of an earlier block's column
//          c < s, from its home or known zero;
//   moves  whether a row can change CTA from one block to the next (then a
//          block starts with a cluster barrier: its rows' homes were last
//          written by the previous block's apply on other CTAs).
//
// FullRows (K1, K2): every row of the couple, in couple order, in every
// block, split contiguously: CTA q owns [q*rpc, (q+1)*rpc), rpc = ceil(m /
// C) (K1/K2's split, unchanged; a column's tail is every row after its
// diagonal).
struct FullRows {
  static constexpr bool moves = false, split_tail = false;
  int n, d0, s;
  __device__ FullRows(const Couple& cp, int s_, int) : n(cp.m), d0(s_), s(s_) {}
  __device__ Mine mine(int q, int C) const {
    const int rpc = ceil_div(n, C);
    return Mine{q * rpc, 0, max(0, min(rpc, n - q * rpc))};
  }
  __device__ int tail_lo(int jj) const { return d0 + jj + 1; }
  __device__ int tail_hi(int) const { return n; }
  __device__ int row(int li) const { return li; }
  __device__ bool fresh(int) const { return s == 0; }
  __device__ float vprev(const Couple& cp, int li, int c) const {
    return vmask(li, c, ldcg(home_at(cp, li, c)));
  }
};

// TriRows (TTQRT): the couple [R1; R2] of two upper-triangular nb x nb
// tiles (r_rows = nb). While block [s, e) is eliminated only R1's rows
// [s, e) and R2's rows [0, e) can be non-zero in its columns: R1's rows
// above s are final R rows that no reflector j >= s touches, R1's rows
// past e and R2's rows past e hold exact zeros there. The set is R1's rows
// [s, e) (live indices 0..ibk-1, the diagonals at d0 = 0), then R2's rows
// [0, e); ibk + e rows, against the couple's 2 nb. Inside the block,
// column j's reflector lives on R1's row j and R2's rows [0, j]: its tail
// is live indices [ibk, ibk + j + 1). The rows are dealt out cyclically
// (CTA q holds li = q, q + C, ...), so every column's tail is spread over
// all C CTAs. The off-diagonal T's V_prev^T Vb needs no other row:
// V_prev's R1 rows (its unit diagonals, rows < s) are not in Vb's support,
// and its R2 rows [0, s) are in the set. An R2 row r joins the set with the
// block that holds column r and stays.
struct TriRows {
  static constexpr bool moves = true, split_tail = true;
  int n, d0, s, ibk, nb;
  __device__ TriRows(const Couple& cp, int s_, int ibk_)
      : n(2 * ibk_ + s_), d0(0), s(s_), ibk(ibk_), nb(cp.nb) {}
  __device__ Mine mine(int q, int C) const {
    return Mine{q, __ffs(C) - 1, q < n ? ceil_div(n - q, C) : 0};
  }
  __device__ int tail_lo(int) const { return ibk; }
  __device__ int tail_hi(int jj) const { return ibk + s + jj + 1; }
  __device__ int row(int li) const { return li < ibk ? s + li : nb + li - ibk; }
  __device__ bool fresh(int li) const { return li < ibk || li - ibk >= s; }
  __device__ float vprev(const Couple& cp, int li, int c) const {
    // R1 rows: below their diagonal (c < s <= row), zero; R2 row r: V2 is
    // upper triangular, zero for r > c
    const int r = li - ibk;
    return (r >= 0 && r <= c) ? ldcg(cp.b_home + (long long)r * cp.nb + c) : 0.f;
  }
};

// PipeRows (a stage of a pipelined K1/K2 launch, panel_pipe.cuh): block s
// walks only the rows at or below its first diagonal that it can change, so
// that the stages running beside it on other couples touch none of them.
// A TS couple [R; B] (R upper triangular, r_rows = nb): R's rows [s, s +
// ibk), then every B row; reflector j lives on R's row j and on B, so R's
// rows past the block hold zeros in its columns, its apply leaves them as
// they are, and earlier blocks' reflectors are zero on the block's R rows.
// A full couple (the GEQRT step's tile, r_rows = 0, or the first couple of
// a K2 launch, whose R rows of later blocks come from r_in): every row from
// s on, [s, m), the rows above s being final R rows that no reflector j >= s
// touches.
// Rows in couple order, split contiguously over the CTAs (live index li,
// the block's first diagonal at li = 0); every row past a column's
// diagonal is its tail.
struct PipeRows {
  static constexpr bool moves = false, split_tail = false;
  int n, d0, s, ibk, r_rows;
  bool full;
  __device__ PipeRows(const Couple& cp, int s_, int ibk_, bool full_)
      : n(full_ ? cp.m - s_ : ibk_ + cp.m - cp.r_rows), d0(0), s(s_), ibk(ibk_),
        r_rows(cp.r_rows), full(full_) {}
  __device__ Mine mine(int q, int C) const {
    const int rpc = ceil_div(n, C);
    return Mine{q * rpc, 0, max(0, min(rpc, n - q * rpc))};
  }
  __device__ int tail_lo(int jj) const { return jj + 1; }
  __device__ int tail_hi(int) const { return n; }
  __device__ int row(int li) const { return (full || li < ibk) ? s + li : r_rows + li - ibk; }
  __device__ bool fresh(int) const { return s == 0; }
  __device__ float vprev(const Couple& cp, int li, int c) const {
    // row > c: the packed value from its home; a TS couple's R rows: zero
    return (full || li >= ibk) ? ldcg(home_at(cp, row(li), c)) : 0.f;
  }
};

// The Householder column loop over an ibk-column block on this CTA's rows
// `mine` of the block's row set: column jj's diagonal row is live index
// rows.d0 + jj, and its reflector lives there and on its tail. No cluster
// barrier: each column's partials and row j go by st.async into every CTA's
// part buffer of the column's parity, and each CTA waits on its own mbarrier
// for them (the exchange, above). Every thread works on the columns still
// active: each of the n_act active columns gets groups_of(n_act) threads,
// each a contiguous group of rows (of all the CTA's rows, or of the tail's
// where the set splits the tail), so the rows per thread shrink as the
// block's columns are eliminated (and a column's partial sums at most
// GRP_MAX groups).
template <class Rows>
__device__ void column_loop(const Cta& w, const Rows& rows, const Mine& mine, int ibk) {
  const int tid = threadIdx.x, ld = w.ld, ib = w.ib, nr = mine.nr;
  float* slab = w.slab;
  for (int jj = 0; jj < ibk; ++jj) {
    const int j = rows.d0 + jj;
    const unsigned col = *xch_cols(w), buf = col & 1;  // the columns exchanged before
    float* part = w.part + buf * (w.ctas + 1) * ib;  // [rank][ib], then row j
    const unsigned bar = smem_u32(xch_bars(w) + buf);
    // the rows the thread groups of a column split, and the tail's
    const int tlo = mine.from(rows.tail_lo(jj)), thi = mine.from(rows.tail_hi(jj));
    const int glo = Rows::split_tail ? tlo : 0, ghi = Rows::split_tail ? thi : nr;
    // A: pack column jj - 1 (nobody reads it in this phase); this CTA's
    // dots of column j's tail with itself and with the columns right of it
    if (jj > 0) {
      const float scale = w.sc[0], beta = w.sc[1];
      for (int r = mine.from(j - 1) + tid; r < nr; r += CL_THREADS) {
        float* x = slab + r * ld + jj - 1;
        *x = (mine.li(r) == j - 1) ? beta : *x * scale;
      }
    }
    {
      const int na = ibk - jj, grp = groups_of(na), rg = div_small(ghi - glo + grp - 1, grp);
      for (int u = tid; u < grp * na; u += CL_THREADS) {
        const int g = div_small(u, na), c = jj + u - g * na;
        const int lo = glo + g * rg, hi = min(ghi, lo + rg);
        w.red[u] = dot_rows(slab, ld, c, jj, max(lo, tlo), min(hi, thi), 0.f);
      }
    }
    __syncthreads();
    CL_STAGE(5);
    // B: the CTA's partials, and the owner's row j, into every CTA's part
    // buffer by st.async; then the wait for the C partial vectors and row j
    // that this CTA's buffer receives
    const int rj = mine.at(j);
    const bool own = rj >= 0;
    {
      const int na = ibk - jj, grp = groups_of(na);
      if (tid == 0) mbar_expect(bar, (unsigned)((w.ctas + 1) * na * sizeof(float)));
      for (int c = jj + tid; c < ibk; c += CL_THREADS) {
        float t = 0.f;
        for (int g = 0; g < grp; ++g) t += w.red[g * na + c - jj];
        const float yj = own ? slab[rj * ld + c] : 0.f;
        const unsigned to_part = smem_u32(part + w.rank * ib + c);
        const unsigned to_row = smem_u32(part + w.ctas * ib + c);
        for (int p = 0; p < w.ctas; ++p) {
          const unsigned pbar = peer_u32(bar, p);
          st_async(peer_u32(to_part, p), t, pbar);
          if (own) st_async(peer_u32(to_row, p), yj, pbar);
        }
      }
    }
    mbar_wait(bar, (col >> 1) & 1);
    CL_STAGE(6);
    // C: the partials of every CTA in rank order, LARFG, the rank-1 update
    const float* yrow = part + w.ctas * ib;
    float tailsq = 0.f;
    for (int p = 0; p < w.ctas; ++p) tailsq += part[p * ib + jj];
    const float alpha = yrow[jj];
    const float sgn = alpha >= 0.f ? 1.f : -1.f;
    const float nrm = sqrtf(alpha * alpha + tailsq);
    const bool has_tail = tailsq > 0.f;
    const float beta = has_tail ? -sgn * nrm : alpha;
    const float tau = has_tail ? (beta - alpha) / beta : 0.f;
    const float scale = has_tail ? 1.f / (alpha - beta) : 0.f;
    if (tid == 0) {
      w.tau[jj] = tau;
      w.sc[0] = scale;
      w.sc[1] = beta;
      *xch_cols(w) = col + 1;  // every thread read col before phase A's barrier
    }
    const int na = ibk - jj - 1;  // the columns right of column j
    if (na > 0) {
      const int grp = groups_of(na), rg = div_small(ghi - glo + grp - 1, grp);
      for (int u = tid; u < grp * na; u += CL_THREADS) {
        const int g = div_small(u, na), c = jj + 1 + u - g * na;
        float d = 0.f;
        for (int p = 0; p < w.ctas; ++p) d += part[p * ib + c];
        const float tw = tau * (yrow[c] + scale * d);
        const int lo = glo + g * rg, hi = min(ghi, lo + rg);
        if (Rows::split_tail) {
          if (g == 0 && own) slab[rj * ld + c] = slab[rj * ld + c] - tw;  // v = 1 on row j
          update_rows(slab, ld, c, jj, max(lo, tlo), min(hi, thi), tw, scale);
        } else {
          int r = max(lo, mine.from(j));
          if (r < hi && mine.li(r) == j) {  // v = 1 on row j
            slab[r * ld + c] = slab[r * ld + c] - tw;
            ++r;
          }
          update_rows(slab, ld, c, jj, r, hi, tw, scale);
        }
      }
    }
    __syncthreads();
    CL_STAGE(7);
  }
  // pack the block's last column
  {
    const int jj = ibk - 1, j = rows.d0 + jj;
    const float scale = w.sc[0], beta = w.sc[1];
    for (int r = mine.from(j) + tid; r < nr; r += CL_THREADS) {
      float* x = slab + r * ld + jj;
      *x = (mine.li(r) == j) ? beta : *x * scale;
    }
  }
  __syncthreads();
}

// the live rows of a TTQRT couple's largest block: its slab's row count
__host__ __device__ inline int tri_rows_max(int nb, int ib) { return nb + (ib < nb ? ib : nb); }

// Block [s, s + ibk) of the couple cp over the rows of its set `rows`, in
// place (its homes): the slab's load, the column loop, the slab's store, P,
// Tb, the off-diagonal T and the apply to the columns right of the block; T's
// columns [s, s + ibk) into cp.t_out. Called by every thread of every CTA of
// the cluster.
template <bool RES, class Rows>
__device__ void couple_block(const Couple& cp, const Cta& w, const Rows& rows, int s, int ibk) {
  const int tid = threadIdx.x, ld = w.ld, nb = cp.nb;
  const int q = w.rank, C = w.ctas;
  float* slab = w.slab;
  const Mine mine = rows.mine(q, C);
  const int nr = mine.nr, d0 = rows.d0;
  auto src = [&](int li, int c) { return src_at(cp, rows.row(li), c, rows.fresh(li)); };

  // ---- the block's rows of this CTA into the slab; the column loop ----
  for (int idx = tid; idx < nr * ibk; idx += CL_THREADS) {
    const int r = div_small(idx, ibk), c = idx - r * ibk;
    slab[r * ld + c] = src(mine.li(r), s + c);
  }
  __syncthreads();
  CL_STAGE(0);
  column_loop(w, rows, mine, ibk);
  for (int idx = tid; idx < nr * ibk; idx += CL_THREADS) {
    const int r = div_small(idx, ibk), c = idx - r * ibk;
    *home_at(cp, rows.row(mine.li(r)), s + c) = slab[r * ld + c];
  }
  CL_STAGE(0);

  // ---- P = Vb^T [V_prev | Vb | A_rest], reduced over the cluster ----
  for (int c0 = 0; c0 < nb; c0 += CL_CW) {
    const int cw = min(CL_CW, nb - c0);
    cta_gemm(
        ibk, cw, nr,
        [&](int r, int a) { return vmask(mine.li(r), d0 + a, slab[r * ld + a]); },
        [&](int r, int jc) {
          const int c = c0 + jc, li = mine.li(r);
          if (c < s) return rows.vprev(cp, li, c);
          if (c < s + ibk) return vmask(li, d0 + c - s, slab[r * ld + c - s]);
          return src(li, c);
        },
        [&](int a, int jc, float v) { w.ybuf[a * cw + jc] = v; }, w.stage);
    cluster_sync_global();
    const int e_all = ibk * cw, share = ceil_div(e_all, C);
    for (int e = q * share + tid; e < min(e_all, (q + 1) * share); e += CL_THREADS) {
      const int a = div_small(e, cw);
      w.pred[(long long)a * nb + c0 + e - a * cw] = sum_ranks<RES>(w, e);
    }
    cluster_sync_global();
  }
  CL_STAGE(1);

  // ---- Tb by doubling, transposed (tb = Tb^T), on every CTA; G (from
  // the reduced P) in the slab's place meanwhile: Vb is in its home ----
  float* G = slab;  // G(a, k) = G[a * ld + k]
  for (int idx = tid; idx < ibk * ibk; idx += CL_THREADS) {
    const int a = div_small(idx, ibk), b = idx - a * ibk;
    w.tb[a * ld + b] = (a == b) ? w.tau[a] : 0.f;
    G[a * ld + b] = ldcg(w.pred + (long long)a * nb + s + b);
  }
  __syncthreads();
  float* X = w.ybuf;
  for (int bsz = 1, lb = 0; bsz < ibk; bsz *= 2, ++lb) {
    // X = (G o M) Tb^T on the pairs (odd block A, even block B = A - 1)
    for (int idx = tid; idx < ibk * bsz; idx += CL_THREADS) {
      const int a = idx >> lb, ea = a >> lb;
      if (!(ea & 1)) continue;
      const int b = (ea - 1) * bsz + (idx & (bsz - 1));
      float t = 0.f;
      for (int k = b; k < ea * bsz; ++k) t = fmaf(G[a * ld + k], w.tb[k * ld + b], t);
      X[idx] = t;
    }
    __syncthreads();
    for (int idx = tid; idx < ibk * bsz; idx += CL_THREADS) {
      const int a = idx >> lb, ea = a >> lb, bo = idx & (bsz - 1);
      if (!(ea & 1)) continue;
      float t = 0.f;
      for (int k = ea * bsz; k <= a; ++k) t = fmaf(w.tb[a * ld + k], X[k * bsz + bo], t);
      w.tb[a * ld + (ea - 1) * bsz + bo] = -t;
    }
    __syncthreads();
  }
  if (q == 0) {
    for (int idx = tid; idx < ibk * ibk; idx += CL_THREADS) {
      const int a = div_small(idx, ibk), b = idx - a * ibk;
      cp.t_out[(long long)(s + a) * nb + s + b] = w.tb[b * ld + a];
    }
  }
  for (int idx = tid; idx < nr * ibk; idx += CL_THREADS) {
    const int r = div_small(idx, ibk), c = idx - r * ibk;
    slab[r * ld + c] = ldcg(home_at(cp, rows.row(mine.li(r)), s + c));
  }
  __syncthreads();
  CL_STAGE(2);

  // ---- off-diagonal T[0:s, block] = -T1 (V1^T Vb) Tb, rows dealt out ----
  if (s > 0) {
    const int sh = ceil_div(s, C), a0 = q * sh, na = max(0, min(sh, s - a0));
    // M2 = T1[a0:a0+na, :] Z, Z(k, b) = P(b, k), T1 upper triangular
    cta_gemm(
        na, ibk, s,
        [&](int k, int i) {
          return k >= a0 + i ? ldcg(cp.t_out + (long long)(a0 + i) * nb + k) : 0.f;
        },
        [&](int k, int b) { return ldcg(w.pred + (long long)b * nb + k); },
        [&](int i, int b, float v) { w.ybuf[i * ibk + b] = v; }, w.stage);
    for (int idx = tid; idx < na * ibk; idx += CL_THREADS) {
      const int al = div_small(idx, ibk), a = a0 + al, b = idx - al * ibk;
      float t = 0.f;
      for (int k = 0; k <= b; ++k) t = fmaf(w.tb[b * ld + k], w.ybuf[al * ibk + k], t);
      cp.t_out[(long long)a * nb + s + b] = -t;
      cp.t_out[(long long)(s + b) * nb + a] = 0.f;
    }
    __syncthreads();
  }
  CL_STAGE(3);

  // ---- A_rest <- A_rest - Vb (Tb^T W), chunk by chunk, on own rows ----
  for (int c0 = s + ibk; c0 < nb; c0 += CL_CW) {
    const int cw = min(CL_CW, nb - c0);
    cta_gemm(
        ibk, cw, ibk, [&](int k, int a) { return k <= a ? w.tb[a * ld + k] : 0.f; },
        [&](int k, int jc) { return ldcg(w.pred + (long long)k * nb + c0 + jc); },
        [&](int a, int jc, float v) { w.ybuf[a * cw + jc] = v; }, w.stage);
    cta_gemm(
        nr, cw, ibk, [&](int k, int r) { return vmask(mine.li(r), d0 + k, slab[r * ld + k]); },
        [&](int k, int jc) { return w.ybuf[k * cw + jc]; },
        [&](int r, int jc, float v) {
          const int li = mine.li(r), c = c0 + jc;
          *home_at(cp, rows.row(li), c) = src(li, c) - v;
        },
        w.stage);
  }
  __syncthreads();
  CL_STAGE(4);
}

// Factor the couple cp in place (its homes), T into cp.t_out, each block
// over the rows of its set (FullRows or TriRows). Called by every thread of
// every CTA of the cluster.
template <bool RES, class Rows = FullRows>
__device__ void geqrt_couple_cluster(const Couple& cp, const Cta& w) {
  for (int s = 0; s < cp.nb; s += w.ib) {
    const int ibk = min(w.ib, cp.nb - s);
    const Rows rows(cp, s, ibk);
    if (Rows::moves && s > 0) cluster_sync_global();
    couple_block<RES>(cp, w, rows, s, ibk);
  }
}

// Launch `kernel` as `clusters` clusters of `ctas` CTAs of `threads`
// threads each (a grid of clusters x ctas; cluster k is CTAs [k ctas,
// (k+1) ctas)), with `smem` bytes of dynamic shared memory a CTA. A
// configuration the card refuses returns its error (the wrapper raises);
// nothing else is launched in its place.
template <typename... Exp, typename... Act>
int launch_clusters_of(void (*kernel)(Exp...), int clusters, int ctas, int threads, size_t smem,
                       cudaStream_t stream, Act&&... args) {
  if ((ctas != 1 && ctas != 2 && ctas != 4 && ctas != 8 && ctas != 16) || clusters < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (ctas > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the same with CL_THREADS threads a CTA (K1, K2, TTQRT, B8, the batched
// GEQRT's cluster route)
template <typename... Exp, typename... Act>
int launch_clusters(void (*kernel)(Exp...), int clusters, int ctas, size_t smem,
                    cudaStream_t stream, Act&&... args) {
  return launch_clusters_of(kernel, clusters, ctas, CL_THREADS, smem, stream,
                            static_cast<Act&&>(args)...);
}

// one cluster of `ctas` CTAs (K1, K2, TTQRT, B8)
template <typename... Exp, typename... Act>
int launch_cluster(void (*kernel)(Exp...), int ctas, size_t smem, cudaStream_t stream,
                   Act&&... args) {
  return launch_clusters(kernel, 1, ctas, smem, stream, static_cast<Act&&>(args)...);
}

#ifdef TQ_CL_STAGES
// copy the stage nanoseconds to `out` (CL_SLOTS x CL_NSTAGES values, row by
// row) and zero them
inline int read_stages(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, cl_stage_ns, sizeof(cl_stage_ns));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[CL_SLOTS][CL_NSTAGES] = {};
  return (int)cudaMemcpyToSymbol(cl_stage_ns, zero, sizeof(zero));
}
#endif

// Whether `smem` is the shared bytes this layout needs, the exchange's words
// included (kernels/geqrt.py:cluster_smem_bytes computes the same number); a
// launch given another is refused.
inline bool smem_matches(int nb, int rows, int ib, int ctas, int resident, long long smem) {
  return smem == (long long)sizeof(float) * smem_floats(sizes(nb, rows, ib, ctas), resident != 0);
}

}  // namespace cl
}  // namespace
