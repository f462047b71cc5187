// B9: batched upper Cholesky R^T R = G, a blocked Cholesky on one
// thread-block cluster per matrix.
//
// Replaces tileqr/drivers/cholqr.py:potrf_batched (_mk_potrf_kernel). The
// TPU kernel keeps a group of (n x n) matrices in VMEM and works in bp-row
// panels: row step j scales row j by rsqrt(max(d2, 1e-30)) (the clamp turns
// a breakdown into a NaN or huge health value, not an exception) and
// rank-1-updates the panel rows below it on the lanes right of j, which is
// the panel TRSM folded in; after the panel, one SYRK
// G[e:, e:] -= R12^T R12 updates the trailing matrix.
//
// What bounds it on the H100: latency. n serial row steps (256 on an hr
// panel's gram), each waiting for the one before; the n^3/3 FLOP (5.6 M at
// n = 256) and 0.5 MB would take well under a microsecond at the card's
// rates. A 256^2 matrix (256 KiB) does not fit one SM's shared memory.
//
// The design: one cluster of C CTAs a matrix (kernels/potrf.py:potrf_plan
// picks C and the shared bytes from the shapes and the SM count), B
// clusters in one launch.
//   - The split: the matrix's bp-row blocks are dealt to the CTAs
//     cyclically, block k to CTA k mod C, so the trailing work stays spread
//     as the panels move down. A CTA holds each of its blocks from the
//     block's first column on (row stride rounded up to 4 floats) in its
//     shared memory: nothing left of a row's block is ever read, so it is
//     neither stored nor updated, and the SYRK covers half the matrix.
//   - A panel (block k) on its owner: one warp runs its bp row steps on the
//     panel's diagonal block (bp x bp, a column a lane, the pivot columns
//     passed by shuffles) and posts every step's pivot column and
//     1 / sqrt(pivot); after one __syncthreads every thread replays the
//     steps on its own columns right of the block, in registers. (A
//     __syncthreads a row step, the first design, spent ~0.6 us a step.)
//   - One cluster barrier a panel publishes it. Every CTA with trailing
//     blocks copies the panel from the owner's shared memory
//     (cluster.map_shared_rank) and applies the SYRK to its own blocks,
//     each thread a 4 x 4 tile of outputs out of shared memory. n/bp cluster
//     barriers in all (16 at n = 256).
//   - R is written once at the end, zeros left of each block.
// Where C = 16 CTAs' shared memory does not hold the matrix (n of about
// 1100 and up), or a stack's C leaves it too large, the same code runs on
// the output in global memory (template RES = false), reading the owner's
// panel through L2; the plan picks that route from the shape.
//
// Arithmetic: IEEE fp32 on the CUDA cores, no TF32, no atomics, and every
// entry's operations are the one-block kernel's (PR 2's) in its order: the
// row step x - (a r)(b r), the row scaling by 1 / sqrtf(fmaxf(d, 1e-30)),
// each panel's SYRK x - sum_t fmaf(.,.) as a chain from 0 in panel order.
// So R is bitwise that kernel's, whatever C, and B9, which the sharded hr
// path replicates on every rank, agrees across ranks.
#include "geqrt_cluster.cuh"

namespace {
namespace chol {

namespace cg = cooperative_groups;

constexpr int BP = 16;  // the largest panel, its rows held in registers

// the most columns a thread holds in a panel's row steps: 2 for the
// resident blocks (kernels/potrf.py:potrf_threads keeps n <= 2 threads),
// up to 8 on the global route of 512 threads (n <= 4096)
__host__ __device__ inline int max_cols(int threads, bool res) {
  return (res || threads < 512) ? 2 : 8;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// the row stride of block k (columns [k bp, n))
__host__ __device__ inline int block_ld(int n, int bp, int k) { return round4(n - k * bp); }

// floats before block k in its CTA's storage (blocks k mod C, k mod C + C, ...)
__host__ __device__ inline long long block_offset(int n, int bp, int ctas, int k) {
  long long off = 0;
  for (int u = k % ctas; u < k; u += ctas) off += (long long)bp * block_ld(n, bp, u);
  return off;
}

// shared floats per CTA: a panel's pivot columns and their 1 / sqrt(pivot)
// (BP x BP + BP), then, when resident, CTA 0's blocks (the most of any
// CTA) and, on a cluster, the copy of a panel (bp x round4(n));
// kernels/potrf.py:potrf_smem_bytes mirrors it
constexpr int PIV_FLOATS = BP * BP + BP;

__host__ __device__ inline long long smem_floats(int n, int bp, int ctas, bool res) {
  if (!res) return PIV_FLOATS;
  const int nblk = (n + bp - 1) / bp;
  const long long copy = ctas > 1 ? (long long)bp * round4(n) : 0;
  return PIV_FLOATS + block_offset(n, bp, ctas, nblk - 1 + ctas - (nblk - 1) % ctas) + copy;
}

// Stage timer, compiled only with TQ_CL_STAGES (utils/cluster_stages.py):
// thread 0 of every CTA of cluster 0 adds each stage's globaltimer
// nanoseconds to potrf_stage_ns[rank]: 0 the blocks' load and store, 1 the
// row steps of its own panels, 2 the cluster barriers (with the wait for
// each panel's owner), 3 the copies of the panels, 4 the SYRKs
constexpr int POTRF_STAGES = 5;
#ifdef TQ_CL_STAGES
__device__ unsigned long long potrf_stage_ns[16][POTRF_STAGES];
#define PO_STAGE(i)                                                        \
  do {                                                                     \
    if (blockIdx.x < (unsigned)C && threadIdx.x == 0) {                    \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      if ((i) >= 0) potrf_stage_ns[rank][(i) < 0 ? 0 : (i)] += t_ - po_last; \
      po_last = t_;                                                        \
    }                                                                      \
  } while (0)
#else
#define PO_STAGE(i) \
  do {              \
  } while (0)
#endif

template <bool RES>
__device__ __forceinline__ float peer(const float* p) {
  return RES ? *p : __ldcg(p);
}

// The row steps of the panel (bpe rows, columns [s, n)) at `blk` (element
// (i, l) at blk[i * ld + l - s]) on its owner, with one __syncthreads:
// warp 0 factors the panel's diagonal block (lane c holds its column c in
// registers, each step's pivot column passed by shuffles) and posts each
// step's pivot column and 1 / sqrt(pivot) to shared memory (piv: BP x BP
// floats, then BP); then every thread replays the bpe steps on its columns
// right of the block, s + bpe + t + u THREADS, u < U, in registers. Every
// entry takes the one-block kernel's operations in its order.
template <int THREADS, int U>
__device__ void row_steps(float* blk, int ld, int s, int n, int bpe, float* piv) {
  constexpr unsigned FULL = 0xffffffffu;
  const int tid = threadIdx.x;
  float* rv = piv + BP * BP;
  if (tid < 32) {
    const int lane = tid;
    float d[BP];
#pragma unroll
    for (int i = 0; i < BP; ++i) d[i] = (lane < bpe && i < bpe) ? blk[i * ld + lane] : 0.f;
#pragma unroll
    for (int jj = 0; jj < BP; ++jj) {
      if (jj < bpe) {
        const float rinv = 1.f / sqrtf(fmaxf(__shfl_sync(FULL, d[jj], jj), 1e-30f));
        float cj[BP];
#pragma unroll
        for (int i = jj + 1; i < BP; ++i) cj[i] = __shfl_sync(FULL, d[i], jj);
        if (lane == jj) {
          rv[jj] = rinv;
#pragma unroll
          for (int i = jj + 1; i < BP; ++i) piv[jj * BP + i] = d[i];
        }
        if (lane > jj && lane < bpe) {
#pragma unroll
          for (int i = jj + 1; i < BP; ++i) {
            if (i < bpe) {
              const float upd = (cj[i] * rinv) * (d[jj] * rinv);
              d[i] = d[i] - upd;
            }
          }
        }
        d[jj] = lane >= jj ? d[jj] * rinv : 0.f;
      }
    }
    if (lane < bpe) {
#pragma unroll
      for (int i = 0; i < BP; ++i)
        if (i < bpe) blk[i * ld + lane] = d[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int l = s + bpe + tid + u * THREADS;
    if (l < n) {
      float p[BP];
#pragma unroll
      for (int i = 0; i < BP; ++i) p[i] = i < bpe ? blk[i * ld + l - s] : 0.f;
#pragma unroll
      for (int jj = 0; jj < BP; ++jj) {
        if (jj < bpe) {
          const float rinv = rv[jj];
#pragma unroll
          for (int i = jj + 1; i < BP; ++i) {
            if (i < bpe) {
              const float upd = (piv[jj * BP + i] * rinv) * (p[jj] * rinv);
              p[i] = p[i] - upd;
            }
          }
          p[jj] = p[jj] * rinv;
        }
      }
#pragma unroll
      for (int i = 0; i < BP; ++i)
        if (i < bpe) blk[i * ld + l - s] = p[i];
    }
  }
}

template <bool RES, int THREADS>
__device__ void panel(float* blk, int ld, int s, int n, int bpe, float* piv) {
  const int u = (n - s - bpe + THREADS - 1) / THREADS;
  if (u <= 1) {
    row_steps<THREADS, 1>(blk, ld, s, n, bpe, piv);
  } else if (u <= 2) {
    row_steps<THREADS, 2>(blk, ld, s, n, bpe, piv);
  } else if constexpr (!RES && THREADS == 512) {
    if (u <= 4) row_steps<THREADS, 4>(blk, ld, s, n, bpe, piv);
    else row_steps<THREADS, 8>(blk, ld, s, n, bpe, piv);
  }
}

// this CTA's first block after block k
__device__ __forceinline__ int first_after(int k, int ctas, int rank) {
  return k + 1 + ((rank - (k + 1) % ctas) + ctas) % ctas;
}

// The SYRK of panel [s, e) (bpe rows at pp, element (t, l) at
// pp[t * pld + l - s]) on this CTA's blocks after it, rows i and columns
// l from the row's block's first column on: x(i, l) -= sum_t fmaf(P(t, i),
// P(t, l)), t ascending from 0. Each thread a 4 x 4 tile, the tiles of all
// the CTA's blocks dealt round-robin.
template <bool RES, int THREADS>
__device__ void syrk(float* mine, float* r, int n, int bp, int ctas, int rank, int k,
                     const float* pp, int pld, int s, int bpe) {
  const int tid = threadIdx.x;
  const int nblk = (n + bp - 1) / bp;
  const int first = first_after(k, ctas, rank);
  long long off = RES ? block_offset(n, bp, ctas, first) : 0;
  int base = 0;  // tiles of the blocks before this one
  for (int kb = first; kb < nblk; kb += ctas) {
    const int sb = kb * bp, rows = min(bp, n - sb), w = n - sb;
    const int ld = RES ? block_ld(n, bp, kb) : n;
    float* xb = RES ? mine + off : r + (long long)sb * n + sb;
    const int cgs = (w + 3) / 4, tiles = ((rows + 3) / 4) * cgs;
    const int t0 = ((tid - base) % THREADS + THREADS) % THREADS;
    for (int it = t0; it < tiles; it += THREADS) {
      const int i0 = (it / cgs) * 4, l0 = (it % cgs) * 4;  // within the block
      float acc[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[h][c] = 0.f;
      for (int t = 0; t < bpe; ++t) {
        const float* pr = pp + (long long)t * pld + (sb - s);
        float av[4], bv[4];
        if (RES) {
          const float4 a4 = *reinterpret_cast<const float4*>(pr + i0);
          const float4 b4 = *reinterpret_cast<const float4*>(pr + l0);
          av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
          bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
        } else {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            av[h] = i0 + h < w ? peer<RES>(pr + i0 + h) : 0.f;
            bv[h] = l0 + h < w ? peer<RES>(pr + l0 + h) : 0.f;
          }
        }
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[h][c] = fmaf(av[h], bv[c], acc[h][c]);
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (i0 + h < rows) {
          float* x = xb + (long long)(i0 + h) * ld + l0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (l0 + c < w) x[c] = x[c] - acc[h][c];
        }
      }
    }
    base = (base + tiles) % THREADS;
    if (RES) off += (long long)bp * ld;
  }
}

template <bool RES, int THREADS>
__global__ void __launch_bounds__(THREADS)
potrf_cluster_kernel(const float* __restrict__ g_all, float* r_all, int n, int bp) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long nn = (long long)n * n, mat = blockIdx.x / C;
  const float* g = g_all + mat * nn;
  float* r = r_all + mat * nn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblk = (n + bp - 1) / bp;
  float* piv = smem;
  float* mine = smem + PIV_FLOATS;                                // RES: this CTA's blocks
  float* copy = mine + block_offset(n, bp, C, nblk - 1 + C - (nblk - 1) % C);  // RES, C > 1
#ifdef TQ_CL_STAGES
  unsigned long long po_last = 0;
#endif
  PO_STAGE(-1);

  // this CTA's rows, from their block's first column on (a warp a row)
  {
    long long off = 0;
    for (int kb = rank; kb < nblk; kb += C) {
      const int sb = kb * bp, rows = min(bp, n - sb);
      const int ld = RES ? block_ld(n, bp, kb) : n;
      float* xb = RES ? mine + off : r + (long long)sb * n + sb;
      for (int i = warp; i < rows; i += THREADS / 32)
        for (int l = lane; l < n - sb; l += 32)
          xb[(long long)i * ld + l] = g[(long long)(sb + i) * n + sb + l];
      off += (long long)bp * ld;
    }
  }
  __syncthreads();
  PO_STAGE(0);

  for (int k = 0; k < nblk; ++k) {
    const int s = k * bp, bpe = min(bp, n - s), o = k % C;
    const int ld = RES ? block_ld(n, bp, k) : n;
    if (rank == o) {
      float* blk = RES ? mine + block_offset(n, bp, C, k) : r + (long long)s * n + s;
      panel<RES, THREADS>(blk, ld, s, n, bpe, piv);
      PO_STAGE(1);
    }
    if (C == 1) __syncthreads();
    else if (RES) cluster.sync();
    else cl::cluster_sync_global();
    PO_STAGE(2);
    if (first_after(k, C, rank) < nblk) {
      const float* pp;
      if (!RES) {
        pp = r + (long long)s * n + s;
      } else if (rank == o) {
        pp = mine + block_offset(n, bp, C, k);
      } else {
        // the panel from its owner's shared memory: bpe rows of ld floats
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(mine + block_offset(n, bp, C, k), o));
        float4* dst = reinterpret_cast<float4*>(copy);
        for (int idx = tid; idx < bpe * ld / 4; idx += THREADS) dst[idx] = src[idx];
        __syncthreads();
        pp = copy;
      }
      PO_STAGE(3);
      syrk<RES, THREADS>(mine, r, n, bp, C, rank, k, pp, ld, s, bpe);
    }
    __syncthreads();
    PO_STAGE(4);
  }

  // R: this CTA's rows, zeros left of each block
  {
    long long off = 0;
    for (int kb = rank; kb < nblk; kb += C) {
      const int sb = kb * bp, rows = min(bp, n - sb);
      const int ld = block_ld(n, bp, kb);
      for (int i = warp; i < rows; i += THREADS / 32) {
        float* ro = r + (long long)(sb + i) * n;
        for (int l = lane; l < n; l += 32) {
          if (l < sb) ro[l] = 0.f;
          else if (RES) ro[l] = mine[off + (long long)i * ld + l - sb];
        }
      }
      off += (long long)bp * ld;
    }
  }
  PO_STAGE(0);
  // no CTA leaves while a peer may still read its shared memory
  if (C > 1) cluster.sync();
}

template <bool RES>
int launch(const float* g, float* r, int batch, int n, int bp, int ctas, int threads,
           size_t smem, cudaStream_t st) {
  if (threads == 128)
    return cl::launch_clusters_of(potrf_cluster_kernel<RES, 128>, batch, ctas, 128, smem, st, g,
                                  r, n, bp);
  if (threads == 256)
    return cl::launch_clusters_of(potrf_cluster_kernel<RES, 256>, batch, ctas, 256, smem, st, g,
                                  r, n, bp);
  return cl::launch_clusters_of(potrf_cluster_kernel<RES, 512>, batch, ctas, 512, smem, st, g, r,
                                n, bp);
}

}  // namespace chol
}  // namespace

// g, r: (batch x n x n) contiguous, g read only, r the output. ctas,
// threads, smem, resident: kernels/potrf.py:potrf_plan(batch, n, sms, bp);
// a launch whose shared bytes disagree with this layout, whose threads
// cannot hold a panel row, or whose panel width the kernel does not take
// (bp <= 16, a multiple of 4 unless it covers n), is refused.
extern "C" int tq_potrf_batched(const float* g, float* r, int batch, int n, int bp, int ctas,
                                int threads, long long smem, int resident, void* stream) {
  bp = bp < n ? bp : n;
  const bool res = resident != 0;
  if (n < 1 || batch < 1 || bp < 1 || bp > chol::BP || (bp < n && bp % 4) ||
      (threads != 128 && threads != 256 && threads != 512) ||
      n > chol::max_cols(threads, res) * threads ||
      smem != (long long)sizeof(float) * chol::smem_floats(n, bp, ctas, res))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return res ? chol::launch<true>(g, r, batch, n, bp, ctas, threads, (size_t)smem, st)
             : chol::launch<false>(g, r, batch, n, bp, ctas, threads, (size_t)smem, st);
}

#ifdef TQ_CL_STAGES
// copy every CTA's stage nanoseconds (16 x 5 values) to `out` and zero them
extern "C" int tq_potrf_stages(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, chol::potrf_stage_ns, sizeof(chol::potrf_stage_ns));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[16 * chol::POTRF_STAGES] = {};
  return (int)cudaMemcpyToSymbol(chol::potrf_stage_ns, zero, sizeof(zero));
}
#endif
