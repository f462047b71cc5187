// Batched GEQRT: for every matrix of a (B x m x n) stack, the Householder QR
// with inner block width ib, kcols = min(m, n), into fresh outputs: packed
// (B x m x n; R on and above the diagonal, the reflectors below) and T
// (B x n x n). The input is read only.
//
// Replaces four TPU kernels that compute this one function:
//   - tileqr/drivers/batched.py:geqrt_batched (one matrix per grid step);
//   - tileqr/drivers/batched.py:geqrt_batched_grouped (G matrices per grid
//     step, to amortise the TPU's per-column latency);
//   - tileqr/drivers/tsqr.py:tall_geqrt (every leaf_rows-row leaf of a tall
//     matrix, i.e. the stack a.view(p, leaf_rows, n), and the tree levels'
//     stacked R factors; its staging DMA only fitted a 16 MB VMEM);
//   - tileqr/kernels/geqrt.py:geqrt (B = 1).
// Three routes, picked by kernels/geqrt.py:batched_plan from the shapes and
// the SM count: a matrix whose transposed tile fits one CTA's shared memory
// takes the small route (geqrt_small.cu, several matrices an SM); a stack
// small enough that one thread-block cluster a matrix fits the card takes
// the cluster route (below); any other stack this file's one-block kernel.
//
// The one-block kernel: one thread block of GEQRT_THREADS (1024) threads
// per matrix, each matrix factored by geqrt_couple (geqrt.cuh), B1's algebra
// step by step; the TPU's sequential grid becomes the CUDA grid. The grid
// is capped at the blocks the card holds at once and each block walks the
// batch with stride gridDim.x, so the workspace is bounded by the card, not
// by B; which block takes a matrix changes no result (no atomics, reruns
// are bitwise equal). The transposed tile and T^T live in a per-block
// global workspace (K1's design), for tall leaves (2048 x 512 = 4 MiB at
// 1048576 x 512) and larger tiles. The reflector v (m floats) is in shared
// memory up to V_SHARED_MAX floats and in the workspace beyond, since
// auto_leaf_rows makes 131072-row leaves at n = 8. Loads and stores go
// through a 32 x 33 shared tile, coalesced both ways.
//
// What bounds it on the H100: latency of the serial column loop (two
// block-wide reductions and barriers per column) on each SM, and the
// block GEMMs' fp32 FMA issue. At 132 leaves of 4 MiB in flight the
// working set (528 MB) no longer stays in the 50 MB L2, as K1's single
// couple did: it streams from HBM. Arithmetic is IEEE fp32 FMA on CUDA
// cores (precision "highest", never TF32).
//
// The cluster route, for small stacks (kernels/geqrt.py:batched_cluster_plan:
// m >= n and B stacks of C CTAs fit the card, C >= 2): one thread-block
// cluster of C CTAs a matrix, B clusters in one launch, each running
// geqrt_cluster.cuh's geqrt_couple_cluster on its matrix as one fresh couple
// (FullRows, no R rows: the way K1's step 0 factors its diagonal tile), so
// a matrix's rows sit in C SMs' shared memory (or a per-CTA global
// workspace where they do not fit) and a column costs one exchange of
// partials between its CTAs (st.async, no cluster barrier), instead of one
// SM walking the matrix through L2. It serves B1s (geqrt, B
// = 1: a 256^2 tile on C = 8) and the tsqr tree's levels (2048 x 512 stacks
// of 32, 8, 2, 1 at 1048576 x 512, C = 4, 16, 16, 16), whose few matrices
// left most SMs idle. Its sums run in another order than the one-block
// kernel's (a column's partials over C CTAs, added in rank order), so a
// matrix's bits depend on its route, and the route on the stack's size:
// the routes agree to rounding, and each is held to the plain version by
// tolerance. No sharded path calls this kernel, so no rank-replicated value
// depends on it.
#include "geqrt.cuh"
#include "geqrt_cluster.cuh"

namespace {

constexpr int V_SHARED_MAX = 16384;  // reflector floats kept in shared memory

// dst (cols x rows, row stride dld) = src (rows x cols, row stride sld)^T,
// by all 1024 threads of the block as 32 x 32.
__device__ void block_transpose(const float* src, long long sld, int rows, int cols,
                                float* dst, long long dld) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    for (int c0 = 0; c0 < cols; c0 += 32) {
      const int r = r0 + ty, c = c0 + tx;
      if (r < rows && c < cols) tile[ty][tx] = src[r * sld + c];
      __syncthreads();
      const int rr = r0 + tx, cc = c0 + ty;
      if (rr < rows && cc < cols) dst[cc * dld + rr] = tile[tx][ty];
      __syncthreads();
    }
  }
}

__host__ __device__ inline bool v_in_shared(int m) { return m <= V_SHARED_MAX; }

__host__ __device__ inline long long work_floats(int m, int n, int ib) {
  return (long long)m * n + (long long)n * n + geqrt_ws_floats(n, ib) + (v_in_shared(m) ? 0 : m);
}

__host__ inline size_t smem_bytes(int m) { return v_in_shared(m) ? sizeof(float) * m : 0; }

__global__ void __launch_bounds__(GEQRT_THREADS)
geqrt_batched_kernel(const float* __restrict__ a, float* packed, float* t_out, float* work,
                     long long batch, int m, int n, int kcols, int ib) {
  extern __shared__ float sh[];
  const long long mn = (long long)m * n, nn = (long long)n * n;
  float* at = work + blockIdx.x * work_floats(m, n, ib);
  float* tt = at + mn;
  float* ws = tt + nn;
  float* v = v_in_shared(m) ? sh : ws + geqrt_ws_floats(n, ib);
  for (long long b = blockIdx.x; b < batch; b += gridDim.x) {
    block_transpose(a + b * mn, n, m, n, at, m);
    for (long long idx = threadIdx.x; idx < nn; idx += blockDim.x) tt[idx] = 0.f;
    __syncthreads();
    geqrt_couple(at, n, m, tt, ib, ws, v, kcols);
    block_transpose(at, m, n, m, packed + b * mn, n);
    block_transpose(tt, n, n, n, t_out + b * nn, n);
  }
}

cudaError_t prepare(int m, int* blocks_per_sm) {
  const size_t smem = smem_bytes(m);
  cudaError_t e = cudaFuncSetAttribute(geqrt_batched_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess || blocks_per_sm == nullptr) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, geqrt_batched_kernel,
                                                       GEQRT_THREADS, smem);
}

// Cluster k of the grid factors matrix k (m x n, m >= n, kcols = n): its
// rows are one couple without R rows, read from a, factored into packed
// (the couple's home) and T; ws floats of workspace a cluster.
template <bool RES>
__global__ void __launch_bounds__(cl::CL_THREADS)
geqrt_cluster_kernel(const float* __restrict__ a, float* packed, float* t_out, float* work,
                     int m, int n, int ib, long long ws) {
  extern __shared__ __align__(16) float csm[];
  const long long k = blockIdx.x / cl::cg::this_cluster().num_blocks();
  const long long mn = (long long)m * n;
  const cl::Cta w = cl::carve<RES>(csm, work + k * ws, n, m, ib);
  cl::Couple cp;
  cp.nb = n;
  cp.r_rows = 0;
  cp.m = m;
  cp.r_src = nullptr;
  cp.r_home = nullptr;
  cp.b_src = a + k * mn;
  cp.ldb = n;
  cp.b_home = packed + k * mn;
  cp.t_out = t_out + k * n * (long long)n;
  cl::geqrt_couple_cluster<RES>(cp, w);
}

}  // namespace

// The cluster route: `batch` clusters of `ctas` CTAs, one a matrix (m >= n),
// with smem and resident from kernels/geqrt.py:batched_cluster_plan and
// tq_cluster_work_floats(n, m, ib, ctas, resident) floats of work a cluster.
extern "C" int tq_geqrt_batched_cluster(const float* a, float* packed, float* t, float* work,
                                        int batch, int m, int n, int ib, int ctas,
                                        long long smem, int resident, void* stream) {
  if (m < n || batch < 1 || !cl::smem_matches(n, m, ib, ctas, resident, smem))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ws = cl::ws_floats(n, m, ib, ctas, resident != 0);
  if (resident)
    return cl::launch_clusters(geqrt_cluster_kernel<true>, batch, ctas, (size_t)smem, st, a,
                               packed, t, work, m, n, ib, ws);
  return cl::launch_clusters(geqrt_cluster_kernel<false>, batch, ctas, (size_t)smem, st, a,
                             packed, t, work, m, n, ib, ws);
}

extern "C" int tq_geqrt_batched_work_floats(int m, int n, int ib) {
  return static_cast<int>(work_floats(m, n, ib));
}

// Blocks to launch: min(batch, blocks the card holds at once), or the
// negated CUDA error.
extern "C" int tq_geqrt_batched_grid(long long batch, int m) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = prepare(m, &per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * sms;
  return (int)(batch < cap ? batch : cap);
}

extern "C" int tq_geqrt_batched(const float* a, float* packed, float* t, float* work,
                                long long batch, int m, int n, int kcols, int ib, int grid,
                                void* stream) {
  const cudaError_t e = prepare(m, nullptr);
  if (e != cudaSuccess) return (int)e;
  geqrt_batched_kernel<<<grid, GEQRT_THREADS, smem_bytes(m), static_cast<cudaStream_t>(stream)>>>(
      a, packed, t, work, batch, m, n, kcols, ib);
  return (int)cudaGetLastError();
}
