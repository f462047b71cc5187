// Batched GEQRT, the tall route: the Householder QR of every matrix of a
// (B x m x n) stack, m >= n, whose narrow panels fit one CTA's shared
// memory, a persistent CTA walking the stack. kcols = n, inner block width
// ib; outputs packed (B x m x n: R on and above the diagonal, the
// reflectors below) and T (B x n x n, the T of all n reflectors). The
// input is read only.
//
// Replaces tileqr/drivers/tsqr.py:tall_geqrt (B10: the tsqr leaves, 512 x
// 2048 x 512 at 1048576 x 512, and the tree's level of 128 stacked R
// factors) and tileqr/drivers/batched.py:geqrt_batched on the other stacks
// that kernels/geqrt.py:batched_plan sends here (m >= n, past the small
// route's 200 KiB, more matrices than one cluster each would fit on the
// card: qr_batched's 4096 x 256^2). It takes over from geqrt_batched.cu's
// one-block kernel, which keeps the stacks this route cannot take (m < n,
// or a panel of 8 columns past shared memory).
//
// The function is B10's: LARFG with no rescaling (sgn = +1 when alpha >=
// 0, beta = -sgn ||x||, tau = (beta - alpha) / beta, v = x (1 / (alpha -
// beta)); with no tail tau = 0, beta = alpha), the n x n T of all the
// reflectors. T is unique given V and tau, so how its blocks are built
// changes only the rounding (kernels/geqrt.py:t_from_gram).
//
// What bounds it on the H100: fp32 FMA issue and the serial column loop. A
// 2048 x 512 leaf is ~0.98 GFLOP of QR and ~0.5 GFLOP of T, on one SM at
// a time; the one-block kernel ran its column loop and every block product
// through the global workspace (~0.5 GB of traffic a leaf, most of it past
// the 50 MB L2) with 64 x 64 tiles of scalar, branch-masked loads, at ~20
// GFLOP/s an SM. Here the products over tall rows at widths of 16 to 64
// (the updates and joins within a block) take the most time, then the
// trailing update, the joins and the column loops
// (utils/cluster_stages.py --only tall).
//
// The design (kernels/geqrt.py:tall_plan picks w, the shared bytes and
// the grid from the shapes and the SM count; tall_schedule lists the
// operations, the same for every matrix):
//   - The matrix is factored in place in `packed` (the input copied in
//     first, T zeroed), in row-major order, so nothing is transposed.
//   - Each ib-column block is factored recursively: its columns are split
//     at a panel boundary into halves, the left half factored, the right
//     half updated by it, the right half factored, and the two joined,
//     down to panels of w columns (8 or 16). The updates and joins
//     thus run at widths ib/2, ib/4, ..., w, so the register-tiled
//     product below runs on tiles that are mostly full.
//   - A panel (its rows [c0, m), w columns) is loaded into shared memory
//     column by column and factored there with one barrier a column: each
//     thread owns rows (tid + 256 i) of all w columns. In one pass over
//     its rows a thread applies column j's reflector and takes, for the
//     next column j + 1, the partial dots of every panel column with j + 1
//     as it stands (unscaled): its tail norm (LARFG), the dots the rank-1
//     update needs (y(j+1) + scale sum y x) and, left of it, G's column
//     (V^T v). Each warp sums its w partials with w - 1 + log2(32 / w)
//     shuffles and posts them; after the barrier every thread adds the 8
//     warps' and runs LARFG itself. Row j + 1's owner posts the row. The
//     panel goes back to global memory W / 4 lanes a row (whole sectors).
//   - T of a panel by the column recurrence (larft) on G, a row a thread;
//     every join T12 = -T1 (V1^T V2) T2, both within a block and of each
//     block to the blocks before it. No doubling.
//   - Every update and join is three calls of tile_gemm.cuh's f32_tile
//     (fp32 FMA on the CUDA cores, never TF32; a 3-stage cp.async ring;
//     its `unit` mask reads V in place): W = V1^T C, W2 = T1^T W, C -= V1
//     W2 and Z^T = V2^T V1 (stored transposed), M = Z T2, T12 = -T1 M, on
//     128 x 128 tiles where both sides pass 64, 128 x 64 down a narrow C,
//     64 x 64 otherwise. The two contractions over
//     rows (W and Z^T) run with KC = 256: partial sums over runs of 256
//     rows, then added in order, as geqrt.cuh's GEMM_KCHUNK bounds the
//     one-block kernel's.
//   - A persistent grid of min(B, SMs) CTAs, one an SM, walks the stack
//     with stride gridDim.x. The workspace (two ib x n buffers a CTA) is
//     bounded by the card. (Two leaves an SM, on 64 x 64 product tiles
//     at w = 8, ran the leaves and level 1 slower than one at w = 16 on
//     the H100: utils/plan_sweep.py --only tall.)
// Arithmetic: IEEE fp32 FMA, no atomics (reruns are bitwise equal); the
// sums run in other orders than the plain version's, which holds the
// kernel by tolerance.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

// the CTA's dynamic shared memory (the panel, or the products' cp.async
// ring), named in every routine so that its accesses compile to shared
// loads and stores
extern __shared__ __align__(16) float tall_sh[];

namespace {
namespace tall {

constexpr int NT = tg::F_THREADS;  // threads a CTA
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KCH = 256;  // rows a partial sum of a contraction over rows runs

// the operations of kernels/geqrt.py:tall_schedule, (kind, c0, h1, h2):
// PANEL factors columns [c0, c0 + h1); UPDATE/TRAIL apply the reflectors
// [c0, c0 + h1) to the columns [c0 + h1, c0 + h1 + h2) (within a block /
// the block's trailing columns); JOIN/JOIN_BLOCK set T[c0 : c0 + h1,
// c0 + h1 : c0 + h1 + h2] = -T1 (V1^T V2) T2 (within a block / a block
// against all the columns before it)
enum { OP_PANEL = 0, OP_UPDATE = 1, OP_TRAIL = 2, OP_JOIN = 3, OP_JOIN_BLOCK = 4 };

// shared floats of a panel of w columns: the panel (m x w, column-major),
// the partials [2][NW][w], the posted head rows [2][w], G and T_p (w x w
// each) and tau (w); kernels/geqrt.py:tall_smem_bytes mirrors it
__host__ __device__ inline long long panel_floats(int m, int w) {
  return (long long)m * w + 2 * NW * w + 2 * w + 2 * w * w + w;
}

// the products' largest cp.async ring (128 x 128 tiles)
constexpr size_t RING_BYTES = tg::f32_smem<128, 128, true>() > tg::f32_smem<128, 128, false>()
                                  ? tg::f32_smem<128, 128, true>()
                                  : tg::f32_smem<128, 128, false>();

__host__ __device__ inline long long smem_bytes(int m, int w) {
  const long long p = (long long)sizeof(float) * panel_floats(m, w);
  return p > (long long)RING_BYTES ? p : (long long)RING_BYTES;
}

// Stage timer, compiled only with TQ_CL_STAGES (utils/cluster_stages.py):
// thread 0 of CTA 0 adds each stage's globaltimer nanoseconds to
// tall_stage_ns: 0 the copy-in and the panels' loads, 1 the panels'
// stores, 2 the inner T (larft and the joins within a block), 3 the
// updates within a block, 4 the trailing updates, 5 the off-diagonal T of
// each block against the ones before it; the column loops in three: 6 the
// warps' sums and LARFG, 7 the pass over the rows, 8 the warp sums and
// the barrier
constexpr int TALL_STAGES = 9;
#ifdef TQ_CL_STAGES
__device__ unsigned long long tall_stage_ns[TALL_STAGES];
__shared__ unsigned long long tall_mark;
#define TL_STAGE(i)                                                  \
  do {                                                               \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                       \
      unsigned long long t_;                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
      if ((i) >= 0) tall_stage_ns[(i) < 0 ? 0 : (i)] += t_ - tall_mark; \
      tall_mark = t_;                                                \
    }                                                                \
  } while (0)
#else
#define TL_STAGE(i) \
  do {              \
  } while (0)
#endif

// One halving exchange of warp_sums: lanes with bit O set keep the upper
// half of the CNT values left, the others the lower, each adding its
// partner's; then the next, at O / 2. Recursion on constants, so x stays
// in registers.
template <int CNT, int O, int W>
__device__ __forceinline__ void halve(float (&x)[W], int lane) {
  if constexpr (CNT > 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int q = 0; q < CNT / 2; ++q) {
      const float send = upper ? x[q] : x[q + CNT / 2];
      const float keep = upper ? x[q + CNT / 2] : x[q];
      x[q] = keep + __shfl_xor_sync(FULL, send, O);
    }
    halve<CNT / 2, O / 2, W>(x, lane);
  }
}

// Sum each of the W values x[0..W) over the warp (W a power of two <= 32):
// halving exchanges, then a butterfly over the lanes left. Returns, in
// lane l, the sum of value l / (32 / W).
template <int W>
__device__ __forceinline__ float warp_sums(float (&x)[W]) {
  halve<W, 16, W>(x, threadIdx.x & 31);
  float v = x[0];
#pragma unroll
  for (int o = 16 / W; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the warp's partials of the panel's W values into red[warp][0..W)
template <int W>
__device__ __forceinline__ void post_partials(float (&part)[W], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float v = warp_sums<W>(part);
  if (lane % (32 / W) == 0) red[warp * W + lane / (32 / W)] = v;
}

// Factor the panel of columns [c0, c0 + wp), wp <= W, rows [c0, m), of the
// matrix P (row stride n) in shared memory; its T into T (row stride n,
// zero on entry) at (c0, c0). Columns right of the panel are not touched.
template <int W>
__device__ __forceinline__ void panel(float* P, float* T, int m, int n, int c0, int wp, bool vec) {
  const int tid = threadIdx.x;
  const int mp = m - c0;  // the panel's rows; row r of the panel is row c0 + r
  float* pan = tall_sh;   // column c at pan + c * mp
  float* red = tall_sh + (long long)W * m;  // [2][NW][W]
  float* head = red + 2 * NW * W;      // [2][W]
  float* g = head + 2 * W;             // G(l, j) at g[l * W + j], l < j
  float* tp = g + W * W;               // T_p(i, j) at tp[i * W + j]
  float* tau = tp + W * W;

  // load, and the partials of column 0: dots of every column with its tail
  float part[W];
#pragma unroll
  for (int c = 0; c < W; ++c) part[c] = 0.f;
  for (int r = tid; r < mp; r += NT) {
    const float* src = P + (long long)(c0 + r) * n + c0;
    float row[W];
    if (vec) {
#pragma unroll
      for (int c = 0; c < W; c += 4) {
        if (c < wp) {
          const float4 v = *reinterpret_cast<const float4*>(src + c);
          row[c] = v.x, row[c + 1] = v.y, row[c + 2] = v.z, row[c + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < wp) row[c] = src[c];
    }
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c < wp) pan[c * mp + r] = row[c];
    if (r > 0) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < wp) part[c] = fmaf(row[c], row[0], part[c]);
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) head[c] = c < wp ? row[c] : 0.f;
    }
  }
  post_partials<W>(part, red);
  __syncthreads();
  TL_STAGE(0);

  for (int jj = 0; jj < wp; ++jj) {
    const int cur = jj & 1, nxt = cur ^ 1;
    // the column's sums over the warps, then its LARFG, by every thread
    float ps[W], hd[W];
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      float4 s = *reinterpret_cast<const float4*>(red + cur * NW * W + c);
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        const float4 t = *reinterpret_cast<const float4*>(red + (cur * NW + w) * W + c);
        s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
      }
      const float4 h = *reinterpret_cast<const float4*>(head + cur * W + c);
      ps[c] = s.x, ps[c + 1] = s.y, ps[c + 2] = s.z, ps[c + 3] = s.w;
      hd[c] = h.x, hd[c + 1] = h.y, hd[c + 2] = h.z, hd[c + 3] = h.w;
    }
    float alpha = 0.f, tailsq = 0.f;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c == jj) alpha = hd[c], tailsq = ps[c];
    const float sgn = alpha >= 0.f ? 1.f : -1.f;
    const float nrm = sqrtf(alpha * alpha + tailsq);
    const bool has_tail = tailsq > 0.f;
    const float beta = has_tail ? -sgn * nrm : alpha;
    const float tj = has_tail ? (beta - alpha) / beta : 0.f;
    const float scale = has_tail ? 1.f / (alpha - beta) : 0.f;
    // v^T y for every column: y(j) + scale sum_{r > j} y(r) x(r); right of j
    // the update's tau v^T y, left of j G's entry V(:, c)^T v
    float tw[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const float d = fmaf(scale, ps[c], hd[c]);
      tw[c] = c > jj && c < wp ? tj * d : 0.f;
      if (tid == 0 && c < jj) g[c * W + jj] = d;
    }
    if (tid == 0) tau[jj] = tj;
    TL_STAGE(6);

    // apply to the own rows below the column's head, and take the next
    // column's partials (its updated column x against every column as
    // updated) and, on row j + 1, its head. Columns left of j are read
    // only, column j is scaled into v.
    const bool more = jj + 1 < wp;
    float twn = 0.f;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      part[c] = 0.f;
      if (c == jj + 1) twn = tw[c];
    }
    for (int r = tid + (jj / NT) * NT; r < mp; r += NT) {
      if (r < jj) continue;
      if (r == jj) {  // v(j) = 1: beta on the diagonal, y(j) - tau v^T y right of it
#pragma unroll
        for (int c = 0; c < W; ++c) {
          if (c == jj) pan[c * mp + r] = beta;
          else if (c > jj && c < wp) pan[c * mp + r] -= tw[c];
        }
        continue;
      }
      // the row, all of it before any store (the compiler cannot tell the
      // columns' addresses apart, so a store would hold back later loads)
      float y[W];
#pragma unroll
      for (int c = 0; c < W; ++c) y[c] = c < wp ? pan[c * mp + r] : 0.f;
      float v = 0.f, xo = 0.f;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (c == jj) v = y[c] * scale;
        if (c == jj + 1) xo = y[c];
      }
      const float xn = more && r > jj + 1 ? fmaf(-twn, v, xo) : 0.f;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (c >= jj) y[c] = c == jj ? v : fmaf(-tw[c], v, y[c]);
        part[c] = fmaf(y[c], xn, part[c]);
      }
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c >= jj && c < wp) pan[c * mp + r] = y[c];
      if (more && r == jj + 1) {
#pragma unroll
        for (int c = 0; c < W; ++c) head[nxt * W + c] = y[c];
      }
    }
    TL_STAGE(7);
    if (more) post_partials<W>(part, red + nxt * NW * W);
    __syncthreads();
    TL_STAGE(8);
  }

  // store the panel (R and V) back: with 16-byte copies W / 4 lanes a row,
  // so a warp writes whole rows (full 32-byte sectors); then T_p by rows, a
  // thread a row: T(i, j) = -tau_j sum_{l = i}^{j - 1} T(i, l) G(l, j)
  if (vec) {
    constexpr int LPR = W / 4;  // lanes a row
    const int c = (tid % LPR) * 4;
    if (c < wp) {
      for (int r = tid / LPR; r < mp; r += NT / LPR)
        *reinterpret_cast<float4*>(P + (long long)(c0 + r) * n + c0 + c) =
            make_float4(pan[c * mp + r], pan[(c + 1) * mp + r], pan[(c + 2) * mp + r],
                        pan[(c + 3) * mp + r]);
    }
  } else {
    for (int r = tid; r < mp; r += NT) {
      float* dst = P + (long long)(c0 + r) * n + c0;
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < wp) dst[c] = pan[c * mp + r];
    }
  }
  TL_STAGE(1);
  if (tid < wp) {
    const int i = tid;
    float* ti = tp + i * W;
    ti[i] = tau[i];
    for (int j = i + 1; j < wp; ++j) {
      float s = 0.f;
      for (int l = i; l < j; ++l) s = fmaf(ti[l], g[l * W + j], s);
      ti[j] = -tau[j] * s;
    }
    for (int j = i; j < wp; ++j) T[(long long)(c0 + i) * n + c0 + j] = ti[j];
  }
  __syncthreads();
  TL_STAGE(2);
}

// The epilogues beside tile_gemm.cuh's Store and Sub
struct StoreT {  // p(j, i) = d: the transpose of D
  float* p;
  long long ld;
  __device__ __forceinline__ float pre(int, int) const { return 0.f; }
  __device__ __forceinline__ void operator()(int i, int j, float d, float) const {
    p[(long long)j * ld + i] = d;
  }
};
struct NegStore {  // p(i, j) = -d
  float* p;
  long long ld;
  __device__ __forceinline__ float pre(int, int) const { return 0.f; }
  __device__ __forceinline__ void operator()(int i, int j, float d, float) const {
    p[(long long)i * ld + j] = -d;
  }
};

// D (M x N) = A (M x K) B (K x N) through epi, tile by tile: 128 x 128
// tiles where both M and N pass 64; with TALL, 128 x 64 where only M does
// (fewer tiles down a tall C, each a pipeline's fill and drain); else
// 64 x 64
template <bool A_KMAJ, int KC, bool TALL = false, class Epi>
__device__ __forceinline__ void gemm(tg::Opnd A, tg::Opnd B, int M, int N, int K, bool vec,
                                     bool unit, Epi epi) {
  if (M > 64 && N > 64) {
    for (int i0 = 0; i0 < M; i0 += 128)
      for (int j0 = 0; j0 < N; j0 += 128)
        tg::f32_tile<128, 128, A_KMAJ, KC>(tall_sh, A, B, M, N, 0, K, i0, j0, vec, unit, epi);
    return;
  }
  if constexpr (TALL) {
    if (M > 64) {
      for (int i0 = 0; i0 < M; i0 += 128)
        for (int j0 = 0; j0 < N; j0 += 64)
          tg::f32_tile<128, 64, A_KMAJ, KC>(tall_sh, A, B, M, N, 0, K, i0, j0, vec, unit, epi);
      return;
    }
  }
  for (int i0 = 0; i0 < M; i0 += 64)
    for (int j0 = 0; j0 < N; j0 += 64)
      tg::f32_tile<64, 64, A_KMAJ, KC>(tall_sh, A, B, M, N, 0, K, i0, j0, vec, unit, epi);
}

// C = columns [c1, c1 + h2) of P, rows [c0, m), c1 = c0 + h1:
// C -= V1 T1^T V1^T C, V1 the reflectors [c0, c1), T1 = T[c0:c1, c0:c1].
// ws: two buffers of h1 x h2 (row stride n).
__device__ __noinline__ void update(float* P, const float* T, float* ws, int m, int n,
                                    int ibm, int c0, int h1, int h2, bool vec) {
  const int c1 = c0 + h1, rows = m - c0;
  float* w1 = ws;
  float* w2 = ws + (long long)ibm * n;
  const tg::Opnd v1{P + (long long)c0 * n + c0, n};
  gemm<false, KCH>(v1, {P + (long long)c0 * n + c1, n}, h1, h2, rows, vec, true,
                        tg::Store{w1, n});
  gemm<false, 0>({T + (long long)c0 * n + c0, n}, {w1, n}, h1, h2, h1, vec, false,
                 tg::Store{w2, n});
  gemm<true, 0, true>(v1, {w2, n}, rows, h2, h1, vec, true,
                      tg::Sub{P + (long long)c0 * n + c1, n});
}

// T[c0:c1, c1:c1 + h2] = -T1 (V1^T V2) T2, c1 = c0 + h1, V1 the
// reflectors [c0, c1), V2 [c1, c1 + h2) (V1^T V2 over rows [c1, m), where
// V2 lives). ws: two buffers of h1 x h2 (row stride ibm).
__device__ __noinline__ void join(const float* P, float* T, float* ws, int m, int n,
                                  int ibm, int c0, int h1, int h2, bool vec) {
  const int c1 = c0 + h1, rows = m - c1;
  float* z = ws;
  float* mz = ws + (long long)ibm * n;
  const float* v2 = P + (long long)c1 * n + c1;
  const float* v1 = P + (long long)c1 * n + c0;
  gemm<false, KCH>({v2, n}, {v1, n}, h2, h1, rows, vec, true, StoreT{z, ibm});
  gemm<true, 0>({z, ibm}, {T + (long long)c1 * n + c1, n}, h1, h2, h2, vec, false,
                tg::Store{mz, ibm});
  gemm<true, 0>({T + (long long)c0 * n + c0, n}, {mz, ibm}, h1, h2, h1, vec, false,
                NegStore{T + (long long)c0 * n + c1, n});
}

template <int W>
__global__ void __launch_bounds__(NT, 1)
geqrt_tall_kernel(const float* __restrict__ a, float* packed, float* t_out, float* work,
                  const int4* __restrict__ ops, int nops, long long batch, int m, int n, int ibm,
                  int vec) {
  const long long mn = (long long)m * n, nn = (long long)n * n;
  float* ws = work + blockIdx.x * 2LL * ibm * n;
#ifdef TQ_CL_STAGES
  if (blockIdx.x == 0 && threadIdx.x == 0) tall_mark = 0;
#endif
  for (long long b = blockIdx.x; b < batch; b += gridDim.x) {
    TL_STAGE(-1);
    float* P = packed + b * mn;
    float* T = t_out + b * nn;
    const float* src = a + b * mn;
    if (vec) {
      for (long long i = 4 * threadIdx.x; i < mn; i += 4 * NT)
        *reinterpret_cast<float4*>(P + i) = *reinterpret_cast<const float4*>(src + i);
    } else {
      for (long long i = threadIdx.x; i < mn; i += NT) P[i] = src[i];
    }
    for (long long i = threadIdx.x; i < nn; i += NT) T[i] = 0.f;
    __syncthreads();
    TL_STAGE(0);
    for (int o = 0; o < nops; ++o) {
      const int4 op = ops[o];
      switch (op.x) {
        case OP_PANEL:
          panel<W>(P, T, m, n, op.y, op.z, vec);
          break;
        case OP_UPDATE:
        case OP_TRAIL:
          update(P, T, ws, m, n, ibm, op.y, op.z, op.w, vec);
          TL_STAGE(op.x == OP_UPDATE ? 3 : 4);
          break;
        default:
          join(P, T, ws, m, n, ibm, op.y, op.z, op.w, vec);
          TL_STAGE(op.x == OP_JOIN ? 2 : 5);
          break;
      }
    }
    __syncthreads();
  }
}

template <int W>
cudaError_t prepare(long long smem) {
  return cudaFuncSetAttribute(geqrt_tall_kernel<W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int W>
int launch(const float* a, float* packed, float* t, float* work, const int4* ops, int nops,
           long long batch, int m, int n, int ibm, int vec, int grid, long long smem,
           cudaStream_t st) {
  const cudaError_t e = prepare<W>(smem);
  if (e != cudaSuccess) return (int)e;
  geqrt_tall_kernel<W><<<grid, NT, smem, st>>>(a, packed, t, work, ops, nops, batch, m, n, ibm,
                                               vec);
  return (int)cudaGetLastError();
}

template <int W>
int per_sm(long long smem) {
  cudaError_t e = prepare<W>(smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, geqrt_tall_kernel<W>, NT, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace tall
}  // namespace

// The tall route: `grid` persistent CTAs of 256 threads walk the stack,
// each with smem = kernels/geqrt.py:tall_smem_bytes(m, w) bytes of shared
// memory and 2 ibm n floats of `work` (ibm = min(ib, n)); ops: the nops
// (kind, c0, h1, h2) of kernels/geqrt.py:tall_schedule, on the device;
// w 8 or 16; vec: m, n, ib and w multiples of 4 (16-byte copies). A
// launch whose bytes disagree with the layout is refused.
extern "C" int tq_geqrt_tall(const float* a, float* packed, float* t, float* work, const int* ops,
                             int nops, long long batch, int m, int n, int ibm, int w, int vec,
                             int grid, long long smem, void* stream) {
  if (batch < 1 || m < n || n < 1 || ibm < 1 || nops < 1 || grid < 1 ||
      smem != tall::smem_bytes(m, w))
    return (int)cudaErrorInvalidValue;
  const int4* o = reinterpret_cast<const int4*>(ops);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TQ_TALL(W) tall::launch<W>(a, packed, t, work, o, nops, batch, m, n, ibm, vec, grid, smem, st)
  if (w == 8) return TQ_TALL(8);
  if (w == 16) return TQ_TALL(16);
#undef TQ_TALL
  return (int)cudaErrorInvalidValue;
}

// CTAs an SM holds at once on the tall route at panel width w, or the
// negated CUDA error (utils/plan_sweep.py prints it)
extern "C" int tq_geqrt_tall_per_sm(int m, int w) {
  const long long smem = tall::smem_bytes(m, w);
  if (w == 8) return tall::per_sm<8>(smem);
  if (w == 16) return tall::per_sm<16>(smem);
  return -(int)cudaErrorInvalidValue;
}

#ifdef TQ_CL_STAGES
// copy the tall route's stage nanoseconds (6 values) to `out` and zero them
extern "C" int tq_tall_stages(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, tall::tall_stage_ns, sizeof(tall::tall_stage_ns));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[tall::TALL_STAGES] = {};
  return (int)cudaMemcpyToSymbol(tall::tall_stage_ns, zero, sizeof(zero));
}
#endif
