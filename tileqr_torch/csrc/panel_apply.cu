// B6: in-place windowed whole-panel apply, the hr driver's trailing update
//   C <- C - Y (op(T) (Y^T C)),   C = carry[s:, s+nb:] (m x n, row stride ldc),
// Y (m x nb) contiguous, tm = op(T) (nb x nb) contiguous.
//
// Replaces tileqr/kernels/panel_apply.py:panel_apply_carry (its two
// pallas_calls). The TPU ran phase 1 as a grid whose row-block dimension is
// sequential, carrying the W accumulator and its Kahan compensation in VMEM
// scratch; CUDA blocks run in no order. Here:
//   phase 1 (project_kernel): each block owns a column slab of W (nb x 32)
//     and loops over the row blocks of mr rows IN ORDER. A row block's
//     partial Y_i^T C_i is summed in registers (fp32 FMA), then added to the
//     running W with Kahan compensation, as _kahan_add does. After the last
//     row block the slab is multiplied by op(T), read in 16-column tiles.
//     No atomics: a rerun is bitwise equal.
//   phase 2 (apply_kernel): a register-tiled SIMT GEMM, 64 x 64 C tiles,
//     C -= Y W written in place through ldc.
// The launch order on one stream is the barrier between the phases.
//
// What bounds it on the H100: fp32 operations. It does 4 m nb n flops for
// 2 m n * 4 bytes of C traffic (read and written once at the bound), about
// 128 flops per byte at nb = 256, above the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20. At 16384^2 its 63 launches do (4/3) n^3 ~
// 5.9 TFLOP: ~88 ms at the fp32 CUDA-core peak. The design does about that
// only what a simple kernel can: register tiles (phase 1: 8 x 4 W entries a
// thread at nb = 256, with their Kahan state; phase 2: 4 x 4 C entries a
// thread), operands staged through shared memory 16 deep. Arithmetic is
// IEEE fp32 on CUDA cores ("highest", never TF32), and the library is built
// without fast math, so the Kahan (t - acc) - y is kept as written. Few
// blocks on the narrow late panels (n = 256 at k = 62 gives 8 slabs) are
// accepted.
//
// The same two phases are B7, tileqr/kernels/panel_apply.py:panel_apply
// (its pallas_calls at :112 and :133): C <- (I - Y T Y^T)^{T?} C on any
// strided (m x n) view, in place through its leading dimension, with row
// blocks of mr = _block(m, nb, 1024) rows. So the phases are two C entries:
// tq_panel_project (W = op(T) sum_i Y_i^T C_i, or the bare sum with no T,
// as panel_project) and tq_panel_sub (C -= Y W, as panel_sub); B6 and B7
// call both. Alone they are B7's halves, tileqr/kernels/panel_apply.py:307
// (_panel_project_call, the bare sum with mr = _block(m, nb, 512)) and :349
// (_panel_sub_call), which the sharded hr driver launches with the sum of W
// over the mesh rows between them (kernels/panel_apply.py panel_project,
// panel_sub). Each takes `passes`, the precision: 0 ("highest") is the code
// above. 1, 3, 4 ("default", "b3"/"high", "b4") compute Y_i^T C_i and Y W
// with the split tensor-core product (bx_mma.cuh): phase 1 keeps one W
// slab and its Kahan compensation in shared memory (2 x 32 KiB at
// nb = 256), takes each row block's emulated partial through the same
// Kahan add, and folds op(T) in with fp32 FMA, as tileqr pins that small
// product "highest" (panel_apply.py:73-79); phase 2 updates 128 x 32 C
// tiles. The split instantiations take any nb up to BX_MAX_NB and any n
// (a column slab past n reads zeros and writes nothing), so B7 takes every
// nb-aligned target tileqr's panel_apply takes, up to the W slab and its
// compensation filling shared memory (2 x 96 KiB at nb = 768). Their bound
// is P passes of 4 m nb n flops at the dense bf16 tensor-core rate (989
// TFLOP/s), about a third of the fp32 one at P = 3, or C's bytes; this
// first version reaches neither (PERF.md).
#include "bx_mma.cuh"

namespace {

constexpr int PA_THREADS = 256;
constexpr int NC = 32;  // W columns per phase-1 block
constexpr int KT = 16;  // rows of Y/C staged per step

// Phase 1. nb = 32 * RPT; thread (ty, tx) = (tid / 8, tid % 8) owns W rows
// ty*RPT .. +RPT and slab columns tx*4 .. +4.
template <int RPT>
__global__ void __launch_bounds__(PA_THREADS, 1)
project_kernel(const float* __restrict__ y, const float* __restrict__ tm,
               const float* __restrict__ c, long long ldc, int m, int n, int mr,
               float* __restrict__ w) {
  constexpr int NB = 32 * RPT;
  extern __shared__ __align__(16) float sm[];
  float* ys = sm;             // KT x NB
  float* cs = ys + KT * NB;   // KT x NC
  float* ws = cs + KT * NC;   // NB x NC
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int col0 = blockIdx.x * NC;

  float acc[RPT][4], comp[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = comp[r][q] = 0.f;

  for (int rb = 0; rb < m; rb += mr) {
    float part[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[r][q] = 0.f;
    for (int k0 = rb; k0 < rb + mr; k0 += KT) {
      const float* ysrc = y + (long long)k0 * NB;
      for (int idx = tid; idx < KT * NB; idx += PA_THREADS) ys[idx] = ysrc[idx];
      for (int idx = tid; idx < KT * NC; idx += PA_THREADS) {
        const int kk = idx / NC, cc = idx % NC;
        cs[idx] = c[(long long)(k0 + kk) * ldc + col0 + cc];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(cs + kk * NC + tx * 4);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float a = ys[kk * NB + ty * RPT + r];
          part[r][0] = fmaf(a, b.x, part[r][0]);
          part[r][1] = fmaf(a, b.y, part[r][1]);
          part[r][2] = fmaf(a, b.z, part[r][2]);
          part[r][3] = fmaf(a, b.w, part[r][3]);
        }
      }
      __syncthreads();
    }
    // Kahan: acc += part across row blocks (tileqr's _kahan_add)
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float yk = part[r][q] - comp[r][q];
        const float t = acc[r][q] + yk;
        comp[r][q] = (t - acc[r][q]) - yk;
        acc[r][q] = t;
      }
  }

  if (tm == nullptr) {  // panel_project: the bare sum
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      *reinterpret_cast<float4*>(w + (long long)(ty * RPT + r) * n + col0 + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    return;
  }
  // fold op(T) in: W_slab = tm (NB x NB) acc (NB x NC)
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) ws[(ty * RPT + r) * NC + tx * 4 + q] = acc[r][q];
  float out[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[r][q] = 0.f;
  for (int k0 = 0; k0 < NB; k0 += KT) {
    __syncthreads();
    // ys[kk][i] = tm[i][k0 + kk]
    for (int idx = tid; idx < KT * NB; idx += PA_THREADS) {
      const int i = idx / KT, kk = idx % KT;
      ys[kk * NB + i] = tm[(long long)i * NB + k0 + kk];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(ws + (k0 + kk) * NC + tx * 4);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float a = ys[kk * NB + ty * RPT + r];
        out[r][0] = fmaf(a, b.x, out[r][0]);
        out[r][1] = fmaf(a, b.y, out[r][1]);
        out[r][2] = fmaf(a, b.z, out[r][2]);
        out[r][3] = fmaf(a, b.w, out[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    *reinterpret_cast<float4*>(w + (long long)(ty * RPT + r) * n + col0 + tx * 4) =
        make_float4(out[r][0], out[r][1], out[r][2], out[r][3]);
}

constexpr int BM = 64, BN = 64, BK = 16;

// Phase 2: C (m x n) -= Y (m x nb) W (nb x n). Block (x, y) = (row tile,
// column tile); thread (ty, tx) = (tid / 16, tid % 16) owns a 4 x 4 tile.
__global__ void __launch_bounds__(PA_THREADS)
apply_kernel(const float* __restrict__ y, const float* __restrict__ w, float* c,
             long long ldc, int m, int n, int nb) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nb; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / PA_THREADS; ++q) {
      const int idx = tid + q * PA_THREADS;
      const int r = idx / BK, kk = idx % BK;
      as[kk][r] = (row0 + r < m) ? y[(long long)(row0 + r) * nb + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / PA_THREADS; ++q) {
      const int idx = tid + q * PA_THREADS;
      const int kk = idx / BN, cc = idx % BN;
      bs[kk][cc] = (col0 + cc < n) ? w[(long long)(k0 + kk) * n + col0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx * 4 + j;
      if (cc < n) {
        float* x = c + (long long)r * ldc + cc;
        *x = *x - acc[i][j];
      }
    }
  }
}

// Phase 1 at P passes of the split product: block = one 32-column slab of
// W, walking the row blocks in order with Kahan compensation in shared
// memory; then op(T) folded in with fp32 FMA (or the bare sum when tm is
// null). RAGGED (n not a multiple of 32) guards the columns past n; it is
// a template flag so that the common case keeps its staging loops free of
// the test (compiled into every launch, it made B6 in "default" 40% slower
// at 16384^2: PERF.md).
template <int P, bool RAGGED>
__global__ void __launch_bounds__(bx::BX_THREADS)
project_bx_kernel(const float* __restrict__ y, const float* __restrict__ tm,
                  const float* __restrict__ c, long long ldc, int m, int n, int nb, int mr,
                  float* __restrict__ w) {
  extern __shared__ __align__(128) float smb[];
  float* acc = smb;                 // nb x NC
  float* comp = acc + nb * bx::NC;  // nb x NC
  const bx::Smem S = bx::carve(comp + nb * bx::NC);
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * bx::NC;
  for (int idx = tid; idx < nb * bx::NC; idx += bx::BX_THREADS) acc[idx] = comp[idx] = 0.f;
  for (int rb = 0; rb < m; rb += mr) {
    bx::gemm32<P, false>(
        S, nb, mr, [&](int i, int k) { return y[(long long)(rb + k) * nb + i]; },
        [&](int k, int cc) {
          return !RAGGED || col0 + cc < n ? c[(long long)(rb + k) * ldc + col0 + cc] : 0.f;
        },
        [&](int i, int cc, float v) {  // Kahan: acc += v (tileqr's _kahan_add)
          const int o = i * bx::NC + cc;
          const float yk = v - comp[o];
          const float t = acc[o] + yk;
          comp[o] = (t - acc[o]) - yk;
          acc[o] = t;
        });
  }
  for (int idx = tid; idx < nb * bx::NC; idx += bx::BX_THREADS) {
    const int i = idx / bx::NC, cc = idx % bx::NC;
    if (RAGGED && col0 + cc >= n) continue;
    float v = acc[idx];
    if (tm != nullptr) {
      v = 0.f;
      for (int k = 0; k < nb; ++k) v = fmaf(tm[(long long)i * nb + k], acc[k * bx::NC + cc], v);
    }
    w[(long long)i * n + col0 + cc] = v;
  }
}

// Phase 2 at P passes: block (x, y) updates C rows 128x .. +128, columns
// 32y .. +32 (those below n when RAGGED): C -= Y W.
template <int P, bool RAGGED>
__global__ void __launch_bounds__(bx::BX_THREADS)
sub_bx_kernel(const float* __restrict__ y, const float* __restrict__ w, float* c,
              long long ldc, int m, int n, int nb) {
  extern __shared__ __align__(128) float smb[];
  const bx::Smem S = bx::carve(smb);
  const long long r0 = (long long)blockIdx.x * bx::MT;
  const int col0 = blockIdx.y * bx::NC;
  const int rows = min((long long)bx::MT, m - r0);
  bx::gemm32<P, true>(
      S, rows, nb, [&](int i, int k) { return y[(r0 + i) * nb + k]; },
      [&](int k, int cc) {
        return !RAGGED || col0 + cc < n ? w[(long long)k * n + col0 + cc] : 0.f;
      },
      [&](int i, int cc, float v) {
        if (RAGGED && col0 + cc >= n) return;
        float* x = c + (r0 + i) * ldc + col0 + cc;
        *x = *x - v;
      });
}

template <int RPT>
int launch_project(const float* y, const float* tm, const float* c, long long ldc, int m,
                   int n, int mr, float* w, cudaStream_t stream) {
  constexpr int NB = 32 * RPT;
  const size_t smem = sizeof(float) * ((size_t)KT * NB + KT * NC + (size_t)NB * NC);
  cudaError_t e = cudaFuncSetAttribute(
      project_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  project_kernel<RPT><<<n / NC, PA_THREADS, smem, stream>>>(y, tm, c, ldc, m, n, mr, w);
  return (int)cudaGetLastError();
}

// the widest panel the split instantiations take: W's slab and its
// compensation, 2 x nb x 32 floats, with gemm32's staging in 227 KiB
constexpr int BX_MAX_NB = 768;

template <int P, bool RAGGED>
int launch_project_bx(const float* y, const float* tm, const float* c, long long ldc, int m,
                      int n, int nb, int mr, float* w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)nb * bx::NC + bx::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      project_bx_kernel<P, RAGGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int slabs = (n + bx::NC - 1) / bx::NC;
  project_bx_kernel<P, RAGGED><<<slabs, bx::BX_THREADS, smem, stream>>>(y, tm, c, ldc, m, n, nb,
                                                                        mr, w);
  return (int)cudaGetLastError();
}

template <int P>
int launch_project_bx(const float* y, const float* tm, const float* c, long long ldc, int m,
                      int n, int nb, int mr, float* w, cudaStream_t stream) {
  if (nb > BX_MAX_NB) return (int)cudaErrorInvalidValue;
  if (n % bx::NC) return launch_project_bx<P, true>(y, tm, c, ldc, m, n, nb, mr, w, stream);
  return launch_project_bx<P, false>(y, tm, c, ldc, m, n, nb, mr, w, stream);
}

template <int P>
int launch_sub_bx(const float* y, const float* w, float* c, long long ldc, int m, int n,
                  int nb, cudaStream_t stream) {
  const dim3 grid((m + bx::MT - 1) / bx::MT, (n + bx::NC - 1) / bx::NC);
  if (n % bx::NC)
    sub_bx_kernel<P, true><<<grid, bx::BX_THREADS, bx::SMEM_BYTES, stream>>>(y, w, c, ldc, m, n,
                                                                            nb);
  else
    sub_bx_kernel<P, false><<<grid, bx::BX_THREADS, bx::SMEM_BYTES, stream>>>(y, w, c, ldc, m, n,
                                                                             nb);
  return (int)cudaGetLastError();
}

}  // namespace

// Phase 1: w (nb x n) = op(T) sum_i Y_i^T C_i over row blocks of mr rows
// (tm = op(T), contiguous), or the bare sum when tm is null. C is (m x n)
// with row stride ldc; m a multiple of mr. passes: 0 ("highest"; nb a
// multiple of 32, <= 256, mr of 16, n of 32), 1 ("default"), 3
// ("b3"/"high"), 4 ("b4") (any nb <= BX_MAX_NB, any n).
extern "C" int tq_panel_project(const float* y, const float* tm, const float* c,
                                long long ldc, int m, int n, int nb, int mr, float* w,
                                int passes, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (passes) {
    case 0: break;
    case 1: return launch_project_bx<1>(y, tm, c, ldc, m, n, nb, mr, w, stream);
    case 3: return launch_project_bx<3>(y, tm, c, ldc, m, n, nb, mr, w, stream);
    case 4: return launch_project_bx<4>(y, tm, c, ldc, m, n, nb, mr, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
  switch (nb / 32) {
    case 1: return launch_project<1>(y, tm, c, ldc, m, n, mr, w, stream);
    case 2: return launch_project<2>(y, tm, c, ldc, m, n, mr, w, stream);
    case 3: return launch_project<3>(y, tm, c, ldc, m, n, mr, w, stream);
    case 4: return launch_project<4>(y, tm, c, ldc, m, n, mr, w, stream);
    case 5: return launch_project<5>(y, tm, c, ldc, m, n, mr, w, stream);
    case 6: return launch_project<6>(y, tm, c, ldc, m, n, mr, w, stream);
    case 7: return launch_project<7>(y, tm, c, ldc, m, n, mr, w, stream);
    case 8: return launch_project<8>(y, tm, c, ldc, m, n, mr, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Phase 2: C (m x n, row stride ldc) -= Y (m x nb) W (nb x n), in place.
extern "C" int tq_panel_sub(const float* y, const float* w, float* c, long long ldc, int m,
                            int n, int nb, int passes, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (passes) {
    case 0: {
      const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
      apply_kernel<<<grid, PA_THREADS, 0, stream>>>(y, w, c, ldc, m, n, nb);
      return (int)cudaGetLastError();
    }
    case 1: return launch_sub_bx<1>(y, w, c, ldc, m, n, nb, stream);
    case 3: return launch_sub_bx<3>(y, w, c, ldc, m, n, nb, stream);
    case 4: return launch_sub_bx<4>(y, w, c, ldc, m, n, nb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
