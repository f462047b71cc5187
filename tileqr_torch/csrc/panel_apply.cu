// B6: in-place windowed whole-panel apply, the hr driver's trailing update
//   C <- C - Y (op(T) (Y^T C)),   C = carry[s:, s+nb:] (m x n, row stride ldc),
// Y (m x nb) contiguous, tm = op(T) (nb x nb) contiguous.
//
// Replaces tileqr/kernels/panel_apply.py:panel_apply_carry (its two
// pallas_calls, :227 and :254). The TPU ran phase 1 as a grid whose
// row-block dimension is sequential, carrying the W accumulator and its
// Kahan compensation in VMEM scratch; CUDA blocks run in no order. The same
// two phases are B7, tileqr/kernels/panel_apply.py:panel_apply (:112 and
// :133), C <- (I - Y T Y^T)^{T?} C on any strided (m x n) view with row
// blocks of mr = _block(m, nb, 1024), and B7's halves, :307
// (_panel_project_call, the bare sum with mr = _block(m, nb, 512)) and :349
// (_panel_sub_call), which the sharded hr driver launches with the sum of W
// over the mesh rows between them. So the phases are two C entries:
// tq_panel_project (W = op(T) sum_i Y_i^T C_i, or the bare sum with no T)
// and tq_panel_sub (C -= Y W). Each takes `passes`, the precision: 0
// ("highest", IEEE fp32 FMA on the CUDA cores, never TF32) or 1, 3, 4
// ("default", "b3"/"high", "b4": the split bf16 product of
// tileqr/kernels/common.py:_dot_bx on the tensor cores).
//
// Phase 1, the projection (tq_panel_project), is a GEMM W = Y^T C whose
// contraction runs over the tall dimension m, summed in row blocks of mr
// rows with tileqr's Kahan compensation (_kahan_add) across the blocks.
// What bounds it on the H100: its operations, 2 m nb n flops, at 67 TFLOP/s
// in fp32 (0.256 ms for Y 4096 x 256, C 4096 x 8192), or P passes at the
// 989 TFLOP/s dense bf16 rate in the split modes, where C's bytes (m n 4)
// at 3.35 TB/s are the larger term. The design:
//   - A grid that fills the card: a block owns a 2-D tile of W (128 x 128
//     in fp32, 128 x 64 in the split modes). Where the tiles leave SMs
//     idle (a narrow W: the tsqr factor's 512 x 512 at nb = 512), the
//     m / mr row blocks are cut into G contiguous groups (per = ceil(rb /
//     G) blocks each), one block per (tile, group): grid (row tiles,
//     column tiles, G), the row tiles of a column tile adjacent so that
//     they read C's rows from L2 together. kernels/panel_apply.py:project_plan picks the tile
//     and G from the shapes and the SM count only; G = 1 whenever the
//     tiles alone take more than half the card.
//   - Each block walks its group's row blocks IN ORDER: a row block's
//     partial Y_i^T C_i is a register accumulator per W entry, then added to
//     the running (acc, comp) with Kahan compensation (fp32: in shared
//     memory, touched once per row block; split modes: in registers).
//   - With G = 1 and no T the block writes acc as W. Otherwise it writes
//     (acc, comp) into the workspace (G x 2 x nb x n) and a second launch
//     (combine_kernel) combines the groups IN GROUP ORDER: starting from
//     group 0's pair, each later group's acc_g - comp_g is Kahan-added to
//     the running pair; the result's acc is the sum (at G = 1 acc_0
//     itself). It then folds op(T) in by fp32 FMA, k ascending, as tileqr
//     pins that small product "highest" (panel_apply.py:73-79). No atomics:
//     a rerun is bitwise equal. A W entry's bits depend on G.
//   - fp32 (project_f32_kernel): 256 threads, 8 x 8 W entries a thread,
//     Y and C tiles 16 rows deep through a 3-stage cp.async ring. Each W
//     entry's partial is one fmaf chain over its row block's rows in
//     ascending order from 0, the Kahan add and the fold are the earlier
//     kernel's, so at G = 1 the bits are those of the one-slab-per-block
//     kernel this replaces.
//   - split modes (project_wg_kernel<P>): two warpgroups, each 64 W rows x
//     64 columns by wgmma (m64n64k16, bf16 in, fp32 accumulators). Stages
//     of 32 rows of Y and C arrive in fp32 by cp.async, three stages ahead
//     in a ring; each element is split ONCE into bf16 hi/lo by round to
//     nearest (as bx_mma.cuh's split_store) and stored K-major in shared
//     memory (8 x 8 core matrices, no swizzle), double-buffered, so the
//     next stage's split overlaps this stage's asynchronous products. The
//     passes run in _dot_bx's order into separate accumulators: hh, then
//     hl and lh into one, then ll; a row block's partial is hh + cross
//     (+ ll).
//   - The library is built without fast math, so the Kahan (t - acc) - y
//     is kept as written.
// Phase 2 (tq_panel_sub) is the earlier kernel: apply_kernel, a SIMT GEMM of
// 64 x 64 C tiles in fp32; sub_bx_kernel, bx::gemm32's split product on
// 128 x 32 C tiles (mma.sync through WMMA), any n.
#include <stdint.h>

#include "bx_mma.cuh"

namespace {

constexpr int PA_THREADS = 256;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---- cp.async, wgmma and proxy fences (sm_90a) ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the compiler may not move accesses of r across this point (the
// accumulators are written asynchronously until wg_wait)
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory matrix descriptor of a K-major bf16 operand without swizzle:
// 8 x 8 core matrices (8 rows of 16 bytes, contiguous), LBO bytes between
// the two core matrices of a row group along K, SBO bytes between row groups.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D (64 x 64 fp32, 32 registers a thread) += A (64 x 16) B (16 x 64), both
// bf16 K-major in shared memory.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ---- phase 1, fp32 ----

constexpr int FM = 128, FN = 128, FK = 16, FSTAGES = 3;
constexpr int FE = 64;  // W entries a thread
constexpr size_t F_SMEM =
    sizeof(float) * ((size_t)FSTAGES * FK * (FM + FN) + 2 * (size_t)FE * PA_THREADS);

// Block (x, y, z) = (row tile, column tile, group): W rows 128x.., columns
// 128y.., row blocks [z per, min(rb, (z+1) per)); the row tiles of a
// column tile are neighbours in the launch order, so they share C's rows
// in L2. Thread (ty, tx) = (tid / 16, tid % 16) owns rows {4ty + r, 64 +
// 4ty + r} and columns {4tx + q, 64 + 4tx + q}. Writes acc to acc_out (nb
// x n) and, when comp_out is not null, comp to comp_out, both offset by z
// * gstride. VEC: Y and C 16-byte aligned rows (16-byte cp.async), else
// 4-byte copies. nb a multiple of 32, mr of FK, n of 32.
template <bool VEC>
__global__ void __launch_bounds__(PA_THREADS, 1)
project_f32_kernel(const float* __restrict__ y, const float* __restrict__ c, long long ldc,
                   int m, int n, int nb, int mr, int per, float* acc_out, float* comp_out,
                   long long gstride) {
  extern __shared__ __align__(16) float smf[];
  float* As = smf;                          // FSTAGES x FK x FM: As[kk][i] = Y(k, i0 + i)
  float* Bs = As + FSTAGES * FK * FM;       // FSTAGES x FK x FN: Bs[kk][j] = C(k, j0 + j)
  float* accs = Bs + FSTAGES * FK * FN;     // FE x PA_THREADS: entry e of thread t at e*256+t
  float* comps = accs + FE * PA_THREADS;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int i0 = blockIdx.x * FM, j0 = blockIdx.y * FN;
  const int rb = m / mr, b0 = blockIdx.z * per, b1 = min(rb, b0 + per);
  const int spb = mr / FK, S = (b1 - b0) * spb;
  for (int e = 0; e < FE; ++e) accs[e * PA_THREADS + tid] = comps[e * PA_THREADS + tid] = 0.f;

  // stage s: rows b0 mr + s FK .. + FK of Y and C (the group's rows are contiguous)
  auto load = [&](int s) {
    if (s < S) {
      const long long k0 = (long long)b0 * mr + (long long)s * FK;
      float* as = As + (s % FSTAGES) * FK * FM;
      float* bs = Bs + (s % FSTAGES) * FK * FN;
#pragma unroll
      for (int q = 0; q < (FK * FM / 4) / PA_THREADS; ++q) {
        const int idx = tid + q * PA_THREADS, kk = idx / (FM / 4), i4 = (idx % (FM / 4)) * 4;
        const bool ok = i0 + i4 < nb;
        const float* src = ok ? y + (k0 + kk) * nb + i0 + i4 : y;
        if (VEC) {
          cp_async16(as + kk * FM + i4, src, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(as + kk * FM + i4 + e, ok ? src + e : y, ok);
        }
      }
#pragma unroll
      for (int q = 0; q < (FK * FN / 4) / PA_THREADS; ++q) {
        const int idx = tid + q * PA_THREADS, kk = idx / (FN / 4), j4 = (idx % (FN / 4)) * 4;
        const bool ok = j0 + j4 < n;
        const float* src = ok ? c + (k0 + kk) * ldc + j0 + j4 : c;
        if (VEC) {
          cp_async16(bs + kk * FN + j4, src, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(bs + kk * FN + j4 + e, ok ? src + e : c, ok);
        }
      }
    }
    cp_commit();  // an empty group past the last stage keeps the count uniform
  };

  float part[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) part[r][q] = 0.f;

  load(0);
  load(1);
  for (int s = 0; s < S; ++s) {
    cp_wait<FSTAGES - 2>();  // this thread's copies of stage s have landed
    __syncthreads();         // everyone's; and stage s - 1's buffer is consumed
    load(s + 2);
    const float* as = As + (s % FSTAGES) * FK * FM;
    const float* bs = Bs + (s % FSTAGES) * FK * FN;
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * FM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * FM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * FN + tx * 4);
      const float4 b1v = *reinterpret_cast<const float4*>(bs + kk * FN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) part[r][q] = fmaf(av[r], bv[q], part[r][q]);
    }
    if ((s + 1) % spb == 0) {  // the row block's last stage: Kahan acc += part
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int o = (r * 8 + q) * PA_THREADS + tid;
          const float yk = part[r][q] - comps[o];
          const float t = accs[o] + yk;
          comps[o] = (t - accs[o]) - yk;
          accs[o] = t;
          part[r][q] = 0.f;
        }
    }
  }
  cp_wait<0>();

  const long long go = (long long)blockIdx.z * gstride;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
    if (i >= nb) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      if (j >= n) continue;
      const int o = (r * 8 + h * 4) * PA_THREADS + tid;
      const long long at = go + (long long)i * n + j;
      *reinterpret_cast<float4*>(acc_out + at) =
          make_float4(accs[o], accs[o + PA_THREADS], accs[o + 2 * PA_THREADS],
                      accs[o + 3 * PA_THREADS]);
      if (comp_out != nullptr)
        *reinterpret_cast<float4*>(comp_out + at) =
            make_float4(comps[o], comps[o + PA_THREADS], comps[o + 2 * PA_THREADS],
                        comps[o + 3 * PA_THREADS]);
    }
  }
}

// ---- phase 1, the split modes on wgmma ----

constexpr int WM = 128, WN = 64, WK = 32;  // W rows, W columns, rows of Y/C a stage
constexpr int WSTAGES = 4;                 // fp32 stages in flight (cp.async ring)
// bytes of one k16 chunk of a K-major bf16 operand (rows x 16), of a split
// stage (A hi, A lo, B hi, B lo), and of an fp32 stage (Y: WK x WM, C: WK x WN)
constexpr int A_CHUNK = WM * 16 * 2, B_CHUNK = WN * 16 * 2;
constexpr int A_BYTES = (WK / 16) * A_CHUNK, B_BYTES = (WK / 16) * B_CHUNK;
constexpr int SPLIT_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int RAW_FLOATS = WK * (WM + WN);
constexpr size_t WG_SMEM = 2 * (size_t)SPLIT_BYTES + sizeof(float) * WSTAGES * RAW_FLOATS;
constexpr unsigned CORE_LBO = 128, CORE_SBO = 256;  // bytes: along K, between row groups

// byte offset of the 8 consecutive k (kg-th group of 8 in the stage) of
// operand row r in a split stage's K-major layout
__device__ __forceinline__ int core_off(int r, int kg, int chunk_bytes) {
  return (kg >> 1) * chunk_bytes + (r >> 3) * CORE_SBO + (kg & 1) * CORE_LBO + (r & 7) * 16;
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// the 8 values x[q * ld] ~ hi + lo, each rounded to nearest (bx_mma.cuh's
// split_store: lo = bf16_rn(x - float(hi))), two at a time (one cvt a
// pair), stored as 16 bytes each
template <int P>
__device__ __forceinline__ void split8(const float* x, int ld, unsigned char* hi,
                                       unsigned char* lo) {
  unsigned h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float a = x[2 * q * ld], b = x[(2 * q + 1) * ld];
    const __nv_bfloat162 hb = __floats2bfloat162_rn(a, b);  // .x = a at the lower address
    h[q] = bits_of(hb);
    if (P > 1) {
      const float2 hf = __bfloat1622float2(hb);
      l[q] = bits_of(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if (P > 1) *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Block (x, y, z) = (row tile, column tile, group): W rows 128x.. (warpgroup
// g: 64g..), columns 64y.., row blocks [z per, min(rb, (z+1) per)), each of
// mr rows in stages of WK (the last stage of a row block zero-filled past
// its end). The fp32 rows of Y and C arrive by cp.async, WSTAGES - 1 stages
// ahead; each stage is split once into the bf16 buffer the products read
// (two, alternating). Accumulator element e of a thread: W row 16 warp +
// lane/4 + 8 ((e/2)%2), column 8 (e/4) + 2 (lane%4) + e%2 (wgmma's D
// layout). Any nb, n; VEC: Y, C 16-byte aligned with nb, n, ldc multiples
// of 4 (16-byte copies), else 4-byte copies.
template <int P, bool VEC>
__global__ void __launch_bounds__(PA_THREADS, 1)
project_wg_kernel(const float* __restrict__ y, const float* __restrict__ c, long long ldc,
                  int m, int n, int nb, int mr, int per, float* acc_out, float* comp_out,
                  long long gstride) {
  extern __shared__ __align__(128) unsigned char smw[];
  float* raw = reinterpret_cast<float*>(smw + 2 * SPLIT_BYTES);  // WSTAGES x (Y, C) fp32
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int i0 = blockIdx.x * WM, j0 = blockIdx.y * WN;
  const int rb = m / mr, b0 = blockIdx.z * per, b1 = min(rb, b0 + per);
  const int spb = ceil_div(mr, WK), S = (b1 - b0) * spb;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smw);

  float hh[32], cr[32], ll[32], acc[32], comp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) hh[e] = cr[e] = ll[e] = acc[e] = comp[e] = 0.f;

  // stage s's rows of Y (WK x WM, columns i0..) and C (WK x WN, columns j0..)
  // into raw stage s % WSTAGES; a commit group per call, empty past S
  auto load = [&](int s) {
    if (s < S) {
      const int blk = b0 + s / spb;
      const long long k0 = (long long)blk * mr + (long long)(s % spb) * WK;
      const long long kend = (long long)blk * mr + mr;
      float* ys = raw + (s % WSTAGES) * RAW_FLOATS;
      float* cs = ys + WK * WM;
#pragma unroll
      for (int q = 0; q < (WK * WM / 4) / PA_THREADS; ++q) {
        const int idx = tid + q * PA_THREADS, kk = idx / (WM / 4), i4 = (idx % (WM / 4)) * 4;
        const long long k = k0 + kk;
        const float* row = y + k * nb + i0 + i4;
        if (VEC) {
          const bool ok = k < kend && i0 + i4 < nb;
          cp_async16(ys + kk * WM + i4, ok ? row : y, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = k < kend && i0 + i4 + e < nb;
            cp_async4(ys + kk * WM + i4 + e, ok ? row + e : y, ok);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < (WK * WN / 4) / PA_THREADS; ++q) {
        const int idx = tid + q * PA_THREADS, kk = idx / (WN / 4), j4 = (idx % (WN / 4)) * 4;
        const long long k = k0 + kk;
        const float* row = c + k * ldc + j0 + j4;
        if (VEC) {
          const bool ok = k < kend && j0 + j4 < n;
          cp_async16(cs + kk * WN + j4, ok ? row : c, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = k < kend && j0 + j4 + e < n;
            cp_async4(cs + kk * WN + j4 + e, ok ? row + e : c, ok);
          }
        }
      }
    }
    cp_commit();
  };
  // split raw stage s into bf16 buffer s % 2 by (column, 8-row group)
  // pairs: Y's p = tid + 256 h (column p % 128, group p / 128), C's
  // likewise (column p % 64, group p / 64); lanes take neighbouring columns
  auto put = [&](int s) {
    const float* ys = raw + (s % WSTAGES) * RAW_FLOATS;
    const float* cs = ys + WK * WM;
    unsigned char* st = smw + (s & 1) * SPLIT_BYTES;
#pragma unroll
    for (int h = 0; h < (WK / 8) * WM / PA_THREADS; ++h) {
      const int p = tid + h * PA_THREADS, r = p % WM, kg = p / WM;
      const int off = core_off(r, kg, A_CHUNK);
      split8<P>(ys + kg * 8 * WM + r, WM, st + off, st + A_BYTES + off);
    }
#pragma unroll
    for (int h = 0; h < (WK / 8) * WN / PA_THREADS; ++h) {
      const int p = tid + h * PA_THREADS, r = p % WN, kg = p / WN;
      const int off = core_off(r, kg, B_CHUNK);
      split8<P>(cs + kg * 8 * WN + r, WN, st + 2 * A_BYTES + off,
                st + 2 * A_BYTES + B_BYTES + off);
    }
  };
  auto mma = [&](int buf) {
    const unsigned st = sbase + buf * SPLIT_BYTES;
#pragma unroll
    for (int ch = 0; ch < WK / 16; ++ch) {
      const unsigned a_hi = st + ch * A_CHUNK + wg * (64 / 8) * CORE_SBO, a_lo = a_hi + A_BYTES;
      const unsigned b_hi = st + 2 * A_BYTES + ch * B_CHUNK, b_lo = b_hi + B_BYTES;
      const uint64_t dah = smem_desc(a_hi, CORE_LBO, CORE_SBO);
      const uint64_t dbh = smem_desc(b_hi, CORE_LBO, CORE_SBO);
      wgmma64(hh, dah, dbh);
      if (P > 1) {
        const uint64_t dal = smem_desc(a_lo, CORE_LBO, CORE_SBO);
        const uint64_t dbl = smem_desc(b_lo, CORE_LBO, CORE_SBO);
        wgmma64(cr, dah, dbl);
        wgmma64(cr, dal, dbh);
        if (P > 3) wgmma64(ll, dal, dbl);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) load(s);
  for (int s = 0; s < S; ++s) {
    cp_wait<WSTAGES - 2>();  // this thread's copies of stage s have landed
    wg_wait<1>();            // this warpgroup's products of stage s - 2 are done
    __syncthreads();         // everyone's: raw stage s is in, split buffer s % 2 is free,
                             // raw stage s - 1 is split
    load(s + WSTAGES - 1);   // into raw stage (s - 1) % WSTAGES
    put(s);
    fence_proxy_async();
    __syncthreads();
    wg_fence();
    mma(s & 1);
    wg_commit();
    if ((s + 1) % spb == 0) {  // the row block's last stage: Kahan acc += partial
      wg_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        fence_reg(hh[e]);
        if (P > 1) fence_reg(cr[e]);
        if (P > 3) fence_reg(ll[e]);
        float v = hh[e];
        if (P > 1) v = v + cr[e];
        if (P > 3) v = v + ll[e];
        const float yk = v - comp[e];
        const float t = acc[e] + yk;
        comp[e] = (t - acc[e]) - yk;
        acc[e] = t;
        hh[e] = cr[e] = ll[e] = 0.f;
      }
    }
  }
  wg_wait<0>();
  cp_wait<0>();

  const long long go = (long long)blockIdx.z * gstride;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = i0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * ((e >> 1) & 1);
    const int j = j0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
    if (i < nb && j < n) {
      const long long at = go + (long long)i * n + j;
      acc_out[at] = acc[e];
      if (comp_out != nullptr) comp_out[at] = comp[e];
    }
  }
}

// ---- phase 1b: the groups combined, op(T) folded in ----

constexpr int CB_COLS = 32;  // W columns a block

// W (nb x n) from work (groups x 2 x nb x n: each group's acc, then comp):
// the groups Kahan-combined in group order, then W = tm . combined (k
// ascending, fp32 FMA), or the combined sum itself when tm is null. Block x:
// columns 32x..; thread: column tid % 32, rows tid / 32 + 8 q.
__global__ void __launch_bounds__(PA_THREADS)
combine_kernel(const float* __restrict__ work, const float* __restrict__ tm, int nb, int n,
               int groups, float* __restrict__ w) {
  extern __shared__ __align__(16) float cs[];  // nb x CB_COLS: the combined slab
  const int tid = threadIdx.x, cc = tid % CB_COLS, col = blockIdx.x * CB_COLS + cc;
  const long long plane = (long long)nb * n;
  for (int i = tid / CB_COLS; i < nb; i += PA_THREADS / CB_COLS) {
    float acc = 0.f;
    if (col < n) {
      const long long o = (long long)i * n + col;
      acc = work[o];
      float comp = work[plane + o];
      for (int g = 1; g < groups; ++g) {
        const float* wg = work + 2 * g * plane;
        const float yk = (wg[o] - wg[plane + o]) - comp;
        const float t = acc + yk;
        comp = (t - acc) - yk;
        acc = t;
      }
    }
    if (tm == nullptr) {
      if (col < n) w[(long long)i * n + col] = acc;
    } else {
      cs[i * CB_COLS + cc] = acc;
    }
  }
  if (tm == nullptr) return;
  __syncthreads();
  constexpr int RQ = 8, ROWS = RQ * (PA_THREADS / CB_COLS);  // rows a pass: 64
  const bool vec = (nb & 3) == 0;
  for (int r0 = tid / CB_COLS; r0 < nb; r0 += ROWS) {
    float out[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) out[q] = 0.f;
    int k = 0;
    if (vec) {
      for (; k < nb; k += 4) {
        const float x0 = cs[k * CB_COLS + cc], x1 = cs[(k + 1) * CB_COLS + cc];
        const float x2 = cs[(k + 2) * CB_COLS + cc], x3 = cs[(k + 3) * CB_COLS + cc];
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const int i = min(r0 + q * (PA_THREADS / CB_COLS), nb - 1);
          const float4 t = __ldg(reinterpret_cast<const float4*>(tm + (long long)i * nb + k));
          out[q] = fmaf(t.x, x0, out[q]);
          out[q] = fmaf(t.y, x1, out[q]);
          out[q] = fmaf(t.z, x2, out[q]);
          out[q] = fmaf(t.w, x3, out[q]);
        }
      }
    }
    for (; k < nb; ++k) {
      const float x = cs[k * CB_COLS + cc];
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int i = min(r0 + q * (PA_THREADS / CB_COLS), nb - 1);
        out[q] = fmaf(__ldg(tm + (long long)i * nb + k), x, out[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int i = r0 + q * (PA_THREADS / CB_COLS);
      if (i < nb && col < n) w[(long long)i * n + col] = out[q];
    }
  }
}

// the widest panel the split instantiations take (kernels/panel_apply.py
// BX_MAX_NB, the contract of the entries since the W slab of the earlier
// phase 1 filled shared memory there); combine_kernel's slab is nb x 32
// floats, 96 KiB at 768
constexpr int BX_MAX_NB = 768;

template <class K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// ---- phase 2 ----

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

// Phase 2 at P passes: block (x, y) updates C rows 128x .. +128, columns
// 32y .. +32 (those below n when RAGGED): C -= Y W. RAGGED (n not a
// multiple of 32) is a template flag so that the common case keeps its
// staging loops free of the test.
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

using ProjectFn = void (*)(const float*, const float*, long long, int, int, int, int, int,
                          float*, float*, long long);

// phase 1a's launch: the mode's kernel on grid (row tiles, column tiles, groups)
template <class K>
int launch_tiles(K kernel, size_t smem, int tm_rows, int tn_cols, const float* y,
                 const float* c, long long ldc, int m, int n, int nb, int mr, int groups,
                 int per, float* acc_out, float* comp_out, long long gstride,
                 cudaStream_t stream) {
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid(ceil_div(nb, tm_rows), ceil_div(n, tn_cols), groups);
  kernel<<<grid, PA_THREADS, smem, stream>>>(y, c, ldc, m, n, nb, mr, per, acc_out, comp_out,
                                             gstride);
  return (int)cudaGetLastError();
}

}  // namespace

// Phase 1: w (nb x n) = op(T) sum_i Y_i^T C_i over row blocks of mr rows
// (tm = op(T), contiguous), or the bare sum when tm is null. C is (m x n)
// with row stride ldc; m a multiple of mr. The row blocks run in `groups`
// contiguous groups (kernels/panel_apply.py:project_plan; G must be
// ceil(rb / ceil(rb / G)), so that no group is empty, and 1 when m = 0,
// which gives W = 0); work holds G x 2 x nb x n floats, and may be null
// when G = 1 and tm is null. passes: 0
// ("highest"; nb a multiple of 32, <= 256, mr of 16, n of 32), 1
// ("default"), 3 ("b3"/"high"), 4 ("b4") (any nb <= BX_MAX_NB, any n).
extern "C" int tq_panel_project(const float* y, const float* tm, const float* c,
                                long long ldc, int m, int n, int nb, int mr, float* w,
                                float* work, int groups, int passes, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (m < 0 || n < 1 || nb < 1 || mr < 1 || m % mr || groups < 1)
    return (int)cudaErrorInvalidValue;
  const int rb = m / mr, per = ceil_div(rb, groups);
  if (rb ? ceil_div(rb, per) != groups : groups != 1) return (int)cudaErrorInvalidValue;
  const bool direct = groups == 1 && tm == nullptr;
  if (!direct && work == nullptr) return (int)cudaErrorInvalidValue;
  float* acc_out = direct ? w : work;
  float* comp_out = direct ? nullptr : work + (long long)nb * n;
  const long long gstride = 2LL * nb * n;
  int e;
  switch (passes) {
    case 0: {
      if (nb % 32 || nb > 256 || mr % FK || n % 32) return (int)cudaErrorInvalidValue;
      const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 16 == 0 && ldc % 4 == 0;
      e = vec ? launch_tiles(project_f32_kernel<true>, F_SMEM, FM, FN, y, c, ldc, m, n, nb, mr,
                             groups, per, acc_out, comp_out, gstride, stream)
              : launch_tiles(project_f32_kernel<false>, F_SMEM, FM, FN, y, c, ldc, m, n, nb, mr,
                             groups, per, acc_out, comp_out, gstride, stream);
      break;
    }
    case 1:
    case 3:
    case 4: {
      if (nb > BX_MAX_NB) return (int)cudaErrorInvalidValue;
      const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 16 == 0 && ldc % 4 == 0 &&
                       nb % 4 == 0 && n % 4 == 0;
      ProjectFn k = &project_wg_kernel<4, false>;
      if (passes == 4 && vec) k = &project_wg_kernel<4, true>;
      if (passes == 3) k = vec ? &project_wg_kernel<3, true> : &project_wg_kernel<3, false>;
      if (passes == 1) k = vec ? &project_wg_kernel<1, true> : &project_wg_kernel<1, false>;
      e = launch_tiles(k, WG_SMEM, WM, WN, y, c, ldc, m, n, nb, mr, groups, per, acc_out,
                       comp_out, gstride, stream);
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0 || direct) return e;
  const size_t smem = tm == nullptr ? 0 : sizeof(float) * (size_t)nb * CB_COLS;
  e = set_smem(combine_kernel, smem);
  if (e != 0) return e;
  combine_kernel<<<ceil_div(n, CB_COLS), PA_THREADS, smem, stream>>>(work, tm, nb, n, groups, w);
  return (int)cudaGetLastError();
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
