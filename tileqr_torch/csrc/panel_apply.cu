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
//   - fp32, the balanced schedule: the fp32 kernel holds 176 KiB of shared
//     memory, one block an SM, and a block walks all its group's rows, so a
//     grid of 136 tiles takes two block-times for 1.03 blocks of work. Where
//     the whole-tile grid ends on a part-filled wave, project_plan instead
//     cuts the launch's units (tile, row block), chain by chain (a chain:
//     one tile's row blocks in one group), into min(SMs, units) contiguous
//     ranges that differ by at most one unit, one persistent block a range,
//     taken by an atomic ticket in start order. A chain cut between two
//     ranges is summed by both blocks in turn: the first sums its row blocks
//     at the start of its run and stores its (acc, comp) into a slot of the
//     workspace behind a release flag; the second reaches the chain's rest
//     at the end of its run, acquires the flag, loads the pair and
//     Kahan-adds its own row blocks' partials in order. Each partial is the
//     same fmaf chain and each fold the same sequence, so W is bitwise the
//     whole-tile grid's at the same G. A cut chain thus takes its whole
//     length to finish, so the rule (kernels/panel_apply.py:project_ranges)
//     takes the schedule only where no chain is cut across more than two
//     ranges and the ranges and cut chains end before the whole-tile grid's
//     waves would: grids of more than one wave. The flags and the ticket are
//     zeroed by a memset in the stream before the launch, so a CUDA graph
//     replays the pair as it was captured.
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
// Phase 2 (tq_panel_sub), C -= Y W, is a GEMM over 2-D tiles of C with the
// contraction over nb. What bounds it on the H100: 2 m nb n flops at 67
// TFLOP/s in fp32 (0.256 ms for Y 4096 x 256, C 4096 x 8192), C's bytes read
// and written (2 m n 4, 0.080 ms there) in the split modes. The design
// (tile_gemm.cuh): a block owns a C tile, 128 x 128 (fp32) or 128 x 64
// (split), or 64 x 64 where the large tiles leave the card idle
// (kernels/panel_apply.py:sub_plan, from the shapes and the SM count; the
// entry refuses any other tile); fp32: f32_tile, 8 x 8 entries a thread,
// Y and W 16 deep through a 3-stage cp.async ring, each C entry's product
// one fmaf chain over k ascending from 0 and then x - acc, the order of the
// 64 x 64 kernel this replaces, so its bits; split modes: wg_tile on
// wgmma, Y's rows (K-major as they lie) and W split once a stage. The same
// kernels take a batch (grid z) of independent products: K3's stage 3
// (strip.cu) runs all of a strip's couples C_bot_q -= V2_q W2_q in one
// launch through tq_sub_launch.
#include <limits.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace {

using tg::ceil_div;
using tg::core_off;
using tg::CORE_LBO;
using tg::CORE_SBO;
using tg::cp_async16;
using tg::cp_async4;
using tg::cp_commit;
using tg::cp_wait;
using tg::fence_proxy_async;
using tg::fence_reg;
using tg::smem_desc;
using tg::wg_commit;
using tg::wg_fence;
using tg::wg_wait;
using tg::wgmma64;

constexpr int PA_THREADS = 256;

// ---- phase 1, fp32 ----

constexpr int FM = 128, FN = 128, FK = 16, FSTAGES = 3;
constexpr int FE = 64;  // W entries a thread
constexpr size_t F_SMEM =
    sizeof(float) * ((size_t)FSTAGES * FK * (FM + FN) + 2 * (size_t)FE * PA_THREADS);

// handed pair: a block's (acc, comp) of one W tile, in its threads' order
constexpr int SLOT = 2 * FE * PA_THREADS;

// W tile (i0, j0), row blocks [b0, b1): each row block's partial Kahan-added
// IN ORDER into the block's (acc, comp) in shared memory (accs, comps: entry
// e of thread t at e*256+t, each thread touching only its own). Thread (ty,
// tx) = (tid / 16, tid % 16) owns rows {4ty + r, 64 + 4ty + r} and columns
// {4tx + q, 64 + 4tx + q}. VEC: Y and C 16-byte aligned rows (16-byte
// cp.async), else 4-byte copies. nb a multiple of 32, mr of FK, n of 32.
template <bool VEC>
__device__ __forceinline__ void f32_rows(float* smf, const float* __restrict__ y,
                                         const float* __restrict__ c, long long ldc, int n,
                                         int nb, int mr, int i0, int j0, int b0, int b1) {
  float* As = smf;                          // FSTAGES x FK x FM: As[kk][i] = Y(k, i0 + i)
  float* Bs = As + FSTAGES * FK * FM;       // FSTAGES x FK x FN: Bs[kk][j] = C(k, j0 + j)
  float* accs = Bs + FSTAGES * FK * FN;     // FE x PA_THREADS
  float* comps = accs + FE * PA_THREADS;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int spb = mr / FK, S = (b1 - b0) * spb;

  // stage s: rows b0 mr + s FK .. + FK of Y and C (the row blocks are contiguous)
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
      const float4 b0v = *reinterpret_cast<const float4*>(bs + kk * FN + tx * 4);
      const float4 b1v = *reinterpret_cast<const float4*>(bs + kk * FN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0v.x, b0v.y, b0v.z, b0v.w, b1v.x, b1v.y, b1v.z, b1v.w};
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
}

// (acc, comp) of W tile (i0, j0) into acc_out (nb x n) and, when comp_out is
// not null, comp_out, both offset by go
__device__ __forceinline__ void f32_store(const float* accs, const float* comps, float* acc_out,
                                          float* comp_out, long long go, int i0, int j0, int nb,
                                          int n) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* f, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(f), "r"(v) : "memory");
}

// The whole-tile grid (BAL false): block (x, y, z) = (row tile, column
// tile, group) sums W rows 128x.., columns 128y.. over row blocks [z per,
// min(rb, (z+1) per)); the row tiles of a column tile are neighbours in the
// launch order, so they share C's rows in L2.
// The balanced schedule (BAL true; kernels/panel_apply.py:project_walk):
// gridDim.x persistent blocks, one a range of the launch's units (tile,
// row block), chains (a tile's row blocks in one group) in order, tile
// fastest; a block takes its range from the ticket sync[0], so it waits
// only on blocks already running. It walks its range's chains last first,
// each chain's row blocks ascending: a chain that runs on into the next
// range (its head) comes first, its pair stored into slot r and flag
// sync[1 + r] released; a chain that began in the previous range (its
// tail) comes last, its pair taken from slot r - 1 once that flag is up.
// Each group's pair is written where the whole-tile grid writes it: acc to
// acc_out and, when comp_out is not null, comp to comp_out, both offset by
// z * gstride.
template <bool VEC, bool BAL>
__global__ void __launch_bounds__(PA_THREADS, 1)
project_f32_kernel(const float* __restrict__ y, const float* __restrict__ c, long long ldc,
                   int m, int n, int nb, int mr, int per, float* acc_out, float* comp_out,
                   long long gstride, float* slots, unsigned* sync) {
  extern __shared__ __align__(16) float smf[];
  float* accs = smf + FSTAGES * FK * (FM + FN);
  float* comps = accs + FE * PA_THREADS;
  const int tid = threadIdx.x, rb = m / mr;
  auto zero = [&]() {
    for (int e = 0; e < FE; ++e) accs[e * PA_THREADS + tid] = comps[e * PA_THREADS + tid] = 0.f;
  };
  if constexpr (!BAL) {
    const int b0 = blockIdx.z * per, i0 = blockIdx.x * FM, j0 = blockIdx.y * FN;
    zero();
    f32_rows<VEC>(smf, y, c, ldc, n, nb, mr, i0, j0, b0, min(rb, b0 + per));
    f32_store(accs, comps, acc_out, comp_out, (long long)blockIdx.z * gstride, i0, j0, nb, n);
  } else {
    __shared__ int ticket;
    if (tid == 0) ticket = (int)atomicAdd(sync, 1u);
    __syncthreads();
    const int r = ticket, ranges = (int)gridDim.x;
    const int xt = ceil_div(nb, FM), tiles = xt * ceil_div(n, FN), groups = ceil_div(rb, per);
    const int units = tiles * rb, base = units / ranges, extra = units % ranges;
    const int u0 = r * base + min(r, extra), u1 = u0 + base + (r < extra ? 1 : 0);
    for (int u = u1; u > u0;) {
      const int z = min((u - 1) / (tiles * per), groups - 1), len = min(per, rb - z * per);
      const int w = (u - 1 - z * tiles * per) / len;
      const int start = z * tiles * per + w * len, s0 = max(start, u0);
      const int i0 = (w % xt) * FM, j0 = (w / xt) * FN, b = z * per - start;
      if (start < u0) {  // the tail: the pair range r - 1 handed on
        if (tid == 0)
          while (ld_acquire(sync + r) == 0) __nanosleep(64);
        __syncthreads();
        const float* from = slots + (long long)(r - 1) * SLOT;
        for (int e = 0; e < FE; ++e) {
          const int o = e * PA_THREADS + tid;
          accs[o] = __ldcg(from + o);
          comps[o] = __ldcg(from + FE * PA_THREADS + o);
        }
      } else {
        zero();
      }
      f32_rows<VEC>(smf, y, c, ldc, n, nb, mr, i0, j0, b + s0, b + u);
      if (start + len > u1) {  // the head: the pair handed on to range r + 1
        float* to = slots + (long long)r * SLOT;
        for (int e = 0; e < FE; ++e) {
          const int o = e * PA_THREADS + tid;
          to[o] = accs[o];
          to[FE * PA_THREADS + o] = comps[o];
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) st_release(sync + 1 + r, 1u);
      } else {
        f32_store(accs, comps, acc_out, comp_out, (long long)z * gstride, i0, j0, nb, n);
        __syncthreads();  // every stage buffer consumed before the next chain's copies
      }
      u = s0;
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
      bx::split8<P>(ys + kg * 8 * WM + r, WM, st + off, st + A_BYTES + off);
    }
#pragma unroll
    for (int h = 0; h < (WK / 8) * WN / PA_THREADS; ++h) {
      const int p = tid + h * PA_THREADS, r = p % WN, kg = p / WN;
      const int off = core_off(r, kg, B_CHUNK);
      bx::split8<P>(cs + kg * 8 * WN + r, WN, st + 2 * A_BYTES + off,
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

// ---- phase 2 (and K3's stage 3): C_z -= Y_z W_z ----

// Block (x, y, z): C_z rows BM x.., columns BN y..; Y_z K-major (the rows
// of Y), W_z N-major.
template <int BM, int BN>
__global__ void __launch_bounds__(tg::F_THREADS, 2)
sub_f32_kernel(const float* y, long long ys, const float* w, long long ldw, long long ws, float* c,
               long long ldc, long long cs, int m, int n, int nb, int vec) {
  extern __shared__ __align__(16) float smf[];
  const int z = blockIdx.z;
  float* cz = c + z * cs;
  tg::f32_tile<BM, BN, true>(smf, {y + z * ys, nb}, {w + z * ws, ldw}, m, n, 0, nb,
                             blockIdx.x * BM, blockIdx.y * BN, vec, false, tg::Sub{cz, ldc});
}

template <int P, int BM>
__global__ void __launch_bounds__(2 * BM, 1)
sub_wg_kernel(const float* y, long long ys, const float* w, long long ldw, long long ws, float* c,
              long long ldc, long long cs, int m, int n, int nb, int vec) {
  extern __shared__ __align__(128) unsigned char smw[];
  const int z = blockIdx.z;
  float* cz = c + z * cs;
  tg::wg_tile<P, BM, true>(smw, {y + z * ys, nb}, {w + z * ws, ldw}, m, n, 0, nb,
                           blockIdx.x * BM, blockIdx.y * tg::WBN, vec, false, tg::Sub{cz, ldc});
}

template <class K>
int launch_sub(K kernel, size_t smem, int threads, int tm, int tn, const float* y, long long ys,
               const float* w, long long ldw, long long ws, float* c, long long ldc,
               long long cs, int m, int n, int nb, int batch, int vec, cudaStream_t stream) {
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid(ceil_div(m, tm), ceil_div(n, tn), batch);
  kernel<<<grid, threads, smem, stream>>>(y, ys, w, ldw, ws, c, ldc, cs, m, n, nb, vec);
  return (int)cudaGetLastError();
}

using ProjectFn = void (*)(const float*, const float*, long long, int, int, int, int, int,
                          float*, float*, long long);

// phase 1a's launch: the mode's kernel on `grid` (the extra arguments: the
// fp32 kernel's slots and sync words)
template <class K, class... Extra>
int launch_project(K kernel, size_t smem, dim3 grid, const float* y, const float* c,
                   long long ldc, int m, int n, int nb, int mr, int per, float* acc_out,
                   float* comp_out, long long gstride, cudaStream_t stream, Extra... extra) {
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<grid, PA_THREADS, smem, stream>>>(y, c, ldc, m, n, nb, mr, per, acc_out, comp_out,
                                             gstride, extra...);
  return (int)cudaGetLastError();
}

// the fp32 kernel on the whole-tile grid (ranges = 0) or the balanced
// schedule's `ranges` blocks, its ticket and flags zeroed first in the
// stream (a CUDA graph captures the memset with the launch)
template <bool VEC>
int launch_f32(const float* y, const float* c, long long ldc, int m, int n, int nb, int mr,
               int groups, int per, float* acc_out, float* comp_out, long long gstride,
               int ranges, float* slots, cudaStream_t stream) {
  if (ranges == 0)
    return launch_project(project_f32_kernel<VEC, false>, F_SMEM,
                          dim3(ceil_div(nb, FM), ceil_div(n, FN), groups), y, c, ldc, m, n, nb,
                          mr, per, acc_out, comp_out, gstride, stream, (float*)nullptr,
                          (unsigned*)nullptr);
  unsigned* sync = reinterpret_cast<unsigned*>(slots + (long long)ranges * SLOT);
  const int e = (int)cudaMemsetAsync(sync, 0, sizeof(unsigned) * (ranges + 1), stream);
  if (e != 0) return e;
  return launch_project(project_f32_kernel<VEC, true>, F_SMEM, dim3(ranges), y, c, ldc, m, n,
                        nb, mr, per, acc_out, comp_out, gstride, stream, slots, sync);
}

}  // namespace

// Phase 1: w (nb x n) = op(T) sum_i Y_i^T C_i over row blocks of mr rows
// (tm = op(T), contiguous), or the bare sum when tm is null. C is (m x n)
// with row stride ldc; m a multiple of mr. The row blocks run in `groups`
// contiguous groups (kernels/panel_apply.py:project_plan; G must be
// ceil(rb / ceil(rb / G)), so that no group is empty, and 1 when m = 0,
// which gives W = 0). work holds G x 2 x nb x n floats, none when G = 1 and
// tm is null (W written directly), then, where `ranges` > 0 (the fp32
// kernel's balanced schedule on that many blocks, at most the launch's
// units), ranges x SLOT floats of handed pairs and ranges + 1 words of
// ticket and flags; work may be null when it holds nothing. passes: 0
// ("highest"; nb a multiple of 32, <= 256, mr of 16, n of 32), 1
// ("default"), 3 ("b3"/"high"), 4 ("b4") (any nb <= BX_MAX_NB, any n).
extern "C" int tq_panel_project(const float* y, const float* tm, const float* c,
                                long long ldc, int m, int n, int nb, int mr, float* w,
                                float* work, int groups, int ranges, int passes,
                                void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (m < 0 || n < 1 || nb < 1 || mr < 1 || m % mr || groups < 1 || ranges < 0)
    return (int)cudaErrorInvalidValue;
  const int rb = m / mr, per = ceil_div(rb, groups);
  if (rb ? ceil_div(rb, per) != groups : groups != 1) return (int)cudaErrorInvalidValue;
  const bool direct = groups == 1 && tm == nullptr;
  if ((!direct || ranges > 0) && work == nullptr) return (int)cudaErrorInvalidValue;
  float* acc_out = direct ? w : work;
  float* comp_out = direct ? nullptr : work + (long long)nb * n;
  const long long gstride = 2LL * nb * n;
  int e;
  switch (passes) {
    case 0: {
      if (nb % 32 || nb > 256 || mr % FK || n % 32) return (int)cudaErrorInvalidValue;
      const long long units = (long long)ceil_div(nb, FM) * ceil_div(n, FN) * rb;
      if (ranges > 0 && (ranges > units || units > INT_MAX)) return (int)cudaErrorInvalidValue;
      const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 16 == 0 && ldc % 4 == 0;
      float* slots = ranges > 0 ? work + (direct ? 0 : groups * gstride) : nullptr;
      e = vec ? launch_f32<true>(y, c, ldc, m, n, nb, mr, groups, per, acc_out, comp_out,
                                 gstride, ranges, slots, stream)
              : launch_f32<false>(y, c, ldc, m, n, nb, mr, groups, per, acc_out, comp_out,
                                  gstride, ranges, slots, stream);
      break;
    }
    case 1:
    case 3:
    case 4: {
      if (nb > BX_MAX_NB || ranges > 0) return (int)cudaErrorInvalidValue;
      const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c) % 16 == 0 && ldc % 4 == 0 &&
                       nb % 4 == 0 && n % 4 == 0;
      ProjectFn k = &project_wg_kernel<4, false>;
      if (passes == 4 && vec) k = &project_wg_kernel<4, true>;
      if (passes == 3) k = vec ? &project_wg_kernel<3, true> : &project_wg_kernel<3, false>;
      if (passes == 1) k = vec ? &project_wg_kernel<1, true> : &project_wg_kernel<1, false>;
      e = launch_project(k, WG_SMEM, dim3(ceil_div(nb, WM), ceil_div(n, WN), groups), y, c, ldc,
                         m, n, nb, mr, per, acc_out, comp_out, gstride, stream);
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

int tq_sub_launch(const float* y, long long ys, const float* w, long long ldw, long long ws,
                  float* c, long long ldc, long long cs, int m, int n, int nb, int batch,
                  int tile_m, int tile_n, int passes, cudaStream_t stream) {
  if (m < 1 || n < 1 || nb < 1 || batch < 1 || batch > 65535 || !tq_tile_ok(tile_m, tile_n, passes))
    return (int)cudaErrorInvalidValue;
  const int vec = tg::aligned16(y) && tg::aligned16(w) && nb % 4 == 0 && ldw % 4 == 0 &&
                  n % 4 == 0 && ys % 4 == 0 && ws % 4 == 0;
#define TQ_SUB(K, SMEM, THREADS) \
  launch_sub(K, SMEM, THREADS, tile_m, tile_n, y, ys, w, ldw, ws, c, ldc, cs, m, n, nb, batch, vec, stream)
  const bool big = tile_m == 128;
  switch (passes) {
    case 0:
      return big ? TQ_SUB((sub_f32_kernel<128, 128>), (tg::f32_smem<128, 128, true>()), 256)
                 : TQ_SUB((sub_f32_kernel<64, 64>), (tg::f32_smem<64, 64, true>()), 256);
    case 1:
      return big ? TQ_SUB((sub_wg_kernel<1, 128>), tg::wg_smem<128>(), 256)
                 : TQ_SUB((sub_wg_kernel<1, 64>), tg::wg_smem<64>(), 128);
    case 3:
      return big ? TQ_SUB((sub_wg_kernel<3, 128>), tg::wg_smem<128>(), 256)
                 : TQ_SUB((sub_wg_kernel<3, 64>), tg::wg_smem<64>(), 128);
    case 4:
      return big ? TQ_SUB((sub_wg_kernel<4, 128>), tg::wg_smem<128>(), 256)
                 : TQ_SUB((sub_wg_kernel<4, 64>), tg::wg_smem<64>(), 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TQ_SUB
}

// Phase 2: C (m x n, row stride ldc) -= Y (m x nb) W (nb x n), in place, on
// C tiles of tile_m x tile_n (kernels/panel_apply.py:sub_plan); any m, n,
// nb >= 1; passes 0 ("highest"), 1, 3 or 4.
extern "C" int tq_panel_sub(const float* y, const float* w, float* c, long long ldc, int m,
                            int n, int nb, int tile_m, int tile_n, int passes, void* stream) {
  return tq_sub_launch(y, 0, w, n, 0, c, ldc, 0, m, n, nb, 1, tile_m, tile_n, passes,
                       static_cast<cudaStream_t>(stream));
}
