// Batched GEQRT, the small route: the Householder QR of every matrix of a
// (B x m x n) stack whose transposed tile fits one CTA's shared memory, one
// CTA a matrix, several matrices an SM. kcols = min(m, n), inner block width
// ib; outputs packed (B x m x n: R on and above the diagonal, the
// reflectors below) and T (B x n x n). The input is read only.
//
// Replaces tileqr/drivers/batched.py:geqrt_batched (B16, one matrix per
// grid step) and :geqrt_batched_grouped (B11, G matrices per grid step) on
// the shapes that kernels/geqrt.py:batched_plan sends here (4 (m n + n^2 +
// m) <= 200 KiB, m < n included): qr_batched's 4096 x 128^2 at ib 32 (B11)
// and 128 (B16). The tall leaves of tsqr take geqrt_batched.cu's one-block
// kernel or its cluster route.
//
// The contract is the JAX body's (tileqr/kernels/geqrt.py:geqrt_in_refs) and
// the plain version's (tileqr_torch/kernels/geqrt.py): the tile held
// transposed (row c of `at` is column c of A); LARFG with no rescaling (sgn
// = +1 when alpha >= 0, beta = -sgn ||x||, tau = (beta - alpha) / beta, v =
// x (1 / (alpha - beta)); with no tail tau = 0, beta = alpha); rank-1
// updates confined to the ib-column block; one block-reflector apply to the
// columns right of the block; the off-diagonal T, -T1 (V1^T V2) T2. T is
// built by LAPACK's column recurrence (larft), T[0:j, j] = -tau_j T[0:j,
// 0:j] G[0:j, j] with G = V^T V, on sub-blocks of 32 columns, each joined
// to the ones before it by the same off-diagonal formula, instead of the
// JAX body's doubling: in exact arithmetic T is unique given V and tau, so
// the two agree to rounding (kernels/geqrt.py:t_from_gram is the recurrence
// in plain torch), at about ib^3/6 FMA a block instead of 2 log2(ib) ib^3.
//
// What bounds it on the H100: latency. A column waits for the one before it;
// the flops (about 2.6 M FMA a 128^2 matrix at ib 32) and bytes (128 KiB in
// and out) are small. The one-block kernel this replaces held one matrix an
// SM (128.5 KiB of shared memory, 1024 threads), spent five barriers of
// 1024 threads a column and built T by doubling (29 M FMA at ib 128).
//
// The design:
//   - Shared memory holds the transposed tile (row stride ld: a multiple of
//     4 floats, at least 132, with ld / 4 odd, so rows load as float4 and a
//     warp reading four rows of each of 8 columns hits distinct banks), the
//     T of the matrix packed as its upper triangle (kcols^2 / 2 floats),
//     each sub-block's G (496 floats) and two LARFG triples: 99-106 KiB at
//     128^2, two matrices an SM. No global workspace. The reflectors are
//     read in place from the packed rows (unit diagonal and zero triangle
//     implied by the loaders of the block's triangle rows, never stored).
//   - The column loop, one __syncthreads a column. After the barrier every
//     thread reads the column's LARFG (beta, tau, 1 / (alpha - beta)),
//     which the warp that last updated the column computed from its head
//     and tail and posted. Warp w owns the block's columns w, w + NW, ...
//     and takes four at a time, their dots with v (from the unscaled
//     column) and warp sums interleaved: right of the column the rank-1
//     update (and, for the next column, its tail norm and LARFG), left of
//     it, within its 32-column sub-block, G's entry. The previous column's
//     owner writes its scaled reflector first, now that no warp reads it
//     unscaled.
//   - T of each sub-block by rows after the column loop (row i needs only
//     row i and G), all rows at once; then each sub-block joined to the
//     ones before it by the block-apply routine below on the reflectors
//     alone and the off-diagonal product.
//   - The block apply and Z = V1^T V_b T_b for the off-diagonal T share one
//     warp routine: a warp takes 6 columns (8 / KQ past 32-wide blocks;
//     reflectors before the block or columns after it), lane k forms
//     W1(c, k) = sum_r A(r, c) V(r, s + k) (four rows a float4) and W2 =
//     W1 T_b with shuffles; a column after the block then takes A(r, c) -=
//     sum_k V(r, s + k) W2(c, k), each lane four consecutive rows. No
//     barrier inside: each warp writes only its own columns.
//   - The off-diagonal T, -T1 (Z T_b), in place top down in chunks.
// Arithmetic: IEEE fp32 FMA on CUDA cores (precision "highest", never TF32),
// no atomics, so reruns are bitwise equal; the sums run in other orders than
// the plain version's, which holds the kernel by tolerance.
#include <cuda_runtime.h>

namespace {
namespace small {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CB = 4;  // columns a warp reduces at once in the column loop

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// LARFG of a column from its head alpha and its tail's squared norm, by one
// warp, posted for every thread (lane 0 stores beta, tau, scale at slot)
__device__ __forceinline__ void larfg_post(float alpha, float tailsq, float* slot) {
  const float sgn = alpha >= 0.f ? 1.f : -1.f;
  const float nrm = sqrtf(alpha * alpha + tailsq);
  const bool has_tail = tailsq > 0.f;
  const float beta = has_tail ? -sgn * nrm : alpha;
  if ((threadIdx.x & 31) == 0) {
    slot[0] = beta;
    slot[1] = has_tail ? (beta - alpha) / beta : 0.f;
    slot[2] = has_tail ? 1.f / (alpha - beta) : 0.f;
  }
}

// the tile's row stride: a multiple of 4 floats >= m with ld / 4 odd, and
// at least 132 where m <= 128, so the column loop's four chunks of 32 rows
// lie in the row (rows m .. 127 zero)
__host__ __device__ inline int tile_ld(int m) {
  const int q = ((m < 128 ? 128 : m) + 3) / 4;
  return 4 * (q | 1);
}

// T's packed index: row i of the kc x kc upper triangle starts at
// i kc - i (i - 1) / 2, so (i, j), i <= j, sits at i (2 kc - i - 1) / 2 + j
__device__ __forceinline__ int tix(int i, int j, int kc) { return i * (2 * kc - i - 1) / 2 + j; }

// T is built a sub-block of TB columns at a time: each sub-block's T by
// rows from its own G (the strict upper triangle of V_q^T V_q, which the
// column loop's dots leave behind, column by column), then each sub-block
// joined to the ones before it in the block by -T1 (V1^T V2) T2, and each
// block to the blocks before it the same way. In exact arithmetic T is
// unique, so this is the T of the recurrence over the whole block.
constexpr int TB = 32;
constexpr int G_SUB = TB * (TB - 1) / 2;  // G floats of a sub-block

__host__ __device__ inline int g_floats(int ibm) { return ((ibm + TB - 1) / TB) * G_SUB; }

// shared floats: the tile (n x tile_ld(m)), T (kc (kc + 1) / 2), G
// (g_floats), two LARFG triples (beta, tau, scale; a column's posted by the
// warp that last updated it); kernels/geqrt.py:small_smem_bytes mirrors it
__host__ __device__ inline long long smem_floats(int m, int n, int ib) {
  const int kc = m < n ? m : n, ibm = ib < kc ? ib : kc;
  return (long long)n * tile_ld(m) + (long long)kc * (kc + 1) / 2 + g_floats(ibm) + 6;
}

// Stage timer, compiled only with TQ_CL_STAGES (utils/cluster_stages.py):
// thread 0 of CTA 0 adds each stage's globaltimer nanoseconds to shared
// counters and, at the end, to small_stage_ns: 0 the tile's load, 1 LARFG,
// 2 warp 0's dots and updates, 3 the column's barrier, 4 T's sub-blocks by
// rows, 5 T's sub-blocks joined, 6 the block apply and its off-diagonal T,
// 7 the stores
constexpr int SMALL_STAGES = 8;
#ifdef TQ_CL_STAGES
__device__ unsigned long long small_stage_ns[SMALL_STAGES];
__shared__ unsigned long long small_acc[SMALL_STAGES + 1];  // the last mark at [SMALL_STAGES]
#define SM_STAGE(i)                                                          \
  do {                                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                               \
      unsigned long long t_;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      if ((i) >= 0) small_acc[(i) < 0 ? 0 : (i)] += t_ - small_acc[SMALL_STAGES]; \
      small_acc[SMALL_STAGES] = t_;                                          \
    }                                                                        \
  } while (0)
#else
#define SM_STAGE(i) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// T of each TB-column sub-block of the block at s from its G (sub-block q's
// G(l, j), l < j, at g[q G_SUB + j (j - 1) / 2 + l], indices within the
// sub-block): row i of the sub-block, a thread each,
// T(s + i, s + j) = -tau_j sum_{l = i}^{j - 1} T(s + i, s + l) G(l, j); a
// row needs only itself and G, so every row of every sub-block runs at once
template <int NT>
__device__ void t_rows(float* tp, int kc, int s, int ibk, const float* g) {
  for (int ib = threadIdx.x; ib < ibk; ib += NT) {
    const int q = ib / TB, i = ib - q * TB, w = min(TB, ibk - q * TB), s0 = s + q * TB;
    const float* gq = g + q * G_SUB;
    float* ti = tp + tix(s0 + i, s0 + i, kc) - i;  // T(s0 + i, s0 + l) = ti[l], l >= i
    for (int j = i + 1; j < w; ++j) {
      const float* gj = gq + j * (j - 1) / 2;
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int l = i;
      for (; l + 8 <= j; l += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) a[u] = fmaf(ti[l + u], gj[l + u], a[u]);
      }
      for (; l < j; ++l) a[0] = fmaf(ti[l], gj[l], a[0]);
      ti[j] = -tp[tix(s0 + j, s0 + j, kc)] *
              (((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7])));
    }
  }
}

// One step's work on up to CB columns cq[q] of the block (-1: none) by one
// warp, for column jj (j = s + jj, LARFG beta/tau/scale, v and the
// unscaled column below row j in registers where SHORT): the previous
// column's reflector written; then each column's dot with v, the warp sums
// interleaved; right of jj the rank-1 update (and for jj + 1 its LARFG,
// posted), left of jj within its sub-block G's entry.
template <bool SHORT>
__device__ __forceinline__ void step_columns(const int (&cq)[CB], float* at, int ld, int m, int s,
                                             int jj, int sb, int u0, const float* x, float tau,
                                             float scale, float pbeta, float pscale,
                                             const float (&xr)[4], const float (&v)[4], float* gj,
                                             float* red) {
  const int lane = threadIdx.x & 31, j = s + jj;
#pragma unroll
  for (int q = 0; q < CB; ++q) {
    if (cq[q] >= 0 && cq[q] == jj - 1) {
      // the previous column's reflector, now that no warp reads it unscaled
      float* y = at + (s + cq[q]) * ld;
      for (int r = s + cq[q] + lane; r < m; r += 32) y[r] = r == s + cq[q] ? pbeta : y[r] * pscale;
    }
  }
  __syncwarp();
  float d[CB], yj[CB];
#pragma unroll
  for (int q = 0; q < CB; ++q) {
    const int cc = cq[q];
    d[q] = 0.f;
    yj[q] = 0.f;
    if (cc >= 0 && cc != jj && cc >= sb) {
      const float* y = at + (s + cc) * ld;
      yj[q] = y[j];
      if (SHORT) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u >= u0) d[q] = fmaf(y[lane + 32 * u], xr[u], d[q]);
      } else {
        for (int r = j + 1 + lane; r < m; r += 32) d[q] = fmaf(y[r], x[r], d[q]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < CB; ++q) d[q] += __shfl_xor_sync(FULL, d[q], o);
#pragma unroll
  for (int q = 0; q < CB; ++q) {
    const int cc = cq[q];
    if (cc < 0 || cc == jj || cc < sb) continue;
    const float dot = fmaf(scale, d[q], yj[q]);  // V(:, cc)^T v or A(:, cc)^T v
    if (cc < jj) {
      if (lane == 0) gj[cc] = dot;  // G(cc, jj)
      continue;
    }
    float* y = at + (s + cc) * ld;
    const float tw = tau * dot;
    if (SHORT) {
      // rows above j take tw * 0: unchanged, rows m .. 127 stay zero
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= u0) {
          float* yr = y + lane + 32 * u;
          *yr = *yr - tw * v[u];
        }
      }
    } else {
      if (lane == 0) y[j] = y[j] - tw;
      for (int r = j + 1 + lane; r < m; r += 32) y[r] = y[r] - tw * (x[r] * scale);
    }
    if (cc == jj + 1) {
      // the next column's LARFG, from its head and its tail's norm
      __syncwarp();
      const int c = s + cc;
      float t = 0.f;
      for (int r = c + 1 + lane; r < m; r += 32) t = fmaf(y[r], y[r], t);
      larfg_post(y[c], warp_sum(t), red + 3 * (c & 1));
    }
  }
}

// The column loop of the block [s, s + ibk), one __syncthreads a column.
// SHORT (m <= 128): lane l's rows l, l + 32, l + 64, l + 96 in registers,
// the chunks of 32 rows above row j's skipped. A column's dots start from
// the unscaled column (y(j) + scale sum_{r > j} y(r) x(r)). Left of the
// column, only its own TB sub-block's columns take a dot (G's entries).
// Warp w owns the block's columns w, w + NW, ..., CB at a time. (Warp 0
// on the step's longest chain, the previous and next columns, with the
// rest dealt to the other warps, ran slower on the H100: their extra
// batches outweighed it.)
template <int NT, bool SHORT>
__device__ void column_loop(float* at, int ld, int m, int s, int ibk, float* tp, int kc,
                            float* g, float* red) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float pbeta = 0.f, pscale = 0.f;  // the previous column's beta and scale
  for (int jj = 0; jj < ibk; ++jj) {
    const int j = s + jj, u0 = j >> 5;  // SHORT: chunks u < u0 lie above row j
    const float* x = at + j * ld;
    const float* lg = red + 3 * (j & 1);  // the column's LARFG, posted by its last updater
    const float beta = lg[0], tau = lg[1], scale = lg[2];
    float xr[4], v[4];  // SHORT: the unscaled column below row j, then v
    if (SHORT) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xr[u] = (u >= u0 && lane + 32 * u > j) ? x[lane + 32 * u] : 0.f;
        v[u] = lane + 32 * u == j ? 1.f : xr[u] * scale;
      }
    }
    if (tid == 0) tp[tix(j, j, kc)] = tau;
    SM_STAGE(1);
    // G(cc, jj) for the columns cc of jj's sub-block left of it
    const int sb = jj - jj % TB;
    float* gj = g + (jj / TB) * G_SUB + (jj - sb) * (jj - sb - 1) / 2 - sb;
    for (int c0 = warp; c0 < ibk; c0 += NW * CB) {
      int cq[CB];  // this warp's columns c0 + q NW
#pragma unroll
      for (int q = 0; q < CB; ++q) cq[q] = c0 + q * NW < ibk ? c0 + q * NW : -1;
      step_columns<SHORT>(cq, at, ld, m, s, jj, sb, u0, x, tau, scale, pbeta, pscale, xr, v, gj,
                          red);
    }
    SM_STAGE(2);
    pbeta = beta;
    pscale = scale;
    __syncthreads();
    SM_STAGE(3);
  }
  // the block's last reflector, then T of each sub-block by rows
  if (warp == (ibk - 1) % NW) {
    const int c = s + ibk - 1;
    float* y = at + c * ld;
    for (int r = c + lane; r < m; r += 32) y[r] = r == c ? pbeta : y[r] * pscale;
  }
  t_rows<NT>(tp, kc, s, ibk, g);
  __syncthreads();
  SM_STAGE(4);
}

// V(r, kk) of the block's reflector kk for a row r of the block's triangle
__device__ __forceinline__ float v_tri(const float* at, int ld, int r, int kk) {
  return r > kk ? at[kk * ld + r] : (r == kk ? 1.f : 0.f);
}

// One row r of W1 (see trailing): w[q][kq] += A(r, col q) V(r, s + k),
// k = lane + 32 kq; TRI: r lies in the block's triangle rows
template <int CG, int KQ, bool TRI>
__device__ __forceinline__ void w1_row(float (&w)[CG][KQ], const float* at, int ld, int r, int s,
                                       int ibk, const int (&col)[CG], int lane) {
  float xq[CG];
#pragma unroll
  for (int q = 0; q < CG; ++q) xq[q] = col[q] >= 0 ? at[col[q] * ld + r] : 0.f;
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq) {
    const int k = lane + 32 * kq;
    float vk = 0.f;
    if (k < ibk) vk = TRI ? v_tri(at, ld, r, s + k) : at[(s + k) * ld + r];
#pragma unroll
    for (int q = 0; q < CG; ++q) w[q][kq] = fmaf(xq[q], vk, w[q][kq]);
  }
}

// Rows r .. r + 3 of W1 below the triangle, a float4 each (r % 4 == 0)
template <int CG, int KQ>
__device__ __forceinline__ void w1_rows4(float (&w)[CG][KQ], const float* at, int ld, int r,
                                         int s, int ibk, const int (&col)[CG], int lane) {
  float4 xq[CG];
#pragma unroll
  for (int q = 0; q < CG; ++q)
    xq[q] = col[q] >= 0 ? ld4(at + col[q] * ld + r) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq) {
    const int k = lane + 32 * kq;
    const float4 vk = k < ibk ? ld4(at + (s + k) * ld + r) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      w[q][kq] = fmaf(xq[q].x, vk.x, w[q][kq]);
      w[q][kq] = fmaf(xq[q].y, vk.y, w[q][kq]);
      w[q][kq] = fmaf(xq[q].z, vk.z, w[q][kq]);
      w[q][kq] = fmaf(xq[q].w, vk.w, w[q][kq]);
    }
  }
}

// The apply (see trailing) on rows [r0, min(r0 + 32, rend)), a row a lane,
// of the columns col q >= e: A(r, c) -= sum_k V(r, s + k) W2(c, k), k
// ascending; TRI: the rows lie in the block's triangle
template <int CG, int KQ, bool TRI>
__device__ __forceinline__ void apply_rows(float* at, int ld, int r0, int rend, int s, int e,
                                           int ibk, const int (&col)[CG],
                                           const float (&w2)[CG][KQ], int lane) {
  const int r = r0 + lane;
  const bool ok = r < rend;
  float acc[CG];
#pragma unroll
  for (int q = 0; q < CG; ++q) acc[q] = (col[q] >= e && ok) ? at[col[q] * ld + r] : 0.f;
#pragma unroll
  for (int lq = 0; lq < KQ; ++lq) {
    for (int l2 = 0; l2 < 32 && 32 * lq + l2 < ibk; ++l2) {
      const int kk = s + 32 * lq + l2;
      float wk[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q) wk[q] = __shfl_sync(FULL, w2[q][lq], l2);
      const float vr = !ok ? 0.f : (TRI ? v_tri(at, ld, r, kk) : at[kk * ld + r]);
#pragma unroll
      for (int q = 0; q < CG; ++q) acc[q] = fmaf(-vr, wk[q], acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < CG; ++q)
    if (col[q] >= e && ok) at[col[q] * ld + r] = acc[q];
}

// The same on rows [r0, min(r0 + 128, rend)) below the triangle, four
// consecutive rows a lane as a float4 (r0 % 4 == 0, rend - r0 % 4 == 0)
template <int CG, int KQ>
__device__ __forceinline__ void apply_rows4(float* at, int ld, int r0, int rend, int s, int e,
                                            int ibk, const int (&col)[CG],
                                            const float (&w2)[CG][KQ], int lane) {
  const int r = r0 + 4 * lane;
  const bool ok = r < rend;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc[CG];
#pragma unroll
  for (int q = 0; q < CG; ++q) acc[q] = (col[q] >= e && ok) ? ld4(at + col[q] * ld + r) : zero;
#pragma unroll
  for (int lq = 0; lq < KQ; ++lq) {
    for (int l2 = 0; l2 < 32 && 32 * lq + l2 < ibk; ++l2) {
      const int kk = s + 32 * lq + l2;
      float wk[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q) wk[q] = __shfl_sync(FULL, w2[q][lq], l2);
      const float4 vr = ok ? ld4(at + kk * ld + r) : zero;
#pragma unroll
      for (int q = 0; q < CG; ++q) {
        acc[q].x = fmaf(-vr.x, wk[q], acc[q].x);
        acc[q].y = fmaf(-vr.y, wk[q], acc[q].y);
        acc[q].z = fmaf(-vr.z, wk[q], acc[q].z);
        acc[q].w = fmaf(-vr.w, wk[q], acc[q].w);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CG; ++q)
    if (col[q] >= e && ok) st4(at + col[q] * ld + r, acc[q]);
}

// After the block [s, e = s + ibk): for the virtual columns p0 .. s - 1 (the
// reflectors p0 .. s - 1 before the block) and, with REST, s .. s + n - e - 1
// (the columns e .. n - 1 after it), CG of them a warp at a time, lane k +
// 32 q of the block's reflector index k:
//   W1(c, k) = sum_{r >= s} A(r, c) V(r, s + k),  W2 = W1 T_b;
// a reflector c < s stores W2 = (Z T_b)(c, k) at T(c, s + k); a column c >= e
// takes A(r, c) -= sum_k V(r, s + k) W2(c, k), and column e, the next block's
// first, posts its LARFG. Rows: the triangle [s, e) with the unit
// diagonal and zeros implied, [e, r4) a row at a time up to a multiple of
// 4, [r4, m4) four at a time, [m4, m) a row at a time.
template <int NW, int KQ, bool REST>
__device__ void trailing(float* at, int ld, int m, int n, int p0, int s, int ibk, int kc,
                         float* tp, float* red) {
  // columns a warp at a time: 6 at one reflector index a lane (the 96
  // columns of each 128^2 block at ib 32 make two rounds of 8 warps)
  constexpr int CG = KQ == 1 ? 6 : 8 / KQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = s + ibk, total = s + (REST ? n - e : 0);
  const int r4 = min((e + 3) & ~3, m), m4 = r4 + ((m - r4) & ~3);
  for (int g0 = p0 + warp * CG; g0 < total; g0 += NW * CG) {
    int col[CG];
    bool after = false;
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      const int vc = g0 + q;
      col[q] = vc < s ? vc : (vc < total ? e + vc - s : -1);
      after = after || col[q] >= e;
    }
    float w[CG][KQ];
#pragma unroll
    for (int q = 0; q < CG; ++q)
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) w[q][kq] = 0.f;
    for (int r = s; r < e; ++r) w1_row<CG, KQ, true>(w, at, ld, r, s, ibk, col, lane);
    for (int r = e; r < r4; ++r) w1_row<CG, KQ, false>(w, at, ld, r, s, ibk, col, lane);
    for (int r = r4; r < m4; r += 4) w1_rows4<CG, KQ>(w, at, ld, r, s, ibk, col, lane);
    for (int r = m4; r < m; ++r) w1_row<CG, KQ, false>(w, at, ld, r, s, ibk, col, lane);
    // W2 = W1 T_b, T_b(l, k) upper triangular
    float w2[CG][KQ];
#pragma unroll
    for (int q = 0; q < CG; ++q)
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) w2[q][kq] = 0.f;
#pragma unroll
    for (int lq = 0; lq < KQ; ++lq) {
      for (int l2 = 0; l2 < 32 && 32 * lq + l2 < ibk; ++l2) {
        const int l = 32 * lq + l2;
        float wl[CG];
#pragma unroll
        for (int q = 0; q < CG; ++q) wl[q] = __shfl_sync(FULL, w[q][lq], l2);
        const float* tl = tp + tix(s + l, s + l, kc) - l;  // T(s + l, s + k) = tl[k], k >= l
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          const int k = lane + 32 * kq;
          if (k >= l && k < ibk) {
            const float t = tl[k];
#pragma unroll
            for (int q = 0; q < CG; ++q) w2[q][kq] = fmaf(wl[q], t, w2[q][kq]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CG; ++q) {
      if (col[q] >= 0 && col[q] < s) {
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          const int k = lane + 32 * kq;
          if (k < ibk) tp[tix(col[q], s + k, kc)] = w2[q][kq];
        }
      }
    }
    if constexpr (!REST) continue;
    if (!after) continue;
    for (int r0 = s; r0 < e; r0 += 32)
      apply_rows<CG, KQ, true>(at, ld, r0, e, s, e, ibk, col, w2, lane);
    for (int r0 = e; r0 < r4; r0 += 32)
      apply_rows<CG, KQ, false>(at, ld, r0, r4, s, e, ibk, col, w2, lane);
    for (int r0 = r4; r0 < m4; r0 += 128)
      apply_rows4<CG, KQ>(at, ld, r0, m4, s, e, ibk, col, w2, lane);
    for (int r0 = m4; r0 < m; r0 += 32)
      apply_rows<CG, KQ, false>(at, ld, r0, m, s, e, ibk, col, w2, lane);
    if (e < kc && g0 <= s && s < g0 + CG) {
      // column e (virtual column s) starts the next block: its LARFG
      __syncwarp();
      const float* y = at + e * ld;
      float t = 0.f;
      for (int r = e + 1 + lane; r < m; r += 32) t = fmaf(y[r], y[r], t);
      larfg_post(y[e], warp_sum(t), red + 3 * (e & 1));
    }
  }
}

// The off-diagonal T of the block [s, s + ibk) against the reflectors
// [p0, s) before it: T(i, s + k) = -sum_{l=i}^{s-1} T(i, l) M(l, k), p0 <= i
// < s, with M = Z T_b at T(l, s + k). In place, top down in chunks of NT R
// outputs (row-major): output (i, k) reads M's column k from row i down,
// so a chunk's writes destroy only what it and earlier chunks read.
template <int NT>
__device__ void offdiag(float* tp, int kc, int p0, int s, int ibk) {
  constexpr int R = 8;
  const int outs = (s - p0) * ibk;
  for (int o0 = 0; o0 < outs; o0 += NT * R) {
    float res[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int o = o0 + u * NT + threadIdx.x;
      res[u] = 0.f;
      if (o < outs) {
        const int i = p0 + o / ibk, k = o - (i - p0) * ibk;
        const float* ti = tp + tix(i, i, kc) - i;  // T(i, l) = ti[l]
        int p = tix(i, s + k, kc);                   // M(l, k), l = i
        float a0 = 0.f, a1 = 0.f;
        int l = i;
        for (; l + 2 <= s; l += 2) {
          a0 = fmaf(ti[l], tp[p], a0);
          p += kc - l - 1;
          a1 = fmaf(ti[l + 1], tp[p], a1);
          p += kc - l - 2;
        }
        if (l < s) a0 = fmaf(ti[l], tp[p], a0);
        res[u] = -(a0 + a1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int o = o0 + u * NT + threadIdx.x;
      if (o < outs) {
        const int i = p0 + o / ibk, k = o - (i - p0) * ibk;
        tp[tix(i, s + k, kc)] = res[u];
      }
    }
    __syncthreads();
  }
}

// ONE: the matrix is one block (m >= n, ib >= n): no block apply and no
// off-diagonal T against earlier blocks, so 512 threads fit two CTAs an SM
// in registers; up to 256 threads, two CTAs an SM too
template <int NT, bool SHORT, bool ONE>
__global__ void __launch_bounds__(NT, ONE || NT <= 256 ? 2 : 1)
geqrt_small_kernel(const float* __restrict__ a, float* __restrict__ packed,
                   float* __restrict__ t_out, int m, int n, int ib) {
  extern __shared__ __align__(16) float sh[];
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = min(m, n), ibm = min(ib, kc), ld = tile_ld(m);
  float* at = sh;
  float* tp = at + n * ld;
  float* g = tp + kc * (kc + 1) / 2;
  float* red = g + g_floats(ibm);
  const long long mn = (long long)m * n;
  const float* src = a + blockIdx.x * mn;
#ifdef TQ_CL_STAGES
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < SMALL_STAGES; ++i) small_acc[i] = 0;
#endif
  SM_STAGE(-1);

  // the tile, transposed: a warp a row, 4 rows of 128 columns in flight
  for (int c0 = 0; c0 < n; c0 += 128) {
    for (int r0 = warp; r0 < m; r0 += 4 * NW) {
      float v[4][4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + h * NW, c = c0 + lane + 32 * q;
          v[h][q] = (r < m && c < n) ? src[(long long)r * n + c] : 0.f;
        }
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + h * NW, c = c0 + lane + 32 * q;
          if (r < m && c < n) at[c * ld + r] = v[h][q];
        }
    }
  }
  if (SHORT)  // rows m .. 127 of every column: zero, the column loop reads them
    for (int c = warp; c < n; c += NW)
      for (int r = m + lane; r < 128; r += 32) at[c * ld + r] = 0.f;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int r = 1 + lane; r < m; r += 32) t = fmaf(at[r], at[r], t);
    larfg_post(at[0], warp_sum(t), red);
  }
  __syncthreads();
  SM_STAGE(0);

  const int kq = (ibm + 31) / 32;
  for (int s = 0; s < kc; s += ib) {
    const int ibk = min(ib, kc - s);
    column_loop<NT, SHORT>(at, ld, m, s, ibk, tp, kc, g, red);
    // the block's T: each sub-block joined to the ones before it, every
    // sub-block's Z T_q at once (they write disjoint parts of T), then the
    // off-diagonal products in order (each needs the ones before it)
    if (ibk > TB) {
      for (int sq = s + TB; sq < s + ibk; sq += TB)
        trailing<NW, 1, false>(at, ld, m, n, s, sq, min(TB, s + ibk - sq), kc, tp, red);
      __syncthreads();
      for (int sq = s + TB; sq < s + ibk; sq += TB) offdiag<NT>(tp, kc, s, sq, min(TB, s + ibk - sq));
    }
    SM_STAGE(5);
    if (!ONE && (s > 0 || s + ibk < n)) {
      if (kq <= 1) trailing<NW, 1, true>(at, ld, m, n, 0, s, ibk, kc, tp, red);
      else if (kq <= 2) trailing<NW, 2, true>(at, ld, m, n, 0, s, ibk, kc, tp, red);
      else if (kq <= 4) trailing<NW, 4, true>(at, ld, m, n, 0, s, ibk, kc, tp, red);
      else trailing<NW, 8, true>(at, ld, m, n, 0, s, ibk, kc, tp, red);
      __syncthreads();
      if (s > 0) offdiag<NT>(tp, kc, 0, s, ibk);
    }
    SM_STAGE(6);
  }

  float* pk = packed + blockIdx.x * mn;
  for (int r = warp; r < m; r += NW)
    for (int c = lane; c < n; c += 32) pk[(long long)r * n + c] = at[c * ld + r];
  float* t = t_out + blockIdx.x * (long long)n * n;
  for (int i = warp; i < n; i += NW)
    for (int j = lane; j < n; j += 32)
      t[(long long)i * n + j] = (i <= j && j < kc) ? tp[tix(i, j, kc)] : 0.f;
  SM_STAGE(7);
#ifdef TQ_CL_STAGES
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < SMALL_STAGES; ++i) small_stage_ns[i] += small_acc[i];
#endif
}

template <int NT, bool SHORT, bool ONE>
int launch(const float* a, float* packed, float* t, int batch, int m, int n, int ib, size_t smem,
           cudaStream_t stream) {
  auto kernel = geqrt_small_kernel<NT, SHORT, ONE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<batch, NT, smem, stream>>>(a, packed, t, m, n, ib);
  return (int)cudaGetLastError();
}

// the one-block kernel where the matrix is one block and NT >= 256
template <int NT>
int launch_nt(const float* a, float* packed, float* t, int batch, int m, int n, int ib,
              size_t smem, cudaStream_t stream) {
  const bool one = NT >= 256 && m >= n && ib >= n, s = m <= 128;
  if constexpr (NT >= 256) {
    if (one)
      return s ? launch<NT, true, true>(a, packed, t, batch, m, n, ib, smem, stream)
               : launch<NT, false, true>(a, packed, t, batch, m, n, ib, smem, stream);
  }
  return s ? launch<NT, true, false>(a, packed, t, batch, m, n, ib, smem, stream)
           : launch<NT, false, false>(a, packed, t, batch, m, n, ib, smem, stream);
}

template <int NT, bool SHORT, bool ONE>
int per_sm(int m, int n, int ib) {
  const size_t smem = sizeof(float) * smem_floats(m, n, ib);
  auto kernel = geqrt_small_kernel<NT, SHORT, ONE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <int NT>
int per_sm_nt(int m, int n, int ib) {
  const bool one = NT >= 256 && m >= n && ib >= n, s = m <= 128;
  if constexpr (NT >= 256) {
    if (one) return s ? per_sm<NT, true, true>(m, n, ib) : per_sm<NT, false, true>(m, n, ib);
  }
  return s ? per_sm<NT, true, false>(m, n, ib) : per_sm<NT, false, false>(m, n, ib);
}

}  // namespace small
}  // namespace

// The small route: `batch` CTAs of `threads` (128, 256 or 512) threads, one
// a matrix, with smem = kernels/geqrt.py:small_smem_bytes(m, n, ib) bytes of
// shared memory each; a launch whose bytes disagree with the layout is
// refused.
extern "C" int tq_geqrt_small(const float* a, float* packed, float* t, int batch, int m, int n,
                              int ib, int threads, long long smem, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || ib < 1 ||
      smem != (long long)sizeof(float) * small::smem_floats(m, n, ib))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads == 128) return small::launch_nt<128>(a, packed, t, batch, m, n, ib, smem, st);
  if (threads == 256) return small::launch_nt<256>(a, packed, t, batch, m, n, ib, smem, st);
  if (threads == 512) return small::launch_nt<512>(a, packed, t, batch, m, n, ib, smem, st);
  return (int)cudaErrorInvalidValue;
}

// Matrices an SM holds at once on the small route at `threads` threads a
// CTA, or the negated CUDA error (utils/plan_sweep.py prints it).
extern "C" int tq_geqrt_small_per_sm(int m, int n, int ib, int threads) {
  if (threads == 128) return small::per_sm_nt<128>(m, n, ib);
  if (threads == 256) return small::per_sm_nt<256>(m, n, ib);
  if (threads == 512) return small::per_sm_nt<512>(m, n, ib);
  return -(int)cudaErrorInvalidValue;
}

#ifdef TQ_CL_STAGES
// copy the small route's stage nanoseconds (8 values) to `out` and zero them
extern "C" int tq_small_stages(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, small::small_stage_ns, sizeof(small::small_stage_ns));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[small::SMALL_STAGES] = {};
  return (int)cudaMemcpyToSymbol(small::small_stage_ns, zero, sizeof(zero));
}
#endif
