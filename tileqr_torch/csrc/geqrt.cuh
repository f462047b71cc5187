// GEQRT of one stacked couple, as a device routine for one thread block.
//
// Replaces tileqr/kernels/geqrt.py:geqrt_in_refs, the Householder column
// loop inside the TPU kernels, for the kernel that runs it on ONE block:
// the batched GEQRT's one-block kernel (geqrt_batched.cu: the tsqr leaves).
// K1, K2 and TTQRT (panel.cu, chain.cu, ttqrt.cu) run the same contract on
// a thread-block cluster (geqrt_cluster.cuh), the batched GEQRT's small
// route (geqrt_small.cu) on one CTA a matrix. Contract, step by step as the JAX body
// (and its plain torch version, tileqr_torch/kernels/geqrt.py):
//   - the couple is held transposed: row j of `at` (n rows of m floats) is
//     column j of the (m x n) couple [R; B];
//   - LARFG with no rescaling: sgn = +1 when alpha >= 0, beta = -sgn*||x||,
//     tau = (beta-alpha)/beta, v = x*(1/(alpha-beta)); with no tail below
//     the diagonal, tau = 0 and beta = alpha;
//   - rank-1 updates confined to the current ib-column block;
//   - after each block's column loop, its T from the gram G = Vb^T Vb by the
//     doubling recurrence T <- T - T (G o M) T;
//   - one block-reflector apply to the columns right of the block;
//   - the off-diagonal T, -T1 (V1^T V2) T2.
//   `tt` receives T transposed, as in the JAX body.
//
// What bounds it on the H100: latency. Each column depends on the one
// before it, so the loop is a chain of block-wide reductions and barriers
// (two per column) on ONE SM; a couple larger than one SM's 227 KB of
// shared memory is streamed from L2.
// What the design does about it: one block of 1024 threads; the couple and
// small work matrices live in a global workspace that stays in the 50 MB
// L2; shared memory holds the current reflector v, the reduction partials
// and the tiles of the block-wide fp32 FMA GEMM below. In the rank-1 phase
// each warp owns whole columns, so it needs no barrier inside. Arithmetic
// is IEEE fp32 FMA on CUDA cores (precision "highest", never TF32).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int GEQRT_THREADS = 1024;

// Matrix operand of the block GEMM: element (i, j) = p[i*rs + j*cs], with
// an optional reflector mask applied on the fly (the unit diagonal and the
// zero triangle of V are never stored).
//   mode 0: plain
//   mode 1: V    -- 1 where i == j + d, p where i > j + d, 0 elsewhere
//   mode 2: V^T  -- 1 where j == i + d, p where j > i + d, 0 elsewhere
struct Mat {
  const float* p;
  long long rs, cs;
  int mode, d;
};

__device__ __forceinline__ Mat mat(const float* p, long long rs, long long cs,
                                   int mode = 0, int d = 0) {
  Mat m;
  m.p = p; m.rs = rs; m.cs = cs; m.mode = mode; m.d = d;
  return m;
}

__device__ __forceinline__ float mat_at(const Mat& a, int i, int j) {
  if (a.mode == 1) {
    if (i == j + a.d) return 1.f;
    if (i < j + a.d) return 0.f;
  } else if (a.mode == 2) {
    if (j == i + a.d) return 1.f;
    if (j < i + a.d) return 0.f;
  }
  return a.p[i * a.rs + j * a.cs];
}

// K terms a thread sums in sequence before adding the partial to its total:
// the contractions over a tall couple's rows (K = m, up to 131072 in a TSQR
// leaf) then carry ~(sqrt(256) + sqrt(K/256)) eps of rounding, not
// sqrt(K) eps. For K <= 256 the result is the plain sequential sum, bitwise.
constexpr int GEMM_KCHUNK = 256;

// C (M x N, row stride ldc) = [C +] alpha * A (M x K) B (K x N), by the
// whole block (blockDim.x == GEQRT_THREADS). C must not overlap A or B.
// 64x64 output tiles, K in steps of 16, four outputs per thread.
__device__ void block_gemm(int M, int N, int K, Mat A, Mat B, float* C,
                           long long ldc, float alpha, bool accumulate) {
  __shared__ float As[64][17];
  __shared__ float Bs[16][65];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  for (int i0 = 0; i0 < M; i0 += 64) {
    for (int j0 = 0; j0 < N; j0 += 64) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float tot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < K; k0 += 16) {
        {
          const int i = tid >> 4, kk = tid & 15;
          const int gi = i0 + i, gk = k0 + kk;
          As[i][kk] = (gi < M && gk < K) ? mat_at(A, gi, gk) : 0.f;
        }
        {
          const int kk = tid >> 6, j = tid & 63;
          const int gk = k0 + kk, gj = j0 + j;
          Bs[kk][j] = (gk < K && gj < N) ? mat_at(B, gk, gj) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const float a = As[ty][kk];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(a, Bs[kk][tx + 16 * q], acc[q]);
        }
        __syncthreads();
        if ((k0 + 16) % GEMM_KCHUNK == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            tot[q] += acc[q];
            acc[q] = 0.f;
          }
        }
      }
      const int gi = i0 + ty;
      if (gi < M) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gj = j0 + tx + 16 * q;
          const float sum = tot[q] + acc[q];
          if (gj < N) {
            float* c = C + gi * ldc + gj;
            *c = accumulate ? *c + alpha * sum : alpha * sum;
          }
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, returned to every thread. red: 33 floats of shared.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// Floats of workspace geqrt_couple needs beyond `at` and `tt`.
__host__ __device__ inline long long geqrt_ws_floats(int n, int ib) {
  return 5LL * ib * ib + 4LL * n * ib;
}

// Factor the couple held transposed in `at` (n x m, row stride m) in place,
// eliminating its first kcols columns (kcols <= min(m, n); the block apply
// still reaches all n); `tt` (n x n, row stride n) must be zero on entry and
// receives T^T. ws: geqrt_ws_floats(n, ib) floats of global scratch. v: m
// floats, shared memory where they fit (global otherwise). `at` and `tt`
// may lie in shared or global memory. Called by all GEQRT_THREADS threads
// of the block.
__device__ void geqrt_couple(float* at, int n, int m, float* tt, int ib,
                             float* ws, float* v, int kcols) {
  __shared__ float red[33];
  __shared__ float sc[3];
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = bd >> 5;

  float* G = ws;
  float* GM = G + ib * ib;
  float* P = GM + ib * ib;
  float* Q = P + ib * ib;
  float* TTB = Q + ib * ib;
  float* W1 = TTB + ib * ib;
  float* W2 = W1 + (long long)n * ib;
  float* ZT = W2 + (long long)n * ib;
  float* M2 = ZT + (long long)ib * n;

  for (int s = 0; s < kcols; s += ib) {
    const int ibk = min(ib, kcols - s);

    // ---- column loop: LARFG + rank-1 updates inside the block ----
    for (int jj = 0; jj < ibk; ++jj) {
      const int j = s + jj;
      float* x = at + (long long)j * m;
      float part = 0.f;
      for (int r = j + 1 + tid; r < m; r += bd) part = fmaf(x[r], x[r], part);
      const float tailsq = block_sum(part, red);
      if (tid == 0) {
        const float alpha = x[j];
        const float sgn = alpha >= 0.f ? 1.f : -1.f;
        const float nrm = sqrtf(alpha * alpha + tailsq);
        const bool has_tail = tailsq > 0.f;
        const float beta = has_tail ? -sgn * nrm : alpha;
        sc[0] = beta;
        sc[1] = has_tail ? (beta - alpha) / beta : 0.f;
        sc[2] = has_tail ? 1.f / (alpha - beta) : 0.f;
        tt[(long long)j * n + j] = sc[1];
      }
      __syncthreads();
      const float beta = sc[0], tau = sc[1], scale = sc[2];
      for (int r = tid; r < m; r += bd) {
        const float xv = x[r];
        v[r] = (r == j) ? 1.f : (r > j ? xv * scale : 0.f);
        if (r == j) x[r] = beta;
        else if (r > j) x[r] = xv * scale;
      }
      __syncthreads();
      for (int c = j + 1 + warp; c < s + ibk; c += nwarps) {
        float* y = at + (long long)c * m;
        float w = 0.f;
        for (int r = j + lane; r < m; r += 32) w = fmaf(y[r], v[r], w);
        const float tw = tau * warp_sum(w);
        for (int r = j + lane; r < m; r += 32) y[r] = y[r] - tw * v[r];
      }
      __syncthreads();
    }

    // V_b^T (ibk x m) and V_b (m x ibk), read from the packed rows of `at`
    const Mat vtb = mat(at + (long long)s * m, m, 1, 2, s);
    const Mat vb = mat(at + (long long)s * m, 1, m, 1, s);

    // ---- block T by doubling, transposed (TTB = T_b^T) ----
    block_gemm(ibk, ibk, m, vtb, vb, G, ib, 1.f, false);
    for (int idx = tid; idx < ibk * ibk; idx += bd) {
      const int a = idx / ibk, b = idx % ibk;
      TTB[a * ib + b] = (a == b) ? tt[(long long)(s + a) * n + s + a] : 0.f;
    }
    __syncthreads();
    for (int bsz = 1; bsz < ibk; bsz *= 2) {
      for (int idx = tid; idx < ibk * ibk; idx += bd) {
        const int a = idx / ibk, b = idx % ibk;
        const bool on = ((b / bsz) % 2 == 0) && (a / bsz == b / bsz + 1);
        GM[a * ib + b] = on ? G[a * ib + b] : 0.f;
      }
      __syncthreads();
      block_gemm(ibk, ibk, ibk, mat(GM, ib, 1), mat(TTB, ib, 1), P, ib, 1.f, false);
      block_gemm(ibk, ibk, ibk, mat(TTB, ib, 1), mat(P, ib, 1), Q, ib, 1.f, false);
      for (int idx = tid; idx < ibk * ibk; idx += bd) {
        const int a = idx / ibk, b = idx % ibk;
        TTB[a * ib + b] = TTB[a * ib + b] - Q[a * ib + b];
      }
      __syncthreads();
    }
    for (int idx = tid; idx < ibk * ibk; idx += bd) {
      const int a = idx / ibk, b = idx % ibk;
      tt[(long long)(s + a) * n + s + b] = TTB[a * ib + b];
    }
    __syncthreads();

    // ---- A_rest <- A_rest - V_b T_b^T V_b^T A_rest ----
    if (s + ibk < n) {
      const int nr = n - s - ibk;
      float* rest = at + (long long)(s + ibk) * m;
      block_gemm(nr, ibk, m, mat(rest, m, 1), vb, W1, ib, 1.f, false);
      block_gemm(nr, ibk, ibk, mat(W1, ib, 1), mat(TTB, 1, ib), W2, ib, 1.f, false);
      block_gemm(nr, m, ibk, mat(W2, ib, 1), vtb, rest, m, -1.f, true);
    }

    // ---- off-diagonal T[0:s, block] = -T1 (V1^T V_b) T_b, transposed ----
    if (s > 0) {
      block_gemm(ibk, s, m, vtb, mat(at, 1, m, 1, 0), ZT, n, 1.f, false);
      block_gemm(ibk, s, s, mat(ZT, n, 1), mat(tt, n, 1), M2, n, 1.f, false);
      block_gemm(ibk, s, ibk, mat(TTB, ib, 1), mat(M2, n, 1), tt + (long long)s * n, n,
                 -1.f, false);
    }
  }
}

}  // namespace
