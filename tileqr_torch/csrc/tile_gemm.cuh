// Block-level tiled products D = A B on the H100, the building blocks of
// the whole-panel apply's phase 2 (panel_apply.cu: tq_panel_sub, B7b and
// phase 2 of B6/B7), of the strip apply K3/K4 (strip.cu: its three
// stages) and of the batched GEQRT's tall route (geqrt_tall.cu: its
// updates and T joins, f32_tile only). One routine a route:
//
//   f32_tile<BM, BN, A_KMAJ>  ("highest"): 256 threads, a BM x BN tile of
//       D (128 x 128, 64 x 64 or 128 x 64), (BM/16) x (BN/16) entries a
//       thread in registers; A and B arrive 16 deep through a 3-stage
//       cp.async ring. Every D entry is ONE fmaf chain over k ascending
//       from k0 (acc = fmaf(A(i, k), B(k, j), acc), acc from 0): the sum
//       order of the earlier one-slab-per-block kernels, so their bits.
//       IEEE fp32 FMA on the CUDA cores, never TF32.
//   wg_tile<P, BM, A_KMAJ>    (the P-pass split product of bx_mma.cuh):
//       BM / 64 warpgroups, a BM x 64 tile of D, each warpgroup 64 rows by
//       wgmma m64n64k16 (bf16 in, fp32 accumulators). Stages of 32 k of A
//       and B arrive in fp32 by cp.async, three stages ahead in a 4-deep
//       ring; each element is split ONCE a stage into bf16 hi/lo by round
//       to nearest and stored K-major (8 x 8 core matrices, no swizzle),
//       double-buffered, so the next stage's split overlaps this stage's
//       asynchronous products. The passes run in _dot_bx's order into
//       separate accumulators (hh, then hl and lh into one, then ll); a D
//       entry is hh + cross (+ ll).
//
// A (M x K rows [k0, k1)) is read K-major (element (i, k) at p[i ld + k]:
// Y, T2) or M-major (at p[k ld + i]: V2^T, op(T) = T^T); B (K x N) is
// always N-major (p[k ld + j]). With `unit`, A is the unit lower triangle
// of what is stored: the element at stored row r, column c counts as 1
// when r == c, as itself when r > c, else 0 (V = unit_lower(vkk) or V^T,
// with no materialised copy). Rows, columns and k past the extents are
// zero-filled (exact: a zero term leaves an fmaf chain's sum unchanged).
// `vec`: 16-byte copies (16-byte aligned operands, leading dimensions and
// the extents that run along memory multiples of 4), else 4-byte ones.
// The result reaches the epilogue (Store, Sub below) once for every i <
// M, j < N of the tile. A routine synchronises the block before and after itself, so a
// block may chain calls on the same shared memory and read in one call
// what the epilogue of the previous one wrote to global memory.
#pragma once
#include <stdint.h>

#include "bx_mma.cuh"

namespace tg {

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

constexpr unsigned CORE_LBO = 128, CORE_SBO = 256;  // bytes: along K, between row groups

// byte offset of the 8 consecutive k (kg-th group of 8 in a 32-deep
// stage) of operand row r in a split stage's K-major layout (chunk_bytes:
// one k16 chunk of the operand)
__device__ __forceinline__ int core_off(int r, int kg, int chunk_bytes) {
  return (kg >> 1) * chunk_bytes + (r >> 3) * CORE_SBO + (kg & 1) * CORE_LBO + (r & 7) * 16;
}

// ---- the shared pieces of both routines ----

struct Opnd {
  const float* p;
  long long ld;
};

// 4 floats that run along memory from src into dst (16-byte aligned shared
// memory), of which the first `left` exist (none when left <= 0): one
// 16-byte copy when vec (then all four exist or none), else four 4-byte
// copies; missing ones are zero-filled (`any` is a valid address to name)
__device__ __forceinline__ void copy4(float* dst, const float* src, int left, bool vec,
                                      const float* any) {
  if (vec) {
    cp_async16(dst, left > 0 ? src : any, left > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < left ? src + e : any, e < left);
  }
}

// The epilogues: `pre(i, j)` reads what D's entry (i, j) updates (all of a
// tile's reads are issued before its first write), then `(i, j, d, old)`
// writes. Store: p(i, j) = d. Sub: p(i, j) = old - d, C -= D in place.
struct Store {
  float* p;
  long long ld;
  __device__ __forceinline__ float pre(int, int) const { return 0.f; }
  __device__ __forceinline__ void operator()(int i, int j, float d, float) const {
    p[(long long)i * ld + j] = d;
  }
};
struct Sub {
  float* p;
  long long ld;
  __device__ __forceinline__ float pre(int i, int j) const { return p[(long long)i * ld + j]; }
  __device__ __forceinline__ void operator()(int i, int j, float d, float old) const {
    p[(long long)i * ld + j] = old - d;
  }
};

// the unit-lower mask of the A element (i, k): stored at row r, column c
__device__ __forceinline__ float unit_of(float x, int r, int c) {
  return r == c ? 1.f : (r > c ? x : 0.f);
}

// ---- fp32 on the CUDA cores ----

constexpr int F_THREADS = 256, FK = 16, FSTAGES = 3, FA_PAD = 4;

template <int BM, bool A_KMAJ>
__host__ __device__ constexpr int f32_a_floats() {
  return A_KMAJ ? BM * (FK + FA_PAD) : FK * BM;
}

// shared bytes of f32_tile<BM, BN, A_KMAJ>
template <int BM, int BN, bool A_KMAJ>
__host__ __device__ constexpr size_t f32_smem() {
  return sizeof(float) * FSTAGES * (f32_a_floats<BM, A_KMAJ>() + FK * BN);
}

// D rows i0.., columns j0.. (a BM x BN tile) over k in [k0, k1). Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows 64 (r / 4) + 4 ty + r % 4 and
// columns 64 (q / 4) + 4 tx + q % 4. The A stage is (FK + 4)-padded rows
// of k when A_KMAJ (read 4 k at a time), else rows of i. KC > 0 (a
// multiple of FK): each D entry is instead the sum, in order, of the fmaf
// chains over consecutive runs of KC k from k0 (geqrt_tall.cu's
// contractions over tall rows keep geqrt.cuh's GEMM_KCHUNK error bound);
// KC = 0 compiles to the single chain above.
template <int BM, int BN, bool A_KMAJ, int KC = 0, class Epi>
__device__ __forceinline__ void f32_tile(float* sm, Opnd A, Opnd B, int M, int N, int k0, int k1,
                                         int i0, int j0, bool vec, bool unit, Epi epi) {
  static_assert(BM % 64 == 0 && BN % 64 == 0, "tiles of 64 rows and columns");
  constexpr int RM = BM / 16, RN = BN / 16;
  constexpr int A_FL = f32_a_floats<BM, A_KMAJ>(), STAGE = A_FL + FK * BN;
  constexpr int AST = FK + FA_PAD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int S = k1 > k0 ? ceil_div(k1 - k0, FK) : 0;
  __syncthreads();  // the block's previous use of sm and of the operands is over

  auto load = [&](int s) {
    if (s < S) {
      const int kb = k0 + s * FK;
      float* as = sm + (s % FSTAGES) * STAGE;
      float* bs = as + A_FL;
      if (A_KMAJ) {
#pragma unroll
        for (int q = 0; q < BM * (FK / 4) / F_THREADS; ++q) {
          const int idx = tid + q * F_THREADS, r = idx >> 2, k4 = (idx & 3) * 4;
          const int i = i0 + r, k = kb + k4;
          copy4(as + r * AST + k4, A.p + (long long)i * A.ld + k, i < M ? k1 - k : 0, vec, A.p);
        }
      } else {
#pragma unroll
        for (int q = 0; q < FK * (BM / 4) / F_THREADS; ++q) {
          const int idx = tid + q * F_THREADS, kk = idx / (BM / 4), i4 = (idx % (BM / 4)) * 4;
          const int i = i0 + i4, k = kb + kk;
          copy4(as + kk * BM + i4, A.p + (long long)k * A.ld + i, k < k1 ? M - i : 0, vec, A.p);
        }
      }
#pragma unroll
      for (int q = 0; q < FK * (BN / 4) / F_THREADS; ++q) {
        const int idx = tid + q * F_THREADS, kk = idx / (BN / 4), j4 = (idx % (BN / 4)) * 4;
        const int j = j0 + j4, k = kb + kk;
        copy4(bs + kk * BN + j4, B.p + (long long)k * B.ld + j, k < k1 ? N - j : 0, vec, B.p);
      }
    }
    cp_commit();  // an empty group past the last stage keeps the count uniform
  };
  // the unit-lower mask on stage s's A tile, in place
  auto mask = [&](int s) {
    const int kb = k0 + s * FK;
    float* as = sm + (s % FSTAGES) * STAGE;
    for (int idx = tid; idx < BM * FK; idx += F_THREADS) {
      const int i = A_KMAJ ? idx / FK : idx % BM, kk = A_KMAJ ? idx % FK : idx / BM;
      const int gi = i0 + i, gk = kb + kk;
      if (gi >= M || gk >= k1) continue;
      float* x = as + (A_KMAJ ? i * AST + kk : kk * BM + i);
      *x = A_KMAJ ? unit_of(*x, gi, gk) : unit_of(*x, gk, gi);
    }
  };

  static_assert(KC % FK == 0, "runs of whole stages");
  float acc[RM][RN], tot[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = tot[r][q] = 0.f;

  load(0);
  load(1);
  for (int s = 0; s < S; ++s) {
    cp_wait<FSTAGES - 2>();  // this thread's copies of stage s have landed
    __syncthreads();         // everyone's; and stage s - 1's buffer is consumed
    load(s + 2);
    // the mask changes only the elements on and above the unit diagonal (r
    // <= c), so only stages whose k reach the tile's rows need it
    const int kb = k0 + s * FK;
    if (unit && (A_KMAJ ? i0 <= kb + FK - 1 : kb <= i0 + BM - 1)) {
      mask(s);
      __syncthreads();
    }
    const float* as = sm + (s % FSTAGES) * STAGE;
    const float* bs = as + A_FL;
    if (A_KMAJ) {
#pragma unroll
      for (int k4 = 0; k4 < FK; k4 += 4) {
        float4 av[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          av[r] = *reinterpret_cast<const float4*>(as + ((r >> 2) * 64 + ty * 4 + (r & 3)) * AST + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[RN];
#pragma unroll
          for (int g = 0; g < RN / 4; ++g) {
            const float4 b = *reinterpret_cast<const float4*>(bs + (k4 + kk) * BN + g * 64 + tx * 4);
            bv[4 * g] = b.x, bv[4 * g + 1] = b.y, bv[4 * g + 2] = b.z, bv[4 * g + 3] = b.w;
          }
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float a = kk == 0 ? av[r].x : kk == 1 ? av[r].y : kk == 2 ? av[r].z : av[r].w;
#pragma unroll
            for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(a, bv[q], acc[r][q]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float av[RM], bv[RN];
#pragma unroll
        for (int g = 0; g < RM / 4; ++g) {
          const float4 a = *reinterpret_cast<const float4*>(as + kk * BM + g * 64 + ty * 4);
          av[4 * g] = a.x, av[4 * g + 1] = a.y, av[4 * g + 2] = a.z, av[4 * g + 3] = a.w;
        }
#pragma unroll
        for (int g = 0; g < RN / 4; ++g) {
          const float4 b = *reinterpret_cast<const float4*>(bs + kk * BN + g * 64 + tx * 4);
          bv[4 * g] = b.x, bv[4 * g + 1] = b.y, bv[4 * g + 2] = b.z, bv[4 * g + 3] = b.w;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
      }
    }
    if constexpr (KC > 0) {
      if ((s + 1) % (KC / FK) == 0) {  // a run of KC k ends: fold it into the total
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) {
            tot[r][q] += acc[r][q];
            acc[r][q] = 0.f;
          }
      }
    }
  }
  if constexpr (KC > 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) acc[r][q] = tot[r][q] + acc[r][q];
  }
  cp_wait<0>();

  // D through shared memory, 64 rows at a time (the stages are free), then
  // the epilogue a column a thread: consecutive threads on consecutive
  // columns, every read of a thread's entries issued before its first write
  // (a read-modify-write each would wait for the one before it; the tile's
  // entries are disjoint, so the reorder is exact)
  constexpr int DST = BN + 4, RSTEP = F_THREADS / BN, RPT = 64 / RSTEP;
  static_assert(64 * DST <= FSTAGES * STAGE, "64 rows of D fit the stages");
  const int jj = tid % BN, r0 = tid / BN, j = j0 + jj;
#pragma unroll
  for (int h = 0; h < BM / 64; ++h) {
    __syncthreads();  // the stages (or the previous half) are consumed
#pragma unroll
    for (int r = 4 * h; r < 4 * h + 4; ++r)
#pragma unroll
      for (int g = 0; g < RN / 4; ++g)
        *reinterpret_cast<float4*>(sm + (ty * 4 + (r & 3)) * DST + g * 64 + tx * 4) =
            make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
    __syncthreads();
    float old[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = i0 + 64 * h + r0 + q * RSTEP;
      old[q] = i < M && j < N ? epi.pre(i, j) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = i0 + 64 * h + r0 + q * RSTEP;
      if (i < M && j < N) epi(i, j, sm[(r0 + q * RSTEP) * DST + jj], old[q]);
    }
  }
  __syncthreads();  // the epilogue's writes are visible to the block, sm is free
}

// ---- the split product on wgmma ----

constexpr int WK = 32, WSTAGES = 4, WBN = 64, WA_PAD = 4;

template <int BM>
__host__ __device__ constexpr int wg_a_bytes() {  // one half (hi or lo) of a split A stage
  return (WK / 16) * BM * 16 * 2;
}
constexpr int WB_BYTES = (WK / 16) * WBN * 16 * 2;
template <int BM>
__host__ __device__ constexpr int wg_split_bytes() {
  return 2 * wg_a_bytes<BM>() + 2 * WB_BYTES;
}
template <int BM, bool A_KMAJ>
__host__ __device__ constexpr int wg_raw_floats() {
  return (A_KMAJ ? BM * (WK + WA_PAD) : WK * BM) + WK * WBN;
}
// shared bytes of wg_tile<P, BM, A_KMAJ> for either A_KMAJ (the raw ring
// sized for the larger, K-major A)
template <int BM>
__host__ __device__ constexpr size_t wg_smem() {
  return 2 * (size_t)wg_split_bytes<BM>() + sizeof(float) * WSTAGES * wg_raw_floats<BM, true>();
}

// D rows i0.. (warpgroup g: i0 + 64 g..), columns j0.. (a BM x 64 tile)
// over k in [k0, k1), by BM / 64 warpgroups (2 BM threads). Accumulator
// element e of a thread: D row 16 warp + lane/4 + 8 ((e/2)%2) of its
// warpgroup's 64, column 8 (e/4) + 2 (lane%4) + e%2 (wgmma's D layout).
template <int P, int BM, bool A_KMAJ, class Epi>
__device__ __forceinline__ void wg_tile(unsigned char* sm, Opnd A, Opnd B, int M, int N, int k0,
                                        int k1, int i0, int j0, bool vec, bool unit, Epi epi) {
  static_assert(P == 1 || P == 3 || P == 4, "P is 1, 3 or 4");
  static_assert(BM == 64 || BM == 128, "one or two warpgroups");
  constexpr int T = 2 * BM;
  constexpr int A_CH = BM * 16 * 2, A_BYTES = wg_a_bytes<BM>();
  constexpr int B_CH = WBN * 16 * 2, B_BYTES = WB_BYTES;
  constexpr int SPLIT = wg_split_bytes<BM>();
  constexpr int A_FL = A_KMAJ ? BM * (WK + WA_PAD) : WK * BM;
  constexpr int RAW = wg_raw_floats<BM, A_KMAJ>(), AST = WK + WA_PAD;
  float* raw = reinterpret_cast<float*>(sm + 2 * SPLIT);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int S = k1 > k0 ? ceil_div(k1 - k0, WK) : 0;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(sm);

  float hh[32], cr[32], ll[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) hh[e] = cr[e] = ll[e] = 0.f;
  __syncthreads();  // the block's previous use of sm and of the operands is over

  // stage s's fp32 A and B into raw stage s % WSTAGES; a commit group per
  // call, empty past S
  auto load = [&](int s) {
    if (s < S) {
      const int kb = k0 + s * WK;
      float* as = raw + (s % WSTAGES) * RAW;
      float* bs = as + A_FL;
      if (A_KMAJ) {
#pragma unroll
        for (int q = 0; q < BM * (WK / 4) / T; ++q) {
          const int idx = tid + q * T, r = idx >> 3, k4 = (idx & 7) * 4;
          const int i = i0 + r, k = kb + k4;
          copy4(as + r * AST + k4, A.p + (long long)i * A.ld + k, i < M ? k1 - k : 0, vec, A.p);
        }
      } else {
#pragma unroll
        for (int q = 0; q < WK * (BM / 4) / T; ++q) {
          const int idx = tid + q * T, kk = idx / (BM / 4), i4 = (idx % (BM / 4)) * 4;
          const int i = i0 + i4, k = kb + kk;
          copy4(as + kk * BM + i4, A.p + (long long)k * A.ld + i, k < k1 ? M - i : 0, vec, A.p);
        }
      }
#pragma unroll
      for (int q = 0; q < WK * (WBN / 4) / T; ++q) {
        const int idx = tid + q * T, kk = idx / (WBN / 4), j4 = (idx % (WBN / 4)) * 4;
        const int j = j0 + j4, k = kb + kk;
        copy4(bs + kk * WBN + j4, B.p + (long long)k * B.ld + j, k < k1 ? N - j : 0, vec, B.p);
      }
    }
    cp_commit();
  };
  // split raw stage s into bf16 buffer s % 2 by (row, 8-k group) pairs,
  // lanes on neighbouring rows
  auto put = [&](int s) {
    const int kb = k0 + s * WK;
    const float* as = raw + (s % WSTAGES) * RAW;
    const float* bs = as + A_FL;
    unsigned char* st = sm + (s & 1) * SPLIT;
#pragma unroll
    for (int h = 0; h < (WK / 8) * BM / T; ++h) {
      const int p = tid + h * T, r = p % BM, kg = p / BM;
      float v[8];
      if (A_KMAJ) {
        const float4 x0 = *reinterpret_cast<const float4*>(as + r * AST + kg * 8);
        const float4 x1 = *reinterpret_cast<const float4*>(as + r * AST + kg * 8 + 4);
        v[0] = x0.x, v[1] = x0.y, v[2] = x0.z, v[3] = x0.w;
        v[4] = x1.x, v[5] = x1.y, v[6] = x1.z, v[7] = x1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = as[(kg * 8 + e) * BM + r];
      }
      if (unit) {
        const int gi = i0 + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int gk = kb + kg * 8 + e;
          if (gi < M && gk < k1) v[e] = A_KMAJ ? unit_of(v[e], gi, gk) : unit_of(v[e], gk, gi);
        }
      }
      const int off = core_off(r, kg, A_CH);
      bx::split8<P>(v, st + off, st + A_BYTES + off);
    }
#pragma unroll
    for (int h = 0; h < (WK / 8) * WBN / T; ++h) {
      const int p = tid + h * T, r = p % WBN, kg = p / WBN;
      const int off = core_off(r, kg, B_CH);
      bx::split8<P>(bs + kg * 8 * WBN + r, WBN, st + 2 * A_BYTES + off,
                    st + 2 * A_BYTES + B_BYTES + off);
    }
  };
  auto mma = [&](int buf) {
    const unsigned st = sbase + buf * SPLIT;
#pragma unroll
    for (int ch = 0; ch < WK / 16; ++ch) {
      const unsigned a_hi = st + ch * A_CH + wg * (64 / 8) * CORE_SBO, a_lo = a_hi + A_BYTES;
      const unsigned b_hi = st + 2 * A_BYTES + ch * B_CH, b_lo = b_hi + B_BYTES;
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
  }
  wg_wait<0>();
  cp_wait<0>();

  // D through shared memory (the split buffers are free once every
  // warpgroup's products are done), then the epilogue a column a thread:
  // consecutive threads on consecutive columns, and every read of a
  // thread's entries issued before its first write
  __syncthreads();
  constexpr int DST = WBN + 4;  // D's row stride in shared memory
  static_assert(BM * DST * 4 <= 2 * SPLIT, "D fits the split buffers");
  float* ds = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fence_reg(hh[e + h]);
      if (P > 1) fence_reg(cr[e + h]);
      if (P > 3) fence_reg(ll[e + h]);
      v[h] = hh[e + h];
      if (P > 1) v[h] = v[h] + cr[e + h];
      if (P > 3) v[h] = v[h] + ll[e + h];
    }
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * ((e >> 1) & 1);
    const int c = 8 * (e >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(ds + r * DST + c) = make_float2(v[0], v[1]);
  }
  __syncthreads();
  constexpr int RSTEP = T / WBN, RPT = BM / RSTEP;  // row step, rows a thread
  const int jj = tid % WBN, r0 = tid / WBN, j = j0 + jj;
  float old[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = i0 + r0 + q * RSTEP;
    old[q] = i < M && j < N ? epi.pre(i, j) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = i0 + r0 + q * RSTEP;
    if (i < M && j < N) epi(i, j, ds[(r0 + q * RSTEP) * DST + jj], old[q]);
  }
  __syncthreads();  // the epilogue's writes are visible to the block, sm is free
}

// whether the 16-byte copies may run: p 16-byte aligned
__host__ inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace tg

// Phase 2's product over a batch (csrc/panel_apply.cu): for z < batch,
// C_z (m x n, row stride ldc) -= Y_z (m x nb, contiguous) W_z (nb x n, row
// stride ldw), Y_z = y + z ys, W_z = w + z ws, C_z = c + z cs, on C tiles
// of tile_m x tile_n (kernels/panel_apply.py:sub_plan: 128 x 128 or 64 x
// 64 at passes 0, 128 x 64 or 64 x 64 at passes 1, 3, 4; any other tile is
// refused). A cudaError_t.
int tq_sub_launch(const float* y, long long ys, const float* w, long long ldw, long long ws,
                  float* c, long long ldc, long long cs, int m, int n, int nb, int batch,
                  int tile_m, int tile_n, int passes, cudaStream_t stream);

// whether (tile_m, tile_n) is one of the route's tiles
inline bool tq_tile_ok(int tile_m, int tile_n, int passes) {
  if (passes == 0) return (tile_m == 128 && tile_n == 128) || (tile_m == 64 && tile_n == 64);
  return (tile_m == 128 || tile_m == 64) && tile_n == 64;
}
