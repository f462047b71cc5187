// The emulated fp32 product on the tensor cores: the Hopper form of
// tileqr/kernels/common.py:_dot_bx (and of precision "default").
//
// Each fp32 operand element is split ONCE, when it is staged to shared
// memory, into two bf16 halves by round to nearest (as _split_bf16):
//   hi = bf16_rn(x),  lo = bf16_rn(x - float(hi))   (x - hi is exact).
// A product then takes PASSES bf16 tensor-core passes with fp32
// accumulation, in _dot_bx's order: hh, then the cross terms (hl + lh) in
// one accumulator, then ll; the result is hh + cross (+ ll):
//   PASSES = 1: Ah.Bh                ("default": one bf16 pass)
//   PASSES = 3: hh + (hl + lh)       ("b3", and "high")
//   PASSES = 4: hh + (hl + lh) + ll  ("b4")
// Each bf16 x bf16 product is exact in fp32; only the accumulation order
// differs from the plain version (tileqr_torch/kernels/common.py:dot_bx),
// so a kernel is held to it by tolerance. No atomics: reruns are bitwise
// equal.
//
// gemm32 is a block-level routine for a block of BX_THREADS threads (8
// warps): Out (M x 32) = A (M x K) . B (K x 32), A and B given by element
// accessors, the result handed to an epilogue element by element. It walks
// M in passes of 128 rows (one 16-row tile per warp, two 16-column tiles)
// and K in steps of 16, staging the split tiles in shared memory; each warp
// issues mma.sync through nvcuda::wmma m16n16k16 bf16 fragments. The
// epilogue goes through a per-warp shared scratch tile, so the fragment
// layout never needs to be known. Simple and right first: wgmma, TMA and
// staging pipelines are later work.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace bx {

constexpr int BX_THREADS = 256;
constexpr int WARPS = BX_THREADS / 32;
constexpr int MT = 16 * WARPS;  // output rows per pass over K
constexpr int NC = 32;          // output columns
constexpr int KT = 16;          // contraction depth per staged step

struct Smem {
  __nv_bfloat16* a_hi;  // KT x MT, A(i, kk) at kk * MT + i (column-major A)
  __nv_bfloat16* a_lo;
  __nv_bfloat16* b_hi;  // KT x NC, B(kk, c) at kk * NC + c (row-major B)
  __nv_bfloat16* b_lo;
  float* scratch;       // WARPS x (16 x NC): the epilogue's tiles
};

// bytes of shared memory gemm32 needs; carve() takes a 128-byte aligned base
constexpr size_t SMEM_BYTES =
    sizeof(__nv_bfloat16) * 2 * (KT * MT + KT * NC) + sizeof(float) * WARPS * 16 * NC;

__device__ __forceinline__ Smem carve(void* base) {
  Smem s;
  s.a_hi = static_cast<__nv_bfloat16*>(base);
  s.a_lo = s.a_hi + KT * MT;
  s.b_hi = s.a_lo + KT * MT;
  s.b_lo = s.b_hi + KT * NC;
  s.scratch = reinterpret_cast<float*>(s.b_lo + KT * NC);
  return s;
}

template <int PASSES>
__device__ __forceinline__ void split_store(float x, __nv_bfloat16* hi, __nv_bfloat16* lo,
                                            int idx) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi[idx] = h;
  if (PASSES > 1) lo[idx] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// Out(i, c) = sum_k A(i, k) B(k, c) for i < M, c < NC, by the PASSES-pass
// product; epi(i, c, value) receives each element once. a_at(i, k) and
// b_at(k, c) are called only for i < M, k < K. A_ROW_MAJOR says which index
// of a_at runs along memory (k when true), so the staging loop reads
// neighbouring addresses with neighbouring threads. Every thread of the
// block calls it; it synchronises the block before and after.
template <int PASSES, bool A_ROW_MAJOR, class AAt, class BAt, class Epi>
__device__ void gemm32(const Smem& S, int M, int K, AAt a_at, BAt b_at, Epi epi) {
  using namespace nvcuda;
  static_assert(PASSES == 1 || PASSES == 3 || PASSES == 4, "PASSES is 1, 3 or 4");
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scr = S.scratch + warp * 16 * NC;
  for (int m0 = 0; m0 < M; m0 += MT) {
    const bool active = m0 + warp * 16 < M;  // warp-uniform
    Acc hh[2], cr[2], ll[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(hh[j], 0.f);
      if (PASSES > 1) wmma::fill_fragment(cr[j], 0.f);
      if (PASSES > 3) wmma::fill_fragment(ll[j], 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += KT) {
      __syncthreads();  // the previous step's tiles are consumed
      for (int idx = tid; idx < KT * MT; idx += BX_THREADS) {
        const int i = A_ROW_MAJOR ? idx / KT : idx % MT;
        const int kk = A_ROW_MAJOR ? idx % KT : idx / MT;
        const int gi = m0 + i, gk = k0 + kk;
        const float x = (gi < M && gk < K) ? a_at(gi, gk) : 0.f;
        split_store<PASSES>(x, S.a_hi, S.a_lo, kk * MT + i);
      }
      for (int idx = tid; idx < KT * NC; idx += BX_THREADS) {
        const int kk = idx / NC, c = idx % NC, gk = k0 + kk;
        split_store<PASSES>(gk < K ? b_at(gk, c) : 0.f, S.b_hi, S.b_lo, idx);
      }
      __syncthreads();
      if (active) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> ah, al;
        wmma::load_matrix_sync(ah, S.a_hi + warp * 16, MT);
        if (PASSES > 1) wmma::load_matrix_sync(al, S.a_lo + warp * 16, MT);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bh, bl;
          wmma::load_matrix_sync(bh, S.b_hi + j * 16, NC);
          wmma::mma_sync(hh[j], ah, bh, hh[j]);
          if (PASSES > 1) {
            wmma::load_matrix_sync(bl, S.b_lo + j * 16, NC);
            wmma::mma_sync(cr[j], ah, bl, cr[j]);
            wmma::mma_sync(cr[j], al, bh, cr[j]);
          }
          if (PASSES > 3) wmma::mma_sync(ll[j], al, bl, ll[j]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        for (int e = 0; e < hh[j].num_elements; ++e) {
          float v = hh[j].x[e];
          if (PASSES > 1) v = v + cr[j].x[e];
          if (PASSES > 3) v = v + ll[j].x[e];
          hh[j].x[e] = v;
        }
        wmma::store_matrix_sync(scr + j * 16, hh[j], NC, wmma::mem_row_major);
      }
      __syncwarp();
      for (int e = lane; e < 16 * NC; e += 32) {
        const int gi = m0 + warp * 16 + e / NC;
        if (gi < M) epi(gi, e % NC, scr[e]);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

}  // namespace bx
