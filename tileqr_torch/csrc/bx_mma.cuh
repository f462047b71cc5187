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
// This header holds the split itself; the products run on wgmma in
// tile_gemm.cuh (wg_tile) and in panel_apply.cu's phase 1.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bx {

template <int PASSES>
__device__ __forceinline__ void split_store(float x, __nv_bfloat16* hi, __nv_bfloat16* lo,
                                            int idx) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi[idx] = h;
  if (PASSES > 1) lo[idx] = __float2bfloat16_rn(x - __bfloat162float(h));
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// the 8 values v[0..7] ~ hi + lo, each rounded to nearest as split_store
// does, two at a time (one cvt a pair), stored as 16 bytes each (lo only
// when PASSES > 1)
template <int PASSES>
__device__ __forceinline__ void split8(const float (&v)[8], unsigned char* hi,
                                       unsigned char* lo) {
  unsigned h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);  // .x first
    h[q] = bits_of(hb);
    if (PASSES > 1) {
      const float2 hf = __bfloat1622float2(hb);
      l[q] = bits_of(__floats2bfloat162_rn(v[2 * q] - hf.x, v[2 * q + 1] - hf.y));
    }
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if (PASSES > 1) *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// the same for the 8 values x[q * ld], q < 8
template <int PASSES>
__device__ __forceinline__ void split8(const float* x, int ld, unsigned char* hi,
                                       unsigned char* lo) {
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = x[q * ld];
  split8<PASSES>(v, hi, lo);
}

}  // namespace bx
