// K2 (panel_chain), K3 (couple_strip) and K4 (larfb_strip).
//
// K2 replaces tileqr/kernels/chain.py:panel_chain (_chain_kernel_factory):
// TSQRT on n_chunks couples [R; B], B of block_rows rows, R carried; B15's
// tsqrt (kernels/tsqrt.py) is K2 with one couple. As in K1 (panel.cu) the
// sequential TPU grid becomes a loop inside ONE thread-block cluster around
// geqrt_couple_cluster (geqrt_cluster.cuh): each couple's m = nb +
// block_rows rows (1280 at the defaults) are split over C CTAs (16 at the
// defaults, 80 rows each; 16 for the tsqr chain's 2560 rows at nb = 512,
// 160 each), each holding its rows of the active ib block in shared memory.
// B's rows live in their V output between blocks, R's in r_out (seeded
// from r_in), both in L2. Bound: latency of the column loop, now one
// cluster barrier and a pass over rpc = m / C shared-memory rows a column
// (geqrt.cuh's single-block design walks m rows through L2 on one SM).
//
// K3 replaces chain.py:couple_strip (_couple_strip_kernel_factory), the
// SSRFB trailing sweep W = T2^T (C_top + V2^T C_bot); C_top -= W;
// C_bot -= V2 W, with the diagonal LARFB fused at the first couple
// (forward) or after the last (reverse). K4 replaces chain.py:larfb_strip.
// The TPU kernels hold one nb x nb strip tile per program in VMEM; here
// the apply is split into slabs of SLAB_COLS columns, one block each: the
// columns are independent, so each slab's result (and its sum order) does
// not depend on the split, and the in-place writes of different blocks
// never overlap. A block keeps its (nb x SLAB_COLS) strip slab and the two
// W slabs in shared memory (3 x 32 KiB at nb = 256) across its couple loop,
// reads V2 and T2 from global memory (L2-resident: every slab rereads
// them) and updates its C_bot columns in place. Bound: fp32 FMA issue and
// the L2 traffic of rereading V2 per slab; the arithmetic is IEEE fp32 FMA
// on CUDA cores ("highest", never TF32).
//
// K3 and K4 take the precision as a template parameter P, the passes of the
// bf16 split product (0 = "highest"). P = 0 is the fp32 FMA code above.
// P = 1, 3, 4 ("default", "b3"/"high", "b4") compute each of the three
// products of ssrfb_body/larfb_body (V^T X, op(T) W, V W2) with
// bx::gemm32 (bx_mma.cuh), the split tensor-core product, as tileqr's
// update kernels do with _dot_bx; the C_top add and the subtractions stay
// fp32. The slab and the two W slabs stay in shared memory; the split
// halves of the staged V/T and X/W tiles take the place of the fp32 staging
// tile (bx::SMEM_BYTES, 26 KiB). Bound at P > 0: the bf16 tensor-core rate
// (989 TFLOP/s dense) times P passes, or the same bytes as at P = 0; this
// first version stages through shared memory with mma.sync and reaches
// neither (PERF.md).
#include "bx_mma.cuh"
#include "geqrt_cluster.cuh"

namespace {

template <bool RES>
__global__ void __launch_bounds__(cl::CL_THREADS)
panel_chain_kernel(const float* __restrict__ a, long long lda, const float* r_in, int k,
                   int nb, int base_block, int n_chunks, int block_rows, int ib,
                   float* r_out, float* v_chunks, float* t2, float* work) {
  extern __shared__ __align__(16) float smem[];
  const cl::Cta w = cl::carve<RES>(smem, work, nb, nb + block_rows, ib);
  for (int i = 0; i < n_chunks; ++i) {
    cl::Couple cp;
    cp.nb = nb;
    cp.m = nb + block_rows;
    cp.r_rows = nb;
    cp.r_src = i == 0 ? r_in : r_out;
    cp.r_home = r_out;
    cp.b_src = a + (long long)(base_block + i) * block_rows * lda + (long long)k * nb;
    cp.ldb = lda;
    cp.b_home = v_chunks + (long long)i * block_rows * nb;
    cp.t_out = t2 + (long long)i * nb * nb;
    cl::geqrt_couple_cluster<RES>(cp, w);
    cl::cluster_sync_global();
  }
}

constexpr int SLAB_COLS = 32;     // strip columns per block (one per lane)
constexpr int SLAB_THREADS = 256;
constexpr int STAGE_ROWS = 32;    // rows of X staged per step of slab_proj

struct Slab {
  float* top;  // (nb x SLAB_COLS) strip slab
  float* w;    // (nb x SLAB_COLS)
  float* w2;   // (nb x SLAB_COLS)
  float* xs;   // (STAGE_ROWS x SLAB_COLS) staging (P = 0)
  bx::Smem bx; // the split product's staging (P > 0), at the same offset
  int nb, ncol;
};

__device__ __forceinline__ float v_elem(const float* V, int nb, int r, int i, bool unit) {
  if (!unit) return V[(long long)r * nb + i];
  return r == i ? 1.f : (r > i ? V[(long long)r * nb + i] : 0.f);
}

// W = [top +] Vm^T X: Vm (rows x nb) is V, or unit_lower(V) when `unit`;
// X (rows x SLAB_COLS, row stride ldx) is global C_bot or the slab itself.
// Each thread owns a row of W and keeps its SLAB_COLS sums in registers.
__device__ void slab_proj(const Slab& S, const float* V, int rows, bool unit,
                          const float* X, long long ldx, bool with_top) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < S.nb; i0 += SLAB_THREADS) {
    const int i = i0 + tid;
    float acc[SLAB_COLS];
#pragma unroll
    for (int c = 0; c < SLAB_COLS; ++c) acc[c] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += STAGE_ROWS) {
      __syncthreads();
      for (int idx = tid; idx < STAGE_ROWS * SLAB_COLS; idx += SLAB_THREADS) {
        const int rr = idx / SLAB_COLS, c = idx % SLAB_COLS;
        S.xs[idx] = (r0 + rr < rows && c < S.ncol) ? X[(long long)(r0 + rr) * ldx + c] : 0.f;
      }
      __syncthreads();
      if (i < S.nb) {
        const int rend = min(STAGE_ROWS, rows - r0);
        for (int rr = 0; rr < rend; ++rr) {
          const float vv = v_elem(V, S.nb, r0 + rr, i, unit);
#pragma unroll
          for (int c = 0; c < SLAB_COLS; ++c)
            acc[c] = fmaf(vv, S.xs[rr * SLAB_COLS + c], acc[c]);
        }
      }
    }
    if (i < S.nb) {
#pragma unroll
      for (int c = 0; c < SLAB_COLS; ++c)
        S.w[i * SLAB_COLS + c] = with_top ? S.top[i * SLAB_COLS + c] + acc[c] : acc[c];
    }
  }
  __syncthreads();
}

// W2 = op(T) W, op = transpose when `trans`.
__device__ void slab_tmul(const Slab& S, const float* T, bool trans) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < S.nb; i0 += SLAB_THREADS) {
    const int i = i0 + tid;
    if (i < S.nb) {
      float acc[SLAB_COLS];
#pragma unroll
      for (int c = 0; c < SLAB_COLS; ++c) acc[c] = 0.f;
      for (int kk = 0; kk < S.nb; ++kk) {
        const float t = trans ? T[(long long)kk * S.nb + i] : T[(long long)i * S.nb + kk];
#pragma unroll
        for (int c = 0; c < SLAB_COLS; ++c) acc[c] = fmaf(t, S.w[kk * SLAB_COLS + c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < SLAB_COLS; ++c) S.w2[i * SLAB_COLS + c] = acc[c];
    }
  }
  __syncthreads();
}

// X -= Vm W2 over `rows` rows; lane = column, each warp four rows at a time.
__device__ void slab_sub(const Slab& S, const float* V, int rows, bool unit, float* X,
                         long long ldx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = SLAB_THREADS / 32;
  for (int r0 = warp * 4; r0 < rows; r0 += NW * 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < S.nb; ++i) {
      const float w = S.w2[i * SLAB_COLS + lane];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r0 + q < rows) acc[q] = fmaf(v_elem(V, S.nb, r0 + q, i, unit), w, acc[q]);
    }
    if (lane < S.ncol) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r0 + q < rows) {
          float* x = X + (long long)(r0 + q) * ldx + lane;
          *x = *x - acc[q];
        }
    }
  }
  __syncthreads();
}

// The same three products by the P-pass split product (P > 0).
template <int P>
__device__ void slab_proj_bx(const Slab& S, const float* V, int rows, bool unit,
                             const float* X, long long ldx, bool with_top) {
  const int nb = S.nb, ncol = S.ncol;
  bx::gemm32<P, false>(
      S.bx, nb, rows, [&](int i, int k) { return v_elem(V, nb, k, i, unit); },
      [&](int k, int c) { return c < ncol ? X[(long long)k * ldx + c] : 0.f; },
      [&](int i, int c, float v) {
        const int o = i * SLAB_COLS + c;
        S.w[o] = with_top ? S.top[o] + v : v;
      });
}

template <int P>
__device__ void slab_tmul_bx(const Slab& S, const float* T, bool trans) {
  const int nb = S.nb;
  bx::gemm32<P, false>(
      S.bx, nb, nb,
      [&](int i, int k) { return trans ? T[(long long)k * nb + i] : T[(long long)i * nb + k]; },
      [&](int k, int c) { return S.w[k * SLAB_COLS + c]; },
      [&](int i, int c, float v) { S.w2[i * SLAB_COLS + c] = v; });
}

template <int P>
__device__ void slab_sub_bx(const Slab& S, const float* V, int rows, bool unit, float* X,
                            long long ldx) {
  const int nb = S.nb, ncol = S.ncol;
  bx::gemm32<P, true>(
      S.bx, rows, nb, [&](int i, int k) { return v_elem(V, nb, i, k, unit); },
      [&](int k, int c) { return S.w2[k * SLAB_COLS + c]; },
      [&](int i, int c, float v) {
        if (c < ncol) {
          float* x = X + (long long)i * ldx + c;
          *x = *x - v;
        }
      });
}

template <int P>
__device__ void slab_proj_p(const Slab& S, const float* V, int rows, bool unit, const float* X,
                            long long ldx, bool with_top) {
  if constexpr (P == 0) slab_proj(S, V, rows, unit, X, ldx, with_top);
  else slab_proj_bx<P>(S, V, rows, unit, X, ldx, with_top);
}

template <int P>
__device__ void slab_tmul_p(const Slab& S, const float* T, bool trans) {
  if constexpr (P == 0) slab_tmul(S, T, trans);
  else slab_tmul_bx<P>(S, T, trans);
}

template <int P>
__device__ void slab_sub_p(const Slab& S, const float* V, int rows, bool unit, float* X,
                           long long ldx) {
  if constexpr (P == 0) slab_sub(S, V, rows, unit, X, ldx);
  else slab_sub_bx<P>(S, V, rows, unit, X, ldx);
}

// slab <- (I - V T V^T)^{T?} slab, V = unit_lower(vkk): larfb_body.
template <int P>
__device__ void slab_larfb(const Slab& S, const float* vkk, const float* tg, bool trans) {
  slab_proj_p<P>(S, vkk, S.nb, true, S.top, SLAB_COLS, false);
  slab_tmul_p<P>(S, tg, trans);
  slab_sub_p<P>(S, vkk, S.nb, true, S.top, SLAB_COLS);
}

// (slab, C_bot) <- couple reflector applied: ssrfb_body.
template <int P>
__device__ void slab_ssrfb(const Slab& S, const float* v2, const float* t2, float* cbot,
                           long long ldc, int rows, bool trans) {
  slab_proj_p<P>(S, v2, rows, false, cbot, ldc, true);
  slab_tmul_p<P>(S, t2, trans);
  for (int idx = threadIdx.x; idx < S.nb * SLAB_COLS; idx += SLAB_THREADS)
    S.top[idx] = S.top[idx] - S.w2[idx];
  __syncthreads();
  slab_sub_p<P>(S, v2, rows, false, cbot, ldc);
}

__device__ Slab slab_load(float* sm, const float* strip, long long lds, int width, int nb) {
  Slab S;
  S.nb = nb;
  S.top = sm;
  S.w = sm + nb * SLAB_COLS;
  S.w2 = S.w + nb * SLAB_COLS;
  S.xs = S.w2 + nb * SLAB_COLS;
  S.bx = bx::carve(S.xs);
  const int j0 = blockIdx.x * SLAB_COLS;
  S.ncol = min(SLAB_COLS, width - j0);
  for (int idx = threadIdx.x; idx < nb * SLAB_COLS; idx += SLAB_THREADS) {
    const int r = idx / SLAB_COLS, c = idx % SLAB_COLS;
    S.top[idx] = c < S.ncol ? strip[(long long)r * lds + j0 + c] : 0.f;
  }
  __syncthreads();
  return S;
}

__device__ void slab_store(const Slab& S, float* strip, long long lds) {
  const int j0 = blockIdx.x * SLAB_COLS;
  for (int idx = threadIdx.x; idx < S.nb * SLAB_COLS; idx += SLAB_THREADS) {
    const int r = idx / SLAB_COLS, c = idx % SLAB_COLS;
    if (c < S.ncol) strip[(long long)r * lds + j0 + c] = S.top[idx];
  }
}

template <int P>
__global__ void __launch_bounds__(SLAB_THREADS)
couple_strip_kernel(const float* v_stack, const float* t2_stack, float* c, long long ldc,
                    float* strip, long long lds, int width, int stack_base,
                    int base_block, int n_chunks, int block_rows, int nb, int col_start,
                    int trans, int reverse, const float* vkk, const float* tg) {
  extern __shared__ __align__(128) float sm[];
  const Slab S = slab_load(sm, strip, lds, width, nb);
  const bool fuse = vkk != nullptr;
  if (fuse && !reverse) slab_larfb<P>(S, vkk, tg, trans);
  const long long col0 = (long long)col_start * nb + (long long)blockIdx.x * SLAB_COLS;
  for (int ii = 0; ii < n_chunks; ++ii) {
    const int q = reverse ? n_chunks - 1 - ii : ii;
    const float* v2 = v_stack + (long long)(stack_base + q) * block_rows * nb;
    const float* t2 = t2_stack + (long long)(stack_base + q) * nb * nb;
    float* cbot = c + (long long)(base_block + q) * block_rows * ldc + col0;
    slab_ssrfb<P>(S, v2, t2, cbot, ldc, block_rows, trans);
  }
  if (fuse && reverse) slab_larfb<P>(S, vkk, tg, trans);
  slab_store(S, strip, lds);
}

template <int P>
__global__ void __launch_bounds__(SLAB_THREADS)
larfb_strip_kernel(const float* vkk, const float* tg, float* strip, long long lds,
                   int width, int nb, int trans) {
  extern __shared__ __align__(128) float sm[];
  const Slab S = slab_load(sm, strip, lds, width, nb);
  slab_larfb<P>(S, vkk, tg, trans);
  slab_store(S, strip, lds);
}

size_t slab_smem(int nb, int passes) {
  const size_t slabs = sizeof(float) * 3 * (size_t)nb * SLAB_COLS;
  return slabs + (passes == 0 ? sizeof(float) * STAGE_ROWS * SLAB_COLS : bx::SMEM_BYTES);
}

template <int P>
int launch_couple_strip(const float* v_stack, const float* t2_stack, float* c, long long ldc,
                        float* strip, long long lds, int width, int stack_base,
                        int base_block, int n_chunks, int block_rows, int nb, int col_start,
                        int trans, int reverse, const float* vkk, const float* tg,
                        cudaStream_t stream) {
  const size_t smem = slab_smem(nb, P);
  cudaError_t e = cudaFuncSetAttribute(
      couple_strip_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (width + SLAB_COLS - 1) / SLAB_COLS;
  couple_strip_kernel<P><<<blocks, SLAB_THREADS, smem, stream>>>(
      v_stack, t2_stack, c, ldc, strip, lds, width, stack_base, base_block, n_chunks,
      block_rows, nb, col_start, trans, reverse, vkk, tg);
  return (int)cudaGetLastError();
}

template <int P>
int launch_larfb_strip(const float* vkk, const float* tg, float* strip, long long lds,
                       int width, int nb, int trans, cudaStream_t stream) {
  const size_t smem = slab_smem(nb, P);
  cudaError_t e = cudaFuncSetAttribute(
      larfb_strip_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (width + SLAB_COLS - 1) / SLAB_COLS;
  larfb_strip_kernel<P><<<blocks, SLAB_THREADS, smem, stream>>>(vkk, tg, strip, lds, width,
                                                               nb, trans);
  return (int)cudaGetLastError();
}

}  // namespace

// ctas, smem, resident: kernels/panel.py:cluster_plan(nb, nb + block_rows, ib)
extern "C" int tq_panel_chain(const float* a, long long lda, const float* r_in, int k,
                              int nb, int base_block, int n_chunks, int block_rows, int ib,
                              float* r_out, float* v_chunks, float* t2, float* work, int ctas,
                              long long smem, int resident, void* stream) {
  const int rows = nb + block_rows;
  if (!cl::smem_matches(nb, rows, ib, ctas, resident, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return cl::launch_cluster(panel_chain_kernel<true>, ctas, (size_t)smem, st, a, lda, r_in, k,
                              nb, base_block, n_chunks, block_rows, ib, r_out, v_chunks, t2,
                              work);
  return cl::launch_cluster(panel_chain_kernel<false>, ctas, (size_t)smem, st, a, lda, r_in, k,
                            nb, base_block, n_chunks, block_rows, ib, r_out, v_chunks, t2, work);
}

// passes: 0 ("highest"), 1 ("default"), 3 ("b3"/"high") or 4 ("b4")
extern "C" int tq_couple_strip(const float* v_stack, const float* t2_stack, float* c,
                               long long ldc, float* strip, long long lds, int width,
                               int stack_base, int base_block, int n_chunks,
                               int block_rows, int nb, int col_start, int trans,
                               int reverse, const float* vkk, const float* tg, int passes,
                               void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
#define TQ_COUPLE(P)                                                                    \
  launch_couple_strip<P>(v_stack, t2_stack, c, ldc, strip, lds, width, stack_base,      \
                         base_block, n_chunks, block_rows, nb, col_start, trans, reverse, \
                         vkk, tg, stream)
  switch (passes) {
    case 0: return TQ_COUPLE(0);
    case 1: return TQ_COUPLE(1);
    case 3: return TQ_COUPLE(3);
    case 4: return TQ_COUPLE(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TQ_COUPLE
}

extern "C" int tq_larfb_strip(const float* vkk, const float* tg, float* strip, long long lds,
                              int width, int nb, int trans, int passes, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (passes) {
    case 0: return launch_larfb_strip<0>(vkk, tg, strip, lds, width, nb, trans, stream);
    case 1: return launch_larfb_strip<1>(vkk, tg, strip, lds, width, nb, trans, stream);
    case 3: return launch_larfb_strip<3>(vkk, tg, strip, lds, width, nb, trans, stream);
    case 4: return launch_larfb_strip<4>(vkk, tg, strip, lds, width, nb, trans, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef TQ_CL_STAGES
extern "C" int tq_cl_stages_chain(unsigned long long* out) { return cl::read_stages(out); }
#endif
