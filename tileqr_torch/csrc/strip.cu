// K3 (couple_strip) and K4 (larfb_strip): the strip apply of the hh driver.
//
// K3 replaces tileqr/kernels/chain.py:couple_strip
// (_couple_strip_kernel_factory, pallas_call at :212), the SSRFB trailing
// sweep over n_chunks couples, each W = C_top + V2^T C_bot; W2 = op(T2) W;
// C_top -= W2; C_bot -= V2 W2, with the diagonal tile's LARFB fused before
// the first couple (forward) or after the last (reverse, the Q-apply
// order); K4 replaces chain.py:larfb_strip (:267), the LARFB alone (B15's
// larfb, B14's couple_apply and B15's ssrfb are K4/K3 at other shapes).
// The TPU held one nb x nb strip tile per program in VMEM and walked the
// couples in a sequential grid.
//
// What bounds it on the H100: its operations, about 4 rows nb width flops
// a couple (the two products with V2) plus 2 nb^2 width (op(T2) W), at 67
// TFLOP/s in fp32 (0.924 ms at the hh path's panel 0: 7 couples of 1024
// rows, 7936 columns), or P bf16 passes at 989 TFLOP/s in the split modes,
// where C's bytes read and written are the larger term.
//
// The design: a couple's projection V2_q^T C_bot_q and its update C_bot_q
// -= V2_q W2_q touch only its own rows, so only the small chain through
// C_top is serial. A call is three launches on the caller's stream:
//   1. proj_*_kernel: every couple's projection P_q = V2_q^T C_bot_q at
//      once, tiles of P_q (tile_gemm.cuh: 128 x 128 fp32 / 128 x 64 split,
//      or 64 x 64 where those leave the card idle) with the couple's rows
//      cut into G groups of whole 32-row stages where the tiles alone
//      leave SMs idle (kernels/chain.py:strip_plan, from the shapes and the
//      SM count); each group's partial is a plain fmaf chain (no Kahan
//      compensation, as tileqr's ssrfb_body has none).
//   2. chain_kernel: a cluster of `bands` CTAs (1, 2 or 4: the card's SMs
//      over the strip's 64-column blocks, kernels/chain.py:strip_plan) owns
//      64 columns of the strip (which stays in L2) and walks the couples in
//      order (reversed when `reverse`), CTA b on its row band of W and the
//      strip, the bands meeting at a cluster barrier between steps: W =
//      C_top + (P_q,0 + P_q,1 + ...), the groups added in group order; W2
//      = op(T2_q) W by the block's tile product (T2 read K-major, or
//      M-major for op = transpose: `trans` is read in the staging, with no
//      transposed copy), each row tile over the k where its rows of the
//      triangular op(T2_q) are not zero; C_top -= W2; W2 stored for stage
//      3. The fused LARFB runs here too, before the couples or after them:
//      three products of the slab, V^T C, op(T) W and C -= V W2, with V =
//      unit_lower(vkk) read through the routines' `unit` mask, each over
//      its triangle likewise. K4 is this launch with no couples.
//   3. tq_sub_launch (panel_apply.cu, the whole-panel apply's phase 2):
//      every couple's C_bot_q -= V2_q W2_q in one batched launch.
// The wrappers count a call once, whatever it launches. fp32 sum orders:
// each P entry one fmaf chain over the couple's rows ascending from 0,
// then top + acc; op(T) W a chain over k from 0 (the skipped k multiply
// the triangle's exact zeros, so the same bits at any band count); top -
// W2; C_bot's update a chain over nb from 0, then x - acc; the LARFB's
// products likewise: the orders of the one-slab-per-block kernel this
// replaces, so at G = 1 its bits. The workspace (strip_plan's floats,
// allocated by the wrapper): couples x G x nb x width partials, couples x
// nb x width W2, and 2 x nb x width for the fused LARFB.
#include "tile_gemm.cuh"

namespace {

constexpr int SC = tg::WBN;  // stage 2's strip columns a block
constexpr int CH_THREADS = 256;
static_assert(tg::F_THREADS == CH_THREADS, "stage 2 runs both routes on 256 threads");

// rows of each of stage 1's groups (the last may be shorter): whole 32-row
// stages (kernels/chain.py:group_rows)
int group_rows(int rows, int groups) { return tg::ceil_div(tg::ceil_div(rows, groups), 32) * 32; }

// ---- stage 1: the couples' projections ----

// Block (x, y, z): P rows BM x.., columns BN y.. of couple q = z / G, group
// g = z % G, over that group's rows; P_q,g at p + z nb width.
template <int BM, int BN>
__global__ void __launch_bounds__(tg::F_THREADS)
proj_f32_kernel(const float* v, const float* c, long long ldc, int rows, int nb, int width,
                int groups, int grows, float* p, int vec) {
  extern __shared__ __align__(16) float smf[];
  const int z = blockIdx.z, q = z / groups, k0 = (z - q * groups) * grows;
  float* out = p + (long long)z * nb * width;
  tg::f32_tile<BM, BN, false>(smf, {v + (long long)q * rows * nb, nb},
                              {c + (long long)q * rows * ldc, ldc}, nb, width, k0,
                              min(rows, k0 + grows), blockIdx.x * BM, blockIdx.y * BN, vec, false,
                              tg::Store{out, width});
}

template <int P, int BM>
__global__ void __launch_bounds__(2 * BM, 1)
proj_wg_kernel(const float* v, const float* c, long long ldc, int rows, int nb, int width,
               int groups, int grows, float* p, int vec) {
  extern __shared__ __align__(128) unsigned char smw[];
  const int z = blockIdx.z, q = z / groups, k0 = (z - q * groups) * grows;
  float* out = p + (long long)z * nb * width;
  tg::wg_tile<P, BM, false>(smw, {v + (long long)q * rows * nb, nb},
                            {c + (long long)q * rows * ldc, ldc}, nb, width, k0,
                            min(rows, k0 + grows), blockIdx.x * BM, blockIdx.y * tg::WBN, vec,
                            false, tg::Store{out, width});
}

// ---- stage 2: the chain through the strip ----

struct Chain {
  const float* t2;   // couple q's T2 at t2 + q nb^2
  float* p;          // stage 1's partials: couple q's group g at p + (q G + g) nb width; W in group 0's
  float* w2;         // couple q's W2 at w2 + q nb width (stage 3's operand)
  float* top;        // the strip (nb x width, row stride lds)
  long long lds;
  const float* vkk;  // the fused LARFB's packed V and its T, or null
  const float* tgk;
  float* x1;         // the LARFB's W and W2 (nb x width each)
  float* x2;
  int nb, width, couples, groups, trans, reverse, vec;
  int bands;         // CTAs (row bands) of each 64-column block: one cluster
};

// The epilogue of a slab product (tile_gemm.cuh's interface): D stored
// into `store`, subtracted from `sub`, or both (one type, so each route
// builds one copy of its tile routine per operand layout). `sub` is read
// through L2 (__ldcg), as is everything a block reads of its own rows, so
// no L1 line of the strip can go stale under another band's writes.
struct SlabEpi {
  float* store;
  long long ld_store;
  float* sub;
  long long ld_sub;
  __device__ __forceinline__ float pre(int i, int j) const {
    return sub != nullptr ? __ldcg(sub + (long long)i * ld_sub + j) : 0.f;
  }
  __device__ __forceinline__ void operator()(int i, int j, float v, float old) const {
    if (sub != nullptr) sub[(long long)i * ld_sub + j] = old - v;
    if (store != nullptr) store[(long long)i * ld_store + j] = v;
  }
};

// rows of each band tile: 128 where the bands leave each CTA a whole
// 128-row tile, else 64 (kernels/chain.py:band_rows)
int band_rows(int nb, int bands) { return nb >= 128 * bands ? 128 : 64; }

// the cluster's barrier: every thread's earlier global writes (its band of
// W, X1 or X2, or of the strip) visible to every thread of the cluster
__device__ __forceinline__ void band_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// D = A B on the block's band of the slab (columns j0.., its row tiles of
// TH rows: tiles band, band + bands, ...), each tile over the k where its
// rows of A are not zero: from its first row to nb where A is upper
// triangular in its rows, from 0 to its last row where lower. The terms
// skipped multiply A's exact zeros, so each D entry is the same fmaf chain
// (the same k16 products on wgmma) as over all nb k: the same bits.
template <int P, int TH, bool KMAJ>
__device__ __forceinline__ void band_gemm(unsigned char* sm, tg::Opnd a, tg::Opnd b, int nb,
                                          int width, int j0, int band, int bands, bool upper,
                                          bool vec, bool unit, SlabEpi epi) {
  for (int i0 = band * TH; i0 < nb; i0 += bands * TH) {
    const int m = min(nb, i0 + TH), k0 = upper ? i0 : 0, k1 = upper ? nb : m;
    if constexpr (P == 0)
      tg::f32_tile<TH, SC, KMAJ>(reinterpret_cast<float*>(sm), a, b, m, width, k0, k1, i0, j0,
                                 vec, unit, epi);
    else  // 128-row tiles (two warpgroups), clipped to the band's TH rows
      tg::wg_tile<P, 128, KMAJ>(sm, a, b, m, width, k0, k1, i0, j0, vec, unit, epi);
  }
}

// Block x: strip columns 64 (x / bands).. through the LARFB (when vkk) and
// the couples, as one loop of slab products with one call site of each
// operand layout (the routines are inlined: a wgmma pipeline may not cross
// a call). The `bands` CTAs of a cluster share the block's columns and
// split its rows (band_gemm); between a step's writes and the next step's
// reads of other bands' rows they meet at the cluster's barrier. The steps:
// the LARFB's W = V^T top (V = unit_lower(vkk), read M-major), W2 = op(T)
// W, top -= V W2, before the couples (forward) or after them; couple q: W
// = top + (P_q,0 + P_q,1 + ...) into group 0's partial (the band's rows),
// then W2 = op(T2_q) W with top -= W2 and W2 kept for stage 3. op(T) reads
// T M-major (T^T, lower triangular) when trans, else K-major (T, upper).
template <int P, int TH>
__global__ void __launch_bounds__(CH_THREADS, 1) chain_kernel(Chain ch) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int bands = ch.bands, band = bands > 1 ? cta_rank() : 0;
  const int j0 = (blockIdx.x / bands) * SC, nb = ch.nb, width = ch.width;
  const long long plane = (long long)nb * width, lds = ch.lds;
  const int larfb = ch.vkk != nullptr ? 3 : 0;
  const int first = ch.reverse ? 0 : larfb;  // the LARFB's steps before the couples
  for (int step = 0; step < ch.couples + larfb; ++step) {
    const int ii = step - first;
    tg::Opnd a, b;
    SlabEpi epi{nullptr, 0, nullptr, 0};
    bool kmaj = !ch.trans, unit = false;
    if (ii >= 0 && ii < ch.couples) {
      const int q = ch.reverse ? ch.couples - 1 - ii : ii;
      float* w = ch.p + (long long)q * ch.groups * plane;
      // the band's rows of W (the slab product below synchronises the
      // block, or the barrier the cluster, before W is read)
      for (int i0 = band * TH; i0 < nb; i0 += bands * TH) {
        const int rows = min(TH, nb - i0);
        if (ch.vec) {  // 4 columns a thread (width % 4 == 0: all or none exist)
          for (int idx = threadIdx.x; idx < rows * (SC / 4); idx += CH_THREADS) {
            const int i = i0 + idx / (SC / 4), j = j0 + 4 * (idx % (SC / 4));
            if (j >= width) continue;
            const long long o = (long long)i * width + j;
            float4 acc = __ldcg(reinterpret_cast<const float4*>(w + o));
            for (int g = 1; g < ch.groups; ++g) {
              const float4 x = __ldcg(reinterpret_cast<const float4*>(w + g * plane + o));
              acc.x = acc.x + x.x, acc.y = acc.y + x.y, acc.z = acc.z + x.z, acc.w = acc.w + x.w;
            }
            const float4 t = __ldcg(reinterpret_cast<const float4*>(ch.top + (long long)i * lds + j));
            *reinterpret_cast<float4*>(w + o) =
                make_float4(t.x + acc.x, t.y + acc.y, t.z + acc.z, t.w + acc.w);
          }
        } else {
          for (int idx = threadIdx.x; idx < rows * SC; idx += CH_THREADS) {
            const int i = i0 + idx / SC, j = j0 + idx % SC;
            if (j >= width) continue;
            const long long o = (long long)i * width + j;
            float acc = __ldcg(w + o);
            for (int g = 1; g < ch.groups; ++g) acc = acc + __ldcg(w + g * plane + o);
            w[o] = __ldcg(ch.top + (long long)i * lds + j) + acc;
          }
        }
      }
      a = {ch.t2 + (long long)q * nb * nb, nb};
      b = {w, width};
      epi = {ch.w2 + (long long)q * plane, width, ch.top, lds};
    } else {
      const int l = ii < 0 ? step : ii - ch.couples;  // the LARFB's step
      if (l == 0) {
        a = {ch.vkk, nb};
        b = {ch.top, lds};
        epi = {ch.x1, width, nullptr, 0};
        kmaj = false;
        unit = true;
      } else if (l == 1) {
        a = {ch.tgk, nb};
        b = {ch.x1, width};
        epi = {ch.x2, width, nullptr, 0};
      } else {
        a = {ch.vkk, nb};
        b = {ch.x2, width};
        epi = {nullptr, 0, ch.top, lds};
        kmaj = true;
        unit = true;
      }
    }
    // every product reads other bands' rows of B, written by this launch
    // but where the LARFB leads (the strip, as the call found it)
    if (bands > 1 && (step > 0 || ii >= 0)) band_sync();
    // A upper triangular in its rows: T2, T (K-major), V^T (M-major, unit);
    // lower: T2^T, T^T (M-major), V (K-major, unit)
    const bool upper = unit ? !kmaj : kmaj;
    if (kmaj)
      band_gemm<P, TH, true>(sm, a, b, nb, width, j0, band, bands, upper, ch.vec, unit, epi);
    else
      band_gemm<P, TH, false>(sm, a, b, nb, width, j0, band, bands, upper, ch.vec, unit, epi);
  }
}

template <class K, class... Args>
int launch(K kernel, size_t smem, dim3 grid, int threads, cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int TH>
constexpr size_t chain_f32_smem() {
  return tg::f32_smem<TH, SC, true>() > tg::f32_smem<TH, SC, false>() ? tg::f32_smem<TH, SC, true>()
                                                                      : tg::f32_smem<TH, SC, false>();
}

// the chain as ceil(width / 64) clusters of ch.bands CTAs (no cluster at 1
// band)
template <class K>
int launch_bands(K kernel, size_t smem, const Chain& ch, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ch.bands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tg::ceil_div(ch.width, SC) * ch.bands, 1, 1);
  cfg.blockDim = dim3(CH_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = ch.bands > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, ch);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// 1, 2 or 4 bands; more than one only on whole 64-row tiles (nb % 64 == 0:
// the bands' rows and the workspace's planes then start on whole L2
// lines), each CTA holding one at least (kernels/chain.py:chain_bands)
bool bands_ok(int nb, int bands) {
  if (bands == 1) return true;
  if (bands != 2 && bands != 4) return false;
  return nb % 64 == 0 && nb / band_rows(nb, bands) >= bands;
}

int launch_chain(const Chain& ch, int passes, cudaStream_t st) {
  const bool wide = band_rows(ch.nb, ch.bands) == 128;
  const size_t wg = tg::wg_smem<128>();
  switch (passes) {
    case 0: return wide ? launch_bands(&chain_kernel<0, 128>, chain_f32_smem<128>(), ch, st)
                        : launch_bands(&chain_kernel<0, 64>, chain_f32_smem<64>(), ch, st);
    case 1: return launch_bands(wide ? &chain_kernel<1, 128> : &chain_kernel<1, 64>, wg, ch, st);
    case 3: return launch_bands(wide ? &chain_kernel<3, 128> : &chain_kernel<3, 64>, wg, ch, st);
    case 4: return launch_bands(wide ? &chain_kernel<4, 128> : &chain_kernel<4, 64>, wg, ch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_proj(int passes, int tm, int tn, const float* v, const float* c, long long ldc,
                int rows, int nb, int width, int couples, int groups, int grows, float* p,
                int vec, cudaStream_t st) {
  const dim3 grid(tg::ceil_div(nb, tm), tg::ceil_div(width, tn), couples * groups);
  const bool big = tm == 128;
#define TQ_PROJ(K, SMEM, THREADS) \
  launch(K, SMEM, grid, THREADS, st, v, c, ldc, rows, nb, width, groups, grows, p, vec)
  switch (passes) {
    case 0:
      return big ? TQ_PROJ((proj_f32_kernel<128, 128>), (tg::f32_smem<128, 128, false>()), 256)
                 : TQ_PROJ((proj_f32_kernel<64, 64>), (tg::f32_smem<64, 64, false>()), 256);
    case 1:
      return big ? TQ_PROJ((proj_wg_kernel<1, 128>), tg::wg_smem<128>(), 256)
                 : TQ_PROJ((proj_wg_kernel<1, 64>), tg::wg_smem<64>(), 128);
    case 3:
      return big ? TQ_PROJ((proj_wg_kernel<3, 128>), tg::wg_smem<128>(), 256)
                 : TQ_PROJ((proj_wg_kernel<3, 64>), tg::wg_smem<64>(), 128);
    case 4:
      return big ? TQ_PROJ((proj_wg_kernel<4, 128>), tg::wg_smem<128>(), 256)
                 : TQ_PROJ((proj_wg_kernel<4, 64>), tg::wg_smem<64>(), 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TQ_PROJ
}

bool mode_ok(int passes) { return passes == 0 || passes == 1 || passes == 3 || passes == 4; }

}  // namespace

// K3: apply n_chunks couples (slots stack_base.. of v_stack (B x block_rows
// x nb) and t2_stack (B x nb x nb); C rows of row block base_block + q,
// columns col_start nb..) to (strip, C), in place; vkk/tg (both or
// neither): the fused LARFB. passes: 0 ("highest"), 1 ("default"), 3
// ("b3"/"high") or 4 ("b4"). The plan (kernels/chain.py:strip_plan): stage
// 1's tile proj_tm x proj_tn and G groups (G = ceil(block_rows /
// group_rows(block_rows, G))), stage 3's tile sub_tm x sub_tn, stage 2's
// row bands (bands_ok); work holds its workspace. Any other tile, G or
// band count is refused.
extern "C" int tq_couple_strip(const float* v_stack, const float* t2_stack, float* c,
                               long long ldc, float* strip, long long lds, int width,
                               int stack_base, int base_block, int n_chunks, int block_rows,
                               int nb, int col_start, int trans, int reverse, const float* vkk,
                               const float* tgk, int passes, float* work, int proj_tm,
                               int proj_tn, int groups, int sub_tm, int sub_tn, int bands,
                               void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  if (!mode_ok(passes) || width < 1 || nb < 1 || n_chunks < 0 || !bands_ok(nb, bands) ||
      (vkk == nullptr) != (tgk == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 &&
      (block_rows < 1 || groups < 1 || !tq_tile_ok(proj_tm, proj_tn, passes) ||
       !tq_tile_ok(sub_tm, sub_tn, passes) || n_chunks * (long long)groups > 65535 ||
       tg::ceil_div(block_rows, group_rows(block_rows, groups)) != groups))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0 && vkk == nullptr) return 0;
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)nb * width;
  float* p = work;
  float* w2 = p + (long long)n_chunks * groups * plane;
  float* x1 = w2 + (long long)n_chunks * plane;
  const float* v = v_stack + (long long)stack_base * block_rows * nb;
  float* cb = c + (long long)base_block * block_rows * ldc + (long long)col_start * nb;
  const bool vec_shape = nb % 4 == 0 && width % 4 == 0;
  int e = 0;
  if (n_chunks > 0) {
    const int vec = vec_shape && tg::aligned16(v) && tg::aligned16(cb) && ldc % 4 == 0;
    e = launch_proj(passes, proj_tm, proj_tn, v, cb, ldc, block_rows, nb, width, n_chunks,
                    groups, group_rows(block_rows, groups), p, vec, st);
    if (e != 0) return e;
  }
  Chain ch;
  ch.t2 = t2_stack + (long long)stack_base * nb * nb;
  ch.p = p, ch.w2 = w2, ch.top = strip, ch.lds = lds, ch.vkk = vkk, ch.tgk = tgk;
  ch.x1 = x1, ch.x2 = x1 + plane;
  ch.nb = nb, ch.width = width, ch.couples = n_chunks, ch.groups = groups;
  ch.trans = trans, ch.reverse = reverse, ch.bands = bands;
  ch.vec = vec_shape && lds % 4 == 0 && tg::aligned16(strip) && tg::aligned16(ch.t2) &&
           tg::aligned16(work) && (vkk == nullptr || (tg::aligned16(vkk) && tg::aligned16(tgk)));
  e = launch_chain(ch, passes, st);
  if (e != 0 || n_chunks == 0) return e;
  return tq_sub_launch(v, (long long)block_rows * nb, w2, width, plane, cb, ldc,
                       (long long)block_rows * ldc, block_rows, width, nb, n_chunks, sub_tm,
                       sub_tn, passes, st);
}

// K4: strip (nb x width, row stride lds) <- (I - V T V^T)^{T?} strip, V =
// unit_lower(vkk), in place, on `bands` row bands; work holds 2 nb width
// floats.
extern "C" int tq_larfb_strip(const float* vkk, const float* tgk, float* strip, long long lds,
                              int width, int nb, int trans, int passes, float* work, int bands,
                              void* stream_) {
  if (!mode_ok(passes) || width < 1 || nb < 1 || vkk == nullptr || tgk == nullptr ||
      work == nullptr || !bands_ok(nb, bands))
    return (int)cudaErrorInvalidValue;
  Chain ch;
  ch.t2 = nullptr, ch.p = nullptr, ch.w2 = nullptr;
  ch.top = strip, ch.lds = lds, ch.vkk = vkk, ch.tgk = tgk;
  ch.x1 = work, ch.x2 = work + (long long)nb * width;
  ch.nb = nb, ch.width = width, ch.couples = 0, ch.groups = 1, ch.trans = trans, ch.reverse = 0;
  ch.bands = bands;
  ch.vec = nb % 4 == 0 && width % 4 == 0 && lds % 4 == 0 && tg::aligned16(strip) &&
           tg::aligned16(vkk) && tg::aligned16(tgk) && tg::aligned16(work);
  return launch_chain(ch, passes, static_cast<cudaStream_t>(stream_));
}
