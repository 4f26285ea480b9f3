// Float32 instantiations of the layer GEMMs on Hopper (sm_90a).
//
// The default model configuration computes in float32 (ModelConfig.
// compute_dtype), and the reference's Pallas kernels follow their inputs'
// dtype (nylon_amt_tpu/ops/layer_fused.py: _matmul and _layer_norm cast to
// x.dtype; the TPU kernel takes dot_general(x, w,
// preferred_element_type=f32) on f32 operands, :97-102). These kernels are
// the f32 twins of the bf16 GEMMs, for the same TPU kernels:
//
//  * gemm_bias_f32_kernel <- layer_fused.cu's gemm_bias_kernel: the QKV,
//    cross Q and K/V and FFN-up projections of encoder_layer (K3),
//    decoder_layer_zero (K4), decoder_layer (K5), the first layer of
//    encoder_layer_with_stem (K2) and the training forwards K7-K9 (with a
//    dropout site);
//  * gemm_res_ln_f32_kernel <- gemm_res_ln_kernel: O projection and FFN
//    down with the residual and the shared post-LayerNorm in the epilogue
//    (a block owns whole rows, N <= 256), with the pre-LN sum for the
//    backward (kTrain);
//  * gemm_nt_f32_kernel <- layer_fused_train.cu's gemm_nt_kernel: the dX
//    GEMMs of the K7-K9 backward with their mask, ReLU-gate and residual
//    epilogues (nt_epilogue), on gemm_bias_f32_kernel's mainloop;
//  * wgrad_f32_kernel <- wgrad_kernel: dW = A^T dY per row chunk into f32
//    partials (with the bias gradient's column sums), summed in a fixed
//    order by layer_fused_train.cu's reduce_rows: no float atomics, the
//    same bits from run to run.
//
// The two forward GEMMs and dX run on the tensor cores: gemm_sm90.cuh's
// TF32 mainloop (TMA ring of 32-deep stages, a producer warpgroup, two
// consumer warpgroups, wgmma m64nNk8 .tf32 with A split in registers) as
// 3xTF32 (tf32.cuh), the weights packed once on the host as K-major TF32
// pairs (ops/layer_fused.py::pack_tf32): w_big, w_small [N, K] (w^T) for
// the forward, [Kout, N] (w itself) for dX = dY w^T. dW = A^T dY reduces
// over rows and gets both operands MN-major, which TF32 wgmma does not read
// from shared memory: A^T is its register operand, and the consumers
// re-stage each landed dY tile as a K-major TF32 pair (tma_ring.cuh feeds
// the raw tiles).
// What bounds them: at the paper widths (hid 256, pf 512) the 3xTF32
// products (3 x 2MNK at 494.7 TFLOP/s) and the f32 bytes (4 (MK + MN [+ MN
// residual or side input])) come within 0.8-2x of each other: QKV, FFN-up
// and most dX / dW products are bound by operations, O and FFN down by
// bytes; the default widths (hid 64) by bytes. A single f32 FFMA core (67
// TFLOP/s) is 2.5x further from both.
//
// Tiles, shared memory and registers (the kernels on RingTf32: 384
// threads, two consumer warpgroups and a producer warpgroup, whose first
// warp issues the TMA loads; 227 KB of shared memory a block; no spills, no
// stack: chip_smoke.py (a) checks). ptxas gives each thread 168 registers;
// the producer warpgroup gives 128 of them back (setmaxnreg: 40) and the
// consumers take them (232: setmaxnreg.inc takes only what the block's own
// dec gave back, so a lone producer warp could not feed it, and the
// consumers waited for ever):
//  * gemm_bias_f32_kernel: 128 rows x BN columns a tile (BN = 32, 64, 96
//    or 128: N in the fewest tiles of <= 128), warpgroup g the rows 64 g ..
//    64 g + 63 at all BN columns. A stage is 16 KB of A + 2 x BN x 128
//    bytes of the pair (48 KB at BN 128: 4 stages, 193 KB). Registers: the
//    m64n128 sum and the chain's accumulator (2 x 64), the split A
//    fragments of a stage (32), the addressing. The epilogue stores float2
//    pairs straight from the fragments (a quad of lanes writes one 32-byte
//    sector of a row).
//  * gemm_res_ln_f32_kernel: 64 rows x BN (64, 128 or 256) a tile, the
//    columns split between the warpgroups (g owns BN / 2 of them: a 64 x
//    256 sum and its chain's accumulator would take 256 registers), the
//    row statistics of the two halves combined through shared memory in a
//    fixed order (half 0 + half 1). A stage is 8 KB of A + 2 x BN x 128
//    bytes (72 KB at BN 256: 3 stages, 221 KB with bias, gamma and beta
//    staged once a block). The residual is read from device memory into
//    registers as the fragments' float2 pairs: all of it before the tile's
//    mainloop at BN <= 128, a quarter at BN 256 and the rest once the
//    mainloop has ended (the training variants a quarter at a time, a
//    quarter ahead); then the two-pass LayerNorm, then pre_out / out as
//    float2 pairs.
//  * gemm_nt_f32_kernel: gemm_bias_f32_kernel's tiles (BN from Kout), the
//    side input (ReLU gate or addend) read from device memory as float2
//    pairs in the epilogue.
//  * wgrad_f32_kernel: 256 threads, two consumer warpgroups and no
//    producer warp (thread 0 issues the loads, tma_ring.cuh: the m64n128
//    sum beside its chain's accumulator takes more than the 168 registers
//    a block with a ninth warp gets), no setmaxnreg; one block an SM, a
//    grid of dW tiles x row chunks in one wave (ops/layer_fused_train.py::
//    wgrad_plan); BM x BN = 64 or 128 each (from Ka and N); a stage of 32
//    rows (BM / 32 + BN / 32 boxes of 4 KB), 4 stages, then two re-staged
//    pair buffers of 2 x BN x 128 bytes (197 KB in all at 128 x 128).
//
// Numerics: the epilogues are layer_epilogue.cuh's f32 ones, the same op
// sequence as the bf16 kernels with every rounding to the compute dtype an
// identity. The products differ from IEEE f32 only by 3xTF32's dropped
// small*small term (~2^-22 of a product), the tensor core's summation
// order and its accumulation over a chain, which is kept to one k-block
// (12 wgmmas) and summed in f32 (RingTf32::mma3): one chain a tile over all of K read 2-4x the plain f32
// twin's float64 distance and failed chip_smoke.py (n.4)'s stage-2 gate on
// the paper forward (PERF.md). (q) holds the forward GEMMs and (r) dX / dW
// at every shape within their gates and prints the distances from a
// float64 truth. There is no split K and no atomic: two runs are
// bit-identical.
//
// gemm_bias_ffma_kernel: the QKV projection of the stem layer (K2, and the
// training layer the stem feeds), where the attention scores reach ~2^14 in
// log2 units. The layer holds chip_smoke.py (n.2)'s 2e-5 of the plain f32
// twin only with the plain GEMM's IEEE f32 products summed over k in
// ascending order: with its QKV as 3xTF32 it reads 1.4e-4 (default widths)
// and 4.3e-4 (paper), with exact products and f64 sums on the FP64 tensor
// cores (closer to a float64 truth than the twin) 7.8e-5 and 2.4e-4
// (PERF.md). So it multiplies on the CUDA cores, one fmaf chain over k per
// output: A [M, K] (128-byte swizzle, 32 k a row) and W [K, N] (as it is
// kept) by TMA into a ring of 2-3 stages that thread 0 fills ahead of the
// warps (tma_ring.cuh), 8 x 8 register tiles (A read as float4 along k: 4
// k steps a load), 256 threads, two blocks an SM (128 registers),
// persistent over the tiles. Bound: FFMA issue, 67 TFLOP/s.

#include "gemm_sm90.cuh"
#include "tma_ring.cuh"
#include "hash_mask.cuh"
#include "layer_epilogue.cuh"

using nylon::DropSite;
using nylon::keep_value;
using nylon::NtEpilogue;
namespace sm = nylon::sm90;
using sm::Frag;

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------ GEMM + bias, TF32 --

constexpr int kBiasRows = 128;  // gemm_bias: rows of a tile
// registers a thread: the producer warpgroup's, and the consumers' (at 128
// columns a warpgroup the chain's accumulator beside the sum, 2 x 64, + 32
// of split A do not fit in the 168 ptxas gives each of 384 threads)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// out[M, N] = (a[M, K] @ w) + bias [, ReLU] [, x keep of `site`], w read
// as its TF32 pair w_big, w_small [N, K]. Tile t is (row block t /
// n_tiles_n, column block t % n_tiles_n).
template <int BN, bool kDrop>
__global__ void __launch_bounds__(sm::kThreadsTf32, 1)
    gemm_bias_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_big,
                         const __grid_constant__ CUtensorMap map_small,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int M, int N, int K,
                         int relu, int n_tiles_n, DropSite site) {
  extern __shared__ uint8_t smem_raw[];
  sm::RingTf32<kBiasRows, BN, 0> ring(smem_raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBKTf32 - 1) / sm::kBKTf32;
  const long long tiles =
      (long long)n_tiles_n * ((M + kBiasRows - 1) / kBiasRows);

  if (warp >= sm::kConsumerWarps) {  // the producer warpgroup
    sm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == sm::kConsumerWarps * 32) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_big);
      sm::tma_prefetch(&map_small);
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (int)(t / n_tiles_n) * kBiasRows;
        const int n0 = (int)(t % n_tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb)
          ring.load(&map_a, &map_big, &map_small, m0, n0, kb);
      }
    }
  } else {
    sm::reg_alloc<kConsumerRegs>();
    const int g = warp >> 2;
    const Frag f(threadIdx.x & 127);
    float acc[BN / 2];
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (int)(t / n_tiles_n) * kBiasRows;
      const int n0 = (int)(t % n_tiles_n) * BN;
      ring.template mma3<BN>(acc, nk, 64 * g, 0);
      const int row0 = m0 + 64 * g + f.r0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * f.q;
        if (col >= N) continue;
        const float2 b = ldg2(bias + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
          if (row >= M) continue;
          st2(out + (size_t)row * N + col,
              nylon::bias_epilogue<float, kDrop>(acc[4 * j + 2 * i], b.x,
                                                 relu, site, (uint32_t)row,
                                                 col, N),
              nylon::bias_epilogue<float, kDrop>(acc[4 * j + 2 * i + 1], b.y,
                                                 relu, site, (uint32_t)row,
                                                 col + 1, N));
        }
      }
    }
  }
}

// ------------------------------- GEMM + residual + shared LayerNorm, TF32 --

constexpr int kLnRows = 64;  // gemm_res_ln: rows of a tile
template <int BN>
constexpr int kLnExtra = (2 * 2 * kLnRows + 3 * BN) * 4;

// out[M, N] = LN(res + (a @ w + bias) [x keep]) * gamma + beta for N <= BN,
// w read as its TF32 pair w_big, w_small [N, K]: a block tile holds
// kLnRows full rows, warpgroup g columns g BN / 2 .. (g + 1) BN / 2 - 1.
// kTrain: the pre-LN sum to pre_out when it is not null, and out may be
// null.
template <int BN, bool kDrop, bool kTrain>
__global__ void __launch_bounds__(sm::kThreadsTf32, 1)
    gemm_res_ln_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_big,
                           const __grid_constant__ CUtensorMap map_small,
                           const float* __restrict__ bias,
                           const float* __restrict__ res,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           float* __restrict__ out,
                           float* __restrict__ pre_out, int M, int N, int K,
                           float eps, DropSite site) {
  constexpr int WN = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  // the extra area: the row statistics of the two halves, [pass][g][row],
  // then bias, gamma and beta
  sm::RingTf32<kLnRows, BN, kLnExtra<BN>> ring(smem_raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBKTf32 - 1) / sm::kBKTf32;
  const int tiles = (M + kLnRows - 1) / kLnRows;

  if (warp >= sm::kConsumerWarps) {  // the producer warpgroup
    sm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == sm::kConsumerWarps * 32) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_big);
      sm::tma_prefetch(&map_small);
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int kb = 0; kb < nk; ++kb)
          ring.load(&map_a, &map_big, &map_small, t * kLnRows, 0, kb);
    }
  } else {
    sm::reg_alloc<kConsumerRegs>();
    const int g = warp >> 2;
    const Frag f(threadIdx.x & 127);
    float* const red = reinterpret_cast<float*>(ring.extra());
    // bias, gamma and beta of the warpgroup's columns, to shared memory once
    float* const s_bias = red + 4 * kLnRows;
    float* const s_gamma = s_bias + BN, *const s_beta = s_gamma + BN;
    for (int c = threadIdx.x; c < N; c += 256) {
      s_bias[c] = bias[c];
      s_gamma[c] = gamma[c];
      s_beta[c] = beta[c];
    }
    sm::named_sync(1, 256);
    const float inv_n = 1.f / (float)N;
    const bool pre = kTrain && pre_out != nullptr;
    const bool has_out = !kTrain || out != nullptr;
    // the residual pairs of a fragment: the first kPre column blocks loaded
    // before the tile's mainloop (in flight under it), the others once it
    // has ended, kRest at a time, a chunk ahead of their use (at 128 columns
    // a warpgroup, 64 registers of residual would not fit beside the
    // mainloop's, nor 48 beside the training epilogue's)
    constexpr int kJ = WN / 8, kPre = kJ <= 8 ? kJ : 4;
    constexpr int kRest = kJ == kPre ? 1 : kTrain ? 4 : kJ - kPre;
    float2 rv[kJ][2];
    const auto load_res = [&](int m0, int j0, int j1) {
#pragma unroll
      for (int j = j0; j < j1; ++j) {
        const int col = g * WN + 8 * j + 2 * f.q;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + f.r0 + 8 * i;
          rv[j][i] = col < N && row < M ? ldg2(res + (size_t)row * N + col)
                                        : make_float2(0.f, 0.f);
        }
      }
    };
    float acc[WN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t * kLnRows;
      load_res(m0, 0, kPre);
      ring.template mma3<WN>(acc, nk, 0, g * WN);
      if constexpr (kPre < kJ) load_res(m0, kPre, kPre + kRest);

      // s = res + (acc + bias) [x keep], in place of acc; row sums
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j >= kPre && (j - kPre) % kRest == 0 && j + kRest < kJ)
          load_res(m0, j + kRest, j + 2 * kRest);  // the next chunk
        const int col = g * WN + 8 * j + 2 * f.q;
        if (col >= N) continue;
        const float2 b = *reinterpret_cast<const float2*>(s_bias + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + f.r0 + 8 * i;
          const float s0 = nylon::residual_sum<float, kDrop>(
              acc[4 * j + 2 * i], b.x, rv[j][i].x, site, (uint32_t)row, col,
              N);
          const float s1 = nylon::residual_sum<float, kDrop>(
              acc[4 * j + 2 * i + 1], b.y, rv[j][i].y, site, (uint32_t)row,
              col + 1, N);
          acc[4 * j + 2 * i] = s0;
          acc[4 * j + 2 * i + 1] = s1;
          if (pre && row < M) st2(pre_out + (size_t)row * N + col, s0, s1);
          sum[i] += s0 + s1;
        }
      }
      // the mean: the quad's sums, then the two halves of the row in order
      float mean[2], rstd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        if (f.q == 0) red[g * kLnRows + f.r0 + 8 * i] = sum[i];
      }
      sm::named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mean[i] = (red[f.r0 + 8 * i] + red[kLnRows + f.r0 + 8 * i]) * inv_n;
      float sq[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        if (g * WN + 8 * j + 2 * f.q >= N) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d0 = acc[4 * j + 2 * i] - mean[i];
          const float d1 = acc[4 * j + 2 * i + 1] - mean[i];
          sq[i] += d0 * d0 + d1 * d1;
        }
      }
      float* const red2 = red + 2 * kLnRows;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 1);
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 2);
        if (f.q == 0) red2[g * kLnRows + f.r0 + 8 * i] = sq[i];
      }
      sm::named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        rstd[i] = rsqrtf(
            (red2[f.r0 + 8 * i] + red2[kLnRows + f.r0 + 8 * i]) * inv_n +
            eps);
      if (!has_out) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = g * WN + 8 * j + 2 * f.q;
        if (col >= N) continue;
        const float2 ga = *reinterpret_cast<const float2*>(s_gamma + col);
        const float2 be = *reinterpret_cast<const float2*>(s_beta + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + f.r0 + 8 * i;
          if (row >= M) continue;
          st2(out + (size_t)row * N + col,
              (acc[4 * j + 2 * i] - mean[i]) * rstd[i] * ga.x + be.x,
              (acc[4 * j + 2 * i + 1] - mean[i]) * rstd[i] * ga.y + be.y);
        }
      }
    }
  }
}

// -------------------------------------------------------------- launch ----

// The tile width of gemm_bias_f32_kernel for an output N columns wide: N in
// the fewest tiles of at most 128 columns, each a multiple of 32.
inline int bias_tile_width(int N) {
  const int tiles = (N + 127) / 128;
  return ((N + tiles - 1) / tiles + 31) / 32 * 32;
}

// The maps of A [M, K] (box_rows a box) and of the two halves of the
// weight's TF32 pair, w_big and w_small [N, K] (BN rows a box).
inline int encode_tf32(CUtensorMap* ma, CUtensorMap* mb, CUtensorMap* ms,
                       const void* a, const void* w_big,
                       const void* w_small, int M, int N, int K,
                       int box_rows, int bn) {
  int e = sm::encode_f32(ma, a, M, K, box_rows);
  if (!e) e = sm::encode_f32(mb, w_big, N, K, bn);
  if (!e) e = sm::encode_f32(ms, w_small, N, K, bn);
  return e;
}

template <int BN, bool kDrop>
int launch_gemm_bias(const void* a, const void* wb, const void* ws,
                     const void* bias, void* out, int M, int N, int K,
                     int relu, DropSite site, cudaStream_t stream) {
  CUtensorMap ma, mb, ms;
  int e = encode_tf32(&ma, &mb, &ms, a, wb, ws, M, N, K, kBiasRows, BN);
  const int n_tiles_n = (N + BN - 1) / BN;
  const long long tiles =
      (long long)n_tiles_n * ((M + kBiasRows - 1) / kBiasRows);
  const auto kernel = gemm_bias_f32_kernel<BN, kDrop>;
  constexpr int smem = sm::RingTf32<kBiasRows, BN, 0>::kBytes;
  int grid = 0;
  if (!e)
    e = sm::persistent_grid(kernel, smem, tiles, &grid, sm::kThreadsTf32);
  if (e) return e;
  kernel<<<grid, sm::kThreadsTf32, smem, stream>>>(
      ma, mb, ms, (const float*)bias, (float*)out, M, N, K, relu, n_tiles_n,
      site);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int gemm_bias(const void* a, const void* wb, const void* ws,
              const void* bias, void* out, int M, int N, int K, int relu,
              DropSite site, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bias_tile_width(N)) {
    case 32:
      return launch_gemm_bias<32, kDrop>(a, wb, ws, bias, out, M, N, K, relu,
                                         site, s);
    case 64:
      return launch_gemm_bias<64, kDrop>(a, wb, ws, bias, out, M, N, K, relu,
                                         site, s);
    case 96:
      return launch_gemm_bias<96, kDrop>(a, wb, ws, bias, out, M, N, K, relu,
                                         site, s);
    default:
      return launch_gemm_bias<128, kDrop>(a, wb, ws, bias, out, M, N, K,
                                          relu, site, s);
  }
}

template <int BN, bool kDrop, bool kTrain>
int launch_res_ln(const void* a, const void* wb, const void* ws,
                  const void* bias, const void* res, const void* gamma,
                  const void* beta, void* out, void* pre_out, int M, int N,
                  int K, float eps, DropSite site, cudaStream_t stream) {
  CUtensorMap ma, mb, ms;
  int e = encode_tf32(&ma, &mb, &ms, a, wb, ws, M, N, K, kLnRows, BN);
  const auto kernel = gemm_res_ln_f32_kernel<BN, kDrop, kTrain>;
  constexpr int smem = sm::RingTf32<kLnRows, BN, kLnExtra<BN>>::kBytes;
  int grid = 0;
  if (!e)
    e = sm::persistent_grid(kernel, smem, (M + kLnRows - 1) / kLnRows, &grid,
                            sm::kThreadsTf32);
  if (e) return e;
  kernel<<<grid, sm::kThreadsTf32, smem, stream>>>(
      ma, mb, ms, (const float*)bias, (const float*)res, (const float*)gamma,
      (const float*)beta, (float*)out, (float*)pre_out, M, N, K, eps, site);
  return (int)cudaGetLastError();
}

// The N tier of a residual layer: 64, 128 or 256 columns.
template <bool kDrop, bool kTrain>
int res_ln_tier(const void* a, const void* wb, const void* ws,
                const void* bias, const void* res, const void* gamma,
                const void* beta, void* out, void* pre_out, int M, int N,
                int K, float eps, DropSite site, cudaStream_t stream) {
  if (N <= 64)
    return launch_res_ln<64, kDrop, kTrain>(a, wb, ws, bias, res, gamma, beta,
                                            out, pre_out, M, N, K, eps, site,
                                            stream);
  if (N <= 128)
    return launch_res_ln<128, kDrop, kTrain>(a, wb, ws, bias, res, gamma,
                                             beta, out, pre_out, M, N, K, eps,
                                             site, stream);
  return launch_res_ln<256, kDrop, kTrain>(a, wb, ws, bias, res, gamma, beta,
                                           out, pre_out, M, N, K, eps, site,
                                           stream);
}

// ------------------------------------------ GEMM + bias, FFMA, TMA ring --

// An 8 x 8 register tile a thread, 256 threads: tiles of kBM x BN = 16384
// outputs, thread (ty, tx) = (t / kTX, t % kTX) at rows ty + kTY i and
// columns 4 tx + j % 4 + (j / 4) BN / 2; stages of 32 k. Its 8 rows share
// row % 8 (kTY is a multiple of 8), so one XOR places a k quad of all of
// them in A's swizzled box, and the rows of a warp's ty hit distinct banks.
template <int BN>
struct FfmaTile {
  static constexpr int kTX = BN / 8;
  static constexpr int kTY = 256 / kTX;
  static constexpr int kBM = 8 * kTY;
  static constexpr int kStages = BN == 128 ? 3 : 2;  // two blocks an SM
  using Ring = nylon::ring::Ring<kBM * 128, BN * 128, kStages, 8>;
};

// out[M, N] = (a[M, K] @ w[K, N]) + bias [, ReLU], each output one fmaf
// chain over k ascending from 0; tile t at (row block t / n_tiles_n,
// column block t % n_tiles_n).
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bias_ffma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_w,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int M, int N, int K,
                          int relu, int n_tiles_n) {
  using T = FfmaTile<BN>;
  constexpr int BM = T::kBM, TX = T::kTX, TY = T::kTY, S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const typename T::Ring ring(smem_raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int nk = (K + 31) / 32;
  const int tiles = n_tiles_n * ((M + BM - 1) / BM);
  const int items =
      (int)blockIdx.x < tiles
          ? ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nk
          : 0;
  // the tile of item q (k-block q % nk of the block's (q / nk)-th tile)
  const auto tile_of = [&](int q, int& m0, int& n0) {
    const int t = blockIdx.x + (q / nk) * gridDim.x;
    m0 = (t / n_tiles_n) * BM;
    n0 = (t % n_tiles_n) * BN;
  };
  const CUtensorMap* const ma = &map_a;
  const CUtensorMap* const mw = &map_w;
  const auto fill = [&](int q) {
    int m0, n0;
    tile_of(q, m0, n0);
    const int k0 = (q % nk) * 32;
    const int s = ring.fill(q);
    sm::tma_load(ring.a(s), ma, ring.full(s), k0, m0);
    sm::tma_load(ring.b(s), mw, ring.full(s), n0, k0);
  };
  if (threadIdx.x == 0) {
    sm::tma_prefetch(ma);
    sm::tma_prefetch(mw);
    for (int q = 0; q < S - 1 && q < items; ++q) fill(q);
  }

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[8][8];
  for (int q = 0; q < items; ++q) {
    if (threadIdx.x == 0 && q + S - 1 < items) fill(q + S - 1);
    const int kb = q % nk;
    if (kb == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const int s = ring.wait(q);
    const uint8_t* const sa = ring.a(s) + ty * 128;
    const float* const sb = reinterpret_cast<const float*>(ring.b(s));
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 4) {
      // A's 128-byte swizzled box: k0 .. k0 + 3 of row r at sw128(r, k0 /
      // 4), the same XOR for the thread's 8 rows
      const uint8_t* const ak = sa + ((((k0 >> 2) ^ ty) & 7) << 4);
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(ak + i * TY * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* const br = sb + (k0 + kk) * BN + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + BN / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0   ? av[i].x
                          : kk == 1 ? av[i].y
                          : kk == 2 ? av[i].z
                                    : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
    ring.release(q);
    if (kb != nk - 1) continue;
    int m0, n0;
    tile_of(q, m0, n0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 4 * tx + h * (BN / 2);
      if (col >= N) continue;
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty + TY * i;
        if (row >= M) continue;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = nylon::bias_epilogue<float, false>(
              acc[i][4 * h + e], b[e], relu, DropSite{}, (uint32_t)row,
              col + e, N);
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
}

template <int BN>
int launch_gemm_bias_ffma(const void* a, const void* w, const void* bias,
                          void* out, int M, int N, int K, int relu,
                          cudaStream_t stream) {
  using T = FfmaTile<BN>;
  CUtensorMap ma, mw;
  int e = sm::encode_f32(&ma, a, M, K, T::kBM);
  if (!e)
    e = nylon::ring::encode_rows_of(&mw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                    w, K, N, N, 32, BN);
  const int n_tiles_n = (N + BN - 1) / BN;
  const long long tiles =
      (long long)n_tiles_n * ((M + T::kBM - 1) / T::kBM);
  const auto kernel = gemm_bias_ffma_kernel<BN>;
  constexpr int smem = 1024 + T::Ring::kBytes;
  int grid = 0;
  if (!e) e = sm::persistent_grid(kernel, smem, tiles, &grid, kThreads);
  if (e) return e;
  kernel<<<grid, kThreads, smem, stream>>>(ma, mw, (const float*)bias,
                                           (float*)out, M, N, K, relu,
                                           n_tiles_n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- dX = dY W^T --

// out[M, Kout] = epilogue(dy[M, N] @ w^T), w [Kout, N] read as its TF32
// pair w_big, w_small [Kout, N] (the weight's own layout, K-major for this
// product: ops/layer_fused.py::pack_tf32's dX pair), on
// gemm_bias_f32_kernel's mainloop with dy as A. Tile t is (row block t /
// n_tiles_n, column block t % n_tiles_n). `side` is ep.gate or ep.addend
// (at most one is given), read as the fragments' float2 pairs, all of a
// tile's loads issued at once after its mainloop; of the two dropout sites
// at most one (`site`) is on, and each thread draws its keep bits of the
// tile (both rows an iteration) in a rolled loop under those loads, before
// the unrolled element math (the hashes unrolled into it made
// layer_fused_train.cu's gemm_nt_kernel 4x slower: instruction cache).
template <int BN>
__global__ void __launch_bounds__(sm::kThreadsTf32, 1)
    gemm_nt_f32_kernel(const __grid_constant__ CUtensorMap map_dy,
                       const __grid_constant__ CUtensorMap map_big,
                       const __grid_constant__ CUtensorMap map_small,
                       const float* __restrict__ side,
                       float* __restrict__ out, int M, int N, int Kout,
                       int n_tiles_n, NtEpilogue ep, DropSite site) {
  extern __shared__ uint8_t smem_raw[];
  sm::RingTf32<kBiasRows, BN, 0> ring(smem_raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (N + sm::kBKTf32 - 1) / sm::kBKTf32;
  const long long tiles =
      (long long)n_tiles_n * ((M + kBiasRows - 1) / kBiasRows);

  if (warp >= sm::kConsumerWarps) {  // the producer warpgroup
    sm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == sm::kConsumerWarps * 32) {
      sm::tma_prefetch(&map_dy);
      sm::tma_prefetch(&map_big);
      sm::tma_prefetch(&map_small);
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (int)(t / n_tiles_n) * kBiasRows;
        const int n0 = (int)(t % n_tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb)
          ring.load(&map_dy, &map_big, &map_small, m0, n0, kb);
      }
    }
  } else {
    sm::reg_alloc<kConsumerRegs>();
    const int g = warp >> 2;
    const Frag f(threadIdx.x & 127);
    const bool masked = ep.act1 || ep.act2;
    float acc[BN / 2];
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (int)(t / n_tiles_n) * kBiasRows;
      const int n0 = (int)(t % n_tiles_n) * BN;
      ring.template mma3<BN>(acc, nk, 64 * g, 0);
      const int row0 = m0 + 64 * g + f.r0;
      // the tile's side values, every load issued before the first is used
      // (one trip to device memory a tile, not one a pair), in flight under
      // the keep bits' hashes
      float2 sv[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = n0 + 8 * j + 2 * f.q, row = row0 + 8 * i;
          sv[j][i] = side && col < Kout && row < M
                         ? ldg2(side + (size_t)row * Kout + col)
                         : make_float2(0.f, 0.f);
        }
      // bit 2 j + c of word i: whether the site keeps column n0 + 8 j + 2 q
      // + c of row row0 + 8 i
      uint32_t kbits[2] = {0u, 0u};
      if (masked) {
#pragma unroll 1
        for (int b = 0; b < BN / 4; ++b) {
          const int col = n0 + 8 * (b >> 1) + 2 * f.q + (b & 1);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            kbits[i] |= (uint32_t)nylon::keeps(site, (uint32_t)(row0 + 8 * i),
                                               col, Kout)
                        << b;
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * f.q;
        if (col >= Kout) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
          if (row >= M) continue;
          const size_t off = (size_t)row * Kout + col;
          const float k0 = (kbits[i] >> (2 * j)) & 1 ? site.scale : 0.f;
          const float k1 = (kbits[i] >> (2 * j + 1)) & 1 ? site.scale : 0.f;
          st2(out + off,
              nylon::nt_epilogue<float>(acc[4 * j + 2 * i], ep, sv[j][i].x,
                                        k0),
              nylon::nt_epilogue<float>(acc[4 * j + 2 * i + 1], ep,
                                        sv[j][i].y, k1));
        }
      }
    }
  }
}

// ------------------------------------------------------------ dW = A^T dY --

constexpr int kWgRows = 32;  // rows of a k-block (a stage)
constexpr int kWgWarps = kThreads / 32;

// The dW kernel's tile: BM (Ka) x BN (N) a block, each 64 or 128. At BM =
// 128 warpgroup g owns the Ka rows 64 g .. 64 g + 63 at all BN columns; at
// BM = 64 all 64 rows at the kWN = BN / 2 columns from g kWN. From the
// 1024-byte aligned base: the ring's stages (the k-block's rows of A, BM / 32
// boxes of 32 rows x 32 floats, and of dy, BN / 32 such boxes, 128-byte
// swizzle, by TMA) and barriers; two buffers of dy's K-major TF32 pair (big,
// small: BN rows of the k-block's 32 rows each, 128-byte swizzle), written
// by the consumers; the column sums of dy of each of kParts parts of the
// block's threads.
template <int BM, int BN>
struct WgTile {
  static constexpr int kWN = BM == 128 ? BN : BN / 2;
  static constexpr int kABytes = BM * 128, kBBytes = BN * 128;
  static constexpr int kPairBytes = 2 * BN * 128;
  static constexpr int kParts = kThreads / (BN / 2);
  static constexpr int kFit =
      (sm::kSmemMax - 2048 - 2 * kPairBytes - kParts * BN * 4) /
      (kABytes + kBBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  using Ring = nylon::ring::Ring<kABytes, kBBytes, kStages, kWgWarps>;
  static constexpr int kPairs = (Ring::kBytes + 1023) / 1024 * 1024;
  static constexpr int kSums = kPairs + 2 * kPairBytes;
  static constexpr int kSmem = 1024 + kSums + kParts * BN * 4;
};

// Byte offset of element (row r, column c) of a stage's A or dy: box c / 32,
// 16-byte chunk (c % 32) / 4 of row r under the 128-byte swizzle.
__device__ __forceinline__ uint32_t wg_at(int r, int c) {
  return (uint32_t)((c >> 5) * 4096) + sm::sw128(r, (c & 31) >> 2) +
         4 * (c & 3);
}

__device__ __forceinline__ float lds(const uint8_t* base, uint32_t at) {
  return *reinterpret_cast<const float*>(base + at);
}

// part[chunk][Ka, N] = a[rows, Ka]^T @ dy[rows, N] over the chunk's rows
// (rows_per_chunk of them, a multiple of kWgRows: no box straddles two
// chunks; TMA zero-fills the rows past M), 3xTF32 on wgmma m64nNk8 .tf32.
// dW reduces over rows, and both operands arrive MN-major (Ka and N
// contiguous), which TF32 wgmma does not read from shared memory: A^T is
// the register operand, each thread reading its fragments straight from
// the staged A boxes and splitting them (as the forward splits A); dy is
// B, re-staged by the consumers from each landed stage into a K-major TF32
// pair (each element read once, split, written as big and small), one
// buffer while the other's wgmmas run. The k index of a k8 step is
// permuted alike in both (index t is row 2 t, t + 4 row 2 t + 1): the rows
// a fragment load touches then sit at distinct swizzle phases, and the
// loads and the re-staging's 16-byte stores are free of bank conflicts.
// Each k-block's 12 wgmmas accumulate in a chain of their own, added into
// the f32 sum (the forward's RingTf32::mma3 rule). Block (t, chunk) owns dW
// tile t (Ka rows and N columns past the matrix are not stored, and a box
// wholly past them is not loaded) and writes its f32 partial straight from
// the registers. The column sums of dy over the chunk are shared by the
// n_kt = ceil(Ka / BM) blocks of the tile's column range, as
// layer_fused_train.cu's wgrad_kernel shares them: the block of Ka tile kt
// sums the rows r = kt (mod n_kt) of each stage, each thread one column
// pair in one of kParts parts of those rows, in row order;
// bias_part[chunk * n_kt + kt][N] is the parts' sums added in order.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_dy,
                     float* __restrict__ part, float* __restrict__ bias_part,
                     int M, int Ka, int N, int rows_per_chunk,
                     int n_tiles_n) {
  using T = WgTile<BM, BN>;
  using Issue = sm::RingTf32<64, T::kWN, 0>;
  constexpr int S = T::kStages, WN = T::kWN;
  extern __shared__ uint8_t smem_raw[];
  const typename T::Ring ring(smem_raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int k0 = (blockIdx.x / n_tiles_n) * BM;
  const int n0 = (blockIdx.x % n_tiles_n) * BN;
  const int chunk = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  const int nk = (r1 - r0 + kWgRows - 1) / kWgRows;
  const int boxes_a = min(BM / 32, (Ka - k0 + 31) / 32);
  const int boxes_b = min(BN / 32, (N - n0 + 31) / 32);
  const CUtensorMap* const ma = &map_a;
  const CUtensorMap* const md = &map_dy;
  const auto fill = [&](int q) {
    const int s = ring.fill(q, (uint32_t)(boxes_a + boxes_b) * 4096u);
    const int row = r0 + q * kWgRows;
    for (int b = 0; b < boxes_a; ++b)
      sm::tma_load(ring.a(s) + b * 4096, ma, ring.full(s), k0 + 32 * b, row);
    for (int b = 0; b < boxes_b; ++b)
      sm::tma_load(ring.b(s) + b * 4096, md, ring.full(s), n0 + 32 * b, row);
  };
  if (threadIdx.x == 0) {
    sm::tma_prefetch(ma);
    sm::tma_prefetch(md);
    for (int q = 0; q < S - 1 && q < nk; ++q) fill(q);
  }

  const int g = threadIdx.x >> 7;
  const Frag f(threadIdx.x & 127);
  const int a_row = (BM == 128 ? 64 * g : 0) + f.r0;  // A^T fragment rows
  const int wn = BM == 128 ? 0 : g * WN;             // the warpgroup's columns
  uint8_t* const pairs = ring.base + T::kPairs;
  // dy's rows 8 ks + 2 e + h (e = 0..3) of column n to the 16-byte chunk cc
  // = 2 ks + h of row n of the pair buffer: thread t takes column t % BN
  // and the chunks t / BN + j 256 / BN
  const auto restage = [&](const uint8_t* sb, uint8_t* pb) {
    const int n = threadIdx.x % BN;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int cc = threadIdx.x / BN + j * (kThreads / BN);
      const int row = 8 * (cc >> 1) + (cc & 1);
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const nylon::Split x = nylon::split(lds(sb, wg_at(row + 2 * e, n)));
        big[e] = x.big;
        small[e] = x.small;
      }
      const uint32_t at = n * 128 + ((cc ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(pb + at) =
          make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(pb + BN * 128 + at) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  };
  // column pair `pair` of the tile, rows first, first + step, ... of each
  // stage
  const int kt = k0 / BM, n_kt = (Ka + BM - 1) / BM;
  const int pair = threadIdx.x % (BN / 2), part_of = threadIdx.x / (BN / 2);
  const int first = kt + n_kt * part_of, step = n_kt * T::kParts;
  float b0 = 0.f, b1 = 0.f;
  float acc[WN / 2], chain[WN / 2];

  restage(ring.b(ring.wait(0)), pairs);
  sm::fence_async_smem();
  __syncthreads();
  for (int q = 0; q < nk; ++q) {
    if (threadIdx.x == 0 && q + S - 1 < nk) fill(q + S - 1);
    const int s = q % S;
    const uint8_t* const sa = ring.a(s);
    const uint8_t* const sb = ring.b(s);
    const uint32_t pb = sm::smem_u32(pairs + (q & 1) * T::kPairBytes);
    const uint32_t bb = pb + wn * 128, bs = pb + BN * 128 + wn * 128;
    // the k-block's 12 wgmmas, each k8 step's A^T fragments (rows a_row, +
    // 8; k indices c, c + 4: rows 8 ks + 2 c, + 1) split while the
    // previous step's run
#pragma unroll
    for (int ks = 0; ks < kWgRows / 8; ++ks) {
      uint32_t big[4], small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const nylon::Split x = nylon::split(
            lds(sa, wg_at(8 * ks + 2 * f.q + (i >> 1), a_row + 8 * (i & 1))));
        big[i] = x.big;
        small[i] = x.small;
      }
      sm::wgmma_fence();
      Issue::template issue3<WN>(chain, big, small, bb + 32 * ks,
                                 bs + 32 * ks, ks);
    }
    sm::wgmma_commit();
#pragma unroll 4
    for (int rr = first; rr < kWgRows; rr += step) {
      const float2 v =
          *reinterpret_cast<const float2*>(sb + wg_at(rr, 2 * pair));
      b0 += v.x;
      b1 += v.y;
    }
    // the next k-block's pair, into the other buffer, under the wgmmas
    if (q + 1 < nk) {
      restage(ring.b(ring.wait(q + 1)),
              pairs + ((q + 1) & 1) * T::kPairBytes);
      sm::fence_async_smem();
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(chain);
#pragma unroll
    for (int i = 0; i < WN / 2; ++i)
      acc[i] = q == 0 ? chain[i] : acc[i] + chain[i];
    ring.release(q);
    // every wgmma of buffer q % 2 has retired, buffer (q + 1) % 2 is whole
    __syncthreads();
  }

  float* const dst = part + (size_t)chunk * Ka * N;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = n0 + wn + 8 * j + 2 * f.q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + a_row + 8 * i;
      if (row < Ka && col < N)
        st2(dst + (size_t)row * N + col, acc[4 * j + 2 * i],
            acc[4 * j + 2 * i + 1]);
    }
  }
  float* const sums = reinterpret_cast<float*>(ring.base + T::kSums);
  *reinterpret_cast<float2*>(sums + part_of * BN + 2 * pair) =
      make_float2(b0, b1);
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    if (n0 + c >= N) continue;
    float v = sums[c];
#pragma unroll
    for (int h = 1; h < T::kParts; ++h) v += sums[h * BN + c];
    bias_part[((size_t)chunk * n_kt + kt) * N + n0 + c] = v;
  }
}

template <int BN>
int launch_gemm_nt(const void* dy, const void* wb, const void* ws, void* out,
                   int M, int N, int Kout, const NtEpilogue& ep,
                   cudaStream_t stream) {
  CUtensorMap md, mb, ms;
  // dy [M, N] is A, the pair [Kout, N] the K-major B
  int e = encode_tf32(&md, &mb, &ms, dy, wb, ws, M, Kout, N, kBiasRows, BN);
  const int n_tiles_n = (Kout + BN - 1) / BN;
  const long long tiles =
      (long long)n_tiles_n * ((M + kBiasRows - 1) / kBiasRows);
  const auto kernel = gemm_nt_f32_kernel<BN>;
  constexpr int smem = sm::RingTf32<kBiasRows, BN, 0>::kBytes;
  int grid = 0;
  if (!e)
    e = sm::persistent_grid(kernel, smem, tiles, &grid, sm::kThreadsTf32);
  if (e) return e;
  const void* side = ep.gate != nullptr ? ep.gate : ep.addend;
  kernel<<<grid, sm::kThreadsTf32, smem, stream>>>(
      md, mb, ms, (const float*)side, (float*)out, M, N, Kout, n_tiles_n, ep,
      ep.act1 ? ep.m1 : ep.m2);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_wgrad(const void* a, const void* dy, void* part, void* bias_part,
                 int M, int Ka, int N, int rows_per_chunk, int chunks,
                 cudaStream_t stream) {
  CUtensorMap ma, md;
  int e = sm::encode_f32(&ma, a, M, Ka, kWgRows);
  if (!e) e = sm::encode_f32(&md, dy, M, N, kWgRows);
  const int n_tiles_n = (N + BN - 1) / BN;
  const int tiles = n_tiles_n * ((Ka + BM - 1) / BM);
  const auto kernel = wgrad_f32_kernel<BM, BN>;
  constexpr int smem = WgTile<BM, BN>::kSmem;
  if (!e)
    e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  kernel<<<dim3(tiles, chunks), kThreads, smem, stream>>>(
      ma, md, (float*)part, (float*)bias_part, M, Ka, N, rows_per_chunk,
      n_tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The float32 twins of nylon_gemm_bias / nylon_gemm_bias_drop
// (layer_fused.cu), the weight [K, N] as its TF32 pair w_big, w_small [N,
// K] (ops/layer_fused.py::tf32_pair): K % 4 == 0, N % 4 == 0.
int nylon_gemm_bias_f32(const void* a, const void* w_big, const void* w_small,
                        const void* bias, void* out, int M, int N, int K,
                        int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  return gemm_bias<false>(a, w_big, w_small, bias, out, M, N, K, relu,
                          DropSite{}, stream);
}

int nylon_gemm_bias_drop_f32(const void* a, const void* w_big,
                             const void* w_small, const void* bias, void* out,
                             int M, int N, int K, int relu, unsigned key,
                             unsigned thresh, float scale, int half,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  return gemm_bias<true>(a, w_big, w_small, bias, out, M, N, K, relu,
                         DropSite{key, thresh, scale, half, 0u}, stream);
}

// nylon_gemm_bias_f32 on the CUDA cores, w the [K, N] weight itself (IEEE
// f32 products summed over k in order: the stem layer's QKV projection): K
// % 4 == 0, N % 4 == 0.
int nylon_gemm_bias_ffma_f32(const void* a, const void* w, const void* bias,
                             void* out, int M, int N, int K, int relu,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return N % 128 == 0
             ? launch_gemm_bias_ffma<128>(a, w, bias, out, M, N, K, relu, s)
             : launch_gemm_bias_ffma<64>(a, w, bias, out, M, N, K, relu, s);
}

// The float32 twins of nylon_gemm_res_ln / nylon_gemm_res_ln_train, the
// weight as its TF32 pair w_big, w_small [N, K]: N <= 256, K % 4 == 0, N %
// 4 == 0.
int nylon_gemm_res_ln_f32(const void* a, const void* w_big,
                          const void* w_small, const void* bias,
                          const void* res, const void* gamma,
                          const void* beta, void* out, int M, int N, int K,
                          float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 || N > 256)
    return (int)cudaErrorInvalidValue;
  return res_ln_tier<false, false>(a, w_big, w_small, bias, res, gamma, beta,
                                   out, nullptr, M, N, K, eps, DropSite{},
                                   (cudaStream_t)stream);
}

int nylon_gemm_res_ln_train_f32(const void* a, const void* w_big,
                                const void* w_small, const void* bias,
                                const void* res, const void* gamma,
                                const void* beta, void* out, void* pre_out,
                                int M, int N, int K, float eps, int active,
                                unsigned key, unsigned thresh, float scale,
                                int half, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 || N > 256 ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  return active ? res_ln_tier<true, true>(a, w_big, w_small, bias, res, gamma,
                                          beta, out, pre_out, M, N, K, eps,
                                          site, (cudaStream_t)stream)
                : res_ln_tier<false, true>(a, w_big, w_small, bias, res,
                                           gamma, beta, out, pre_out, M, N, K,
                                           eps, site, (cudaStream_t)stream);
}

// The float32 twin of nylon_gemm_nt (layer_fused_train.cu), the weight w
// [Kout, N] as its TF32 pair w_big, w_small [Kout, N] (ops/layer_fused.py
// ::pack_tf32's dX pair): N % 4 == 0, Kout % 4 == 0; gate and addend not
// both set, act1 and act2 not both on.
int nylon_gemm_nt_f32(const void* dy, const void* w_big, const void* w_small,
                      void* out, const void* gate, const void* addend, int M,
                      int N, int Kout, int act1, unsigned key1,
                      unsigned thresh1, float scale1, int half1, int act2,
                      unsigned key2, unsigned thresh2, float scale2,
                      int half2, void* stream) {
  if (M <= 0 || N <= 0 || Kout <= 0 || N % 4 || Kout % 4 ||
      (gate != nullptr && addend != nullptr) || (act1 && act2) ||
      (half1 && 2 * half1 != Kout) || (half2 && 2 * half2 != Kout))
    return (int)cudaErrorInvalidValue;
  const NtEpilogue ep{gate, addend, DropSite{key1, thresh1, scale1, half1, 0u},
                      DropSite{key2, thresh2, scale2, half2, 0u}, act1, act2};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bias_tile_width(Kout)) {
    case 32:
      return launch_gemm_nt<32>(dy, w_big, w_small, out, M, N, Kout, ep, s);
    case 64:
      return launch_gemm_nt<64>(dy, w_big, w_small, out, M, N, Kout, ep, s);
    case 96:
      return launch_gemm_nt<96>(dy, w_big, w_small, out, M, N, Kout, ep, s);
    default:
      return launch_gemm_nt<128>(dy, w_big, w_small, out, M, N, Kout, ep, s);
  }
}

// The float32 twin of nylon_wgrad: part[chunks, Ka, N] and
// bias_part[chunks * ceil(Ka / bm), N], the dW tile bm x bn (64 or 128
// each: ops/layer_fused_train.py::wgrad_tile, which sizes bias_part; no
// other tile is taken), rows split into chunks of rows_per_chunk (a
// multiple of 32), each holding at least one row; Ka % 4 == 0, N % 4 == 0.
int nylon_wgrad_f32(const void* a, const void* dy, void* part,
                    void* bias_part, int M, int Ka, int N, int rows_per_chunk,
                    int chunks, int bm, int bn, void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % 4 || N % 4 ||
      rows_per_chunk <= 0 || rows_per_chunk % kWgRows || chunks <= 0 ||
      chunks > 65535 || (long long)rows_per_chunk * chunks < M ||
      (long long)rows_per_chunk * (chunks - 1) >= M ||
      (bm != 64 && bm != 128) || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64)
    return bn == 64 ? launch_wgrad<64, 64>(a, dy, part, bias_part, M, Ka, N,
                                           rows_per_chunk, chunks, s)
                    : launch_wgrad<64, 128>(a, dy, part, bias_part, M, Ka, N,
                                            rows_per_chunk, chunks, s);
  return bn == 64 ? launch_wgrad<128, 64>(a, dy, part, bias_part, M, Ka, N,
                                          rows_per_chunk, chunks, s)
                  : launch_wgrad<128, 128>(a, dy, part, bias_part, M, Ka, N,
                                           rows_per_chunk, chunks, s);
}

}  // extern "C"
