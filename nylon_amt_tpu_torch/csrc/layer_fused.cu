// The GEMM kernels of the hFT transformer layers on Hopper (sm_90a), bf16.
//
// Replaces the matrix products of the whole-layer Pallas kernels of
// nylon_amt_tpu/ops/layer_fused.py (encoder_layer: _enc_kernel ->
// _self_block; decoder_layer_zero: _dec_zero_kernel -> _cross_tail;
// decoder_layer: _dec_kernel) and of the training forwards of
// nylon_amt_tpu/ops/layer_fused_train.py (K7-K9, also run again as the
// forward recompute of their backward). The TPU kernel kept a layer's ~1.3
// MB of weights in VMEM and streamed the activations through once; a
// Hopper block has at most 227 KB of shared memory, so a layer is instead
// a short sequence of kernels launched by ops/layer_fused.py: the two
// GEMMs of this file and the attention of mha.cu.
//
//  * gemm_bias_kernel: out = bf16(A @ W) + bias [, ReLU] [, x keep mask]
//    (QKV, cross Q and K/V, FFN up);
//  * gemm_res_ln_kernel: out = LN(res + (bf16(A @ W) + bias) [x keep]),
//    the block owning full rows (N <= 256) so the shared post-LayerNorm
//    runs in its epilogue (O projection, FFN down); kTrain also writes the
//    pre-LN sum (pre_out) that the backward kernels need, and out may be
//    null.
//
// What bounds them: a GEMM moves 2 (MK + KN + MN) bytes (+ 2 MN for the
// residual) for 2 MKN operations. At the paper widths (hid 256, pf 512,
// M ~ 10^5-10^6 rows) that is 85 (O projection: K = N = 256 with the
// residual) to 192 (QKV: K 256, N 768) FLOP per byte, under the H100's
// ~295 FLOP/B ridge (989 TFLOP/s bf16 over 3.35 TB/s): every one of them is
// bound by device-memory bytes, and what counts is keeping HBM busy while
// the tensor cores and the epilogue keep up.
//
// The design (the mainloop is gemm_sm90.cuh's):
//  * persistent blocks, about one per SM, each walking its output tiles
//    of 128 rows x BN columns (BN 64-256 by N; gemm_bias walks the N tiles
//    of one row block together, so A is read from HBM once and its other
//    reads hit L2);
//  * one producer warp keeps TMA loads of A and W in flight in a ring of
//    3-4 stages 64 deep in K, across tile boundaries, so the next tile's
//    loads run under this tile's epilogue; gemm_res_ln's producer also
//    loads the residual tile by TMA while the mainloop runs;
//  * two consumer warpgroups each run wgmma m64nBNk16 on 64 of the rows
//    (W MN-major through the descriptor's transpose bit: no copy of the
//    weights), the f32 accumulator in registers;
//  * the epilogue works on the accumulator fragments in registers: in the
//    m64nN layout a row's values sit in the 4 lanes of one quad, so the
//    LayerNorm's two f32 passes are register sums and two shfl_xor each;
//    outputs go through 128-byte-swizzled 64 x 64 shared boxes
//    (bank-conflict free for that layout) and leave by TMA stores, which
//    clip the ragged edge and overlap the next tile's mainloop
//    (gemm_bias: box by box through a ring of two, so that a 128 x 256
//    tile keeps 4 stages; gemm_res_ln: in place of the residual tile);
//  * the element math runs on column pairs in bf16x2 (bias_epilogue2 /
//    residual_sum2 of layer_epilogue.cuh, the same bits as the scalar
//    epilogues), since each scalar round to bf16 costs a conversion on the
//    SM's 16-lane conversion pipe; bias, gamma and beta are read from
//    shared memory. Measured on an NVIDIA H100 80GB HBM3 at 700 W
//    (PERF.md): the scalar epilogue cost 22% of gemm_bias's time, loading
//    gamma and beta from global memory 5-11% of gemm_res_ln's.
//
// Numerics are the reference's, op for op (layer_epilogue.cuh, shared with
// the float32 kernels of layer_fused_f32.cu): f32 accumulation, cast to
// bf16 BEFORE the bias add, bias and residual added in bf16, the keep mask
// of hash_mask.cuh (a pure function of the element's index) after the bias
// [and ReLU], f32 two-pass LayerNorm statistics with rsqrtf and the
// caller's eps. Only the summation order inside the tensor core and of the
// row statistics differs from the plain version; there is no split K and
// no atomic, so two runs are bit-identical.

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hash_mask.cuh"
#include "layer_epilogue.cuh"

using nylon::bf16;
using nylon::DropSite;
namespace sm = nylon::sm90;
using sm::bf16x2;
using sm::bits;
using sm::Frag;
using sm::store_tile;

namespace {

constexpr int kDepth = 32;    // the entry points take K % kDepth == 0
constexpr int kLnMaxN = 256;  // gemm_res_ln: a block owns full rows

// ------------------------------------------------------ GEMM + bias ----

// gemm_bias stages its output a 64-column box at a time, through a ring of
// two boxes a warpgroup (so that a 128 x 256 tile leaves 4 stages of
// room), and each warpgroup copies the tile's 256 bias values to shared
// memory (512 bytes) once a tile.
constexpr int kBiasEpiBytes = 2 * 2 * sm::kBoxBytes + 2 * 512;

// out[M, N] = bf16(a[M, K] @ w[K, N]) + bias[N] [, ReLU if relu] [, x the
// keep mask of `site` at (row, column) if kDrop]. Tile t is (row block
// t / n_tiles_n, column block t % n_tiles_n).
template <int BN, bool kDrop>
__global__ void __launch_bounds__(sm::kThreads, 1)
    gemm_bias_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_out,
                     const bf16* __restrict__ bias, int M, int N, int K,
                     int relu, int n_tiles_n, DropSite site) {
  extern __shared__ uint8_t smem_raw[];
  sm::Ring<BN, kBiasEpiBytes> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(1);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBK - 1) / sm::kBK;
  const long long tiles =
      (long long)n_tiles_n * ((M + sm::kBM - 1) / sm::kBM);

  if (warp == sm::kConsumerWarps) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_w);
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (int)(t / n_tiles_n) * sm::kBM;
        const int n0 = (int)(t % n_tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) ring.load(&map_a, &map_w, m0, n0, kb);
      }
    }
    return;
  }

  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ebase = sm::smem_u32(ring.epi(2 * g));
  const uint32_t s_bias = sm::smem_u32(ring.epi(4)) + 512 * g;
  const __nv_bfloat162 keep = __float2bfloat162_rn(site.scale);
  uint32_t staged = 0;  // boxes this warpgroup has staged: ring slot parity
  float acc[BN / 2];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (int)(t / n_tiles_n) * sm::kBM;
    const int n0 = (int)(t % n_tiles_n) * BN;
    const int row0 = m0 + 64 * g;
    ring.mma(acc, nk, g);
    // (the previous tile's last reads of s_bias precede its last box sync)
    if (2 * tid < BN && n0 + 2 * tid < N)
      sm::st_shared(s_bias + 4 * tid,
                    *reinterpret_cast<const uint32_t*>(bias + n0 + 2 * tid));
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      const uint32_t box = ebase + (staged++ & 1) * sm::kBoxBytes;
      // the slot is free once every store group but the newest (the other
      // slot's: one group a box, empty if the box is not stored) has read
      // its box
      if (tid == 0) sm::bulk_wait_read<1>();
      sm::named_sync(1 + g, 128);
#pragma unroll
      for (int j = 8 * c; j < 8 * c + 8; ++j) {
        const int col = n0 + 8 * j + 2 * f.q;
        if (col < N) {
          const __nv_bfloat162 b =
              bf16x2(sm::ld_shared(s_bias + 2 * (col - n0)));
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sm::st_shared(f.addr(box, i, j),
                          bits(nylon::bias_epilogue2<kDrop>(
                              acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], b,
                              relu, site, keep,
                              (uint32_t)(row0 + f.r0 + 8 * i), col, N)));
        }
      }
      sm::fence_async_smem();
      sm::named_sync(1 + g, 128);
      if (tid == 0) {
        if (row0 < M && n0 + 64 * c < N)
          sm::tma_store(&map_out, box, n0 + 64 * c, row0);
        sm::bulk_commit();
      }
    }
  }
  if (tid == 0) sm::bulk_wait();
}

// ------------------------------------ GEMM + residual + shared LayerNorm ----

// gemm_res_ln's epilogue area: the 128 x BN residual / output tile, then
// gamma and beta (f32) and the bias (bf16), copied once a block.
template <int BN>
constexpr int kLnEpiBytes = sm::kBM * BN * 2 + BN * 10;

// out[M, N] = LN(res + (bf16(a @ w) + bias) [x keep]) * gamma + beta for
// N <= BN: a block tile holds full rows. The producer loads the tile's
// residual into the epilogue tile by TMA once its first k-blocks are
// issued; each warpgroup reads its half, overwrites it in place with the
// outputs (pre_out, then out) and releases it after its stores have read
// it. kTrain: pre_out (the pre-LN sum) if has_pre, out only if has_out.
template <int BN, bool kDrop, bool kTrain>
__global__ void __launch_bounds__(sm::kThreads, 1)
    gemm_res_ln_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_res,
                       const __grid_constant__ CUtensorMap map_out,
                       const __grid_constant__ CUtensorMap map_pre,
                       const bf16* __restrict__ bias,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, int M, int N, int K,
                       float eps, DropSite site, int has_out, int has_pre) {
  extern __shared__ uint8_t smem_raw[];
  sm::Ring<BN, kLnEpiBytes<BN>> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(2);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBK - 1) / sm::kBK;
  const int tiles = (M + sm::kBM - 1) / sm::kBM;
  uint32_t epi_phase = 0;

  if (warp == sm::kConsumerWarps) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_w);
      sm::tma_prefetch(&map_res);
      const int res_after = (nk < ring.kStages ? nk : ring.kStages) - 1;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t * sm::kBM;
        for (int kb = 0; kb < nk; ++kb) {
          ring.load(&map_a, &map_w, m0, 0, kb);
          if (kb != res_after) continue;
          sm::mbar_wait(ring.epi_empty(), epi_phase ^ 1);
          sm::mbar_expect_tx(ring.epi_full(), sm::kBM * BN * 2);
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              sm::tma_load(ring.epi(g * (BN / 64) + c), &map_res,
                           ring.epi_full(), 64 * c, m0 + 64 * g);
          epi_phase ^= 1;
        }
      }
    }
    return;
  }

  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ebase = sm::smem_u32(ring.epi(g * (BN / 64)));
  const float inv_n = 1.f / (float)N;
  const bool pre = kTrain && has_pre, out = !kTrain || has_out;
  const __nv_bfloat162 keep = __float2bfloat162_rn(site.scale);
  const auto box = [ebase](int j) {
    return ebase + (j >> 3) * sm::kBoxBytes;  // of 64-column block j / 8
  };
  // gamma, beta and the bias, to shared memory once
  const uint32_t s_gamma = sm::smem_u32(ring.epi(2 * (BN / 64)));
  const uint32_t s_beta = s_gamma + 4 * BN, s_bias = s_beta + 4 * BN;
  for (int c = threadIdx.x; c < N; c += 256) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_gamma + 4 * c),
                 "f"(gamma[c]) : "memory");
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_beta + 4 * c),
                 "f"(beta[c]) : "memory");
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(s_bias + 2 * c),
                 "h"(__bfloat16_as_ushort(bias[c])) : "memory");
  }
  sm::named_sync(3, 256);
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t * sm::kBM;
    ring.mma(acc, nk, g);
    sm::mbar_wait(ring.epi_full(), epi_phase);
    epi_phase ^= 1;

    // s = res + (bf16(acc) + bias) [x keep], in place of acc (and with
    // pre, of the residual in the epilogue tile); row sums
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * f.q;
      if (col < N) {
        const __nv_bfloat162 b = bf16x2(sm::ld_shared(s_bias + 2 * col));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t row = (uint32_t)(m0 + 64 * g + f.r0 + 8 * i);
          const __nv_bfloat162 s2 = nylon::residual_sum2<kDrop>(
              acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], b,
              bf16x2(sm::ld_shared(f.addr(box(j), i, j))), site, keep, row,
              col, N);
          if (pre) sm::st_shared(f.addr(box(j), i, j), bits(s2));
          const float2 sf = __bfloat1622float2(s2);
          acc[4 * j + 2 * i] = sf.x;
          acc[4 * j + 2 * i + 1] = sf.y;
          sum[i] += sf.x + sf.y;
        }
      }
    }
    const int row0 = m0 + 64 * g;
    if (pre) {  // the pre-LN sums leave while the statistics run
      sm::fence_async_smem();
      sm::named_sync(1 + g, 128);
      if (tid == 0) store_tile<BN>(&map_pre, ebase, 0, row0, N, M);
    }
    float mean[2], rstd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      mean[i] = sum[i] * inv_n;
    }
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (8 * j + 2 * f.q < N) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d0 = acc[4 * j + 2 * i] - mean[i];
          const float d1 = acc[4 * j + 2 * i + 1] - mean[i];
          sq[i] += d0 * d0 + d1 * d1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 1);
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 2);
      rstd[i] = rsqrtf(sq[i] * inv_n + eps);
    }

    if (out) {
      if (pre) {  // the tile is free once the pre-LN store has read it
        if (tid == 0) sm::bulk_wait_read();
        sm::named_sync(1 + g, 128);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * f.q;
        if (col < N) {
          const float2 ga = sm::ld_shared_f2(s_gamma + 4 * col);
          const float2 be = sm::ld_shared_f2(s_beta + 4 * col);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sm::st_shared(
                f.addr(box(j), i, j),
                bits(__floats2bfloat162_rn(
                    (acc[4 * j + 2 * i] - mean[i]) * rstd[i] * ga.x + be.x,
                    (acc[4 * j + 2 * i + 1] - mean[i]) * rstd[i] * ga.y +
                        be.y)));
        }
      }
      sm::fence_async_smem();
      sm::named_sync(1 + g, 128);
      if (tid == 0) store_tile<BN>(&map_out, ebase, 0, row0, N, M);
    } else if (!pre) {
      sm::named_sync(1 + g, 128);  // every read of the residual is done
    }
    if (tid == 0) {
      sm::bulk_wait_read();
      sm::mbar_arrive(ring.epi_empty());
    }
  }
  if (tid == 0) sm::bulk_wait();
}

// ------------------------------------------------------------- launch ----

template <int BN, bool kDrop>
int launch_gemm_bias(const void* a, const void* w, const void* bias,
                     void* out, int M, int N, int K, int relu, DropSite site,
                     cudaStream_t stream) {
  CUtensorMap ma, mw, mo;
  int e = sm::encode_bf16(&ma, a, M, K, sm::kBM);
  if (!e) e = sm::encode_bf16(&mw, w, K, N, 64);
  if (!e) e = sm::encode_bf16(&mo, out, M, N, 64);
  const int n_tiles_n = (N + BN - 1) / BN;
  const long long tiles =
      (long long)n_tiles_n * ((M + sm::kBM - 1) / sm::kBM);
  const auto kernel = gemm_bias_kernel<BN, kDrop>;
  constexpr int smem = sm::Ring<BN, kBiasEpiBytes>::kBytes;
  int grid = 0;
  if (!e) e = sm::persistent_grid(kernel, smem, tiles, &grid);
  if (e) return e;
  kernel<<<grid, sm::kThreads, smem, stream>>>(ma, mw, mo, (const bf16*)bias,
                                               M, N, K, relu, n_tiles_n,
                                               site);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int gemm_bias(const void* a, const void* w, const void* bias, void* out,
              int M, int N, int K, int relu, DropSite site, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (sm::tile_width(N)) {
    case 64:
      return launch_gemm_bias<64, kDrop>(a, w, bias, out, M, N, K, relu,
                                         site, s);
    case 128:
      return launch_gemm_bias<128, kDrop>(a, w, bias, out, M, N, K, relu,
                                          site, s);
    case 192:
      return launch_gemm_bias<192, kDrop>(a, w, bias, out, M, N, K, relu,
                                          site, s);
    default:
      return launch_gemm_bias<256, kDrop>(a, w, bias, out, M, N, K, relu,
                                          site, s);
  }
}

template <int BN, bool kDrop, bool kTrain>
int launch_gemm_res_ln(const void* a, const void* w, const void* bias,
                       const void* res, const void* gamma, const void* beta,
                       void* out, void* pre_out, int M, int N, int K,
                       float eps, DropSite site, cudaStream_t stream) {
  CUtensorMap ma, mw, mr, mo = {}, mp = {};
  int e = sm::encode_bf16(&ma, a, M, K, sm::kBM);
  if (!e) e = sm::encode_bf16(&mw, w, K, N, 64);
  if (!e) e = sm::encode_bf16(&mr, res, M, N, 64);
  if (!e && out != nullptr) e = sm::encode_bf16(&mo, out, M, N, 64);
  if (!e && pre_out != nullptr) e = sm::encode_bf16(&mp, pre_out, M, N, 64);
  const auto kernel = gemm_res_ln_kernel<BN, kDrop, kTrain>;
  constexpr int smem = sm::Ring<BN, kLnEpiBytes<BN>>::kBytes;
  int grid = 0;
  if (!e)
    e = sm::persistent_grid(kernel, smem, (M + sm::kBM - 1) / sm::kBM, &grid);
  if (e) return e;
  kernel<<<grid, sm::kThreads, smem, stream>>>(
      ma, mw, mr, mo, mp, (const bf16*)bias, (const float*)gamma,
      (const float*)beta, M, N, K, eps, site, out != nullptr,
      pre_out != nullptr);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kTrain>
int gemm_res_ln(const void* a, const void* w, const void* bias,
                const void* res, const void* gamma, const void* beta,
                void* out, void* pre_out, int M, int N, int K, float eps,
                DropSite site, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((N + 63) / 64) {
    case 1:
      return launch_gemm_res_ln<64, kDrop, kTrain>(
          a, w, bias, res, gamma, beta, out, pre_out, M, N, K, eps, site, s);
    case 2:
      return launch_gemm_res_ln<128, kDrop, kTrain>(
          a, w, bias, res, gamma, beta, out, pre_out, M, N, K, eps, site, s);
    case 3:
      return launch_gemm_res_ln<192, kDrop, kTrain>(
          a, w, bias, res, gamma, beta, out, pre_out, M, N, K, eps, site, s);
    default:
      return launch_gemm_res_ln<256, kDrop, kTrain>(
          a, w, bias, res, gamma, beta, out, pre_out, M, N, K, eps, site, s);
  }
}

}  // namespace

extern "C" {

int nylon_gemm_bias(const void* a, const void* w, const void* bias, void* out,
                    int M, int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kDepth || N % 8)
    return (int)cudaErrorInvalidValue;
  return gemm_bias<false>(a, w, bias, out, M, N, K, relu, DropSite{},
                          stream);
}

// nylon_gemm_bias, then times the keep mask of a dropout site.
int nylon_gemm_bias_drop(const void* a, const void* w, const void* bias,
                         void* out, int M, int N, int K, int relu,
                         unsigned key, unsigned thresh, float scale, int half,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kDepth || N % 8 ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  return gemm_bias<true>(a, w, bias, out, M, N, K, relu,
                         DropSite{key, thresh, scale, half, 0u}, stream);
}

int nylon_gemm_res_ln(const void* a, const void* w, const void* bias,
                      const void* res, const void* gamma, const void* beta,
                      void* out, int M, int N, int K, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kDepth || N % 8 || N > kLnMaxN ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  return gemm_res_ln<false, false>(a, w, bias, res, gamma, beta, out, nullptr,
                                   M, N, K, eps, DropSite{}, stream);
}

// Training variant of nylon_gemm_res_ln: an optional dropout site on the GEMM
// output (active != 0), the pre-LN sum to pre_out (if not null), out may be
// null.
int nylon_gemm_res_ln_train(const void* a, const void* w, const void* bias,
                            const void* res, const void* gamma,
                            const void* beta, void* out, void* pre_out, int M,
                            int N, int K, float eps, int active, unsigned key,
                            unsigned thresh, float scale, int half,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kDepth || N % 8 || N > kLnMaxN ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  return active ? gemm_res_ln<true, true>(a, w, bias, res, gamma, beta, out,
                                          pre_out, M, N, K, eps, site, stream)
                : gemm_res_ln<false, true>(a, w, bias, res, gamma, beta, out,
                                           pre_out, M, N, K, eps, site,
                                           stream);
}

const char* nylon_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
