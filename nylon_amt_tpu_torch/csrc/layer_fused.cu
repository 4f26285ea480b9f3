// Transformer-layer kernels for the hFT inference engine on Hopper (sm_90a).
//
// Replaces the whole-layer Pallas kernels of nylon_amt_tpu/ops/layer_fused.py:
// encoder_layer (_enc_kernel -> _self_block), decoder_layer_zero
// (_dec_zero_kernel -> _cross_tail) and decoder_layer (_dec_kernel).
//
// What bounds them here: at hid 256 a [tokens, 256] x [256, 256] projection
// does ~128 FLOP per byte of bf16 activations, under the H100's ~295 FLOP/B
// ridge, so a layer is bound by device-memory traffic, as it was on the TPU.
// The TPU kernel kept a layer's ~1.3 MB of weights resident in VMEM and
// streamed the activations through once. A Hopper block has at most 227 KB of
// shared memory, so that design does not carry over as it is. Each layer is
// instead a short sequence of three hand-written kernels, launched in turn by
// the Python wrapper (ops/layer_fused.py):
//
//  * gemm_bias_kernel: out = bf16(A @ W) + bias [, ReLU], a tiled bf16 WMMA
//    GEMM with an f32 accumulator (QKV, cross Q and K/V, FFN up);
//  * the attention kernel of mha.cu (nylon_attention): one block per
//    (sequence, head, 128-query tile), K and V of the whole sequence (L <=
//    256, D = 64) in shared memory, an exact softmax;
//  * gemm_res_ln_kernel: out = LN(res + (bf16(A @ W) + bias)), a GEMM whose
//    block owns full 256-wide rows so the shared post-LayerNorm runs in its
//    epilogue (O projection, FFN down).
//
// The intermediates (QKV, attention output, FFN hidden) go to device memory
// in this version; fusing them back into fewer passes is later work.
//
// Numerics follow the reference exactly where it pins them (the epilogues of
// layer_epilogue.cuh, shared with the float32 kernels of layer_fused_f32.cu):
// f32 accumulation, cast to bf16 BEFORE the bias add, bias and residual
// added in bf16, f32
// two-pass LayerNorm statistics (eps from the caller), exp2 softmax with the
// 1/l normalisation deferred to the f32 output, l summed from the unrounded
// f32 probabilities, probabilities rounded to bf16 for the PV product.
//
// The training forward (K7-K9, ops/layer_fused_train.py) runs the same three
// kernels with a dropout site (kDrop): the keep mask of hash_mask.cuh (K6)
// multiplies the GEMM output after the bias [and ReLU], before the residual
// and LayerNorm (sites ATTN_OUT, SA_OUT, FFN_MID, FFN_OUT), and the
// attention probabilities after l is summed from the unmasked p (per-head
// sites ATTN, SA: nylon_attention_drop of mha.cu). kTrain lets gemm_res_ln
// also write the pre-LN sum that the backward kernels (layer_fused_train.cu)
// need. The inference instantiations (kDrop = kTrain = false) are the code
// of the first slice.

#include <mma.h>

#include "common.cuh"
#include "hash_mask.cuh"
#include "layer_epilogue.cuh"

using namespace nvcuda;
using nylon::bf16;
using nylon::DropSite;

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel of this file
constexpr int kBK = 32;        // GEMM depth per pipeline stage
constexpr int kALd = kBK + 8;  // padded smem row of an A tile (bf16)

// ---------------------------------------------------------------- tiles ----

// rows x 32 tile of a row-major [M, K] matrix; rows past M are zero-filled.
__device__ __forceinline__ void load_a_tile(bf16* dst, const bf16* a, int M,
                                            int K, int m0, int k0, int rows) {
  for (int c = threadIdx.x; c < rows * (kBK / 8); c += kThreads) {
    const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const int gr = m0 + r;
    const bool ok = gr < M;
    const bf16* src = a + (size_t)(ok ? gr : 0) * K + k0 + col;
    nylon::cp_async16(dst + r * kALd + col, src, ok);
  }
}

// 32 x cols tile of a row-major [K, N] matrix; columns past N are zero-filled.
__device__ __forceinline__ void load_b_tile(bf16* dst, const bf16* w, int N,
                                            int k0, int n0, int cols,
                                            int ld_dst) {
  const int cpr = cols / 8;
  for (int c = threadIdx.x; c < kBK * cpr; c += kThreads) {
    const int r = c / cpr, col = (c % cpr) * 8;
    const int gc = n0 + col;
    const bool ok = gc < N;
    const bf16* src = w + (size_t)(k0 + r) * N + (ok ? gc : 0);
    nylon::cp_async16(dst + r * ld_dst + col, src, ok);
  }
}

// ------------------------------------------------------ GEMM + bias ----

constexpr int kGemmBM = 128, kGemmBN = 128;
constexpr int kGemmBLd = kGemmBN + 8;

struct GemmSmem {
  bf16 a[2][kGemmBM * kALd];
  bf16 b[2][kBK * kGemmBLd];
  float stage[kThreads / 32][16 * 16];
};

// out[M, N] = bf16(a[M, K] @ w[K, N]) + bias[N], then ReLU if relu.
// 8 warps as 2 x 4, each owning a 64 x 32 piece of the 128 x 128 tile.
// Capped at 128 registers so two blocks share an SM (16 warps to hide
// latency): 23% less time than one block at 134 registers on the H100.
// kDrop: then times the keep mask of `site` at (row, column).
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bias_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     int M, int N, int K, int relu, int n_tiles_n,
                     DropSite site) {
  __shared__ __align__(128) GemmSmem sm;
  const int m0 = (blockIdx.x / n_tiles_n) * kGemmBM;
  const int n0 = (blockIdx.x % n_tiles_n) * kGemmBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / kBK;
  load_a_tile(sm.a[0], a, M, K, m0, 0, kGemmBM);
  load_b_tile(sm.b[0], w, N, 0, n0, kGemmBN, kGemmBLd);
  nylon::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_a_tile(sm.a[cur ^ 1], a, M, K, m0, (kt + 1) * kBK, kGemmBM);
      load_b_tile(sm.b[cur ^ 1], w, N, (kt + 1) * kBK, n0, kGemmBN, kGemmBLd);
      nylon::cp_async_commit();
      nylon::cp_async_wait<1>();
    } else {
      nylon::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sm.a[cur] + (wm * 64 + i * 16) * kALd + kk,
                               kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sm.b[cur] + kk * kGemmBLd + wn * 32 + j * 16,
                               kGemmBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue, one 16 x 16 fragment at a time through a per-warp staging
  // buffer: each lane owns 8 consecutive columns of one row.
  float* stage = sm.stage[warp];
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c8;
      if (gr < M && gc < N) {
        const uint4 bv = *reinterpret_cast<const uint4*>(bias + gc);
        const bf16* bb = reinterpret_cast<const bf16*>(&bv);
        uint4 ov;
        bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = __float2bfloat16(nylon::bias_epilogue<bf16, kDrop>(
              stage[r * 16 + c8 + e], __bfloat162float(bb[e]), relu, site,
              (uint32_t)gr, gc + e, N));
        *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) = ov;
      }
      __syncwarp();
    }
  }
}

// ------------------------------------ GEMM + residual + shared LayerNorm ----

constexpr int kLnBM = 64, kLnBN = 256;
constexpr int kLnBLd = kLnBN + 8;
constexpr int kLnCLd = kLnBN + 4;
constexpr size_t kLnPipeBytes = 2 * (kLnBM * kALd + kBK * kLnBLd) * sizeof(bf16);
constexpr size_t kLnStageBytes = kLnBM * kLnCLd * sizeof(float);
constexpr size_t kLnSmem = kLnPipeBytes > kLnStageBytes ? kLnPipeBytes : kLnStageBytes;

// out[M, N] = LN(res + (bf16(a @ w) + bias)) * gamma + beta, for N <= 256.
// A block owns 64 full rows, so the LayerNorm statistics stay in the block.
// 8 warps as 2 x 4, each owning a 32 x 64 piece of the 64 x 256 tile.
// kDrop: the GEMM output is multiplied by the keep mask of `site` before the
// residual. kTrain: the pre-LN sum goes to pre_out when it is not null, and
// out may be null.
template <bool kDrop, bool kTrain>
__global__ void __launch_bounds__(kThreads)
    gemm_res_ln_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ res,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, bf16* __restrict__ out,
                       bf16* __restrict__ pre_out, int M, int N, int K,
                       float eps, DropSite site) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sa0 = reinterpret_cast<bf16*>(smem);
  bf16* const sb0 = sa0 + 2 * kLnBM * kALd;
  const int m0 = blockIdx.x * kLnBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / kBK;
  load_a_tile(sa0, a, M, K, m0, 0, kLnBM);
  load_b_tile(sb0, w, N, 0, 0, kLnBN, kLnBLd);
  nylon::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    bf16* const sa = sa0 + cur * kLnBM * kALd;
    bf16* const sb = sb0 + cur * kBK * kLnBLd;
    if (kt + 1 < nk) {
      load_a_tile(sa0 + (cur ^ 1) * kLnBM * kALd, a, M, K, m0, (kt + 1) * kBK,
                  kLnBM);
      load_b_tile(sb0 + (cur ^ 1) * kBK * kLnBLd, w, N, (kt + 1) * kBK, 0,
                  kLnBN, kLnBLd);
      nylon::cp_async_commit();
      nylon::cp_async_wait<1>();
    } else {
      nylon::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], sb + kk * kLnBLd + wn * 64 + j * 16, kLnBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The pipeline buffers are dead: stage the f32 tile over them.
  float* const C = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(C + (wm * 32 + i * 16) * kLnCLd + wn * 64 + j * 16,
                              acc[i][j], kLnCLd, wmma::mem_row_major);
  __syncthreads();

  // Each warp normalises 8 rows; lane owns columns lane + 32 t.
  const float inv_n = 1.f / (float)N;
  for (int rr = 0; rr < kLnBM / 8; ++rr) {
    const int r = warp * (kLnBM / 8) + rr;
    const int gr = m0 + r;
    if (gr >= M) break;  // warp-uniform
    float s[kLnBN / 32];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kLnBN / 32; ++t) {
      const int c = lane + 32 * t;
      s[t] = 0.f;
      if (c < N) {
        s[t] = nylon::residual_sum<bf16, kDrop>(
            C[r * kLnCLd + c], __bfloat162float(bias[c]),
            __bfloat162float(res[(size_t)gr * N + c]), site, (uint32_t)gr, c,
            N);
        if constexpr (kTrain)
          if (pre_out != nullptr)
            pre_out[(size_t)gr * N + c] = __float2bfloat16(s[t]);
        sum += s[t];
      }
    }
    const float mean = nylon::warp_sum(sum) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < kLnBN / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < N) {
        const float d = s[t] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(nylon::warp_sum(sq) * inv_n + eps);
    if constexpr (kTrain)
      if (out == nullptr) continue;  // warp-uniform
#pragma unroll
    for (int t = 0; t < kLnBN / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < N)
        out[(size_t)gr * N + c] =
            __float2bfloat16((s[t] - mean) * rstd * gamma[c] + beta[c]);
    }
  }
}

template <bool kDrop>
int launch_gemm_res_ln_train(const void* a, const void* w, const void* bias,
                             const void* res, const void* gamma,
                             const void* beta, void* out, void* pre_out,
                             int M, int N, int K, float eps, DropSite site,
                             cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_res_ln_kernel<kDrop, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLnSmem);
  if (e != cudaSuccess) return (int)e;
  gemm_res_ln_kernel<kDrop, true><<<(M + kLnBM - 1) / kLnBM, kThreads,
                                    kLnSmem, stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (const bf16*)res,
      (const float*)gamma, (const float*)beta, (bf16*)out, (bf16*)pre_out, M,
      N, K, eps, site);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nylon_gemm_bias(const void* a, const void* w, const void* bias, void* out,
                    int M, int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8)
    return (int)cudaErrorInvalidValue;
  const int n_tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const long long tiles = (long long)n_tiles_n * ((M + kGemmBM - 1) / kGemmBM);
  gemm_bias_kernel<false><<<(unsigned)tiles, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (bf16*)out, M, N, K,
      relu, n_tiles_n, DropSite{});
  return (int)cudaGetLastError();
}

// nylon_gemm_bias, then times the keep mask of a dropout site.
int nylon_gemm_bias_drop(const void* a, const void* w, const void* bias,
                         void* out, int M, int N, int K, int relu,
                         unsigned key, unsigned thresh, float scale, int half,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const int n_tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const long long tiles = (long long)n_tiles_n * ((M + kGemmBM - 1) / kGemmBM);
  gemm_bias_kernel<true><<<(unsigned)tiles, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (bf16*)out, M, N, K,
      relu, n_tiles_n, DropSite{key, thresh, scale, half, 0u});
  return (int)cudaGetLastError();
}

int nylon_gemm_res_ln(const void* a, const void* w, const void* bias,
                      const void* res, const void* gamma, const void* beta,
                      void* out, int M, int N, int K, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || N > kLnBN)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_res_ln_kernel<false, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLnSmem);
  if (e != cudaSuccess) return (int)e;
  gemm_res_ln_kernel<false, false><<<(M + kLnBM - 1) / kLnBM, kThreads,
                                     kLnSmem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (const bf16*)res,
      (const float*)gamma, (const float*)beta, (bf16*)out, nullptr, M, N, K,
      eps, DropSite{});
  return (int)cudaGetLastError();
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
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || N > kLnBN ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  return active ? launch_gemm_res_ln_train<true>(a, w, bias, res, gamma, beta,
                                                 out, pre_out, M, N, K, eps,
                                                 site, (cudaStream_t)stream)
                : launch_gemm_res_ln_train<false>(
                      a, w, bias, res, gamma, beta, out, pre_out, M, N, K,
                      eps, site, (cudaStream_t)stream);
}

const char* nylon_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
