// Float32 instantiations of the layer GEMMs on Hopper (sm_90a).
//
// The default model configuration computes in float32 (ModelConfig.
// compute_dtype), and the reference's Pallas kernels follow their inputs'
// dtype (nylon_amt_tpu/ops/layer_fused.py: _matmul and _layer_norm cast to
// x.dtype). These kernels are the f32 twins of the bf16 GEMMs, for the
// same TPU kernels:
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
//    epilogues;
//  * wgrad_f32_kernel <- wgrad_kernel: dW = A^T dY per row chunk into f32
//    partials (with the bias gradient's column sums), summed in a fixed
//    order by layer_fused_train.cu's reduce_rows: no float atomics, the
//    same bits from run to run.
//
// The product core is gemm_f32.cuh (SIMT FFMA tiles): wmma has no f32
// operands. The epilogues are layer_epilogue.cuh's, the same op sequence
// as the bf16 kernels with every rounding to the compute dtype an identity.
// What bounds them: FFMA issue at the layer widths; the default widths (hid
// 64, pf 128) make every product thin, so N-tiles are sized to the width
// (64, 128 or 256 columns) rather than padded to 256.

#include "gemm_f32.cuh"
#include "hash_mask.cuh"
#include "layer_epilogue.cuh"

using nylon::DropSite;
using nylon::F32Gemm;
using nylon::keep_value;
using nylon::NtEpilogue;

namespace {

constexpr int kThreads = 256;

// ----------------------------------------------------------- GEMM + bias ----

using GemmNN = F32Gemm<64, 64, 4, 4, false, false>;

// out[M, N] = (a[M, K] @ w[K, N]) + bias [, ReLU] [, x keep of `site`].
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bias_f32_kernel(const float* __restrict__ a,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int M, int N, int K,
                         int relu, int n_tiles_n, DropSite site) {
  __shared__ __align__(16) GemmNN::Smem sm;
  const int m0 = (blockIdx.x / n_tiles_n) * 64;
  const int n0 = (blockIdx.x % n_tiles_n) * 64;
  float acc[4][4];
  GemmNN::run(sm, a, K, w, N, M, N, m0, n0, 0, K, acc, [](const float*) {});
  const int col = n0 + GemmNN::col(0);
  if (col >= N) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + col);
  const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + GemmNN::row(i);
    if (row >= M) continue;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = nylon::bias_epilogue<float, kDrop>(acc[i][e], b[e], relu, site,
                                                (uint32_t)row, col + e, N);
    *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

// ------------------------------------- GEMM + residual + shared LayerNorm ----

// A block owns BM full rows of BN >= N columns: 64 x 64, 64 x 128 or 32 x
// 256 tiles, the f32 product staged in shared memory over the dead
// pipeline buffers, then each warp normalises BM / 8 rows (lane owning
// columns lane + 32 t).
template <int BN>
struct LnTile {
  static constexpr int BM = BN == 256 ? 32 : 64;
  static constexpr int TN = BN == 64 ? 4 : 8;
  using Gemm = F32Gemm<BM, BN, 4, TN, false, false>;
  static constexpr int kCLd = BN + 4;
  union Smem {
    typename Gemm::Smem pipe;
    float c[BM * kCLd];
  };
};

// out[M, N] = LN(res + (a @ w + bias) [x keep]) * gamma + beta; kTrain: the
// pre-LN sum to pre_out when it is not null, and out may be null.
template <int BN, bool kDrop, bool kTrain>
__global__ void __launch_bounds__(kThreads)
    gemm_res_ln_f32_kernel(const float* __restrict__ a,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ res,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           float* __restrict__ out,
                           float* __restrict__ pre_out, int M, int N, int K,
                           float eps, DropSite site) {
  using Tile = LnTile<BN>;
  using Gemm = typename Tile::Gemm;
  constexpr int BM = Tile::BM, TN = Tile::TN, kCLd = Tile::kCLd;
  __shared__ __align__(16) typename Tile::Smem sm;
  const int m0 = blockIdx.x * BM;
  float acc[4][TN];
  Gemm::run(sm.pipe, a, K, w, N, M, N, m0, 0, 0, K, acc,
            [](const float*) {});
  // run() ends on a barrier: the pipeline buffers are dead
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN / 4; ++j)
      *reinterpret_cast<float4*>(sm.c + Gemm::row(i) * kCLd +
                                 Gemm::col(4 * j)) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                      acc[i][4 * j + 3]);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_n = 1.f / (float)N;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int gr = m0 + r;
    if (gr >= M) break;  // warp-uniform
    float s[BN / 32];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < BN / 32; ++t) {
      const int c = lane + 32 * t;
      s[t] = 0.f;
      if (c < N) {
        s[t] = nylon::residual_sum<float, kDrop>(
            sm.c[r * kCLd + c], bias[c], res[(size_t)gr * N + c], site,
            (uint32_t)gr, c, N);
        if constexpr (kTrain)
          if (pre_out != nullptr) pre_out[(size_t)gr * N + c] = s[t];
        sum += s[t];
      }
    }
    const float mean = nylon::warp_sum(sum) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < BN / 32; ++t) {
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
    for (int t = 0; t < BN / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < N)
        out[(size_t)gr * N + c] = (s[t] - mean) * rstd * gamma[c] + beta[c];
    }
  }
}

template <int BN, bool kDrop, bool kTrain>
int launch_res_ln(const void* a, const void* w, const void* bias,
                  const void* res, const void* gamma, const void* beta,
                  void* out, void* pre_out, int M, int N, int K, float eps,
                  DropSite site, cudaStream_t stream) {
  constexpr int BM = LnTile<BN>::BM;
  gemm_res_ln_f32_kernel<BN, kDrop, kTrain>
      <<<(M + BM - 1) / BM, kThreads, 0, stream>>>(
          (const float*)a, (const float*)w, (const float*)bias,
          (const float*)res, (const float*)gamma, (const float*)beta,
          (float*)out, (float*)pre_out, M, N, K, eps, site);
  return (int)cudaGetLastError();
}

// The N tier of a residual layer: 64, 128 or 256 columns.
template <bool kDrop, bool kTrain>
int res_ln_tier(const void* a, const void* w, const void* bias,
                const void* res, const void* gamma, const void* beta,
                void* out, void* pre_out, int M, int N, int K, float eps,
                DropSite site, cudaStream_t stream) {
  if (N <= 64)
    return launch_res_ln<64, kDrop, kTrain>(a, w, bias, res, gamma, beta, out,
                                            pre_out, M, N, K, eps, site,
                                            stream);
  if (N <= 128)
    return launch_res_ln<128, kDrop, kTrain>(a, w, bias, res, gamma, beta,
                                             out, pre_out, M, N, K, eps, site,
                                             stream);
  return launch_res_ln<256, kDrop, kTrain>(a, w, bias, res, gamma, beta, out,
                                           pre_out, M, N, K, eps, site,
                                           stream);
}

// ------------------------------------------------------------- dX = dY W^T --

using GemmNT = F32Gemm<64, 64, 4, 4, false, true>;

// out[M, Kout] = epilogue(dy[M, N] @ w[Kout, N]^T).
__global__ void __launch_bounds__(kThreads, 2)
    gemm_nt_f32_kernel(const float* __restrict__ dy,
                       const float* __restrict__ w, float* __restrict__ out,
                       int M, int N, int Kout, int n_tiles_k, NtEpilogue ep) {
  __shared__ __align__(16) GemmNT::Smem sm;
  const int m0 = (blockIdx.x / n_tiles_k) * 64;
  const int c0 = (blockIdx.x % n_tiles_k) * 64;
  float acc[4][4];
  GemmNT::run(sm, dy, N, w, N, M, Kout, m0, c0, 0, N, acc,
              [](const float*) {});
  const int col = c0 + GemmNT::col(0);
  if (col >= Kout) return;
  const float* gate = static_cast<const float*>(ep.gate);
  const float* addend = static_cast<const float*>(ep.addend);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + GemmNT::row(i);
    if (row >= M) continue;
    const size_t off = (size_t)row * Kout + col;
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), av = gv;
    if (gate) gv = *reinterpret_cast<const float4*>(gate + off);
    if (addend) av = *reinterpret_cast<const float4*>(addend + off);
    const float g[4] = {gv.x, gv.y, gv.z, gv.w};
    const float ad[4] = {av.x, av.y, av.z, av.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = nylon::nt_epilogue<float>(acc[i][e], ep, g[e], ad[e],
                                       (uint32_t)row, col + e, Kout);
    *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ------------------------------------------------------------ dW = A^T dY --

using GemmTN = F32Gemm<64, 64, 4, 4, true, false>;

// part[chunk][Ka][N] = a[rows, Ka]^T @ dy[rows, N] over the chunk's rows;
// blocks of the first Ka tile also write bias_part[chunk][N], the column
// sums of dy over those rows (row order, from the staged dY slices).
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ dy,
                     float* __restrict__ part, float* __restrict__ bias_part,
                     int M, int Ka, int N, int rows_per_chunk) {
  __shared__ __align__(16) GemmTN::Smem sm;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int chunk = blockIdx.z;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(M, r_begin + rows_per_chunk);
  const bool bias = blockIdx.y == 0;
  float bsum = 0.f;  // column threadIdx.x of the bias sum (threads < 64)
  float acc[4][4];
  GemmTN::run(sm, a, Ka, dy, N, Ka, N, k0, n0, r_begin, r_end, acc,
              [&](const float* Bs) {
                if (bias && threadIdx.x < 64) {
                  // rows past r_end are zero-filled
#pragma unroll
                  for (int k = 0; k < GemmTN::kBK; ++k)
                    bsum += Bs[k * GemmTN::kBLd + threadIdx.x];
                }
              });
  float* const dst = part + (size_t)chunk * Ka * N;
  const int col = n0 + GemmTN::col(0);
  if (col < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + GemmTN::row(i);
      if (row < Ka)
        *reinterpret_cast<float4*>(dst + (size_t)row * N + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (bias && threadIdx.x < 64 && n0 + threadIdx.x < N)
    bias_part[(size_t)chunk * N + n0 + threadIdx.x] = bsum;
}

}  // namespace

extern "C" {

// The float32 twins of nylon_gemm_bias / nylon_gemm_bias_drop
// (layer_fused.cu): K % 4 == 0, N % 4 == 0.
int nylon_gemm_bias_f32(const void* a, const void* w, const void* bias,
                        void* out, int M, int N, int K, int relu,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  const int n_tiles_n = (N + 63) / 64;
  const long long tiles = (long long)n_tiles_n * ((M + 63) / 64);
  gemm_bias_f32_kernel<false><<<(unsigned)tiles, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)a, (const float*)w, (const float*)bias, (float*)out, M, N,
      K, relu, n_tiles_n, DropSite{});
  return (int)cudaGetLastError();
}

int nylon_gemm_bias_drop_f32(const void* a, const void* w, const void* bias,
                             void* out, int M, int N, int K, int relu,
                             unsigned key, unsigned thresh, float scale,
                             int half, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const int n_tiles_n = (N + 63) / 64;
  const long long tiles = (long long)n_tiles_n * ((M + 63) / 64);
  gemm_bias_f32_kernel<true><<<(unsigned)tiles, kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)a, (const float*)w, (const float*)bias, (float*)out, M, N,
      K, relu, n_tiles_n, DropSite{key, thresh, scale, half, 0u});
  return (int)cudaGetLastError();
}

// The float32 twins of nylon_gemm_res_ln / nylon_gemm_res_ln_train: N <=
// 256, K % 4 == 0, N % 4 == 0.
int nylon_gemm_res_ln_f32(const void* a, const void* w, const void* bias,
                          const void* res, const void* gamma,
                          const void* beta, void* out, int M, int N, int K,
                          float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 || N > 256)
    return (int)cudaErrorInvalidValue;
  return res_ln_tier<false, false>(a, w, bias, res, gamma, beta, out, nullptr,
                                   M, N, K, eps, DropSite{},
                                   (cudaStream_t)stream);
}

int nylon_gemm_res_ln_train_f32(const void* a, const void* w,
                                const void* bias, const void* res,
                                const void* gamma, const void* beta,
                                void* out, void* pre_out, int M, int N, int K,
                                float eps, int active, unsigned key,
                                unsigned thresh, float scale, int half,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 || N > 256 ||
      (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  return active ? res_ln_tier<true, true>(a, w, bias, res, gamma, beta, out,
                                          pre_out, M, N, K, eps, site,
                                          (cudaStream_t)stream)
                : res_ln_tier<false, true>(a, w, bias, res, gamma, beta, out,
                                           pre_out, M, N, K, eps, site,
                                           (cudaStream_t)stream);
}

// The float32 twin of nylon_gemm_nt (layer_fused_train.cu): N % 4 == 0,
// Kout % 4 == 0.
int nylon_gemm_nt_f32(const void* dy, const void* w, void* out,
                      const void* gate, const void* addend, int M, int N,
                      int Kout, int act1, unsigned key1, unsigned thresh1,
                      float scale1, int half1, int act2, unsigned key2,
                      unsigned thresh2, float scale2, int half2,
                      void* stream) {
  if (M <= 0 || N <= 0 || Kout <= 0 || N % 4 || Kout % 4 ||
      (half1 && 2 * half1 != Kout) || (half2 && 2 * half2 != Kout))
    return (int)cudaErrorInvalidValue;
  const NtEpilogue ep{gate, addend, DropSite{key1, thresh1, scale1, half1, 0u},
                      DropSite{key2, thresh2, scale2, half2, 0u}, act1, act2};
  const int n_tiles_k = (Kout + 63) / 64;
  const long long tiles = (long long)n_tiles_k * ((M + 63) / 64);
  gemm_nt_f32_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dy, (const float*)w, (float*)out, M, N, Kout, n_tiles_k,
      ep);
  return (int)cudaGetLastError();
}

// The float32 twin of nylon_wgrad: Ka % 4 == 0, N % 4 == 0, any
// rows_per_chunk.
int nylon_wgrad_f32(const void* a, const void* dy, void* part,
                    void* bias_part, int M, int Ka, int N, int rows_per_chunk,
                    int chunks, void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % 4 || N % 4 || rows_per_chunk <= 0 ||
      chunks <= 0 || chunks > 65535 || (long long)rows_per_chunk * chunks < M)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + 63) / 64, (Ka + 63) / 64, chunks);
  wgrad_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)dy, (float*)part, (float*)bias_part, M,
      Ka, N, rows_per_chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
