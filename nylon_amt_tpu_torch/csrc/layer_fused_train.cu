// Backward kernels of the training layers K7, K8 and K9 on Hopper (sm_90a).
//
// Replaces the backward Pallas kernels of nylon_amt_tpu/ops/
// layer_fused_train.py: _enc_train_bwd_kernel (encoder_layer_train, K7),
// _dec_zero_train_bwd_kernel (decoder_layer_zero_train, K8) and
// _dec_train_bwd_kernel (decoder_layer_train, K9). Their forwards run the
// kernels of layer_fused.cu with a dropout site (kDrop); the masks are the
// index hashes of hash_mask.cuh (K6), so the backward regenerates exactly
// the forward's masks.
//
// The TPU kernel recomputed a layer's forward in VMEM and accumulated the
// weight gradients by read-modify-write over a sequential grid. Here the
// Python wrapper (ops/layer_fused_train.py) first recomputes the forward
// internals into device memory with the forward kernels (saving the pre-LN
// sums), then runs, per layer, in turn:
//
//  * ln_bwd_kernel: the LayerNorm backward of one row per warp (statistics
//    recomputed from the saved pre-LN sum), the bf16 cast of the input
//    gradient, the dropout mask of the site feeding the residual, and per-
//    block partial sums of dgamma/dbeta;
//  * gemm_nt_kernel: dX = dY @ W^T with the epilogues of the analytic
//    backward (bf16 cast, dropout mask, ReLU gate, + residual gradient,
//    embedding mask);
//  * the attention backward of mha.cu (nylon_attention_bwd), with the
//    layer's per-head probability masks;
//  * wgrad_kernel: dW = A^T @ dY over a chunk of rows into f32 per-chunk
//    partials (with the bias gradient's column sums), and reduce_rows_kernel
//    summing the partials in a fixed order. No float atomics: a weight
//    gradient is the same bits from run to run.
//
// What bounds them: the layer's GEMMs and attention products run at the
// WMMA rate of this simple tiling, and the recompute moves the layer's
// intermediates through device memory (~2 GB per frequency-encoder layer at
// batch 8). Fusing the recompute and wgmma tiles are later work.
//
// Numerics follow the TPU kernel's analytic backward cast for cast: every
// product accumulates in f32, each gradient is rounded to bf16 where the
// JAX code casts (.astype(dt)), weight gradients stay f32, dq/dk are scaled
// in f32 before their cast. The dX epilogue is layer_epilogue.cuh's.
//
// Float32 compute dtype: ln_bwd_kernel is instantiated for f32 rows
// (nylon_ln_bwd_f32); the dX and dW GEMMs have f32 twins in
// layer_fused_f32.cu (the SIMT core of gemm_f32.cuh), whose partials this
// file's reduce_rows sums in the same fixed order.

#include <mma.h>

#include "common.cuh"
#include "hash_mask.cuh"
#include "layer_epilogue.cuh"

using namespace nvcuda;
using nylon::bf16;
using nylon::DropSite;
using nylon::keep_value;

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel of this file
constexpr int kBK = 32;
constexpr int kALd = kBK + 8;

// rows x 32 tile of a row-major [M, K] matrix from column k0; rows past M are
// zero-filled.
__device__ __forceinline__ void load_rows32(bf16* dst, const bf16* a, int M,
                                            int K, int m0, int k0, int rows) {
  for (int c = threadIdx.x; c < rows * (kBK / 8); c += kThreads) {
    const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const int gr = m0 + r;
    const bool ok = gr < M;
    const bf16* src = a + (size_t)(ok ? gr : 0) * K + k0 + col;
    nylon::cp_async16(dst + r * kALd + col, src, ok);
  }
}

__device__ __forceinline__ void load8(float* dst, const bf16* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(b[e]);
}

// ------------------------------------------------------ LayerNorm backward --

constexpr int kLnMaxN = 256;

// For each row of the pre-LN sum s [M, N] and its output gradient dy:
// xhat, inv from s (f32 two-pass, as the forward); dxhat = dy * gamma;
// da = bf16((dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * inv); with
// kDrop also dam = bf16(da * keep) for the dropout site feeding the sum.
// Block b owns rows [b * rows_per_block, ...); its warps take every 8th row.
// dg_part[b] / db_part[b] = sum over the block's rows of dy * xhat / dy,
// summed warp by warp in a fixed order. T: bf16, or f32 (the float32
// compute dtype, where every cast to T is the identity).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ s,
                  const float* __restrict__ gamma, T* __restrict__ da,
                  T* __restrict__ dam, float* __restrict__ dg_part,
                  float* __restrict__ db_part, int M, int N,
                  int rows_per_block, float eps, DropSite site) {
  __shared__ float red[2][kThreads / 32][kLnMaxN];
  constexpr int kT = kLnMaxN / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = N / 32;
  const float inv_n = 1.f / (float)N;
  float dg[kT], db[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) dg[t] = db[t] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += kThreads / 32) {
    const size_t off = (size_t)row * N;
    float x[kT], g[kT], dxh[kT];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      x[t] = 0.f;
      if (t < nt) {
        x[t] = nylon::to_f(s[off + lane + 32 * t]);
        sum += x[t];
      }
    }
    const float mean = nylon::warp_sum(sum) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t)
      if (t < nt) {
        const float d = x[t] - mean;
        sq += d * d;
      }
    const float inv = rsqrtf(nylon::warp_sum(sq) * inv_n + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      g[t] = dxh[t] = 0.f;
      if (t < nt) {
        const int c = lane + 32 * t;
        const float xh = (x[t] - mean) * inv;
        const float d = nylon::to_f(dy[off + c]);
        dg[t] += d * xh;
        db[t] += d;
        dxh[t] = d * gamma[c];
        s1 += dxh[t];
        s2 += dxh[t] * xh;
        x[t] = xh;
      }
    }
    const float m1 = nylon::warp_sum(s1) * inv_n;
    const float m2 = nylon::warp_sum(s2) * inv_n;
#pragma unroll
    for (int t = 0; t < kT; ++t)
      if (t < nt) {
        const int c = lane + 32 * t;
        const T v = nylon::from_f<T>((dxh[t] - m1 - x[t] * m2) * inv);
        da[off + c] = v;
        if constexpr (kDrop)
          dam[off + c] = nylon::from_f<T>(
              nylon::to_f(v) * keep_value(site, (uint32_t)row, c, N));
      }
  }
#pragma unroll
  for (int t = 0; t < kT; ++t)
    if (t < nt) {
      red[0][warp][lane + 32 * t] = dg[t];
      red[1][warp][lane + 32 * t] = db[t];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[0][w][c];
      b += red[1][w][c];
    }
    dg_part[(size_t)blockIdx.x * N + c] = a;
    db_part[(size_t)blockIdx.x * N + c] = b;
  }
}

// ------------------------------------------------------------- dX = dY W^T --

constexpr int kNtBM = 128, kNtBN = 128;
constexpr size_t kNtPipeBytes = 2 * 2 * kNtBM * kALd * sizeof(bf16);

using nylon::NtEpilogue;

// out[M, Kout] = epilogue(bf16(dy[M, N] @ w^T)), w [Kout, N] row-major.
// The tiling of gemm_bias_kernel (layer_fused.cu): 8 warps as 2 x 4, each
// owning a 64 x 32 piece of the 128 x 128 tile; W^T tiles are W's rows read
// as column-major fragments.
__global__ void __launch_bounds__(kThreads, 2)
    gemm_nt_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int M, int N, int Kout,
                   int n_tiles_k, NtEpilogue ep) {
  __shared__ __align__(128) unsigned char smem[kNtPipeBytes];
  bf16* const sa0 = reinterpret_cast<bf16*>(smem);
  bf16* const sb0 = sa0 + 2 * kNtBM * kALd;
  const int m0 = (blockIdx.x / n_tiles_k) * kNtBM;
  const int c0 = (blockIdx.x % n_tiles_k) * kNtBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = N / kBK;
  load_rows32(sa0, dy, M, N, m0, 0, kNtBM);
  load_rows32(sb0, w, Kout, N, c0, 0, kNtBN);
  nylon::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    bf16* const sa = sa0 + cur * kNtBM * kALd;
    bf16* const sb = sb0 + cur * kNtBN * kALd;
    if (kt + 1 < nk) {
      load_rows32(sa0 + (cur ^ 1) * kNtBM * kALd, dy, M, N, m0,
                  (kt + 1) * kBK, kNtBM);
      load_rows32(sb0 + (cur ^ 1) * kNtBN * kALd, w, Kout, N, c0,
                  (kt + 1) * kBK, kNtBN);
      nylon::cp_async_commit();
      nylon::cp_async_wait<1>();
    } else {
      nylon::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 64 + i * 16) * kALd + kk,
                               kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb + (wn * 32 + j * 16) * kALd + kk,
                               kALd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The pipeline buffers are dead: one 16 x 16 staging tile per warp.
  float* const stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, e8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = c0 + wn * 32 + j * 16 + e8;
      if (gr < M && gc < Kout) {
        const size_t off = (size_t)gr * Kout + gc;
        float gate[8] = {}, add[8] = {};
        if (ep.gate) load8(gate, static_cast<const bf16*>(ep.gate) + off);
        if (ep.addend) load8(add, static_cast<const bf16*>(ep.addend) + off);
        uint4 ov;
        bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = __float2bfloat16(nylon::nt_epilogue<bf16>(
              stage[r * 16 + e8 + e], ep, gate[e], add[e], (uint32_t)gr,
              gc + e, Kout));
        *reinterpret_cast<uint4*>(out + off) = ov;
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------ dW = A^T dY --

constexpr int kWgBK = 128, kWgBN = 128;  // tile of dW [Ka, N]
constexpr int kWgRows = 32;              // rows per pipeline stage
constexpr int kWgLd = 128 + 8;

// rows x 128 tile of a row-major [*, width] matrix at (r0, c0); rows at or
// past r_end and columns at or past width (a multiple of 8) are zero-filled.
__device__ __forceinline__ void load_cols128(bf16* dst, const bf16* a,
                                             int width, int r0, int r_end,
                                             int c0) {
  for (int c = threadIdx.x; c < kWgRows * 16; c += kThreads) {
    const int r = c / 16, col = (c % 16) * 8;
    const bool ok = r0 + r < r_end && c0 + col < width;
    const bf16* src = a + (ok ? (size_t)(r0 + r) * width + c0 + col : 0);
    nylon::cp_async16(dst + r * kWgLd + col, src, ok);
  }
}

// part[chunk][Ka][N] = a[rows, Ka]^T @ dy[rows, N] over the chunk's rows;
// blocks of the first Ka tile also write bias_part[chunk][N] = column sums
// of dy over those rows. 8 warps as 2 x 4, each owning 64 x 32 of the tile;
// a tile past Ka or N (multiples of 16) is zero-filled there and not stored.
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ dy,
                 float* __restrict__ part, float* __restrict__ bias_part,
                 int M, int Ka, int N, int rows_per_chunk) {
  __shared__ __align__(128) bf16 sa[2][kWgRows * kWgLd];
  __shared__ __align__(128) bf16 sb[2][kWgRows * kWgLd];
  const int n0 = blockIdx.x * kWgBN, k0 = blockIdx.y * kWgBK;
  const int chunk = blockIdx.z;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(M, r_begin + rows_per_chunk);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const bool bias = blockIdx.y == 0;
  float bsum = 0.f;  // column threadIdx.x of the bias sum (threads < 128)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int steps = r_end > r_begin ? (r_end - r_begin + kWgRows - 1) / kWgRows
                                    : 0;
  if (steps > 0) {
    load_cols128(sa[0], a, Ka, r_begin, r_end, k0);
    load_cols128(sb[0], dy, N, r_begin, r_end, n0);
    nylon::cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    if (st + 1 < steps) {
      const int rn = r_begin + (st + 1) * kWgRows;
      load_cols128(sa[cur ^ 1], a, Ka, rn, r_end, k0);
      load_cols128(sb[cur ^ 1], dy, N, rn, r_end, n0);
      nylon::cp_async_commit();
      nylon::cp_async_wait<1>();
    } else {
      nylon::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWgRows; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sa[cur] + kk * kWgLd + wm * 64 + i * 16,
                               kWgLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb[cur] + kk * kWgLd + wn * 32 + j * 16,
                               kWgLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (bias && threadIdx.x < kWgBN) {
      // rows past r_end are zero-filled
      for (int r = 0; r < kWgRows; ++r)
        bsum += __bfloat162float(sb[cur][r * kWgLd + threadIdx.x]);
    }
    __syncthreads();
  }

  float* const dst = part + (size_t)chunk * Ka * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = k0 + wm * 64 + i * 16, col = n0 + wn * 32 + j * 16;
      if (row < Ka && col < N)  // warp-uniform
        wmma::store_matrix_sync(dst + (size_t)row * N + col, acc[i][j], N,
                                wmma::mem_row_major);
    }
  if (bias && threadIdx.x < kWgBN && n0 + threadIdx.x < N)
    bias_part[(size_t)chunk * N + n0 + threadIdx.x] = bsum;
}

// out[i] = sum over p = 0, 1, ..., P - 1 of parts[p][i], in that order.
__global__ void __launch_bounds__(kThreads)
    reduce_rows_kernel(const float* __restrict__ parts,
                       float* __restrict__ out, int P, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += parts[(size_t)p * n + i];
  out[i] = s;
}

template <typename T>
int launch_ln_bwd(const void* dy, const void* s, const void* gamma, void* da,
                  void* dam, void* dg_part, void* db_part, int M, int N,
                  int rows_per_block, int n_blocks, float eps, int active,
                  unsigned key, unsigned thresh, float scale, int half,
                  cudaStream_t stream) {
  if (M <= 0 || N <= 0 || N % 32 || N > kLnMaxN || rows_per_block <= 0 ||
      (long long)rows_per_block * n_blocks < M || (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  if (active)
    ln_bwd_kernel<T, true><<<n_blocks, kThreads, 0, stream>>>(
        (const T*)dy, (const T*)s, (const float*)gamma, (T*)da, (T*)dam,
        (float*)dg_part, (float*)db_part, M, N, rows_per_block, eps, site);
  else
    ln_bwd_kernel<T, false><<<n_blocks, kThreads, 0, stream>>>(
        (const T*)dy, (const T*)s, (const float*)gamma, (T*)da, nullptr,
        (float*)dg_part, (float*)db_part, M, N, rows_per_block, eps, site);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// da = bf16 LayerNorm input gradient; with active also dam = bf16(da *
// keep). dg_part/db_part: [n_blocks, N] partial sums.
int nylon_ln_bwd(const void* dy, const void* s, const void* gamma, void* da,
                 void* dam, void* dg_part, void* db_part, int M, int N,
                 int rows_per_block, int n_blocks, float eps, int active,
                 unsigned key, unsigned thresh, float scale, int half,
                 void* stream) {
  return launch_ln_bwd<bf16>(dy, s, gamma, da, dam, dg_part, db_part, M, N,
                             rows_per_block, n_blocks, eps, active, key,
                             thresh, scale, half, (cudaStream_t)stream);
}

// The float32 twin of nylon_ln_bwd: f32 dy, s, da and dam.
int nylon_ln_bwd_f32(const void* dy, const void* s, const void* gamma,
                     void* da, void* dam, void* dg_part, void* db_part, int M,
                     int N, int rows_per_block, int n_blocks, float eps,
                     int active, unsigned key, unsigned thresh, float scale,
                     int half, void* stream) {
  return launch_ln_bwd<float>(dy, s, gamma, da, dam, dg_part, db_part, M, N,
                              rows_per_block, n_blocks, eps, active, key,
                              thresh, scale, half, (cudaStream_t)stream);
}

// out[M, Kout] = epilogue(bf16(dy[M, N] @ w[Kout, N]^T)); gate and addend
// may be null; act1/act2 switch the two dropout sites.
int nylon_gemm_nt(const void* dy, const void* w, void* out, const void* gate,
                  const void* addend, int M, int N, int Kout, int act1,
                  unsigned key1, unsigned thresh1, float scale1, int half1,
                  int act2, unsigned key2, unsigned thresh2, float scale2,
                  int half2, void* stream) {
  if (M <= 0 || N <= 0 || Kout <= 0 || N % kBK || Kout % 8 ||
      (half1 && 2 * half1 != Kout) || (half2 && 2 * half2 != Kout))
    return (int)cudaErrorInvalidValue;
  const NtEpilogue ep{gate, addend, DropSite{key1, thresh1, scale1, half1, 0u},
                      DropSite{key2, thresh2, scale2, half2, 0u}, act1, act2};
  const int n_tiles_k = (Kout + kNtBN - 1) / kNtBN;
  const long long tiles = (long long)n_tiles_k * ((M + kNtBM - 1) / kNtBM);
  gemm_nt_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, (const bf16*)w, (bf16*)out, M, N, Kout, n_tiles_k, ep);
  return (int)cudaGetLastError();
}

// part[chunks, Ka, N] and bias_part[chunks, N] for dW = a^T dy, a [M, Ka],
// dy [M, N], rows split into chunks of rows_per_chunk (a multiple of 32);
// Ka and N multiples of 16.
int nylon_wgrad(const void* a, const void* dy, void* part, void* bias_part,
                int M, int Ka, int N, int rows_per_chunk, int chunks,
                void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % 16 || N % 16 ||
      rows_per_chunk <= 0 || rows_per_chunk % kWgRows || chunks <= 0 ||
      chunks > 65535 || (long long)rows_per_chunk * chunks < M)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kWgBN - 1) / kWgBN, (Ka + kWgBK - 1) / kWgBK, chunks);
  wgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)dy, (float*)part, (float*)bias_part, M, Ka,
      N, rows_per_chunk);
  return (int)cudaGetLastError();
}

// out[n] = sum over the P rows of parts[P, n], in row order.
int nylon_reduce_rows(const void* parts, void* out, int P, long long n,
                      void* stream) {
  if (P <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  reduce_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>((const float*)parts,
                                               (float*)out, P, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
