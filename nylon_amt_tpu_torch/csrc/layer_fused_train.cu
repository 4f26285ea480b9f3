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
//  * attn_bwd_dq_kernel / attn_bwd_dkv_kernel: attention backward per
//    (sequence, head). The first owns query rows (recomputes s, p, l, the
//    mask, row = sum(da * a), ds; writes dq and the row statistics), the
//    second owns key rows (recomputes a and ds from the statistics; dk, dv
//    summed over all queries inside one block, so no reduction across
//    blocks);
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
// in f32 before their cast.

#include <mma.h>

#include "common.cuh"
#include "hash_mask.cuh"

using namespace nvcuda;
using nylon::bf16;
using nylon::bf16_round;
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
// summed warp by warp in a fixed order.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ s,
                  const float* __restrict__ gamma, bf16* __restrict__ da,
                  bf16* __restrict__ dam, float* __restrict__ dg_part,
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
        x[t] = __bfloat162float(s[off + lane + 32 * t]);
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
        const float d = __bfloat162float(dy[off + c]);
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
        const bf16 v = __float2bfloat16((dxh[t] - m1 - x[t] * m2) * inv);
        da[off + c] = v;
        if constexpr (kDrop)
          dam[off + c] = __float2bfloat16(
              __bfloat162float(v) * keep_value(site, (uint32_t)row, c, N));
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

struct Epilogue {
  const bf16* gate;    // keep v only where gate > 0 (ReLU of the forward)
  const bf16* addend;  // v = bf16(addend + v)
  DropSite m1;         // v = bf16(v * keep) right after the cast
  DropSite m2;         // v = bf16(v * keep) at the end
  int act1, act2;
};

// out[M, Kout] = epilogue(bf16(dy[M, N] @ w^T)), w [Kout, N] row-major.
// The tiling of gemm_bias_kernel (layer_fused.cu): 8 warps as 2 x 4, each
// owning a 64 x 32 piece of the 128 x 128 tile; W^T tiles are W's rows read
// as column-major fragments.
__global__ void __launch_bounds__(kThreads, 2)
    gemm_nt_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int M, int N, int Kout,
                   int n_tiles_k, Epilogue ep) {
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
        float gate[8], add[8];
        if (ep.gate) load8(gate, ep.gate + off);
        if (ep.addend) load8(add, ep.addend + off);
        uint4 ov;
        bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = bf16_round(stage[r * 16 + e8 + e]);
          if (ep.act1)
            v = bf16_round(v * keep_value(ep.m1, (uint32_t)gr, gc + e, Kout));
          if (ep.gate && !(gate[e] > 0.f)) v = 0.f;
          if (ep.addend) v = bf16_round(add[e] + v);
          if (ep.act2)
            v = bf16_round(v * keep_value(ep.m2, (uint32_t)gr, gc + e, Kout));
          o[e] = __float2bfloat16(v);
        }
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
// past r_end are zero-filled.
__device__ __forceinline__ void load_cols128(bf16* dst, const bf16* a,
                                             int width, int r0, int r_end,
                                             int c0) {
  for (int c = threadIdx.x; c < kWgRows * 16; c += kThreads) {
    const int r = c / 16, col = (c % 16) * 8;
    const bool ok = r0 + r < r_end;
    const bf16* src = a + (size_t)(ok ? r0 + r : 0) * width + c0 + col;
    nylon::cp_async16(dst + r * kWgLd + col, src, ok);
  }
}

// part[chunk][Ka][N] = a[rows, Ka]^T @ dy[rows, N] over the chunk's rows;
// blocks of the first Ka tile also write bias_part[chunk][N] = column sums
// of dy over those rows. 8 warps as 2 x 4, each owning 64 x 32 of the tile.
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
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          dst + (size_t)(k0 + wm * 64 + i * 16) * N + n0 + wn * 32 + j * 16,
          acc[i][j], N, wmma::mem_row_major);
  if (bias && threadIdx.x < kWgBN)
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

// ------------------------------------------------------ attention backward --

constexpr int kAttnRows = 128;  // query (kernel A) or key (kernel B) rows
constexpr int kMaxL = 256;
constexpr int kSLd = 16 + 4;    // f32 row of a staged 16 x 16 tile
constexpr int kPLd = 16 + 8;    // bf16 row of a 16 x 16 tile

struct AttnBwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* stats;  // [3][n_seq][n_heads][lq]: m, l, row
  int n_seq, n_heads, lq, lk;
  long long q_row, q_seq, kv_row, kv_seq, do_row, do_seq, dq_row, dq_seq,
      dkv_row, dkv_seq;
  float scale, scale_log2e;
  uint32_t seed_mix;
  int tag_base;
  DropSite site;  // thresh, scale, half of the probability site
};

template <int D>
__host__ __device__ constexpr int bwd_tile_bytes() {
  // two bf16 [16][D+8] tiles
  return 2 * 16 * (D + 8) * (int)sizeof(bf16);
}

// Per-warp region of kernel A: Q and dO tiles (then the f32 dq output, 16 x
// (D+4), over them), a score tile and a dP tile (f32), a ds tile (bf16).
template <int D>
__host__ __device__ constexpr int bwd_q_region_bytes() {
  return bwd_tile_bytes<D>() + 2 * 16 * kSLd * 4 + 16 * kPLd * 2;
}

// 16 x 16 f32 tile of rows(A) . rows(B)^T over D columns: a[kk] holds the
// warp's 16 rows of A, b points at 16 rows of B in shared memory.
template <int D>
__device__ __forceinline__ void row_dot_tile(
    float* dst,
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>* a,
    const bf16* b, int ldb) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
    wmma::load_matrix_sync(bf, b + kk * 16, ldb);
    wmma::mma_sync(acc, a[kk], bf, acc);
  }
  wmma::store_matrix_sync(dst, acc, kSLd, wmma::mem_row_major);
  __syncwarp();
}

// Stage rows [r0, r0 + rows) of a strided [*, D] head slice into dst
// (row length D + 8); rows at or past n are zero.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int rows, int n, int tid,
                                           int nthreads) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < rows * (D / 8); c += nthreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    uint4 val = zero;
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c8) = val;
  }
}

// Kernel A: one block per (sequence, head, 128-query tile); each warp owns
// 16 query rows, K and V of the whole sequence sit in shared memory. Four
// passes over the key tiles (the same MMAs each time, so the same scores):
// the row max m; l = sum p; row = sum(da * a) with a = p / l and da = dP *
// keep; then ds = bf16(a * (da - row)) and dq += ds K. Writes dq * scale
// and (m, l, row) of every query row for kernel B.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(AttnBwdArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kvLd = D + 8;
  constexpr int oLd = D + 4;
  const int lq = args.lq, lk = args.lk;
  const int lk_pad = (lk + 15) & ~15;
  bf16* const Ks = reinterpret_cast<bf16*>(smem);
  bf16* const Vs = Ks + lk_pad * kvLd;
  unsigned char* const regions =
      reinterpret_cast<unsigned char*>(Vs + lk_pad * kvLd);

  const int seq = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_rows<D>(Ks, args.k + seq * args.kv_seq + h * D, args.kv_row, 0,
                lk_pad, lk, threadIdx.x, kThreads);
  stage_rows<D>(Vs, args.v + seq * args.kv_seq + h * D, args.kv_row, 0,
                lk_pad, lk, threadIdx.x, kThreads);
  unsigned char* const region = regions + warp * bwd_q_region_bytes<D>();
  bf16* const Qw = reinterpret_cast<bf16*>(region);
  bf16* const dOw = Qw + 16 * kvLd;
  float* const Sw = reinterpret_cast<float*>(region + bwd_tile_bytes<D>());
  float* const Dw = Sw + 16 * kSLd;
  bf16* const Pw = reinterpret_cast<bf16*>(Dw + 16 * kSLd);
  float* const Ow = reinterpret_cast<float*>(region);
  const int qw0 = q0 + warp * 16;
  stage_rows<D>(Qw, args.q + seq * args.q_seq + h * D, args.q_row, qw0, 16,
                lq, lane, 32);
  stage_rows<D>(dOw, args.dout + seq * args.do_seq + h * D, args.do_row, qw0,
                16, lq, lane, 32);
  __syncthreads();
  // From here on every warp works alone: no block-wide barrier follows.
  if (qw0 >= lq) return;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16],
      df[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qw + kk * 16, kvLd);
    wmma::load_matrix_sync(df[kk], dOw + kk * 16, kvLd);
  }
  __syncwarp();

  // Lanes 2r and 2r+1 own row r of a tile, 8 columns each.
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const float sl2e = args.scale_log2e;
  const float neg_inf = __int_as_float(0xff800000u);
  DropSite hsite = args.site;
  if constexpr (kDrop) hsite.key = nylon::head_key(args.seed_mix, args.tag_base, h);
  const uint32_t mask_row = (uint32_t)seq * (uint32_t)lq + (uint32_t)(qw0 + r);

  float m = neg_inf;
  for (int j0 = 0; j0 < lk_pad; j0 += 16) {
    row_dot_tile<D>(Sw, qf, Ks + j0 * kvLd, kvLd);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j0 + c0 + e < lk) m = fmaxf(m, Sw[r * kSLd + c0 + e] * sl2e);
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  float l = 0.f;
  for (int j0 = 0; j0 < lk_pad; j0 += 16) {
    row_dot_tile<D>(Sw, qf, Ks + j0 * kvLd, kvLd);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j0 + c0 + e < lk) l += exp2f(Sw[r * kSLd + c0 + e] * sl2e - m);
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  float row = 0.f;
  for (int j0 = 0; j0 < lk_pad; j0 += 16) {
    row_dot_tile<D>(Sw, qf, Ks + j0 * kvLd, kvLd);
    row_dot_tile<D>(Dw, df, Vs + j0 * kvLd, kvLd);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + c0 + e;
      if (j < lk) {
        const float a = exp2f(Sw[r * kSLd + c0 + e] * sl2e - m) / l;
        float da = Dw[r * kSLd + c0 + e];
        if constexpr (kDrop) da *= keep_value(hsite, mask_row, j, lk);
        row += da * a;
      }
    }
    __syncwarp();
  }
  row += __shfl_xor_sync(0xffffffffu, row, 1);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(dq[dj], 0.f);
  for (int j0 = 0; j0 < lk_pad; j0 += 16) {
    row_dot_tile<D>(Sw, qf, Ks + j0 * kvLd, kvLd);
    row_dot_tile<D>(Dw, df, Vs + j0 * kvLd, kvLd);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + c0 + e;
      float ds = 0.f;
      if (j < lk) {
        const float a = exp2f(Sw[r * kSLd + c0 + e] * sl2e - m) / l;
        float da = Dw[r * kSLd + c0 + e];
        if constexpr (kDrop) da *= keep_value(hsite, mask_row, j, lk);
        ds = a * (da - row);
      }
      Pw[r * kPLd + c0 + e] = __float2bfloat16(ds);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sf;
    wmma::load_matrix_sync(sf, Pw, kPLd);
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kf;
      wmma::load_matrix_sync(kf, Ks + j0 * kvLd + dj * 16, kvLd);
      wmma::mma_sync(dq[dj], sf, kf, dq[dj]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(Ow + dj * 16, dq[dj], oLd, wmma::mem_row_major);
  __syncwarp();
  bf16* const dqb = args.dq + seq * args.dq_seq + h * D;
  for (int rr = 0; rr < 16; ++rr) {
    const int gq = qw0 + rr;
    if (gq >= lq) break;  // warp-uniform
    for (int c = lane; c < D; c += 32)
      dqb[gq * args.dq_row + c] = __float2bfloat16(Ow[rr * oLd + c] * args.scale);
  }
  const int gq = qw0 + r;
  if ((lane & 1) == 0 && gq < lq) {
    const size_t plane = (size_t)args.n_seq * args.n_heads * lq;
    const size_t at = ((size_t)seq * args.n_heads + h) * lq + gq;
    args.stats[at] = m;
    args.stats[plane + at] = l;
    args.stats[2 * plane + at] = row;
  }
}

// Per-warp region of kernel B: its K and V tiles (then the f32 dk/dv output
// over them), transposed score and dP tiles (f32), ad and ds tiles (bf16).
template <int D>
__host__ __device__ constexpr int bwd_kv_region_bytes() {
  constexpr int work = 2 * 16 * kSLd * 4 + 2 * 16 * kPLd * 2;
  constexpr int tiles = bwd_tile_bytes<D>();
  constexpr int out = 16 * (D + 4) * 4;
  return (tiles > out ? tiles : out) + work;
}

template <int D>
__host__ __device__ constexpr size_t bwd_kv_smem_bytes(int lq_pad) {
  return (size_t)2 * lq_pad * (D + 8) * sizeof(bf16) +
         (size_t)3 * lq_pad * sizeof(float) +
         (size_t)(kThreads / 32) * bwd_kv_region_bytes<D>();
}

// Kernel B: one block per (sequence, head, 128-key tile); each warp owns 16
// key rows and walks all query tiles (Q, dO and the row statistics of the
// sequence in shared memory): s^T = K Q^T, dP^T = V dO^T, a = exp2(s - m) / l,
// ad = a * keep, ds = a * (dP * keep - row); dV += bf16(ad)^T dO and dK +=
// bf16(ds)^T Q stay in registers. Writes dk * scale and dv.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(AttnBwdArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kvLd = D + 8;
  constexpr int oLd = D + 4;
  const int lq = args.lq, lk = args.lk;
  const int lq_pad = (lq + 15) & ~15;
  bf16* const Qs = reinterpret_cast<bf16*>(smem);
  bf16* const dOs = Qs + lq_pad * kvLd;
  float* const ms = reinterpret_cast<float*>(dOs + lq_pad * kvLd);
  float* const ls = ms + lq_pad;
  float* const rs = ls + lq_pad;
  unsigned char* const regions = reinterpret_cast<unsigned char*>(rs + lq_pad);

  const int seq = blockIdx.x, h = blockIdx.y, k0 = blockIdx.z * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kTiles = bwd_tile_bytes<D>() > 16 * oLd * 4
                             ? bwd_tile_bytes<D>()
                             : 16 * oLd * 4;
  unsigned char* const region = regions + warp * bwd_kv_region_bytes<D>();
  bf16* const Kw = reinterpret_cast<bf16*>(region);
  bf16* const Vw = Kw + 16 * kvLd;
  float* const Ow = reinterpret_cast<float*>(region);
  float* const St = reinterpret_cast<float*>(region + kTiles);
  float* const Dt = St + 16 * kSLd;
  bf16* const At = reinterpret_cast<bf16*>(Dt + 16 * kSLd);
  bf16* const Gt = At + 16 * kPLd;

  stage_rows<D>(Qs, args.q + seq * args.q_seq + h * D, args.q_row, 0, lq_pad,
                lq, threadIdx.x, kThreads);
  stage_rows<D>(dOs, args.dout + seq * args.do_seq + h * D, args.do_row, 0,
                lq_pad, lq, threadIdx.x, kThreads);
  {
    const size_t plane = (size_t)args.n_seq * args.n_heads * lq;
    const size_t at = ((size_t)seq * args.n_heads + h) * lq;
    for (int i = threadIdx.x; i < lq_pad; i += kThreads) {
      const bool ok = i < lq;
      ms[i] = ok ? args.stats[at + i] : 0.f;
      ls[i] = ok ? args.stats[plane + at + i] : 1.f;
      rs[i] = ok ? args.stats[2 * plane + at + i] : 0.f;
    }
  }
  const int kw0 = k0 + warp * 16;
  stage_rows<D>(Kw, args.k + seq * args.kv_seq + h * D, args.kv_row, kw0, 16,
                lk, lane, 32);
  stage_rows<D>(Vw, args.v + seq * args.kv_seq + h * D, args.kv_row, kw0, 16,
                lk, lane, 32);
  __syncthreads();
  if (kw0 >= lk) return;  // no block-wide barrier follows

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> kf[D / 16],
      vf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], Kw + kk * 16, kvLd);
    wmma::load_matrix_sync(vf[kk], Vw + kk * 16, kvLd);
  }
  __syncwarp();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[D / 16], dv[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
    wmma::fill_fragment(dk[dj], 0.f);
    wmma::fill_fragment(dv[dj], 0.f);
  }

  // Lanes 2r and 2r+1 own key row r of a tile, 8 query columns each.
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const int key = kw0 + r;
  const float sl2e = args.scale_log2e;
  DropSite hsite = args.site;
  if constexpr (kDrop) hsite.key = nylon::head_key(args.seed_mix, args.tag_base, h);
  for (int i0 = 0; i0 < lq_pad; i0 += 16) {
    row_dot_tile<D>(St, kf, Qs + i0 * kvLd, kvLd);
    row_dot_tile<D>(Dt, vf, dOs + i0 * kvLd, kvLd);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int qi = i0 + c0 + e;
      float ad = 0.f, ds = 0.f;
      if (qi < lq && key < lk) {
        const float a = exp2f(St[r * kSLd + c0 + e] * sl2e - ms[qi]) / ls[qi];
        float mk = 1.f;
        if constexpr (kDrop)
          mk = keep_value(hsite, (uint32_t)seq * (uint32_t)lq + (uint32_t)qi,
                          key, lk);
        ad = a * mk;
        ds = a * (Dt[r * kSLd + c0 + e] * mk - rs[qi]);
      }
      At[r * kPLd + c0 + e] = __float2bfloat16(ad);
      Gt[r * kPLd + c0 + e] = __float2bfloat16(ds);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af, gf;
    wmma::load_matrix_sync(af, At, kPLd);
    wmma::load_matrix_sync(gf, Gt, kPLd);
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> of, qf;
      wmma::load_matrix_sync(of, dOs + i0 * kvLd + dj * 16, kvLd);
      wmma::load_matrix_sync(qf, Qs + i0 * kvLd + dj * 16, kvLd);
      wmma::mma_sync(dv[dj], af, of, dv[dj]);
      wmma::mma_sync(dk[dj], gf, qf, dk[dj]);
    }
    __syncwarp();
  }

  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj)
      wmma::store_matrix_sync(Ow + dj * 16, which ? dv[dj] : dk[dj], oLd,
                              wmma::mem_row_major);
    __syncwarp();
    bf16* const dst = (which ? args.dv : args.dk) + seq * args.dkv_seq + h * D;
    const float mul = which ? 1.f : args.scale;
    for (int rr = 0; rr < 16; ++rr) {
      const int gk = kw0 + rr;
      if (gk >= lk) break;  // warp-uniform
      for (int c = lane; c < D; c += 32)
        dst[gk * args.dkv_row + c] = __float2bfloat16(Ow[rr * oLd + c] * mul);
    }
    __syncwarp();
  }
}

template <bool kDrop>
int launch_attn_bwd(const AttnBwdArgs& args, cudaStream_t stream) {
  const int lk_pad = (args.lk + 15) & ~15;
  const int lq_pad = (args.lq + 15) & ~15;
  const size_t smem_a = (size_t)2 * lk_pad * (64 + 8) * sizeof(bf16) +
                        (size_t)(kThreads / 32) * bwd_q_region_bytes<64>();
  const size_t smem_b = bwd_kv_smem_bytes<64>(lq_pad);
  const size_t max_a = (size_t)2 * kMaxL * (64 + 8) * sizeof(bf16) +
                       (size_t)(kThreads / 32) * bwd_q_region_bytes<64>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<64, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_dkv_kernel<64, kDrop>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bwd_kv_smem_bytes<64>(kMaxL));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_a(args.n_seq, args.n_heads,
                    (args.lq + kAttnRows - 1) / kAttnRows);
  attn_bwd_dq_kernel<64, kDrop><<<grid_a, kThreads, smem_a, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_b(args.n_seq, args.n_heads,
                    (args.lk + kAttnRows - 1) / kAttnRows);
  attn_bwd_dkv_kernel<64, kDrop><<<grid_b, kThreads, smem_b, stream>>>(args);
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
  if (M <= 0 || N <= 0 || N % 32 || N > kLnMaxN || rows_per_block <= 0 ||
      (long long)rows_per_block * n_blocks < M || (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  if (active)
    ln_bwd_kernel<true><<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const bf16*)dy, (const bf16*)s, (const float*)gamma, (bf16*)da,
        (bf16*)dam, (float*)dg_part, (float*)db_part, M, N, rows_per_block,
        eps, site);
  else
    ln_bwd_kernel<false><<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const bf16*)dy, (const bf16*)s, (const float*)gamma, (bf16*)da,
        nullptr, (float*)dg_part, (float*)db_part, M, N, rows_per_block, eps,
        site);
  return (int)cudaGetLastError();
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
  const Epilogue ep{(const bf16*)gate, (const bf16*)addend,
                    DropSite{key1, thresh1, scale1, half1, 0u},
                    DropSite{key2, thresh2, scale2, half2, 0u}, act1, act2};
  const int n_tiles_k = (Kout + kNtBN - 1) / kNtBN;
  const long long tiles = (long long)n_tiles_k * ((M + kNtBM - 1) / kNtBM);
  gemm_nt_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)dy, (const bf16*)w, (bf16*)out, M, N, Kout, n_tiles_k, ep);
  return (int)cudaGetLastError();
}

// part[chunks, Ka, N] and bias_part[chunks, N] for dW = a^T dy, a [M, Ka],
// dy [M, N], rows split into chunks of rows_per_chunk (a multiple of 32).
int nylon_wgrad(const void* a, const void* dy, void* part, void* bias_part,
                int M, int Ka, int N, int rows_per_chunk, int chunks,
                void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % kWgBK || N % kWgBN ||
      rows_per_chunk <= 0 || rows_per_chunk % kWgRows || chunks <= 0 ||
      chunks > 65535 || (long long)rows_per_chunk * chunks < M)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kWgBN, Ka / kWgBK, chunks);
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

// Attention backward of n_seq sequences on strided head-interleaved views
// (row strides in elements, sequence stride = rows x row stride): dq [*, H*D]
// and dk/dv sharing dkv_row; stats is f32 scratch [3, n_seq, H, lq]. With
// active, head h's probabilities carry the keep mask of tag (tag_base + 8) *
// 64 + h.
int nylon_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        void* stats, int n_seq, int lq, int lk, int n_heads,
                        int head_dim, long long q_row, long long kv_row,
                        long long do_row, long long dq_row, long long dkv_row,
                        float scale, float scale_log2e, int active,
                        unsigned seed_mix, int tag_base, unsigned thresh,
                        float pscale, int half, void* stream) {
  if (head_dim != 64 || n_seq <= 0 || lq <= 0 || lk <= 0 || lq > kMaxL ||
      lk > kMaxL || n_heads <= 0 || n_heads > 65535 ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  AttnBwdArgs args{};
  args.q = (const bf16*)q;
  args.k = (const bf16*)k;
  args.v = (const bf16*)v;
  args.dout = (const bf16*)dout;
  args.dq = (bf16*)dq;
  args.dk = (bf16*)dk;
  args.dv = (bf16*)dv;
  args.stats = (float*)stats;
  args.n_seq = n_seq;
  args.n_heads = n_heads;
  args.lq = lq;
  args.lk = lk;
  args.q_row = q_row;
  args.q_seq = q_row * lq;
  args.kv_row = kv_row;
  args.kv_seq = kv_row * lk;
  args.do_row = do_row;
  args.do_seq = do_row * lq;
  args.dq_row = dq_row;
  args.dq_seq = dq_row * lq;
  args.dkv_row = dkv_row;
  args.dkv_seq = dkv_row * lk;
  args.scale = scale;
  args.scale_log2e = scale_log2e;
  args.seed_mix = seed_mix;
  args.tag_base = tag_base;
  args.site = DropSite{0u, thresh, pscale, half, 0u};
  return active ? launch_attn_bwd<true>(args, (cudaStream_t)stream)
                : launch_attn_bwd<false>(args, (cudaStream_t)stream);
}

}  // extern "C"
