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
//  * attention_kernel: one block per (sequence, head, 128-query tile). K and V
//    of the whole sequence (L <= 256, D = 64) sit in shared memory, so the
//    softmax is exact (row max first), with no online-softmax rescaling;
//  * gemm_res_ln_kernel: out = LN(res + (bf16(A @ W) + bias)), a GEMM whose
//    block owns full 256-wide rows so the shared post-LayerNorm runs in its
//    epilogue (O projection, FFN down).
//
// The intermediates (QKV, attention output, FFN hidden) go to device memory
// in this version; fusing them back into fewer passes is later work.
//
// Numerics follow the reference exactly where it pins them: f32 accumulation,
// cast to bf16 BEFORE the bias add, bias and residual added in bf16, f32
// two-pass LayerNorm statistics (eps from the caller), exp2 softmax with the
// 1/l normalisation deferred to the f32 output, l summed from the unrounded
// f32 probabilities, probabilities rounded to bf16 for the PV product.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using nylon::bf16;
using nylon::bf16_round;

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
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bias_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     int M, int N, int K, int relu, int n_tiles_n) {
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
        for (int e = 0; e < 8; ++e) {
          float y = bf16_round(bf16_round(stage[r * 16 + c8 + e]) +
                               __bfloat162float(bb[e]));
          if (relu) y = fmaxf(y, 0.f);
          o[e] = __float2bfloat16(y);
        }
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
__global__ void __launch_bounds__(kThreads)
    gemm_res_ln_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ res,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, bf16* __restrict__ out,
                       int M, int N, int K, float eps) {
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
        const float y = bf16_round(bf16_round(C[r * kLnCLd + c]) +
                                   __bfloat162float(bias[c]));
        s[t] = bf16_round(__bfloat162float(res[(size_t)gr * N + c]) + y);
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
#pragma unroll
    for (int t = 0; t < kLnBN / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < N)
        out[(size_t)gr * N + c] =
            __float2bfloat16((s[t] - mean) * rstd * gamma[c] + beta[c]);
    }
  }
}

// -------------------------------------------------------------- attention ----

constexpr int kAttnRows = 128;  // queries per block: 16 per warp
constexpr int kMaxLk = 256;
constexpr int kSLd = 16 + 4;    // f32 row of a staged 16 x 16 score tile
constexpr int kPLd = 16 + 8;    // bf16 row of a 16 x 16 probability tile

// Per-warp shared-memory region, reused phase by phase: the warp's Q tile
// [16][D+8] bf16; then one score tile [16][kSLd] f32 followed by one
// probability tile [16][kPLd] bf16; then the output [16][D+4] f32.
template <int D>
__host__ __device__ constexpr int attn_region_floats() {
  constexpr int q = 16 * (D + 8) / 2;
  constexpr int sp = 16 * kSLd + 16 * kPLd / 2;
  constexpr int o = 16 * (D + 4);
  return q > sp ? (q > o ? q : o) : (sp > o ? sp : o);
}

template <int D>
__host__ __device__ constexpr size_t attn_smem_bytes(int lk_pad) {
  return (size_t)2 * lk_pad * (D + 8) * sizeof(bf16) +
         (size_t)(kThreads / 32) * attn_region_floats<D>() * sizeof(float);
}

// o[seq, q, h*D:(h+1)*D] = softmax(q_h k_h^T * scale) v_h for one
// (sequence, head, query tile). q/k/v are strided views (row and sequence
// strides in elements) so packed QKV and K/V projections are read in place.
//
// K and V of the whole sequence sit in shared memory; each warp owns 16
// query rows and walks the keys in 16-key tiles twice: first for the exact
// row max of the scaled scores, then recomputing each score tile (the same
// MMAs, so the same values) to take p = exp2(s - max), sum l from the
// unrounded f32 p, and accumulate bf16(p) V. Staging one score tile instead
// of a whole [16, Lk] row block keeps a block at ~106 KB, so two blocks
// share an SM.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int lq,
                     int lk, long long q_row, long long q_seq,
                     long long kv_row, long long kv_seq, int o_row,
                     float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kvLd = D + 8;
  constexpr int oLd = D + 4;
  constexpr int region = attn_region_floats<D>();
  const int lk_pad = (lk + 15) & ~15;
  bf16* const Ks = reinterpret_cast<bf16*>(smem);
  bf16* const Vs = Ks + lk_pad * kvLd;
  float* const regions = reinterpret_cast<float*>(Vs + lk_pad * kvLd);

  const int seq = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // K and V of the whole sequence, zero rows past lk.
  const bf16* kb = k + seq * kv_seq + h * D;
  const bf16* vb = v + seq * kv_seq + h * D;
  for (int c = threadIdx.x; c < lk_pad * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    uint4 kv = zero, vv = zero;
    if (r < lk) {
      kv = *reinterpret_cast<const uint4*>(kb + r * kv_row + c8);
      vv = *reinterpret_cast<const uint4*>(vb + r * kv_row + c8);
    }
    *reinterpret_cast<uint4*>(Ks + r * kvLd + c8) = kv;
    *reinterpret_cast<uint4*>(Vs + r * kvLd + c8) = vv;
  }
  // Each warp's 16 query rows go to the head of its own region.
  const bf16* qb = q + seq * q_seq + h * D;
  for (int c = threadIdx.x; c < kAttnRows * (D / 8); c += kThreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    const int gq = q0 + r;
    uint4 qv = zero;
    if (gq < lq) qv = *reinterpret_cast<const uint4*>(qb + gq * q_row + c8);
    bf16* qw = reinterpret_cast<bf16*>(regions + (r / 16) * region);
    *reinterpret_cast<uint4*>(qw + (r % 16) * kvLd + c8) = qv;
  }
  __syncthreads();
  // From here on every warp works alone: no block-wide barrier follows.
  if (q0 + warp * 16 >= lq) return;

  float* const Sw = regions + warp * region;                 // score tile
  bf16* const Pw = reinterpret_cast<bf16*>(Sw + 16 * kSLd);   // prob. tile
  float* const Ow = Sw;                                      // output

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], reinterpret_cast<const bf16*>(Sw) + kk * 16,
                           kvLd);
  __syncwarp();

  // Stage the f32 score tile S[:, j0 : j0 + 16] = Q K^T in Sw.
  auto score_tile = [&](int j0) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
    wmma::fill_fragment(sacc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, Ks + j0 * kvLd + kk * 16, kvLd);
      wmma::mma_sync(sacc, qf[kk], kf, sacc);
    }
    wmma::store_matrix_sync(Sw, sacc, kSLd, wmma::mem_row_major);
    __syncwarp();
  };

  // Lanes 2r and 2r+1 own row r of a tile, 8 columns each.
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const float neg_inf = __int_as_float(0xff800000u);

  // Pass 1: the exact row max of the scaled scores.
  float m = neg_inf;
  for (int j0 = 0; j0 < lk_pad; j0 += 16) {
    score_tile(j0);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (j0 + c0 + e < lk) m = fmaxf(m, Sw[r * kSLd + c0 + e] * scale_log2e);
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // Pass 2: p = exp2(s - m) (0 past lk), l += p in f32, O += bf16(p) V.
  float l = 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(oacc[dj], 0.f);
  for (int j0 = 0; j0 < lk_pad; j0 += 16) {
    score_tile(j0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float p = 0.f;
      if (j0 + c0 + e < lk) p = exp2f(Sw[r * kSLd + c0 + e] * scale_log2e - m);
      l += p;
      Pw[r * kPLd + c0 + e] = __float2bfloat16(p);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
    wmma::load_matrix_sync(pf, Pw, kPLd);
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, Vs + j0 * kvLd + dj * 16, kvLd);
      wmma::mma_sync(oacc[dj], pf, vf, oacc[dj]);
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(Ow + dj * 16, oacc[dj], oLd, wmma::mem_row_major);
  __syncwarp();

  bf16* ob = o + ((long long)seq * lq) * o_row + h * D;
  for (int rr = 0; rr < 16; ++rr) {
    const float lr = __shfl_sync(0xffffffffu, l, 2 * rr);
    const int gq = q0 + warp * 16 + rr;
    if (gq >= lq) break;  // warp-uniform
    for (int c = lane; c < D; c += 32)
      ob[(long long)gq * o_row + c] = __float2bfloat16(Ow[rr * oLd + c] / lr);
  }
}

}  // namespace

extern "C" {

int nylon_gemm_bias(const void* a, const void* w, const void* bias, void* out,
                    int M, int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8)
    return (int)cudaErrorInvalidValue;
  const int n_tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const long long tiles = (long long)n_tiles_n * ((M + kGemmBM - 1) / kGemmBM);
  gemm_bias_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (bf16*)out, M, N, K,
      relu, n_tiles_n);
  return (int)cudaGetLastError();
}

int nylon_gemm_res_ln(const void* a, const void* w, const void* bias,
                      const void* res, const void* gamma, const void* beta,
                      void* out, int M, int N, int K, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || N > kLnBN)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_res_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLnSmem);
  if (e != cudaSuccess) return (int)e;
  gemm_res_ln_kernel<<<(M + kLnBM - 1) / kLnBM, kThreads, kLnSmem,
                       (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (const bf16*)res,
      (const float*)gamma, (const float*)beta, (bf16*)out, M, N, K, eps);
  return (int)cudaGetLastError();
}

int nylon_attention(const void* q, const void* k, const void* v, void* o,
                    int n_seq, int lq, int lk, int n_heads, int head_dim,
                    long long q_row, long long q_seq, long long kv_row,
                    long long kv_seq, float scale_log2e, void* stream) {
  if (head_dim != 64 || n_seq <= 0 || lq <= 0 || lk <= 0 || lk > kMaxLk ||
      n_heads <= 0 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_smem_bytes<64>(kMaxLk));
  if (e != cudaSuccess) return (int)e;
  const int lk_pad = (lk + 15) & ~15;
  const dim3 grid(n_seq, n_heads, (lq + kAttnRows - 1) / kAttnRows);
  attention_kernel<64><<<grid, kThreads, attn_smem_bytes<64>(lk_pad),
                         (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lq, lk, q_row,
      q_seq, kv_row, kv_seq, n_heads * head_dim, scale_log2e);
  return (int)cudaGetLastError();
}

const char* nylon_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
