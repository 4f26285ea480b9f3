// Multi-head attention kernels on Hopper (sm_90a).
//
// Replaces the per-site attention kernels of nylon_amt_tpu/ops/attention.py:
// fused_mha (K10: _fwd_kernel, and _bwd_kernel for its custom VJP),
// fused_mha_with_probs (K11: _fwd_kernel with the probabilities written,
// and K10's backward) and fused_mha_dropout (K12: _fwd_dropout_kernel,
// _bwd_dropout_kernel). The layer kernels K3-K5 (layer_fused.cu's GEMMs
// around them) and K7-K9 (with a dropout site, and the backward of
// layer_fused_train.cu) run the same attention step through the same entry
// points; only the keep mask's tag differs (head_tag0 below).
//
// The attention sites of the hFT model are short (256 bins, 88 notes, 128
// frames, head_dim 64) and numerous (one sequence per frame or per note), so
// one block owns one (sequence, head, 128-row tile), K and V (or Q and dO)
// of the whole sequence sit in shared memory, and the softmax is exact: the
// row max first, no online rescaling. Scores and probabilities never reach
// device memory, except the probabilities that K11 returns.
//
// What bounds them: a site does Lq * Lk / (Lq + Lk) FLOP per byte of q, k, v
// and o (128 at 256 x 256, 65 at 88 x 256), under the H100's ~295 FLOP/B
// ridge, so the least time is the bytes'. This version is far from it: it
// recomputes the score tiles in every pass (two in the forward, three with
// the probabilities, four in the backward's query kernel) with `wmma` bf16
// tiles; register-resident softmax, wgmma tiles and fewer passes are later
// work.
//
//  * attention_kernel (forward): each warp owns 16 query rows and walks the
//    keys in 16-key tiles: pass 1 the row max m of the scaled scores, pass 2
//    p = exp2(s - m), l += p (unrounded f32), O += bf16(p [* keep]) V, then
//    O / l; with kProbs a third pass writes the normalised f32 p / l.
//  * attn_bwd_dq_kernel / attn_bwd_dkv_kernel (backward): the first owns
//    query rows (recomputes s, p, l, the mask, row = sum(da * a), ds; writes
//    dq and the row statistics), the second owns key rows (recomputes a and
//    ds from the statistics; dk and dv summed over all queries in one block,
//    so no float atomics and the same bits from run to run).
//
// Numerics follow the TPU kernels: f32 scores times scale * log2(e), exp2,
// l summed from the unrounded p, bf16(p) (times the keep mask under
// dropout) into the PV product, the 1/l normalisation deferred to the f32
// output; the backward casts ds and a (or a * keep) to bf16 before their
// products and scales dq/dk in f32 before the cast.
//
// Dropout (kDrop): head h takes the keep mask of hash_mask.cuh (K6) with tag
// head_tag0 + h, row seq * Lq + query and column key. K12's TPU kernel
// hashes head h with the raw tag h (head_tag0 = 0); K7-K9 use the tag
// (tag_base + 8) * 64 + h (ops/layer_fused_train.py::_head_tag).

#include <mma.h>

#include "common.cuh"
#include "hash_mask.cuh"

using namespace nvcuda;
using nylon::bf16;
using nylon::DropSite;
using nylon::keep_value;

namespace {

constexpr int kThreads = 256;   // 8 warps in every kernel of this file
constexpr int kAttnRows = 128;  // query (or key) rows per block: 16 per warp
constexpr int kMaxL = 256;      // K/V (or Q/dO) of a sequence in shared memory
constexpr int kSLd = 16 + 4;    // f32 row of a staged 16 x 16 tile
constexpr int kPLd = 16 + 8;    // bf16 row of a 16 x 16 tile

// ---------------------------------------------------------------- forward ----

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
//
// kDrop: the probabilities that multiply V are p times the keep mask of
// head h (tag head_tag0 + h, row seq * lq + query, column key); l stays the
// sum of the unmasked p, as in the TPU kernel.
//
// kProbs (fused_mha_with_probs, K11): a third pass recomputes each score
// tile once l is known and writes the normalised f32 probabilities p / l to
// probs[seq, h, query, key] (gridDim.y heads), 32 contiguous bytes per lane.
template <int D, bool kDrop, bool kProbs>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ probs, int lq, int lk,
                     long long q_row, long long q_seq, long long kv_row,
                     long long kv_seq, int o_row, float scale_log2e,
                     uint32_t seed_mix, int head_tag0, DropSite site) {
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

  // Pass 2: p = exp2(s - m) (0 past lk), l += p in f32, O += bf16(p) V
  // (with kDrop, bf16(p * keep) V).
  DropSite hsite = site;
  if constexpr (kDrop) hsite.key = nylon::tag_key(seed_mix, head_tag0 + h);
  const uint32_t mask_row = (uint32_t)seq * (uint32_t)lq +
                            (uint32_t)(q0 + warp * 16 + r);
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
      if constexpr (kDrop) p *= keep_value(hsite, mask_row, j0 + c0 + e, lk);
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

  if constexpr (kProbs) {
    // Pass 3: the normalised probabilities, row r's 8 columns per lane.
    __syncwarp();  // Ow (read above) and Sw share the region
    const int gq = q0 + warp * 16 + r;
    float* pr = probs + (((size_t)seq * gridDim.y + h) * lq + gq) * lk;
    for (int j0 = 0; j0 < lk_pad; j0 += 16) {
      score_tile(j0);
      float pv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        pv[e] = exp2f(Sw[r * kSLd + c0 + e] * scale_log2e - m) / l;
      const int j = j0 + c0;
      if (gq < lq) {
        if (j + 8 <= lk && lk % 4 == 0) {
          *reinterpret_cast<float4*>(pr + j) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
          *reinterpret_cast<float4*>(pr + j + 4) =
              make_float4(pv[4], pv[5], pv[6], pv[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (j + e < lk) pr[j + e] = pv[e];
        }
      }
      __syncwarp();
    }
  }
}

// One attention launch (head_dim 64): (sequence, head, 128-query tile)
// blocks, shared memory sized to the keys.
template <bool kDrop, bool kProbs>
int launch_attention(const void* q, const void* k, const void* v, void* o,
                     void* probs, int n_seq, int lq, int lk, int n_heads,
                     long long q_row, long long q_seq, long long kv_row,
                     long long kv_seq, float scale_log2e, uint32_t seed_mix,
                     int head_tag0, DropSite site, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<64, kDrop, kProbs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_smem_bytes<64>(kMaxL));
  if (e != cudaSuccess) return (int)e;
  const int lk_pad = (lk + 15) & ~15;
  const dim3 grid(n_seq, n_heads, (lq + kAttnRows - 1) / kAttnRows);
  attention_kernel<64, kDrop, kProbs>
      <<<grid, kThreads, attn_smem_bytes<64>(lk_pad), stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
          (float*)probs, lq, lk, q_row, q_seq, kv_row, kv_seq, n_heads * 64,
          scale_log2e, seed_mix, head_tag0, site);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- backward ----

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
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
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
  if constexpr (kDrop) hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
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
  if constexpr (kDrop) hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
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

int nylon_attention(const void* q, const void* k, const void* v, void* o,
                    int n_seq, int lq, int lk, int n_heads, int head_dim,
                    long long q_row, long long q_seq, long long kv_row,
                    long long kv_seq, float scale_log2e, void* stream) {
  if (head_dim != 64 || n_seq <= 0 || lq <= 0 || lk <= 0 || lk > kMaxL ||
      n_heads <= 0 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_attention<false, false>(q, k, v, o, nullptr, n_seq, lq, lk,
                                        n_heads, q_row, q_seq, kv_row, kv_seq,
                                        scale_log2e, 0u, 0, DropSite{},
                                        (cudaStream_t)stream);
}

// nylon_attention that also writes the normalised f32 probabilities
// probs[n_seq, n_heads, lq, lk] (fused_mha_with_probs, K11).
int nylon_attention_probs(const void* q, const void* k, const void* v,
                          void* o, void* probs, int n_seq, int lq, int lk,
                          int n_heads, int head_dim, long long q_row,
                          long long q_seq, long long kv_row, long long kv_seq,
                          float scale_log2e, void* stream) {
  if (head_dim != 64 || n_seq <= 0 || lq <= 0 || lk <= 0 || lk > kMaxL ||
      n_heads <= 0 || n_heads > 65535 || probs == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_attention<false, true>(q, k, v, o, probs, n_seq, lq, lk,
                                       n_heads, q_row, q_seq, kv_row, kv_seq,
                                       scale_log2e, 0u, 0, DropSite{},
                                       (cudaStream_t)stream);
}

// nylon_attention with dropout on the probabilities: head h takes the keep
// mask of tag head_tag0 + h; thresh/scale/half as for any site whose rows
// are lk long.
int nylon_attention_drop(const void* q, const void* k, const void* v, void* o,
                         int n_seq, int lq, int lk, int n_heads, int head_dim,
                         long long q_row, long long q_seq, long long kv_row,
                         long long kv_seq, float scale_log2e,
                         unsigned seed_mix, int head_tag0, unsigned thresh,
                         float scale, int half, void* stream) {
  if (head_dim != 64 || n_seq <= 0 || lq <= 0 || lk <= 0 || lk > kMaxL ||
      n_heads <= 0 || n_heads > 65535 || (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  return launch_attention<true, false>(
      q, k, v, o, nullptr, n_seq, lq, lk, n_heads, q_row, q_seq, kv_row,
      kv_seq, scale_log2e, seed_mix, head_tag0,
      DropSite{0u, thresh, scale, half, 0u}, (cudaStream_t)stream);
}

// Attention backward of n_seq sequences on strided head-interleaved views
// (row strides in elements, sequence stride = rows x row stride): dq [*, H*D]
// and dk/dv sharing dkv_row; stats is f32 scratch [3, n_seq, H, lq]. With
// active, head h's probabilities carry the keep mask of tag head_tag0 + h.
int nylon_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        void* stats, int n_seq, int lq, int lk, int n_heads,
                        int head_dim, long long q_row, long long kv_row,
                        long long do_row, long long dq_row, long long dkv_row,
                        float scale, float scale_log2e, int active,
                        unsigned seed_mix, int head_tag0, unsigned thresh,
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
  args.head_tag0 = head_tag0;
  args.site = DropSite{0u, thresh, pscale, half, 0u};
  return active ? launch_attn_bwd<true>(args, (cudaStream_t)stream)
                : launch_attn_bwd<false>(args, (cudaStream_t)stream);
}

}  // extern "C"
