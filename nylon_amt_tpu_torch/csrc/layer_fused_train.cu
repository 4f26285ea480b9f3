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
//  * gemm_nt_kernel: dX = dY @ W^T (the TPU kernel's dot_general of dY and
//    W over W's second axis) with the epilogues of the analytic backward
//    (bf16 cast, dropout mask, ReLU gate, + residual gradient, embedding
//    mask);
//  * the attention backward of mha.cu (nylon_attention_bwd), with the
//    layer's per-head probability masks;
//  * wgrad_kernel: dW = A^T @ dY (the dot_general over the rows) over a
//    chunk of rows into f32 per-chunk partials, with the bias gradient's
//    column sums, and reduce_rows_kernel summing the partials in a fixed
//    order. No float atomics: a weight gradient is the same bits from run
//    to run.
//
// What bounds the two GEMMs: at the paper widths (hid 256, pf 512, 90,112-
// 262,144 rows a step) each moves its operands once for 85-192 FLOP a byte,
// under the H100's ~295 FLOP/B ridge: device-memory bytes. So they run on
// the wgmma + TMA mainloop of gemm_sm90.cuh, which keeps HBM streaming: a
// ring of 3-4 stages 64 deep, one producer warp, two consumer warpgroups
// decoupled by mbarriers. gemm_nt reads W K-major (W [Kout, N] row-major is
// B^T) and is persistent over 128 x BN output tiles with the epilogue of
// layer_epilogue.cuh packed in bf16x2 and its side input (ReLU gate or
// addend) loaded by TMA under the mainloop. wgrad reads both operands MN-
// major (A^T and dY in their row-major [rows, *] layout); its output has
// only 4-12 tiles of 128 x 128 at the paper widths, so its grid is tiles x
// row chunks, one wave of one block an SM, and the ~20 MB of partials cost
// a few microseconds to write and reduce. The forward recompute moves the
// layer's intermediates through device memory (~2 GB per frequency-encoder
// layer at batch 8); fusing it is later work.
//
// Numerics follow the TPU kernel's analytic backward cast for cast: every
// product accumulates in f32, each gradient is rounded to bf16 where the
// JAX code casts (.astype(dt)), weight gradients stay f32, dq/dk are scaled
// in f32 before their cast. The dX epilogue is layer_epilogue.cuh's.
//
// Float32 compute dtype: ln_bwd_kernel is instantiated for f32 rows
// (nylon_ln_bwd_f32); the dX and dW GEMMs have f32 twins in
// layer_fused_f32.cu (3xTF32 on wgmma), whose partials
// this file's reduce_rows sums in the same fixed order.

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hash_mask.cuh"
#include "layer_epilogue.cuh"

using nylon::bf16;
using nylon::DropSite;
using nylon::keep_value;
using nylon::NtEpilogue;
namespace sm = nylon::sm90;
using sm::bf16x2;
using sm::bits;
using sm::Frag;
using sm::store_tile;

namespace {

constexpr int kThreads = 256;  // ln_bwd_kernel and reduce_rows_kernel

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

// gemm_nt's epilogue area: the 128 x BN tile of the side input (the gate or
// the addend), overwritten in place by the outputs.
template <int BN>
constexpr int kNtEpiBytes = sm::kBM * BN * 2;

// out[M, Kout] = epilogue(bf16(dy[M, N] @ w^T)), w [Kout, N] row-major: dy
// is A (K-major), w is B K-major (its rows are the output columns), on the
// mainloop of gemm_sm90.cuh. Tile t is (row block t / n_tiles_n, column
// block t % n_tiles_n); blocks are persistent. With a side input (ep.gate
// or ep.addend, at most one: map_side) the producer loads the tile's side
// values by TMA into the epilogue tile while the mainloop runs, as
// gemm_res_ln_kernel (layer_fused.cu) loads its residual; each warpgroup
// reads its half, overwrites it with the outputs, stores them by TMA and
// releases the tile once the stores have read it. nt_epilogue2 is the
// element math (layer_epilogue.cuh); of the two dropout sites at most one
// is on (every call of the backward has at most one), and each thread draws
// its keep bits of a 64-column box in a rolled loop before the box's
// unrolled element math.
template <int BN>
__global__ void __launch_bounds__(sm::kThreads, 1)
    gemm_nt_kernel(const __grid_constant__ CUtensorMap map_dy,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_side,
                   const __grid_constant__ CUtensorMap map_out, int M, int N,
                   int Kout, int n_tiles_n, NtEpilogue ep, DropSite site) {
  extern __shared__ uint8_t smem_raw[];
  sm::Ring<BN, kNtEpiBytes<BN>, 0, 0> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(2);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (N + sm::kBK - 1) / sm::kBK;
  const long long tiles =
      (long long)n_tiles_n * ((M + sm::kBM - 1) / sm::kBM);
  const bool side = ep.gate != nullptr || ep.addend != nullptr;
  uint32_t epi_phase = 0;

  if (warp == sm::kConsumerWarps) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      sm::tma_prefetch(&map_dy);
      sm::tma_prefetch(&map_w);
      if (side) sm::tma_prefetch(&map_side);
      const int side_after = (nk < ring.kStages ? nk : ring.kStages) - 1;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (int)(t / n_tiles_n) * sm::kBM;
        const int n0 = (int)(t % n_tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          ring.load(&map_dy, &map_w, m0, n0, kb);
          if (kb != side_after) continue;
          sm::mbar_wait(ring.epi_empty(), epi_phase ^ 1);
          if (side) {
            sm::mbar_expect_tx(ring.epi_full(), sm::kBM * BN * 2);
#pragma unroll
            for (int g = 0; g < 2; ++g)
#pragma unroll
              for (int c = 0; c < BN / 64; ++c)
                sm::tma_load(ring.epi(g * (BN / 64) + c), &map_side,
                             ring.epi_full(), n0 + 64 * c, m0 + 64 * g);
          } else {
            sm::mbar_arrive(ring.epi_full());
          }
          epi_phase ^= 1;
        }
      }
    }
    return;
  }

  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ebase = sm::smem_u32(ring.epi(g * (BN / 64)));
  // site: the one dropout site that is on (m1 or m2); its keep value in
  // both halves
  const bool masked = ep.act1 || ep.act2;
  const __nv_bfloat162 keep = __float2bfloat162_rn(site.scale);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  float acc[BN / 2];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (int)(t / n_tiles_n) * sm::kBM;
    const int n0 = (int)(t % n_tiles_n) * BN;
    const int row0 = m0 + 64 * g;
    ring.mma(acc, nk, g);
    sm::mbar_wait(ring.epi_full(), epi_phase);
    epi_phase ^= 1;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      // the site's keep bits of this 64-column box: bit 2 jj + e of word i
      // is column 8 (8 c + jj) + 2 q + e of row r0 + 8 i, drawn in a rolled
      // loop (unrolled with the element math, the hashes made the kernel
      // too long for the instruction cache)
      uint32_t kbits[2] = {0u, 0u};
      if (masked) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t row = (uint32_t)(row0 + f.r0 + 8 * i);
#pragma unroll 1
          for (int b = 0; b < 16; ++b)
            kbits[i] |= (uint32_t)nylon::keeps(
                            site, row, n0 + 64 * c + 8 * (b >> 1) + 2 * f.q +
                                           (b & 1), Kout)
                        << b;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t at = f.addr(ebase + c * sm::kBoxBytes, i, j);
          const __nv_bfloat162 s = side ? bf16x2(sm::ld_shared(at)) : zero;
          const __nv_bfloat162 k = __halves2bfloat162(
              (kbits[i] >> (2 * jj)) & 1 ? keep.x : zero.x,
              (kbits[i] >> (2 * jj + 1)) & 1 ? keep.y : zero.y);
          sm::st_shared(at, bits(nylon::nt_epilogue2(
                                acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1],
                                ep, s, k)));
        }
      }
    }
    sm::fence_async_smem();
    sm::named_sync(1 + g, 128);
    if (tid == 0) {
      store_tile<BN>(&map_out, ebase, n0, row0, Kout, M);
      sm::bulk_wait_read();
      sm::mbar_arrive(ring.epi_empty());
    }
  }
  if (tid == 0) sm::bulk_wait();
}

// ------------------------------------------------------------ dW = A^T dY --

// wgrad's epilogue area: the column sums of dy of each part of the block's
// 256 consumer threads (256 / (BN / 2) parts of BN columns).
template <int BN>
constexpr int kWgEpiBytes = 2048;
// wgrad's dW tile width, and the k-blocks (of kBK rows) that one wgmma
// accumulator sums before the f32 sum takes it: the tensor core's f32
// accumulation rounds less finely than an FADD, and its error grows with
// the length of the chain (a chunk of 8,000 rows read 10x the error of an
// f32 cuBLAS product from a float64 truth on an NVIDIA H100), so each chain
// is kWgFlush k-blocks long and the chains add in f32, in order. The second
// accumulator is why the tile is 128 columns wide.
constexpr int kWgBN = 128;
constexpr int kWgFlush = 4;

// part[chunk][Ka, N] = a[rows, Ka]^T @ dy[rows, N] over the chunk's rows
// (rows_per_chunk of them, a multiple of kBK, so that no box straddles two
// chunks; TMA zero-fills the rows past M), on the mainloop of
// gemm_sm90.cuh with Ka as the wgmma M dimension: A^T is MN-major (one box
// of 64 Ka-columns x 64 rows a warpgroup), dy is B MN-major (the forward's
// W layout). Block (t, chunk) owns the dW tile t of 128 x BN (Ka rows
// past Ka, a multiple of 8, read TMA's zeros and are not stored) and writes
// its f32 partial straight from the registers. The column sums of dy over
// the chunk are shared by the KT = ceil(Ka / 128) blocks of the tile's
// column range: the block of Ka tile kt sums the rows r = kt (mod KT) of
// each dy stage, each of its consumer threads one column pair in one of
// 256 / (BN / 2) parts of those rows, in row order, while the stage's
// wgmmas run; bias_part[chunk * KT + kt][N] is the parts' sums added in
// order. (Only the first Ka tile's blocks summing every row read 40% slower
// on an NVIDIA H100: they held each stage past the others.)
template <int BN>
__global__ void __launch_bounds__(sm::kThreads, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_dy,
                 float* __restrict__ part, float* __restrict__ bias_part,
                 int M, int Ka, int N, int rows_per_chunk, int n_tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  sm::Ring<BN, kWgEpiBytes<BN>, 1, 1> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(1);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int k0 = (blockIdx.x / n_tiles_n) * sm::kBM;
  const int n0 = (blockIdx.x % n_tiles_n) * BN;
  const int chunk = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  const int nk = (r1 - r0 + sm::kBK - 1) / sm::kBK;

  if (warp == sm::kConsumerWarps) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_dy);
      for (int kb = 0; kb < nk; ++kb)
        ring.load(&map_a, &map_dy, k0, n0, kb, r0);
    }
    return;
  }

  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  // column pair `pair` of the tile (16-byte chunk (pair % 32) / 4 of box
  // pair / 32 in each dy row), rows first, first + step, ... of each stage
  constexpr int kParts = 256 / (BN / 2);
  const int kt = k0 / sm::kBM, n_kt = (Ka + sm::kBM - 1) / sm::kBM;
  const int pair = threadIdx.x % (BN / 2), part_of = threadIdx.x / (BN / 2);
  const uint32_t pair_at = (pair >> 5) * sm::kBoxBytes + 4 * (pair & 3);
  const int pair_chunk = (pair & 31) >> 2;
  const int first = kt + n_kt * part_of, step = n_kt * kParts;
  float b0 = 0.f, b1 = 0.f;
  const auto bias_sums = [&](uint32_t sb) {
#pragma unroll 4
    for (int r = first; r < sm::kBK; r += step) {
      const float2 v = __bfloat1622float2(
          bf16x2(sm::ld_shared(sb + pair_at + sm::sw128(r, pair_chunk))));
      b0 += v.x;
      b1 += v.y;
    }
  };
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  for (int kb = 0; kb < nk; kb += kWgFlush) {
    ring.mma(acc, min(kWgFlush, nk - kb), g, bias_sums);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
  }

  float* const dst = part + (size_t)chunk * Ka * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * f.q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + 64 * g + f.r0 + 8 * i;
      if (row < Ka && col < N)
        *reinterpret_cast<float2*>(dst + (size_t)row * N + col) =
            make_float2(sum[4 * j + 2 * i], sum[4 * j + 2 * i + 1]);
    }
  }
  float* const sums = reinterpret_cast<float*>(ring.epi(0));
  *reinterpret_cast<float2*>(sums + part_of * BN + 2 * pair) =
      make_float2(b0, b1);
  sm::named_sync(1, 256);
  for (int c = threadIdx.x; c < BN; c += 256) {
    if (n0 + c >= N) continue;
    float t = sums[c];
#pragma unroll
    for (int h = 1; h < kParts; ++h) t += sums[h * BN + c];
    bias_part[((size_t)chunk * n_kt + kt) * N + n0 + c] = t;
  }
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

template <int BN>
int launch_gemm_nt(const void* dy, const void* w, void* out, int M, int N,
                   int Kout, const NtEpilogue& ep, cudaStream_t stream) {
  const void* side = ep.gate != nullptr ? ep.gate : ep.addend;
  CUtensorMap md, mw, ms = {}, mo;
  int e = sm::encode_bf16(&md, dy, M, N, sm::kBM);
  if (!e) e = sm::encode_bf16(&mw, w, Kout, N, BN);
  if (!e && side != nullptr) e = sm::encode_bf16(&ms, side, M, Kout, 64);
  if (!e) e = sm::encode_bf16(&mo, out, M, Kout, 64);
  const int n_tiles_n = (Kout + BN - 1) / BN;
  const long long tiles =
      (long long)n_tiles_n * ((M + sm::kBM - 1) / sm::kBM);
  const auto kernel = gemm_nt_kernel<BN>;
  constexpr int smem = sm::Ring<BN, kNtEpiBytes<BN>, 0, 0>::kBytes;
  int grid = 0;
  if (!e) e = sm::persistent_grid(kernel, smem, tiles, &grid);
  if (e) return e;
  kernel<<<grid, sm::kThreads, smem, stream>>>(
      md, mw, ms, mo, M, N, Kout, n_tiles_n, ep, ep.act1 ? ep.m1 : ep.m2);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgrad(const void* a, const void* dy, void* part, void* bias_part,
                 int M, int Ka, int N, int rows_per_chunk, int chunks,
                 cudaStream_t stream) {
  CUtensorMap ma, md;
  int e = sm::encode_bf16(&ma, a, M, Ka, 64);
  if (!e) e = sm::encode_bf16(&md, dy, M, N, 64);
  const int n_tiles_n = (N + BN - 1) / BN;
  const int tiles = n_tiles_n * ((Ka + sm::kBM - 1) / sm::kBM);
  const auto kernel = wgrad_kernel<BN>;
  constexpr int smem = sm::Ring<BN, kWgEpiBytes<BN>, 1, 1>::kBytes;
  if (!e)
    e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  kernel<<<dim3(tiles, chunks), sm::kThreads, smem, stream>>>(
      ma, md, (float*)part, (float*)bias_part, M, Ka, N, rows_per_chunk,
      n_tiles_n);
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
// may be null, not both set; act1/act2 switch the two dropout sites, not
// both on. N and Kout multiples of 8 (TMA: 16-byte rows), every pointer
// 16-byte aligned.
int nylon_gemm_nt(const void* dy, const void* w, void* out, const void* gate,
                  const void* addend, int M, int N, int Kout, int act1,
                  unsigned key1, unsigned thresh1, float scale1, int half1,
                  int act2, unsigned key2, unsigned thresh2, float scale2,
                  int half2, void* stream) {
  if (M <= 0 || N <= 0 || Kout <= 0 || N % 8 || Kout % 8 ||
      (gate != nullptr && addend != nullptr) || (act1 && act2) ||
      (half1 && 2 * half1 != Kout) || (half2 && 2 * half2 != Kout))
    return (int)cudaErrorInvalidValue;
  const NtEpilogue ep{gate, addend, DropSite{key1, thresh1, scale1, half1, 0u},
                      DropSite{key2, thresh2, scale2, half2, 0u}, act1, act2};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (sm::tile_width(Kout)) {
    case 64:
      return launch_gemm_nt<64>(dy, w, out, M, N, Kout, ep, s);
    case 128:
      return launch_gemm_nt<128>(dy, w, out, M, N, Kout, ep, s);
    case 192:
      return launch_gemm_nt<192>(dy, w, out, M, N, Kout, ep, s);
    default:
      return launch_gemm_nt<256>(dy, w, out, M, N, Kout, ep, s);
  }
}

// part[chunks, Ka, N] and bias_part[chunks * ceil(Ka / 128), N] for dW =
// a^T dy (and dy's column sums), a [M, Ka], dy [M, N], rows split into
// chunks of rows_per_chunk (a multiple of 64), each holding at least one
// row; Ka and N multiples of 8.
int nylon_wgrad(const void* a, const void* dy, void* part, void* bias_part,
                int M, int Ka, int N, int rows_per_chunk, int chunks,
                void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % 8 || N % 8 ||
      rows_per_chunk <= 0 || rows_per_chunk % sm::kBK || chunks <= 0 ||
      chunks > 65535 || (long long)rows_per_chunk * chunks < M ||
      (long long)rows_per_chunk * (chunks - 1) >= M)
    return (int)cudaErrorInvalidValue;
  return launch_wgrad<kWgBN>(a, dy, part, bias_part, M, Ka, N,
                             rows_per_chunk, chunks, (cudaStream_t)stream);
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
