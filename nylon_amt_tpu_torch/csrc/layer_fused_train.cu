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
//  * ln_bwd_kernel: the LayerNorm backward from TMA-fed row tiles
//    (statistics recomputed from the saved pre-LN sum), the bf16 cast of
//    the input gradient, the dropout mask of the site feeding the residual,
//    and per-block partial sums of dgamma/dbeta (its design note is at the
//    kernel);
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
#include "tma_ring.cuh"

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

constexpr int kThreads = 256;  // reduce_rows_kernel

// ------------------------------------------------------ LayerNorm backward --
//
// ln_bwd_kernel: the LayerNorm backward of the TPU kernels' bodies (JAX's
// _ln_bwd on the statistics of _ln_fwd recomputed from the saved pre-LN
// sum, in _enc_train_bwd_kernel and _dec_train_bwd_kernel /
// _dec_zero_train_bwd_kernel). What bounds it: bytes. Per element it does
// ~20 f32 operations (~35 with a dropout site's hash) on 6 bytes of bf16
// (dy and s read, da written; 8 with dam), some 3-6 operations a byte
// against the card's ~20 f32 FLOP a byte of HBM (67 TFLOP/s over 3.35
// TB/s): a launch at M = 262,144, N = 256 needs 0.12 ms of device memory.
// Its first form (one row per warp, 2-byte loads straight from device
// memory, three dependent warp reductions a row, gamma re-read every row,
// 16 warps an SM) kept few bytes in flight and ran at 23-31% of that
// bound on an NVIDIA H100 (PERF.md). This design keeps HBM streaming:
//
//  * a persistent grid, one or two blocks an SM (kLnBlocks), kLnWarps
//    consumer warps and a producer warp whose lane 0 keeps a ring of row
//    tiles in flight by TMA (a stage: the tile's R rows x N of dy, then of
//    s, through 2-D maps over [M, N]; 15-45 KB a stage, up to kLnRingBytes
//    of shared memory);
//  * rows spread over lanes in 16-byte chunks (8 bf16, 4 f32): kC chunks a
//    lane (chunks j, j + lanes, ..), `lanes` lanes a row, 32 / lanes rows a
//    warp, so no lane idles at N = 64, 96 and 256 (ln_layout), and a tile
//    is one row group a warp. A lane reads its chunks from shared memory
//    16 bytes at a time: once, into registers, releasing the stage before
//    the math, where they fit (up to 8 values a lane: N = 64 and 256 in
//    either dtype); else (N = 96) s four times and dy twice (the
//    statistics' two passes, the sums, the outputs). It reduces each row
//    by xor shuffles over its lanes and stores da (and dam) 16 bytes at a
//    time;
//  * gamma and the lane's dgamma / dbeta sums stay in registers for the
//    whole block, then are summed over the warp's row groups (xor shuffles)
//    and over the warps in warp order into the block's partial row: a fixed
//    order for a fixed grid, so reruns give the same bits;
//  * the keep bits of a chunk are drawn in a rolled loop (hashes unrolled
//    into the element math make a kernel too long for the instruction
//    cache: gemm_nt_kernel).

constexpr int kLnMaxN = 256;
// 15 consumer warps and the producer warp: 4 warps an SM sub-partition, so
// 128 registers a thread (a 17th warp puts 5 on one sub-partition, caps the
// kernel at 96 registers and spills its 3-chunk form)
constexpr int kLnWarps = 15;
constexpr int kLnThreads = (kLnWarps + 1) * 32;
constexpr int kLnMaxStages = 10;
// Blocks an SM: two where a lane holds one chunk (64 registers a thread),
// each with a ring of 96 KB; else one with 160 KB.
template <int kC>
constexpr int kLnBlocks = kC == 1 ? 2 : 1;
template <int kC>
constexpr int kLnRingBytes = kC == 1 ? 96 * 1024 : 160 * 1024;

// The lanes' share of a row of N elements of `elem` bytes: kc 16-byte
// chunks a lane, `lanes` lanes a row (a power of two up to 32) and `rows`
// rows a tile (one row group a warp). The fewest lanes with no lane idle;
// where no kc <= 3 gives that, 32 lanes and the chunks past the row idle.
// ops/layer_fused_train.py::ln_bwd_layout is this function.
struct LnLayout {
  int kc, lanes, rows;
};
inline LnLayout ln_layout(int N, int elem) {
  const int chunks = N * elem / 16;
  for (int kc = 1; kc <= 3; ++kc) {
    const int lanes = chunks / kc;
    if (chunks % kc == 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0)
      return {kc, lanes, kLnWarps * 32 / lanes};
  }
  return {(chunks + 31) / 32, 32, kLnWarps};
}

// 16 bytes of T as f32 values, and f32 values rounded to T into 16 bytes.
template <typename T>
struct Chunk16;

template <>
struct Chunk16<bf16> {
  static constexpr int kE = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(sm::bf16x2(w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 raw;
    raw.x = bits(__floats2bfloat162_rn(v[0], v[1]));
    raw.y = bits(__floats2bfloat162_rn(v[2], v[3]));
    raw.z = bits(__floats2bfloat162_rn(v[4], v[5]));
    raw.w = bits(__floats2bfloat162_rn(v[6], v[7]));
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Chunk16<float> {
  static constexpr int kE = 4;
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[4]) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// The sum of v over the `lanes` lanes (a power of two) of this lane's row.
__device__ __forceinline__ float row_sum(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// For each row of the pre-LN sum s [M, N] and its output gradient dy (both
// contiguous): xhat, inv from s (f32 two-pass, as the forward); dxhat = dy
// * gamma; da = T((dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) *
// inv); with kDrop also dam = T(T(da) * keep) for the dropout site feeding
// the sum. Block b takes the tiles of `rows` rows b, b + gridDim.x, ..;
// dg_part[b] / db_part[b] = its rows' sums of dy * xhat and dy. The ring:
// `stages` stages of stage_bytes from a 1024-byte aligned base, each the
// dy tile, then the s tile from the next multiple of 1024 bytes; full[s]
// completes its u-th phase when the u-th tile of the stage has landed,
// empty[s] when the kLnWarps warps have read it. T: bf16, or f32 (the
// float32 compute dtype, where every cast to T is the identity).
template <typename T, int kC, bool kDrop>
__global__ void __launch_bounds__(kLnThreads, kLnBlocks<kC>)
    ln_bwd_kernel(const __grid_constant__ CUtensorMap map_dy,
                  const __grid_constant__ CUtensorMap map_s,
                  const float* __restrict__ gamma, T* __restrict__ da,
                  T* __restrict__ dam, float* __restrict__ dg_part,
                  float* __restrict__ db_part, int M, int N, int lanes,
                  int rows, int stages, int stage_bytes, float eps,
                  DropSite site) {
  using C16 = Chunk16<T>;
  constexpr int kE = C16::kE;
  // a lane's chunks of a row fit in registers beside gamma and the sums
  constexpr bool kKeep = kC * kE <= 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kLnMaxStages], empty[kLnMaxStages];
  uint8_t* const base =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int box = rows * N * (int)sizeof(T);  // bytes of one tile
  const int s_at = (box + 1023) / 1024 * 1024;  // the s tile in a stage
  const int tiles = (M + rows - 1) / rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], kLnWarps);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kLnWarps) {  // the producer
    if (lane == 0) {
      sm::tma_prefetch(&map_dy);
      sm::tma_prefetch(&map_s);
      int q = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
        const int s = q % stages, u = q / stages;
        if (u > 0) sm::mbar_wait(&empty[s], (uint32_t)((u - 1) & 1));
        sm::mbar_expect_tx(&full[s], 2 * box);
        uint8_t* const dst = base + s * stage_bytes;
        sm::tma_load(dst, &map_dy, &full[s], 0, t * rows);
        sm::tma_load(dst + s_at, &map_s, &full[s], 0, t * rows);
      }
    }
    return;
  }

  const int chunks = N / kE;
  const int j = lane % lanes;                         // the lane's place
  const int r = warp * (32 / lanes) + lane / lanes;   // its row of a tile
  const float inv_n = 1.f / (float)N;
  float g[kC][kE], dg[kC][kE], db[kC][kE];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = j + lanes * c;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      g[c][e] = k < chunks ? gamma[k * kE + e] : 0.f;
      dg[c][e] = db[c][e] = 0.f;
    }
  }
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
    const int s = q % stages;
    sm::mbar_wait(&full[s], (uint32_t)((q / stages) & 1));
    const T* const ys =
        reinterpret_cast<const T*>(base + s * stage_bytes) + r * N;
    const T* const xs =
        reinterpret_cast<const T*>(base + s * stage_bytes + s_at) + r * N;
    const int row = t * rows + r;
    const bool live = row < M;  // TMA's zero rows past M: computed, unused
    // da of chunk k from v (f32 values) [and dam, in scratch tmp]
    const auto emit = [&](int k, const float(&v)[kE], float(&tmp)[kE]) {
      const size_t off = (size_t)row * N + k * kE;
      C16::store(da + off, v);
      if constexpr (kDrop) {
        uint32_t keep = 0u;
#pragma unroll 1
        for (int e = 0; e < kE; ++e)
          keep |= (uint32_t)nylon::keeps(site, (uint32_t)row, k * kE + e, N)
                  << e;
#pragma unroll
        for (int e = 0; e < kE; ++e)
          tmp[e] = nylon::round_to<T>(v[e]) * ((keep >> e) & 1u ? site.scale
                                                                : 0.f);
        C16::store(dam + off, tmp);
      }
    };
    if constexpr (kKeep) {
      // the lane's chunks of the row in registers, read once: the stage
      // is released before the math
      float x[kC][kE], d[kC][kE];
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = j + lanes * c;
        if (k >= chunks) continue;
        C16::load(xs + k * kE, x[c]);
        C16::load(ys + k * kE, d[c]);
#pragma unroll
        for (int e = 0; e < kE; ++e) sum += x[c][e];
      }
      __syncwarp();
      if (lane == 0) sm::mbar_arrive(&empty[s]);
      // the statistics: the mean, then the variance about it
      const float mean = row_sum(sum, lanes) * inv_n;
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (j + lanes * c >= chunks) continue;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          x[c][e] -= mean;
          sq += x[c][e] * x[c][e];
        }
      }
      const float inv = rsqrtf(row_sum(sq, lanes) * inv_n + eps);
      // x to xhat, d to dxhat: dgamma, dbeta, the row means of dxhat and
      // dxhat * xhat
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (j + lanes * c >= chunks) continue;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          x[c][e] *= inv;
          if (live) {
            dg[c][e] += d[c][e] * x[c][e];
            db[c][e] += d[c][e];
          }
          d[c][e] *= g[c][e];
          s1 += d[c][e];
          s2 += d[c][e] * x[c][e];
        }
      }
      const float m1 = row_sum(s1, lanes) * inv_n;
      const float m2 = row_sum(s2, lanes) * inv_n;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = j + lanes * c;
        if (k >= chunks) continue;
#pragma unroll
        for (int e = 0; e < kE; ++e)
          d[c][e] = (d[c][e] - m1 - x[c][e] * m2) * inv;
        if (live) emit(k, d[c], x[c]);
      }
      continue;
    }
    // wider lanes: the chunks read from the stage in every pass
    float x[kE], d[kE];
    // the statistics: the mean, then the variance about it
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = j + lanes * c;
      if (k >= chunks) continue;
      C16::load(xs + k * kE, x);
#pragma unroll
      for (int e = 0; e < kE; ++e) sum += x[e];
    }
    const float mean = row_sum(sum, lanes) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = j + lanes * c;
      if (k >= chunks) continue;
      C16::load(xs + k * kE, x);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float v = x[e] - mean;
        sq += v * v;
      }
    }
    const float inv = rsqrtf(row_sum(sq, lanes) * inv_n + eps);
    // dgamma, dbeta, and the row means of dxhat and dxhat * xhat
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = j + lanes * c;
      if (k >= chunks) continue;
      C16::load(xs + k * kE, x);
      C16::load(ys + k * kE, d);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float xh = (x[e] - mean) * inv;
        if (live) {
          dg[c][e] += d[e] * xh;
          db[c][e] += d[e];
        }
        const float dxh = d[e] * g[c][e];
        s1 += dxh;
        s2 += dxh * xh;
      }
    }
    const float m1 = row_sum(s1, lanes) * inv_n;
    const float m2 = row_sum(s2, lanes) * inv_n;
    // da [and dam], 16 bytes a chunk
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = j + lanes * c;
      if (k >= chunks) continue;
      C16::load(xs + k * kE, x);
      C16::load(ys + k * kE, d);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float xh = (x[e] - mean) * inv;
        d[e] = (d[e] * g[c][e] - m1 - xh * m2) * inv;
      }
      if (live) emit(k, d, x);
    }
    __syncwarp();
    if (lane == 0) sm::mbar_arrive(&empty[s]);
  }

  // the block's dgamma / dbeta: over the warp's row groups, then over the
  // warps in order, in the ring (every tile has been read: the named
  // barrier waits for the warps still on their last one)
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o >= lanes) {
          dg[c][e] += __shfl_xor_sync(0xffffffffu, dg[c][e], o);
          db[c][e] += __shfl_xor_sync(0xffffffffu, db[c][e], o);
        }
  sm::named_sync(1, kLnWarps * 32);
  float* const red = reinterpret_cast<float*>(base);  // [2][kLnWarps][N]
  if (lane < lanes) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = j + lanes * c;
      if (k >= chunks) continue;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        red[warp * N + k * kE + e] = dg[c][e];
        red[(kLnWarps + warp) * N + k * kE + e] = db[c][e];
      }
    }
  }
  sm::named_sync(1, kLnWarps * 32);
  for (int col = threadIdx.x; col < N; col += kLnWarps * 32) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kLnWarps; ++w) {
      a += red[w * N + col];
      b += red[(kLnWarps + w) * N + col];
    }
    dg_part[(size_t)blockIdx.x * N + col] = a;
    db_part[(size_t)blockIdx.x * N + col] = b;
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

template <typename T, int kC>
int launch_ln_bwd_c(const void* dy, const void* s, const void* gamma,
                    void* da, void* dam, void* dg_part, void* db_part, int M,
                    int N, const LnLayout& lay, int n_blocks, float eps,
                    int active, const DropSite& site, cudaStream_t stream) {
  const int stage_bytes = 2 * ((lay.rows * N * (int)sizeof(T) + 1023) /
                               1024 * 1024);
  const int fit = kLnRingBytes<kC> / stage_bytes;
  const int stages = fit < kLnMaxStages ? fit : kLnMaxStages;
  const int red = 2 * kLnWarps * N * (int)sizeof(float);  // the block sums
  const int smem =
      (stages * stage_bytes > red ? stages * stage_bytes : red) + 1024;
  CUtensorMap md, ms;
  int e = nylon::ring::encode_rows_of(&md, nylon::ring::tma_type<T>(),
                                      sizeof(T), dy, M, N, N, lay.rows, N);
  if (!e)
    e = nylon::ring::encode_rows_of(&ms, nylon::ring::tma_type<T>(),
                                    sizeof(T), s, M, N, N, lay.rows, N);
  const auto kernel =
      active ? ln_bwd_kernel<T, kC, true> : ln_bwd_kernel<T, kC, false>;
  if (!e)
    e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  kernel<<<n_blocks, kLnThreads, smem, stream>>>(
      md, ms, (const float*)gamma, (T*)da, active ? (T*)dam : nullptr,
      (float*)dg_part, (float*)db_part, M, N, lay.lanes, lay.rows, stages,
      stage_bytes, eps, site);
  return (int)cudaGetLastError();
}

// rows_per_tile: ln_layout's rows (the caller's plan must be this
// kernel's); n_blocks: at most the tiles, so that every block has one.
template <typename T>
int launch_ln_bwd(const void* dy, const void* s, const void* gamma, void* da,
                  void* dam, void* dg_part, void* db_part, int M, int N,
                  int rows_per_tile, int n_blocks, float eps, int active,
                  unsigned key, unsigned thresh, float scale, int half,
                  cudaStream_t stream) {
  if (M <= 0 || N <= 0 || N % 32 || N > kLnMaxN || (half && 2 * half != N))
    return (int)cudaErrorInvalidValue;
  const LnLayout lay = ln_layout(N, sizeof(T));
  const long long tiles = ((long long)M + lay.rows - 1) / lay.rows;
  if (rows_per_tile != lay.rows || n_blocks <= 0 || n_blocks > tiles)
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, 0u};
  if (lay.kc == 1)
    return launch_ln_bwd_c<T, 1>(dy, s, gamma, da, dam, dg_part, db_part, M,
                                 N, lay, n_blocks, eps, active, site, stream);
  if constexpr (sizeof(T) == 4)  // a bf16 row's <= 32 chunks: 1 or 3 a lane
    if (lay.kc == 2)
      return launch_ln_bwd_c<T, 2>(dy, s, gamma, da, dam, dg_part, db_part,
                                   M, N, lay, n_blocks, eps, active, site,
                                   stream);
  return launch_ln_bwd_c<T, 3>(dy, s, gamma, da, dam, dg_part, db_part, M, N,
                               lay, n_blocks, eps, active, site, stream);
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
// keep). dy, s, da, dam: contiguous [M, N], 16-byte aligned; N % 32 == 0,
// N <= 256; rows_per_tile: the kernel's tile (ln_layout); dg_part/db_part:
// [n_blocks, N] partial sums, n_blocks at most the tiles.
int nylon_ln_bwd(const void* dy, const void* s, const void* gamma, void* da,
                 void* dam, void* dg_part, void* db_part, int M, int N,
                 int rows_per_tile, int n_blocks, float eps, int active,
                 unsigned key, unsigned thresh, float scale, int half,
                 void* stream) {
  return launch_ln_bwd<bf16>(dy, s, gamma, da, dam, dg_part, db_part, M, N,
                             rows_per_tile, n_blocks, eps, active, key,
                             thresh, scale, half, (cudaStream_t)stream);
}

// The float32 twin of nylon_ln_bwd: f32 dy, s, da and dam.
int nylon_ln_bwd_f32(const void* dy, const void* s, const void* gamma,
                     void* da, void* dam, void* dg_part, void* db_part, int M,
                     int N, int rows_per_tile, int n_blocks, float eps,
                     int active, unsigned key, unsigned thresh, float scale,
                     int half, void* stream) {
  return launch_ln_bwd<float>(dy, s, gamma, da, dam, dg_part, db_part, M, N,
                              rows_per_tile, n_blocks, eps, active, key,
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
