// int8 (W8A8) transformer-layer kernels for the hFT inference engine on
// Hopper (sm_90a).
//
// Replaces the whole-layer Pallas kernels of nylon_amt_tpu/ops/
// layer_fused_q8.py: encoder_layer_q8, encoder_layer_with_stem_q8 (after
// K2's stem kernel, csrc/stem_embed.cu), decoder_layer_zero_q8 and
// decoder_layer_q8 (_self_block_q8 / _cross_tail_q8 and the decoder's
// self-attention prologue).
//
// What bounds them here: the int8 products of a layer at hid 256 do ~128
// operations per byte of bf16 activations, under the H100's ~590 int8
// operations per byte ridge (1,979 TOPS over 3.35 TB/s), so by the
// operation count alone a layer is bound by device-memory traffic; a
// layer's time is set by how many passes its activations and their int8
// copies make through device memory. As in csrc/layer_fused.cu, each layer
// is a short sequence of simple kernels launched in turn by the Python
// wrapper (ops/layer_fused_q8.py). Every kernel takes the activations in
// the compute dtype T, bf16 or f32 (the default model configuration
// computes in f32; JAX's int8 layers compute in q.dtype), each with its own
// entry point (the f32 ones end in _f32):
//
//  * quant_rows_kernel: T rows -> int8 codes + an f32 scale per row (one
//    warp per row), for the GEMM inputs that no kernel before them writes
//    as codes (the stem layer's and the first time layer's input, the
//    decoder's note queries);
//  * quant_cols_kernel: V's quantizer, one scale per column over the whole
//    key sequence, from one TMA-fed read of V; it writes the codes
//    transposed per sequence, [hid, Lk_pad] with zero codes past Lk, which
//    is the operand layout the PV product needs (a ragged last block of
//    columns for hid % 64 != 0; its design note is at the kernel);
//  * gemm_q8_bias_kernel: out = T((f32(A @ W) * sa[row]) * sw[col]) +
//    bias [, ReLU], an s8 x s8 -> s32 tensor-core GEMM (wgmma m64nNk32 fed
//    by TMA: gemm_sm90.cuh's s8 mainloop) with a dequantizing epilogue;
//    optionally the row quantization of its first n_seg column segments
//    (Q and K of the QKV product, K of the cross KV product, the cross Q,
//    the FFN hidden) from the same registers, those columns then leaving
//    as codes only;
//  * gemm_q8_res_ln_kernel: the same GEMM with a block that owns full rows,
//    so the residual and the shared post-LayerNorm run in its epilogue on
//    the accumulator fragments, and optionally the row quantization of its
//    output for the next GEMM;
//  * attention_q8_kernel: a persistent grid of thread-block clusters, one
//    block a head, walking the sequences with the next one's loads in
//    flight; int8 QK^T and PV products on wgmma fed by TMA, an exact
//    two-pass softmax in f32, and the row quantization of the heads'
//    output across the cluster (each row's scale spans every head): codes
//    and row scales out, the output in T only on request.
//
// Every row quantization (quant_rows_kernel and the epilogues) goes through
// row_quant and frag_codes below, on the values as rounded to T: its codes
// and scales are _quant_rows's of the T values, bit for bit.
//
// 8-bit wgmma reads both operands K-major only, so the GEMMs take the
// weights as W^T [N, K], packed once on the host (ops/layer_fused_q8.py::
// pack_wt) from the [K, N] codes JAX's pack keeps; a stage is one 128-byte
// swizzle row of int8 (K 128) of A and of W^T. K is a multiple of 16 (a
// TMA row of K bytes) up to kMaxK; ragged K and M are zero-filled by TMA.
//
// Numerics follow the JAX kernel body where it pins them (the traps):
//  * rounding: jnp.round rounds half to even; rintf does too (roundf rounds
//    half away from zero and would flip codes at ties);
//  * the quantizer computes x * (127 / a) with a = max(absmax, 1e-12) and
//    the scale a * (1 / 127), in that order (x / a * 127 is another
//    number); the constants are the f32 roundings of the double values, as
//    JAX takes Python floats;
//  * dequant: (f32(acc) * sx) * sw, cast to T BEFORE the bias add, the
//    bias added in T (in f32 the casts are identities);
//  * Q and K scales span all heads (the row quantizer sees the whole hid),
//    V's span the whole key sequence (quant_cols sees it): a per-head block
//    could compute neither, so attention takes int8 tensors and scales;
//  * scores f32(s_i) * (sq * scale*log2e) * sk; l sums the UNquantized p =
//    exp2(s - m); pq = rint(p * 127) feeds the PV product; the output is
//    f32(o) * sv / l with sv = av / 127^2;
//  * keys past Lk (88 decoder queries attend to 88 keys) are zero codes,
//    masked out of the row max and out of l.
// Every int8 sum is exact (|acc| <= K * 127^2 < 2^24 for K <= 1040, so
// f32(acc) is too): the GEMM outputs equal the plain version's bit for bit;
// only the f32 sums of the LayerNorm and of l, and exp2, are taken in
// another order or by another routine than PyTorch's.

#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "layer_epilogue.cuh"
#include "tma_ring.cuh"

using nylon::bf16;
namespace sm = nylon::sm90;
using sm::Frag;

namespace {

constexpr int kThreads = 256;  // 8 warps: the quantizers
constexpr int kMaxK = 1040;    // the GEMMs' depth: |sum| <= K 127^2 < 2^24
constexpr int kLnMaxN = 256;   // gemm_q8_res_ln: a block owns full rows
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kInv127Sq = (float)(1.0 / (127.0 * 127.0));
constexpr float kAbsFloor = 1e-12f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The int8 code of x for the reciprocal scale r = 127 / a, as an int
// (round half to even: rintf's bits in one conversion; |x * r| <= 127 up
// to rounding, so the code fits a byte).
__device__ __forceinline__ int quant_int(float x, float r) {
  return __float2int_rn(x * r);
}
__device__ __forceinline__ int8_t quant_code(float x, float r) {
  return (int8_t)quant_int(x, r);
}

// The codes of x0, x1 in the low two bytes (x0's first); the high two
// are x0's again: callers keep the low half.
__device__ __forceinline__ uint32_t code_bytes(float x0, float x1, float r) {
  return __byte_perm(quant_int(x0, r), quant_int(x1, r), 0x0040);
}

// A row's quantizer from the absmax of its values: a = max(absmax, 1e-12),
// the codes' reciprocal scale r = 127 / a (IEEE division: no fast math),
// and the dequantizing scale a * (1 / 127).
struct RowQuant {
  float a, r;
  __device__ __forceinline__ explicit RowQuant(float absmax)
      : a(fmaxf(absmax, kAbsFloor)), r(127.f / a) {}
  __device__ __forceinline__ float scale() const { return a * kInv127; }
};

// 8 consecutive elements as f32 (16 bytes of bf16, 32 of f32).
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(e[t]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// (f32(acc) * sx) * sw, each product rounded (no FMA with the bias add that
// follows in f32).
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn((float)acc, sx), sw);
}

// ------------------------------------------------------------ quantizers ----

constexpr int kMaxRowChunks = 4;  // 8 elements per chunk per lane: K <= 1024

// Row r: x[r, :K] -> q[r, :K], s[r]. One warp per row; the row stays in
// registers. T: bf16 or f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_rows_kernel(const T* __restrict__ x, long long ld_x, int M,
                      int K, int8_t* __restrict__ q,
                      float* __restrict__ s) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // warp-uniform
  const T* src = x + (size_t)row * ld_x;
  const int chunks = K / 8;
  float v[kMaxRowChunks][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      load8(src + c * 8, v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[i][t]));
    }
  }
  const RowQuant rq(warp_max(amax));
  int8_t* dst = q + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      uint2 packed;
      int8_t* o = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) o[t] = quant_code(v[i][t], rq.r);
      *reinterpret_cast<uint2*>(dst + c * 8) = packed;
    }
  }
  if (lane == 0) s[row] = rq.scale();
}

// quant_cols_kernel: V's quantizer (JAX's _mha_block_q8: av, vq, sv).
// What bounds it: bytes. It reads V once (T) and writes one code a value
// and one scale a column, a few operations a value. Its first form read V
// twice from device memory with 2-byte loads on V's row stride of 3 hid
// or 2 hid (the absmax, then the codes), two __syncthreads every 32 keys,
// and ran at 47% of this bound on an NVIDIA H100 (PERF.md). This design
// reads V once:
//
//  * a persistent grid over work items (sequence, 64-column block); one TMA
//    load brings an item's whole [L, 64] slice of V into shared memory (a
//    2-D map over V's strided view [n L, hid]: its column extent hid, so
//    the ragged last block is TMA's zero fill and nothing past V is read),
//    into a ring of 2-4 stages that thread 0 keeps filled ahead of the
//    block (the next items' loads in flight while one is quantized);
//  * each thread owns a column pair (lane l: columns 2 l, 2 l + 1) and a
//    set of 16-key chunks (warp w: chunks (w + l) % 8, + 8, ..): the
//    column absmax from shared memory (order-free: the scales are the plain
//    version's bits), combined over the warps in shared memory, then the
//    codes of its chunks from shared memory again, 16 codes of a column in
//    one 16-byte store into the item's code tile [64, L_pad] (the rotation
//    of the chunks over the lanes keeps both the loads and these stores
//    free of bank conflicts);
//  * the code tile, laid out as the item's rows of vt, leaves by one bulk
//    copy (cp.async.bulk) while the next item is quantized into the other
//    tile.
//
// The quantizer is RowQuant's on the column: a = max(absmax, 1e-12), the
// codes rint(x * (127 / a)), the scale a / 127^2 (P's 1/127 folded in).

constexpr int kColTile = 64;      // V columns a work item
constexpr int kColChunk = 16;     // keys a 16-byte chunk of codes
constexpr int kColMaxKeys = 256;  // L: a stage of at most 64 KB
constexpr int kColMaxStages = 4;
constexpr int kColRingBytes = 64 * 1024;

// The item's code tile to device memory: `bytes` (a multiple of 16) from
// shared address `src` to `dst` (16-byte aligned).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// Two consecutive T of shared memory as f32.
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Item i of n_seq * ceil(hid / 64): sequence i / n_cb, columns 64 (i %
// n_cb) ..: x[seq L + j, col] -> vt[seq, col, j] (j < l_pad, zero codes
// past L) and sv[seq, col]. The ring: `stages` stages of stage_bytes, then
// two code tiles of 64 l_pad bytes, from a 1024-byte aligned base.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_cols_kernel(const __grid_constant__ CUtensorMap map_v, int n_seq,
                      int L, int l_pad, int hid, int stages, int stage_bytes,
                      int8_t* __restrict__ vt, float* __restrict__ sv) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kColMaxStages];
  __shared__ float part[kThreads / 32][kColTile];
  uint8_t* const base =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const codes = base + stages * stage_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_cb = (hid + kColTile - 1) / kColTile;
  const int items = n_seq * n_cb, n_chunks = l_pad / kColChunk;
  const uint32_t box = (uint32_t)(L * kColTile * sizeof(T));
  const auto load = [&](int k) {  // thread 0: the block's k-th item
    const int i = blockIdx.x + k * gridDim.x;
    if (i >= items) return;
    uint64_t* const bar = &full[k % stages];
    sm::mbar_expect_tx(bar, box);
    sm::tma_load(base + (k % stages) * stage_bytes, &map_v, bar,
                 (i % n_cb) * kColTile, (i / n_cb) * L);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) sm::mbar_init(&full[s], 1);
    sm::fence_barrier_init();
    sm::tma_prefetch(&map_v);
    for (int k = 0; k < stages - 1; ++k) load(k);
  }
  __syncthreads();

  int k = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++k) {
    // the stage of item k - 1 has been read (the barrier that closed it):
    // refill it
    if (threadIdx.x == 0) load(k + stages - 1);
    const int seq = i / n_cb, col0 = (i % n_cb) * kColTile;
    sm::mbar_wait(&full[k % stages], (uint32_t)((k / stages) & 1));
    const T* const v =
        reinterpret_cast<const T*>(base + (k % stages) * stage_bytes) +
        2 * lane;  // [L][64]
    float a0 = 0.f, a1 = 0.f;
    for (int c = (warp + lane) & 7; c < n_chunks; c += 8)
#pragma unroll 4
      for (int t = 0; t < kColChunk; ++t) {
        const int j = c * kColChunk + t;
        if (j < L) {
          const float2 x = ld_pair(v + j * kColTile);
          a0 = fmaxf(a0, fabsf(x.x));
          a1 = fmaxf(a1, fabsf(x.y));
        }
      }
    part[warp][2 * lane] = a0;
    part[warp][2 * lane + 1] = a1;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {  // every warp's keys
      a0 = fmaxf(a0, part[w][2 * lane]);
      a1 = fmaxf(a1, part[w][2 * lane + 1]);
    }
    const RowQuant q0(a0), q1(a1);
    const int col = col0 + 2 * lane;
    if (warp == 0 && col < hid) {  // hid % 8 == 0: col + 1 < hid too
      sv[(size_t)seq * hid + col] = q0.a * kInv127Sq;
      sv[(size_t)seq * hid + col + 1] = q1.a * kInv127Sq;
    }
    int8_t* const tile =
        reinterpret_cast<int8_t*>(codes + (k & 1) * kColTile * l_pad);
    const uint32_t out0 = sm::smem_u32(tile + 2 * lane * l_pad);
    for (int c = (warp + lane) & 7; c < n_chunks; c += 8) {
      uint32_t w0[4], w1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w0[u] = w1[u] = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = c * kColChunk + 4 * u + b;
          const float2 x = j < L ? ld_pair(v + j * kColTile)
                                 : make_float2(0.f, 0.f);
          w0[u] |= (uint32_t)(quant_int(x.x, q0.r) & 0xFF) << (8 * b);
          w1[u] |= (uint32_t)(quant_int(x.y, q1.r) & 0xFF) << (8 * b);
        }
      }
      const uint32_t at = out0 + c * kColChunk;
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(w0[0]), "r"(w0[1]), "r"(w0[2]), "r"(w0[3])
                   : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       at + l_pad),
                   "r"(w1[0]), "r"(w1[1]), "r"(w1[2]), "r"(w1[3])
                   : "memory");
    }
    sm::fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int cols = hid - col0 < kColTile ? hid - col0 : kColTile;
      bulk_store(vt + ((size_t)seq * hid + col0) * l_pad, sm::smem_u32(tile),
                 (uint32_t)(cols * l_pad));
      sm::bulk_commit();
      sm::bulk_wait_read<1>();  // the other tile is free for the next item
    }
  }
  if (threadIdx.x == 0) sm::bulk_wait();
}

// ------------------------------------------------------------ s8 GEMM ----
//
// Both GEMM kernels run gemm_sm90.cuh's s8 mainloop (RingS8): persistent
// blocks of one producer warp (TMA loads of A [M, K] and W^T [N, K], a
// ring of 3-4 stages 128 deep in K) and two consumer warpgroups (wgmma
// m64nBNk32 .s32.s8.s8, 64 rows each), and their epilogues work on the s32
// accumulator fragments in registers. Outputs in T leave through
// 128-byte-swizzled 64-row boxes of 128-byte rows (64 bf16 or 32 f32
// columns) by TMA stores, which clip the ragged edge.

// Columns of T in a box row of 128 bytes: 64 bf16, 32 f32.
template <typename T>
constexpr int kBoxCols = 128 / (int)sizeof(T);

// Shared address of consumer thread f's column pair (8 j + 2 q, + 1) of row
// r0 + 8 i in the 64-row box at `box` that holds column 8 j (128-byte
// swizzle).
template <typename T>
__device__ __forceinline__ uint32_t pair_addr(const Frag& f, uint32_t box,
                                              int i, int j) {
  const int b = ((8 * j) % kBoxCols<T> + 2 * f.q) * (int)sizeof(T);
  return box + sm::sw128(f.r0 + 8 * i, b >> 4) + (b & 15);
}

// A column pair (col, col + 1) of T, kept as T: bf16x2, or two f32; its
// shared-memory and global loads, its shared-memory store, its f32 values,
// and two f32 values rounded to it.
template <typename T>
struct PairOf;

template <>
struct PairOf<bf16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type ld(uint32_t addr) {
    return sm::bf16x2(sm::ld_shared(addr));
  }
  static __device__ __forceinline__ type ldg(const bf16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  static __device__ __forceinline__ void st(uint32_t addr, type v) {
    sm::st_shared(addr, sm::bits(v));
  }
  static __device__ __forceinline__ float2 f32(type v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ type from(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};

template <>
struct PairOf<float> {
  using type = float2;
  static __device__ __forceinline__ type ld(uint32_t addr) {
    return sm::ld_shared_f2(addr);
  }
  static __device__ __forceinline__ type ldg(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void st(uint32_t addr, type v) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x),
                 "f"(v.y)
                 : "memory");
  }
  static __device__ __forceinline__ float2 f32(type v) { return v; }
  static __device__ __forceinline__ type from(float x, float y) {
    return make_float2(x, y);
  }
};

// gemm_q8_bias's epilogue on a column pair of a row: T(T((f32(acc) * sx) *
// sw) + bias) [, ReLU]: the dequantized product cast to T BEFORE the bias
// add, the bias added in T. bf16: packed, layer_epilogue.cuh's
// bias_epilogue2 on the dequantized pair (the bits of the scalar form on
// each element, with one conversion of the pair).
__device__ __forceinline__ __nv_bfloat162 bias_pair(int a0, int a1, float sx,
                                                    float2 sw,
                                                    __nv_bfloat162 bias,
                                                    int relu) {
  return nylon::bias_epilogue2<false>(dequant(a0, sx, sw.x),
                                      dequant(a1, sx, sw.y), bias, relu,
                                      nylon::DropSite{}, bias, 0u, 0, 0);
}
__device__ __forceinline__ float2 bias_pair(int a0, int a1, float sx,
                                            float2 sw, float2 bias,
                                            int relu) {
  float2 y = make_float2(dequant(a0, sx, sw.x) + bias.x,
                         dequant(a1, sx, sw.y) + bias.y);
  if (relu) y = make_float2(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f));
  return y;
}

// gemm_q8_res_ln's pre-LN sum on a column pair: T(res + T(T(dequant) +
// bias)); bf16: residual_sum2's packed form.
__device__ __forceinline__ __nv_bfloat162 res_pair(int a0, int a1, float sx,
                                                   float2 sw,
                                                   __nv_bfloat162 bias,
                                                   __nv_bfloat162 res) {
  return nylon::residual_sum2<false>(dequant(a0, sx, sw.x),
                                     dequant(a1, sx, sw.y), bias, res,
                                     nylon::DropSite{}, bias, 0u, 0, 0);
}
__device__ __forceinline__ float2 res_pair(int a0, int a1, float sx,
                                           float2 sw, float2 bias,
                                           float2 res) {
  return make_float2(res.x + (dequant(a0, sx, sw.x) + bias.x),
                     res.y + (dequant(a1, sx, sw.y) + bias.y));
}

// One element of T to shared memory.
__device__ __forceinline__ void st_shared_t(uint32_t addr, bf16 v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr),
               "h"(__bfloat16_as_ushort(v))
               : "memory");
}
__device__ __forceinline__ void st_shared_t(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The int8 codes of a column pair (f32 bits a0, a1) for the reciprocal
// scale r, in the low two bytes (column col's first).
__device__ __forceinline__ uint32_t code_pair(int a0, int a1, float r) {
  return code_bytes(__int_as_float(a0), __int_as_float(a1), r);
}

// A row's codes of column fragments 4 J .. 4 J + 3 regrouped within the
// quad: lane q holds two codes of each (columns 8 j + 2 q, + 1; w0 = those
// of 4 J | 4 J + 1 << 16, w1 = 4 J + 2 | 4 J + 3 << 16) and gets the eight
// codes of fragment 4 J + q, in column order: two shfl_xor and byte
// permutes, so that each lane stores 8 bytes and the quad a 32-byte sector
// of the row. Every lane of the warp calls it.
__device__ __forceinline__ uint2 quad_gather(uint32_t w0, uint32_t w1,
                                             int q) {
  // lanes q, q ^ 2 swap halves: then x holds lane (q & 1)'s codes and y
  // lane (q & 1) + 2's, of fragments 4 J + 2 (q >> 1) (low) and + 1 (high)
  const bool upper = q >= 2;
  const uint32_t kept = upper ? w1 : w0;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, upper ? w0 : w1, 2);
  const uint32_t x = upper ? got : kept, y = upper ? kept : got;
  // lanes q, q ^ 1 swap the fragment each wants: k, lanes (q & 1) and
  // (q & 1) + 2 of fragment 4 J + q; r, the other two lanes'
  const bool odd = q & 1;
  const uint32_t lo = __byte_perm(x, y, 0x5410), hi = __byte_perm(x, y, 0x7632);
  const uint32_t k = odd ? hi : lo;
  const uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
  const uint32_t a = odd ? r : k, b = odd ? k : r;  // lanes 0, 2 | 1, 3
  return make_uint2(__byte_perm(a, b, 0x5410), __byte_perm(a, b, 0x7632));
}

// The eight codes lane q of a quad stores for row i of the column
// fragments j .. j + 3 held as f32 bits in v (v[4 j' + 2 i + c]: the
// accumulator's fragment layout), for the reciprocal scale r (RowQuant):
// those of fragment j + q, in column order (quad_gather). Every lane of the
// warp calls it.
template <int R>
__device__ __forceinline__ uint2 frag_codes(const int (&v)[R], int j, int i,
                                            float r, int q) {
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = 4 * (j + 2 * h) + 2 * i;  // fragments j + 2 h, + 1
    w[h] = __byte_perm(code_pair(v[a], v[a + 1], r),
                       code_pair(v[a + 4], v[a + 5], r), 0x5410);
  }
  return quad_gather(w[0], w[1], q);
}

// ------------------------------------------------------- GEMM + bias ----

// With kStash (codes only, each row one segment over a row block's two
// column tiles) each consumer thread stashes its first tile's T values in
// shared memory, as pairs of T (32-bit words: bf16x2, or the two halves of
// a float2), BN / 4 words of bf16 or BN / 2 of f32 a thread, word k of all
// 256 consumers contiguous.
template <int BN, typename T>
constexpr int kStashWords = BN / 4 * (int)sizeof(T) / 2;
// gemm_q8_bias's epilogue area: a ring of two output boxes a warpgroup,
// then each warpgroup's copy of the tile's column scales (f32) and bias
// (T), BN of each. With kStash the stash instead of the boxes, and in f32
// no column values (the stash leaves no room: the epilogue reads them from
// global memory).
template <int BN, typename T>
constexpr int kBiasParamBytes = 2 * BN * (4 + (int)sizeof(T));
template <int BN, typename T, bool kStash>
constexpr bool kBiasParamsInSmem = !kStash || sizeof(T) == 2;
template <int BN, typename T, bool kStash>
constexpr int kBiasEpiBytes =
    (kStash ? 2 * 128 * 4 * kStashWords<BN, T> : 2 * 2 * sm::kBoxBytes) +
    (kBiasParamsInSmem<BN, T, kStash> ? kBiasParamBytes<BN, T> : 0);

// Column segments of a tile the codes epilogue tracks: at least 64 columns
// each, at most two (codes_tile).
template <int BN>
constexpr int kSlots = BN / 64 < 2 ? BN / 64 : 2;

// gemm_q8_bias's registers a thread: its producer warpgroup's and its
// consumers'. At BN 256 the accumulator (128) and the codes epilogue do not
// fit in the 168 that ptxas gives each of 288 threads, so the kernel runs
// 384 (a full producer warpgroup, whose registers the consumers take:
// setmaxnreg.inc takes only what the block's own dec gave back).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// out[M, N] = T(T((f32(a @ w) * sa[row]) * sw[col]) + bias[col]) [, ReLU]
// with a [M, K] and W^T [N, K] int8. Tile t is (row block t / n_tiles_n,
// column block t % n_tiles_n): the N tiles of a row block run together, so
// A is read from HBM once and its other reads hit L2.
//
// With q: the row quantization of the first n_codes / seg column segments
// of seg columns each, from the T values in registers (RowQuant,
// frag_codes): codes q [M, n_codes] and scales s [n_codes / seg, M]. Each
// segment lies inside one tile (codes_tile), or, with kStash, the only
// segment is the whole row over the two column tiles of a row block, which
// one block walks in turn, stashing the first tile's values until the
// second gives the row's absmax. Only the columns from n_codes on leave in
// T, to out [M, N] (none if n_codes == N). A tile holds at most two
// segments; a column's is found by one compare with the second's first
// column (no division but the quantizers').
template <typename T, int BN, bool kStash>
__global__ void __launch_bounds__(sm::kThreadsTf32, 1)
    gemm_q8_bias_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_wt,
                        const __grid_constant__ CUtensorMap map_out,
                        const float* __restrict__ sa,
                        const float* __restrict__ sw,
                        const T* __restrict__ bias,
                        int8_t* __restrict__ q, float* __restrict__ s,
                        int M, int N, int K, int relu, int n_tiles_n,
                        int seg, int n_codes) {
  constexpr int kCols = kBoxCols<T>;
  constexpr bool kParams = kBiasParamsInSmem<BN, T, kStash>;
  constexpr int kGroups = BN / 32;  // quad_gather groups of a tile
  static_assert(kSlots<BN> <= 2, "a tile's segments");
  extern __shared__ uint8_t smem_raw[];
  sm::RingS8<BN, kBiasEpiBytes<BN, T, kStash>> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(1);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBKS8 - 1) / sm::kBKS8;
  // a block's unit of work: a tile, or with kStash a row block's tiles
  const int per_unit = kStash ? n_tiles_n : 1;
  const long long units =
      (long long)(n_tiles_n / per_unit) * ((M + sm::kBM - 1) / sm::kBM);

  if (warp >= sm::kConsumerWarps) {  // the producer warpgroup
    sm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == sm::kConsumerWarps * 32) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_wt);
      for (long long u = blockIdx.x; u < units; u += gridDim.x)
        for (int jn = 0; jn < per_unit; ++jn) {
          const long long t = u * per_unit + jn;
          const int m0 = (int)(t / n_tiles_n) * sm::kBM;
          const int n0 = (int)(t % n_tiles_n) * BN;
          for (int kb = 0; kb < nk; ++kb)
            ring.load(&map_a, &map_wt, m0, n0, kb);
        }
    }
    return;
  }

  sm::reg_alloc<kConsumerRegs>();
  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ebase = sm::smem_u32(ring.epi(2 * g));
  const uint32_t stash = sm::smem_u32(ring.epi(0)) + 4 * (128 * g + tid);
  const uint32_t s_sw =
      sm::smem_u32(ring.epi(0)) +
      (kStash ? 2 * 128 * 4 * kStashWords<BN, T> : 4 * sm::kBoxBytes) +
      g * BN * (4 + (int)sizeof(T));
  const uint32_t s_bias = s_sw + 4 * BN;
  using Pair = PairOf<T>;
  constexpr int kJ = kCols / 8;  // column fragments a box
  uint32_t staged = 0;  // boxes this warpgroup has staged: ring slot parity
  int acc[BN / 2];
  float amax[kSlots<BN>][2];  // the rows' absmax of each segment
  constexpr int kPer = (BN + 127) / 128;  // columns a thread stages
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    for (int jn = 0; jn < per_unit; ++jn) {
      const long long t = u * per_unit + jn;
      const int m0 = (int)(t / n_tiles_n) * sm::kBM;
      const int n0 = (int)(t % n_tiles_n) * BN;
      const int row0 = m0 + 64 * g;
      // the tile's row scales, column scales and bias, loaded while the
      // mainloop runs (their latency, once a tile, would stall the epilogue)
      float sx[2], swv[kPer];
      T bv[kPer];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + f.r0 + 8 * i;
        sx[i] = row < M ? sa[row] : 0.f;
      }
      if constexpr (kParams) {
#pragma unroll
        for (int u2 = 0; u2 < kPer; ++u2) {
          const int c = tid + 128 * u2;
          if (c < BN && n0 + c < N) {
            swv[u2] = sw[n0 + c];
            bv[u2] = bias[n0 + c];
          }
        }
      }
      ring.mma(acc, nk, g);
      if constexpr (kParams) {
        // the column values to shared memory: a T tile's box syncs order
        // them after the previous tile's reads and before this one's; a
        // codes tile has none, so with q the warpgroup syncs around them
        if (q != nullptr) sm::named_sync(1 + g, 128);
#pragma unroll
        for (int u2 = 0; u2 < kPer; ++u2) {
          const int c = tid + 128 * u2;
          if (c < BN && n0 + c < N) {
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_sw + 4 * c),
                         "f"(swv[u2])
                         : "memory");
            st_shared_t(s_bias + (int)sizeof(T) * c, bv[u2]);
          }
        }
        if (q != nullptr) sm::named_sync(1 + g, 128);
      }
      // the segments that start in this tile: the tile-relative first
      // column of each, BN past the last (with kStash the one segment is
      // the row, begun in the row block's first tile)
      const int first = kStash ? 0 : (n0 + seg - 1) / seg;
      int lo[kSlots<BN>];
#pragma unroll
      for (int k = 0; k < kSlots<BN>; ++k) {
        const int c0 = (first + k) * seg;
        lo[k] = !kStash && c0 < n_codes && c0 < n0 + BN ? c0 - n0 : BN;
      }
      if (!kStash || jn == 0) {
#pragma unroll
        for (int k = 0; k < kSlots<BN>; ++k) amax[k][0] = amax[k][1] = 0.f;
      }
      // a tile with T columns stages them through the ring of two boxes
      const bool t_out = !kStash && n0 + BN > n_codes && n_codes < N;
      // a box of kJ fragments at a time
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j / kJ;
        const uint32_t box = ebase + ((staged + c) & 1) * sm::kBoxBytes;
        if (t_out && j % kJ == 0) {
          // the slot is free once every store group but the newest (the
          // other slot's: one group a box, empty if the box is not stored)
          // has read its box
          if (tid == 0) sm::bulk_wait_read<1>();
          sm::named_sync(1 + g, 128);
        }
        const int col = n0 + 8 * j + 2 * f.q;
        if (col < N) {
          float2 w2;
          typename Pair::type b2;
          if constexpr (kParams) {
            w2 = sm::ld_shared_f2(s_sw + 4 * (col - n0));
            b2 = Pair::ld(s_bias + (int)sizeof(T) * (col - n0));
          } else {
            w2 = *reinterpret_cast<const float2*>(sw + col);
            b2 = Pair::ldg(bias + col);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const auto y2 = bias_pair(acc[4 * j + 2 * i],
                                      acc[4 * j + 2 * i + 1], sx[i], w2, b2,
                                      relu);
            if (col < n_codes) {  // kept as T values for the codes
              const float2 y = Pair::f32(y2);
              acc[4 * j + 2 * i] = __float_as_int(y.x);
              acc[4 * j + 2 * i + 1] = __float_as_int(y.y);
              const float m = fmaxf(fabsf(y.x), fabsf(y.y));
              if (kSlots<BN> > 1 && 8 * j >= lo[kSlots<BN> - 1])
                amax[kSlots<BN> - 1][i] =
                    fmaxf(amax[kSlots<BN> - 1][i], m);
              else
                amax[0][i] = fmaxf(amax[0][i], m);
              if constexpr (kStash) {
                if (jn + 1 < per_unit) {  // the row's absmax is not known
                  if constexpr (sizeof(T) == 2) {
                    sm::st_shared(stash + 1024 * (2 * j + i), sm::bits(y2));
                  } else {
                    sm::st_shared(stash + 1024 * (4 * j + 2 * i),
                                  __float_as_uint(y.x));
                    sm::st_shared(stash + 1024 * (4 * j + 2 * i + 1),
                                  __float_as_uint(y.y));
                  }
                }
              }
            } else if constexpr (!kStash) {
              Pair::st(pair_addr<T>(f, box, i, j), y2);
            }
          }
        }
        if (t_out && j % kJ == kJ - 1) {
          sm::fence_async_smem();
          sm::named_sync(1 + g, 128);
          if (tid == 0) {
            const int bc = n0 + c * kCols;
            if (row0 < M && bc < N && bc + kCols > n_codes)
              sm::tma_store(&map_out, box, bc, row0);
            sm::bulk_commit();
          }
        }
      }
      if (t_out) staged += BN / kCols;
      if (q == nullptr || n0 >= n_codes) continue;
      if (kStash && jn + 1 < per_unit) continue;  // the row goes on
      // each segment's quantizer
      float rs[kSlots<BN>][2], scale[kSlots<BN>][2];
#pragma unroll
      for (int k = 0; k < kSlots<BN>; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const RowQuant rq(quad_max(amax[k][i]));
          rs[k][i] = rq.r;
          scale[k][i] = rq.scale();
        }
      // the codes of the tile at column nt0 (its values in acc), 8 bytes a
      // lane
      const auto codes = [&](int nt0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + f.r0 + 8 * i;
#pragma unroll
          for (int gr = 0; gr < kGroups; ++gr) {
            const int col = nt0 + 32 * gr;  // the group's first column
            if (col >= n_codes) continue;  // warp-uniform
            const float r = kSlots<BN> > 1 && 32 * gr >= lo[kSlots<BN> - 1]
                                ? rs[kSlots<BN> - 1][i]
                                : rs[0][i];
            const uint2 w = frag_codes(acc, 4 * gr, i, r, f.q);
            if (row < M && col + 8 * f.q < n_codes)
              *reinterpret_cast<uint2*>(q + (size_t)row * n_codes + col +
                                        8 * f.q) = w;
          }
        }
      };
      codes(n0);
      if constexpr (kStash) {  // the first tile's codes, from the stash
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (sizeof(T) == 2) {
              const float2 y = Pair::f32(
                  sm::bf16x2(sm::ld_shared(stash + 1024 * (2 * j + i))));
              acc[4 * j + 2 * i] = __float_as_int(y.x);
              acc[4 * j + 2 * i + 1] = __float_as_int(y.y);
            } else {
              acc[4 * j + 2 * i] =
                  (int)sm::ld_shared(stash + 1024 * (4 * j + 2 * i));
              acc[4 * j + 2 * i + 1] =
                  (int)sm::ld_shared(stash + 1024 * (4 * j + 2 * i + 1));
            }
          }
        codes(n0 - BN);
      }
      // the scales of the segments that start in this tile
      if (f.q == 0) {
#pragma unroll
        for (int k = 0; k < kSlots<BN>; ++k) {
          if (lo[k] == BN && !(kStash && k == 0)) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + f.r0 + 8 * i;
            if (row < M) s[(size_t)(first + k) * M + row] = scale[k][i];
          }
        }
      }
    }
  }
  if (tid == 0) sm::bulk_wait();
}

// ------------------------------------ GEMM + residual + shared LayerNorm ----

// gemm_q8_res_ln's epilogue area: the 128 x BN residual / output tile (T),
// then, where they fit beside two stages, the column scales, gamma, beta
// (f32) and the bias (T), copied once a block; where they do not (f32 at BN
// 256), the epilogue reads them from global memory.
template <int BN, typename T>
constexpr int kLnTileBytes = sm::kBM * BN * (int)sizeof(T);
template <int BN, typename T>
constexpr int kLnParamBytes = BN * (12 + (int)sizeof(T));
template <int BN, typename T>
constexpr bool kLnParamsInSmem =
    sm::kSmemMax - 2048 - kLnTileBytes<BN, T> - kLnParamBytes<BN, T> >=
    2 * (sm::kBM + BN) * sm::kBKS8;
template <int BN, typename T>
constexpr int kLnEpiBytes =
    kLnTileBytes<BN, T> + (kLnParamsInSmem<BN, T> ? kLnParamBytes<BN, T> : 0);

// out[M, N] = LN(res + T(T((f32(a @ w) * sa[row]) * sw[col]) + bias)) *
// gamma + beta for N <= BN: a block tile holds full rows, and a row's
// values sit in the 4 lanes of one quad, so the LayerNorm's statistics are
// register sums and two shfl_xor each. The producer loads the tile's
// residual into the epilogue tile by TMA once its first k-blocks are
// issued; each warpgroup reads its half and overwrites it in place with the
// outputs. With q_out, also the next GEMM's row quantization of out: codes
// q_out [M, N] and scales s_out [M], from the same registers.
template <typename T, int BN>
__global__ void __launch_bounds__(sm::kThreads, 1)
    gemm_q8_res_ln_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_wt,
                          const __grid_constant__ CUtensorMap map_res,
                          const __grid_constant__ CUtensorMap map_out,
                          const float* __restrict__ sa,
                          const float* __restrict__ sw,
                          const T* __restrict__ bias,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          int8_t* __restrict__ q_out,
                          float* __restrict__ s_out, int M, int N, int K,
                          float eps) {
  constexpr int kCols = kBoxCols<T>, kBoxes = BN / kCols;  // a warpgroup's
  extern __shared__ uint8_t smem_raw[];
  sm::RingS8<BN, kLnEpiBytes<BN, T>> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(2);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBKS8 - 1) / sm::kBKS8;
  const int tiles = (M + sm::kBM - 1) / sm::kBM;
  uint32_t epi_phase = 0;

  if (warp == sm::kConsumerWarps) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_wt);
      sm::tma_prefetch(&map_res);
      const int res_after = (nk < ring.kStages ? nk : ring.kStages) - 1;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t * sm::kBM;
        for (int kb = 0; kb < nk; ++kb) {
          ring.load(&map_a, &map_wt, m0, 0, kb);
          if (kb != res_after) continue;
          sm::mbar_wait(ring.epi_empty(), epi_phase ^ 1);
          sm::mbar_expect_tx(ring.epi_full(), kLnTileBytes<BN, T>);
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int c = 0; c < kBoxes; ++c)
              sm::tma_load(ring.epi(g * kBoxes + c), &map_res,
                           ring.epi_full(), kCols * c, m0 + 64 * g);
          epi_phase ^= 1;
        }
      }
    }
    return;
  }

  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ebase = sm::smem_u32(ring.epi(g * kBoxes));
  const float inv_n = 1.f / (float)N;
  // the column scales, gamma, beta and the bias, to shared memory once
  const uint32_t s_sw = sm::smem_u32(ring.epi(2 * kBoxes));
  const uint32_t s_gamma = s_sw + 4 * BN, s_beta = s_gamma + 4 * BN;
  const uint32_t s_bias = s_beta + 4 * BN;
  if constexpr (kLnParamsInSmem<BN, T>) {
    for (int c = threadIdx.x; c < N; c += 256) {
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_sw + 4 * c),
                   "f"(sw[c]) : "memory");
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_gamma + 4 * c),
                   "f"(gamma[c]) : "memory");
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_beta + 4 * c),
                   "f"(beta[c]) : "memory");
      st_shared_t(s_bias + (int)sizeof(T) * c, bias[c]);
    }
    sm::named_sync(3, 256);
  }
  // the pair (col, col + 1) of an f32 per-column vector, kept at s in
  // shared memory, or at v in global memory
  const auto param = [](uint32_t s, const float* v, int col) {
    if constexpr (kLnParamsInSmem<BN, T>) return sm::ld_shared_f2(s + 4 * col);
    else return *reinterpret_cast<const float2*>(v + col);
  };
  using Pair = PairOf<T>;
  const auto bias2 = [s_bias, bias](int col) {
    if constexpr (kLnParamsInSmem<BN, T>)
      return Pair::ld(s_bias + (int)sizeof(T) * col);
    else return Pair::ldg(bias + col);
  };
  const auto box = [ebase](int j) {  // of column 8 j
    return ebase + (8 * j / kCols) * sm::kBoxBytes;
  };

  int acc[BN / 2];  // the s32 products, then the f32 bits of s, then of out
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t * sm::kBM, row0 = m0 + 64 * g;
    float sx[2];  // the row scales, loaded while the mainloop runs
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + f.r0 + 8 * i;
      sx[i] = row < M ? sa[row] : 0.f;
    }
    ring.mma(acc, nk, g);
    sm::mbar_wait(ring.epi_full(), epi_phase);
    epi_phase ^= 1;

    // s = T(res + T(T(dequant) + bias)), in place of acc; row sums
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * f.q;
      if (col < N) {
        const float2 w2 = param(s_sw, sw, col);
        const auto b2 = bias2(col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 s2 = Pair::f32(res_pair(
              acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], sx[i], w2, b2,
              Pair::ld(pair_addr<T>(f, box(j), i, j))));
          acc[4 * j + 2 * i] = __float_as_int(s2.x);
          acc[4 * j + 2 * i + 1] = __float_as_int(s2.y);
          sum[i] += s2.x + s2.y;
        }
      }
    }
    float mean[2], rstd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) mean[i] = quad_sum(sum[i]) * inv_n;
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (8 * j + 2 * f.q < N) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d0 = __int_as_float(acc[4 * j + 2 * i]) - mean[i];
          const float d1 = __int_as_float(acc[4 * j + 2 * i + 1]) - mean[i];
          sq[i] += d0 * d0 + d1 * d1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rstd[i] = rsqrtf(quad_sum(sq[i]) * inv_n + eps);

    // out = T((s - mean) * rstd * gamma + beta), in place of the residual
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * f.q;
      if (col < N) {
        const float2 ga = param(s_gamma, gamma, col);
        const float2 be = param(s_beta, beta, col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const auto o2 = Pair::from(
              (__int_as_float(acc[4 * j + 2 * i]) - mean[i]) * rstd[i] *
                      ga.x + be.x,
              (__int_as_float(acc[4 * j + 2 * i + 1]) - mean[i]) * rstd[i] *
                      ga.y + be.y);
          Pair::st(pair_addr<T>(f, box(j), i, j), o2);
          const float2 o = Pair::f32(o2);  // out as T, for its codes
          acc[4 * j + 2 * i] = __float_as_int(o.x);
          acc[4 * j + 2 * i + 1] = __float_as_int(o.y);
          amax[i] = fmaxf(amax[i], fmaxf(fabsf(o.x), fabsf(o.y)));
        }
      }
    }
    sm::fence_async_smem();
    sm::named_sync(1 + g, 128);
    if (tid == 0) {
      if (row0 < M) {
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          if (kCols * c < N)
            sm::tma_store(&map_out, ebase + c * sm::kBoxBytes, kCols * c,
                          row0);
      }
      sm::bulk_commit();
    }
    if (q_out != nullptr) {  // the next GEMM's row quantization of out
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const RowQuant rq(quad_max(amax[i]));
        const int row = row0 + f.r0 + 8 * i;
        int8_t* dst = q_out + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < BN / 8; j += 4) {
          const uint2 codes = frag_codes(acc, j, i, rq.r, f.q);
          const int col = 8 * (j + f.q);
          if (row < M && col < N)
            *reinterpret_cast<uint2*>(dst + col) = codes;
        }
        if (row < M && f.q == 0) s_out[row] = rq.scale();
      }
    }
    if (tid == 0) {  // the tile is free once the store has read it
      sm::bulk_wait_read();
      sm::mbar_arrive(ring.epi_empty());
    }
  }
  if (tid == 0) sm::bulk_wait();
}

// -------------------------------------------------------------- attention ----
//
// A persistent grid of thread-block clusters, one block a head, two blocks
// an SM: a cluster walks the sequences (cluster c takes c, c + the
// clusters, ...), every block of it the same ones. Thread 0 prefetches the
// next sequence's head slice of the Q, K and V^T codes and its key scales
// (TMA and a bulk copy, one barrier a stage) into the second of two
// shared-memory stages while the block works on the current one, so the
// loads overlap the products and no block waits for its inputs after the
// first. A stage is small enough for two blocks an SM (8 warps, 128
// registers a thread) because Q and K arrive as boxes exactly D bytes wide
// (64- or 32-byte swizzle), V^T as boxes of D rows x 128 keys. A consumer
// warpgroup takes 64 queries a round (128 a round for the block). The
// scores of a 64-key chunk are one m64n64k32 wgmma chain, taken twice (the
// exact two-pass softmax: the row max first, then p = exp2(s - m), l from
// the unquantized p and the codes pq = rint(127 p)): recomputing the
// products costs less than holding 256 scores a row in registers. Each
// chunk's P codes go to shared memory (64 rows x 64 keys, 64-byte swizzle)
// as the A operand of its PV product (m64nDk32 on V^T). The row
// quantization of the output spans every head: each block writes its
// rows' absmax of the T values into every block of its cluster
// (distributed shared memory) and, after the cluster barrier, quantizes
// its own D columns from its own copies.

constexpr int kMaxLk = 256;
constexpr int kChunk = 64;                 // keys a score wgmma
constexpr int kRoundRows = 128;            // queries a round
constexpr int kMaxRounds = 2;              // Lq <= 256
constexpr int kMaxHeads = 8;               // the portable cluster size
constexpr int kAttnThreads = 256;          // two consumer warpgroups

// exp2 on the special-function unit, subnormal results flushed to 0: the
// bits of exp2f wherever its result is normal (a p below 2^-126 has the
// code 0 and adds nothing to l either way).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, completing
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(sm::smem_u32(bar))
      : "memory");
}

// The K-major shared-memory matrix descriptor of rows of kRowBytes (128,
// 64 or 32) under the swizzle of that width (gemm_sm90.cuh's sw128_desc
// for 128): SBO eight rows, LBO unused.
template <int kRowBytes>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  constexpr uint64_t mode = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * kRowBytes >> 4) << 32) | (mode << 62);
}

// Byte offset of (row, byte b) in a tile of 64-byte rows under the 64-byte
// swizzle (tile start 512-byte aligned): the 16-byte chunk XOR (row / 2) %
// 4.
__device__ __forceinline__ uint32_t sw64(int row, int b) {
  return (uint32_t)(row * 64 + ((((b >> 4) ^ (row >> 1)) & 3) << 4) +
                    (b & 15));
}

// attention_q8_kernel's shared memory (from a 1024-byte aligned base): two
// stages, each a sequence's Q (four boxes of 64 rows x D bytes), K (256
// rows x D bytes), V^T (two boxes of D rows x 128 keys) and key scales;
// then each warpgroup's P chunk (64 rows x 64 keys), the rows' absmax of
// the last two exchanges (every head's: 1024 bytes a head), the stages'
// barriers. The launch sizes it by its heads (kBytes(n_heads)): at 4
// heads of 64 two blocks fit an SM.
template <int D>
struct AttnSmem {
  static constexpr int kQBytes = 2 * kMaxRounds * 64 * D;
  static constexpr int kKBytes = kMaxLk * D;
  static constexpr int kVBytes = kMaxLk / 128 * D * 128;
  static constexpr int kSkBytes = kMaxLk * 4;
  static constexpr int kStage = kQBytes + kKBytes + kVBytes + kSkBytes;
  static constexpr int kP = 2 * kStage;
  static constexpr int kPart = kP + 2 * 64 * kChunk;
  __host__ __device__ static constexpr int bars(int n_heads) {
    return kPart + 2 * n_heads * kRoundRows * 4;
  }
  __host__ __device__ static constexpr int bytes(int n_heads) {
    return 1024 + bars(n_heads) + 16;
  }
  static_assert(kStage % 1024 == 0, "1024-byte aligned stages");
};

// codes [n * lq, hid] and scales [n * lq] of out = attention(Q, K, V) of
// each sequence, head h's columns from block h of its cluster; with o, out
// in T too. map_q / map_k: the codes [n * lq | n * lk, hid] (row-strided)
// in boxes of 64 | 256 rows x D bytes (D-byte swizzle); map_vt: V^T codes
// [n * hid, lk_pad] in boxes of D rows x 128 keys (128-byte swizzle).
template <int D, typename T>
__global__ void __launch_bounds__(kAttnThreads, 2)
    attention_q8_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_vt,
                        const float* __restrict__ sq,
                        const float* __restrict__ sk,
                        const float* __restrict__ sv,
                        int8_t* __restrict__ codes,
                        float* __restrict__ scales, T* __restrict__ o,
                        int n_seq, int lq, int lk, int hid, int n_heads,
                        float scale_log2e) {
  using L = AttnSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + L::bars(n_heads));
  const uint32_t part = sm::smem_u32(base + L::kPart);
  const int h = (int)sm::cluster_rank();  // blockIdx.x % n_heads
  const int first_seq = blockIdx.x / n_heads;
  const int n_clusters = gridDim.x / n_heads;
  const int nq = (lq + 63) / 64;           // Q boxes a sequence
  const int n_chunks = (lk + kChunk - 1) / kChunk;
  const int n_vbox = (lk + 127) / 128;
  const int rounds = (lq + kRoundRows - 1) / kRoundRows;
  // thread 0: sequence seq's loads into stage st
  const auto load = [&](int seq, int st) {
    uint8_t* const sb = base + st * L::kStage;
    sm::mbar_expect_tx(full + st, nq * 64 * D + kMaxLk * D +
                                      n_vbox * D * 128 + lk * 4);
    for (int b = 0; b < nq; ++b)
      sm::tma_load(sb + b * 64 * D, &map_q, full + st, h * D,
                   seq * lq + 64 * b);
    sm::tma_load(sb + L::kQBytes, &map_k, full + st, h * D, seq * lk);
    for (int b = 0; b < n_vbox; ++b)
      sm::tma_load(sb + L::kQBytes + L::kKBytes + b * D * 128, &map_vt,
                   full + st, 128 * b, seq * hid + h * D);
    bulk_load(sb + L::kQBytes + L::kKBytes + L::kVBytes,
              sk + (size_t)seq * lk, lk * 4, full + st);
  };
  if (threadIdx.x == 0) {
    sm::mbar_init(full, 1);
    sm::mbar_init(full + 1, 1);
    sm::fence_barrier_init();
    sm::tma_prefetch(&map_q);
    sm::tma_prefetch(&map_k);
    sm::tma_prefetch(&map_vt);
    if (first_seq < n_seq) load(first_seq, 0);
  }
  __syncthreads();

  const int g = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ps = sm::smem_u32(base + L::kP) + g * 64 * kChunk;
  const float neg_inf = __int_as_float(0xff800000u);
  using Pair = PairOf<T>;
  int exchange = 0;  // the cluster exchanges so far: part's parity
  int it = 0;
  for (int seq = first_seq; seq < n_seq; seq += n_clusters, ++it) {
    const int st = it & 1;
    // the next sequence's loads, into the stage the last one left
    if (threadIdx.x == 0 && seq + n_clusters < n_seq)
      load(seq + n_clusters, st ^ 1);
    const uint8_t* const sb = base + st * L::kStage;
    const uint32_t ks = sm::smem_u32(sb + L::kQBytes);
    const uint32_t vs = sm::smem_u32(sb + L::kQBytes + L::kKBytes);
    const float* const sks = reinterpret_cast<const float*>(
        sb + L::kQBytes + L::kKBytes + L::kVBytes);
    const float* const svh = sv + (size_t)seq * hid + h * D;
    sm::mbar_wait(full + st, (it >> 1) & 1);
    for (int r = 0; r < rounds; ++r, ++exchange) {
      const int row0 = r * kRoundRows + 64 * g;  // the warpgroup's first
      const bool active = row0 < lq;             // warpgroup-uniform
      // this round's absmax copies: [head][row of the round]
      const uint32_t xslot = part + 4 * (exchange & 1) * n_heads * kRoundRows;
      int ov[D / 2];  // the s32 PV products, then the f32 bits of out
      if (active) {
        const uint32_t qs = sm::smem_u32(sb) + (2 * r + g) * 64 * D;
        // sq * (scale * log2e), then (f32(s_i) * that) * sk, as the JAX
        // body, each product rounded
        float sqc[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + f.r0 + 8 * i;
          sqc[i] = row < lq
                       ? __fmul_rn(sq[(size_t)seq * lq + row], scale_log2e)
                       : 0.f;
        }
        const auto score = [&](int v, int i, float skv) {
          return __fmul_rn(__fmul_rn((float)v, sqc[i]), skv);
        };
        // chunk c's s32 scores: the warpgroup's 64 queries x 64 keys
        int sc[kChunk / 2];
        const auto scores = [&](int c) {
          sm::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 32; ++kk)
            sm::WgmmaS8<kChunk>::mma(
                sc, kmajor_desc<D>(qs + 32 * kk),
                kmajor_desc<D>(ks + c * kChunk * D + 32 * kk), kk);
          sm::wgmma_commit();
          sm::wgmma_wait<0>();
          sm::fence_regs(sc);
        };
        // pass 1: the exact row max over the keys < lk
        float m[2] = {neg_inf, neg_inf};
        for (int c = 0; c < n_chunks; ++c) {
          scores(c);
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j) {
            const int key = c * kChunk + 8 * j + 2 * f.q;
            const float2 k2 = *reinterpret_cast<const float2*>(sks + key);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (key < lk) m[i] = fmaxf(m[i], score(sc[4 * j + 2 * i], i, k2.x));
              if (key + 1 < lk)
                m[i] = fmaxf(m[i], score(sc[4 * j + 2 * i + 1], i, k2.y));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
        // pass 2: p = exp2(s - m) (padded keys: 0, out of l), l, the P
        // codes of the chunk, its PV product
        float l[2] = {0.f, 0.f};
        for (int c = 0; c < n_chunks; ++c) {
          scores(c);  // its wait also retires the last chunk's PV
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j) {
            const int key = c * kChunk + 8 * j + 2 * f.q;
            const float2 k2 = *reinterpret_cast<const float2*>(sks + key);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float p0 =
                  key < lk
                      ? exp2_ftz(score(sc[4 * j + 2 * i], i, k2.x) - m[i])
                      : 0.f;
              const float p1 =
                  key + 1 < lk
                      ? exp2_ftz(score(sc[4 * j + 2 * i + 1], i, k2.y) - m[i])
                      : 0.f;
              l[i] += p0;
              l[i] += p1;
              const uint32_t pc = code_bytes(p0, p1, 127.f);
              asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                               ps + sw64(f.r0 + 8 * i, 8 * j + 2 * f.q)),
                           "h"((unsigned short)pc)
                           : "memory");
            }
          }
          // the chunk's P codes of the whole warpgroup, to the async proxy
          sm::fence_async_smem();
          sm::named_sync(1 + g, 128);
          sm::fence_regs(ov);
          sm::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 32; ++kk)
            sm::WgmmaS8<D>::mma(
                ov, kmajor_desc<64>(ps + 32 * kk),
                kmajor_desc<128>(vs + (c >> 1) * D * 128 + (c & 1) * 64 +
                                 32 * kk),
                c | kk);
          sm::wgmma_commit();
        }
        sm::wgmma_wait<0>();
        sm::fence_regs(ov);
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
        // out = T((f32(o) * sv) / l); its absmax per row; out in T on
        // request
        float amax[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * f.q;
          const float2 v2 = *reinterpret_cast<const float2*>(svh + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const auto y2 = Pair::from(
                __fmul_rn((float)ov[4 * j + 2 * i], v2.x) / l[i],
                __fmul_rn((float)ov[4 * j + 2 * i + 1], v2.y) / l[i]);
            const float2 y = Pair::f32(y2);
            ov[4 * j + 2 * i] = __float_as_int(y.x);
            ov[4 * j + 2 * i + 1] = __float_as_int(y.y);
            amax[i] = fmaxf(amax[i], fmaxf(fabsf(y.x), fabsf(y.y)));
            const int row = row0 + f.r0 + 8 * i;
            if (o != nullptr && row < lq)
              *reinterpret_cast<typename Pair::type*>(
                  o + ((size_t)seq * lq + row) * hid + h * D + col) = y2;
          }
        }
        // the rows' absmax, into this head's slot of every block's copy
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          amax[i] = quad_max(amax[i]);
          const uint32_t at =
              xslot + 4 * (h * kRoundRows + 64 * g + f.r0 + 8 * i);
#pragma unroll
          for (int rk = 0; rk < kMaxHeads; ++rk)
            if (rk < n_heads && f.q == (rk & 3))
              sm::st_cluster_f32(at, (uint32_t)rk, amax[i]);
        }
      }
      sm::cluster_sync();  // every head's absmax of the round, in place
      if (active) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + f.r0 + 8 * i;
          float a = 0.f;
#pragma unroll
          for (int rk = 0; rk < kMaxHeads; ++rk)
            if (rk < n_heads)
              a = fmaxf(a, sm::ld_shared_f32(
                               xslot + 4 * (rk * kRoundRows + 64 * g +
                                            f.r0 + 8 * i)));
          const RowQuant rq(a);
          int8_t* dst = codes + ((size_t)seq * lq + row) * hid + h * D;
#pragma unroll
          for (int j = 0; j < D / 8; j += 4) {
            const uint2 w = frag_codes(ov, j, i, rq.r, f.q);
            if (row < lq) *reinterpret_cast<uint2*>(dst + 8 * (j + f.q)) = w;
          }
          if (h == 0 && f.q == 0 && row < lq)
            scales[(size_t)seq * lq + row] = rq.scale();
        }
      }
    }
    __syncthreads();  // the stage is free for the loads after the next
  }
}

template <typename T>
int launch_quant_rows(const void* x, long long ld_x, int M, int K, void* q,
                      void* s, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 || K > 8 * 32 * kMaxRowChunks || ld_x % 8 ||
      ld_x < K)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)(((long long)M * 32 + kThreads - 1) / kThreads);
  quant_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, ld_x, M, K, (int8_t*)q, (float*)s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant_cols(const void* x, long long ld_x, int n_seq, int L,
                      int hid, void* vt, void* sv, cudaStream_t stream) {
  if (n_seq <= 0 || L <= 0 || L > kColMaxKeys || hid <= 0 || hid % 8 ||
      ld_x < hid)
    return (int)cudaErrorInvalidValue;
  const int l_pad = (L + 31) / 32 * 32;
  const int stage_bytes = (L * kColTile * (int)sizeof(T) + 1023) / 1024 * 1024;
  const int fit = kColRingBytes / stage_bytes;
  const int stages = fit < 2 ? 2 : fit > kColMaxStages ? kColMaxStages : fit;
  const int smem = stages * stage_bytes + 2 * kColTile * l_pad + 1024;
  CUtensorMap map;
  int e = nylon::ring::encode_rows_of(&map, nylon::ring::tma_type<T>(),
                                      sizeof(T), x, (long long)n_seq * L, hid,
                                      ld_x, L, kColTile);
  const long long items = (long long)n_seq * ((hid + kColTile - 1) / kColTile);
  int grid = 0;
  const auto kernel = quant_cols_kernel<T>;
  if (!e) e = sm::persistent_grid(kernel, smem, items, &grid, kThreads);
  if (e) return e;
  kernel<<<grid, kThreads, smem, stream>>>(map, n_seq, L, l_pad, hid, stages,
                                           stage_bytes, (int8_t*)vt,
                                           (float*)sv);
  return (int)cudaGetLastError();
}

// The tensor map of an activation matrix of T [rows, cols] in boxes of 64
// rows x one 128-byte row (the epilogues' boxes).
template <typename T>
int encode_act(CUtensorMap* map, const void* ptr, long long rows,
               long long cols) {
  return std::is_same<T, float>::value
             ? sm::encode_f32(map, ptr, rows, cols, 64)
             : sm::encode_bf16(map, ptr, rows, cols, 64);
}

// What both GEMM entry points refuse: K a multiple of 16 (a TMA row of K
// bytes) up to kMaxK, N a multiple of 8.
inline bool gemm_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && K % 16 == 0 && K <= kMaxK && N % 8 == 0;
}

// The tile width of gemm_q8_bias's codes epilogue for n_seg segments of
// seg columns: the first of tile_width(N), 256, 192, 128 and 64 that holds
// each segment inside one tile; 0 if none does, or the segments are not
// one or two of a multiple of 32 columns, at least 64
// (ops/layer_fused_q8.py::codes_tile is its twin).
inline int codes_tile(int N, int seg, int n_seg) {
  if (seg < 64 || seg % 32 || n_seg > 2) return 0;
  const int widths[5] = {sm::tile_width(N), 256, 192, 128, 64};
  for (int bn : widths) {
    bool ok = bn >= seg;
    for (int k = 0; ok && k < n_seg; ++k)
      ok = k * seg / bn == ((k + 1) * seg - 1) / bn;
    if (ok) return bn;
  }
  return 0;
}

template <typename T, int BN, bool kStash>
int launch_gemm_bias(const void* a, const void* sa, const void* wt,
                     const void* sw, const void* bias, void* out, void* q,
                     void* s, int M, int N, int K, int relu, int seg,
                     int n_codes, cudaStream_t stream) {
  CUtensorMap ma, mw, mo = {};
  int e = sm::encode_s8(&ma, a, M, K, sm::kBM);
  if (!e) e = sm::encode_s8(&mw, wt, N, K, BN);
  if (!e && n_codes < N) e = encode_act<T>(&mo, out, M, N);
  const int n_tiles_n = (N + BN - 1) / BN;
  const long long units =
      (long long)(kStash ? 1 : n_tiles_n) * ((M + sm::kBM - 1) / sm::kBM);
  const auto kernel = gemm_q8_bias_kernel<T, BN, kStash>;
  constexpr int smem = sm::RingS8<BN, kBiasEpiBytes<BN, T, kStash>>::kBytes;
  int grid = 0;
  if (!e)
    e = sm::persistent_grid(kernel, smem, units, &grid, sm::kThreadsTf32);
  if (e) return e;
  kernel<<<grid, sm::kThreadsTf32, smem, stream>>>(
      ma, mw, mo, (const float*)sa, (const float*)sw, (const T*)bias,
      (int8_t*)q, (float*)s, M, N, K, relu, n_tiles_n, seg > 0 ? seg : N,
      n_codes);
  return (int)cudaGetLastError();
}

// gemm_q8_bias with q null: out [M, N] in T. With q: the codes of the first
// n_seg segments of seg columns to q [M, n_seg seg] and their scales to s
// [n_seg, M]; the other columns to out [M, N], which is null when the
// segments cover the row.
template <typename T>
int gemm_bias(const void* a, const void* sa, const void* wt, const void* sw,
              const void* bias, void* out, void* q, void* s, int M, int N,
              int K, int relu, int seg, int n_seg, cudaStream_t stream) {
  if (!gemm_shape_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  int bn = sm::tile_width(N), n_codes = 0;
  if (q != nullptr) {
    n_codes = seg * n_seg;
    if (s == nullptr || seg <= 0 || n_seg <= 0 || n_codes > N ||
        (out == nullptr) != (n_codes == N))
      return (int)cudaErrorInvalidValue;
    if (out == nullptr && n_seg == 1 && N > 256 && N <= 512)
      return launch_gemm_bias<T, 256, true>(a, sa, wt, sw, bias, out, q, s, M,
                                            N, K, relu, seg, n_codes, stream);
    bn = codes_tile(N, seg, n_seg);
  } else if (out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  switch (bn) {
    case 64:
      return launch_gemm_bias<T, 64, false>(a, sa, wt, sw, bias, out, q, s, M,
                                            N, K, relu, seg, n_codes, stream);
    case 128:
      return launch_gemm_bias<T, 128, false>(a, sa, wt, sw, bias, out, q, s,
                                             M, N, K, relu, seg, n_codes,
                                             stream);
    case 192:
      return launch_gemm_bias<T, 192, false>(a, sa, wt, sw, bias, out, q, s,
                                             M, N, K, relu, seg, n_codes,
                                             stream);
    case 256:
      return launch_gemm_bias<T, 256, false>(a, sa, wt, sw, bias, out, q, s,
                                             M, N, K, relu, seg, n_codes,
                                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int BN>
int launch_gemm_res_ln(const void* a, const void* sa, const void* wt,
                       const void* sw, const void* bias, const void* res,
                       const void* gamma, const void* beta, void* out,
                       void* q_out, void* s_out, int M, int N, int K,
                       float eps, cudaStream_t stream) {
  CUtensorMap ma, mw, mr, mo;
  int e = sm::encode_s8(&ma, a, M, K, sm::kBM);
  if (!e) e = sm::encode_s8(&mw, wt, N, K, BN);
  if (!e) e = encode_act<T>(&mr, res, M, N);
  if (!e) e = encode_act<T>(&mo, out, M, N);
  const auto kernel = gemm_q8_res_ln_kernel<T, BN>;
  constexpr int smem = sm::RingS8<BN, kLnEpiBytes<BN, T>>::kBytes;
  int grid = 0;
  if (!e)
    e = sm::persistent_grid(kernel, smem, (M + sm::kBM - 1) / sm::kBM, &grid);
  if (e) return e;
  kernel<<<grid, sm::kThreads, smem, stream>>>(
      ma, mw, mr, mo, (const float*)sa, (const float*)sw, (const T*)bias,
      (const float*)gamma, (const float*)beta, (int8_t*)q_out,
      (float*)s_out, M, N, K, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int gemm_res_ln(const void* a, const void* sa, const void* wt, const void* sw,
                const void* bias, const void* res, const void* gamma,
                const void* beta, void* out, void* q_out, void* s_out, int M,
                int N, int K, float eps, cudaStream_t stream) {
  if (!gemm_shape_ok(M, N, K) || N > kLnMaxN ||
      (q_out == nullptr) != (s_out == nullptr))
    return (int)cudaErrorInvalidValue;
  switch ((N + 63) / 64) {
    case 1:
      return launch_gemm_res_ln<T, 64>(a, sa, wt, sw, bias, res, gamma, beta,
                                       out, q_out, s_out, M, N, K, eps,
                                       stream);
    case 2:
      return launch_gemm_res_ln<T, 128>(a, sa, wt, sw, bias, res, gamma,
                                        beta, out, q_out, s_out, M, N, K, eps,
                                        stream);
    case 3:
      return launch_gemm_res_ln<T, 192>(a, sa, wt, sw, bias, res, gamma,
                                        beta, out, q_out, s_out, M, N, K, eps,
                                        stream);
    default:
      return launch_gemm_res_ln<T, 256>(a, sa, wt, sw, bias, res, gamma,
                                        beta, out, q_out, s_out, M, N, K, eps,
                                        stream);
  }
}

template <int D, typename T>
int launch_attention_d(const void* q, long long q_row, const void* sq,
                       const void* k, long long k_row, const void* sk,
                       const void* vt, int vt_ld, const void* sv, void* codes,
                       void* scales, void* o, int n_seq, int lq, int lk,
                       int n_heads, float scale_log2e, cudaStream_t stream) {
  const int hid = n_heads * D;
  CUtensorMap mq, mk, mv;
  constexpr auto kS8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int e = sm::encode_swizzled(&mq, kS8, 1, q, (long long)n_seq * lq, hid,
                              q_row, 64, D);
  if (!e)
    e = sm::encode_swizzled(&mk, kS8, 1, k, (long long)n_seq * lk, hid,
                            k_row, kMaxLk, D);
  if (!e) e = sm::encode_s8(&mv, vt, (long long)n_seq * hid, vt_ld, D);
  if (e) return e;
  const auto kernel = attention_q8_kernel<D, T>;
  const int smem = AttnSmem<D>::bytes(n_heads);
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AttnSmem<D>::bytes(kMaxHeads));
  if (ce != cudaSuccess) return (int)ce;
  // a persistent grid of clusters of n_heads blocks: as many as the card
  // holds at once, at most one a sequence
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kAttnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_heads;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((unsigned)n_heads);
  int clusters = 0;
  ce = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (ce != cudaSuccess) return (int)ce;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (clusters > n_seq) clusters = n_seq;
  cfg.gridDim = dim3((unsigned)(clusters * n_heads));
  ce = cudaLaunchKernelEx(&cfg, kernel, mq, mk, mv, (const float*)sq,
                          (const float*)sk, (const float*)sv, (int8_t*)codes,
                          (float*)scales, (T*)o, n_seq, lq, lk, hid, n_heads,
                          scale_log2e);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attention(const void* q, long long q_row, const void* sq,
                     const void* k, long long k_row, const void* sk,
                     const void* vt, int vt_ld, const void* sv, void* codes,
                     void* scales, void* o, int n_seq, int lq, int lk,
                     int n_heads, int head_dim, float scale_log2e,
                     cudaStream_t stream) {
  if ((head_dim != 32 && head_dim != 64) || n_seq <= 0 || lq <= 0 ||
      lq > kMaxRounds * kRoundRows || lk <= 0 || lk > kMaxLk ||
      n_heads <= 0 || n_heads > kMaxHeads ||
      (long long)n_seq * n_heads > 0x7fffffffll ||
      vt_ld != (lk + 31) / 32 * 32 || q_row % 16 || k_row % 16 ||
      lk % 4 || codes == nullptr || scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return head_dim == 32
             ? launch_attention_d<32, T>(q, q_row, sq, k, k_row, sk, vt,
                                         vt_ld, sv, codes, scales, o, n_seq,
                                         lq, lk, n_heads, scale_log2e, stream)
             : launch_attention_d<64, T>(q, q_row, sq, k, k_row, sk, vt,
                                         vt_ld, sv, codes, scales, o, n_seq,
                                         lq, lk, n_heads, scale_log2e, stream);
}

}  // namespace

// Each entry point takes bf16 activations (and writes bf16); its _f32 twin
// takes and writes f32 (the float32 compute dtype). The GEMMs take the
// weight codes as W^T [N, K] (wt).
#define NYLON_Q8_ENTRY(name, T)                                                \
  int nylon_q8_quant_rows##name(const void* x, long long ld_x, int M, int K,  \
                                void* q, void* s, void* stream) {             \
    return launch_quant_rows<T>(x, ld_x, M, K, q, s, (cudaStream_t)stream);   \
  }                                                                           \
  int nylon_q8_quant_cols##name(const void* x, long long ld_x, int n_seq,     \
                                int L, int hid, void* vt, void* sv,           \
                                void* stream) {                               \
    return launch_quant_cols<T>(x, ld_x, n_seq, L, hid, vt, sv,               \
                                (cudaStream_t)stream);                        \
  }                                                                           \
  int nylon_q8_gemm_bias##name(const void* a, const void* sa, const void* wt, \
                               const void* sw, const void* bias, void* out,   \
                               void* q, void* s, int M, int N, int K,         \
                               int relu, int seg, int n_seg, void* stream) {  \
    return gemm_bias<T>(a, sa, wt, sw, bias, out, q, s, M, N, K, relu, seg,   \
                        n_seg, (cudaStream_t)stream);                         \
  }                                                                           \
  int nylon_q8_gemm_res_ln##name(                                             \
      const void* a, const void* sa, const void* wt, const void* sw,          \
      const void* bias, const void* res, const void* gamma, const void* beta, \
      void* out, void* q_out, void* s_out, int M, int N, int K, float eps,    \
      void* stream) {                                                         \
    return gemm_res_ln<T>(a, sa, wt, sw, bias, res, gamma, beta, out, q_out,  \
                          s_out, M, N, K, eps, (cudaStream_t)stream);         \
  }                                                                           \
  int nylon_q8_attention##name(                                               \
      const void* q, long long q_row, const void* sq, const void* k,          \
      long long k_row, const void* sk, const void* vt, int vt_ld,             \
      const void* sv, void* codes, void* scales, void* o, int n_seq, int lq,  \
      int lk, int n_heads, int head_dim, float scale_log2e, void* stream) {   \
    return launch_attention<T>(q, q_row, sq, k, k_row, sk, vt, vt_ld, sv,     \
                               codes, scales, o, n_seq, lq, lk, n_heads,      \
                               head_dim, scale_log2e, (cudaStream_t)stream);  \
  }

extern "C" {
NYLON_Q8_ENTRY(, bf16)
NYLON_Q8_ENTRY(_f32, float)
}  // extern "C"
