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
//    warp per row segment);
//  * quant_cols_kernel: V's quantizer, one scale per column over the whole
//    key sequence; it writes the codes transposed per sequence, [hid,
//    Lk_pad] with zero codes past Lk, which is the operand layout the PV
//    product needs;
//  * gemm_q8_bias_kernel: out = T((f32(A @ W) * sa[row]) * sw[col]) +
//    bias [, ReLU], an s8 x s8 -> s32 tensor-core GEMM (wgmma m64nNk32 fed
//    by TMA: gemm_sm90.cuh's s8 mainloop) with a dequantizing epilogue;
//  * gemm_q8_res_ln_kernel: the same GEMM with a block that owns full rows,
//    so the residual and the shared post-LayerNorm run in its epilogue on
//    the accumulator fragments, and optionally the row quantization of its
//    output for the next GEMM;
//  * attention_q8_kernel: one block per (sequence, head, 128-query tile),
//    int8 K and V^T of the whole sequence in shared memory, int8 QK^T and
//    PV products, an exact two-pass softmax in f32; head_dim D = 64 (two
//    k32 steps of the score product) or 32 (one), the K rows padded to D +
//    16 bytes either way.
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

using nylon::bf16;
namespace sm = nylon::sm90;
using sm::Frag;

namespace {

constexpr int kThreads = 256;  // 8 warps: the quantizers and attention
constexpr int kMaxK = 1040;    // the GEMMs' depth: |sum| <= K 127^2 < 2^24
constexpr int kLnMaxN = 256;   // gemm_q8_res_ln: a block owns full rows
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kInv127Sq = (float)(1.0 / (127.0 * 127.0));
constexpr float kAbsFloor = 1e-12f;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The int8 code of x for the reciprocal scale r = 127 / a (round half to
// even; |x * r| <= 127 up to rounding, so the cast cannot overflow).
__device__ __forceinline__ int8_t quant_code(float x, float r) {
  return (int8_t)(int)rintf(x * r);
}

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

// Two consecutive elements in one store.
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  __nv_bfloat162 o;
  o.x = __float2bfloat16(a);
  o.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(dst) = o;
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// ------------------------------------------------------------ quantizers ----

constexpr int kMaxRowChunks = 4;  // 8 elements per chunk per lane: K <= 1024

// Row r, segment j: x[r, j*K : (j+1)*K] -> q[r, j*K : (j+1)*K], s[j, r].
// One warp per (row, segment); the row stays in registers. T: bf16 or f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_rows_kernel(const T* __restrict__ x, long long ld_x, int M,
                      int K, int n_seg, int8_t* __restrict__ q,
                      float* __restrict__ s) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= M * n_seg) return;  // warp-uniform
  const int row = warp / n_seg, seg = warp % n_seg;
  const T* src = x + (size_t)row * ld_x + (size_t)seg * K;
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
  const float a = fmaxf(warp_max(amax), kAbsFloor);
  const float r = 127.f / a;  // IEEE division (no fast math)
  int8_t* dst = q + (size_t)row * n_seg * K + (size_t)seg * K;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      uint2 packed;
      int8_t* o = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) o[t] = quant_code(v[i][t], r);
      *reinterpret_cast<uint2*>(dst + c * 8) = packed;
    }
  }
  if (lane == 0) s[(size_t)seg * M + row] = a * kInv127;
}

constexpr int kColTile = 64;   // columns per block
constexpr int kRowTile = 32;   // key rows per transposed store

// V of sequence `seq`: x[seq*L + j, col] -> vt[seq, col, j] (j < L_pad,
// zero codes past L) and sv[seq, col] = max(absmax_j, 1e-12) / 127^2.
// Block per (sequence, 64 columns); thread (c = tid % 64, g = tid / 64).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_cols_kernel(const T* __restrict__ x, long long ld_x, int L,
                      int hid, int8_t* __restrict__ vt,
                      float* __restrict__ sv) {
  __shared__ float part[4][kColTile];
  __shared__ __align__(16) int8_t tile[kColTile][kRowTile + 16];
  const int seq = blockIdx.x, col0 = blockIdx.y * kColTile;
  const int c = threadIdx.x % kColTile, g = threadIdx.x / kColTile;
  const int l_pad = (L + kRowTile - 1) / kRowTile * kRowTile;
  const T* base = x + (size_t)seq * L * ld_x + col0 + c;
  float amax = 0.f;
  for (int j = g; j < L; j += 4)
    amax = fmaxf(amax, fabsf(nylon::to_f(base[(size_t)j * ld_x])));
  part[g][c] = amax;
  __syncthreads();
  const float a = fmaxf(fmaxf(fmaxf(part[0][c], part[1][c]), part[2][c]),
                        part[3][c]);
  const float r = 127.f / a;
  if (g == 0) sv[(size_t)seq * hid + col0 + c] = a * kInv127Sq;
  int8_t* out = vt + ((size_t)seq * hid + col0) * l_pad;
  for (int j0 = 0; j0 < l_pad; j0 += kRowTile) {
    // thread (c, g) quantizes rows j0 + 8g .. j0 + 8g + 7 of column c
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int j = j0 + 8 * g + t;
      tile[c][8 * g + t] =
          j < L ? quant_code(nylon::to_f(base[(size_t)j * ld_x]), r)
                : (int8_t)0;
    }
    __syncthreads();
    // 64 columns x 32 bytes out, 8 bytes per thread, contiguous per column
    const int oc = threadIdx.x / 4, part8 = (threadIdx.x % 4) * 8;
    *reinterpret_cast<uint2*>(out + (size_t)oc * l_pad + j0 + part8) =
        *reinterpret_cast<const uint2*>(&tile[oc][part8]);
    __syncthreads();
  }
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
// scale r, as the low 16 bits (column col in the low byte).
__device__ __forceinline__ uint32_t code_pair(int a0, int a1, float r) {
  return (uint32_t)(uint8_t)quant_code(__int_as_float(a0), r) |
         (uint32_t)(uint8_t)quant_code(__int_as_float(a1), r) << 8;
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

// ------------------------------------------------------- GEMM + bias ----

// gemm_q8_bias's epilogue area: a ring of two output boxes a warpgroup,
// then each warpgroup's copy of the tile's column scales (f32) and bias
// (T), BN of each.
template <int BN, typename T>
constexpr int kBiasEpiBytes =
    2 * 2 * sm::kBoxBytes + 2 * BN * (4 + (int)sizeof(T));

// out[M, N] = T(T((f32(a @ w) * sa[row]) * sw[col]) + bias[col]) [, ReLU]
// with a [M, K] and W^T [N, K] int8. Tile t is (row block t / n_tiles_n,
// column block t % n_tiles_n): the N tiles of a row block run together, so
// A is read from HBM once and its other reads hit L2.
template <typename T, int BN>
__global__ void __launch_bounds__(sm::kThreads, 1)
    gemm_q8_bias_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_wt,
                        const __grid_constant__ CUtensorMap map_out,
                        const float* __restrict__ sa,
                        const float* __restrict__ sw,
                        const T* __restrict__ bias, int M, int N, int K,
                        int relu, int n_tiles_n) {
  constexpr int kCols = kBoxCols<T>;
  extern __shared__ uint8_t smem_raw[];
  sm::RingS8<BN, kBiasEpiBytes<BN, T>> ring(smem_raw);
  if (threadIdx.x == 0) ring.init(1);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int nk = (K + sm::kBKS8 - 1) / sm::kBKS8;
  const long long tiles =
      (long long)n_tiles_n * ((M + sm::kBM - 1) / sm::kBM);

  if (warp == sm::kConsumerWarps) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      sm::tma_prefetch(&map_a);
      sm::tma_prefetch(&map_wt);
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (int)(t / n_tiles_n) * sm::kBM;
        const int n0 = (int)(t % n_tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) ring.load(&map_a, &map_wt, m0, n0, kb);
      }
    }
    return;
  }

  const int g = warp >> 2, tid = threadIdx.x & 127;
  const Frag f(tid);
  const uint32_t ebase = sm::smem_u32(ring.epi(2 * g));
  const uint32_t s_sw =
      sm::smem_u32(ring.epi(4)) + g * BN * (4 + (int)sizeof(T));
  const uint32_t s_bias = s_sw + 4 * BN;
  using Pair = PairOf<T>;
  constexpr int kJ = kCols / 8;  // column fragments a box
  uint32_t staged = 0;  // boxes this warpgroup has staged: ring slot parity
  int acc[BN / 2];
  constexpr int kPer = (BN + 127) / 128;  // columns a thread stages
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
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
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + 128 * u;
      if (c < BN && n0 + c < N) {
        swv[u] = sw[n0 + c];
        bv[u] = bias[n0 + c];
      }
    }
    ring.mma(acc, nk, g);
    // the column values to shared memory (the previous tile's last reads
    // of them precede its last box sync)
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + 128 * u;
      if (c < BN && n0 + c < N) {
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_sw + 4 * c),
                     "f"(swv[u])
                     : "memory");
        st_shared_t(s_bias + (int)sizeof(T) * c, bv[u]);
      }
    }
    // a box of kJ fragments at a time, through the ring of two
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j / kJ;
      const uint32_t box = ebase + ((staged + c) & 1) * sm::kBoxBytes;
      if (j % kJ == 0) {
        // the slot is free once every store group but the newest (the
        // other slot's: one group a box, empty if the box is not stored)
        // has read its box
        if (tid == 0) sm::bulk_wait_read<1>();
        sm::named_sync(1 + g, 128);
      }
      const int col = 8 * j + 2 * f.q;  // of the tile
      if (n0 + col < N) {
        const float2 w2 = sm::ld_shared_f2(s_sw + 4 * col);
        const auto b2 = Pair::ld(s_bias + (int)sizeof(T) * col);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          Pair::st(pair_addr<T>(f, box, i, j),
                   bias_pair(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1],
                             sx[i], w2, b2, relu));
      }
      if (j % kJ == kJ - 1) {
        sm::fence_async_smem();
        sm::named_sync(1 + g, 128);
        if (tid == 0) {
          if (row0 < M && n0 + c * kCols < N)
            sm::tma_store(&map_out, box, n0 + c * kCols, row0);
          sm::bulk_commit();
        }
      }
    }
    staged += BN / kCols;
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
        const float qa = fmaxf(quad_max(amax[i]), kAbsFloor);
        const float qr = 127.f / qa;  // IEEE division (no fast math)
        const int row = row0 + f.r0 + 8 * i;
        int8_t* dst = q_out + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < BN / 8; j += 4) {
          uint32_t w[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int a = 4 * (j + 2 * h) + 2 * i;  // fragments j + 2 h, + 1
            w[h] = code_pair(acc[a], acc[a + 1], qr) |
                   code_pair(acc[a + 4], acc[a + 5], qr) << 16;
          }
          const uint2 codes = quad_gather(w[0], w[1], f.q);
          const int col = 8 * (j + f.q);
          if (row < M && col < N)
            *reinterpret_cast<uint2*>(dst + col) = codes;
        }
        if (row < M && f.q == 0) s_out[row] = qa * kInv127;
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

constexpr int kAttnRows = 128;  // queries per block: 16 per warp
constexpr int kMaxLk = 256;
constexpr int kPLd = 32 + 16;   // per-warp int8 probability tile row

// K code rows of head_dim D padded by 16 bytes: 20 (D = 64) or 12 (D = 32)
// words, so the fragment loads of 8 rows x 4 lanes hit 32 distinct banks.
template <int D>
constexpr int kKLd = D + 16;

template <int D>
__host__ __device__ constexpr size_t attn_q8_smem(int lk_pad) {
  return (size_t)lk_pad * kKLd<D>             // K codes [lk_pad][D + 16]
         + (size_t)D * (lk_pad + 16)          // V^T codes [D][lk_pad + 16]
         + (size_t)lk_pad * sizeof(float)     // key scales
         + (size_t)(kThreads / 32) * 16 * kPLd;
}

// o[seq, i, h*D : (h+1)*D] for one (sequence, head, query tile), D = 32 or
// 64, in T (bf16 or f32). Q codes go straight from device memory into the
// warp's A fragments (D / 32 k-steps of m16n8k32); K codes [lk_pad][D] and
// V^T codes [D][lk_pad] of the whole sequence sit in shared memory. Each
// warp owns 16 query rows and walks the keys in 32-key chunks twice: first
// for the exact row max of the dequantized scores, then recomputing each
// chunk (the same MMAs, so the same values) to take p = exp2(s - m), sum l
// from the unquantized p, and accumulate the int8 product of pq = rint(127
// p) with V.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    attention_q8_kernel(const int8_t* __restrict__ q, long long q_row,
                        const float* __restrict__ sq,
                        const int8_t* __restrict__ k, long long k_row,
                        const float* __restrict__ sk,
                        const int8_t* __restrict__ vt, int vt_ld,
                        const float* __restrict__ sv, T* __restrict__ o,
                        int lq, int lk, int hid, float scale_log2e) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int KLD = kKLd<D>;
  constexpr int KS = D / 32;  // k-steps of the score product
  const int lk_pad = vt_ld;  // a multiple of 32
  const int vs_ld = lk_pad + 16;
  uint8_t* const Ks = smem;
  uint8_t* const Vs = Ks + lk_pad * KLD;
  float* const sks = reinterpret_cast<float*>(Vs + D * vs_ld);
  uint8_t* const Ps = reinterpret_cast<uint8_t*>(sks + lk_pad);

  const int seq = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kAttnRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  const int8_t* kb = k + (size_t)seq * lk * k_row + h * D;
  for (int c = threadIdx.x; c < lk_pad * (D / 16); c += kThreads) {
    const int r = c / (D / 16), c16 = (c % (D / 16)) * 16;
    const uint4 v = r < lk ? *reinterpret_cast<const uint4*>(
                                 kb + (size_t)r * k_row + c16)
                           : zero;
    *reinterpret_cast<uint4*>(Ks + r * KLD + c16) = v;
  }
  const int8_t* vb = vt + ((size_t)seq * hid + h * D) * lk_pad;
  for (int c = threadIdx.x; c < D * (lk_pad / 16); c += kThreads) {
    const int r = c / (lk_pad / 16), c16 = (c % (lk_pad / 16)) * 16;
    *reinterpret_cast<uint4*>(Vs + r * vs_ld + c16) =
        *reinterpret_cast<const uint4*>(vb + (size_t)r * lk_pad + c16);
  }
  for (int j = threadIdx.x; j < lk_pad; j += kThreads)
    sks[j] = j < lk ? sk[(size_t)seq * lk + j] : 0.f;
  __syncthreads();
  // From here on every warp works alone: no block-wide barrier follows.
  if (q0 + warp * 16 >= lq) return;

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const bool ok_a = row_a < lq, ok_b = row_b < lq;
  uint32_t qa[KS][4];
  {
    const int8_t* pa = q + ((size_t)seq * lq + row_a) * q_row + h * D;
    const int8_t* pb = q + ((size_t)seq * lq + row_b) * q_row + h * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 32 + t * 4;
      qa[ks][0] = ok_a ? *reinterpret_cast<const uint32_t*>(pa + c) : 0u;
      qa[ks][1] = ok_b ? *reinterpret_cast<const uint32_t*>(pb + c) : 0u;
      qa[ks][2] = ok_a ? *reinterpret_cast<const uint32_t*>(pa + c + 16) : 0u;
      qa[ks][3] = ok_b ? *reinterpret_cast<const uint32_t*>(pb + c + 16) : 0u;
    }
  }
  // sq * (scale * log2e), then (f32(s_i) * that) * sk, as the JAX body
  const float sqc_a = ok_a ? sq[(size_t)seq * lq + row_a] * scale_log2e : 0.f;
  const float sqc_b = ok_b ? sq[(size_t)seq * lq + row_b] * scale_log2e : 0.f;

  // s32 scores of the 16 x 32 chunk at keys j0.. in acc[n8 tile][4]
  auto scores = [&](int j0, int (&acc)[4][4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
      const uint8_t* kp = Ks + (j0 + nt * 8 + g) * KLD + t * 4;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_s8(acc[nt], qa[ks], lds32(kp + ks * 32), lds32(kp + ks * 32 + 16));
    }
  };

  const float neg_inf = __int_as_float(0xff800000u);
  float m_a = neg_inf, m_b = neg_inf;
  for (int j0 = 0; j0 < lk_pad; j0 += 32) {
    int acc[4][4];
    scores(j0, acc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j0 + nt * 8 + t * 2 + e;
        if (key < lk) {
          m_a = fmaxf(m_a, (float)acc[nt][e] * sqc_a * sks[key]);
          m_b = fmaxf(m_b, (float)acc[nt][2 + e] * sqc_b * sks[key]);
        }
      }
  }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, o2));
    m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, o2));
  }

  uint8_t* const Pw = Ps + warp * 16 * kPLd;
  float l_a = 0.f, l_b = 0.f;
  int oacc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0;
  for (int j0 = 0; j0 < lk_pad; j0 += 32) {
    int acc[4][4];
    scores(j0, acc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j0 + nt * 8 + t * 2 + e;
        float pa = 0.f, pb = 0.f;  // padded keys: out of l, zero codes
        if (key < lk) {
          pa = exp2f((float)acc[nt][e] * sqc_a * sks[key] - m_a);
          pb = exp2f((float)acc[nt][2 + e] * sqc_b * sks[key] - m_b);
        }
        l_a += pa;
        l_b += pb;
        Pw[g * kPLd + nt * 8 + t * 2 + e] = (uint8_t)quant_code(pa, 127.f);
        Pw[(g + 8) * kPLd + nt * 8 + t * 2 + e] =
            (uint8_t)quant_code(pb, 127.f);
      }
    __syncwarp();
    uint32_t pf[4];
    pf[0] = lds32(Pw + g * kPLd + t * 4);
    pf[1] = lds32(Pw + (g + 8) * kPLd + t * 4);
    pf[2] = lds32(Pw + g * kPLd + 16 + t * 4);
    pf[3] = lds32(Pw + (g + 8) * kPLd + 16 + t * 4);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const uint8_t* vp = Vs + (dt * 8 + g) * vs_ld + j0 + t * 4;
      mma_s8(oacc[dt], pf, lds32(vp), lds32(vp + 16));
    }
    __syncwarp();
  }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }

  const float* svh = sv + (size_t)seq * hid + h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    const float v0 = svh[c], v1 = svh[c + 1];
    if (ok_a)
      store2(o + ((size_t)seq * lq + row_a) * hid + h * D + c,
             (float)oacc[dt][0] * v0 / l_a, (float)oacc[dt][1] * v1 / l_a);
    if (ok_b)
      store2(o + ((size_t)seq * lq + row_b) * hid + h * D + c,
             (float)oacc[dt][2] * v0 / l_b, (float)oacc[dt][3] * v1 / l_b);
  }
}


template <typename T>
int launch_quant_rows(const void* x, long long ld_x, int M, int K, int n_seg,
                      void* q, void* s, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 || K > 8 * 32 * kMaxRowChunks || n_seg <= 0 ||
      ld_x % 8 || ld_x < (long long)n_seg * K)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)M * n_seg;
  const unsigned blocks = (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  quant_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, ld_x, M, K, n_seg, (int8_t*)q, (float*)s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant_cols(const void* x, long long ld_x, int n_seq, int L,
                      int hid, void* vt, void* sv, cudaStream_t stream) {
  if (n_seq <= 0 || L <= 0 || hid <= 0 || hid % kColTile || ld_x < hid)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_seq, hid / kColTile);
  quant_cols_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, ld_x, L, hid, (int8_t*)vt, (float*)sv);
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

template <typename T, int BN>
int launch_gemm_bias(const void* a, const void* sa, const void* wt,
                     const void* sw, const void* bias, void* out, int M,
                     int N, int K, int relu, cudaStream_t stream) {
  CUtensorMap ma, mw, mo;
  int e = sm::encode_s8(&ma, a, M, K, sm::kBM);
  if (!e) e = sm::encode_s8(&mw, wt, N, K, BN);
  if (!e) e = encode_act<T>(&mo, out, M, N);
  const int n_tiles_n = (N + BN - 1) / BN;
  const long long tiles =
      (long long)n_tiles_n * ((M + sm::kBM - 1) / sm::kBM);
  const auto kernel = gemm_q8_bias_kernel<T, BN>;
  constexpr int smem = sm::RingS8<BN, kBiasEpiBytes<BN, T>>::kBytes;
  int grid = 0;
  if (!e) e = sm::persistent_grid(kernel, smem, tiles, &grid);
  if (e) return e;
  kernel<<<grid, sm::kThreads, smem, stream>>>(
      ma, mw, mo, (const float*)sa, (const float*)sw, (const T*)bias, M, N,
      K, relu, n_tiles_n);
  return (int)cudaGetLastError();
}

template <typename T>
int gemm_bias(const void* a, const void* sa, const void* wt, const void* sw,
              const void* bias, void* out, int M, int N, int K, int relu,
              cudaStream_t stream) {
  if (!gemm_shape_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  switch (sm::tile_width(N)) {
    case 64:
      return launch_gemm_bias<T, 64>(a, sa, wt, sw, bias, out, M, N, K, relu,
                                     stream);
    case 128:
      return launch_gemm_bias<T, 128>(a, sa, wt, sw, bias, out, M, N, K,
                                      relu, stream);
    case 192:
      return launch_gemm_bias<T, 192>(a, sa, wt, sw, bias, out, M, N, K,
                                      relu, stream);
    default:
      return launch_gemm_bias<T, 256>(a, sa, wt, sw, bias, out, M, N, K,
                                      relu, stream);
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
                       const void* vt, int vt_ld, const void* sv, void* o,
                       int n_seq, int lq, int lk, int n_heads,
                       float scale_log2e, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      attention_q8_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_q8_smem<D>(kMaxLk));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_seq, n_heads, (lq + kAttnRows - 1) / kAttnRows);
  attention_q8_kernel<D, T><<<grid, kThreads, attn_q8_smem<D>(vt_ld),
                              stream>>>(
      (const int8_t*)q, q_row, (const float*)sq, (const int8_t*)k, k_row,
      (const float*)sk, (const int8_t*)vt, vt_ld, (const float*)sv, (T*)o,
      lq, lk, n_heads * D, scale_log2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attention(const void* q, long long q_row, const void* sq,
                     const void* k, long long k_row, const void* sk,
                     const void* vt, int vt_ld, const void* sv, void* o,
                     int n_seq, int lq, int lk, int n_heads, int head_dim,
                     float scale_log2e, cudaStream_t stream) {
  if ((head_dim != 32 && head_dim != 64) || n_seq <= 0 || lq <= 0 ||
      lk <= 0 || lk > kMaxLk || n_heads <= 0 || n_heads > 65535 ||
      vt_ld != (lk + 31) / 32 * 32 || q_row % 16 || k_row % 16)
    return (int)cudaErrorInvalidValue;
  return head_dim == 32
             ? launch_attention_d<32, T>(q, q_row, sq, k, k_row, sk, vt,
                                         vt_ld, sv, o, n_seq, lq, lk, n_heads,
                                         scale_log2e, stream)
             : launch_attention_d<64, T>(q, q_row, sq, k, k_row, sk, vt,
                                         vt_ld, sv, o, n_seq, lq, lk, n_heads,
                                         scale_log2e, stream);
}

}  // namespace

// Each entry point takes bf16 activations (and writes bf16); its _f32 twin
// takes and writes f32 (the float32 compute dtype). The GEMMs take the
// weight codes as W^T [N, K] (wt).
#define NYLON_Q8_ENTRY(name, T)                                                \
  int nylon_q8_quant_rows##name(const void* x, long long ld_x, int M, int K,  \
                                int n_seg, void* q, void* s, void* stream) {  \
    return launch_quant_rows<T>(x, ld_x, M, K, n_seg, q, s,                   \
                                (cudaStream_t)stream);                        \
  }                                                                           \
  int nylon_q8_quant_cols##name(const void* x, long long ld_x, int n_seq,     \
                                int L, int hid, void* vt, void* sv,           \
                                void* stream) {                               \
    return launch_quant_cols<T>(x, ld_x, n_seq, L, hid, vt, sv,               \
                                (cudaStream_t)stream);                        \
  }                                                                           \
  int nylon_q8_gemm_bias##name(const void* a, const void* sa, const void* wt, \
                               const void* sw, const void* bias, void* out,   \
                               int M, int N, int K, int relu, void* stream) { \
    return gemm_bias<T>(a, sa, wt, sw, bias, out, M, N, K, relu,              \
                        (cudaStream_t)stream);                                \
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
      const void* sv, void* o, int n_seq, int lq, int lk, int n_heads,        \
      int head_dim, float scale_log2e, void* stream) {                        \
    return launch_attention<T>(q, q_row, sq, k, k_row, sk, vt, vt_ld, sv, o,  \
                               n_seq, lq, lk, n_heads, head_dim, scale_log2e, \
                               (cudaStream_t)stream);                         \
  }

extern "C" {
NYLON_Q8_ENTRY(, bf16)
NYLON_Q8_ENTRY(_f32, float)
}  // extern "C"
