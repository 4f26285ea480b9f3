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
//    bias [, ReLU], an s8 x s8 -> s32 tensor-core GEMM (mma.sync
//    m16n8k32) with a dequantizing epilogue;
//  * gemm_q8_res_ln_kernel: the same GEMM with a block that owns full rows,
//    so the residual and the shared post-LayerNorm run in its epilogue, and
//    optionally the row quantization of its output for the next GEMM;
//  * attention_q8_kernel: one block per (sequence, head, 128-query tile),
//    int8 K and V^T of the whole sequence in shared memory, int8 QK^T and
//    PV products, an exact two-pass softmax in f32; head_dim D = 64 (two
//    k32 steps of the score product) or 32 (one), the K rows padded to D +
//    16 bytes either way.
//
// The mma's B operand wants each output column's K values contiguous, and
// the packed weights are [K, N] (N contiguous). The GEMM's loader reads a
// 4 x 4 byte block of W as four 32-bit words and transposes it in
// registers (__byte_perm) before the shared-memory store.
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
// Every int8 sum is exact (|acc| <= 512 * 127^2 < 2^24, so f32(acc) is
// too): the GEMM outputs equal the plain version's bit for bit; only the
// f32 sums of the LayerNorm and of l, and exp2, are taken in another order
// or by another routine than PyTorch's.

#include "common.cuh"

using nylon::bf16;
using nylon::round_to;

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel of this file
constexpr int kBK = 64;        // GEMM depth per pipeline stage, in int8
constexpr int kLd = kBK + 16;  // padded smem row (bytes): 20 words, so the
                               // fragment loads of 8 rows x 4 lanes hit 32
                               // distinct banks
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

// rows r0..r3 of a 4 x 4 byte block (byte c of each = column c) ->
// columns: out[c] holds {r0.c, r1.c, r2.c, r3.c}.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
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

// The tiled mainloop shared by both GEMM kernels: acc += A[m0:m0+BM, :] @
// W[:, n0:n0+BN], warps WM x WN, each owning (BM/WM) x (BN/WN). A stage
// holds A[BM][kLd] (cp.async, zero rows past M) and W^T[BN][kLd] (transposed
// 4 x 4 byte blocks, zero columns past N); double-buffered: the next
// stage's A is in flight by cp.async and its W words in registers while
// the current stage is multiplied.
template <int BM, int BN, int WM, int WN>
struct S8Gemm {
  static constexpr int kMT = BM / WM / 16;        // m16 tiles per warp
  static constexpr int kNT = BN / WN / 8;         // n8 tiles per warp
  static constexpr int kABytes = BM * kLd;
  static constexpr int kBBytes = BN * kLd;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPipeBytes = 2 * kStageBytes;
  static constexpr int kWBlocks = (kBK / 4) * (BN / 4) / kThreads;
  static_assert(WM * WN == kThreads / 32, "8 warps");
  static_assert(kWBlocks * kThreads == (kBK / 4) * (BN / 4), "W blocks");

  __device__ static void load_a(uint8_t* dst, const int8_t* a, int M, int K,
                                int m0, int k0) {
    for (int c = threadIdx.x; c < BM * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
      const bool ok = m0 + r < M;
      const int8_t* src = a + (size_t)(ok ? m0 + r : 0) * K + k0 + col;
      nylon::cp_async16(dst + r * kLd + col, src, ok);
    }
  }

  // Block b of the stage: k rows 4*ii .. 4*ii+3, columns 4*j .. 4*j+3.
  __device__ static void fetch_w(uint32_t (&w4)[kWBlocks][4],
                                 const int8_t* w, int N, int k0, int n0) {
#pragma unroll
    for (int i = 0; i < kWBlocks; ++i) {
      const int b = threadIdx.x + i * kThreads;
      const int j = b % (BN / 4), ii = b / (BN / 4);
      const int n = n0 + 4 * j;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w4[i][r] = n < N ? *reinterpret_cast<const uint32_t*>(
                               w + (size_t)(k0 + 4 * ii + r) * N + n)
                         : 0u;
    }
  }

  __device__ static void store_w(uint8_t* dst,
                                 const uint32_t (&w4)[kWBlocks][4]) {
#pragma unroll
    for (int i = 0; i < kWBlocks; ++i) {
      const int b = threadIdx.x + i * kThreads;
      const int j = b % (BN / 4), ii = b / (BN / 4);
      uint32_t cols[4];
      transpose4x4(w4[i], cols);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        *reinterpret_cast<uint32_t*>(dst + (4 * j + cc) * kLd + 4 * ii) =
            cols[cc];
    }
  }

  __device__ static void run(const int8_t* a, const int8_t* w, int M, int N,
                             int K, int m0, int n0, uint8_t* smem,
                             int (&acc)[kMT][kNT][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    uint32_t w4[kWBlocks][4];
    const int nk = K / kBK;
    load_a(smem, a, M, K, m0, 0);
    nylon::cp_async_commit();
    fetch_w(w4, w, N, 0, n0);
    store_w(smem + kABytes, w4);
    for (int kt = 0; kt < nk; ++kt) {
      uint8_t* const cur = smem + (kt & 1) * kStageBytes;
      uint8_t* const nxt = smem + ((kt + 1) & 1) * kStageBytes;
      const bool more = kt + 1 < nk;
      if (more) {
        load_a(nxt, a, M, K, m0, (kt + 1) * kBK);
        nylon::cp_async_commit();
        fetch_w(w4, w, N, (kt + 1) * kBK, n0);
        nylon::cp_async_wait<1>();
      } else {
        nylon::cp_async_wait<0>();
      }
      __syncthreads();
      const uint8_t* As = cur;
      const uint8_t* Bs = cur + kABytes;
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
        uint32_t af[kMT][4], bfr[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const uint8_t* p = As + (wm * (BM / WM) + i * 16 + g) * kLd + ks +
                             t * 4;
          af[i][0] = lds32(p);
          af[i][1] = lds32(p + 8 * kLd);
          af[i][2] = lds32(p + 16);
          af[i][3] = lds32(p + 8 * kLd + 16);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint8_t* p = Bs + (wn * (BN / WN) + j * 8 + g) * kLd + ks +
                             t * 4;
          bfr[j][0] = lds32(p);
          bfr[j][1] = lds32(p + 16);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
      if (more) store_w(nxt + kABytes, w4);  // nxt is not read this stage
      __syncthreads();
    }
  }
};

// GEMM + bias: 128 x 128 tiles, warps 2 x 4 of 64 x 32.
using GemmBias = S8Gemm<128, 128, 2, 4>;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_q8_bias_kernel(const int8_t* __restrict__ a,
                        const float* __restrict__ sa,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ sw,
                        const T* __restrict__ bias, T* __restrict__ out,
                        int M, int N, int K, int relu, int n_tiles_n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int m0 = (blockIdx.x / n_tiles_n) * 128;
  const int n0 = (blockIdx.x % n_tiles_n) * 128;
  int acc[GemmBias::kMT][GemmBias::kNT][4];
  GemmBias::run(a, w, M, N, K, m0, n0, smem, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < GemmBias::kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (row >= M) continue;
      const float sx = sa[row];
#pragma unroll
      for (int j = 0; j < GemmBias::kNT; ++j) {
        const int col = n0 + wn * 32 + j * 8 + t * 2;
        if (col >= N) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float q = dequant(acc[i][j][2 * half + e], sx, sw[col + e]);
          y[e] = round_to<T>(round_to<T>(q) + nylon::to_f(bias[col + e]));
          if (relu) y[e] = fmaxf(y[e], 0.f);
        }
        store2(out + (size_t)row * N + col, y[0], y[1]);
      }
    }
  }
}

// GEMM + residual + shared LayerNorm: 64 x 256 tiles (a block owns whole
// rows, N <= 256), warps 2 x 4 of 32 x 64. The s32 tile is staged in
// shared memory over the dead pipeline buffers; each warp then normalises
// 8 rows, lane owning columns lane + 32 t.
using GemmLn = S8Gemm<64, 256, 2, 4>;
constexpr int kLnBM = 64, kLnBN = 256;
constexpr int kLnCLd = kLnBN + 4;
constexpr size_t kLnStageBytes = (size_t)kLnBM * kLnCLd * sizeof(int);
constexpr size_t kLnSmem = (size_t)GemmLn::kPipeBytes > kLnStageBytes
                               ? (size_t)GemmLn::kPipeBytes
                               : kLnStageBytes;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_q8_res_ln_kernel(const int8_t* __restrict__ a,
                          const float* __restrict__ sa,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ sw,
                          const T* __restrict__ bias,
                          const T* __restrict__ res,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          T* __restrict__ out, int8_t* __restrict__ q_out,
                          float* __restrict__ s_out, int M, int N, int K,
                          float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int m0 = blockIdx.x * kLnBM;
  int acc[GemmLn::kMT][GemmLn::kNT][4];
  GemmLn::run(a, w, M, N, K, m0, 0, smem, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  int* const C = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < GemmLn::kMT; ++i)
#pragma unroll
    for (int j = 0; j < GemmLn::kNT; ++j) {
      const int r = wm * 32 + i * 16 + g, c = wn * 64 + j * 8 + t * 2;
      C[r * kLnCLd + c] = acc[i][j][0];
      C[r * kLnCLd + c + 1] = acc[i][j][1];
      C[(r + 8) * kLnCLd + c] = acc[i][j][2];
      C[(r + 8) * kLnCLd + c + 1] = acc[i][j][3];
    }
  __syncthreads();

  const float inv_n = 1.f / (float)N;
  for (int rr = 0; rr < kLnBM / 8; ++rr) {
    const int r = warp * (kLnBM / 8) + rr;
    const int row = m0 + r;
    if (row >= M) break;  // warp-uniform
    const float sx = sa[row];
    float s[kLnBN / 32];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kLnBN / 32; ++k) {
      const int c = lane + 32 * k;
      s[k] = 0.f;
      if (c < N) {
        const float y = round_to<T>(
            round_to<T>(dequant(C[r * kLnCLd + c], sx, sw[c])) +
            nylon::to_f(bias[c]));
        s[k] = round_to<T>(nylon::to_f(res[(size_t)row * N + c]) + y);
        sum += s[k];
      }
    }
    const float mean = nylon::warp_sum(sum) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kLnBN / 32; ++k) {
      const int c = lane + 32 * k;
      if (c < N) {
        const float d = s[k] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(nylon::warp_sum(sq) * inv_n + eps);
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < kLnBN / 32; ++k) {
      const int c = lane + 32 * k;
      if (c < N) {
        s[k] = round_to<T>((s[k] - mean) * rstd * gamma[c] + beta[c]);
        out[(size_t)row * N + c] = nylon::from_f<T>(s[k]);
        amax = fmaxf(amax, fabsf(s[k]));
      }
    }
    if (q_out == nullptr) continue;  // warp-uniform
    // the next GEMM's row quantization of the output
    const float qa = fmaxf(warp_max(amax), kAbsFloor);
    const float qr = 127.f / qa;
#pragma unroll
    for (int k = 0; k < kLnBN / 32; ++k) {
      const int c = lane + 32 * k;
      if (c < N) q_out[(size_t)row * N + c] = quant_code(s[k], qr);
    }
    if (lane == 0) s_out[row] = qa * kInv127;
  }
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

template <typename T>
int launch_gemm_bias(const void* a, const void* sa, const void* w,
                     const void* sw, const void* bias, void* out, int M,
                     int N, int K, int relu, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8)
    return (int)cudaErrorInvalidValue;
  const int smem = GemmBias::kPipeBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_q8_bias_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles_n = (N + 127) / 128;
  const long long tiles = (long long)n_tiles_n * ((M + 127) / 128);
  gemm_q8_bias_kernel<T><<<(unsigned)tiles, kThreads, smem, stream>>>(
      (const int8_t*)a, (const float*)sa, (const int8_t*)w, (const float*)sw,
      (const T*)bias, (T*)out, M, N, K, relu, n_tiles_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemm_res_ln(const void* a, const void* sa, const void* w,
                       const void* sw, const void* bias, const void* res,
                       const void* gamma, const void* beta, void* out,
                       void* q_out, void* s_out, int M, int N, int K,
                       float eps, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || N > kLnBN ||
      ((q_out == nullptr) != (s_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_q8_res_ln_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLnSmem);
  if (e != cudaSuccess) return (int)e;
  gemm_q8_res_ln_kernel<T><<<(M + kLnBM - 1) / kLnBM, kThreads, kLnSmem,
                             stream>>>(
      (const int8_t*)a, (const float*)sa, (const int8_t*)w, (const float*)sw,
      (const T*)bias, (const T*)res, (const float*)gamma, (const float*)beta,
      (T*)out, (int8_t*)q_out, (float*)s_out, M, N, K, eps);
  return (int)cudaGetLastError();
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
// takes and writes f32 (the float32 compute dtype).
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
  int nylon_q8_gemm_bias##name(const void* a, const void* sa, const void* w,  \
                               const void* sw, const void* bias, void* out,   \
                               int M, int N, int K, int relu, void* stream) { \
    return launch_gemm_bias<T>(a, sa, w, sw, bias, out, M, N, K, relu,        \
                               (cudaStream_t)stream);                         \
  }                                                                           \
  int nylon_q8_gemm_res_ln##name(                                             \
      const void* a, const void* sa, const void* w, const void* sw,           \
      const void* bias, const void* res, const void* gamma, const void* beta, \
      void* out, void* q_out, void* s_out, int M, int N, int K, float eps,    \
      void* stream) {                                                         \
    return launch_gemm_res_ln<T>(a, sa, w, sw, bias, res, gamma, beta, out,   \
                                 q_out, s_out, M, N, K, eps,                  \
                                 (cudaStream_t)stream);                       \
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
