// Float32 multi-head attention kernels on Hopper (sm_90a).
//
// The float32 twins of mha.cu's kernels, for the same TPU kernels of
// nylon_amt_tpu/ops/attention.py: fused_mha (K10: _fwd_kernel, and
// _bwd_kernel for its custom VJP), fused_mha_with_probs (K11) and
// fused_mha_dropout (K12: _fwd_dropout_kernel, _bwd_dropout_kernel), and the
// attention step of the float32 layer kernels K3-K5 (ops/layer_fused.py)
// and K7-K9 (ops/layer_fused_train.py): the default model configuration
// computes in float32, and the TPU kernels follow their inputs' dtype.
//
// The sites have Lq, Lk <= 256 (256 bins, 88 notes, 128 frames; head_dim 64
// in the paper model, 32 in the default), so one block owns one (sequence,
// head) and keeps K and V of the whole head in shared memory, staged once
// by cp.async as f32 rows of D + 4 floats. Instantiated for D in {32, 64}
// and a key tier of 96, 128 or 256 (K/V rows past Lk are zeros, their
// scores -inf).
//
// 3xTF32: a product on the tensor cores is mma.sync m16n8k8 .tf32 with f32
// accumulators. An operand element x is split once, when its tile is
// staged or its fragment loaded, never per product: big = x rounded to
// nearest at TF32's 11 significant bits (Veltkamp's split, three f32
// operations), small = x - big (exact), rounded to nearest by adding half
// a TF32 ulp to its bits (the tensor core drops the low 13); each tile
// product accumulates small*big + big*small + big*big, in that order
// (CUTLASS's OpMultiplyAddFastF32). One TF32 pass keeps ~11 bits and misses
// the f32 gates by 20-200x. cvt.rna.tf32.f32 rounds the same way but
// issues on the 16-lane conversion pipe (a 3xTF32 forward, D 32
// [4096,256,256]: 2.79 ms with it, 1.80 without, in one run). TF32 wgmma
// takes only K-major operands, so PV, dV and dK would need transposed
// staging: not used yet.
//
// attn_fwd_f32_kernel: scores on the CUDA cores (FFMA), PV on the tensor
// cores. 8 warps; a block step takes 8R queries (R = 8 rows a warp, 4 where
// Lq <= 96). Scores: a warp's R rows of Q sit in its own buffer (read as
// broadcasts) and lane j owns keys j, j + 32, ... of the [R, tier] score
// block in registers, so a 16-byte K row read feeds 4R FMAs; each score is
// one fmaf chain over d ascending. The exact row max comes from the
// registers (warp max), p = exp2(s - m) with s = f32(q k) * (scale * log2
// e) (__fmul_rn keeps the product out of an FMA), l is summed from the
// unmasked p, and p [* keep] goes to the block's P buffer; K11 writes p / l
// from the registers. After a barrier, O = P V as 3xTF32: warp w takes m
// tile w % (R / 2) and TPW n tiles of the step's [16, 8] tiles, with k
// index t as key 2t (P's A loads are float2, V's B loads conflict-free),
// one fresh accumulator a k8 step added into acc in f32 (the tensor core
// truncates as it accumulates: five times the error when 96 products share
// one); 1/l is applied at the store (div_rn). Why the scores stay on FFMA:
// on chip_smoke.py (n.2)'s stem layer the scores reach ~2^14 in log2
// units, where the plain f32 version is itself 8e-5 from a float64 truth;
// a kernel stays within 2e-5 of it only if its score sums agree with the
// plain GEMM's, as this fmaf chain's do (to ~1e-7) and 3xTF32's do not
// (7e-5). Bound: FFMA issue for the scores (~55% of the time at D = 64,
// 256 keys) and, for PV, the split of every fragment element (5
// operations; V's are split again by each m tile's warp at every step:
// shared memory holds no split copy of V beside K, V and P at D = 64) more
// than the tensor core; one block per SM at 256 keys leaves K/V staging
// unhidden.
//
// attn_bwd_f32_kernel: 5 products per head (S^T, dP^T, dV, dK, dQ) as
// 3xTF32 and no statistics pass. Key major: warp w owns key tiles w and w +
// 8 (16 keys each) and walks the queries in chunks of QC (16 at D = 32, 8
// at D = 64). A chunk's Q and dO are loaded a chunk ahead into registers
// and split once into shared memory for every warp. Per chunk: S^T = K Q^T
// and dP^T = V dO^T into registers; the row max m, then l = sum p and
// sum(da p) (da = dP [* keep]), each reduced over the warps through shared
// memory in warp order, so m is the exact max; row = sum(da p) / l, a = p /
// l, ds = a (da - row); dV += (a [* keep])^T dO and dK += ds^T Q in
// registers: the accumulator gives a thread queries 2t and 2t + 1 of each
// n8 tile, so these products take k index t as query 2t and read dO's and
// Q's rows in that order (no shuffle, no shared round trip). ds^T goes to
// shared memory as TF32 pairs and, after a barrier, dQ^T = K^T ds^T: its 4
// [16 d, 8 queries] tiles are each taken by two warps over half the keys
// (4 accumulators a warp, summed in order: one mma.sync chain is
// latency-bound), and the high half is added to the low one through shared
// memory. The block owns every query and key of its head, so dq, dk and dv
// need no float atomics and no scratch in device memory: a backward is the
// same bits from run to run. Divisions take the correctly rounded
// reciprocal of l and one FMA correction (div_rn), without IEEE division's
// slow-path branch. 8 warps, one block per SM at 256 keys (up to 171 KB of
// shared memory at D = 64, 246-251 registers). Bound: operations, 3 x 5 x
// Lq x Lk x D multiply-adds per head at the 495 TFLOP/s TF32 peak, which
// mma.sync reaches only in part (wgmma is the only way to all of it);
// beside each mma triple a thread issues the fragment loads and, for
// operands split at load, 5 f32 / integer operations an element; one
// block per SM leaves the 5 barrier phases of a chunk unhidden.
//
// Dropout (kDrop): head h takes hash_mask.cuh's keep mask with tag
// head_tag0 + h (K12: head_tag0 = 0; K7-K9: (tag_base + 8) * 64), row seq *
// Lq + query and column key. The forward draws it per element
// (keep_value); in the backward at 256 keys, where the draws are packed
// (one hash gives keys c and c + 128), key tiles w and w + 8 are exactly
// such pairs, so one hash serves both.

#include <type_traits>

#include "common.cuh"
#include "hash_mask.cuh"

using nylon::DropSite;
using nylon::keep_value;

namespace {

constexpr int kMaxL = 256;
constexpr int kWarps = 8;  // forward warps a block
constexpr int kBwdWarps = 8;
// independent accumulators of a dQ tile (k8 step s adds to s % kDqChains;
// summed at the end in order): one chain of mma.sync is latency-bound
constexpr int kDqChains = 4;

// ----------------------------------------------------------- 3xTF32 ------

// An f32 operand as a TF32 pair: x ~ big + small, both round-to-nearest.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const float c = __fmul_rn(x, 8193.f);
  const float big = __fsub_rn(c, __fsub_rn(c, x));
  return {__float_as_uint(big), __float_as_uint(__fsub_rn(x, big)) + 0x1000u};
}

// c += a (16 x 8, row-major) b (8 x 8, column-major), one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b in f32 accuracy: small*big + big*small + big*big. a[i] is the
// split of A register i (rows g, g + 8, g, g + 8 at k indices t, t, t + 4,
// t + 4), b[i] of B register i (k indices t, t + 4 at column g).
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  mma_tf32(c, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big,
           b[1].big);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small,
           b[1].small);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

// The A operand of a k8 step from the accumulators of one n8 tile: k index
// t is column 2t (c[0], c[2]), k index t + 4 column 2t + 1 (c[1], c[3]).
// The B operand of the same step must take its k rows in that order.
__device__ __forceinline__ void acc_to_a(Split (&a)[4], const float (&c)[4]) {
  a[0] = split(c[0]);
  a[1] = split(c[2]);
  a[2] = split(c[1]);
  a[3] = split(c[3]);
}

// B fragment of a k8 step over rows k0 .. k0 + 7 of a row-major [k][n]
// tile (row length ld), columns n0 .. n0 + 7, with the k order of
// acc_to_a: rows k0 + 2t and k0 + 2t + 1 at column n0 + g.
__device__ __forceinline__ void b_rows(Split (&b)[2], const float* s, int ld,
                                       int k0, int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = split(p[0]);
  b[1] = split(p[ld]);
}

// A fragment of a row-major [m][k] tile: rows m0 + g, m0 + g + 8, columns
// k0 + t, k0 + t + 4.
__device__ __forceinline__ void a_rows(Split (&a)[4], const float* s, int ld,
                                       int m0, int k0, int g, int t) {
  const float* p = s + (m0 + g) * ld + k0 + t;
  a[0] = split(p[0]);
  a[1] = split(p[8 * ld]);
  a[2] = split(p[4]);
  a[3] = split(p[8 * ld + 4]);
}

// p / l from r = 1 / l (the correctly rounded reciprocal): one FMA
// correction of p * r gives the correctly rounded quotient (Markstein) in
// the normal range, without the library division's slow-path branch.
__device__ __forceinline__ float div_rn(float p, float l, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-l, q, p), r, q);
}

// Over the 8 lanes of one t (lane bits 2-4), in a fixed butterfly order.
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, rows) of a strided [*, D] head slice into dst (row length D + 4)
// by cp.async; rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long row_stride, int rows,
                                           int n, int tid, int nthreads) {
  for (int c = tid; c < rows * (D / 4); c += nthreads) {
    const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
    const bool ok = r < n;
    nylon::cp_async16(dst + r * (D + 4) + c4,
                      src + (long long)(ok ? r : 0) * row_stride + c4, ok);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [r0, r0 + R) of a strided slice into a warp's buffer (row length
// D); rows at or past n are zeros.
template <int D, int R>
__device__ __forceinline__ void warp_rows(float* dst, const float* src,
                                          long long row_stride, int r0, int n,
                                          int lane) {
  for (int c = lane; c < R * (D / 4); c += 32) {
    const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) *
                                                     row_stride + c4);
    *reinterpret_cast<float4*>(dst + r * D + c4) = v;
  }
}

// acc[r][j] = sum over d ascending of X[r][d] * Y[lane + 32 j][d] (one fmaf
// a step) for r < R and j < NJ: X the warp's rows (row length D, read as
// broadcasts), Y a block buffer (row length D + 4).
template <int D, int R, int NJ>
__device__ __forceinline__ void dot_rows(float (&acc)[R][NJ], const float* X,
                                         const float* Y, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = *reinterpret_cast<const float4*>(X + r * D + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(Y + (lane + 32 * j) * (D + 4) + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = acc[r][j];
        a = fmaf(x[r].x, y.x, a);
        a = fmaf(x[r].y, y.y, a);
        a = fmaf(x[r].z, y.z, a);
        a = fmaf(x[r].w, y.w, a);
        acc[r][j] = a;
      }
    }
  }
}

// The key tier of a site: the register score block and the K/V rows in
// shared memory cover kKeys >= lk keys (zero-filled past lk).
template <typename F>
int with_tier(int lk, F f) {
  if (lk <= 96) return f(std::integral_constant<int, 96>{});
  if (lk <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

// ------------------------------------------------------------- forward ----

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* probs;  // K11: [n_seq, n_heads, lq, lk], else null
  int lq, lk, n_heads, o_row;
  long long q_row, q_seq, kv_row, kv_seq;
  float scale_log2e;
  uint32_t seed_mix;
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
  DropSite site;  // thresh, scale, half of the probability site
};

// Query rows a forward warp scores at a time (R; a block step takes kWarps
// * R queries): 8 shares each K load among more rows, 4 where lq <= 96
// would leave much of a 64-query step empty.
int fwd_rows(int lq) { return lq > 96 ? 8 : 4; }

// P row length: = 8 mod 32 puts PV's float2 A loads (row g, keys 2t, 2t +
// 1) of a half-warp on distinct banks.
template <int kKeys>
constexpr int kPLD = kKeys + 8;

// K, V [kKeys][D + 4]; P [kWarps * R][kPLD]; per warp Q rows [R][D]; l of
// the step's rows [kWarps * R].
template <int D, int kKeys, int R>
constexpr size_t fwd_smem_bytes() {
  constexpr size_t qb = (size_t)kWarps * R;
  return ((size_t)2 * kKeys * (D + 4) + qb * kPLD<kKeys> + qb * D + qb) *
         sizeof(float);
}

// Blocks a SM can hold by shared memory (228 KB, 1 KB of it reserved a
// block), at most 2: the registers' cap for the launch bounds.
template <int D, int kKeys, int R>
constexpr int fwd_min_blocks() {
  constexpr int b = 228 * 1024 / (int)(fwd_smem_bytes<D, kKeys, R>() + 1024);
  return b > 2 ? 2 : b;
}

template <int D, int kKeys, int R, bool kDrop, bool kProbs>
__global__ void __launch_bounds__(kWarps * 32, (fwd_min_blocks<D, kKeys, R>()))
    attn_fwd_f32_kernel(const FwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 4, NK = kKeys / 32;
  constexpr int QB = kWarps * R, PLD = kPLD<kKeys>;
  // PV of a step: (QB / 16) x (D / 8) [16, 8] tiles; warp w takes m tile w %
  // MT and n tiles (w / MT) * TPW, ..., + TPW - 1
  constexpr int MT = QB / 16, TPW = QB * D / (128 * kWarps);
  static_assert(MT * (D / 8) == TPW * kWarps, "PV's tiles, TPW a warp");
  const int lq = args.lq, lk = args.lk;
  const int seq = blockIdx.x / args.n_heads, h = blockIdx.x % args.n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* const Ks = smem;
  float* const Vs = Ks + kKeys * LD;
  float* const Ps = Vs + kKeys * LD;
  float* const qw = Ps + QB * PLD + warp * R * D;
  float* const ls = Ps + QB * PLD + QB * D;

  // group 0: K (the score product); group 1: V
  stage_rows<D>(Ks, args.k + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                lk, threadIdx.x, kWarps * 32);
  nylon::cp_async_commit();
  stage_rows<D>(Vs, args.v + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                lk, threadIdx.x, kWarps * 32);
  nylon::cp_async_commit();
  nylon::cp_async_wait<1>();
  __syncthreads();

  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const float neg_inf = __int_as_float(0xff800000u);
  const float* const qsrc = args.q + seq * args.q_seq + h * D;
  const int mt = warp % MT, nt0 = (warp / MT) * TPW;
  const int steps = (lq + QB - 1) / QB;
  for (int it = 0; it < steps; ++it) {
    // scores of rows r0 .. r0 + R - 1 on FFMA (zero Q rows past lq)
    const int r0 = it * QB + warp * R;
    float s[R][NK], l[R];
    warp_rows<D, R>(qw, qsrc, args.q_row, r0, lq, lane);
    __syncwarp();
    dot_rows<D, R, NK>(s, qw, Ks, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m = neg_inf;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float x = __fmul_rn(s[r][j], args.scale_log2e);
        s[r][j] = lane + 32 * j < lk ? x : neg_inf;
        m = fmaxf(m, s[r][j]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[r][j] = exp2f(s[r][j] - m);  // 0 past lk
        sum += s[r][j];
      }
      l[r] = nylon::warp_sum(sum);
    }
    if constexpr (kProbs) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r >= lq) break;
        float* const pr =
            args.probs + (((size_t)seq * args.n_heads + h) * lq + r0 + r) * lk;
#pragma unroll
        for (int j = 0; j < NK; ++j)
          if (lane + 32 * j < lk) pr[lane + 32 * j] = s[r][j] / l[r];
      }
    }
    if (it == 0) nylon::cp_async_wait<0>();  // V
    __syncthreads();  // the last step's P and l are read; V has landed
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float p = s[r][j];
        if constexpr (kDrop)
          if (lane + 32 * j < lk)
            p *= keep_value(hsite, (uint32_t)seq * (uint32_t)lq + r0 + r,
                            lane + 32 * j, lk);
        Ps[(warp * R + r) * PLD + lane + 32 * j] = p;
      }
      if (lane == 0) ls[warp * R + r] = l[r];
    }
    __syncthreads();

    // O = P V on the tensor cores, 3xTF32 (k index t as key 2t), a fresh
    // accumulator a k8 step added to acc in f32
    float acc[TPW][4];
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
#pragma unroll 2
    for (int kb = 0; kb < kKeys; kb += 8) {
      const float* const pp = Ps + (mt * 16 + g) * PLD + kb + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(pp);
      const float2 x1 = *reinterpret_cast<const float2*>(pp + 8 * PLD);
      const Split a[4] = {split(x0.x), split(x1.x), split(x0.y), split(x1.y)};
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        Split b[2];
        b_rows(b, Vs, LD, kb, (nt0 + i) * 8, g, t);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(c, a, b);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] += c[r];
      }
    }
    // acc[i][2 hr + e]: row mt * 16 + g + 8 hr, column (nt0 + i) * 8 + 2t + e
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = mt * 16 + g + 8 * hr, q = it * QB + qi;
      if (q >= lq) continue;
      const float lr = ls[qi], rr = __frcp_rn(lr);
      float* const dst = args.o + ((long long)seq * lq + q) * args.o_row +
                         h * D + nt0 * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        *reinterpret_cast<float2*>(dst + 8 * i) =
            make_float2(div_rn(acc[i][2 * hr], lr, rr),
                        div_rn(acc[i][2 * hr + 1], lr, rr));
    }
  }
}

template <int D, int kKeys, int R, bool kDrop, bool kProbs>
int launch_fwd(const FwdArgs& a, int n_items, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, kKeys, R>();
  auto kernel = attn_fwd_f32_kernel<D, kKeys, R, kDrop, kProbs>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_items, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kProbs>
int launch_attention(const FwdArgs& a, int n_items, int head_dim,
                     cudaStream_t stream) {
  const int rows = fwd_rows(a.lq);
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    if (head_dim == 32)
      return rows == 8
                 ? launch_fwd<32, kKeys, 8, kDrop, kProbs>(a, n_items, stream)
                 : launch_fwd<32, kKeys, 4, kDrop, kProbs>(a, n_items, stream);
    return rows == 8
               ? launch_fwd<64, kKeys, 8, kDrop, kProbs>(a, n_items, stream)
               : launch_fwd<64, kKeys, 4, kDrop, kProbs>(a, n_items, stream);
  });
}

// ------------------------------------------------------------ backward ----

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  int lq, lk;
  long long q_row, q_seq, kv_row, kv_seq, do_row, do_seq, dq_row, dq_seq,
      dkv_row, dkv_seq;
  float scale, scale_log2e;
  uint32_t seed_mix;
  int head_tag0;
  DropSite site;
};

// Queries a backward chunk: its Q and dO are one float2 of each a thread,
// and its dQ^T [D, QC] is kDqTiles [16, 8] tiles.
template <int D>
constexpr int kQC = 512 / D;
constexpr int kDqTiles = 4;

// ds^T tile [kKeys][QC + pad]: row length = 4 mod 16 puts dQ's B loads
// (rows 2t, 2t + 1, column g) on distinct banks.
template <int D>
constexpr int kLS = kQC<D> + 4;

// K, V [kKeys][D + 4]; the chunk's Q and dO split into TF32 pairs, [QC][D
// + 4] for each half; ds^T split, [kKeys][kLS] for each half; per-warp
// partial max, l and sum(da p) of the chunk's queries [3][kBwdWarps][QC];
// the high key half of dQ^T [kDqTiles][32 lanes][4].
template <int D, int kKeys>
constexpr size_t bwd_smem_bytes() {
  return ((size_t)2 * kKeys * (D + 4) + (size_t)4 * kQC<D> * (D + 4) +
          (size_t)2 * kKeys * kLS<D> + (size_t)3 * kBwdWarps * kQC<D> +
          (size_t)kDqTiles * 32 * 4) *
         sizeof(float);
}

// B fragments from a tile stored as TF32 pairs (hi: big, lo: small): b_cols2
// takes an [n][k] tile (k indices t, t + 4), b_rows2 a [k][n] tile in
// b_rows' pattern.
__device__ __forceinline__ void b_cols2(Split (&b)[2], const uint32_t* hi,
                                        const uint32_t* lo, int ld, int n0,
                                        int k0, int g, int t) {
  const int i = (n0 + g) * ld + k0 + t;
  b[0] = {hi[i], lo[i]};
  b[1] = {hi[i + 4], lo[i + 4]};
}

__device__ __forceinline__ void b_rows2(Split (&b)[2], const uint32_t* hi,
                                        const uint32_t* lo, int ld, int k0,
                                        int n0, int g, int t) {
  const int i = (k0 + 2 * t) * ld + n0 + g;
  b[0] = {hi[i], lo[i]};
  b[1] = {hi[i + ld], lo[i + ld]};
}

template <int D, int kKeys, bool kDrop>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
    attn_bwd_f32_kernel(const BwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 4, QC = kQC<D>, LS = kLS<D>, NJ = QC / 8;
  constexpr int NKT = (kKeys / 16 + kBwdWarps - 1) / kBwdWarps;
  constexpr int nthreads = kBwdWarps * 32;
  static_assert(QC * D == 2 * nthreads, "one float2 of Q and dO a thread");
  static_assert(QC * D == kDqTiles * 128 && 2 * kDqTiles == kBwdWarps,
                "dQ^T's tiles, each over two key halves, one a warp");
  static_assert(kKeys % 16 == 0, "the key halves are whole k8 steps");
  const int lq = args.lq, lk = args.lk;
  float* const Ks = smem;
  float* const Vs = Ks + kKeys * LD;
  uint32_t* const Qh = reinterpret_cast<uint32_t*>(Vs + kKeys * LD);
  uint32_t* const Ql = Qh + QC * LD;
  uint32_t* const dOh = Ql + QC * LD;
  uint32_t* const dOl = dOh + QC * LD;
  uint32_t* const dsh = dOl + QC * LD;  // [kKeys][LS]
  uint32_t* const dsl = dsh + kKeys * LS;
  float* const red_m = reinterpret_cast<float*>(dsl + kKeys * LS);
  float* const red_l = red_m + kBwdWarps * QC;  // [kBwdWarps][QC] each
  float* const red_r = red_l + kBwdWarps * QC;
  float* const dqx = red_r + kBwdWarps * QC;  // [kDqTiles][32][4]
  const int seq = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long kv_off = seq * args.kv_seq + h * D;
  const float* const qsrc = args.q + seq * args.q_seq + h * D;
  const float* const dosrc = args.dout + seq * args.do_seq + h * D;
  const float sl2e = args.scale_log2e, scale = args.scale;
  const float neg_inf = __int_as_float(0xff800000u);
  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const uint32_t row0 = (uint32_t)seq * (uint32_t)lq;

  stage_rows<D>(Ks, args.k + kv_off, args.kv_row, kKeys, lk, threadIdx.x,
                nthreads);
  stage_rows<D>(Vs, args.v + kv_off, args.kv_row, kKeys, lk, threadIdx.x,
                nthreads);
  nylon::cp_async_commit();

  // Q and dO of a chunk pass through registers (one float2 of each a
  // thread, loaded a chunk ahead) and are split once into shared memory,
  // where every warp reads them
  const int cr = threadIdx.x / (D / 2), cc = (threadIdx.x % (D / 2)) * 2;
  float2 qn, don;
  auto load_chunk = [&](int q0) {
    const int r = q0 + cr;
    const float2 z = make_float2(0.f, 0.f);
    qn = r < lq ? *reinterpret_cast<const float2*>(
                      qsrc + (long long)r * args.q_row + cc)
                : z;
    don = r < lq ? *reinterpret_cast<const float2*>(
                       dosrc + (long long)r * args.do_row + cc)
                 : z;
  };
  auto store_split = [&](uint32_t* hi, uint32_t* lo, float2 v) {
    const Split a = split(v.x), b = split(v.y);
    *reinterpret_cast<uint2*>(hi + cr * LD + cc) = make_uint2(a.big, b.big);
    *reinterpret_cast<uint2*>(lo + cr * LD + cc) =
        make_uint2(a.small, b.small);
  };
  load_chunk(0);
  store_split(Qh, Ql, qn);
  store_split(dOh, dOl, don);

  float dk[NKT][D / 8][4], dv[NKT][D / 8][4];
#pragma unroll
  for (int i = 0; i < NKT; ++i)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) dk[i][nd][r] = dv[i][nd][r] = 0.f;

  nylon::cp_async_wait<0>();
  const int nchunks = (lq + QC - 1) / QC;
  for (int c = 0; c < nchunks; ++c) {
    const int qc0 = c * QC;
    __syncthreads();  // chunk c split; last chunk's ds^T and sums read
    if (c + 1 < nchunks) load_chunk(qc0 + QC);

    // S^T = K Q^T and dP^T = V dO^T of this warp's keys and the chunk
    float st[NKT][NJ][4], dpt[NKT][NJ][4];
#pragma unroll
    for (int i = 0; i < NKT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[i][j][r] = dpt[i][j][r] = 0.f;
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int kt = warp + i * kBwdWarps;
      if (kt >= kKeys / 16) break;  // warp-uniform
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Split ka[4], va[4];
        a_rows(ka, Ks, LD, kt * 16, kk * 8, g, t);
        a_rows(va, Vs, LD, kt * 16, kk * 8, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          Split b[2];
          b_cols2(b, Qh, Ql, LD, j * 8, kk * 8, g, t);
          mma3(st[i][j], ka, b);
          b_cols2(b, dOh, dOl, LD, j * 8, kk * 8, g, t);
          mma3(dpt[i][j], va, b);
        }
      }
    }
    // element (i, j, r): key (warp + 8i) * 16 + g + 8 (r >> 1), query qc0 +
    // j * 8 + 2t + (r & 1)
    float pm[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) pm[j][0] = pm[j][1] = neg_inf;
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int kt = warp + i * kBwdWarps;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = kt * 16 + g + (r >> 1) * 8;
          const float x = __fmul_rn(st[i][j][r], sl2e);
          st[i][j][r] = kt < kKeys / 16 && key < lk ? x : neg_inf;
          pm[j][r & 1] = fmaxf(pm[j][r & 1], st[i][j][r]);
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m = col_max(pm[j][e]);
        if (g == 0) red_m[warp * QC + j * 8 + 2 * t + e] = m;
      }
    __syncthreads();
    float mq[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = red_m[j * 8 + 2 * t + e];
#pragma unroll
        for (int w = 1; w < kBwdWarps; ++w)
          m = fmaxf(m, red_m[w * QC + j * 8 + 2 * t + e]);
        mq[j][e] = m;
      }
    // p = exp2(s - m) in place; da = dP [* keep] in place; partial l and
    // sum(da p) over this warp's keys (the keep bit of element (i, j, r) in
    // bit (i * NJ + j) * 4 + r of kbits)
    float pl[NJ][2], pr[NJ][2];
    uint32_t kbits = 0u;
    if constexpr (kDrop) {
      if (kKeys == 256 && hsite.half == 128) {
        // packed draws: key tiles w and w + 8 hold keys c and c + 128,
        // which one hash gives
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = qc0 + j * 8 + 2 * t + (r & 1);
            const uint32_t c = (uint32_t)(warp * 16 + g + (r >> 1) * 8);
            const uint32_t x = nylon::hash_mix(
                (hsite.base + (row0 + q) * 128u + c) ^ hsite.key);
            const uint32_t ok = q < lq ? 1u : 0u;
            kbits |= (ok & (uint32_t)((x & 0xFFFFu) >= hsite.thresh))
                     << (j * 4 + r);
            kbits |= (ok & (uint32_t)((x >> 16) >= hsite.thresh))
                     << ((NJ + j) * 4 + r);
          }
      } else {
#pragma unroll
        for (int i = 0; i < NKT; ++i) {
          const int kt = warp + i * kBwdWarps;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int key = kt * 16 + g + (r >> 1) * 8;
              const int q = qc0 + j * 8 + 2 * t + (r & 1);
              const bool keep = kt < kKeys / 16 && key < lk && q < lq &&
                                keep_value(hsite, row0 + q, key, lk) != 0.f;
              kbits |= (uint32_t)keep << ((i * NJ + j) * 4 + r);
            }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      pl[j][0] = pl[j][1] = pr[j][0] = pr[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int kt = warp + i * kBwdWarps;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r & 1;
          const int key = kt * 16 + g + (r >> 1) * 8;
          const int q = qc0 + j * 8 + 2 * t + e;
          const float p = exp2f(st[i][j][r] - mq[j][e]);  // 0 past lk
          float da = dpt[i][j][r];
          if constexpr (kDrop)
            da *= (kbits >> ((i * NJ + j) * 4 + r)) & 1u ? hsite.scale : 0.f;
          st[i][j][r] = p;
          dpt[i][j][r] = da;
          pl[j][e] += p;
          pr[j][e] += da * p;
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = col_sum(pl[j][e]), rr = col_sum(pr[j][e]);
        if (g == 0) {
          red_l[warp * QC + j * 8 + 2 * t + e] = l;
          red_r[warp * QC + j * 8 + 2 * t + e] = rr;
        }
      }
    __syncthreads();
    float lsum[NJ][2], rcp[NJ][2], rowq[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float l = 0.f, rr = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) {
          l += red_l[w * QC + j * 8 + 2 * t + e];
          rr += red_r[w * QC + j * 8 + 2 * t + e];
        }
        lsum[j][e] = l;
        rcp[j][e] = __frcp_rn(l);
        rowq[j][e] = div_rn(rr, l, rcp[j][e]);
      }
    // a = p / l; ad = a [* keep]; ds = a (da - row); dV += ad^T dO and dK
    // += ds^T Q (the k8 step of n8 tile j takes queries j * 8 + 2t, j * 8 +
    // 2t + 1); ds^T to shared memory as TF32 pairs
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int kt = warp + i * kBwdWarps;
      if (kt >= kKeys / 16) break;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r & 1;
          const int key = kt * 16 + g + (r >> 1) * 8;
          const int q = qc0 + j * 8 + 2 * t + e;
          float ad = 0.f, ds = 0.f;
          if (q < lq && key < lk) {
            const float a = div_rn(st[i][j][r], lsum[j][e], rcp[j][e]);
            float mk = 1.f;
            if constexpr (kDrop)
              mk = (kbits >> ((i * NJ + j) * 4 + r)) & 1u ? hsite.scale
                                                          : 0.f;
            ad = a * mk;
            ds = a * (dpt[i][j][r] - rowq[j][e]);
          }
          st[i][j][r] = ad;
          dpt[i][j][r] = ds;
        }
        Split aa[4], sa[4];
        acc_to_a(aa, st[i][j]);
        acc_to_a(sa, dpt[i][j]);
        // sa[0], sa[2]: row g, queries 2t, 2t + 1; sa[1], sa[3]: row g + 8
        const int w0 = (kt * 16 + g) * LS + j * 8 + 2 * t;
        *reinterpret_cast<uint2*>(dsh + w0) = make_uint2(sa[0].big, sa[2].big);
        *reinterpret_cast<uint2*>(dsl + w0) =
            make_uint2(sa[0].small, sa[2].small);
        *reinterpret_cast<uint2*>(dsh + w0 + 8 * LS) =
            make_uint2(sa[1].big, sa[3].big);
        *reinterpret_cast<uint2*>(dsl + w0 + 8 * LS) =
            make_uint2(sa[1].small, sa[3].small);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          Split b[2];
          b_rows2(b, dOh, dOl, LD, j * 8, nd * 8, g, t);
          mma3(dv[i][nd], aa, b);
          b_rows2(b, Qh, Ql, LD, j * 8, nd * 8, g, t);
          mma3(dk[i][nd], sa, b);
        }
      }
    }
    __syncthreads();  // ds^T of every key; the chunk's Q and dO are read
    if (c + 1 < nchunks) {
      store_split(Qh, Ql, qn);
      store_split(dOh, dOl, don);
    }

    // dQ^T of the chunk = K^T ds^T: kDqTiles [16 d, 8 queries] tiles, warp
    // w takes tile w % kDqTiles over key half w / kDqTiles (k index t as
    // key 2t, as in dK); the halves are added low + high
    {
      constexpr int kSteps = kKeys / 16;  // k8 steps a key half
      const int tile = warp % kDqTiles, kh = warp / kDqTiles;
      const int d0 = (tile % (D / 16)) * 16, n0 = (tile / (D / 16)) * 8;
      float acc[kDqChains][4];
#pragma unroll
      for (int u = 0; u < kDqChains; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;
      // every key of the tier (ds^T and K are zero past lk, so the sums
      // are those over lk): a trip count the compiler unrolls
#pragma unroll
      for (int st8 = 0; st8 < kSteps; ++st8) {
        const int kb = kh * (kKeys / 2) + 8 * st8;
        const float* const kp = Ks + (kb + 2 * t) * LD + d0 + g;
        const Split a[4] = {split(kp[0]), split(kp[8]), split(kp[LD]),
                            split(kp[LD + 8])};
        Split b[2];
        b_rows2(b, dsh, dsl, LS, kb, n0, g, t);
        mma3(acc[st8 % kDqChains], a, b);
      }
#pragma unroll
      for (int u = 1; u < kDqChains; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[0][r] += acc[u][r];
      float4* const x = reinterpret_cast<float4*>(dqx) + tile * 32 + lane;
      if (kh) *x = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      __syncthreads();
      if (!kh) {
        const float4 hi = *x;
        const float v[4] = {acc[0][0] + hi.x, acc[0][1] + hi.y,
                            acc[0][2] + hi.z, acc[0][3] + hi.w};
        // v[e]: query n0 + 2t + e at d0 + g; v[2 + e]: at d0 + g + 8
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = qc0 + n0 + 2 * t + e;
          if (q >= lq) continue;
          float* const dst = args.dq + seq * args.dq_seq +
                             (long long)q * args.dq_row + h * D + d0 + g;
          dst[0] = v[e] * scale;
          dst[8] = v[2 + e] * scale;
        }
      }
    }
  }

  // dK (times scale) and dV of this warp's keys
#pragma unroll
  for (int i = 0; i < NKT; ++i) {
    const int kt = warp + i * kBwdWarps;
    if (kt >= kKeys / 16) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = kt * 16 + g + 8 * hr;
      if (key >= lk) continue;
      const long long off = seq * args.dkv_seq +
                            (long long)key * args.dkv_row + h * D + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<float2*>(args.dk + off + nd * 8) = make_float2(
            dk[i][nd][2 * hr] * scale, dk[i][nd][2 * hr + 1] * scale);
        *reinterpret_cast<float2*>(args.dv + off + nd * 8) =
            make_float2(dv[i][nd][2 * hr], dv[i][nd][2 * hr + 1]);
      }
    }
  }
}

template <int D, int kKeys, bool kDrop>
int launch_bwd(const BwdArgs& a, int n_seq, int n_heads, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D, kKeys>();
  auto kernel = attn_bwd_f32_kernel<D, kKeys, kDrop>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(n_seq, n_heads), kBwdWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_attn_bwd(const BwdArgs& a, int n_seq, int n_heads, int head_dim,
                    cudaStream_t stream) {
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32
               ? launch_bwd<32, kKeys, kDrop>(a, n_seq, n_heads, stream)
               : launch_bwd<64, kKeys, kDrop>(a, n_seq, n_heads, stream);
  });
}

// Resident blocks per SM of the K10 forward (R rows a warp; the backward
// when bwd) at head_dim D and key tier kKeys, after the shared-memory
// opt-in.
template <int D, int kKeys>
int occupancy(int R, int bwd) {
  int blocks = 0;
  cudaError_t e;
  if (bwd) {
    auto kernel = attn_bwd_f32_kernel<D, kKeys, false>;
    const size_t smem = bwd_smem_bytes<D, kKeys>();
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kBwdWarps * 32, smem);
  } else {
    auto kernel = R == 8 ? attn_fwd_f32_kernel<D, kKeys, 8, false, false>
                         : attn_fwd_f32_kernel<D, kKeys, 4, false, false>;
    const size_t smem = R == 8 ? fwd_smem_bytes<D, kKeys, 8>()
                               : fwd_smem_bytes<D, kKeys, 4>();
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kWarps * 32, smem);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

bool bad_geometry(int n_seq, int lq, int lk, int n_heads, int head_dim) {
  return (head_dim != 32 && head_dim != 64) || n_seq <= 0 || lq <= 0 ||
         lk <= 0 || lq > kMaxL || lk > kMaxL || n_heads <= 0 ||
         n_heads > 65535 || (long long)n_seq * n_heads > 0x7fffffffLL;
}

FwdArgs fwd_args(const void* q, const void* k, const void* v, void* o,
                 void* probs, int lq, int lk, int n_heads, int head_dim,
                 long long q_row, long long q_seq, long long kv_row,
                 long long kv_seq, float scale_log2e) {
  FwdArgs a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.o = (float*)o;
  a.probs = (float*)probs;
  a.lq = lq;
  a.lk = lk;
  a.n_heads = n_heads;
  a.o_row = n_heads * head_dim;
  a.q_row = q_row;
  a.q_seq = q_seq;
  a.kv_row = kv_row;
  a.kv_seq = kv_seq;
  a.scale_log2e = scale_log2e;
  return a;
}

}  // namespace

extern "C" {

// The float32 twins of mha.cu's entry points, with the same arguments.
int nylon_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int n_seq, int lq, int lk, int n_heads, int head_dim,
                        long long q_row, long long q_seq, long long kv_row,
                        long long kv_seq, float scale_log2e, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = fwd_args(q, k, v, o, nullptr, lq, lk, n_heads, head_dim,
                             q_row, q_seq, kv_row, kv_seq, scale_log2e);
  return launch_attention<false, false>(a, n_seq * n_heads, head_dim,
                                        (cudaStream_t)stream);
}

int nylon_attention_probs_f32(const void* q, const void* k, const void* v,
                              void* o, void* probs, int n_seq, int lq,
                              int lk, int n_heads, int head_dim,
                              long long q_row, long long q_seq,
                              long long kv_row, long long kv_seq,
                              float scale_log2e, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) || probs == nullptr)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = fwd_args(q, k, v, o, probs, lq, lk, n_heads, head_dim,
                             q_row, q_seq, kv_row, kv_seq, scale_log2e);
  return launch_attention<false, true>(a, n_seq * n_heads, head_dim,
                                       (cudaStream_t)stream);
}

int nylon_attention_drop_f32(const void* q, const void* k, const void* v,
                             void* o, int n_seq, int lq, int lk, int n_heads,
                             int head_dim, long long q_row, long long q_seq,
                             long long kv_row, long long kv_seq,
                             float scale_log2e, unsigned seed_mix,
                             int head_tag0, unsigned thresh, float scale,
                             int half, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = fwd_args(q, k, v, o, nullptr, lq, lk, n_heads, head_dim, q_row,
                       q_seq, kv_row, kv_seq, scale_log2e);
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, scale, half, 0u};
  return launch_attention<true, false>(a, n_seq * n_heads, head_dim,
                                       (cudaStream_t)stream);
}

int nylon_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* dout, void* dq, void* dk, void* dv,
                            int n_seq, int lq, int lk, int n_heads,
                            int head_dim, long long q_row, long long kv_row,
                            long long do_row, long long dq_row,
                            long long dkv_row, float scale, float scale_log2e,
                            int active, unsigned seed_mix, int head_tag0,
                            unsigned thresh, float pscale, int half,
                            void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.dout = (const float*)dout;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.lq = lq;
  a.lk = lk;
  a.q_row = q_row;
  a.q_seq = q_row * lq;
  a.kv_row = kv_row;
  a.kv_seq = kv_row * lk;
  a.do_row = do_row;
  a.do_seq = do_row * lq;
  a.dq_row = dq_row;
  a.dq_seq = dq_row * lq;
  a.dkv_row = dkv_row;
  a.dkv_seq = dkv_row * lk;
  a.scale = scale;
  a.scale_log2e = scale_log2e;
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, pscale, half, 0u};
  return active ? launch_attn_bwd<true>(a, n_seq, n_heads, head_dim,
                                        (cudaStream_t)stream)
                : launch_attn_bwd<false>(a, n_seq, n_heads, head_dim,
                                         (cudaStream_t)stream);
}

// Resident blocks per SM of the float32 attention kernels (the forward, or
// the backward when bwd) at head_dim 32 or 64, lq queries and the key tier
// of lk; a negative CUDA status on failure.
int nylon_attention_f32_occupancy(int head_dim, int lq, int lk, int bwd) {
  if ((head_dim != 32 && head_dim != 64) || lq <= 0 || lq > kMaxL ||
      lk <= 0 || lk > kMaxL)
    return -(int)cudaErrorInvalidValue;
  const int rows = fwd_rows(lq);
  return with_tier(lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32 ? occupancy<32, kKeys>(rows, bwd)
                          : occupancy<64, kKeys>(rows, bwd);
  });
}

}  // extern "C"
