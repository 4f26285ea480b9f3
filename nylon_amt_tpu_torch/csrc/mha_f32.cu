// Float32 multi-head attention kernels on Hopper (sm_90a): 3xTF32 wgmma
// products on operands that TMA brings into shared memory.
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
// in the paper model, 32 in the default). TMA reads q, k, v (and dO) from
// the strided views the callers pass: a 3-D tensor map [sequence, row,
// column] a view (attn_tma.cuh), boxes of 32 floats (one 128-byte swizzle
// row; a head of D columns is D / 32 boxes) by a tile's rows, rows past Lq
// or Lk zero-filled. Outputs leave from the registers by plain stores.
//
// 3xTF32: every product is wgmma m64nNk8 .tf32 with an f32 accumulator, an
// operand element x split once into TF32 big + small (tf32.cuh: big = x
// rounded to nearest at TF32's 11 significant bits, small = x - big rounded
// to nearest), each k8 step taken as small*big + big*small + big*big, in
// that order. TF32 wgmma reads shared-memory operands K-major only, and A
// from registers or shared memory; here A is always in registers (split in
// registers from shared memory or from an accumulator) and B in shared
// memory as a split pair: big and small, each in the layout TMA writes
// (rows of 128 bytes, 128-byte swizzle; the k8 step +32 bytes, SBO 1024)
// or, for the [D, 16] tiles of the backward, rows of 64 bytes (64-byte
// swizzle, SBO 512). Which split each operand takes:
//  * register A operands (Q, K, V, K^T, p, ds, a): split in registers from
//    the f32 value;
//  * B operands whose reduction runs over d (K for S = Q K^T; Q and dO for
//    S^T = K Q^T and dP^T = V dO^T): the landed rows split chunk by chunk
//    into a big and a small tile of the same layout (the forward's K in
//    place: its raw tile becomes the big half);
//  * B operands whose reduction runs over tokens (V for P V; dO, Q for dV,
//    dK; ds for dQ): written transposed by the consumer threads into a
//    big / small pair, in the same pass that splits them. Where the A
//    operand comes from an accumulator (P, a, ds), its k index t of an n8
//    block is column 2t and k index t + 4 column 2t + 1 (acc_to_a), and the
//    transposed B takes its k rows in that order.
//
// attn_fwd_f32_kernel: a persistent grid of blocks of two warpgroups (256
// threads), each walking (sequence, head) items. An item is taken in rounds
// of two 64-query tiles (one a warpgroup) and each round in steps of KC keys
// (kKC: 64 at D = 64, 32 at D = 32; flash style: the whole head's K and V as
// TF32 pairs do not fit 227 KB at D = 64 and 256 keys). Thread 0 issues a
// step's TMA loads (K, V; Q with a round's first step, into the other of two
// Q buffers) one step ahead, into the other of two stages. A step: all 256
// threads split K in place and stage V^T's pair, one block barrier, then
// each warpgroup S = Q K^T (Q's pairs split into registers, see below), the
// online softmax update (m the running exact max, l and O rescaled by
// exp2(m_old - m_new)), p [* keep] into the register A of O += P V, a fresh
// accumulator a step added into O in f32. O / l is stored after a round's
// last step (div_rn). K11 takes a second pass over the round's steps with
// its scores recomputed on FFMA from the raw Q and K tiles (the plain GEMM's
// summation order): it writes p = exp2(s - m) (the first pass's m) and sums
// l' = sum p, then each thread rewrites the probabilities it wrote as p / l'
// (div_rn). From the 3xTF32 scores its probabilities read 1.13e-6 from the
// plain f32 ones at D = 64, past chip_smoke.py (n.1)'s 1e-6 (likely the
// tensor core's accumulation over the 24 wgmmas of a D = 64 score, which
// drops bits as it adds; not measured apart), and 1.01e-6 with FFMA scores
// over the 3xTF32 l. Its output is K10's bit for bit (the same first pass).
// Q's pairs: at D = 64 split once a round into registers; at D = 32 once a
// round in shared memory (the tile's big half in place, its small half
// beside it; S reads A from there), which keeps the kernel within 128
// registers, two blocks an SM; K11 at D = 32 splits them into registers at
// every step (its FFMA pass reads the raw tile), which keeps it at two
// blocks an SM (one, holding them a round, read 18-30% slower).
//
// The stem-fed layer (attn_fwd_ffma_f32_kernel, attn_bwd_ffma_f32_kernel):
// there the scores reach ~2^14 in log2 units, where the plain f32 version
// is itself 8e-5 from a float64 truth; a kernel stays within chip_smoke.py
// (n.2)'s 2e-5 of it only if its score sums agree with the plain GEMM's,
// as an fmaf chain over d ascending does (to ~1e-7) and 3xTF32 does not
// (7e-5 in the forward; 1.19e-4 / 7.97e-4 of dq / dk / dv in the
// backward). So those instantiations compute S (or S^T) on FFMA from the
// raw Q and K tiles, each score one fmaf chain over d ascending, the same
// expression in both directions (the backward's probabilities are the
// forward's bit for bit); every other product stays on wgmma.
// ops/layer_fused.py (stem=True) and ops/layer_fused_train.py (stem=True)
// route the stem-fed layers there.
//
// attn_bwd_f32_kernel: a block a (sequence, head), two warpgroups. K and V
// of the head land once by TMA ([Lk rounded up to 64] rows); the queries
// stream in chunks of 16 by TMA, double-buffered, one chunk ahead. Key-
// major: warpgroup w owns key tiles w and w + 2 (64 keys each; at most 128
// keys at tiers 96 and 128). Per chunk: the chunk's Q and dO split into
// pairs and staged transposed; S^T = K Q^T and dP^T = V dO^T; the row max m,
// l = sum p and sum(da p) (da = dP [* keep]), each reduced over the 8 warps
// through shared memory in warp order, so m is the exact max; row = sum(da
// p) / l, a = p / l, ds = a (da - row); dV += (a [* keep])^T dO and dK +=
// ds^T Q (register A from the accumulators); ds to shared memory as a
// [query, key] pair, then dQ^T = K^T ds^T over the warpgroup's own keys (A:
// K^T gathered from the K tile, M = 64 rows of d: at D = 32 the upper half
// is zeros, so there, at 256 keys, it runs after every second chunk over
// both chunks' ds, N = 32 queries a wgmma: 1.433 -> 1.269 ms at freq self,
// batch 8, on an H100 80GB HBM3, tools/gemm_ab.py --attn32), each key
// tile's chain in a fresh accumulator added in f32, the two warpgroups'
// halves added low + high through shared memory. The block owns every
// query and key of its head, so dq, dk and dv need no float atomics and no
// scratch in device memory: a backward is the same bits from run to run. 5
// products a chunk. Where shared memory holds them (kPairs: D
// = 32, or up to 128 keys), K and V are split once into pairs in place (K
// not in the FFMA form, whose scores read it raw) and S^T and dP^T read A
// from shared memory, dQ^T's A gathered from K's pair; at D = 64 and 256
// keys (K and V alone take 128 KB) A is split from the raw tiles a k8 step
// at a time, NB steps in flight (the pairs took the D = 32 backward at freq
// self, batch 8, from 1.749 to 1.420 ms on an H100 80GB HBM3 at 700 W:
// tools/gemm_ab.py --attn32, PERF.md).
//
// What bounds them: operations. The forward's 2 and the backward's 5 Lq x Lk
// x D products a head, each as 3 TF32 passes, at the 495 TFLOP/s TF32 peak;
// beside them every score's softmax (and hash under dropout) on the CUDA
// cores, the splits (5 f32 / integer operations an element), and, at one
// or two blocks an SM, the block barriers of a step (forward) or chunk
// (backward) left unhidden.
//
// Dropout (kDrop): head h takes hash_mask.cuh's keep mask with tag
// head_tag0 + h (K12: head_tag0 = 0; K7-K9: (tag_base + 8) * 64), row seq *
// Lq + query and column key. The forward draws it per element
// (keep_value); in the backward at 256 keys, where the draws are packed
// (one hash gives keys c and c + 128), a thread's key tiles i = 0, 1 (keys
// 64 w' + 16 warp' + ... and the same + 128) are exactly such pairs, so one
// hash serves both.

#include <type_traits>

#include "attn_tma.cuh"
#include "hash_mask.cuh"
#include "tf32.cuh"

using nylon::DropSite;
using nylon::keep_value;
using nylon::Split;
using nylon::split;
using nylon::attn::desc;
using nylon::attn::encode_view;
using nylon::attn::swz;
using nylon::attn::tma_load3;
namespace sm = nylon::sm90;

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kMaxL = 256;
// keys a forward step: 64 at D = 64 (fewer steps, barriers and wgmma
// chains an item), 32 at D = 32 (two blocks an SM need <= 128 registers)
template <int D>
constexpr int kKC = D == 64 ? 64 : 32;
constexpr int kQC = 16;  // queries a backward chunk

// ------------------------------------------------------------- helpers ----

// The f32 at (row, col) of a tile of D columns stored as D / 32 boxes of
// `rows` rows of 32 floats (128-byte swizzle), from its base.
__device__ __forceinline__ uint32_t at(int rows, int row, int col) {
  return (uint32_t)((col >> 5) * rows * 128) +
         nylon::attn::swz<128>(row, (col & 31) >> 2) + 4 * (col & 3);
}

__device__ __forceinline__ float ld_f(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

__device__ __forceinline__ float4 ld_f4(const uint8_t* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st_u4(uint8_t* p, uint32_t a, uint32_t b,
                                      uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// Four values into a big and a small quad at p_big, p_small.
__device__ __forceinline__ void split_store4(uint8_t* p_big, uint8_t* p_small,
                                             const float (&x)[4]) {
  const Split a = split(x[0]), b = split(x[1]), c = split(x[2]),
              d = split(x[3]);
  st_u4(p_big, a.big, b.big, c.big, d.big);
  st_u4(p_small, a.small, b.small, c.small, d.small);
}

__device__ __forceinline__ void split4(uint32_t (&big)[4],
                                       uint32_t (&small)[4], float a0,
                                       float a1, float a2, float a3) {
  const float x[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(x[i]);
    big[i] = s.big;
    small[i] = s.small;
  }
}

// The A operand of a k8 step from n8 block j of an accumulator x: k index t
// is column 2t (x[4j], x[4j + 2]), k index t + 4 column 2t + 1 (x[4j + 1],
// x[4j + 3]). The B operand of the same step takes its k rows in that order.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&big)[4],
                                         uint32_t (&small)[4],
                                         const float (&x)[R], int j) {
  split4(big, small, x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]);
}

// The three wgmmas of a k8 step: d (+)= small_a big_b + big_a small_b +
// big_a big_b (B descriptors b_big, b_small); more == 0 starts d afresh.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2],
                                     const uint32_t (&big)[4],
                                     const uint32_t (&small)[4],
                                     uint64_t b_big, uint64_t b_small,
                                     int more) {
  sm::WgmmaTf32<N>::mma(d, small, b_big, more);
  sm::WgmmaTf32<N>::mma(d, big, b_small, 1);
  sm::WgmmaTf32<N>::mma(d, big, b_big, 1);
}

// D[64, N] (+)= A[64, 8] B[8, N], TF32, both operands K-major
// shared-memory descriptors (N 16 or 32); scale_d == 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The three wgmmas of a k8 step with A in shared memory as a pair too (A
// descriptors a_big, a_small).
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_big,
                                        uint64_t a_small, uint64_t b_big,
                                        uint64_t b_small, int more) {
  wgmma_ss<N>(d, a_small, b_big, more);
  wgmma_ss<N>(d, a_big, b_small, 1);
  wgmma_ss<N>(d, a_big, b_big, 1);
}

// One fmaf a step over the four elements in order: the score chain of the
// FFMA forms (x from Q, y from K), d ascending.
__device__ __forceinline__ float fma4(float4 x, float4 y, float a) {
  a = fmaf(x.x, y.x, a);
  a = fmaf(x.y, y.y, a);
  a = fmaf(x.z, y.z, a);
  return fmaf(x.w, y.w, a);
}

// p / l from r = 1 / l (the correctly rounded reciprocal): one FMA
// correction of p * r gives the correctly rounded quotient (Markstein) in
// the normal range, without the library division's slow-path branch.
__device__ __forceinline__ float div_rn(float p, float l, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-l, q, p), r, q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// The key tier of a site: the backward's K and V tiles and register arrays
// cover kKeys >= lk keys (zero-filled past lk).
template <typename F>
int with_tier(int lk, F f) {
  if (lk <= 96) return f(std::integral_constant<int, 96>{});
  if (lk <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

bool bad_geometry(int n_seq, int lq, int lk, int n_heads, int head_dim) {
  return (head_dim != 32 && head_dim != 64) || n_seq <= 0 || lq <= 0 ||
         lk <= 0 || lq > kMaxL || lk > kMaxL || n_heads <= 0 ||
         n_heads > 65535 || (long long)n_seq * n_heads > 0x7fffffffLL;
}

// ------------------------------------------------------------- forward ----

struct FwdArgs {
  float* o;
  float* probs;  // K11: [n_seq, n_heads, lq, lk], else null
  int n_items, lq, lk, n_heads, o_row;
  float scale_log2e;
  uint32_t seed_mix;
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
  DropSite site;  // thresh, scale, half of the probability site
};

// attn_fwd_f32_kernel's shared memory (from a 1024-byte aligned base): two
// stages of a step's K (its big half in place), K's small half, V, and
// V^T's big and small halves (each kChunk bytes: K and V D / 32 boxes of
// [KC rows][32 floats], V^T KC / 32 boxes of [D rows][32 floats]); two
// buffers of a round's Q tiles (each warpgroup's [64 rows][D], D / 32
// boxes); at D = 32 the small halves of the warpgroups' Q tiles; the two
// stages' barriers.
template <int D>
struct FwdSmem {
  static constexpr int kChunk = kKC<D> * D * 4;
  static constexpr int kStage = 5 * kChunk;
  static constexpr int kQTile = 64 * D * 4;
  static constexpr int kQ = 2 * kStage;
  static constexpr int kQs = kQ + 4 * kQTile;
  static constexpr int kBars = kQs + (D == 32 ? 2 * kQTile : 0);
  static constexpr int kBytes = 1024 + kBars + 16;
};

// A block's place in its walk: item, round (two 64-query tiles), pass (K11:
// 1 writes the probabilities) and step (kKC keys).
struct Cursor {
  int item, round, pass, step;
};

__device__ __forceinline__ bool advance(Cursor& x, int rounds, int passes,
                                        int steps, int n_items) {
  if (++x.step < steps) return true;
  x.step = 0;
  if (++x.pass < passes) return true;
  x.pass = 0;
  if (++x.round < rounds) return true;
  x.round = 0;
  x.item += gridDim.x;
  return x.item < n_items;
}

// o[seq, q, h*D:(h+1)*D] = softmax(q_h k_h^T * scale) v_h of each (sequence,
// head) item, items blockIdx.x, + gridDim.x, ... (item = seq * n_heads + h).
// map_q: boxes of 64 rows; map_k / map_v: boxes of kKC<D> rows. kFfmaS: the
// scores on FFMA (the stem-fed layer).
template <int D, bool kDrop, bool kProbs, bool kFfmaS>
__device__ __forceinline__ void attn_fwd_f32(const CUtensorMap* map_q,
                                             const CUtensorMap* map_k,
                                             const CUtensorMap* map_v,
                                             const FwdArgs& args) {
  using L = FwdSmem<D>;
  constexpr int KS = D / 8;  // k8 steps over d
  constexpr int KC = kKC<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + L::kBars);
  const int lq = args.lq, lk = args.lk, n_heads = args.n_heads;
  const int rounds = ((lq + 63) / 64 + 1) / 2;
  const int passes = kProbs ? 2 : 1;
  const int steps = (lk + KC - 1) / KC;
  if ((int)blockIdx.x >= args.n_items) return;

  // thread 0: a step's K and V (and Q with a round's first step, into Q
  // buffer qsel) into stage st
  const auto load = [&](const Cursor& x, int st, int qsel) {
    uint8_t* const sb = base + st * L::kStage;
    const int seq = x.item / n_heads, h = x.item % n_heads;
    const bool with_q = x.pass == 0 && x.step == 0;
    sm::mbar_expect_tx(full + st, 2 * L::kChunk + (with_q ? 2 * L::kQTile : 0));
#pragma unroll
    for (int b = 0; b < D / 32; ++b) {
      tma_load3(sm::smem_u32(sb + b * KC * 128), map_k, full + st,
                h * D + 32 * b, x.step * KC, seq);
      tma_load3(sm::smem_u32(sb + 2 * L::kChunk + b * KC * 128), map_v,
                full + st, h * D + 32 * b, x.step * KC, seq);
      if (with_q)
#pragma unroll
        for (int w = 0; w < 2; ++w)
          tma_load3(sm::smem_u32(base + L::kQ + (2 * qsel + w) * L::kQTile +
                                 b * 64 * 128),
                    map_q, full + st, h * D + 32 * b, (2 * x.round + w) * 64,
                    seq);
    }
  };
  Cursor cur{(int)blockIdx.x, 0, 0, 0};
  if (threadIdx.x == 0) {
    sm::mbar_init(full, 1);
    sm::mbar_init(full + 1, 1);
    sm::fence_barrier_init();
    sm::tma_prefetch(map_q);
    sm::tma_prefetch(map_k);
    sm::tma_prefetch(map_v);
    load(cur, 0, 0);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int r_in = 16 * (tid >> 5) + g;  // the thread's rows r_in, r_in + 8
  const float sl2e = args.scale_log2e;
  const float neg_inf = __int_as_float(0xff800000u);
  // the Q tile as TF32 pairs (see the head note): in shared memory once a
  // round (kQPairs), in registers once a round (kCacheQ), or in registers
  // at every step (K11 at D = 32, within 128 registers)
  constexpr bool kQPairs = D == 32 && !kFfmaS && !kProbs;
  constexpr bool kCacheQ = D == 64 && !kFfmaS;
  uint32_t qb[KS][4], qs[KS][4];
  const auto split_q = [&](const uint8_t* qt) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Split x = split(ld_f(
            qt + at(64, r_in + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1))));
        qb[kk][i] = x.big;
        qs[kk][i] = x.small;
      }
  };
  float o[D / 2], m[2], l[2], lf[2];  // lf: K11's l on its FFMA scores
  int k = 0, rc = 0;  // steps and rounds done
  for (;;) {
    const int st = k & 1;
    uint8_t* const sb = base + st * L::kStage;
    if (k > 0 && cur.pass == 0 && cur.step == 0) ++rc;
    sm::mbar_wait(full + st, (k >> 1) & 1);
    // K's pair in place (its raw tile becomes the big half; not where the
    // scores are on FFMA, as in K11's second pass), V^T's pair (row d, k
    // positions 8j + p: key 8j + 2p for p < 4, 8j + 2(p - 4) + 1 for p >=
    // 4, the order of acc_to_a)
    const bool ffma = kFfmaS || (kProbs && cur.pass > 0);
    if (!ffma) {
      for (int e = threadIdx.x; e < KC * D / 4; e += kThreads) {
        const float4 x = ld_f4(sb + 16 * e);
        const float v[4] = {x.x, x.y, x.z, x.w};
        split_store4(sb + 16 * e, sb + L::kChunk + 16 * e, v);
      }
    }
    for (int e = threadIdx.x; e < D * (KC / 4); e += kThreads) {
      const int d = e % D, pc = e / D;
      const int key0 = 8 * (pc >> 1) + (pc & 1);
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = ld_f(sb + 2 * L::kChunk + at(KC, key0 + 2 * u, d));
      const uint32_t off = (pc >> 3) * D * 128 + swz<128>(d, pc & 7);
      split_store4(sb + 3 * L::kChunk + off, sb + 4 * L::kChunk + off, v);
    }
    sm::fence_async_smem();
    __syncthreads();  // the step's pairs; every thread's last step is done
    Cursor nx = cur;
    const bool more = advance(nx, rounds, passes, steps, args.n_items);
    if (threadIdx.x == 0 && more)
      load(nx, st ^ 1, (rc + (nx.pass == 0 && nx.step == 0)) & 1);

    const int seq = cur.item / n_heads, h = cur.item % n_heads;
    const int tile = 2 * cur.round + wg;
    uint8_t* const qt = base + L::kQ + (2 * (rc & 1) + wg) * L::kQTile;
    uint8_t* const qsm = base + L::kQs + wg * L::kQTile;  // with kQPairs
    if (cur.pass == 0 && cur.step == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = neg_inf;
      l[0] = l[1] = 0.f;
      if constexpr (kQPairs) {
        for (int e = tid; e < 64 * D / 4; e += 128) {
          const float4 x = ld_f4(qt + 16 * e);
          const float v[4] = {x.x, x.y, x.z, x.w};
          split_store4(qt + 16 * e, qsm + 16 * e, v);
        }
        sm::fence_async_smem();
        sm::named_sync(1 + wg, 128);
      } else if constexpr (kCacheQ) {
        split_q(qt);
      }
    }
    // S = Q K^T of the warpgroup's 64 rows and the step's KC keys: s[4j +
    // 2i + c] at row r_in + 8i, key 8j + 2t + c of the step
    float s[KC / 2];
    if (ffma) {
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) s[i] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 q0 = ld_f4(qt + at(64, r_in, d));
        const float4 q1 = ld_f4(qt + at(64, r_in + 8, d));
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 kv = ld_f4(sb + at(KC, 8 * j + 2 * t + c, d));
            s[4 * j + c] = fma4(q0, kv, s[4 * j + c]);
            s[4 * j + 2 + c] = fma4(q1, kv, s[4 * j + 2 + c]);
          }
      }
    } else if constexpr (!kFfmaS) {
      const uint32_t kb = sm::smem_u32(sb), ks = kb + L::kChunk;
      const uint32_t qa = sm::smem_u32(qt), qas = sm::smem_u32(qsm);
      if constexpr (!kQPairs && !kCacheQ) split_q(qt);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk >> 2) * KC * 128 + 32 * (kk & 3);
        if constexpr (kQPairs) {
          const uint32_t a = (kk >> 2) * 64 * 128 + 32 * (kk & 3);
          mma3_ss<KC>(s, desc<128>(qa + a), desc<128>(qas + a),
                      desc<128>(kb + off), desc<128>(ks + off), kk);
        } else {
          mma3<KC>(s, qb[kk], qs[kk], desc<128>(kb + off),
                   desc<128>(ks + off), kk);
        }
      }
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(s);
    }
    const int key0 = cur.step * KC;
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const float x = __fmul_rn(s[i], sl2e);
      s[i] = key0 + 8 * (i >> 2) + 2 * t + (i & 1) < lk ? x : neg_inf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    if (cur.pass == 1) {
      // K11: p = exp2(s - m) on the FFMA scores to probs, l' summed; after
      // the round's last step each thread rewrites its own p as p / l'
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = tile * 64 + r_in + 8 * hr;
        float* const pr =
            args.probs + (((size_t)seq * n_heads + h) * lq + q) * lk;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[4 * j + 2 * hr + c] - m[hr]);  // 0 past lk
            sum[hr] += p;
            const int key = key0 + 8 * j + 2 * t + c;
            if (q < lq && key < lk) pr[key] = p;
          }
        lf[hr] = (cur.step == 0 ? 0.f : lf[hr]) + quad_sum(sum[hr]);
        if (cur.step == steps - 1 && q < lq) {
          const float rr = __frcp_rn(lf[hr]);
          for (int key = 2 * t; key < lk; key += 8)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (key + c < lk) pr[key + c] = div_rn(pr[key + c], lf[hr], rr);
        }
      }
    } else {
      DropSite hsite = args.site;
      if constexpr (kDrop)
        hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
      float al[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float mn = fmaxf(m[hr], quad_max(mx[hr]));
        al[hr] = exp2f(m[hr] - mn);  // 0 at a round's first step
        m[hr] = mn;
      }
      const uint32_t row0 =
          (uint32_t)seq * (uint32_t)lq + (uint32_t)(tile * 64 + r_in);
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        const int hr = (i >> 1) & 1;
        const float p = exp2f(s[i] - m[hr]);  // 0 past lk
        sum[hr] += p;
        s[i] = p;
        if constexpr (kDrop) {
          const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (key < lk)
            s[i] = p * keep_value(hsite, row0 + 8 * hr, key, lk);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        l[hr] = __fmaf_rn(l[hr], al[hr], quad_sum(sum[hr]));
      // O = O al + P V_step: P from the score registers, V^T's pair
      uint32_t pb[KC / 8][4], ps[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) acc_to_a(pb[j], ps[j], s, j);
      const uint32_t vb = sm::smem_u32(sb + 3 * L::kChunk),
                     vs = sm::smem_u32(sb + 4 * L::kChunk);
      float part[D / 2];
      sm::wgmma_fence();
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
        mma3<D>(part, pb[j], ps[j],
                desc<128>(vb + (j >> 2) * D * 128 + 32 * (j & 3)),
                desc<128>(vs + (j >> 2) * D * 128 + 32 * (j & 3)), j);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o[i] = __fmaf_rn(o[i], al[(i >> 1) & 1], part[i]);
      if (cur.step == steps - 1) {
        // O / l: o[4 nd + 2 hr + c] at row r_in + 8 hr, column 8 nd + 2t + c
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int q = tile * 64 + r_in + 8 * hr;
          if (q >= lq) continue;
          const float rr = __frcp_rn(l[hr]);
          float* const dst = args.o +
                             ((long long)seq * lq + q) * args.o_row +
                             h * D + 2 * t;
#pragma unroll
          for (int nd = 0; nd < D / 8; ++nd)
            *reinterpret_cast<float2*>(dst + 8 * nd) =
                make_float2(div_rn(o[4 * nd + 2 * hr], l[hr], rr),
                            div_rn(o[4 * nd + 2 * hr + 1], l[hr], rr));
        }
      }
    }
    if (!more) break;
    cur = nx;
    ++k;
  }
}

template <int D, bool kDrop, bool kProbs>
__global__ void __launch_bounds__(kThreads, D == 32 ? 2 : 1)
    attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const FwdArgs args) {
  attn_fwd_f32<D, kDrop, kProbs, false>(&map_q, &map_k, &map_v, args);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, D == 32 ? 2 : 1)
    attn_fwd_ffma_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const FwdArgs args) {
  attn_fwd_f32<D, kDrop, false, true>(&map_q, &map_k, &map_v, args);
}

// ------------------------------------------------------------ backward ----

struct BwdArgs {
  float* dq;
  float* dk;
  float* dv;
  int lq, lk;
  long long dq_row, dq_seq, dkv_row, dkv_seq;
  float scale, scale_log2e;
  uint32_t seed_mix;
  int head_tag0;
  DropSite site;
};

// attn_bwd_f32_kernel's shared memory (from a 1024-byte aligned base): K
// and V ([kK64 rows][D], D / 32 boxes each) and, with kPairs, their small
// halves (the same layout); two stages of a chunk's raw Q
// and dO ([kQC rows][D] each); the chunk's pairs: Q and dO big and small
// ([kQC][D], the raw layout), Q^T and dO^T big and small ([D rows][kQC],
// 64-byte rows); ds big and small ([kQD kQC rows][kK64 keys], kK64 / 32
// boxes of [kQD kQC][32], chunk c at rows kQC (c % kQD)); the per-warp
// partial max, l and sum(da p) of the chunk's queries [3][8][kQC]; the high
// key half of dQ^T [128 threads][kQD kQC / 2]; the barriers (K and V; the
// two stages).
template <int D, int kKeys>
struct BwdSmem {
  static constexpr int kK64 = (kKeys + 63) / 64 * 64;
  static constexpr int kKV = kK64 * D * 4;
  static constexpr int kRows = kQC * D * 4;  // also [D][kQC]
  // K and V split once into pairs (each tile's big half in place, the
  // small halves beside them), where shared memory holds them: S^T and
  // dP^T then read A from shared memory (no per-chunk split)
  static constexpr bool kPairs = D == 32 || kKeys <= 128;
  static constexpr int kK = 0, kV = kKV;
  static constexpr int kKs = 2 * kKV, kVs = 3 * kKV;  // with kPairs
  static constexpr int kStage0 = (kPairs ? 4 : 2) * kKV;  // + st * 2 kRows
  static constexpr int kConv = kStage0 + 4 * kRows;
  // kConv + i kRows: Qb, Qs, dOb, dOs, QTb, QTs, dOTb, dOTs
  static constexpr int kDs = kConv + 8 * kRows;  // big, then small
  // the chunks one dQ^T takes: two at D = 32, whose M = 64 rows of d are
  // half zeros, so that each of its wgmmas spans N = 32 queries (ds of both
  // chunks side by side), at 256 keys (one block an SM already); at 96 and
  // 128 keys the second ds tile would leave one block an SM instead of two
  // (note and time self read 0.339 -> 0.435 and 0.316 -> 0.398 ms on an
  // H100 80GB HBM3, tools/gemm_ab.py --attn32)
  static constexpr int kQD = D == 32 && kKeys > 128 ? 2 : 1;
  static constexpr int kDsBytes = kK64 * kQD * kQC * 4;
  static constexpr int kRed = kDs + 2 * kDsBytes;
  static constexpr int kXchg = kRed + 3 * 8 * kQC * 4;
  static constexpr int kBars = kXchg + 128 * 2 * kQD * kQC;
  static constexpr int kBytes = 1024 + kBars + 32;
};

// dq, dk, dv of one (sequence, head) (blockIdx.x, blockIdx.y), see the head
// note. The maps: q and dO in boxes of kQC rows, k and v of kK64 rows.
template <int D, int kKeys, bool kDrop, bool kFfmaS>
__device__ __forceinline__ void attn_bwd_f32(const CUtensorMap* map_q,
                                             const CUtensorMap* map_k,
                                             const CUtensorMap* map_v,
                                             const CUtensorMap* map_do,
                                             const BwdArgs& args) {
  using L = BwdSmem<D, kKeys>;
  constexpr int KS = D / 8;                       // k8 steps over d
  constexpr int NKT = kKeys > 128 ? 2 : 1;        // key tiles a warpgroup
  constexpr int NJ = kQC / 8;                     // n8 blocks of a chunk
  constexpr int NQ = L::kQD * kQC;                // queries a dQ^T
  // k8 steps of A fragments in flight in the S^T / dP^T and dQ^T chains
  // (registers: 16 / 8 a step)
  constexpr int NB = D == 32 ? 4 : 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + L::kBars);
  float* const red_m = reinterpret_cast<float*>(base + L::kRed);
  float* const red_l = red_m + 8 * kQC;  // [8 warps][kQC] each
  float* const red_r = red_l + 8 * kQC;
  float* const xchg = reinterpret_cast<float*>(base + L::kXchg);
  const int lq = args.lq, lk = args.lk;
  const int seq = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_in = 16 * (tid >> 5) + g;  // rows r_in, r_in + 8 of a tile
  const int nchunks = (lq + kQC - 1) / kQC;

  // thread 0: chunk c's Q and dO into stage st
  const auto load_chunk = [&](int c, int st) {
    uint8_t* const sb = base + L::kStage0 + st * 2 * L::kRows;
    sm::mbar_expect_tx(full + 1 + st, 2 * L::kRows);
#pragma unroll
    for (int b = 0; b < D / 32; ++b) {
      tma_load3(sm::smem_u32(sb + b * kQC * 128), map_q, full + 1 + st,
                h * D + 32 * b, c * kQC, seq);
      tma_load3(sm::smem_u32(sb + L::kRows + b * kQC * 128), map_do,
                full + 1 + st, h * D + 32 * b, c * kQC, seq);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) sm::mbar_init(full + i, 1);
    sm::fence_barrier_init();
    sm::mbar_expect_tx(full, 2 * L::kKV);
#pragma unroll
    for (int b = 0; b < D / 32; ++b) {
      tma_load3(sm::smem_u32(base + L::kK + b * L::kK64 * 128), map_k, full,
                h * D + 32 * b, 0, seq);
      tma_load3(sm::smem_u32(base + L::kV + b * L::kK64 * 128), map_v, full,
                h * D + 32 * b, 0, seq);
    }
    load_chunk(0, 0);
  }
  __syncthreads();

  const float sl2e = args.scale_log2e, scale = args.scale;
  const float neg_inf = __int_as_float(0xff800000u);
  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const uint32_t row0 = (uint32_t)seq * (uint32_t)lq;
  const uint8_t* const Kr = base + L::kK;
  const uint8_t* const Vr = base + L::kV;
  uint8_t* const cv = base + L::kConv;
  const uint32_t cvs = sm::smem_u32(cv);
  uint8_t* const dsb = base + L::kDs;
  uint8_t* const dss = dsb + L::kDsBytes;

  float dk[NKT][D / 2], dv[NKT][D / 2];
#pragma unroll
  for (int i = 0; i < NKT; ++i)
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk[i][x] = dv[i][x] = 0.f;

  sm::mbar_wait(full, 0);  // K and V
  if constexpr (L::kPairs) {
    // K (not with kFfmaS, whose S^T reads it raw) and V split in place,
    // their small halves beside them; made visible to the wgmmas by the
    // first chunk's fence and barrier
    for (int e = threadIdx.x; e < L::kKV / 16; e += kThreads) {
      const float4 y = ld_f4(base + L::kV + 16 * e);
      const float w[4] = {y.x, y.y, y.z, y.w};
      split_store4(base + L::kV + 16 * e, base + L::kVs + 16 * e, w);
      if constexpr (!kFfmaS) {
        const float4 x = ld_f4(base + L::kK + 16 * e);
        const float v[4] = {x.x, x.y, x.z, x.w};
        split_store4(base + L::kK + 16 * e, base + L::kKs + 16 * e, v);
      }
    }
  }
  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1, qc0 = c * kQC;
    const uint8_t* const qr = base + L::kStage0 + st * 2 * L::kRows;
    const uint8_t* const dr = qr + L::kRows;
    sm::mbar_wait(full + 1 + st, (c >> 1) & 1);
    // the chunk's pairs: Q (not with kFfmaS) and dO split chunk-wise; Q^T
    // and dO^T (row d, k positions 8j + p: query 8j + 2p for p < 4, 8j +
    // 2(p - 4) + 1 for p >= 4, the order of acc_to_a)
    for (int e = threadIdx.x; e < kQC * D / 4; e += kThreads) {
      const float4 y = ld_f4(dr + 16 * e);
      const float w[4] = {y.x, y.y, y.z, y.w};
      split_store4(cv + 2 * L::kRows + 16 * e, cv + 3 * L::kRows + 16 * e, w);
      if constexpr (!kFfmaS) {
        const float4 x = ld_f4(qr + 16 * e);
        const float v[4] = {x.x, x.y, x.z, x.w};
        split_store4(cv + 16 * e, cv + L::kRows + 16 * e, v);
      }
    }
    for (int e = threadIdx.x; e < D * (kQC / 4); e += kThreads) {
      const int d = e % D, pc = e / D;
      const int q0 = 8 * (pc >> 1) + (pc & 1);
      float v[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = ld_f(qr + at(kQC, q0 + 2 * u, d));
        w[u] = ld_f(dr + at(kQC, q0 + 2 * u, d));
      }
      const uint32_t off = swz<64>(d, pc);
      split_store4(cv + 4 * L::kRows + off, cv + 5 * L::kRows + off, v);
      split_store4(cv + 6 * L::kRows + off, cv + 7 * L::kRows + off, w);
    }
    sm::fence_async_smem();
    __syncthreads();  // the pairs; the last chunk's products are done
    if (threadIdx.x == 0 && c + 1 < nchunks) load_chunk(c + 1, st ^ 1);

    // S^T = K Q^T and dP^T = V dO^T of the warpgroup's key tiles (warp's
    // rows r_in, r_in + 8 of tile kt = wg + 2i): element (i, 4j + r) at key
    // 64 kt + r_in + 8 (r >> 1), query qc0 + 8j + 2t + (r & 1)
    float st_[NKT][kQC / 2], dpt[NKT][kQC / 2];
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int key0 = 64 * (wg + 2 * i) + r_in;
      if constexpr (kFfmaS) {
        // S^T on FFMA: each score the forward's fmaf chain
#pragma unroll
        for (int x = 0; x < kQC / 2; ++x) st_[i][x] = 0.f;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
          const float4 ka = ld_f4(Kr + at(L::kK64, key0, d));
          const float4 kb = ld_f4(Kr + at(L::kK64, key0 + 8, d));
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 qa = ld_f4(qr + at(kQC, 8 * j + 2 * t, d));
            const float4 qb = ld_f4(qr + at(kQC, 8 * j + 2 * t + 1, d));
            st_[i][4 * j] = fma4(qa, ka, st_[i][4 * j]);
            st_[i][4 * j + 1] = fma4(qb, ka, st_[i][4 * j + 1]);
            st_[i][4 * j + 2] = fma4(qa, kb, st_[i][4 * j + 2]);
            st_[i][4 * j + 3] = fma4(qb, kb, st_[i][4 * j + 3]);
          }
        }
      }
      if constexpr (L::kPairs) {
        // A from the pairs in shared memory: the tile's 64 key rows
        const uint32_t kb = sm::smem_u32(base + L::kK),
                       ks = sm::smem_u32(base + L::kKs),
                       vb = sm::smem_u32(base + L::kV),
                       vs = sm::smem_u32(base + L::kVs);
        sm::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t a = (kk >> 2) * L::kK64 * 128 +
                             (wg + 2 * i) * 64 * 128 + 32 * (kk & 3);
          const uint32_t off = (kk >> 2) * kQC * 128 + 32 * (kk & 3);
          if constexpr (!kFfmaS)
            mma3_ss<kQC>(st_[i], desc<128>(kb + a), desc<128>(ks + a),
                         desc<128>(cvs + off), desc<128>(cvs + L::kRows + off),
                         kk);
          mma3_ss<kQC>(dpt[i], desc<128>(vb + a), desc<128>(vs + a),
                       desc<128>(cvs + 2 * L::kRows + off),
                       desc<128>(cvs + 3 * L::kRows + off), kk);
        }
        sm::wgmma_commit();
        sm::wgmma_wait<0>();
        sm::fence_regs(st_[i]);
        sm::fence_regs(dpt[i]);
        continue;
      }
      // a k8 step's A fragments split while the last NB - 1 steps' wgmmas
      // run (each step's pairs in a buffer of their own until it retires)
      uint32_t kbig[NB][4], ksm[NB][4], vbig[NB][4], vsm[NB][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int b = kk % NB;
        float kx[4], vx[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t off =
              at(L::kK64, key0 + 8 * (u & 1), 8 * kk + t + 4 * (u >> 1));
          if constexpr (!kFfmaS) kx[u] = ld_f(Kr + off);
          vx[u] = ld_f(Vr + off);
        }
        if constexpr (!kFfmaS) split4(kbig[b], ksm[b], kx[0], kx[1], kx[2], kx[3]);
        split4(vbig[b], vsm[b], vx[0], vx[1], vx[2], vx[3]);
        const uint32_t off = (kk >> 2) * kQC * 128 + 32 * (kk & 3);
        sm::wgmma_fence();
        if constexpr (!kFfmaS)
          mma3<kQC>(st_[i], kbig[b], ksm[b], desc<128>(cvs + off),
                    desc<128>(cvs + L::kRows + off), kk);
        mma3<kQC>(dpt[i], vbig[b], vsm[b],
                  desc<128>(cvs + 2 * L::kRows + off),
                  desc<128>(cvs + 3 * L::kRows + off), kk);
        sm::wgmma_commit();
        sm::wgmma_wait<NB - 1>();
      }
      sm::wgmma_wait<0>();
      sm::fence_regs(st_[i]);
      sm::fence_regs(dpt[i]);
    }
    // the scaled scores, -inf past lk, and the exact max of each query
    float pm[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) pm[j][0] = pm[j][1] = neg_inf;
#pragma unroll
    for (int i = 0; i < NKT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = 64 * (wg + 2 * i) + r_in + (r >> 1) * 8;
          const float x = __fmul_rn(st_[i][4 * j + r], sl2e);
          st_[i][4 * j + r] = key < lk ? x : neg_inf;
          pm[j][r & 1] = fmaxf(pm[j][r & 1], st_[i][4 * j + r]);
        }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float mm = col_max(pm[j][e]);
        if (g == 0) red_m[warp * kQC + j * 8 + 2 * t + e] = mm;
      }
    __syncthreads();
    float mq[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mm = red_m[j * 8 + 2 * t + e];
#pragma unroll
        for (int w = 1; w < 8; ++w)
          mm = fmaxf(mm, red_m[w * kQC + j * 8 + 2 * t + e]);
        mq[j][e] = mm;
      }
    // p = exp2(s - m) in place; da = dP [* keep] in place; partial l and
    // sum(da p) over this warp's keys (the keep bit of element (i, j, r) in
    // bit (i * NJ + j) * 4 + r of kbits)
    uint32_t kbits = 0u;
    if constexpr (kDrop) {
      if (kKeys == 256 && hsite.half == 128) {
        // packed draws: key tiles i = 0, 1 hold keys c and c + 128, which
        // one hash gives
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = qc0 + j * 8 + 2 * t + (r & 1);
            const uint32_t cc = (uint32_t)(64 * wg + r_in + (r >> 1) * 8);
            const uint32_t x = nylon::hash_mix(
                (hsite.base + (row0 + q) * 128u + cc) ^ hsite.key);
            const uint32_t ok = q < lq ? 1u : 0u;
            kbits |= (ok & (uint32_t)((x & 0xFFFFu) >= hsite.thresh))
                     << (j * 4 + r);
            kbits |= (ok & (uint32_t)((x >> 16) >= hsite.thresh))
                     << ((NJ + j) * 4 + r);
          }
      } else {
#pragma unroll
        for (int i = 0; i < NKT; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int key = 64 * (wg + 2 * i) + r_in + (r >> 1) * 8;
              const int q = qc0 + j * 8 + 2 * t + (r & 1);
              const bool keep = key < lk && q < lq &&
                                keep_value(hsite, row0 + q, key, lk) != 0.f;
              kbits |= (uint32_t)keep << ((i * NJ + j) * 4 + r);
            }
      }
    }
    float pl[NJ][2], pr[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      pl[j][0] = pl[j][1] = pr[j][0] = pr[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < NKT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r & 1;
          const float p = exp2f(st_[i][4 * j + r] - mq[j][e]);  // 0 past lk
          float da = dpt[i][4 * j + r];
          if constexpr (kDrop)
            da *= (kbits >> ((i * NJ + j) * 4 + r)) & 1u ? hsite.scale : 0.f;
          st_[i][4 * j + r] = p;
          dpt[i][4 * j + r] = da;
          pl[j][e] += p;
          pr[j][e] += da * p;
        }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ll = col_sum(pl[j][e]), rr = col_sum(pr[j][e]);
        if (g == 0) {
          red_l[warp * kQC + j * 8 + 2 * t + e] = ll;
          red_r[warp * kQC + j * 8 + 2 * t + e] = rr;
        }
      }
    __syncthreads();
    float lsum[NJ][2], rcp[NJ][2], rowq[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float ll = 0.f, rr = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          ll += red_l[w * kQC + j * 8 + 2 * t + e];
          rr += red_r[w * kQC + j * 8 + 2 * t + e];
        }
        lsum[j][e] = ll;
        rcp[j][e] = __frcp_rn(ll);
        rowq[j][e] = div_rn(rr, ll, rcp[j][e]);
      }
    // a = p / l; ad = a [* keep]; ds = a (da - row); ds to shared memory as
    // a [query, key] pair; dV += ad^T dO and dK += ds^T Q (the k8 step of
    // n8 block j takes queries 8j + 2t, 8j + 2t + 1: Q^T's and dO^T's k
    // order)
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int kt = wg + 2 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r & 1;
          const int key = 64 * kt + r_in + (r >> 1) * 8;
          const int ql = j * 8 + 2 * t + e, q = qc0 + ql;
          float ad = 0.f, ds = 0.f;
          if (q < lq && key < lk) {
            const float a = div_rn(st_[i][4 * j + r], lsum[j][e], rcp[j][e]);
            float mk = 1.f;
            if constexpr (kDrop)
              mk = (kbits >> ((i * NJ + j) * 4 + r)) & 1u ? hsite.scale : 0.f;
            ad = a * mk;
            ds = a * (dpt[i][4 * j + r] - rowq[j][e]);
          }
          st_[i][4 * j + r] = ad;
          dpt[i][4 * j + r] = ds;
          const Split sp = split(ds);
          const uint32_t off = (key >> 5) * NQ * 128 +
                               swz<128>(ql + kQC * (c % L::kQD),
                                        (key & 31) >> 2) +
                               4 * (key & 3);
          *reinterpret_cast<uint32_t*>(dsb + off) = sp.big;
          *reinterpret_cast<uint32_t*>(dss + off) = sp.small;
        }
      uint32_t ab[NJ][4], as_[NJ][4], sb_[NJ][4], ss_[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc_to_a(ab[j], as_[j], st_[i], j);
        acc_to_a(sb_[j], ss_[j], dpt[i], j);
      }
      sm::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3<D>(dv[i], ab[j], as_[j], desc<64>(cvs + 6 * L::kRows + 32 * j),
                desc<64>(cvs + 7 * L::kRows + 32 * j), 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3<D>(dk[i], sb_[j], ss_[j], desc<64>(cvs + 4 * L::kRows + 32 * j),
                desc<64>(cvs + 5 * L::kRows + 32 * j), 1);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
    }
    if (c % L::kQD != L::kQD - 1 && c + 1 < nchunks) continue;
    sm::fence_async_smem();
    sm::named_sync(1 + wg, 128);  // the warpgroup's ds

    // dQ^T [64 rows of d, NQ] = K^T ds^T over the warpgroup's keys for the
    // queries from qp0 (the last kQD chunks; past lq when nchunks is not a
    // multiple of kQD: their columns are not stored): A = K^T gathered from
    // the K tile (rows d >= D zeros), B = ds's pair (k8 step s of tile kt:
    // keys 64 kt + 8s ..); a fresh chain a key tile
    const int qp0 = (c - c % L::kQD) * kQC;
    float dqa[NQ / 2];
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const int kt = wg + 2 * i;
      float part[NQ / 2];
      uint32_t abig[NB][4], asm_[NB][4];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int b = s % NB;
        if constexpr (L::kPairs && !kFfmaS) {
          // K^T's pair gathered from K's
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = r_in + 8 * (u & 1);
            const int key = 64 * kt + 8 * s + t + 4 * (u >> 1);
            const uint32_t off = at(L::kK64, key, d);
            abig[b][u] = d < D ? *reinterpret_cast<const uint32_t*>(Kr + off)
                               : 0u;
            asm_[b][u] = d < D ? *reinterpret_cast<const uint32_t*>(
                                     base + L::kKs + off)
                               : 0u;
          }
        } else {
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = r_in + 8 * (u & 1);
            const int key = 64 * kt + 8 * s + t + 4 * (u >> 1);
            x[u] = d < D ? ld_f(Kr + at(L::kK64, key, d)) : 0.f;
          }
          split4(abig[b], asm_[b], x[0], x[1], x[2], x[3]);
        }
        const int key8 = 64 * kt + 8 * s;
        const uint32_t off = (key8 >> 5) * NQ * 128 + 32 * ((key8 & 31) >> 3);
        sm::wgmma_fence();
        mma3<NQ>(part, abig[b], asm_[b], desc<128>(sm::smem_u32(dsb) + off),
                 desc<128>(sm::smem_u32(dss) + off), s);
        sm::wgmma_commit();
        sm::wgmma_wait<NB - 1>();
      }
      sm::wgmma_wait<0>();
      sm::fence_regs(part);
#pragma unroll
      for (int x = 0; x < NQ / 2; ++x)
        dqa[x] = i == 0 ? part[x] : dqa[x] + part[x];
    }
    // the two warpgroups' halves, low + high; dqa[4j + r]: d = r_in + 8 (r
    // >> 1), query qp0 + 8j + 2t + (r & 1)
    float4* const xp = reinterpret_cast<float4*>(xchg) + (NQ / 8) * tid;
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
        xp[j] = make_float4(dqa[4 * j], dqa[4 * j + 1], dqa[4 * j + 2],
                            dqa[4 * j + 3]);
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float4 hv = xp[j];
        const float hi[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = r_in + 8 * (r >> 1);
          const int q = qp0 + 8 * j + 2 * t + (r & 1);
          if (d < D && q < lq)
            args.dq[seq * args.dq_seq + (long long)q * args.dq_row + h * D +
                    d] = (dqa[4 * j + r] + hi[r]) * scale;
        }
      }
    }
  }
  sm::fence_regs(dk[0]);
  sm::fence_regs(dv[0]);
  if constexpr (NKT > 1) {
    sm::fence_regs(dk[NKT - 1]);
    sm::fence_regs(dv[NKT - 1]);
  }

  // dK (times scale) and dV of the warpgroup's keys: element 4 nd + 2 hr +
  // c at key 64 kt + r_in + 8 hr, column 8 nd + 2t + c
#pragma unroll
  for (int i = 0; i < NKT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = 64 * (wg + 2 * i) + r_in + 8 * hr;
      if (key >= lk) continue;
      const long long off = seq * args.dkv_seq +
                            (long long)key * args.dkv_row + h * D + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<float2*>(args.dk + off + nd * 8) =
            make_float2(dk[i][4 * nd + 2 * hr] * scale,
                        dk[i][4 * nd + 2 * hr + 1] * scale);
        *reinterpret_cast<float2*>(args.dv + off + nd * 8) =
            make_float2(dv[i][4 * nd + 2 * hr], dv[i][4 * nd + 2 * hr + 1]);
      }
    }
}

template <int D, int kKeys, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const BwdArgs args) {
  attn_bwd_f32<D, kKeys, kDrop, false>(&map_q, &map_k, &map_v, &map_do,
                                       args);
}

template <int D, int kKeys, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_ffma_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const BwdArgs args) {
  attn_bwd_f32<D, kKeys, kDrop, true>(&map_q, &map_k, &map_v, &map_do, args);
}

// ----------------------------------------------------------------- host ----

struct Views {  // the forward's pointers and strides (elements)
  const void *q, *k, *v;
  int n_seq;
  long long q_row, q_seq, kv_row, kv_seq;
};

// The resident blocks an SM of `kernel` with `smem` bytes, after the
// shared-memory opt-in; a negative CUDA status on failure.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <int D, bool kDrop, bool kProbs, bool kFfmaS>
int launch_fwd(const Views& w, const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e = encode_view(&mq, w.q, 4, w.n_seq, a.lq, a.n_heads, D, w.q_row,
                      w.q_seq, 64);
  if (!e)
    e = encode_view(&mk, w.k, 4, w.n_seq, a.lk, a.n_heads, D, w.kv_row,
                    w.kv_seq, kKC<D>);
  if (!e)
    e = encode_view(&mv, w.v, 4, w.n_seq, a.lk, a.n_heads, D, w.kv_row,
                    w.kv_seq, kKC<D>);
  if (e) return e;
  constexpr int smem = FwdSmem<D>::kBytes;
  const auto kernel = [] {
    if constexpr (kFfmaS)
      return attn_fwd_ffma_f32_kernel<D, kDrop>;
    else
      return attn_fwd_f32_kernel<D, kDrop, kProbs>;
  }();
  // the persistent grid: every block the card holds at once, found once
  static int most = 0;
  if (most == 0) {
    const int per_sm = blocks_per_sm(kernel, smem);
    int dev = 0, sms = 0;
    cudaError_t ce = cudaGetDevice(&dev);
    if (ce == cudaSuccess)
      ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (ce != cudaSuccess) return (int)ce;
    if (per_sm < 0) return -per_sm;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    most = per_sm * sms;
  }
  const int grid = a.n_items < most ? a.n_items : most;
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kProbs, bool kFfmaS>
int launch_attention(const Views& w, const FwdArgs& a, int head_dim,
                     cudaStream_t stream) {
  return head_dim == 32
             ? launch_fwd<32, kDrop, kProbs, kFfmaS>(w, a, stream)
             : launch_fwd<64, kDrop, kProbs, kFfmaS>(w, a, stream);
}

FwdArgs fwd_args(void* o, void* probs, int n_seq, int lq, int lk,
                 int n_heads, int head_dim, float scale_log2e) {
  FwdArgs a{};
  a.o = (float*)o;
  a.probs = (float*)probs;
  a.n_items = n_seq * n_heads;
  a.lq = lq;
  a.lk = lk;
  a.n_heads = n_heads;
  a.o_row = n_heads * head_dim;
  a.scale_log2e = scale_log2e;
  return a;
}

struct BwdViews {  // the backward's pointers and row strides (elements)
  const void *q, *k, *v, *dout;
  int n_seq, n_heads;
  long long q_row, kv_row, do_row;
};

template <int D, int kKeys, bool kDrop, bool kFfmaS>
int launch_bwd(const BwdViews& w, const BwdArgs& a, cudaStream_t stream) {
  using L = BwdSmem<D, kKeys>;
  const int lq = a.lq, lk = a.lk;
  CUtensorMap mq, mk, mv, mdo;
  int e = encode_view(&mq, w.q, 4, w.n_seq, lq, w.n_heads, D, w.q_row,
                      w.q_row * lq, kQC);
  if (!e)
    e = encode_view(&mk, w.k, 4, w.n_seq, lk, w.n_heads, D, w.kv_row,
                    w.kv_row * lk, L::kK64);
  if (!e)
    e = encode_view(&mv, w.v, 4, w.n_seq, lk, w.n_heads, D, w.kv_row,
                    w.kv_row * lk, L::kK64);
  if (!e)
    e = encode_view(&mdo, w.dout, 4, w.n_seq, lq, w.n_heads, D, w.do_row,
                    w.do_row * lq, kQC);
  if (e) return e;
  const auto kernel = [] {
    if constexpr (kFfmaS)
      return attn_bwd_ffma_f32_kernel<D, kKeys, kDrop>;
    else
      return attn_bwd_f32_kernel<D, kKeys, kDrop>;
  }();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (ce != cudaSuccess) return (int)ce;
    attr_set = true;
  }
  kernel<<<dim3(w.n_seq, w.n_heads), kThreads, L::kBytes, stream>>>(
      mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kFfmaS>
int launch_attn_bwd(const BwdViews& w, const BwdArgs& a, int head_dim,
                    cudaStream_t stream) {
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32
               ? launch_bwd<32, kKeys, kDrop, kFfmaS>(w, a, stream)
               : launch_bwd<64, kKeys, kDrop, kFfmaS>(w, a, stream);
  });
}

// The f32 attention forward, its scores on FFMA when ffma_scores; with
// active, head h's probabilities carry the keep mask of tag head_tag0 + h.
int attention_f32(bool ffma_scores, const void* q, const void* k,
                  const void* v, void* o, int n_seq, int lq, int lk,
                  int n_heads, int head_dim, long long q_row,
                  long long q_seq, long long kv_row, long long kv_seq,
                  float scale_log2e, int active, unsigned seed_mix,
                  int head_tag0, unsigned thresh, float scale, int half,
                  void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  const Views w{q, k, v, n_seq, q_row, q_seq, kv_row, kv_seq};
  FwdArgs a = fwd_args(o, nullptr, n_seq, lq, lk, n_heads, head_dim,
                       scale_log2e);
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, scale, half, 0u};
  const cudaStream_t s = (cudaStream_t)stream;
  if (active)
    return ffma_scores ? launch_attention<true, false, true>(w, a, head_dim, s)
                       : launch_attention<true, false, false>(w, a, head_dim,
                                                              s);
  return ffma_scores ? launch_attention<false, false, true>(w, a, head_dim, s)
                     : launch_attention<false, false, false>(w, a, head_dim,
                                                             s);
}

}  // namespace

extern "C" {

// The float32 twins of mha.cu's entry points, with the same arguments.
int nylon_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int n_seq, int lq, int lk, int n_heads, int head_dim,
                        long long q_row, long long q_seq, long long kv_row,
                        long long kv_seq, float scale_log2e, void* stream) {
  return attention_f32(false, q, k, v, o, n_seq, lq, lk, n_heads, head_dim,
                       q_row, q_seq, kv_row, kv_seq, scale_log2e, 0, 0u, 0,
                       0u, 1.f, 0, stream);
}

int nylon_attention_probs_f32(const void* q, const void* k, const void* v,
                              void* o, void* probs, int n_seq, int lq,
                              int lk, int n_heads, int head_dim,
                              long long q_row, long long q_seq,
                              long long kv_row, long long kv_seq,
                              float scale_log2e, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) || probs == nullptr)
    return (int)cudaErrorInvalidValue;
  const Views w{q, k, v, n_seq, q_row, q_seq, kv_row, kv_seq};
  return launch_attention<false, true, false>(
      w, fwd_args(o, probs, n_seq, lq, lk, n_heads, head_dim, scale_log2e),
      head_dim, (cudaStream_t)stream);
}

int nylon_attention_drop_f32(const void* q, const void* k, const void* v,
                             void* o, int n_seq, int lq, int lk, int n_heads,
                             int head_dim, long long q_row, long long q_seq,
                             long long kv_row, long long kv_seq,
                             float scale_log2e, unsigned seed_mix,
                             int head_tag0, unsigned thresh, float scale,
                             int half, void* stream) {
  return attention_f32(false, q, k, v, o, n_seq, lq, lk, n_heads, head_dim,
                       q_row, q_seq, kv_row, kv_seq, scale_log2e, 1,
                       seed_mix, head_tag0, thresh, scale, half, stream);
}

// The f32 attention forward with its scores on FFMA (the layer that the
// stem feeds): nylon_attention_drop_f32's arguments with `active` (0: no
// dropout) before seed_mix.
int nylon_attention_ffma_f32(const void* q, const void* k, const void* v,
                             void* o, int n_seq, int lq, int lk, int n_heads,
                             int head_dim, long long q_row, long long q_seq,
                             long long kv_row, long long kv_seq,
                             float scale_log2e, int active,
                             unsigned seed_mix, int head_tag0,
                             unsigned thresh, float scale, int half,
                             void* stream) {
  return attention_f32(true, q, k, v, o, n_seq, lq, lk, n_heads, head_dim,
                       q_row, q_seq, kv_row, kv_seq, scale_log2e, active,
                       seed_mix, head_tag0, thresh, scale, half, stream);
}

}  // extern "C"

namespace {

// The f32 attention backward, S^T on FFMA when ffma_scores.
int attention_bwd_f32(bool ffma_scores, const void* q, const void* k,
                      const void* v, const void* dout, void* dq, void* dk,
                      void* dv, int n_seq, int lq, int lk, int n_heads,
                      int head_dim, long long q_row, long long kv_row,
                      long long do_row, long long dq_row, long long dkv_row,
                      float scale, float scale_log2e, int active,
                      unsigned seed_mix, int head_tag0, unsigned thresh,
                      float pscale, int half, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  const BwdViews w{q, k, v, dout, n_seq, n_heads, q_row, kv_row, do_row};
  BwdArgs a{};
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.lq = lq;
  a.lk = lk;
  a.dq_row = dq_row;
  a.dq_seq = dq_row * lq;
  a.dkv_row = dkv_row;
  a.dkv_seq = dkv_row * lk;
  a.scale = scale;
  a.scale_log2e = scale_log2e;
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, pscale, half, 0u};
  const cudaStream_t s = (cudaStream_t)stream;
  if (ffma_scores)
    return active ? launch_attn_bwd<true, true>(w, a, head_dim, s)
                  : launch_attn_bwd<false, true>(w, a, head_dim, s);
  return active ? launch_attn_bwd<true, false>(w, a, head_dim, s)
                : launch_attn_bwd<false, false>(w, a, head_dim, s);
}

}  // namespace

extern "C" {

int nylon_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* dout, void* dq, void* dk, void* dv,
                            int n_seq, int lq, int lk, int n_heads,
                            int head_dim, long long q_row, long long kv_row,
                            long long do_row, long long dq_row,
                            long long dkv_row, float scale, float scale_log2e,
                            int active, unsigned seed_mix, int head_tag0,
                            unsigned thresh, float pscale, int half,
                            void* stream) {
  return attention_bwd_f32(false, q, k, v, dout, dq, dk, dv, n_seq, lq, lk,
                           n_heads, head_dim, q_row, kv_row, do_row, dq_row,
                           dkv_row, scale, scale_log2e, active, seed_mix,
                           head_tag0, thresh, pscale, half, stream);
}

// nylon_attention_bwd_f32 with S^T recomputed on FFMA (the layer that the
// stem feeds), the same arguments.
int nylon_attention_bwd_ffma_f32(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int n_seq, int lq, int lk, int n_heads, int head_dim,
    long long q_row, long long kv_row, long long do_row, long long dq_row,
    long long dkv_row, float scale, float scale_log2e, int active,
    unsigned seed_mix, int head_tag0, unsigned thresh, float pscale,
    int half, void* stream) {
  return attention_bwd_f32(true, q, k, v, dout, dq, dk, dv, n_seq, lq, lk,
                           n_heads, head_dim, q_row, kv_row, do_row, dq_row,
                           dkv_row, scale, scale_log2e, active, seed_mix,
                           head_tag0, thresh, pscale, half, stream);
}

// Resident blocks per SM of the float32 attention kernels (the forward, or
// the backward at the key tier of lk when bwd) at head_dim 32 or 64; a
// negative CUDA status on failure.
int nylon_attention_f32_occupancy(int head_dim, int lq, int lk, int bwd) {
  if ((head_dim != 32 && head_dim != 64) || lq <= 0 || lq > kMaxL ||
      lk <= 0 || lk > kMaxL)
    return -(int)cudaErrorInvalidValue;
  if (!bwd)
    return head_dim == 32
               ? blocks_per_sm(attn_fwd_f32_kernel<32, false, false>,
                               FwdSmem<32>::kBytes)
               : blocks_per_sm(attn_fwd_f32_kernel<64, false, false>,
                               FwdSmem<64>::kBytes);
  return with_tier(lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32
               ? blocks_per_sm(attn_bwd_f32_kernel<32, kKeys, false>,
                               BwdSmem<32, kKeys>::kBytes)
               : blocks_per_sm(attn_bwd_f32_kernel<64, kKeys, false>,
                               BwdSmem<64, kKeys>::kBytes);
  });
}

}  // extern "C"
