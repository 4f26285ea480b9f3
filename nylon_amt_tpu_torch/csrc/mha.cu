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
// The sites. The hFT model's attention sequences are short (256 bins, 88
// notes, 128 frames; head_dim 64 in the paper model, 32 in the reduced
// default) and numerous (one per frame or per note), and every site has
// Lq, Lk <= 256. So one block owns one (sequence, head): it stages Q, K and
// V (and dO in the backward) of the whole head in shared memory once, by
// cp.async in two commit groups (what the score product needs, then the
// rest, which lands while that product runs), and no other block reads
// them. Each kernel is instantiated for D in {32, 64} and a key tier of
// 96, 128 or 256 (the sites' 88, 128 and 256 keys): every register array
// and every loop over keys has a compile-time size, K and V rows past Lk
// are zeros, and a site with Lk == tier skips the column mask.
//
// What bounds them on this card: a site does Lq * Lk / (Lq + Lk) FLOP per
// byte of q, k, v and o (128 at 256 x 256, 65 at 88 x 256), under the
// H100's ~295 FLOP/B ridge, so the least time is the bytes'. What keeps
// the kernels above it is instruction rate and latency, not bytes:
// mma.sync on 16-row warp tiles (wgmma, with its 64-row warpgroup tiles
// and operands in its swizzled shared-memory layout, is not used yet), the
// exp2 / hash / IEEE-division work per score, every warp reading all of K
// and V through ldmatrix, and occupancy (the forward's 110 KB at D = 64
// holds two 4-warp blocks per SM; the backward's 169 KB one 8-warp block).
// A persistent forward (one block per SM, the next item's loads in flight
// in a second buffer) measured slower than two resident blocks per SM: the
// loads were not what stalled it.
//
// Scores live in registers. A warp owns 16 query rows and computes their
// whole [16, tier] score block with mma.sync.m16n8k16 into accumulator
// registers (256 keys: 32 n8 tiles, 128 f32 registers a thread). The
// accumulator layout of two n8 tiles is the A-fragment layout of one k16
// step, so bf16(p [* keep]) goes from those registers straight into the
// next product. No score, probability or ds tile is staged in shared
// memory; only outputs pass through a warp's staging tile for 16-byte
// stores.
//
//  * attn_fwd_kernel (4 warps, a warp walks query tiles): ONE QK^T product
//    per query tile, the exact row max from the registers, p = exp2(s - m)
//    in place, l summed from the unrounded f32 p, O = bf16(p [* keep]) V,
//    then O / l. K11 writes the normalised f32 p / l from the same
//    registers (one product where the wmma version took three). 2
//    products per head.
//  * attn_bwd_kernel (8 warps), one kernel, no statistics in device
//    memory. Phase 1, query-major (16 query rows a warp): S = Q K^T once
//    -> m, l, a = p / l in f32 registers; dP = dO V^T streamed 16 keys at a
//    time for row = sum(da * a) (da = dP [* keep]); dP again for ds =
//    bf16(a * (da - row)) and dQ += ds K; (m, l, row) and the keep bits go
//    to shared memory. Phase 2, key-major (16 keys a warp, after a block
//    barrier): S^T = K Q^T and dP^T = V dO^T per 16-query chunk, a^T from
//    the shared statistics, dV += bf16(a [* keep])^T dO and dK += bf16(ds)^T
//    Q in registers. 8 QK^T-sized products per head, where the two wmma
//    kernels took 11 (5 is the minimum: keeping dP beside a would take 128
//    registers more, and ds in the key-major phase would need a transpose
//    and a sum of dQ across warps). The block owns every query and every
//    key, so dq, dk and dv are summed inside it in a fixed order: no float
//    atomics, no scratch, the same bits from run to run.
//
// Numerics follow the TPU kernels: f32 scores times scale * log2(e)
// (rounded: __fmul_rn keeps the product out of an FMA), exp2 with the
// exact row max (ex2.approx.ftz: subnormal p flushed), l summed from the
// unrounded p, bf16(p) (times the keep mask under dropout) into the PV
// product, the 1/l normalisation deferred to the f32 output; the
// backward's a = p / l by IEEE division and row = sum(da * a) from the
// unrounded f32 a, ds and a (or a * keep) cast to bf16 before their
// products, dq/dk scaled in f32 before the cast.
//
// Dropout (kDrop): head h takes the keep mask of hash_mask.cuh (K6) with tag
// head_tag0 + h, row seq * Lq + query and column key, drawn per element
// from its (row, column) in the fragment. K12's TPU kernel hashes head h
// with the raw tag h (head_tag0 = 0); K7-K9 use the tag (tag_base + 8) * 64
// + h (ops/layer_fused_train.py::_head_tag). At Lk = 256 the draws are
// packed (half = 128): columns j and j + 128 come from one hash, and a
// query-major thread holds both (n8 tiles i and i + 16), so the forward
// and the backward's phase 1 hash once a pair. Phase 1 keeps its keep bits
// in registers for its two dP passes and writes them, row-major, to shared
// memory for phase 2, whose threads hold keys as rows.

#include <type_traits>

#include "common.cuh"
#include "hash_mask.cuh"

using nylon::bf16;
using nylon::DropSite;
using nylon::hash_mix;
using nylon::keep_value;

namespace {

constexpr int kFwdWarps = 4;  // 4 warps a forward block: 2+ blocks per SM
constexpr int kBwdWarps = 8;  // 8 warps a backward block: one block per SM
constexpr int kMaxL = 256;    // Q, K, V (and dO) of a head in shared memory

// ------------------------------------------------------------- mma.sync ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of one row.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 16, row-major) b (16 x 8, column-major); f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane addresses of ldmatrix x4 over a row-major tile with row length ld:
// the A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16);
template <int ld>
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int r0, int c0,
                                              int lane) {
  return s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// the B fragments of two n8 tiles (rows n0 .. n0 + 15 of an [n][k] tile,
// columns k0 .. k0 + 15): r[0], r[1] for rows n0 .. n0 + 7, r[2], r[3] for
// the next 8;
template <int ld>
__device__ __forceinline__ const bf16* bn_addr(const bf16* s, int n0, int k0,
                                               int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// with .trans, the B fragments of two n8 tiles of a [k][n] tile (rows k0 ..
// k0 + 15, columns n0 .. n0 + 15).
template <int ld>
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int k0, int n0,
                                               int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// The A fragment of a k16 step from the accumulators of two n8 tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x with subnormal results flushed to zero (one MUFU.EX2).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The [16, kKeys] score block of a warp's 16 query rows: s = Q K^T, the A
// fragments of Q in qa, K [kKeys][D+8] in shared memory. Then s <- s *
// scale_log2e (rounded: __fmul_rn keeps the product out of an FMA), -inf
// past lk, and (m0, m1) the exact max of rows g and g + 8. Every loop has
// a compile-time trip count, so the compiler interleaves the whole block.
template <int D, int kKeys>
__device__ __forceinline__ void score_block(float (&s)[kKeys / 8][4],
                                            const uint32_t (&qa)[D / 16][4],
                                            const bf16* Ks, float sl2e,
                                            int lk, int lane, float& m0,
                                            float& m1) {
  constexpr int NT = kKeys / 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bn_addr<D + 8>(Ks, np * 16, kk * 16, lane));
      mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
  const float neg_inf = __int_as_float(0xff800000u);
  const int t = lane & 3;
  m0 = m1 = neg_inf;
  if (lk == kKeys) {  // every column is a key: no mask (the common sites)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[nt][r] = __fmul_rn(s[nt][r], sl2e);
        if (r < 2) m0 = fmaxf(m0, s[nt][r]);
        else m1 = fmaxf(m1, s[nt][r]);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = __fmul_rn(s[nt][r], sl2e);
        s[nt][r] = nt * 8 + 2 * t + (r & 1) < lk ? x : neg_inf;
        if (r < 2) m0 = fmaxf(m0, s[nt][r]);
        else m1 = fmaxf(m1, s[nt][r]);
      }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// s <- p = exp2(s - m) in place; returns (l0, l1), the sums of the
// unrounded p of rows g and g + 8.
template <int NT>
__device__ __forceinline__ void exp_rows(float (&s)[NT][4], float m0, float m1,
                                         float& l0, float& l1) {
  l0 = l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p = exp2_ftz(s[nt][r] - (r < 2 ? m0 : m1));
      s[nt][r] = p;
      if (r < 2) l0 += p;
      else l1 += p;
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
}

// ------------------------------------------------------------- staging ----

// Rows [0, rows) of a strided [*, D] head slice into dst (row length D +
// 8, which keeps ldmatrix free of bank conflicts) by cp.async; rows at or
// past n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            long long row_stride, int rows,
                                            int n) {
  for (int c = threadIdx.x; c < rows * (D / 8); c += blockDim.x) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    const bool ok = r < n;
    nylon::cp_async16(dst + r * (D + 8) + c8,
                      src + (long long)(ok ? r : 0) * row_stride + c8, ok);
  }
}

// A warp's [16, D] output tile, written to the staging tile `st` (row
// length D + 8) from f32 accumulators by f(value, row half), then copied to
// dst rows r0 .. r0 + 15 (those < n) 16 bytes a lane.
template <int D, typename F>
__device__ __forceinline__ void store_tile(bf16* st,
                                           const float (&acc)[D / 8][4], F f,
                                           bf16* dst, long long row_stride,
                                           int r0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    *reinterpret_cast<uint32_t*>(st + g * (D + 8) + nd * 8 + 2 * t) =
        pack_bf16(f(acc[nd][0], 0), f(acc[nd][1], 0));
    *reinterpret_cast<uint32_t*>(st + (g + 8) * (D + 8) + nd * 8 + 2 * t) =
        pack_bf16(f(acc[nd][2], 1), f(acc[nd][3], 1));
  }
  __syncwarp();
  for (int c = lane; c < 16 * (D / 8); c += 32) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * row_stride + c8) =
          *reinterpret_cast<const uint4*>(st + r * (D + 8) + c8);
  }
  __syncwarp();
}

// ------------------------------------------------------------ keep mask ----

// Element r of n8 tile nt of a thread's [16, kKeys] row block sits at row
// g + 8 * (r >= 2), column nt * 8 + 2t + (r & 1), and keeps its keep bit at
// nt * 4 + r. Packed draws at Lk = 256 (half 128): tiles nt and nt + 16
// share one hash.
template <int kKeys>
constexpr int kBitWords = (kKeys / 2 + 31) / 32;

// The keep bits of a [16, 256] row block whose draws are packed (half =
// 128): one hash gives columns j and j + 128, so words 0, 1 (tiles 0-15)
// take the low draws and words 2, 3 (tiles 16-31) the high draws.
// Invariants this form keeps: each word is built in a local of its own and
// stored once; every word index and every shift count (j * 4 + r < 32) is
// a compile-time constant, so `bits` stays in registers and no shift
// reaches 32. An earlier form that or-ed both draws of a pair into `bits`
// in one loop gave the backward wrong masks at 256 keys on an H100 while
// the forward's same hashes were right; its cause was not found, so keep
// to this form. chip_smoke.py (l) and (m) read K12's masks back and hold
// its backward to the plain version at 88, 128 and 256 keys, D = 32 and 64.
__device__ __forceinline__ void packed_keep_bits(uint32_t (&bits)[4],
                                                 const DropSite& s,
                                                 uint32_t row0, int t) {
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t row = row0 + (r >> 1) * 8;
        const uint32_t c = (uint32_t)((8 * w + j) * 8 + 2 * t + (r & 1));
        const uint32_t x = hash_mix((s.base + row * 128u + c) ^ s.key);
        lo |= (uint32_t)((x & 0xFFFFu) >= s.thresh) << (j * 4 + r);
        hi |= (uint32_t)((x >> 16) >= s.thresh) << (j * 4 + r);
      }
    bits[w] = lo;
    bits[w + 2] = hi;
  }
}

template <int kKeys>
__device__ __forceinline__ void keep_bits(uint32_t (&bits)[kBitWords<kKeys>],
                                          const DropSite& s, uint32_t row0,
                                          int lk, int lane) {
  constexpr int NT = kKeys / 8;
  const int t = lane & 3;
  if constexpr (kKeys == 256) {
    if (s.half == 128) {
      packed_keep_bits(bits, s, row0, t);
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < kBitWords<kKeys>; ++w) bits[w] = 0u;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = nt * 4 + r;
      bits[i >> 5] |= (uint32_t)(keep_value(s, row0 + (r >> 1) * 8,
                                            nt * 8 + 2 * t + (r & 1), lk) !=
                                 0.f)
                      << (i & 31);
    }
}

template <int kKeys>
__device__ __forceinline__ float keep_of(
    const uint32_t (&bits)[kBitWords<kKeys>], int i, float scale) {
  return (bits[i >> 5] >> (i & 31)) & 1u ? scale : 0.f;
}

// s *= keep for a thread's elements of a [16, kKeys] row block (rows row0,
// row0 + 8): one hash for the pair of columns j, j + 128 when packed.
template <int kKeys>
__device__ __forceinline__ void apply_keep(float (&s)[kKeys / 8][4],
                                           const DropSite& ds, uint32_t row0,
                                           int lk, int lane) {
  constexpr int NT = kKeys / 8;
  const int t = lane & 3;
  if (kKeys == 256 && ds.half == 128) {
#pragma unroll
    for (int nt = 0; nt < NT / 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t row = row0 + (r >> 1) * 8;
        const uint32_t c = (uint32_t)(nt * 8 + 2 * t + (r & 1));
        const uint32_t x = hash_mix((ds.base + row * 128u + c) ^ ds.key);
        s[nt][r] *= (x & 0xFFFFu) >= ds.thresh ? ds.scale : 0.f;
        s[nt + NT / 2][r] *= (x >> 16) >= ds.thresh ? ds.scale : 0.f;
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[nt][r] *= keep_value(ds, row0 + (r >> 1) * 8,
                               nt * 8 + 2 * t + (r & 1), lk);
  }
}

// The key tier of a site: the register row block and the K/V rows in
// shared memory cover kKeys >= lk keys (zero-filled past lk).
template <typename F>
int with_tier(int lk, F f) {
  if (lk <= 96) return f(std::integral_constant<int, 96>{});
  if (lk <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

// ------------------------------------------------------------- forward ----

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* probs;  // K11: [n_seq, n_heads, lq, lk] f32, else null
  int n_items, lq, lk, n_heads, o_row;  // n_items = n_seq * n_heads blocks
  long long q_row, q_seq, kv_row, kv_seq;
  float scale_log2e;
  uint32_t seed_mix;
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
  DropSite site;  // thresh, scale, half of the probability site
};

// One (sequence, head): K and V [kKeys][D+8], Q [lq16][D+8] bf16.
template <int D, int kKeys>
__host__ __device__ constexpr size_t fwd_smem_bytes(int lq16) {
  return (size_t)(2 * kKeys + lq16) * (D + 8) * sizeof(bf16);
}

// o[seq, q, h*D:(h+1)*D] = softmax(q_h k_h^T * scale) v_h of one (sequence,
// head) item; q/k/v are strided views (row and sequence strides in
// elements) so packed QKV and K/V projections are read in place. Lk <=
// kKeys.
template <int D, int kKeys, bool kDrop, bool kProbs>
__global__ void __launch_bounds__(kFwdWarps * 32)
    attn_fwd_kernel(const FwdArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 8;
  constexpr int NT = kKeys / 8;
  const int lq = args.lq, lk = args.lk;
  const int lq16 = (lq + 15) & ~15;
  bf16* const Ks = reinterpret_cast<bf16*>(smem);
  bf16* const Vs = Ks + kKeys * LD;
  bf16* const Qs = Vs + kKeys * LD;
  const int seq = blockIdx.x / args.n_heads, h = blockIdx.x % args.n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // group 0: K and Q (the score product); group 1: V
  stage_async<D>(Ks, args.k + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                 lk);
  stage_async<D>(Qs, args.q + seq * args.q_seq + h * D, args.q_row, lq16, lq);
  nylon::cp_async_commit();
  stage_async<D>(Vs, args.v + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                 lk);
  nylon::cp_async_commit();
  nylon::cp_async_wait<1>();
  __syncthreads();

  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const int nqt = lq16 / 16;
  const int iters = (nqt + kFwdWarps - 1) / kFwdWarps;  // block-uniform
  for (int it = 0; it < iters; ++it) {
    const int tile = warp + it * kFwdWarps;
    const bool active = tile < nqt;
    float s[NT][4];
    float l0 = 0.f, l1 = 0.f;
    if (active) {
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], a_addr<LD>(Qs, tile * 16, kk * 16, lane));
      float m0, m1;
      score_block<D, kKeys>(s, qa, Ks, args.scale_log2e, lk, lane, m0, m1);
      exp_rows<NT>(s, m0, m1, l0, l1);
    }
    if (it == 0) {  // V has landed
      nylon::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    const int q0 = tile * 16 + g;
    if constexpr (kProbs) {
      // the normalised probabilities, straight from the registers
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gq = q0 + half * 8;
        if (gq >= lq) continue;
        const float l = half ? l1 : l0;
        float* pr = args.probs +
                    (((size_t)seq * args.n_heads + h) * lq + gq) * lk;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * t;
          if (col >= lk) continue;
          const float p0 = s[nt][2 * half] / l, p1 = s[nt][2 * half + 1] / l;
          if (lk % 2 == 0) {
            *reinterpret_cast<float2*>(pr + col) = make_float2(p0, p1);
          } else {
            pr[col] = p0;
            if (col + 1 < lk) pr[col + 1] = p1;
          }
        }
      }
    }
    if constexpr (kDrop)
      apply_keep<kKeys>(s, hsite, (uint32_t)seq * (uint32_t)lq + q0, lk,
                        lane);
    // O = bf16(p [* keep]) V, p taken from the score registers
    float o[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nd][r] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<LD>(Vs, kc * 16, dp * 16, lane));
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    // O / l through the warp's own Q rows (read into registers above)
    store_tile<D>(Qs + tile * 16 * LD, o,
                  [&](float x, int half) { return x / (half ? l1 : l0); },
                  args.o + (long long)seq * lq * args.o_row + h * D,
                  args.o_row, tile * 16, lq, lane);
  }
}

template <int D, int kKeys, bool kDrop, bool kProbs>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D, kKeys>((a.lq + 15) & ~15);
  auto kernel = attn_fwd_kernel<D, kKeys, kDrop, kProbs>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.n_items, kFwdWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kProbs>
int launch_attention(const FwdArgs& a, int head_dim, cudaStream_t stream) {
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32 ? launch_fwd<32, kKeys, kDrop, kProbs>(a, stream)
                          : launch_fwd<64, kKeys, kDrop, kProbs>(a, stream);
  });
}

// ------------------------------------------------------------ backward ----

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int lq, lk;
  long long q_row, q_seq, kv_row, kv_seq, do_row, do_seq, dq_row, dq_seq,
      dkv_row, dkv_seq;
  float scale, scale_log2e;
  uint32_t seed_mix;
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
  DropSite site;  // thresh, scale, half of the probability site
};

// Keep-bit words a row of the backward's shared mask: bit k % 32 of word
// k / 32 is key k's (one word of padding against bank conflicts).
template <int kKeys>
constexpr int kMaskLd = kKeys / 32 + 1;

// Q, dO [lq16][D+8], K, V [kKeys][D+8] bf16; m, l, row [lq16] f32; with
// dropout the keep bits [lq16][kMaskLd]; one [16][D+8] bf16 output
// staging tile per warp.
template <int D, int kKeys, bool kDrop>
__host__ __device__ constexpr size_t bwd_smem_bytes(int lq16) {
  return (size_t)(2 * lq16 + 2 * kKeys) * (D + 8) * sizeof(bf16) +
         (size_t)3 * lq16 * sizeof(float) +
         (kDrop ? (size_t)lq16 * kMaskLd<kKeys> * sizeof(uint32_t) : 0) +
         (size_t)kBwdWarps * 16 * (D + 8) * sizeof(bf16);
}

// dq, dk, dv of one (sequence, head): phase 1 query-major (dq and the row
// statistics), phase 2 key-major (dk, dv), see the head note.
template <int D, int kKeys, bool kDrop>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
    attn_bwd_kernel(const BwdArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 8;
  constexpr int NT = kKeys / 8;
  const int lq = args.lq, lk = args.lk;
  const int lq16 = (lq + 15) & ~15, lk16 = (lk + 15) & ~15;
  bf16* const Qs = reinterpret_cast<bf16*>(smem);
  bf16* const dOs = Qs + lq16 * LD;
  bf16* const Ks = dOs + lq16 * LD;
  bf16* const Vs = Ks + kKeys * LD;
  float* const ms = reinterpret_cast<float*>(Vs + kKeys * LD);
  float* const ls = ms + lq16;
  float* const rs = ls + lq16;
  uint32_t* const Ms = reinterpret_cast<uint32_t*>(rs + lq16);
  const int seq = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* const St = reinterpret_cast<bf16*>(
                       Ms + (kDrop ? lq16 * kMaskLd<kKeys> : 0)) +
                   warp * 16 * LD;

  // group 0: K and Q (the score product); group 1: dO and V
  stage_async<D>(Ks, args.k + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                 lk);
  stage_async<D>(Qs, args.q + seq * args.q_seq + h * D, args.q_row, lq16, lq);
  nylon::cp_async_commit();
  stage_async<D>(dOs, args.dout + seq * args.do_seq + h * D, args.do_row,
                 lq16, lq);
  stage_async<D>(Vs, args.v + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                 lk);
  nylon::cp_async_commit();
  nylon::cp_async_wait<1>();
  __syncthreads();

  const float sl2e = args.scale_log2e;
  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);

  // ---- phase 1: query rows ----
  const int nqt = lq16 / 16;
  const int iters = (nqt + kBwdWarps - 1) / kBwdWarps;  // block-uniform
  for (int it = 0; it < iters; ++it) {
    const int tile = warp + it * kBwdWarps;
    const bool active = tile < nqt;
    float a[NT][4];
    if (active) {
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], a_addr<LD>(Qs, tile * 16, kk * 16, lane));
      float m0, m1, l0, l1;
      score_block<D, kKeys>(a, qa, Ks, sl2e, lk, lane, m0, m1);
      exp_rows<NT>(a, m0, m1, l0, l1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[nt][r] = a[nt][r] / (r < 2 ? l0 : l1);
      if (t == 0) {
        ms[tile * 16 + g] = m0;
        ms[tile * 16 + g + 8] = m1;
        ls[tile * 16 + g] = l0;
        ls[tile * 16 + g + 8] = l1;
      }
    }
    if (it == 0) {  // dO and V have landed
      nylon::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    uint32_t bits[kBitWords<kKeys>];
    if constexpr (kDrop) {
      keep_bits<kKeys>(bits, hsite,
                       (uint32_t)seq * (uint32_t)lq + tile * 16 + g, lk,
                       lane);
      // the same bits, row-major, for phase 2 (whose threads hold keys as
      // rows): one word a (row, 32 keys), OR-ed over the quad
#pragma unroll
      for (int w = 0; w < kKeys / 32; ++w)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          uint32_t word = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = (4 * w + j) * 4 + 2 * hr + e;
              word |= ((bits[i >> 5] >> (i & 31)) & 1u)
                      << (j * 8 + 2 * t + e);
            }
          word |= __shfl_xor_sync(0xffffffffu, word, 1);
          word |= __shfl_xor_sync(0xffffffffu, word, 2);
          if (t == 0) Ms[(tile * 16 + g + 8 * hr) * kMaskLd<kKeys> + w] = word;
        }
    }
    uint32_t da_frag[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(da_frag[kk], a_addr<LD>(dOs, tile * 16, kk * 16, lane));
    // dP of 16 keys: dO V^T, times the keep mask
    auto dp_chunk = [&](int np, float (&dp)[2][4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) dp[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, bn_addr<LD>(Vs, np * 16, kk * 16, lane));
        mma_bf16(dp[0], da_frag[kk], b[0], b[1]);
        mma_bf16(dp[1], da_frag[kk], b[2], b[3]);
      }
      if constexpr (kDrop) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dp[j][r] *= keep_of<kKeys>(bits, (2 * np + j) * 4 + r,
                                       hsite.scale);
      }
    };
    float row0 = 0.f, row1 = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      float dp[2][4];
      dp_chunk(np, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        row0 += dp[j][0] * a[2 * np + j][0] + dp[j][1] * a[2 * np + j][1];
        row1 += dp[j][2] * a[2 * np + j][2] + dp[j][3] * a[2 * np + j][3];
      }
    }
    row0 = quad_sum(row0);
    row1 = quad_sum(row1);
    if (t == 0) {
      rs[tile * 16 + g] = row0;
      rs[tile * 16 + g + 8] = row1;
    }
    // ds = bf16(a * (da - row)); dQ += ds K
    float dq[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) dq[nd][r] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      float dp[2][4];
      dp_chunk(np, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dp[j][r] = a[2 * np + j][r] * (dp[j][r] - (r < 2 ? row0 : row1));
      uint32_t sa[4];
      acc_to_a(sa, dp[0], dp[1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<LD>(Ks, np * 16, dd * 16, lane));
        mma_bf16(dq[2 * dd], sa, b[0], b[1]);
        mma_bf16(dq[2 * dd + 1], sa, b[2], b[3]);
      }
    }
    const float scale = args.scale;
    store_tile<D>(St, dq, [&](float x, int) { return x * scale; },
                  args.dq + seq * args.dq_seq + h * D, args.dq_row, tile * 16,
                  lq, lane);
  }
  __syncthreads();  // m, l, row of every query row

  // ---- phase 2: key rows ----
  for (int kt = warp; kt < lk16 / 16; kt += kBwdWarps) {
    uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldsm_x4(ka[kk], a_addr<LD>(Ks, kt * 16, kk * 16, lane));
      ldsm_x4(va[kk], a_addr<LD>(Vs, kt * 16, kk * 16, lane));
    }
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) dk[nd][r] = dv[nd][r] = 0.f;
    const int key0 = kt * 16 + g;
    for (int qc = 0; qc < lq16; qc += 16) {
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[j][r] = dpt[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, bn_addr<LD>(Qs, qc, kk * 16, lane));
        mma_bf16(st[0], ka[kk], b[0], b[1]);
        mma_bf16(st[1], ka[kk], b[2], b[3]);
        ldsm_x4(b, bn_addr<LD>(dOs, qc, kk * 16, lane));
        mma_bf16(dpt[0], va[kk], b[0], b[1]);
        mma_bf16(dpt[1], va[kk], b[2], b[3]);
      }
      // st -> a [* keep], dpt -> ds, keys as rows
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = qc + j * 8 + 2 * t + (r & 1);
          const int key = key0 + (r >> 1) * 8;
          float ad = 0.f, ds = 0.f;
          if (q < lq && key < lk) {
            const float a =
                exp2_ftz(__fmul_rn(st[j][r], sl2e) - ms[q]) / ls[q];
            float mk = 1.f;
            if constexpr (kDrop)
              mk = (Ms[q * kMaskLd<kKeys> + (key >> 5)] >> (key & 31)) & 1u
                       ? hsite.scale
                       : 0.f;
            ad = a * mk;
            ds = a * (dpt[j][r] * mk - rs[q]);
          }
          st[j][r] = ad;
          dpt[j][r] = ds;
        }
      uint32_t aa[4], sa[4];
      acc_to_a(aa, st[0], st[1]);
      acc_to_a(sa, dpt[0], dpt[1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<LD>(dOs, qc, dd * 16, lane));
        mma_bf16(dv[2 * dd], aa, b[0], b[1]);
        mma_bf16(dv[2 * dd + 1], aa, b[2], b[3]);
        ldsm_x4_t(b, bt_addr<LD>(Qs, qc, dd * 16, lane));
        mma_bf16(dk[2 * dd], sa, b[0], b[1]);
        mma_bf16(dk[2 * dd + 1], sa, b[2], b[3]);
      }
    }
    const float scale = args.scale;
    store_tile<D>(St, dk, [&](float x, int) { return x * scale; },
                  args.dk + seq * args.dkv_seq + h * D, args.dkv_row, kt * 16,
                  lk, lane);
    store_tile<D>(St, dv, [](float x, int) { return x; },
                  args.dv + seq * args.dkv_seq + h * D, args.dkv_row, kt * 16,
                  lk, lane);
  }
}

template <int D, int kKeys, bool kDrop>
int launch_bwd(const BwdArgs& a, int n_seq, int n_heads, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D, kKeys, kDrop>((a.lq + 15) & ~15);
  auto kernel = attn_bwd_kernel<D, kKeys, kDrop>;
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

bool bad_geometry(int n_seq, int lq, int lk, int n_heads, int head_dim) {
  return (head_dim != 32 && head_dim != 64) || n_seq <= 0 || lq <= 0 ||
         lk <= 0 || lq > kMaxL || lk > kMaxL || n_heads <= 0 ||
         n_heads > 65535 || (long long)n_seq * n_heads > 0x7fffffffLL;
}

FwdArgs fwd_args(const void* q, const void* k, const void* v, void* o,
                 void* probs, int n_seq, int lq, int lk, int n_heads,
                 int head_dim,
                 long long q_row, long long q_seq, long long kv_row,
                 long long kv_seq, float scale_log2e) {
  FwdArgs a{};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.o = (bf16*)o;
  a.probs = (float*)probs;
  a.n_items = n_seq * n_heads;
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

int nylon_attention(const void* q, const void* k, const void* v, void* o,
                    int n_seq, int lq, int lk, int n_heads, int head_dim,
                    long long q_row, long long q_seq, long long kv_row,
                    long long kv_seq, float scale_log2e, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = fwd_args(q, k, v, o, nullptr, n_seq, lq, lk, n_heads,
                             head_dim, q_row, q_seq, kv_row, kv_seq,
                             scale_log2e);
  return launch_attention<false, false>(a, head_dim,
                                        (cudaStream_t)stream);
}

// nylon_attention that also writes the normalised f32 probabilities
// probs[n_seq, n_heads, lq, lk] (fused_mha_with_probs, K11).
int nylon_attention_probs(const void* q, const void* k, const void* v,
                          void* o, void* probs, int n_seq, int lq, int lk,
                          int n_heads, int head_dim, long long q_row,
                          long long q_seq, long long kv_row, long long kv_seq,
                          float scale_log2e, void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) || probs == nullptr)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a = fwd_args(q, k, v, o, probs, n_seq, lq, lk, n_heads,
                             head_dim, q_row, q_seq, kv_row, kv_seq,
                             scale_log2e);
  return launch_attention<false, true>(a, head_dim,
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
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = fwd_args(q, k, v, o, nullptr, n_seq, lq, lk, n_heads,
                       head_dim, q_row, q_seq, kv_row, kv_seq, scale_log2e);
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, scale, half, 0u};
  return launch_attention<true, false>(a, head_dim,
                                       (cudaStream_t)stream);
}

// Attention backward of n_seq sequences on strided head-interleaved views
// (row strides in elements, sequence stride = rows x row stride): dq [*, H*D]
// and dk/dv sharing dkv_row. With active, head h's probabilities carry the
// keep mask of tag head_tag0 + h.
int nylon_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        int n_seq, int lq, int lk, int n_heads, int head_dim,
                        long long q_row, long long kv_row, long long do_row,
                        long long dq_row, long long dkv_row, float scale,
                        float scale_log2e, int active, unsigned seed_mix,
                        int head_tag0, unsigned thresh, float pscale, int half,
                        void* stream) {
  if (bad_geometry(n_seq, lq, lk, n_heads, head_dim) ||
      (half && 2 * half != lk))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
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

}  // extern "C"
