// Multi-head attention kernels on Hopper (sm_90a): wgmma products on
// operands that TMA brings into shared memory.
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
// Lq, Lk <= 256. So a block owns a whole (sequence, head): TMA brings its
// Q, K and V (and dO in the backward) into shared memory once, from the
// strided views the callers pass (row stride 3 hid for a packed QKV, 2 hid
// for a packed KV: a 3-D tensor map [sequence, row, column] a view, its box
// one head's D columns by the rows of a sequence, 128- or 64-byte swizzled
// rows for D = 64 or 32; rows past Lq or Lk are zero-filled by TMA), and no
// other block reads them. Each kernel is instantiated for D in {32, 64} and
// a key tier of 96, 128 or 256 (the sites' 88, 128 and 256 keys): every
// register array and every loop over keys has a compile-time size, and a
// site with Lk == tier skips the column mask. Outputs leave through a
// shared-memory tile and a TMA store, which clips the rows past Lq or Lk.
//
// Every product is a wgmma of a warpgroup (64 query or key rows): operands
// in shared memory as TMA wrote them (K-major for Q K^T-shaped products, V,
// K, dO or Q MN-major through the transpose bit where they are the B of a
// product over keys or queries), and probabilities or ds from registers:
// the accumulator layout of two n8 column blocks is the register-A layout
// of one k16 step, so bf16(p [* keep]) goes from the score registers
// straight into the next product. A warpgroup's whole [64, tier] score
// block lives in registers (tier 256: 128 f32 a thread), which the exact
// row max needs.
//
//  * attn_fwd_kernel: a persistent grid of blocks of two consumer
//    warpgroups (256 threads; one block an SM at tier 256, two below, in
//    128 registers a thread), walking (sequence, head) items; thread 0
//    prefetches the next item's Q, K, V into the second of two shared-memory
//    stages while the block works on the current one, so the loads run
//    under the products. A warpgroup takes the item's 64-query tiles g, g +
//    2: S = Q K^T (m64 n{tier}), the exact row max from the registers, p =
//    exp2(s - m) in place, l summed from the unrounded f32 p, O = bf16(p [*
//    keep]) V (register A, V MN-major), then O / l into the warpgroup's
//    output tile and one TMA store. K11 writes the normalised f32 p / l
//    from the same registers. 2 products per head.
//  * attn_bwd_kernel (two warpgroups, one block an SM, a block a (sequence,
//    head)), no statistics in device memory. Phase 1, query-major (64 query
//    rows a warpgroup): S = Q K^T -> m, l, a = p / l in f32 registers; dP =
//    dO V^T in chunks of 64 keys (96 at tier 96) for row = sum(da * a) (da =
//    dP [* keep]); dP again for ds = bf16(a * (da - row)) and dQ += ds K
//    (register A, K MN-major); (m, l, row) and the keep bits go to shared
//    memory. Phase 2, key-major (64 keys a warpgroup, after a block
//    barrier): S^T = K Q^T and dP^T = V dO^T per 64-query chunk, a^T from
//    the shared statistics, dV += bf16(a [* keep])^T dO and dK += bf16(ds)^T
//    Q (register A, dO and Q MN-major). 8 QK^T-sized products per head (5
//    is the minimum: dP beside a would take 128 registers more, and ds for
//    the key-major products would need a [Lq, Lk] tile in shared memory, 128
//    KB at 256 x 256 beside the 128 KB of Q, K, V and dO). The block owns
//    every query and every key, so dq, dk and dv are summed inside it in a
//    fixed order: no float atomics, no scratch, the same bits from run to
//    run.
//
// What bounds them on this card: a site does Lq * Lk / (Lq + Lk) FLOP per
// byte of q, k, v and o (128 at 256 x 256, 65 at 88 x 256), under the
// H100's ~295 FLOP/B ridge, so the least time is the bytes'. The forward
// runs at 84-89% of that rate at the paper's sites (PERF.md); probes of an
// earlier form at 256 x 256 read its loads and stores alone at 0.720 ms
// against the 0.641 bound, its products and softmax alone at 1.031 of its
// 0.993: the prefetch hides the loads, and the compute sets the time.
// What is left is the per-score work on the CUDA cores and the
// special-function unit (the scale, the max, exp2, the sum, the bf16
// packs, the hash under dropout), a warpgroup's chain of dependent
// products, and in the backward its 8 products and a second exp2 a score
// (~39% of the bound). So the reductions keep four chains a row, every
// division by l is a multiply and one Newton step (div_rn: the IEEE slow
// path of `/` cost the forward ~20%), and nothing branches around a wgmma
// (warps skipping the softmax past Lq made the Lq 88 forwards 2x slower).
//
// Numerics follow the TPU kernels: f32 scores times scale * log2(e)
// (rounded: __fmul_rn keeps the product out of an FMA), exp2 with the
// exact row max (ex2.approx.ftz: subnormal p flushed), l summed from the
// unrounded p, bf16(p) (times the keep mask under dropout) into the PV
// product, the 1/l normalisation deferred to the f32 output (o / l, K11's p
// / l and the backward's a = p / l correctly rounded: div_rn); the
// backward's row = sum(da * a) from the unrounded f32 a, ds and a (or a *
// keep) cast to bf16 before their products, dq/dk scaled in f32 before the
// cast.
//
// Dropout (kDrop): head h takes the keep mask of hash_mask.cuh (K6) with tag
// head_tag0 + h, row seq * Lq + query and column key, drawn per element
// from its (row, column) in the fragment. K12's TPU kernel hashes head h
// with the raw tag h (head_tag0 = 0); K7-K9 use the tag (tag_base + 8) * 64
// + h (ops/layer_fused_train.py::_head_tag). A warp's share of a wgmma
// accumulator is the mma.sync m16n8 layout repeated over N / 8 column
// blocks, so at Lk = 256 the draws are packed (half = 128): columns j and j
// + 128 come from one hash and one thread holds both (blocks i and i + 16),
// so the forward and the backward's phase 1 hash once a pair. Phase 1 draws
// its rows' keep bits before its score product and stores each thread's
// words to shared memory as they fall in the fragment; its own two dP
// passes read each score's bit from the sign of its a (a >= 0, a dropped
// score's kept negated: held in registers beside the 128 score registers
// of tier 256, the bits spilled), and phase 2 (whose threads hold keys as
// rows) gathers a chunk's 32 bits a thread into one word while its
// products run (a load a score cost the dropout backward ~15%).

#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hash_mask.cuh"

using nylon::DropSite;
using nylon::hash_mix;
using nylon::keep_value;
namespace sm = nylon::sm90;

namespace {

constexpr int kWarpgroups = 2;               // consumer warpgroups a block
constexpr int kThreads = kWarpgroups * 128;  // one block an SM
constexpr int kMaxL = 256;                   // queries and keys a sequence

// ------------------------------------------------------------- operands ----

// The shared-memory descriptor of an operand whose rows are RB bytes (2 D:
// 128 or 64) under the swizzle of that width, K-major (rows along M or N,
// the k16 step +32 bytes) or MN-major one swizzle atom wide (rows along K,
// the k16 step +16 rows): either way eight rows apart (SBO), LBO unused.
template <int RB>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t mode = RB == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * RB >> 4) << 32) | (mode << 62);
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a tile of RB-byte
// rows under the swizzle TMA writes (tile start 1024- or 512-byte aligned).
template <int RB>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  if constexpr (RB == 128)
    return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
  else
    return (uint32_t)(row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4));
}

// The box at (x = column, y = row, z = sequence) of a 3-D map into dst,
// completing on bar; and a box from shared memory to (x, y, z).
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint64_t* bar, int x, int y,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm::smem_u32(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int x, int y,
                                           int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register-A fragment of k16 step kc from an accumulator d: the column
// blocks 2 kc and 2 kc + 1.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R],
                                         int kc) {
  const int j0 = 8 * kc, j1 = 8 * kc + 4;
  a[0] = pack_bf16(d[j0], d[j0 + 1]);
  a[1] = pack_bf16(d[j0 + 2], d[j0 + 3]);
  a[2] = pack_bf16(d[j1], d[j1 + 1]);
  a[3] = pack_bf16(d[j1 + 2], d[j1 + 3]);
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

// p / l, correctly rounded, from r = 1 / l (IEEE, once a row): one Newton
// step on the quotient, which yields the IEEE quotient wherever it is
// normal (0 < p <= 1 <= l here), without a reciprocal on the
// special-function unit for every score.
__device__ __forceinline__ float div_rn(float p, float l, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-l, q, p), r, q);
}

// A thread's share of a [64, kKeys] score block (element 4 nt + r at row g
// + 8 (r >= 2) of its warp's 16, column 8 nt + 2t + (r & 1)): s <- s *
// scale_log2e (rounded), -inf past lk, and (m0, m1) the exact max of its
// two rows. Reductions here and in exp_rows keep four chains a row (the
// element's column pair c and n8 block parity): one chain of 64 dependent
// operations a row left two warps an SM sub-partition waiting on latency.
template <int kKeys>
__device__ __forceinline__ void scale_max(float (&s)[kKeys / 2], float sl2e,
                                          int lk, int t, float& m0,
                                          float& m1) {
  const float neg_inf = __int_as_float(0xff800000u);
  float m[8];  // row (i & 2) / 2, chain (i & 1) + 2 ((i >> 2) & 1)
#pragma unroll
  for (int c = 0; c < 8; ++c) m[c] = neg_inf;
  // at tier 256 (every site has Lk = 256) a loop of its own without the
  // mask; below, one loop for both (two spilled the dropout forward at 128
  // registers)
  if (kKeys == 256 && lk == kKeys) {
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = __fmul_rn(s[i], sl2e);
  } else {
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const float x = __fmul_rn(s[i], sl2e);
      s[i] = lk == kKeys || (i >> 2) * 8 + 2 * t + (i & 1) < lk ? x : neg_inf;
    }
  }
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    float& mc = m[(i & 3) + 4 * ((i >> 2) & 1)];
    mc = fmaxf(mc, s[i]);
  }
  m0 = quad_max(fmaxf(fmaxf(m[0], m[1]), fmaxf(m[4], m[5])));
  m1 = quad_max(fmaxf(fmaxf(m[2], m[3]), fmaxf(m[6], m[7])));
}

// s <- p = exp2(s - m) in place; returns (l0, l1), the sums of the
// unrounded p of the thread's two rows.
template <int R>
__device__ __forceinline__ void exp_rows(float (&s)[R], float m0, float m1,
                                         float& l0, float& l1) {
  float l[8];  // as scale_max's chains
#pragma unroll
  for (int c = 0; c < 8; ++c) l[c] = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float p = exp2_ftz(s[i] - ((i & 3) < 2 ? m0 : m1));
    s[i] = p;
    l[(i & 3) + 4 * ((i >> 2) & 1)] += p;
  }
  l0 = quad_sum((l[0] + l[1]) + (l[4] + l[5]));
  l1 = quad_sum((l[2] + l[3]) + (l[6] + l[7]));
}

// ------------------------------------------------------------ keep mask ----

// Element 4 nt + r of a thread's [16, kKeys] row block keeps its keep bit
// at nt * 4 + r. Packed draws at Lk = 256 (half 128): blocks nt and nt + 16
// share one hash.
template <int kKeys>
constexpr int kBitWords = (kKeys / 2 + 31) / 32;

// The keep bits of a [16, 256] row block whose draws are packed (half =
// 128): one hash gives columns j and j + 128, so words 0, 1 (blocks 0-15)
// take the low draws and words 2, 3 (blocks 16-31) the high draws.
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
                                          int lk, int t) {
  constexpr int NT = kKeys / 8;
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

// s *= keep for a thread's elements of a [16, kKeys] row block (rows row0,
// row0 + 8): one hash for the pair of columns j, j + 128 when packed.
template <int kKeys>
__device__ __forceinline__ void apply_keep(float (&s)[kKeys / 2],
                                           const DropSite& ds, uint32_t row0,
                                           int lk, int t) {
  constexpr int NT = kKeys / 8;
  if (kKeys == 256 && ds.half == 128) {
#pragma unroll
    for (int nt = 0; nt < NT / 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t row = row0 + (r >> 1) * 8;
        const uint32_t c = (uint32_t)(nt * 8 + 2 * t + (r & 1));
        const uint32_t x = hash_mix((ds.base + row * 128u + c) ^ ds.key);
        s[4 * nt + r] *= (x & 0xFFFFu) >= ds.thresh ? ds.scale : 0.f;
        s[4 * (nt + NT / 2) + r] *= (x >> 16) >= ds.thresh ? ds.scale : 0.f;
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[4 * nt + r] *= keep_value(ds, row0 + (r >> 1) * 8,
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

// A warpgroup's [64, D] f32 tile, times f, as bf16 into the tile of RB-byte
// rows at shared address `tile` (swizzled as TMA reads it), then one TMA
// store of it to (h D, row0, seq) of `map` by the warpgroup's thread 0.
// The tile must be free: its last store has finished reading it.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], float f,
                                           uint32_t tile,
                                           const CUtensorMap* map, int h,
                                           int row0, int seq, int wg,
                                           int tid) {
  const int r = 16 * (tid >> 5) + ((tid & 31) >> 2), t = tid & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sm::st_shared(tile + swz<2 * D>(r + 8 * i, j) + 4 * t,
                    pack_bf16(acc[4 * j + 2 * i] * f,
                              acc[4 * j + 2 * i + 1] * f));
  sm::fence_async_smem();
  sm::named_sync(1 + wg, 128);
  if (tid == 0) {
    tma_store3(map, tile, h * D, row0, seq);
    sm::bulk_commit();
  }
}

// ------------------------------------------------------------- forward ----

struct FwdArgs {
  float* probs;  // K11: [n_seq, n_heads, lq, lk] f32, else null
  int n_items, lq, lk, n_heads;  // n_items = n_seq * n_heads
  float scale_log2e;
  uint32_t seed_mix;
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
  DropSite site;  // thresh, scale, half of the probability site
};

// attn_fwd_kernel's shared memory (from a 1024-byte aligned base): two
// stages of Q [Lq rounded up to 64 rows], K and V [kKeys rows], rows of 2 D
// bytes; at tier 256 each warpgroup's [64, D] output tile (its store may
// still read it while the next item's loads land in the stage; below 256 a
// tile's O goes through its own Q rows, and two blocks fit an SM); the
// stages' barriers.
template <int D, int kKeys>
struct FwdSmem {
  static constexpr int RB = 2 * D;
  static constexpr bool kOwnTile = kKeys == 256;
  __host__ __device__ static int q_bytes(int lq) {
    return (lq + 63) / 64 * 64 * RB;
  }
  __host__ __device__ static int stage(int lq) {
    return q_bytes(lq) + 2 * kKeys * RB;
  }
  __host__ __device__ static int bytes(int lq) {
    return 1024 + 2 * stage(lq) + (kOwnTile ? kWarpgroups * 64 * RB : 0) +
           16;
  }
};

// o[seq, q, h*D:(h+1)*D] = softmax(q_h k_h^T * scale) v_h of each (sequence,
// head) item, items blockIdx.x, + gridDim.x, ... (item = seq * n_heads + h).
// map_q / map_k / map_v: the strided views, boxes of one head's D columns by
// Lq rounded up to 64 / kKeys rows; map_o: the output, boxes of 64 rows.
// Two blocks an SM where a tier <= 128 leaves room: 128 registers a thread
// hold the [64, 128] score block (not with K11's probabilities).
template <int D, int kKeys, bool kDrop, bool kProbs>
__global__ void __launch_bounds__(kThreads, kKeys <= 128 && !kProbs ? 2 : 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o,
                    const FwdArgs args) {
  using L = FwdSmem<D, kKeys>;
  constexpr int RB = L::RB;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned, as an offset into smem_raw (the compiler then keeps
  // the shared window: 32-bit addresses)
  uint8_t* const base =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  const int lq = args.lq, lk = args.lk, n_heads = args.n_heads;
  const int q_bytes = L::q_bytes(lq), stage = L::stage(lq);
  const int n_tiles = q_bytes / (64 * RB);
  const uint32_t obuf = sm::smem_u32(base + 2 * stage);
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      base + 2 * stage + (L::kOwnTile ? kWarpgroups * 64 * RB : 0));
  // thread 0: item `item`'s Q, K and V into stage st
  const auto load = [&](int item, int st) {
    const uint32_t sb = sm::smem_u32(base + st * stage);
    const int seq = item / n_heads, h = item % n_heads;
    sm::mbar_expect_tx(full + st, stage);
    tma_load3(sb, &map_q, full + st, h * D, 0, seq);
    tma_load3(sb + q_bytes, &map_k, full + st, h * D, 0, seq);
    tma_load3(sb + q_bytes + kKeys * RB, &map_v, full + st, h * D, 0, seq);
  };
  if (threadIdx.x == 0) {
    sm::mbar_init(full, 1);
    sm::mbar_init(full + 1, 1);
    sm::fence_barrier_init();
    sm::tma_prefetch(&map_q);
    sm::tma_prefetch(&map_k);
    sm::tma_prefetch(&map_v);
    sm::tma_prefetch(&map_o);
    if ((int)blockIdx.x < args.n_items) load(blockIdx.x, 0);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, t = tid & 3;
  const int r_in = 16 * warp + ((tid & 31) >> 2);  // rows r_in, r_in + 8
  int it = 0;
  for (int item = blockIdx.x; item < args.n_items; item += gridDim.x, ++it) {
    const int st = it & 1;
    // the next item's loads, into the stage the last one left
    if (threadIdx.x == 0 && item + (int)gridDim.x < args.n_items)
      load(item + gridDim.x, st ^ 1);
    const int seq = item / n_heads, h = item % n_heads;
    const uint32_t qs = sm::smem_u32(base + st * stage);
    const uint32_t ks = qs + q_bytes, vs = ks + kKeys * RB;
    DropSite hsite = args.site;
    if constexpr (kDrop)
      hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
    sm::mbar_wait(full + st, (it >> 1) & 1);
    for (int tile = wg; tile < n_tiles; tile += kWarpgroups) {
      const uint32_t qt = qs + tile * 64 * RB;
      // S = Q K^T: the warpgroup's 64 rows by every key
      float s[kKeys / 2];
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm::Wgmma<kKeys, 0, 0>::mma(s, desc<RB>(qt + 32 * kk),
                                    desc<RB>(ks + 32 * kk), kk);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(s);
      float m0, m1, l0, l1;
      scale_max<kKeys>(s, args.scale_log2e, lk, t, m0, m1);
      exp_rows(s, m0, m1, l0, l1);
      const int row = tile * 64 + r_in;
      if constexpr (kProbs) {
        // the normalised probabilities, straight from the registers
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gq = row + half * 8;
          if (gq >= lq) continue;
          const float l = half ? l1 : l0, ri = 1.f / l;
          float* pr = args.probs +
                      (((size_t)seq * n_heads + h) * lq + gq) * lk;
#pragma unroll
          for (int nt = 0; nt < kKeys / 8; ++nt) {
            const int col = nt * 8 + 2 * t;
            if (col >= lk) continue;
            const float p0 = div_rn(s[4 * nt + 2 * half], l, ri);
            const float p1 = div_rn(s[4 * nt + 2 * half + 1], l, ri);
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
        apply_keep<kKeys>(s, hsite, (uint32_t)seq * (uint32_t)lq + row, lk,
                          t);
      // O = bf16(p [* keep]) V, p from the score registers
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) acc_to_a(pa[kc], s, kc);
      float o[D / 2];
      sm::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc)
        sm::WgmmaRA<D, 1>::mma(o, pa[kc], desc<RB>(vs + kc * 16 * RB), kc);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_regs(o);
      // O / l into the warpgroup's output tile (or the tile's own Q rows,
      // read by S above), then stored
      const uint32_t ot = L::kOwnTile ? obuf + wg * 64 * RB : qt;
      if constexpr (L::kOwnTile) {
        if (tid == 0) sm::bulk_wait_read<0>();  // its last store read it
        sm::named_sync(1 + wg, 128);
      }
      const float ri0 = 1.f / l0, ri1 = 1.f / l1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float l = i ? l1 : l0, ri = i ? ri1 : ri0;
          sm::st_shared(ot + swz<RB>(r_in + 8 * i, j) + 4 * t,
                        pack_bf16(div_rn(o[4 * j + 2 * i], l, ri),
                                  div_rn(o[4 * j + 2 * i + 1], l, ri)));
        }
      sm::fence_async_smem();
      sm::named_sync(1 + wg, 128);
      if (tid == 0) {
        tma_store3(&map_o, ot, h * D, tile * 64, seq);
        sm::bulk_commit();
      }
    }
    // the stage is free for the loads after the next (once its stores have
    // read it, where O went through the Q rows)
    if (!L::kOwnTile && tid == 0) sm::bulk_wait_read<0>();
    __syncthreads();
  }
  if (tid == 0) sm::bulk_wait();
}

// ------------------------------------------------------------ backward ----

struct BwdArgs {
  int lq, lk;
  float scale, scale_log2e;
  uint32_t seed_mix;
  int head_tag0;  // head h's keep mask has tag head_tag0 + h
  DropSite site;  // thresh, scale, half of the probability site
};

// The backward's shared keep bits: each phase-1 thread's words as
// keep_bits draws them (bit 4 nt + r: element r of n8 block nt of its two
// rows), one word apart more than it has (phase 2's reads, 16 threads of a
// warp on 16 phase-1 threads, then fall in distinct banks).
template <int kKeys>
constexpr int kBitLd = kBitWords<kKeys> + 1;

// Phase 1's dP chunks: keys a wgmma (the whole row block at tier 96), in
// the row pass and in the ds pass (which holds dQ's 32 accumulators too:
// at tier 256 under dropout, 64 keys spilled).
template <int kKeys>
constexpr int kChunk = kKeys == 96 ? 96 : 64;
template <int kKeys, bool kDrop>
constexpr int kChunkDs = kDrop && kKeys == 256 ? 32 : kChunk<kKeys>;

// dP of KC keys from key c * KC of a warpgroup's 64 query rows: dO V^T (the
// rows' dO at shared address dot, V at vs), times the keep mask that a's
// signs carry (a dropped score's a is negative or -0).
template <int D, int KC, int kKeys, bool kDrop>
__device__ __forceinline__ void dp_chunk(float (&dp)[KC / 2],
                                         const float (&a)[kKeys / 2], int c,
                                         uint32_t dot, uint32_t vs,
                                         float keep) {
  constexpr int RB = 2 * D;
  sm::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm::Wgmma<KC, 0, 0>::mma(dp, desc<RB>(dot + 32 * kk),
                             desc<RB>(vs + c * KC * RB + 32 * kk), kk);
  sm::wgmma_commit();
  sm::wgmma_wait<0>();
  sm::fence_regs(dp);
  if constexpr (kDrop) {
#pragma unroll
    for (int i = 0; i < KC / 2; ++i)
      dp[i] = a[c * (KC / 2) + i] < 0.f ? 0.f : dp[i] * keep;
  }
}

// attn_bwd_kernel's shared memory (from a 1024-byte aligned base): Q, dO
// [Lq rounded up to 64 rows], K, V [kKeys rounded up to 64 rows], rows of 2
// D bytes; each warpgroup's two [64, D] output tiles; m, l, 1 / l, row [Lq
// rounded up to 64] f32; with dropout the keep bits of phase 1's threads
// [Lq rounded up to 64 / 64][128][kBitLd]; the two load barriers.
template <int D, int kKeys, bool kDrop>
struct BwdSmem {
  static constexpr int RB = 2 * D;
  static constexpr int kK64 = (kKeys + 63) / 64 * 64;
  static constexpr int kTile = 64 * RB;
  int lq64, dout, k, v, out, stats, mask, bars, bytes;  // offsets; Q at 0
  __host__ __device__ explicit BwdSmem(int lq)
      : lq64((lq + 63) / 64 * 64),
        dout(lq64 * RB),
        k(2 * lq64 * RB),
        v(k + kK64 * RB),
        out(v + kK64 * RB),
        stats(out + 2 * kWarpgroups * kTile),
        mask(stats + 4 * lq64 * 4),
        bars(mask + (kDrop ? lq64 / 64 * 128 * kBitLd<kKeys> * 4 : 0)),
        bytes(1024 + bars + 16) {}
};

// dq, dk, dv of one (sequence, head) (blockIdx.x, blockIdx.y): phase 1
// query-major (dq and the row statistics), phase 2 key-major (dk, dv), see
// the head note. The maps: the strided views of q, k, v, dO (boxes of one
// head's D columns by Lq rounded up to 64, or kKeys rounded up to 64, rows)
// and of dq, dk, dv (boxes of 64 rows).
template <int D, int kKeys, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dq,
                    const __grid_constant__ CUtensorMap map_dk,
                    const __grid_constant__ CUtensorMap map_dv,
                    const BwdArgs args) {
  using L = BwdSmem<D, kKeys, kDrop>;
  constexpr int RB = L::RB;
  constexpr int KC = kChunk<kKeys>, KS = kChunkDs<kKeys, kDrop>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned, as an offset into smem_raw (the compiler then keeps
  // the shared window: 32-bit addresses)
  uint8_t* const base =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  const int lq = args.lq, lk = args.lk;
  const L lay(lq);
  const uint32_t qs = sm::smem_u32(base), dos = qs + lay.dout,
                 ks = qs + lay.k, vs = qs + lay.v;
  float* const ms = reinterpret_cast<float*>(base + lay.stats);
  float* const ls = ms + lay.lq64;
  float* const ri = ls + lay.lq64;
  float* const rs = ri + lay.lq64;
  uint32_t* const Mb = reinterpret_cast<uint32_t*>(base + lay.mask);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + lay.bars);
  const int seq = blockIdx.x, h = blockIdx.y;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r_in = 16 * warp + g;  // the thread's rows r_in, r_in + 8
  const uint32_t out0 = qs + lay.out + wg * 2 * L::kTile;  // its two tiles
  const uint32_t out1 = out0 + L::kTile;

  // barrier 0: Q and K (the score product); barrier 1: dO and V
  if (threadIdx.x == 0) {
    sm::mbar_init(full, 1);
    sm::mbar_init(full + 1, 1);
    sm::fence_barrier_init();
    sm::mbar_expect_tx(full, (lay.lq64 + L::kK64) * RB);
    tma_load3(qs, &map_q, full, h * D, 0, seq);
    tma_load3(ks, &map_k, full, h * D, 0, seq);
    sm::mbar_expect_tx(full + 1, (lay.lq64 + L::kK64) * RB);
    tma_load3(dos, &map_do, full + 1, h * D, 0, seq);
    tma_load3(vs, &map_v, full + 1, h * D, 0, seq);
  }
  __syncthreads();

  const float sl2e = args.scale_log2e, scale = args.scale;
  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const int n_qt = lay.lq64 / 64, n_kt = (lk + 63) / 64;

  // ---- phase 1: query rows ----
  sm::mbar_wait(full, 0);
  for (int tile = wg; tile < n_qt; tile += kWarpgroups) {
    const uint32_t qt = qs + tile * 64 * RB, dot = dos + tile * 64 * RB;
    const int row = tile * 64 + r_in;
    // the keep bits, drawn before any score is live, to shared memory as
    // they fall in the fragment (phase 2 finds a (query, key)'s bit there)
    uint32_t* const mb = Mb + (tile * 128 + tid) * kBitLd<kKeys>;
    if constexpr (kDrop) {
      uint32_t bits[kBitWords<kKeys>];
      keep_bits<kKeys>(bits, hsite, (uint32_t)seq * (uint32_t)lq + row, lk,
                       t);
#pragma unroll
      for (int w = 0; w < kBitWords<kKeys>; ++w) mb[w] = bits[w];
    }
    float a[kKeys / 2];
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm::Wgmma<kKeys, 0, 0>::mma(a, desc<RB>(qt + 32 * kk),
                                  desc<RB>(ks + 32 * kk), kk);
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_regs(a);
    float m0, m1, l0, l1;
    scale_max<kKeys>(a, sl2e, lk, t, m0, m1);
    exp_rows(a, m0, m1, l0, l1);
    const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i)
      a[i] = (i & 3) < 2 ? div_rn(a[i], l0, r0) : div_rn(a[i], l1, r1);
    if (t == 0) {
      ms[row] = m0;
      ms[row + 8] = m1;
      ls[row] = l0;
      ls[row + 8] = l1;
      ri[row] = r0;
      ri[row + 8] = r1;
    }
    if constexpr (kDrop) {
      // each score's keep bit into the sign of its a (a >= 0: a dropped
      // score's a is kept negated, -0 where a = 0, which weighs nothing
      // either way), where the two dP passes read it
      uint32_t bits[kBitWords<kKeys>];
#pragma unroll
      for (int w = 0; w < kBitWords<kKeys>; ++w) bits[w] = mb[w];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i)
        if (!((bits[i >> 5] >> (i & 31)) & 1u)) a[i] = -a[i];
    }
    sm::mbar_wait(full + 1, 0);  // dO and V
    float row0 = 0.f, row1 = 0.f;
#pragma unroll
    for (int c = 0; c < kKeys / KC; ++c) {
      float dp[KC / 2];
      dp_chunk<D, KC, kKeys, kDrop>(dp, a, c, dot, vs, hsite.scale);
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        const float x = dp[i] * fabsf(a[c * (KC / 2) + i]);
        if ((i & 3) < 2) row0 += x;
        else row1 += x;
      }
    }
    row0 = quad_sum(row0);
    row1 = quad_sum(row1);
    if (t == 0) {
      rs[row] = row0;
      rs[row + 8] = row1;
    }
    // ds = bf16(a * (da - row)); dQ += ds K (K MN-major: keys are the k)
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kKeys / KS; ++c) {
      float dp[KS / 2];
      // its wait also retires the last chunk's dQ product
      dp_chunk<D, KS, kKeys, kDrop>(dp, a, c, dot, vs, hsite.scale);
#pragma unroll
      for (int i = 0; i < KS / 2; ++i)
        dp[i] = fabsf(a[c * (KS / 2) + i]) *
                (dp[i] - ((i & 3) < 2 ? row0 : row1));
      uint32_t sa[KS / 16][4];
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc) acc_to_a(sa[kc], dp, kc);
      sm::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc)
        sm::WgmmaRA<D, 1>::mma(dq, sa[kc],
                               desc<RB>(ks + (c * KS + 16 * kc) * RB), 1);
      sm::wgmma_commit();
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(dq);
    if (tid == 0) sm::bulk_wait_read<0>();  // the tile's last store read it
    sm::named_sync(1 + wg, 128);
    store_tile<D>(dq, scale, out0, &map_dq, h, tile * 64, seq, wg, tid);
  }
  __syncthreads();  // m, l, row (and the keep bits) of every query row

  // ---- phase 2: key rows ----
  for (int kt = wg; kt < n_kt; kt += kWarpgroups) {
    const uint32_t kts = ks + kt * 64 * RB, vts = vs + kt * 64 * RB;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const int key0 = kt * 64 + r_in;  // the thread's keys key0, key0 + 8
    for (int qc = 0; qc < n_qt; ++qc) {
      const uint32_t qcs = qs + qc * 64 * RB, docs = dos + qc * 64 * RB;
      float st[32], dpt[32];  // S^T, dP^T: 64 keys by 64 queries
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm::Wgmma<64, 0, 0>::mma(st, desc<RB>(kts + 32 * kk),
                                 desc<RB>(qcs + 32 * kk), kk);
      sm::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm::Wgmma<64, 0, 0>::mma(dpt, desc<RB>(vts + 32 * kk),
                                 desc<RB>(docs + 32 * kk), kk);
      sm::wgmma_commit();
      // the keep bits of the thread's (key0 + 8 i, query qc * 64 + 8 j + 2t
      // + e), gathered into bit 16 i + 2 j + e while the products run: as
      // phase 1's thread of the query's row drew them (tile qc, warp j / 2,
      // lane 4 (2t + e) + g / 2; its element 4 (key / 8) + 2 (j & 1) + (g &
      // 1))
      uint32_t kw = 0u;
      if constexpr (kDrop) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int bit = ((key0 + 8 * i) >> 3) * 4 + (g & 1);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t w =
                  Mb[(qc * 128 + (j >> 1) * 32 + (2 * t + e) * 4 + (g >> 1)) *
                         kBitLd<kKeys> +
                     (bit >> 5)];
              kw |= ((w >> ((bit + 2 * (j & 1)) & 31)) & 1u)
                    << (16 * i + 2 * j + e);
            }
        }
      }
      // S^T (and the last chunk's dV, dK products) retired; dP^T runs on
      // under the exp2 work
      sm::wgmma_wait<1>();
      sm::fence_regs(st);
      // st -> a (0 past lq or lk), keys as rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = qc * 64 + 8 * j + 2 * t;  // queries q, q + 1
        const float2 m2 = *reinterpret_cast<const float2*>(ms + q);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + q);
        const float2 i2 = *reinterpret_cast<const float2*>(ri + q);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const float a = div_rn(
                exp2_ftz(__fmul_rn(st[x], sl2e) - (e ? m2.y : m2.x)),
                e ? l2.y : l2.x, e ? i2.y : i2.x);
            st[x] = q + e < lq && key0 + 8 * i < lk ? a : 0.f;
          }
      }
      sm::wgmma_wait<0>();
      sm::fence_regs(dpt);
      // dpt -> ds = a (dP [* keep] - row), st -> a [* keep]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = qc * 64 + 8 * j + 2 * t;
        const float2 r2 = *reinterpret_cast<const float2*>(rs + q);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e, key = key0 + 8 * i;
            float mk = 1.f;
            if constexpr (kDrop)
              mk = q + e < lq && key < lk && (kw >> (16 * i + 2 * j + e)) & 1u
                       ? hsite.scale
                       : 0.f;
            // da = dP * keep rounded before row is taken from it (an FMA
            // would keep da's rounding error: ds != 0 at Lk 1)
            dpt[x] = st[x] * (__fmul_rn(dpt[x], mk) - (e ? r2.y : r2.x));
            st[x] *= mk;
          }
      }
      uint32_t aa[4][4], sa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        acc_to_a(aa[kc], st, kc);
        acc_to_a(sa[kc], dpt, kc);
      }
      // dV += bf16(a [* keep])^T dO, dK += bf16(ds)^T Q (queries are the k)
      sm::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        sm::WgmmaRA<D, 1>::mma(dv, aa[kc],
                               desc<RB>(docs + 16 * kc * RB), 1);
        sm::WgmmaRA<D, 1>::mma(dk, sa[kc], desc<RB>(qcs + 16 * kc * RB),
                               1);
      }
      sm::wgmma_commit();
    }
    sm::wgmma_wait<0>();
    sm::fence_regs(dk);
    sm::fence_regs(dv);
    if (tid == 0) sm::bulk_wait_read<0>();  // the tiles' last stores read them
    sm::named_sync(1 + wg, 128);
    store_tile<D>(dk, scale, out0, &map_dk, h, kt * 64, seq, wg, tid);
    store_tile<D>(dv, 1.f, out1, &map_dv, h, kt * 64, seq, wg, tid);
  }
  if (tid == 0) sm::bulk_wait();
}

// ----------------------------------------------------------------- host ----

bool bad_geometry(int n_seq, int lq, int lk, int n_heads, int head_dim) {
  return (head_dim != 32 && head_dim != 64) || n_seq <= 0 || lq <= 0 ||
         lk <= 0 || lq > kMaxL || lk > kMaxL || n_heads <= 0 ||
         n_heads > 65535 || (long long)n_seq * n_heads > 0x7fffffffLL;
}

// The 3-D tensor map [n_seq][rows][n_heads * D] of a bf16 view (row and
// sequence strides in elements), read or written in boxes of one head's D
// columns by box_rows rows, rows of 2 D bytes under the swizzle of that
// width, zero fill past the rows of a sequence. TMA takes a 16-byte aligned
// base and strides that are multiples of 16 bytes; anything else returns
// cudaErrorInvalidValue before any launch (ops/attention.py and
// ops/layer_fused.py::check_rows refuse such views first).
int encode_view(CUtensorMap* map, const void* ptr, int n_seq, int rows,
                int n_heads, int D, long long row_stride,
                long long seq_stride, int box_rows) {
  const sm::EncodeTiledFn fn = sm::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long cols = (long long)n_heads * D;
  if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 ||
      row_stride % 8 || seq_stride % 8 || row_stride < cols ||
      seq_stride < (long long)rows * row_stride)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n_seq};
  const cuuint64_t strides[2] = {(cuuint64_t)(row_stride * 2),
                                 (cuuint64_t)(seq_stride * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const auto encode = [&] {
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
              const_cast<void*>(ptr), dims, strides, box, steps,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_NONE,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    // cuTensorMapEncodeTiled needs the device's context current on this
    // thread; one of PyTorch's autograd threads may not have bound it (no
    // runtime call there has needed it yet). cudaSetDevice binds it.
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaSetDevice(dev);
    if (e != cudaSuccess) return (int)e;
    r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : 100 + (int)r;
}

struct Views {  // the forward's pointers and strides (elements)
  const void *q, *k, *v;
  void* o;
  int n_seq;
  long long q_row, q_seq, kv_row, kv_seq;
};

template <int D, int kKeys, bool kDrop, bool kProbs>
int launch_fwd(const Views& w, const FwdArgs& a, cudaStream_t stream) {
  using L = FwdSmem<D, kKeys>;
  const int lq64 = (a.lq + 63) / 64 * 64;
  CUtensorMap mq, mk, mv, mo;
  int e = encode_view(&mq, w.q, w.n_seq, a.lq, a.n_heads, D, w.q_row,
                      w.q_seq, lq64);
  if (!e)
    e = encode_view(&mk, w.k, w.n_seq, a.lk, a.n_heads, D, w.kv_row,
                    w.kv_seq, kKeys);
  if (!e)
    e = encode_view(&mv, w.v, w.n_seq, a.lk, a.n_heads, D, w.kv_row,
                    w.kv_seq, kKeys);
  const long long hid = (long long)a.n_heads * D;
  if (!e)
    e = encode_view(&mo, w.o, w.n_seq, a.lq, a.n_heads, D, hid,
                    (long long)a.lq * hid, 64);
  if (e) return e;
  const auto kernel = attn_fwd_kernel<D, kKeys, kDrop, kProbs>;
  const int smem = L::bytes(a.lq);
  // blocks an SM by Lq / 64 (the shared memory a block takes), found once
  static int per_sm[kMaxL / 64 + 1] = {};
  static int sms = 0;
  int& fit = per_sm[lq64 / 64];
  if (fit == 0) {
    cudaError_t ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(kMaxL));
    int dev = 0, n = 0;
    if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
    if (ce == cudaSuccess)
      ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (ce == cudaSuccess)
      ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                         smem);
    if (ce != cudaSuccess) return (int)ce;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    fit = n;
  }
  const long long most = (long long)fit * sms;
  const int grid = (int)(a.n_items < most ? a.n_items : most);
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mo, a);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kProbs>
int launch_attention(const Views& w, const FwdArgs& a, int head_dim,
                     cudaStream_t stream) {
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32
               ? launch_fwd<32, kKeys, kDrop, kProbs>(w, a, stream)
               : launch_fwd<64, kKeys, kDrop, kProbs>(w, a, stream);
  });
}

struct BwdViews {  // the backward's pointers and row strides (elements)
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  int n_seq, n_heads;
  long long q_row, kv_row, do_row, dq_row, dkv_row;
};

template <int D, int kKeys, bool kDrop>
int launch_bwd(const BwdViews& w, const BwdArgs& a, cudaStream_t stream) {
  using L = BwdSmem<D, kKeys, kDrop>;
  const int lq64 = (a.lq + 63) / 64 * 64, lq = a.lq, lk = a.lk;
  CUtensorMap mq, mk, mv, mdo, mdq, mdk, mdv;
  int e = encode_view(&mq, w.q, w.n_seq, lq, w.n_heads, D, w.q_row,
                      w.q_row * lq, lq64);
  if (!e)
    e = encode_view(&mk, w.k, w.n_seq, lk, w.n_heads, D, w.kv_row,
                    w.kv_row * lk, L::kK64);
  if (!e)
    e = encode_view(&mv, w.v, w.n_seq, lk, w.n_heads, D, w.kv_row,
                    w.kv_row * lk, L::kK64);
  if (!e)
    e = encode_view(&mdo, w.dout, w.n_seq, lq, w.n_heads, D, w.do_row,
                    w.do_row * lq, lq64);
  if (!e)
    e = encode_view(&mdq, w.dq, w.n_seq, lq, w.n_heads, D, w.dq_row,
                    w.dq_row * lq, 64);
  if (!e)
    e = encode_view(&mdk, w.dk, w.n_seq, lk, w.n_heads, D, w.dkv_row,
                    w.dkv_row * lk, 64);
  if (!e)
    e = encode_view(&mdv, w.dv, w.n_seq, lk, w.n_heads, D, w.dkv_row,
                    w.dkv_row * lk, 64);
  if (e) return 1000 + e;
  const auto kernel = attn_bwd_kernel<D, kKeys, kDrop>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L(kMaxL).bytes);
    if (ce != cudaSuccess) return 2000 + (int)ce;
    attr_set = true;
  }
  kernel<<<dim3(w.n_seq, w.n_heads), kThreads, L(lq).bytes, stream>>>(
      mq, mk, mv, mdo, mdq, mdk, mdv, a);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_attn_bwd(const BwdViews& w, const BwdArgs& a, int head_dim,
                    cudaStream_t stream) {
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32 ? launch_bwd<32, kKeys, kDrop>(w, a, stream)
                          : launch_bwd<64, kKeys, kDrop>(w, a, stream);
  });
}

FwdArgs fwd_args(void* probs, int n_seq, int lq, int lk, int n_heads,
                 float scale_log2e) {
  FwdArgs a{};
  a.probs = (float*)probs;
  a.n_items = n_seq * n_heads;
  a.lq = lq;
  a.lk = lk;
  a.n_heads = n_heads;
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
  const Views w{q, k, v, o, n_seq, q_row, q_seq, kv_row, kv_seq};
  return launch_attention<false, false>(
      w, fwd_args(nullptr, n_seq, lq, lk, n_heads, scale_log2e), head_dim,
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
  const Views w{q, k, v, o, n_seq, q_row, q_seq, kv_row, kv_seq};
  return launch_attention<false, true>(
      w, fwd_args(probs, n_seq, lq, lk, n_heads, scale_log2e), head_dim,
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
  const Views w{q, k, v, o, n_seq, q_row, q_seq, kv_row, kv_seq};
  FwdArgs a = fwd_args(nullptr, n_seq, lq, lk, n_heads, scale_log2e);
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, scale, half, 0u};
  return launch_attention<true, false>(w, a, head_dim, (cudaStream_t)stream);
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
  const BwdViews w{q,     k,       v,       dout,   dq,     dk,     dv,
                   n_seq, n_heads, q_row,   kv_row, do_row, dq_row, dkv_row};
  BwdArgs a{};
  a.lq = lq;
  a.lk = lk;
  a.scale = scale;
  a.scale_log2e = scale_log2e;
  a.seed_mix = seed_mix;
  a.head_tag0 = head_tag0;
  a.site = DropSite{0u, thresh, pscale, half, 0u};
  return active ? launch_attn_bwd<true>(w, a, head_dim, (cudaStream_t)stream)
                : launch_attn_bwd<false>(w, a, head_dim,
                                         (cudaStream_t)stream);
}

}  // extern "C"
