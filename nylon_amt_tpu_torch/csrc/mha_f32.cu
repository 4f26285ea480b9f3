// Float32 multi-head attention kernels on Hopper (sm_90a).
//
// The float32 twins of mha.cu's kernels, for the same TPU kernels of
// nylon_amt_tpu/ops/attention.py: fused_mha (K10: _fwd_kernel, _bwd_kernel),
// fused_mha_with_probs (K11) and fused_mha_dropout (K12:
// _fwd_dropout_kernel, _bwd_dropout_kernel), and the attention step of the
// float32 layer kernels K3-K5 and K7-K9 (the default model configuration
// computes in float32, and the TPU kernels follow their inputs' dtype).
// mha.cu keeps its scores in mma.sync.m16n8k16 bf16 fragments, which take
// no f32 operands, so these kernels are their own design on the CUDA cores:
// IEEE f32 products, f32 sums.
//
// One block of 8 warps owns one (sequence, head), as in mha.cu. The block
// stages the operands every warp reads (K and V of the head in the forward,
// 2 x 256 x 68 x 4 = 139 KB at D = 64) in shared memory as f32 rows padded
// to D + 4 floats, so that a lane reading row `lane` with 16-byte loads
// hits distinct banks. A warp takes 4 query rows at a time: its rows of Q
// go to the warp's own buffer (read as broadcasts), lane j owns keys j, j +
// 32, ... of the [4, tier] score block in registers (tier 96, 128 or 256,
// the sites' 88, 128 and 256 keys), so every K row read feeds 4 rows of
// FMAs. The exact row max comes from the registers (warp max), p = exp2(s -
// m) with s = f32(q k) * (scale * log2 e) (rounded: __fmul_rn keeps the
// product out of an FMA), l is summed from the unmasked p, p [* keep] goes to
// the warp's buffer, and the PV product has lane j own output columns 2j,
// 2j + 1 (D = 64) or j (D = 32); the 1/l normalisation is deferred to the
// output, as in the TPU bodies. K11 writes p / l from the registers.
//
// The backward (one block per (sequence, head), 8 warps) recomputes the
// probabilities and never stores them:
//  * phase 1, query-major: K and V in shared memory; per 4 query rows, s
//    -> m, l, a = p / l (IEEE division), dP = dO V^T [* keep], row = sum(dP
//    * a), ds = a * (dP - row), dQ = ds K * scale; (m, l, row) of every
//    query go to shared memory;
//  * phase 2, key-major, after a block barrier: Q and dO replace K and V in
//    shared memory; per 4 key rows, lane j owns queries j, j + 32, ...:
//    S^T and dP^T again, a from the shared statistics (the same dot products
//    in the same order, so the same bits as phase 1), dV = (a [* keep])^T
//    dO and dK = ds^T Q * scale.
// Every sum has a fixed order and no float atomics are used: a backward is
// the same bits from run to run. The keep masks are drawn per element by
// hash_mask.cuh's keep_value (K12: tag h; K7-K9: (tag_base + 8) * 64 + h),
// in both phases, so no keep bits are packed or stored.
//
// What bounds them: FFMA and shared-memory issue. A score needs one FMA
// per dimension per product; at D = 32 and 256 x 256 a (sequence, head) is
// 4.2 M FMAs (QK^T and PV), under a microsecond of the card's 67 TFLOP/s
// f32 peak spread over 132 SMs; 16-byte shared loads of K rows are shared by
// 4 query rows, of Q rows by one lane's 4 FMAs.

#include <type_traits>

#include "common.cuh"
#include "hash_mask.cuh"

using nylon::DropSite;
using nylon::keep_value;

namespace {

constexpr int kWarps = 8;
constexpr int kR = 4;  // query (forward, phase 1) or key (phase 2) rows a warp
constexpr int kMaxL = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [0, rows) of a strided [*, D] head slice into dst (row length D + 4)
// by cp.async; rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long row_stride, int rows,
                                           int n) {
  for (int c = threadIdx.x; c < rows * (D / 4); c += blockDim.x) {
    const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
    const bool ok = r < n;
    nylon::cp_async16(dst + r * (D + 4) + c4,
                      src + (long long)(ok ? r : 0) * row_stride + c4, ok);
  }
}

// Rows [r0, r0 + kR) of a strided slice into a warp's buffer (row length
// D); rows at or past n are zeros.
template <int D>
__device__ __forceinline__ void warp_rows(float* dst, const float* src,
                                          long long row_stride, int r0, int n,
                                          int lane) {
  for (int c = lane; c < kR * (D / 4); c += 32) {
    const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) *
                                                     row_stride + c4);
    *reinterpret_cast<float4*>(dst + r * D + c4) = v;
  }
}

// acc[r][j] = sum over d ascending of X[r][d] * Y[lane + 32 j][d] (one fmaf
// a step) for r < kR and j < nj: X the warp's rows (row length D, read as
// broadcasts), Y a block buffer (row length D + 4). fmaf's product is
// symmetric, so dot(X=a, Y=b) and dot(X=b, Y=a) give the same bits.
template <int D, int NJ>
__device__ __forceinline__ void dot_rows(float (&acc)[kR][NJ], const float* X,
                                         const float* Y, int nj, int lane) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      x[r] = *reinterpret_cast<const float4*>(X + r * D + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
      const float4 y =
          *reinterpret_cast<const float4*>(Y + (lane + 32 * j) * (D + 4) + d);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
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

// o[r][e] = sum over i < n4 (ascending) of P[r * pld + i] * Y[i][lane * DV
// + e]: P the warp's rows (broadcast reads), Y a block buffer (row length D
// + 4); n4 a multiple of 4.
template <int D>
__device__ __forceinline__ void rows_by_block(float (&o)[kR][D / 32],
                                              const float* P, int pld,
                                              const float* Y, int n4,
                                              int lane) {
  constexpr int DV = D / 32;
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int e = 0; e < DV; ++e) o[r][e] = 0.f;
  for (int i = 0; i < n4; i += 4) {
    float4 p[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      p[r] = *reinterpret_cast<const float4*>(P + r * pld + i);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float y[DV];
      const float* yr = Y + (i + u) * (D + 4) + lane * DV;
      if constexpr (DV == 2) {
        const float2 v = *reinterpret_cast<const float2*>(yr);
        y[0] = v.x;
        y[1] = v.y;
      } else {
        y[0] = yr[0];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float pu = u == 0 ? p[r].x : u == 1 ? p[r].y
                       : u == 2 ? p[r].z : p[r].w;
#pragma unroll
        for (int e = 0; e < DV; ++e) o[r][e] = fmaf(pu, y[e], o[r][e]);
      }
    }
  }
}

// A lane's DV output columns of one row.
template <int DV>
__device__ __forceinline__ void store_cols(float* dst, const float (&v)[DV]) {
  if constexpr (DV == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    dst[0] = v[0];
}

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

// K, V [kKeys][D + 4]; per warp Q rows [kR][D] and p rows [kR][kKeys].
template <int D, int kKeys>
constexpr size_t fwd_smem_bytes() {
  return ((size_t)2 * kKeys * (D + 4) + (size_t)kWarps * kR * (D + kKeys)) *
         sizeof(float);
}

template <int D, int kKeys, bool kDrop, bool kProbs>
__global__ void __launch_bounds__(kWarps * 32)
    attn_fwd_f32_kernel(const FwdArgs args) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 4, NK = kKeys / 32, DV = D / 32;
  const int lq = args.lq, lk = args.lk;
  float* const Ks = smem;
  float* const Vs = Ks + kKeys * LD;
  const int seq = blockIdx.x / args.n_heads, h = blockIdx.x % args.n_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const qw = Vs + kKeys * LD + warp * kR * D;
  float* const pw = Vs + kKeys * LD + kWarps * kR * D + warp * kR * kKeys;

  // group 0: K (the score product); group 1: V
  stage_rows<D>(Ks, args.k + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                lk);
  nylon::cp_async_commit();
  stage_rows<D>(Vs, args.v + seq * args.kv_seq + h * D, args.kv_row, kKeys,
                lk);
  nylon::cp_async_commit();
  nylon::cp_async_wait<1>();
  __syncthreads();

  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const float neg_inf = __int_as_float(0xff800000u);
  const float* const qsrc = args.q + seq * args.q_seq + h * D;
  const int groups = (lq + kR - 1) / kR;
  const int iters = (groups + kWarps - 1) / kWarps;  // block-uniform
  const int lk4 = (lk + 3) & ~3;
  for (int it = 0; it < iters; ++it) {
    const int grp = warp + it * kWarps;
    const bool active = grp < groups;
    const int r0 = grp * kR;
    float s[kR][NK], l[kR];
    if (active) {
      warp_rows<D>(qw, qsrc, args.q_row, r0, lq, lane);
      __syncwarp();
      dot_rows<D, NK>(s, qw, Ks, NK, lane);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
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
    }
    if (it == 0) {  // V has landed
      nylon::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    if constexpr (kProbs) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r0 + r >= lq) break;
        float* const pr =
            args.probs + (((size_t)seq * args.n_heads + h) * lq + r0 + r) * lk;
#pragma unroll
        for (int j = 0; j < NK; ++j)
          if (lane + 32 * j < lk) pr[lane + 32 * j] = s[r][j] / l[r];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float p = s[r][j];
        if constexpr (kDrop)
          if (lane + 32 * j < lk)
            p *= keep_value(hsite, (uint32_t)seq * (uint32_t)lq + r0 + r,
                            lane + 32 * j, lk);
        pw[r * kKeys + lane + 32 * j] = p;
      }
    __syncwarp();
    float o[kR][DV];
    rows_by_block<D>(o, pw, kKeys, Vs, lk4, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r >= lq) break;
      float v[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) v[e] = o[r][e] / l[r];
      store_cols<DV>(args.o + ((long long)seq * lq + r0 + r) * args.o_row +
                         h * D + lane * DV,
                     v);
    }
    __syncwarp();  // qw and pw are rewritten by the next group
  }
}

template <int D, int kKeys, bool kDrop, bool kProbs>
int launch_fwd(const FwdArgs& a, int n_items, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, kKeys>();
  auto kernel = attn_fwd_f32_kernel<D, kKeys, kDrop, kProbs>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_items, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kDrop, bool kProbs>
int launch_attention(const FwdArgs& a, int n_items, int head_dim,
                     cudaStream_t stream) {
  return with_tier(a.lk, [&](auto tier) {
    constexpr int kKeys = decltype(tier)::value;
    return head_dim == 32
               ? launch_fwd<32, kKeys, kDrop, kProbs>(a, n_items, stream)
               : launch_fwd<64, kKeys, kDrop, kProbs>(a, n_items, stream);
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

// Two block buffers of `rows` rows of D + 4 floats (K, V in phase 1; Q, dO
// in phase 2; rows = max(tier, lq rounded up to 32)), m, l, row of every
// query, and per warp two [kR][D] row buffers and two [kR][rows] buffers.
template <int D>
size_t bwd_smem_bytes(int rows) {
  return ((size_t)2 * rows * (D + 4) + (size_t)3 * rows +
          (size_t)kWarps * 2 * kR * (D + rows)) *
         sizeof(float);
}

template <int D, int kKeys, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32, 1)
    attn_bwd_f32_kernel(const BwdArgs args, int rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NK = kKeys / 32, DV = D / 32, NQ = kMaxL / 32;
  const int lq = args.lq, lk = args.lk;
  const int nq = (lq + 31) / 32;
  float* const B0 = smem;                  // K, then Q
  float* const B1 = B0 + rows * (D + 4);   // V, then dO
  float* const ms = B1 + rows * (D + 4);
  float* const ls = ms + rows;
  float* const rs = ls + rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const xw = rs + rows + warp * 2 * kR * (D + rows);
  float* const yw = xw + kR * D;
  float* const pa = yw + kR * D;   // [kR][rows]
  float* const pd = pa + kR * rows;  // [kR][rows]
  const int seq = blockIdx.x, h = blockIdx.y;
  const long long kv_off = seq * args.kv_seq + h * D;
  const long long q_off = seq * args.q_seq + h * D;
  const long long do_off = seq * args.do_seq + h * D;
  const float sl2e = args.scale_log2e, scale = args.scale;
  const float neg_inf = __int_as_float(0xff800000u);
  DropSite hsite = args.site;
  if constexpr (kDrop)
    hsite.key = nylon::tag_key(args.seed_mix, args.head_tag0 + h);
  const uint32_t row0 = (uint32_t)seq * (uint32_t)lq;

  // ---- phase 1: query rows ----
  stage_rows<D>(B0, args.k + kv_off, args.kv_row, kKeys, lk);
  stage_rows<D>(B1, args.v + kv_off, args.kv_row, kKeys, lk);
  nylon::cp_async_commit();
  nylon::cp_async_wait<0>();
  __syncthreads();
  const int lk4 = (lk + 3) & ~3;
  for (int grp = warp; grp * kR < lq; grp += kWarps) {
    const int r0 = grp * kR;
    warp_rows<D>(xw, args.q + q_off, args.q_row, r0, lq, lane);
    warp_rows<D>(yw, args.dout + do_off, args.do_row, r0, lq, lane);
    __syncwarp();
    float a[kR][NK], dp[kR][NK];
    dot_rows<D, NK>(a, xw, B0, NK, lane);
    dot_rows<D, NK>(dp, yw, B1, NK, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float m = neg_inf;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float x = __fmul_rn(a[r][j], sl2e);
        a[r][j] = lane + 32 * j < lk ? x : neg_inf;
        m = fmaxf(m, a[r][j]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        a[r][j] = exp2f(a[r][j] - m);
        sum += a[r][j];
      }
      const float l = nylon::warp_sum(sum);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        a[r][j] = a[r][j] / l;
        if constexpr (kDrop)
          if (lane + 32 * j < lk)
            dp[r][j] *= keep_value(hsite, row0 + r0 + r, lane + 32 * j, lk);
        rsum += dp[r][j] * a[r][j];
      }
      const float row = nylon::warp_sum(rsum);
      if (lane == 0 && r0 + r < lq) {
        ms[r0 + r] = m;
        ls[r0 + r] = l;
        rs[r0 + r] = row;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
        pd[r * rows + lane + 32 * j] = a[r][j] * (dp[r][j] - row);
    }
    __syncwarp();
    float dq[kR][DV];
    rows_by_block<D>(dq, pd, rows, B0, lk4, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r >= lq) break;
      float v[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) v[e] = dq[r][e] * scale;
      store_cols<DV>(args.dq + seq * args.dq_seq + (long long)(r0 + r) *
                                                       args.dq_row +
                         h * D + lane * DV,
                     v);
    }
    __syncwarp();
  }
  __syncthreads();  // K and V are dead; m, l, row of every query are in

  // ---- phase 2: key rows ----
  const int lq32 = nq * 32;
  stage_rows<D>(B0, args.q + q_off, args.q_row, lq32, lq);
  stage_rows<D>(B1, args.dout + do_off, args.do_row, lq32, lq);
  nylon::cp_async_commit();
  nylon::cp_async_wait<0>();
  __syncthreads();
  const int lq4 = (lq + 3) & ~3;
  for (int grp = warp; grp * kR < lk; grp += kWarps) {
    const int r0 = grp * kR;
    warp_rows<D>(xw, args.k + kv_off, args.kv_row, r0, lk, lane);
    warp_rows<D>(yw, args.v + kv_off, args.kv_row, r0, lk, lane);
    __syncwarp();
    float st[kR][NQ], dpt[kR][NQ];
    dot_rows<D, NQ>(st, xw, B0, nq, lane);
    dot_rows<D, NQ>(dpt, yw, B1, nq, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (j >= nq) break;
        const int q = lane + 32 * j, key = r0 + r;
        float ad = 0.f, ds = 0.f;
        if (q < lq && key < lk) {
          const float a = exp2f(__fmul_rn(st[r][j], sl2e) - ms[q]) / ls[q];
          float mk = 1.f;
          if constexpr (kDrop) mk = keep_value(hsite, row0 + q, key, lk);
          ad = a * mk;
          ds = a * (dpt[r][j] * mk - rs[q]);
        }
        pa[r * rows + q] = ad;
        pd[r * rows + q] = ds;
      }
    __syncwarp();
    float dv[kR][DV], dk[kR][DV];
    rows_by_block<D>(dv, pa, rows, B1, lq4, lane);
    rows_by_block<D>(dk, pd, rows, B0, lq4, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r >= lk) break;
      float v[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) v[e] = dk[r][e] * scale;
      const long long off = seq * args.dkv_seq +
                            (long long)(r0 + r) * args.dkv_row + h * D +
                            lane * DV;
      store_cols<DV>(args.dk + off, v);
      store_cols<DV>(args.dv + off, dv[r]);
    }
    __syncwarp();
  }
}

template <int D, int kKeys, bool kDrop>
int launch_bwd(const BwdArgs& a, int n_seq, int n_heads, cudaStream_t stream) {
  const int lq32 = (a.lq + 31) / 32 * 32;
  const int rows = lq32 > kKeys ? lq32 : kKeys;
  const size_t smem = bwd_smem_bytes<D>(rows);
  auto kernel = attn_bwd_f32_kernel<D, kKeys, kDrop>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(n_seq, n_heads), kWarps * 32, smem, stream>>>(a, rows);
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

}  // extern "C"
