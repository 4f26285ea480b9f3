// The per-element epilogues of the layer GEMMs, for either element type T
// (bf16 or f32): the float32 kernels of layer_fused_f32.cu compute with
// these, and they state, op for op, what the bf16 kernels compute after
// their products (the wgmma GEMMs of layer_fused.cu with bias_epilogue2 /
// residual_sum2 below, and the dX GEMM of layer_fused_train.cu with
// nt_epilogue2: the same bits as bias_epilogue<bf16>, residual_sum<bf16>
// and nt_epilogue<bf16> on column pairs). Every "round to T" of the reference
// (JAX's _matmul casts the f32 product to the compute dtype BEFORE the bias
// add, and every elementwise op rounds to its dtype) stays in the code; for
// f32 it is the identity. Every product is taken by __fmul_rn: in f32, where no rounding
// to T separates a product from the next addition, the compiler could
// otherwise fuse the two into one FMA and skip the product's rounding that
// the reference takes (in bf16 the rounding between prevents it anyway, so
// the bf16 kernels' bits do not change).
#pragma once

#include "common.cuh"
#include "hash_mask.cuh"

namespace nylon {

// out = T(acc) + bias [, ReLU] [, x keep of `site` at (row, col)]
template <typename T, bool kDrop>
__device__ __forceinline__ float bias_epilogue(float acc, float bias,
                                               int relu, const DropSite& site,
                                               uint32_t row, int col, int n) {
  float y = round_to<T>(round_to<T>(acc) + bias);
  if (relu) y = fmaxf(y, 0.f);
  if constexpr (kDrop)
    y = round_to<T>(__fmul_rn(y, keep_value(site, row, col, n)));
  return y;
}

// The pre-LN sum of a residual layer: res + (T(acc) + bias) [x keep].
template <typename T, bool kDrop>
__device__ __forceinline__ float residual_sum(float acc, float bias,
                                              float res, const DropSite& site,
                                              uint32_t row, int col, int n) {
  float y = round_to<T>(round_to<T>(acc) + bias);
  if constexpr (kDrop)
    y = round_to<T>(__fmul_rn(y, keep_value(site, row, col, n)));
  return round_to<T>(res + y);
}

// The same two epilogues in bf16 on a pair of adjacent columns (col, col +
// 1), packed, for the Hopper GEMMs of layer_fused.cu: the same bits as
// bias_epilogue<bf16> / residual_sum<bf16> on each element. An f32 sum or
// product of two bf16 values rounds to the same bf16 as their correctly
// rounded bf16 sum or product (the f32 result is exact unless one addend
// is below 2^-16 of the other, and then both round to the larger one; a
// product of two 8-bit significands is exact while it stays above f32's
// smallest normal, 2^-126), so each "round to bf16" after an add or a
// multiply is one bf16x2 instruction here, and the accumulator pair goes
// through the 16-lane conversion pipe once (cvt.rn.bf16x2.f32) instead of
// each value twice, plus once more to pack. `keep` holds the site's keep
// value in bf16 in both halves. The adds and multiplies carry an explicit
// .rn, which keeps ptxas from contracting a multiply and the add after it
// into one fma (one rounding where the reference takes two).
__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const __nv_bfloat162*>(&d);
}

__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const __nv_bfloat162*>(&d);
}

template <bool kDrop>
__device__ __forceinline__ __nv_bfloat162 keep_pair(
    __nv_bfloat162 y, const DropSite& site, __nv_bfloat162 keep,
    uint32_t row, int col, int n) {
  if constexpr (kDrop) {
    const __nv_bfloat162 z = __float2bfloat162_rn(0.f);
    y = mul_rn(y, __halves2bfloat162(
                       keeps(site, row, col, n) ? keep.x : z.x,
                       keeps(site, row, col + 1, n) ? keep.y : z.y));
  }
  return y;
}

// bf16(acc) + bias [, ReLU] [, x keep] on (col, col + 1)
template <bool kDrop>
__device__ __forceinline__ __nv_bfloat162 bias_epilogue2(
    float acc0, float acc1, __nv_bfloat162 bias, int relu,
    const DropSite& site, __nv_bfloat162 keep, uint32_t row, int col,
    int n) {
  __nv_bfloat162 y = add_rn(__floats2bfloat162_rn(acc0, acc1), bias);
  if (relu) y = __hmax2(y, __float2bfloat162_rn(0.f));
  return keep_pair<kDrop>(y, site, keep, row, col, n);
}

// res + (bf16(acc) + bias) [x keep] on (col, col + 1)
template <bool kDrop>
__device__ __forceinline__ __nv_bfloat162 residual_sum2(
    float acc0, float acc1, __nv_bfloat162 bias, __nv_bfloat162 res,
    const DropSite& site, __nv_bfloat162 keep, uint32_t row, int col,
    int n) {
  const __nv_bfloat162 y = keep_pair<kDrop>(
      add_rn(__floats2bfloat162_rn(acc0, acc1), bias), site, keep, row, col,
      n);
  return add_rn(res, y);
}

// The dX epilogue of the backward: T(acc) [x keep m1] [ReLU gate]
// [+ addend] [x keep m2].
struct NtEpilogue {
  const void* gate;    // keep v only where gate > 0 (ReLU of the forward)
  const void* addend;  // v = T(addend + v)
  DropSite m1;         // v = T(v * keep) right after the cast
  DropSite m2;         // v = T(v * keep) at the end
  int act1, act2;
};

// At most one of the gate and the addend, and at most one of m1 and m2, are
// on (every call of the backward gives them so): side is the value of the
// one given at the element, keep the keep value there (the site's or 0) of
// the site that is on.
template <typename T>
__device__ __forceinline__ float nt_epilogue(float acc, const NtEpilogue& ep,
                                             float side, float keep) {
  float v = round_to<T>(acc);
  if (ep.act1) v = round_to<T>(__fmul_rn(v, keep));
  if (ep.gate && !(side > 0.f)) v = 0.f;
  if (ep.addend) v = round_to<T>(side + v);
  if (ep.act2) v = round_to<T>(__fmul_rn(v, keep));
  return v;
}

// nt_epilogue<bf16> on (col, col + 1), packed as bias_epilogue2: bf16(acc)
// [x keep m1] [ReLU gate] [+ addend] [x keep m2], where at most one of the
// gate and the addend and at most one of m1 and m2 are on (the bf16 dX
// kernel's terms). side: the pair of ep.gate or ep.addend at (row, col);
// keep: the keep values of the dropout site that is on at the pair (its
// keep value or 0 in each half).
__device__ __forceinline__ __nv_bfloat162 nt_epilogue2(
    float acc0, float acc1, const NtEpilogue& ep, __nv_bfloat162 side,
    __nv_bfloat162 keep) {
  __nv_bfloat162 v = __floats2bfloat162_rn(acc0, acc1);
  if (ep.act1) v = mul_rn(v, keep);
  if (ep.gate) {
    const float2 g = __bfloat1622float2(side);
    const __nv_bfloat162 z = __float2bfloat162_rn(0.f);
    v = __halves2bfloat162(g.x > 0.f ? v.x : z.x, g.y > 0.f ? v.y : z.y);
  }
  if (ep.addend) v = add_rn(side, v);
  if (ep.act2) v = mul_rn(v, keep);
  return v;
}

}  // namespace nylon
