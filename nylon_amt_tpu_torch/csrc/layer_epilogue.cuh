// The per-element epilogues of the layer GEMMs, for either element type T
// (bf16 or f32): the float32 kernels of layer_fused_f32.cu compute with
// these, and they state, op for op, what the bf16 kernels of
// layer_fused.cu and layer_fused_train.cu compute after their wmma
// products. Every "round to T" of the reference (JAX's _matmul casts the
// f32 product to the compute dtype BEFORE the bias add, and every
// elementwise op rounds to its dtype) stays in the code; for f32 it is the
// identity. Every product is taken by __fmul_rn: in f32, where no rounding
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

// The dX epilogue of the backward: T(acc) [x keep m1] [ReLU gate]
// [+ addend] [x keep m2].
struct NtEpilogue {
  const void* gate;    // keep v only where gate > 0 (ReLU of the forward)
  const void* addend;  // v = T(addend + v)
  DropSite m1;         // v = T(v * keep) right after the cast
  DropSite m2;         // v = T(v * keep) at the end
  int act1, act2;
};

template <typename T>
__device__ __forceinline__ float nt_epilogue(float acc, const NtEpilogue& ep,
                                             float gate, float add,
                                             uint32_t row, int col, int n) {
  float v = round_to<T>(acc);
  if (ep.act1)
    v = round_to<T>(__fmul_rn(v, keep_value(ep.m1, row, col, n)));
  if (ep.gate && !(gate > 0.f)) v = 0.f;
  if (ep.addend) v = round_to<T>(add + v);
  if (ep.act2)
    v = round_to<T>(__fmul_rn(v, keep_value(ep.m2, row, col, n)));
  return v;
}

}  // namespace nylon
