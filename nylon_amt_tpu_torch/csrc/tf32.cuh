// The 3xTF32 split of an f32 operand, shared by the kernels that multiply
// f32 values on the tensor cores (mha_f32.cu's mma.sync products, the
// wgmma GEMMs of layer_fused_f32.cu) and mirrored bit for bit by the host
// pack of the weights (ops/layer_fused.py::tf32_pair).
//
// x ~ big + small: big = x rounded to nearest at TF32's 11 significant
// bits (Veltkamp's split, three f32 operations), small = x - big (exact),
// rounded to nearest by adding half a TF32 ulp to its bits (the tensor core
// drops the low 13). A product a b is then taken as small_a big_b + big_a
// small_b + big_a big_b with f32 accumulation (CUTLASS's
// OpMultiplyAddFastF32): the dropped small_a small_b is ~2^-22 of a b.
#pragma once

#include <stdint.h>

namespace nylon {

// An f32 operand as a TF32 pair: x ~ big + small, both round-to-nearest.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const float c = __fmul_rn(x, 8193.f);
  const float big = __fsub_rn(c, __fsub_rn(c, x));
  return {__float_as_uint(big), __float_as_uint(__fsub_rn(x, big)) + 0x1000u};
}

}  // namespace nylon
