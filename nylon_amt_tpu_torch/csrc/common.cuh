// Small device helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nylon {

typedef __nv_bfloat16 bf16;

// 16-byte asynchronous global->shared copy; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr,
                                           bool pred) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem_ptr), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Round an f32 value to bf16 (nearest-even) and back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace nylon
