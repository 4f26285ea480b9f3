// K6's standalone kernel: the dropout keep mask of one site, written out, or
// applied to a tensor.
//
// The training kernels call keep_value() (hash_mask.cuh) in their epilogues;
// this kernel is the same device function over a whole (rows, d2) view. The
// training path launches it for the embedding-dropout site (x * mask on the
// first layer's input, ops/layer_fused_train.py); chip_smoke.py also holds
// its written masks bit for bit against the plain version.
//
// Bound by device memory: it reads x once (when given) and writes the
// output once, ~11 integer operations per element. A grid-stride loop with
// eight consecutive elements per thread keeps the loads and stores
// coalesced.

#include "common.cuh"
#include "hash_mask.cuh"

using nylon::bf16;
using nylon::bf16_round;
using nylon::DropSite;
using nylon::keep_value;

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

// out = mask (x == nullptr) or x * mask, in f32 or bf16. A bf16 product is
// rounded once from the exact f32 product of two bf16 values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hash_mask_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long rows, int d2, DropSite site) {
  const long long total = rows * d2;
  const long long stride = (long long)gridDim.x * kThreads * kPerThread;
  for (long long i0 =
           ((long long)blockIdx.x * kThreads + threadIdx.x) * kPerThread;
       i0 < total; i0 += stride) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long i = i0 + e;
      if (i >= total) break;
      const long long row = i / d2;
      const int col = (int)(i - row * d2);
      const float k = keep_value(site, (uint32_t)row, col, d2);
      float v = k;
      if (x != nullptr) {
        if constexpr (sizeof(T) == 2)
          v = bf16_round(__bfloat162float(x[i]) * k);
        else
          v = (float)x[i] * k;
      }
      if constexpr (sizeof(T) == 2)
        out[i] = __float2bfloat16(v);
      else
        out[i] = v;
    }
  }
}

}  // namespace

extern "C" {

// x may be null (write the mask). dtype_bf16: 1 for bf16 x/out, 0 for f32.
int nylon_hash_mask(const void* x, void* out, long long rows, int d2,
                    unsigned key, unsigned thresh, float scale, int half,
                    unsigned base, int dtype_bf16, void* stream) {
  if (rows <= 0 || d2 <= 0 || (half && 2 * half != d2))
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, base};
  const long long per_block = (long long)kThreads * kPerThread;
  long long blocks = (rows * d2 + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (dtype_bf16)
    hash_mask_kernel<bf16><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const bf16*)x, (bf16*)out, rows, d2, site);
  else
    hash_mask_kernel<float><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, rows, d2, site);
  return (int)cudaGetLastError();
}

}  // extern "C"
