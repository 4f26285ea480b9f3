// The TMA side of the attention kernels (mha.cu in bf16, mha_f32.cu in f32):
// 3-D tensor maps [sequence, row, column] of the strided head-interleaved
// views the callers pass (row stride 3 hid for a packed QKV, 2 hid for a
// packed KV), the 3-D box loads and stores, and the swizzled byte geometry
// and wgmma descriptors of the tiles they land. The byte geometry is the
// same for both element types: a k16 step of bf16 and a k8 step of TF32
// are both 32 bytes of a swizzle row.
#pragma once

#include "gemm_sm90.cuh"

namespace nylon {
namespace attn {

namespace sm = nylon::sm90;

// The shared-memory descriptor of an operand whose rows are RB bytes (128
// or 64) under the swizzle of that width, K-major (rows along M or N, the
// k step +32 bytes) or, for 16-bit types, MN-major one swizzle atom wide
// (rows along K, the k16 step +16 rows): either way eight rows apart
// (SBO), LBO unused.
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

// The 3-D tensor map [n_seq][rows][n_heads * D] of a view of elem_bytes-byte
// elements (2: bf16, 4: f32; row and sequence strides in elements), read or
// written in boxes of box_rows rows, zero fill past the rows of a
// sequence. bf16: a box is one head's D columns, rows of 2 D bytes under
// the swizzle of that width (128 or 64 bytes). f32: a box is 32 columns,
// one 128-byte swizzle row (a head of D columns is D / 32 boxes). TMA takes
// a 16-byte aligned base and strides that are multiples of 16 bytes;
// anything else returns cudaErrorInvalidValue before any launch
// (ops/attention.py and ops/layer_fused.py::check_rows refuse such views
// first).
inline int encode_view(CUtensorMap* map, const void* ptr, int elem_bytes,
                       int n_seq, int rows, int n_heads, int D,
                       long long row_stride, long long seq_stride,
                       int box_rows) {
  const sm::EncodeTiledFn fn = sm::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long cols = (long long)n_heads * D;
  if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 ||
      row_stride * elem_bytes % 16 || seq_stride * elem_bytes % 16 ||
      row_stride < cols || seq_stride < (long long)rows * row_stride)
    return (int)cudaErrorInvalidValue;
  const bool f32 = elem_bytes == 4;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n_seq};
  const cuuint64_t strides[2] = {(cuuint64_t)(row_stride * elem_bytes),
                                 (cuuint64_t)(seq_stride * elem_bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)(f32 ? 32 : D), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const auto encode = [&] {
    return fn(map,
              f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              3, const_cast<void*>(ptr), dims, strides, box, steps,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              f32 || D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
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

}  // namespace attn
}  // namespace nylon
