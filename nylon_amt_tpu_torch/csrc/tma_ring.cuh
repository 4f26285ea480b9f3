// A TMA ring with no producer warp (sm_90a): the f32-exact kernels of the
// port (log_mel.cu's DFT on the FP64 tensor cores, layer_fused_f32.cu's
// stem-layer QKV on the CUDA cores) and layer_fused_f32.cu's dW GEMM
// (3xTF32 wgmma, its B operand re-staged by the warps).
//
// They keep large register tiles (K1: 64 f64 accumulators a thread; the
// QKV: an 8 x 8 f32 tile and its operands; dW: the m64n128 sum beside its
// chain's accumulator, and the split fragments), and a block of 8 warps
// plus a producer warp gets at most 168 registers a thread (three of its 9
// warps share one SM sub-partition's 16384): K1 spilled there. So thread 0
// of the block issues the TMA loads itself, kStages - 1 stages ahead of the
// warps, in the same loop: before it refills a stage it waits until every
// warp has released the stage's previous use.
//
// Its encode_rows_of also maps the row tiles that layer_fused_train.cu's
// LayerNorm backward and layer_fused_q8.cu's V quantizer load by TMA into
// rings of their own (stage sizes known only at launch).
//
// Item q of a block's sequence of (tile, k-block) pairs lives in stage q %
// kStages, its u-th use (u = q / kStages): full[s] completes its phase u when
// the loads of item q have landed (thread 0's expect_tx + the TMA bytes),
// empty[s] its phase u once all kWarps warps have read item q (one lane a
// warp). Both sides derive the parities from q, so nothing is exchanged;
// mbar_wait traps after ~17 s instead of hanging the card.
#pragma once

#include "gemm_sm90.cuh"

namespace nylon {
namespace ring {

namespace sm = nylon::sm90;

// kStages stages of kABytes of A (0: none) and kBBytes of B from a
// 1024-byte aligned base (the 128-byte swizzle's period), then the
// barriers.
template <int kABytes, int kBBytes, int kStages, int kWarps>
struct Ring {
  static constexpr int kStageBytes = kABytes + kBBytes;
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "stage");
  static constexpr int kBytes = kStages * kStageBytes + 2 * kStages * 8;

  uint8_t* base;

  // raw: the block's dynamic shared memory. base is raw plus an offset, so
  // that the compiler still sees shared memory behind it and its loads are
  // LDS, not generic loads.
  __device__ explicit Ring(uint8_t* raw)
      : base(raw + ((1024 - (sm::smem_u32(raw) & 1023)) & 1023)) {}

  __device__ uint8_t* a(int s) const { return base + s * kStageBytes; }
  __device__ uint8_t* b(int s) const { return a(s) + kABytes; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kStages * kStageBytes) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(kStages + s); }

  // One thread, then __syncthreads().
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(full(s), 1);
      sm::mbar_init(empty(s), kWarps);
    }
    sm::fence_barrier_init();
  }

  // Thread 0, before it issues item q's loads on full(stage): the stage
  // once free, expecting `bytes` (those of the boxes it will load: the
  // whole stage unless some are left out). Returns the stage.
  __device__ int fill(int q, uint32_t bytes = kStageBytes) const {
    const int s = q % kStages, u = q / kStages;
    if (u > 0) sm::mbar_wait(empty(s), (uint32_t)((u - 1) & 1));
    sm::mbar_expect_tx(full(s), bytes);
    return s;
  }

  // Every warp: wait for item q; release it once read. Return its stage.
  __device__ int wait(int q) const {
    const int s = q % kStages;
    sm::mbar_wait(full(s), (uint32_t)((q / kStages) & 1));
    return s;
  }
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm::mbar_arrive(empty(q % kStages));
  }
};

// The box at (x, y, z) of a 3-D tensor map into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(sm::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm::smem_u32(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

// The tensor map of a row-major [rows, cols] matrix of `elem`-byte
// elements of row stride ld (elements; ld * elem a multiple of 16, the
// start 16-byte aligned) read in boxes of box_rows rows x box_cols columns
// (<= 256 each, box_cols * elem a multiple of 16), unswizzled: a box lands
// as [box_rows][box_cols] elements; zero fill past the edges. Returns a
// cudaError_t.
inline int encode_rows_of(CUtensorMap* map, CUtensorMapDataType type,
                          int elem, const void* ptr, long long rows,
                          long long cols, long long ld, int box_rows,
                          int box_cols) {
  const sm::EncodeTiledFn fn = sm::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || ld * elem % 16 ||
      ld < cols || rows <= 0 || cols <= 0 || box_cols * elem % 16 ||
      box_cols <= 0 || box_cols > 256 || box_rows <= 0 || box_rows > 256)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The TMA element type of T (bf16 or f32).
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

}  // namespace ring
}  // namespace nylon
