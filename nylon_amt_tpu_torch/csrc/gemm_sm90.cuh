// The Hopper (sm_90a) GEMM mainloop of the port's bf16 layer kernels:
// TMA tile loads into a ring of shared-memory stages, full / empty
// mbarriers between one producer warp and two consumer warpgroups, and
// wgmma products with an f32 accumulator in registers. No epilogue lives
// here, only the helpers epilogues share (the fragment layout, swizzled
// staging, TMA stores): a kernel (layer_fused.cu, layer_fused_train.cu)
// runs this mainloop for each output tile it owns and then its own
// epilogue on the accumulator fragments. Its TF32 form (layer_fused_f32.cu)
// and its s8 form (layer_fused_q8.cu) follow at the end of the file.
//
// A block tile is kBM = 128 rows (warpgroup g owns rows 64 g .. 64 g + 63)
// by BN columns (64, 128, 192 or 256: one m64nBNk16 wgmma a k16 step). A
// stage is kBK = 64 deep in K, one 128-byte swizzle row of bf16. Each
// operand is K-major (K contiguous in memory) or MN-major (M or N
// contiguous: the wgmma transpose bit), a template parameter of the Ring:
//
//   * K-major, e.g. A [M, K] row-major (the forward's activations, the dX
//     product's dY) or B^T = W [N, K] row-major (the dX product's W): one
//     TMA box of 64 (K) x 128 (A) or x BN (B) rows, rows 128 bytes apart,
//     16-byte chunks XOR-swizzled by row % 8 (CU_TENSOR_MAP_SWIZZLE_128B).
//     Descriptor: SBO 1024 (eight rows), LBO unused; the k16 step advances
//     the start address by 32 bytes inside the swizzle row.
//   * MN-major, e.g. B [K, N] row-major as JAX keeps the weights (the
//     forward; the dW product's dY), or A^T with A [K, M] row-major (the dW
//     product's activations): 64-wide boxes of 64 (M or N) x 64 (K), each
//     64 K-rows of 128 bytes, 8 KB apart (BN / 64 of them for B; for A one
//     per warpgroup). Descriptor: LBO 8192 (from one 64-column box to the
//     next), SBO 1024 (eight K-rows); the k16 step advances 16 K-rows, 2048
//     bytes.
//
// Ragged K and M need no code: a box past the tensor's end is zero-filled
// by TMA (and its bytes still count toward the barrier's transaction), so
// K % 64 == 32 multiplies zeros into the sum.
//
// The block has 288 threads: warps 0-7 are the consumer warpgroups, warp 8
// the producer (one elected lane issues every TMA load). ptxas gives the
// kernels of layer_fused.cu up to 168 registers a thread under
// __launch_bounds__(288, 1), room for the m64n256 accumulator (128 f32) and
// the epilogue with no spills (chip_smoke.py (a) checks), so the register
// file needs no setmaxnreg rebalancing between producer and consumers.
//
// Pipeline: full[s] completes when stage s's bytes have landed (the
// producer's arrive.expect_tx + the TMA transactions); empty[s] when all 8
// consumer warps have released it (one lane a warp, after the wgmma that
// read it has retired). Producer and consumers walk the same sequence of
// (tile, k-block) pairs, so each keeps its own (stage, phase) and the
// parities need no exchange: a consumer waits full[s] on `phase`, the
// producer waits empty[s] on `phase ^ 1` (a fresh barrier passes that
// wait at once).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"

namespace nylon {
namespace sm90 {

constexpr int kBM = 128;       // rows of a block tile
constexpr int kBK = 64;        // depth of a stage
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kBoxBytes = 64 * 128;  // one 64-row box of 128-byte rows

// A waiter that sees no phase change for this many SM cycles (~17 s) traps:
// a broken parity then fails the launch instead of hanging the card.
constexpr long long kHangCycles = 1ll << 35;

// ------------------------------------------------------------ barriers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------- TMA --

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Box at (x = inner coordinate, y = outer) of `map` into `dst`, completing
// on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// The box at shared address `src` to (x, y) of `map`; TMA clips what lies
// past the tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All but the newest N committed stores have finished reading shared
// memory.
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The committed stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA) reads of them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// Byte offset of the 16-byte chunk `chunk` (0-7) of row `row` in a box of
// 128-byte rows under the 128-byte swizzle (box start 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// -------------------------------------------------------------- wgmma --

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to the accumulator across the
// asynchronous wgmma (which writes it after the asm statement returns).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D[64, N] (+)= A[64, 16] B[16, N], bf16 in, f32 accumulator: thread t of
// the warpgroup holds d[4 j + 2 i + c] = D[16 (t / 32) + (t % 32) / 4 +
// 8 i][8 j + 2 (t % 4) + c]. kTA / kTB: the operand is MN-major (1) or
// K-major (0). scale_d == 0 overwrites D.
template <int N, int kTA, int kTB>
struct Wgmma;

#define NYLON_D8(i)                                                    \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),            \
      "+f"(d[(i) + 7])

template <int kTA, int kTB>
struct Wgmma<32, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : NYLON_D8(0), NYLON_D8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

template <int kTA, int kTB>
struct Wgmma<64, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

template <int kTA, int kTB>
struct Wgmma<96, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24),
        NYLON_D8(32), NYLON_D8(40)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

template <int kTA, int kTB>
struct Wgmma<128, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24),
        NYLON_D8(32), NYLON_D8(40), NYLON_D8(48), NYLON_D8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

template <int kTA, int kTB>
struct Wgmma<192, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24),
        NYLON_D8(32), NYLON_D8(40), NYLON_D8(48), NYLON_D8(56),
        NYLON_D8(64), NYLON_D8(72), NYLON_D8(80), NYLON_D8(88)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

template <int kTA, int kTB>
struct Wgmma<256, kTA, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24),
        NYLON_D8(32), NYLON_D8(40), NYLON_D8(48), NYLON_D8(56),
        NYLON_D8(64), NYLON_D8(72), NYLON_D8(80), NYLON_D8(88),
        NYLON_D8(96), NYLON_D8(104), NYLON_D8(112), NYLON_D8(120)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

// D[64, N] (+)= A[64, 16] B[16, N] with A from registers: thread t of the
// warpgroup holds a[0..3] = A[16 (t / 32) + g (+ 8 for a[1], a[3])][2 c, 2
// c + 1 (+ 8 for a[2], a[3])], g = (t % 32) / 4, c = t % 4, two bf16 a
// register (the accumulator layout of two n8 column blocks of a product
// whose output feeds this one); B a shared-memory descriptor, MN-major if
// kTB. D's layout is Wgmma's.
template <int N, int kTB>
struct WgmmaRA;

template <int kTB>
struct WgmmaRA<32, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : NYLON_D8(0), NYLON_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTB));
  }
};

template <int kTB>
struct WgmmaRA<64, kTB> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTB));
  }
};

#undef NYLON_D8

// --------------------------------------------------------------- ring --

// The dynamic shared memory of a block: kStages stages of (A boxes, B
// boxes), then kEpiBytes for the kernel's epilogue (swizzled 64 x 64
// boxes), then the barriers. Every piece starts on a 1024-byte boundary
// (the swizzle's period). As many stages as fit, at most 4. kTA / kTB: A /
// B MN-major (1) or K-major (0); the defaults are the forward's layout.
template <int BN, int kEpi, int kTA = 0, int kTB = 1>
struct Ring {
  static_assert(BN % 64 == 0 && BN >= 64 && BN <= 256, "BN");
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kEpiBytes = kEpi;
  static constexpr int kFit = (kSmemMax - 2048 - kEpiBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "stages");
  static constexpr int kBytes = 1024 + kStages * kStageBytes + kEpiBytes + 256;

  uint8_t* base;  // 1024-byte aligned
  int stage = 0;
  uint32_t phase = 0;

  __device__ explicit Ring(uint8_t* raw)
      : base(reinterpret_cast<uint8_t*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}

  __device__ uint8_t* a(int s) const { return base + s * kABytes; }
  __device__ uint8_t* b(int s) const {
    return base + kStages * kABytes + s * kBBytes;
  }
  // box i of the epilogue area
  __device__ uint8_t* epi(int i) const {
    return base + kStages * kStageBytes + i * kBoxBytes;
  }
  __device__ uint64_t* bars() const {
    return reinterpret_cast<uint64_t*>(base + kStages * kStageBytes +
                                       kEpiBytes);
  }
  __device__ uint64_t* full(int s) const { return bars() + s; }
  __device__ uint64_t* empty(int s) const { return bars() + kStages + s; }
  // the epilogue tile's own pair (a kernel that loads into it by TMA)
  __device__ uint64_t* epi_full() const { return bars() + 2 * kStages; }
  __device__ uint64_t* epi_empty() const { return bars() + 2 * kStages + 1; }

  __device__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // One thread, before the block's roles split (then __syncthreads()).
  __device__ void init(uint32_t epi_empty_count) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(epi_full(), 1);
    mbar_init(epi_empty(), epi_empty_count);
    fence_barrier_init();
  }

  // Producer: k-block kb (from K offset k0) of the tile at (m0, n0) into the
  // next stage, A and B in the layouts of kTA / kTB (the head of this file).
  __device__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                       int m0, int n0, int kb, int k0 = 0) {
    mbar_wait(empty(stage), phase ^ 1);
    mbar_expect_tx(full(stage), kStageBytes);
    if constexpr (kTA == 0) {
      tma_load(a(stage), map_a, full(stage), k0 + kb * kBK, m0);
    } else {
#pragma unroll
      for (int g = 0; g < kBM / 64; ++g)
        tma_load(a(stage) + g * kBoxBytes, map_a, full(stage), m0 + 64 * g,
                 k0 + kb * kBK);
    }
    if constexpr (kTB == 1) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_load(b(stage) + c * kBoxBytes, map_b, full(stage), n0 + 64 * c,
                 k0 + kb * kBK);
    } else {
      tma_load(b(stage), map_b, full(stage), k0 + kb * kBK, n0);
    }
    advance();
  }

  // Consumer warpgroup g: acc = A[rows of g] B over nk k-blocks. Keeps one
  // k-block of wgmmas in flight and releases each stage once the wgmmas
  // that read it have retired. After issuing a stage's wgmmas and
  // releasing the stage before it, calls on_stage(shared address of its B
  // boxes): work that runs while the tensor cores do, and may read the
  // stage (it is released only after the next stage's wgmmas are issued).
  template <typename OnStage>
  __device__ void mma(float (&acc)[BN / 2], int nk, int g, OnStage on_stage) {
    const bool signal = (threadIdx.x & 31) == 0;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full(stage), phase);
      // A: K-major, 64 rows of 128 bytes a warpgroup; MN-major, one box
      const uint32_t sa = smem_u32(a(stage)) + g * kBoxBytes;
      const uint32_t sb = smem_u32(b(stage));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        Wgmma<BN, kTA, kTB>::mma(
            acc,
            kTA ? sw128_desc(sa + 2048 * k, kBoxBytes, 1024)
                : sw128_desc(sa + 32 * k, 16, 1024),
            kTB ? sw128_desc(sb + 2048 * k, kBoxBytes, 1024)
                : sw128_desc(sb + 32 * k, 16, 1024),
            (kb | k) != 0);
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();
        if (signal) mbar_arrive(empty(prev));
      }
      on_stage(sb);
      prev = stage;
      advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (signal) mbar_arrive(empty(prev));
  }

  __device__ void mma(float (&acc)[BN / 2], int nk, int g) {
    mma(acc, nk, g, [](uint32_t) {});
  }
};

// ---------------------------------------------------------- epilogue --

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf16x2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// Where consumer thread `tid` (0-127) of a warpgroup finds its fragment
// d[4 j + 2 i + c]: row r0 + 8 i of the warpgroup's 64, column 8 j + 2 q +
// c of the tile; and the byte address of that (row, j) in a 64 x 64 box
// of 64-column block j / 8 at shared address `box`.
struct Frag {
  int r0, q;
  __device__ explicit Frag(int tid)
      : r0(((tid >> 5) << 4) + ((tid & 31) >> 2)), q(tid & 3) {}
  __device__ uint32_t addr(uint32_t box, int i, int j) const {
    return box + sw128(r0 + 8 * i, j & 7) + 4 * q;
  }
};

// The warpgroup's 64 x BN tile, staged as BN / 64 boxes from `ebase`, to
// (n0, row0) of `map` by its thread 0 (boxes wholly past N or M are
// skipped).
template <int BN>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t ebase, int n0, int row0,
                                           int N, int M) {
  if (row0 >= M) return;
#pragma unroll
  for (int c = 0; c < BN / 64; ++c)
    if (n0 + 64 * c < N)
      tma_store(map, ebase + c * kBoxBytes, n0 + 64 * c, row0);
  bulk_commit();
}

// -------------------------------------------------------------- host --

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver, through the runtime's entry-point
// query (so the library links no libcuda); null if the driver has none.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major [rows, cols] matrix of `elem`-byte elements
// of row stride ld (elements; a multiple of 16 bytes, 16-byte aligned) read
// or written in boxes of box_rows x one row of row_bytes (128, 64 or 32:
// row_bytes / elem columns) under the swizzle of that width, zero fill
// past the edges. Returns a cudaError_t.
inline int encode_swizzled(CUtensorMap* map, CUtensorMapDataType type,
                           int elem, const void* ptr, long long rows,
                           long long cols, long long ld, int box_rows,
                           int row_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || ld * elem % 16 ||
      rows <= 0 || cols <= 0 || ld < cols)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)(row_bytes / elem),
                             (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A contiguous [rows, cols] matrix in boxes of box_rows x one 128-byte
// swizzle row (128 / elem columns).
inline int encode_sw128(CUtensorMap* map, CUtensorMapDataType type, int elem,
                        const void* ptr, long long rows, long long cols,
                        int box_rows) {
  return encode_swizzled(map, type, elem, ptr, rows, cols, cols, box_rows,
                         128);
}

// bf16 [rows, cols] (cols % 8 == 0) in boxes of box_rows x 64 columns.
inline int encode_bf16(CUtensorMap* map, const void* ptr, long long rows,
                       long long cols, int box_rows) {
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows,
                      cols, box_rows);
}

// The tile width of an output N columns wide: N in the fewest tiles of at
// most 256 columns, each a multiple of 64.
inline int tile_width(int N) {
  const int tiles = (N + 255) / 256;
  return ((N + tiles - 1) / tiles + 63) / 64 * 64;
}

// Blocks of a persistent launch: every block the card holds at once (at
// most `tiles`), after raising the kernel's dynamic shared-memory limit.
template <typename Kernel>
int persistent_grid(Kernel kernel, int smem_bytes, long long tiles,
                    int* grid, int threads = kThreads) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)per_sm * sms;
  *grid = (int)(tiles < most ? tiles : most);
  return 0;
}


// ============================================================ TF32 ====
//
// The f32 form of the mainloop (layer_fused_f32.cu's forward GEMMs): the
// same ring, barriers, producer warp and consumer warpgroups, with wgmma
// m64nNk8 .tf32 products taken as 3xTF32 (tf32.cuh). What differs from
// the bf16 form:
//
//  * TF32 wgmma reads shared-memory operands K-major only (the transpose
//    bits are for 16-bit types), so B is the weights packed once on the
//    host as a K-major TF32 pair w_big, w_small [N, K] (ops/layer_fused.py
//    ::tf32_pair): two boxes of BN rows x 32 floats a stage, one 128-byte
//    swizzle row each, read by the K-major descriptor of the bf16 form (SBO
//    1024, the k8 step +32 bytes).
//  * A [M, K] (the activations) is split in registers: each consumer thread
//    reads its m64k8 fragments from the swizzled A box (rows r, r + 8 of its
//    warp's 16, columns t and t + 4 of each k8 step: 16 conflict-free
//    32-bit shared loads a stage), splits each value once, and issues the
//    register-A form of wgmma: small_a big_w + big_a small_w + big_a big_w
//    a k8 step, a k-block's 12 wgmmas in one chain, each chain's sum added
//    into an f32 register sum (mma3).
//  * A stage is kBKTf32 = 32 deep (one 128-byte row of floats), half the
//    bf16 stage's depth; the stage holds A (kRowsA x 128 bytes) and B's two
//    boxes (2 x BN x 128 bytes).
//  * The block has kThreadsTf32 = 384 threads: a full producer warpgroup,
//    whose registers the consumers take (reg_dealloc / reg_alloc).

constexpr int kBKTf32 = 32;

#define NYLON_D8(i)                                                    \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),            \
      "+f"(d[(i) + 7])

// D[64, N] (+)= A[64, 8] B[8, N], TF32 in, f32 accumulator; A from
// registers (thread t of the warpgroup holds a[0..3] = A[16 (t / 32) + g
// (+ 8 for a[1], a[3])][c (+ 4 for a[2], a[3])], g = (t % 32) / 4, c = t %
// 4), B a K-major shared-memory descriptor. D's layout is Wgmma's.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : NYLON_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : NYLON_D8(0), NYLON_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24),
        NYLON_D8(32), NYLON_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : NYLON_D8(0), NYLON_D8(8), NYLON_D8(16), NYLON_D8(24),
        NYLON_D8(32), NYLON_D8(40), NYLON_D8(48), NYLON_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

#undef NYLON_D8

// Hand registers between the warpgroups of a block (every warp of a
// warpgroup executes it). reg_alloc takes only what the block's own
// reg_dealloc gave back, so the TF32 kernels run kThreadsTf32 threads: the
// producer warpgroup's 4 warps give 128 of their 168 registers each (16384
// in all), the two consumer warpgroups take 64 more each (16384).
constexpr int kThreadsTf32 = (kConsumerWarps + 4) * 32;

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The ring of the TF32 form: kStages stages of (A box, w_big box, w_small
// box), then kExtra bytes for the kernel, then the barriers. A: kRowsA rows
// (a block's rows) of 32 floats; B: BN rows of each half of the pair.
template <int kRowsA, int BN, int kExtra>
struct RingTf32 {
  static_assert(kRowsA % 64 == 0 && kRowsA <= 256, "A box");
  static_assert(BN % 8 == 0 && BN <= 256, "B box");
  static constexpr int kABytes = kRowsA * 128;
  static constexpr int kBBytes = BN * 128;
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kExtraBytes = (kExtra + 1023) / 1024 * 1024;
  static constexpr int kFit =
      (kSmemMax - 1024 - 256 - kExtraBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "stages");
  static constexpr int kBytes =
      1024 + kStages * kStageBytes + kExtraBytes + 256;

  uint8_t* base;  // 1024-byte aligned
  int stage = 0;
  uint32_t phase = 0;

  __device__ explicit RingTf32(uint8_t* raw)
      : base(reinterpret_cast<uint8_t*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}

  __device__ uint8_t* a(int s) const { return base + s * kStageBytes; }
  __device__ uint8_t* b_big(int s) const { return a(s) + kABytes; }
  __device__ uint8_t* b_small(int s) const { return a(s) + kABytes + kBBytes; }
  __device__ uint8_t* extra() const { return base + kStages * kStageBytes; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(extra() + kExtraBytes) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(0) + kStages + s; }

  __device__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // One thread, before the block's roles split (then __syncthreads()).
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    fence_barrier_init();
  }

  // Producer: k-block kb of rows m0 of A and rows n0 of the pair.
  __device__ void load(const CUtensorMap* map_a, const CUtensorMap* map_big,
                       const CUtensorMap* map_small, int m0, int n0, int kb) {
    mbar_wait(empty(stage), phase ^ 1);
    mbar_expect_tx(full(stage), kStageBytes);
    const int k0 = kb * kBKTf32;
    tma_load(a(stage), map_a, full(stage), k0, m0);
    tma_load(b_big(stage), map_big, full(stage), k0, n0);
    tma_load(b_small(stage), map_small, full(stage), k0, n0);
    advance();
  }

  // Consumer warpgroup: acc[64, WN] = A[a_row0 .. a_row0 + 63] B[b_row0 ..
  // b_row0 + WN - 1]^T over nk k-blocks, 3xTF32. Each k-block's 12 wgmmas
  // accumulate in a chain of their own, added into acc in f32: over longer
  // chains the tensor core's own accumulation drifts (PERF.md). The
  // A fragments of k8 step s + 1 are read and split while step s's wgmmas
  // run; a stage is released once its wgmmas have retired.
  template <int WN>
  __device__ void mma3(float (&acc)[WN / 2], int nk, int a_row0,
                       int b_row0) {
    const int tid = threadIdx.x & 127;
    const int r = a_row0 + ((tid >> 5) << 4) + ((tid & 31) >> 2);
    const int c = tid & 3;
    const bool signal = (threadIdx.x & 31) == 0;
    float part[WN / 2];
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full(stage), phase);
      const uint32_t sa = smem_u32(a(stage));
      const uint32_t sb = smem_u32(b_big(stage)) + b_row0 * 128;
      const uint32_t ss = smem_u32(b_small(stage)) + b_row0 * 128;
      uint32_t big[4][4], small[4][4];
#pragma unroll
      for (int s = 0; s < kBKTf32 / 8; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r + 8 * (i & 1), k = 8 * s + c + 4 * (i >> 1);
          const Split x =
              split(ld_shared_f32(sa + sw128(row, k >> 2) + 4 * (k & 3)));
          big[s][i] = x.big;
          small[s][i] = x.small;
        }
        wgmma_fence();
        issue3<WN>(part, big[s], small[s], sb + 32 * s, ss + 32 * s, s);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < WN / 2; ++i)
        acc[i] = kb == 0 ? part[i] : acc[i] + part[i];
      if (signal) mbar_arrive(empty(stage));
      advance();
    }
  }

  // The three wgmmas of a k8 step into d, B's boxes at shared addresses sb
  // (w_big) and ss (w_small): small_a big_w + big_a small_w + big_a big_w;
  // `more` == 0 starts d afresh.
  template <int WN>
  static __device__ __forceinline__ void issue3(float (&d)[WN / 2],
                                                const uint32_t (&big)[4],
                                                const uint32_t (&small)[4],
                                                uint32_t sb, uint32_t ss,
                                                int more) {
    WgmmaTf32<WN>::mma(d, small, sw128_desc(sb, 16, 1024), more);
    WgmmaTf32<WN>::mma(d, big, sw128_desc(ss, 16, 1024), 1);
    WgmmaTf32<WN>::mma(d, big, sw128_desc(sb, 16, 1024), 1);
  }
};

// f32 [rows, cols] (cols % 4 == 0) in boxes of box_rows x 32 columns.
inline int encode_f32(CUtensorMap* map, const void* ptr, long long rows,
                      long long cols, int box_rows) {
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows,
                      cols, box_rows);
}


// ============================================================== s8 ====
//
// The int8 form of the mainloop (layer_fused_q8.cu's W8A8 GEMMs): the ring,
// barriers, producer warp and consumer warpgroups of the bf16 form, with
// wgmma m64nBNk32 .s32.s8.s8 products into an s32 accumulator. What differs
// from the bf16 form:
//
//  * 8-bit wgmma reads both shared-memory operands K-major only (the
//    transpose bits are for 16-bit types), so B is the weights packed once
//    on the host as W^T [N, K] (ops/layer_fused_q8.py::pack_wt), and A the
//    activation codes [M, K] as they are.
//  * A stage is kBKS8 = 128 deep: one 128-byte swizzle row of int8. So its
//    bytes are the bf16 K-major stage's (an A box of 128 rows and a B box of
//    BN rows, 128 bytes each), read by the same descriptors: SBO 1024, the
//    k32 step +32 bytes inside the swizzle row.
//  * The s32 accumulator has the f32 one's fragment layout (Frag).

constexpr int kBKS8 = 128;

// D[64, N] (+)= A[64, 32] B[32, N], s8 in, s32 accumulator, both operands
// K-major shared-memory descriptors. scale_d == 0 overwrites D.
template <int N>
struct WgmmaS8;

#define NYLON_R8(i)                                                    \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), \
      "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]),            \
      "+r"(d[(i) + 7])

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : NYLON_R8(0), NYLON_R8(8)
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : NYLON_R8(0), NYLON_R8(8), NYLON_R8(16), NYLON_R8(24)
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : NYLON_R8(0), NYLON_R8(8), NYLON_R8(16), NYLON_R8(24),
        NYLON_R8(32), NYLON_R8(40), NYLON_R8(48), NYLON_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : NYLON_R8(0), NYLON_R8(8), NYLON_R8(16), NYLON_R8(24),
        NYLON_R8(32), NYLON_R8(40), NYLON_R8(48), NYLON_R8(56),
        NYLON_R8(64), NYLON_R8(72), NYLON_R8(80), NYLON_R8(88)
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : NYLON_R8(0), NYLON_R8(8), NYLON_R8(16), NYLON_R8(24),
        NYLON_R8(32), NYLON_R8(40), NYLON_R8(48), NYLON_R8(56),
        NYLON_R8(64), NYLON_R8(72), NYLON_R8(80), NYLON_R8(88),
        NYLON_R8(96), NYLON_R8(104), NYLON_R8(112), NYLON_R8(120)
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

#undef NYLON_R8

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The ring of the s8 form: the bf16 ring's stages, epilogue area and
// barriers (both operands K-major), with the s8 producer load and consumer
// mainloop.
template <int BN, int kEpi>
struct RingS8 : Ring<BN, kEpi, 0, 0> {
  using Base = Ring<BN, kEpi, 0, 0>;
  static_assert(Base::kABytes == kBM * kBKS8 && Base::kBBytes == BN * kBKS8,
                "an s8 stage holds the bf16 K-major stage's bytes");

  __device__ explicit RingS8(uint8_t* raw) : Base(raw) {}

  // Producer: k-block kb of the tile at (m0, n0): A [M, K] rows m0.., W^T
  // [N, K] rows n0.., one box each.
  __device__ void load(const CUtensorMap* map_a, const CUtensorMap* map_wt,
                       int m0, int n0, int kb) {
    const int s = this->stage;
    mbar_wait(this->empty(s), this->phase ^ 1);
    mbar_expect_tx(this->full(s), Base::kStageBytes);
    tma_load(this->a(s), map_a, this->full(s), kb * kBKS8, m0);
    tma_load(this->b(s), map_wt, this->full(s), kb * kBKS8, n0);
    this->advance();
  }

  // Consumer warpgroup g: acc = A[rows of g] W over nk k-blocks, exact in
  // s32. Keeps one k-block of wgmmas in flight and releases each stage once
  // the wgmmas that read it have retired.
  __device__ void mma(int (&acc)[BN / 2], int nk, int g) {
    const bool signal = (threadIdx.x & 31) == 0;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = this->stage;
      mbar_wait(this->full(s), this->phase);
      const uint32_t sa = smem_u32(this->a(s)) + g * kBoxBytes;
      const uint32_t sb = smem_u32(this->b(s));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBKS8 / 32; ++k)
        WgmmaS8<BN>::mma(acc, sw128_desc(sa + 32 * k, 16, 1024),
                         sw128_desc(sb + 32 * k, 16, 1024), (kb | k) != 0);
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();
        if (signal) mbar_arrive(this->empty(prev));
      }
      prev = s;
      this->advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (signal) mbar_arrive(this->empty(prev));
  }
};

// int8 [rows, cols] (cols % 16 == 0) in boxes of box_rows x 128 columns.
inline int encode_s8(CUtensorMap* map, const void* ptr, long long rows,
                     long long cols, int box_rows) {
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, cols,
                      box_rows);
}

// ---------------------------------------------------------- clusters --
//
// A thread-block cluster's blocks write each other's shared memory
// (distributed shared memory) between cluster barriers.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster (all lanes of a warp
// together): the writes to shared memory before it are seen by every block
// after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v to shared address `addr` of block `rank` of the cluster (`addr`: the
// address in this block).
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, uint32_t rank,
                                               float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

}  // namespace sm90
}  // namespace nylon
