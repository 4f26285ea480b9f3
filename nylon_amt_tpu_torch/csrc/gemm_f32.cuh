// The float32 product core of the port's GEMM kernels (sm_90a).
//
// wmma and mma.sync take bf16 operands only, so the float32 instantiations
// of the layer GEMMs (layer_fused_f32.cu: the forwards of K2-K5 and K7-K9,
// and the dX and dW GEMMs of K7-K9's backward) multiply on the CUDA cores:
// true IEEE f32 products, f32 sums over k in ascending order per element.
// Only the order of the sums differs from PyTorch's f32 matmul.
//
// One block of 256 threads owns a BM x BN tile of C = A B. K-slices of 16
// are staged in shared memory k-major (As[k][m], Bs[k][n]), double-buffered:
// the next slice's 16-byte global loads sit in registers while the current
// slice is multiplied, and a single barrier per slice separates the two
// buffers. Thread (ty, tx) owns a TM x TN register micro-tile: rows
// (i / 4) * (BM / (TM / 4)) + 4 ty + i % 4 and columns (j / 4) * (BN / (TN /
// 4)) + 4 tx + j % 4, so its shared-memory reads are 16-byte vectors and
// neighbouring threads read neighbouring vectors.
//
// What bounds it: FFMA issue (67 TFLOP/s of f32 on an H100 SXM) with one
// 16-byte shared load per 4 FMAs of each operand row; the default model's
// products are small (hid 64, pf 128), so f32 speed is not this core's aim:
// PERF.md has its times.
#pragma once

#include "common.cuh"

namespace nylon {

// Operand layouts: A(m, k) = kAT ? a[k * lda + m] : a[m * lda + k];
// B(k, n) = kBT ? b[n * ldb + k] : b[k * ldb + n]. Rows m >= M, columns
// n >= N and depths k >= k_end read as zeros. The vectors along a
// contiguous axis are masked whole: that axis's extent (K for !kAT / kBT,
// M for kAT, N for !kBT) must be a multiple of 4, and every pointer and
// leading dimension 16-byte aligned.
template <int BM, int BN, int TM, int TN, bool kAT, bool kBT>
struct F32Gemm {
  static constexpr int kThreads = 256;
  static constexpr int kBK = 16;
  static constexpr int kTX = BN / TN, kTY = BM / TM;
  static constexpr int kALd = BM + 4, kBLd = BN + 4;
  static constexpr int kAVec = (BM * kBK / 4 + kThreads - 1) / kThreads;
  static constexpr int kBVec = (BN * kBK / 4 + kThreads - 1) / kThreads;
  static_assert(kTX * kTY == kThreads, "256 threads");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "16-byte micro-tile rows");

  struct Smem {
    float a[2][kBK * kALd];
    float b[2][kBK * kBLd];
  };

  __device__ static int tx() { return threadIdx.x % kTX; }
  __device__ static int ty() { return threadIdx.x / kTX; }
  // tile row of micro-tile row i, tile column of micro-tile column j
  __device__ static int row(int i) {
    return (i / 4) * (BM / (TM / 4)) + 4 * ty() + i % 4;
  }
  __device__ static int col(int j) {
    return (j / 4) * (BN / (TN / 4)) + 4 * tx() + j % 4;
  }

  __device__ static float4 ld4(const float* p, bool ok) {
    return ok ? *reinterpret_cast<const float4*>(p)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ static void fetch(float4 (&ra)[kAVec], float4 (&rb)[kBVec],
                               const float* a, int lda, const float* b,
                               int ldb, int M, int N, int m0, int n0, int k0,
                               int k_end) {
#pragma unroll
    for (int v = 0; v < kAVec; ++v) {
      const int c = threadIdx.x + v * kThreads;
      if (c >= BM * kBK / 4) break;
      if constexpr (kAT) {
        const int k = c / (BM / 4), m = (c % (BM / 4)) * 4;
        const bool ok = k0 + k < k_end && m0 + m < M;
        ra[v] = ld4(a + (size_t)(ok ? k0 + k : 0) * lda + (ok ? m0 + m : 0),
                    ok);
      } else {
        const int m = c / (kBK / 4), k = (c % (kBK / 4)) * 4;
        const bool ok = m0 + m < M && k0 + k < k_end;
        ra[v] = ld4(a + (size_t)(ok ? m0 + m : 0) * lda + (ok ? k0 + k : 0),
                    ok);
      }
    }
#pragma unroll
    for (int v = 0; v < kBVec; ++v) {
      const int c = threadIdx.x + v * kThreads;
      if (c >= BN * kBK / 4) break;
      if constexpr (kBT) {
        const int n = c / (kBK / 4), k = (c % (kBK / 4)) * 4;
        const bool ok = n0 + n < N && k0 + k < k_end;
        rb[v] = ld4(b + (size_t)(ok ? n0 + n : 0) * ldb + (ok ? k0 + k : 0),
                    ok);
      } else {
        const int k = c / (BN / 4), n = (c % (BN / 4)) * 4;
        const bool ok = k0 + k < k_end && n0 + n < N;
        rb[v] = ld4(b + (size_t)(ok ? k0 + k : 0) * ldb + (ok ? n0 + n : 0),
                    ok);
      }
    }
  }

  __device__ static void store(float* sa, float* sb, const float4 (&ra)[kAVec],
                               const float4 (&rb)[kBVec]) {
#pragma unroll
    for (int v = 0; v < kAVec; ++v) {
      const int c = threadIdx.x + v * kThreads;
      if (c >= BM * kBK / 4) break;
      if constexpr (kAT) {
        const int k = c / (BM / 4), m = (c % (BM / 4)) * 4;
        *reinterpret_cast<float4*>(sa + k * kALd + m) = ra[v];
      } else {
        const int m = c / (kBK / 4), k = (c % (kBK / 4)) * 4;
        sa[(k + 0) * kALd + m] = ra[v].x;
        sa[(k + 1) * kALd + m] = ra[v].y;
        sa[(k + 2) * kALd + m] = ra[v].z;
        sa[(k + 3) * kALd + m] = ra[v].w;
      }
    }
#pragma unroll
    for (int v = 0; v < kBVec; ++v) {
      const int c = threadIdx.x + v * kThreads;
      if (c >= BN * kBK / 4) break;
      if constexpr (kBT) {
        const int n = c / (kBK / 4), k = (c % (kBK / 4)) * 4;
        sb[(k + 0) * kBLd + n] = rb[v].x;
        sb[(k + 1) * kBLd + n] = rb[v].y;
        sb[(k + 2) * kBLd + n] = rb[v].z;
        sb[(k + 3) * kBLd + n] = rb[v].w;
      } else {
        const int k = c / (BN / 4), n = (c % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(sb + k * kBLd + n) = rb[v];
      }
    }
  }

  // acc[i][j] = sum over k in [k_begin, k_end) of A(m0 + row(i), k) *
  // B(k, n0 + col(j)), in ascending k. `slice(sb)` is called after each
  // K-slice with that slice's B tile in shared memory (Bs[k][n], zero rows
  // past k_end), before the barrier that frees it.
  template <typename F>
  __device__ static void run(Smem& sm, const float* a, int lda,
                             const float* b, int ldb, int M, int N, int m0,
                             int n0, int k_begin, int k_end,
                             float (&acc)[TM][TN], F slice) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
    if (nk == 0) return;
    float4 ra[kAVec], rb[kBVec];
    fetch(ra, rb, a, lda, b, ldb, M, N, m0, n0, k_begin, k_end);
    store(sm.a[0], sm.b[0], ra, rb);
    __syncthreads();
    const int r0 = 4 * ty(), c0 = 4 * tx();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < nk;
      if (more)
        fetch(ra, rb, a, lda, b, ldb, M, N, m0, n0,
              k_begin + (kt + 1) * kBK, k_end);
      const float* As = sm.a[cur];
      const float* Bs = sm.b[cur];
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM / 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + k * kALd + i * (BM / (TM / 4)) + r0);
          av[4 * i] = v.x;
          av[4 * i + 1] = v.y;
          av[4 * i + 2] = v.z;
          av[4 * i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + k * kBLd + j * (BN / (TN / 4)) + c0);
          bv[4 * j] = v.x;
          bv[4 * j + 1] = v.y;
          bv[4 * j + 2] = v.z;
          bv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      slice(Bs);
      if (more) store(sm.a[cur ^ 1], sm.b[cur ^ 1], ra, rb);
      __syncthreads();
    }
  }
};

}  // namespace nylon
