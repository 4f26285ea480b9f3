// Encoder stem + frequency position embedding for Hopper (sm_90a).
//
// Replaces the stem half of encoder_layer_with_stem in
// nylon_amt_tpu/ops/layer_fused.py (_enc_stem_kernel -> _stem_embed): the
// collapsed 65-tap stem convolution over frames, its bias, the sqrt(hid)
// embedding scale and the frequency position embedding. The layer half is
// K3's kernels (layer_fused.cu), launched after this one by the wrapper
// (ops/layer_fused.py::encoder_layer_with_stem).
//
// What bounds it here: each output element is a 65-tap f32 dot product
// (~35 GFLOP per batch-32 paper forward) against 2 bytes written, so the
// kernel is bound by f32 FMA issue and shared-memory loads, not by device
// memory. The reference keeps the stem in IEEE f32, so it runs on the CUDA
// cores, not on TF32 tensor cores.
//
// What changes from the TPU design: Mosaic could not slice frames at
// arbitrary dynamic offsets, so the Pallas kernel turned the convolution into
// one matmul against a banded tap matrix (build_stem_kband), 8-alignment
// phases included. Shared memory has no such rule: a block stages the taps of
// its 64 hidden columns and the spectrogram rows of its 8 bins once, and each
// thread slides a register window along the frames (4 frames x 8 columns per
// thread, 4 taps per window load). The f32 conv output and the transposed,
// scaled and embedded intermediates of the plain route never reach device
// memory: the kernel writes the bf16 layer input [B * n_frame, n_bin, hid].
//
// Numerics follow the plain route step by step: f32 sum, rounded to bf16,
// + bf16(bias), x bf16(sqrt(hid)), + position embedding, each op rounded to
// bf16 as PyTorch and XLA round a bf16 elementwise op.

#include "common.cuh"

using nylon::bf16;
using nylon::bf16_round;

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 8;   // frequency bins per block
constexpr int kCols = 64;  // hidden columns per block: 8 per thread
constexpr int kFrames = 128;  // frames per pass: 32 thread rows x 4

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Spectrogram row length in shared memory: the last window load of the last
// frame group reads up to n_frame + round4(n_proc) - 1.
__host__ __device__ inline int spec_ld(int n_frame, int n_proc) {
  return round4(n_frame + round4(n_proc));
}

inline size_t stem_smem_bytes(int n_frame, int n_proc) {
  return (size_t)(round4(n_proc) * kCols + kBins * spec_ld(n_frame, n_proc)) *
         sizeof(float);
}

// out[(b * n_frame + f) * n_bin + bin, h] =
//   bf16(bf16(bf16(bf16(sum_m spec_t[b, f + m, bin] * keff[m, h]) + bq[h])
//             * sqrt_hid) + pos[bin, h])
// for one (64-column tile, 8-bin group, example). Thread (ty, tx) owns frames
// 4 ty .. 4 ty + 3 of each 128-frame pass and columns 4 tx .. 4 tx + 3 and
// 32 + 4 tx .. 32 + 4 tx + 3 of the tile (two conflict-free 16-byte loads).
__global__ void __launch_bounds__(kThreads)
    stem_embed_kernel(const float* __restrict__ spec_t,
                      const float* __restrict__ keff,
                      const float* __restrict__ beff,
                      const bf16* __restrict__ pos, bf16* __restrict__ out,
                      int total, int n_bin, int n_frame, int n_proc, int hid,
                      float sqrt_hid) {
  extern __shared__ __align__(16) float sm[];
  const int n_taps = round4(n_proc);
  const int sld = spec_ld(n_frame, n_proc);
  float* const Ks = sm;                   // [n_taps][kCols], zero taps past n_proc
  float* const Ss = Ks + n_taps * kCols;  // [kBins][sld], zero frames past the span

  const int h0 = blockIdx.x * kCols, bin0 = blockIdx.y * kBins, b = blockIdx.z;
  for (int e = threadIdx.x; e < n_taps * (kCols / 4); e += kThreads) {
    const int m = e / (kCols / 4), c4 = (e % (kCols / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < n_proc)
      v = *reinterpret_cast<const float4*>(keff + (size_t)m * hid + h0 + c4);
    *reinterpret_cast<float4*>(Ks + m * kCols + c4) = v;
  }
  const int span = n_frame + n_proc - 1;
  const float* const sb = spec_t + (size_t)b * total * n_bin + bin0;
  for (int e = threadIdx.x; e < sld * kBins; e += kThreads) {
    const int t = e / kBins, j = e % kBins;
    Ss[j * sld + t] = t < span ? sb[(size_t)t * n_bin + j] : 0.f;
  }
  __syncthreads();

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int ca = 4 * tx, cb = 32 + 4 * tx;  // the thread's two column quads
  float bq[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bq[e] = bf16_round(beff[h0 + ca + e]);
    bq[4 + e] = bf16_round(beff[h0 + cb + e]);
  }

  for (int j = 0; j < kBins; ++j) {
    const int bin = bin0 + j;
    const float* const srow = Ss + j * sld;
    float pq[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pq[e] = __bfloat162float(pos[(size_t)bin * hid + h0 + ca + e]);
      pq[4 + e] = __bfloat162float(pos[(size_t)bin * hid + h0 + cb + e]);
    }
    for (int fb = 0; fb < n_frame; fb += kFrames) {
      const int f = fb + 4 * ty;
      if (f >= n_frame) break;  // no barrier follows
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
      for (int m = 0; m < n_taps; m += 4) {
        // frames f .. f+3 at taps m .. m+3 read spec f + m .. f + m + 6
        const float4 w0 = *reinterpret_cast<const float4*>(srow + f + m);
        const float4 w1 = *reinterpret_cast<const float4*>(srow + f + m + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const float4 ka = *reinterpret_cast<const float4*>(Ks + (m + mm) * kCols + ca);
          const float4 kb = *reinterpret_cast<const float4*>(Ks + (m + mm) * kCols + cb);
          const float k[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(w[i + mm], k[e], acc[i][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bf16* const row = out + ((size_t)(b * n_frame + f + i) * n_bin + bin) * hid + h0;
        uint2 oa, ob;
        bf16* const pa = reinterpret_cast<bf16*>(&oa);
        bf16* const pb = reinterpret_cast<bf16*>(&ob);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float x = bf16_round(bf16_round(acc[i][e]) + bq[e]);
          x = bf16_round(x * sqrt_hid);
          const bf16 y = __float2bfloat16(x + pq[e]);
          if (e < 4) pa[e] = y; else pb[e - 4] = y;
        }
        *reinterpret_cast<uint2*>(row + ca) = oa;
        *reinterpret_cast<uint2*>(row + cb) = ob;
      }
    }
  }
}

}  // namespace

extern "C" int nylon_stem_embed(const void* spec_t, const void* keff,
                                const void* beff, const void* pos, void* out,
                                int batch, int total, int n_bin, int n_frame,
                                int n_proc, int hid, float sqrt_hid,
                                void* stream) {
  if (batch <= 0 || batch > 65535 || n_frame <= 0 || n_frame % 4 ||
      n_proc <= 0 || total < n_frame + n_proc - 1 || n_bin % kBins ||
      hid % kCols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stem_smem_bytes(n_frame, n_proc);
  const cudaError_t e = cudaFuncSetAttribute(
      stem_embed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hid / kCols, n_bin / kBins, batch);
  stem_embed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)spec_t, (const float*)keff, (const float*)beff,
      (const bf16*)pos, (bf16*)out, total, n_bin, n_frame, n_proc, hid,
      sqrt_hid);
  return (int)cudaGetLastError();
}
