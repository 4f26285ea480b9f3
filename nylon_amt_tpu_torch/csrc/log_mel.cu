// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces log_mel_pallas in nylon_amt_tpu/ops/spectrogram_pallas.py
// (_kernel, _build_call): centre padding, framing, the windowed one-sided
// DFT, the power spectrum, the mel projection and the log in one pass. Only
// raw samples are read and only [T, 256] log-mel is written: the [T, 2048]
// frame tensor and the [T, 1025] power spectrum never reach device memory.
//
// What bounds it here: the DFT is ~8.4 MFLOP per frame against 1 KB of new
// samples, so it is bound by arithmetic, and the arithmetic must be at least
// true f32 (bf16 passes gave 0.5 log-mel error on the TPU, and TF32 keeps ~3
// decimal digits). Even f32 is not enough everywhere: where a low DFT bin of
// loud audio is nearly empty (|X| ~ 1e-3 against ~70 of summed |terms|), any
// f32 summation order is ~7e-4 off in log-mel. So the f32 samples and bases
// are widened to f64 in shared memory and the DFT accumulates in f64 FMAs
// (products of f32 values are exact in f64), as a register-tiled GEMM on the
// CUDA cores: 4 frames x 4 frequencies per thread for the real and the
// imaginary part. The power is rounded to f32; the mel projection and the
// log run in f32 (positive terms, no cancellation).
//
// What changes from the TPU design: the Pallas kernel carried the mel sum
// across a sequential grid axis over frequency blocks, and deinterleaved rows
// and re-fetched a 16-row tail because BlockSpecs cannot overlap. CUDA blocks
// run in no order, so here one block owns 64 frames, reads their whole
// overlapping sample span into shared memory once, loops over every
// frequency chunk itself, and keeps the [64, 256] mel sums in registers.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFB = 64;       // frames per block
constexpr int kFK = 64;       // frequencies per chunk
constexpr int kTK = 32;       // DFT taps per stage
constexpr int kMels = 256;
constexpr int kFbRows = 16;   // filterbank rows staged at once

// Frame starts are hop (256) samples apart; one pad word per 256 puts the
// four frames a thread reads on different banks.
__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 8); }

__host__ __device__ inline int span_samples(int hop, int n_fft) {
  return (kFB - 1) * hop + n_fft;
}

// Shared memory: the f64 cos/sin stage [kTK][kFK] each (the f32 power tile
// [kFK][kFB] reuses it), the f32 filterbank rows, then the f64 samples.
inline size_t log_mel_smem_bytes(int hop, int n_fft) {
  return (size_t)2 * kTK * kFK * sizeof(double) +
         (size_t)kFbRows * kMels * sizeof(float) +
         (size_t)(skew(span_samples(hop, n_fft) - 1) + 1) * sizeof(double);
}

__global__ void __launch_bounds__(kThreads)
    log_mel_kernel(const float* __restrict__ wav, int n,
                   const float* __restrict__ wc_t,
                   const float* __restrict__ ws_t,
                   const float* __restrict__ fb, float* __restrict__ out,
                   int n_frames, int n_fft, int hop, int n_freq_pad,
                   float log_offset) {
  extern __shared__ __align__(16) double smd[];
  double* const Bc = smd;                   // [kTK][kFK] windowed cos basis
  double* const Bs = Bc + kTK * kFK;        // [kTK][kFK] windowed sin basis
  float* const Ps = reinterpret_cast<float*>(smd);  // [kFK][kFB] power, over Bc
  float* const Fs = reinterpret_cast<float*>(Bs + kTK * kFK);  // [kFbRows][kMels]
  double* const Xs = reinterpret_cast<double*>(Fs + kFbRows * kMels);  // samples, skewed

  const int f0 = blockIdx.x * kFB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int span = span_samples(hop, n_fft);
  const long long s0 = (long long)f0 * hop - n_fft / 2;  // centre padding
  for (int e = threadIdx.x; e < span; e += kThreads) {
    const long long s = s0 + e;
    Xs[skew(e)] = (s >= 0 && s < n) ? (double)wav[s] : 0.0;
  }

  // mel[i][4 jj + j]: frame ty*4 + i, mel bin (tx + 16 jj) * 4 + j
  float mel[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) mel[i][j] = 0.f;

  for (int k0 = 0; k0 < n_freq_pad; k0 += kFK) {
    // re/im[i][j]: frame ty*4 + i, frequency k0 + tx*4 + j
    double re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0;

    for (int t0 = 0; t0 < n_fft; t0 += kTK) {
      __syncthreads();  // Xs is loaded; Bc/Bs (and Ps) are free again
      for (int e = threadIdx.x; e < kTK * kFK / 4; e += kThreads) {
        const int r = e / (kFK / 4), c4 = (e % (kFK / 4)) * 4;
        const size_t g = (size_t)(t0 + r) * n_freq_pad + k0 + c4;
        const float4 c = *reinterpret_cast<const float4*>(wc_t + g);
        const float4 s = *reinterpret_cast<const float4*>(ws_t + g);
        double2* const bc = reinterpret_cast<double2*>(Bc + 4 * e);
        double2* const bs = reinterpret_cast<double2*>(Bs + 4 * e);
        bc[0] = make_double2(c.x, c.y);
        bc[1] = make_double2(c.z, c.w);
        bs[0] = make_double2(s.x, s.y);
        bs[1] = make_double2(s.z, s.w);
      }
      __syncthreads();
#pragma unroll 4
      for (int tt = 0; tt < kTK; ++tt) {
        double a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[skew((ty * 4 + i) * hop + t0 + tt)];
        const double2* const cr = reinterpret_cast<const double2*>(Bc + tt * kFK + tx * 4);
        const double2* const sr = reinterpret_cast<const double2*>(Bs + tt * kFK + tx * 4);
        const double2 c01 = cr[0], c23 = cr[1], s01 = sr[0], s23 = sr[1];
        const double c[4] = {c01.x, c01.y, c23.x, c23.y};
        const double s[4] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fma(a[i], c[j], re[i][j]);
            im[i][j] = fma(a[i], s[j], im[i][j]);
          }
      }
    }
    __syncthreads();  // every thread is done with Bc/Bs
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 p;
      p.x = (float)(re[0][j] * re[0][j] + im[0][j] * im[0][j]);
      p.y = (float)(re[1][j] * re[1][j] + im[1][j] * im[1][j]);
      p.z = (float)(re[2][j] * re[2][j] + im[2][j] * im[2][j]);
      p.w = (float)(re[3][j] * re[3][j] + im[3][j] * im[3][j]);
      reinterpret_cast<float4*>(Ps + (tx * 4 + j) * kFB)[ty] = p;
    }
    // mel[64 frames, 256] += power[64, kFK] @ fb[k0 : k0 + kFK, 256]
    for (int kb = 0; kb < kFK; kb += kFbRows) {
      __syncthreads();  // Ps is written; the previous Fs rows are consumed
      for (int e = threadIdx.x; e < kFbRows * kMels / 4; e += kThreads)
        reinterpret_cast<float4*>(Fs)[e] =
            reinterpret_cast<const float4*>(fb + (size_t)(k0 + kb) * kMels)[e];
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kFbRows; ++r) {
        const float4 a = reinterpret_cast<const float4*>(Ps + (kb + r) * kFB)[ty];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 b = reinterpret_cast<const float4*>(Fs + r * kMels)[tx + 16 * jj];
          mel[0][jj * 4 + 0] += a.x * b.x;
          mel[0][jj * 4 + 1] += a.x * b.y;
          mel[0][jj * 4 + 2] += a.x * b.z;
          mel[0][jj * 4 + 3] += a.x * b.w;
          mel[1][jj * 4 + 0] += a.y * b.x;
          mel[1][jj * 4 + 1] += a.y * b.y;
          mel[1][jj * 4 + 2] += a.y * b.z;
          mel[1][jj * 4 + 3] += a.y * b.w;
          mel[2][jj * 4 + 0] += a.z * b.x;
          mel[2][jj * 4 + 1] += a.z * b.y;
          mel[2][jj * 4 + 2] += a.z * b.z;
          mel[2][jj * 4 + 3] += a.z * b.w;
          mel[3][jj * 4 + 0] += a.w * b.x;
          mel[3][jj * 4 + 1] += a.w * b.y;
          mel[3][jj * 4 + 2] += a.w * b.z;
          mel[3][jj * 4 + 3] += a.w * b.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int frame = f0 + ty * 4 + i;
    if (frame >= n_frames) break;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 o;
      o.x = logf(mel[i][jj * 4 + 0] + log_offset);
      o.y = logf(mel[i][jj * 4 + 1] + log_offset);
      o.z = logf(mel[i][jj * 4 + 2] + log_offset);
      o.w = logf(mel[i][jj * 4 + 3] + log_offset);
      reinterpret_cast<float4*>(out + (size_t)frame * kMels)[tx + 16 * jj] = o;
    }
  }
}

}  // namespace

extern "C" int nylon_log_mel(const void* wav, int n, const void* wc_t,
                             const void* ws_t, const void* fb, void* out,
                             int n_frames, int n_fft, int hop, int n_freq_pad,
                             int n_mels, float log_offset, void* stream) {
  if (n <= 0 || hop <= 0 || n_mels != kMels || n_fft % kTK ||
      n_freq_pad % kFK || n_frames != 1 + n / hop)
    return (int)cudaErrorInvalidValue;
  const size_t smem = log_mel_smem_bytes(hop, n_fft);
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  log_mel_kernel<<<(n_frames + kFB - 1) / kFB, kThreads, smem,
                   (cudaStream_t)stream>>>(
      (const float*)wav, n, (const float*)wc_t, (const float*)ws_t,
      (const float*)fb, (float*)out, n_frames, n_fft, hop, n_freq_pad,
      log_offset);
  return (int)cudaGetLastError();
}
