// Fused log-mel spectrogram for Hopper (sm_90a), on the FP64 tensor cores.
//
// Replaces log_mel_pallas in nylon_amt_tpu/ops/spectrogram_pallas.py
// (_kernel, _build_call): centre padding, framing, the windowed one-sided
// DFT, the power spectrum, the mel projection and the log in one pass. Only
// raw samples and the constants are read and only [T, n_mels] log-mel is
// written: the [T, n_fft] frame tensor and the power spectrum never reach
// device memory.
//
// What bounds it: the DFT, 2 x 2 x n_fft multiply-adds per frame and bin
// against 4 bytes of new samples per frame and hop: operations. They must
// be at least true f32 (bf16 passes gave 0.5 log-mel error on the TPU, and
// TF32 keeps ~3 decimal digits), and even f32 is not enough everywhere:
// where a low DFT bin of loud audio is nearly empty (|X| ~ 1e-3 against ~70
// of summed |terms|), any f32 summation order is ~7e-4 off in log-mel. So
// the DFT is an f64 GEMM on the FP64 tensor cores (mma.sync .f64, 67
// TFLOP/s on an H100 SXM, as fast as the f32 CUDA cores and twice their
// f64 FMA): A the frames, a strided view of the padded
// samples (row stride hop), B the f32 windowed bases, both widened to f64
// in registers (exact), every product of two f32 values exact in f64, the
// sums f64. The power is rounded to f32 once; the mel projection and the
// log run in f32 (positive terms, no cancellation).
//
// The design:
//  * Only the bins the filterbank uses: the host (ops/spectrogram.py::
//    kernel_bases) cuts the mel bins into groups whose bins lie within kBins
//    bins from an 8-aligned first bin (the mma's n), from the first to the
//    last non-zero filterbank row (bins 1..1024 of 1025 for the 256-mel
//    filterbank at n_fft 2048: bin 0 has no mel weight). A block owns
//    kFrames frames x one group: it computes those bins and writes the
//    group's mel bins itself, so no partial mel sum crosses blocks (a
//    bin at a group boundary is computed by both groups, and a warp's 16
//    bins are computed whole: 1088 bins for 1024, ~6% more work)
//    and two runs are bit-identical.
//  * The bases [n_fft, 2 x bins] hold each 8 bins' cos and then sin
//    columns side by side; a stage of 32 taps x 2 kBins columns (32 KB)
//    comes by TMA (encode_cols8, column blocks of 8) into a ring of
//    kStages (tma_ring.cuh: thread 0 issues the loads, no producer warp, so
//    the 8 warps keep up to 255 registers: 128 of them hold a thread's 16
//    f64 accumulator quads). The 8 warps each own the 64 frames x 32
//    columns (16 bins, cos and sin) of a block: their accumulators hold the
//    real and imaginary part of the same (frame, bin) in one thread, so the
//    power needs no exchange.
//  * The block's sample span ((kFrames - 1) hop + n_fft f32 samples, 72 KB
//    at hop 256) is read into shared memory once, 4 pad words after every
//    hop samples: frame r's tap t then sits at r (hop + 4) + t + 4 (t /
//    hop), a fixed offset from the stage's base for every fragment element
//    (no address arithmetic in the mainloop), and the 8 frames of an A
//    fragment load hit 8 distinct bank quads (hop % 32 == 0).
//  * The filterbank is sparse (at most 2 non-zeros a bin): the power of the
//    block's bins goes to shared memory and each mel bin gathers its own
//    contiguous range of bins, in ascending order, with its f32 weights.
//
// What changes from the TPU design: the Pallas kernel carried the mel sum
// across a sequential grid axis over frequency blocks, and deinterleaved rows
// and re-fetched a 16-row tail because BlockSpecs cannot overlap. CUDA blocks
// run in no order, so here a block owns whole mel bins; the frequency split
// over blocks fills the card (118 frame tiles alone leave 14 of 132 SMs
// idle on a 120 s file, and a shorter file more).

#include "tma_ring.cuh"

namespace {

namespace sm = nylon::sm90;

// The DMMA mainloop:
//  * mma16: mma.sync.aligned.m16n8k16.row.col.f64, the largest of the
//    three shapes PTX gives sm_90 for f64 (m16n8k4, k8, k16).
//  * warp_stage: one warp's 64 x 32 tile over one 32-deep stage: the B
//    fragments of a k step (4 n8 tiles) loaded and widened once, then for
//    each of the 4 m16 tiles its A fragment and 4 mma.sync.
//  * B from shared memory in column blocks of 8: [col block][32 k][8]
//    floats, as a TMA box of a 3-D view of a row-major [K, N] f32 matrix
//    (encode_cols8: dims 8 x K x N / 8, strides N * 4 and 32 bytes). A
//    fragment element (k = c + 4 i, n = g) sits at word 8 (c + 4 i) + g:
//    the 32 lanes of a load hit 32 banks.
constexpr int kMmaK = 16;            // depth of one mma.sync
constexpr int kBK = 32;              // depth of a stage
constexpr int kColBlock = kBK * 8;   // floats of one B column block a stage
constexpr int kNT = 4;               // n8 tiles of a warp

// D[16, 8] += A[16, 16] B[16, 8] in f64 (mma.sync m16n8k16 .f64). Lane l
// (g = l / 4, c = l % 4) holds a[i] = A[g + 8 (i % 2)][c + 4 (i / 2)],
// b[i] = B[c + 4 i][g] and d[i] = D[g + 8 (i / 2)][2 c + i % 2].
__device__ __forceinline__ void mma16(double (&d)[4], const double (&a)[8],
                                      const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// One warp: acc[mt][j] (+)= A[16 mt .. 16 mt + 15][stage] B[stage][8 j ..
// 8 j + 7] over the kBK taps of one stage, for mt < 4 and j < kNT: a 64 x
// 32 tile, 64 f64 accumulators a thread.
// a_at(row, k): A's f32 element at warp row `row` (< 64) and stage depth k
// (< kBK). sb: the warp's first B column block of the stage. A's elements
// are widened as they are loaded, B's once a k step.
template <typename ALoad>
__device__ __forceinline__ void warp_stage(double (&acc)[4][kNT][4],
                                           const ALoad& a_at,
                                           const float* sb, int g, int c) {
#pragma unroll
  for (int s = 0; s < kBK / kMmaK; ++s) {
    double b[kNT][kMmaK / 4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < kMmaK / 4; ++i)
        b[j][i] = (double)sb[j * kColBlock + (kMmaK * s + c + 4 * i) * 8 + g];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      double a[kMmaK / 2];
#pragma unroll
      for (int i = 0; i < kMmaK / 2; ++i)
        a[i] = (double)a_at(16 * mt + g + 8 * (i & 1),
                            kMmaK * s + c + 4 * (i >> 1));
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma16(acc[mt][j], a, b[j]);
    }
  }
}

// The tensor map of a row-major f32 [rows, cols] matrix (cols % 8 == 0,
// 16-byte aligned) read in boxes of kBK rows x box_cols columns (a
// multiple of 8, <= 256), laid out in shared memory as box_cols / 8 column
// blocks of [kBK][8] floats; zero fill past the edges. Returns a
// cudaError_t.
int encode_cols8(CUtensorMap* map, const void* ptr, long long rows,
                 long long cols, int box_cols) {
  const sm::EncodeTiledFn fn = sm::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || cols % 8 || rows <= 0 ||
      cols <= 0 || box_cols % 8 || box_cols <= 0 || box_cols > 256)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {8, (cuuint64_t)rows, (cuuint64_t)cols / 8};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, 32};
  const cuuint32_t box[3] = {8, (cuuint32_t)kBK, (cuuint32_t)box_cols / 8};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrames = 64;         // frames a block
constexpr int kBins = 128;          // bins a block, from its group's first
constexpr int kCols = 2 * kBins;    // their cos and sin columns
constexpr int kStages = 3;
constexpr int kPLd = kBins + 4;     // row length of the power tile
using BasesRing =
    nylon::ring::Ring<0, kCols * kBK * 4, kStages, kWarps>;
static_assert(kCols == kWarps * 32, "32 columns a warp");

// Sample e of the block's span at word skew(e): 4 pad words every hop.
__host__ __device__ __forceinline__ int skew(int e, int hop) {
  return e + 4 * (e / hop);
}

__host__ __device__ inline int span_samples(int hop, int n_fft) {
  return (kFrames - 1) * hop + n_fft;
}

// Shared memory (from a 1024-byte aligned base): the ring and its
// barriers, the skewed sample span, the power tile [kFrames][kPLd].
__host__ __device__ inline int ring_words() {
  return (BasesRing::kBytes + 15) / 16 * 4;
}
__host__ __device__ inline int span_words(int hop, int n_fft) {
  return (skew(span_samples(hop, n_fft) - 1, hop) + 1 + 3) / 4 * 4;
}
inline size_t log_mel_smem_bytes(int hop, int n_fft) {
  return 1024 + (size_t)(ring_words() + span_words(hop, n_fft) +
                         kFrames * kPLd) * sizeof(float);
}

// groups[4 y + 0..3] of block row y: its first bin (a multiple of 8), the
// bins its mel bins reach from there (<= kBins), its mel bins [lo, hi).
// mel_tab[3 m + 0..2] of mel bin m: first bin, bin count, offset of its
// weights in mel_w.
__global__ void __launch_bounds__(kThreads, 1)
    log_mel_kernel(const __grid_constant__ CUtensorMap map_bases,
                   const float* __restrict__ wav, int n,
                   const int* __restrict__ groups,
                   const int* __restrict__ mel_tab,
                   const float* __restrict__ mel_w, float* __restrict__ out,
                   int n_frames, int n_fft, int hop, int n_mels,
                   float log_offset) {
  extern __shared__ uint8_t smem_raw[];
  const BasesRing ring(smem_raw);
  float* const Xs = reinterpret_cast<float*>(ring.base) + ring_words();
  float* const Ps = Xs + span_words(hop, n_fft);
  const int f0 = blockIdx.x * kFrames;
  const int bin0 = groups[4 * blockIdx.y], n_bins = groups[4 * blockIdx.y + 1];
  const int mel_lo = groups[4 * blockIdx.y + 2];
  const int mel_hi = groups[4 * blockIdx.y + 3];
  if (threadIdx.x == 0) ring.init();
  const int span = span_samples(hop, n_fft);
  const long long s0 = (long long)f0 * hop - n_fft / 2;  // centre padding
  for (int e = threadIdx.x; e < span; e += kThreads) {
    const long long s = s0 + e;
    Xs[skew(e, hop)] = (s >= 0 && s < n) ? wav[s] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = n_fft / kBK;
  // the taps kb * kBK .. + kBK - 1 of the block's columns (from bin0)
  const CUtensorMap* const map = &map_bases;
  const auto fill = [&](int kb) {
    const int s = ring.fill(kb);
    nylon::ring::tma_load_3d(ring.b(s), map, ring.full(s), 0, kb * kBK,
                             bin0 / 4);
  };
  if (threadIdx.x == 0) {
    sm::tma_prefetch(map);
    for (int kb = 0; kb < kStages - 1 && kb < nk; ++kb) fill(kb);
  }

  // warp w: the block's columns 32 w .. 32 w + 31, i.e. n8 tiles cos, sin
  // of bins 16 w .. 16 w + 7, then cos, sin of bins 16 w + 8 .. 16 w + 15
  const int g = lane >> 2, c = lane & 3;
  const bool active = 16 * warp < n_bins;  // warp-uniform
  double acc[4][kNT][4] = {};
  const int rs = hop + 4;  // the span's words from one frame to the next
  for (int kb = 0; kb < nk; ++kb) {
    if (threadIdx.x == 0 && kb + kStages - 1 < nk) fill(kb + kStages - 1);
    const int s = ring.wait(kb);
    if (active) {
      // tap t0 + k of frame r at x[r rs + k]: t0 + k < the next multiple
      // of hop, as hop % kBK == 0
      const int t0 = kb * kBK;
      const float* const x = Xs + skew(t0, hop);
      const float* const sb = reinterpret_cast<const float*>(ring.b(s));
      warp_stage(
          acc, [&](int row, int k) { return x[row * rs + k]; },
          sb + 4 * warp * kColBlock, g, c);
    }
    ring.release(kb);
  }
  // acc[mt][j][e]: frame 16 mt + g + 8 (e / 2), column 8 j + 2 c + e % 2
  // of the warp: cos (j even) and sin (j odd) of bin 16 warp + 8 (j / 2) +
  // 2 c + e % 2
  if (active) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const double re = acc[mt][2 * jj][2 * h + e];
            const double im = acc[mt][2 * jj + 1][2 * h + e];
            p[e] = __double2float_rn(__fma_rn(re, re, __dmul_rn(im, im)));
          }
          *reinterpret_cast<float2*>(
              Ps + (16 * mt + g + 8 * h) * kPLd + 16 * warp + 8 * jj + 2 * c) =
              make_float2(p[0], p[1]);
        }
  }
  __syncthreads();

  // mel[f][m] = sum over the bins of m, ascending, of power x weight
  const int nm = mel_hi - mel_lo;
  for (int idx = threadIdx.x; idx < kFrames * nm;
       idx += kThreads) {
    const int f = idx / nm, m = mel_lo + idx % nm;
    if (f0 + f >= n_frames) break;  // idx / nm grows with idx
    const int lo = __ldg(mel_tab + 3 * m), cnt = __ldg(mel_tab + 3 * m + 1);
    const float* const w = mel_w + __ldg(mel_tab + 3 * m + 2);
    const float* const p = Ps + f * kPLd + lo - bin0;
    float s = 0.f;
    for (int q = 0; q < cnt; ++q) s = fmaf(p[q], __ldg(w + q), s);
    out[(size_t)(f0 + f) * n_mels + m] = logf(s + log_offset);
  }
}

}  // namespace

extern "C" int nylon_log_mel(const void* wav, int n, const void* bases,
                             int n_cols, const void* groups, int n_groups,
                             const void* mel_tab, const void* mel_w,
                             void* out, int n_frames, int n_fft, int hop,
                             int n_mels, float log_offset, void* stream) {
  if (n <= 0 || hop <= 0 || hop % kBK || n_fft <= 0 || n_fft % kBK ||
      n_mels <= 0 ||
      n_groups <= 0 || n_groups > 65535 || n_cols <= 0 || n_cols % 8 ||
      n_frames != 1 + n / hop)
    return (int)cudaErrorInvalidValue;
  const size_t smem = log_mel_smem_bytes(hop, n_fft);
  if (smem > (size_t)sm::kSmemMax) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int e = encode_cols8(&map, bases, n_fft, n_cols, kCols);
  if (e) return e;
  const cudaError_t s = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (s != cudaSuccess) return (int)s;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, n_groups);
  log_mel_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      map, (const float*)wav, n, (const int*)groups, (const int*)mel_tab,
      (const float*)mel_w, (float*)out, n_frames, n_fft, hop, n_mels,
      log_offset);
  return (int)cudaGetLastError();
}
