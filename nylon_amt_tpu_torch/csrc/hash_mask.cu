// K6's standalone kernel: the dropout keep mask of one site, written out, or
// applied to a tensor.
//
// Replaces nylon_amt_tpu/ops/attention.py:55 (hash_keep_mask) where the JAX
// code calls it outside a Pallas kernel (the training kernels call keep_value()
// of hash_mask.cuh in their epilogues instead). The training path launches it
// for the embedding-dropout site (x * mask on the first layer's input of each
// stage, forward and backward recompute, ops/layer_fused_train.py), the
// per-site models for every dropout site (models/hft.py, models/ablation.py:
// forward, backward and, with remat, the recompute); chip_smoke.py also holds
// its written masks bit for bit against the plain version.
//
// What bounds it: device-memory bytes. It reads x once (when given) and
// writes the output once; the hash is ~11 integer operations an element
// (~6 when packed), far under the card's integer issue rate at 2-8 bytes an
// element. So the design keeps HBM streaming and spends no issue slot it
// need not:
//
//  * 16-byte vectors: a thread loads and stores 8 bf16 or 4 f32 at a time
//    (x with the evict-first hint: it is read once), and each thread keeps
//    kUnroll items in flight (4 vectors when packed);
//  * no division in the loop. Unpacked (d2 % 256 != 0), the hash's linear
//    index is base + row * d2 + col = base + the element's flat index, so a
//    thread walks flat vectors and never needs its row; a flat tail of
//    fewer than a vector (rows * d2 not a multiple of it) is done scalar by
//    the first threads. Packed (d2 % 256 == 0), an item is the pair of
//    vectors at columns [c, c + v) and [c + d2/2, c + d2/2 + v) of one row:
//    a thread finds its (row, c) once, with one 32-bit division, and then
//    strides by a whole grid of items as a (rows, columns) step with a
//    carry;
//  * one hash per pair when packed: its low draw keeps element c, its high
//    draw element c + d2/2 (keep_bits of hash_mask.cuh);
//  * a persistent grid: at most the SM count times the blocks an SM holds
//    (nylon_hash_mask_occupancy), no more than an item a thread
//    (nylon_hash_mask_grid reports it, ops/attention.py::hash_mask_plan
//    mirrors it).
//
// All index arithmetic is 32-bit: the entry point refuses sites of 2^31
// elements or more, and the hash's linear index wraps mod 2^32 as
// hash_mask.cuh documents.

#include <algorithm>

#include "common.cuh"
#include "hash_mask.cuh"

using nylon::bf16;
using nylon::DropSite;
using nylon::hash_mix;
using nylon::keep_bits;

namespace {

constexpr int kThreads = 256;
// items a thread has in flight (one vector unpacked, a pair packed); one
// item a pass measured the same (PERF.md section 6)
constexpr int kUnroll = 2;

// x * keep, or keep alone, of one 16-byte vector: element e keeps `scale`
// when bit e of `bits` is set, else 0. A bf16 product is rounded once from
// the exact f32 product of the two bf16 values.
template <typename T>
__device__ __forceinline__ uint4 masked(uint4 v, bool has_x, uint32_t bits,
                                        float scale);

template <>
__device__ __forceinline__ uint4 masked<bf16>(uint4 v, bool has_x,
                                              uint32_t bits, float scale) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = (bits >> (2 * i)) & 1u ? scale : 0.f;
    float hi = (bits >> (2 * i + 1)) & 1u ? scale : 0.f;
    if (has_x) {
      lo *= __uint_as_float(w[i] << 16);
      hi *= __uint_as_float(w[i] & 0xFFFF0000u);
    }
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    w[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <>
__device__ __forceinline__ uint4 masked<float>(uint4 v, bool has_x,
                                               uint32_t bits, float scale) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float k = (bits >> i) & 1u ? scale : 0.f;
    if (has_x) k *= __uint_as_float(w[i]);
    w[i] = __float_as_uint(k);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load_x(const uint4* p) {
  return __ldcs(p);
}

// out = mask (x == nullptr) or x * mask over a (rows, d2) view, in f32 or
// bf16. Unpacked: `items` vectors of the flat view, then `tail` scalar
// elements. Packed: `rows` rows of `width` items, an item the vectors at
// column vector c and c + width of a row (width = d2 / 2 / v).
template <typename T, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    hash_mask_kernel(const T* __restrict__ x, T* __restrict__ out,
                     uint32_t rows, uint32_t width, uint32_t items,
                     uint32_t tail, DropSite site) {
  constexpr int kV = 16 / sizeof(T);
  const bool has_x = x != nullptr;
  const uint4* const xv = reinterpret_cast<const uint4*>(x);
  uint4* const ov = reinterpret_cast<uint4*>(out);
  const uint32_t stride = gridDim.x * kThreads;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  uint4 a[kUnroll] = {}, b[kUnroll] = {};  // x's vectors (unread: mask)
  if constexpr (kPacked) {
    // this thread's first item and the grid's step, as (row, column
    // vector): the loop adds them with a carry
    uint32_t row = t / width, c = t - row * width;
    const uint32_t drow = stride / width, dc = stride - drow * width;
    const uint32_t rv = 2 * width;  // vectors a row
    while (row < rows) {
      uint32_t r[kUnroll], cv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = row;
        cv[u] = c;
        c += dc;
        row += drow;
        if (c >= width) {
          c -= width;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (has_x && r[u] < rows) {
          a[u] = load_x(xv + r[u] * rv + cv[u]);
          b[u] = load_x(xv + r[u] * rv + width + cv[u]);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r[u] < rows) {
          uint32_t lo, hi;
          keep_bits<kV, true>(site,
                              site.base + r[u] * (uint32_t)site.half +
                                  cv[u] * kV,
                              lo, hi);
          ov[r[u] * rv + cv[u]] = masked<T>(a[u], has_x, lo, site.scale);
          ov[r[u] * rv + width + cv[u]] =
              masked<T>(b[u], has_x, hi, site.scale);
        }
    }
  } else {
    for (uint32_t k = t; k < items; k += kUnroll * stride) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (has_x && k + u * stride < items)
          a[u] = load_x(xv + k + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t kk = k + u * stride;
        if (kk < items) {
          uint32_t bits, unused;
          keep_bits<kV, false>(site, site.base + kk * kV, bits, unused);
          ov[kk] = masked<T>(a[u], has_x, bits, site.scale);
        }
      }
    }
    if (t < tail) {  // the last rows * d2 % v elements
      const uint32_t i = items * kV + t;
      float k = hash_mix((site.base + i) ^ site.key) >= site.thresh
                    ? site.scale
                    : 0.f;
      if (has_x) k *= nylon::to_f(x[i]);
      out[i] = nylon::from_f<T>(k);
    }
  }
}

// Blocks of hash_mask_kernel<T, kPacked> an SM holds at once (0 on error).
template <typename T, bool kPacked>
int occupancy() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, hash_mask_kernel<T, kPacked>, kThreads, 0) != cudaSuccess)
    return 0;
  return n;
}

// The vectors / items of a site (the arguments of hash_mask_kernel).
struct Shape {
  uint32_t width, items, tail;
};

Shape shape_of(uint32_t rows, uint32_t d2, bool packed, uint32_t v) {
  if (packed) return Shape{d2 / 2 / v, rows * (d2 / 2 / v), 0};
  return Shape{0, rows * d2 / v, rows * d2 % v};
}

// The persistent grid: at most the card's SMs times the blocks an SM holds
// (both read once a device), no more than one item a thread.
int grid(uint32_t items, bool is_bf16, bool packed) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices], held[kMaxDevices][4];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  const int k = 2 * is_bf16 + packed;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return -1;
  if (!held[dev][k])
    held[dev][k] = is_bf16 ? (packed ? occupancy<bf16, true>()
                                     : occupancy<bf16, false>())
                           : (packed ? occupancy<float, true>()
                                     : occupancy<float, false>());
  if (held[dev][k] <= 0) return -1;
  const long long want = (items + kThreads - 1) / kThreads;
  return (int)std::max(1LL, std::min((long long)sms[dev] * held[dev][k],
                                     want));
}

template <typename T, bool kPacked>
int launch(const void* x, void* out, uint32_t rows, uint32_t d2,
           const DropSite& site, cudaStream_t stream) {
  const Shape sh = shape_of(rows, d2, kPacked, 16 / sizeof(T));
  const int blocks = grid(sh.items, sizeof(T) == 2, kPacked);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  hash_mask_kernel<T, kPacked><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (T*)out, rows, sh.width, sh.items, sh.tail, site);
  return (int)cudaGetLastError();
}

// Whether the kernel takes a (rows, d2) site: fewer than 2^31 elements, a
// packed site's half row (half = d2 / 2) a whole number of vectors.
bool takes(long long rows, int d2, int half, int v) {
  return rows > 0 && d2 > 0 && rows * d2 < (1LL << 31) &&
         (!half || (2 * half == d2 && half % v == 0));
}

}  // namespace

extern "C" {

// x may be null (write the mask). dtype_bf16: 1 for bf16 x/out, 0 for f32.
// x and out start 16-byte aligned.
int nylon_hash_mask(const void* x, void* out, long long rows, int d2,
                    unsigned key, unsigned thresh, float scale, int half,
                    unsigned base, int dtype_bf16, void* stream) {
  if (!takes(rows, d2, half, dtype_bf16 ? 8 : 4) ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const DropSite site{key, thresh, scale, half, base};
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t r = (uint32_t)rows, n = (uint32_t)d2;
  if (dtype_bf16)
    return half ? launch<bf16, true>(x, out, r, n, site, s)
                : launch<bf16, false>(x, out, r, n, site, s);
  return half ? launch<float, true>(x, out, r, n, site, s)
              : launch<float, false>(x, out, r, n, site, s);
}

// Blocks of hash_mask_kernel an SM holds at once (0 on error).
int nylon_hash_mask_occupancy(int dtype_bf16, int packed) {
  if (dtype_bf16) return packed ? occupancy<bf16, true>()
                                : occupancy<bf16, false>();
  return packed ? occupancy<float, true>() : occupancy<float, false>();
}

// The grid nylon_hash_mask launches for a site on the current device (-1:
// it refuses the site).
int nylon_hash_mask_grid(long long rows, int d2, int half, int dtype_bf16) {
  const int v = dtype_bf16 ? 8 : 4;
  if (!takes(rows, d2, half, v)) return -1;
  return grid(shape_of((uint32_t)rows, (uint32_t)d2, half != 0, v).items,
              dtype_bf16 != 0, half != 0);
}

}  // extern "C"
