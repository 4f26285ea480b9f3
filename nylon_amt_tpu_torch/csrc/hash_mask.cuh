// K6: the inverted-dropout keep mask of the training kernels, as a device
// function.
//
// Replaces nylon_amt_tpu/ops/attention.py::hash_keep_mask (used inside the
// Pallas kernels of ops/layer_fused_train.py and ops/attention.py). The mask
// is a pure hash of the element's global index in the site's (rows, d2)
// view, mixed with the caller's seed and a per-site tag, so a forward kernel
// and the backward kernels that recompute it draw the same bits in any
// launch geometry. Bit for bit the JAX function:
//
//   lin  = base + row * w + (col mod w)              (all arithmetic mod 2^32)
//   x    = lin ^ key,  key = seed * 0x9E3779B9 ^ tag * 0x85EBCA6B
//   x   ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15; x *= 0x846CA68B
//
// Unpacked (d2 % 256 != 0): w = d2, keep when x >= thresh. Packed (d2 % 256
// == 0): w = d2 / 2 and each hash gives two 16-bit draws, the low half for
// columns [0, d2/2) and the high half for [d2/2, d2); keep when the draw >=
// thresh (the rate quantised to 1/65536). A kept element takes `scale`
// (1 / (1 - rate), rounded by the caller to the mask's dtype), a dropped one
// 0. The host computes key, thresh and scale (ops/attention.py).
//
// Cost: ~11 integer operations per element, or ~6 per element when packed;
// inside the GEMM and attention epilogues it adds no memory traffic.
#pragma once

#include <stdint.h>

namespace nylon {

struct DropSite {
  uint32_t key;     // seed * 0x9E3779B9 ^ tag * 0x85EBCA6B (mod 2^32)
  uint32_t thresh;  // keep when the draw >= thresh
  float scale;      // the keep value
  int half;         // d2 / 2 when packed, 0 when not
  uint32_t base;    // row0 * d1 * w of the JAX function (0 on a whole tensor)
};

__host__ __device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x;
}

// Whether element (row, col) of a site whose rows are d2 long is kept.
__device__ __forceinline__ bool keeps(const DropSite& s, uint32_t row,
                                      int col, int d2) {
  if (s.half) {
    const bool hi = col >= s.half;
    const uint32_t c = (uint32_t)(hi ? col - s.half : col);
    const uint32_t x = hash_mix((s.base + row * (uint32_t)s.half + c) ^ s.key);
    const uint32_t v = hi ? (x >> 16) : (x & 0xFFFFu);
    return v >= s.thresh;
  }
  const uint32_t x =
      hash_mix((s.base + row * (uint32_t)d2 + (uint32_t)col) ^ s.key);
  return x >= s.thresh;
}

// Keep value of element (row, col) of a site whose rows are d2 long.
__device__ __forceinline__ float keep_value(const DropSite& s, uint32_t row,
                                            int col, int d2) {
  return keeps(s, row, col, d2) ? s.scale : 0.f;
}

// The key of tag `tag` under a seed whose mix (seed * 0x9E3779B9) is
// seed_mix. The attention kernels give head h the tag head_tag0 + h: head_tag0
// is (tag_base + 8) * 64 in the training layers K7-K9
// (ops/layer_fused_train.py::_head_tag) and 0 in fused_mha_dropout (K12),
// whose TPU kernel hashes head h with the raw tag h.
__device__ __forceinline__ uint32_t tag_key(uint32_t seed_mix, int tag) {
  return seed_mix ^ ((uint32_t)tag * 0x85EBCA6Bu);
}

}  // namespace nylon
