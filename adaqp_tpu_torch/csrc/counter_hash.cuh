// The counter-based uniforms of the quantization kernels (quant_pack.cu,
// quant_rows.cu). The TPU kernels draw from the chip's hardware generator;
// here u of element (row, col) of a launch is a pure function of the
// launch's 32-bit key and (row, col): h = mix32(mix32(key ^ row) ^ col),
// u = (h & 0xFFFFFF) * 2^-24, with mix32 the lowbias32 hash (two
// xorshift-multiply rounds). ops/quant_cuda.py::uniforms computes the same
// numbers in PyTorch, so the plain versions draw the same codes.
#pragma once

#include <stdint.h>

namespace adaqp {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// The row's half of the hash of element (row, c): hrow = mix32(key ^ row)
// with the first xor-shift of the second mix32 folded in, h2 = hrow ^ (hrow
// >> 16), which equals the xor-shift of hrow ^ c for every c < 2^16.
__device__ __forceinline__ uint32_t row_hash(uint32_t key, uint32_t row) {
  const uint32_t h = mix32(key ^ row);
  return h ^ (h >> 16);
}

// y + u(key, row, c), rounded once, from h2 = row_hash(key, row) and a
// column c < 2^16: u = (h & 0xFFFFFF) * 2^-24 is exact, so the fma rounds
// once, as the plain version's y + u does.
__device__ __forceinline__ float add_uniform(float y, uint32_t h2, uint32_t c) {
  uint32_t h = (h2 ^ c) * 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return __fmaf_rn(__uint2float_rn(h & 0xFFFFFFu), 5.9604644775390625e-8f, y);
}

}  // namespace adaqp
