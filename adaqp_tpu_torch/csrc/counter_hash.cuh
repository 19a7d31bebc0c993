// The counter-based uniforms of the quantization kernels (quant_pack.cu,
// quant_rows.cu). The TPU kernels draw from the chip's hardware generator;
// here u of element (row, col) of a launch is a pure function of the
// launch's 32-bit key and (row, col): h = mix32(mix32(key ^ row) ^ col),
// u = (h & 0xFFFFFF) * 2^-24, with mix32 the lowbias32 hash (two
// xorshift-multiply rounds). ops/quant_cuda.py::uniforms computes the same
// numbers in PyTorch, so the plain versions draw the same codes.
#pragma once

#include <stddef.h>
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

__device__ __forceinline__ float uniform(uint32_t key, uint32_t row, uint32_t col) {
  const uint32_t h = mix32(mix32(key ^ row) ^ col);
  return __uint2float_rn(h & 0xFFFFFFu) * 5.9604644775390625e-8f;  // 2^-24, exact
}

// element i of a row-major f32 (kBf16 = false) or bf16 array, as f32
template <bool kBf16>
__device__ __forceinline__ float load(const void* x, size_t i) {
  if constexpr (kBf16) {
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(x)[i]) << 16);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

}  // namespace adaqp
