// 16-byte vectors of bf16 or f32 values, summed in f32 registers: the
// helpers of the tile SpMM kernels on NVIDIA Hopper (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vec16 {

template <bool kBf16>
struct Elem {
  static constexpr int kVec = kBf16 ? 8 : 4;    // values per 16-byte load
  static constexpr int kBytes = kBf16 ? 2 : 4;  // bytes per value
};

template <bool kBf16>
__device__ __forceinline__ void add_vec(float (&acc)[Elem<kBf16>::kVec], const uint4& v) {
  if constexpr (kBf16) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // little-endian: value 2i is the low half of word i
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
}

template <bool kBf16>
__device__ __forceinline__ uint4 pack_vec(const float (&acc)[Elem<kBf16>::kVec]) {
  if constexpr (kBf16) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
}

}  // namespace vec16
