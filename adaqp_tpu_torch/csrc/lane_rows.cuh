// Row helpers of the wires' kernels (quant_pack.cu, quant_rows.cu): a
// warp staging one source row into shared memory as f32 with its range
// over the true columns (stage_row), and a lane storing or adding four
// neighbouring output columns (put4).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace adaqp {

// element i of a row-major f32 (kBf16 = false) or bf16 array, as f32
template <bool kBf16>
__device__ __forceinline__ float load(const void* x, size_t i) {
  if constexpr (kBf16) {
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(x)[i]) << 16);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// One 16-byte chunk v of a row into `row` as f32, with min and max over
// columns < f_true
template <bool kBf16>
__device__ __forceinline__ void put_chunk(uint4 u, int v, int f_true, float* __restrict__ row,
                                          float& lo, float& hi) {
  constexpr int kPer = kBf16 ? 8 : 4;
  float e[kPer];
  if constexpr (kBf16) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e[2 * k] = __uint_as_float(w[k] << 16);
      e[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
    e[0] = __uint_as_float(u.x);
    e[1] = __uint_as_float(u.y);
    e[2] = __uint_as_float(u.z);
    e[3] = __uint_as_float(u.w);
  }
  const int c0 = v * kPer;
#pragma unroll
  for (int k = 0; k < kPer; k += 4) {
    *reinterpret_cast<float4*>(row + c0 + k) = make_float4(e[k], e[k + 1], e[k + 2], e[k + 3]);
  }
  const bool inside = c0 + kPer <= f_true;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (inside || c0 + k < f_true) {
      lo = fminf(lo, e[k]);
      hi = fmaxf(hi, e[k]);
    }
  }
}

// Copies the first n columns of row r of x [rows, f] into `row` as f32:
// where the row's address allows, 16-byte loads up to the chunk that holds
// column n - 1 while it lies in the row (up to n rounded up to 8 columns:
// a partial chunk costs no second round trip to memory, scalar loads
// would), then scalar ones; returns this lane's min and max over columns <
// f_true <= n (reduced over the warp by the caller).
template <bool kBf16>
__device__ __forceinline__ void stage_row(const void* __restrict__ x, int64_t r, int f, int n,
                                          int f_true, float* __restrict__ row, int lane,
                                          float& lo, float& hi) {
  constexpr int kEs = kBf16 ? 2 : 4;
  constexpr int kPer = 16 / kEs;  // elements a 16-byte load
  const char* base = static_cast<const char*>(x) + r * f * kEs;
  const int nvec =
      (reinterpret_cast<uintptr_t>(base) & 15) == 0 ? min((n + kPer - 1) / kPer, f / kPer) : 0;
  for (int v = lane; v < nvec; v += 32) {
    put_chunk<kBf16>(__ldg(reinterpret_cast<const uint4*>(base) + v), v, f_true, row, lo, hi);
  }
  for (int c = nvec * kPer + lane; c < n; c += 32) {
    const float e = load<kBf16>(x, static_cast<size_t>(r) * f + c);
    row[c] = e;
    if (c < f_true) {
      lo = fminf(lo, e);
      hi = fmaxf(hi, e);
    }
  }
}

// Stores 4 neighbouring columns c0.. of an output row: one 16-byte store
// (kVec: f_pad is a multiple of 4, so rows start on 16 bytes) or scalar
// stores up to f_pad; kAdd adds them instead (atomics).
template <bool kVec, bool kAdd>
__device__ __forceinline__ void put4(float* __restrict__ orow, int c0, int f_pad,
                                     const float (&v)[4]) {
  if constexpr (kVec) {
    const float4 x = make_float4(v[0], v[1], v[2], v[3]);
    if constexpr (kAdd) {
      atomicAdd(reinterpret_cast<float4*>(orow + c0), x);
    } else {
      *reinterpret_cast<float4*>(orow + c0) = x;
    }
  } else {
    for (int e = 0; e < 4 && c0 + e < f_pad; ++e) {
      if constexpr (kAdd) {
        atomicAdd(orow + c0 + e, v[e]);
      } else {
        orow[c0 + e] = v[e];
      }
    }
  }
}

}  // namespace adaqp
