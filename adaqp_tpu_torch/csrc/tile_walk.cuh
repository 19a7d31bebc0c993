// The bitmask row walk shared by the block and compact SpMM kernels
// (spmm_block.cu, spmm_compact.cu) on NVIDIA Hopper (sm_90a).
//
// A tile row is 128 16-bit halfwords: column v of the tile (a "virtual"
// column for the compact kernel's gathered subtiles) lives at halfword
// v % 128, bit v / 128, so bit plane b holds columns [128 b, 128 (b + 1)).
// One warp walks one row: lane l holds halfwords l, l+32, l+64, l+96; planes
// empty across the warp are skipped; for each plane the warp ballots the set
// columns, which come out in ascending v, and for each one every lane adds
// its 16-byte slice of the source row (8 bf16 or 4 f32 values; neighbouring
// lanes on neighbouring columns) into f32 registers, with up to kUnroll
// source rows loaded before they are added so that loads overlap. Each
// output element is summed by one thread in a fixed order, so results do not
// change from run to run, and a speed-up of the walk serves every kernel
// that includes it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace tile_walk {

using vec16::add_vec;
using vec16::Elem;
using vec16::pack_vec;

constexpr int kBD = 256;     // destination rows per tile
constexpr int kWords = 128;  // 16-bit mask halfwords per tile row
constexpr int kUnroll = 4;   // source-row loads in flight per warp

// The lane's four halfwords of tile row `mrow`; returns the bit planes that
// are set anywhere in the row (the same value on every lane).
__device__ __forceinline__ uint32_t row_words(const uint16_t* __restrict__ mrow, int lane,
                                              uint32_t (&w)[4]) {
  w[0] = mrow[lane];
  w[1] = mrow[lane + 32];
  w[2] = mrow[lane + 64];
  w[3] = mrow[lane + 96];
  return __reduce_or_sync(0xffffffffu, w[0] | w[1] | w[2] | w[3]);
}

// acc += the source rows of the set columns of `planes` (warp-uniform) in
// one tile row held as `w`. Column v's source row starts at
// hcol + row_of(v) * row_bytes; `active` lanes (those inside F) load and add.
template <bool kBf16, class RowOf>
__device__ __forceinline__ void walk_planes(float (&acc)[Elem<kBf16>::kVec],
                                            const uint32_t (&w)[4], uint32_t planes,
                                            const uint8_t* __restrict__ hcol,
                                            size_t row_bytes, bool active, RowOf row_of) {
  while (planes) {  // warp-uniform
    const int b = __ffs(planes) - 1;
    planes &= planes - 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bal = __ballot_sync(0xffffffffu, (w[q] >> b) & 1u);
      const int v0 = b * kWords + q * 32;
      while (bal) {  // warp-uniform
        uint4 v[kUnroll];
        int cnt = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (bal) {
            const int j = __ffs(bal) - 1;
            bal &= bal - 1;
            if (active) {
              const size_t row = static_cast<size_t>(row_of(v0 + j));
              v[u] = *reinterpret_cast<const uint4*>(hcol + row * row_bytes);
            }
            cnt = u + 1;
          }
        }
        if (active) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (u < cnt) add_vec<kBf16>(acc, v[u]);
          }
        }
      }
    }
  }
}

// out = A^T h over tiles listed per destination block (the strip and block
// layouts): tiles blk_ptr[b] .. blk_ptr[b + 1] belong to block b, tile t's
// column j reads h row tile_src[t] + j. Grid (destination block, 32-lane
// column chunk), 8 warps, one warp per destination row (every 8th row of
// the block); a block with no tile writes zeros.
constexpr int kWarps = 8;

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
tile_range_kernel(const uint16_t* __restrict__ masks, const int32_t* __restrict__ tile_src,
                  const int32_t* __restrict__ blk_ptr, const uint8_t* __restrict__ h,
                  uint8_t* __restrict__ out, int f) {
  constexpr int kVec = Elem<kBf16>::kVec;
  constexpr int kBytes = Elem<kBf16>::kBytes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blk = blockIdx.x;
  const int col = (blockIdx.y * 32 + lane) * kVec;
  const bool active = col < f;  // the last chunk may be part-filled
  const size_t row_bytes = static_cast<size_t>(f) * kBytes;
  const uint8_t* hcol = h + static_cast<size_t>(col) * kBytes;
  const int t0 = blk_ptr[blk];
  const int t1 = blk_ptr[blk + 1];

  for (int r = warp; r < kBD; r += kWarps) {
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    for (int t = t0; t < t1; ++t) {
      uint32_t w[4];
      const uint32_t planes =
          row_words(masks + (static_cast<size_t>(t) * kBD + r) * kWords, lane, w);
      const int src = tile_src[t];
      walk_planes<kBf16>(acc, w, planes, hcol, row_bytes, active,
                         [src](int v) { return src + v; });
    }
    if (active) {
      uint8_t* dst = out + (static_cast<size_t>(blk) * kBD + r) * row_bytes +
                     static_cast<size_t>(col) * kBytes;
      *reinterpret_cast<uint4*>(dst) = pack_vec<kBf16>(acc);
    }
  }
}

// Launches tile_range_kernel on `stream` of `device`; returns
// cudaGetLastError() (0 on success) and does not synchronise.
inline int launch_tile_range(const void* masks, const void* tile_src, const void* blk_ptr,
                             const void* h, void* out, int n_blocks, int f, int is_bf16,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks <= 0 || f <= 0) return 0;
  const int cols = 32 * (is_bf16 ? Elem<true>::kVec : Elem<false>::kVec);
  const dim3 grid(n_blocks, (f + cols - 1) / cols);
  const dim3 block(kWarps * 32);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint16_t*>(masks);
  const auto* ts = static_cast<const int32_t*>(tile_src);
  const auto* bp = static_cast<const int32_t*>(blk_ptr);
  const auto* hp = static_cast<const uint8_t*>(h);
  auto* op = static_cast<uint8_t*>(out);
  if (is_bf16) {
    tile_range_kernel<true><<<grid, block, 0, s>>>(m, ts, bp, hp, op, f);
  } else {
    tile_range_kernel<false><<<grid, block, 0, s>>>(m, ts, bp, hp, op, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile_walk
