// Strip bitmask SpMM for NVIDIA Hopper (sm_90a): out = A^T h over 0/1 tiles.
//
// Replaces the JAX package's TPU kernel ops/spmm_strip.py::_strip_kernel
// (launched by _run_strip_pallas). It computes what that kernel computes,
// not its grid:
//
//   for each destination row r of block b = r / 256, the sum over the
//   block's dense tiles t of h[tile_src[t] + j] for every set bit j of row
//   r % 256 of masks[t]; column j of a tile is halfword j % 128, bit
//   j / 128. The sum is taken in f32 and written in h's dtype. A block with
//   no tiles is written as zeros (the TPU kernel's flush-only path).
//
// Masks are in destination-block-major order (the layout sorts tiles by
// dst block, then source window), so blk_ptr[b] .. blk_ptr[b + 1] is block
// b's tile range. The ELL straggler edges are added outside, in PyTorch.
//
// What bounds it. The TPU kernel expands each tile into a dense 256 x 2048
// 0/1 matrix for the matrix unit. At the density of the benchmark graph
// (under 1% of a tile's bits are set) that dense product is over a hundred
// times the useful work, so this kernel walks the set bits instead: the
// work is one F-wide row add per edge, and the least time is the larger of
// (mask + h + out bytes) / 3.35 TB/s and (2 * edges * F) / 989 TFLOP/s (the
// card's bf16 rate with f32 accumulation); at the smoke and benchmark
// shapes the bytes bound it, most of them the masks.
//
// The design, simple first: a grid of (destination block, 32-lane column
// chunk), one warp per destination row (8 warps take every 8th row of the
// block). Per tile a warp reads its row's 128 halfwords (lane l holds
// halfwords l, l+32, l+64, l+96), skips bit planes empty across the warp,
// and for each plane ballots the set columns, which come out in ascending
// j. For each set column every lane adds its 16-byte slice of h[src] (8
// bf16 or 4 f32 values; neighbouring lanes on neighbouring columns) into
// f32 registers, with up to four source rows loaded before they are added
// so that loads overlap. No shared memory and no atomics: each output
// element is summed by one thread in a fixed order (tile, then j), so the
// result does not change from run to run. h's windows are re-read from L2
// once per row that uses them; keeping windows in shared memory (TMA) and
// using the tensor cores for dense tiles are the known next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBD = 256;     // destination rows per tile
constexpr int kWords = 128;  // 16-bit mask halfwords per tile row
constexpr int kWarps = 8;    // warps per block
constexpr int kUnroll = 4;   // source-row loads in flight per warp

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

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
strip_spmm_kernel(const uint16_t* __restrict__ masks,
                  const int32_t* __restrict__ tile_src,
                  const int32_t* __restrict__ blk_ptr,
                  const uint8_t* __restrict__ h, uint8_t* __restrict__ out,
                  int f) {
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
      const uint16_t* mrow = masks + (static_cast<size_t>(t) * kBD + r) * kWords;
      const uint32_t w[4] = {mrow[lane], mrow[lane + 32], mrow[lane + 64],
                             mrow[lane + 96]};
      // bit b of halfword q*32 + lane is source column b*128 + q*32 + lane
      uint32_t planes = __reduce_or_sync(0xffffffffu, w[0] | w[1] | w[2] | w[3]);
      const uint8_t* win = hcol + static_cast<size_t>(tile_src[t]) * row_bytes;
      while (planes) {  // warp-uniform
        const int b = __ffs(planes) - 1;
        planes &= planes - 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t bal = __ballot_sync(0xffffffffu, (w[q] >> b) & 1u);
          const uint8_t* base = win + static_cast<size_t>(b * kWords + q * 32) * row_bytes;
          while (bal) {  // warp-uniform
            uint4 v[kUnroll];
            int cnt = 0;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (bal) {
                const int j = __ffs(bal) - 1;
                bal &= bal - 1;
                if (active) {
                  v[u] = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(j) * row_bytes);
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
    if (active) {
      uint8_t* dst = out + (static_cast<size_t>(blk) * kBD + r) * row_bytes +
                     static_cast<size_t>(col) * kBytes;
      *reinterpret_cast<uint4*>(dst) = pack_vec<kBf16>(acc);
    }
  }
}

}  // namespace

// out[n_blocks * 256, f] = A^T h. masks int16 [T, 256, 128]; tile_src int32
// [T] (window start rows); blk_ptr int32 [n_blocks + 1]; h and out bf16
// (is_bf16 = 1) or f32, row-major, 16-byte aligned, f a multiple of 8 (bf16)
// or 4 (f32). Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_strip_spmm(const void* masks, const void* tile_src,
                                const void* blk_ptr, const void* h, void* out,
                                int n_blocks, int f, int is_bf16, int device,
                                void* stream) {
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
    strip_spmm_kernel<true><<<grid, block, 0, s>>>(m, ts, bp, hp, op, f);
  } else {
    strip_spmm_kernel<false><<<grid, block, 0, s>>>(m, ts, bp, hp, op, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
