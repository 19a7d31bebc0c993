// Compact-column SpMM and its row-gather probe for NVIDIA Hopper (sm_90a).
//
// compact_spmm replaces the JAX package's TPU kernel
// ops/spmm_compact.py::_compact_kernel (launched by _run_compact_pallas),
// the v2 tile kernel of spmm_impl=compact: out = A^T h over work items
// sorted by (destination strip of 2048 rows, source window, kind). Item i
// of strip st = strip_id[i] reads the 2048-row window from src_start[i]:
//
//   kind 0 (a full bitmask tile): for every set bit v of row r of masks[i]
//   add h[src_start[i] + v] to out row st * 2048 + dst_off[i, 0] + r;
//   kind 1 (a group of 8 compact subtiles): subtile s < nsub[i] owns the
//   virtual columns [256 s, 256 (s + 1)), which are bit planes 2s and 2s+1
//   of every halfword; for every set bit v of row r there add
//   h[src_start[i] + col_idx[i, v]] to out row st * 2048 + dst_off[i, s] + r.
//
// Virtual column v is halfword v % 128, bit v / 128, as in every tile
// layout. Subtiles of one group may share a target (a region with more
// than 256 occupied columns); their contributions add. Sums are taken in
// f32 and written in h's dtype; a strip whose items are all inert is
// written as zeros. The ELL tail is added outside, in PyTorch.
//
// What bounds it. The larger of (masks + col_idx of kind-1 items + h rows
// read + out bytes) / 3.35 TB/s and (2 * edges * F) / 989 TFLOP/s (the
// card's bf16 rate, f32 accumulation). The TPU kernel gathers each group's
// occupied window rows with one square take_along_axis and multiplies 8
// narrow 256 x 256 tiles on the matrix unit; its Mosaic gather stays inside
// one vreg, which retired the kernel there. On Hopper a row gather is one
// indexed load, so this kernel walks the set bits (tile_walk.cuh, the walk
// of the strip and block kernels) and reads column v's source row through
// the item's col_idx staged in shared memory (8 KB).
//
// The design, simple first. A thread block owns 64 destination rows of one
// strip and a 32-lane column chunk; its 8 warps take every 8th row. It
// walks its strip's item range (item_ptr, built on the host from strip_id
// before any shard padding) and skips every item with no subtile aimed at
// its destination block; for a kind-1 item it first stages the item's
// col_idx in shared memory. Because items of one strip target different
// rows, a row's f32 sums live in shared memory (64 rows x the chunk) between
// items and are loaded into registers only for a row that has set bits in
// the item. Each output element is summed by one thread in a fixed order
// (item, plane, column), with no atomics, so results do not change from run
// to run.
//
// gather_rows replaces the capability probe `kern` of
// ops/spmm_compact.py::dynamic_gather_supported: out[r, c] = x[idx[r, c], c]
// for f32 x and int32 idx of one shape [R, C] (take_along_axis along rows),
// one thread per element, bound by its 12 bytes per element.
#include "tile_walk.cuh"

namespace {

using tile_walk::Elem;
using tile_walk::kBD;
using tile_walk::kWarps;
using tile_walk::kWords;

constexpr int kRows = 64;      // destination rows per thread block
constexpr int kGroup = 8;      // subtile slots of a kind-1 item
constexpr int kWindow = 2048;  // source rows of a window (virtual columns of an item)
constexpr int kStrip = 2048;   // destination rows of a strip

template <bool kBf16>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kRows) * 32 * Elem<kBf16>::kVec * sizeof(float) +
         kWindow * sizeof(int32_t);
}

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
compact_spmm_kernel(const uint16_t* __restrict__ masks, const int32_t* __restrict__ col_idx,
                    const int32_t* __restrict__ src_start, const int32_t* __restrict__ kind,
                    const int32_t* __restrict__ dst_off, const int32_t* __restrict__ nsub,
                    const int32_t* __restrict__ item_ptr, const uint8_t* __restrict__ h,
                    uint8_t* __restrict__ out, int f) {
  constexpr int kVec = Elem<kBf16>::kVec;
  constexpr int kBytes = Elem<kBf16>::kBytes;
  constexpr int kChunk = 32 * kVec;  // columns of this thread block
  extern __shared__ float4 smem[];
  float* acc_s = reinterpret_cast<float*>(smem);                         // [kRows][kChunk]
  int32_t* cidx = reinterpret_cast<int32_t*>(acc_s + kRows * kChunk);  // [kWindow]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;  // first output row
  const int strip = row0 / kStrip;
  const int blk_off = (row0 % kStrip) & ~(kBD - 1);  // its destination block in the strip
  const int tile_row0 = row0 % kBD;                  // its first row within that block
  const int col = (blockIdx.y * 32 + lane) * kVec;
  const bool active = col < f;  // the last chunk may be part-filled
  const size_t row_bytes = static_cast<size_t>(f) * kBytes;
  const uint8_t* hcol = h + static_cast<size_t>(col) * kBytes;

  for (int i = threadIdx.x; i < kRows * kChunk; i += blockDim.x) acc_s[i] = 0.f;
  __syncthreads();

  const int i1 = item_ptr[strip + 1];
  for (int it = item_ptr[strip]; it < i1; ++it) {
    // block-uniform: which bit planes of this item land on this block
    const int32_t* doff = dst_off + static_cast<size_t>(it) * kGroup;
    const int k = kind[it];
    uint32_t plane_mask = 0;
    if (k == 0) {
      if (doff[0] == blk_off) plane_mask = 0xffffu;
    } else {
      const int ns = nsub[it];
      for (int s = 0; s < ns; ++s) {
        if (doff[s] == blk_off) plane_mask |= 3u << (2 * s);
      }
    }
    if (!plane_mask) continue;
    const int src = src_start[it];
    if (k == 1) {
      __syncthreads();  // every warp is done with the previous item's columns
      const int4* g = reinterpret_cast<const int4*>(col_idx + static_cast<size_t>(it) * kWindow);
      for (int i = threadIdx.x; i < kWindow / 4; i += blockDim.x) {
        reinterpret_cast<int4*>(cidx)[i] = g[i];
      }
      __syncthreads();
    }
    const uint16_t* m = masks + (static_cast<size_t>(it) * kBD + tile_row0) * kWords;
    for (int r = warp; r < kRows; r += kWarps) {
      uint32_t w[4];
      const uint32_t planes =
          tile_walk::row_words(m + static_cast<size_t>(r) * kWords, lane, w) & plane_mask;
      if (!planes) continue;  // warp-uniform
      float4* a = reinterpret_cast<float4*>(acc_s + r * kChunk + lane * kVec);
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i) {
        const float4 x = a[i];
        acc[4 * i] = x.x;
        acc[4 * i + 1] = x.y;
        acc[4 * i + 2] = x.z;
        acc[4 * i + 3] = x.w;
      }
      if (k == 0) {
        tile_walk::walk_planes<kBf16>(acc, w, planes, hcol, row_bytes, active,
                                      [src](int v) { return src + v; });
      } else {
        tile_walk::walk_planes<kBf16>(acc, w, planes, hcol, row_bytes, active,
                                      [src, cidx](int v) { return src + cidx[v]; });
      }
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i) {
        a[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
  }

  // each warp writes the rows it summed (its own lanes' shared slots)
  if (!active) return;
  for (int r = warp; r < kRows; r += kWarps) {
    const float4* a = reinterpret_cast<const float4*>(acc_s + r * kChunk + lane * kVec);
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      const float4 x = a[i];
      acc[4 * i] = x.x;
      acc[4 * i + 1] = x.y;
      acc[4 * i + 2] = x.z;
      acc[4 * i + 3] = x.w;
    }
    uint8_t* dst = out + (static_cast<size_t>(row0) + r) * row_bytes +
                   static_cast<size_t>(col) * kBytes;
    *reinterpret_cast<uint4*>(dst) = tile_walk::pack_vec<kBf16>(acc);
  }
}

__global__ void gather_rows_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int rows, int cols) {
  const size_t n = static_cast<size_t>(rows) * cols;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t c = e % cols;
    out[e] = x[static_cast<size_t>(idx[e]) * cols + c];
  }
}

template <bool kBf16>
int launch_compact(const void* masks, const void* col_idx, const void* src_start,
                   const void* kind, const void* dst_off, const void* nsub,
                   const void* item_ptr, const void* h, void* out, int n_pad, int f,
                   cudaStream_t s) {
  constexpr size_t kSmem = smem_bytes<kBf16>();
  cudaError_t err = cudaFuncSetAttribute(compact_spmm_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = 32 * Elem<kBf16>::kVec;
  const dim3 grid(n_pad / kRows, (f + cols - 1) / cols);
  compact_spmm_kernel<kBf16><<<grid, kWarps * 32, kSmem, s>>>(
      static_cast<const uint16_t*>(masks), static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(src_start), static_cast<const int32_t*>(kind),
      static_cast<const int32_t*>(dst_off), static_cast<const int32_t*>(nsub),
      static_cast<const int32_t*>(item_ptr), static_cast<const uint8_t*>(h),
      static_cast<uint8_t*>(out), f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[n_pad, f] = A^T h over compact items. masks int16 [T, 256, 128];
// col_idx int32 [T, 2048]; src_start, kind, nsub int32 [T]; dst_off int32
// [T, 8]; item_ptr int32 [n_pad / 2048 + 1] (strip st's items are
// item_ptr[st] .. item_ptr[st + 1]); h and out bf16 (is_bf16 = 1) or f32,
// row-major, 16-byte aligned, f a multiple of 8 (bf16) or 4 (f32); n_pad a
// multiple of 2048. Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_compact_spmm(const void* masks, const void* col_idx, const void* src_start,
                                  const void* kind, const void* dst_off, const void* nsub,
                                  const void* item_ptr, const void* h, void* out, int n_pad,
                                  int f, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pad <= 0 || f <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_compact<true>(masks, col_idx, src_start, kind, dst_off, nsub, item_ptr, h,
                                out, n_pad, f, s);
  }
  return launch_compact<false>(masks, col_idx, src_start, kind, dst_off, nsub, item_ptr, h, out,
                               n_pad, f, s);
}

// out[r, c] = x[idx[r, c], c] for f32 x, int32 idx and out of shape [rows,
// cols], every idx in [0, rows). Same launch contract as above.
extern "C" int adaqp_gather_rows(const void* x, const void* idx, void* out, int rows, int cols,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(rows) * cols;
  if (n == 0) return 0;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gather_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx), static_cast<float*>(out),
      rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
