// The compact path's row-gather probe for NVIDIA Hopper (sm_90a).
//
// gather_rows replaces the capability probe `kern` of
// ops/spmm_compact.py::dynamic_gather_supported: out[r, c] = x[idx[r, c], c]
// for f32 x and int32 idx of one shape [R, C] (take_along_axis along rows).
// The TPU kernel of spmm_impl=compact gathers each item's occupied window
// rows with one such take_along_axis, whose Mosaic gather stays inside one
// vreg, which retired the kernel there; on Hopper a row gather is an
// indexed load, and the compact layout runs the window-stationary kernel
// of spmm_strip.cu.
//
// What bounds it: bytes, 12 an element (idx, the gathered value, out) at
// 3.35 TB/s, 0.94 us at the probe's [2048, 128]. What it waits on there is
// the launch, an idx load, then the gathers that depend on it (each a
// 32-byte sector of L2 for 4 bytes: on an H100, random idx took markedly
// longer than rows in order), then a store. So every thread issues all
// its loads before it uses any, and there are many threads:
// - A thread owns `width` consecutive columns of a row (4, or 1 on the
//   scalar path) and `kLoads / width` rows blockDim.y apart: one 16-byte
//   idx load, 4 independent read-only gathers and one 16-byte store on the
//   4-wide path. Columns run along threadIdx.x (a warp reads 32
//   consecutive column groups of a row: the idx loads and out stores
//   coalesce), rows along threadIdx.y: no division or modulo an element.
// - The grid is the column groups along x and at most one wave of 128-
//   thread blocks (16 an SM) along y; a block strides over rows past it.
//   On an H100 at [2048, 128], 4 gathers a thread over more blocks ran a
//   little faster than 8, 16 or 32 over fewer, and staging a column slab
//   of x in each block's shared memory (read once, gathered there) ran
//   slower than this at every index pattern tried.
// - The 4-wide path needs C a multiple of 4 and idx and out 16-byte
//   aligned; anything else takes the scalar path.
// The plan (width, block and grid) is the wrapper's (ops/spmm_compact.py
// ::gather_plan); this launcher checks it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLoads = 4;  // gathers a thread has in flight a pass

template <int W>
__device__ __forceinline__ void load_idx(int32_t (&v)[W], const int32_t* p) {
  if constexpr (W == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int rows, int cols) {
  constexpr int U = kLoads / W;  // rows a thread a pass
  const int group = blockIdx.x * blockDim.x + threadIdx.x;
  if (group >= cols / W) return;
  const int64_t c = static_cast<int64_t>(group) * W;
  const int64_t pass = static_cast<int64_t>(gridDim.y) * blockDim.y * U;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * blockDim.y * U + threadIdx.y; r0 < rows;
       r0 += pass) {
    int32_t iv[U][W];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t r = r0 + k * static_cast<int64_t>(blockDim.y);
      if (r < rows) load_idx<W>(iv[k], idx + r * cols + c);
    }
    float v[U][W];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t r = r0 + k * static_cast<int64_t>(blockDim.y);
      if (r < rows) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          v[k][e] = __ldg(x + static_cast<int64_t>(iv[k][e]) * cols + c + e);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t r = r0 + k * static_cast<int64_t>(blockDim.y);
      if (r < rows) store_row<W>(out + r * cols + c, v[k]);
    }
  }
}

}  // namespace

// out[r, c] = x[idx[r, c], c] for f32 x, int32 idx and out of shape [rows,
// cols], every idx in [0, rows), on the plan of ops/spmm_compact.py
// ::gather_plan: `width` 4 (cols a multiple of 4, idx and out 16-byte
// aligned) or 1, blocks of bx x by = 128 threads, a grid of gx x gy.
// Launches on `stream` of CUDA device `device` (made current if it is not)
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a plan it does not take; an empty shape launches nothing. It does
// not synchronise.
extern "C" int adaqp_gather_rows(const void* x, const void* idx, void* out, int rows, int cols,
                                 int width, int bx, int by, int gx, int gy, int device,
                                 void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0) return 0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out);
  const bool aligned = at % 16 == 0;
  if ((width != 1 && width != 4) || cols % width || (width == 4 && !aligned) || bx < 1 ||
      by < 1 || bx * by != kThreads || gx < 1 || gy < 1 || gy > 65535 ||
      static_cast<int64_t>(gx) * bx < cols / width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(gx, gy), block(bx, by);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* ip = static_cast<const int32_t*>(idx);
  auto* op = static_cast<float*>(out);
  if (width == 4) {
    gather_rows_kernel<4><<<grid, block, 0, st>>>(xp, ip, op, rows, cols);
  } else {
    gather_rows_kernel<1><<<grid, block, 0, st>>>(xp, ip, op, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
