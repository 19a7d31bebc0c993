// The compact path's row-gather probe for NVIDIA Hopper (sm_90a).
//
// gather_rows replaces the capability probe `kern` of
// ops/spmm_compact.py::dynamic_gather_supported: out[r, c] = x[idx[r, c], c]
// for f32 x and int32 idx of one shape [R, C] (take_along_axis along rows),
// one thread per element, bound by its 12 bytes per element. The TPU
// kernel of spmm_impl=compact gathers each item's occupied window rows with
// one such take_along_axis, whose Mosaic gather stays inside one vreg, which
// retired the kernel there; on Hopper a row gather is an indexed load, and
// the compact layout runs the window-stationary kernel of spmm_strip.cu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int rows, int cols) {
  const size_t n = static_cast<size_t>(rows) * cols;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t c = e % cols;
    out[e] = x[static_cast<size_t>(idx[e]) * cols + c];
  }
}

}  // namespace

// out[r, c] = x[idx[r, c], c] for f32 x, int32 idx and out of shape [rows,
// cols], every idx in [0, rows). Launches on `stream` of CUDA device
// `device` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
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
