// transpose_u32 for NVIDIA Hopper (sm_90a): a [R, C] matrix of 32-bit
// words to its [C, R] transpose.
//
// It replaces the TPU kernel `kern` of scripts/probe_r5.py:63 (called at
// :68): o_ref[:] = x_ref[:].T on a grid of 4, each program reading 1,024
// rows of a [4096, 25] u32 array and writing them as the (25, 1,024) block
// of the output at column i * 1,024. The probe asked whether a kernel can
// write the wire's plane-major word stream (one plane of `wpr` words a row
// after another) without lane padding. Here the transpose is general: any
// R and C, the ragged edges masked.
//
// What bounds it: bytes. Each word is read once and written once, 8 bytes
// a word at 3.35 TB/s: 0.111 ms for the wire's [1,856,512, 25] words.
//
// The design: a block of 32 x 8 threads moves one 32 x 32 tile through
// shared memory of 32 x 33 words (the extra column keeps a column read
// off one bank). Reads walk rows of x with consecutive threads on
// consecutive words, writes walk rows of the output the same way, so both
// sides are coalesced; each thread moves four words each way. Row tiles run
// along grid x (up to 2^31 - 1 of them), column tiles along grid y (up to
// 65,535, so C up to 2,097,120).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsA = 8;  // thread rows of a block: 4 words a thread each way

__global__ void __launch_bounds__(kTile * kRowsA)
transpose_u32_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t rows,
                     int cols) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int c0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int k = 0; k < kTile; k += kRowsA) {
    const int64_t r = r0 + ty + k;
    const int c = c0 + tx;
    if (r < rows && c < cols) tile[ty + k][tx] = x[r * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTile; k += kRowsA) {
    const int c = c0 + ty + k;  // a row of the output
    const int64_t r = r0 + tx;  // its column
    if (c < cols && r < rows) out[static_cast<int64_t>(c) * rows + r] = tile[tx][ty + k];
  }
}

}  // namespace

// x [rows, cols] and out [cols, rows] of 32-bit words, contiguous. Launches
// on `stream` of CUDA device `device` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape past the grid's reach; it
// does not synchronise. An empty matrix launches nothing.
extern "C" int adaqp_transpose_u32(const void* x, void* out, long long rows, int cols,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 0 || cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return 0;
  const long long gx = (rows + kTile - 1) / kTile;
  const long long gy = (static_cast<long long>(cols) + kTile - 1) / kTile;
  if (gx > 2147483647LL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(kTile, kRowsA);
  transpose_u32_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
