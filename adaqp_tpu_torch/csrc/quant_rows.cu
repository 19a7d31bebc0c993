// Padded-wire quantization kernels for NVIDIA Hopper (sm_90a): quant_rows
// and dequant_rows.
//
// quant_rows replaces the JAX package's TPU kernel
// ops/quant_pallas.py::_quant_kernel (quantize_rows_tpu). Per row r of
// x [n, f] (f32 or bf16):
//   rmin, rmax over columns < f_true;
//   scale = (2^bits - 1) / max(rmax - rmin, 1e-10);
//   q[r, c] = clip(floor((x[r, c] - rmin) * scale + u(key, r, c)), 0, 2^bits - 1)
//   for EVERY column c < f (layout padding included, as the TPU kernel
//   codes it: up to three such columns travel when the wire width
//   pad_features(f_true) exceeds f_true);
// and it writes u8 q [n, f], f32 scale [n] and f32 rmin [n]. The TPU
// kernel pads n to its 256-row blocks; here the ragged edge is masked (one
// warp per row, rows past n return), so the wrapper pads nothing.
//
// dequant_rows replaces ops/quant_pallas.py::_dequant_kernel
// (dequantize_rows_tpu): out[r, c] = q[r, c] / scale[r] + rmin[r], u8
// q [n, f] -> f32 [n, f].
//
// The uniforms are counter_hash.cuh's, the ones quant_pack draws;
// ops/quant_cuda.py::uniforms computes them in PyTorch, so the plain version
// quantize_rows(x, bits, uniforms(key, n, f), f_true) gives the same codes.
// Every step rounds once (__fsub_rn, __fmul_rn, __fadd_rn: no FMA
// contraction; __fdiv_rn: IEEE division), as the plain version's separate
// PyTorch ops do, so both kernels agree with it bit for bit.
//
// What bounds them. Each is one pass over memory with a few operations per
// element. quant_rows reads n * f * (2 or 4) bytes and writes n * f + 8n;
// dequant_rows reads n * f + 8n and writes 4 * n * f. At the main path's
// layer-0 shapes (n = K * cap ~ 26,000 lanes, f = 640) that is some 60 MB
// in all, tens of microseconds at 3.35 TB/s; the hash's two dozen integer
// operations per element stay far below the card's integer rate.
//
// The design, simple first. quant_rows: one warp per row; the lanes stride
// over the first f_true columns for min and max, reduce with shuffles, and
// then stride over all f columns again (from L1/L2), each lane writing one
// code byte per column, neighbouring lanes on neighbouring bytes.
// dequant_rows: one thread per element in a grid-stride loop, neighbouring
// threads on neighbouring bytes and floats. Fusing the lane gather and the
// column packing (pack_rows) into quant_rows, and vector loads and stores,
// are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

using adaqp::load;
using adaqp::uniform;

constexpr int kWarps = 8;  // rows (warps) per block of quant_rows

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
quant_rows_kernel(const void* __restrict__ x, int n, int f, int f_true, int bits,
                  uint32_t key, uint8_t* __restrict__ q,
                  float* __restrict__ scale_out, float* __restrict__ rmin_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform
  const size_t base = static_cast<size_t>(row) * f;
  float lo = INFINITY, hi = -INFINITY;
  for (int c = lane; c < f_true; c += 32) {
    const float v = load<kBf16>(x, base + c);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const float qmax = static_cast<float>((1 << bits) - 1);
  const float s = __fdiv_rn(qmax, fmaxf(__fsub_rn(hi, lo), 1e-10f));
  for (int c = lane; c < f; c += 32) {
    const float y = __fmul_rn(__fsub_rn(load<kBf16>(x, base + c), lo), s);
    const float v = fminf(fmaxf(floorf(__fadd_rn(y, uniform(key, row, c))), 0.f), qmax);
    q[base + c] = static_cast<uint8_t>(v);
  }
  if (lane == 0) {
    scale_out[row] = s;
    rmin_out[row] = lo;
  }
}

__global__ void dequant_rows_kernel(const uint8_t* __restrict__ q,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ rmin, int n, int f,
                                    float* __restrict__ out) {
  const size_t total = static_cast<size_t>(n) * f;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / f;
    out[i] = __fadd_rn(__fdiv_rn(__uint2float_rn(q[i]), scale[row]), rmin[row]);
  }
}

}  // namespace

// x [n, f] f32 (is_bf16 = 0) or bf16, row-major; q u8 [n, f]; scale, rmin
// f32 [n]. Columns < f_true (<= f) enter the range; bits in {2, 4, 8}.
// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_quant_rows(const void* x, int is_bf16, int n, int f, int f_true,
                                int bits, uint32_t key, void* q, void* scale, void* rmin,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const dim3 grid((n + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qo = static_cast<uint8_t*>(q);
  auto* sc = static_cast<float*>(scale);
  auto* rm = static_cast<float*>(rmin);
  if (is_bf16) {
    quant_rows_kernel<true><<<grid, block, 0, s>>>(x, n, f, f_true, bits, key, qo, sc, rm);
  } else {
    quant_rows_kernel<false><<<grid, block, 0, s>>>(x, n, f, f_true, bits, key, qo, sc, rm);
  }
  return static_cast<int>(cudaGetLastError());
}

// q u8 [n, f]; scale, rmin f32 [n]; out f32 [n, f], written in full. Same
// launch and return conventions as adaqp_quant_rows.
extern "C" int adaqp_dequant_rows(const void* q, const void* scale, const void* rmin,
                                  int n, int f, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || f <= 0) return 0;
  const size_t total = static_cast<size_t>(n) * f;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  dequant_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(rmin), n, f, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_quant_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
