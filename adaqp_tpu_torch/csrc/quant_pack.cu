// Quantized-wire kernels for NVIDIA Hopper (sm_90a): quant_pack and
// unpack_dequant.
//
// quant_pack replaces the JAX package's TPU kernel
// ops/quant_pallas.py::_quant_pack_kernel (quantize_pack_rows_tpu). Per row
// r of x [n, f] (f32 or bf16):
//   rmin, rmax over columns < f_true;
//   scale = (2^bits - 1) / max(rmax - rmin, 1e-10);
//   q[c] = clip(floor((x[c] - rmin) * scale + u(key, r, c)), 0, 2^bits - 1);
//   word j (j < wpr) = OR over t < 32/bits of q[t * wpr + j] << (t * bits),
//   with code 0 for columns >= f;
// and it writes scale[r] and rmin[r] in f32.
//
// unpack_dequant replaces ops/quant_pallas.py::_unpack_dequant_kernel
// (unpack_dequantize_rows_tpu): out[r, c] = q[c] / scale[r] + rmin[r] for
// c < f_true, 0 for f_true <= c < f_pad.
//
// The uniforms: counter_hash.cuh (u of element (r, c) is a pure function of
// the launch key and (r, c)); ops/quant_cuda.py::uniforms draws the same
// numbers in PyTorch, so the plain version draws the same codes.
//
// Rounding. Every step rounds once, as the plain version's separate
// PyTorch ops do: __fsub_rn, __fmul_rn, __fadd_rn (no FMA contraction,
// which would move floor() across an integer now and then) and IEEE
// divisions (__fdiv_rn; the build uses no fast-math flag).
//
// What bounds them. Both are a pass over memory with a few operations per
// element: quant_pack reads n * f * (2 or 4) bytes and writes n * wpr * 4 +
// 8n; unpack_dequant reads n * wpr * 4 + 8n and writes n * f_pad * 4. At the
// main path's shapes (n ~ 25,700 lanes, f = 640) the least time is tens of
// microseconds at 3.35 TB/s; the hash's two dozen integer operations per
// element stay far below the card's rate.
//
// The design, simple first. quant_pack: one warp per row; the lanes stride
// over the first f_true columns for min and max, reduce with shuffles, and
// then each lane builds whole words (j = lane, lane + 32, ...), reading the
// row again from L1/L2; neighbouring lanes read neighbouring columns in
// every slot t, and write neighbouring words. unpack_dequant: one thread
// per output element over a grid-stride loop; neighbouring threads read
// neighbouring words of a slot and write neighbouring floats.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

using adaqp::load;
using adaqp::uniform;

constexpr int kWarps = 8;  // rows (warps) per block of quant_pack

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
quant_pack_kernel(const void* __restrict__ x, int n, int f, int f_true, int bits,
                  int wpr, uint32_t key, uint32_t* __restrict__ words,
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
  const int m = 32 / bits;
  for (int j = lane; j < wpr; j += 32) {
    uint32_t w = 0;
    for (int t = 0; t < m; ++t) {
      const int c = t * wpr + j;
      if (c < f) {
        const float y = __fmul_rn(__fsub_rn(load<kBf16>(x, base + c), lo), s);
        float q = floorf(__fadd_rn(y, uniform(key, row, c)));
        q = fminf(fmaxf(q, 0.f), qmax);
        w |= static_cast<uint32_t>(q) << (t * bits);
      }
    }
    words[static_cast<size_t>(row) * wpr + j] = w;
  }
  if (lane == 0) {
    scale_out[row] = s;
    rmin_out[row] = lo;
  }
}

__global__ void unpack_dequant_kernel(const uint32_t* __restrict__ words,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ rmin, int n, int bits,
                                      int f_true, int wpr, int f_pad,
                                      float* __restrict__ out) {
  const size_t total = static_cast<size_t>(n) * f_pad;
  const uint32_t mask = (1u << bits) - 1u;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / f_pad;
    const int c = static_cast<int>(i - row * f_pad);
    float v = 0.f;
    if (c < f_true) {
      const int t = c / wpr;
      const int j = c - t * wpr;
      const uint32_t q = (words[row * wpr + j] >> (t * bits)) & mask;
      v = __fadd_rn(__fdiv_rn(__uint2float_rn(q), scale[row]), rmin[row]);
    }
    out[i] = v;
  }
}

}  // namespace

// x [n, f] f32 (is_bf16 = 0) or bf16, row-major; words int32 [n, wpr];
// scale, rmin f32 [n]. f_true <= f columns enter the range; bits in {2, 4,
// 8}; wpr = f_wire * bits / 32. Launches on `stream` of CUDA device `device`
// and returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_quant_pack(const void* x, int is_bf16, int n, int f, int f_true,
                                int bits, int wpr, uint32_t key, void* words,
                                void* scale, void* rmin, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const dim3 grid((n + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<uint32_t*>(words);
  auto* sc = static_cast<float*>(scale);
  auto* rm = static_cast<float*>(rmin);
  if (is_bf16) {
    quant_pack_kernel<true><<<grid, block, 0, s>>>(x, n, f, f_true, bits, wpr, key, w, sc, rm);
  } else {
    quant_pack_kernel<false><<<grid, block, 0, s>>>(x, n, f, f_true, bits, wpr, key, w, sc, rm);
  }
  return static_cast<int>(cudaGetLastError());
}

// words int32 [n, wpr]; scale, rmin f32 [n]; out f32 [n, f_pad], written in
// full. Same launch and return conventions as adaqp_quant_pack.
extern "C" int adaqp_unpack_dequant(const void* words, const void* scale, const void* rmin,
                                    int n, int bits, int f_true, int wpr, int f_pad,
                                    void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || f_pad <= 0) return 0;
  const size_t total = static_cast<size_t>(n) * f_pad;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  unpack_dequant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scale),
      static_cast<const float*>(rmin), n, bits, f_true, wpr, f_pad,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
