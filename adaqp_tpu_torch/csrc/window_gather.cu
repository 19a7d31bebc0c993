// window_gather for NVIDIA Hopper (sm_90a): an element gather inside a
// window held in on-chip memory, summed over iterations.
//
// It replaces two TPU kernels of scripts/microbench_gather.py, both
// `kern` bodies over a window held whole in VMEM:
//   :72  (mk_kernel)  out = sum_{k < iters} take_along_axis(x, idx, axis=0)
//        with a full int32 index of x's shape;
//   :130 (mk_sq)      the same along axis 0 or 1, with a full index or a
//        1-D column list [1, x.shape[axis]] broadcast inside the kernel.
// For x [R, C] and output position (r, c) the gathered value is
// x[g, c] (axis 0) or x[r, g] (axis 1), with g = idx[r, c] for a full
// index and g = idx[0, p] for a 1-D one, p being r (axis 0) or c (axis 1).
// The sum is taken in x's dtype, rounded once per iteration: f32 adds, or
// for bf16 an f32 add rounded with __float2bfloat16_rn, which is what
// PyTorch's bf16 add does, so the result equals the plain version's
// torch.gather loop bit for bit.
//
// The design. The TPU held the whole window in VMEM; a [4096, 256] f32
// window (4 MiB) exceeds a block's 227 KB of shared memory. So each block
// stages a slab of `s` whole lines of the gather axis in shared memory --
// s columns of x for axis 0, s rows for axis 1, at most 64 KB so three
// blocks fit an SM -- and computes the outputs of those lines at a range
// of positions along the gather axis: kThreads * kPer = 2,048 outputs a
// block, kPer a thread, with their indices loaded once into registers.
// Every iteration gathers each output's value from the slab through a
// volatile shared-memory load, so the compiler cannot hoist the gather out
// of the iteration loop (the per-iteration slope of the time measures the
// gather), and adds it into the thread's accumulator. A [4096, 256] f32
// window runs as 512 blocks of 4 columns x 512 positions.
//
// What bounds it: bytes for one iteration (x read once, the index read
// once, the output written once), the f32 adds for many: iters * R * C
// adds at the card's f32 rate. The slabs are re-read from L2 by each
// block that shares them (L2 holds the window), and each iteration costs
// one shared-memory gather an output.
//
// The indices must lie in [0, x.shape[axis]); the kernel trusts them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                      // outputs a thread
constexpr int kOutputs = kThreads * kPer;    // outputs a block
constexpr int kSlabBytes = 64 * 1024;        // target shared memory a block
constexpr int kMaxLines = 32;                // lines a slab at most
constexpr int kMaxSmem = 227 * 1024;         // a block's limit on Hopper

// Elements travel as their bits (S): volatile loads of a bf16 struct do
// not compile, and bits convert to f32 exactly.
template <bool kBf16>
struct Elem;
template <>
struct Elem<false> {
  using S = float;
  static __device__ __forceinline__ float to_float(S v) { return v; }
  static __device__ __forceinline__ float add(float acc, float v) { return acc + v; }
  static __device__ __forceinline__ S from_float(float v) { return v; }
};
template <>
struct Elem<true> {
  using S = uint16_t;
  static __device__ __forceinline__ float to_float(S v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  // one rounding to bf16 per iteration, as a bf16 tensor add
  static __device__ __forceinline__ float add(float acc, float v) {
    return __bfloat162float(__float2bfloat16_rn(acc + v));
  }
  static __device__ __forceinline__ S from_float(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// x [rows, cols] row-major. The gather axis has length L (rows for axis 0,
// cols for axis 1); the block owns lines [m0, m0 + s) of the other axis
// and positions [p0, p0 + kOutputs / s) of the gather axis.
template <int kAxis, bool kFull, bool kBf16>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const void* x_, const int32_t* idx, void* out_, int rows, int cols,
                     int lines, int iters) {
  using E = Elem<kBf16>;
  using S = typename E::S;
  extern __shared__ __align__(16) uint8_t smem[];
  S* slab = reinterpret_cast<S*>(smem);
  const S* x = static_cast<const S*>(x_);
  S* out = static_cast<S*>(out_);
  const int L = kAxis == 0 ? rows : cols;
  const int M = kAxis == 0 ? cols : rows;
  const int m0 = blockIdx.x * lines;
  const int sm = min(lines, M - m0);
  const int per = kOutputs / lines;  // positions a block
  const int p0 = blockIdx.y * per;
  const int np = min(per, L - p0);
  // stage lines [m0, m0 + sm): axis 0 slab[l * lines + i] = x[l, m0 + i],
  // axis 1 slab[i * L + l] = x[m0 + i, l]
  for (int e = threadIdx.x; e < L * sm; e += kThreads) {
    if (kAxis == 0) {
      const int l = e / sm, i = e % sm;
      slab[l * lines + i] = x[static_cast<size_t>(l) * cols + m0 + i];
    } else {
      const int i = e / L, l = e % L;
      slab[i * L + l] = x[static_cast<size_t>(m0 + i) * cols + l];
    }
  }
  __syncthreads();
  int off[kPer];      // each output's gather address in the slab
  size_t dst[kPer];   // and its place in out
  bool live[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    live[j] = e < sm * np;
    const int ee = live[j] ? e : 0;
    int i, p;  // line in the slab, position along the gather axis
    if (kAxis == 0) {
      p = p0 + ee / sm;
      i = ee % sm;
    } else {
      i = ee / np;
      p = p0 + ee % np;
    }
    const int r = kAxis == 0 ? p : m0 + i;
    const int c = kAxis == 0 ? m0 + i : p;
    dst[j] = static_cast<size_t>(r) * cols + c;
    const int g = kFull ? idx[dst[j]] : idx[p];
    off[j] = kAxis == 0 ? g * lines + i : i * L + g;
  }
  const volatile S* win = slab;
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      acc[j] = E::add(acc[j], E::to_float(win[off[j]]));
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (live[j]) out[dst[j]] = E::from_float(acc[j]);
  }
}

template <int kAxis, bool kFull, bool kBf16>
int launch(const void* x, const void* idx, void* out, int rows, int cols, int iters,
           cudaStream_t s) {
  const int esize = kBf16 ? 2 : 4;
  const int L = kAxis == 0 ? rows : cols;
  const int M = kAxis == 0 ? cols : rows;
  const size_t line_bytes = static_cast<size_t>(L) * esize;
  int lines = static_cast<int>(kSlabBytes / line_bytes);
  lines = lines < 1 ? 1 : (lines > kMaxLines ? kMaxLines : lines);
  lines = lines > M ? M : lines;
  const size_t smem = line_bytes * lines;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_gather_kernel<kAxis, kFull, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = kOutputs / lines;
  const dim3 grid((M + lines - 1) / lines, (L + per - 1) / per);
  kernel<<<grid, kThreads, smem, s>>>(x, static_cast<const int32_t*>(idx), out, rows, cols,
                                      lines, iters);
  return static_cast<int>(cudaGetLastError());
}

template <int kAxis, bool kFull>
int launch_dtype(int is_bf16, const void* x, const void* idx, void* out, int rows, int cols,
                 int iters, cudaStream_t s) {
  return is_bf16 ? launch<kAxis, kFull, true>(x, idx, out, rows, cols, iters, s)
                 : launch<kAxis, kFull, false>(x, idx, out, rows, cols, iters, s);
}

}  // namespace

// x [rows, cols] f32 (is_bf16 = 0) or bf16, row-major; idx int32 [rows,
// cols] (full = 1) or [x.shape[axis]] (full = 0); out like x, written in
// full; iters >= 1. Launches on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// one line of the gather axis exceeds a block's shared memory; it does not
// synchronise.
extern "C" int adaqp_window_gather(const void* x, const void* idx, void* out, int rows,
                                   int cols, int axis, int full, int is_bf16, int iters,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    return full ? launch_dtype<0, true>(is_bf16, x, idx, out, rows, cols, iters, s)
                : launch_dtype<0, false>(is_bf16, x, idx, out, rows, cols, iters, s);
  }
  return full ? launch_dtype<1, true>(is_bf16, x, idx, out, rows, cols, iters, s)
              : launch_dtype<1, false>(is_bf16, x, idx, out, rows, cols, iters, s);
}

extern "C" const char* adaqp_window_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
