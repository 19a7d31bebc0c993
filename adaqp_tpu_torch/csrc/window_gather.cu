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
// window (4 MiB) exceeds a block's 227 KB of shared memory. So the grid
// covers the lines of the non-gather axis only (columns of x for axis 0,
// rows for axis 1): block b stages its `lines` lines whole -- every
// position of the gather axis -- and computes every output of them, so
// each element of x, and of a full index, is read from device memory once
// by one block. The caller's plan (window_plan in
// scripts/microbench_gather.py) picks `lines` for about one wave of one or
// two blocks an SM, the slab's `stride` and the staging loads' width
// `unit`. Staging takes no division: thread t stages gather positions t,
// t + kThreads, ... -- for axis 0 each position's segment of `lines`
// columns by `unit`-byte loads into a slab [L][stride] whose positions lie
// an odd number of words apart (a warp's random rows of one line then
// spread over all 32 banks), for axis 1 each line by `unit`-byte
// cp.async copies into a slab [lines][stride]. A full index is staged
// after the slab the same way, by cp.async, before x's loads, so that both
// are in flight together (a 1-D index: its entries). Then each thread
// takes kPer outputs at a time: their slab offsets are worked out once,
// and every iteration gathers each output's value from the slab through a
// volatile shared-memory load, so that the compiler cannot hoist the
// gather out of the iteration loop (the per-iteration slope of the time
// measures the gather), and adds it into the thread's accumulator.
//
// What bounds it: bytes for one iteration (x read once, the index read
// once, the output written once), the f32 adds for many: iters * R * C
// adds at the card's f32 rate; each iteration costs one shared-memory
// gather an output. What holds it back along axis 0: a block owning two of
// 256 columns reads and writes an 8-byte piece of every row, a memory
// request a piece, where torch.gather reads whole rows; wider blocks leave
// SMs idle and double the per-iteration slope, and clusters of 2-8 blocks
// that shared a sector-wide slab through distributed shared memory were
// slower still (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// The indices must lie in [0, x.shape[axis]); the kernel trusts them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 8;               // outputs a thread at a time
constexpr int kStage = 8;             // staging loads a thread in flight
constexpr int kMaxSmem = 227 * 1024;  // a block's limit on Hopper

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

// U bytes as one load
template <int U>
struct Unit;
template <>
struct Unit<16> {
  using T = uint4;
};
template <>
struct Unit<8> {
  using T = uint2;
};
template <>
struct Unit<4> {
  using T = uint32_t;
};
template <>
struct Unit<2> {
  using T = uint16_t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// U bytes as one load from U-aligned global memory, and one store to
// shared memory: a vector (kWide: dst U-aligned) or U / 4 words (dst
// 4-byte aligned).
template <int U>
__device__ __forceinline__ typename Unit<U>::T load_unit(const uint8_t* src) {
  return __ldg(reinterpret_cast<const typename Unit<U>::T*>(src));
}
template <int U, bool kWide>
__device__ __forceinline__ void store_unit(uint8_t* dst, typename Unit<U>::T v) {
  if constexpr (kWide || U <= 4) {
    *reinterpret_cast<typename Unit<U>::T*>(dst) = v;
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int k = 0; k < U / 4; ++k) reinterpret_cast<uint32_t*>(dst)[k] = w[k];
  }
}

// U (4, 8 or 16) bytes global -> shared without passing through registers;
// complete after cp.async.wait_all.
template <int U>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src), "n"(U)
               : "memory");
}

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The slab of x: axis 0 [L][stride], axis 1 [lines][stride] elements.
__host__ __device__ inline size_t slab_bytes(int axis, int L, int lines, int stride, int esize) {
  return round16(static_cast<size_t>(axis == 0 ? L : lines) * stride * esize);
}

// The staged index after it: a full one axis 0 [L][lines], axis 1
// [lines][L rounded up to 4]; a 1-D one [L rounded up to 4].
__host__ __device__ inline int index_stride(int L) { return (L + 3) / 4 * 4; }
__host__ __device__ inline size_t index_bytes(int axis, int full, int L, int lines) {
  if (!full) return static_cast<size_t>(index_stride(L)) * 4;
  return static_cast<size_t>(axis == 0 ? L : index_stride(L)) * lines * 4;
}

// x [rows, cols] row-major. The gather axis has length L (rows for axis 0,
// cols for axis 1); block b owns lines [b * lines, b * lines + lines) of
// the other axis, M of them in all, at every position of the gather axis.
// kUnit is the staging loads' width for x; the full index's is kIUnit, as
// many positions wide.
template <int kAxis, bool kFull, bool kBf16, int kUnit>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const void* __restrict__ x_, const int32_t* __restrict__ idx, void* out_,
                     int rows, int cols, int lines, int stride, int iters) {
  using E = Elem<kBf16>;
  using S = typename E::S;
  constexpr int kIUnit = kUnit * 4 / static_cast<int>(sizeof(S)) > 16
                             ? 16 : kUnit * 4 / static_cast<int>(sizeof(S));
  extern __shared__ __align__(16) uint8_t smem[];
  S* slab = reinterpret_cast<S*>(smem);
  const S* x = static_cast<const S*>(x_);
  S* out = static_cast<S*>(out_);
  const int L = kAxis == 0 ? rows : cols;
  const int M = kAxis == 0 ? cols : rows;
  const int m0 = blockIdx.x * lines;
  const int sm = min(lines, M - m0);
  const int li = index_stride(L);
  int32_t* islab = reinterpret_cast<int32_t*>(
      smem + slab_bytes(kAxis, L, lines, stride, static_cast<int>(sizeof(S))));
  // the index first, by asynchronous copies, so that its loads and x's are
  // in flight together
  if (!kFull) {
    for (int l = threadIdx.x; l < L; l += kThreads) copy_async<4>(islab + l, idx + l);
  } else if (kAxis == 0) {
    // position p's segment: sm entries of row p, to islab[p * lines + i]
    const int seg = sm * 4;
    for (int p = threadIdx.x; p < L; p += kThreads) {
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(idx + static_cast<size_t>(p) * cols + m0);
      uint8_t* dst = reinterpret_cast<uint8_t*>(islab + static_cast<size_t>(p) * lines);
      for (int b = 0; b < seg; b += kIUnit) copy_async<kIUnit>(dst + b, src + b);
    }
  } else {
    // line i: row m0 + i of the index, to islab[i * li + l]
    const int units = L * 4 / kIUnit;
    for (int i = 0; i < sm; ++i) {
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(idx + static_cast<size_t>(m0 + i) * cols);
      uint8_t* dst = reinterpret_cast<uint8_t*>(islab + static_cast<size_t>(i) * li);
      for (int u = threadIdx.x; u < units; u += kThreads) {
        copy_async<kIUnit>(dst + u * kIUnit, src + u * kIUnit);
      }
    }
  }
  if (kAxis == 0) {
    // position p's segment: sm columns of row p, to slab[p * stride + i]
    // (kStage loads a thread in flight, then their stores: an odd number
    // of words apart, the positions take no vector stores)
    using T = typename Unit<kUnit>::T;
    T v[kStage];
    const int seg = sm * static_cast<int>(sizeof(S));
    const uint8_t* src = reinterpret_cast<const uint8_t*>(x + m0);
    uint8_t* dst = reinterpret_cast<uint8_t*>(slab);
    const size_t src_row = static_cast<size_t>(cols) * sizeof(S);
    const size_t dst_row = static_cast<size_t>(stride) * sizeof(S);
    for (int p0 = threadIdx.x; p0 < L; p0 += kThreads * kStage) {
      for (int b = 0; b < seg; b += kUnit) {
#pragma unroll
        for (int j = 0; j < kStage; ++j) {
          const int p = p0 + j * kThreads;
          if (p < L) v[j] = load_unit<kUnit>(src + p * src_row + b);
        }
#pragma unroll
        for (int j = 0; j < kStage; ++j) {
          const int p = p0 + j * kThreads;
          if (p < L) store_unit<kUnit, false>(dst + p * dst_row + b, v[j]);
        }
      }
    }
  } else {
    // line i: row m0 + i of x, to slab[i * stride + l]; by asynchronous
    // copies, or 2-byte loads for a line of an odd number of bf16 values
    const int units = L * static_cast<int>(sizeof(S)) / kUnit;
    for (int i = 0; i < sm; ++i) {
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(x + static_cast<size_t>(m0 + i) * cols);
      uint8_t* dst = reinterpret_cast<uint8_t*>(slab + static_cast<size_t>(i) * stride);
      for (int u = threadIdx.x; u < units; u += kThreads) {
        if constexpr (kUnit >= 4) {
          copy_async<kUnit>(dst + u * kUnit, src + u * kUnit);
        } else {
          store_unit<kUnit, true>(dst + u * kUnit, load_unit<kUnit>(src + u * kUnit));
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  // outputs e = 0 .. sm * L - 1 of the block: axis 0 position-major (e = p
  // * sm + i, x's order), axis 1 line-major (e = i * L + p)
  const int total = sm * L;
  const volatile S* win = slab;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kPer) {
    int off[kPer];     // each output's gather address in the slab
    size_t dst[kPer];  // and its place in out
    bool live[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = e0 + j * kThreads;
      live[j] = e < total;
      const int ee = live[j] ? e : e0;
      int i, p;  // line in the slab, position along the gather axis
      if (kAxis == 0) {
        p = ee / sm;
        i = ee - p * sm;
      } else {
        i = ee / L;
        p = ee - i * L;
      }
      const int r = kAxis == 0 ? p : m0 + i;
      const int c = kAxis == 0 ? m0 + i : p;
      dst[j] = static_cast<size_t>(r) * cols + c;
      const int g = !kFull ? islab[p] : islab[kAxis == 0 ? p * lines + i : i * li + p];
      off[j] = kAxis == 0 ? g * stride + i : i * stride + g;
    }
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int k = 0; k < iters; ++k) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        // a chunk's dead outputs (past the block's last) gather nothing
        if (live[j]) acc[j] = E::add(acc[j], E::to_float(win[off[j]]));
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (live[j]) out[dst[j]] = E::from_float(acc[j]);
    }
  }
}

template <int kAxis, bool kFull, bool kBf16, int kUnit>
int launch(const void* x, const void* idx, void* out, int rows, int cols, int lines, int stride,
           int iters, size_t smem, cudaStream_t s) {
  auto kernel = window_gather_kernel<kAxis, kFull, kBf16, kUnit>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = kAxis == 0 ? cols : rows;
  kernel<<<(M + lines - 1) / lines, kThreads, smem, s>>>(
      x, static_cast<const int32_t*>(idx), out, rows, cols, lines, stride, iters);
  return static_cast<int>(cudaGetLastError());
}

template <int kAxis, bool kFull, bool kBf16>
int launch_unit(int unit, const void* x, const void* idx, void* out, int rows, int cols,
                int lines, int stride, int iters, size_t smem, cudaStream_t s) {
  switch (unit) {
    case 16:
      return launch<kAxis, kFull, kBf16, 16>(x, idx, out, rows, cols, lines, stride, iters,
                                             smem, s);
    case 8:
      return launch<kAxis, kFull, kBf16, 8>(x, idx, out, rows, cols, lines, stride, iters,
                                            smem, s);
    case 4:
      return launch<kAxis, kFull, kBf16, 4>(x, idx, out, rows, cols, lines, stride, iters,
                                            smem, s);
    default:
      if constexpr (kBf16) {
        return launch<kAxis, kFull, kBf16, 2>(x, idx, out, rows, cols, lines, stride, iters,
                                              smem, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kAxis, bool kFull>
int launch_dtype(int is_bf16, int unit, const void* x, const void* idx, void* out, int rows,
                 int cols, int lines, int stride, int iters, size_t smem, cudaStream_t s) {
  return is_bf16 ? launch_unit<kAxis, kFull, true>(unit, x, idx, out, rows, cols, lines, stride,
                                                   iters, smem, s)
                 : launch_unit<kAxis, kFull, false>(unit, x, idx, out, rows, cols, lines, stride,
                                                    iters, smem, s);
}

// Shared memory a launch takes (the slab and the staged index), or 0 for
// a plan the kernel cannot run: `lines` >= 1; axis 0: stride >= lines,
// positions a whole number of words apart; axis 1: stride >= L, lines
// 16-byte aligned; `unit` (2, 4, 8 or 16 bytes, at least an element)
// divides the row stride, the staged segments and their starts.
size_t plan_smem(int rows, int cols, int axis, int full, int is_bf16, int lines, int stride,
                 int unit) {
  const int esize = is_bf16 ? 2 : 4;
  const int L = axis == 0 ? rows : cols;
  const int M = axis == 0 ? cols : rows;
  if (lines < 1 || (unit != 2 && unit != 4 && unit != 8 && unit != 16) || unit < esize ||
      (cols * esize) % unit) {
    return 0;
  }
  if (axis == 0) {
    if (stride < lines || (stride * esize) % 4 || (lines * esize) % unit ||
        ((M % lines) * esize) % unit) {
      return 0;
    }
  } else if (stride < L || (stride * esize) % 16) {
    return 0;
  }
  return slab_bytes(axis, L, lines, stride, esize) + index_bytes(axis, full, L, lines);
}

}  // namespace

// x [rows, cols] f32 (is_bf16 = 0) or bf16, row-major, `unit`-byte
// aligned; idx int32 [rows, cols] (full = 1), aligned to `unit` bytes of x's
// elements as many of its own (at most 16), or [x.shape[axis]] (full = 0);
// out like x, written in full; iters >= 1; the plan's `lines`, `stride`
// and `unit` (window_plan in scripts/microbench_gather.py). Launches on
// `stream` of CUDA device `device` and returns cudaGetLastError() (0 on
// success), or
// cudaErrorInvalidValue for a plan the kernel cannot run or whose slab
// exceeds a block's shared memory; it does not synchronise.
extern "C" int adaqp_window_gather(const void* x, const void* idx, void* out, int rows,
                                   int cols, int axis, int full, int is_bf16, int iters,
                                   int lines, int stride, int unit, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0) return 0;
  const size_t smem = plan_smem(rows, cols, axis, full, is_bf16, lines, stride, unit);
  const int iunit = std::min(16, unit * 4 / (is_bf16 ? 2 : 4));
  if (smem == 0 || smem > static_cast<size_t>(kMaxSmem) || iters < 1 ||
      reinterpret_cast<uintptr_t>(x) % unit ||
      reinterpret_cast<uintptr_t>(idx) % (full ? iunit : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    return full ? launch_dtype<0, true>(is_bf16, unit, x, idx, out, rows, cols, lines, stride,
                                        iters, smem, s)
                : launch_dtype<0, false>(is_bf16, unit, x, idx, out, rows, cols, lines, stride,
                                         iters, smem, s);
  }
  return full ? launch_dtype<1, true>(is_bf16, unit, x, idx, out, rows, cols, lines, stride,
                                      iters, smem, s)
              : launch_dtype<1, false>(is_bf16, unit, x, idx, out, rows, cols, lines, stride,
                                       iters, smem, s);
}

extern "C" const char* adaqp_window_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
