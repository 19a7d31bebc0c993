// expand_spmm for NVIDIA Hopper (sm_90a): block bitmask SpMM through dense
// 0/1 tiles on the tensor cores.
//
// It replaces the TPU kernel `kernel` of scripts/microbench_expand.py:48
// (make_run, called at :149): one pass out = A^T h over a block layout,
// where each [256, 2048] tile's int16 mask [256, 128] is expanded into a
// 0/1 bf16 matrix `a` (column j is bit j / 128 of halfword j % 128, the
// tiling of pltpu.repeat) and `a @ window` is added into an f32
// accumulator of the destination block, written once as bf16 at the
// block's last tile. The four variants compute `a` four ways:
//   v0  (w >> bit) & 1, to f32, to bf16
//   v1  (w >> bit) & 1, straight to bf16
//   v2  a sign select: (w << (31 - bit)) < 0 ? 1 : 0
//   v3  the raw sign-extended halfword w to bf16: WRONG math on purpose,
//       the reference's timing floor (expansion reduced to a cast)
// where w is the halfword sign-extended to 32 bits. The probe asks whether
// a dense tensor-core product of expanded tiles beats walking each tile
// row's set columns (csrc/spmm_strip.cu, the strip/block/compact kernel).
//
// What bounds it: operations. A pass does 2 * 256 * 2048 * F flops a tile
// on the tensor cores (bf16 in, f32 accumulate; 989 TFLOP/s dense), some
// 40x more time than moving the masks, h and out once at 3.35 TB/s.
//
// The design (simple and right; speed is later work). The TPU ran the
// tiles in order on one core and carried the accumulator across grid
// steps; here a CTA of 8 warps owns a [128, 128] slice of one destination
// block's output (a row half x a 128-column chunk of F) and walks that
// block's tiles blk_ptr[b] .. blk_ptr[b + 1] itself, so nothing carries
// between CTAs and the accumulator stays in registers (64 f32 a thread).
// A tile runs as 32 K-steps of 64 source columns. Columns
// bit * 128 + half * 64 + c (c < 64) are bit `bit` of the 64 halfwords
// half * 64 + c, so a thread loads its row's 32 halfwords of a half once
// into registers (4 x 16-byte loads) and expands them for 16 bits in turn,
// writing bf16 0/1 into a shared [128, 64] A slice; the matching 64 window
// rows x 128 columns of h arrive in shared memory by cp.async, double-
// buffered one K-step ahead. Each warp multiplies a [64, 32] piece with
// mma.sync.m16n8k16 (bf16, f32 accumulate), its fragments loaded with
// ldmatrix (.trans for the row-major window). Shared rows are padded by 16
// bytes so ldmatrix's eight row addresses fall on distinct banks. The
// output is written once, as bf16. A destination block without tiles gives zeros.
//
// Every CTA of a block expands the same masks once per 128-column chunk
// of F (5 times at F = 640), and a K-step waits on its window without
// overlapping its expansion: simple first. The wrapper (scripts/
// microbench_expand.py::expand_spmm) takes only bf16 h with F a multiple
// of 128 and a square layout, and raises on anything else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BD = 256;        // destination rows of a tile
constexpr int BS = 2048;       // source columns of a tile
constexpr int WORDS = 128;     // halfwords of a tile row
constexpr int kRows = 128;     // output rows of a CTA (a row half of a block)
constexpr int kCols = 128;     // output columns of a CTA
constexpr int kK = 64;         // source columns of a K-step
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kAStride = kK + 8;      // bf16 a row of the A slice (144 bytes)
constexpr int kBStride = kCols + 8;   // bf16 a row of a window slice (272 bytes)
constexpr int kASize = kRows * kAStride;  // bf16 of the A slice
constexpr int kBSize = kK * kBStride;     // bf16 of one window buffer
constexpr size_t kSmem = (kASize + 2 * kBSize) * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 bits of one element of `a`: halfword w (sign-extended) at bit b.
template <int V>
__device__ __forceinline__ uint32_t expand_one(int w, int b) {
  if constexpr (V == 0) {
    return __bfloat16_as_ushort(__float2bfloat16(static_cast<float>((w >> b) & 1)));
  } else if constexpr (V == 1) {
    return __bfloat16_as_ushort(__int2bfloat16_rn((w >> b) & 1));
  } else if constexpr (V == 2) {
    const int s = static_cast<int>(static_cast<uint32_t>(w) << (31 - b));
    return s < 0 ? 0x3F80u : 0u;  // bf16 1.0 and 0.0
  } else {
    return __bfloat16_as_ushort(__int2bfloat16_rn(w));
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
expand_tile_kernel(const int16_t* __restrict__ masks, const int32_t* __restrict__ src_start,
                   const int32_t* __restrict__ blk_ptr, const __nv_bfloat16* __restrict__ h,
                   __nv_bfloat16* __restrict__ out, int f) {
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + kASize;  // two buffers of kBSize

  const int f0 = blockIdx.x * kCols;
  const int row_half = blockIdx.y;
  const int blk = blockIdx.z;
  const int t0 = blk_ptr[blk];
  const int steps = (blk_ptr[blk + 1] - t0) * 32;  // K-steps of this block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // rows wm * 64 .. + 64 of the CTA's 128
  const int wn = warp & 3;   // columns wn * 32 .. + 32 of its 128
  // expansion: thread (er, ep) writes A slice row er, columns ep * 32 .. + 32
  const int er = tid >> 1;
  const int ep = tid & 1;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // window rows of K-step g (tile t0 + g / 32; within it i = g % 32 is
  // half i / 16, bit i % 16: source columns bit * 128 + half * 64 + [0, 64))
  auto load_window = [&](int g) {
    const int i = g & 31;
    const int64_t row0 = static_cast<int64_t>(src_start[t0 + (g >> 5)]) + (i & 15) * WORDS +
                         (i >> 4) * kK;
    __nv_bfloat16* dst = b_s + (g & 1) * kBSize;
#pragma unroll
    for (int k = 0; k < (kK * kCols / 8) / kThreads; ++k) {  // 4 16-byte chunks a thread
      const int q = tid + k * kThreads;
      const int r = q >> 4;         // 16 chunks a 128-column row
      const int c = (q & 15) * 8;
      cp_async16(dst + r * kBStride + c, h + (row0 + r) * f + f0 + c);
    }
  };

  uint32_t words[16];  // this thread's 32 halfwords of the current half, in pairs
  if (steps > 0) load_window(0);
  cp_commit();
  for (int g = 0; g < steps; ++g) {
    const int i = g & 31;
    if ((i & 15) == 0) {  // a new half of a tile: this row's 32 halfwords
      const int64_t t = t0 + (g >> 5);
      const uint4* src = reinterpret_cast<const uint4*>(
          masks + (t * BD + row_half * kRows + er) * WORDS + (i >> 4) * kK + ep * 32);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 v = src[k];
        words[4 * k] = v.x;
        words[4 * k + 1] = v.y;
        words[4 * k + 2] = v.z;
        words[4 * k + 3] = v.w;
      }
    }
    // the other buffer was last read by K-step g - 1, which ended in a barrier
    if (g + 1 < steps) load_window(g + 1);
    cp_commit();
    // expand bit i % 16 of the 32 halfwords into A row er, columns ep * 32 ..
    const int bit = i & 15;
    uint4* arow = reinterpret_cast<uint4*>(a_s + er * kAStride + ep * 32);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t packed[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t pair = words[4 * k + p];
        const int lo = static_cast<int>(static_cast<int16_t>(pair & 0xFFFFu));
        const int hi = static_cast<int>(static_cast<int16_t>(pair >> 16));
        packed[p] = expand_one<V>(lo, bit) | (expand_one<V>(hi, bit) << 16);
      }
      arow[k] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    cp_wait_one();  // this thread's copies of K-step g have landed
    __syncthreads();
    const __nv_bfloat16* b_cur = b_s + (g & 1) * kBSize;
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(af[mi], a_s + (wm * 64 + mi * 16 + (lane & 15)) * kAStride + kk * 16 +
                                (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        const int m = lane >> 3;
        ldmatrix_x4_trans(bf, b_cur + (kk * 16 + (m & 1) * 8 + (lane & 7)) * kBStride +
                                  wn * 32 + np * 16 + (m >> 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // A and this window buffer are free for the next K-step
  }

  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int64_t row_base = static_cast<int64_t>(blk) * BD + row_half * kRows + wm * 64;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = f0 + wn * 32 + ni * 8 + tig * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int64_t row = row_base + mi * 16 + gid + hf * 8;
        const float x0 = acc[mi][ni][2 * hf], x1 = acc[mi][ni][2 * hf + 1];
        reinterpret_cast<__nv_bfloat162*>(out + row * f + col)[0] =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <int V>
cudaError_t launch(const int16_t* masks, const int32_t* src_start, const int32_t* blk_ptr,
                   const __nv_bfloat16* h, __nv_bfloat16* out, int n_blocks, int f,
                   cudaStream_t stream) {
  auto kernel = expand_tile_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(f / kCols, BD / kRows, n_blocks);
  kernel<<<grid, kThreads, kSmem, stream>>>(masks, src_start, blk_ptr, h, out, f);
  return cudaGetLastError();
}

}  // namespace

// masks int16 [T, 256, 128]; src_start int32 [T]; blk_ptr int32
// [n_blocks + 1] (tiles blk_ptr[b] .. blk_ptr[b + 1] belong to destination
// block b); h bf16 [n_src_pad, f], f a positive multiple of 128, all
// 16-byte aligned; out bf16 [n_blocks * 256, f].
// variant 0..3 (v0..v3). Launches on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// an f or variant it does not take; it does not synchronise.
extern "C" int adaqp_expand_spmm(const void* masks, const void* src_start, const void* blk_ptr,
                                 const void* h, void* out, int n_blocks, int f, int variant,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f <= 0 || f % kCols || n_blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const auto* m = static_cast<const int16_t*>(masks);
  const auto* ss = static_cast<const int32_t*>(src_start);
  const auto* bp = static_cast<const int32_t*>(blk_ptr);
  const auto* hh = static_cast<const __nv_bfloat16*>(h);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (variant) {
    case 0: err = launch<0>(m, ss, bp, hh, o, n_blocks, f, s); break;
    case 1: err = launch<1>(m, ss, bp, hh, o, n_blocks, f, s); break;
    case 2: err = launch<2>(m, ss, bp, hh, o, n_blocks, f, s); break;
    case 3: err = launch<3>(m, ss, bp, hh, o, n_blocks, f, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* adaqp_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
