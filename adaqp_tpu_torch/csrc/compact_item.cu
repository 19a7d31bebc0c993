// compact_item for NVIDIA Hopper (sm_90a): the cost model of one compact
// work item -- mask expansion, then bf16 products into f32 accumulators.
//
// It replaces the TPU kernel `kern` of scripts/microbench_gather.py:212
// (mk_item). A is the 0/1 expansion of a [256, 128] halfword mask: A[r, l]
// is bit l / 128 of halfword mask[r, l % 128] (pltpu.repeat tiles the 128
// halfwords 16 times; the convention of every tile layout of the port).
// With win bf16 [2048, fc] and an f32 accumulator of [2048, fc], each of
// `iters` iterations expands A again and adds
//   kind 0: A @ win into accumulator rows 0..255;
//   kind 1: for s < 8, A[:, 256s : 256s + 256] @ win[col[256s : 256s + 256]]
//           into accumulator rows 256s..256s + 255 (the row gather win[col]
//           happens inside the kernel);
// then the accumulator is rounded once to bf16. The TPU kernel never
// zeroes its VMEM accumulator (microbench_gather.py:211-238: it summed onto
// whatever VMEM held, NaN in interpret mode); here it starts at zero, so
// kind 0's rows 256..2047 are zero.
//
// The design, simple first. A block of four warps owns 64 output rows x 64
// columns (a kind-1 tile lies inside one subtile). Per iteration it loads
// its 64 mask rows into shared memory, and per 32-deep step of the
// product's depth (2,048 for kind 0, 256 for kind 1) expands A's 64 x 32
// 0/1 values into bf16 and gathers the 32 x 64 slice of win (rows through
// col for kind 1, columns past fc zero) into shared memory, transposed so
// that each B fragment is one 32-bit load. Each warp then runs 2 x 8
// mma.sync m16n8k16 (bf16 in, f32 out) over its 16 rows. As the TPU's
// `acc += jnp.dot(...)`, an iteration's product is summed from zero in its
// own registers and then added into the accumulator registers, so the
// result differs from the plain version only by the order of each
// product's f32 sum. The loads are re-issued every iteration (a compiler
// memory barrier heads each one, the inputs are not __restrict__) and the
// products are asm volatile, so no iteration's work can be hoisted.
//
// What bounds it: one item reads the mask, col and win once and writes
// out once (about 2.1 MB at fc = 256) and does 2 * 256 * 2048 * fc flops
// an iteration, at 989 TFLOP/s for bf16 with f32 accumulation; one
// iteration is bound by bytes, 200 by operations. Kind 0 has work for 4
// of the 32 row tiles only; wgmma, a ring of TMA loads and a split of the
// depth across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBD = 256;      // mask rows (destination rows of a tile)
constexpr int kWords = 128;   // halfwords a mask row
constexpr int kBS = 2048;     // virtual columns of a tile, rows of win
constexpr int kCsub = 256;    // columns of a subtile
constexpr int kRowsOut = 2048;  // accumulator rows (8 subtiles of 256)
constexpr int kTm = 64, kTn = 64, kTk = 32;  // block tile, depth step
constexpr int kStride = kTk / 2 + 4;  // words a staged row: 16 + 4 of padding (no bank conflicts)
constexpr int kThreads = 128;
constexpr uint32_t kOne = 0x3F80;  // bf16 1.0

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
compact_item_kernel(const uint16_t* mask, const int32_t* col, const uint16_t* win,
                    uint16_t* out, int fc, int kind, int iters) {
  __shared__ __align__(16) uint16_t mask_s[kTm][kWords];
  __shared__ uint32_t a_s[kTm][kStride];  // A step: [row][pair of depth columns]
  __shared__ uint32_t b_s[kTn][kStride];  // B step, transposed: [column][pair of depth rows]
  const int m0 = blockIdx.x * kTm, n0 = blockIdx.y * kTn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread in group
  if (kind == 0 && m0 >= kBD) {  // rows past A's 256 only ever hold zeros
    for (int e = tid; e < kTm * kTn; e += kThreads) {
      const int r = m0 + e / kTn, c = n0 + e % kTn;
      if (c < fc) out[static_cast<size_t>(r) * fc + c] = 0;
    }
    return;
  }
  const int a0 = kind == 0 ? m0 : m0 % kBD;                   // first mask row
  const int k_begin = kind == 0 ? 0 : (m0 / kBD) * kCsub;    // depth range
  const int k_end = kind == 0 ? kBS : k_begin + kCsub;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    asm volatile("" ::: "memory");  // every iteration reads its inputs again
    for (int e = tid; e < kTm * kWords / 8; e += kThreads) {  // 16 bytes at a time
      const int r = e / (kWords / 8), q = e % (kWords / 8);
      reinterpret_cast<uint4*>(&mask_s[r][0])[q] =
          reinterpret_cast<const uint4*>(mask + static_cast<size_t>(a0 + r) * kWords)[q];
    }
    __syncthreads();
    float p[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) p[i][q] = 0.f;
    }
    for (int k0 = k_begin; k0 < k_end; k0 += kTk) {
      // k0 is a multiple of 32: a step's 32 depth columns lie in one band of
      // 128 and so share one bit of their halfwords
      const int bit = k0 / kWords, h0 = k0 % kWords;
      for (int e = tid; e < kTm * kTk / 2; e += kThreads) {
        const int r = e / (kTk / 2), w = e % (kTk / 2);
        const uint32_t lo = (mask_s[r][h0 + 2 * w] >> bit) & 1u;
        const uint32_t hi = (mask_s[r][h0 + 2 * w + 1] >> bit) & 1u;
        a_s[r][w] = (lo ? kOne : 0u) | ((hi ? kOne : 0u) << 16);
      }
      for (int e = tid; e < kTn * kTk / 2; e += kThreads) {
        const int n = e % kTn, w = e / kTn;  // neighbouring threads on neighbouring columns
        const int k = k0 + 2 * w;
        uint32_t lo = 0, hi = 0;
        if (n0 + n < fc) {
          const int r0 = kind == 0 ? k : col[k];
          const int r1 = kind == 0 ? k + 1 : col[k + 1];
          lo = win[static_cast<size_t>(r0) * fc + n0 + n];
          hi = win[static_cast<size_t>(r1) * fc + n0 + n];
        }
        b_s[n][w] = lo | (hi << 16);
      }
      __syncthreads();
      const int wr = warp * 16;
#pragma unroll
      for (int ks = 0; ks < kTk / 2; ks += 8) {  // two k16 steps, 8 words each
        uint32_t a[4];
        a[0] = a_s[wr + g][ks + t];
        a[1] = a_s[wr + g + 8][ks + t];
        a[2] = a_s[wr + g][ks + t + 4];
        a[3] = a_s[wr + g + 8][ks + t + 4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mma_bf16(p[i], a, b_s[i * 8 + g][ks + t], b_s[i * 8 + g][ks + t + 4]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += p[i][q];
    }
  }
  // c0, c1 at row g, columns 2t, 2t + 1 of n-tile i; c2, c3 at row g + 8
  const int r = m0 + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = n0 + i * 8 + 2 * t + (q & 1);
      if (c < fc) {
        out[static_cast<size_t>(r + (q >> 1) * 8) * fc + c] =
            __bfloat16_as_ushort(__float2bfloat16_rn(acc[i][q]));
      }
    }
  }
}

}  // namespace

// mask int16 [256, 128]; col int32 [2048] in [0, 2048) (read for kind 1);
// win bf16 [2048, fc]; out bf16 [2048, fc], written in full; kind 0 or 1;
// iters >= 1. Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_compact_item(const void* mask, const void* col, const void* win,
                                  void* out, int fc, int kind, int iters, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fc <= 0) return 0;
  const dim3 grid(kRowsOut / kTm, (fc + kTn - 1) / kTn);
  compact_item_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(mask), static_cast<const int32_t*>(col),
      static_cast<const uint16_t*>(win), static_cast<uint16_t*>(out), fc, kind, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_compact_item_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
