// The Hopper (sm_90a) building blocks of the kernels that multiply 0/1
// tiles expanded from bitmasks on the tensor cores (expand_tile.cu,
// compact_item.cu): mbarriers, TMA loads and their tensor maps, wgmma with
// A from registers and B from shared memory, and the expansion of mask
// halfwords into A's bf16 fragments.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// a wait that outlasts this many polls means a lost copy or arrival: fail
// the launch instead of hanging the card
constexpr uint32_t kMaxPolls = 1u << 26;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits on the barrier's phase. kGuard (the producers' waits): a wait
// that outlasts kMaxPolls polls traps, so a lost copy or arrival fails the
// launch instead of hanging the card, and with it the consumers waiting on
// that copy. The consumers' waits have no trap: a trap on their path makes
// ptxas hold the whole kernel to the registers of its launch, spilling and
// serialising the wgmmas (C7512).
template <bool kGuard>
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t i = 0; !try_wait(bar, parity); ++i) {
    if (kGuard && i == kMaxPolls) __trap();
  }
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// The box of `map` at (column c0, row r0) into shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int r0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
        "r"(smem_u32(bar))
      : "memory");
}

// wgmma's descriptor of a K16 x N128 piece of bf16 B at `addr` (1 KB
// aligned) in the layout a 128-byte-swizzled TMA box of 64 columns writes:
// MN-major, rows of 128 bytes, LBO = `half_bytes` to the piece's second 64
// columns, SBO = the 1 KB to the next 8 rows.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t half_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(half_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to the sums across a wgmma fence
__device__ __forceinline__ void fence_sums(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = a (registers, 64 x 16 bf16) * B (shared, 16 x 128 bf16,
// MN-major) + (accumulate ? d : 0), f32 sums
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The bf16 bits of one element of an expanded tile: halfword w
// (sign-extended) at bit b, four ways:
//   v0  (w >> b) & 1, to f32, to bf16 (the TPU's .astype(f32).astype(bf16))
//   v1  (w >> b) & 1, straight to bf16
//   v2  a sign select: (w << (31 - b)) < 0 ? 1 : 0
//   v3  the raw halfword w to bf16 (wrong math, a timing floor)
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

// One register of an A fragment: the two halfwords of a mask word at bit b
// (the lower halfword is the lower column).
template <int V>
__device__ __forceinline__ uint32_t expand_pair(uint32_t word, int b) {
  const int lo = static_cast<int>(static_cast<int16_t>(word & 0xFFFFu));
  const int hi = static_cast<int>(static_cast<int16_t>(word >> 16));
  return expand_one<V>(lo, b) | (expand_one<V>(hi, b) << 16);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA library, looked up through the runtime
// (no -lcuda at link time).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 2-D map of `rows` rows of `cols` 16-bit elements, boxes of box_cols x
// box_rows, 128-byte swizzle; columns past `cols` read as zeros.
inline bool encode_2d(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, uint64_t cols, uint64_t rows, uint32_t box_cols,
                      uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Makes `device` current unless it is already (a cudaSetDevice costs the
// host a few microseconds a call).
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace hopper
