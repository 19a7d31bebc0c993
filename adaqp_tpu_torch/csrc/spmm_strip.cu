// Window-stationary bitmask SpMM for NVIDIA Hopper (sm_90a): out = A^T h
// over 0/1 tiles, the tile kernel of the strip, block and compact layouts.
//
// Replaces three of the JAX package's TPU kernels, which compute one
// function over three layouts: ops/spmm_strip.py::_strip_kernel (launched by
// _run_strip_pallas), ops/spmm_block.py::_block_kernel (_run_block_pallas)
// and ops/spmm_compact.py::_compact_kernel (_run_compact_pallas). What this
// kernel reads (a "walk", built once per layout by ops/spmm_walk.py):
//
//   for each destination row r of block b = r / 256, the sum over the
//   block's walk tiles t of h[step_win + j] for every column j of row
//   r % 256 of tile t; the sum is taken in f32 and written in h's dtype. A
//   block with no tile is written as zeros (the TPU kernels' flush-only
//   path). A strip or block layout's dense tiles are walk tiles as they are
//   (a block layout pads its rows to 256 only, so its last strip may be
//   part-filled: rows past n_out are not written); a compact layout's
//   items decode into them, a kind-1 item's virtual column v into window
//   row col_idx[v], and the subtiles of every item that land on one (strip,
//   window, block) merge into one walk tile. The ELL straggler edges are
//   added outside, in PyTorch.
//
// What bounds it. Each edge adds one F-wide source row. Read from L2 for
// every edge, as the first port of this kernel did, the rows cost 41 GB a
// pass on the smoke layout at F=640 (32.2 M tile edges x 1,280 B): that
// kernel took 11.8-12.1 ms on the H100, 56x the 0.210 ms of moving each
// input byte once. The TPU kernel does not fetch per edge: it copies each
// 2,048-row source window into VMEM once for a strip of 8 destination
// blocks and applies it to all of them. This kernel does the same in
// shared memory:
//
// - A CTA owns one (strip of 8 destination blocks, column slice of 32
//   bytes: 16 bf16 or 8 f32 columns). Its 2,048 rows' f32 sums live in
//   registers: 16 warps, two lanes a row (16 bytes each), one row of each
//   of the 8 blocks a lane pair (64 sums a lane in bf16; 16 warps keep 128
//   registers a thread).
// - The strip's schedule (strip_ptr, step_win, step_tile; built once per
//   layout) lists the source windows its blocks touch, ascending, and each
//   block's tile in each. Window slices [2048 rows, 32 bytes] go into a
//   ring of kStages stages by TMA (8 tensor copies of 256 rows, completing
//   on the stage's mbarrier): thread 0 issues step k + kStages once every
//   warp is done with step k, so the next windows' copies overlap this
//   window's adds.
// - The tiles' bits are decoded once per layout into column lists, each
//   tile row's columns within its window ascending, so no column slice
//   re-reads the 512-byte mask rows. A warp walks its 16 rows of a tile in
//   step, as batches of kBatch columns a row: the layout keeps each group
//   of 16 tile rows as [batches, 16 rows, kBatch] uint16 columns (grp_ptr,
//   grp_len: where the group's batches start and its longest row), padded
//   with the column of a zero row, so a lane pair reads a batch's columns
//   with one 16-byte load, the next batch's (and the next tile's first)
//   while this one's adds run, and has kBatch shared-memory reads in
//   flight; the last batch takes only the group's longest row's columns.
//   Walks in which each lane pair looped over its own list diverged, and
//   were slower than the old per-edge walk; per-row lists with 2-byte reads
//   left each sparse tile row waiting on L2 (most tiles of the smoke layout
//   hold 1-5 edges a row).
// - Each output element is summed by one thread, tile (window) order and
//   then column order, with no atomics: the result does not change from run
//   to run (the zero row's padding adds +0).
//
// So each window slice is read from L2 once per strip and slice, 2.7 GB a
// pass at F=640 instead of 41, and the edges' adds read shared memory; that
// design's floor is its shared-memory bytes over the SMs' 128 B a clock.
// What is left above it: two rows of a quarter-warp's four often share
// banks (random rows of 32 bytes), a warp walks its longest row of each
// tile (1.5 column slots an edge on the smoke layout), and each bf16 value
// costs an unpack and an add. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, the smoke layout): 4.25 ms at F=640 and 1.72 ms at F=256,
// against torch.sparse.mm's 11.15 and 4.49 ms and the shared-memory floor's
// 1.31 and 0.53 ms; 128 registers a thread, no spills. On the products
// layout (chip_smoke.py train_agg): the block layout 0.206 / 0.395 ms at
// F=128 / 256, as the strip layout; the compact layout 0.815 ms at F=384
// (torch.sparse.mm 1.517 ms), its walk twice the window steps (579 against
// 278) and 2.29 column slots an edge (1.72).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

using vec16::Elem;

constexpr int kSB = 8;                           // destination blocks per strip
constexpr int kBD = 256;                         // rows per destination block
constexpr int kBS = 2048;                        // source rows per window
constexpr int kSliceBytes = 32;                  // a row's bytes in one column slice
constexpr int kBoxRows = 256;                    // rows per TMA tensor copy (its limit)
constexpr int kStages = 3;                       // window slices in flight
constexpr int kStageBytes = kBS * kSliceBytes;   // 64 KiB of window slice
// each stage is followed by one zero row (column kBS): the lanes of a row
// whose list has run out read it, so that a warp walks its rows in step
constexpr int kStageStride = kStageBytes + 128;  // (TMA destinations: 128-byte aligned)
constexpr int kSmemBytes = kStages * kStageStride;
constexpr int kWarps = 16;                       // 16 rows a warp: one block's 256 rows
constexpr int kThreads = kWarps * 32;            // 4 warps a scheduler: 128 registers a thread
constexpr int kBatch = 8;                        // shared-memory reads in flight a lane
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

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t i = 0; !try_wait(bar, parity); ++i) {
    if (i == kMaxPolls) __trap();
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

// acc += the window rows of the first r of the kBatch columns packed in
// `c` (uint16 each); `win` points at this lane's 16 bytes of window row 0.
template <bool kBf16>
__device__ __forceinline__ void add_batch(float (&acc)[Elem<kBf16>::kVec], const uint8_t* win,
                                          const uint4& c, int r) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint4 v[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (u < r) {
      const uint32_t col = (w[u / 2] >> (16 * (u % 2))) & 0xffffu;
      v[u] = *reinterpret_cast<const uint4*>(win + col * kSliceBytes);
    }
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (u < r) vec16::add_vec<kBf16>(acc, v[u]);
  }
}

// acc += lane pair `pair`'s row of a group of 16 tile rows: n columns (the
// group's longest row; the same on every lane) in batches j, j + 1, ... of
// `cols`, the first batch's columns already loaded into `cur`. The next
// batch's columns load while this one's adds run.
template <bool kBf16>
__device__ __forceinline__ void walk_rows(float (&acc)[Elem<kBf16>::kVec], const uint8_t* win,
                                          const uint4* __restrict__ cols, int j, int n,
                                          uint4 cur, int pair) {
  int i = 0;
  for (; i + kBatch <= n; i += kBatch, ++j) {
    uint4 next = cur;
    if (i + kBatch < n) next = __ldg(cols + static_cast<size_t>(j + 1) * 16 + pair);
    add_batch<kBf16>(acc, win, cur, kBatch);
    cur = next;
  }
  if (n > i) add_batch<kBf16>(acc, win, cur, n - i);
}

// Grid (column slice, strip): a CTA takes the strip's 8 blocks. Thread 0
// also keeps the ring full: it issues the first kStages window slices, and
// the slice of step k + kStages once every warp is done with step k.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
strip_kernel(const __grid_constant__ CUtensorMap map, const int32_t* __restrict__ grp_ptr,
             const int32_t* __restrict__ grp_len, const uint4* __restrict__ cols,
             const int32_t* __restrict__ strip_ptr,
             const int32_t* __restrict__ step_win, const int32_t* __restrict__ step_tile,
             uint8_t* __restrict__ out, int n_out, int f) {
  constexpr int kVec = Elem<kBf16>::kVec;      // values in a lane's 16 bytes
  constexpr int kBytes = Elem<kBf16>::kBytes;
  constexpr int kCols = kSliceBytes / kBytes;  // columns per slice
  extern __shared__ __align__(1024) uint8_t win[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = static_cast<int>(blockIdx.x) * kCols;
  const int strip = blockIdx.y;
  const int k0 = strip_ptr[strip];
  const int steps = strip_ptr[strip + 1] - k0;

  if (threadIdx.x < kStages * kSliceBytes / 4) {  // the zero rows
    reinterpret_cast<uint32_t*>(win + (threadIdx.x / (kSliceBytes / 4)) * kStageStride +
                                kStageBytes)[threadIdx.x % (kSliceBytes / 4)] = 0u;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], kWarps);
    }
    // the barriers' initialisation is seen by the TMA unit's arrivals
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the window slice of step k into stage k % kStages (thread 0)
  auto load = [&](int k) {
    const int s = k % kStages;
    expect_bytes(&full[s], kStageBytes);
    const int row0 = step_win[k0 + k];
    uint8_t* stage = win + s * kStageStride;
#pragma unroll
    for (int i = 0; i < kBS / kBoxRows; ++i) {
      tma_load(stage + i * kBoxRows * kSliceBytes, &map, col0, row0 + i * kBoxRows, &full[s]);
    }
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < steps && k < kStages; ++k) load(k);
  }

  const int pair = lane >> 1;             // the lane pair's row of each group of 16
  const int r = warp * 16 + pair;         // ... and of each destination block
  const int half = lane & 1;              // its 16 bytes of the slice
  float acc[kSB][kVec];
#pragma unroll
  for (int b = 0; b < kSB; ++b) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[b][i] = 0.f;
  }
  for (int k = 0; k < steps; ++k) {
    const int s = k % kStages;
    const int32_t* tiles = step_tile + static_cast<size_t>(k0 + k) * kSB;
    // lane b < kSB holds where the warp's group of tile b starts and its
    // longest row (tile t's group of rows 16 warp .. is t * kWarps + warp)
    int my_bp = 0, my_n = 0;
    if (lane < kSB) {
      const int t = __ldg(tiles + lane);
      if (t >= 0) {
        my_bp = __ldg(grp_ptr + static_cast<size_t>(t) * kWarps + warp);
        my_n = __ldg(grp_len + static_cast<size_t>(t) * kWarps + warp);
      }
    }
    int bp = __shfl_sync(0xffffffffu, my_bp, 0);
    int n = __shfl_sync(0xffffffffu, my_n, 0);
    uint4 first = make_uint4(0, 0, 0, 0);
    if (n > 0) first = __ldg(cols + static_cast<size_t>(bp) * 16 + pair);
    wait(&full[s], (k / kStages) & 1);
    const uint8_t* w = win + s * kStageStride + half * 16;
#pragma unroll
    for (int b = 0; b < kSB; ++b) {
      const int b0 = bp, n0 = n;
      const uint4 f0 = first;
      if (b + 1 < kSB) {  // the next tile's first batch loads during this walk
        bp = __shfl_sync(0xffffffffu, my_bp, b + 1);
        n = __shfl_sync(0xffffffffu, my_n, b + 1);
        if (n > 0) first = __ldg(cols + static_cast<size_t>(bp) * 16 + pair);
      }
      walk_rows<kBf16>(acc[b], w, cols, b0, n0, f0, pair);
    }
    __syncwarp();
    if (lane == 0) arrive(&empty[s]);
    if (threadIdx.x == 0 && k + kStages < steps) {
      wait(&empty[s], (k / kStages) & 1);
      load(k + kStages);
    }
  }
  const int col = col0 + half * kVec;
  if (col < f) {  // the last slice may be part-filled
    const size_t row_bytes = static_cast<size_t>(f) * kBytes;
#pragma unroll
    for (int b = 0; b < kSB; ++b) {
      const size_t row = (static_cast<size_t>(strip) * kSB + b) * kBD + r;
      if (row < static_cast<size_t>(n_out)) {  // the last strip may be part-filled
        *reinterpret_cast<uint4*>(out + row * row_bytes + static_cast<size_t>(col) * kBytes) =
            vec16::pack_vec<kBf16>(acc[b]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA library, looked up through the runtime
// (no -lcuda at link time).
EncodeTiled encode_tiled() {
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

template <bool kBf16>
cudaError_t launch(const CUtensorMap& map, const int32_t* grp_ptr, const int32_t* grp_len,
                   const uint4* cols, const int32_t* strip_ptr, const int32_t* step_win,
                   const int32_t* step_tile,
                   uint8_t* out, int n_strips, int n_out, int f, cudaStream_t stream) {
  auto kernel = strip_kernel<kBf16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  constexpr int kCols = kSliceBytes / Elem<kBf16>::kBytes;
  const dim3 grid((f + kCols - 1) / kCols, n_strips);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(map, grp_ptr, grp_len, cols, strip_ptr,
                                                   step_win, step_tile, out, n_out, f);
  return cudaGetLastError();
}

}  // namespace

// out[n_out, f] = A^T h from a layout's walk arrays (n_out a multiple of
// 256 in ((n_strips - 1) * 2048, n_strips * 2048]):
// grp_ptr int32 [T * 16 + 1], grp_len int32 [T * 16] and cols uint16
// [batches, 16, 8] (group g = rows 16 (g % 16) .. of tile g / 16: batches
// grp_ptr[g] .. grp_ptr[g + 1], each row's columns ascending, padded with
// 2048 to its longest row's grp_len[g]; 16-byte aligned), strip_ptr int32
// [n_strips + 1] (each strip's steps),
// step_win int32 [steps] (window start rows, multiples of 2048, ascending
// within a strip) and step_tile int32 [steps, 8] (each block's tile in that
// window, -1 for none). h [n_src, f] and out bf16 (is_bf16 = 1) or f32,
// row-major, 16-byte aligned, f a multiple of 8 (bf16) or 4 (f32), n_src a
// multiple of 2048. Launches on `stream` of CUDA device `device` and
// returns a cudaError_t code (0 on success); it does not synchronise.
extern "C" int adaqp_strip_spmm(const void* grp_ptr, const void* grp_len, const void* cols,
                                const void* strip_ptr, const void* step_win,
                                const void* step_tile, const void* h,
                                void* out, int n_strips, int n_out, int n_src, int f,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_strips <= 0 || f <= 0) return 0;
  if (n_out % kBD || n_out <= (n_strips - 1) * kSB * kBD || n_out > n_strips * kSB * kBD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t bytes = is_bf16 ? 2 : 4;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(f), static_cast<cuuint64_t>(n_src)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(f) * bytes};
  const cuuint32_t box[2] = {kSliceBytes / bytes, kBoxRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(h), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(grp_ptr);
  const auto* gl = static_cast<const int32_t*>(grp_len);
  const auto* cl = static_cast<const uint4*>(cols);
  const auto* sp = static_cast<const int32_t*>(strip_ptr);
  const auto* sw = static_cast<const int32_t*>(step_win);
  const auto* st = static_cast<const int32_t*>(step_tile);
  auto* op = static_cast<uint8_t*>(out);
  err = is_bf16 ? launch<true>(map, rp, gl, cl, sp, sw, st, op, n_strips, n_out, f, s)
                : launch<false>(map, rp, gl, cl, sp, sw, st, op, n_strips, n_out, f, s);
  return static_cast<int>(err);
}

// What the compiler gave the kernel: info[0..4] = registers a thread,
// static and dynamic shared bytes, local (spill) bytes a thread, columns a
// slice. Returns a cudaError_t code.
extern "C" int adaqp_strip_kernel_info(int is_bf16, int* info) {
  cudaFuncAttributes a;
  const void* kernel = is_bf16 ? reinterpret_cast<const void*>(strip_kernel<true>)
                               : reinterpret_cast<const void*>(strip_kernel<false>);
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes);
  info[2] = kSmemBytes;
  info[3] = static_cast<int>(a.localSizeBytes);
  info[4] = kSliceBytes / (is_bf16 ? 2 : 4);
  return 0;
}

extern "C" const char* adaqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
