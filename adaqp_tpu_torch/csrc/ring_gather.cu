// ring_gather for NVIDIA Hopper (sm_90a): rows gathered by index through a
// ring of in-flight bulk copies.
//
// It replaces the TPU kernel `kern` of scripts/microbench_dma_gather.py:72
// (mk_dma_gather): out[j] = h[idx[j]] for j < chunk, repeated over `iters`
// passes in one launch, with `depth` row copies in flight through a ring
// of VMEM slots, each with its own DMA semaphore. The question the probe
// asks is how fast the device gathers rows by index when a fixed number of
// row copies is kept in flight, against the library gather.
//
// What it computes is the function, not the TPU's block structure: the TPU
// copied the aligned 8-row tile that holds each row and picked the row out
// with a masked reduce, because Mosaic cannot slice one row of a tiled HBM
// buffer (the script's docstring). Here each copy moves one row.
//
// The design. One warp per thread block owns a contiguous range of
// rows_per_block output rows and walks k = 0 .. iters * rows - 1 (pass-major,
// as the TPU's k walked passes of the chunk). Shared memory holds `depth`
// ring slots of one row each, one mbarrier per slot, and the block's
// indices. Lane 0 fills slot k % depth with one cp.async.bulk global ->
// shared copy of row idx[k % rows] that completes on the slot's mbarrier
// (the counterpart of make_async_copy plus a DMA semaphore); the warp waits
// on that barrier (phase parity (k / depth) & 1), writes the slot to its
// output row with 16-byte stores, and lane 0 then refills the slot with copy
// k + depth. So each block keeps min(depth, rows * iters) row copies in
// flight, and the ring wraps across passes.
//
// The caller picks the grid (ring_plan in scripts/microbench_dma_gather.py):
// one block over the whole chunk is the reference's form, `depth` copies in
// flight for the stream; many blocks of a few rows each put
// blocks * min(depth, rows * iters) copies in flight. One warp's wait /
// store / re-issue loop bounds a block at some 360 cycles a row (1.6 ns a
// row warm at 32 rows a block, chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W), so the many-block form runs 4 rows a block, 1,024 blocks for
// 4,096 rows, and takes a block a row when there are fewer rows than SMs.
//
// What bounds it: bytes. Each row is read once and written once, with a
// 4-byte index: chunk * (2 * row_bytes + 4) bytes a pass, 0.31 ns a row for
// bf16 rows of 256 columns at 3.35 TB/s. Over `iters` passes the rows of a
// 4,096-row chunk (2 MiB in bf16) stay in the 50 MB L2 after the first
// pass; only a pass with L2 flushed speaks for a gather from a large table.
//
// A bulk copy needs a 16-byte-aligned source and destination and a size
// that is a multiple of 16 bytes: the wrapper raises on rows of another
// size or a misaligned base, and nothing falls back. The indices must lie
// in [0, n_rows): like the library's gather on the card, the kernel trusts
// them. The copies are asynchronous-proxy instructions in asm volatile, so
// no pass can be hoisted out of the loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// One row copy global -> shared that completes `bytes` of transaction on
// `bar`, after the issuing thread's arrival that expects them.
__device__ __forceinline__ void copy_row(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
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

// Shared memory: `depth` barriers, the block's indices, then the ring.
__host__ __device__ inline size_t rows_offset(int depth) {
  return (static_cast<size_t>(depth) * sizeof(uint64_t) + 15) / 16 * 16;
}
__host__ __device__ inline size_t ring_offset(int depth, int rows) {
  return (rows_offset(depth) + static_cast<size_t>(rows) * sizeof(int32_t) + 127) / 128 * 128;
}

__global__ void __launch_bounds__(kThreads)
ring_gather_kernel(const uint8_t* h, const int32_t* idx, uint8_t* out, int chunk, int iters,
                   int depth, int row_bytes, int rows_per_block) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + rows_offset(depth));
  uint8_t* ring = smem + ring_offset(depth, rows_per_block);
  const int lane = threadIdx.x;
  const int j0 = blockIdx.x * rows_per_block;
  const int nj = min(rows_per_block, chunk - j0);
  if (nj <= 0) return;
  for (int j = lane; j < nj; j += kThreads) rows[j] = idx[j0 + j];
  if (lane == 0) {
    for (int s = 0; s < depth; ++s) barrier_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncwarp();
  const long long total = static_cast<long long>(iters) * nj;
  const uint32_t bytes = static_cast<uint32_t>(row_bytes);
  // positions advance by increments: no division on the per-row path
  long long issued = 0;  // lane 0's copies so far; the next goes to row pj, slot ps
  int pj = 0, ps = 0;
  auto issue_next = [&]() {
    copy_row(ring + static_cast<size_t>(ps) * row_bytes,
             h + static_cast<size_t>(rows[pj]) * row_bytes, bytes, &bars[ps]);
    if (++ps == depth) ps = 0;
    if (++pj == nj) pj = 0;
    ++issued;
  };
  if (lane == 0) {
    while (issued < depth && issued < total) issue_next();
  }
  const int vecs = row_bytes / 16;
  int j = 0, slot = 0;
  uint32_t phase = 0;  // parity of the slots' current use: flips as the ring wraps
  for (long long k = 0; k < total; ++k) {
    while (!try_wait(&bars[slot], phase)) {
    }
    const uint4* src = reinterpret_cast<const uint4*>(ring + static_cast<size_t>(slot) * row_bytes);
    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(j0 + j) * row_bytes);
    for (int v = lane; v < vecs; v += kThreads) dst[v] = src[v];
    // every lane has read the slot before lane 0 hands it to the next copy
    __syncwarp();
    if (lane == 0 && issued < total) issue_next();
    if (++j == nj) j = 0;
    if (++slot == depth) {
      slot = 0;
      phase ^= 1;
    }
  }
}

}  // namespace

// Shared memory a launch takes: `depth` slots of `row_bytes` with their
// barriers and rows_per_block indices. The wrapper checks it against the
// card's 227 KB a block.
extern "C" size_t adaqp_ring_gather_smem(int depth, int row_bytes, int rows_per_block) {
  return ring_offset(depth, rows_per_block) + static_cast<size_t>(depth) * row_bytes;
}

// h [n_rows, row_bytes] (any element type, row_bytes a multiple of 16 and
// h 16-byte aligned); idx int32 [chunk] in [0, n_rows); out [chunk,
// row_bytes], 16-byte aligned; iters >= 1 passes, depth >= 1 copies in
// flight a block; `blocks` blocks of rows_per_block rows each (the last
// may hold fewer; blocks * rows_per_block >= chunk). Launches on `stream`
// of CUDA device `device` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a grid that does not cover the chunk; it
// does not synchronise.
extern "C" int adaqp_ring_gather(const void* h, const void* idx, void* out, int chunk,
                                 int iters, int depth, int row_bytes, int blocks,
                                 int rows_per_block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk <= 0) return 0;
  if (blocks < 1 || rows_per_block < 1 ||
      static_cast<long long>(blocks) * rows_per_block < chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = adaqp_ring_gather_smem(depth, row_bytes, rows_per_block);
  err = cudaFuncSetAttribute(ring_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_gather_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(h), static_cast<const int32_t*>(idx),
      static_cast<uint8_t*>(out), chunk, iters, depth, row_bytes, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_ring_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
