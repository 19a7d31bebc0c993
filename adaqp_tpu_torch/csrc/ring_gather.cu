// ring_gather for NVIDIA Hopper (sm_90a): rows gathered by index through a
// ring of in-flight bulk copies on every SM.
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
// The design. The TPU's one program ran on the whole TensorCore; its
// counterpart here is one persistent block an SM (the caller's grid,
// ring_plan in scripts/microbench_dma_gather.py), and `depth` is the copies
// in flight a block. Block b owns the contiguous output rows
// [b * chunk / blocks, (b + 1) * chunk / blocks) and walks the items
// k = 0 .. iters * rows - 1 of its rows, pass-major (as the TPU's k walked
// passes of the chunk). Shared memory holds `depth` ring slots of one row
// each, one mbarrier a slot, and the block's indices. No row passes
// through registers: a row comes in by one cp.async.bulk global -> shared
// copy that completes on its slot's mbarrier, and goes out by one
// cp.async.bulk shared -> global copy in a bulk group of its own. The
// block's ring is split among `issuers` warps, of which one thread each
// runs: issuer w takes the items k = w (mod issuers) and the slots
// s = w (mod issuers), so the block still keeps min(depth, iters * rows)
// copies in flight. For each item it waits on the slot's barrier, issues
// the store and commits it, then refills the slot of its previous item
// once cp.async.bulk.wait_group.read 1 says that item's store has read it
// (with one slot, its only item's store: wait_group.read 0). A row costs
// its thread a handful of instructions, yet an issuing thread moves about
// one row each 250 ns, however many slots it has: refilling a slot
// half a ring after its store, or leaving out the proxy fence before a
// store, changed nothing measurable. So the issuers set an SM's pace: warm
// at depth 64, 1 issuer 1.92 ns a row, 4 0.50, 8 0.28, 16 0.18-0.19
// (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's gather timing), where
// the L2 that holds a warm pass's rows takes over: 32 were slower
// (0.198-0.209), hence up to 16 warps a block.
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

constexpr int kMaxIssuers = 16;  // warps a block at most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// One row copy global -> shared that completes `bytes` of transaction on
// `bar`, after the issuing thread's arrival that expects them.
__device__ __forceinline__ void load_row(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// One row copy shared -> global, committed as a bulk group of its own.
__device__ __forceinline__ void store_row(void* dst, const void* src, uint32_t bytes) {
  // the slot was written by the asynchronous proxy and is read by it: order
  // the barrier's observation before the store's read
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
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

__global__ void __launch_bounds__(kMaxIssuers * 32)
ring_gather_kernel(const uint8_t* h, const int32_t* idx, uint8_t* out, int chunk, int iters,
                   int depth, int row_bytes, int max_rows, int issuers) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + rows_offset(depth));
  uint8_t* ring = smem + ring_offset(depth, max_rows);
  const long long b = blockIdx.x;
  const int j0 = static_cast<int>(b * chunk / gridDim.x);
  const int nj = static_cast<int>((b + 1) * chunk / gridDim.x) - j0;
  if (nj <= 0) return;
  for (int j = threadIdx.x; j < nj; j += blockDim.x) rows[j] = idx[j0 + j];
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) barrier_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const long long total = static_cast<long long>(iters) * nj;
  if ((threadIdx.x & 31) != 0 || w >= issuers || w >= total) return;
  // issuer w: items w, w + issuers, ... (n of them) through its d slots
  // w, w + issuers, ...; both cursors advance by increments, with no
  // division on the per-row path
  const long long n = (total - 1 - w) / issuers + 1;
  const int d = (depth - 1 - w) / issuers + 1;
  const uint32_t bytes = static_cast<uint32_t>(row_bytes);
  const size_t slot_step = static_cast<size_t>(issuers) * row_bytes;
  uint8_t* const ring_w = ring + static_cast<size_t>(w) * row_bytes;
  uint64_t* const bars_w = bars + w;
  int lrow = w % nj, lq = 0;  // the next load: its row in the block, its slot
  long long loaded = 0;
  auto load_next = [&]() {
    load_row(ring_w + lq * slot_step, h + static_cast<size_t>(rows[lrow]) * row_bytes, bytes,
             bars_w + lq * issuers);
    if (++lq == d) lq = 0;
    lrow += issuers;
    while (lrow >= nj) lrow -= nj;
    ++loaded;
  };
  while (loaded < d && loaded < n) load_next();
  int srow = w % nj, sq = 0;  // the next store: its row, its slot
  uint32_t phase = 0;         // parity of the slots' current use: flips as the ring wraps
  for (long long m = 0; m < n; ++m) {
    while (!try_wait(bars_w + sq * issuers, phase)) {
    }
    store_row(out + static_cast<size_t>(j0 + srow) * row_bytes, ring_w + sq * slot_step, bytes);
    if (loaded < n) {
      if (d == 1) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        load_next();
      } else if (m >= 1) {
        // the previous item's store has read its slot: refill that slot
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load_next();
      }
    }
    srow += issuers;
    while (srow >= nj) srow -= nj;
    if (++sq == d) {
      sq = 0;
      phase ^= 1;
    }
  }
  // the slots stay valid until every store has read them
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// Shared memory a launch takes: `depth` slots of `row_bytes` with their
// barriers and max_rows indices. The wrapper checks it against the card's
// 227 KB a block.
extern "C" size_t adaqp_ring_gather_smem(int depth, int row_bytes, int max_rows) {
  return ring_offset(depth, max_rows) + static_cast<size_t>(depth) * row_bytes;
}

// h [n_rows, row_bytes] (any element type, row_bytes a multiple of 16 and
// h 16-byte aligned); idx int32 [chunk] in [0, n_rows); out [chunk,
// row_bytes], 16-byte aligned; iters >= 1 passes, depth >= 1 copies in
// flight a block; `blocks` blocks, block b owning rows [b * chunk / blocks,
// (b + 1) * chunk / blocks), none more than max_rows; `issuers` (1 to 16,
// at most depth) warps a block issue the copies. Launches on `stream` of
// CUDA device `device` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a grid that does not fit the chunk; it does
// not synchronise.
extern "C" int adaqp_ring_gather(const void* h, const void* idx, void* out, int chunk,
                                 int iters, int depth, int row_bytes, int blocks,
                                 int max_rows, int issuers, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk <= 0) return 0;
  if (blocks < 1 || blocks > chunk || max_rows < (chunk + blocks - 1) / blocks ||
      issuers < 1 || issuers > kMaxIssuers || issuers > depth || iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = adaqp_ring_gather_smem(depth, row_bytes, max_rows);
  err = cudaFuncSetAttribute(ring_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_gather_kernel<<<blocks, issuers * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(h), static_cast<const int32_t*>(idx),
      static_cast<uint8_t*>(out), chunk, iters, depth, row_bytes, max_rows, issuers);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_ring_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
