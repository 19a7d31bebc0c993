// Block bitmask SpMM for NVIDIA Hopper (sm_90a): out = A^T h over 0/1 tiles.
//
// Replaces the JAX package's TPU kernel ops/spmm_block.py::_block_kernel
// (launched by _run_block_pallas), the v1 tile kernel of spmm_impl=block:
//
//   for each destination row r of block b = r / 256, the sum over block
//   b's tiles t of h[src_start[t] + j] for every set bit j of row r % 256
//   of masks[t]; column j of a tile is halfword j % 128, bit j / 128. The
//   sum is taken in f32 and written in h's dtype. A block with no tile is
//   written as zeros.
//
// On Hopper it is the strip kernel's function. The TPU's block (v1) and
// strip (v3) kernels differ only in their schedule there: a source window
// DMA'd per tile against one reused across a strip of destination blocks.
// Both layouts hold the same tiles in destination-block order, so this
// kernel walks each block's tile range (blk_ptr, built on the host from
// dst_blk before any shard padding) with the walk of tile_walk.cuh, the one
// the strip kernel runs; a speed-up of the walk serves both. The block
// layout gives every destination block at least one (maybe all-zero) tile,
// as the TPU kernel needs to zero its output block; here those tiles cost
// one read of their mask rows.
//
// What bounds it. The larger of (mask + src_start + blk_ptr + h + out
// bytes) / 3.35 TB/s and (2 * edges * F) / 989 TFLOP/s (the card's bf16
// rate, f32 accumulation); at the smoke shapes the bytes bound it, most of
// them the masks. The design walks set bits instead of the TPU's dense
// 256 x 2048 product, whose work at under 1% density is a hundred times the
// useful adds (see spmm_strip.cu for the walk and its known next steps).
// The ELL straggler edges are added outside, in PyTorch.
#include "tile_walk.cuh"

// out[n_blocks * 256, f] = A^T h. masks int16 [T, 256, 128]; src_start int32
// [T] (window start rows); blk_ptr int32 [n_blocks + 1]; h and out bf16
// (is_bf16 = 1) or f32, row-major, 16-byte aligned, f a multiple of 8 (bf16)
// or 4 (f32). Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_block_spmm(const void* masks, const void* src_start,
                                const void* blk_ptr, const void* h, void* out,
                                int n_blocks, int f, int is_bf16, int device,
                                void* stream) {
  return tile_walk::launch_tile_range(masks, src_start, blk_ptr, h, out, n_blocks, f,
                                      is_bf16, device, stream);
}

extern "C" const char* adaqp_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
