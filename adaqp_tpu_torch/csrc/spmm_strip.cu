// Strip bitmask SpMM for NVIDIA Hopper (sm_90a): out = A^T h over 0/1 tiles.
//
// Replaces the JAX package's TPU kernel ops/spmm_strip.py::_strip_kernel
// (launched by _run_strip_pallas). It computes what that kernel computes,
// not its grid:
//
//   for each destination row r of block b = r / 256, the sum over the
//   block's dense tiles t of h[tile_src[t] + j] for every set bit j of row
//   r % 256 of masks[t]; column j of a tile is halfword j % 128, bit
//   j / 128. The sum is taken in f32 and written in h's dtype. A block with
//   no tiles is written as zeros (the TPU kernel's flush-only path).
//
// Masks are in destination-block-major order (the layout sorts tiles by
// dst block, then source window), so blk_ptr[b] .. blk_ptr[b + 1] is block
// b's tile range. The ELL straggler edges are added outside, in PyTorch.
//
// What bounds it. The TPU kernel expands each tile into a dense 256 x 2048
// 0/1 matrix for the matrix unit. At the density of the benchmark graph
// (under 1% of a tile's bits are set) that dense product is over a hundred
// times the useful work, so this kernel walks the set bits instead: the
// work is one F-wide row add per edge, and the least time is the larger of
// (mask + h + out bytes) / 3.35 TB/s and (2 * edges * F) / 989 TFLOP/s (the
// card's bf16 rate with f32 accumulation); at the smoke and benchmark
// shapes the bytes bound it, most of them the masks.
//
// The design, simple first: a grid of (destination block, 32-lane column
// chunk), one warp per destination row (8 warps take every 8th row of the
// block), walking the row's set bits tile by tile (tile_walk.cuh, the walk
// this kernel shares with the block kernel, spmm_block.cu, and the compact
// kernel, spmm_compact.cu). For each set column every lane adds its 16-byte
// slice of h[src] into f32 registers. No shared memory and no atomics: each
// output element is summed by one thread in a fixed order (tile, then j),
// so the result does not change from run to run. h's windows are re-read
// from L2 once per row that uses them; keeping windows in shared memory
// (TMA) and using the tensor cores for dense tiles are the known next steps.
#include "tile_walk.cuh"

// out[n_blocks * 256, f] = A^T h. masks int16 [T, 256, 128]; tile_src int32
// [T] (window start rows); blk_ptr int32 [n_blocks + 1]; h and out bf16
// (is_bf16 = 1) or f32, row-major, 16-byte aligned, f a multiple of 8 (bf16)
// or 4 (f32). Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_strip_spmm(const void* masks, const void* tile_src,
                                const void* blk_ptr, const void* h, void* out,
                                int n_blocks, int f, int is_bf16, int device,
                                void* stream) {
  return tile_walk::launch_tile_range(masks, tile_src, blk_ptr, h, out, n_blocks, f,
                                      is_bf16, device, stream);
}

extern "C" const char* adaqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
