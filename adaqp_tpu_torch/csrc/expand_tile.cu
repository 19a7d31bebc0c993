// expand_spmm for NVIDIA Hopper (sm_90a): block bitmask SpMM through dense
// 0/1 tiles on the tensor cores, by wgmma.
//
// It replaces the TPU kernel `kernel` of scripts/microbench_expand.py:48
// (make_run, called at :149): one pass out = A^T h over a block layout,
// where each [256, 2048] tile's int16 mask [256, 128] is expanded into a
// 0/1 bf16 matrix `a` (column j is bit j / 128 of halfword j % 128, the
// tiling of pltpu.repeat) and `a @ window` is added into an f32
// accumulator of the destination block, written once as bf16. The four
// variants compute `a` four ways:
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
// 27x more time than moving the masks, h and out once at 3.35 TB/s.
//
// The design, Hopper's warp-specialised shape:
// - A CTA owns one (destination block, 128-column chunk of F): all 256
//   rows, so each window slice is fetched once for each tile and chunk.
//   The block runs along grid x and the chunk along grid y, so the CTAs
//   that run at once read one chunk's columns of h.
// - 384 threads. Warpgroups 0 and 1 consume, 128 destination rows each:
//   two wgmma.mma_async.m64n128k16 a k16 step, 128 f32 sums a thread in
//   registers (setmaxnreg 232). Warpgroup 2 produces: one thread issues
//   every TMA load, the warpgroup gives its registers up (setmaxnreg 40).
// - B, a K-step's window slice, is 64 source rows x 128 columns of h, by
//   TMA with the 128-byte swizzle: 16 KB a stage (columns 64.. 8 KB after
//   columns 0..), in a ring of kStages stages on full/empty mbarriers, so
//   the producer runs up to kStages K-steps ahead. h is row-major, so B is
//   MN-major: wgmma's transposed-B form, its descriptor LBO 8 KB (the next
//   64 columns) and SBO 1 KB (the next 8 rows).
// - A never passes through shared memory: wgmma takes it from registers.
//   A tile's 32 K-steps run half (64 halfwords), word group (16 halfwords
//   of the half) and bit quad (4 bits) from outer to inner: K-step g holds
//   k16 steps kk = 0..3, bit 4 (g % 4) + kk of the group's halfwords, so its
//   B slice is four 16-row pieces of the window (source rows bit * 128 +
//   half * 64 + group * 16 + [0, 16)), one 64 x 16 box each per 64
//   columns, and a piece's rows sit at kk * 2 KB as a k16 step's descriptor
//   reads them. A thread's fragment holds rows 16 warp + lane / 4 (and + 8)
//   of its m64 tile and columns 2 (lane % 4) (+ 1, + 8, + 9) of the group;
//   columns c and c + 1 are the two halves of one 32-bit mask word, so one
//   32-bit register of `a` comes from one word, and a thread's 8 words of a
//   group serve its 4 K-steps (16 bits). It reads them from a copy of the
//   half tile (256 rows x 64 halfwords, 32 KB, 128-byte swizzle) that the
//   producer stages by TMA in a ring of two. 8 words a thread, not a half's
//   32, keep the sums, two fragment sets and the words within the registers.
// - Expansion overlaps the products: the fragment of k16 step kk is built
//   while step kk - 1's wgmmas run, in a register set of its own (ptxas
//   keeps v0-v2's four apart), and wgmma.wait_group 1 after each commit
//   lets at most one step's pair run behind. A window stage goes back to
//   the producer after the first wait of the next K-step, when no wgmma
//   reads it any more. Only the producer's waits trap on a lost arrival:
//   a trap on the consumers' path held ptxas to the launch's 168 registers
//   a thread, which spilled and serialised every wgmma.
// - The f32 sums are rounded once to bf16 and stored; a destination block
//   without tiles writes zeros.
// The mbarrier, TMA, wgmma and expansion helpers live in hopper_mma.cuh,
// which compact_item.cu shares.
//
// The wrapper (scripts/microbench_expand.py::expand_spmm) takes only bf16
// h with F a multiple of 128 and a square layout, and raises on anything
// else.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int BD = 256;         // destination rows of a tile
constexpr int WORDS = 128;      // halfwords of a tile row
constexpr int kCols = 128;      // columns of F a CTA
constexpr int kK = 64;          // source rows of a K-step
constexpr int kTileSteps = 32;  // K-steps a tile: 2 halves x 4 word groups x 4 bit quads
constexpr int kGroup = 16;      // halfwords of a word group
constexpr int kStages = 6;      // window slices in flight
constexpr int kBoxCols = 64;    // a box of h: 64 columns (128 bytes) x 16 rows
constexpr int kStageBytes = kK * kCols * 2;         // 16 KB
constexpr int kPieceBytes = kGroup * kBoxCols * 2;  // 2 KB: one box
constexpr int kHalfBytes = BD * (WORDS / 2) * 2;    // 32 KB: 256 rows x 64 halfwords
constexpr int kMaskStages = 2;
constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kMTiles = BD / 64 / kConsumers;       // m64 tiles a consumer warpgroup
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// setmaxnreg moves registers within the CTA's allocation: the kernel must
// start with at least this many a thread (ptxas gives 168 at 384 threads)
constexpr int kRegsAtLaunch = (kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs) / kThreads;
// + 1 KB to align the rings to the 128-byte swizzle's 1 KB pattern
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + kMaskStages * kHalfBytes;

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
expand_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap mmap,
              const int32_t* __restrict__ src_start, const int32_t* __restrict__ blk_ptr,
              __nv_bfloat16* __restrict__ out, int f) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(8) uint64_t mfull[kMaskStages], mempty[kMaskStages];
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* mring = ring + kStages * kStageBytes;

  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * kCols;
  const int t0 = blk_ptr[blk];
  const int steps = (blk_ptr[blk + 1] - t0) * kTileSteps;
  // the warpgroup, warp-uniform by construction, as the .sync.aligned
  // setmaxnreg of each role's branch needs
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], kConsumers);  // one thread a consumer warpgroup
    }
    for (int s = 0; s < kMaskStages; ++s) {
      barrier_init(&mfull[s], 1);
      barrier_init(&mempty[s], kConsumers * 4);  // one lane a consumer warp
    }
    // the barriers' initialisation is seen by the TMA unit's arrivals
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- the producer: one thread keeps the rings full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t phase = 0;
      int row_base = 0;
      for (int g = 0; g < steps; ++g) {
        const int i = g & (kTileSteps - 1);
        const int tile = t0 + g / kTileSteps;
        if (i == 0) row_base = src_start[tile];
        const int half = i >> 4;
        if ((i & 15) == 0) {  // a new half tile: its masks into mask stage hm % 2
          const int hm = g >> 4;
          const int ms = hm & 1;
          wait<true>(&mempty[ms], ((hm >> 1) & 1) ^ 1);
          expect_bytes(&mfull[ms], kHalfBytes);
          tma_load(mring + ms * kHalfBytes, &mmap, half * (WORDS / 2), tile * BD, &mfull[ms]);
        }
        wait<true>(&empty[s], phase ^ 1);
        expect_bytes(&full[s], kStageBytes);
        // piece kk: the 16 rows of bit 4 * quad + kk, word group `group`
        const int row0 = row_base + (4 * (i & 3)) * WORDS + half * (WORDS / 2) +
                         ((i >> 2) & 3) * kGroup;
        uint8_t* stage = ring + s * kStageBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tma_load(stage + kk * kPieceBytes, &hmap, f0, row0 + kk * WORDS, &full[s]);
          tma_load(stage + kStageBytes / 2 + kk * kPieceBytes, &hmap, f0 + kBoxCols,
                   row0 + kk * WORDS, &full[s]);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- the consumers: kMTiles m64 tiles of rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x & 127;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int quad = lane & 3;
    const int r8 = lane >> 2;
    // this thread's first row of the block (+ m * 64 + rr * 8)
    const int row_a = wg * kMTiles * 64 + warp * 16 + r8;

    float acc[kMTiles][64];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
      fence_sums(acc[m]);
    }
    uint32_t words[kMTiles][2][2];  // [m][row + 8 rr][column + 8 j]
    uint32_t a[2][kMTiles][4];      // two fragment sets: [set][m][register]
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int g = 0; g < steps; ++g) {
      const int i = g & (kTileSteps - 1);
      const int group = (i >> 2) & 3;  // the word group of this half
      if ((i & 3) == 0) {  // a new word group: this thread's 8 mask words
        const int hm = g >> 4;
        const int ms = hm & 1;
        if (group == 0) wait<false>(&mfull[ms], (hm >> 1) & 1);
        const uint8_t* mb = mring + ms * kHalfBytes;
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // 128-byte rows; the swizzle moves 16-byte chunk c to c ^ (row % 8)
              const int r = row_a + m * 64 + rr * 8;
              words[m][rr][j] = *reinterpret_cast<const uint32_t*>(
                  mb + r * 128 + (((2 * group + j) ^ r8) << 4) + 4 * quad);
            }
        if (group == 3) {
          // the half's last words are in registers: the stage may be
          // refilled (by the async proxy, after these generic reads)
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (lane == 0) arrive(&mempty[ms]);
        }
      }
      const uint32_t stage = smem_u32(ring + s * kStageBytes);
      // v3's fragment does not depend on the bit: ptxas folds a K-step's four
      // into one register set, which this step would rewrite while the last
      // step's final wgmmas still read it, so v3 drains them first
      if constexpr (V == 3) wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int bit = 4 * (i & 3) + kk;
        uint32_t(&frag)[kMTiles][4] = a[kk & 1];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          frag[m][0] = expand_pair<V>(words[m][0][0], bit);
          frag[m][1] = expand_pair<V>(words[m][1][0], bit);
          frag[m][2] = expand_pair<V>(words[m][0][1], bit);
          frag[m][3] = expand_pair<V>(words[m][1][1], bit);
        }
        if (kk == 0) wait<false>(&full[s], phase);  // the first fragment is built meanwhile
        wgmma_fence();
        // piece kk's 16 rows
        const uint64_t desc = b_desc(stage + kk * kPieceBytes, kStageBytes / 2);
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) wgmma_n128(acc[m], frag[m], desc, 1);
        wgmma_commit();
        wgmma_wait<1>();  // step kk - 1's group is done: its set may be rewritten
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) fence_sums(acc[m]);
        // after the first wait of a K-step no wgmma reads the last step's stage
        if (kk == 0 && g > 0 && ct == 0) arrive(&empty[prev]);
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) fence_sums(acc[m]);

    const int64_t row0 = static_cast<int64_t>(blk) * BD + row_a;
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int col = f0 + j * 8 + 2 * quad;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = row0 + m * 64 + rr * 8;
          reinterpret_cast<__nv_bfloat162*>(out + row * f + col)[0] =
              __floats2bfloat162_rn(acc[m][4 * j + 2 * rr], acc[m][4 * j + 2 * rr + 1]);
        }
      }
    }
  }
}

// Each kernel's attributes set and its register count checked, once a
// device (bit d of the mask: device d; a device past 31 checks every call).
template <int V>
cudaError_t prepare(int device) {
  static uint32_t ready = 0;
  const uint32_t bit = device < 32 ? (1u << device) : 0u;
  if (ready & bit) return cudaSuccess;
  auto kernel = expand_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // fewer registers at launch and setmaxnreg.inc would wait forever
  if (attr.numRegs < kRegsAtLaunch) return cudaErrorInvalidConfiguration;
  ready |= bit;
  return cudaSuccess;
}

template <int V>
cudaError_t launch(const CUtensorMap& hmap, const CUtensorMap& mmap, const int32_t* src_start,
                   const int32_t* blk_ptr, int n_blocks, __nv_bfloat16* out, int f, int device,
                   cudaStream_t stream) {
  cudaError_t err = prepare<V>(device);
  if (err != cudaSuccess) return err;
  expand_kernel<V><<<dim3(n_blocks, f / kCols), kThreads, kSmemBytes, stream>>>(
      hmap, mmap, src_start, blk_ptr, out, f);
  return cudaGetLastError();
}

}  // namespace

// The two TMA maps a call reads, into maps[0..255] (two CUtensorMaps, any
// alignment): h bf16 [n_src, f] (boxes of 64 columns x 16 rows) and masks
// int16 [mask_rows, 128] (the tiles' rows; boxes of 64 halfwords x 256
// rows). Both 16-byte aligned, f a multiple of 128. Returns a cudaError_t
// code.
extern "C" int adaqp_expand_maps(const void* h, long long n_src, int f, const void* masks,
                                 long long mask_rows, void* maps) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if (f <= 0 || f % kCols || n_src <= 0 || mask_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap m[2];
  if (!encode_2d(encode, &m[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, f, n_src, kBoxCols,
                 kGroup) ||
      !encode_2d(encode, &m[1], CU_TENSOR_MAP_DATA_TYPE_UINT16, masks, WORDS, mask_rows,
                 WORDS / 2, BD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(maps, m, sizeof(m));
  return 0;
}

// out bf16 [n_blocks * 256, f] from the maps of adaqp_expand_maps, src_start
// int32 [T] and blk_ptr int32 [n_blocks + 1] (tiles blk_ptr[b] ..
// blk_ptr[b + 1] belong to destination block b; T >= 1, as the masks' map
// needs); a CTA for each destination block and 128-column chunk of f.
// variant 0..3 (v0..v3). Launches on `stream` of CUDA device `device` (made
// current if it is not) and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an f, block count or variant it does not take;
// it does not synchronise.
extern "C" int adaqp_expand_spmm(const void* maps, const void* src_start, const void* blk_ptr,
                                 int n_blocks, void* out, int f, int variant, int device,
                                 void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f <= 0 || f % kCols || f / kCols > 65535 || n_blocks < 0 || variant < 0 || variant > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof(m));
  const auto* ss = static_cast<const int32_t*>(src_start);
  const auto* bp = static_cast<const int32_t*>(blk_ptr);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(m[0], m[1], ss, bp, n_blocks, o, f, device, s));
    case 1: return static_cast<int>(launch<1>(m[0], m[1], ss, bp, n_blocks, o, f, device, s));
    case 2: return static_cast<int>(launch<2>(m[0], m[1], ss, bp, n_blocks, o, f, device, s));
    default: return static_cast<int>(launch<3>(m[0], m[1], ss, bp, n_blocks, o, f, device, s));
  }
}

extern "C" const char* adaqp_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
