// compact_item for NVIDIA Hopper (sm_90a): the cost model of one compact
// work item -- mask expansion, then bf16 products into f32 sums, by wgmma.
//
// It replaces the TPU kernel `kern` of scripts/microbench_gather.py:212
// (mk_item, called at :253). A is the 0/1 expansion of a [256, 128]
// halfword mask: A[r, l] is bit l / 128 of halfword mask[r, l % 128]
// (pltpu.repeat tiles the 128 halfwords 16 times; the convention of every
// tile layout of the port), computed as (w >> bit) & 1, to f32, to bf16,
// the TPU's .astype(f32).astype(bf16). With win bf16 [2048, fc] and f32
// sums of [2048, fc], each of `iters` iterations expands A again and adds
//   kind 0: A @ win into rows 0..255;
//   kind 1: for s < 8, A[:, 256s : 256s + 256] @ win[col[256s : 256s + 256]]
//           into rows 256s..256s + 255 (the row gather win[col] happens
//           inside the kernel);
// then the sums are rounded once to bf16. The TPU kernel never zeroes its
// VMEM accumulator (microbench_gather.py:211-238); here it starts at zero,
// so kind 0's rows 256..2047 are zero.
//
// What bounds it: one item reads the mask, col and win once and writes out
// once (about 2.1 MB at fc = 256) and does 2 * 256 * 2048 * fc flops an
// iteration at 989 TFLOP/s (bf16 in, f32 sums): one iteration is bound by
// bytes, 200 by operations (0.407 us an iteration at fc = 384).
//
// The design. One work unit serves both kinds: slice s of the depth is A's
// columns 256s..256s + 255, bits 2s and 2s + 1 of all 128 halfwords: kind
// 1's subtile s and the s-th eighth of kind 0's depth. A CTA owns a unit
// (slice, 128-column chunk of fc, 64-row share of A) of a grid (8 slices,
// chunks, 4 shares): 96 CTAs at fc 384 and 64 at fc 256, for either kind.
// - 256 threads: warpgroup 0 multiplies (wgmma.mma_async m64n128k16, A
//   from registers, B from shared memory); warpgroup 1 stages B.
// - A's 0/1 values never pass through shared memory. Each consumer thread
//   stages its 32 mask words once (rows 16 warp + lane / 4 and + 8 of the
//   share; words 8g + lane % 4 and + 4 of each 16-halfword group g: wgmma's
//   A fragment layout, as in expand_tile.cu) in shared memory of its own,
//   and every iteration reads and expands them again in registers, k16
//   step kk at bit 2s + kk / 8 of group kk % 8. A stage's four steps are
//   one commit group of four wgmmas; the next stage's fragments are built
//   while they run.
// - B, 64 depth rows x 128 columns a stage (16 KB), comes into a ring of 8
//   stages in the 128-byte-swizzled layout of a TMA box of 64 columns
//   (wgmma's descriptor: MN-major, the second 64 columns 8 KB on). Kind 0's
//   rows win[256s + ...] are contiguous: two TMA boxes a stage, issued by
//   one thread. Kind 1's rows win[col[...]] are gathered by the producer
//   warpgroup's 128 threads in 16-byte cp.async pieces at the swizzled
//   addresses (Hopper's TMA has no row gather); each lane's arrival on the
//   stage's barrier comes when its copies have landed
//   (cp.async.mbarrier.arrive), and the consumers fence the async proxy
//   after their wait. B is staged again every iteration, and kind 1
//   gathers it again.
// - Each iteration's product is summed from zero in registers of its own
//   (an iteration's first wgmma ignores its input) and then added into the
//   running f32 sums, as the TPU's acc += jnp.dot(...). Nothing leaves the
//   loop: the copies are issued every iteration, the mask words are read
//   from shared memory every step, the products are asm volatile.
// - Kind 1 rounds its sums to bf16 and stores them into rows 256s + 64 share
//   + .... Kind 0's 8 slices of one (chunk, share) form a cluster of 8 CTAs.
//   A slice's running sum grows to `iters` times its product while the 8
//   slices' sums may cancel to a small total, so kind 0 keeps each as a
//   pair of floats (TwoSum: the f32 sum and its rounding error). After the
//   last iteration each CTA stores the pairs' f64 values into the shared
//   memory of the CTA that owns their rows (CTA q owns rows 8q..8q + 7 of the
//   share; distributed shared memory, a slot a slice), one cluster barrier
//   follows, and each CTA adds its rows over the 8 slots in slice order, in
//   f64, and rounds them once; its producer warpgroup writes zeros into its
//   56 of rows 256..2047. (Plain f32 sums per slice broke the tolerance on
//   outputs near zero at 200 iterations; reading the sums from the other
//   CTAs instead, with a second barrier, made one iteration markedly slower
//   on an H100.)
// - The consumers' waits do not trap (hopper_mma.cuh: a trap there held
//   expand_tile.cu to its launch's registers and serialised its wgmmas);
//   they give up after kMaxPolls polls instead of hanging.
//
// The wrapper (scripts/microbench_gather.py::compact_item) passes win with
// a row stride `ld` that is a multiple of 8 (16 bytes, as TMA and the
// 16-byte pieces need), copying it padded where fc is not.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int BD = 256;                   // mask rows
constexpr int kMaskWords = 64;            // 32-bit words a mask row (128 halfwords)
constexpr int kSlices = 8;                // 256-column slices of A's 2,048
constexpr int kSliceK = 256;              // depth a slice
constexpr int kRows = 64;                 // rows of A a CTA: one m64 tile
constexpr int kShares = BD / kRows;       // 4
constexpr int kCols = 128;                // columns of fc a CTA
constexpr int kK = 64;                    // depth rows a stage
constexpr int kStagesIter = kSliceK / kK;  // 4 stages an iteration
constexpr int kStages = 8;                // the ring: two iterations' B
constexpr int kBoxCols = 64;              // a box of win: 64 columns (128 bytes) x 64 rows
constexpr int kStageBytes = kK * kCols * 2;     // 16 KB
constexpr int kHalfBytes = kStageBytes / 2;     // a stage's 64 columns
constexpr int kPieceBytes = 16 * kBoxCols * 2;  // 2 KB: a k16 step's rows of a half
constexpr int kThreads = 256;  // a consumer warpgroup and a producer warpgroup
constexpr int kRedStride = kCols + 8;  // f64 sums a row of kind 0's reduction buffer
constexpr int kWordBytes = 8 * 128 * 16;  // the consumers' mask words: 16 bytes a group a thread
constexpr int kZeroRows = (kSlices * BD - BD) / (kSlices * kShares);  // 56 a CTA

// + 1 KB to align the ring to the 128-byte swizzle's 1 KB pattern
constexpr size_t smem_bytes(int kind) {
  return 1024 + kStages * kStageBytes + kWordBytes + (kind == 0 ? kRows * kRedStride * 8 : 0);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
// an arrival on `bar` once this thread's cp.asyncs so far have landed (the
// barrier counts it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// orders the generic-proxy writes this thread has acquired before its
// wgmmas' (async-proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// every thread of the cluster, each warp converged
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// The consumers' wait: no trap (see hopper_mma.cuh), but it gives up after
// kMaxPolls polls, so that a lost arrival that the producer's guarded waits
// cannot see (a run of fewer stages than the ring holds) gives wrong sums
// that the comparisons catch instead of a hung card.
__device__ __forceinline__ void wait_bounded(uint64_t* bar, uint32_t parity) {
  for (uint32_t i = 0; i < kMaxPolls && !try_wait(bar, parity); ++i) {
  }
}

// The four fragments of a stage: k16 steps at bit `bit` of word groups g0
// .. g0 + 3, from this thread's staged words (slot g at words[128 g]).
__device__ __forceinline__ void build_stage(uint32_t (&f)[4][4], const uint4* words, int bit,
                                            int g0) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 w = words[(g0 + k) * 128];
    f[k][0] = expand_pair<0>(w.x, bit);
    f[k][1] = expand_pair<0>(w.y, bit);
    f[k][2] = expand_pair<0>(w.z, bit);
    f[k][3] = expand_pair<0>(w.w, bit);
  }
}

__device__ __forceinline__ uint16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
compact_item_kernel(const __grid_constant__ CUtensorMap wmap, const uint32_t* __restrict__ mask,
                    const int32_t* __restrict__ col, const uint16_t* __restrict__ win,
                    uint16_t* __restrict__ out, int fc, int ld, int iters) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint4* words = reinterpret_cast<uint4*>(ring + kStages * kStageBytes);  // [group][thread]
  // kind 0: the sums of this CTA's 8 rows of the share from each slice, [slice][row]
  double* red = reinterpret_cast<double*>(ring + kStages * kStageBytes + kWordBytes);

  const int s = blockIdx.x;             // the slice
  const int c0 = blockIdx.y * kCols;    // the chunk's first column
  const int share = blockIdx.z;         // the 64 rows of A
  const int stages = iters * kStagesIter;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      barrier_init(&full[i], kKind == 0 ? 1 : 128);  // the TMA thread, or each gatherer
      barrier_init(&empty[i], 1);                   // one consumer thread
    }
    // the barriers' initialisation is seen by the TMA unit's arrivals
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {
    // ---- the producer warpgroup: B into the ring, stage g of slice s's
    // depth rows 64 (g % 4).. ----
    const int pt = threadIdx.x - 128;  // the producer's thread
    if constexpr (kKind == 0) {
      if (pt == 0) {
        const bool two = c0 + kBoxCols < ld;  // columns past ld read as zeros
        int st = 0;
        uint32_t phase = 0;
        for (int g = 0; g < stages; ++g) {
          wait<true>(&empty[st], phase ^ 1);
          expect_bytes(&full[st], two ? kStageBytes : kHalfBytes);
          const int r0 = s * kSliceK + (g % kStagesIter) * kK;
          uint8_t* stage = ring + st * kStageBytes;
          tma_load(stage, &wmap, c0, r0, &full[st]);
          if (two) tma_load(stage + kHalfBytes, &wmap, c0 + kBoxCols, r0, &full[st]);
          if (++st == kStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
      // kind 0's zero rows: 56 of rows 256..2047, this CTA's columns, 16
      // bytes a store where the rows allow it
      const int64_t z0 = BD + (share * kSlices + s) * kZeroRows;
      const int width = min(kCols, fc - c0);
      if (fc % 8 == 0) {
        for (int e = pt; e < kZeroRows * (width / 8); e += 128) {
          const int r = e / (width / 8), c = e % (width / 8);
          *reinterpret_cast<uint4*>(out + (z0 + r) * fc + c0 + 8 * c) = make_uint4(0, 0, 0, 0);
        }
      } else {
        for (int r = 0; r < kZeroRows; ++r) {
          for (int c = pt; c < width; c += 128) out[(z0 + r) * fc + c0 + c] = 0;
        }
      }
    } else {
      // warp w of the four gathers rows 16w..16w + 15 of a stage: its lanes
      // 0-15 and 16-31 alternate rows, each lane one 16-byte piece (8
      // columns) of a row; a piece past ld stays unloaded, since it only
      // feeds columns that are never written. (One warp alone kept too few
      // copies in flight: the group item ran at half the full item's speed.)
      const int sub = lane >> 4, piece = lane & 15, t0 = (warp - 4) * 16;
      const bool live = c0 + piece * 8 < ld;
      const uint32_t dst0 = smem_u32(ring) + (piece >> 3) * kHalfBytes;
      const uint16_t* src0 = win + c0 + piece * 8;
      int st = 0;
      uint32_t phase = 0;
      for (int g = 0; g < stages; ++g) {
        wait<true>(&empty[st], phase ^ 1);
        // the warp's 16 row indices in one coalesced load, handed out by
        // shuffles: a load between the copies would wait for each copy's
        // issue (they are asm with a memory clobber)
        const int rv = __ldg(col + s * kSliceK + (g % kStagesIter) * kK + t0 + piece);
        const uint32_t stage = dst0 + st * kStageBytes;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = __shfl_sync(0xffffffffu, rv, 2 * i + sub);
          const int t = t0 + 2 * i + sub;
          // the 128-byte swizzle moves 16-byte chunk c of row t to c ^ (t % 8)
          if (live) {
            cp_async16(stage + t * 128 + (((piece & 7) ^ (t & 7)) << 4),
                       src0 + static_cast<int64_t>(r) * ld);
          }
        }
        // the lane's arrival, once its copies so far have landed
        cp_async_arrive(&full[st]);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- the consumer warpgroup: the share's 64 rows x 128 columns ----
    const int quad = lane & 3;
    const int row = warp * 16 + (lane >> 2);  // this thread's first row of the share (and + 8)
    // this thread's 32 mask words, staged once: word group g's four (rows
    // row and row + 8, words 8g + quad and + 4) as one 16-byte slot, in the
    // order of the fragment's registers
    uint4* wmine = words + threadIdx.x;
    const uint32_t* mrow = mask + static_cast<int64_t>(share * kRows + row) * kMaskWords;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const uint32_t* m = mrow + g * 8 + quad;
      wmine[g * 128] = make_uint4(m[0], m[8 * kMaskWords], m[4], m[8 * kMaskWords + 4]);
    }

    // kind 0 keeps each sum as acc + lo (TwoSum): a slice's sum grows to
    // `iters` times its product, and the 8 slices' sums may cancel down
    // to a small total, which the rounding of plain f32 sums of that size
    // would swamp; kind 1's rows are one slice's own sums
    float acc[64], prod[64], lo[kKind == 0 ? 64 : 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = prod[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kKind == 0 ? 64 : 1); ++i) lo[i] = 0.f;
    // two sets of a stage's four fragments: one stage's wgmmas run while
    // the next stage's fragments are built
    uint32_t a[2][4][4];
    build_stage(a[0], wmine, 2 * s, 0);
    int st = 0, prev = 0;
    uint32_t phase = 0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int q = 0; q < kStagesIter; ++q) {
        wait_bounded(&full[st], phase);
        if constexpr (kKind == 1) fence_proxy_async();  // B came by cp.async
        wgmma_fence();
        const uint32_t stage = smem_u32(ring + st * kStageBytes);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // the iteration's first step starts its sums from zero
          wgmma_n128(prod, a[q & 1][k], b_desc(stage + k * kPieceBytes, kHalfBytes), q | k);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before is done: its stage and fragment set are free
        fence_sums(prod);
        if ((it > 0 || q > 0) && threadIdx.x == 0) arrive(&empty[prev]);
        prev = st;
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
        // stage q + 1's fragments (the next iteration's first at q = 3)
        build_stage(a[(q + 1) & 1], wmine, 2 * s + ((q + 1) % kStagesIter) / 2,
                    4 * ((q + 1) % 2));
      }
      wgmma_wait<0>();
      fence_sums(prod);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if constexpr (kKind == 0) {
          const float sum = acc[i] + prod[i];
          const float back = sum - acc[i];
          lo[i] += (acc[i] - (sum - back)) + (prod[i] - back);
          acc[i] = sum;
        } else {
          acc[i] += prod[i];
        }
      }
    }

    // sum i sits at row + 8 rr, column 8 j + 2 quad + e for i = 4 j + 2 rr + e
    if constexpr (kKind == 1) {
      const int64_t r0 = static_cast<int64_t>(s) * BD + share * kRows + row;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int c = c0 + j * 8 + 2 * quad;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint16_t* o = out + (r0 + rr * 8) * fc + c;
          const float v0 = acc[4 * j + 2 * rr], v1 = acc[4 * j + 2 * rr + 1];
          if (fc % 2 == 0 && c < fc) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < fc) o[0] = to_bf16(v0);
            if (c + 1 < fc) o[1] = to_bf16(v1);
          }
        }
      }
    } else {
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int rw = row + rr * 8;
        double* dst = cluster.map_shared_rank(red, rw / 8) + (s * 8 + rw % 8) * kRedStride;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const int i = 4 * j + 2 * rr;
          *reinterpret_cast<double2*>(dst + j * 8 + 2 * quad) =
              make_double2(static_cast<double>(acc[i]) + lo[i],
                           static_cast<double>(acc[i + 1]) + lo[i + 1]);
        }
      }
    }
  }

  if constexpr (kKind == 0) {
    // rows 8s..8s + 7 of the share: the 8 slices' sums added in f64 in
    // slice order, then rounded once (to f32, then bf16)
    __syncwarp();
    cluster_sync();  // every slice's sums are in their owners' shared memory
    if (warp < 4) {
      cg::cluster_group cluster = cg::this_cluster();
      const int r = static_cast<int>(cluster.block_rank()) * 8 + (threadIdx.x >> 4);
      const int cc = (threadIdx.x & 15) * 8;
      double sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.0;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) {  // slice q's slot of this CTA's rows
        const double* src = red + (q * 8 + (threadIdx.x >> 4)) * kRedStride + cc;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const double2 v = reinterpret_cast<const double2*>(src)[h];
          sum[2 * h] += v.x;
          sum[2 * h + 1] += v.y;
        }
      }
      uint16_t* o = out + static_cast<int64_t>(share * kRows + r) * fc + c0 + cc;
      if (fc % 8 == 0 && c0 + cc < fc) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = to_bf16(static_cast<float>(sum[2 * e])) |
                 (static_cast<uint32_t>(to_bf16(static_cast<float>(sum[2 * e + 1]))) << 16);
        }
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (c0 + cc + e < fc) o[e] = to_bf16(static_cast<float>(sum[e]));
        }
      }
    }
  }
}

// The kernel's shared-memory size set, once a device (bit d of the mask:
// device d; a device past 31 sets it every call).
template <int kKind>
cudaError_t prepare(int device) {
  static uint32_t ready = 0;
  const uint32_t bit = device < 32 ? (1u << device) : 0u;
  if (ready & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(compact_item_kernel<kKind>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes(kKind)));
  if (err == cudaSuccess) ready |= bit;
  return err;
}

}  // namespace

// Kind 0's TMA map of win bf16 [2048, ld] (ld a multiple of 8, win 16-byte
// aligned; boxes of 64 columns x 64 rows) into map[0..127]. Returns a
// cudaError_t code.
extern "C" int adaqp_compact_item_map(const void* win, int ld, void* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if (ld <= 0 || ld % 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  if (!encode_2d(encode, &m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, win, ld, kSlices * kSliceK,
                 kBoxCols, kK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(map, &m, sizeof(m));
  return 0;
}

// mask int16 [256, 128] (4-byte aligned); col int32 [2048] in [0, 2048)
// (read for kind 1); win bf16 [2048, ld], 16-byte aligned, its first fc
// columns the item's; out bf16 [2048, fc], written in full; `chunks` =
// ceil(fc / 128); kind 0 (with `map` from adaqp_compact_item_map) or 1
// (`map` unused); iters >= 1. Launches on `stream` of CUDA device `device`
// (made current if it is not) and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments it does not take; it
// does not synchronise.
extern "C" int adaqp_compact_item(const void* map, const void* mask, const void* col,
                                  const void* win, void* out, int fc, int ld, int chunks,
                                  int kind, int iters, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fc <= 0 || ld < fc || ld % 8 || chunks != (fc + kCols - 1) / kCols || chunks > 65535 ||
      kind < 0 || kind > 1 || iters < 1 || (kind == 0 && map == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap m;
  if (kind == 0) {
    memcpy(&m, map, sizeof(m));
  } else {
    memset(&m, 0, sizeof(m));
  }
  const auto* mk = static_cast<const uint32_t*>(mask);
  const auto* cl = static_cast<const int32_t*>(col);
  const auto* w = static_cast<const uint16_t*>(win);
  auto* o = static_cast<uint16_t*>(out);
  const dim3 grid(kSlices, chunks, kShares);
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    err = prepare<0>(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes(0);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kSlices;  // the 8 slices of a (chunk, share)
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, compact_item_kernel<0>, m, mk, cl, w, o, fc, ld, iters);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    err = prepare<1>(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_item_kernel<1><<<grid, kThreads, smem_bytes(1), st>>>(m, mk, cl, w, o, fc, ld, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_compact_item_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
