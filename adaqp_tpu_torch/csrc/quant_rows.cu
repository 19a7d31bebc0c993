// Padded-wire kernels for NVIDIA Hopper (sm_90a): quant_rows and
// dequant_rows.
//
// quant_rows replaces the JAX package's TPU kernel
// ops/quant_pallas.py::_quant_kernel (quantize_rows_tpu) together with the
// torch ops the padded exchange ran around it (comm/exchange.py before: the
// lane gather h[send_idx], the column packing pack_rows, the bf16 pair and
// the frame's concatenation, once a bucket). One launch serves one
// direction of one layer's exchange. Per lane l, with source row r = src[l]
// of x [n, f] (f32 or bf16; r >= n reads a zero row: the backward's
// sentinel gather slots), bucket b = bucket[l] (its bits and key) and
// index i = index[l] in the bucket's [K * cap] batch:
//   rmin, rmax over columns < f_true;
//   scale = (2^bits - 1) / max(rmax - rmin, 1e-10);
//   q[c] = clip(floor((x[c] - rmin) * scale + u(key_b, i, c)), 0, 2^bits - 1)
//   for the f_wire = pad_features(f_true) wire columns c, code 0 for c >= f;
// and it writes the lane's frame at byte frame_off[l] of the direction's
// send buffer: the codes column-packed (byte p holds columns p * m + t, t <
// m = 8 / bits, at bit t * bits: ops/quant.py::pack_rows), then the bf16
// scale and rmin (round to nearest even), little-endian, 4 bytes. Optionally
// range[r] = rmax - rmin for each source row r < n (the backward's trace).
// Without lane tables it is the contiguous quant_rows: lane l is row l, one
// code byte a column for all f columns at byte l * f, its f32 scale and rmin
// in scale[l] and rmin[l].
//
// dequant_rows replaces ops/quant_pallas.py::_dequant_kernel
// (dequantize_rows_tpu) together with the torch ops of the receive side
// (the frame's split, unpack_rows, the widening of the bf16 pair,
// true_columns and the placement remote[recv_slot] = ... or the backward's
// index_add_). Per lane l whose destination d = dst[l] lies below n_out
// (the sentinels r_pad and l_max lie past it: dropped), it reads the
// lane's frame and writes out[d, c] = q[c] / scale + rmin for c < f_true
// and 0 for f_true <= c < f_out (forward), or adds the first f_true
// columns into row d with f32 atomics (backward: several peers may return
// one row, so the order of a sum of three or more terms varies from run to
// run, as index_add_'s does). Without lane tables it is the contiguous
// dequant_rows: one code byte a column at byte l * f, f32 scale[l] and
// rmin[l], every column decoded.
//
// Both agree with their plain versions (ops/quant_cuda.py) bit for bit:
// the uniforms are counter_hash.cuh's, and every step rounds once
// (__fsub_rn, __fmul_rn, an fma that adds an exact uniform, __fdiv_rn: no
// FMA contraction, no fast-math flag), as the plain versions' separate
// PyTorch ops do.
//
// What bounds them. quant_rows reads the columns of each lane's row that
// its frame codes once (min(f, f_wire)) and writes its frame: at
// train_pad's largest layer-0 bucket (34,240 lanes of 640 bf16 columns,
// 602 true, 604 on the wire, 8 bits) 41.4 MB and 20.8 MB with the lane
// tables, 18.9 us at 3.35 TB/s. Its hash and rounding cost about ten
// integer-pipe operations an element and two conversions (chip_smoke.py
// counts them in the SASS of the built library), about 12 us at that
// shape, so bytes bound it. dequant_rows reads the frames and writes f_out
// floats a lane (87.7 MB at that shape, 32.6 us): bytes bound it.
//
// The design. quant_rows: one warp a lane. It copies the source row's
// coded columns (all f without lane tables) into shared memory as f32
// (16-byte loads where the row's address allows), taking min and max on
// the way. A lane whose codes are a byte each and
// start on 4 bytes (every frame of an 8-bit bucket whose slice does, as
// every slice does when the capacities are multiples of 8, since frames
// are f_wire + 4 bytes; every contiguous row of a multiple-of-4 width)
// then codes word j = columns 4j
// .. 4j + 3 from one 16-byte shared load and stores it straight to global
// memory, neighbouring lanes on neighbouring words. The other frames (306
// or 155 bytes at 4 or 2 bits start anywhere): lane j codes frame bytes j,
// j + 32, ... (its columns in one vector load) into a frame staged in
// shared memory at the global frame's offset modulo 4, and the warp stores
// it with aligned 4-byte stores and byte stores at its two ragged ends.
// Persistent warps that fetched the next lane's row with cp.async while
// coding this one, blocks of 64 or 128 threads, and several row loads a
// thread in flight were each measured and were no faster. dequant_rows:
// one warp a lane, its scale and rmin loaded once; each lane takes 4
// neighbouring columns at a time, loads their codes with aligned word loads
// (a funnel shift where they straddle two words), divides each by the scale
// (IEEE) and stores them with one 16-byte store or one 16-byte atomic add
// (scalar ones where f_out is not a multiple of 4). No division by the row
// length anywhere: the lane's row comes from its warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "lane_rows.cuh"

namespace {

using adaqp::add_uniform;
using adaqp::put4;
using adaqp::row_hash;
using adaqp::stage_row;

constexpr int kMaxBuckets = 4;
constexpr int kThreads = 256;  // 8 warps, one lane each
constexpr int kWarps = kThreads / 32;

struct Buckets {
  int bits[kMaxBuckets];
  uint32_t key[kMaxBuckets];
};

// Frame bytes p = lane, lane + 32, ... < n_cb of one lane into fb (shared
// memory), kPack bits a code: byte p holds the codes of columns p * m + t
// (t < m = 8 / kPack) at bit t * kPack, code 0 for columns >= f unless
// kFull (every coded column lies in the row). The float clamp before the
// round-down conversion gives the codes of the plain version's clamp after
// floor().
template <int kPack, bool kFull>
__device__ __forceinline__ void code_bytes(const float* __restrict__ row, int f, int n_cb,
                                           float lo, float s, float qmax, uint32_t h2,
                                           uint8_t* __restrict__ fb, int lane) {
  constexpr int kM = 8 / kPack;
  for (int p = lane; p < n_cb; p += 32) {
    float e[kM];
    if constexpr (kFull && kM == 4) {  // one 16-byte load (rows start on 16 bytes)
      const float4 t = reinterpret_cast<const float4*>(row)[p];
      e[0] = t.x, e[1] = t.y, e[2] = t.z, e[3] = t.w;
    } else if constexpr (kFull && kM == 2) {
      const float2 t = reinterpret_cast<const float2*>(row)[p];
      e[0] = t.x, e[1] = t.y;
    } else {
#pragma unroll
      for (int t = 0; t < kM; ++t) e[t] = kFull || p * kM + t < f ? row[p * kM + t] : 0.f;
    }
    uint32_t byte = 0;
#pragma unroll
    for (int t = 0; t < kM; ++t) {
      const int c = p * kM + t;
      if (kFull || c < f) {
        const float v = add_uniform(__fmul_rn(__fsub_rn(e[t], lo), s), h2,
                                    static_cast<uint32_t>(c));
        byte |= static_cast<uint32_t>(__float2int_rd(fminf(fmaxf(v, 0.f), qmax))) << (t * kPack);
      }
    }
    fb[p] = static_cast<uint8_t>(byte);
  }
}

// The 8-bit codes of one lane as words j = lane, lane + 32, ... < n_words
// (word j: columns 4j .. 4j + 3, all in the row, one 16-byte load from
// shared memory), stored straight to the lane's 4-byte aligned codes `out`.
__device__ __forceinline__ void code_words8(const float* __restrict__ row, int n_words, float lo,
                                            float s, float qmax, uint32_t h2,
                                            uint32_t* __restrict__ out, int lane) {
  for (int j = lane; j < n_words; j += 32) {
    const float4 t = reinterpret_cast<const float4*>(row)[j];
    const float e[4] = {t.x, t.y, t.z, t.w};
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = add_uniform(__fmul_rn(__fsub_rn(e[k], lo), s), h2,
                                  static_cast<uint32_t>(4 * j + k));
      w |= static_cast<uint32_t>(__float2int_rd(fminf(fmaxf(v, 0.f), qmax))) << (8 * k);
    }
    out[j] = w;
  }
}

// Copies bytes [lead, lead + n) of fbase (shared memory, 4-byte aligned)
// to the same bytes of g (4-byte aligned): a 4-byte store for each word
// wholly inside, byte stores for the others (a neighbouring frame's warp
// writes the rest of them).
__device__ __forceinline__ void store_bytes(const uint8_t* __restrict__ fbase, int lead, int n,
                                            uint8_t* __restrict__ g, int lane) {
  const int end = lead + n;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(fbase);
  uint32_t* gw = reinterpret_cast<uint32_t*>(g);
  for (int j = lane; 4 * j < end; j += 32) {
    const int b0 = 4 * j;
    if (b0 >= lead && b0 + 4 <= end) {
      gw[j] = sw[j];
    } else {
      for (int k = max(b0, lead); k < min(b0 + 4, end); ++k) g[k] = fbase[k];
    }
  }
}

template <bool kBf16, bool kFrames>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const void* __restrict__ x, int64_t n_rows, int n_lanes, int f, int f_true,
                  int f_wire, Buckets bk, int fb_stride, const int64_t* __restrict__ src,
                  const int64_t* __restrict__ bucket, const int64_t* __restrict__ index,
                  const int64_t* __restrict__ frame_off, uint8_t* __restrict__ out,
                  float* __restrict__ scale_out, float* __restrict__ rmin_out,
                  float* __restrict__ range_out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = blockIdx.x * kWarps + warp;
  if (l >= n_lanes) return;  // warp-uniform
  const int fs = kFrames ? min(f, f_wire) : f;  // the columns the codes read
  const int rf = (fs + 7) & ~7;  // stage_row may stage up to fs rounded up to 8
  float* row = reinterpret_cast<float*>(smem) + warp * (rf + fb_stride / 4);
  uint8_t* fbase = reinterpret_cast<uint8_t*>(row + rf);
  const int64_t r = kFrames ? src[l] : l;
  const int b = kFrames ? static_cast<int>(bucket[l]) : 0;
  const int bits = bk.bits[b];
  float lo = INFINITY, hi = -INFINITY;
  if (r < n_rows) {
    stage_row<kBf16>(x, r, f, fs, f_true, row, lane, lo, hi);
  } else {  // a sentinel: the zero row
    for (int c = lane; c < fs; c += 32) row[c] = 0.f;
    lo = hi = 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __syncwarp();
  if (range_out != nullptr && lane == 0 && r < n_rows) range_out[r] = __fsub_rn(hi, lo);
  const float qmax = static_cast<float>((1 << bits) - 1);
  const float s = __fdiv_rn(qmax, fmaxf(__fsub_rn(hi, lo), 1e-10f));
  const uint32_t h2 = row_hash(bk.key[b], static_cast<uint32_t>(kFrames ? index[l] : l));
  uint8_t* g = out + (kFrames ? frame_off[l] : static_cast<int64_t>(l) * f);
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 3);
  const int n_code = kFrames ? f_wire : f;  // coded columns
  if ((!kFrames || bits == 8) && lead == 0 && n_code <= fs && n_code % 4 == 0) {
    // a byte a code on 4-byte aligned codes: whole words, no staging (the
    // frames of an 8-bit bucket all start on 4 bytes: its buffer slice
    // does, and frames are f_wire + 4 bytes)
    code_words8(row, n_code / 4, lo, s, qmax, h2, reinterpret_cast<uint32_t*>(g), lane);
    if (lane == 0) {
      if constexpr (kFrames) {  // the bf16 pair: scale in the low half, rmin in the high
        reinterpret_cast<uint32_t*>(g)[n_code / 4] =
            (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) << 16) |
            __bfloat16_as_ushort(__float2bfloat16_rn(s));
      } else {
        scale_out[l] = s;
        rmin_out[l] = lo;
      }
    }
    return;
  }
  uint8_t* fb = fbase + lead;  // the frame sits at the global frame's offset modulo 4
  int n;
  if constexpr (kFrames) {
    const int n_cb = f_wire * bits / 8;
    const bool full = f_wire <= f;
    switch (bits * 2 + full) {  // not full: fs = f, codes 0 past it
      case 4: code_bytes<2, false>(row, fs, n_cb, lo, s, qmax, h2, fb, lane); break;
      case 5: code_bytes<2, true>(row, fs, n_cb, lo, s, qmax, h2, fb, lane); break;
      case 8: code_bytes<4, false>(row, fs, n_cb, lo, s, qmax, h2, fb, lane); break;
      case 9: code_bytes<4, true>(row, fs, n_cb, lo, s, qmax, h2, fb, lane); break;
      case 16: code_bytes<8, false>(row, fs, n_cb, lo, s, qmax, h2, fb, lane); break;
      default: code_bytes<8, true>(row, fs, n_cb, lo, s, qmax, h2, fb, lane); break;
    }
    if (lane < 4) {  // the bf16 pair: scale in the low half, rmin in the high
      const uint32_t pw =
          (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) << 16) |
          __bfloat16_as_ushort(__float2bfloat16_rn(s));
      fb[n_cb + lane] = static_cast<uint8_t>(pw >> (8 * lane));
    }
    n = n_cb + 4;
  } else {
    code_bytes<8, true>(row, f, f, lo, s, qmax, h2, fb, lane);
    if (lane == 0) {
      scale_out[l] = s;
      rmin_out[l] = lo;
    }
    n = f;
  }
  __syncwarp();
  store_bytes(fbase, lead, n, g - lead, lane);
}

// Bytes p[0 .. n) (n <= 4) little-endian in the low bits of the result
// (the rest is not defined), from aligned word loads of only the words
// that hold one of them.
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const int sh = static_cast<int>(a & 3);
  const uint32_t lo = __ldg(w);
  if (sh == 0) return lo;
  return __funnelshift_r(lo, sh + n > 4 ? __ldg(w + 1) : 0u, 8 * sh);
}

// One lane's row from its codes (kPack bits a code, packed as code_bytes
// packs them), scale s and rmin r: columns c0 = 4 * lane, + 128, ... < end,
// 4 at a time; q / s + r below f_true, 0 above.
template <int kPack, bool kVec, bool kAdd>
__device__ __forceinline__ void dequant_row(const uint8_t* __restrict__ codes, int f_true,
                                            int end, int f_out, float s, float r,
                                            float* __restrict__ orow, int lane) {
  constexpr uint32_t kMask = (1u << kPack) - 1u;
  for (int c0 = 4 * lane; c0 < end; c0 += 128) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (c0 < f_true) {
      const int valid = min(4, f_true - c0);
      const uint32_t w = load_bytes(codes + c0 * kPack / 8, (valid * kPack + 7) / 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < valid) {
          const float q = __uint2float_rn((w >> (e * kPack)) & kMask);
          v[e] = __fadd_rn(__fdiv_rn(q, s), r);
        }
      }
    }
    put4<kVec, kAdd>(orow, c0, f_out, v);
  }
}

// One warp a lane. Without kAdd: row dst[l] of out takes lane l's row
// (lanes whose dst lies outside [0, n_out) are dropped), or row l without
// tables. kAdd: lane l's first f_true columns are added into row dst[l].
template <bool kFrames, bool kVec, bool kAdd>
__global__ void __launch_bounds__(kThreads)
dequant_rows_kernel(const uint8_t* __restrict__ in, int n_lanes, int64_t n_out, int f_true,
                    int f_wire, int f_out, Buckets bk, const int64_t* __restrict__ dst,
                    const int64_t* __restrict__ bucket, const int64_t* __restrict__ frame_off,
                    const float* __restrict__ scale, const float* __restrict__ rmin,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (l >= n_lanes) return;  // warp-uniform
  int64_t d = l;
  int pack = 8;
  const uint8_t* codes;
  float s, r;
  if constexpr (kFrames) {
    d = dst[l];
    if (d < 0 || d >= n_out) return;  // a sentinel lane
    pack = bk.bits[bucket[l]];
    codes = in + frame_off[l];
    const uint32_t pw = load_bytes(codes + f_wire * pack / 8, 4);
    s = __uint_as_float(pw << 16);
    r = __uint_as_float(pw & 0xFFFF0000u);
  } else {
    codes = in + static_cast<int64_t>(l) * f_out;
    s = scale[l];
    r = rmin[l];
  }
  float* orow = out + d * f_out;
  const int end = kAdd ? min(f_out, f_true) : f_out;  // kAdd leaves the zero columns alone
  switch (pack) {
    case 2: dequant_row<2, kVec, kAdd>(codes, f_true, end, f_out, s, r, orow, lane); break;
    case 4: dequant_row<4, kVec, kAdd>(codes, f_true, end, f_out, s, r, orow, lane); break;
    default: dequant_row<8, kVec, kAdd>(codes, f_true, end, f_out, s, r, orow, lane); break;
  }
}

int make_buckets(int nb, const int* bits, const uint32_t* keys, Buckets* bk) {
  if (nb < 1 || nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  *bk = Buckets{};
  for (int i = 0; i < nb; ++i) {
    if (bits[i] != 2 && bits[i] != 4 && bits[i] != 8) return static_cast<int>(cudaErrorInvalidValue);
    bk->bits[i] = bits[i];
    bk->key[i] = keys != nullptr ? keys[i] : 0u;
  }
  return 0;
}

}  // namespace

// x [n_rows, f] f32 (is_bf16 = 0) or bf16, row-major; nb buckets of bits[i]
// in {2, 4, 8} with the uniforms of keys[i]. With lane tables (src, bucket,
// index, frame_off: int64 [n_lanes]; src >= n_rows reads a zero row) each
// lane's frame, f_wire * bits / 8 bytes of codes then the bf16 pair, goes
// into `out` (uint8) at frame_off; range (f32 [n_rows], or null) takes
// rmax - rmin of each source row a lane reads. Without (src null) lane l is
// row l (n_lanes = n_rows), its codes one byte a column at out + l * f and
// its f32 scale and rmin in scale[l] and rmin[l] (bits[0], keys[0]).
// f_true <= f; f, f_wire < 65536, f_wire a multiple of 4 that is >= f_true.
// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int adaqp_quant_rows(const void* x, int is_bf16, int64_t n_rows, int n_lanes, int f,
                                int f_true, int f_wire, int nb, const int* bits,
                                const uint32_t* keys, const void* src, const void* bucket,
                                const void* index, const void* frame_off, void* out,
                                void* scale, void* rmin, void* range, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Buckets bk;
  if (int rc = make_buckets(nb, bits, keys, &bk)) return rc;
  const bool frames = src != nullptr;
  if (f <= 0 || f >= 65536 || f_true <= 0 || f_true > f ||
      (frames && (f_wire % 4 || f_wire < f_true || f_wire >= 65536))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes <= 0) return 0;
  const int fs = frames ? min(f, f_wire) : f;  // the columns a warp stages
  int max_frame = f;
  if (frames) {
    max_frame = 0;
    for (int i = 0; i < nb; ++i) max_frame = max(max_frame, f_wire * bits[i] / 8 + 4);
  }
  const int fb_stride = (3 + max_frame + 15) & ~15;
  const size_t smem = static_cast<size_t>(kWarps) * (((fs + 7) & ~7) * sizeof(float) + fb_stride);
  auto kernel = frames ? (is_bf16 ? quant_rows_kernel<true, true> : quant_rows_kernel<false, true>)
                       : (is_bf16 ? quant_rows_kernel<true, false> : quant_rows_kernel<false, false>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_lanes + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n_rows, n_lanes, f, f_true, f_wire, bk, fb_stride, static_cast<const int64_t*>(src),
      static_cast<const int64_t*>(bucket), static_cast<const int64_t*>(index),
      static_cast<const int64_t*>(frame_off), static_cast<uint8_t*>(out),
      static_cast<float*>(scale), static_cast<float*>(rmin), static_cast<float*>(range));
  return static_cast<int>(cudaGetLastError());
}

// out f32 [n_out, f_out]. With lane tables (dst, bucket, frame_off: int64
// [n_lanes]) lane l's frame sits at frame_off[l] of `in` (f_wire * bits / 8
// bytes of codes, then the bf16 pair) and its row goes to row dst[l] (lanes
// with dst outside [0, n_out) are dropped; rows no lane writes keep their
// contents): stored (add = 0: columns >= f_true zero) or added (add = 1,
// atomics: the first f_true columns). Without (dst null) lane l's codes are
// one byte a column at in + l * f_out with f32 scale[l] and rmin[l], and
// row l of out takes every column (n_out = n_lanes, f_true = f_wire = f_out).
// Same launch and return conventions as adaqp_quant_rows.
extern "C" int adaqp_dequant_rows(const void* in, int n_lanes, int64_t n_out, int f_true,
                                  int f_wire, int f_out, int nb, const int* bits,
                                  const void* dst, const void* bucket, const void* frame_off,
                                  const void* scale, const void* rmin, int add, void* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Buckets bk;
  if (int rc = make_buckets(nb, bits, nullptr, &bk)) return rc;
  const bool frames = dst != nullptr;
  if (f_true <= 0 || f_true > f_wire || (frames && f_wire % 4) || (!frames && add)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes <= 0 || n_out <= 0 || f_out <= 0) return 0;
  const bool vec = (f_out & 3) == 0;
  auto kernel = !frames ? (vec ? dequant_rows_kernel<false, true, false>
                               : dequant_rows_kernel<false, false, false>)
                : add   ? (vec ? dequant_rows_kernel<true, true, true>
                               : dequant_rows_kernel<true, false, true>)
                        : (vec ? dequant_rows_kernel<true, true, false>
                               : dequant_rows_kernel<true, false, false>);
  const int blocks = (n_lanes + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), n_lanes, n_out, f_true, f_wire, f_out, bk,
      static_cast<const int64_t*>(dst), static_cast<const int64_t*>(bucket),
      static_cast<const int64_t*>(frame_off), static_cast<const float*>(scale),
      static_cast<const float*>(rmin), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_quant_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
