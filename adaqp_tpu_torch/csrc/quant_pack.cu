// Ragged-wire kernels for NVIDIA Hopper (sm_90a): pack_lanes (quant_pack)
// and unpack_lanes (unpack_dequant).
//
// pack_lanes replaces the JAX package's TPU kernel
// ops/quant_pallas.py::_quant_pack_kernel (quantize_pack_rows_tpu) together
// with the XLA gather and scatter around it (comm/exchange_ragged.py:317-386,
// the per-lane offsets q_off / q_poff). Per lane l of one direction of one
// layer's exchange, with source row r = src[l] of x [n, f] (f32 or bf16),
// bucket b = bucket[l] (bits, wpr, key of the bucket) and index i = index[l]
// inside its bucket:
//   rmin, rmax over columns < f_true;
//   scale = (2^bits - 1) / max(rmax - rmin, 1e-10);
//   q[c] = clip(floor((x[c] - rmin) * scale + u(key_b, i, c)), 0, 2^bits - 1);
//   word j (j < wpr) = OR over t < 32/bits of q[t * wpr + j] << (t * bits),
//   code 0 for columns >= f, written at words[word_off[l] + j];
//   the bf16 parameter word (scale low, rmin high, round to nearest even)
//   at words[param_off[l]] when param_off[l] >= 0;
// lanes of a 32-bit bucket copy the row's f32 bits (zero past f) and a zero
// parameter word. Optionally range[l] = rmax - rmin (the backward trace).
// Without lane tables it is the contiguous quant_pack: lane l is row l, its
// words at l * wpr, f32 scale[l] and rmin[l] instead of a parameter word.
//
// unpack_lanes replaces ops/quant_pallas.py::_unpack_dequant_kernel
// (unpack_dequantize_rows_tpu) and the gather that places the rows, or the
// scatter-add that sums them. Output row o takes lane l = inv[o] (none when
// l >= n_lanes: a zero row), or l = o without inv, or (the backward) lane o
// is added into row dst[o]: out[o, c] = q[c] / scale + rmin for c < f_true, with q
// read from word c mod wpr, slot c / wpr, and scale, rmin from the lane's
// parameter word (or the f32 arrays of the contiguous unpack_dequant); 0
// for f_true <= c < f_pad. A 32-bit lane's words are its f32 columns.
//
// The uniforms: counter_hash.cuh (u of element (i, c) is a pure function of
// the bucket's key and (i, c)); ops/quant_cuda.py::uniforms draws the same
// numbers in PyTorch, so the plain versions draw the same codes. Every step
// rounds once (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction, which
// would move floor() across an integer now and then; __fdiv_rn: IEEE
// division; the build uses no fast-math flag), as the plain versions'
// separate PyTorch ops do.
//
// What bounds them. pack_lanes reads each lane's row once (n_lanes * f * 2
// or 4 bytes) and writes wpr + 1 words a lane: at layer 0 of the K=4 smoke
// (25,526 lanes, f = 640 bf16, 8 bits) 46.5 MB, 13.9 us at 3.35 TB/s. It
// also hashes every element, and that is not far below the card's integer
// rate: the previous kernel's hot loop took 22.5 integer-pipe operations an
// element (chip_smoke.py counts them in the SASS of the built library),
// 15.4M elements at 64 a clock per SM and 1,980 MHz: 20.7 us, more than the
// bytes. pack_words takes 11.25 (the hash's first xor-shift folded into the
// lane's half, the code's width a template argument so that shifts are
// constants and no column needs a bound check where the row covers the
// wire, the clamp on the f32 pipe): 10.4 us, so bytes bound it;
// chip_smoke.py states the larger of the two. unpack_lanes reads wpr + 1
// words a lane and writes f_pad floats a row (81 MB at layer 0, 24.2 us):
// bytes bound it.
//
// The design. pack_lanes: one warp a lane. It copies the source row once
// into shared memory as f32 (16-byte loads where the row's address allows,
// a scalar edge), taking min and max on the way and reducing them with
// shuffles; then lane j builds words j, j + 32, ... from shared memory
// (neighbouring lanes on neighbouring columns of a slot: no bank
// conflicts) and stores them coalesced. Persistent warps that load the
// next lane's row while they code this one were slower. unpack_lanes: one
// warp an output row; each lane takes 4 neighbouring columns at a time and
// stores them with one 16-byte store (scalar stores where f_pad is not a
// multiple of 4); the column's slot and word advance by addition (two
// divisions a row, none an element), and every element takes one IEEE
// division (a table of the lane's 2^bits values in shared memory was no
// faster). The backward adds each lane's row into its destination with
// 16-byte atomics (several peers may return one row), so the order of a
// sum of three or more rows varies from run to run, as index_add_'s does.
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
constexpr int kThreads = 256;  // 8 warps, one lane (row) each
constexpr int kWarps = kThreads / 32;

struct Buckets {
  int bits[kMaxBuckets];
  int wpr[kMaxBuckets];
  uint32_t key[kMaxBuckets];
};

// Words j = lane, lane + 32, ... < wpr of one lane at kBits bits from its
// row in shared memory: the codes of columns c = t * wpr + j (t < 32 /
// kBits), code 0 past f unless kFull (every wire column lies in the row).
// The uniform of column c comes from counter_hash.cuh's add_uniform with
// h2 = row_hash(key, i) (c < 2^16: the hash's first xor-shift costs one xor
// here). The float clamp before the round-down conversion gives the codes
// of the plain version's clamp after floor().
template <int kBits, bool kFull>
__device__ __forceinline__ void pack_words(const float* __restrict__ row, int f, int wpr,
                                           float lo, float s, uint32_t h2,
                                           uint32_t* __restrict__ out, int lane) {
  constexpr int kM = 32 / kBits;
  constexpr float kQmax = static_cast<float>((1 << kBits) - 1);
  for (int j = lane; j < wpr; j += 32) {
    uint32_t w = 0;
#pragma unroll
    for (int t = 0; t < kM; ++t) {
      const int c = j + t * wpr;
      if (kFull || c < f) {
        const float y = __fmul_rn(__fsub_rn(row[c], lo), s);
        const float v = add_uniform(y, h2, static_cast<uint32_t>(c));
        w += static_cast<uint32_t>(__float2int_rd(fminf(fmaxf(v, 0.f), kQmax))) << (t * kBits);
      }
    }
    out[j] = w;
  }
}

// Six blocks an SM (48 warps, 40 registers a thread, a few bytes of spills)
// ran faster than the compiler's own 50 registers or 32 (chip_smoke.py
// timed all three)
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 6)
pack_lanes_kernel(const void* __restrict__ x, int n_lanes, int f, int f_true, Buckets bk,
                  const int64_t* __restrict__ src, const int64_t* __restrict__ bucket,
                  const int64_t* __restrict__ index, const int64_t* __restrict__ word_off,
                  const int64_t* __restrict__ param_off, uint32_t* __restrict__ words,
                  float* __restrict__ scale_out, float* __restrict__ rmin_out,
                  float* __restrict__ range_out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = blockIdx.x * kWarps + warp;
  if (l >= n_lanes) return;  // warp-uniform
  float* row = reinterpret_cast<float*>(smem) + warp * ((f + 3) & ~3);
  const bool tables = src != nullptr;
  const int b = tables ? static_cast<int>(bucket[l]) : 0;
  const int bits = bk.bits[b];
  const int wpr = bk.wpr[b];
  const int64_t wo = tables ? word_off[l] : static_cast<int64_t>(l) * wpr;
  float lo = INFINITY, hi = -INFINITY;
  stage_row<kBf16>(x, tables ? src[l] : l, f, f, f_true, row, lane, lo, hi);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __syncwarp();
  if (range_out != nullptr && lane == 0) range_out[l] = __fsub_rn(hi, lo);
  const int64_t po = tables && param_off != nullptr ? param_off[l] : -1;
  if (bits == 32) {  // raw f32 lanes: the row's bits, zero past f
    for (int c = lane; c < wpr; c += 32) {
      words[wo + c] = c < f ? __float_as_uint(row[c]) : 0u;
    }
    if (po >= 0 && lane == 0) words[po] = 0u;
    return;
  }
  const float s = __fdiv_rn(static_cast<float>((1 << bits) - 1),
                            fmaxf(__fsub_rn(hi, lo), 1e-10f));
  const uint32_t h2 = row_hash(bk.key[b], static_cast<uint32_t>(tables ? index[l] : l));
  uint32_t* out = words + wo;
  const bool full = wpr * (32 / bits) <= f;  // every wire column lies in the row
  switch (bits * 2 + full) {
    case 4: pack_words<2, false>(row, f, wpr, lo, s, h2, out, lane); break;
    case 5: pack_words<2, true>(row, f, wpr, lo, s, h2, out, lane); break;
    case 8: pack_words<4, false>(row, f, wpr, lo, s, h2, out, lane); break;
    case 9: pack_words<4, true>(row, f, wpr, lo, s, h2, out, lane); break;
    case 16: pack_words<8, false>(row, f, wpr, lo, s, h2, out, lane); break;
    default: pack_words<8, true>(row, f, wpr, lo, s, h2, out, lane); break;
  }
  if (lane == 0) {
    if (po >= 0) {
      const uint32_t sb = __bfloat16_as_ushort(__float2bfloat16_rn(s));
      const uint32_t rb = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
      words[po] = (rb << 16) | sb;
    }
    if (scale_out != nullptr) {
      scale_out[l] = s;
      rmin_out[l] = lo;
    }
  }
}

// One warp an output row o. Without kAdd: row o of out takes lane inv[o]
// (a zero row when inv[o] >= n_lanes), or lane o without inv. kAdd: lane o
// is added into row dst[o] of out (zeroed by the caller), columns past
// f_true left as they are.
template <bool kVec, bool kAdd>
__global__ void __launch_bounds__(kThreads)
unpack_lanes_kernel(const uint32_t* __restrict__ words, int n_out, int64_t n_lanes,
                    int f_true, int f_pad, Buckets bk, const int64_t* __restrict__ inv,
                    const int64_t* __restrict__ dst, const int64_t* __restrict__ bucket,
                    const int64_t* __restrict__ word_off, const int64_t* __restrict__ param_off,
                    const float* __restrict__ scale, const float* __restrict__ rmin,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (o >= n_out) return;  // warp-uniform
  float* orow = out + (kAdd ? dst[o] : static_cast<int64_t>(o)) * f_pad;
  const int64_t l = inv != nullptr ? inv[o] : o;
  float v[4];
  if (l >= n_lanes) {  // a slot that receives nothing
    v[0] = v[1] = v[2] = v[3] = 0.f;
    for (int c0 = 4 * lane; c0 < f_pad; c0 += 128) put4<kVec, false>(orow, c0, f_pad, v);
    return;
  }
  const bool tables = word_off != nullptr;
  const int b = tables ? static_cast<int>(bucket[l]) : 0;
  const int bits = bk.bits[b];
  const int wpr = bk.wpr[b];
  const uint32_t* lw = words + (tables ? word_off[l] : l * wpr);
  // kAdd leaves the zero columns alone
  const int end = kAdd ? min(f_pad, bits == 32 ? wpr : f_true) : f_pad;
  if (bits == 32) {  // raw f32 columns, zero past the wire's width
    for (int c0 = 4 * lane; c0 < end; c0 += 128) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        v[e] = c < wpr && c < f_pad ? __uint_as_float(__ldg(lw + c)) : 0.f;
      }
      put4<kVec, kAdd>(orow, c0, f_pad, v);
    }
    return;
  }
  float s, r;
  if (tables) {
    const uint32_t pw = __ldg(words + param_off[l]);
    s = __uint_as_float(pw << 16);
    r = __uint_as_float(pw & 0xFFFF0000u);
  } else {
    s = scale[l];
    r = rmin[l];
  }
  const uint32_t mask = (1u << bits) - 1u;
  // column c0 = 4 * lane sits in word j of slot t; each step moves 128
  // columns on: dt whole slots and dj words
  int t = (4 * lane) / wpr;
  int j = 4 * lane - t * wpr;
  const int dt = 128 / wpr;
  const int dj = 128 - dt * wpr;
  for (int c0 = 4 * lane; c0 < end; c0 += 128) {
    int tt = t, jj = j;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = 0.f;
      if (c0 + e < f_true) {
        const uint32_t q = (__ldg(lw + jj) >> (tt * bits)) & mask;
        y = __fadd_rn(__fdiv_rn(__uint2float_rn(q), s), r);
      }
      v[e] = y;
      if (++jj == wpr) {
        jj = 0;
        ++tt;
      }
    }
    put4<kVec, kAdd>(orow, c0, f_pad, v);
    t += dt;
    j += dj;
    if (j >= wpr) {
      j -= wpr;
      ++t;
    }
  }
}

int check_buckets(int nb, const int* bits, const int* wpr) {
  if (nb < 1 || nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nb; ++i) {
    if ((bits[i] != 2 && bits[i] != 4 && bits[i] != 8 && bits[i] != 32) || wpr[i] <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return 0;
}

Buckets make_buckets(int nb, const int* bits, const int* wpr, const uint32_t* keys) {
  Buckets bk{};
  for (int i = 0; i < nb; ++i) {
    bk.bits[i] = bits[i];
    bk.wpr[i] = wpr[i];
    bk.key[i] = keys != nullptr ? keys[i] : 0u;
  }
  return bk;
}

}  // namespace

// x [n, f] f32 (is_bf16 = 0) or bf16, row-major. nb buckets of bits[i] in
// {2, 4, 8, 32} and wpr[i] words a lane, uniforms of keys[i]. With lane
// tables (src, bucket, index, word_off: int64 [n_lanes]; param_off int64
// [n_lanes] with -1 for none, or null for no parameter words) the lanes'
// words go into `words` (int32) at their offsets; without (src null) lane l
// is row l, its words at l * wpr[0] and its f32 scale and rmin in
// scale_out and rmin_out. range_out (f32 [n_lanes], or null) takes each
// lane's rmax - rmin. f_true <= f. Launches on `stream` of CUDA device
// `device` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int adaqp_pack_lanes(const void* x, int is_bf16, int n_lanes, int f, int f_true,
                                int nb, const int* bits, const int* wpr, const uint32_t* keys,
                                const void* src, const void* bucket, const void* index,
                                const void* word_off, const void* param_off, void* words,
                                void* scale_out, void* rmin_out, void* range_out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (int rc = check_buckets(nb, bits, wpr)) return rc;
  if (f >= 65536) return static_cast<int>(cudaErrorInvalidValue);  // pack_words' c < 2^16
  if (n_lanes <= 0) return 0;
  const Buckets bk = make_buckets(nb, bits, wpr, keys);
  const size_t smem = static_cast<size_t>(kWarps) * ((f + 3) & ~3) * sizeof(float);
  auto kernel = is_bf16 ? pack_lanes_kernel<true> : pack_lanes_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_lanes + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n_lanes, f, f_true, bk, static_cast<const int64_t*>(src),
      static_cast<const int64_t*>(bucket), static_cast<const int64_t*>(index),
      static_cast<const int64_t*>(word_off), static_cast<const int64_t*>(param_off),
      static_cast<uint32_t*>(words), static_cast<float*>(scale_out),
      static_cast<float*>(rmin_out), static_cast<float*>(range_out));
  return static_cast<int>(cudaGetLastError());
}

// out f32 [n_out, f_pad], written in full: row o takes lane inv[o] (int64
// [n_out]; lanes >= n_lanes give a zero row), or lane o when inv is null.
// With dst (int64 [n_lanes], inv null, n_out = n_lanes) lane o is added
// into row dst[o] of out instead (atomics; the caller zeroes out). With
// lane tables (bucket, word_off, param_off: int64 [n_lanes]) a lane's words
// sit at word_off and its bf16 pair in the word at param_off; without
// (word_off null) lane l's words sit at l * wpr[0] and its scale and rmin
// in the f32 arrays. Same launch and return conventions as
// adaqp_pack_lanes.
extern "C" int adaqp_unpack_lanes(const void* words, int n_out, int64_t n_lanes, int f_true,
                                  int f_pad, int nb, const int* bits, const int* wpr,
                                  const void* inv, const void* dst, const void* bucket,
                                  const void* word_off, const void* param_off,
                                  const void* scale, const void* rmin, void* out, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (int rc = check_buckets(nb, bits, wpr)) return rc;
  if (dst != nullptr && inv != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out <= 0 || f_pad <= 0) return 0;
  const Buckets bk = make_buckets(nb, bits, wpr, nullptr);
  const dim3 grid((n_out + kWarps - 1) / kWarps);
  const bool vec = (f_pad & 3) == 0;
  auto kernel = dst != nullptr ? (vec ? unpack_lanes_kernel<true, true>
                                      : unpack_lanes_kernel<false, true>)
                               : (vec ? unpack_lanes_kernel<true, false>
                                      : unpack_lanes_kernel<false, false>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_out, n_lanes, f_true, f_pad, bk,
      static_cast<const int64_t*>(inv), static_cast<const int64_t*>(dst),
      static_cast<const int64_t*>(bucket), static_cast<const int64_t*>(word_off),
      static_cast<const int64_t*>(param_off), static_cast<const float*>(scale),
      static_cast<const float*>(rmin), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adaqp_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
