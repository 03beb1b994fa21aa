// B2: weight-only GEMV for few rows, 8-bit codes, rowwise or grouped scales.
//
//   row mode: y[m, o] = (sum_k x[m, k] * c[o, k]) * scale[o]
//                       (+ rowsum(x)[m] * zp[o]) (+ bias[o])
//   grouped:  y[m, o] = sum_k x[m, k] * XT(c[o, k] * scale[o, k / g]
//                                          (+ zp[o, k / g]))  (+ bias[o])
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_dequant_mm_kernel` (:60) at few
// rows in its unpacked modes: the rowwise `row_epi` (:114-128, epilogue
// :153-162), where rowwise scales commute with the K sum, so the codes enter
// the dot as plain numbers and scale / zero point / bias apply once per
// output; and the grouped mode (:129-142), where each scaled weight is first
// ROUNDED TO x's DTYPE XT (the TPU kernel's decode scratch has x's dtype,
// :325) and x multiplies the rounded weight; code * scale + zp is one fused
// multiply-add, as XLA computes it.  Codes are int8, uint8
// (widened before the scale, as :133-135) or float8 e4m3.  The layers below
// the 32-row cut-off take it: at batch 1 the FLUX modulation linears and the
// time / vector / guidance MLPs, M = 1 (grouped under the default int8
// recipe, K 3072 in 3 groups of 1024).
//
// At M <= 32 the product is a GEMV, bound by the bytes of the weight
// (O*K bytes) over memory bandwidth.  Each warp owns one output row o: every
// lane reads 8 codes as one 8-byte load per 256-wide K chunk, and the block
// stages that chunk of x (all M rows, as fp32) in shared memory once for
// its 8 warps.  In the grouped mode the 8 codes of a load lie in one group
// (g % 8 == 0), whose scale and zero point the lane reads once per chunk.
// Partial sums stay in registers (MT = M rounded up to 1, 4, 8, 16 or 32)
// and are reduced across the warp at the end.  K must be a multiple of 8
// (the wrapper zero-pads in the row mode).
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8, NT = WARPS * 32, KC = 256;

enum { I8 = 0, U8 = 1, E4M3 = 2 };  // code kinds

__device__ __forceinline__ float code_f32(unsigned b, int kind) {
  if (kind == I8) return static_cast<float>(static_cast<int8_t>(b));
  if (kind == U8) return static_cast<float>(b);
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(v);
}

template <int MT, typename XT, bool GROUPED, typename OutT>
__global__ void __launch_bounds__(NT)
    dequant_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ zp,
                        const float* __restrict__ bias, OutT* __restrict__ out, int M, int K,
                        int O, int kind, int G, int g) {
  extern __shared__ float xs_s[];  // [M][KC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.x * WARPS + warp;
  float acc[MT], xsum[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = xsum[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * KC; i += NT) {
      const int m = i / KC, kk = i - m * KC;
      xs_s[i] = kk < kc ? sdnq::to_f32(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int kk = lane * 8;
    if (o < O && kk < kc) {
      const uint2 wv = *reinterpret_cast<const uint2*>(w + (size_t)o * K + k0 + kk);
      float wf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wf[j] = code_f32((wv.x >> (8 * j)) & 0xffu, kind);
        wf[j + 4] = code_f32((wv.y >> (8 * j)) & 0xffu, kind);
      }
      if constexpr (GROUPED) {
        // the 8 codes lie in one group: scale (and zero point) once, and
        // each weight rounded to x's dtype before it multiplies x
        const size_t gi = (size_t)o * G + (k0 + kk) / g;
        const float s = scale[gi];
        const float z = zp ? zp[gi] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = zp ? __fmaf_rn(wf[j], s, z) : __fmul_rn(wf[j], s);
          wf[j] = sdnq::to_f32(sdnq::from_f32<XT>(v));
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float* xr = xs_s + m * KC + kk;
          float s = 0.f, t = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s = fmaf(xr[j], wf[j], s);
            t += xr[j];
          }
          acc[m] += s;
          xsum[m] += t;
        }
      }
    }
  }
  if (o >= O) return;

  const float sc = GROUPED ? 1.f : scale[o];
  const float z = (!GROUPED && zp) ? zp[o] : 0.f;
  const float b = bias ? bias[o] : 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float a = acc[m], t = xsum[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        t += __shfl_xor_sync(0xffffffffu, t, off);
      }
      if (lane == 0) {
        float v = GROUPED ? a : a * sc;
        if (!GROUPED && zp) v += t * z;
        if (bias) v += b;
        out[(size_t)m * O + o] = sdnq::from_f32<OutT>(v);
      }
    }
  }
}

struct Call {
  const void* x;
  const uint8_t* w;
  const float *s, *zp, *b;
  void* out;
  int M, K, O, kind, G, g;
};

template <int MT, typename XT, typename OutT>
void launch(const Call& c, cudaStream_t st) {
  const dim3 grid((c.O + WARPS - 1) / WARPS);
  const size_t smem = (size_t)c.M * KC * sizeof(float);
  if (c.G > 1)
    dequant_gemv_kernel<MT, XT, true, OutT><<<grid, NT, smem, st>>>(
        static_cast<const XT*>(c.x), c.w, c.s, c.zp, c.b, static_cast<OutT*>(c.out), c.M, c.K,
        c.O, c.kind, c.G, c.g);
  else
    dequant_gemv_kernel<MT, XT, false, OutT><<<grid, NT, smem, st>>>(
        static_cast<const XT*>(c.x), c.w, c.s, c.zp, c.b, static_cast<OutT*>(c.out), c.M, c.K,
        c.O, c.kind, c.G, c.g);
}

template <int MT, typename XT>
int launch_out(const Call& c, int out_kind, cudaStream_t st) {
  if (out_kind == sdnq::F32)
    launch<MT, XT, float>(c, st);
  else if (out_kind == sdnq::BF16)
    launch<MT, XT, __nv_bfloat16>(c, st);
  else if (out_kind == sdnq::F16)
    launch<MT, XT, __half>(c, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int MT>
int launch_x(const Call& c, int x_kind, int out_kind, cudaStream_t st) {
  if (x_kind == sdnq::F32) return launch_out<MT, float>(c, out_kind, st);
  if (x_kind == sdnq::BF16) return launch_out<MT, __nv_bfloat16>(c, out_kind, st);
  if (x_kind == sdnq::F16) return launch_out<MT, __half>(c, out_kind, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bit-plane mode (B2's packed mode, sdnq_tpu/kernels/dequant_mm.py:73-113):
//
//   y[m, o] = sum_k x[m, k] * XT(v(code[o, k]) * scale[o, k / g]
//                               (+ zp[o, k / g]))  (+ bias[o])
//
// with every scaled weight rounded to x's dtype XT, rowwise (G = 1) too,
// as in the JAX kernel.  The codes lie in `bits` byte planes of S bytes a
// row: bit i of byte b of plane j is bit j of code k = i * S + b.
//
// Bound by the weight's bytes (O * bits * S) at M = 1, so the bytes move at
// full width and the decode takes a few operations a code:
// - a warp owns a row; each lane loads 4 consecutive bytes of every plane,
//   all planes' loads issued together: a warp's load of a plane is 128
//   contiguous bytes; 16 warps a block;
// - the 32 codes of a lane's 4 bytes (8 a byte, S apart) come out of two 4
//   x 4 byte transposes and an 8 x 8 bit transpose a byte position
//   (sdnq::bitplane_codes4, shared with csrc/decode_weight.cu), each value
//   out of sdnq::decode_value, and two weights round to bf16 in one cvt;
// - x is read in its natural order: the lane's codes i * S + b .. + 3 meet
//   x[m, i*S + b .. + 3], one 16-byte shared-memory load a row and
//   segment.  x is staged there as fp32 for a chunk of BB bytes of every
//   plane: the whole row where M * 32 * S bytes fit XS_BYTES (K 3072 up to
//   4 rows), staged once by blocks that persist (as many as the card
//   holds, each walking rows a grid apart); else chunks of 128 bytes a
//   multiple, two barriers each, a block for every 16 rows;
// - where S and the group are multiples of 4 (and the planes aligned to
//   them) a lane's 4 codes of a segment share one group's scale; else each
//   code looks up its own and the planes are read a byte at a time.
constexpr int BP_WARPS = 16, BP_NT = BP_WARPS * 32;
constexpr int XS_BYTES = 48 * 1024;
constexpr int XS_MAX_BYTES = 32 * 32 * 128;  // 32 rows, 8 segments, 128 bytes, fp32

template <typename XT>
__device__ __forceinline__ void round4(float (&w)[4]) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(w[0], w[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(w[2], w[3]);
    w[0] = __low2float(a);
    w[1] = __high2float(a);
    w[2] = __low2float(b);
    w[3] = __high2float(b);
  }
}

// One warp's row o over plane bytes c0 .. cend - 1 (the staged chunk of x
// starts at c0), 4 consecutive bytes of every plane a lane: one 4-byte load
// a plane (`aligned`) or a byte at a time.  8-byte loads of wider codes
// measured slower on an H100; 16-byte loads of 8-bit codes gained about 4%
// at M 1, less than an R1 step's spread, and were not kept.  WIDE: codes
// of more than 8 bits; FLOAT: minifloat codes.  Without a zero point z is 0
// (v * s + 0 rounds as v * s).
template <bool WIDE, bool FLOAT, int MT, typename XT>
__device__ __forceinline__ void bitplane_row(const uint8_t* __restrict__ wr, const float* __restrict__ sr,
                                             const float* __restrict__ zr, const float* __restrict__ xs,
                                             int M, int K, int S, int bits, int G, int g, unsigned ginv,
                                             const sdnq::CodeFmt& f, bool aligned, int BB, int c0,
                                             int cend, int lane, float (&acc)[MT]) {
  constexpr int NP = WIDE ? 16 : 8;  // planes
  for (int b = c0 + 4 * lane; b < cend; b += 32 * 4) {
    unsigned wv[16] = {};
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < bits) {
        const uint8_t* p = wr + (size_t)j * S + b;
        if (aligned) {
          wv[j] = __ldg(reinterpret_cast<const unsigned*>(p));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (b + q < S) wv[j] |= static_cast<unsigned>(__ldg(p + q)) << (8 * q);
        }
      }
    }
    // the scale and zero point of each segment's first code
    float s8[8], z8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gi = G == 1 ? 0 : min(sdnq::div_magic(i * S + b, g, ginv), G - 1);
      s8[i] = __ldg(sr + gi);
      z8[i] = zr ? __ldg(zr + gi) : 0.f;
    }
    uint64_t lo[4], hi[4];  // byte i of lo[q]: bits 0-7 of code i * S + b + q (8-15 in hi)
    sdnq::bitplane_codes4(wv, lo);
    if constexpr (WIDE) sdnq::bitplane_codes4(wv + 8, hi);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k0 = i * S + b;
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned code = static_cast<unsigned>(lo[q] >> (8 * i)) & 0xffu;
        if constexpr (WIDE) code |= (static_cast<unsigned>(hi[q] >> (8 * i)) & 0xffu) << 8;
        w[q] = sdnq::decode_value<FLOAT>(code, f);
      }
      if (aligned) {  // the 4 codes lie in one group (past K: x is 0 there)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = __fmaf_rn(w[q], s8[i], z8[i]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gi = G == 1 ? 0 : min(sdnq::div_magic(k0 + q, g, ginv), G - 1);
          w[q] = __fmaf_rn(w[q], __ldg(sr + gi), zr ? __ldg(zr + gi) : 0.f);
        }
      }
      round4<XT>(w);  // each scaled weight rounded to x's dtype
      const float* xi = xs + (size_t)i * BB + (b - c0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float4 xv = *reinterpret_cast<const float4*>(xi + (size_t)m * 8 * BB);
          acc[m] = fmaf(xv.x, w[0], acc[m]);
          acc[m] = fmaf(xv.y, w[1], acc[m]);
          acc[m] = fmaf(xv.z, w[2], acc[m]);
          acc[m] = fmaf(xv.w, w[3], acc[m]);
        }
      }
    }
  }
}

// bitplane_row for the code kind (FLOAT), a choice of the kernel's arguments
template <bool WIDE, int MT, typename XT>
__device__ __forceinline__ void bitplane_row_of(const uint8_t* __restrict__ wr,
                                                const float* __restrict__ sr,
                                                const float* __restrict__ zr,
                                                const float* __restrict__ xs, int M, int K, int S,
                                                int bits, int G, int g, unsigned ginv,
                                                const sdnq::CodeFmt& f, bool aligned, int BB,
                                                int c0, int cend, int lane, float (&acc)[MT]) {
  if (f.is_float)
    bitplane_row<WIDE, true, MT, XT>(wr, sr, zr, xs, M, K, S, bits, G, g, ginv, f, aligned, BB,
                                     c0, cend, lane, acc);
  else
    bitplane_row<WIDE, false, MT, XT>(wr, sr, zr, xs, M, K, S, bits, G, g, ginv, f, aligned, BB,
                                      c0, cend, lane, acc);
}

template <int MT, typename XT, typename OutT>
__global__ void __launch_bounds__(BP_NT)
    dequant_gemv_kernel_bitplane(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                                 const float* __restrict__ scale, const float* __restrict__ zp,
                                 const float* __restrict__ bias, OutT* __restrict__ out, int M,
                                 int K, int S, int O, int bits, int G, int g, unsigned ginv,
                                 sdnq::CodeFmt f, int aligned, int BB) {
  extern __shared__ __align__(16) float xs_s[];  // [M][8][BB]: x[m, i*S + c0 + bb]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = M * 8 * BB;  // staged values a chunk
  const unsigned bbinv = 0xffffffffu / static_cast<unsigned>(BB);
  // the block's rows o0 + warp, o0 + gridDim.x * BP_WARPS + warp, ..; x is
  // staged once where one chunk holds a row (BB >= S), else every chunk
  // for every pass
  for (int o0 = blockIdx.x * BP_WARPS; o0 < O; o0 += gridDim.x * BP_WARPS) {
    const int o = o0 + warp;
    const uint8_t* wr = w + (size_t)o * bits * S;
    const float* sr = scale + (size_t)o * G;
    const float* zr = zp ? zp + (size_t)o * G : nullptr;
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    for (int c0 = 0; c0 < S; c0 += BB) {
      const int cend = min(S, c0 + BB);
      if (BB < S || o0 == static_cast<int>(blockIdx.x) * BP_WARPS) {
        __syncthreads();  // every warp is done with the last chunk
#pragma unroll 4
        for (int idx = threadIdx.x; idx < n; idx += BP_NT) {  // all loads in flight
          const int r = sdnq::div_magic(idx, BB, bbinv), i = r & 7;
          const int b = c0 + idx - r * BB;
          xs_s[idx] = (b < cend && i * S + b < K)
                          ? sdnq::to_f32(x[(size_t)(r >> 3) * K + (size_t)i * S + b])
                          : 0.f;
        }
        __syncthreads();
      }
      if (o < O) {
        if (bits > 8)
          bitplane_row_of<true, MT, XT>(wr, sr, zr, xs_s, M, K, S, bits, G, g, ginv, f, aligned,
                                        BB, c0, cend, lane, acc);
        else
          bitplane_row_of<false, MT, XT>(wr, sr, zr, xs_s, M, K, S, bits, G, g, ginv, f, aligned,
                                         BB, c0, cend, lane, acc);
      }
    }
    if (o < O) {
      const float bo = bias ? bias[o] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float a = acc[m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
          if (lane == 0) out[(size_t)m * O + o] = sdnq::from_f32<OutT>(bias ? a + bo : a);
        }
      }
    }
  }
}

template <int MT, typename XT, typename OutT>
int launch_bitplane(const void* x, const uint8_t* w, const float* s, const float* zp,
                    const float* b, void* out, int M, int K, int S, int O, int bits, int G,
                    const sdnq::CodeFmt& f, cudaStream_t st) {
  auto kernel = dequant_gemv_kernel_bitplane<MT, XT, OutT>;
  static bool ready = false;  // chunks of more than 48 KB at many rows
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, XS_MAX_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  // bytes of staged x a byte of every plane; the whole row in one chunk
  // where it fits XS_BYTES, else chunks of 128 bytes a multiple
  const int per = M * 8 * 4, S4 = (S + 3) & ~3;
  const int BB = per * S4 <= XS_BYTES ? S4 : 128 * max(1, XS_BYTES / (per * 128));
  const int g = K / G;
  const bool aligned = S % 4 == 0 && (G == 1 || g % 4 == 0) &&
                       reinterpret_cast<uintptr_t>(w) % 4 == 0;
  // blocks that persist where x is staged once: as many as fit on the
  // card, each walking rows a grid apart
  const size_t smem = (size_t)per * BB;
  int blocks = (O + BP_WARPS - 1) / BP_WARPS;
  if (BB >= S) {
    static size_t occ_smem = 0;
    static int occ_blocks = 0;  // blocks an SM holds at that shared memory
    if (occ_smem != smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BP_NT, smem);
      occ_blocks = max(1, sms * per_sm);
      occ_smem = smem;
    }
    blocks = min(blocks, occ_blocks);
  }
  kernel<<<blocks, BP_NT, smem, st>>>(
      static_cast<const XT*>(x), w, s, zp, b, static_cast<OutT*>(out), M, K, S, O, bits, G, g,
      0xffffffffu / static_cast<unsigned>(g), f, aligned, BB);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_bitplane_types(int x_kind, int out_kind, const void* x, const uint8_t* w,
                          const float* s, const float* zp, const float* b, void* out, int M,
                          int K, int S, int O, int bits, int G, const sdnq::CodeFmt& f,
                          cudaStream_t st) {
  if (x_kind == sdnq::F32 && out_kind == sdnq::F32)
    return launch_bitplane<MT, float, float>(x, w, s, zp, b, out, M, K, S, O, bits, G, f, st);
  if (x_kind == sdnq::F32 && out_kind == sdnq::BF16)
    return launch_bitplane<MT, float, __nv_bfloat16>(x, w, s, zp, b, out, M, K, S, O, bits, G,
                                                     f, st);
  if (x_kind == sdnq::BF16 && out_kind == sdnq::F32)
    return launch_bitplane<MT, __nv_bfloat16, float>(x, w, s, zp, b, out, M, K, S, O, bits, G,
                                                     f, st);
  if (x_kind == sdnq::BF16 && out_kind == sdnq::BF16)
    return launch_bitplane<MT, __nv_bfloat16, __nv_bfloat16>(x, w, s, zp, b, out, M, K, S, O,
                                                             bits, G, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) contiguous of x_kind; w (O, K) codes of code_kind (0 int8, 1
// uint8, 2 e4m3); G = 1: scale (O,), zp (O,) or null; G > 1: scale, zp
// (O, G) with g = K / G a multiple of 8; bias (O,) or null; all f32; out
// (M, O) of out_kind.  1 <= M <= 32, K % 8 == 0.
extern "C" int sdnq_dequant_gemv(const void* x, const void* w, const void* scale, const void* zp,
                                 const void* bias, void* out, int M, int K, int O, int G,
                                 int x_kind, int code_kind, int out_kind, void* stream) {
  if (M < 1 || M > 32 || K % 8 != 0 || G < 1 || K % G != 0 || (G > 1 && (K / G) % 8 != 0) ||
      code_kind < I8 || code_kind > E4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{x, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
               static_cast<const float*>(zp), static_cast<const float*>(bias), out, M, K, O,
               code_kind, G, K / G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (M == 1)
    rc = launch_x<1>(c, x_kind, out_kind, st);
  else if (M <= 4)
    rc = launch_x<4>(c, x_kind, out_kind, st);
  else if (M <= 8)
    rc = launch_x<8>(c, x_kind, out_kind, st);
  else if (M <= 16)
    rc = launch_x<16>(c, x_kind, out_kind, st);
  else
    rc = launch_x<32>(c, x_kind, out_kind, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Bit-plane mode.  x (M, K) of x_kind (f32 or bf16), contiguous; w (O,
// bits*S) uint8 planes, S = ceil(K / 8); scale, zp (O, G) f32 with g = K /
// G (zp, bias (O,) may be null); the code format as sdnq::code_fmt's
// arguments; out (M, O) of out_kind (f32 or bf16).  1 <= M <= 32.
extern "C" int sdnq_dequant_gemv_bitplane(const void* x, const void* w, const void* scale,
                                          const void* zp, const void* bias, void* out, int M,
                                          int K, int S, int O, int G, int bits, int is_float,
                                          int code_min, int e, int m, int fbias, int x_kind,
                                          int out_kind, void* stream) {
  if (M < 1 || M > 32 || K < 1 || G < 1 || K % G != 0 || bits < 1 || bits > 16 || S != (K + 7) / 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const sdnq::CodeFmt f = sdnq::code_fmt(is_float, code_min, e, m, fbias);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    return launch_bitplane_types<1>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                    f, st);
  if (M <= 4)
    return launch_bitplane_types<4>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                    f, st);
  if (M <= 8)
    return launch_bitplane_types<8>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                    f, st);
  if (M <= 16)
    return launch_bitplane_types<16>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                     f, st);
  return launch_bitplane_types<32>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G, f,
                                   st);
}
