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
// row (bit i of byte b of plane j is bit j of code k = i*S + b); x comes
// in the same byte-major column order, x'[m, 8*b + i] = x[m, i*S + b]
// (zero past K), so each lane takes one byte of every plane per 256-code
// chunk (the warp's loads of a plane are 32 consecutive bytes), rebuilds
// its 8 codes with a shift-and-mask and a shift-or a plane, decodes and
// scales them (each in its own group: they lie S apart) and multiplies the
// 8 staged x' values.  Bound by the weight's bytes (O * bits * S) at M = 1,
// as the unpacked GEMV; the decode costs some 3 * bits operations a code.
template <int MT, typename XT, typename OutT>
__global__ void __launch_bounds__(NT)
    dequant_gemv_kernel_bitplane(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                                 const float* __restrict__ scale, const float* __restrict__ zp,
                                 const float* __restrict__ bias, OutT* __restrict__ out, int M,
                                 int K, int S, int O, int bits, int G, int g, sdnq::CodeFmt f) {
  extern __shared__ float xs_s[];  // [M][KC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.x * WARPS + warp;
  const int Kx = 8 * S;  // columns of x'
  const size_t wrow = (size_t)bits * S;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < S; c0 += KC / 8) {  // KC codes: KC / 8 bytes of each plane
    __syncthreads();
    for (int i = threadIdx.x; i < M * KC; i += NT) {
      const int m = i / KC, kk = i - m * KC;
      const int col = 8 * c0 + kk;
      xs_s[i] = col < Kx ? sdnq::to_f32(x[(size_t)m * Kx + col]) : 0.f;
    }
    __syncthreads();
    const int b = c0 + lane;
    if (o < O && b < S) {
      unsigned code[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) code[i] = 0u;
      for (int j = 0; j < bits; ++j) {
        const unsigned byte = w[(size_t)o * wrow + (size_t)j * S + b];
#pragma unroll
        for (int i = 0; i < 8; ++i) code[i] |= ((byte >> i) & 1u) << j;
      }
      float wf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = i * S + b;
        float v = 0.f;
        if (k < K) {
          const size_t gi = (size_t)o * G + (G == 1 ? 0 : k / g);
          const float c = sdnq::decode_value(code[i], f);
          v = sdnq::to_f32(sdnq::from_f32<XT>(zp ? __fmaf_rn(c, scale[gi], zp[gi])
                                                  : __fmul_rn(c, scale[gi])));
        }
        wf[i] = v;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float* xr = xs_s + m * KC + lane * 8;
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) s = fmaf(xr[i], wf[i], s);
          acc[m] += s;
        }
      }
    }
  }
  if (o >= O) return;
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

template <int MT, typename XT, typename OutT>
int launch_bitplane(const void* x, const uint8_t* w, const float* s, const float* zp,
                    const float* b, void* out, int M, int K, int S, int O, int bits, int G,
                    const sdnq::CodeFmt& f, cudaStream_t st) {
  const dim3 grid((O + WARPS - 1) / WARPS);
  const size_t smem = (size_t)M * KC * sizeof(float);
  dequant_gemv_kernel_bitplane<MT, XT, OutT><<<grid, NT, smem, st>>>(
      static_cast<const XT*>(x), w, s, zp, b, static_cast<OutT*>(out), M, K, S, O, bits, G,
      K / G, f);
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

// Bit-plane mode.  x (M, 8*S) of x_kind (f32 or bf16) in byte-major column
// order (see the kernel); w (O, bits*S) uint8 planes, 8*S >= K; scale, zp
// (O, G) f32 with g = K / G (zp, bias (O,) may be null); the code format as
// sdnq::CodeFmt's fields; out (M, O) of out_kind (f32 or bf16).  1 <= M <= 32.
extern "C" int sdnq_dequant_gemv_bitplane(const void* x, const void* w, const void* scale,
                                          const void* zp, const void* bias, void* out, int M,
                                          int K, int S, int O, int G, int bits, int is_float,
                                          int code_min, int e, int m, int fbias, int is_signed,
                                          int x_kind, int out_kind, void* stream) {
  if (M < 1 || M > 32 || K < 1 || G < 1 || K % G != 0 || bits < 1 || bits > 16 || 8 * S < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const sdnq::CodeFmt f{is_float, code_min, e, m, fbias, is_signed};
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
