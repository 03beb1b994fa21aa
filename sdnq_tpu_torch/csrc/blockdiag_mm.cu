// B6: weight-only group-dot GEMV for a few rows on half-split packed codes.
//
//   y[m, o] = sum_g scale[o, g] * (x_g[m] . c_g[o]) + xsum[m, g] * zpc[o, g]
//             (+ bias[o])
//
// the same function as B5 (kernels/dequant_mm.py explains the layout
// and zpc), for M <= 8 rows.  Replaces sdnq_tpu/kernels/dequant_mm.py
// `_blockdiag_kernel` (:593, wrapper `_blockdiag_mm_pallas` :655).  The TPU
// kernel expands x block-diagonally so that one matrix-unit dot yields
// every group's partial; on the H100 the product at M = 1 is a GEMV bound
// by the bytes of the packed weight (O * K * BITS / 8: 28.3 MB for the
// FLUX.1-dev 3072 -> 18432 modulation linear, 8.5 us at 3.35 TB/s), so it
// is written as one: each warp owns one output row o and streams its
// packed bytes as 8-byte loads, 256 bytes per warp step; the block stages
// the x values those bytes meet (for each of the P = 8 / BITS bit fields,
// x[m, t * seg + c0 .. + 256]) in shared memory as fp32 once for its 8
// warps.  Every lane decodes its 8 bytes field by field, forms the 8-term
// dot and x sum in fp32 and weights them with the group's scale and zpc
// right away (8 | g and g | seg, so the 8 codes of a field share a
// group); the lanes' sums are reduced across the warp at the end and the
// bias added.
#include "common.cuh"

namespace {

constexpr int WARPS = 8, NT = WARPS * 32, CB = 256;  // CB: packed bytes per warp step

template <int MT, int BITS, typename XT, typename OutT>
__global__ void __launch_bounds__(NT)
    blockdiag_mm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ zpc,
                        const float* __restrict__ bias, OutT* __restrict__ out, int M, int K,
                        int O, int G, int g) {
  constexpr int P = 8 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  extern __shared__ __align__(16) float xs_s[];  // [P][M][CB]
  const int seg = K / P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.x * WARPS + warp;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < seg; c0 += CB) {
    const int cb = min(CB, seg - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < P * M * CB; i += NT) {
      const int tm = i / CB, kk = i - tm * CB;
      const int t = tm / M, m = tm - t * M;
      xs_s[i] = kk < cb ? sdnq::to_f32(x[(size_t)m * K + t * seg + c0 + kk]) : 0.f;
    }
    __syncthreads();
    const int kk = lane * 8;
    if (o < O && kk < cb) {
      const uint2 wv = *reinterpret_cast<const uint2*>(w + (size_t)o * seg + c0 + kk);
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const int gi = (t * seg + c0 + kk) / g;
        const float sc = scale[(size_t)o * G + gi];
        const float z = zpc[(size_t)o * G + gi];
        float cf[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cf[j] = static_cast<float>((wv.x >> (8 * j + BITS * t)) & MASK);
          cf[j + 4] = static_cast<float>((wv.y >> (8 * j + BITS * t)) & MASK);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < M) {
            const float4* xr = reinterpret_cast<const float4*>(xs_s + (t * M + m) * CB + kk);
            const float4 a = xr[0], b = xr[1];
            const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
            float s = 0.f, xsum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              s = fmaf(xv[j], cf[j], s);
              xsum += xv[j];
            }
            acc[m] = fmaf(s, sc, acc[m]);
            acc[m] = fmaf(xsum, z, acc[m]);
          }
        }
      }
    }
  }
  if (o >= O) return;

  const float b = bias ? bias[o] : 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float a = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) out[(size_t)m * O + o] = sdnq::from_f32<OutT>(a + b);
    }
  }
}

template <int MT, int BITS, typename XT, typename OutT>
int launch(const void* x, const uint8_t* w, const float* s, const float* z, const float* b,
           void* out, int M, int K, int O, int G, int g, cudaStream_t st) {
  const dim3 grid((O + WARPS - 1) / WARPS);
  const size_t smem = (size_t)(8 / BITS) * M * CB * sizeof(float);
  auto kern = blockdiag_mm_kernel<MT, BITS, XT, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, NT, smem, st>>>(static_cast<const XT*>(x), w, s, z, b, static_cast<OutT*>(out), M,
                               K, O, G, g);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int BITS, typename XT>
int launch_out(const void* x, const uint8_t* w, const float* s, const float* z, const float* b,
               void* out, int M, int K, int O, int G, int g, int out_kind, cudaStream_t st) {
  if (out_kind == sdnq::F32) return launch<MT, BITS, XT, float>(x, w, s, z, b, out, M, K, O, G, g, st);
  if (out_kind == sdnq::BF16)
    return launch<MT, BITS, XT, __nv_bfloat16>(x, w, s, z, b, out, M, K, O, G, g, st);
  if (out_kind == sdnq::F16) return launch<MT, BITS, XT, __half>(x, w, s, z, b, out, M, K, O, G, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MT, int BITS>
int launch_x(const void* x, const uint8_t* w, const float* s, const float* z, const float* b,
             void* out, int M, int K, int O, int G, int g, int x_kind, int out_kind,
             cudaStream_t st) {
  if (x_kind == sdnq::F32)
    return launch_out<MT, BITS, float>(x, w, s, z, b, out, M, K, O, G, g, out_kind, st);
  if (x_kind == sdnq::BF16)
    return launch_out<MT, BITS, __nv_bfloat16>(x, w, s, z, b, out, M, K, O, G, g, out_kind, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MT>
int launch_bits(int bits, const void* x, const uint8_t* w, const float* s, const float* z,
                const float* b, void* out, int M, int K, int O, int G, int g, int x_kind,
                int out_kind, cudaStream_t st) {
  if (bits == 4) return launch_x<MT, 4>(x, w, s, z, b, out, M, K, O, G, g, x_kind, out_kind, st);
  if (bits == 2) return launch_x<MT, 2>(x, w, s, z, b, out, M, K, O, G, g, x_kind, out_kind, st);
  if (bits == 1) return launch_x<MT, 1>(x, w, s, z, b, out, M, K, O, G, g, x_kind, out_kind, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B6's general mode: 3/5/6/7-bit integer codes in two or three half-split
// field planes, and minifloat codes of 1 to 7 bits (the JAX kernel decodes
// those through packing.decode_float, dequant_mm.py:641-646).  A lane takes
// 8 consecutive codes k .. k + 7 per 256-code chunk: they lie in one field
// of 8 consecutive bytes of every plane (the narrowest plane's segment K /
// pmax is a multiple of 8), read as one 8-byte load a plane; the code is
// the shift-or of the planes' fields, decoded to its value for minifloats
// (sdnq::decode_value).  A byte of a 4-bit plane is thus read once for
// each of its two fields (the second time from cache); the stream is still
// the weight's bytes.  Integer codes enter raw (zpc carries code_min);
// minifloats are values and their zpc is the zero point alone.
template <int MT, typename XT, typename OutT>
__global__ void __launch_bounds__(NT)
    blockdiag_mm_kernel_gen(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                            const float* __restrict__ scale, const float* __restrict__ zpc,
                            const float* __restrict__ bias, OutT* __restrict__ out, int M, int K,
                            int O, int G, int g, int bits, sdnq::CodeFmt f) {
  constexpr int KC = 256;  // codes per chunk
  extern __shared__ __align__(16) float xs_s[];  // [M][KC]
  const sdnq::HalfSplit hs = sdnq::halfsplit_planes(bits, K);
  const size_t wrow = (size_t)K * bits / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.x * WARPS + warp;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * KC; i += NT) {
      const int m = i / KC, kk = i - m * KC;
      xs_s[i] = kk < kc ? sdnq::to_f32(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int k = k0 + lane * 8;
    if (o < O && lane * 8 < kc) {
      unsigned code[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) code[j] = 0u;
#pragma unroll
      for (int pd = 0; pd < 3; ++pd) {
        if (pd < hs.n) {
          const int t = k / hs.seg[pd], b = k - t * hs.seg[pd];
          const uint2 v = *reinterpret_cast<const uint2*>(w + (size_t)o * wrow + hs.off[pd] + b);
          const int sh = hs.width[pd] * t;
          const unsigned mask = (1u << hs.width[pd]) - 1u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            code[j] |= ((v.x >> (8 * j + sh)) & mask) << hs.shift[pd];
            code[j + 4] |= ((v.y >> (8 * j + sh)) & mask) << hs.shift[pd];
          }
        }
      }
      const size_t gi = (size_t)o * G + k / g;  // 8 | g: one group
      const float sc = scale[gi], z = zpc[gi];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float* xr = xs_s + m * KC + lane * 8;
          float s = 0.f, xsum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float c =
                f.is_float ? sdnq::decode_value(code[j], f) : static_cast<float>(code[j]);
            s = fmaf(xr[j], c, s);
            xsum += xr[j];
          }
          acc[m] = fmaf(s, sc, acc[m]);
          acc[m] = fmaf(xsum, z, acc[m]);
        }
      }
    }
  }
  if (o >= O) return;

  const float b = bias ? bias[o] : 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float a = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) out[(size_t)m * O + o] = sdnq::from_f32<OutT>(a + b);
    }
  }
}

template <int MT, typename XT, typename OutT>
int launch_gen(const void* x, const uint8_t* w, const float* s, const float* z, const float* b,
               void* out, int M, int K, int O, int G, int g, int bits, const sdnq::CodeFmt& f,
               cudaStream_t st) {
  const dim3 grid((O + WARPS - 1) / WARPS);
  const size_t smem = (size_t)M * 256 * sizeof(float);
  blockdiag_mm_kernel_gen<MT, XT, OutT><<<grid, NT, smem, st>>>(
      static_cast<const XT*>(x), w, s, z, b, static_cast<OutT*>(out), M, K, O, G, g, bits, f);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_gen_types(int x_kind, int out_kind, const void* x, const uint8_t* w, const float* s,
                     const float* z, const float* b, void* out, int M, int K, int O, int G, int g,
                     int bits, const sdnq::CodeFmt& f, cudaStream_t st) {
  if (x_kind == sdnq::F32 && out_kind == sdnq::F32)
    return launch_gen<MT, float, float>(x, w, s, z, b, out, M, K, O, G, g, bits, f, st);
  if (x_kind == sdnq::F32 && out_kind == sdnq::BF16)
    return launch_gen<MT, float, __nv_bfloat16>(x, w, s, z, b, out, M, K, O, G, g, bits, f, st);
  if (x_kind == sdnq::BF16 && out_kind == sdnq::F32)
    return launch_gen<MT, __nv_bfloat16, float>(x, w, s, z, b, out, M, K, O, G, g, bits, f, st);
  if (x_kind == sdnq::BF16 && out_kind == sdnq::BF16)
    return launch_gen<MT, __nv_bfloat16, __nv_bfloat16>(x, w, s, z, b, out, M, K, O, G, g, bits,
                                                        f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) contiguous of x_kind (f32 or bf16); w (O, K*bits/8) half-split
// uint8; scale, zpc (O, K/g) f32; bias (O,) f32 or null; out (M, O) of
// out_kind.  1 <= M <= 8; bits 1, 2 or 4; 8 divides g and g divides the
// field segment K*bits/8.
extern "C" int sdnq_blockdiag_mm(const void* x, const void* w, const void* scale, const void* zpc,
                                 const void* bias, void* out, int M, int K, int O, int g, int bits,
                                 int x_kind, int out_kind, void* stream) {
  if (bits != 1 && bits != 2 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = K * bits / 8;
  if (M < 1 || M > 8 || g <= 0 || K % g != 0 || g % 8 != 0 || seg % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zpc);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / g;
  if (M == 1) return launch_bits<1>(bits, x, wp, s, z, b, out, M, K, O, G, g, x_kind, out_kind, st);
  return launch_bits<8>(bits, x, wp, s, z, b, out, M, K, O, G, g, x_kind, out_kind, st);
}

// B6's general mode: x (M, K) of x_kind (f32 or bf16); w (O, K*bits/8)
// half-split uint8 of `bits` (1..7) bits; integer codes (is_float 0, raw)
// or minifloat codes (is_float 1 and the format's e, m, bias);
// scale, zpc (O, K/g) f32; bias (O,) f32 or null; out (M, O) of out_kind
// (f32 or bf16).  1 <= M <= 8; 8 divides g and the narrowest plane's
// segment.
extern "C" int sdnq_blockdiag_mm_gen(const void* x, const void* w, const void* scale,
                                     const void* zpc, const void* bias, void* out, int M, int K,
                                     int O, int g, int bits, int is_float, int e, int m, int fbias,
                                     int x_kind, int out_kind, void* stream) {
  if (bits < 1 || bits > 7 || M < 1 || M > 8 || g <= 0 || K % g != 0 || g % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pmax = (bits & 1) ? 8 : (bits & 2) ? 4 : 2;
  if (K % pmax != 0 || (K / pmax) % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const sdnq::CodeFmt f = sdnq::code_fmt(is_float, 0, e, m, fbias);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zpc);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / g;
  if (M == 1)
    return launch_gen_types<1>(x_kind, out_kind, x, wp, s, z, b, out, M, K, O, G, g, bits, f, st);
  return launch_gen_types<8>(x_kind, out_kind, x, wp, s, z, b, out, M, K, O, G, g, bits, f, st);
}
