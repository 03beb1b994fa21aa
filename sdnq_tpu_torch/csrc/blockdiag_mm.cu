// B6: weight-only group-dot GEMV for a few rows on half-split packed codes.
//
//   y[m, o] = sum_g scale[o, g] * (x_g[m] . c_g[o]) + xsum[m, g] * zpc[o, g]
//             (+ bias[o])
//
// the same function as B5 (csrc/groupdot_mm.cu, which explains the layout
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
