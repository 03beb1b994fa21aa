// B2: weight-only GEMV for few rows, rowwise int8/uint8 weights.
//
//   y[m, o] = (sum_k x[m, k] * codes[o, k]) * scale[o]
//             (+ rowsum(x)[m] * zp[o]) (+ bias[o])
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_dequant_mm_kernel` (:60) in its
// unpacked `row_epi` mode (:114-128, epilogue :153-162): rowwise scales
// commute with the K sum, so the codes enter the dot as plain integers and
// scale / zero point / bias apply once per output.  The layers below the
// 32-row cut-off take it: at batch 1 the FLUX modulation linears and the
// time / vector / guidance MLPs, M = 1.
//
// At M <= 32 the product is a GEMV, bound by the bytes of the weight
// (O*K int8) over memory bandwidth.  Each warp owns one output row o: every
// lane reads 8 codes as one 8-byte load per 256-wide K chunk, and the block
// stages that chunk of x (all M rows, as fp32) in shared memory once for
// its 8 warps.  Partial sums stay in registers (MT = M rounded up to 1, 4,
// 8, 16 or 32) and are reduced across the warp at the end.  K must be a
// multiple of 8 (the wrapper zero-pads).
#include "common.cuh"

namespace {

constexpr int WARPS = 8, NT = WARPS * 32, KC = 256;

template <int MT, typename XT, bool UNSIGNED, typename OutT>
__global__ void __launch_bounds__(NT)
    dequant_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ zp,
                        const float* __restrict__ bias, OutT* __restrict__ out, int M, int K,
                        int O) {
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
        const unsigned b0 = (wv.x >> (8 * j)) & 0xffu, b1 = (wv.y >> (8 * j)) & 0xffu;
        wf[j] = UNSIGNED ? static_cast<float>(b0) : static_cast<float>(static_cast<int8_t>(b0));
        wf[j + 4] = UNSIGNED ? static_cast<float>(b1) : static_cast<float>(static_cast<int8_t>(b1));
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

  const float sc = scale[o];
  const float z = zp ? zp[o] : 0.f;
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
        float v = a * sc;
        if (zp) v += t * z;
        if (bias) v += b;
        out[(size_t)m * O + o] = sdnq::from_f32<OutT>(v);
      }
    }
  }
}

template <int MT, typename XT, typename OutT>
void launch(const void* x, const uint8_t* w, const float* s, const float* zp, const float* b,
            void* out, int M, int K, int O, bool uns, cudaStream_t st) {
  const dim3 grid((O + WARPS - 1) / WARPS);
  const size_t smem = (size_t)M * KC * sizeof(float);
  if (uns)
    dequant_gemv_kernel<MT, XT, true, OutT><<<grid, NT, smem, st>>>(
        static_cast<const XT*>(x), w, s, zp, b, static_cast<OutT*>(out), M, K, O);
  else
    dequant_gemv_kernel<MT, XT, false, OutT><<<grid, NT, smem, st>>>(
        static_cast<const XT*>(x), w, s, zp, b, static_cast<OutT*>(out), M, K, O);
}

template <int MT, typename XT>
int launch_out(const void* x, const uint8_t* w, const float* s, const float* zp, const float* b,
               void* out, int M, int K, int O, bool uns, int out_kind, cudaStream_t st) {
  if (out_kind == sdnq::F32)
    launch<MT, XT, float>(x, w, s, zp, b, out, M, K, O, uns, st);
  else if (out_kind == sdnq::BF16)
    launch<MT, XT, __nv_bfloat16>(x, w, s, zp, b, out, M, K, O, uns, st);
  else if (out_kind == sdnq::F16)
    launch<MT, XT, __half>(x, w, s, zp, b, out, M, K, O, uns, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int MT>
int launch_x(const void* x, const uint8_t* w, const float* s, const float* zp, const float* b,
             void* out, int M, int K, int O, bool uns, int x_kind, int out_kind,
             cudaStream_t st) {
  if (x_kind == sdnq::F32)
    return launch_out<MT, float>(x, w, s, zp, b, out, M, K, O, uns, out_kind, st);
  if (x_kind == sdnq::BF16)
    return launch_out<MT, __nv_bfloat16>(x, w, s, zp, b, out, M, K, O, uns, out_kind, st);
  if (x_kind == sdnq::F16)
    return launch_out<MT, __half>(x, w, s, zp, b, out, M, K, O, uns, out_kind, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) contiguous of x_kind; w (O, K) int8 (w_unsigned = 0) or uint8
// codes; scale (O,), zp (O,) or null, bias (O,) or null, all f32; out (M, O)
// of out_kind.  1 <= M <= 32, K % 8 == 0.
extern "C" int sdnq_dequant_gemv(const void* x, const void* w, const void* scale, const void* zp,
                                 const void* bias, void* out, int M, int K, int O, int x_kind,
                                 int w_unsigned, int out_kind, void* stream) {
  if (M < 1 || M > 32 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool uns = w_unsigned != 0;
  int rc;
  if (M == 1)
    rc = launch_x<1>(x, wp, s, z, b, out, M, K, O, uns, x_kind, out_kind, st);
  else if (M <= 4)
    rc = launch_x<4>(x, wp, s, z, b, out, M, K, O, uns, x_kind, out_kind, st);
  else if (M <= 8)
    rc = launch_x<8>(x, wp, s, z, b, out, M, K, O, uns, x_kind, out_kind, st);
  else if (M <= 16)
    rc = launch_x<16>(x, wp, s, z, b, out, M, K, O, uns, x_kind, out_kind, st);
  else
    rc = launch_x<32>(x, wp, s, z, b, out, M, K, O, uns, x_kind, out_kind, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
