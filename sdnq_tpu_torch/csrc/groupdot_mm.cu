// B7: group-dot GEMM of int8 rows and half-split packed integer codes.
//
//   acc[m, o] = sum_g scale[o, g] * P_g[m, o] + xsum[m, g] * zpc[o, g]
//   P_g[m, o] = sum_{k in group g} x[m, k] * c[o, k]       (int32)
//   out = acc * xs[m] + bias[o]
//
// x are int8 codes with row scales xs; c are the raw codes 0 .. 2^BITS - 1
// of a half-split row: byte b of the packed row (seg = K * BITS / 8 bytes)
// carries code k = t * seg + b in its bit field t.  zpc = zero point +
// code_min * scale folds the offset-binary minimum of signed formats into
// the zero-point term, as the JAX package does; xsum is the per-row group
// sum of the int8 codes, computed by the wrapper.
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_groupdot_i8_kernel` (:741,
// wrapper `_groupdot_i8_mm_pallas` :808).  The TPU kernel decodes a full-K
// weight block into VMEM once per column block and reuses it over the rows;
// here a block decodes its own K step.
//
// At the FLUX.1-dev shapes (M = 4096 or 4608, K = 3072 .. 15360) the product
// is bound by tensor-core operations (2*M*N*K against M*K + N*K/2 bytes).
// This first design is simple and follows csrc/scaled_mm.cu: 128x128 output
// tiles, 8 warps each owning 64x32, 64-byte x stages and the matching code
// bytes double-buffered with cp.async, mma.sync s8 m16n8k32.  A K step
// covers 64 consecutive codes of one field, so it loads 64 bytes of each
// packed row and decodes one bit field of them into the B fragments in
// registers; every packed byte is thus read once per field.  Each group's
// partial sum stays in registers and is scaled when the group ends (64
// divides g, g divides seg); the epilogue adds the bias.  The fp32 folds use
// round-to-nearest single operations (no FMA contraction), so the kernel,
// whose partials are exact integers, equals its plain version bit for bit.
// (B5, the bf16 weight-only product on the same codes, is now a decode
// into csrc/decode_weight.cu and the GEMM of csrc/wgmma_mm.cu.)
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, NT = 256;
constexpr int BKB = 64;         // bytes of an x row per stage
constexpr int LDS = BKB + 16;   // padded shared-memory row (bytes)

// four codes of bit field `sh` of four packed bytes, as four int8 lanes
template <int BITS>
__device__ __forceinline__ unsigned dec_s8x4(unsigned v, int sh) {
  constexpr unsigned MASK4 = 0x01010101u * ((1u << BITS) - 1u);
  return (v >> sh) & MASK4;
}

template <int BITS, typename OutT>
__global__ void __launch_bounds__(NT)
    groupdot_mm_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ W,
                       const float* __restrict__ scale, const float* __restrict__ zpc,
                       const float* __restrict__ xsum, const float* __restrict__ xs,
                       const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                       int K, int G, int g) {
  __shared__ __align__(16) uint8_t sX[2][BM * LDS];
  __shared__ __align__(16) uint8_t sW[2][BN * LDS];
  constexpr int BK = BKB;  // codes per stage (one byte each of x)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int seg = K * BITS / 8;              // bytes of a packed row
  const size_t xrow = (size_t)K;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < (BM * BKB / 16) / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int gr = m0 + r;
      sdnq::cp_async16(&sX[stage][r * LDS + cb], X + (size_t)(gr < M ? gr : 0) * xrow +
                       (size_t)k0 + cb, gr < M);
    }
    const int t = k0 / seg, b0 = k0 - t * seg;
    for (int c = tid; c < BN * BK / 16; c += NT) {
      const int r = c / (BK / 16), cb = (c % (BK / 16)) * 16;
      const int gn = n0 + r;
      sdnq::cp_async16(&sW[stage][r * LDS + cb], W + (size_t)(gn < N ? gn : 0) * seg + b0 + cb,
                       gn < N);
    }
    sdnq::cp_async_commit();
  };

  float acc[4][4][4];
  int part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][j][k] = 0.f;
        part[i][j][k] = 0;
      }

  const int nk = K / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_stage(cur ^ 1, (kt + 1) * BK);
      sdnq::cp_async_wait<1>();
    } else {
      sdnq::cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* a_s = sX[cur];
    const uint8_t* b_s = sW[cur];
    const int sh = BITS * ((kt * BK) / seg);  // bit field of this step's codes
#pragma unroll
    for (int ks = 0; ks < BKB; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = a_s + (wm * 64 + mi * 16 + gq) * LDS + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* row = b_s + (wn * 32 + ni * 8 + gq) * LDS;
        // k = ks + t4*4 .. +3 and ks + 16 + t4*4 .. +3: one code byte each
        bfr[ni][0] = dec_s8x4<BITS>(*reinterpret_cast<const unsigned*>(row + ks + t4 * 4), sh);
        bfr[ni][1] =
            dec_s8x4<BITS>(*reinterpret_cast<const unsigned*>(row + ks + 16 + t4 * 4), sh);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) sdnq::mma_s8(part[mi][ni], af[mi], bfr[ni]);
    }

    const int kend = (kt + 1) * BK;
    if (kend % g == 0) {  // the group ends: weight its partial, add the zp term
      const int gi = kend / g - 1;
      float sc[4][2], zc[4][2], xv[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          const size_t i = (size_t)(col < N ? col : 0) * G + gi;
          sc[ni][j] = scale[i];
          zc[ni][j] = zpc[i];
        }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 64 + mi * 16 + gq + h * 8;
          xv[mi][h] = xsum[(size_t)(row < M ? row : 0) * G + gi];
        }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, j = e & 1;
            float a = acc[mi][ni][e];
            a = __fadd_rn(a, __fmul_rn(static_cast<float>(part[mi][ni][e]), sc[ni][j]));
            a = __fadd_rn(a, __fmul_rn(xv[mi][h], zc[ni][j]));
            acc[mi][ni][e] = a;
            part[mi][ni][e] = 0;
          }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + gq + h * 8;
      if (row >= M) continue;
      const float xsv = xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= N) continue;
          float v = acc[mi][ni][h * 2 + j];
          v = __fmul_rn(v, xsv);
          if (bias) v = __fadd_rn(v, bias[col]);
          out[(size_t)row * N + col] = sdnq::from_f32<OutT>(v);
        }
    }
}

template <int BITS>
int launch(const void* x, const void* w, const float* scale, const float* zpc, const float* xsum,
           const float* xs, const float* bias, void* out, int M, int N, int K, int G, int g,
           int out_kind, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uint8_t* X = static_cast<const uint8_t*>(x);
  const uint8_t* Wp = static_cast<const uint8_t*>(w);
  if (out_kind == sdnq::F32)
    groupdot_mm_kernel<BITS, float><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<float*>(out), M, N, K, G, g);
  else if (out_kind == sdnq::BF16)
    groupdot_mm_kernel<BITS, __nv_bfloat16><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<__nv_bfloat16*>(out), M, N, K, G, g);
  else if (out_kind == sdnq::F16)
    groupdot_mm_kernel<BITS, __half><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<__half*>(out), M, N, K, G, g);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) int8 codes; w (N, K*bits/8) half-split uint8; scale, zpc (N, K/g)
// f32; xsum (M, K/g) f32; xs (M,) f32; bias (N,) f32 or null; out (M, N) of
// out_kind.  bits 1, 2 or 4; 64 divides g and g divides the field segment
// K*bits/8.
extern "C" int sdnq_groupdot_i8_mm(const void* x, const void* w, const void* scale,
                                   const void* zpc, const void* xsum, const void* xs,
                                   const void* bias, void* out, int M, int K, int N, int g,
                                   int bits, int out_kind, void* stream) {
  if (bits != 1 && bits != 2 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = K * bits / 8;
  if (g <= 0 || K % g != 0 || g % BKB != 0 || seg % g != 0 || !xs)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zpc);
  const float* xsm = static_cast<const float*>(xsum);
  const float* xsc = static_cast<const float*>(xs);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / g;
  if (bits == 4) return launch<4>(x, w, s, z, xsm, xsc, b, out, M, N, K, G, g, out_kind, st);
  if (bits == 2) return launch<2>(x, w, s, z, xsm, xsc, b, out, M, N, K, G, g, out_kind, st);
  return launch<1>(x, w, s, z, xsm, xsc, b, out, M, N, K, G, g, out_kind, st);
}
