// B2: weight-only GEMM on unpacked 8-bit codes, tensor-core tiles.
//
//   grouped:  out[m, o] = sum_k x[m, k] * bf16(code[o, k] * scale[o, k / g]
//                                             (+ zp[o, k / g]))  (+ bias[o])
//   row mode: out[m, o] = (sum_k x[m, k] * code[o, k]) * scale[o]
//                         (+ xsum[m] * zp[o]) (+ bias[o])
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_dequant_mm_kernel` (:60,
// wrapper `_dequant_mm_pallas` :245) in its unpacked modes: grouped scales
// (:129-142) and the rowwise `row_epi` (:114-128, epilogue :153-159).  The
// TPU kernel decodes each (BN, BK) weight tile into a scratch of x's dtype
// (:325), bf16 on the chip (x is cast at :1222), and multiplies that in bf16
// with fp32 accumulation; the bias is added in fp32 (:160-162).  So in the
// grouped mode every scaled weight is ROUNDED TO BF16 before the product:
// that rounding point is the function, and the group-dot algebra of B5 (each
// group's partial dot weighted by its scale) would compute another number.
// code * scale + zp is one fused multiply-add (one rounding), as XLA
// computes the JAX kernel's decode.
// In the row mode the codes enter the product exactly (int8, uint8 and e4m3
// are exact in bf16) and the scale, zero point and bias apply once per
// output; xsum is the fp32 row sum of x, computed by the wrapper.
//
// Codes are int8, uint8 (widened before the scale) or float8 e4m3.  x is
// bf16 (M, Kp) and the codes (N, Kp), Kp a multiple of 16 (the wrapper pads
// with zeros); columns k >= K decode to 0 whatever the zero point, and
// their group is never read.  Any group size g dividing K.
//
// The FLUX.1-dev DiT and T5-XXL under SDNQ's default int8 recipe (auto group
// 1024) take the grouped mode at M = 77 .. 4608 rows (2*M*N*K operations
// against about (M+N)*K bytes: bound by the tensor cores from a few hundred
// rows).  This first design is simple: 128x128 output tiles, 8 warps each
// owning 64x32; a K stage of 32 codes.  The x stage (64 bytes a row) and
// the raw code stage (32 bytes a row) are double-buffered with cp.async;
// after a stage lands, each thread decodes 16 codes of one weight row into
// a bf16 tile in padded shared memory (the layout of scaled_mm.cu's bf16 B
// operand), and the warps run mma.sync m16n8k16 bf16 -> fp32 on it while the
// next stage loads.  The epilogue uses round-to-nearest single operations.
// wgmma/TMA pipelines and a decode shared by several M tiles are later work.
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, NT = 256;
constexpr int BK = 32;          // codes (k values) per stage
constexpr int LDX = 2 * BK + 16;  // padded x row in shared memory (bytes)
constexpr int LDR = BK + 16;      // padded raw code row (bytes)
constexpr int LDW = 2 * BK + 16;  // padded decoded bf16 weight row (bytes)

enum { I8 = 0, U8 = 1, E4M3 = 2 };  // code kinds

template <int KIND>
__device__ __forceinline__ float code_f32(unsigned b) {
  if constexpr (KIND == I8) return static_cast<float>(static_cast<int8_t>(b));
  if constexpr (KIND == U8) return static_cast<float>(b);
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(v);
}

template <int KIND, bool ROW, typename OutT>
__global__ void __launch_bounds__(NT)
    dequant_mm_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ W,
                      const float* __restrict__ scale, const float* __restrict__ zp,
                      const float* __restrict__ xsum, const float* __restrict__ bias,
                      OutT* __restrict__ out, int M, int N, int K, int Kp, int G, int g) {
  __shared__ __align__(16) uint8_t sX[2][BM * LDX];
  __shared__ __align__(16) uint8_t sR[2][BN * LDR];
  __shared__ __align__(16) uint8_t sW[BN * LDW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t xrow = (size_t)Kp * 2;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < (BM * 2 * BK / 16) / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int gr = m0 + r;
      const bool ok = gr < M && k0 + cb / 2 < Kp;
      sdnq::cp_async16(&sX[stage][r * LDX + cb],
                       X + (size_t)(ok ? gr : 0) * xrow + (ok ? (size_t)k0 * 2 + cb : 0), ok);
    }
    {
      const int r = tid >> 1, cb = (tid & 1) * 16;
      const int gn = n0 + r;
      const bool ok = gn < N && k0 + cb < Kp;
      sdnq::cp_async16(&sR[stage][r * LDR + cb],
                       W + (size_t)(ok ? gn : 0) * Kp + (ok ? k0 + cb : 0), ok);
    }
    sdnq::cp_async_commit();
  };

  // this thread's decode slot: weight row dr, codes dc .. dc + 15 of a stage
  const int dr = tid >> 1, dc = (tid & 1) * 16;
  const int dn = n0 + dr;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int nk = (Kp + BK - 1) / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const int k0 = kt * BK;
    sdnq::cp_async_wait<0>();
    __syncthreads();  // stage kt landed; every warp is done with sW

    // decode 16 codes of row dn into bf16
    {
      const uint4 raw = *reinterpret_cast<const uint4*>(&sR[cur][dr * LDR + dc]);
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
      const int kb = k0 + dc;
      float s = 0.f, z = 0.f;
      int gend = 0;  // first k of the next group
      float wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = kb + j;
        float w = 0.f;
        if (dn < N && k < K) {
          w = code_f32<KIND>((words[j >> 2] >> (8 * (j & 3))) & 0xffu);
          if constexpr (!ROW) {
            if (k >= gend) {  // a new group: its scale (and zero point)
              const int gi = k / g;
              gend = (gi + 1) * g;
              s = scale[(size_t)dn * G + gi];
              z = zp ? zp[(size_t)dn * G + gi] : 0.f;
            }
            w = zp ? __fmaf_rn(w, s, z) : __fmul_rn(w, s);
          }
        }
        wv[j] = w;
      }
      // rounded to bf16 here: the grouped mode's rounding point
      uint4* dst = reinterpret_cast<uint4*>(&sW[dr * LDW + dc * 2]);
      dst[0] = make_uint4(sdnq::pack_bf16x2(wv[0], wv[1]), sdnq::pack_bf16x2(wv[2], wv[3]),
                          sdnq::pack_bf16x2(wv[4], wv[5]), sdnq::pack_bf16x2(wv[6], wv[7]));
      dst[1] = make_uint4(sdnq::pack_bf16x2(wv[8], wv[9]), sdnq::pack_bf16x2(wv[10], wv[11]),
                          sdnq::pack_bf16x2(wv[12], wv[13]), sdnq::pack_bf16x2(wv[14], wv[15]));
    }
    // the next stage's buffers were last read before this iteration's barrier
    if (kt + 1 < nk) load_stage(cur ^ 1, k0 + BK);
    __syncthreads();  // sW holds stage kt

    const uint8_t* a_s = sX[cur];
#pragma unroll
    for (int ks = 0; ks < 2 * BK; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = a_s + (wm * 64 + mi * 16 + gq) * LDX + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDX);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDX + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = sW + (wn * 32 + ni * 8 + gq) * LDW + ks + t4 * 4;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) sdnq::mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + gq + h * 8;
      if (row >= M) continue;
      const float xs = (ROW && zp) ? xsum[row] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= N) continue;
          float v = acc[mi][ni][h * 2 + j];
          if constexpr (ROW) {
            v = __fmul_rn(v, scale[col]);
            if (zp) v = __fadd_rn(v, __fmul_rn(xs, zp[col]));
          }
          if (bias) v = __fadd_rn(v, bias[col]);
          out[(size_t)row * N + col] = sdnq::from_f32<OutT>(v);
        }
    }
}

template <int KIND, bool ROW>
int launch(const void* x, const void* w, const float* scale, const float* zp, const float* xsum,
           const float* bias, void* out, int M, int N, int K, int Kp, int G, int g, int out_kind,
           cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uint8_t* X = static_cast<const uint8_t*>(x);
  const uint8_t* Wp = static_cast<const uint8_t*>(w);
  if (out_kind == sdnq::F32)
    dequant_mm_kernel<KIND, ROW, float><<<grid, NT, 0, s>>>(
        X, Wp, scale, zp, xsum, bias, static_cast<float*>(out), M, N, K, Kp, G, g);
  else if (out_kind == sdnq::BF16)
    dequant_mm_kernel<KIND, ROW, __nv_bfloat16><<<grid, NT, 0, s>>>(
        X, Wp, scale, zp, xsum, bias, static_cast<__nv_bfloat16*>(out), M, N, K, Kp, G, g);
  else if (out_kind == sdnq::F16)
    dequant_mm_kernel<KIND, ROW, __half><<<grid, NT, 0, s>>>(
        X, Wp, scale, zp, xsum, bias, static_cast<__half*>(out), M, N, K, Kp, G, g);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROW>
int launch_kind(int kind, const void* x, const void* w, const float* scale, const float* zp,
                const float* xsum, const float* bias, void* out, int M, int N, int K, int Kp,
                int G, int g, int out_kind, cudaStream_t s) {
  if (kind == I8)
    return launch<I8, ROW>(x, w, scale, zp, xsum, bias, out, M, N, K, Kp, G, g, out_kind, s);
  if (kind == U8)
    return launch<U8, ROW>(x, w, scale, zp, xsum, bias, out, M, N, K, Kp, G, g, out_kind, s);
  if (kind == E4M3)
    return launch<E4M3, ROW>(x, w, scale, zp, xsum, bias, out, M, N, K, Kp, G, g, out_kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Bit-plane mode: B2's packed mode (sdnq_tpu/kernels/dequant_mm.py:73-113).
//
//   out[m, o] = sum_k x[m, k] * bf16(v(code[o, k]) * scale[o, k / g]
//                                    (+ zp[o, k / g]))  (+ bias[o])
//
// v is the integer code plus its offset-binary minimum, or the minifloat
// value (sdnq::decode_value); G = 1 (rowwise) and any group g dividing K.
// As in the JAX kernel every scaled weight is rounded to bf16 before the
// product, rowwise too (the packed mode has no row epilogue).
//
// Layout (sdnq_tpu/packing.py pack_codes): a row of K codes, padded to 8*S,
// is stored as `bits` planes of S bytes; bit i of byte b of plane j is bit j
// of code k = i*S + b.  So one byte of every plane holds 8 codes S apart.
// The wrapper hands the kernel x with its columns in the same byte-major
// order, x'[m, 8*b + i] = x[m, i*S + b] (zero where i*S + b >= K), padded
// to 8*Sp columns, Sp = S rounded up to 4 (the weight's planes are
// re-padded to Sp bytes where S % 4 != 0).  The sum over k is the same sum
// over k', so the tiles, stages and mma.sync loop of the unpacked mode
// serve unchanged: a stage of 32 k' columns is 4 bytes of every plane,
// copied with 4-byte cp.async into a `bits` x 4-byte row of shared memory.
// Each thread then rebuilds 16 codes of one weight row from two bytes of
// every plane (one shift-and-mask and one shift-or a plane and code: some
// 3 * bits integer operations a value, against the unpacked mode's one
// load), decodes, scales (each code's own group: the 16 codes lie in 8
// segments) and rounds to bf16.  The decode bounds this mode, not the
// tensor cores; a decode shared by several M tiles is later work.
constexpr int LDP = 64;  // a weight row's stage bytes: up to 16 planes x 4

template <typename OutT>
__global__ void __launch_bounds__(NT)
    dequant_mm_kernel_bitplane(const uint8_t* __restrict__ X, const uint8_t* __restrict__ W,
                               const float* __restrict__ scale, const float* __restrict__ zp,
                               const float* __restrict__ bias, OutT* __restrict__ out, int M,
                               int N, int K, int S, int Sp, int bits, int G, int g,
                               sdnq::CodeFmt f) {
  __shared__ __align__(16) uint8_t sX[2][BM * LDX];
  __shared__ __align__(16) uint8_t sR[2][BN * LDP];
  __shared__ __align__(16) uint8_t sW[BN * LDW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Kp = 8 * Sp;  // columns of x'
  const size_t xrow = (size_t)Kp * 2, wrow = (size_t)bits * Sp;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * 2 * BK / 16) / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int gr = m0 + r;
      sdnq::cp_async16(&sX[stage][r * LDX + cb],
                       X + (size_t)(gr < M ? gr : 0) * xrow + (size_t)k0 * 2 + cb, gr < M);
    }
    for (int c = tid; c < BN * bits; c += NT) {  // 4 bytes of each plane
      const int r = c / bits, j = c - r * bits;
      const int gn = n0 + r;
      sdnq::cp_async4(&sR[stage][r * LDP + 4 * j],
                      W + (size_t)(gn < N ? gn : 0) * wrow + (size_t)j * Sp + 4 * kt, gn < N);
    }
    sdnq::cp_async_commit();
  };

  const int dr = tid >> 1, h = tid & 1;  // decode slot: row dr, k' 16h .. 16h + 15
  const int dn = n0 + dr;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int nk = Sp / 4;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    sdnq::cp_async_wait<0>();
    __syncthreads();  // stage kt landed; every warp is done with sW

    {
      // bytes b and b + 1 of every plane: codes (b + bb, segment i) at
      // position p = 8 * bb + i of this thread's 16
      unsigned code[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) code[p] = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < bits) {
          const unsigned pl =
              *reinterpret_cast<const unsigned short*>(&sR[cur][dr * LDP + 4 * j + 2 * h]);
#pragma unroll
          for (int p = 0; p < 16; ++p) code[p] |= ((pl >> p) & 1u) << j;
        }
      }
      const int b = 4 * kt + 2 * h;
      float wv[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int bb = b + (p >> 3), k = (p & 7) * S + bb;
        float w = 0.f;
        if (dn < N && bb < S && k < K) {
          const size_t gi = (size_t)dn * G + (G == 1 ? 0 : k / g);
          const float v = sdnq::decode_value(code[p], f);
          w = zp ? __fmaf_rn(v, scale[gi], zp[gi]) : __fmul_rn(v, scale[gi]);
        }
        wv[p] = w;
      }
      uint4* dst = reinterpret_cast<uint4*>(&sW[dr * LDW + h * 32]);
      dst[0] = make_uint4(sdnq::pack_bf16x2(wv[0], wv[1]), sdnq::pack_bf16x2(wv[2], wv[3]),
                          sdnq::pack_bf16x2(wv[4], wv[5]), sdnq::pack_bf16x2(wv[6], wv[7]));
      dst[1] = make_uint4(sdnq::pack_bf16x2(wv[8], wv[9]), sdnq::pack_bf16x2(wv[10], wv[11]),
                          sdnq::pack_bf16x2(wv[12], wv[13]), sdnq::pack_bf16x2(wv[14], wv[15]));
    }
    if (kt + 1 < nk) load_stage(cur ^ 1, kt + 1);
    __syncthreads();  // sW holds stage kt

    const uint8_t* a_s = sX[cur];
#pragma unroll
    for (int ks = 0; ks < 2 * BK; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = a_s + (wm * 64 + mi * 16 + gq) * LDX + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDX);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDX + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = sW + (wn * 32 + ni * 8 + gq) * LDW + ks + t4 * 4;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) sdnq::mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 64 + mi * 16 + gq + hh * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= N) continue;
          float v = acc[mi][ni][hh * 2 + j];
          if (bias) v = __fadd_rn(v, bias[col]);
          out[(size_t)row * N + col] = sdnq::from_f32<OutT>(v);
        }
    }
}

}  // namespace

// x (M, Kp) bf16; w (N, Kp) codes of code_kind (0 int8, 1 uint8, 2 e4m3);
// Kp a multiple of 16 and K <= Kp the true contraction length (columns past
// K must be zero in x).  Grouped (row_mode 0): scale, zp (N, G) f32, g = K /
// G; row mode (row_mode 1): scale, zp (N,) f32 and xsum (M,) f32 (the row
// sums of x, needed with zp).  zp, bias (N,) f32 may be null; out (M, N) of
// out_kind.
extern "C" int sdnq_dequant_mm(const void* x, const void* w, const void* scale, const void* zp,
                               const void* xsum, const void* bias, void* out, int M, int K, int Kp,
                               int N, int G, int code_kind, int row_mode, int out_kind,
                               void* stream) {
  if (M < 0 || N < 0 || K < 1 || Kp < K || Kp % 16 != 0 || G < 1 || K % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_mode && (G != 1 || (zp && !xsum))) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  const float* xs = static_cast<const float*>(xsum);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = K / G;
  if (row_mode)
    return launch_kind<true>(code_kind, x, w, s, z, xs, b, out, M, N, K, Kp, G, g, out_kind, st);
  return launch_kind<false>(code_kind, x, w, s, z, xs, b, out, M, N, K, Kp, G, g, out_kind, st);
}

// Bit-plane mode.  x (M, 8*Sp) bf16 in byte-major column order (see the
// kernel); w (N, bits*Sp) uint8 planes of Sp bytes, Sp a multiple of 4 and
// S <= Sp the planes' true length (8*S >= K); scale, zp (N, G) f32 with g =
// K / G (zp, bias (N,) may be null); the code format as sdnq::CodeFmt's
// fields; out (M, N) of out_kind.
extern "C" int sdnq_dequant_mm_bitplane(const void* x, const void* w, const void* scale,
                                        const void* zp, const void* bias, void* out, int M, int K,
                                        int S, int Sp, int N, int G, int bits, int is_float,
                                        int code_min, int e, int m, int fbias, int is_signed,
                                        int out_kind, void* stream) {
  if (M < 0 || N < 0 || K < 1 || G < 1 || K % G != 0 || bits < 1 || bits > 16 || Sp % 4 != 0 ||
      S > Sp || 8 * S < K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const sdnq::CodeFmt f{is_float, code_min, e, m, fbias, is_signed};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uint8_t* X = static_cast<const uint8_t*>(x);
  const uint8_t* Wp = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = K / G;
  if (out_kind == sdnq::F32)
    dequant_mm_kernel_bitplane<float><<<grid, NT, 0, st>>>(
        X, Wp, s, z, b, static_cast<float*>(out), M, N, K, S, Sp, bits, G, g, f);
  else if (out_kind == sdnq::BF16)
    dequant_mm_kernel_bitplane<__nv_bfloat16><<<grid, NT, 0, st>>>(
        X, Wp, s, z, b, static_cast<__nv_bfloat16*>(out), M, N, K, S, Sp, bits, G, g, f);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
