// B5 and B7: group-dot GEMMs on half-split packed integer codes.
//
//   acc[m, o] = sum_g scale[o, g] * P_g[m, o] + xsum[m, g] * zpc[o, g]
//   P_g[m, o] = sum_{k in group g} x[m, k] * c[o, k]
//   B5: out = acc + bias[o]                    x bf16, P_g fp32
//   B7: out = acc * xs[m] + bias[o]            x int8 codes, P_g int32
//
// c are the raw codes 0 .. 2^BITS - 1 of a half-split row: byte b of the
// packed row (seg = K * BITS / 8 bytes) carries code k = t * seg + b in its
// bit field t.  zpc = zero point + code_min * scale folds the offset-binary
// minimum of signed formats into the zero-point term, as the JAX package
// does; xsum is the per-row group sum of x (fp32 for B5, the integer sum of
// the int8 codes for B7), computed by the wrapper.
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_groupdot_kernel` (:355,
// wrapper `_groupdot_mm_pallas` :471) in its group-dot mode, and
// `_groupdot_i8_kernel` (:741, wrapper `_groupdot_i8_mm_pallas` :808).  The
// TPU kernels decode a full-K weight block into VMEM once per column block
// and reuse it over the rows; here a block decodes its own K step, and the
// group-dot algebra is used at every M (the TPU's "expanded" mode, which
// rounds code * scale + zero point to bf16 before the dot, is not carried
// over: the group-dot sum is the more exact of the two).
//
// At the FLUX.1-dev shapes (M = 4096 or 4608, K = 3072 .. 15360) the product
// is bound by tensor-core operations (2*M*N*K against M*K*2 + N*K/2 bytes).
// This first design is simple and follows csrc/scaled_mm.cu: 128x128 output
// tiles, 8 warps each owning 64x32, 64-byte x stages and the matching code
// bytes double-buffered with cp.async, mma.sync (bf16 m16n8k16 for B5, s8
// m16n8k32 for B7).  A K step covers BK consecutive codes of one field
// (BK = 32 for B5, 64 for B7), so it loads BK bytes of each packed row and
// decodes one bit field of them into the B fragments in registers; every
// packed byte is thus read once per field (the weight stream is K bytes per
// row, twice the packed size at 4 bits).  Each group's partial sum stays
// in registers and is scaled when the group ends (BK divides g, g divides
// seg); the epilogue adds the bias.  The fp32 folds use round-to-nearest
// single operations (no FMA contraction), so B7, whose partials are exact
// integers, equals its plain version bit for bit.  wgmma/TMA pipelines and
// decoding both fields of a byte per load are later work.
//
// B5's general mode (GEN) takes every other half-split code: 3-, 5-, 6- and
// 7-bit integers, stored as two or three field planes (6 = 4 + 2: code >> 2
// in a 4-bit plane, code & 3 in a 2-bit plane, sdnq::halfsplit_planes), and
// minifloat codes of 1 to 7 bits (the `_groupdot_kernel` of the JAX package
// decodes those through packing.decode_float, dequant_mm.py:393-401).  A
// K step of 32 consecutive codes lies in one field of each plane (the
// narrowest plane's segment K / pmax is a multiple of 32), so the stage
// copies 32 bytes of every plane into one shared-memory row; each B
// fragment's code is a shift-and-mask of its byte in every plane and a
// shift-or of the fields, and a minifloat code is then decoded to its
// value (sdnq::decode_value), exact in bf16.  Integer codes enter raw, as
// in the 1/2/4-bit mode (zpc carries code_min); minifloats are signed
// values, so their zpc is the zero point alone (zero for the signed
// formats).  Group boundaries only need to fall on K steps (32 | g).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, NT = 256;
constexpr int BKB = 64;         // bytes of an x row per stage
constexpr int LDS = BKB + 16;   // padded shared-memory row (bytes)
constexpr int LDG = 3 * 32 + 16;  // GEN: 32 bytes of up to three planes a row

enum { BF16X = 0, S8X = 1 };    // B5 / B7
constexpr int GEN = 0;          // BITS of B5's general mode (planes at run time)

// four codes of bit field `sh` of four packed bytes, as four int8 lanes
template <int BITS>
__device__ __forceinline__ unsigned dec_s8x4(unsigned v, int sh) {
  constexpr unsigned MASK4 = 0x01010101u * ((1u << BITS) - 1u);
  return (v >> sh) & MASK4;
}

// two codes of bit field `sh` of two packed bytes, as a bf16 pair (codes
// below 2^8 are exact in bf16)
template <int BITS>
__device__ __forceinline__ unsigned dec_bf16x2(unsigned v, int sh) {
  constexpr unsigned MASK = (1u << BITS) - 1u;
  return sdnq::pack_bf16x2(static_cast<float>((v >> sh) & MASK),
                           static_cast<float>((v >> (8 + sh)) & MASK));
}

template <int KIND, int BITS, typename OutT>
__global__ void __launch_bounds__(NT)
    groupdot_mm_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ W,
                       const float* __restrict__ scale, const float* __restrict__ zpc,
                       const float* __restrict__ xsum, const float* __restrict__ xs,
                       const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                       int K, int G, int g, int gen_bits, sdnq::CodeFmt f) {
  constexpr int LDW = BITS == GEN ? LDG : LDS;
  __shared__ __align__(16) uint8_t sX[2][BM * LDS];
  __shared__ __align__(16) uint8_t sW[2][BN * LDW];
  using PartT = typename std::conditional<KIND == S8X, int, float>::type;
  constexpr int XB = KIND == S8X ? 1 : 2;  // bytes per x value
  constexpr int BK = BKB / XB;              // codes per stage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int seg = K * BITS / 8;              // bytes of a packed row
  const size_t xrow = (size_t)K * XB;
  const sdnq::HalfSplit hs = sdnq::halfsplit_planes(gen_bits, K);  // GEN only
  const size_t grow = (size_t)K * gen_bits / 8;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < (BM * BKB / 16) / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int gr = m0 + r;
      sdnq::cp_async16(&sX[stage][r * LDS + cb], X + (size_t)(gr < M ? gr : 0) * xrow +
                       (size_t)k0 * XB + cb, gr < M);
    }
    if constexpr (BITS == GEN) {
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        if (pl < hs.n) {  // 32 bytes of plane pl: its field k0 / seg[pl]
          const int pb = k0 % hs.seg[pl];
          for (int c = tid; c < BN * 2; c += NT) {
            const int r = c >> 1, cb = (c & 1) * 16;
            const int gn = n0 + r;
            sdnq::cp_async16(&sW[stage][r * LDW + pl * 32 + cb],
                             W + (size_t)(gn < N ? gn : 0) * grow + hs.off[pl] + pb + cb, gn < N);
          }
        }
      }
    } else {
      const int t = k0 / seg, b0 = k0 - t * seg;
      for (int c = tid; c < BN * BK / 16; c += NT) {
        const int r = c / (BK / 16), cb = (c % (BK / 16)) * 16;
        const int gn = n0 + r;
        sdnq::cp_async16(&sW[stage][r * LDS + cb], W + (size_t)(gn < N ? gn : 0) * seg + b0 + cb,
                         gn < N);
      }
    }
    sdnq::cp_async_commit();
  };

  float acc[4][4][4];
  PartT part[4][4][4];
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
    const int sh = BITS == GEN ? 0 : BITS * ((kt * BK) / seg);  // bit field of this step's codes
    int gsh[3];  // GEN: each plane's field of this step's codes
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      gsh[pl] = pl < hs.n ? hs.width[pl] * ((kt * BK) / hs.seg[pl]) : 0;
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
        const uint8_t* row = b_s + (wn * 32 + ni * 8 + gq) * LDW;
        if constexpr (BITS == GEN) {
          // codes k = ks/2 + t4*2 .. +1 and ks/2 + 8 + t4*2 .. +1, from the
          // same two bytes of every plane
          const int kb = ks / 2 + t4 * 2;
          unsigned c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int pd = 0; pd < 3; ++pd) {
            if (pd < hs.n) {
              const unsigned mask = (1u << hs.width[pd]) - 1u;
              const unsigned w0 = *reinterpret_cast<const unsigned short*>(row + pd * 32 + kb);
              const unsigned w1 = *reinterpret_cast<const unsigned short*>(row + pd * 32 + kb + 8);
              c[0] |= ((w0 >> gsh[pd]) & mask) << hs.shift[pd];
              c[1] |= ((w0 >> (8 + gsh[pd])) & mask) << hs.shift[pd];
              c[2] |= ((w1 >> gsh[pd]) & mask) << hs.shift[pd];
              c[3] |= ((w1 >> (8 + gsh[pd])) & mask) << hs.shift[pd];
            }
          }
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = f.is_float ? sdnq::decode_value(c[i], f) : static_cast<float>(c[i]);
          bfr[ni][0] = sdnq::pack_bf16x2(v[0], v[1]);
          bfr[ni][1] = sdnq::pack_bf16x2(v[2], v[3]);
        } else if constexpr (KIND == S8X) {
          // k = ks + t4*4 .. +3 and ks + 16 + t4*4 .. +3: one code byte each
          bfr[ni][0] = dec_s8x4<BITS>(*reinterpret_cast<const unsigned*>(row + ks + t4 * 4), sh);
          bfr[ni][1] =
              dec_s8x4<BITS>(*reinterpret_cast<const unsigned*>(row + ks + 16 + t4 * 4), sh);
        } else {
          // k = ks/2 + t4*2 .. +1 and ks/2 + 8 + t4*2 .. +1
          const int kb = ks / 2 + t4 * 2;
          const unsigned w0 = *reinterpret_cast<const unsigned short*>(row + kb);
          const unsigned w1 = *reinterpret_cast<const unsigned short*>(row + kb + 8);
          bfr[ni][0] = dec_bf16x2<BITS>(w0, sh);
          bfr[ni][1] = dec_bf16x2<BITS>(w1, sh);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (KIND == S8X)
            sdnq::mma_s8(part[mi][ni], af[mi], bfr[ni]);
          else
            sdnq::mma_bf16(part[mi][ni], af[mi], bfr[ni]);
        }
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
      const float xsv = KIND == S8X ? xs[row] : 1.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= N) continue;
          float v = acc[mi][ni][h * 2 + j];
          if (KIND == S8X) v = __fmul_rn(v, xsv);
          if (bias) v = __fadd_rn(v, bias[col]);
          out[(size_t)row * N + col] = sdnq::from_f32<OutT>(v);
        }
    }
}

template <int KIND, int BITS>
int launch(const void* x, const void* w, const float* scale, const float* zpc, const float* xsum,
           const float* xs, const float* bias, void* out, int M, int N, int K, int G, int g,
           int out_kind, cudaStream_t s, int gen_bits = 0, sdnq::CodeFmt f = {}) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uint8_t* X = static_cast<const uint8_t*>(x);
  const uint8_t* Wp = static_cast<const uint8_t*>(w);
  if (out_kind == sdnq::F32)
    groupdot_mm_kernel<KIND, BITS, float><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<float*>(out), M, N, K, G, g, gen_bits, f);
  else if (out_kind == sdnq::BF16)
    groupdot_mm_kernel<KIND, BITS, __nv_bfloat16><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<__nv_bfloat16*>(out), M, N, K, G, g,
        gen_bits, f);
  else if (out_kind == sdnq::F16)
    groupdot_mm_kernel<KIND, BITS, __half><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<__half*>(out), M, N, K, G, g, gen_bits,
        f);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_bits(int bits, const void* x, const void* w, const float* scale, const float* zpc,
                const float* xsum, const float* xs, const float* bias, void* out, int M, int N,
                int K, int G, int g, int out_kind, cudaStream_t s) {
  if (bits == 4)
    return launch<KIND, 4>(x, w, scale, zpc, xsum, xs, bias, out, M, N, K, G, g, out_kind, s);
  if (bits == 2)
    return launch<KIND, 2>(x, w, scale, zpc, xsum, xs, bias, out, M, N, K, G, g, out_kind, s);
  if (bits == 1)
    return launch<KIND, 1>(x, w, scale, zpc, xsum, xs, bias, out, M, N, K, G, g, out_kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K): bf16 (kind 0, B5) or int8 codes (kind 1, B7); w (N, K*bits/8)
// half-split uint8; scale, zpc (N, K/g) f32; xsum (M, K/g) f32; xs (M,) f32
// for kind 1 (null for kind 0); bias (N,) f32 or null; out (M, N) of
// out_kind.  bits 1, 2 or 4; the K step (32 codes for kind 0, 64 for kind 1)
// divides g and g divides the field segment K*bits/8.
extern "C" int sdnq_groupdot_mm(const void* x, const void* w, const void* scale, const void* zpc,
                                const void* xsum, const void* xs, const void* bias, void* out,
                                int M, int K, int N, int g, int bits, int kind, int out_kind,
                                void* stream) {
  const int bk = kind == S8X ? BKB : BKB / 2;
  if (bits != 1 && bits != 2 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = K * bits / 8;
  if (g <= 0 || K % g != 0 || g % bk != 0 || seg % g != 0 || (kind == S8X && !xs))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zpc);
  const float* xsm = static_cast<const float*>(xsum);
  const float* xsc = static_cast<const float*>(xs);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / g;
  if (kind == BF16X)
    return launch_bits<BF16X>(bits, x, w, s, z, xsm, xsc, b, out, M, N, K, G, g, out_kind, st);
  if (kind == S8X)
    return launch_bits<S8X>(bits, x, w, s, z, xsm, xsc, b, out, M, N, K, G, g, out_kind, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B5's general mode: x (M, K) bf16; w (N, K*bits/8) half-split uint8 of
// `bits` (1..7) bits in one to three field planes; integer codes
// (is_float 0: raw codes, zpc with code_min folded in) or minifloat codes
// (is_float 1 and the format's e, m, bias, is_signed: decoded values);
// scale, zpc (N, K/g) f32; xsum (M, K/g) f32; bias (N,) f32 or null; out
// (M, N) of out_kind.  32 divides g and the narrowest plane's segment.
extern "C" int sdnq_groupdot_mm_gen(const void* x, const void* w, const void* scale,
                                    const void* zpc, const void* xsum, const void* bias, void* out,
                                    int M, int K, int N, int g, int bits, int is_float, int e,
                                    int m, int fbias, int is_signed, int out_kind, void* stream) {
  if (bits < 1 || bits > 7 || g <= 0 || K % g != 0 || g % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pmax = (bits & 1) ? 8 : (bits & 2) ? 4 : 2;
  if ((K / pmax) % 32 != 0 || K % pmax != 0) return static_cast<int>(cudaErrorInvalidValue);
  const sdnq::CodeFmt f{is_float, 0, e, m, fbias, is_signed};
  return launch<BF16X, GEN>(x, w, static_cast<const float*>(scale),
                            static_cast<const float*>(zpc), static_cast<const float*>(xsum),
                            nullptr, static_cast<const float*>(bias), out, M, N, K, K / g, g,
                            out_kind, static_cast<cudaStream_t>(stream), bits, f);
}
