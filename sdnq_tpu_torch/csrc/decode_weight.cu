// The decode half of B2's tiles, B5 and B7: a weight's codes become a
// weight W' (N, ldo) in natural k order, once a call, for csrc/wgmma_mm.cu.
//
//   unpacked, grouped:  W'[o, k] = T(code[o, k] * scale[o, k / g] (+ zp[o, k / g]))
//   unpacked, row mode: W'[o, k] = T(code[o, k])                         (exact)
//   bit-plane:          W'[o, k] = T(v(code[o, k]) * scale[o, k / g] (+ zp))
//   half-split:         W'[o, k] = T(v(code[o, k]))                      (exact)
//   half-split, int8:   W'[o, k] = code[o, k]                     (B7, exact)
//
// T is x's 16-bit type, bf16 or fp16: the TPU kernel's decode scratch has
// x's dtype (so an fp16 x multiplies weights rounded to fp16, not bf16),
// and the GEMM multiplies x and W' in that type.  Unpacked codes are int8,
// uint8, e4m3 or e5m2 (an e5m2 code is the high byte of its fp16 value;
// every e5m2 value is exact in fp16 and in bf16).  Half-split minifloats
// with 5 exponent bits reach 65536 and 98304, which fp16 cannot hold: at
// fp16 x they decode to inf, as in the TPU kernel's fp16 scratch.
//
// v is the integer code (plus code_min for bit-plane integers; B5 and B7
// fold code_min into zpc and take the raw code) or the minifloat value
// (sdnq::decode_value).  T columns K .. ldo - 1 (ldo = K rounded up to
// 8, so that a row is a whole number of 16-byte units for TMA) are written
// 0; B7's K is a multiple of 64.
//
// Replaces the decode of sdnq_tpu/kernels/dequant_mm.py `_dequant_mm_kernel`
// (:60: each weight tile decoded into a scratch of x's dtype, :325), of
// `_groupdot_kernel` (:355: a full-K weight block decoded once per column
// block and reused over the rows) and of `_groupdot_i8_kernel` (:741: the
// raw codes of a column block written once into an int8 scratch, :776-781,
// since every code of 1-7 bits is below 2^7).  Here the reuse goes through
// device memory and L2: the weight is decoded once a call, not once for
// every 128-row tile of x as the Ampere-style tiles did.  The rounding point
// of B2's grouped and bit-plane modes stays the function: each scaled
// weight is one fp32 FMA (or multiply) rounded to T before the product.
// B2's row mode, B5 and B7 write exact values (int8 / uint8 / e4m3 codes,
// raw half-split codes below 2^7, minifloats with at most 6 mantissa bits)
// and apply their scales in the GEMM's epilogue.
//
// Bound by bytes: codes in, 2 bytes (B7: 1) a weight out (the GEMM then
// reads W' again, mostly from L2 for the tiles that run together).  Each
// thread writes 8 consecutive values (one 16-byte store, B7's 8 bytes) in
// the unpacked and half-split kernels; the bit-plane kernel takes 4 bytes
// of every plane a thread, so a warp writes 128 consecutive values of each
// of the 8 segments, and rebuilds its 32 codes with byte and 8 x 8 bit
// transposes (sdnq::bitplane_codes4: a few operations a code, where a bit
// at a time took 3 * bits).
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
enum { I8 = 0, U8 = 1, E4M3 = 2, E5M2 = 3 };  // unpacked code kinds

template <int KIND>
__device__ __forceinline__ float code_f32(unsigned b) {
  if constexpr (KIND == I8) return static_cast<float>(static_cast<int8_t>(b));
  if constexpr (KIND == U8) return static_cast<float>(b);
  if constexpr (KIND == E5M2) {  // the high byte of an fp16
    __half_raw h;
    h.x = static_cast<unsigned short>(b << 8);
    return __half2float(__half(h));
  }
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(v);
}

// 8 values rounded to T, one 16-byte store
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(sdnq::pack_x2<T>(v[0], v[1]), sdnq::pack_x2<T>(v[2], v[3]),
                 sdnq::pack_x2<T>(v[4], v[5]), sdnq::pack_x2<T>(v[6], v[7]));
}

// one thread: 8 consecutive columns k0 .. k0 + 7 of row n
template <int KIND, bool ROW, typename T>
__global__ void __launch_bounds__(NT)
    decode_weight_unpacked(const uint8_t* __restrict__ W, const float* __restrict__ scale,
                           const float* __restrict__ zp, T* __restrict__ out, int N,
                           int K, int ldo, int G, int g) {
  const int k0 = (blockIdx.x * NT + threadIdx.x) * 8;
  if (k0 >= ldo) return;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const uint8_t* row = W + (size_t)n * K;
    unsigned b[8];
    if (K % 8 == 0) {  // k0 + 7 < K and the 8 codes are 8-byte aligned
      const uint2 u = *reinterpret_cast<const uint2*>(row + k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ((j < 4 ? u.x : u.y) >> (8 * (j & 3))) & 0xffu;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = k0 + j < K ? row[k0 + j] : 0u;
    }
    float v[8];
    if (!ROW && g % 8 == 0) {  // the 8 codes lie in one group
      const int gi = k0 / g;
      const float s = scale[(size_t)n * G + gi];
      const float z = zp ? zp[(size_t)n * G + gi] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = code_f32<KIND>(b[j]);
        v[j] = zp ? __fmaf_rn(w, s, z) : __fmul_rn(w, s);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + j;
        float w = 0.f;
        if (k < K) {
          w = code_f32<KIND>(b[j]);
          if constexpr (!ROW) {
            const int gi = k / g;
            w = zp ? __fmaf_rn(w, scale[(size_t)n * G + gi], zp[(size_t)n * G + gi])
                   : __fmul_rn(w, scale[(size_t)n * G + gi]);
          }
        }
        v[j] = w;
      }
    }
    // rounded to T by the store: the grouped mode's rounding point
    store8<T>(out + (size_t)n * ldo + k0, v);
  }
}

// Bit-plane codes (sdnq_tpu/packing.py pack_codes): a row of K codes, padded
// to 8 * S, is `bits` planes of S bytes; bit i of byte b of plane j is bit j
// of code k = i * S + b.  One thread: Q consecutive bytes b .. b + Q - 1 of
// every plane, codes i * S + b + q.  Q = 4 where S and the group are
// multiples of 4: one 4-byte load a plane, the codes rebuilt by
// sdnq::bitplane_codes4 (planes 0-7 and 8-15), the Q codes of a segment in
// one group and one 8-byte store; else a byte a plane and one 8 x 8 bit
// transpose.  8 * S = ldo, so every column of W' is written once.
template <int Q, typename T>
__global__ void __launch_bounds__(NT)
    decode_weight_bitplane(const uint8_t* __restrict__ W, const float* __restrict__ scale,
                           const float* __restrict__ zp, T* __restrict__ out, int N,
                           int K, int S, int bits, int G, int g, unsigned ginv, sdnq::CodeFmt f) {
  const int b = (blockIdx.x * NT + threadIdx.x) * Q;
  if (b >= S) return;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const uint8_t* row = W + (size_t)n * bits * S;
    uint64_t lo[Q], hi[Q];  // byte i of lo[q]: bits 0-7 of code i * S + b + q (8-15 in hi)
    if constexpr (Q == 4) {
      unsigned pl[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        pl[j] = j < bits ? *reinterpret_cast<const unsigned*>(row + (size_t)j * S + b) : 0u;
      sdnq::bitplane_codes4(pl, lo);
      sdnq::bitplane_codes4(pl + 8, hi);
    } else {
      lo[0] = hi[0] = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < bits) {
          const uint64_t byte = row[(size_t)j * S + b];
          if (j < 8)
            lo[0] |= byte << (8 * j);
          else
            hi[0] |= byte << (8 * (j - 8));
        }
      }
      lo[0] = sdnq::transpose8(lo[0]);
      hi[0] = sdnq::transpose8(hi[0]);
    }
    T* o = out + (size_t)n * 8 * S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = i * S + b;  // the first of this segment's Q codes
      const size_t gi = (size_t)n * G + (G == 1 ? 0 : sdnq::div_magic(k, g, ginv));
      float w[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        w[q] = 0.f;
        if (k + q < K) {
          const unsigned code = static_cast<unsigned>((lo[q] >> (8 * i)) & 0xffu) |
                                (static_cast<unsigned>((hi[q] >> (8 * i)) & 0xffu) << 8);
          const float v = sdnq::decode_value(code, f);
          w[q] = zp ? __fmaf_rn(v, scale[gi], zp[gi]) : __fmul_rn(v, scale[gi]);
        }
      }
      if constexpr (Q == 4)
        *reinterpret_cast<uint2*>(o + k) =
            make_uint2(sdnq::pack_x2<T>(w[0], w[1]), sdnq::pack_x2<T>(w[2], w[3]));
      else
        o[k] = sdnq::from_f32<T>(w[0]);
    }
  }
}

// Half-split codes (sdnq_tpu/packing.py halfsplit_planes): plane p holds
// fields of width[p] bits; code k lies in field k / seg[p] of byte k % seg[p]
// of plane p, and plane p contributes its field shifted left by shift[p].
// One thread: 8 consecutive codes k0 .. k0 + 7, which lie in 8 consecutive
// bytes (one 8-byte load) of each plane, since every seg[p] is a multiple
// of 8.  OutT bf16 or fp16 (B5, x's type): the raw code or the minifloat
// value (at most 7 bits: exact in either); int8 (B7):
// the raw integer code, below 2^7, as an int8 (the operand of the int8
// GEMM), 8 codes in one 8-byte store.
template <typename OutT>
__global__ void __launch_bounds__(NT)
    decode_weight_halfsplit(const uint8_t* __restrict__ W, OutT* __restrict__ out, int N, int K,
                            int bits, sdnq::CodeFmt f) {
  const int k0 = (blockIdx.x * NT + threadIdx.x) * 8;
  if (k0 >= K) return;
  const sdnq::HalfSplit hs = sdnq::halfsplit_planes(bits, K);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const uint8_t* row = W + (size_t)n * (K * bits / 8);
    unsigned c[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (p < hs.n) {
        const int t = k0 / hs.seg[p];
        const uint2 u = *reinterpret_cast<const uint2*>(row + hs.off[p] + (k0 - t * hs.seg[p]));
        const unsigned mask = (1u << hs.width[p]) - 1u;
        const unsigned sh = hs.width[p] * t;  // the field of these codes
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned byte = ((j < 4 ? u.x : u.y) >> (8 * (j & 3))) & 0xffu;
          c[j] |= ((byte >> sh) & mask) << hs.shift[p];
        }
      }
    }
    if constexpr (std::is_same<OutT, int8_t>::value) {
      *reinterpret_cast<uint2*>(out + (size_t)n * K + k0) =
          make_uint2(c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24,
                     c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24);
    } else {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = f.is_float ? sdnq::decode_value(c[j], f) : static_cast<float>(c[j]);
      store8<OutT>(out + (size_t)n * K + k0, v);
    }
  }
}

// threads along a row (x) and one row a block (y; a block walks rows
// gridDim.y apart past 65535)
dim3 grid(int per_row, int N) { return dim3((per_row + NT - 1) / NT, N < 65535 ? N : 65535); }

template <bool ROW, typename T>
int launch_unpacked(int kind, const uint8_t* w, const float* s, const float* z, void* out_,
                    int N, int K, int ldo, int G, cudaStream_t st) {
  const dim3 gr = grid(ldo / 8, N);
  const int g = K / G;
  T* out = static_cast<T*>(out_);
  if (kind == I8)
    decode_weight_unpacked<I8, ROW, T><<<gr, NT, 0, st>>>(w, s, z, out, N, K, ldo, G, g);
  else if (kind == U8)
    decode_weight_unpacked<U8, ROW, T><<<gr, NT, 0, st>>>(w, s, z, out, N, K, ldo, G, g);
  else if (kind == E4M3)
    decode_weight_unpacked<E4M3, ROW, T><<<gr, NT, 0, st>>>(w, s, z, out, N, K, ldo, G, g);
  else if (kind == E5M2)
    decode_weight_unpacked<E5M2, ROW, T><<<gr, NT, 0, st>>>(w, s, z, out, N, K, ldo, G, g);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bitplane(const uint8_t* W, const float* s, const float* z, void* out, int N, int K,
                    int S, int bits, int G, const sdnq::CodeFmt& f, cudaStream_t st) {
  const int g = K / G;
  const unsigned ginv = 0xffffffffu / static_cast<unsigned>(g);
  T* o = static_cast<T*>(out);
  if (S % 4 == 0 && (G == 1 || g % 4 == 0))
    decode_weight_bitplane<4, T><<<grid(S / 4, N), NT, 0, st>>>(W, s, z, o, N, K, S, bits, G, g,
                                                                ginv, f);
  else
    decode_weight_bitplane<1, T><<<grid(S, N), NT, 0, st>>>(W, s, z, o, N, K, S, bits, G, g, ginv,
                                                            f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Unpacked codes w (N, K) of code_kind (0 int8, 1 uint8, 2 e4m3, 3 e5m2)
// into out (N, ldo) of out_kind (bf16 1 or fp16 2), ldo = K rounded up to
// 8.  row_mode 1: T(code) (scale, zp unused); row_mode 0: scale, zp (N, G)
// f32 (zp may be null), g = K / G.
extern "C" int sdnq_decode_unpacked(const void* w, const void* scale, const void* zp, void* out,
                                    int N, int K, int ldo, int G, int code_kind, int row_mode,
                                    int out_kind, void* stream) {
  if (N < 0 || K < 1 || ldo < K || ldo % 8 != 0 || ldo - K >= 8 || G < 1 || K % G != 0 ||
      (!row_mode && !scale) || (out_kind != sdnq::BF16 && out_kind != sdnq::F16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const uint8_t* W = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == sdnq::F16)
    return row_mode ? launch_unpacked<true, __half>(code_kind, W, s, z, out, N, K, ldo, G, st)
                    : launch_unpacked<false, __half>(code_kind, W, s, z, out, N, K, ldo, G, st);
  return row_mode ? launch_unpacked<true, __nv_bfloat16>(code_kind, W, s, z, out, N, K, ldo, G, st)
                  : launch_unpacked<false, __nv_bfloat16>(code_kind, W, s, z, out, N, K, ldo, G,
                                                          st);
}

// Bit-plane codes w (N, bits * S), S = ceil(K / 8), into out (N, 8 * S) of
// out_kind (bf16 1 or fp16 2); scale, zp (N, G) f32 (zp may be null), g =
// K / G; the code format as sdnq::code_fmt's arguments.
extern "C" int sdnq_decode_bitplane(const void* w, const void* scale, const void* zp, void* out,
                                    int N, int K, int S, int G, int bits, int is_float,
                                    int code_min, int e, int m, int fbias, int out_kind,
                                    void* stream) {
  if (N < 0 || K < 1 || S != (K + 7) / 8 || G < 1 || K % G != 0 || bits < 1 || bits > 16 ||
      !scale || (out_kind != sdnq::BF16 && out_kind != sdnq::F16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const sdnq::CodeFmt f = sdnq::code_fmt(is_float, code_min, e, m, fbias);
  const uint8_t* W = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == sdnq::F16) return launch_bitplane<__half>(W, s, z, out, N, K, S, bits, G, f, st);
  return launch_bitplane<__nv_bfloat16>(W, s, z, out, N, K, S, bits, G, f, st);
}

// Half-split codes w (N, K * bits / 8) of 1..7 bits into out (N, K): out_kind
// bf16 (1) or fp16 (2): the raw integer code (is_float 0) or the minifloat
// value (is_float 1 and the format's e, m, bias); int8 (out_kind 0, out_i8
// 1) the raw integer code.  Every plane's segment a multiple of 8 bytes: K *
// (narrowest width) / 8 a multiple of 8.
extern "C" int sdnq_decode_halfsplit(const void* w, void* out, int N, int K, int bits,
                                     int is_float, int e, int m, int fbias, int out_i8,
                                     int out_kind, void* stream) {
  const int wmin = bits & -bits;  // the narrowest plane's width
  if (N < 0 || K < 1 || bits < 1 || bits > 7 || K * wmin % 64 != 0 || (out_i8 && is_float))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const sdnq::CodeFmt f = sdnq::code_fmt(is_float, 0, e, m, fbias);
  const uint8_t* W = static_cast<const uint8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_i8)
    decode_weight_halfsplit<int8_t><<<grid(K / 8, N), NT, 0, st>>>(
        W, static_cast<int8_t*>(out), N, K, bits, f);
  else if (out_kind == sdnq::F16)
    decode_weight_halfsplit<__half><<<grid(K / 8, N), NT, 0, st>>>(
        W, static_cast<__half*>(out), N, K, bits, f);
  else
    decode_weight_halfsplit<__nv_bfloat16><<<grid(K / 8, N), NT, 0, st>>>(
        W, static_cast<__nv_bfloat16*>(out), N, K, bits, f);
  return static_cast<int>(cudaGetLastError());
}
