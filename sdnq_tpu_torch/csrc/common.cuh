// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Type codes passed from the Python wrappers: 0 = float32, 1 = bfloat16,
// 2 = float16 (activations and outputs); 0 = int8, 1 = bfloat16,
// 2 = float8 e4m3 (GEMM operands).  Every C entry point returns cudaGetLastError() after its
// launch so a refused launch is reported at the call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace sdnq {

enum { F32 = 0, BF16 = 1, F16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when !valid nothing is read and the
// destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}
// 4-byte global -> shared copy through L1, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// How a packed code becomes a value (sdnq_tpu/packing.py decode_float and
// the offset-binary integers of packing.pack), exactly, in a few
// operations.  Integer formats: code + code_min, through the fp32 magic
// number 1.5 * 2^23 (an integer add and one exact subtraction, where a
// conversion instruction runs at a quarter of the rate; exact below 2^22 in
// magnitude).  Minifloats (sign | e exponent bits | m mantissa bits, bias
// 2^(e-1) - 1, subnormals, no inf or nan; unsigned ones have no sign bit):
// the exponent|mantissa field laid into fp32's slots (exponent field E at
// bit 23) and the sign bit at bit 31, then one exact multiply by 2^(127 -
// bias): a normal code reads 2^(E-127)(1 + f) * 2^(127-bias), a subnormal
// one (E = 0) the fp32 denormal 2^-126 f * 2^(127-bias) = 2^(1-bias) f.
// (The build keeps fp32 denormals: no -ftz.)  Every value is exact in fp32
// (and in bf16: m <= 6 for the half-split widths, and the bit-plane kernels
// round scaled values anyway).
struct CodeFmt {
  int is_float;
  int int_base;        // integers: bits of 1.5 * 2^23 plus code_min
  int mag_shift;       // minifloats: 23 - m
  unsigned mag_mask;   // the exponent|mantissa field at mag_shift
  int sign_shift;      // 31 - (e + m)
  float pow2;          // 2^(127 - bias)
};

// on the host, for a kernel's argument
inline CodeFmt code_fmt(int is_float, int code_min, int e, int m, int bias) {
  CodeFmt r{};
  r.is_float = is_float;
  r.int_base = 0x4B400000 + code_min;
  if (is_float) {
    r.mag_shift = 23 - m;
    r.mag_mask = ((1u << (e + m)) - 1u) << r.mag_shift;
    r.sign_shift = 31 - (e + m);
    r.pow2 = std::ldexp(1.f, 127 - bias);
  }
  return r;
}

template <bool FLOAT>
__device__ __forceinline__ float decode_value(unsigned code, const CodeFmt& f) {
  if constexpr (!FLOAT) {
    return __fsub_rn(__int_as_float(static_cast<int>(code) + f.int_base), 12582912.f);
  } else {
    const unsigned b =
        ((code << f.mag_shift) & f.mag_mask) | ((code << f.sign_shift) & 0x80000000u);
    return __fmul_rn(__uint_as_float(b), f.pow2);
  }
}

__device__ __forceinline__ float decode_value(unsigned code, const CodeFmt& f) {
  return f.is_float ? decode_value<true>(code, f) : decode_value<false>(code, f);
}

// The 8 x 8 bit matrix of 8 bytes transposed: bit i of byte j becomes bit
// j of byte i (Hacker's Delight, transpose8).
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// Bit-plane codes (sdnq_tpu/packing.py pack_codes): bit i of byte b of
// plane j is bit j of code i * S + b.  From one 32-bit word of each of 8
// planes (w[j]: bytes b .. b + 3 of plane j; 0 past the last plane), c[q]
// holds in its byte i the 8 bits those planes give code i * S + b + q: two
// 4 x 4 byte transposes gather each byte position's planes, and an 8 x 8
// bit transpose turns planes into codes.
__device__ __forceinline__ void bitplane_codes4(const unsigned* w, uint64_t (&c)[4]) {
  unsigned t[4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // planes 4h .. 4h + 3; byte q of t[q][h] is plane 4h + j's byte q
    const unsigned* a = w + 4 * h;
    const unsigned t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[0], a[1], 0x7362);
    const unsigned t2 = __byte_perm(a[2], a[3], 0x5140), t3 = __byte_perm(a[2], a[3], 0x7362);
    t[0][h] = __byte_perm(t0, t2, 0x5410);
    t[1][h] = __byte_perm(t0, t2, 0x7632);
    t[2][h] = __byte_perm(t1, t3, 0x5410);
    t[3][h] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = transpose8(t[q][0] | (static_cast<uint64_t>(t[q][1]) << 32));
}

// k / g for 0 <= k < 2^31 with inv = floor((2^32 - 1) / g): the high word
// of k * inv is k / g or one below it (k * inv / 2^32 > k / g - 1), so one
// correction makes it exact; a few integer operations where a division
// takes dozens.
__device__ __forceinline__ int div_magic(int k, int g, unsigned inv) {
  int q = static_cast<int>(__umulhi(static_cast<unsigned>(k), inv));
  q += (q + 1) * g <= k;
  return q;
}

// The half-split field planes of a `bits`-wide code (sdnq_tpu/packing.py
// halfsplit_planes): the set bits of `bits` in {4, 2, 1}, most significant
// first.  Plane p holds fields of width[p] bits (8 / width[p] fields a
// byte), is seg[p] = K * width[p] / 8 bytes long, starts off[p] bytes into
// the packed row, and contributes its field shifted left by shift[p].  The
// code k lies in field k / seg[p] of byte k % seg[p] of each plane.
struct HalfSplit {
  int n;
  int width[3], shift[3], seg[3], off[3];
};

__device__ __forceinline__ HalfSplit halfsplit_planes(int bits, int K) {
  HalfSplit h;
  h.n = __popc(bits & 7);
  int rem = bits & 7, off = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p) {  // static indices: the planes stay in registers
    const int w = (rem & 4) ? 4 : (rem & 2) ? 2 : (rem & 1);  // top set bit left
    rem &= ~w;
    h.width[p] = w;
    h.shift[p] = rem;  // the value of the lower planes' bits
    h.seg[p] = K * w / 8;
    h.off[p] = off;
    off += K * w / 8;
  }
  return h;
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A(16x32 s8, row) * B(32x8 s8, col), int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A(16x16 bf16, row) * B(16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two 8x8 b16 matrices, transposed on load: the B fragment of m16n8k16
// from a row-major [k][n] tile in shared memory.
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned pack_f16x2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// two values rounded to T (bf16 or fp16), lo in the low half
template <typename T>
__device__ __forceinline__ unsigned pack_x2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16x2(lo, hi);
  else
    return pack_bf16x2(lo, hi);
}

// rint(e / sc) as the IEEE division rounds it (ties to even), in the low
// byte of the result, for |e / sc| <= 129 (larger quotients: see the
// callers' clips).  y = e * inv (inv = 1 / sc rounded) differs from the
// rounded quotient by at most two roundings of 2^-24 |y| and half an ulp of
// the quotient: under 2.4e-5 below 129.  So where y is more than 2.5e-5
// from a half-integer both round to the same integer: the low byte of y +
// 1.5 * 2^23, which rounds y to the nearest, ties to even (its low byte is
// the integer's two's complement byte).  `near` is set where y is nearer;
// the division decides there (quant_div).  B1's row quantizer
// (quantize_rows.cu) and B3 / B9's token mode (flash_attn.cu) use it.
__device__ __forceinline__ unsigned quant_round(float y, bool& near) {
  const float r = __fadd_rn(y, 12582912.f);
  near |= fabsf(__fsub_rn(y, __fsub_rn(r, 12582912.f))) > 0.499975f;
  return __float_as_uint(r);
}
__device__ __forceinline__ unsigned quant_fast(float e, float inv, bool& near) {
  return quant_round(__fmul_rn(e, inv), near);
}
__device__ __forceinline__ unsigned quant_div(float e, float sc) {
  return static_cast<unsigned>(__float2int_rn(__fdiv_rn(e, sc)));
}

// the low bytes of a, b, c, d in one word, a's in the low byte
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

}  // namespace sdnq
