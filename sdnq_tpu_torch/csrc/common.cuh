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

// D += A(16x32 e4m3, row) * B(32x8 e4m3, col), fp32 accumulate (sm_89+).
__device__ __forceinline__ void mma_e4m3(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

// An 8-bit tile of R contraction rows x 128 columns, from a matrix stored
// (rows, cols) with cols contiguous, into shared memory as [col][row]: the
// K-major layout that the 8-bit operands of mma.sync need.  ldmatrix.trans
// moves 16-bit elements only, so the transpose goes through registers: each
// thread loads four 32-bit words of four consecutive rows (4 x 4 bytes) and
// transposes them with __byte_perm into four words, one per column, each
// stored with one 32-bit store.  Lanes take 4 row groups x 8 column groups,
// so one load instruction of a warp reads whole 32-byte sectors.  Rows >=
// `rows` and columns >= `cols` read as zero; `cols` and `ld` are multiples
// of 4 bytes.  Each of the NT threads holds R * 8 / NT blocks of four words:
// load() the next stage's tile while the current one is in use, store() it
// after.
template <int NT, int R>
struct TransTile8 {
  static constexpr int PER = R * 8 / NT;  // 4x4 blocks per thread
  static_assert(PER >= 1 && R * 8 % NT == 0, "tile does not divide over the threads");
  unsigned w[PER][4];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ src, size_t ld, int row0, int rows,
                                       int col0, int cols, int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NT;
      const int rq = (idx & 3) + 4 * (idx >> 7), cq = (idx >> 2) & 31;
      const int col = col0 + 4 * cq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + 4 * rq + j;
        w[i][j] = (row < rows && col < cols)
                      ? *reinterpret_cast<const unsigned*>(src + (size_t)row * ld + col)
                      : 0u;
      }
    }
  }

  __device__ __forceinline__ void store(uint8_t* smem, int lds, int tid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NT;
      const int rq = (idx & 3) + 4 * (idx >> 7), cq = (idx >> 2) & 31;
      // bytes r.b<c> of rows r0..r3 -> word c = [r0.b<c>, r1.b<c>, r2.b<c>, r3.b<c>]
      const unsigned t0 = __byte_perm(w[i][0], w[i][1], 0x5140);
      const unsigned t1 = __byte_perm(w[i][0], w[i][1], 0x7362);
      const unsigned t2 = __byte_perm(w[i][2], w[i][3], 0x5140);
      const unsigned t3 = __byte_perm(w[i][2], w[i][3], 0x7362);
      uint8_t* p = smem + (4 * cq) * lds + 4 * rq;
      *reinterpret_cast<unsigned*>(p) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<unsigned*>(p + lds) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<unsigned*>(p + 2 * lds) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<unsigned*>(p + 3 * lds) = __byte_perm(t1, t3, 0x7632);
    }
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct SumOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};

// Reduction over a block of exactly NT threads (a multiple of 32, <= 1024);
// every thread gets the result.  `scratch` holds 32 values.
template <int NT, typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T identity, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) scratch[w] = v;
  __syncthreads();
  v = (l < NT / 32) ? scratch[l] : identity;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // scratch may be reused by the caller's next reduce
  return v;
}

}  // namespace sdnq
