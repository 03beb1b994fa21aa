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
// the offset-binary integers of packing.pack).  Integer formats: code +
// code_min.  Minifloats (sign | e exponent bits | m mantissa bits, bias
// 2^(e-1) - 1, subnormals, no inf or nan; e <= 5 in the registry): the
// exponent|mantissa field goes into the fp32 slots with one shift and add;
// the subnormal codes then read as 2^-bias * (1 + mant / 2^m), and one
// exact subtraction of 2^(1-bias) from twice that gives 2^(1-bias) * mant /
// 2^m.  Every value is exact in fp32 (and in bf16: m <= 6 for the
// half-split widths, and the bit-plane tiles round scaled values anyway).
struct CodeFmt {
  int is_float;  // 0: value = code + code_min
  int code_min;
  int e, m, bias, is_signed;
};

__device__ __forceinline__ float decode_value(unsigned code, const CodeFmt& f) {
  if (!f.is_float) return static_cast<float>(static_cast<int>(code) + f.code_min);
  const int em = f.e + f.m;
  const unsigned mag = code & ((1u << em) - 1u);
  float v = __uint_as_float((mag << (23 - f.m)) + (static_cast<unsigned>(127 - f.bias) << 23));
  if (mag < (1u << f.m))  // a subnormal code
    v = __fsub_rn(2.f * v, __uint_as_float(static_cast<unsigned>(128 - f.bias) << 23));
  if (f.is_signed && ((code >> em) & 1u)) v = -v;
  return v;
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
