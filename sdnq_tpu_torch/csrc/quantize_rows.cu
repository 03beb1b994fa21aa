// B1, first half: per-row activation quantization for the scaled GEMM.
//
// Replaces the quantize prologue of sdnq_tpu/kernels/scaled_mm.py
// `_fused_act_mm_kernel` (:230, prologue at :244-280).  On the TPU that
// prologue lives inside the GEMM: the whole (bm, K) row block of x stays in
// 128 MB of VMEM across the sweep over weight tiles.  On Hopper a block has
// at most 227 KB of shared memory, and at K = 15360 (FLUX linear2) even 64
// bf16 rows are 1.9 MB, so the quantize is its own pass, bound by memory
// bandwidth: it reads x (M*K values) and writes x_q (one byte a value) and
// one scale a row; the GEMM (scaled_mm.cu) reads x_q.
//
// Each value of x is read from device memory once.  The blocks persist (as
// many an SM as their shared memory allows) and walk the rows, a block a
// row (256 threads; 1024 for the column scale's rows, whose loads wait on
// the L1 cache), each row brought into one of the block's two shared-memory
// buffers by one TMA bulk copy (hopper.cuh's `bulk_load`) while the block
// works on the one before it.  (A warp a row, eight to a block, each with
// two buffers of its own, took 13% longer at K 3072 fp32 on an H100 80GB
// HBM3 at 700 W.)  The codes leave 4 or 8 at a time.  rint(v / scale) is a
// multiply by the rounded reciprocal (common.cuh's quant_round); the true
// division decides only where that product lies within 2.5e-5 of a
// half-integer, so the codes equal the division's bit for bit.  The column
// scale is read in 16-byte vectors through the L1 cache (a copy staged in
// shared memory once a block read no faster).  Rows that TMA cannot copy
// (not a multiple of 16 bytes long, or off a 16-byte boundary) or that do
// not fit twice in shared memory (over 113 KB) take a loop that reads x
// twice, the second time from the L2 cache.  The entry picks the kernel.
//
// Modes, with the numerics of the JAX kernel and of quant/core.py (the
// codes are bit-equal to the plain version's):
//   int8:  scale = max(absmax / 127, 2^-126), q = clip(rint(x / scale))
//   uint8: signed codes with x = q*scale + zp: scale = (max-min)/255,
//          zp = min + 128*scale, q = clip(rint((x - zp) / scale)); also
//          writes zp and rowsum(q)*scale for the GEMM's rank-1 terms
//   fp8:   scale = max(absmax / 448, 2^-126), q = e4m3(clip(x / scale))
//          (round to nearest even; the true division: the window of the
//          multiply's shortcut around e4m3's midpoints is not shown exact)
// Columns [K, Kpad) of x_q are written as zeros (K padding for the GEMM).
// With a column scale cs (K,), every value is first multiplied by cs[k] in
// fp32 (the `x_colscale` of the TPU prologue, :248-253: the grad-input
// cotangent times the weight's row scales), so the codes equal those of
// quantize_int_mm(x * cs) and the scaled cotangent never reaches device
// memory.
#include <cuda_fp8.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;     // threads a block (the staged kernel's without a column scale)
constexpr int NT_CS = 1024;  // the staged kernel's with a column scale
constexpr int SMEM_ROWS = 227 * 1024 - 1024;  // a block's shared memory for rows
enum { INT8 = 0, UINT8 = 1, FP8 = 2 };
#define kInf __int_as_float(0x7f800000)
#define kScaleFloor __int_as_float(0x00800000)  // 2^-126

struct Args {
  const void* x;
  uint8_t* xq;
  float* xs;
  float* zp;
  float* rs;
  const float* cs;
  const float* gs;  // a given scale a row (M,) (uint8: a given min (M,) then max (M,)),
                    // or null: the row's own
  int M, K, Kpad;
  int cvec;  // cs on a 16-byte boundary: 16-byte loads of it
};

// v over the block (a multiple of 32 threads, at most 1024); every thread
// gets the result.  `scratch` holds 33 values: each warp's, then the
// block's, which warp 0 reduces from them.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, Op op, V identity, V* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : identity;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  v = scratch[32];
  __syncthreads();  // scratch is reused by the next reduction
  return v;
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

// Value e of a 16-byte vector's raw bits as fp32 (exact; e a constant
// once unrolled: one instruction for bf16), and value e's bits set from
// memory.
template <typename T>
__device__ __forceinline__ float bits_to_f32(const uint4& v, int e) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
  } else {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1)))));
  }
}

// clip(rint(v / scale)) by the true division, as the plain version
__device__ __forceinline__ unsigned code_div(float v, float scale) {
  return static_cast<unsigned>(min(max(static_cast<int>(sdnq::quant_div(v, scale)), -128), 127));
}

// One row's work, a 16-byte vector at a time: vector vi is the row's values
// EPV vi .. EPV vi + EPV - 1.  FULL: every value of every vector lies in
// the row (K a multiple of EPV); else the values past K read as 0 and
// write nothing.
template <typename T, int MODE, bool FULL>
struct RowOps {
  static constexpr int EPV = 16 / sizeof(T);
  Args a;

  __device__ __forceinline__ bool in_row(int vi, int e) const { return FULL || EPV * vi + e < a.K; }

  // vector vi as fp32 values, times the column scale
  __device__ __forceinline__ void values(const uint4& v, int vi, float (&f)[EPV]) const {
#pragma unroll
    for (int e = 0; e < EPV; ++e) f[e] = in_row(vi, e) ? bits_to_f32<T>(v, e) : 0.f;
    if (a.cs) {
      float c[EPV];
      if (FULL && a.cvec) {
#pragma unroll
        for (int e = 0; e < EPV; e += 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(a.cs + EPV * vi + e));
          c[e] = q.x, c[e + 1] = q.y, c[e + 2] = q.z, c[e + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) c[e] = __ldg(a.cs + min(EPV * vi + e, a.K - 1));
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) f[e] = __fmul_rn(f[e], c[e]);
    }
  }

  // the row's statistics: absmax, or min and max (uint8)
  __device__ __forceinline__ void stat(const uint4& v, int vi, float& amax, float& vmin,
                                       float& vmax) const {
    float f[EPV];
    values(v, vi, f);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      if (!in_row(vi, e)) continue;
      if constexpr (MODE == UINT8) {
        vmin = fminf(vmin, f[e]);
        vmax = fmaxf(vmax, f[e]);
      } else {
        amax = fmaxf(amax, fabsf(f[e]));
      }
    }
  }

  // vector vi's codes into the row's x_q (qr), 4 or 8 a store where `vst`
  __device__ __forceinline__ void codes(const uint4& v, int vi, float scale, float inv, float zp,
                                        uint8_t* qr, bool vst, int& qsum) const {
    float f[EPV];
    values(v, vi, f);
    unsigned c[EPV];
    if constexpr (MODE == FP8) {
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        c[e] = __nv_cvt_float_to_fp8(fminf(fmaxf(__fdiv_rn(f[e], scale), -448.f), 448.f),
                                     __NV_SATFINITE, __NV_E4M3);
    } else {
      bool near = false;
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        float y;
        if constexpr (MODE == UINT8) {
          // (x - zp) / scale: quotients past the int8 range clip (a large
          // offset can leave some past 128)
          f[e] = __fsub_rn(f[e], zp);
          y = fminf(fmaxf(__fmul_rn(f[e], inv), -128.f), 127.f);
        } else {
          // |x| <= absmax and scale >= absmax / 127 rounded: |y| <
          // 127.0001, which rounds inside the int8 range
          y = __fmul_rn(f[e], inv);
        }
        c[e] = sdnq::quant_round(y, near);
      }
      if (near) {  // a quotient next to a half-integer: the division decides
#pragma unroll
        for (int e = 0; e < EPV; ++e) c[e] = code_div(f[e], scale);
      }
      if constexpr (MODE == UINT8) {
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          if (in_row(vi, e)) qsum += static_cast<int8_t>(c[e] & 0xFFu);
      }
    }
    uint8_t* q = qr + EPV * vi;
    if (vst) {
      if constexpr (EPV == 8)
        *reinterpret_cast<uint2*>(q) =
            make_uint2(sdnq::pack4(c[0], c[1], c[2], c[3]), sdnq::pack4(c[4], c[5], c[6], c[7]));
      else
        *reinterpret_cast<unsigned*>(q) = sdnq::pack4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        if (in_row(vi, e)) q[e] = static_cast<uint8_t>(c[e]);
    }
  }

  // the scale (and zero point) from the row's statistics, reduced over
  // the block
  __device__ __forceinline__ void row_scale(float amax, float vmin, float vmax, float* scratch,
                                            float& scale, float& zp) const {
    if constexpr (MODE == UINT8) {
      vmin = block_reduce(vmin, MinOp(), kInf, scratch);
      vmax = block_reduce(vmax, MaxOp(), -kInf, scratch);
      scale = fmaxf(__fdiv_rn(__fsub_rn(vmax, vmin), 255.f), kScaleFloor);
      zp = __fadd_rn(vmin, __fmul_rn(scale, 128.f));
    } else {
      amax = block_reduce(amax, MaxOp(), 0.f, scratch);
      scale = fmaxf(__fdiv_rn(amax, MODE == FP8 ? 448.f : 127.f), kScaleFloor);
      zp = 0.f;
    }
  }

  // the scale and zero point of a given row range (uint8), as row_scale
  // computes them from the row's own
  __device__ __forceinline__ void range_scale(float vmin, float vmax, float& scale,
                                              float& zp) const {
    scale = fmaxf(__fdiv_rn(__fsub_rn(vmax, vmin), 255.f), kScaleFloor);
    zp = __fadd_rn(vmin, __fmul_rn(scale, 128.f));
  }

  // the padding columns, the row sum and the scales
  __device__ __forceinline__ void finish(int row, float scale, float zp, uint8_t* qr, int qsum,
                                         int* iscratch) const {
    for (int k = a.K + threadIdx.x; k < a.Kpad; k += blockDim.x) qr[k] = 0;
    if constexpr (MODE == UINT8) qsum = block_reduce(qsum, SumOp(), 0, iscratch);
    if (threadIdx.x == 0) {
      a.xs[row] = scale;
      if constexpr (MODE == UINT8) {
        a.zp[row] = zp;
        a.rs[row] = __fmul_rn(static_cast<float>(qsum), scale);
      }
    }
  }
};

// Rows of `bytes` (a multiple of 16, at most SMEM_ROWS / 2) on 16-byte
// boundaries, a block a row, each brought into one of two shared-memory
// buffers by a TMA bulk copy: the next row is in flight while the block
// works on one.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT_CS) quantize_rows_kernel(const Args a, int bytes) {
  constexpr int EPV = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t rows_smem[];
  __shared__ uint64_t bar[2];
  __shared__ float fscratch[33];
  __shared__ int iscratch[33];
  const RowOps<T, MODE, true> ops{a};
  const int nv = a.K / EPV;
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  const bool vst = a.Kpad % EPV == 0;
  if (threadIdx.x == 0) {
    sdnq::mbar_init(&bar[0], 1);
    sdnq::mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: the block's i-th row, if any, into buffer i & 1
  auto fetch = [&](int i) {
    const int row = blockIdx.x + i * gridDim.x, b = i & 1;
    if (row >= a.M) return;
    sdnq::mbar_expect_tx(&bar[b], static_cast<unsigned>(bytes));
    sdnq::bulk_load(rows_smem + (size_t)b * bytes, x + (size_t)row * bytes,
                    static_cast<unsigned>(bytes), &bar[b]);
  };
  if (threadIdx.x == 0) fetch(0);
  int i = 0;
  for (int row = blockIdx.x; row < a.M; row += gridDim.x, ++i) {
    const int b = i & 1;
    // the next row, into the buffer every thread finished reading before
    // the last row's closing barrier
    if (threadIdx.x == 0) fetch(i + 1);
    sdnq::mbar_wait(&bar[b], (i >> 1) & 1);
    const uint4* buf = reinterpret_cast<const uint4*>(rows_smem + (size_t)b * bytes);
    float scale, zp = 0.f;
    if (a.gs) {
      if constexpr (MODE == UINT8)
        ops.range_scale(a.gs[row], a.gs[a.M + row], scale, zp);
      else
        scale = a.gs[row];
    } else {
      float amax = 0.f, vmin = kInf, vmax = -kInf;
#pragma unroll 4
      for (int vi = threadIdx.x; vi < nv; vi += blockDim.x) ops.stat(buf[vi], vi, amax, vmin, vmax);
      ops.row_scale(amax, vmin, vmax, fscratch, scale, zp);
    }
    const float inv = __frcp_rn(scale);
    uint8_t* qr = a.xq + (size_t)row * a.Kpad;
    int qsum = 0;
#pragma unroll 4
    for (int vi = threadIdx.x; vi < nv; vi += blockDim.x)
      ops.codes(buf[vi], vi, scale, inv, zp, qr, vst, qsum);
    ops.finish(row, scale, zp, qr, qsum, iscratch);
    __syncthreads();  // buffer b is read: the next fetch may fill it
  }
}

// Any row, read twice from device memory (the second time from the L2
// cache): 16-byte loads where VEC (K a multiple of EPV, rows on 16-byte
// boundaries), else a value at a time.
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(NT) quantize_rows_loop_kernel(const Args a) {
  constexpr int EPV = 16 / sizeof(T);
  __shared__ float fscratch[33];
  __shared__ int iscratch[33];
  const RowOps<T, MODE, VEC> ops{a};
  const int row = blockIdx.x, nv = (a.K + EPV - 1) / EPV;
  const T* xr = static_cast<const T*>(a.x) + (size_t)row * a.K;
  auto load = [&](int vi) {
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const uint4*>(xr) + vi);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        if (EPV * vi + e >= a.K) continue;
        if constexpr (sizeof(T) == 4)
          w[e] = *reinterpret_cast<const unsigned*>(xr + EPV * vi + e);
        else
          w[e >> 1] |= static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(
                           xr + EPV * vi + e))
                       << (16 * (e & 1));
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  };
  float scale, zp = 0.f;
  if (a.gs) {
    if constexpr (MODE == UINT8)
      ops.range_scale(a.gs[row], a.gs[a.M + row], scale, zp);
    else
      scale = a.gs[row];
  } else {
    float amax = 0.f, vmin = kInf, vmax = -kInf;
#pragma unroll 4
    for (int vi = threadIdx.x; vi < nv; vi += NT) ops.stat(load(vi), vi, amax, vmin, vmax);
    ops.row_scale(amax, vmin, vmax, fscratch, scale, zp);
  }
  const float inv = __frcp_rn(scale);
  uint8_t* qr = a.xq + (size_t)row * a.Kpad;
  const bool vst = VEC && a.Kpad % EPV == 0;
  int qsum = 0;
#pragma unroll 4
  for (int vi = threadIdx.x; vi < nv; vi += NT) ops.codes(load(vi), vi, scale, inv, zp, qr, vst, qsum);
  ops.finish(row, scale, zp, qr, qsum, iscratch);
}

// The kernel for rows of K values of T at x: a block a row where TMA can
// copy them (rows a multiple of 16 bytes on 16-byte boundaries) and two fit
// in shared memory, as many blocks as fit on the SMs; else the loop, a
// block a row (16-byte loads where the rows are so laid out).
template <typename T, int MODE>
int launch_mode(const Args& a, cudaStream_t s) {
  constexpr int EPV = 16 / sizeof(T);
  const int bytes = a.K * static_cast<int>(sizeof(T));
  const bool vec = a.K % EPV == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  if (vec && 2 * bytes <= SMEM_ROWS) {
    const int nt = a.cs ? NT_CS : NT, smem = 2 * bytes;
    static int set_smem = 0, per_sm = 0, per_sm_smem = -1, per_sm_nt = 0;  // the last call's
    if (smem > set_smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          quantize_rows_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      set_smem = smem;
    }
    if (smem != per_sm_smem || nt != per_sm_nt) {  // blocks an SM: as many as fit
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quantize_rows_kernel<T, MODE>, nt, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      per_sm_smem = smem, per_sm_nt = nt;
    }
    const long long cap = (long long)sdnq::sm_count() * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(a.M < cap ? a.M : cap);
    quantize_rows_kernel<T, MODE><<<grid, nt, smem, s>>>(a, bytes);
  } else if (vec) {
    quantize_rows_loop_kernel<T, MODE, true><<<a.M, NT, 0, s>>>(a);
  } else {
    quantize_rows_loop_kernel<T, MODE, false><<<a.M, NT, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Args a, int mode, cudaStream_t s) {
  if (sdnq::sm_count() < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.cvec = reinterpret_cast<uintptr_t>(a.cs) % 16 == 0;
  if (mode == INT8) return launch_mode<T, INT8>(a, s);
  if (mode == UINT8) return launch_mode<T, UINT8>(a, s);
  if (mode == FP8) return launch_mode<T, FP8>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) contiguous, x_kind 0 f32 / 1 bf16 / 2 f16; xq (M, Kpad) int8 or
// e4m3 bytes; xs (M,) f32; zp, rs (M,) f32 (uint8 mode only, else may be
// null); cs (K,) f32 column scale or null; mode 0 int8 / 1 uint8 / 2 fp8
// e4m3; gs (M,) f32 a given scale a row, or (uint8) a given minimum (M,)
// then maximum (M,) a row, or null (the codes against it, no statistics
// pass; xs gets the scale).
extern "C" int sdnq_quantize_rows(const void* x, void* xq, void* xs, void* zp, void* rs,
                                  const void* cs, const void* gs, int M, int K, int Kpad,
                                  int x_kind, int mode, void* stream) {
  if (M < 1 || K < 1 || Kpad < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x,      static_cast<uint8_t*>(xq),     static_cast<float*>(xs),
         static_cast<float*>(zp), static_cast<float*>(rs), static_cast<const float*>(cs),
         static_cast<const float*>(gs), M,   K,
         Kpad,   0};
  if (x_kind == sdnq::F32) return launch<float>(a, mode, s);
  if (x_kind == sdnq::BF16) return launch<__nv_bfloat16>(a, mode, s);
  if (x_kind == sdnq::F16) return launch<__half>(a, mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
