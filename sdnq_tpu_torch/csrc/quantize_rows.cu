// B1, first half: per-row activation quantization for the scaled GEMM.
//
// Replaces the quantize prologue of sdnq_tpu/kernels/scaled_mm.py
// `_fused_act_mm_kernel` (:230, prologue at :244-280).  On the TPU that
// prologue lives inside the GEMM: the whole (bm, K) row block of x stays in
// 128 MB of VMEM across the sweep over weight tiles.  On Hopper a block has
// at most 227 KB of shared memory, and at K = 15360 (FLUX linear2) even 64
// bf16 rows are 1.9 MB, so the quantize is its own pass: this kernel reads x
// once and writes x_q (one byte per value) and one scale per row, and the
// GEMM (scaled_mm.cu) reads x_q.  The pass moves M*K*(2+1) bytes for bf16
// x: it is bound by memory bandwidth; one block per row keeps the row's
// second read in L1/L2.
//
// Modes, with the numerics of the JAX kernel and of quant/core.py (true
// division, so the codes are bit-equal to the plain version's):
//   int8:  scale = max(absmax / 127, 2^-126), q = clip(rint(x / scale))
//   uint8: signed codes with x = q*scale + zp: scale = (max-min)/255,
//          zp = min + 128*scale, q = clip(rint((x - zp) / scale)); also
//          writes zp and rowsum(q)*scale for the GEMM's rank-1 terms
//   fp8:   scale = max(absmax / 448, 2^-126), q = e4m3(clip(x / scale))
//          (round to nearest even)
// Columns [K, Kpad) of x_q are written as zeros (K padding for the GEMM).
// With a column scale cs (K,), every value is first multiplied by cs[k] in
// fp32 (the `x_colscale` of the TPU prologue, :248-253: the grad-input
// cotangent times the weight's row scales), so the codes equal those of
// quantize_int_mm(x * cs) and the scaled cotangent never reaches device
// memory.
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
enum { INT8 = 0, UINT8 = 1, FP8 = 2 };
#define kInf __int_as_float(0x7f800000)
#define kScaleFloor __int_as_float(0x00800000)  // 2^-126

template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
    quantize_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ xq, float* __restrict__ xs,
                         float* __restrict__ zp_out, float* __restrict__ rs_out,
                         const float* __restrict__ cs, int K, int Kpad) {
  __shared__ float fscratch[32];
  __shared__ int iscratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)K;
  uint8_t* qr = xq + row * (size_t)Kpad;
  auto val = [&](int k) {
    float v = sdnq::to_f32(xr[k]);
    if (cs) v = __fmul_rn(v, cs[k]);
    return v;
  };

  float scale, zp = 0.f;
  if (MODE == UINT8) {
    float vmin = kInf, vmax = -kInf;
    for (int k = threadIdx.x; k < K; k += NT) {
      float v = val(k);
      vmin = fminf(vmin, v);
      vmax = fmaxf(vmax, v);
    }
    vmin = sdnq::block_reduce<NT>(vmin, sdnq::MinOp(), kInf, fscratch);
    vmax = sdnq::block_reduce<NT>(vmax, sdnq::MaxOp(), -kInf, fscratch);
    scale = fmaxf(__fdiv_rn(__fsub_rn(vmax, vmin), 255.f), kScaleFloor);
    zp = __fadd_rn(vmin, __fmul_rn(scale, 128.f));
  } else {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += NT) amax = fmaxf(amax, fabsf(val(k)));
    amax = sdnq::block_reduce<NT>(amax, sdnq::MaxOp(), 0.f, fscratch);
    scale = fmaxf(__fdiv_rn(amax, MODE == FP8 ? 448.f : 127.f), kScaleFloor);
  }

  int qsum = 0;
  for (int k = threadIdx.x; k < K; k += NT) {
    float v = val(k);
    if (MODE == FP8) {
      const float q = fminf(fmaxf(__fdiv_rn(v, scale), -448.f), 448.f);
      qr[k] = __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
    } else {
      if (MODE == UINT8) v = __fsub_rn(v, zp);
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -128.f), 127.f);
      qr[k] = static_cast<uint8_t>(static_cast<int8_t>(q));
      if (MODE == UINT8) qsum += static_cast<int>(q);
    }
  }
  for (int k = K + threadIdx.x; k < Kpad; k += NT) qr[k] = 0;
  if (MODE == UINT8) qsum = sdnq::block_reduce<NT>(qsum, sdnq::SumOp(), 0, iscratch);

  if (threadIdx.x == 0) {
    xs[row] = scale;
    if (MODE == UINT8) {
      zp_out[row] = zp;
      rs_out[row] = __fmul_rn(static_cast<float>(qsum), scale);
    }
  }
}

template <typename T>
int launch(const void* x, uint8_t* xq, float* xs, float* zp, float* rs, const float* cs, int M,
           int K, int Kpad, int mode, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  if (mode == INT8)
    quantize_rows_kernel<T, INT8><<<M, NT, 0, s>>>(xp, xq, xs, zp, rs, cs, K, Kpad);
  else if (mode == UINT8)
    quantize_rows_kernel<T, UINT8><<<M, NT, 0, s>>>(xp, xq, xs, zp, rs, cs, K, Kpad);
  else if (mode == FP8)
    quantize_rows_kernel<T, FP8><<<M, NT, 0, s>>>(xp, xq, xs, zp, rs, cs, K, Kpad);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x (M, K) contiguous, x_kind 0 f32 / 1 bf16 / 2 f16; xq (M, Kpad) int8 or
// e4m3 bytes; xs (M,) f32; zp, rs (M,) f32 (uint8 mode only, else may be
// null); cs (K,) f32 column scale or null; mode 0 int8 / 1 uint8 / 2 fp8
// e4m3.
extern "C" int sdnq_quantize_rows(const void* x, void* xq, void* xs, void* zp, void* rs,
                                  const void* cs, int M, int K, int Kpad, int x_kind, int mode,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* q = static_cast<uint8_t*>(xq);
  float* xsf = static_cast<float*>(xs);
  float* zpf = static_cast<float*>(zp);
  float* rsf = static_cast<float*>(rs);
  const float* csf = static_cast<const float*>(cs);
  int rc;
  if (x_kind == sdnq::F32)
    rc = launch<float>(x, q, xsf, zpf, rsf, csf, M, K, Kpad, mode, s);
  else if (x_kind == sdnq::BF16)
    rc = launch<__nv_bfloat16>(x, q, xsf, zpf, rsf, csf, M, K, Kpad, mode, s);
  else if (x_kind == sdnq::F16)
    rc = launch<__half>(x, q, xsf, zpf, rsf, csf, M, K, Kpad, mode, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
