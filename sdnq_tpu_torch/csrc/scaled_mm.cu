// B4 (and B1's GEMM half): scaled GEMM with a fused epilogue.
//
//   out[m, n] = acc[m, n] * xs[m] * ws[n] + bias[n]
//               (+ rs[m] * vz0[n] + zp[m] * vz1[n])        (each term optional)
//   acc = A (M, K) . B (N, K)^T, both K-contiguous ("nt"), or, for the
//   8-bit kinds, acc = A (M, K) . B (K, N) with B N-contiguous ("nn");
//   int8 x int8 -> int32 (mma.sync m16n8k32 s8), fp8 e4m3 x e4m3 -> fp32
//   (m16n8k32 e4m3), or bf16 x bf16 -> fp32 (m16n8k16 bf16) for the
//   16-bit family.
//
// Replaces sdnq_tpu/kernels/scaled_mm.py `_mm_kernel` (:57, wrapper
// `_scaled_mm_pallas` :133) and the GEMM half of `_fused_act_mm_kernel`
// (:230); the rank-1 zero-point terms are those of its asymmetric "uint8"
// mode.  At the FLUX shapes (M = 4608, K = 3072 or 15360) the product is
// bound by tensor-core operations (2*M*N*K ops against ~(M+N)*K bytes).
// This first design is simple: 128x128 output tiles, 8 warps each owning
// 64x32, 64-byte K stages double-buffered with cp.async, fragments read
// from padded shared memory (80-byte rows: conflict-free 32-bit loads), and
// mma.sync.  The int8, fp8 and bf16 A/B fragments of one 32-byte K step
// have the same byte layout, so one loader and one fragment walk serve all
// three.  The
// epilogue uses round-to-nearest single operations (no FMA contraction) so
// the int8 result is bit-equal to the plain version.  K must be a multiple
// of 64 bytes (the wrapper zero-pads); rows beyond M or N are zero-filled
// and never stored.  wgmma/TMA pipelines are later work.
//
// The "nn" mode is B1's grad-input orientation (`_fused_act_mm_kernel` with
// b_dim0, scaled_mm.py:283): the stored (O, K) weight is B with the
// contraction O as its slow axis.  The 8-bit fragments need B K-major, so
// each 64-row stage of B is read through registers and transposed in
// shared memory (sdnq::TransTile8, shared with scaled_mm_tn.cu), its loads
// issued before the current stage's products; no transposed weight is
// written to device memory.  N must be a multiple of 4.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BKB = 64;  // tile rows, cols, K bytes per stage
constexpr int LDS = BKB + 16;                // padded shared-memory row (bytes)
constexpr int NT = 256;

struct Epilogue {
  const float* xs;
  const float* ws;
  const float* bias;
  const float* rs;
  const float* zp;
  const float* vz0;
  const float* vz1;
};

enum { S8 = 0, BF16 = 1, E4M3 = 2 };  // operand kinds

template <int KIND, bool NN, typename OutT>
__global__ void __launch_bounds__(NT)
    scaled_mm_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                     OutT* __restrict__ C, int M, int N, int Kb, Epilogue ep) {
  __shared__ __align__(16) uint8_t sA[2][BM * LDS];
  __shared__ __align__(16) uint8_t sB[2][BN * LDS];
  using AccT = typename std::conditional<KIND == S8, int, float>::type;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int stage, int kb0) {
#pragma unroll
    for (int i = 0; i < (BM * BKB / 16) / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int ga = m0 + r, gb = n0 + r;
      sdnq::cp_async16(&sA[stage][r * LDS + cb], A + (size_t)(ga < M ? ga : 0) * Kb + kb0 + cb,
                 ga < M);
      if constexpr (!NN)
        sdnq::cp_async16(&sB[stage][r * LDS + cb], B + (size_t)(gb < N ? gb : 0) * Kb + kb0 + cb,
                         gb < N);
    }
    sdnq::cp_async_commit();
  };
  sdnq::TransTile8<NT, BKB> tb;  // "nn": B's stages through registers

  AccT acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int nk = Kb / BKB;
  load_stage(0, 0);
  if constexpr (NN) {
    tb.load(B, N, 0, Kb, n0, N, tid);
    tb.store(sB[0], LDS, tid);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_stage(cur ^ 1, (kt + 1) * BKB);
      if constexpr (NN) tb.load(B, N, (kt + 1) * BKB, Kb, n0, N, tid);
      sdnq::cp_async_wait<1>();
    } else {
      sdnq::cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* a_s = sA[cur];
    const uint8_t* b_s = sB[cur];
#pragma unroll
    for (int ks = 0; ks < BKB; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = a_s + (wm * 64 + mi * 16 + g) * LDS + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = b_s + (wn * 32 + ni * 8 + g) * LDS + ks + t4 * 4;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (KIND == S8)
            sdnq::mma_s8(acc[mi][ni], af[mi], bfr[ni]);
          else if constexpr (KIND == E4M3)
            sdnq::mma_e4m3(acc[mi][ni], af[mi], bfr[ni]);
          else
            sdnq::mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
        }
    }
    // sB[cur ^ 1] was last read before the previous barrier
    if constexpr (NN)
      if (kt + 1 < nk) tb.store(sB[cur ^ 1], LDS, tid);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
      const float xsv = ep.xs ? ep.xs[row] : 1.f;
      const float rsv = ep.rs ? ep.rs[row] : 0.f;
      const float zpv = ep.zp ? ep.zp[row] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= N) continue;
          float v = static_cast<float>(acc[mi][ni][h * 2 + j]);
          if (ep.xs) v = __fmul_rn(v, xsv);
          if (ep.ws) v = __fmul_rn(v, ep.ws[col]);
          if (ep.bias) v = __fadd_rn(v, ep.bias[col]);
          if (ep.rs) v = __fadd_rn(v, __fmul_rn(rsv, ep.vz0[col]));
          if (ep.zp) v = __fadd_rn(v, __fmul_rn(zpv, ep.vz1[col]));
          C[(size_t)row * N + col] = sdnq::from_f32<OutT>(v);
        }
    }
}

template <int KIND, bool NN>
int launch(const void* a, const void* b, void* out, int M, int N, int Kb, int out_kind,
           const Epilogue& ep, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uint8_t* A = static_cast<const uint8_t*>(a);
  const uint8_t* B = static_cast<const uint8_t*>(b);
  if (out_kind == sdnq::F32)
    scaled_mm_kernel<KIND, NN, float><<<grid, NT, 0, s>>>(A, B, static_cast<float*>(out), M, N, Kb, ep);
  else if (out_kind == sdnq::BF16)
    scaled_mm_kernel<KIND, NN, __nv_bfloat16>
        <<<grid, NT, 0, s>>>(A, B, static_cast<__nv_bfloat16*>(out), M, N, Kb, ep);
  else if (out_kind == sdnq::F16)
    scaled_mm_kernel<KIND, NN, __half><<<grid, NT, 0, s>>>(A, B, static_cast<__half*>(out), M, N, Kb, ep);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) contiguous; b (N, K) contiguous, or with b_nn (K, N) contiguous
// (8-bit kinds, N a multiple of 4); in_kind 0 int8 / 1 bf16 / 2 fp8 e4m3,
// K * elem bytes a multiple of 64; out (M, N) of out_kind.  Epilogue
// pointers may be null (rs needs vz0, zp needs vz1).
extern "C" int sdnq_scaled_mm(const void* a, const void* b, void* out, const void* xs,
                              const void* ws, const void* bias, const void* rs, const void* zp,
                              const void* vz0, const void* vz1, int M, int N, int K, int in_kind,
                              int out_kind, int b_nn, void* stream) {
  const int Kb = K * (in_kind == BF16 ? 2 : 1);
  if (Kb % BKB != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b_nn && (in_kind == BF16 || N % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  Epilogue ep{static_cast<const float*>(xs),  static_cast<const float*>(ws),
              static_cast<const float*>(bias), static_cast<const float*>(rs),
              static_cast<const float*>(zp),  static_cast<const float*>(vz0),
              static_cast<const float*>(vz1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_nn) {
    if (in_kind == S8) return launch<S8, true>(a, b, out, M, N, Kb, out_kind, ep, s);
    if (in_kind == E4M3) return launch<E4M3, true>(a, b, out, M, N, Kb, out_kind, ep, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_kind == S8) return launch<S8, false>(a, b, out, M, N, Kb, out_kind, ep, s);
  if (in_kind == BF16) return launch<BF16, false>(a, b, out, M, N, Kb, out_kind, ep, s);
  if (in_kind == E4M3) return launch<E4M3, false>(a, b, out, M, N, Kb, out_kind, ep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
