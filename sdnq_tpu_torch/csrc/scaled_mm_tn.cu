// B10: the grad-weight GEMM, contracting the leading axis of both operands.
//
//   out[n, k] = (sum_m A[m, n] * B[m, k]) * a_s[n] * b_s[k]   (scales optional)
//   A (M, N) and B (M, K) in their natural (row-major) layouts, both int8
//   (int32 accumulate, mma.sync m16n8k32 s8) or both fp8 e4m3 (fp32
//   accumulate, m16n8k32 e4m3); out (N, K) fp32.
//
// Replaces sdnq_tpu/kernels/scaled_mm.py `_tn_mm_kernel` (:534, wrapper
// `_scaled_mm_tn_pallas` :576): gw = g^T x, with g and x quantized
// columnwise by the caller.  At FLUX.1-dev's training shapes (M = 1536
// tokens, N, K in the thousands) it is bound by tensor-core operations
// (2*M*N*K against (M*N + M*K + 4*N*K) bytes); at M = 1 (the modulation
// linears at batch 1) by writing the fp32 output.
//
// The 8-bit mma.sync operands must be K-major (contraction contiguous), but
// here the contraction index m is the slow axis of both A and B, and no
// ldmatrix moves 8-bit elements transposed.  So each stage of 64 m rows is
// read through registers and transposed 4x4 bytes at a time with
// __byte_perm (sdnq::TransTile8) into [n][m] and [k][m] tiles in shared
// memory; no transposed copy of A or B is written to device memory (the
// JAX package's XLA route contracts leading axes directly too).  The next
// stage's loads are issued before the current stage's products, so their
// latency overlaps the tensor-core work.  128 x 128 output tiles, 8 warps of
// 64 x 32, fragments from 80-byte shared rows as in scaled_mm.cu.  A ragged
// M tail is masked to zero in the loader (the JAX wrapper zero-pads M,
// :583-597); so are rows and columns past N and K.  The epilogue multiplies
// in the plain version's order with single roundings (no FMA), so the int8
// result is bit-equal to it.  wgmma / TMA pipelines are later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BN = 128, BK = 128, BM = 64;  // out rows (n), out cols (k), m rows per stage
constexpr int LDS = BM + 16;                // padded shared-memory row (bytes)
constexpr int NT = 256;

enum { S8 = 0, E4M3 = 2 };  // operand kinds, as in scaled_mm.cu

template <int KIND>
__global__ void __launch_bounds__(NT)
    scaled_mm_tn_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                        float* __restrict__ C, const float* __restrict__ as,
                        const float* __restrict__ bs, int M, int N, int K) {
  __shared__ __align__(16) uint8_t sA[BN * LDS];
  __shared__ __align__(16) uint8_t sB[BK * LDS];
  using AccT = typename std::conditional<KIND == S8, int, float>::type;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int n0 = blockIdx.y * BN, k0 = blockIdx.x * BK;

  AccT acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  sdnq::TransTile8<NT, BM> ta, tb;
  const int nm = (M + BM - 1) / BM;
  ta.load(A, N, 0, M, n0, N, tid);
  tb.load(B, K, 0, M, k0, K, tid);
  for (int mt = 0; mt < nm; ++mt) {
    ta.store(sA, LDS, tid);
    tb.store(sB, LDS, tid);
    __syncthreads();
    if (mt + 1 < nm) {  // the next stage's loads run under this stage's products
      ta.load(A, N, (mt + 1) * BM, M, n0, N, tid);
      tb.load(B, K, (mt + 1) * BM, M, k0, K, tid);
    }
#pragma unroll
    for (int ks = 0; ks < BM; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = sA + (wm * 64 + mi * 16 + g) * LDS + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = sB + (wn * 32 + ni * 8 + g) * LDS + ks + t4 * 4;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (KIND == S8)
            sdnq::mma_s8(acc[mi][ni], af[mi], bfr[ni]);
          else
            sdnq::mma_e4m3(acc[mi][ni], af[mi], bfr[ni]);
        }
    }
    __syncthreads();  // the tiles are overwritten by the next stage
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = n0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= N) continue;
      const float sa = as ? as[row] : 1.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = k0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= K) continue;
          const float sb = bs ? bs[col] : 1.f;
          float v = static_cast<float>(acc[mi][ni][h * 2 + j]);
          if (as) v = __fmul_rn(v, sa);
          if (bs) v = __fmul_rn(v, sb);
          C[(size_t)row * K + col] = v;
        }
    }
}

}  // namespace

// a (M, N), b (M, K) contiguous, in_kind 0 int8 / 2 fp8 e4m3, N and K
// multiples of 4; out (N, K) fp32; a_s (N,), b_s (K,) fp32 or null.
extern "C" int sdnq_scaled_mm_tn(const void* a, const void* b, void* out, const void* a_s,
                                 const void* b_s, int M, int N, int K, int in_kind,
                                 void* stream) {
  if (N % 4 != 0 || K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((K + BK - 1) / BK, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* A = static_cast<const uint8_t*>(a);
  const uint8_t* B = static_cast<const uint8_t*>(b);
  float* C = static_cast<float*>(out);
  const float* as = static_cast<const float*>(a_s);
  const float* bs = static_cast<const float*>(b_s);
  if (in_kind == S8)
    scaled_mm_tn_kernel<S8><<<grid, NT, 0, s>>>(A, B, C, as, bs, M, N, K);
  else if (in_kind == E4M3)
    scaled_mm_tn_kernel<E4M3><<<grid, NT, 0, s>>>(A, B, C, as, bs, M, N, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
