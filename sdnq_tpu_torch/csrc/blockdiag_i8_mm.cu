// B8: int8 rows times raw half-split codes at any group size.
//
//   out[m, o] = xs[m] * sum_g (scale[o, g] * P_g[m, o] + xsum[m, g] * zpc[o, g])
//               + bias[o]
//   P_g[m, o] = sum_{k in group g} xq[m, k] * c[o, k]        (exact int32)
//
// The same function as B7 (csrc/wgmma_mm.cu's int8 fold); c are the raw codes
// 0 .. 2^BITS - 1 of a half-split row (byte b of the seg = K * BITS / 8
// packed bytes carries code t * seg + b in bit field t), zpc folds the zero
// point and the offset-binary minimum, xsum is the per-row group sum of the
// int8 codes (computed by the wrapper).
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_blockdiag_i8_kernel` (:890,
// wrapper `_blockdiag_i8_mm_pallas` :948).  The TPU kernel expands x into a
// block-diagonal (M*G, K) operand so that one full-K MXU dot yields every
// group's partial; that trades G-fold redundant MACs for fewer MXU calls.
// On Hopper the partials are taken directly instead: the group size here
// can be 8 or 16 (the auto groups of 1- and 2-bit codes), below the 32-deep
// K step of an s8 mma.sync, so each thread accumulates its partials with
// dp4a (four int8 products per instruction, exact int32) and weights a
// partial by its group's scale the moment the group ends.  Groups may
// straddle the field boundary (G odd): the kernel walks K in code order, so
// a group is just a run of g consecutive codes wherever its bytes lie.  A
// group size that is not a multiple of 4 takes a byte-at-a-time loop.
//
// Bound: at the decode shapes of its domain (M = 32, K = 2048, O = 8192, g =
// 64) the weight is 8 MB of packed bytes (2.5 us at 3.35 TB/s) against 1.1
// G integer operations, so on CUDA cores this design is bound by the dp4a
// instruction rate, not by bytes.  One block of 256 threads takes 32 rows x 64
// output columns; each thread owns 4 rows x 2 columns, stages of 64 codes
// of x (16-byte cp.async) and of the 64 code bytes of each column (4-byte
// cp.async into rows padded to 17 words, conflict-free) are
// double-buffered.  The fp32 folds are round-to-nearest single operations
// in the plain version's order, so the kernel equals it bit for bit.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, NT = 256, KS = 64;  // rows, cols, threads, codes/stage
constexpr int TM = 4, TN = 2;                       // outputs per thread
constexpr int LDX = KS + 16;                        // padded x row (bytes)
constexpr int LDW = KS + 4;                         // padded code row (bytes)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdnq::smem_addr(smem)),
               "l"(gmem), "r"(n));
}

template <int BITS, bool BYTEWISE, typename OutT>
__global__ void __launch_bounds__(NT)
    blockdiag_i8_mm_kernel(const int8_t* __restrict__ X, const uint8_t* __restrict__ W,
                           const float* __restrict__ scale, const float* __restrict__ zpc,
                           const float* __restrict__ xsum, const float* __restrict__ xs,
                           const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                           int K, int G, int g) {
  __shared__ __align__(16) int8_t sX[2][BM * LDX];
  __shared__ __align__(16) uint8_t sW[2][BN * LDW];
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr unsigned MASK4 = 0x01010101u * MASK;

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int seg = K * BITS / 8;

  auto load_stage = [&](int stage, int k0) {
    const int t = k0 / seg, b0 = k0 - t * seg;
    if (tid < BM * KS / 16) {
      const int r = tid >> 2, cb = (tid & 3) * 16, gr = m0 + r;
      sdnq::cp_async16(&sX[stage][r * LDX + cb], X + (size_t)(gr < M ? gr : 0) * K + k0 + cb,
                       gr < M);
    }
#pragma unroll
    for (int i = 0; i < BN * KS / 4 / NT; ++i) {
      const int c = tid + i * NT;
      const int r = c / (KS / 4), cb = (c % (KS / 4)) * 4, gn = n0 + r;
      cp_async4(&sW[stage][r * LDW + cb], W + (size_t)(gn < N ? gn : 0) * seg + b0 + cb, gn < N);
    }
    sdnq::cp_async_commit();
  };

  float acc[TM][TN];
  int part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0;
    }

  int gi = 0, to_end = g;  // the current group and the codes left in it
  auto flush = [&]() {     // the group ends: weight its partial, add the zp term
    float sc[TN], zc[TN], xv[TM];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 32 * j;
      sc[j] = scale[(size_t)(col < N ? col : 0) * G + gi];
      zc[j] = zpc[(size_t)(col < N ? col : 0) * G + gi];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      xv[i] = xsum[(size_t)(row < M ? row : 0) * G + gi];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float a = acc[i][j];
        a = __fadd_rn(a, __fmul_rn(static_cast<float>(part[i][j]), sc[j]));
        a = __fadd_rn(a, __fmul_rn(xv[i], zc[j]));
        acc[i][j] = a;
        part[i][j] = 0;
      }
    ++gi;
    to_end = g;
  };

  const int nk = K / KS;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_stage(cur ^ 1, (kt + 1) * KS);
      sdnq::cp_async_wait<1>();
    } else {
      sdnq::cp_async_wait<0>();
    }
    __syncthreads();
    const int sh = BITS * ((kt * KS) / seg);  // bit field of this stage's codes
    const int8_t* xr = sX[cur] + ty * TM * LDX;
    const uint8_t* wr = sW[cur] + tx * LDW;
    if constexpr (!BYTEWISE) {
#pragma unroll 4
      for (int kk = 0; kk < KS; kk += 4) {
        int xa[TM], wb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xa[i] = *reinterpret_cast<const int*>(xr + i * LDX + kk);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          wb[j] = static_cast<int>(
              (*reinterpret_cast<const unsigned*>(wr + 32 * j * LDW + kk) >> sh) & MASK4);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = __dp4a(xa[i], wb[j], part[i][j]);
        to_end -= 4;
        if (to_end == 0) flush();
      }
    } else {
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            part[i][j] += static_cast<int>(xr[i * LDX + kk]) *
                          static_cast<int>((wr[32 * j * LDW + kk] >> sh) & MASK);
        if (--to_end == 0) flush();
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
    const float xsv = xs[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 32 * j;
      if (col >= N) continue;
      float v = __fmul_rn(acc[i][j], xsv);
      if (bias) v = __fadd_rn(v, bias[col]);
      out[(size_t)row * N + col] = sdnq::from_f32<OutT>(v);
    }
  }
}

template <int BITS, bool BYTEWISE>
int launch(const void* x, const void* w, const float* scale, const float* zpc, const float* xsum,
           const float* xs, const float* bias, void* out, int M, int N, int K, int G, int g,
           int out_kind, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int8_t* X = static_cast<const int8_t*>(x);
  const uint8_t* Wp = static_cast<const uint8_t*>(w);
  if (out_kind == sdnq::F32)
    blockdiag_i8_mm_kernel<BITS, BYTEWISE, float><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<float*>(out), M, N, K, G, g);
  else if (out_kind == sdnq::BF16)
    blockdiag_i8_mm_kernel<BITS, BYTEWISE, __nv_bfloat16><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<__nv_bfloat16*>(out), M, N, K, G, g);
  else if (out_kind == sdnq::F16)
    blockdiag_i8_mm_kernel<BITS, BYTEWISE, __half><<<grid, NT, 0, s>>>(
        X, Wp, scale, zpc, xsum, xs, bias, static_cast<__half*>(out), M, N, K, G, g);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_g(int g, const void* x, const void* w, const float* scale, const float* zpc,
             const float* xsum, const float* xs, const float* bias, void* out, int M, int N,
             int K, int G, int out_kind, cudaStream_t s) {
  if (g % 4 == 0)
    return launch<BITS, false>(x, w, scale, zpc, xsum, xs, bias, out, M, N, K, G, g, out_kind, s);
  return launch<BITS, true>(x, w, scale, zpc, xsum, xs, bias, out, M, N, K, G, g, out_kind, s);
}

}  // namespace

// xq (M, K) int8 codes; xs (M,) f32; w (N, K*bits/8) half-split uint8;
// scale, zpc (N, K/g) f32; xsum (M, K/g) f32; bias (N,) f32 or null; out (M,
// N) of out_kind.  bits 1, 2 or 4; g divides K; the field segment K*bits/8
// is a multiple of 64 (a stage of 64 codes never straddles two fields).
extern "C" int sdnq_blockdiag_i8_mm(const void* xq, const void* w, const void* scale,
                                    const void* zpc, const void* xsum, const void* xs,
                                    const void* bias, void* out, int M, int K, int N, int g,
                                    int bits, int out_kind, void* stream) {
  if (bits != 1 && bits != 2 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 0 || K % g != 0 || (K * bits / 8) % KS != 0 || !xs)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zpc);
  const float* xsm = static_cast<const float*>(xsum);
  const float* xsc = static_cast<const float*>(xs);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / g;
  if (bits == 4) return launch_g<4>(g, xq, w, s, z, xsm, xsc, b, out, M, N, K, G, out_kind, st);
  if (bits == 2) return launch_g<2>(g, xq, w, s, z, xsm, xsc, b, out, M, N, K, G, out_kind, st);
  return launch_g<1>(g, xq, w, s, z, xsm, xsc, b, out, M, N, K, G, out_kind, st);
}
