// B4 (and B1's GEMM half): scaled GEMM with a fused epilogue.
//
//   out[m, n] = ((((acc[m, n] * xs[m]) * ws[n]) + bias[n]) + rs[m] * vz0[n]) + zp[m] * vz1[n]
//               (each term optional)
//   acc = A (M, K) . B (N, K)^T, both K-contiguous ("nt"), or, for the
//   8-bit kinds, acc = A (M, K) . B (K, N) with B N-contiguous ("nn");
//   int8 x int8 -> int32, fp8 e4m3 x e4m3 -> fp32, or bf16 x bf16 -> fp32
//   for the 16-bit family.
//
// Replaces sdnq_tpu/kernels/scaled_mm.py `_mm_kernel` (:57, wrapper
// `_scaled_mm_pallas` :133) and the GEMM half of `_fused_act_mm_kernel`
// (:230); the rank-1 zero-point terms are those of its asymmetric "uint8"
// mode.  At the FLUX shapes (M = 4608, K = 3072 or 15360) the product is
// bound by tensor-core operations (2*M*N*K ops against ~(M+N)*K bytes).
//
// "nt" (every forward) is Hopper's GEMM, built as csrc/wgmma_mm.cu's on
// csrc/hopper.cuh: A and B tiles arrive by TMA (128-byte swizzle; a stage
// row is 128 bytes of K: 128 int8 or e4m3 values, 64 bf16; the zero fill
// takes the M, N and K tails) in a ring of stages guarded by mbarriers,
// one producer warp issues the loads (hopper.cuh's `produce`), and two
// consumer warpgroups each run SS wgmma (K-major) on 64 rows of the tile:
// s8 x s8 -> s32 in k32 steps, bf16 in k16 steps, four a stage.  Tiles are
// 128 x 256 (m64n256: a 128-register accumulator a thread) where
// hopper.cuh's `wide_tiles` says, else 128 x 128; the blocks persist, one an
// SM, and walk the tiles with M fastest.  One wgmma group stays in flight
// while the next stage is issued.  The int32 sum is exact for K < 2^17
// (|a b| <= 2^14); the entry refuses a larger K.  e4m3 arrives by TMA as
// e4m3 but multiplies as fp16 (m64n128k16, 128 x 128 tiles): the consumers
// convert each stage into one of two fp16 buffers (e4m3 values and their
// products are exact in fp16 and fp32), since the fp8 wgmma's own sum keeps
// about 14 bits (DeepSeek-V3 §3.3.2), too few for the card tests' 1e-5 of
// sum |a b| even with a fresh fp32 promotion every k32 step.  The epilogue
// rounds each operation once (__fmul_rn / __fadd_rn) in the plain
// version's order, so the int8 result equals it bit for bit.
//
// "nn" is B1's grad-input orientation (`_fused_act_mm_kernel` with b_dim0,
// scaled_mm.py:283): the stored (O, K) weight is B with the contraction O
// as its slow axis.  8-bit wgmma operands are K-major only, so this mode
// keeps mma.sync m16n8k32: 128x128 output tiles, 8 warps each owning
// 64x32, 64-byte K stages double-buffered with cp.async, A's fragments
// from padded shared memory (80-byte rows: conflict-free 32-bit loads),
// and each 64-row stage of B read through registers and transposed in
// shared memory (sdnq::TransTile8, shared with scaled_mm_tn.cu), its loads
// issued before the current stage's products; no transposed weight is
// written to device memory.  K must be a multiple of 64 bytes (the wrapper
// zero-pads) and N a multiple of 4.
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace sdnq;

struct Epilogue {
  const float* xs;
  const float* ws;
  const float* bias;
  const float* rs;
  const float* zp;
  const float* vz0;
  const float* vz1;
};

enum { KIND_S8 = 0, KIND_BF16 = 1, KIND_E4M3 = 2 };  // operand kinds

// the epilogue of one output, from its accumulator (exact int32 or fp32)
struct RowTerms {
  float xs, rs, zp;
};
template <typename AccT>
__device__ __forceinline__ float epilogue(const Epilogue& ep, AccT a, const RowTerms& rt, int col) {
  float v;
  if constexpr (std::is_same<AccT, int>::value)
    v = __int2float_rn(a);
  else
    v = a;
  // the terms by the read-only path (__ldg): the compiler may issue them
  // ahead of the stores to the output
  if (ep.xs) v = __fmul_rn(v, rt.xs);
  if (ep.ws) v = __fmul_rn(v, __ldg(ep.ws + col));
  if (ep.bias) v = __fadd_rn(v, __ldg(ep.bias + col));
  if (ep.rs) v = __fadd_rn(v, __fmul_rn(rt.rs, __ldg(ep.vz0 + col)));
  if (ep.zp) v = __fadd_rn(v, __fmul_rn(rt.zp, __ldg(ep.vz1 + col)));
  return v;
}
__device__ __forceinline__ RowTerms row_terms(const Epilogue& ep, int row) {
  return RowTerms{ep.xs ? __ldg(ep.xs + row) : 1.f, ep.rs ? __ldg(ep.rs + row) : 0.f,
                  ep.zp ? __ldg(ep.zp + row) : 0.f};
}

// ---- nt: TMA + wgmma ---------------------------------------------------------
constexpr int BM = GEMM_BM;
constexpr int NT = 384;  // two consumer warpgroups, then the producer's

// one k-step of a warpgroup's 64 x 128 NB product (k32 for int8, k16 for
// bf16): acc += A . Bᵀ
template <int KIND, int NB, typename AccT>
__device__ __forceinline__ void mma_step(AccT (&acc)[NB * 64], uint64_t da, uint64_t db) {
  if constexpr (KIND == KIND_S8) {
    if constexpr (NB == 2)
      wgmma_s8_256(acc, da, db);
    else
      wgmma_s8(acc, da, db, 1);
  } else {
    if constexpr (NB == 2)
      wgmma256(acc, da, db);
    else
      wgmma128(acc, da, db, 1);
  }
}

// e4m3 x e4m3 runs as fp16 x fp16: each e4m3 stage is converted in shared
// memory into two k64 fp16 sub-tiles (e4m3 values and their products are
// exact in fp16 and fp32), because the fp8 wgmma's own sum keeps about 14
// bits (DeepSeek-V3 §3.3.2), too few for 1e-5 of sum |a b|, even with a
// fresh partial for every k32 step.
__device__ __forceinline__ unsigned e4m3x2_to_f16x2(unsigned v) {
  unsigned r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(static_cast<unsigned short>(v)));
  return r;
}
constexpr int CONV_BYTES = 2 * 128 * 256;  // A' and B': 128 rows of 128 fp16 each

// Stage s's e4m3 rows (A's 128, then B's; 128-byte swizzle, as TMA wrote
// them) into dst as fp16: A' then B', each two k64 sub-tiles of 128 rows
// in the 128-byte swizzle that sw128_desc reads; thread t of the 256
// consumer threads takes eight 16-byte chunks.
__device__ __forceinline__ void e4m3_to_f16(const uint8_t* src, uint8_t* dst, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int id = t + 256 * i;
    const int r = id >> 3, c = id & 7, rr = r & 127;  // codes 16 c .. 16 c + 15 of row r
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * 128 + ((c ^ (r & 7)) << 4));
    uint8_t* d = dst + (r >> 7) * (CONV_BYTES / 2) + (c >> 2) * (128 * 128) + rr * 128;
    const uint4 lo = make_uint4(e4m3x2_to_f16x2(v.x), e4m3x2_to_f16x2(v.x >> 16),
                                e4m3x2_to_f16x2(v.y), e4m3x2_to_f16x2(v.y >> 16));
    const uint4 hi = make_uint4(e4m3x2_to_f16x2(v.z), e4m3x2_to_f16x2(v.z >> 16),
                                e4m3x2_to_f16x2(v.w), e4m3x2_to_f16x2(v.w >> 16));
    *reinterpret_cast<uint4*>(d + (((2 * (c & 3)) ^ (rr & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(d + (((2 * (c & 3) + 1) ^ (rr & 7)) << 4)) = hi;
  }
}

// the two consumer warpgroups meet (named barrier 1; the producer's warp
// does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Tiles of 128 x 128 NB; a stage holds 128 rows of A and 128 NB of B, each
// row 128 bytes of K.
// e4m3 (NB 1) keeps three stages and two converted fp16 buffers.
template <int KIND, int NB>
struct Tile {
  static constexpr int BN = 128 * NB;
  static constexpr int ST = KIND == KIND_E4M3 ? 3 : NB == 2 ? 4 : 6;  // stages
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE_BYTES = A_BYTES + BN * 128;
  static constexpr int CONV = KIND == KIND_E4M3 ? 2 * CONV_BYTES : 0;
  static constexpr int SMEM_BYTES = ST * STAGE_BYTES + CONV + 2 * ST * 8 + 1024;  // + barriers, alignment
};

template <int KIND, int NB, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    scaled_mm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, OutT* __restrict__ out, int M,
                           int N, int K, Epilogue ep) {
  using T = Tile<KIND, NB>;
  using AccT = typename std::conditional<KIND == KIND_S8, int, float>::type;
  constexpr int BN = T::BN, ST = T::ST, A_BYTES = T::A_BYTES, STAGE_BYTES = T::STAGE_BYTES;
  constexpr int BKE = KIND == KIND_BF16 ? 64 : 128;  // K elements of a stage row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the first 1024-byte boundary (an offset from smem_raw, so that the
  // compiler keeps the shared address space: shared loads, not generic)
  uint8_t* smem = smem_raw + ((1024u - (sdnq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* conv = smem + ST * STAGE_BYTES;  // e4m3: the fp16 buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + T::CONV);
  uint64_t* empty = full + ST;
  const int mt = (M + BM - 1) / BM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const int nk = (K + BKE - 1) / BKE;  // the k-stages of a tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, with the stage's bytes
      mbar_init(&empty[s], 8);  // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256)
      produce<ST, STAGE_BYTES, A_BYTES, BKE, BN>(&ta, &tb, smem, full, empty, mt, tiles, nk);
    return;
  }
  // consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = threadIdx.x & 31, wr = (threadIdx.x & 127) >> 5;
  const int cq = 2 * (lane & 3);  // this thread's columns 128 h + 8 j + cq + {0, 1}
  AccT acc[NB * 64];              // columns 128 h + .. in acc[64 h ..]
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int pending = -1;  // the stage whose wgmmas may still be in flight
  int it = 0;        // stages consumed so far

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
    const int r0 = m0 + wg * 64 + wr * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
#pragma unroll
    for (int i = 0; i < NB * 64; ++i) acc[i] = 0;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      if constexpr (KIND == KIND_E4M3) {
        // buffer it & 1 was last read by the wgmmas of stage it - 2, which
        // both warpgroups have waited for
        uint8_t* cv = conv + (it & 1) * CONV_BYTES;
        consumers_sync();
        e4m3_to_f16(smem + s * STAGE_BYTES, cv, threadIdx.x);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        consumers_sync();
        release(s);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t da = sw128_desc(cv + h * 128 * 128 + wg * 64 * 128);
          const uint64_t db = sw128_desc(cv + CONV_BYTES / 2 + h * 128 * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma128_f16(acc, da + 2 * kk, db + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before's wgmmas have completed
      } else {
        const uint64_t da = sw128_desc(smem + s * STAGE_BYTES + wg * 64 * 128);
        const uint64_t db = sw128_desc(smem + s * STAGE_BYTES + A_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +2: 32 bytes along K
          mma_step<KIND, NB>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the stage before's wgmmas have completed
        if (pending >= 0) release(pending);
        pending = s;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) {  // the producer fills it for the next tile meanwhile
      release(pending);
      pending = -1;
    }
    store_tile<NB>(
        acc, out, r0, n0, cq, M, N, [&](int row) { return row_terms(ep, row); },
        [&](AccT a, const RowTerms& rt, int col) { return epilogue(ep, a, rt, col); });
  }
}

template <int KIND, int NB, typename OutT>
int launch_nt(const CUtensorMap& ta, const CUtensorMap& tb, void* out, int M, int N, int K,
              const Epilogue& ep, int grid, cudaStream_t s) {
  static bool ready = false;  // the block's shared memory is above the 48 KB default
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(scaled_mm_wgmma_kernel<KIND, NB, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<KIND, NB>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  scaled_mm_wgmma_kernel<KIND, NB, OutT>
      <<<grid, NT, Tile<KIND, NB>::SMEM_BYTES, s>>>(ta, tb, static_cast<OutT*>(out), M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int NB>
int launch_nt_out(int out_kind, const CUtensorMap& ta, const CUtensorMap& tb, void* out, int M,
                  int N, int K, const Epilogue& ep, int grid, cudaStream_t s) {
  if (out_kind == sdnq::F32) return launch_nt<KIND, NB, float>(ta, tb, out, M, N, K, ep, grid, s);
  if (out_kind == sdnq::BF16)
    return launch_nt<KIND, NB, __nv_bfloat16>(ta, tb, out, M, N, K, ep, grid, s);
  if (out_kind == sdnq::F16) return launch_nt<KIND, NB, __half>(ta, tb, out, M, N, K, ep, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KIND>
int launch_nt_kind(int nb, int out_kind, const CUtensorMap& ta, const CUtensorMap& tb, void* out,
                   int M, int N, int K, const Epilogue& ep, int grid, cudaStream_t s) {
  if constexpr (KIND == KIND_E4M3)  // the fp16 buffers take the shared memory of 128 x 256
    return launch_nt_out<KIND, 1>(out_kind, ta, tb, out, M, N, K, ep, grid, s);
  else
    return nb == 2 ? launch_nt_out<KIND, 2>(out_kind, ta, tb, out, M, N, K, ep, grid, s)
                   : launch_nt_out<KIND, 1>(out_kind, ta, tb, out, M, N, K, ep, grid, s);
}

// ---- nn: mma.sync with B transposed stage by stage --------------------------
constexpr int NN_BN = 128, BKB = 64;  // tile cols, K bytes per stage
constexpr int LDS = BKB + 16;         // padded shared-memory row (bytes)
constexpr int NN_NT = 256;

template <int KIND, typename OutT>
__global__ void __launch_bounds__(NN_NT)
    scaled_mm_nn_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                        OutT* __restrict__ C, int M, int N, int Kb, Epilogue ep) {
  __shared__ __align__(16) uint8_t sA[2][BM * LDS];
  __shared__ __align__(16) uint8_t sB[2][NN_BN * LDS];
  using AccT = typename std::conditional<KIND == KIND_S8, int, float>::type;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * NN_BN;

  auto load_a = [&](int stage, int kb0) {
#pragma unroll
    for (int i = 0; i < (BM * BKB / 16) / NN_NT; ++i) {
      const int c = tid + i * NN_NT;
      const int r = c >> 2, cb = (c & 3) * 16;
      const int ga = m0 + r;
      sdnq::cp_async16(&sA[stage][r * LDS + cb], A + (size_t)(ga < M ? ga : 0) * Kb + kb0 + cb,
                       ga < M);
    }
    sdnq::cp_async_commit();
  };
  sdnq::TransTile8<NN_NT, BKB> tb;  // B's stages through registers

  AccT acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int nk = Kb / BKB;
  load_a(0, 0);
  tb.load(B, N, 0, Kb, n0, N, tid);
  tb.store(sB[0], LDS, tid);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_a(cur ^ 1, (kt + 1) * BKB);
      tb.load(B, N, (kt + 1) * BKB, Kb, n0, N, tid);
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
          if constexpr (KIND == KIND_S8)
            sdnq::mma_s8(acc[mi][ni], af[mi], bfr[ni]);
          else
            sdnq::mma_e4m3(acc[mi][ni], af[mi], bfr[ni]);
        }
    }
    // sB[cur ^ 1] was last read before the previous barrier
    if (kt + 1 < nk) tb.store(sB[cur ^ 1], LDS, tid);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
      const RowTerms rt = row_terms(ep, row);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + j;
          if (col >= N) continue;
          C[(size_t)row * N + col] = sdnq::from_f32<OutT>(epilogue(ep, acc[mi][ni][h * 2 + j], rt, col));
        }
    }
}

template <int KIND>
int launch_nn(const void* a, const void* b, void* out, int M, int N, int Kb, int out_kind,
              const Epilogue& ep, cudaStream_t s) {
  dim3 grid((N + NN_BN - 1) / NN_BN, (M + BM - 1) / BM);
  const uint8_t* A = static_cast<const uint8_t*>(a);
  const uint8_t* B = static_cast<const uint8_t*>(b);
  if (out_kind == sdnq::F32)
    scaled_mm_nn_kernel<KIND, float><<<grid, NN_NT, 0, s>>>(A, B, static_cast<float*>(out), M, N, Kb, ep);
  else if (out_kind == sdnq::BF16)
    scaled_mm_nn_kernel<KIND, __nv_bfloat16>
        <<<grid, NN_NT, 0, s>>>(A, B, static_cast<__nv_bfloat16*>(out), M, N, Kb, ep);
  else if (out_kind == sdnq::F16)
    scaled_mm_nn_kernel<KIND, __half><<<grid, NN_NT, 0, s>>>(A, B, static_cast<__half*>(out), M, N, Kb, ep);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_kind 0 int8 / 1 bf16 / 2 fp8 e4m3; out (M, N) of out_kind; epilogue
// pointers may be null (rs needs vz0, zp needs vz1), all f32.
// nt (b_nn 0): a (M, K) and b (N, K) with rows lda and ldb elements apart
// (multiples of 16 bytes, base addresses 16-byte aligned); int8 K < 2^17.
// nn (b_nn 1, 8-bit kinds): a (M, K) and b (K, N) contiguous, K a multiple
// of 64 bytes, N of 4.
extern "C" int sdnq_scaled_mm(const void* a, int lda, const void* b, int ldb, void* out,
                              const void* xs, const void* ws, const void* bias, const void* rs,
                              const void* zp, const void* vz0, const void* vz1, int M, int N,
                              int K, int in_kind, int out_kind, int b_nn, void* stream) {
  if (in_kind != KIND_S8 && in_kind != KIND_BF16 && in_kind != KIND_E4M3) return static_cast<int>(cudaErrorInvalidValue);
  if ((rs && !vz0) || (zp && !vz1) || M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = in_kind == KIND_BF16 ? 2 : 1;
  const Epilogue ep{static_cast<const float*>(xs),  static_cast<const float*>(ws),
                    static_cast<const float*>(bias), static_cast<const float*>(rs),
                    static_cast<const float*>(zp),  static_cast<const float*>(vz0),
                    static_cast<const float*>(vz1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_nn) {
    const int Kb = K * esize;
    if (Kb % BKB != 0 || in_kind == KIND_BF16 || N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0 || N == 0) return 0;
    if (in_kind == KIND_S8) return launch_nn<KIND_S8>(a, b, out, M, N, Kb, out_kind, ep, s);
    return launch_nn<KIND_E4M3>(a, b, out, M, N, Kb, out_kind, ep, s);
  }
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (K < 1 || lda < K || ldb < K || (lda * esize) % 16 != 0 || (ldb * esize) % 16 != 0 ||
      misaligned(a) || misaligned(b) || (in_kind == KIND_S8 && K >= (1 << 17)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long mt = (M + BM - 1) / BM;
  const int nb = in_kind != KIND_E4M3 && wide_tiles(mt, N, sms) ? 2 : 1;
  const long long tiles = mt * ((N + 128 * nb - 1) / (128 * nb));
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // one block an SM
  const CUtensorMapDataType type =
      in_kind == KIND_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int box_k = 128 / esize;
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, M, K, lda, BM, type, esize, box_k) ||
      !tensor_map(&tb, b, N, K, ldb, 128 * nb, type, esize, box_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_kind == KIND_S8) return launch_nt_kind<KIND_S8>(nb, out_kind, ta, tb, out, M, N, K, ep, grid, s);
  if (in_kind == KIND_E4M3) return launch_nt_kind<KIND_E4M3>(nb, out_kind, ta, tb, out, M, N, K, ep, grid, s);
  return launch_nt_kind<KIND_BF16>(nb, out_kind, ta, tb, out, M, N, K, ep, grid, s);
}
