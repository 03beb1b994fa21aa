// B10: the grad-weight GEMM, contracting the leading axis of both operands.
//
//   out[n, k] = ((sum_m A[m, n] * B[m, k]) * a_s[n]) * b_s[k] + sum_r u[n, r] v[r, k]
//   (scales and the rank-R term optional)
//   A (M, N) and B (M, K) in their natural (row-major) layouts, both int8
//   (int32 accumulate) or both fp8 e4m3 (fp32 accumulate); out (N, K) fp32.
//
// Replaces sdnq_tpu/kernels/scaled_mm.py `_tn_mm_kernel` (:534, wrapper
// `_scaled_mm_tn_pallas` :576): gw = g^T x, with g and x quantized
// columnwise by the caller.  At FLUX.1-dev's training shapes (M = 1536
// tokens, N, K in the thousands) it is bound by tensor-core operations
// (2*M*N*K against M*N + M*K + 4*N*K bytes, the fp32 output the largest
// term); at M = 1 (the modulation linears at batch 1) by writing the output.
//
// Hopper's GEMM on csrc/hopper.cuh, as csrc/scaled_mm.cu's: one producer
// warp issues TMA loads (`produce_tn`) of token-major boxes -- `tok`
// contraction rows (tokens) x 128 columns of A and of B, as they lie in
// device memory; no transposed copy is written -- into a ring of stages
// guarded by mbarriers; TMA's zero fill takes the ragged M, N and K tails.
// Two consumer warpgroups own 64 output rows each of a 128 x 128 NB tile
// (128 x 256 where hopper.cuh's `wide_tiles` says); the blocks persist,
// one an SM.  Each stage is rewritten in shared memory
// into the layout its wgmma reads, by both warpgroups, into one of two
// buffers, so that one stage's products run while the next is rewritten:
//  - int8: 8-bit wgmma operands are K-major only (contraction contiguous),
//    a token-major tile is not, so each 128-token stage is transposed
//    (hopper.cuh's `Transpose8`) into [column][token] rows in the
//    128-byte swizzle, then s8 wgmma (m64n128k32 / m64n256k32) sums in
//    int32, exact for M < 2^17 (|a b| <= 2^14); a longer M is summed in
//    parts (below);
//  - e4m3: each 64-token stage is converted to fp16 (e4m3 values and their
//    products are exact in fp16 and fp32) without moving a column: 16-bit
//    wgmma reads MN-major operands (trans-a, trans-b), so the fp16 tile
//    keeps the tokens as its rows; fp32 sums (m64n128k16 / m64n256k16).
//    The fp8 wgmma's own sum keeps about 14 bits (DeepSeek-V3 §3.3.2), too
//    few for 1e-5 of sum |a b| (B4's e4m3 probes, chip_smoke.py phase 8).
// Below 128 (int8) or 64 (e4m3) tokens a stage holds M rounded up to 32:
// at M = 1 one k32 step makes the sum and TMA fills 31 rows, not 127.
// The epilogue goes through shared memory so that each warp stores whole
// output rows (the fp32 output is the largest term of the bytes, and
// wgmma's fragments would store 32 bytes a row); it rounds each operation
// once (__fmul_rn, __fadd_rn) in the plain version's order, so the int8
// result equals it bit for bit; the
// rank-R term is summed in fp32 in r order (torch's u @ v may round it
// otherwise) and added last, so the uint8 family's grad-weight is one pass
// over the output.  The tile walk takes the smaller operand's tiles fastest,
// so that the larger one is read from device memory about once.
//
// int8 over 2^17 tokens or more (FLUX.1-dev's grad-weights at batch 29 and
// up), in `parts` as the wrapper's `long_parts` says: each tile's stages
// split into parts of fewer than 2^17 tokens, each its own unit (hopper.cuh's
// `part_stages`, as B4's), int32 sums in slabs, the tile's last part adds
// them in int64 (`wide_total`), so the total is exact and rounded once,
// bit-equal to the plain version's.
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace sdnq;

enum { S8 = 0, E4M3 = 2 };  // operand kinds, as in scaled_mm.cu
constexpr int NT = 384;     // two consumer warpgroups, then the producer's

// Tiles of 128 x 128 NB; a stage holds one A box and NB B boxes of TOK
// token rows x 128 bytes, in a ring of ST; the consumers' two buffers hold
// a rewritten stage each: int8 A' (128 x 128 tokens) then B' (128 NB x 128
// tokens); e4m3 fp16 A' then B', each 64-column chunks of TOK token rows,
// chunk c at c * TOK * 128.  The epilogue stages its output in them too
// (TN_LDW floats a row, 128 rows: at most a buffer's size).
template <int KIND, int NB>
struct TnTile {
  static constexpr int TOK = KIND == S8 ? 128 : 64;
  static constexpr int BK = 128 * NB;
  static constexpr int BOX = TOK * 128;
  static constexpr int STAGE_BYTES = BOX * (1 + NB);
  static constexpr int ST = KIND == S8 && NB == 2 ? 2 : 4;  // 192 KB or less in all
  static constexpr int CONV = KIND == S8 ? 128 * 128 * (1 + NB) : 2 * BOX * (1 + NB);
  static constexpr int SMEM_BYTES = ST * STAGE_BYTES + 2 * CONV + 2 * ST * 8 + 16 + 1024;
};

// A long int8 call's workspace: a counter a tile (0 between calls) and
// parts x tiles slabs of 128 x 128 NB int32.
struct TnWork {
  int* counters;
  int* slabs;
};

struct TnEpilogue {
  const float* as;  // (N,)
  const float* bs;  // (K,)
  const float* u;   // (N, R)
  const float* v;   // (R, K)
  int R, N, K;
};

__device__ __forceinline__ void consumers_sync() { gemm_consumers_sync(); }

// an accumulator as fp32: an int32 sum rounded, or (`fbits`) a long
// contraction's total, already rounded and kept as the float's bits
template <typename AccT>
__device__ __forceinline__ float acc_value(AccT a, bool fbits) {
  if constexpr (std::is_same<AccT, int>::value)
    return fbits ? __int_as_float(a) : static_cast<float>(a);
  else
    return a;
}

// A tile's outputs through shared memory (`buf`, the consumers' buffers,
// free once both warpgroups have waited for their last wgmmas): 64 columns
// at a time, each thread writes its accumulators (wgmma's layout: rows
// 16 (t / 32) + (t % 32) / 4 and 8 below, columns 8 j + 2 (t % 4) + {0, 1})
// times their row scale into rows of TN_LDW floats, then each warp stores
// whole rows: a row's 64 columns as 16 lanes' 16-byte stores (coalesced;
// where K is not a multiple of 4, one value a lane at a time), times the
// column scale and plus the rank-R term on the way out.  Every scale is
// loaded before the first store (a load after a store to `out` would wait
// for it).  Each operation is rounded once, in the plain version's order.
constexpr int TN_CW = 64, TN_LDW = TN_CW + 8;  // staged columns; padded row (floats)
template <int NB, typename AccT>
__device__ __forceinline__ void store_tile_tn(const AccT (&acc)[NB * 64], uint8_t* buf,
                                              float* __restrict__ out, int2 nk0, int cq,
                                              const TnEpilogue& ep, bool fbits = false) {
  float* sm = reinterpret_cast<float*>(buf);
  const int t = threadIdx.x, lane = t & 31;
  const int rl = (t >> 7) * 64 + ((t & 127) >> 5) * 16 + (lane >> 2);  // local rows rl, rl + 8
  const int N = ep.N, K = ep.K, c4 = 4 * (t & 15);
  const bool vec = K % 4 == 0;
  float sa[2];  // the row scales of rows rl, rl + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) sa[hr] = ep.as ? __ldg(ep.as + min(nk0.x + rl + 8 * hr, N - 1)) : 1.f;
#pragma unroll
  for (int c = 0; c < NB * 128 / TN_CW; ++c) {
    const int h = c >> 1, j0 = 8 * (c & 1);
    const int k0 = nk0.y + TN_CW * c + c4;
    float sb[4];  // the column scales of columns k0 .. k0 + 3
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[e] = ep.bs ? __ldg(ep.bs + min(k0 + e, K - 1)) : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 64 * h + 4 * (j0 + j) + 2 * hr;
        float v0 = acc_value(acc[i], fbits), v1 = acc_value(acc[i + 1], fbits);
        if (ep.as) v0 = __fmul_rn(v0, sa[hr]), v1 = __fmul_rn(v1, sa[hr]);
        *reinterpret_cast<float2*>(sm + (rl + 8 * hr) * TN_LDW + 8 * j + cq) = make_float2(v0, v1);
      }
    consumers_sync();
#pragma unroll 2
    for (int p = 0; p < 8; ++p) {  // rows 16 p + t / 16
      const int r = 16 * p + (t >> 4), row = nk0.x + r;
      if (row < N && k0 < K) {
        const float4 a = *reinterpret_cast<const float4*>(sm + r * TN_LDW + c4);
        float w[4] = {a.x, a.y, a.z, a.w};
        if (ep.bs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = __fmul_rn(w[e], sb[e]);
        }
        if (ep.u) {  // the rank-R term, summed in r order, then added
          const float* u = ep.u + (size_t)row * ep.R;
          for (int e = 0; e < 4; ++e) {
            const int col = min(k0 + e, K - 1);
            float s = __fmul_rn(__ldg(u), __ldg(ep.v + col));
            for (int q = 1; q < ep.R; ++q) s = __fmaf_rn(__ldg(u + q), __ldg(ep.v + (size_t)q * K + col), s);
            w[e] = __fadd_rn(w[e], s);
          }
        }
        float* o = out + (size_t)row * K + k0;
        if (vec && k0 + 3 < K) {
          *reinterpret_cast<float4*>(o) = make_float4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + e < K) o[e] = w[e];
        }
      }
    }
    consumers_sync();  // before the next chunk overwrites `sm`
  }
}

// LONG: an int8 sum over 2^17 tokens or more (`parts` > 1), a build of its
// own, so that the others keep their registers
template <int KIND, int NB, bool LONG>
__global__ void __launch_bounds__(NT, 1)
    scaled_mm_tn_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                              const __grid_constant__ CUtensorMap tb, float* __restrict__ out,
                              int M, int tok, int k_fast, int parts_, TnWork work,
                              TnEpilogue ep) {
  using T = TnTile<KIND, NB>;
  using AccT = typename std::conditional<KIND == S8, int, float>::type;
  constexpr int ST = T::ST, STAGE_BYTES = T::STAGE_BYTES, BOX = T::BOX, CONV = T::CONV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (sdnq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* conv = smem + ST * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + 2 * CONV);
  uint64_t* empty = full + ST;
  int* last = reinterpret_cast<int*>(empty + ST);  // parts: this tile's last part
  const int parts = LONG ? parts_ : 1;
  const int N = ep.N, K = ep.K;
  const int nt = (N + 127) / 128, kt = (K + T::BK - 1) / T::BK;
  const int tiles = nt * kt;
  const int nk = (M + tok - 1) / tok;  // the stages of a tile
  const int wg = threadIdx.x / 128;
  auto at = [&](int tile) {  // (n0, k0); the smaller operand's tiles fastest
    return k_fast ? make_int2((tile / kt) * 128, (tile % kt) * T::BK)
                  : make_int2((tile % nt) * 128, (tile / nt) * T::BK);
  };

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
      produce_tn<ST, STAGE_BYTES, BOX, NB>(&ta, &tb, smem, full, empty, tiles, nk, tok, at, parts);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  const Transpose8 tr(threadIdx.x);
  AccT acc[NB * 64];
  int it = 0;  // stages consumed so far

  for (int u = blockIdx.x; u < tiles * parts; u += gridDim.x) {
    const int tile = u % tiles, part = u / tiles;
    const int2 nk0 = at(tile);
    const int2 kr = part_stages(part, parts, nk);
#pragma unroll
    for (int i = 0; i < NB * 64; ++i) acc[i] = 0;
    for (int kb = kr.x; kb < kr.y; ++kb, ++it) {
      const int s = it % ST;
      const uint8_t* st = smem + s * STAGE_BYTES;
      uint8_t* cv = conv + (it & 1) * CONV;
      mbar_wait(&full[s], (it / ST) & 1);
      // buffer it & 1 was last read by the wgmmas of stage it - 2, which
      // both warpgroups have waited for
      consumers_sync();
      if constexpr (KIND == S8) {
#pragma unroll
        for (int h = 0; h <= NB; ++h) tr.run(st + h * BOX, cv + h * 128 * 128, tok);  // A, then B's
      } else {
#pragma unroll
        for (int h = 0; h <= NB; ++h)
          e4m3_rows_to_f16(st + h * BOX, cv + h * 2 * BOX, tok, BOX, threadIdx.x);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      consumers_sync();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the raw stage is free
      fence_regs(acc);
      wgmma_fence();
      if constexpr (KIND == S8) {
        const uint64_t da = sw128_desc(cv + wg * 64 * 128);
        const uint64_t db = sw128_desc(cv + 128 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // +2: 32 tokens along the rows
          if (kk * 32 >= tok) break;
          if constexpr (NB == 2)
            wgmma_s8_256(acc, da + 2 * kk, db + 2 * kk);
          else
            wgmma_s8(acc, da + 2 * kk, db + 2 * kk, 1);
        }
      } else {
        const uint64_t da = sw128_desc_mn(cv + wg * BOX, BOX);
        const uint64_t db = sw128_desc_mn(cv + 2 * BOX, BOX);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // +128: 16 token rows
          if (kk * 16 >= tok) break;
          if constexpr (NB == 2)
            wgmma256_f16_tt(acc, da + 128 * kk, db + 128 * kk);
          else
            wgmma128_f16_tt(acc, da + 128 * kk, db + 128 * kk);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before's wgmmas have completed
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (LONG) {  // this part's sum, then the tile's last adds them
      const int rl = (threadIdx.x >> 7) * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
      constexpr int SLAB = 128 * T::BK;
      int* slab0 = work.slabs + (size_t)tile * SLAB;
      const size_t stride = (size_t)tiles * SLAB;
      slab_store<NB>(acc, slab0 + part * stride, rl, cq, N - nk0.x);
      if (!last_part(work.counters + tile, parts, last)) continue;
      wide_total<NB>(acc, slab0, stride, parts, part, rl, cq, N - nk0.x);
    }
    consumers_sync();  // the other warpgroup's last wgmmas have read `conv`
    store_tile_tn<NB>(acc, conv, out, nk0, cq, ep, LONG);  // LONG: the total's fp32 bits
  }
}

template <int KIND, int NB, bool LONG = false>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, float* out, int M, int tok, int k_fast,
           int parts, const TnWork& work, const TnEpilogue& ep, int grid, cudaStream_t s) {
  constexpr int smem = TnTile<KIND, NB>::SMEM_BYTES;
  static bool ready = false;  // the block's shared memory is above the 48 KB default
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(scaled_mm_tn_wgmma_kernel<KIND, NB, LONG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  scaled_mm_tn_wgmma_kernel<KIND, NB, LONG>
      <<<grid, NT, smem, s>>>(ta, tb, out, M, tok, k_fast, parts, work, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, N) and b (M, K) with rows lda and ldb bytes apart (multiples of 16,
// base addresses 16-byte aligned), in_kind 0 int8 / 2 fp8 e4m3; out (N, K)
// fp32 contiguous; a_s (N,), b_s (K,) fp32 or null; u (N, R) and v (R, K)
// fp32 contiguous, both or neither.  The wrapper's plan (scaled_mm.py
// `tn_plan`): `tok` tokens a stage, a multiple of 32 up to 128 (int8) or 64
// (e4m3), and k_fast 1 to walk the K tiles fastest; the tiles are 128 x 256
// where `wide_tiles` says, as scaled_mm.cu's.  An int8 M >= 2^17 takes
// `parts` > 1 (stages of 128 tokens, each part at most LONG_PART_STAGES;
// `counters` a tile, zero, and `slabs` parts x tiles x 128 x 256 int32);
// else parts 1.
extern "C" int sdnq_scaled_mm_tn(const void* a, int lda, const void* b, int ldb, void* out,
                                 const void* a_s, const void* b_s, const void* u, const void* v,
                                 int R, int M, int N, int K, int in_kind, int tok, int k_fast,
                                 int parts, void* counters, void* slabs, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const int tok_max = in_kind == S8 ? 128 : 64;
  if ((in_kind != S8 && in_kind != E4M3) || M < 1 || N < 1 || K < 1 || lda < N || ldb < K ||
      lda % 16 != 0 || ldb % 16 != 0 || misaligned(a) || misaligned(b) || tok < 32 ||
      tok > tok_max || tok % 32 != 0 || (!u != !v) || (u && R < 1) || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_kind == S8 && M >= LONG_K) {  // parts, each under 2^17 tokens
    const int nk = (M + 127) / 128;
    if (tok != 128 || parts < 2 || (nk + parts - 1) / parts > LONG_PART_STAGES || !counters ||
        !slabs)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (parts != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = wide_tiles((N + 127) / 128, K, sms) ? 2 : 1;
  const long long tiles = (long long)((N + 127) / 128) * ((K + 128 * nb - 1) / (128 * nb));
  const long long units = tiles * parts;
  const int grid = static_cast<int>(units < sms ? units : sms);  // one block an SM
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, M, N, lda, tok, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128) ||
      !tensor_map(&tb, b, M, K, ldb, tok, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const TnEpilogue ep{static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                      static_cast<const float*>(u), static_cast<const float*>(v), u ? R : 0, N, K};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TnWork work{static_cast<int*>(counters), static_cast<int*>(slabs)};
  if (in_kind == E4M3)
    return nb == 2 ? launch<E4M3, 2>(ta, tb, o, M, tok, k_fast, 1, work, ep, grid, s)
                   : launch<E4M3, 1>(ta, tb, o, M, tok, k_fast, 1, work, ep, grid, s);
  if (parts > 1)
    return nb == 2 ? launch<S8, 2, true>(ta, tb, o, M, tok, k_fast, parts, work, ep, grid, s)
                   : launch<S8, 1, true>(ta, tb, o, M, tok, k_fast, parts, work, ep, grid, s);
  return nb == 2 ? launch<S8, 2>(ta, tb, o, M, tok, k_fast, 1, work, ep, grid, s)
                 : launch<S8, 1>(ta, tb, o, M, tok, k_fast, 1, work, ep, grid, s);
}
