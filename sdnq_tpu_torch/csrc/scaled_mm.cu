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
// (|a b| <= 2^14); a longer int8 contraction splits each tile into parts
// of fewer than 2^17 rows (hopper.cuh's `part_stages`: their own units,
// int32 sums in slabs, the tile's last part adds them in int64 and rounds
// once to fp32), so the result stays the plain version's bit for bit at
// any K.  e4m3 arrives by TMA as
// e4m3 but multiplies as fp16 (m64n128k16, 128 x 128 tiles): the consumers
// convert each stage into one of two fp16 buffers (e4m3 values and their
// products are exact in fp16 and fp32), since the fp8 wgmma's own sum keeps
// about 14 bits (DeepSeek-V3 §3.3.2), too few for the card tests' 1e-5 of
// sum |a b| even with a fresh fp32 promotion every k32 step.  The epilogue
// rounds each operation once (__fmul_rn / __fadd_rn) in the plain
// version's order, so the int8 result equals it bit for bit.
//
// "nn" is B1's grad-input orientation (`_fused_act_mm_kernel` with b_dim0,
// scaled_mm.py:283): the stored (O, K) weight is B (K, N) with the
// contraction as its slow axis, read as it lies: no transposed copy is
// written to device memory.  The same persistent TMA + wgmma GEMM: A
// arrives K-major (nt's boxes), B in boxes of 128 contraction rows x 128
// columns (as scaled_mm_tn.cu's `produce_tn` reads its operands), and the
// consumers rewrite each B stage in shared memory into the layout wgmma
// reads, into one of two buffers, while the stage before multiplies:
//  - int8: 8-bit wgmma operands are K-major only, so each B box is
//    transposed (hopper.cuh's `Transpose8`) into [column][contraction]
//    rows in the 128-byte swizzle; A is read from the stage as TMA wrote
//    it, so the transpose traffic is half of B10's; s8 wgmma m64n128k32 /
//    m64n256k32 into int32 (128 x 256 tiles where the plan says);
//  - e4m3: each stage converted to fp16, A K-major and B MN-major (trans-b:
//    no transpose), fp32 sums, 128 x 128 tiles.
// The grad-input's output is narrow ((M, 3072) against a contraction of
// 9216-21504; M = 1 at the batch-1 modulation linears: 24 tiles), so its
// tiles fill the SMs in few rounds, the last one part-empty.  The wrapper's
// plan (scaled_mm.py `nn_plan`) computes the first `whole` tiles whole, in
// full rounds, and splits the contraction of the others `splits` ways, so
// that their units fill the last round: such a unit writes its partial sum
// (int32 or fp32) to its slab of the workspace and counts itself in; the
// tile's last unit sets the tile's counter back to 0 (so that the next call
// finds the counters as it needs them, with no fill), adds the other slabs
// in split order and runs the epilogue.  Int32 partials add exactly in any order, so the int8 result
// stays bit-equal to the plain version's; at K >= 2^17 every tile is split
// into parts of fewer than 2^17 rows and the last adds them in int64
// (`wide_total`), as nt's parts.
// At the training shapes it is bound by tensor-core operations; at M = 1
// by reading the weight (2 M N K operations against K N bytes).
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
constexpr int CONV_BYTES = 2 * 128 * 256;  // A' and B': 128 rows of 128 fp16 each

// ROWS e4m3 rows of a stage (nt: A's 128, then B's; nn: A's; 128-byte
// swizzle, as TMA wrote them) into dst as fp16: A' then B', each two k64
// sub-tiles of 128 rows in the 128-byte swizzle that sw128_desc reads;
// thread t of the 256 consumer threads takes ROWS / 32 16-byte chunks.
template <int ROWS = 256>
__device__ __forceinline__ void e4m3_to_f16(const uint8_t* src, uint8_t* dst, int t) {
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
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

__device__ __forceinline__ void consumers_sync() { gemm_consumers_sync(); }

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
  static constexpr int SMEM_BYTES = ST * STAGE_BYTES + CONV + 2 * ST * 8 + 16 + 1024;  // + barriers, flag, alignment
};

// A long int8 call's workspace (hopper.cuh's `part_stages`; nn's split
// tiles too): an arrival counter a split tile (0 between calls), and its
// parts' slabs of int32 (int8) or fp32 (e4m3, nn) partial sums.
struct NnWork {
  int* counters;
  void* slabs;
};

template <int KIND, int NB, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    scaled_mm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, OutT* __restrict__ out, int M,
                           int N, int K, int parts, NnWork work, Epilogue ep) {
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
  int* last = reinterpret_cast<int*>(empty + ST);  // a long call: this tile's last part
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
      produce<ST, STAGE_BYTES, A_BYTES, BKE, BN>(&ta, &tb, smem, full, empty, mt, tiles, nk, parts);
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

  for (int u = blockIdx.x; u < tiles * parts; u += gridDim.x) {
    const int tile = u % tiles, part = u / tiles;
    const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
    const int rl = wg * 64 + wr * 16 + (lane >> 2), r0 = m0 + rl;  // this thread's rows r0, r0 + 8
    const int2 kr = part_stages(part, parts, nk);
#pragma unroll
    for (int i = 0; i < NB * 64; ++i) acc[i] = 0;
    for (int kb = kr.x; kb < kr.y; ++kb, ++it) {
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
    if constexpr (KIND == KIND_S8) {
      if (parts > 1) {  // a long contraction: this part's sum, then the last adds them
        constexpr int SLAB = 128 * BN;
        int* slab0 = static_cast<int*>(work.slabs) + (size_t)tile * SLAB;
        const size_t stride = (size_t)tiles * SLAB;
        slab_store<NB>(acc, slab0 + part * stride, rl, cq, M - m0);
        if (!last_part(work.counters + tile, parts, last)) continue;
        wide_total<NB>(acc, slab0, stride, parts, part, rl, cq, M - m0);
        store_tile<NB>(
            acc, out, r0, n0, cq, M, N, [&](int row) { return row_terms(ep, row); },
            [&](int a, const RowTerms& rt, int col) { return epilogue(ep, __int_as_float(a), rt, col); });
        continue;
      }
    }
    store_tile<NB>(
        acc, out, r0, n0, cq, M, N, [&](int row) { return row_terms(ep, row); },
        [&](AccT a, const RowTerms& rt, int col) { return epilogue(ep, a, rt, col); });
  }
}

template <int KIND, int NB, typename OutT>
int launch_nt(const CUtensorMap& ta, const CUtensorMap& tb, void* out, int M, int N, int K,
              int parts, const NnWork& work, const Epilogue& ep, int grid, cudaStream_t s) {
  static bool ready = false;  // the block's shared memory is above the 48 KB default
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(scaled_mm_wgmma_kernel<KIND, NB, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<KIND, NB>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  scaled_mm_wgmma_kernel<KIND, NB, OutT>
      <<<grid, NT, Tile<KIND, NB>::SMEM_BYTES, s>>>(ta, tb, static_cast<OutT*>(out), M, N, K, parts,
                                                    work, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int NB>
int launch_nt_out(int out_kind, const CUtensorMap& ta, const CUtensorMap& tb, void* out, int M,
                  int N, int K, int parts, const NnWork& work, const Epilogue& ep, int grid,
                  cudaStream_t s) {
  if (out_kind == sdnq::F32)
    return launch_nt<KIND, NB, float>(ta, tb, out, M, N, K, parts, work, ep, grid, s);
  if (out_kind == sdnq::BF16)
    return launch_nt<KIND, NB, __nv_bfloat16>(ta, tb, out, M, N, K, parts, work, ep, grid, s);
  if (out_kind == sdnq::F16)
    return launch_nt<KIND, NB, __half>(ta, tb, out, M, N, K, parts, work, ep, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KIND>
int launch_nt_kind(int nb, int out_kind, const CUtensorMap& ta, const CUtensorMap& tb, void* out,
                   int M, int N, int K, int parts, const NnWork& work, const Epilogue& ep,
                   int grid, cudaStream_t s) {
  if constexpr (KIND == KIND_E4M3)  // the fp16 buffers take the shared memory of 128 x 256
    return launch_nt_out<KIND, 1>(out_kind, ta, tb, out, M, N, K, parts, work, ep, grid, s);
  else
    return nb == 2 ? launch_nt_out<KIND, 2>(out_kind, ta, tb, out, M, N, K, parts, work, ep, grid, s)
                   : launch_nt_out<KIND, 1>(out_kind, ta, tb, out, M, N, K, parts, work, ep, grid, s);
}

// ---- nn: TMA + wgmma, B rewritten stage by stage in shared memory -----------
// A stage holds A's box (128 rows x 128 bytes of K, as nt's) and NB boxes of
// B (128 contraction rows x 128 columns each, as they lie); BOX bytes each.
constexpr int BOX = 128 * 128;

template <int KIND, int NB>
struct NnTile {
  static constexpr int BN = 128 * NB;
  static constexpr int STAGE_BYTES = BOX * (1 + NB);
  static constexpr int ST = KIND == KIND_E4M3 ? 2 : NB == 2 ? 3 : 4;  // stages
  // each of the consumers' two buffers: int8 B' (BN rows of 128 bytes of
  // contraction); e4m3 A' (two k64 fp16 sub-tiles of 128 rows) then B'
  // (two fp16 chunks of 64 columns x 128 contraction rows)
  static constexpr int CONV = KIND == KIND_E4M3 ? 4 * BOX : NB * BOX;
  static constexpr int SMEM_BYTES = ST * STAGE_BYTES + 2 * CONV + 2 * ST * 8 + 16 + 1024;
};

// The units of a call: tiles 0 .. whole - 1 whole (M fastest), then split
// s of tail tile t (tile whole + t) for s = 0 .. splits - 1 (one split of
// every tail tile before the next split, so that the blocks at work at once
// share their stripes of B in the L2 cache).  A unit takes stages [kb0,
// kb1) of nk; `part` is its tail tile's index, -1 for a whole tile.
struct NnPlan {
  int mt, tiles, whole, splits, nk;
  __device__ __forceinline__ int units() const { return whole + (tiles - whole) * splits; }
};
struct NnUnit {
  int part, split, m0, n0, kb0, kb1;
};
__device__ __forceinline__ NnUnit nn_unit(int u, const NnPlan& p, int bn) {
  NnUnit w;
  int tile = u;
  w.part = -1, w.split = 0, w.kb0 = 0, w.kb1 = p.nk;
  if (u >= p.whole) {
    const int tail = p.tiles - p.whole, v = u - p.whole;
    w.part = v % tail;
    w.split = v / tail;
    tile = p.whole + w.part;
    w.kb0 = (w.split * p.nk) / p.splits;
    w.kb1 = ((w.split + 1) * p.nk) / p.splits;
  }
  w.m0 = (tile % p.mt) * BM;
  w.n0 = (tile / p.mt) * bn;
  return w;
}

// The producer's loop: one thread issues each stage's loads, A's box at
// (kb * 128, m0) and B's at (n0 + 128 h, kb * 128), the units walked as the
// consumers walk them; it waits for a stage's last load before re-arming
// it, and for every load before it returns.
template <int ST, int STAGE_BYTES, int NB>
__device__ __forceinline__ void produce_nn(const CUtensorMap* ta, const CUtensorMap* tb,
                                           uint8_t* smem, uint64_t* full, uint64_t* empty,
                                           const NnPlan& p) {
  int it = 0;  // stages filled so far
  for (int u = blockIdx.x; u < p.units(); u += gridDim.x) {
    const NnUnit w = nn_unit(u, p, 128 * NB);
    for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (it >= ST) mbar_wait(&full[s], ((it / ST) & 1) ^ 1);
      mbar_expect_tx(&full[s], STAGE_BYTES);
      uint8_t* st = smem + s * STAGE_BYTES;
      tma_load(st, ta, &full[s], kb * 128, w.m0);
#pragma unroll
      for (int h = 0; h < NB; ++h) tma_load(st + (1 + h) * BOX, tb, &full[s], w.n0 + 128 * h, kb * 128);
    }
  }
  for (int j = it > ST ? it - ST : 0; j < it; ++j) mbar_wait(&full[j % ST], (j / ST) & 1);
}

// The split tiles' workspace (`NnWork`): an arrival counter a tail tile,
// and a slab of partial sums a split and tail tile (hopper.cuh's
// `slab_store` layout).
// acc += the slab's share (read through the L2: other SMs wrote it)
template <int NB, typename AccT>
__device__ __forceinline__ void slab_add(AccT (&acc)[NB * 64], const AccT* slab, int rl, int cq,
                                         int rows) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rl + 8 * hr >= rows) continue;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 64 * h + 4 * j + 2 * hr;
        const AccT* p = slab + (rl + 8 * hr) * (128 * NB) + 128 * h + 8 * j + cq;
        if constexpr (std::is_same<AccT, int>::value) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(p));
          acc[i] += v.x, acc[i + 1] += v.y;
        } else {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
          acc[i] += v.x, acc[i + 1] += v.y;
        }
      }
  }
}

template <int KIND, int NB, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    scaled_mm_nn_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                              const __grid_constant__ CUtensorMap tb, OutT* __restrict__ out,
                              int M, int N, int K, int whole, int splits, NnWork work,
                              Epilogue ep) {
  using T = NnTile<KIND, NB>;
  using AccT = typename std::conditional<KIND == KIND_S8, int, float>::type;
  constexpr int BN = T::BN, ST = T::ST, STAGE_BYTES = T::STAGE_BYTES, CONV = T::CONV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (sdnq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* conv = smem + ST * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + 2 * CONV);
  uint64_t* empty = full + ST;
  int* last = reinterpret_cast<int*>(empty + ST);  // this tile's last unit
  const int mt = (M + BM - 1) / BM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const NnPlan plan{mt, tiles, whole, splits, (K + 127) / 128};  // 128 contraction rows a stage
  const int tail = tiles - whole;
  const int wg = threadIdx.x / 128;
  int* counters = work.counters;
  AccT* slabs = static_cast<AccT*>(work.slabs);

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
      produce_nn<ST, STAGE_BYTES, NB>(&ta, &tb, smem, full, empty, plan);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = threadIdx.x & 31, wr = (threadIdx.x & 127) >> 5;
  const int cq = 2 * (lane & 3);
  const Transpose8 tr(threadIdx.x);
  AccT acc[NB * 64];
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int pending = -1;  // int8: the stage whose wgmmas (reading A there) may be in flight
  int it = 0;        // stages consumed so far

  for (int u = blockIdx.x; u < plan.units(); u += gridDim.x) {
    const NnUnit w = nn_unit(u, plan, BN);
    const int rl = wg * 64 + wr * 16 + (lane >> 2), r0 = w.m0 + rl;  // rows r0, r0 + 8
#pragma unroll
    for (int i = 0; i < NB * 64; ++i) acc[i] = 0;
    for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
      const int s = it % ST;
      const uint8_t* st = smem + s * STAGE_BYTES;
      uint8_t* buf = conv + (it & 1) * CONV;
      mbar_wait(&full[s], (it / ST) & 1);
      // buffer it & 1 was last read by the wgmmas of stage it - 2, which
      // both warpgroups have waited for
      consumers_sync();
      if constexpr (KIND == KIND_S8) {
#pragma unroll
        for (int h = 0; h < NB; ++h) tr.run(st + (1 + h) * BOX, buf + h * BOX, 128);  // B's boxes
      } else {
        e4m3_to_f16<128>(st, buf, threadIdx.x);                          // A' K-major
        e4m3_rows_to_f16(st + BOX, buf + 2 * BOX, 128, BOX, threadIdx.x);  // B' MN-major
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      consumers_sync();
      fence_regs(acc);
      wgmma_fence();
      if constexpr (KIND == KIND_S8) {
        const uint64_t da = sw128_desc(st + wg * 64 * 128);
        const uint64_t db = sw128_desc(buf);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +2: 32 bytes along the contraction
          mma_step<KIND_S8, NB>(acc, da + 2 * kk, db + 2 * kk);
      } else {
        release(s);  // the raw stage is converted
        const uint64_t db = sw128_desc_mn(buf + 2 * BOX, BOX);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t da = sw128_desc(buf + h * BOX + wg * 64 * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // +128: 16 contraction rows of B'
            wgmma128_f16_tb(acc, da + 2 * kk, db + 128 * (4 * h + kk));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before's wgmmas have completed
      if constexpr (KIND == KIND_S8) {
        if (pending >= 0) release(pending);
        pending = s;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) {  // the producer fills it for the next unit meanwhile
      release(pending);
      pending = -1;
    }
    if (w.part >= 0 && splits > 1) {  // a split tile: its partial sum, then the last adds them
      constexpr int SLAB = 128 * BN;
      slab_store<NB>(acc, slabs + ((size_t)w.split * tail + w.part) * SLAB, rl, cq, M - w.m0);
      __threadfence();
      consumers_sync();
      if (threadIdx.x == 0) {
        *last = atomicAdd(counters + w.part, 1) == splits - 1;
        if (*last) counters[w.part] = 0;  // every unit of the tile has counted itself in
      }
      consumers_sync();
      if (!*last) continue;
      __threadfence();
      if constexpr (KIND == KIND_S8) {
        if (K >= (1 << 17)) {  // a long contraction: the parts added in int64
          wide_total<NB>(acc, slabs + (size_t)w.part * SLAB, (size_t)tail * SLAB, splits, w.split,
                         rl, cq, M - w.m0);
          store_tile<NB>(
              acc, out, r0, w.n0, cq, M, N, [&](int row) { return row_terms(ep, row); },
              [&](int a, const RowTerms& rt, int col) {
                return epilogue(ep, __int_as_float(a), rt, col);
              });
          continue;
        }
      }
      for (int sp = 0; sp < splits; ++sp)
        if (sp != w.split)
          slab_add<NB>(acc, slabs + ((size_t)sp * tail + w.part) * SLAB, rl, cq, M - w.m0);
    }
    store_tile<NB>(
        acc, out, r0, w.n0, cq, M, N, [&](int row) { return row_terms(ep, row); },
        [&](AccT a, const RowTerms& rt, int col) { return epilogue(ep, a, rt, col); });
  }
}

template <int KIND, int NB, typename OutT>
int launch_nn(const CUtensorMap& ta, const CUtensorMap& tb, void* out, int M, int N, int K,
              int whole, int splits, const NnWork& work, const Epilogue& ep, int grid,
              cudaStream_t s) {
  constexpr int smem = NnTile<KIND, NB>::SMEM_BYTES;
  static bool ready = false;  // the block's shared memory is above the 48 KB default
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(scaled_mm_nn_wgmma_kernel<KIND, NB, OutT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  scaled_mm_nn_wgmma_kernel<KIND, NB, OutT>
      <<<grid, NT, smem, s>>>(ta, tb, static_cast<OutT*>(out), M, N, K, whole, splits, work, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int NB>
int launch_nn_out(int out_kind, const CUtensorMap& ta, const CUtensorMap& tb, void* out, int M,
                  int N, int K, int whole, int splits, const NnWork& work, const Epilogue& ep,
                  int grid, cudaStream_t s) {
  if (out_kind == sdnq::F32)
    return launch_nn<KIND, NB, float>(ta, tb, out, M, N, K, whole, splits, work, ep, grid, s);
  if (out_kind == sdnq::BF16)
    return launch_nn<KIND, NB, __nv_bfloat16>(ta, tb, out, M, N, K, whole, splits, work, ep, grid,
                                              s);
  if (out_kind == sdnq::F16)
    return launch_nn<KIND, NB, __half>(ta, tb, out, M, N, K, whole, splits, work, ep, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// in_kind 0 int8 / 1 bf16 / 2 fp8 e4m3; out (M, N) of out_kind; epilogue
// pointers may be null (rs needs vz0, zp needs vz1), all f32.  Rows lda and
// ldb elements apart (multiples of 16 bytes, base addresses 16-byte
// aligned).
// nt (b_nn 0): a (M, K) and b (N, K); `splits` 1, but for an int8 K >=
// 2^17 each tile's parts (each at most LONG_PART_STAGES stages of 128),
// with `counters` (a tile each, zero) and `slabs` (parts x tiles x 128 x
// 128 nb int32, nb as `wide_tiles` says; the wrapper sizes them for nb 2).
// nn (b_nn 1, 8-bit kinds): a (M, K) and b (K, N); the wrapper's plan
// (scaled_mm.py `nn_plan`): tiles 128 x 128 nb (int8 nb 1 or 2, e4m3 1),
// the first `whole` whole, the contraction of the other `tail` split
// `splits` ways (at most its stages of 128), and where they are split
// `counters`: tail int32 counters, zero (each call leaves them so), and
// `slabs`: splits x tail x 128 x 128 nb partial sums of 4 bytes; an int8 K
// >= 2^17 splits every tile (whole 0) into parts of at most
// LONG_PART_STAGES stages.
extern "C" int sdnq_scaled_mm(const void* a, int lda, const void* b, int ldb, void* out,
                              const void* xs, const void* ws, const void* bias, const void* rs,
                              const void* zp, const void* vz0, const void* vz1, int M, int N,
                              int K, int in_kind, int out_kind, int b_nn, int nb, int whole,
                              int splits, void* counters, void* slabs, void* stream) {
  if (in_kind != KIND_S8 && in_kind != KIND_BF16 && in_kind != KIND_E4M3) return static_cast<int>(cudaErrorInvalidValue);
  if ((rs && !vz0) || (zp && !vz1) || M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = in_kind == KIND_BF16 ? 2 : 1;
  const Epilogue ep{static_cast<const float*>(xs),  static_cast<const float*>(ws),
                    static_cast<const float*>(bias), static_cast<const float*>(rs),
                    static_cast<const float*>(zp),  static_cast<const float*>(vz0),
                    static_cast<const float*>(vz1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (K < 1 || lda < K || ldb < (b_nn ? N : K) || (lda * esize) % 16 != 0 ||
      (ldb * esize) % 16 != 0 || misaligned(a) || misaligned(b) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // an int8 contraction of 2^17 rows or more: every tile in parts of at most
  // LONG_PART_STAGES stages (nn: its splits), with their workspace
  const bool long_k = in_kind == KIND_S8 && K >= LONG_K;
  const int nk128 = (K + 127) / 128;
  if (long_k && ((nk128 + splits - 1) / splits > LONG_PART_STAGES || (b_nn && whole != 0) ||
                 !(counters && slabs)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!b_nn && !long_k && splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long mt = (M + BM - 1) / BM;
  const CUtensorMapDataType type =
      in_kind == KIND_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap ta, tb;
  if (b_nn) {
    const int nk = (K + 127) / 128;
    const long long tiles = mt * ((N + 128 * nb - 1) / (128 * nb));
    if (in_kind == KIND_BF16 || (nb != 1 && nb != 2) || (in_kind == KIND_E4M3 && nb != 1) ||
        splits < 1 || splits > nk || whole < 0 || whole > tiles ||
        (splits > 1 && whole < tiles && !(counters && slabs)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0 || N == 0) return 0;
    const long long units = whole + (tiles - whole) * splits;
    const NnWork work{static_cast<int*>(counters), slabs};
    const int grid = static_cast<int>(units < sms ? units : sms);  // one block an SM
    // A: boxes of 128 rows x 128 bytes of K; B (K rows of N): 128 x 128
    if (!tensor_map(&ta, a, M, K, lda, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128) ||
        !tensor_map(&tb, b, K, N, ldb, 128, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128))
      return static_cast<int>(cudaErrorInvalidValue);
    if (in_kind == KIND_E4M3)
      return launch_nn_out<KIND_E4M3, 1>(out_kind, ta, tb, out, M, N, K, whole, splits, work, ep,
                                         grid, s);
    return nb == 2 ? launch_nn_out<KIND_S8, 2>(out_kind, ta, tb, out, M, N, K, whole, splits, work,
                                               ep, grid, s)
                   : launch_nn_out<KIND_S8, 1>(out_kind, ta, tb, out, M, N, K, whole, splits, work,
                                               ep, grid, s);
  }
  if (M == 0 || N == 0) return 0;
  const int nbt = in_kind != KIND_E4M3 && wide_tiles(mt, N, sms) ? 2 : 1;
  const long long tiles = mt * ((N + 128 * nbt - 1) / (128 * nbt));
  const long long units = tiles * splits;  // nt: `splits` parts a tile (1 below 2^17)
  const int grid = static_cast<int>(units < sms ? units : sms);  // one block an SM
  const int box_k = 128 / esize;
  if (!tensor_map(&ta, a, M, K, lda, BM, type, esize, box_k) ||
      !tensor_map(&tb, b, N, K, ldb, 128 * nbt, type, esize, box_k))
    return static_cast<int>(cudaErrorInvalidValue);
  const NnWork work{static_cast<int*>(counters), slabs};
  if (in_kind == KIND_S8)
    return launch_nt_kind<KIND_S8>(nbt, out_kind, ta, tb, out, M, N, K, splits, work, ep, grid, s);
  if (in_kind == KIND_E4M3)
    return launch_nt_kind<KIND_E4M3>(nbt, out_kind, ta, tb, out, M, N, K, 1, work, ep, grid, s);
  return launch_nt_kind<KIND_BF16>(nbt, out_kind, ta, tb, out, M, N, K, 1, work, ep, grid, s);
}
