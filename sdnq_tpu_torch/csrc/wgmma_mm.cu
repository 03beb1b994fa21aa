// The GEMM half of B2's tiles, B5 and B7: out = x @ W'ᵀ on Hopper's tensor
// cores, W' the weight that csrc/decode_weight.cu writes once a call in x's
// 16-bit type (bf16 or fp16: the wgmma of either, fp32 sums), with one of
// four epilogues:
//
//   EPI_BIAS  out[m, o] = acc[m, o] (+ bias[o])                 B2 grouped, bit-plane
//   EPI_ROW   out[m, o] = acc * scale[o] (+ xsum[m] * zp[o]) (+ bias[o])   B2 row mode
//   EPI_FOLD  acc = sum_g acc_g: at each group's end
//             acc = acc + part_g * scale[o, g];  acc = acc + xsum[m, g] * zpc[o, g]
//             then out = acc (+ bias[o])                         B5's group-dot algebra
//   B7 (wgmma_i8_fold_kernel): x and W' int8, part_g the int32 product,
//             folded as EPI_FOLD with float(part_g), then out = acc * xs[m] (+ bias[o])
//
// part_g is the product of group g alone (a register accumulator of its
// own that each group starts afresh, wgmma's scale-d = 0): fp32 for bf16
// operands, an exact int32 for B7's.  Every epilogue operation rounds once
// (__fmul_rn / __fadd_rn), in the order of the plain versions, so B7 equals
// its plain version bit for bit.
//
// Replaces the tensor-core half of sdnq_tpu/kernels/dequant_mm.py
// `_dequant_mm_kernel` (:60, wrapper :245), `_groupdot_kernel` (:355,
// wrapper :471) and `_groupdot_i8_kernel` (:741, wrapper :808).  At the
// FLUX.1-dev shapes (M 4096-4608, K 3072-15360) the product is bound by
// tensor-core operations (2 M N K; bf16, or int8 at twice the rate), so
// the design is Hopper's: x and W' tiles arrive by TMA (128-byte swizzle, a
// stage row of 128 bytes: 64 bf16 or 128 int8 values; the zero fill takes
// the M, N and K tails) in a ring of stages guarded by mbarriers; one
// producer warp issues the loads; two consumer warpgroups each run wgmma
// (both operands in shared memory, K-major) on 64 rows of the tile: 128 x
// 256 with m64n256k16 for the bias and row epilogues (128 x 128 where that
// fills the card in fewer rounds), 128 x 128 with m64n128k16 for the fold
// and m64n128k32 s8 for B7, whose group products take the registers.  One
// wgmma group stays in flight while the next stage is issued.  B5's groups
// of whole stages alternate two products, so a group is folded on the CUDA
// cores while the next one's wgmmas run; its groups that end inside a
// stage, and all of B7's, wait for their wgmmas.  The fold's terms are
// copied to shared memory two groups ahead, from group-major arrays: one
// coalesced row a group (read column by column from (N, G), they slowed
// the fold at K 15360).  The blocks persist, one an SM, walking tiles with
// M fastest so that x stays in L2 and the producer fills the next tile's
// stages while the consumers store the last one.
//
// The barriers, TMA loads, descriptors, wgmma wrappers, the producer's loop
// and the tile store are csrc/hopper.cuh's, shared with B4
// (csrc/scaled_mm.cu); a barrier wait that lasts over 2^36 cycles traps.
#include "hopper.cuh"

namespace {

using namespace sdnq;

constexpr int BM = GEMM_BM, BK = 64;
constexpr int NT = 384;  // two consumer warpgroups, then the producer's

// EPI_FOLD takes groups that are multiples of the stage (64), EPI_FOLD_FINE
// any multiple of 16 (a group may end inside a stage)
enum { EPI_BIAS = 0, EPI_ROW = 1, EPI_FOLD = 2, EPI_FOLD_FINE = 3 };

struct Epi {
  const float* bias;   // (N,) or null
  const float* scale;  // ROW: (N,); FOLD: (G, N)
  const float* zp;     // ROW: (N,) or null; FOLD: zpc (G, N)
  const float* xsum;   // ROW: (M,) (with zp); FOLD: (G, M)
  int g;               // FOLD: the group size
};

// The group fold's terms: each group's scale and zero-point terms of a
// tile's 128 columns and xsum of a warpgroup's 64 rows, copied to shared
// memory (three buffers of 320 floats a warpgroup) two groups ahead, so
// that the copies overlap two groups' wgmmas and folds.
struct FoldTerms {
  float* buf;  // the warpgroup's three buffers
  const float *scale, *zpc, *xsum;  // (G, N), (G, N), (G, M)
  int g, t, wg, m0, n0, M, N, K;
  __device__ __forceinline__ void load(int gi) const {
    float* d = buf + (gi % 3) * 320;
    const int col = n0 + t, row = m0 + wg * 64 + t;
    sdnq::cp_async4(d + t, scale + (size_t)gi * N + (col < N ? col : 0), col < N);
    sdnq::cp_async4(d + 128 + t, zpc + (size_t)gi * N + (col < N ? col : 0), col < N);
    if (t < 64) sdnq::cp_async4(d + 256 + t, xsum + (size_t)gi * M + (row < M ? row : 0), row < M);
    sdnq::cp_async_commit();
  }
  // a tile's first two groups; every thread of the warpgroup is done with
  // the last tile's buffers
  __device__ __forceinline__ void start() const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    load(0);
    if (g < K) load(1);
  }
  // group gi's terms, once every thread of the warpgroup has them (the
  // copy of group gi + 1 may still be in flight); group gi + 2's copy
  // starts into the buffer of group gi - 1, which every thread is done with
  __device__ __forceinline__ const float* get(int gi) const {
    if ((gi + 1) * g < K)
      sdnq::cp_async_wait<1>();
    else
      sdnq::cp_async_wait<0>();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((gi + 2) * g < K) load(gi + 2);
    return buf + (gi % 3) * 320;
  }
};

// bf16 or fp16 operands: the wgmma of that type (the same shapes,
// descriptors and accumulator layout)
template <typename AT>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<AT, __half>::value)
    wgmma128_f16(d, da, db, scale_d);
  else
    wgmma128(d, da, db, scale_d);
}
template <typename AT>
__device__ __forceinline__ void mma256(float (&d)[128], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<AT, __half>::value)
    wgmma256_f16(d, da, db);
  else
    wgmma256(d, da, db);
}

// Tiles of 128 x 128 NB: the bias and row epilogues keep one fp32
// accumulator and take NB = 2 (128 registers a thread) unless the grid
// fills the card better with NB = 1; the fold keeps two or three products
// and takes NB = 1.  A stage holds BM x 64 of x and BN x 64 of W'.
template <int NB_>
struct Tile {
  static constexpr int NB = NB_;  // n128 halves
  static constexpr int BN = 128 * NB;
  static constexpr int ST = NB == 2 ? 4 : 6;  // stages
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  // + barriers, the fold's terms (two warpgroups x three buffers), alignment
  static constexpr int SMEM_BYTES = ST * STAGE_BYTES + 2 * ST * 8 + (NB == 1 ? 6 * 320 * 4 : 0) + 1024;
};

// A persistent kernel: block b takes output tiles b, b + gridDim.x, ..,
// numbered with the M tile fastest (the blocks that run together share W'
// tiles, and x stays in L2).  The producer runs on into the next tile's
// stages while the consumers store the last one.
template <int EPI, int NB_, typename AT, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    wgmma_mm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    OutT* __restrict__ out, int M, int N, int K, Epi e) {
  using T = Tile<NB_>;
  constexpr int NB = T::NB, BN = T::BN, ST = T::ST;
  constexpr int A_BYTES = T::A_BYTES, STAGE_BYTES = T::STAGE_BYTES;
  constexpr bool FOLD = EPI == EPI_FOLD || EPI == EPI_FOLD_FINE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the first 1024-byte boundary (an offset from smem_raw, so that the
  // compiler keeps the shared address space: shared loads, not generic)
  uint8_t* smem = smem_raw + ((1024u - (sdnq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * STAGE_BYTES);
  uint64_t* empty = full + ST;
  const int mt = (M + BM - 1) / BM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const int nk = (K + BK - 1) / BK;
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
      produce<ST, STAGE_BYTES, A_BYTES, BK, BN>(&tx, &tw, smem, full, empty, mt, tiles, nk);
  } else {  // consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, wr = (threadIdx.x & 127) >> 5, t = threadIdx.x & 127;
    const int cq = 2 * (lane & 3);  // this thread's columns 128 h + 8 j + cq + {0, 1}
    float acc[NB * 64];             // columns 128 h + .. in acc[64 h ..]
    float part[64], part2[64];      // EPI_FOLD*: the groups' products
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    int pending = -1;  // the stage whose wgmmas may still be in flight
    int it = 0;        // stages consumed so far
    // EPI_FOLD*: the fold's terms, a group ahead
    FoldTerms terms{reinterpret_cast<float*>(smem + ST * STAGE_BYTES + 2 * ST * 8) + wg * 960,
                    e.scale, e.zp, e.xsum, e.g, t, wg, 0, 0, M, N, K};
    if constexpr (FOLD) {
      // warpgroup 1 starts once warpgroup 0 has issued its first stage, so
      // that the two fold at different times
      if (wg == 1) asm volatile("bar.sync 3, 256;\n" ::: "memory");
    }

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
      const int r0 = m0 + wg * 64 + wr * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
#pragma unroll
      for (int i = 0; i < NB * 64; ++i) acc[i] = 0.f;
      terms.m0 = m0;
      terms.n0 = n0;
      // acc = acc + q * scale; acc = acc + xsum * zpc, for group gi's
      // product q, whose wgmmas have completed
      auto fold_into = [&](float(&q)[64], int gi) {
        const float* d = terms.get(gi);
        fence_regs(q);
        const float x0 = d[256 + wr * 16 + (lane >> 2)], x1 = d[256 + wr * 16 + (lane >> 2) + 8];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(d + 8 * j + cq);
          const float2 zc = *reinterpret_cast<const float2*>(d + 128 + 8 * j + cq);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 4 * j + 2 * h + c;
              float a = acc[i];
              a = __fadd_rn(a, __fmul_rn(q[i], c ? sc.y : sc.x));
              a = __fadd_rn(a, __fmul_rn(h ? x1 : x0, c ? zc.y : zc.x));
              acc[i] = a;
            }
        }
        fence_regs(q);
      };
      if constexpr (FOLD) terms.start();

      if constexpr (EPI == EPI_FOLD) {
        // Groups of whole stages: two products in turn, so that a group is
        // folded while the next one's wgmmas run (no wait for all).
        const int kpg = e.g / BK, G = K / e.g;
        auto group = [&](float(&p)[64], float(&q)[64], int gi) {
          for (int j = 0; j < kpg; ++j, ++it) {
            const int s = it % ST;
            const unsigned ph = (it / ST) & 1;
            mbar_wait(&full[s], ph);
            const uint64_t da = sw128_desc(smem + s * STAGE_BYTES + wg * 64 * 128);
            const uint64_t db = sw128_desc(smem + s * STAGE_BYTES + A_BYTES);
            fence_regs(p);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const int step = j * (BK / 16) + kk;  // k16 steps into the group
              mma128<AT>(p, da + 2 * kk, db + 2 * kk, step != 0);  // a group starts afresh
            }
            wgmma_commit();
            if (wg == 0 && it == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
            wgmma_wait<1>();  // the stage before (and the group before) are done
            if (pending >= 0) release(pending);
            pending = s;
            if (j == 0 && gi > 0) fold_into(q, gi - 1);
          }
        };
        for (int gi = 0; gi < G; gi += 2) {
          group(part, part2, gi);
          if (gi + 1 < G) group(part2, part, gi + 1);
        }
        wgmma_wait<0>();
        if ((G - 1) & 1)
          fold_into(part2, G - 1);
        else
          fold_into(part, G - 1);
      } else {
        // the group that ends at k = kfold (EPI_FOLD_FINE: inside a stage or
        // at its end), folded once every wgmma issued so far has completed
        auto fold = [&](int kfold) {
          wgmma_wait<0>();
          if (pending >= 0) {
            release(pending);
            pending = -1;
          }
          fold_into(part, kfold / e.g - 1);
        };
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % ST;
          const unsigned ph = (it / ST) & 1;
          mbar_wait(&full[s], ph);
          const uint64_t da = sw128_desc(smem + s * STAGE_BYTES + wg * 64 * 128);
          const uint64_t db = sw128_desc(smem + s * STAGE_BYTES + A_BYTES);
          if constexpr (FOLD)
            fence_regs(part);
          else
            fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            if constexpr (!FOLD) {
              if constexpr (NB == 2)
                mma256<AT>(acc, da + 2 * kk, db + 2 * kk);
              else
                mma128<AT>(acc, da + 2 * kk, db + 2 * kk, 1);
            } else {  // past K the tiles are zero-filled: those steps add 0
              const int kg = kb * BK + kk * 16;
              mma128<AT>(part, da + 2 * kk, db + 2 * kk, kg % e.g != 0);  // a group starts afresh
              if (kk + 1 < BK / 16 && kg + 16 <= K && (kg + 16) % e.g == 0) {
                wgmma_commit();
                fold(kg + 16);
                wgmma_fence();
              }
            }
          }
          wgmma_commit();
          bool drained = false;
          if constexpr (FOLD) {
            if (wg == 0 && it == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
            const int kfold = (kb + 1) * BK;  // the k after this stage
            if (kfold <= K && kfold % e.g == 0) {
              fold(kfold);
              drained = true;
            }
          }
          if (drained) {  // every wgmma on stage s has completed
            release(s);
          } else {
            wgmma_wait<1>();  // those of the stage before have
            if (pending >= 0) release(pending);
            pending = s;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (pending >= 0) {  // the producer fills it for the next tile meanwhile
        release(pending);
        pending = -1;
      }

      store_tile<NB>(
          acc, out, r0, n0, cq, M, N,
          [&](int row) { return EPI == EPI_ROW && e.zp ? e.xsum[row] : 0.f; },
          [&](float a, float xs, int col) {
            if constexpr (EPI == EPI_ROW) {
              a = __fmul_rn(a, e.scale[col]);
              if (e.zp) a = __fadd_rn(a, __fmul_rn(xs, e.zp[col]));
            }
            if (e.bias) a = __fadd_rn(a, e.bias[col]);
            return a;
          });
    }
  }
}

// ---- B7: int8 x int8 with the group fold ---------------------------------
// A stage holds BM x 128 int8 codes of x and 128 x 128 of W' (128-byte
// rows, as the bf16 tiles' 64 values).  The tiles are 128 x 128: a group's
// int32 product and the fp32 sum of 128 x 256 would take 256 registers a
// thread.
constexpr int BKI = 128;  // codes of a stage row
struct I8Tile {
  static constexpr int BN = 128, ST = 6;
  static constexpr int A_BYTES = BM * BKI;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BKI;
  static constexpr int SMEM_BYTES = ST * STAGE_BYTES + 2 * ST * 8 + 6 * 320 * 4 + 1024;
};

// acc = acc + float(q) * scale; acc = acc + xsum * zpc for one group, with
// its terms d (FoldTerms' buffer) and q's wgmmas complete.  float(q) rounds
// to nearest (exact below 2^24), as the plain version's float64 -> fp32
// cast.
__device__ __forceinline__ void fold_i8(float (&acc)[64], int (&q)[64], const float* d, int wr,
                                        int lane, int cq) {
  fence_regs(q);
  const float x0 = d[256 + wr * 16 + (lane >> 2)], x1 = d[256 + wr * 16 + (lane >> 2) + 8];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 sc = *reinterpret_cast<const float2*>(d + 8 * j + cq);
    const float2 zc = *reinterpret_cast<const float2*>(d + 128 + 8 * j + cq);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 4 * j + 2 * h + c;
        float a = acc[i];
        a = __fadd_rn(a, __fmul_rn(__int2float_rn(q[i]), c ? sc.y : sc.x));
        a = __fadd_rn(a, __fmul_rn(h ? x1 : x0, c ? zc.y : zc.x));
        acc[i] = a;
      }
  }
  fence_regs(q);
}

// The persistent kernel of B7: tiles, producer and stages as
// wgmma_mm_kernel's.  A group's k32 steps are issued in runs that end at
// the stages' ends (groups are multiples of 64 codes, so a stage holds one
// or two runs), the product started afresh (scale-d 0) at the group's
// first step; once they have completed, the group is folded.  One int32
// product and the fp32 sum take 128 registers a thread, which leaves the
// fold room.  Two products in turn, so that a group's fold overlaps the
// next group's wgmmas (as B5's fold does), measured slower on the H100, as
// did the two warpgroups taking turns at the tensor cores and releasing a
// stage before the fold.  After the last group: out = acc * xs[m] (+
// bias[n]).
template <typename OutT>
__global__ void __launch_bounds__(NT, 1)
    wgmma_i8_fold_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw, OutT* __restrict__ out, int M,
                         int N, int K, Epi e, const float* __restrict__ xs) {
  using T = I8Tile;
  constexpr int BN = T::BN, ST = T::ST, A_BYTES = T::A_BYTES, STAGE_BYTES = T::STAGE_BYTES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the first 1024-byte boundary (an offset from smem_raw, so that the
  // compiler keeps the shared address space: shared loads, not generic)
  uint8_t* smem = smem_raw + ((1024u - (sdnq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * STAGE_BYTES);
  uint64_t* empty = full + ST;
  const int mt = (M + BM - 1) / BM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const int nk = (K + BKI - 1) / BKI;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256)
      produce<ST, STAGE_BYTES, A_BYTES, BKI, BN>(&tx, &tw, smem, full, empty, mt, tiles, nk);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = threadIdx.x & 31, wr = (threadIdx.x & 127) >> 5, t = threadIdx.x & 127;
  const int cq = 2 * (lane & 3);
  float acc[64];
  int part[64];  // the group's product
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int pending = -1;  // the stage of the newest run, whose wgmmas may be in flight
  int base = 0;      // the ring index of the tile's first stage
  FoldTerms terms{reinterpret_cast<float*>(smem + ST * STAGE_BYTES + 2 * ST * 8) + wg * 960,
                  e.scale, e.zp, e.xsum, e.g, t, wg, 0, 0, M, N, K};
  const int G = K / e.g;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, base += nk) {
    const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
    const int r0 = m0 + wg * 64 + wr * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    terms.m0 = m0;
    terms.n0 = n0;
    terms.start();
    int waited = -1;  // the tile's stage whose full barrier has been waited for
    for (int gi = 0; gi < G; ++gi) {
      const int k0 = gi * e.g, k1 = k0 + e.g;
      for (int ka = k0; ka < k1;) {
        const int kb = ka / BKI, kend = min(k1, (kb + 1) * BKI);
        const int s = (base + kb) % ST;
        if (kb != waited) {
          mbar_wait(&full[s], ((base + kb) / ST) & 1);
          waited = kb;
        }
        // the run's k32 steps, straight-line (a branch between two wgmmas
        // makes the compiler fence them apart): a whole stage, or the half
        // at c0
        const int c0 = 2 * ((ka - kb * BKI) / 32);
        const uint64_t da = sw128_desc(smem + s * STAGE_BYTES + wg * 64 * BKI) + c0;
        const uint64_t db = sw128_desc(smem + s * STAGE_BYTES + A_BYTES) + c0;
        const int acc_in = ka != k0;
        fence_regs(part);
        if (kend - ka == BKI) {
          wgmma_fence();
          wgmma_s8(part, da, db, acc_in);
          wgmma_s8(part, da + 2, db + 2, 1);
          wgmma_s8(part, da + 4, db + 4, 1);
          wgmma_s8(part, da + 6, db + 6, 1);
        } else {
          wgmma_fence();
          wgmma_s8(part, da, db, acc_in);
          wgmma_s8(part, da + 2, db + 2, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // every run but this one has completed
        if (pending >= 0 && pending != s) release(pending);
        pending = s;
        ka = kend;
      }
      wgmma_wait<0>();
      fold_i8(acc, part, terms.get(gi), wr, lane, cq);
    }
    release(pending);  // the producer fills it for the next tile meanwhile
    pending = -1;

    store_tile<1>(
        acc, out, r0, n0, cq, M, N, [&](int row) { return xs[row]; },
        [&](float a, float xr, int col) {
          a = __fmul_rn(a, xr);
          if (e.bias) a = __fadd_rn(a, e.bias[col]);
          return a;
        });
  }
}

// ---- host ------------------------------------------------------------------
template <int EPI, int NB, typename AT, typename OutT>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, void* out, int M, int N, int K,
           const Epi& e, int grid, cudaStream_t st) {
  static bool ready = false;  // the block's shared memory is above the 48 KB default
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(wgmma_mm_kernel<EPI, NB, AT, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<NB>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  wgmma_mm_kernel<EPI, NB, AT, OutT><<<grid, NT, Tile<NB>::SMEM_BYTES, st>>>(
      tx, tw, static_cast<OutT*>(out), M, N, K, e);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, int NB, typename AT>
int launch_out(int out_kind, const CUtensorMap& tx, const CUtensorMap& tw, void* out, int M,
               int N, int K, const Epi& e, int grid, cudaStream_t st) {
  if (out_kind == sdnq::F32) return launch<EPI, NB, AT, float>(tx, tw, out, M, N, K, e, grid, st);
  if (out_kind == sdnq::BF16)
    return launch<EPI, NB, AT, __nv_bfloat16>(tx, tw, out, M, N, K, e, grid, st);
  if (out_kind == sdnq::F16) return launch<EPI, NB, AT, __half>(tx, tw, out, M, N, K, e, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename AT>
int launch_epi(int epi, int nb, int out_kind, const CUtensorMap& tx, const CUtensorMap& tw,
               void* out, int M, int N, int K, const Epi& e, int grid, cudaStream_t st) {
  if (epi == EPI_BIAS)
    return nb == 2 ? launch_out<EPI_BIAS, 2, AT>(out_kind, tx, tw, out, M, N, K, e, grid, st)
                   : launch_out<EPI_BIAS, 1, AT>(out_kind, tx, tw, out, M, N, K, e, grid, st);
  if (epi == EPI_ROW)
    return nb == 2 ? launch_out<EPI_ROW, 2, AT>(out_kind, tx, tw, out, M, N, K, e, grid, st)
                   : launch_out<EPI_ROW, 1, AT>(out_kind, tx, tw, out, M, N, K, e, grid, st);
  if (epi == EPI_FOLD)
    return launch_out<EPI_FOLD, 1, AT>(out_kind, tx, tw, out, M, N, K, e, grid, st);
  if (epi == EPI_FOLD_FINE)
    return launch_out<EPI_FOLD_FINE, 1, AT>(out_kind, tx, tw, out, M, N, K, e, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename OutT>
int launch_i8(const CUtensorMap& tx, const CUtensorMap& tw, void* out, int M, int N, int K,
              const Epi& e, const float* xs, int grid, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_i8_fold_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, I8Tile::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  wgmma_i8_fold_kernel<OutT><<<grid, NT, I8Tile::SMEM_BYTES, st>>>(
      tx, tw, static_cast<OutT*>(out), M, N, K, e, xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, N) of out_kind = x (M, K) @ w (N, K)ᵀ with the epilogue `epi`:
// x and w of in_kind (bf16 1 or fp16 2) with rows ldx and ldw elements
// apart (multiples of 8, base addresses 16-byte aligned); epi 0: bias (N,)
// f32 or null; epi 1: scale (N,), zp (N,) or null, xsum (M,) (with zp),
// bias; epi 2: scale and zpc (G, N), xsum (G, M), bias, groups of g (a
// multiple of 16 dividing K).
extern "C" int sdnq_wgmma_mm(const void* x, int ldx, const void* w, int ldw, void* out, int M,
                             int N, int K, int epi, const void* bias, const void* scale,
                             const void* zp, const void* xsum, int g, int in_kind, int out_kind,
                             void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 0 || N < 0 || K < 1 || ldx < K || ldw < K || ldx % 8 != 0 || ldw % 8 != 0 ||
      misaligned(x) || misaligned(w) || (in_kind != sdnq::BF16 && in_kind != sdnq::F16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (epi == EPI_ROW && (!scale || (zp && !xsum))) return static_cast<int>(cudaErrorInvalidValue);
  if (epi == EPI_FOLD && (!scale || !zp || !xsum || g < 16 || g % 16 != 0 || K % g != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (epi == EPI_FOLD && g % BK != 0) epi = EPI_FOLD_FINE;
  if (M == 0 || N == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the bias and row epilogues take 128 x 256 tiles where wide_tiles says
  // (hopper.cuh), the folds 128 x 128
  const long long mt = (M + BM - 1) / BM;
  const int nb = (epi == EPI_BIAS || epi == EPI_ROW) && wide_tiles(mt, N, sms) ? 2 : 1;
  const long long tiles = mt * ((N + 128 * nb - 1) / (128 * nb));
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // one block an SM
  const bool f16 = in_kind == sdnq::F16;
  const CUtensorMapDataType type =
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, M, K, ldx, BM, type) || !tensor_map(&tw, w, N, K, ldw, 128 * nb, type))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epi e{static_cast<const float*>(bias), static_cast<const float*>(scale),
              static_cast<const float*>(zp), static_cast<const float*>(xsum), g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f16 ? launch_epi<__half>(epi, nb, out_kind, tx, tw, out, M, N, K, e, grid, st)
             : launch_epi<__nv_bfloat16>(epi, nb, out_kind, tx, tw, out, M, N, K, e, grid, st);
}

// B7: out (M, N) of out_kind from int8 codes x (M, K) and w (N, K), rows
// ldx and ldw bytes apart (multiples of 16, base addresses 16-byte
// aligned): groups of g codes (a multiple of 64 dividing K), each group's
// int32 product P folded as acc = acc + float(P) * scale[g, n]; acc = acc +
// xsum[g, m] * zpc[g, n]; then out = acc * xs[m] (+ bias[n]).  scale, zpc
// (G, N), xsum (G, M), xs (M,), bias (N,) or null, all f32.
extern "C" int sdnq_wgmma_i8_mm(const void* x, int ldx, const void* w, int ldw, void* out, int M,
                                int N, int K, const void* bias, const void* scale, const void* zpc,
                                const void* xsum, const void* xs, int g, int out_kind,
                                void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 0 || N < 0 || K < 1 || ldx < K || ldw < K || ldx % 16 != 0 || ldw % 16 != 0 ||
      misaligned(x) || misaligned(w) || !scale || !zpc || !xsum || !xs || g < 64 || g % 64 != 0 ||
      K % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + I8Tile::BN - 1) / I8Tile::BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, M, K, ldx, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, BKI) ||
      !tensor_map(&tw, w, N, K, ldw, I8Tile::BN, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, BKI))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epi e{static_cast<const float*>(bias), static_cast<const float*>(scale),
              static_cast<const float*>(zpc), static_cast<const float*>(xsum), g};
  const float* xsc = static_cast<const float*>(xs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == sdnq::F32) return launch_i8<float>(tx, tw, out, M, N, K, e, xsc, grid, st);
  if (out_kind == sdnq::BF16)
    return launch_i8<__nv_bfloat16>(tx, tw, out, M, N, K, e, xsc, grid, st);
  if (out_kind == sdnq::F16) return launch_i8<__half>(tx, tw, out, M, N, K, e, xsc, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
