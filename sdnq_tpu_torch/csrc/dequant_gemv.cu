// B2: weight-only GEMV for few rows, 8-bit codes, rowwise or grouped scales.
//
//   row mode: y[m, o] = (sum_k x[m, k] * c[o, k]) * scale[o]
//                       (+ rowsum(x)[m] * zp[o]) (+ bias[o])
//   grouped:  y[m, o] = sum_k x[m, k] * XT(c[o, k] * scale[o, k / g]
//                                          (+ zp[o, k / g]))  (+ bias[o])
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_dequant_mm_kernel` (:60) at few
// rows in its unpacked modes: the rowwise `row_epi` (:114-128, epilogue
// :153-162), where rowwise scales commute with the K sum, so the codes enter
// the dot as plain numbers and scale / zero point / bias apply once per
// output; and the grouped mode (:129-142), where each scaled weight is first
// ROUNDED TO x's DTYPE XT (the TPU kernel's decode scratch has x's dtype,
// :325) and x multiplies the rounded weight; code * scale + zp is one fused
// multiply-add, as XLA computes it.  Codes are int8, uint8
// (widened before the scale, as :133-135), float8 e4m3 or e5m2.  The layers below
// the 32-row cut-off take it: at batch 1 the FLUX modulation linears and the
// time / vector / guidance MLPs, M = 1 (grouped under the default int8
// recipe, K 3072 in 3 groups of 1024), and every linear of a Llama decode
// step (M = the batch).
//
// At M <= 32 the product is a GEMV, bound by the bytes of the weight (O*K:
// 56.6 MB for FLUX.1-dev's 3072 -> 18432 modulation linear, 16.9 us at 3.35
// TB/s).  bf16 and fp16 x take the tensor cores (dequant_gemv_mma_kernel,
// below): on the CUDA cores x times the codes costs some 11 instructions a
// code at Llama-3-8B's M 4, more than the bytes allow.  fp32 x (the FLUX
// modulation linears' vec) stays on the CUDA cores, as a stream of those
// bytes:
//  - a producer warp copies the weight into a ring of four 16 KB stages of
//    shared memory by the TMA unit (cp.async.bulk, one copy a row and K
//    chunk, mbarriers full and empty a stage), so that up to 64 KB a block
//    are in flight whatever the registers of the eight consumer warps;
//  - a consumer warp owns one output row (or a K slice of one, below) of a
//    stage and takes 512 codes at a time, a lane four runs of 4 codes 128
//    apart, so that the lanes' reads of the codes and of x in shared memory
//    are neighbours (no bank conflicts: runs of 16 codes a lane, 64 bytes of
//    fp32 x apart, cost four times the shared-memory wavefronts);
//  - x is staged once a block for the whole K where M * K fits XS_MAX,
//    while the first stages load, else read through the L1 cache;
//  - int8 and uint8 codes decode through the fp32 magic number 2^23 (a byte
//    permute and one exact subtraction), e4m3 and e5m2 by the fp8x2 ->
//    f16x2 conversion; every value exact;
//  - grouped: each run of 4 codes lies in one group (8 | g), whose scale and
//    zero point are read once (each weight fp32, x's dtype);
//  - the blocks persist, as many as fit on the card, and walk units of 8 / S
//    rows.  Where a layer has too few rows to give every SM two units
//    (Llama-3-8B's 4096 -> 1024 k and v projections), the S warps of a row
//    split its K and their sums meet in shared memory, added in a fixed
//    order.
// The lanes' fp32 sums are reduced across the warp at the end of a row.  K
// is a multiple of 16 (the wrapper zero-pads the codes and x; a grouped
// weight's pad takes its last group's scale, times x's zeros).
#include <cuda_fp8.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8, NT = WARPS * 32 + 32;  // consumer warps, then the producer warp
constexpr int ST = 4, STAGE_BYTES = 16 * 1024;  // the weight's ring
constexpr int XS_MAX = 128 * 1024;              // bytes of x staged in shared memory
constexpr int RED_BYTES = WARPS * 2 * 32 * 4;   // the K split's partial sums
constexpr int HEAD = ST * STAGE_BYTES + RED_BYTES + 2 * ST * 8;  // ring, sums, barriers

enum { I8 = 0, U8 = 1, E4M3 = 2, E5M2 = 3 };  // code kinds

struct GemvArgs {
  const void* x;        // (M, K) of XT
  const uint8_t* w;     // (O, K) codes
  const float* scale;   // (O,) or (O, G)
  const float* zp;      // the same, or null
  const float* bias;    // (O,) or null
  void* out;            // (M, O) of out_kind
  int M, K, O, G, g;
  unsigned ginv;        // floor((2^32 - 1) / g), for sdnq::div_magic
  int kind, out_kind;
  int S, KC, nc;        // warps a row (K split), codes a stage row, stages a row
  int stage;            // x is copied into shared memory
};

// 4 codes (a 32-bit word) as their values; integer codes as bytes b ^ flip
// less off (int8: flip 0x80, off 2^23 + 128; uint8: 0, 2^23): the fp32
// bits 0x4B0000bb are 2^23 + b, and the subtraction is exact; fp8 codes
// as e4m3, or as e5m2 where `e5m2` (one choice for a whole call)
template <bool FP8>
__device__ __forceinline__ void decode4(unsigned u, unsigned flip, float off, float (&w)[4],
                                        bool e5m2) {
  if constexpr (FP8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((u >> (16 * h)) & 0xFFFFu),
          e5m2 ? __NV_E5M2 : __NV_E4M3);
      const float2 f = __half22float2(__half2(r));
      w[2 * h] = f.x;
      w[2 * h + 1] = f.y;
    }
  } else {
    const unsigned b = u ^ flip;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | e)), off);
  }
}

// 4 consecutive fp32 x values from p (aligned to 4 of them)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void store_out(void* out, int kind, size_t i, float v) {
  if (kind == sdnq::F32)
    static_cast<float*>(out)[i] = v;
  else if (kind == sdnq::BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(v);
}

// the consumer warps' named barrier (barrier 1, their 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int MT, bool FP8, bool GROUPED>
__global__ void __launch_bounds__(NT) dequant_gemv_kernel(const GemvArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem + ST * STAGE_BYTES);  // [warp][acc, xsum][m]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * STAGE_BYTES + RED_BYTES);
  uint64_t* empty = full + ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = a.M, K = a.K, O = a.O;
  const int S = a.S, rows = WARPS / S;  // rows a unit
  const int KC = a.KC, nc = a.nc;       // codes a stage row, stages a unit
  const int units = (O + rows - 1) / rows;
  // the block's stages: unit blockIdx.x + (st / nc) grid strides on, K chunk st % nc
  const int nsteps =
      (units - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
      static_cast<int>(gridDim.x) * nc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sdnq::mbar_init(&full[s], 1);
      sdnq::mbar_init(&empty[s], WARPS);  // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer warp: lane 0 copies each stage's rows
    if (lane != 0) return;
    for (int st = 0; st < nsteps; ++st) {
      const int s = st % ST;
      const unsigned ph = ((st / ST) & 1) ^ 1;  // the first round passes at once
      sdnq::mbar_wait(&empty[s], ph);
      if (st >= ST) sdnq::mbar_wait(&full[s], ph);  // and its last copy has landed
      const int o0 = (blockIdx.x + (st / nc) * gridDim.x) * rows, k0 = (st % nc) * KC;
      const int nr = min(rows, O - o0), len = min(KC, K - k0);
      sdnq::mbar_expect_tx(&full[s], static_cast<unsigned>(nr * len));
      for (int r = 0; r < nr; ++r)
        sdnq::bulk_load(smem + s * STAGE_BYTES + r * KC, a.w + (size_t)(o0 + r) * K + k0, len, &full[s]);
    }
    return;
  }

  const float* xp = static_cast<const float*>(a.x);
  if (a.stage) {  // 16-byte pieces, while the first stages load
    float* xs = reinterpret_cast<float*>(smem + HEAD);
    const int n = M * K * 4 / 16;
    for (int i = threadIdx.x; i < n; i += WARPS * 32)
      reinterpret_cast<uint4*>(xs)[i] = reinterpret_cast<const uint4*>(xp)[i];
    xp = xs;
    consumers_sync();
  }
  const int slot = warp / S, part = warp % S;  // this warp's row of a unit, and K slice
  const bool xsum_on = !GROUPED && a.zp, e5m2 = a.kind == E5M2;
  const unsigned flip = a.kind == I8 ? 0x80808080u : 0u;
  const float off = a.kind == I8 ? 8388736.f : 8388608.f;

  float acc[MT], xsm[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = xsm[m] = 0.f;
  for (int st = 0; st < nsteps; ++st) {
    const int s = st % ST, c = st % nc;
    const int o = (blockIdx.x + (st / nc) * gridDim.x) * rows + slot;
    const int kc = c * KC, len = min(KC, K - kc);
    sdnq::mbar_wait(&full[s], (st / ST) & 1);
    if (o < O) {
      const uint8_t* row = smem + s * STAGE_BYTES + slot * KC;
      // a warp takes 512 codes at a time, a lane four runs of 4 (128 apart),
      // so that the lanes' reads of the stage and of x are neighbours
#pragma unroll 2
      for (int j0 = part * 512 + lane * 4; j0 < len; j0 += S * 512) {
        unsigned cw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cw[q] = j0 + 128 * q < len ? *reinterpret_cast<const unsigned*>(row + j0 + 128 * q) : 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k0 = kc + j0 + 128 * q;  // codes k0 .. k0 + 3
          if (j0 + 128 * q >= len) continue;
          float w[4];
          decode4<FP8>(cw[q], flip, off, w, e5m2);
          if constexpr (GROUPED) {
            // the run lies in one group (the pad past g G in the last): its
            // scale and zero point (each weight in x's fp32)
            const size_t gi = (size_t)o * a.G + min(sdnq::div_magic(k0, a.g, a.ginv), a.G - 1);
            const float sc = __ldg(a.scale + gi);
            const float z = a.zp ? __ldg(a.zp + gi) : 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = a.zp ? __fmaf_rn(w[e], sc, z) : __fmul_rn(w[e], sc);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < M) {
              float xv[4];
              load4(xp + (size_t)m * K + k0, xv);
              acc[m] = fmaf(xv[3], w[3], fmaf(xv[2], w[2], fmaf(xv[1], w[1], fmaf(xv[0], w[0], acc[m]))));
              if (xsum_on) xsm[m] += (xv[0] + xv[1]) + (xv[2] + xv[3]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) sdnq::mbar_arrive(&empty[s]);  // the stage's row is read

    if (c == nc - 1) {  // the unit's last stage: reduce, store
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
            if (xsum_on) xsm[m] += __shfl_xor_sync(0xffffffffu, xsm[m], off);
          }
        }
      }
      if (S > 1) {  // the row's S slices meet in shared memory, in slice order
        if (lane == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (m < M) red[warp * 64 + m] = acc[m], red[warp * 64 + 32 + m] = xsm[m];
        }
        consumers_sync();
        if (part == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < M) {
              acc[m] = red[warp * 64 + m];
              xsm[m] = red[warp * 64 + 32 + m];
              for (int j = 1; j < S; ++j) {
                acc[m] += red[(warp + j) * 64 + m];
                xsm[m] += red[(warp + j) * 64 + 32 + m];
              }
            }
          }
        }
        consumers_sync();
      }
      if (lane == 0 && part == 0 && o < O) {
        const float sc = GROUPED ? 1.f : a.scale[o];
        const float z = xsum_on ? a.zp[o] : 0.f;
        const float bo = a.bias ? a.bias[o] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < M) {
            float v = GROUPED ? acc[m] : acc[m] * sc;
            if (xsum_on) v += xsm[m] * z;
            if (a.bias) v += bo;
            store_out(a.out, a.out_kind, (size_t)m * O + o, v);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = xsm[m] = 0.f;
    }
  }
}

template <int MT, bool FP8, bool GROUPED>
int launch(GemvArgs a, cudaStream_t st) {
  auto kern = dequant_gemv_kernel<MT, FP8, GROUPED>;
  const long long xbytes = 4LL * a.M * a.K;
  a.stage = xbytes <= XS_MAX;
  const int smem = HEAD + (a.stage ? static_cast<int>(xbytes) : 0);
  static bool big = false;  // above the 48 KB default, once
  if (!big) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, HEAD + XS_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    big = true;
  }
  static int occ_smem = -1, occ = 0;  // blocks an SM at the last size
  if (smem != occ_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    occ_smem = smem;
  }
  // split K over S warps a row until the card has two units an SM, while
  // each warp keeps at least 1024 codes of a row; a stage row is 16 KB over
  // the unit's rows
  const int sms = sdnq::sm_count();
  int S = 1;
  while (S < WARPS && (a.O + WARPS / S - 1) / (WARPS / S) < 2 * sms && a.K >= 2 * S * 1024) S *= 2;
  a.S = S;
  a.KC = STAGE_BYTES / (WARPS / S);
  a.nc = (a.K + a.KC - 1) / a.KC;
  const long long units = (a.O + WARPS / S - 1) / (WARPS / S);
  const long long cap = (long long)sms * (occ > 0 ? occ : 1);
  kern<<<static_cast<int>(units < cap ? units : cap), NT, smem, st>>>(a);
  return 0;
}

// the partial sums of MT rows of x stay in registers: 1, 4, 8 or 32
template <bool FP8, bool GROUPED>
int launch_rows(const GemvArgs& a, cudaStream_t st) {
  if (a.M == 1) return launch<1, FP8, GROUPED>(a, st);
  if (a.M <= 4) return launch<4, FP8, GROUPED>(a, st);
  if (a.M <= 8) return launch<8, FP8, GROUPED>(a, st);
  return launch<32, FP8, GROUPED>(a, st);
}

// fp32 x
int launch_x(const GemvArgs& a, cudaStream_t st) {
  const bool fp8 = a.kind == E4M3 || a.kind == E5M2, grouped = a.G > 1;
  if (fp8) return grouped ? launch_rows<true, true>(a, st) : launch_rows<true, false>(a, st);
  return grouped ? launch_rows<false, true>(a, st) : launch_rows<false, false>(a, st);
}

// bf16 / fp16 x: the tensor cores.  Each scaled weight is a bf16 / fp16
// value (the codes exactly; grouped, rounded to x's dtype, as the function
// says), so x times the weight is mma.sync m16n8k16 of the weight (A, 16
// rows) and x (B, its rows as the n columns), fp32 sums: the CUDA cores
// only decode.  A warp takes 16 rows and steps of 64 codes: lane (g, t) of
// the mma layout loads 16 codes of rows g and g + 8 (one 16-byte load each,
// a row's 64 bytes by four lanes), and k16 step s of the four takes codes
// 4 s .. 4 s + 3 of each lane's 16: the mma's k slots 2t, 2t + 1, 2t + 8,
// 2t + 9 of a lane hold its codes 16 t + 4 s + 0 .. 3, and x's B fragment
// the same four k (the sum over k is the same in any order).  The next
// step's codes load while this one's decode; S warps split a row tile's K
// where the layer has few rows, their sums meeting in shared memory in a
// fixed order.
constexpr int MW = 8, MNT = MW * 32;  // warps, threads of a block

template <typename XT>
__device__ __forceinline__ unsigned pack2(float lo, float hi);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// D += A(16x16, row) * B(16x8, col), fp32 sums, in x's 16-bit type
template <typename XT>
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value)
    sdnq::mma_bf16(d, a, b);
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float xval(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float xval(const __half* p, int i) { return __half2float(p[i]); }

// NTN n tiles of 8 rows of x (M <= 8 NTN)
template <int NTN, typename XT, bool FP8, bool GROUPED>
__global__ void __launch_bounds__(MNT) dequant_gemv_mma_kernel(const GemvArgs a) {
  __shared__ float red[MW][32][5 * NTN];  // the K split's sums: acc, then x's row sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = a.M, K = a.K, O = a.O, S = a.S;
  const int part = warp % S;
  const int o0 = (blockIdx.x * (MW / S) + warp / S) * 16;  // the warp's 16 rows
  const bool xsum_on = !GROUPED && a.zp, e5m2 = a.kind == E5M2;
  const unsigned flip = a.kind == I8 ? 0x80808080u : 0u;
  const float off = a.kind == I8 ? 8388736.f : 8388608.f;
  const XT* x = static_cast<const XT*>(a.x);
  const int ra = o0 + g, rb = o0 + g + 8;  // the lane's two rows
  const uint8_t* wa = a.w + (size_t)min(ra, O - 1) * K;
  const uint8_t* wb = a.w + (size_t)min(rb, O - 1) * K;
  const int nsteps = (K + 63) / 64;

  float acc[NTN][4], xs[NTN];
#pragma unroll
  for (int n = 0; n < NTN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = xs[n] = 0.f;
  // the codes of step j (k 64 j + 16 t ..) of both rows, zeros past K and O
  auto load = [&](int j, uint4& ca, uint4& cb) {
    const int k = 64 * j + 16 * t;
    const bool in = j < nsteps && k < K;
    ca = in && ra < O ? __ldg(reinterpret_cast<const uint4*>(wa + k)) : make_uint4(0u, 0u, 0u, 0u);
    cb = in && rb < O ? __ldg(reinterpret_cast<const uint4*>(wb + k)) : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 ca, cb, na, nb;
  load(part, ca, cb);
  for (int j = part; j < nsteps; j += S) {
    load(j + S, na, nb);  // in flight while these decode
    const unsigned wa4[4] = {ca.x, ca.y, ca.z, ca.w}, wb4[4] = {cb.x, cb.y, cb.z, cb.w};
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4) {
      const int k = 64 * j + 16 * t + 4 * s4;  // this lane's four k of step s4
      float fa[4], fb[4];
      decode4<FP8>(wa4[s4], flip, off, fa, e5m2);
      decode4<FP8>(wb4[s4], flip, off, fb, e5m2);
      if constexpr (GROUPED) {  // four codes lie in one group (a pad in the last)
        const int gi = min(sdnq::div_magic(min(k, K - 1), a.g, a.ginv), a.G - 1);
        const size_t ia = (size_t)min(ra, O - 1) * a.G + gi, ib = (size_t)min(rb, O - 1) * a.G + gi;
        const float sa = __ldg(a.scale + ia), sb = __ldg(a.scale + ib);
        const float za = a.zp ? __ldg(a.zp + ia) : 0.f, zb = a.zp ? __ldg(a.zp + ib) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fa[e] = a.zp ? __fmaf_rn(fa[e], sa, za) : __fmul_rn(fa[e], sa);
          fb[e] = a.zp ? __fmaf_rn(fb[e], sb, zb) : __fmul_rn(fb[e], sb);
        }
      }
      // slots 2t, 2t + 1 (a[0] row g, a[1] row g + 8) and 2t + 8, 2t + 9
      const unsigned af[4] = {pack2<XT>(fa[0], fa[1]), pack2<XT>(fb[0], fb[1]),
                              pack2<XT>(fa[2], fa[3]), pack2<XT>(fb[2], fb[3])};
#pragma unroll
      for (int n = 0; n < NTN; ++n) {
        const int m = 8 * n + g;
        uint2 xb = make_uint2(0u, 0u);
        if (m < M && k < K) xb = __ldg(reinterpret_cast<const uint2*>(x + (size_t)m * K + k));
        const unsigned bf[2] = {xb.x, xb.y};
        mma16<XT>(acc[n], af, bf);
        if (xsum_on) {
          const XT* xe = reinterpret_cast<const XT*>(&xb);
          xs[n] += (xval(xe, 0) + xval(xe, 1)) + (xval(xe, 2) + xval(xe, 3));
        }
      }
    }
    ca = na, cb = nb;
  }
  if (xsum_on) {  // row 8 n + g's sum over this warp's k
#pragma unroll
    for (int n = 0; n < NTN; ++n) {
      xs[n] += __shfl_xor_sync(0xffffffffu, xs[n], 1);
      xs[n] += __shfl_xor_sync(0xffffffffu, xs[n], 2);
    }
  }
  if (S > 1) {  // the tile's S slices meet in shared memory, in slice order
#pragma unroll
    for (int n = 0; n < NTN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][lane][4 * n + i] = acc[n][i];
      red[warp][lane][4 * NTN + n] = xs[n];
    }
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < S; ++p) {
#pragma unroll
        for (int n = 0; n < NTN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] += red[warp + p][lane][4 * n + i];
          xs[n] += red[warp + p][lane][4 * NTN + n];
        }
      }
    }
  }
  if (part != 0) return;
  // acc[n][2 h + c]: row o0 + g + 8 h, x row 8 n + 2 t + c
#pragma unroll
  for (int n = 0; n < NTN; ++n) {
    float xm[2] = {0.f, 0.f};  // x's row sums of rows 8 n + 2 t + c (from quad 2 t + c)
    if (xsum_on) {
      xm[0] = __shfl_sync(0xffffffffu, xs[n], 8 * t);
      xm[1] = __shfl_sync(0xffffffffu, xs[n], 8 * t + 4);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + g + 8 * h;
      if (o >= O) continue;
      const float sc = GROUPED ? 1.f : a.scale[o];
      const float z = xsum_on ? a.zp[o] : 0.f;
      const float bo = a.bias ? a.bias[o] : 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = 8 * n + 2 * t + c;
        if (m >= M) continue;
        float v = GROUPED ? acc[n][2 * h + c] : acc[n][2 * h + c] * sc;
        if (xsum_on) v += xm[c] * z;
        if (a.bias) v += bo;
        store_out(a.out, a.out_kind, (size_t)m * O + o, v);
      }
    }
  }
}

template <int NTN, typename XT, bool FP8, bool GROUPED>
int launch_mma(GemvArgs a, cudaStream_t st) {
  // split K over S warps a 16-row tile until the card has three blocks an
  // SM, while each warp keeps at least 256 codes (4 steps of 64)
  const int sms = sdnq::sm_count(), tiles = (a.O + 15) / 16;
  int S = 1;
  while (S < MW && (tiles + MW / S - 1) / (MW / S) < 3 * sms && a.K >= 2 * S * 256) S *= 2;
  a.S = S;
  const int blocks = (tiles + MW / S - 1) / (MW / S);
  dequant_gemv_mma_kernel<NTN, XT, FP8, GROUPED><<<blocks, MNT, 0, st>>>(a);
  return 0;
}

template <typename XT>
int launch_x_mma(const GemvArgs& a, cudaStream_t st) {
  const bool fp8 = a.kind == E4M3 || a.kind == E5M2, grouped = a.G > 1, four = a.M > 8;
  if (fp8 && grouped) return four ? launch_mma<4, XT, true, true>(a, st) : launch_mma<1, XT, true, true>(a, st);
  if (fp8) return four ? launch_mma<4, XT, true, false>(a, st) : launch_mma<1, XT, true, false>(a, st);
  if (grouped) return four ? launch_mma<4, XT, false, true>(a, st) : launch_mma<1, XT, false, true>(a, st);
  return four ? launch_mma<4, XT, false, false>(a, st) : launch_mma<1, XT, false, false>(a, st);
}

// Bit-plane mode (B2's packed mode, sdnq_tpu/kernels/dequant_mm.py:73-113):
//
//   y[m, o] = sum_k x[m, k] * XT(v(code[o, k]) * scale[o, k / g]
//                               (+ zp[o, k / g]))  (+ bias[o])
//
// with every scaled weight rounded to x's dtype XT, rowwise (G = 1) too,
// as in the JAX kernel.  The codes lie in `bits` byte planes of S bytes a
// row: bit i of byte b of plane j is bit j of code k = i * S + b.
//
// Bound by the weight's bytes (O * bits * S) at M = 1, so the bytes move at
// full width and the decode takes a few operations a code:
// - a warp owns a row; each lane loads 4 consecutive bytes of every plane,
//   all planes' loads issued together: a warp's load of a plane is 128
//   contiguous bytes; 16 warps a block;
// - the 32 codes of a lane's 4 bytes (8 a byte, S apart) come out of two 4
//   x 4 byte transposes and an 8 x 8 bit transpose a byte position
//   (sdnq::bitplane_codes4, shared with csrc/decode_weight.cu), each value
//   out of sdnq::decode_value, and two weights round to bf16 in one cvt;
// - x is read in its natural order: the lane's codes i * S + b .. + 3 meet
//   x[m, i*S + b .. + 3], one 16-byte shared-memory load a row and
//   segment.  x is staged there as fp32 for a chunk of BB bytes of every
//   plane: the whole row where M * 32 * S bytes fit XS_BYTES (K 3072 up to
//   4 rows), staged once by blocks that persist (as many as the card
//   holds, each walking rows a grid apart); else chunks of 128 bytes a
//   multiple, two barriers each, a block for every 16 rows;
// - where S and the group are multiples of 4 (and the planes aligned to
//   them) a lane's 4 codes of a segment share one group's scale; else each
//   code looks up its own and the planes are read a byte at a time.
constexpr int BP_WARPS = 16, BP_NT = BP_WARPS * 32;
constexpr int XS_BYTES = 48 * 1024;
constexpr int XS_MAX_BYTES = 32 * 32 * 128;  // 32 rows, 8 segments, 128 bytes, fp32

template <typename XT>
__device__ __forceinline__ void round4(float (&w)[4]) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(w[0], w[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(w[2], w[3]);
    w[0] = __low2float(a);
    w[1] = __high2float(a);
    w[2] = __low2float(b);
    w[3] = __high2float(b);
  } else if constexpr (std::is_same<XT, __half>::value) {
    const __half2 a = __floats2half2_rn(w[0], w[1]);
    const __half2 b = __floats2half2_rn(w[2], w[3]);
    w[0] = __low2float(a);
    w[1] = __high2float(a);
    w[2] = __low2float(b);
    w[3] = __high2float(b);
  }
}

// One warp's row o over plane bytes c0 .. cend - 1 (the staged chunk of x
// starts at c0), 4 consecutive bytes of every plane a lane: one 4-byte load
// a plane (`aligned`) or a byte at a time.  8-byte loads of wider codes
// measured slower on an H100; 16-byte loads of 8-bit codes gained about 4%
// at M 1, less than an R1 step's spread, and were not kept.  WIDE: codes
// of more than 8 bits; FLOAT: minifloat codes.  Without a zero point z is 0
// (v * s + 0 rounds as v * s).
template <bool WIDE, bool FLOAT, int MT, typename XT>
__device__ __forceinline__ void bitplane_row(const uint8_t* __restrict__ wr, const float* __restrict__ sr,
                                             const float* __restrict__ zr, const float* __restrict__ xs,
                                             int M, int K, int S, int bits, int G, int g, unsigned ginv,
                                             const sdnq::CodeFmt& f, bool aligned, int BB, int c0,
                                             int cend, int lane, float (&acc)[MT]) {
  constexpr int NP = WIDE ? 16 : 8;  // planes
  for (int b = c0 + 4 * lane; b < cend; b += 32 * 4) {
    unsigned wv[16] = {};
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < bits) {
        const uint8_t* p = wr + (size_t)j * S + b;
        if (aligned) {
          wv[j] = __ldg(reinterpret_cast<const unsigned*>(p));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (b + q < S) wv[j] |= static_cast<unsigned>(__ldg(p + q)) << (8 * q);
        }
      }
    }
    // the scale and zero point of each segment's first code
    float s8[8], z8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gi = G == 1 ? 0 : min(sdnq::div_magic(i * S + b, g, ginv), G - 1);
      s8[i] = __ldg(sr + gi);
      z8[i] = zr ? __ldg(zr + gi) : 0.f;
    }
    uint64_t lo[4], hi[4];  // byte i of lo[q]: bits 0-7 of code i * S + b + q (8-15 in hi)
    sdnq::bitplane_codes4(wv, lo);
    if constexpr (WIDE) sdnq::bitplane_codes4(wv + 8, hi);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k0 = i * S + b;
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned code = static_cast<unsigned>(lo[q] >> (8 * i)) & 0xffu;
        if constexpr (WIDE) code |= (static_cast<unsigned>(hi[q] >> (8 * i)) & 0xffu) << 8;
        w[q] = sdnq::decode_value<FLOAT>(code, f);
      }
      if (aligned) {  // the 4 codes lie in one group (past K: x is 0 there)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = __fmaf_rn(w[q], s8[i], z8[i]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gi = G == 1 ? 0 : min(sdnq::div_magic(k0 + q, g, ginv), G - 1);
          w[q] = __fmaf_rn(w[q], __ldg(sr + gi), zr ? __ldg(zr + gi) : 0.f);
        }
      }
      round4<XT>(w);  // each scaled weight rounded to x's dtype
      const float* xi = xs + (size_t)i * BB + (b - c0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float4 xv = *reinterpret_cast<const float4*>(xi + (size_t)m * 8 * BB);
          acc[m] = fmaf(xv.x, w[0], acc[m]);
          acc[m] = fmaf(xv.y, w[1], acc[m]);
          acc[m] = fmaf(xv.z, w[2], acc[m]);
          acc[m] = fmaf(xv.w, w[3], acc[m]);
        }
      }
    }
  }
}

// bitplane_row for the code kind (FLOAT), a choice of the kernel's arguments
template <bool WIDE, int MT, typename XT>
__device__ __forceinline__ void bitplane_row_of(const uint8_t* __restrict__ wr,
                                                const float* __restrict__ sr,
                                                const float* __restrict__ zr,
                                                const float* __restrict__ xs, int M, int K, int S,
                                                int bits, int G, int g, unsigned ginv,
                                                const sdnq::CodeFmt& f, bool aligned, int BB,
                                                int c0, int cend, int lane, float (&acc)[MT]) {
  if (f.is_float)
    bitplane_row<WIDE, true, MT, XT>(wr, sr, zr, xs, M, K, S, bits, G, g, ginv, f, aligned, BB,
                                     c0, cend, lane, acc);
  else
    bitplane_row<WIDE, false, MT, XT>(wr, sr, zr, xs, M, K, S, bits, G, g, ginv, f, aligned, BB,
                                      c0, cend, lane, acc);
}

template <int MT, typename XT>
__global__ void __launch_bounds__(BP_NT)
    dequant_gemv_kernel_bitplane(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                                 const float* __restrict__ scale, const float* __restrict__ zp,
                                 const float* __restrict__ bias, void* __restrict__ out,
                                 int out_kind, int M, int K, int S, int O, int bits, int G, int g,
                                 unsigned ginv, sdnq::CodeFmt f, int aligned, int BB) {
  extern __shared__ __align__(16) float xs_s[];  // [M][8][BB]: x[m, i*S + c0 + bb]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = M * 8 * BB;  // staged values a chunk
  const unsigned bbinv = 0xffffffffu / static_cast<unsigned>(BB);
  // the block's rows o0 + warp, o0 + gridDim.x * BP_WARPS + warp, ..; x is
  // staged once where one chunk holds a row (BB >= S), else every chunk
  // for every pass
  for (int o0 = blockIdx.x * BP_WARPS; o0 < O; o0 += gridDim.x * BP_WARPS) {
    const int o = o0 + warp;
    const uint8_t* wr = w + (size_t)o * bits * S;
    const float* sr = scale + (size_t)o * G;
    const float* zr = zp ? zp + (size_t)o * G : nullptr;
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    for (int c0 = 0; c0 < S; c0 += BB) {
      const int cend = min(S, c0 + BB);
      if (BB < S || o0 == static_cast<int>(blockIdx.x) * BP_WARPS) {
        __syncthreads();  // every warp is done with the last chunk
#pragma unroll 4
        for (int idx = threadIdx.x; idx < n; idx += BP_NT) {  // all loads in flight
          const int r = sdnq::div_magic(idx, BB, bbinv), i = r & 7;
          const int b = c0 + idx - r * BB;
          xs_s[idx] = (b < cend && i * S + b < K)
                          ? sdnq::to_f32(x[(size_t)(r >> 3) * K + (size_t)i * S + b])
                          : 0.f;
        }
        __syncthreads();
      }
      if (o < O) {
        if (bits > 8)
          bitplane_row_of<true, MT, XT>(wr, sr, zr, xs_s, M, K, S, bits, G, g, ginv, f, aligned,
                                        BB, c0, cend, lane, acc);
        else
          bitplane_row_of<false, MT, XT>(wr, sr, zr, xs_s, M, K, S, bits, G, g, ginv, f, aligned,
                                         BB, c0, cend, lane, acc);
      }
    }
    if (o < O) {
      const float bo = bias ? bias[o] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float a = acc[m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
          if (lane == 0) store_out(out, out_kind, (size_t)m * O + o, bias ? a + bo : a);
        }
      }
    }
  }
}

template <int MT, typename XT>
int launch_bitplane(const void* x, const uint8_t* w, const float* s, const float* zp,
                    const float* b, void* out, int out_kind, int M, int K, int S, int O, int bits,
                    int G, const sdnq::CodeFmt& f, cudaStream_t st) {
  auto kernel = dequant_gemv_kernel_bitplane<MT, XT>;
  static bool ready = false;  // chunks of more than 48 KB at many rows
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, XS_MAX_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  // bytes of staged x a byte of every plane; the whole row in one chunk
  // where it fits XS_BYTES, else chunks of 128 bytes a multiple
  const int per = M * 8 * 4, S4 = (S + 3) & ~3;
  const int BB = per * S4 <= XS_BYTES ? S4 : 128 * max(1, XS_BYTES / (per * 128));
  const int g = K / G;
  const bool aligned = S % 4 == 0 && (G == 1 || g % 4 == 0) &&
                       reinterpret_cast<uintptr_t>(w) % 4 == 0;
  // blocks that persist where x is staged once: as many as fit on the
  // card, each walking rows a grid apart
  const size_t smem = (size_t)per * BB;
  int blocks = (O + BP_WARPS - 1) / BP_WARPS;
  if (BB >= S) {
    static size_t occ_smem = 0;
    static int occ_blocks = 0;  // blocks an SM holds at that shared memory
    if (occ_smem != smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BP_NT, smem);
      occ_blocks = max(1, sms * per_sm);
      occ_smem = smem;
    }
    blocks = min(blocks, occ_blocks);
  }
  kernel<<<blocks, BP_NT, smem, st>>>(
      static_cast<const XT*>(x), w, s, zp, b, out, out_kind, M, K, S, O, bits, G, g,
      0xffffffffu / static_cast<unsigned>(g), f, aligned, BB);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_bitplane_types(int x_kind, int out_kind, const void* x, const uint8_t* w,
                          const float* s, const float* zp, const float* b, void* out, int M,
                          int K, int S, int O, int bits, int G, const sdnq::CodeFmt& f,
                          cudaStream_t st) {
  if (x_kind == sdnq::F32)
    return launch_bitplane<MT, float>(x, w, s, zp, b, out, out_kind, M, K, S, O, bits, G, f, st);
  if (x_kind == sdnq::BF16)
    return launch_bitplane<MT, __nv_bfloat16>(x, w, s, zp, b, out, out_kind, M, K, S, O, bits, G,
                                              f, st);
  if (x_kind == sdnq::F16)
    return launch_bitplane<MT, __half>(x, w, s, zp, b, out, out_kind, M, K, S, O, bits, G, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) contiguous of x_kind and w (O, K) codes of code_kind (0 int8,
// 1 uint8, 2 e4m3, 3 e5m2), both 16-byte aligned, K a multiple of 16; G = 1: scale
// (O,), zp (O,) or null; G > 1: scale, zp (O, G), groups of g codes (a
// multiple of 8), the last ending within 16 codes of K (the wrapper's pad);
// bias (O,) or null; all f32; out (M, O) of out_kind.  1 <= M <= 32.
extern "C" int sdnq_dequant_gemv(const void* x, const void* w, const void* scale, const void* zp,
                                 const void* bias, void* out, int M, int K, int O, int G, int g,
                                 int x_kind, int code_kind, int out_kind, void* stream) {
  if (M < 1 || M > 32 || K < 16 || K % 16 != 0 || O < 0 || G < 1 || g < 8 || g % 8 != 0 ||
      (long long)g * G > K || K - (long long)g * G >= 16 || code_kind < I8 || code_kind > E5M2 ||
      out_kind < sdnq::F32 || out_kind > sdnq::F16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (O == 0) return 0;
  const GemvArgs a{x, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
                   static_cast<const float*>(zp), static_cast<const float*>(bias), out, M, K, O,
                   G, g, 0xffffffffu / static_cast<unsigned>(g), code_kind, out_kind, 1, K, 1, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_kind == sdnq::F32)
    rc = launch_x(a, st);
  else if (x_kind == sdnq::BF16)
    rc = launch_x_mma<__nv_bfloat16>(a, st);
  else if (x_kind == sdnq::F16)
    rc = launch_x_mma<__half>(a, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Bit-plane mode.  x (M, K) of x_kind (f32, bf16 or fp16), contiguous; w
// (O, bits*S) uint8 planes, S = ceil(K / 8); scale, zp (O, G) f32 with g =
// K / G (zp, bias (O,) may be null); the code format as sdnq::code_fmt's
// arguments; out (M, O) of out_kind (f32, bf16 or fp16).  1 <= M <= 32.
extern "C" int sdnq_dequant_gemv_bitplane(const void* x, const void* w, const void* scale,
                                          const void* zp, const void* bias, void* out, int M,
                                          int K, int S, int O, int G, int bits, int is_float,
                                          int code_min, int e, int m, int fbias, int x_kind,
                                          int out_kind, void* stream) {
  if (M < 1 || M > 32 || K < 1 || G < 1 || K % G != 0 || bits < 1 || bits > 16 ||
      S != (K + 7) / 8 || out_kind < sdnq::F32 || out_kind > sdnq::F16)
    return static_cast<int>(cudaErrorInvalidValue);
  const sdnq::CodeFmt f = sdnq::code_fmt(is_float, code_min, e, m, fbias);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    return launch_bitplane_types<1>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                    f, st);
  if (M <= 4)
    return launch_bitplane_types<4>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                    f, st);
  if (M <= 8)
    return launch_bitplane_types<8>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                    f, st);
  if (M <= 16)
    return launch_bitplane_types<16>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G,
                                     f, st);
  return launch_bitplane_types<32>(x_kind, out_kind, x, wp, s, z, b, out, M, K, S, O, bits, G, f,
                                   st);
}
