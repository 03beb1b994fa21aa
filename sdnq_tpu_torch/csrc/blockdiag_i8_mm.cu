// B8: int8 rows times raw half-split codes at any group size.
//
//   out[m, o] = xs[m] * sum_g (scale[o, g] * P_g[m, o] + xsum[m, g] * zpc[o, g])
//               + bias[o]
//   P_g[m, o] = sum_{k in group g} xq[m, k] * c[o, k]        (exact int32)
//
// The same function as B7 (csrc/wgmma_mm.cu's int8 fold); c are the raw codes
// 0 .. 2^BITS - 1 of a half-split row of 1-7-bit codes (sdnq::HalfSplit:
// each field plane p of width w_p carries code k in field k / seg_p of its
// byte k % seg_p, shifted left by shift_p), zpc folds the zero point and
// the offset-binary minimum, xsum is the per-row group sum of the int8
// codes (computed by the wrapper, group-major (G, M)).
//
// Replaces sdnq_tpu/kernels/dequant_mm.py `_blockdiag_i8_kernel` (:890,
// wrapper `_blockdiag_i8_mm_pallas` :948).  The TPU kernel expands x into a
// block-diagonal (M*G, K) operand so that one full-K MXU dot yields every
// group's partial.  On Hopper the partials are taken directly on the
// tensor cores instead.  B8 serves products of a few rows (M up to
// dequant_mm.I8_BLOCKDIAG_MAX_ROWS on the packed-int8 route), where the
// bound is the weight's bytes: at M 32, 2048 -> 8192, uint4 g 64, 8.4 MB of
// codes and 2.1 MB of fp32 scale / zpc against 1.1 G integer operations.
//
// Design: a block takes 32 weight rows (four n8 slices) and up to 128 x
// rows (MT m16 tiles), one warp a slice, or two where the block has two m16
// tiles or more (each takes half of them: shorter serial chains); 256
// blocks at O 8192.  Stages of 256, 128 or 64 codes (the largest that
// every field plane's segment allows; x: a stage of each row; each plane:
// the bytes that hold the stage's codes in one field) arrive by 16-byte
// cp.async in a ring, with the fold terms of the groups that end in the
// stage (the tile's scale and zpc columns, xsum of its rows) beside them;
// the stage's fields and groups are tracked without a division.  Each k32
// step decodes the B fragment of the warp's weight rows in registers (per
// plane a 32-bit word of four codes: shift by the field, mask, shift by
// the plane's place, or) and runs mma.sync m16n8k32 s8 with the x rows as
// the A side (ldmatrix).  A group that is a multiple of 32 ends at a
// step's end; smaller groups (8, 16, 12, ...) and groups that end inside a
// step take one mma a group with the weight fragment's bytes outside the
// group zeroed, so a partial never mixes two groups.  At each group's end
// its int32 partial is folded into the fp32 sum, acc + P * scale then acc
// + xsum * zpc, one rounding each (__fmul_rn / __fadd_rn), in group order
// as the plain version folds, so the kernel equals it bit for bit.
#include "common.cuh"

namespace {

constexpr int BN = 32;          // weight rows of a block: four n8 slices
constexpr int NE_STAGED = 17;   // fold terms staged for up to this many groups a stage

// Stages of KS codes (the largest of 256, 128, 64 that every field plane's
// segment allows), ST of them in the ring (512-768 codes a row in flight)
template <int KS>
struct Stage {
  static constexpr int ST = KS == 256 ? 3 : KS == 128 ? 4 : 6;
  static constexpr int LD = KS + 16;  // padded shared row (bytes): conflict-free fragment loads
};

// Warps: four n8 slices of the block's weight rows, times MS halves of its
// x rows where there are two m16 tiles or more (shorter serial chains)
template <int MT>
struct Warps {
  static constexpr int MS = MT >= 2 ? 2 : 1;
  static constexpr int NW = 4 * MS, NT = 32 * NW;
  static constexpr int MTW = MT / MS;  // m16 tiles a warp
};

struct Args {
  const int8_t* X;      // (M, K)
  const uint8_t* W;     // (N, rowbytes)
  const float* scale;   // (N, G)
  const float* zpc;     // (N, G)
  const float* xsum;    // (G, M)
  const float* xs;      // (M,)
  const float* bias;    // (N,) or null
  int M, N, K, G, g, bits, rowbytes;
  unsigned inv_g;       // floor((2^32 - 1) / g), for sdnq::div_magic
  int ne_max;           // groups that end in one stage, at most (0: terms not staged)
  int x_bytes, terms_off, stage_bytes;
};

// bytes j of a fragment word (codes o .. o + 3 of the step) with lo <= o + j < hi
__device__ __forceinline__ unsigned byte_mask(int o, int lo, int hi) {
  const int a = max(lo - o, 0), b = min(hi - o, 4);
  if (a >= b) return 0u;
  const unsigned upper = b == 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
  return upper & ~((1u << (8 * a)) - 1u);
}

// the A fragment of m16n8k32 (rows r, r + 8; bytes 4 t4 .., 16 + 4 t4 ..)
// from a row-major int8 tile: four 8 x 16-byte matrices, one ldmatrix
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(sdnq::smem_addr(p)));
}

template <int KS, int MT, typename OutT>
__global__ void __launch_bounds__(Warps<MT>::NT)
    blockdiag_i8_mm_kernel(Args a, OutT* __restrict__ out) {
  constexpr int MB = 16 * MT;  // x rows of a block
  constexpr int ST = Stage<KS>::ST, LD = Stage<KS>::LD, CH = KS / 16;  // 16-byte chunks a row
  constexpr int NT = Warps<MT>::NT, MTW = Warps<MT>::MTW;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, i0 = (tid >> 7) * MTW;  // n8 slice; first m16 tile
  const int r = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MB;
  const sdnq::HalfSplit hs = sdnq::halfsplit_planes(a.bits, a.K);
  const int w_bytes = BN * LD, tstride = 2 * BN + MB;
  unsigned inv_seg[3];  // for the planes' fields without a division a stage
#pragma unroll
  for (int p = 0; p < 3; ++p) inv_seg[p] = p < hs.n ? 0xffffffffu / hs.seg[p] : 1u;

  auto load_stage = [&](int kt) {
    uint8_t* st = smem + (kt % ST) * a.stage_bytes;
    const int k0 = kt * KS;
    for (int c = tid; c < MB * CH; c += NT) {  // x: KS bytes of each row
      const int row = c / CH, cb = (c % CH) * 16, gr = m0 + row;
      sdnq::cp_async16(st + row * LD + cb, a.X + (size_t)(gr < a.M ? gr : 0) * a.K + k0 + cb,
                       gr < a.M);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {  // each plane's KS bytes of the stage's field
      if (p < hs.n) {
        const int b0 = hs.off[p] + k0 - sdnq::div_magic(k0, hs.seg[p], inv_seg[p]) * hs.seg[p];
        for (int c = tid; c < BN * CH; c += NT) {
          const int row = c / CH, cb = (c % CH) * 16, gn = n0 + row;
          sdnq::cp_async16(st + a.x_bytes + p * w_bytes + row * LD + cb,
                           a.W + (size_t)(gn < a.N ? gn : 0) * a.rowbytes + b0 + cb, gn < a.N);
        }
      }
    }
    if (a.ne_max) {  // the terms of the groups that end in this stage
      const int e0 = sdnq::div_magic(k0, a.g, a.inv_g);
      const int ne = sdnq::div_magic(k0 + KS, a.g, a.inv_g) - e0;
      float* tm = reinterpret_cast<float*>(st + a.terms_off);
      for (int j = 0; j < ne; ++j)
        for (int q = tid; q < tstride; q += NT) {
          if (q < 2 * BN) {
            const int cq = q < BN ? q : q - BN, col = n0 + cq;
            sdnq::cp_async4(tm + (q < BN ? 0 : a.ne_max * BN) + j * BN + cq,
                            (q < BN ? a.scale : a.zpc) + (size_t)(col < a.N ? col : 0) * a.G + e0 + j,
                            col < a.N);
          } else {
            const int row = m0 + q - 2 * BN;
            sdnq::cp_async4(tm + 2 * a.ne_max * BN + j * MB + (q - 2 * BN),
                            a.xsum + (size_t)(e0 + j) * a.M + (row < a.M ? row : 0), row < a.M);
          }
        }
    }
    sdnq::cp_async_commit();
  };

  float acc[MTW][4];  // m16 tiles i0 + i
  int part[MTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] = 0.f;
      part[i][e] = 0;
    }

  const int nk = a.K / KS;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk)
      load_stage(s);
    else
      sdnq::cp_async_commit();
  }
  const int col = 8 * warp + 2 * t4;  // this thread's weight rows col, col + 1 of the block
  // the A fragments' ldmatrix rows: lanes 0-7 and 16-23 rows 0-7, the
  // others rows 8-15; lanes 16-31 the 16 bytes after
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 16 * (lane >> 4);
  int gi = 0, gend = a.g;  // the group being summed, and the code where it ends
  for (int kt = 0; kt < nk; ++kt) {
    sdnq::cp_async_wait<ST - 2>();  // stage kt has landed
    __syncthreads();                // for every thread; and stage kt - 1 is read
    if (kt + ST - 1 < nk)
      load_stage(kt + ST - 1);
    else
      sdnq::cp_async_commit();
    const uint8_t* st = smem + (kt % ST) * a.stage_bytes;
    const int k0 = kt * KS, e0 = gi;  // the first group that ends in this stage
    const float* tm = reinterpret_cast<const float*>(st + a.terms_off);

    // group gi's partial folded in, and the next group begun; its terms
    // staged at j = gi - e0, or read from device memory where the groups
    // are too small to stage
    auto fold = [&]() {
      float sc[2], zc[2], xv[MTW][2];
      if (a.ne_max) {
        const int j = gi - e0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[c] = tm[j * BN + col + c];
          zc[c] = tm[a.ne_max * BN + j * BN + col + c];
        }
#pragma unroll
        for (int i = 0; i < MTW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[i][h] = tm[2 * a.ne_max * BN + j * MB + 16 * (i0 + i) + r + 8 * h];
      } else {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = min(n0 + col + c, a.N - 1);
          sc[c] = a.scale[(size_t)o * a.G + gi];
          zc[c] = a.zpc[(size_t)o * a.G + gi];
        }
#pragma unroll
        for (int i = 0; i < MTW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[i][h] = a.xsum[(size_t)gi * a.M + min(m0 + 16 * (i0 + i) + r + 8 * h, a.M - 1)];
      }
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = acc[i][2 * h + c];
            v = __fadd_rn(v, __fmul_rn(__int2float_rn(part[i][2 * h + c]), sc[c]));
            v = __fadd_rn(v, __fmul_rn(xv[i][h], zc[c]));
            acc[i][2 * h + c] = v;
            part[i][2 * h + c] = 0;
          }
      ++gi;
      gend += a.g;
    };

    // each plane's field of this stage: shift and mask of a word of 4 codes
    int sh[3];
    unsigned m4[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      sh[p] = p < hs.n ? hs.width[p] * sdnq::div_magic(k0, hs.seg[p], inv_seg[p]) : 0;
      m4[p] = p < hs.n ? 0x01010101u * ((1u << hs.width[p]) - 1u) : 0u;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ks += 32) {
      // B: codes ks + 4 t4 .. + 3 and ks + 16 + 4 t4 .. + 3 of weight row 8 warp + r
      unsigned b[2] = {0u, 0u};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint8_t* wp = st + a.x_bytes + p * w_bytes + (8 * warp + r) * LD + ks + 4 * t4;
        if (p < hs.n) {
          b[0] |= ((*reinterpret_cast<const unsigned*>(wp) >> sh[p]) & m4[p]) << hs.shift[p];
          b[1] |= ((*reinterpret_cast<const unsigned*>(wp + 16) >> sh[p]) & m4[p]) << hs.shift[p];
        }
      }
      // A: the same codes of x rows 16 (i0 + i) + r and + 8
      unsigned af[MTW][4];
#pragma unroll
      for (int i = 0; i < MTW; ++i) ldmatrix_x4(af[i], st + (16 * (i0 + i) + lrow) * LD + ks + lcol);
      const int kg = k0 + ks;  // the step's first code
      if (a.g % 32 == 0) {     // the step lies in one group
#pragma unroll
        for (int i = 0; i < MTW; ++i) sdnq::mma_s8(part[i], af[i], b);
        if (kg + 32 == gend) fold();
      } else {  // one mma a group, the codes outside it zeroed
        for (int lo = 0; lo < 32;) {
          const int hi = min(gend - kg, 32);
          const unsigned bm[2] = {b[0] & byte_mask(4 * t4, lo, hi),
                                  b[1] & byte_mask(16 + 4 * t4, lo, hi)};
#pragma unroll
          for (int i = 0; i < MTW; ++i) sdnq::mma_s8(part[i], af[i], bm);
          if (hi < 32) {  // the group ends inside the step
            fold();
          } else {
            if (gend == kg + 32) fold();
            break;
          }
          lo = hi;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * (i0 + i) + r + 8 * h;
      if (row >= a.M) continue;
      const float xsv = a.xs[row];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int o = n0 + col + c;
        if (o >= a.N) continue;
        float v = __fmul_rn(acc[i][2 * h + c], xsv);
        if (a.bias) v = __fadd_rn(v, a.bias[o]);
        out[(size_t)row * a.N + o] = sdnq::from_f32<OutT>(v);
      }
    }
}

template <int KS, int MT, typename OutT>
int launch(const Args& a, void* out, cudaStream_t s) {
  static int smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  const int bytes = Stage<KS>::ST * a.stage_bytes;
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        blockdiag_i8_mm_kernel<KS, MT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = bytes;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + 16 * MT - 1) / (16 * MT));
  blockdiag_i8_mm_kernel<KS, MT, OutT><<<grid, Warps<MT>::NT, bytes, s>>>(a, static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int KS, int MT>
int launch_out(int out_kind, Args a, void* out, cudaStream_t s) {
  constexpr int MB = 16 * MT, LD = Stage<KS>::LD;
  a.ne_max = KS / a.g + 1 <= NE_STAGED ? KS / a.g + 1 : 0;
  a.x_bytes = MB * LD;
  a.terms_off = a.x_bytes + __builtin_popcount(a.bits) * BN * LD;
  a.stage_bytes = (a.terms_off + a.ne_max * (2 * BN + MB) * 4 + 15) / 16 * 16;
  if (out_kind == sdnq::F32) return launch<KS, MT, float>(a, out, s);
  if (out_kind == sdnq::BF16) return launch<KS, MT, __nv_bfloat16>(a, out, s);
  if (out_kind == sdnq::F16) return launch<KS, MT, __half>(a, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KS>
int launch_rows(int out_kind, const Args& a, void* out, cudaStream_t s) {
  if (a.M <= 16) return launch_out<KS, 1>(out_kind, a, out, s);
  if (a.M <= 32) return launch_out<KS, 2>(out_kind, a, out, s);
  if (a.M <= 64) return launch_out<KS, 4>(out_kind, a, out, s);
  return launch_out<KS, 8>(out_kind, a, out, s);
}

}  // namespace

// xq (M, K) int8 codes; xs (M,) f32; w (N, K*bits/8) half-split uint8 of
// 1-7-bit codes; scale, zpc (N, K/g) f32; xsum (K/g, M) f32 (group-major);
// bias (N,) f32 or null; out (M, N) of out_kind.  g divides K; the
// narrowest plane's field segment K / pmax is a multiple of 64 (a stage of
// 64 codes never straddles two fields); every pointer 16-byte aligned.
extern "C" int sdnq_blockdiag_i8_mm(const void* xq, const void* w, const void* scale,
                                    const void* zpc, const void* xsum, const void* xs,
                                    const void* bias, void* out, int M, int K, int N, int g,
                                    int bits, int out_kind, void* stream) {
  if (bits < 1 || bits > 7 || g <= 0 || K <= 0 || K % g != 0 || !xs || !scale || !zpc || !xsum)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pmax = 8 / (bits & -bits);  // fields a byte of the narrowest plane
  if ((K / pmax) % 64 != 0 || K % pmax != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  Args a{static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scale), static_cast<const float*>(zpc),
         static_cast<const float*>(xsum), static_cast<const float*>(xs),
         static_cast<const float*>(bias), M, N, K, K / g, g, bits, K * bits / 8,
         0xffffffffu / static_cast<unsigned>(g), 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((K / pmax) % 256 == 0) return launch_rows<256>(out_kind, a, out, s);
  if ((K / pmax) % 128 == 0) return launch_rows<128>(out_kind, a, out, s);
  return launch_rows<64>(out_kind, a, out, s);
}
