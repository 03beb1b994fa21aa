// B3: flash attention, online softmax in base 2.  The kernels and C entries
// of three libraries: flash_attn.cu builds them for bf16 and int8 Q.K^T at
// head dims 64 and 128, flash_attn_d256.cu (SDNQ_FLASH_D256) for those
// kinds at head dim 256, flash_attn_e4m3.cu (SDNQ_FLASH_E4M3) for e4m3
// Q.K^T at every head dim, so that the three compile in parallel; a
// library called with a kind or head dim it does not hold returns
// cudaErrorNotSupported.  Other head dims up to 256 are zero-padded by the
// wrapper (kernels/attention.py) to the next of 64, 128 and 256.
//
// Head dim 256 (D 256).  O (64 rows x 256 columns of fp32 a warpgroup) and
// the int32 P.V sum of token mode would take 128 registers a thread each,
// beside S and P.  So each block writes DV = 128 of the D output columns
// (grid.z = D / DV: the blocks of a query tile compute Q.K^T and the
// softmax over all D, and P.V against their own half of V), and the
// registers are those of D 128.  The bf16-P.V kernel takes tiles of 64 keys
// at D 256 (Q 64 KB and two stages of K 32 KB, of V 16 KB: 160 KB of shared
// memory in bf16, 225 KB with e4m3's fp16 copies); the token kernel keeps
// its 64-key tiles and 128 KB of scores and takes one stage of K and V^T in
// bf16 and e4m3 Q.K^T (three in int8), e4m3's Q as TMA loaded it lying in
// the scores' space until its conversion.  Q.K^T and the softmax run twice
// a query tile: 1.5 times D 128's operations for D 256's work.
//
//   out[b, i] = sum_j p_ij v[kvb, j] / sum_j p_ij,  p_ij = exp2(s_ij - max_j s_ij)
//   bf16 QK:  s = q . k  with q already scaled by sm_scale * log2(e)
//   int8 QK:  s = (q_q . k_q) * qs[i] * ks[j], qs carrying sm_scale * log2(e)
//   s_ij = -1e30 where key j is masked: past KN, right of the diagonal
//   (causal, i < j) or where the bool mask is 0;
//   s_ij += mask_ij * log2(e) with a float (additive) mask, whose -inf
//   entries give p = 0.
//
// Replaces sdnq_tpu/kernels/attention.py `_attn_kernel` (:67, wrapper
// `_attn_pallas` :192) in these modes: bf16 or int8 Q.K^T; bool masks and
// bf16 or fp32 additive masks (`mask_is_bool` False, :118-123: the score
// in the exp2 domain plus mask * log2(e)), both read through their strides
// (a head-broadcast mask such as T5's (1, H, N, N) relative position bias is
// never materialised per batch);
// causal, with the KV tiles wholly right of a block's last row skipped;
// grouped KV heads (query head h of batch b reads KV head b * KH + h /
// (H / KH), the JAX index map `b // q_per_kv`); P.V in bf16, or in int8
// ("token" mode, :148-157) on per-token-quantized V, or in int8 on V with
// one scale per KV head ("head" mode, the constant p scale of :127-141);
// Q.K^T in bf16, int8 or fp8 e4m3 (per-token scales, the product summed
// in fp32: `acc_t`, :77).
//
// e4m3 Q.K^T (QK_E4M3, both kernels).  TMA loads the codes as int8's one
// byte an element; the consumers convert Q once and each K tile into fp16
// in shared memory (the bf16 mode's K-major layout: e4m3 values are exact
// in fp16) and run the fp16 wgmma into fp32, then s = acc * qs[i] * ks[j]
// as the int8 mode does.  The fp8 wgmma is not used: its sum keeps about
// 14 bits (as in scaled_mm.cu), the plain version's fp32 sum 24.  Each
// consumer warpgroup of the bf16-P.V kernel converts into a buffer of its
// own, before its turn at the tensor cores.
//
// Head mode (`flash_attn_tok_kernel` given V scales a head, `vhead`): the
// token kernel's three passes with p127 = exp2(s - (m_new - log2 127)) in pass (B) (the JAX
// kernel's shift: p127 <= 127, so it needs no scale of its own), l summing
// the unrounded p127, no p * vs and no per-block p scale: pass (C) rounds
// p127 itself (the quantiser with scale 1) and acc = acc * alpha + the
// int32 sum.  The epilogue writes acc / l in the output type and then, as
// the JAX wrapper does after its kernel, that value times the KV head's V
// scale, rounded again.
//
// bf16 P.V (`flash_attn_wgmma_kernel`).  At FLUX's shape (24 heads, N =
// 4608, D = 128) attention is bound by tensor-core operations (4*N^2*D per
// head), which on Hopper only wgmma reaches.  One block takes 128 query rows
// of one (batch*head): two consumer warpgroups of 64 rows each and a
// producer warp whose lane 0 issues every load.  TMA brings Q once
// and K and V in tiles of 128 keys into a ring of two stages, K and V each
// with full and empty mbarriers (Q.K^T of a tile starts before its V has
// landed); the tensor maps are 3-D, (D, rows, heads), so the zero fill
// takes a head's ragged end and no row of the next head is read.  Rows of
// 256 bytes (bf16 at D 128) are two 128-byte-swizzled column chunks, int8
// rows of 64 bytes one 64-byte-swizzled chunk.  S = Q.K^T is an SS wgmma
// (bf16 m64n128k16, or s8 m64n128k32 into int32 for the int8 mode), both
// operands K-major; the online softmax runs in registers on the
// accumulator layout (a thread holds two rows, each row's other values on
// the three other lanes of its quad); P is rounded to bf16 in registers
// and is the A operand of an RS wgmma m64n{D}k16 against V's tile read
// MN-major (V row-major is B transposed).  Overlap: the two warpgroups
// take turns at issuing Q.K^T (named barriers), so that one's softmax runs
// under the other's products; within a warpgroup the products and the
// softmax of a tile follow each other (168 registers a thread hold S, O and
// P of D 128 one after the other, not S of the next tile in flight beside
// O and P).  The tiles run from the last in key order down: the first a
// block takes holds the ragged end of KN and the causal diagonal (at D 256,
// with 64-key tiles, the diagonal's two tiles) and only they run masking
// code for them; tiles right of the diagonal are never loaded, and the
// unmasked path reads no mask.
//
// int8 P.V (`flash_attn_tok_kernel`).  The JAX kernel quantises P once per
// P block of `bk` keys (bk = min(512, KN), halved until it divides KN):
// p = exp2(s - m_new) with m_new the running max after the whole block,
// p_eff = p * vs, p_scale = max(rowmax(p_eff), 1e-20) / 127, p_q =
// rint(p_eff / p_scale), acc = acc * alpha + (p_q . v_q)_int32 * p_scale,
// while l sums the unquantised p.  The P block is part of the function, so
// the wrapper passes it, and every key of a block is scored before any of
// its P.V (p_scale takes the block's final max).  Bound by operations, 4 N
// KN D a head (Q.K^T and P.V at the int8 rate), and by the CUDA cores'
// exponent and quantisation of every (row, key).  A block takes 64 query
// rows of one (batch*head): a consumer warpgroup and a producer warp whose
// lane 0 issues every TMA load, Q once, K tiles of 64 keys and V^T tiles
// into rings of three stages.  The s8 wgmma reads its B operand K-major
// only (keys contiguous), so `flash_attn_vt_kernel` writes V^T once a call,
// each 16 keys' slots in vt_key's order: the scores' accumulator layout,
// so that P's A registers are the thread's own values (no shuffle).  Three
// passes a P block: (A) Q.K^T a tile (SS wgmma m64n64, s8 or bf16),
// fix_scores, the values kept in the thread's own slots of shared memory
// (64 rows x 512 keys x 4 bytes) and the row max; (B) p, l, p_eff = p vs in
// place and its row max; (C) rint(p_eff / p_scale) by a multiply that falls
// back to the division next to half-integers (quant_fast, the same codes),
// the RS s8 wgmma m64nDk32 into an int32 sum for the block, then acc = acc
// alpha + sum p_scale.  The (N, KN) score matrix never reaches device
// memory.
//
// B9, the block mode (`PARTIAL`, entry `sdnq_flash_attn_block`): replaces
// sdnq_tpu/kernels/attention.py `_attn_kernel` with `partial_out=True` (:67,
// wrapper `_attn_block_pallas` :259, `pallas_call` :285), the ring's
// per-block step.  One KV block, no causal flag; each row's unnormalised
// fp32 acc, running max m and sum l are written (:177-184), for the
// caller's online-softmax merge in natural-log units.  So this mode keeps
// the scores in natural units, as the JAX block kernel does: int8 QK s =
// (q_q . k_q) * qs[i] * ks[j] with sm_scale folded into qs by the caller,
// bf16 QK s = (q . k) * sm_scale after the dot (:102-111), an additive mask
// added as it is; p = expf(s - m) (`ex<true>`), and m is the natural max,
// with no conversion on output.  The kernels and the three passes of the
// token mode are B3's.  A row whose every key a bool mask
// hides keeps m = -1e30, so each of its p is exp(0) = 1 and l = KN (:119-121,
// :143-146), as in the JAX kernel.  Bound by tensor-core operations at the
// ring's block shapes (4 * N * KN * D per head), like B3.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace sdnq;

constexpr int BM = 128;  // query rows of a block (bf16 P.V)
// keys of a tile of the bf16-P.V kernel, and output columns of a block
template <int D>
__host__ __device__ constexpr int bn_of() { return D == 256 ? 64 : 128; }
template <int D>
__host__ __device__ constexpr int dv_of() { return D > 128 ? 128 : D; }
constexpr float NEG = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2_127 = 6.988684686772166f;  // head mode's shift
enum { MASK_BOOL = 1, MASK_BF16 = 2, MASK_F32 = 3 };
enum { QK_BF16 = 0, QK_S8 = 1, QK_E4M3 = 2 };  // the Q.K^T kinds

struct Args {
  const uint8_t* q;      // (BH, N, D) bf16, int8 or e4m3
  const uint8_t* k;      // (BKH, KN, D) bf16, int8 or e4m3
  const uint8_t* v;      // (BKH, KN, D) bf16, or int8 in token and head mode
  const float* qs;       // (BH, N) int8 / e4m3 QK, else null
  const float* ks;       // (BKH, KN) int8 / e4m3 QK, else null
  const float* vs;       // (BKH, KN) token mode, else null
  const uint8_t* mask;   // element strides msb / msh / msn / msk, or null
  long long msb, msh, msn, msk;
  int mkind;             // MASK_BOOL, MASK_BF16 or MASK_F32
  void* out;             // (BH, N, D); B9: fp32 acc
  int N, KN, H, qpk, causal, pblock;
  float* m_out;          // B9: (BH, N) row max, natural units
  float* l_out;          // B9: (BH, N) row sum
  float sm_scale;        // B9, bf16 QK: the score's scale after the dot
  int out_kind;          // B3: the type of out (sdnq::F32 / BF16 / F16)
  const float* vhead;    // (BKH) head mode's V scales, else null
};

// p = exp(x): base 2 for B3 (log2(e) folded into the scores), base e for B9
template <bool NATURAL>
__device__ __forceinline__ float ex(float x) {
  return NATURAL ? expf(x) : exp2f(x);
}

// A row whose every key is masked by -inf keeps the running max at its
// -1e30 start, so exp2(-inf - m) = 0 and l = 0: the row's output is 0/1e-30
// = 0, not NaN, as in the JAX kernel (:80, :186).

// the last KV position (exclusive) a block of query rows q0 .. q0+bq-1 reads
__device__ __forceinline__ int kv_stop(const Args& a, int q0, int bq) {
  return a.causal ? min(a.KN, q0 + bq) : a.KN;
}

// KV head of query head bh = b * H + h: b * KH + h / (H / KH)
__device__ __forceinline__ size_t kv_head(const Args& a, size_t bh) {
  const int hh = static_cast<int>(bh % a.H), KH = a.H / a.qpk;
  return (bh / a.H) * KH + hh / a.qpk;
}

// the mask row of query row r (clamped into range) of head bh, or null
__device__ __forceinline__ const uint8_t* mask_row(const Args& a, size_t bh, int r) {
  if (!a.mask) return nullptr;
  const long long b = static_cast<long long>(bh / a.H), h = static_cast<long long>(bh % a.H);
  const long long esz = a.mkind == MASK_F32 ? 4 : (a.mkind == MASK_BF16 ? 2 : 1);
  return a.mask + (b * a.msb + h * a.msh + static_cast<long long>(min(r, a.N - 1)) * a.msn) * esz;
}

// acc / l in the output type; in head mode then times the head's V scale
// vh, rounded again (the JAX wrapper's two steps; a no-op at vh = 1)
template <typename OutT>
__device__ __forceinline__ OutT out_val(float acc, float d, float vh) {
  const OutT o = sdnq::from_f32<OutT>(__fdiv_rn(acc, d));
  return sdnq::from_f32<OutT>(__fmul_rn(sdnq::to_f32(o), vh));
}

// rows r0, r1 of the block's output columns c0 .. c0 + 8 NDT - 1 (c0 =
// blockIdx.z * 8 NDT: D 256 takes two blocks a query tile) of rows D wide
template <typename OutT, int D, int NDT>
__device__ __forceinline__ void store_rows(const Args& a, size_t bh, int r0, int r1, int t4,
                                           const float (&o_acc)[NDT][4], float l0, float l1) {
  const int c0 = blockIdx.z * NDT * 8;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const float vh = a.vhead ? a.vhead[kv_head(a, bh)] : 1.f;
  OutT* o0 = static_cast<OutT*>(a.out) + (bh * a.N + r0) * (size_t)D + c0;
  OutT* o1 = static_cast<OutT*>(a.out) + (bh * a.N + r1) * (size_t)D + c0;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < a.N) {
      o0[c] = out_val<OutT>(o_acc[dt][0], d0, vh);
      o0[c + 1] = out_val<OutT>(o_acc[dt][1], d0, vh);
    }
    if (r1 < a.N) {
      o1[c] = out_val<OutT>(o_acc[dt][2], d1, vh);
      o1[c + 1] = out_val<OutT>(o_acc[dt][3], d1, vh);
    }
  }
}

// B9's epilogue: acc unnormalised in fp32, and each row's m and l (the
// quad's four threads hold the same row values; the first writes them)
template <int D, int NDT>
__device__ __forceinline__ void store_partial(const Args& a, size_t bh, int r0, int r1, int t4,
                                              const float (&o_acc)[NDT][4], float m0, float m1,
                                              float l0, float l1) {
  const int c0 = blockIdx.z * NDT * 8;
  float* o0 = static_cast<float*>(a.out) + (bh * a.N + r0) * (size_t)D + c0;
  float* o1 = static_cast<float*>(a.out) + (bh * a.N + r1) * (size_t)D + c0;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < a.N) *reinterpret_cast<float2*>(o0 + c) = make_float2(o_acc[dt][0], o_acc[dt][1]);
    if (r1 < a.N) *reinterpret_cast<float2*>(o1 + c) = make_float2(o_acc[dt][2], o_acc[dt][3]);
  }
  if (t4 == 0 && blockIdx.z == 0) {  // the blocks of a tile hold the same m, l
    if (r0 < a.N) {
      a.m_out[bh * a.N + r0] = m0;
      a.l_out[bh * a.N + r0] = l0;
    }
    if (r1 < a.N) {
      a.m_out[bh * a.N + r1] = m1;
      a.l_out[bh * a.N + r1] = l1;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// `rows` e4m3 rows of D codes as TMA wrote them (64-byte rows in the
// 64-byte swizzle, 16-byte unit u of row r at u ^ ((r >> 1) & 3); else
// chunks of 128 bytes a row, `src_chunk` bytes apart, in the 128-byte
// swizzle, at u ^ (r & 7)) into fp16 in the bf16 mode's K-major layout:
// chunks of 64 values `chunk` bytes apart, 128-byte rows in the 128-byte
// swizzle.  NT threads, this one t.  The next reader is wgmma (the async
// proxy): fence_async first.
template <int D, int NT>
__device__ __forceinline__ void e4m3_to_f16_rows(const uint8_t* src, uint8_t* dst, int rows,
                                                 int src_chunk, int chunk, int t) {
  constexpr int U = D / 16;  // 16-code units of a row
  for (int id = t; id < rows * U; id += NT) {
    const int r = id / U, c = id % U;
    const uint8_t* at = D == 64 ? src + r * 64 + ((c ^ ((r >> 1) & 3)) << 4)
                                : src + (c >> 3) * src_chunk + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    const uint4 v = *reinterpret_cast<const uint4*>(at);
    const uint4 lo = make_uint4(e4m3x2_to_f16x2(v.x), e4m3x2_to_f16x2(v.x >> 16),
                                e4m3x2_to_f16x2(v.y), e4m3x2_to_f16x2(v.y >> 16));
    const uint4 hi = make_uint4(e4m3x2_to_f16x2(v.z), e4m3x2_to_f16x2(v.z >> 16),
                                e4m3x2_to_f16x2(v.w), e4m3x2_to_f16x2(v.w >> 16));
    uint8_t* d = dst + (c >> 2) * chunk + r * 128;
    *reinterpret_cast<uint4*>(d + (((2 * (c & 3)) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(d + (((2 * (c & 3) + 1) ^ (r & 7)) << 4)) = hi;
  }
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// bf16 P.V: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int ST = 2;  // stages of K and of V
// Two consumer warpgroups, then the producer warp.  ptxas gives each thread
// 168 registers (as for 384 threads): S, O and P of D 128 fit one after the
// other, not S of the next tile in flight beside O and P of this one (ptxas
// then serializes the wgmmas and spills).  setmaxnreg (the producer's dec
// 24, the consumers' inc 240) did not raise its allocation above 168, and
// the card refused to launch a 224-register build (__maxnreg__).
constexpr int WGT = 128, NTW = 2 * WGT + 32;

// Shared memory of a mode: Q (BM rows), ST stages of K and of V (BN rows
// each), ST stages of the int8 / e4m3 modes' key scales, in the e4m3 mode
// each consumer warpgroup's converted K tile and Q as TMA loaded it, the
// barriers.  A row of Q or K as wgmma reads it is QB bytes, stored as
// column chunks of CH bytes a row (a chunk of R rows takes R * CH bytes):
// 128-byte chunks in the 128-byte swizzle, or at 64-byte rows (int8, D 64)
// one chunk in the 64-byte swizzle.  As TMA loads it, TB bytes in chunks of
// TCH (e4m3: int8's layout).  V's rows (the block's DV columns, 2 DV bytes)
// are 128-byte chunks of 64 columns.
template <int D, int QKIND>
struct Smem {
  static constexpr int BN = bn_of<D>(), DV = dv_of<D>();
  static constexpr bool CONV = QKIND == QK_E4M3;
  static constexpr int QB = QKIND == QK_S8 ? D : 2 * D;
  static constexpr int CH = QB < 128 ? QB : 128;
  static constexpr int TB = QKIND == QK_BF16 ? 2 * D : D;
  static constexpr int TCH = TB < 128 ? TB : 128;
  static constexpr int Q_BYTES = BM * QB, K_BYTES = BN * TB, V_BYTES = BN * 2 * DV;
  static constexpr int KS_BYTES = QKIND != QK_BF16 ? BN * 4 : 0;
  static constexpr int KC_BYTES = CONV ? BN * QB : 0, QT_BYTES = CONV ? BM * TB : 0;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + ST * K_BYTES;
  // the key scales' span rounded up to 1024 bytes, the converted tiles'
  // swizzle alignment
  static constexpr int KS_SPAN = (ST * KS_BYTES + 1023) / 1024 * 1024;
  static constexpr int KS_OFF = V_OFF + ST * V_BYTES, KC_OFF = KS_OFF + KS_SPAN;
  static constexpr int QT_OFF = KC_OFF + 2 * KC_BYTES, BAR_OFF = QT_OFF + QT_BYTES;
  static constexpr int QL_OFF = CONV ? QT_OFF : 0;  // where TMA writes Q
  static constexpr int BYTES = BAR_OFF + (1 + 4 * ST) * 8 + 1024;  // + the 1024-byte alignment
};

template <int CH>
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return CH == 128 ? sw128_desc(p) : sw64_desc(p);
}

// S = Q.K^T of a warpgroup's 64 rows (sq) and a tile's BN keys (sk), both
// K-major: bf16 or fp16 (e4m3 converted) m64n{BN}k16, or s8 m64n{BN}k32
// (into S's registers as int32), 32 bytes of the rows a step.
template <int D, int QKIND>
__device__ __forceinline__ void issue_qk(float (&s)[bn_of<D>() / 2], const uint8_t* sq,
                                         const uint8_t* sk) {
  using L = Smem<D, QKIND>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < L::QB / 32; ++st) {
    const int c = st * 32 / L::CH, step = (st * 32 % L::CH) / 16;
    const uint64_t da = kmajor_desc<L::CH>(sq + c * BM * L::CH) + step;
    const uint64_t db = kmajor_desc<L::CH>(sk + c * L::BN * L::CH) + step;
    if constexpr (L::BN == 64) {
      if constexpr (QKIND == QK_S8)
        wgmma_s8_64(reinterpret_cast<int(&)[32]>(s), da, db, st != 0);
      else if constexpr (QKIND == QK_E4M3)
        wgmma64_f16(s, da, db, st != 0);
      else
        wgmma64(s, da, db, st != 0);
    } else {
      if constexpr (QKIND == QK_S8)
        wgmma_s8(reinterpret_cast<int(&)[64]>(s), da, db, st != 0);
      else if constexpr (QKIND == QK_E4M3)
        wgmma128_f16(s, da, db, st != 0);
      else
        wgmma128(s, da, db, st != 0);
    }
  }
  wgmma_commit();
}

// O += P.V over a tile: P (the warpgroup's 64 rows x BN keys as bf16 pairs,
// p[4 kk .. 4 kk + 3] the A operand of keys 16 kk ..) times V (BN keys x
// the block's DV columns, chunks of 64 columns BN * 128 bytes apart), V an
// MN-major B.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[dv_of<D>() / 2],
                                         const unsigned (&p)[bn_of<D>() / 4], const uint8_t* sv) {
  constexpr int BN = bn_of<D>();
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const unsigned a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t db = sw128_desc_mn(sv + kk * 16 * 128, BN * 128);
    if constexpr (dv_of<D>() == 128)
      wgmma_rs128_t(o, a, db);
    else
      wgmma_rs64_t(o, a, db);
  }
  wgmma_commit();
}

// The mask values of 16 scores (4 chunks of 8 keys from chunk j0: keys kv0
// + 8 j + 2 (t % 4) + {0, 1} of rows r0 and r1, in fix_scores' order): bool
// masks as 0 / 1, additive ones as fp32, 0 past KN (not read).  The kind is
// branched on once and the loads are issued together, so that their
// latencies overlap.
template <bool EDGE>
__device__ __forceinline__ void load_mask16(float (&mv)[16], const Args& a, const uint8_t* mrow0,
                                            const uint8_t* mrow1, int kv0, int j0, int t4) {
  auto col_of = [&](int e) { return kv0 + 8 * (j0 + e / 4) + 2 * t4 + (e & 1); };
  auto in = [&](int e) { return !EDGE || col_of(e) < a.KN; };
  auto at = [&](int e) { return ((e & 2) ? mrow1 : mrow0); };
  if (a.mkind == MASK_F32) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      mv[e] = in(e) ? reinterpret_cast<const float*>(at(e))[col_of(e) * a.msk] : 0.f;
  } else if (a.mkind == MASK_BF16) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      mv[e] = in(e) ? __bfloat162float(
                          reinterpret_cast<const __nv_bfloat16*>(at(e))[col_of(e) * a.msk])
                    : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) mv[e] = in(e) && at(e)[col_of(e) * a.msk] != 0 ? 1.f : 0.f;
  }
}

// A tile's scores after Q.K^T (s[4j], s[4j+1] of row r0 and s[4j+2],
// s[4j+3] of row r1 at keys kv0 + 8j + 2 (t % 4) + {0, 1}): the int8 modes' scales, B9's sm_scale on bf16 products, and the masks.  The EDGE tile (the
// first a block takes: the last in key order) masks keys past KN with -inf,
// so that they add nothing even to a row a bool mask hides everywhere, and,
// causal, keys right of the diagonal; MASKED reads the bool or additive
// mask of each (row, key), 16 values at a time.  The tiles inside KN and
// left of the diagonal carry none of this code.
template <int QKIND, bool NATURAL, bool MASKED, bool EDGE, int NS>
__device__ __forceinline__ void fix_scores(float (&s)[NS], const float* sks, float qs0, float qs1,
                                           const Args& a, int kv0, int r0, int r1,
                                           const uint8_t* mrow0, const uint8_t* mrow1, int t4) {
  const bool fmask = a.mkind != MASK_BOOL;
#pragma unroll
  for (int j0 = 0; j0 < NS / 4; j0 += 4) {
    float mv[16];
    if constexpr (MASKED) load_mask16<EDGE>(mv, a, mrow0, mrow1, kv0, j0, t4);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = j0 + e / 4, i = e & 3;
      const int c = 8 * j + 2 * t4 + (i & 1), col = kv0 + c, row = i < 2 ? r0 : r1;
      float x = s[4 * j + i];
      if constexpr (QKIND == QK_S8)
        x = (static_cast<float>(__float_as_int(x)) * (i < 2 ? qs0 : qs1)) * sks[c];
      else if constexpr (QKIND == QK_E4M3)
        x = __fmul_rn(__fmul_rn(x, i < 2 ? qs0 : qs1), sks[c]);
      else if constexpr (NATURAL)
        x = __fmul_rn(x, a.sm_scale);
      bool keep = true;
      if constexpr (EDGE) keep = !(a.causal && row < col);
      if (MASKED && keep && (!EDGE || col < a.KN)) {
        if (fmask && NATURAL)
          x = __fadd_rn(x, mv[e]);
        else if (fmask)
          x = __fadd_rn(x, __fmul_rn(mv[e], kLog2e));
        else
          keep = mv[e] != 0.f;
      }
      x = keep ? x : NEG;
      if (EDGE && col >= a.KN) x = -INFINITY;
      s[4 * j + i] = x;
    }
  }
}

// The online softmax of a tile on the accumulator layout: s becomes p =
// ex(s - m_new); al0 / al1 the factors of the sums so far; l0 / l1 this
// thread's share of its rows' sums (the quad's four summed at the end).
template <bool NATURAL, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float& m0, float& m1, float& l0,
                                             float& l1, float& al0, float& al1) {
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  al0 = ex<NATURAL>(m0 - mn0);
  al1 = ex<NATURAL>(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    s[4 * j] = ex<NATURAL>(s[4 * j] - mn0);
    s[4 * j + 1] = ex<NATURAL>(s[4 * j + 1] - mn0);
    s[4 * j + 2] = ex<NATURAL>(s[4 * j + 2] - mn1);
    s[4 * j + 3] = ex<NATURAL>(s[4 * j + 3] - mn1);
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
}

template <int NDT>
__device__ __forceinline__ void rescale(float (&o)[NDT][4], float al0, float al1) {
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    o[dt][0] *= al0;
    o[dt][1] *= al0;
    o[dt][2] *= al1;
    o[dt][3] *= al1;
  }
}

// P = bf16(p) in the A operand's order: neighbouring columns paired
template <int NS>
__device__ __forceinline__ void pack_p(unsigned (&p)[NS / 2], const float (&s)[NS]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

// Ping-pong: warpgroup wg waits at named barrier 1 + wg before it issues a
// tile's Q.K^T and, once it is issued, lets the other one go (barrier 2 -
// wg); each barrier counts the 128 threads waiting and the 128 arriving.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// a consumer warpgroup's named barrier (3 + wg, its 128 threads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// B3 / B9 with bf16 P.V; grid (ceil(N / BM), BH, D / DV).  QKIND: the Q.K^T kind;
// MASKED: a bool or additive mask; PARTIAL: B9's natural units and
// epilogue.  A consumer warpgroup takes each tile in turn: Q.K^T (e4m3:
// the tile converted to fp16 first), the softmax once it has completed,
// P.V; warpgroup 0 issues each tile's Q.K^T first.
template <int D, int QKIND, bool MASKED, bool PARTIAL>
__global__ void __launch_bounds__(NTW, 1)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<D, QKIND>;
  constexpr bool QUANT = QKIND != QK_BF16, CONV = L::CONV;
  constexpr int BN = L::BN, DV = L::DV, NS = BN / 2;  // S's registers a thread
  constexpr int NDT = DV / 8;
  constexpr int NCH = L::TB / L::TCH;  // column chunks of a Q / K row as TMA loads it
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the first 1024-byte boundary (an offset from smem_raw, so that the
  // compiler keeps the shared address space)
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  const int wg = threadIdx.x / WGT;
  const int q0 = blockIdx.x * BM;
  const size_t bh = blockIdx.y;
  const int kvbh = static_cast<int>(kv_head(a, bh));
  const int n_tiles = (kv_stop(a, q0, BM) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      // the producer's arrive with the stage's bytes (and, int8, its arrive
      // once the key scales are stored)
      mbar_init(&k_full[s], QUANT ? 2 : 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrive from each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: lane 0 issues every load
    const bool leader = threadIdx.x == 2 * WGT;
    constexpr int CE = QUANT ? L::TCH : L::TCH / 2;  // elements of a chunk's row
    if (leader) {
      mbar_expect_tx(q_full, BM * L::TB);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(smem + L::QL_OFF + c * BM * L::TCH, &tq, q_full, c * CE, q0,
                    static_cast<int>(bh));
    }
    for (int i = 0; i < n_tiles; ++i) {  // tile i of the block: keys from kv0
      const int s = i % ST, kv0 = (n_tiles - 1 - i) * BN;
      const unsigned ph = ((i / ST) & 1) ^ 1;  // the first round passes at once
      // the stage is released, and its last load has landed (implied by
      // the release; waited for all the same, so that a stage never has
      // two loads in flight on its barrier)
      mbar_wait(&k_empty[s], ph);
      if (i >= ST) mbar_wait(&k_full[s], ph);
      if (leader) {
        mbar_expect_tx(&k_full[s], L::K_BYTES);
        uint8_t* sk = smem + L::K_OFF + s * L::K_BYTES;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load_3d(sk + c * BN * L::TCH, &tk, &k_full[s], c * CE, kv0, kvbh);
      }
      if constexpr (QUANT) {  // the tile's key scales, zeros past KN, by the warp
        float* sks = reinterpret_cast<float*>(smem + L::KS_OFF + s * L::KS_BYTES);
        const float* ks = a.ks + static_cast<size_t>(kvbh) * a.KN;
        for (int c = threadIdx.x % 32; c < BN; c += 32)
          sks[c] = kv0 + c < a.KN ? ks[kv0 + c] : 0.f;
        __syncwarp();
        if (leader) mbar_arrive(&k_full[s]);
      }
      mbar_wait(&v_empty[s], ph);
      if (i >= ST) mbar_wait(&v_full[s], ph);
      if (leader) {
        mbar_expect_tx(&v_full[s], L::V_BYTES);
        uint8_t* sv = smem + L::V_OFF + s * L::V_BYTES;
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)  // the block's columns of V
          tma_load_3d(sv + c * BN * 128, &tv, &v_full[s], blockIdx.z * DV + c * 64, kv0, kvbh);
      }
    }
  } else {  // consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of the block
    const int t = threadIdx.x % WGT, lane = t % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * (t / 32) + g;  // this thread's rows r0, r0 + 8
    const int r1 = r0 + 8;
    float qs0 = 0.f, qs1 = 0.f;
    if constexpr (QUANT) {
      qs0 = r0 < a.N ? a.qs[bh * a.N + r0] : 0.f;
      qs1 = r1 < a.N ? a.qs[bh * a.N + r1] : 0.f;
    }
    const uint8_t* mr0 = MASKED ? mask_row(a, bh, r0) : nullptr;
    const uint8_t* mr1 = MASKED ? mask_row(a, bh, r1) : nullptr;
    const uint8_t* sq = smem + wg * 64 * L::CH;
    uint8_t* kc = smem + L::KC_OFF + wg * L::KC_BYTES;  // e4m3: the tile as fp16
    auto k_stage = [&](int s) { return smem + L::K_OFF + s * L::K_BYTES; };
    auto ks_stage = [&](int s) {
      return reinterpret_cast<const float*>(smem + L::KS_OFF + s * L::KS_BYTES);
    };
    auto v_stage = [&](int s) { return smem + L::V_OFF + s * L::V_BYTES; };
    // tile i's K and V have landed
    auto wait_k = [&](int i) { mbar_wait(&k_full[i % ST], (i / ST) & 1); };
    auto wait_v = [&](int i) { mbar_wait(&v_full[i % ST], (i / ST) & 1); };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float s[NS], o[NDT][4];
    unsigned p[NS / 2];
    float(&of)[DV / 2] = reinterpret_cast<float(&)[DV / 2]>(o);
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;

    mbar_wait(q_full, 0);
    if constexpr (CONV) {  // the warpgroup's 64 rows of Q as fp16
      e4m3_to_f16_rows<D, WGT>(smem + L::QL_OFF + wg * 64 * L::TCH, smem + wg * 64 * 128, 64,
                               BM * 128, BM * 128, t);
      fence_async();
      wg_sync(wg);
    }
    for (int i = 0; i < n_tiles; ++i) {  // tile i: keys from kv0, in stage st
      const int kv0 = (n_tiles - 1 - i) * BN, st = i % ST;
      if constexpr (CONV) {  // the tile as fp16, before this warpgroup's turn
        wait_k(i);
        wg_sync(wg);  // the last tile's Q.K^T has read kc in every warp
        e4m3_to_f16_rows<D, WGT>(k_stage(st), kc, BN, BN * 128, BN * 128, t);
        fence_async();
        wg_sync(wg);
      }
      if (wg == 1 || i > 0) turn_wait(wg);
      wait_k(i);
      issue_qk<D, QKIND>(s, sq, CONV ? kc : k_stage(st));
      if (wg == 0 || i < n_tiles - 1) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      // the edge tiles: the first (KN's ragged end) and, causal, every tile
      // that reaches past the block's first row (two of 64 keys at D 256)
      if (i == 0 || (a.causal && kv0 + BN > q0))
        fix_scores<QKIND, PARTIAL, MASKED, true>(s, ks_stage(st), qs0, qs1, a, kv0, r0, r1, mr0,
                                                 mr1, t4);
      else
        fix_scores<QKIND, PARTIAL, MASKED, false>(s, ks_stage(st), qs0, qs1, a, kv0, r0, r1, mr0,
                                                  mr1, t4);
      release(&k_empty[st]);
      softmax_tile<PARTIAL>(s, m0, m1, l0, l1, al0, al1);
      rescale(o, al0, al1);
      pack_p(p, s);
      wait_v(i);
      issue_pv<D>(of, p, v_stage(st));
      wgmma_wait<0>();
      fence_regs(of);
      fence_regs(p);
      release(&v_empty[st]);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if constexpr (PARTIAL)
      store_partial<D, NDT>(a, bh, r0, r1, t4, o, m0, m1, l0, l1);
    else if (a.out_kind == sdnq::F32)
      store_rows<float, D, NDT>(a, bh, r0, r1, t4, o, l0, l1);
    else if (a.out_kind == sdnq::BF16)
      store_rows<__nv_bfloat16, D, NDT>(a, bh, r0, r1, t4, o, l0, l1);
    else
      store_rows<__half, D, NDT>(a, bh, r0, r1, t4, o, l0, l1);
  }
}

// ---------------------------------------------------------------------------
// int8 P.V, token mode: TMA + s8 wgmma
// ---------------------------------------------------------------------------

constexpr int TBM = 64, TBN = 64;  // query rows of a block, keys of a tile
constexpr int TST = 3;             // stages of K and of V^T (D 256: see TokSmem)
constexpr int TPB = 512;           // the largest P block (attn_p_block)
constexpr int TNT = WGT + 32;      // one consumer warpgroup, then the producer warp

// Shared memory of the token kernel: Q (TBM rows), NST stages of K (TBN
// rows) and of V^T (the block's DV rows of TBN keys, 64-byte swizzle), the
// P block's scores (each thread's accumulator values, TPB keys), its key
// and V scales, in the e4m3 mode the converted K tile, the barriers; e4m3's
// Q as TMA loads it lies in the scores' space (converted before the first
// score is kept).  Rows as in Smem (QB / CH as wgmma reads them, TB / TCH
// as TMA loads them).  NST is TST but at D 256 with 16-bit K rows, where
// one stage fits beside the scores.
template <int D, int QKIND>
struct TokSmem {
  static constexpr int DV = dv_of<D>();
  static constexpr int NST = D == 256 && QKIND != QK_S8 ? 1 : TST;
  static constexpr bool CONV = QKIND == QK_E4M3;
  static constexpr int QB = QKIND == QK_S8 ? D : 2 * D;
  static constexpr int CH = QB < 128 ? QB : 128;
  static constexpr int TB = QKIND == QK_BF16 ? 2 * D : D;
  static constexpr int TCH = TB < 128 ? TB : 128;
  static constexpr int Q_BYTES = TBM * QB, K_BYTES = TBN * TB, V_BYTES = DV * TBN;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + NST * K_BYTES;
  static constexpr int S_OFF = V_OFF + NST * V_BYTES;
  static constexpr int S_BYTES = TBM * TPB * 4;
  static constexpr int SC_OFF = S_OFF + S_BYTES;
  static constexpr int KC_OFF = SC_OFF + 2 * TPB * 4;
  static constexpr int KC_BYTES = CONV ? TBN * QB : 0;
  static constexpr int BAR_OFF = KC_OFF + KC_BYTES;
  static constexpr int QL_OFF = CONV ? S_OFF : 0;  // where TMA writes Q
  static constexpr int BYTES = BAR_OFF + (1 + 4 * NST) * 8 + 1024;
};

// The key held by slot `pos` of V^T.  The s8 wgmma's A operand from
// registers gives thread t (t % 4 = q) of a row the P of slots 4 q .. 4 q +
// 3 of each 16-key half of a k32 step, in one register; the scores'
// accumulator gives it keys 2 q, 2 q + 1, 8 + 2 q, 9 + 2 q of each 16.  V^T's
// slots take the keys in that order within each 16 (the sum over keys is
// exact in int32, so their order is free), and P goes into the A registers
// as it lies, with no shuffle.
__host__ __device__ constexpr int vt_key(int pos) {
  return (pos & ~15) + 2 * ((pos & 15) >> 2) + (pos & 1) + 8 * ((pos >> 1) & 1);
}

// V (BKH, KN, D) int8 -> V^T (BKH, D, KN), its slots in vt_key's order;
// grid (KN / TBN, BKH): a tile of TBN keys through shared memory, rows
// padded by 4 bytes so that a warp's gathers spread over the banks
template <int D>
__global__ void __launch_bounds__(256) flash_attn_vt_kernel(const uint8_t* __restrict__ v,
                                                            uint8_t* __restrict__ vt, int KN) {
  constexpr int LD = D + 4;
  __shared__ __align__(16) uint8_t tile[TBN * LD];
  const int k0 = blockIdx.x * TBN;
  const size_t h = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(v + (h * KN + k0) * D);
  for (int i = threadIdx.x; i < TBN * D / 16; i += 256) {
    const uint4 w = src[i];
    unsigned* dst = reinterpret_cast<unsigned*>(tile + (i / (D / 16)) * LD + (i % (D / 16)) * 16);
    dst[0] = w.x, dst[1] = w.y, dst[2] = w.z, dst[3] = w.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * TBN / 4; i += 256) {  // word w of row d: slots 4 w ..
    const int d = i / (TBN / 4), w = i % (TBN / 4);
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) word |= static_cast<unsigned>(tile[vt_key(4 * w + b) * LD + d]) << (8 * b);
    reinterpret_cast<unsigned*>(vt + (h * D + d) * KN + k0)[w] = word;
  }
}

// S = Q.K^T of the warpgroup's 64 rows (sq) and a tile's TBN keys (sk), both
// K-major: s8 m64n64k32 into S's registers as int32, or bf16 or fp16 (e4m3
// converted) m64n64k16
template <int D, int QKIND>
__device__ __forceinline__ void tok_qk(float (&s)[32], const uint8_t* sq, const uint8_t* sk) {
  using L = TokSmem<D, QKIND>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < L::QB / 32; ++st) {
    const int c = st * 32 / L::CH, step = (st * 32 % L::CH) / 16;
    const uint64_t da = kmajor_desc<L::CH>(sq + c * TBM * L::CH) + step;
    const uint64_t db = kmajor_desc<L::CH>(sk + c * TBN * L::CH) + step;
    if constexpr (QKIND == QK_S8)
      wgmma_s8_64(reinterpret_cast<int(&)[32]>(s), da, db, st != 0);
    else if constexpr (QKIND == QK_E4M3)
      wgmma64_f16(s, da, db, st != 0);
    else
      wgmma64(s, da, db, st != 0);
  }
  wgmma_commit();
}

// the consumer warpgroup's named barrier (barrier 1, its 128 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// B3 / B9 in token mode, and B3 in head mode (a.vhead); grid (ceil(N / TBM),
// BH, D / DV).  Three passes over each P block of pblock keys, in key order: (A)
// Q.K^T of each tile (s8, bf16 or fp16 wgmma; e4m3 converted to fp16
// first), scaled and masked by fix_scores, kept in shared memory, and the
// block's row max; (B) p = ex(s - m_new), l, p_eff = p * vs and its row
// max, p_eff kept in place of s (head mode: p127 = ex(s - (m_new - log2
// 127)) and l alone); (C) P_q = rint(p_eff / p_scale) (head mode: rint(p127))
// into the A registers and the RS s8 wgmma against V^T's tile, into an
// int32 sum for the block, then acc = acc * alpha + sum * p_scale (head
// mode: + sum).
template <int D, int QKIND, bool MASKED, bool PARTIAL>
__global__ void __launch_bounds__(TNT, 1)
    flash_attn_tok_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = TokSmem<D, QKIND>;
  constexpr bool QUANT = QKIND != QK_BF16, CONV = L::CONV;
  constexpr int DV = L::DV, NDT = DV / 8, TST = L::NST;  // stages of each ring
  constexpr int NCH = L::TB / L::TCH;
  // head mode: the token passes with V scales of 1, the log2 127 shift and
  // a p scale of 1 (selects once a P block: the score loops are token
  // mode's; a template flag would double the source's build time)
  const bool head = a.vhead != nullptr;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + TST;
  uint64_t* v_full = k_empty + TST;
  uint64_t* v_empty = v_full + TST;
  const int q0 = blockIdx.x * TBM;
  const size_t bh = blockIdx.y;
  const int kvh = static_cast<int>(kv_head(a, bh));
  const int PB = a.pblock;  // keys per P block: P is quantised once per block
  const int kv_end = kv_stop(a, q0, TBM);
  auto k_stage = [&](int s) { return smem + L::K_OFF + s * L::K_BYTES; };
  auto v_stage = [&](int s) { return smem + L::V_OFF + s * L::V_BYTES; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4);  // one arrive from each consumer warp
      mbar_init(&v_empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WGT) {  // the producer warp: lane 0 issues every load
    if (threadIdx.x != WGT) return;
    constexpr int CE = QUANT ? L::TCH : L::TCH / 2;  // elements of a chunk's row
    mbar_expect_tx(q_full, TBM * L::TB);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load_3d(smem + L::QL_OFF + c * TBM * L::TCH, &tq, q_full, c * CE, q0,
                  static_cast<int>(bh));
    int ik = 0, iv = 0;  // loads issued into the K and the V^T ring
    // wait until a stage is released and its last load has landed, then
    // arm it (the first round passes at once)
    auto arm = [&](uint64_t* full, uint64_t* empty, int i, unsigned bytes) {
      const int s = i % TST;
      const unsigned ph = ((i / TST) & 1) ^ 1;
      mbar_wait(&empty[s], ph);
      if (i >= TST) mbar_wait(&full[s], ph);
      mbar_expect_tx(&full[s], bytes);
      return s;
    };
    auto load_k = [&](int kv0) {
      const int s = arm(k_full, k_empty, ik++, L::K_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(k_stage(s) + c * TBN * L::TCH, &tk, &k_full[s], c * CE, kv0, kvh);
    };
    auto load_v = [&](int kv0) {  // V^T's rows of the block's columns
      const int s = arm(v_full, v_empty, iv++, L::V_BYTES);
      tma_load_3d(v_stage(s), &tv, &v_full[s], kv0, blockIdx.z * DV, kvh);
    };
    // the order in which the consumers take them
    for (int pb0 = 0; pb0 < kv_end; pb0 += PB) {
      const int pend = min(pb0 + PB, kv_end);
      for (int kv0 = pb0; kv0 < pend; kv0 += TBN) load_k(kv0);
      for (int kv0 = pb0; kv0 < pend; kv0 += TBN) load_v(kv0);
    }
    return;
  }

  // the consumer warpgroup: rows q0 .. q0 + 63
  const int t = threadIdx.x, lane = t % 32;
  const int t4 = lane & 3;
  const int r0 = q0 + 16 * (t / 32) + (lane >> 2);  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  float qs0 = 0.f, qs1 = 0.f;
  if constexpr (QUANT) {
    qs0 = r0 < a.N ? a.qs[bh * a.N + r0] : 0.f;
    qs1 = r1 < a.N ? a.qs[bh * a.N + r1] : 0.f;
  }
  const uint8_t* mr0 = MASKED ? mask_row(a, bh, r0) : nullptr;
  const uint8_t* mr1 = MASKED ? mask_row(a, bh, r1) : nullptr;
  float* sks = reinterpret_cast<float*>(smem + L::SC_OFF);  // the block's key scales
  float* svs = sks + TPB;                                   // and V scales
  float4* sS = reinterpret_cast<float4*>(smem + L::S_OFF) + t;  // this thread's scores
  uint8_t* kc = smem + L::KC_OFF;                               // e4m3: the tile as fp16
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float oacc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  int ik = 0, iv = 0;  // tiles taken from the K and the V^T ring
  float s[32];
  // the scores of the tile at kv0 of the block at pb0 (the ik-th K tile)
  // into s: Q.K^T once the tile has landed, its stage released once the
  // products are done, then scaled and masked
  auto scores = [&](int kv0, int pb0) {
    const int st = ik % TST;
    mbar_wait(&k_full[st], (ik / TST) & 1);
    if constexpr (CONV) {
      consumers_sync();  // the last tile's Q.K^T has read kc in every warp
      e4m3_to_f16_rows<D, WGT>(k_stage(st), kc, TBN, TBN * 128, TBN * 128, t);
      fence_async();
      consumers_sync();
    }
    tok_qk<D, QKIND>(s, smem, CONV ? kc : k_stage(st));
    wgmma_wait<0>();
    fence_regs(s);
    release(&k_empty[st]);
    ++ik;
    if (a.causal && kv0 + TBN > q0)  // the tile of the diagonal
      fix_scores<QKIND, PARTIAL, MASKED, true>(s, sks + (kv0 - pb0), qs0, qs1, a, kv0, r0, r1,
                                               mr0, mr1, t4);
    else
      fix_scores<QKIND, PARTIAL, MASKED, false>(s, sks + (kv0 - pb0), qs0, qs1, a, kv0, r0, r1,
                                                mr0, mr1, t4);
  };
  // p = ex(s - m) in place (each step rounded as the plain version's: no
  // contraction with the scores' products)
  auto exp_tile = [&](float mn0, float mn1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = ex<PARTIAL>(__fsub_rn(s[4 * j], mn0));
      s[4 * j + 1] = ex<PARTIAL>(__fsub_rn(s[4 * j + 1], mn0));
      s[4 * j + 2] = ex<PARTIAL>(__fsub_rn(s[4 * j + 2], mn1));
      s[4 * j + 3] = ex<PARTIAL>(__fsub_rn(s[4 * j + 3], mn1));
    }
  };
  // p_eff = p * vs of tile i in place
  auto times_vs = [&](int i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 vs = *reinterpret_cast<const float2*>(svs + i * TBN + 8 * j + 2 * t4);
      s[4 * j] = __fmul_rn(s[4 * j], vs.x);
      s[4 * j + 1] = __fmul_rn(s[4 * j + 1], vs.y);
      s[4 * j + 2] = __fmul_rn(s[4 * j + 2], vs.x);
      s[4 * j + 3] = __fmul_rn(s[4 * j + 3], vs.y);
    }
  };
  auto keep = [&](int i) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      sS[(i * 8 + q) * WGT] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  };
  auto fetch = [&](int i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = sS[(i * 8 + q) * WGT];
      s[4 * q] = v.x, s[4 * q + 1] = v.y, s[4 * q + 2] = v.z, s[4 * q + 3] = v.w;
    }
  };

  mbar_wait(q_full, 0);
  if constexpr (CONV) {  // Q as fp16, where the wgmma reads it
    e4m3_to_f16_rows<D, WGT>(smem + L::QL_OFF, smem, TBM, TBM * 128, TBM * 128, t);
    fence_async();
    consumers_sync();
  }
  const size_t srow = static_cast<size_t>(kvh) * a.KN;  // the head's scales
  for (int pb0 = 0; pb0 < kv_end; pb0 += PB) {
    const int pend = min(pb0 + PB, kv_end), nt = (pend - pb0) / TBN;
    consumers_sync();  // every thread is done with the last block's scales
    for (int c = t; c < pend - pb0; c += WGT) {
      if constexpr (QUANT) sks[c] = a.ks[srow + pb0 + c];
      svs[c] = head ? 1.f : a.vs[srow + pb0 + c];
    }
    consumers_sync();

    // (A) the scores and the block's row max.  (Two tiles' Q.K^T in flight
    // together took ptxas to 255 registers, and the next tile's in flight
    // while this one is fixed made it serialize every wgmma of the kernel,
    // C7515: both measured slower.)
    float mx0 = NEG, mx1 = NEG;
    for (int i = 0; i < nt; ++i) {
      scores(pb0 + i * TBN, pb0);
      keep(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = ex<PARTIAL>(m0 - mn0), al1 = ex<PARTIAL>(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // (B) p, l, p_eff = p * vs and its row max; head mode: p127 (times V
    // scales of 1) and l
    const float hm0 = head ? __fsub_rn(mn0, kLog2_127) : mn0;
    const float hm1 = head ? __fsub_rn(mn1, kLog2_127) : mn1;
    float ps0 = 0.f, ps1 = 0.f, pm0 = 0.f, pm1 = 0.f;
    for (int i = 0; i < nt; ++i) {
      fetch(i);
      exp_tile(hm0, hm1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      times_vs(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pm0 = fmaxf(pm0, fmaxf(s[4 * j], s[4 * j + 1]));
        pm1 = fmaxf(pm1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      keep(i);
    }
    ps0 = quad_sum(ps0);
    ps1 = quad_sum(ps1);
    l0 = __fadd_rn(__fmul_rn(l0, al0), ps0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ps1);
    // head mode: p127 is its own code (scale 1: the quantiser then rounds
    // it, ties to even, and acc adds the sum unscaled)
    const float sc0_ = head ? 1.f : __fdiv_rn(fmaxf(quad_max(pm0), 1e-20f), 127.f);
    const float sc1_ = head ? 1.f : __fdiv_rn(fmaxf(quad_max(pm1), 1e-20f), 127.f);
    const float inv0 = __frcp_rn(sc0_), inv1 = __frcp_rn(sc1_);

    // (C) P_q . V_q over the block's V^T tiles, into an int32 sum; tile i + 1
    // is quantised while tile i's wgmma runs (two sets of A registers)
    int pv[DV / 2] = {};
    // the A registers of tile i's two k32 steps: keys 32 kk + 16 h + .. of row
    // r0 (rr 0) and r1 (rr 1), chunks 4 kk + 2 h and the next
    auto quantize = [&](int i, unsigned (&pa)[2][4]) {
      fetch(i);
      bool near = false;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int b = 4 * (4 * kk + 2 * h) + 2 * rr;
            const float inv = rr ? inv1 : inv0;
            pa[kk][2 * h + rr] = pack4(quant_fast(s[b], inv, near), quant_fast(s[b + 1], inv, near),
                                       quant_fast(s[b + 4], inv, near),
                                       quant_fast(s[b + 5], inv, near));
          }
      if (__any_sync(0xffffffffu, near) && near) {  // a code next to a half-integer
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int b = 4 * (4 * kk + 2 * h) + 2 * rr;
              const float sc = rr ? sc1_ : sc0_;
              pa[kk][2 * h + rr] = pack4(quant_div(s[b], sc), quant_div(s[b + 1], sc),
                                         quant_div(s[b + 4], sc), quant_div(s[b + 5], sc));
            }
      }
    };
    // tile i's wgmmas against its V^T stage (the iv-th), once it has landed
    auto issue_pv = [&](int i, const unsigned (&pa)[2][4]) {
      const int st = iv % TST;
      mbar_wait(&v_full[st], (iv / TST) & 1);
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = sw64_desc(v_stage(st)) + 2 * kk;
        if constexpr (DV == 128)
          wgmma_rs_s8_128(pv, pa[kk], db, i > 0 || kk > 0);
        else
          wgmma_rs_s8_64(pv, pa[kk], db, i > 0 || kk > 0);
      }
      wgmma_commit();
    };
    // the issued wgmmas done: their A registers free, their stage released
    auto retire = [&](unsigned (&pa)[2][4]) {
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(pa[0]);
      fence_regs(pa[1]);
      release(&v_empty[iv % TST]);
      ++iv;
    };
    unsigned qa[2][4], qb[2][4];
    for (int i = 0; i < nt; i += 2) {
      quantize(i, qa);
      if (i > 0) retire(qb);
      issue_pv(i, qa);
      if (i + 1 < nt) {
        quantize(i + 1, qb);
        retire(qa);
        issue_pv(i + 1, qb);
      }
    }
    if (nt & 1)
      retire(qa);
    else
      retire(qb);
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      oacc[dt][0] = __fadd_rn(__fmul_rn(oacc[dt][0], al0), __fmul_rn((float)pv[4 * dt], sc0_));
      oacc[dt][1] = __fadd_rn(__fmul_rn(oacc[dt][1], al0), __fmul_rn((float)pv[4 * dt + 1], sc0_));
      oacc[dt][2] = __fadd_rn(__fmul_rn(oacc[dt][2], al1), __fmul_rn((float)pv[4 * dt + 2], sc1_));
      oacc[dt][3] = __fadd_rn(__fmul_rn(oacc[dt][3], al1), __fmul_rn((float)pv[4 * dt + 3], sc1_));
    }
  }
  if constexpr (PARTIAL)
    store_partial<D, NDT>(a, bh, r0, r1, t4, oacc, m0, m1, l0, l1);
  else if (a.out_kind == sdnq::F32)
    store_rows<float, D, NDT>(a, bh, r0, r1, t4, oacc, l0, l1);
  else if (a.out_kind == sdnq::BF16)
    store_rows<__nv_bfloat16, D, NDT>(a, bh, r0, r1, t4, oacc, l0, l1);
  else
    store_rows<__half, D, NDT>(a, bh, r0, r1, t4, oacc, l0, l1);
}

// The tensor maps' element type and size of q and k: int8 and e4m3 are
// loaded as bytes
constexpr CUtensorMapDataType qk_map_type(int qkind) {
  return qkind == QK_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// B3 / B9 with bf16 P.V: the tensor maps of q (D, N, BH), k and v (D, KN,
// BKH), then the kernel of the mask mode
template <int D, int QKIND, bool PARTIAL>
int launch_wgmma(const Args& a, int BH, int BKH, cudaStream_t st) {
  using L = Smem<D, QKIND>;
  const CUtensorMapDataType qk_type = qk_map_type(QKIND);
  const int es = QKIND == QK_BF16 ? 2 : 1;
  const CUtensorMapSwizzle swz =
      L::TCH == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  if (!tensor_map_3d(&tq, a.q, qk_type, es, D, a.N, BH, L::TCH / es, BM, swz) ||
      !tensor_map_3d(&tk, a.k, qk_type, es, D, a.KN, BKH, L::TCH / es, L::BN, swz) ||
      !tensor_map_3d(&tv, a.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, a.KN, BKH, 64, L::BN,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool masked = a.mask != nullptr;
  auto kernel = masked ? flash_attn_wgmma_kernel<D, QKIND, true, PARTIAL>
                       : flash_attn_wgmma_kernel<D, QKIND, false, PARTIAL>;
  static bool ready[2] = {false, false};  // the block's shared memory is above the 48 KB default
  if (!ready[masked]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[masked] = true;
  }
  const dim3 grid((a.N + BM - 1) / BM, BH, D / L::DV);
  kernel<<<grid, NTW, L::BYTES, st>>>(tq, tk, tv, a);
  return 0;
}

// token and head mode (int8 P.V): V^T into vt (slots in vt_key's order),
// the tensor maps of q (D, N, BH), k (D, KN, BKH) and V^T (KN, D, BKH),
// then the kernel of the mask mode
template <int D, int QKIND, bool PARTIAL>
int launch_tok(const Args& a, void* vt, int BH, int BKH, cudaStream_t st) {
  using L = TokSmem<D, QKIND>;
  flash_attn_vt_kernel<D><<<dim3(a.KN / TBN, BKH), 256, 0, st>>>(a.v, static_cast<uint8_t*>(vt),
                                                                 a.KN);
  const CUtensorMapDataType qk_type = qk_map_type(QKIND);
  const int es = QKIND == QK_BF16 ? 2 : 1;
  const CUtensorMapSwizzle swz =
      L::TCH == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  if (!tensor_map_3d(&tq, a.q, qk_type, es, D, a.N, BH, L::TCH / es, TBM, swz) ||
      !tensor_map_3d(&tk, a.k, qk_type, es, D, a.KN, BKH, L::TCH / es, TBN, swz) ||
      !tensor_map_3d(&tv, vt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.KN, D, BKH, TBN, L::DV,
                     CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool masked = a.mask != nullptr;
  auto kernel = masked ? flash_attn_tok_kernel<D, QKIND, true, PARTIAL>
                       : flash_attn_tok_kernel<D, QKIND, false, PARTIAL>;
  static bool ready[2] = {false, false};  // the block's shared memory is above the 48 KB default
  if (!ready[masked]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[masked] = true;
  }
  const dim3 grid((a.N + TBM - 1) / TBM, BH, D / L::DV);
  kernel<<<grid, TNT, L::BYTES, st>>>(tq, tk, tv, a);
  return 0;
}

template <int D, int QKIND>
int launch(const Args& a, void* vt, int BH, int BKH, cudaStream_t st) {
  if (!a.vs && !a.vhead) return launch_wgmma<D, QKIND, false>(a, BH, BKH, st);
  return launch_tok<D, QKIND, false>(a, vt, BH, BKH, st);
}

// Whether this library holds the kernels of a Q.K^T kind at head dim D
constexpr bool holds(int D, int quant) {
#if defined(SDNQ_FLASH_E4M3)
  return quant == QK_E4M3;
#elif defined(SDNQ_FLASH_D256)
  return quant != QK_E4M3 && D == 256;
#else
  return quant != QK_E4M3 && D != 256;
#endif
}

// B3's kernels of the Q.K^T kinds this library holds at head dim D
template <int D>
int launch_kind(const Args& a, void* vt, int BH, int BKH, int quant, cudaStream_t st) {
  if constexpr (holds(D, QK_E4M3))
    if (quant == QK_E4M3) return launch<D, QK_E4M3>(a, vt, BH, BKH, st);
  if constexpr (holds(D, QK_S8))
    if (quant == QK_S8) return launch<D, QK_S8>(a, vt, BH, BKH, st);
  if constexpr (holds(D, QK_BF16))
    if (quant == QK_BF16) return launch<D, QK_BF16>(a, vt, BH, BKH, st);
  return static_cast<int>(cudaErrorNotSupported);
}

// B9's kernels (D 128 or 256) of the Q.K^T kinds this library holds: token
// mode where a.vs is given, else bf16 P.V
template <int D, int QKIND>
int launch_block(const Args& a, void* vt, int BH, cudaStream_t st) {
  return a.vs ? launch_tok<D, QKIND, true>(a, vt, BH, BH, st)
              : launch_wgmma<D, QKIND, true>(a, BH, BH, st);
}

template <int D>
int launch_block_kind(const Args& a, void* vt, int BH, int quant, cudaStream_t st) {
  if constexpr (holds(D, QK_E4M3))
    if (quant == QK_E4M3) return launch_block<D, QK_E4M3>(a, vt, BH, st);
  if constexpr (holds(D, QK_S8))
    if (quant == QK_S8) return launch_block<D, QK_S8>(a, vt, BH, st);
  if constexpr (holds(D, QK_BF16))
    if (quant == QK_BF16) return launch_block<D, QK_BF16>(a, vt, BH, st);
  return static_cast<int>(cudaErrorNotSupported);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// q (BH, N, D), k (BH / qpk, KN, D): bf16 (quant = 0), int8 (1) or e4m3
// (2); v (BH / qpk, KN, D) bf16, or int8 with vs (BH / qpk, KN) f32 (token
// mode) or with vhead (BH / qpk) f32 (head mode), P quantised per block of
// pblock keys (a multiple of 64 that divides KN, at most 512), and vt (BH /
// qpk, D, KN) int8 scratch for V^T; qs (BH, N), ks (BH / qpk, KN) f32 in
// the int8 and e4m3 modes, else null;
// mask read at b*msb + h*msh + row*msn + key*msk (elements) for head bh =
// b*H + h, or null: bool (mask_kind 1), or an additive bf16 (2) or fp32 (3)
// mask; causal 0/1; out (BH, N, D) of out_kind.
// D is 64, 128 or 256; KN >= 1; qpk divides H and H divides BH; q, k, v
// 16-byte aligned.
extern "C" int sdnq_flash_attn(const void* q, const void* k, const void* v, const void* qs,
                               const void* ks, const void* vs, const void* vhead, const void* mask,
                               long long msb, long long msh, long long msn, long long msk,
                               void* out, void* vt, int BH, int N, int KN, int D, int H, int qpk,
                               int causal, int pblock, int quant, int mask_kind, int out_kind,
                               void* stream) {
  if (KN < 1 || (D != 64 && D != 128 && D != 256) || H < 1 || qpk < 1 || H % qpk || BH % H)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask && (mask_kind < MASK_BOOL || mask_kind > MASK_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((vs && vhead) || quant < QK_BF16 || quant > QK_E4M3 || (quant != QK_BF16 && (!qs || !ks)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((vs || vhead) && (pblock < TBN || pblock > TPB || pblock % TBN || KN % pblock || !vt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind < sdnq::F32 || out_kind > sdnq::F16 || misaligned(q) || misaligned(k) ||
      misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
         static_cast<const uint8_t*>(v), static_cast<const float*>(qs),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const uint8_t*>(mask), msb, msh, msn, msk, mask_kind, out, N, KN, H, qpk,
         causal, pblock, nullptr, nullptr, 1.f, out_kind, static_cast<const float*>(vhead)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BKH = BH / qpk;
  const int rc = D == 64    ? launch_kind<64>(a, vt, BH, BKH, quant, st)
                 : D == 128 ? launch_kind<128>(a, vt, BH, BKH, quant, st)
                            : launch_kind<256>(a, vt, BH, BKH, quant, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// B9: q (BH, N, D), k (BH, KN, D), D 128 or 256: bf16 (quant = 0, the
// score times sm_scale), or int8 (quant = 1) or e4m3 (2) with qs (BH, N)
// carrying sm_scale and ks (BH, KN); v (BH, KN, D) bf16, or int8 with vs
// (BH, KN) (token mode, P quantised per block of pblock keys, as above,
// V^T in the scratch vt (BH, D, KN) int8); mask null, or (mask_heads, N,
// KN) read at (bh % mask_heads)*msh + row*msn + key*msk (elements), bool
// (mask_kind 1) or additive bf16 (2) / fp32 (3), mask_heads dividing BH;
// q, k, v 16-byte aligned.  Writes acc (BH, N, D) and m, l (BH, N), all
// fp32.
extern "C" int sdnq_flash_attn_block(const void* q, const void* k, const void* v, const void* qs,
                                     const void* ks, const void* vs, const void* mask,
                                     long long msh, long long msn, long long msk, void* acc,
                                     void* m, void* l, void* vt, int BH, int N, int KN, int D,
                                     int mask_heads, int pblock, int quant, int mask_kind,
                                     float sm_scale, void* stream) {
  if (KN < 1 || (D != 128 && D != 256) || mask_heads < 1 || BH % mask_heads || quant < QK_BF16 ||
      quant > QK_E4M3 || (quant != QK_BF16 && (!qs || !ks)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask && (mask_kind < MASK_BOOL || mask_kind > MASK_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vs && (pblock < TBN || pblock > TPB || pblock % TBN || KN % pblock || !vt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(q) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorInvalidValue);
  // H = mask_heads, one query head per KV head: row bh reads KV head bh and
  // mask head bh % mask_heads (mask_row with b = bh / H, h = bh % H, msb 0)
  Args a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
         static_cast<const uint8_t*>(v), static_cast<const float*>(qs),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const uint8_t*>(mask), 0, msh, msn, msk, mask_kind, acc, N, KN, mask_heads,
         1, 0, pblock, static_cast<float*>(m), static_cast<float*>(l), sm_scale, sdnq::F32,
         nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = D == 128 ? launch_block_kind<128>(a, vt, BH, quant, st)
                          : launch_block_kind<256>(a, vt, BH, quant, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
