// B6: weight-only group-dot GEMV for a few rows on half-split packed codes.
//
//   y[m, o] = sum_g scale[o, g] * (x_g[m] . c_g[o]) + xsum[m, g] * zpc[o, g]
//             (+ bias[o])
//
// the same function as B5 (kernels/dequant_mm.py explains the layout
// and zpc), for M <= 8 rows, on codes of 1 to 7 bits: integers (raw codes;
// zpc carries code_min) or minifloats (their values; zpc the zero point
// alone).  Replaces sdnq_tpu/kernels/dequant_mm.py `_blockdiag_kernel`
// (:593, wrapper `_blockdiag_mm_pallas` :655).  The TPU kernel expands x
// block-diagonally so that one matrix-unit dot yields every group's
// partial; on the H100 the product at M = 1 is a GEMV bound by the bytes of
// the packed weight (O * K * BITS / 8: 28.3 MB for the FLUX.1-dev 3072 ->
// 18432 modulation linear at 4 bits, 8.5 us at 3.35 TB/s), so it is written
// as a stream of those bytes:
//  - a code's BITS lie in half-split field planes (sdnq_tpu/packing.py
//    halfsplit_planes): plane p of width w holds its fields of code k in
//    byte k % seg_p; with S = K / pmax (the narrowest plane's segment), the
//    bytes at S * i + q (i < BITS * pmax / 8, q < S) hold every field of
//    the pmax codes q + S * j.  A lane takes 8 positions q .. q + 7 (a
//    "unit") of a row and reads one 8-byte word at each S * i + q, so every
//    byte of the weight is read once, warp-wide in runs of 256 bytes;
//  - a group of 8, 16 or 32 lanes owns R = 2 rows, so each x value a lane
//    reads serves both (the group's width is the one that leaves the
//    fewest lanes idle over a row's units); a lane takes UN units an
//    iteration (4 for one-plane codes, whose unit is one word, else 1) and
//    loads the next iteration's words before it decodes these, so 8 (one
//    plane) to 14 (three) loads a lane are in flight;
//  - a plane's fields are cut out of four codes at once (a code a byte);
//  - x is staged once a block for the whole K in its own type (bf16 stays
//    bf16) where it fits in XS_MAX bytes, else read through the L1 cache;
//  - minifloat codes decode through a table of their 2^BITS values (built
//    on the host by the port's decode_float) in shared memory, integer
//    codes through the fp32 magic number 2^23: each code is decoded once,
//    for all M rows of x;
//  - each unit's codes of one j lie in one group (8 | g and 8 | S): its dot
//    is weighted by the group's scale and its x sum by the group's zpc
//    (both read through L1: once per group a row from device memory);
//  - the blocks persist, as many as fit on the card, and each warp walks
//    its row pairs; the lanes' sums are reduced across the warp at the end
//    of a row pair (across the group's lanes) and the bias added.
// The sums are fp32 in another order than the plain version's (FMA).
#include "common.cuh"

namespace {

constexpr int WARPS = 8, NT = WARPS * 32, R = 2;  // R: rows a lane group
constexpr int XS_MAX = 96 * 1024;                 // bytes of x staged in shared memory
constexpr int TAB_BYTES = 512;                    // the minifloat table, 2^7 floats

// The half-split planes of a BITS-wide code (the set bits of BITS in
// {4, 2, 1}, most significant first): width, the value of the lower
// planes' bits (shift), words a unit (f = pmax * width / 8: the
// plane's segment is f * S bytes) and the first of them (off, in S).
template <int BITS>
struct Planes {
  static constexpr int NP = (BITS & 1) + ((BITS >> 1) & 1) + ((BITS >> 2) & 1);
  static constexpr int WMIN = (BITS & 1) ? 1 : (BITS & 2) ? 2 : 4;
  static constexpr int PMAX = 8 / WMIN;  // codes a byte of the narrowest plane
  static constexpr int W = PMAX * BITS / 8;  // words a unit
  static constexpr int UN = W == 1 ? 4 : 1;  // units a lane an iteration
  __host__ __device__ static constexpr int width(int p) {
    int seen = 0;
    for (int w = 4; w >= 1; w >>= 1)
      if (BITS & w) {
        if (seen == p) return w;
        ++seen;
      }
    return 0;
  }
  __host__ __device__ static constexpr int shift(int p) { return BITS & (width(p) - 1); }
  __host__ __device__ static constexpr int f(int p) { return PMAX * width(p) / 8; }
  __host__ __device__ static constexpr int off(int p) { return p == 0 ? 0 : off(p - 1) + f(p - 1); }
};

struct B6Args {
  const void* x;         // (M, K) of XT
  const uint8_t* w;      // (O, K * BITS / 8) half-split
  const float* scale;    // (O, G)
  const float* zpc;      // (O, G)
  const float* bias;     // (O,) or null
  const float* table;    // (2^BITS,) minifloat values, or null
  void* out;             // (M, O) of out_kind
  int M, K, O, G, g;
  unsigned ginv;         // floor((2^32 - 1) / g), for sdnq::div_magic
  int out_kind, stage;   // stage: x is copied into shared memory
  int lanes;             // lanes a row pair: 8, 16 or 32
};

// the 8 codes e = 0 .. 7 of unit word set `wv` at field j, decoded: each
// plane's fields of four codes at once (one code a byte: shifted left by
// the lower planes' width, a field stays inside its byte), then a byte a
// code into its value
template <int BITS, bool TABLE, int J>
__device__ __forceinline__ void decode8(const uint2 (&wv)[Planes<BITS>::W], const float* tab,
                                        float (&cf)[8]) {
  using H = Planes<BITS>;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned c4 = 0;
#pragma unroll
    for (int p = 0; p < H::NP; ++p) {
      const int i = J % H::f(p), t = J / H::f(p);
      const unsigned word = half ? wv[H::off(p) + i].y : wv[H::off(p) + i].x;
      const unsigned mask = ((1u << H::width(p)) - 1u) * 0x01010101u;
      c4 |= ((word >> (H::width(p) * t)) & mask) << H::shift(p);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (TABLE)
        cf[4 * half + e] = tab[(c4 >> (8 * e)) & 0xFFu];
      else  // 2^23 + code, exact, less 2^23
        cf[4 * half + e] =
            __fsub_rn(__uint_as_float(__byte_perm(c4, 0x4B000000u, 0x7440u | e)), 8388608.f);
    }
  }
}

// 8 consecutive x values from p (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store_out(void* out, int kind, size_t i, float v) {
  if (kind == sdnq::F32)
    static_cast<float*>(out)[i] = v;
  else if (kind == sdnq::BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(v);
}

// A lane's words of UN units (u = (ui UN + v) L + sub) of rows R rg ..
// R rg + R - 1: W 8-byte loads a unit and row, S bytes apart (zeros past
// the row's units or the last row)
template <int BITS, int UN = Planes<BITS>::UN, int W = Planes<BITS>::W>
__device__ __forceinline__ void load_words(uint2 (&wv)[UN][R][W], const B6Args& a, int rg, int ui,
                                           int L, int sub, int S, int U, size_t wrow) {
#pragma unroll
  for (int v = 0; v < UN; ++v) {
    const int u = (ui * UN + v) * L + sub;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = rg * R + r;
      const bool ok = u < U && o < a.O;
      const uint8_t* p = a.w + (ok ? (size_t)o * wrow + 8 * u : 0);
#pragma unroll
      for (int i = 0; i < W; ++i)
        wv[v][r][i] = ok ? __ldg(reinterpret_cast<const uint2*>(p + (size_t)S * i)) : make_uint2(0, 0);
    }
  }
}

// The codes of field J (k = S J + 8 u + 0 .. 7) of a unit of both rows,
// times x, into acc; then field J + 1.  J is a constant in each step, so
// the words stay in registers.
template <int BITS, bool TABLE, typename XT, int MT, int J>
__device__ __forceinline__ void unit_fields(const uint2 (&wv)[R][Planes<BITS>::W], const B6Args& a,
                                            const XT* __restrict__ xp, const float* tab, int u,
                                            int rg, int S, float (&acc)[R][MT]) {
  if constexpr (J < Planes<BITS>::PMAX) {
    const int k0 = S * J + 8 * u;
    const int gi = sdnq::div_magic(k0, a.g, a.ginv);  // one group: 8 | g, 8 | S
    float cf[R][8], sc[R], z[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      decode8<BITS, TABLE, J>(wv[r], tab, cf[r]);
      const int o = min(rg * R + r, a.O - 1);
      sc[r] = __ldg(a.scale + (size_t)o * a.G + gi);
      z[r] = __ldg(a.zpc + (size_t)o * a.G + gi);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < a.M) {
        float xv[8];
        load8(xp + (size_t)m * a.K + k0, xv);
        float xsum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) xsum += xv[e];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(xv[e], cf[r][e], s);
          acc[r][m] = fmaf(s, sc[r], acc[r][m]);
          acc[r][m] = fmaf(xsum, z[r], acc[r][m]);
        }
      }
    }
    unit_fields<BITS, TABLE, XT, MT, J + 1>(wv, a, xp, tab, u, rg, S, acc);
  }
}

template <int BITS, bool TABLE, typename XT, int MT>
__global__ void __launch_bounds__(NT, MT == 1 ? 3 : 2) blockdiag_mm_kernel(const B6Args a) {
  using H = Planes<BITS>;
  constexpr int W = H::W, PMAX = H::PMAX, UN = H::UN;
  extern __shared__ __align__(16) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem);
  XT* xs = reinterpret_cast<XT*>(smem + TAB_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = a.M, K = a.K, O = a.O;

  if constexpr (TABLE)
    for (int i = threadIdx.x; i < (1 << BITS); i += NT) tab[i] = a.table[i];
  const XT* xp = static_cast<const XT*>(a.x);
  if (a.stage) {  // 16-byte pieces: K * sizeof(XT) is a multiple of 16
    const int n = M * K * (int)sizeof(XT) / 16;
    for (int i = threadIdx.x; i < n; i += NT)
      reinterpret_cast<uint4*>(xs)[i] = reinterpret_cast<const uint4*>(xp)[i];
    xp = xs;
  }
  __syncthreads();

  // the warp's lanes in groups of L, each group a row pair; a lane takes
  // units sub, sub + L, .. of its pair's rows
  const int L = a.lanes, grp = lane / L, sub = lane % L;
  const int S = K / PMAX, U = S / 8;  // positions and units a row
  const int ipr = (U + L * UN - 1) / (L * UN);  // iterations a row pair
  const size_t wrow = (size_t)K * BITS / 8;
  const int nrg = (O + R - 1) / R, step = gridDim.x * WARPS * (32 / L);

  uint2 cur[UN][R][W], nxt[UN][R][W];
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
  // rw: the warp's first row pair (its lanes' loop stays in step: the
  // reductions below take every lane); rg: this lane's
  int rw = (blockIdx.x * WARPS + warp) * (32 / L), ui = 0;
  if (rw < nrg) load_words<BITS>(cur, a, rw + grp, 0, L, sub, S, U, wrow);
  while (rw < nrg) {
    const int rg = rw + grp;
    int rw2 = rw, ui2 = ui + 1;
    if (ui2 == ipr) ui2 = 0, rw2 += step;
    if (rw2 < nrg)  // in flight while these decode
      load_words<BITS>(nxt, a, rw2 + grp, ui2, L, sub, S, U, wrow);
#pragma unroll
    for (int v = 0; v < UN; ++v) {
      const int u = (ui * UN + v) * L + sub;
      if (u < U) unit_fields<BITS, TABLE, XT, MT, 0>(cur[v], a, xp, tab, u, rg, S, acc);
    }

    if (ui == ipr - 1) {  // the row pair's last iteration: reduce, store
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = rg * R + r;
        const float b = a.bias && o < O ? a.bias[o] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < M) {
            float s = acc[r][m];
            for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (sub == 0 && o < O) store_out(a.out, a.out_kind, (size_t)m * O + o, s + b);
          }
          acc[r][m] = 0.f;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < UN; ++v)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < W; ++i) cur[v][r][i] = nxt[v][r][i];
    rw = rw2, ui = ui2;
  }
}

template <int BITS, bool TABLE, typename XT, int MT>
int launch(const B6Args& a, cudaStream_t st) {
  auto kern = blockdiag_mm_kernel<BITS, TABLE, XT, MT>;
  const int smem = TAB_BYTES + (a.stage ? a.M * a.K * (int)sizeof(XT) : 0);
  static bool big = false;  // above the 48 KB default, once
  if (smem > 48 * 1024 && !big) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TAB_BYTES + XS_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    big = true;
  }
  static int occ_smem = -1, occ = 0;  // blocks an SM at the last size
  if (smem != occ_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    occ_smem = smem;
  }
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long need = ((a.O + R - 1) / R + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * (occ > 0 ? occ : 1);
  kern<<<static_cast<int>(need < cap ? need : cap), NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, bool TABLE>
int launch_types(const B6Args& a, int x_kind, cudaStream_t st) {
  const bool one = a.M == 1;
  if (x_kind == sdnq::F32)
    return one ? launch<BITS, TABLE, float, 1>(a, st) : launch<BITS, TABLE, float, 8>(a, st);
  if (x_kind == sdnq::BF16)
    return one ? launch<BITS, TABLE, __nv_bfloat16, 1>(a, st)
               : launch<BITS, TABLE, __nv_bfloat16, 8>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool TABLE>
int launch_bits(int bits, const B6Args& a, int x_kind, cudaStream_t st) {
  switch (bits) {
    case 1: return launch_types<1, TABLE>(a, x_kind, st);
    case 2: return launch_types<2, TABLE>(a, x_kind, st);
    case 3: return launch_types<3, TABLE>(a, x_kind, st);
    case 4: return launch_types<4, TABLE>(a, x_kind, st);
    case 5: return launch_types<5, TABLE>(a, x_kind, st);
    case 6: return launch_types<6, TABLE>(a, x_kind, st);
    case 7: return launch_types<7, TABLE>(a, x_kind, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// every entry's checks: 1 <= M <= 8; 8 divides g and the narrowest plane's
// segment K / pmax; x 16-byte and the codes 8-byte aligned
int run(const void* x, const void* w, const void* scale, const void* zpc, const void* bias,
        const void* table, void* out, int M, int K, int O, int g, int bits, int x_kind,
        int out_kind, void* stream) {
  const int pmax = (bits & 1) ? 8 : (bits & 2) ? 4 : 2;
  const auto off = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n != 0; };
  if (bits < 1 || bits > 7 || M < 1 || M > 8 || O < 0 || K < 1 || g <= 0 || K % g != 0 ||
      g % 8 != 0 || K % pmax != 0 || (K / pmax) % 8 != 0 || off(x, 16) || off(w, 8) ||
      (out_kind != sdnq::F32 && out_kind != sdnq::BF16 && out_kind != sdnq::F16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (O == 0) return 0;
  const int esize = x_kind == sdnq::F32 ? 4 : 2;
  // lanes a row pair: the fewest idle lanes over a row's units (U = K /
  // pmax / 8, UN a lane an iteration), the widest group on a tie
  const int words = pmax * bits / 8, un = words == 1 ? 4 : 1, units = K / pmax / 8;
  int lanes = 32, waste = 1 << 30;
  for (int l = 32; l >= 8; l /= 2) {
    const int span = l * un, w = (units + span - 1) / span * span - units;
    if (w < waste) waste = w, lanes = l;
  }
  const B6Args a{x, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
                 static_cast<const float*>(zpc), static_cast<const float*>(bias),
                 static_cast<const float*>(table), out, M, K, O, K / g, g,
                 0xFFFFFFFFu / static_cast<unsigned>(g), out_kind,
                 (long long)M * K * esize <= XS_MAX, lanes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table ? launch_bits<true>(bits, a, x_kind, st) : launch_bits<false>(bits, a, x_kind, st);
}

}  // namespace

// x (M, K) contiguous of x_kind (f32 or bf16); w (O, K*bits/8) half-split
// uint8; scale, zpc (O, K/g) f32; bias (O,) f32 or null; out (M, O) of
// out_kind.  1 <= M <= 8; bits 1, 2 or 4 (integer codes); 8 divides g and
// g divides the field segment K*bits/8.
extern "C" int sdnq_blockdiag_mm(const void* x, const void* w, const void* scale, const void* zpc,
                                 const void* bias, void* out, int M, int K, int O, int g, int bits,
                                 int x_kind, int out_kind, void* stream) {
  if ((bits != 1 && bits != 2 && bits != 4) || g <= 0 || (K * bits / 8) % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(x, w, scale, zpc, bias, nullptr, out, M, K, O, g, bits, x_kind, out_kind, stream);
}

// B6's general mode: x (M, K) of x_kind (f32 or bf16); w (O, K*bits/8)
// half-split uint8 of `bits` (1..7) bits; integer codes (table null: raw
// codes) or minifloat codes (table: the format's 2^bits values, f32);
// scale, zpc (O, K/g) f32; bias (O,) f32 or null; out (M, O) of out_kind
// (f32 or bf16).  1 <= M <= 8; 8 divides g and the narrowest plane's
// segment.
extern "C" int sdnq_blockdiag_mm_gen(const void* x, const void* w, const void* scale,
                                     const void* zpc, const void* bias, const void* table,
                                     void* out, int M, int K, int O, int g, int bits, int x_kind,
                                     int out_kind, void* stream) {
  if (out_kind == sdnq::F16) return static_cast<int>(cudaErrorInvalidValue);
  return run(x, w, scale, zpc, bias, table, out, M, K, O, g, bits, x_kind, out_kind, stream);
}
