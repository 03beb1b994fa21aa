// B3: flash attention, online softmax in base 2.
//
//   out[b, i] = sum_j p_ij v[b, j] / sum_j p_ij,  p_ij = exp2(s_ij - max_j s_ij)
//   bf16 mode:  s = q . k  with q already scaled by sm_scale * log2(e)
//   int8 mode:  s = (q_q . k_q) * qs[i] * ks[j], qs carrying sm_scale * log2(e)
//
// Replaces sdnq_tpu/kernels/attention.py `_attn_kernel` (:67, wrapper
// `_attn_pallas` :192) in its unquantized (bf16 QK) and int8-QK modes, with
// bf16 P.V, no mask, not causal, one KV head per query head.  The KV tail
// past KN is masked with -1e30 as the JAX kernel masks KV padding.
//
// At FLUX's shape (24 heads, N = 4608, D = 128) attention is bound by
// tensor-core operations (4*N^2*D per head).  One block of 8 warps takes
// 128 query rows of one (batch*head); each warp keeps its 16 rows of Q as
// mma A fragments in registers and walks the KV sequence in 64-key tiles
// staged in padded shared memory by cp.async (K and V in two copy groups,
// so V lands while Q.K^T runs).  S = Q.K^T comes from mma.sync (bf16 m16n8k16
// or s8 m16n8k32), the running max / sum use exp2f, P is rounded to bf16 in
// registers and reused directly as the A fragment of P.V, whose B fragment
// is read with ldmatrix.trans.  The (N, KN) score matrix never reaches
// device memory.  Pipelined TMA/wgmma versions are later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8, NT = WARPS * 32, BQ = WARPS * 16, BKV = 64;
constexpr float NEG = -1e30f;

template <int D, bool QUANT, typename OutT>
__global__ void __launch_bounds__(NT)
    flash_attn_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ qs,
                      const float* __restrict__ ks, OutT* __restrict__ out, int N, int KN) {
  constexpr int QB = QUANT ? D : 2 * D;  // bytes per Q / K row
  constexpr int LDK = QB + 16;           // padded K row in shared memory
  constexpr int LDV = 2 * D + 16;        // padded V row in shared memory
  constexpr int KSTEPS = QB / 32;        // mma K steps over the head dim
  constexpr int NDT = D / 8;             // n8 tiles of the output
  __shared__ __align__(16) uint8_t sK[BKV * LDK];
  __shared__ __align__(16) uint8_t sV[BKV * LDV];
  __shared__ float sKs[BKV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.y;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;

  // Q fragments straight from global memory (read once per block).
  unsigned qf[KSTEPS][4];
  {
    const uint8_t* q0 = q + (bh * N + r0) * (size_t)QB;
    const uint8_t* q1 = q + (bh * N + r1) * (size_t)QB;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const int c = s * 32 + t4 * 4;
      qf[s][0] = r0 < N ? *reinterpret_cast<const unsigned*>(q0 + c) : 0u;
      qf[s][1] = r1 < N ? *reinterpret_cast<const unsigned*>(q1 + c) : 0u;
      qf[s][2] = r0 < N ? *reinterpret_cast<const unsigned*>(q0 + c + 16) : 0u;
      qf[s][3] = r1 < N ? *reinterpret_cast<const unsigned*>(q1 + c + 16) : 0u;
    }
  }
  float qs0 = 0.f, qs1 = 0.f;
  if (QUANT) {
    qs0 = r0 < N ? qs[bh * N + r0] : 0.f;
    qs1 = r1 < N ? qs[bh * N + r1] : 0.f;
  }

  float o_acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) o_acc[i][0] = o_acc[i][1] = o_acc[i][2] = o_acc[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  const uint8_t* kbase = k + bh * (size_t)KN * QB;
  const uint8_t* vbase = reinterpret_cast<const uint8_t*>(v) + bh * (size_t)KN * (2 * D);

  for (int kv0 = 0; kv0 < KN; kv0 += BKV) {
    // stage K and V tiles (two cp.async groups); rows past KN are zeros
    for (int c = tid; c < BKV * QB / 16; c += NT) {
      const int r = c / (QB / 16), cb = (c % (QB / 16)) * 16;
      const bool ok = kv0 + r < KN;
      sdnq::cp_async16(sK + r * LDK + cb, kbase + (size_t)(ok ? kv0 + r : 0) * QB + cb, ok);
    }
    sdnq::cp_async_commit();
    for (int c = tid; c < BKV * 2 * D / 16; c += NT) {
      const int r = c / (2 * D / 16), cb = (c % (2 * D / 16)) * 16;
      const bool ok = kv0 + r < KN;
      sdnq::cp_async16(sV + r * LDV + cb, vbase + (size_t)(ok ? kv0 + r : 0) * (2 * D) + cb, ok);
    }
    sdnq::cp_async_commit();
    if (QUANT && tid < BKV) sKs[tid] = kv0 + tid < KN ? ks[bh * KN + kv0 + tid] : 0.f;
    sdnq::cp_async_wait<1>();
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows x 64 keys
    float s[BKV / 8][4];
    {
      using AccT = typename std::conditional<QUANT, int, float>::type;
      AccT sacc[BKV / 8][4];
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st)
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt) {
          const uint8_t* p = sK + (nt * 8 + g) * LDK + st * 32 + t4 * 4;
          const unsigned b[2] = {*reinterpret_cast<const unsigned*>(p),
                                 *reinterpret_cast<const unsigned*>(p + 16)};
          if constexpr (QUANT)
            sdnq::mma_s8(sacc[nt], qf[st], b);
          else
            sdnq::mma_bf16(sacc[nt], qf[st], b);
        }
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + t4 * 2 + (i & 1);
          float x = static_cast<float>(sacc[nt][i]);
          if (QUANT) x = (x * (i < 2 ? qs0 : qs1)) * sKs[col];
          s[nt][i] = kv0 + col < KN ? x : NEG;
        }
    }

    // online softmax (rows r0: entries 0,1; r1: entries 2,3)
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      o_acc[dt][0] *= al0;
      o_acc[dt][1] *= al0;
      o_acc[dt][2] *= al1;
      o_acc[dt][3] *= al1;
    }

    sdnq::cp_async_wait<0>();
    __syncthreads();

    // O += P . V ; the S accumulator layout is the A fragment layout of P
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const unsigned a[4] = {sdnq::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             sdnq::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             sdnq::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             sdnq::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint8_t* vrow = sV + (kk * 16 + (lane & 15)) * LDV;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        unsigned b[2];
        sdnq::ldmatrix_x2_trans(b[0], b[1], vrow + dt * 16);
        sdnq::mma_bf16(o_acc[dt], a, b);
      }
    }
    __syncthreads();
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  OutT* o0 = out + (bh * N + r0) * (size_t)D;
  OutT* o1 = out + (bh * N + r1) * (size_t)D;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < N) {
      o0[c] = sdnq::from_f32<OutT>(__fdiv_rn(o_acc[dt][0], d0));
      o0[c + 1] = sdnq::from_f32<OutT>(__fdiv_rn(o_acc[dt][1], d0));
    }
    if (r1 < N) {
      o1[c] = sdnq::from_f32<OutT>(__fdiv_rn(o_acc[dt][2], d1));
      o1[c + 1] = sdnq::from_f32<OutT>(__fdiv_rn(o_acc[dt][3], d1));
    }
  }
}

template <int D, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* qs, const float* ks,
           void* out, int BH, int N, int KN, int out_kind, cudaStream_t st) {
  const dim3 grid((N + BQ - 1) / BQ, BH);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const uint8_t* kp = static_cast<const uint8_t*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  if (out_kind == sdnq::F32)
    flash_attn_kernel<D, QUANT, float>
        <<<grid, NT, 0, st>>>(qp, kp, vp, qs, ks, static_cast<float*>(out), N, KN);
  else if (out_kind == sdnq::BF16)
    flash_attn_kernel<D, QUANT, __nv_bfloat16>
        <<<grid, NT, 0, st>>>(qp, kp, vp, qs, ks, static_cast<__nv_bfloat16*>(out), N, KN);
  else if (out_kind == sdnq::F16)
    flash_attn_kernel<D, QUANT, __half>
        <<<grid, NT, 0, st>>>(qp, kp, vp, qs, ks, static_cast<__half*>(out), N, KN);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// q (BH, N, D), k (BH, KN, D): bf16 (quant = 0) or int8 (quant = 1);
// v (BH, KN, D) bf16; qs (BH, N), ks (BH, KN) f32 in int8 mode, else null;
// out (BH, N, D) of out_kind.  D is 64 or 128; KN >= 1.
extern "C" int sdnq_flash_attn(const void* q, const void* k, const void* v, const void* qs,
                               const void* ks, void* out, int BH, int N, int KN, int D,
                               int quant, int out_kind, void* stream) {
  if (KN < 1 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  const float* qsp = static_cast<const float*>(qs);
  const float* ksp = static_cast<const float*>(ks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (D == 64)
    rc = quant ? launch<64, true>(q, k, v, qsp, ksp, out, BH, N, KN, out_kind, st)
               : launch<64, false>(q, k, v, qsp, ksp, out, BH, N, KN, out_kind, st);
  else
    rc = quant ? launch<128, true>(q, k, v, qsp, ksp, out, BH, N, KN, out_kind, st)
               : launch<128, false>(q, k, v, qsp, ksp, out, BH, N, KN, out_kind, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
