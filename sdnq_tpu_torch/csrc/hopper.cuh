// Hopper (sm_90a) building blocks of the TMA + wgmma kernels
// (csrc/wgmma_mm.cu, csrc/scaled_mm.cu, csrc/scaled_mm_tn.cu,
// csrc/flash_attn.cu) and of the GEMV's weight stream (csrc/dequant_gemv.cu):
// mbarriers whose waits trap, TMA loads through 2- and 3-D tensor maps and
// bulk copies, shared-memory matrix descriptors (K-major in the 128-
// and 64-byte swizzles, and MN-major "transposed" operands of row-major
// tiles), the wgmma wrappers, the persistent GEMMs' producer loops (and the
// one for operands contracted along their rows), tile store and tile-size
// rule, the 8-bit transposer and the e4m3-to-fp16 conversion in shared
// memory, and the host's tensor-map encoder.
//
// A barrier wait that lasts longer than TRAP_CYCLES (over 30 s) traps: the
// launch fails and the next synchronising call raises, where a broken
// barrier would otherwise hold the card.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace sdnq {

constexpr long long TRAP_CYCLES = 1ll << 36;

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sdnq::smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sdnq::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sdnq::smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try(unsigned addr, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = sdnq::smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > TRAP_CYCLES) __trap();
}

// ---- TMA -------------------------------------------------------------------
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sdnq::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sdnq::smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(sdnq::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sdnq::smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory by the TMA unit, counted
// on `bar` (the GEMV's weight stream, csrc/dequant_gemv.cu).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          sdnq::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(sdnq::smem_addr(bar))
      : "memory");
}

// ---- descriptors and wgmma --------------------------------------------------
// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (as TMA writes it): start >> 4, leading offset 16 bytes
// (unused), 1024 bytes between groups of 8 rows, layout 1 (SWIZZLE_128B).
// The tile starts on a 1024-byte boundary; +2 advances 16 bf16 along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = sdnq::smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The same for 64-byte rows in the 64-byte swizzle: 512 bytes between
// groups of 8 rows, layout 2 (SWIZZLE_64B); +2 advances 32 bytes along K.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  const uint64_t a = sdnq::smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// Descriptor of an MN-major ("transposed") B operand in the 128-byte
// swizzle: B (N x K) stored K-row by K-row, each row 64 N values (128 bytes)
// wide, as TMA writes a row-major tile whose rows are the K index (V's
// keys).  1024 bytes between groups of 8 K rows, `lbo` bytes between the
// 64-wide column chunks of N; +128 advances 16 K rows.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p, unsigned lbo) {
  const uint64_t a = sdnq::smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma's fences and waits
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(unsigned (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D(64 x 128, f32) (+)= A(64 x 16, bf16) * B(128 x 16, bf16)ᵀ; D is
// overwritten where scale_d is 0.  Thread t of the warpgroup holds, for
// each 8-column chunk j, d[4j], d[4j+1] at row 16 (t / 32) + (t % 32) / 4,
// columns 8j + 2 (t % 4) + {0, 1}, and d[4j+2], d[4j+3] 8 rows below.
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B 256 x 16 and D 64 x 256: 32 chunks of 8 columns, d[4j ..]
// as above (A read once for both halves of a 128 x 256 tile).
__device__ __forceinline__ void wgmma256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

// wgmma256 with fp16 operands.
__device__ __forceinline__ void wgmma256_f16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

// D(64 x 128, s32) (+)= A(64 x 32, s8) * B(128 x 32, s8)ᵀ, both K-major (the
// only layout of 8-bit operands); D is overwritten where scale_d is 0.  The
// fragment layout of D is wgmma128's.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 256, s32) += A(64 x 32, s8) * B(256 x 32, s8)ᵀ, both K-major; D's
// layout is wgmma256's.
__device__ __forceinline__ void wgmma_s8_256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db));
}

// wgmma128 with fp16 operands.
__device__ __forceinline__ void wgmma128_f16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma128_f16 with A K-major (sw128_desc) and B MN-major (trans-b; its
// descriptor from sw128_desc_mn).
__device__ __forceinline__ void wgmma128_f16_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, 1, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// wgmma128_f16 with both operands MN-major (trans-a and trans-b; each
// descriptor from sw128_desc_mn): A stored K-row by K-row, 64 M values a
// row; B as wgmma_rs128_t's.
__device__ __forceinline__ void wgmma128_f16_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, 1, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// The same with B 256 wide and D 64 x 256 (wgmma256's layout).
__device__ __forceinline__ void wgmma256_f16_tt(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, 1, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db));
}

// D(64 x 128, f32) += A(64 x 16, bf16, registers) * B(16 x 128, bf16),
// B MN-major (trans-b; its descriptor from sw128_desc_mn).  A's registers
// take wgmma's accumulator layout of a 64 x 16 tile: a[0] row r, columns
// 2 (t % 4) + {0, 1}; a[1] row r + 8; a[2], a[3] the same 8 columns on.
__device__ __forceinline__ void wgmma_rs128_t(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// The same with B 16 x 64 and D 64 x 64.
__device__ __forceinline__ void wgmma_rs64_t(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D(64 x 64, s32) (+)= A(64 x 32, s8) * B(64 x 32, s8)ᵀ, both K-major from shared
// memory; D is overwritten where scale_d is 0 (layout as wgmma128's, 8 chunks).
__device__ __forceinline__ void wgmma_s8_64(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) (+)= A(64 x 16, bf16) * B(64 x 16, bf16)ᵀ, both K-major.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma64 with fp16 operands.
__device__ __forceinline__ void wgmma64_f16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, s32) (+)= A(64 x 32, s8, registers) * B(128 x 32, s8)ᵀ, B
// K-major.  A's registers as mma.sync m16n8k32's A in each warp's 16 rows:
// a[0] row r, columns 4 (t % 4) + 0..3 (a byte each); a[1] row r + 8;
// a[2], a[3] the same 16 columns on.
__device__ __forceinline__ void wgmma_rs_s8_128(int (&d)[64], const unsigned (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The same with B 64 x 32 and D 64 x 64.
__device__ __forceinline__ void wgmma_rs_s8_64(int (&d)[32], const unsigned (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- the persistent GEMMs (csrc/wgmma_mm.cu, csrc/scaled_mm.cu) -------------
// Output tiles of GEMM_BM rows; a stage row is 128 bytes of K.
constexpr int GEMM_BM = 128;

// ---- int8 contractions of 2^17 rows or more (csrc/scaled_mm.cu, scaled_mm_tn.cu) ----
// A sum of products of 8-bit codes (|a b| <= 2^14) is exact in int32 below
// 2^17 rows.  A longer one splits each output tile's stages into `parts`
// runs of fewer than 2^17 rows (the wrapper's `long_parts`): unit u is part
// u / tiles of tile u % tiles, so that every tile's part 0 comes first and
// the blocks at work at once walk the operands as an unsplit call does.
// Each part writes its int32 sum to its slab (`slab_store`) and counts
// itself in at its tile's counter (`last_part`); the tile's last part adds
// the others' slabs to its own sum in int64 and rounds the total once to
// fp32 (`wide_total`) before the epilogue.
constexpr int LONG_K = 1 << 17;            // contractions from here on take parts
constexpr int LONG_PART_STAGES = 1023;     // of 128 rows: 130,944 < 2^17 rows a part
__device__ __forceinline__ int2 part_stages(int part, int parts, int nk) {
  return make_int2((part * nk) / parts, ((part + 1) * nk) / parts);  // stages [x, y)
}

// The producer's loop: one thread issues each stage's two TMA loads
// (GEMM_BM rows of x and BN of w, BKE elements of K) into a ring of ST
// stages, the units walked as the consumers walk them (unit b, b +
// gridDim.x, .., the M tile fastest; a unit is a tile's `part_stages`).  It
// waits for a stage's last load before re-arming it, and for every load
// before it returns.
template <int ST, int STAGE_BYTES, int A_BYTES, int BKE, int BN>
__device__ __forceinline__ void produce(const CUtensorMap* tx, const CUtensorMap* tw,
                                        uint8_t* smem, uint64_t* full, uint64_t* empty, int mt,
                                        int tiles, int nk, int parts = 1) {
  int it = 0;  // stages filled so far: stage it % ST, round it / ST
  for (int u = blockIdx.x; u < tiles * parts; u += gridDim.x) {
    const int tile = u % tiles;
    const int m0 = (tile % mt) * GEMM_BM, n0 = (tile / mt) * BN;
    const int2 kr = part_stages(u / tiles, parts, nk);
    for (int kb = kr.x; kb < kr.y; ++kb, ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);  // the first round passes at once
      // and the stage's last load has landed (implied by the consumers'
      // release; waited for all the same, so that a stage never has two
      // loads in flight on its barrier)
      if (it >= ST) mbar_wait(&full[s], ((it / ST) & 1) ^ 1);
      mbar_expect_tx(&full[s], STAGE_BYTES);
      tma_load(smem + s * STAGE_BYTES, tx, &full[s], kb * BKE, m0);
      tma_load(smem + s * STAGE_BYTES + A_BYTES, tw, &full[s], kb * BKE, n0);
    }
  }
  // no load may be in flight when the block exits
  for (int j = it > ST ? it - ST : 0; j < it; ++j) mbar_wait(&full[j % ST], (j / ST) & 1);
}

// The grad-weight GEMM's producer loop (csrc/scaled_mm_tn.cu), `produce`
// for operands whose contraction is their leading (row) axis: each stage
// is one TMA box of `tok` contraction rows x 128 columns of A at column n0
// and NB such boxes of B at columns k0, k0 + 128, .. (boxes BOX bytes
// apart, A's first), both read in their natural row-major layout; `at`
// maps a tile to its (n0, k0), and units are tiles' `part_stages` as in
// `produce`.  The boxes of a ragged tail are zero-filled by TMA and still
// count their whole size.
template <int ST, int STAGE_BYTES, int BOX, int NB, typename TileAt>
__device__ __forceinline__ void produce_tn(const CUtensorMap* ta, const CUtensorMap* tb,
                                           uint8_t* smem, uint64_t* full, uint64_t* empty,
                                           int tiles, int nk, int tok, TileAt at, int parts = 1) {
  const unsigned tx = static_cast<unsigned>(tok) * 128u * (1 + NB);
  int it = 0;  // stages filled so far
  for (int u = blockIdx.x; u < tiles * parts; u += gridDim.x) {
    const int2 nk0 = at(u % tiles);
    const int2 kr = part_stages(u / tiles, parts, nk);
    for (int kb = kr.x; kb < kr.y; ++kb, ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (it >= ST) mbar_wait(&full[s], ((it / ST) & 1) ^ 1);
      mbar_expect_tx(&full[s], tx);
      uint8_t* st = smem + s * STAGE_BYTES;
      tma_load(st, ta, &full[s], nk0.x, kb * tok);
#pragma unroll
      for (int h = 0; h < NB; ++h) tma_load(st + (1 + h) * BOX, tb, &full[s], nk0.y + 128 * h, kb * tok);
    }
  }
  for (int j = it > ST ? it - ST : 0; j < it; ++j) mbar_wait(&full[j % ST], (j / ST) & 1);
}

// ---- the 8-bit transposer ----------------------------------------------------
// An 8-bit tile of `rows` contraction rows (a multiple of 32, at most 128)
// x 128 columns, as TMA writes it in the 128-byte swizzle (16-byte unit u
// of row r at u ^ (r & 7)), into its transpose in shared memory: 128 rows,
// one a column, each 128 bytes of contraction, in the same swizzle: the
// K-major layout that sw128_desc reads, the only layout of 8-bit wgmma
// operands (bytes past `rows` are left as they were).  Each of 256 threads
// takes blocks of 4 rows x 4 columns (rows / 32 of them): four 32-bit
// loads, __byte_perm's 4 x 4 byte transpose, four 32-bit stores.  A warp's
// 32 blocks span 4 column quads and 8 row quads, and each lane reads its
// four rows and writes its four columns in an order turned by its row quad
// (loads) and column quad (stores), so that every load and every store of
// the warp falls in 32 different banks; the turns live in the byte
// selectors, and the addresses are fixed a thread but for a constant a
// block, so a block costs 18 instructions.  Construct once a thread, then
// run() a tile at a time.  The next reader of a transposed tile is wgmma
// (the async proxy): fence.proxy.async first.
struct Transpose8 {
  unsigned ld[4], st[4];  // byte offsets of a thread's loads and stores, block 0
  unsigned lo, hi, x0, x1;  // the byte selectors of the two perm stages

  __device__ __forceinline__ explicit Transpose8(int t) {
    const int lane = t & 31, cq = ((t >> 5) << 2) | (lane & 3);  // columns 4 cq ..
    const int tq = lane >> 2;  // rows 4 tq .. (block 0; block i adds 32 i)
    const int rr = (tq >> 1) & 3, turn = cq & 2;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int row = 4 * tq + (s ^ rr);  // load s: row 4 tq + (s ^ rr)
      ld[s] = row * 128 + ((((cq >> 2) ^ row) & 7) << 4) + ((cq & 3) << 2);
      const int col = 4 * cq + (s ^ turn);  // store s: column 4 cq + (s ^ turn)
      st[s] = (col * 128 + ((tq & 3) << 2)) | ((((lane >> 4) ^ col) & 7) << 4);
    }
    // w[s] holds row s ^ rr: the first stage pairs rows (0, 1) and (2, 3)
    // with their operands swapped where rr & 1, the second stage where
    // rr & 2; `turn` swaps the first stage's two halves
    lo = rr & 1 ? 0x1504u : 0x5140u;
    hi = rr & 1 ? 0x3726u : 0x7362u;
    if (turn) {
      const unsigned x = lo;
      lo = hi;
      hi = x;
    }
    x0 = rr & 2 ? 0x1054u : 0x5410u;
    x1 = rr & 2 ? 0x3276u : 0x7632u;
  }

  __device__ __forceinline__ void run(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                      int rows) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // block i: rows 32 i ..
      if (i * 32 >= rows) break;
      unsigned w[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) w[s] = *reinterpret_cast<const unsigned*>(src + ld[s] + 4096 * i);
      const unsigned alo = __byte_perm(w[0], w[1], lo), ahi = __byte_perm(w[0], w[1], hi);
      const unsigned blo = __byte_perm(w[2], w[3], lo), bhi = __byte_perm(w[2], w[3], hi);
      const unsigned c[4] = {__byte_perm(alo, blo, x0), __byte_perm(alo, blo, x1),
                             __byte_perm(ahi, bhi, x0), __byte_perm(ahi, bhi, x1)};
#pragma unroll
      for (int s = 0; s < 4; ++s) *reinterpret_cast<unsigned*>(dst + (st[s] ^ (i << 5))) = c[s];
    }
  }
};

// ---- e4m3 stages as fp16 ----------------------------------------------------
// The e4m3 GEMMs (scaled_mm.cu, scaled_mm_tn.cu) multiply as fp16: e4m3
// values and their products are exact in fp16 and fp32, and the fp8
// wgmma's own sum keeps about 14 bits (DeepSeek-V3 §3.3.2), too few for
// the card tests' 1e-5 of sum |a b|.
__device__ __forceinline__ unsigned e4m3x2_to_f16x2(unsigned v) {
  unsigned r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(static_cast<unsigned short>(v)));
  return r;
}

// `rows` e4m3 rows of 128 codes (128-byte swizzle, as TMA wrote them) into
// fp16: two chunks of `rows` rows x 64 values in the 128-byte swizzle,
// `chunk` bytes apart, as sw128_desc_mn reads an operand whose rows are
// contraction rows (`chunk` its lbo).  Thread t of 256 takes 16-byte
// pieces; lanes of the second chunk store their high half first, so that a
// quarter warp's stores fall in eight bank groups.
__device__ __forceinline__ void e4m3_rows_to_f16(const uint8_t* src, uint8_t* dst, int rows,
                                                 int chunk, int t) {
  for (int id = t; id < rows * 8; id += 256) {
    const int r = id >> 3, c = id & 7;  // codes 16 c .. 16 c + 15 of row r
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * 128 + ((c ^ (r & 7)) << 4));
    const uint4 lo = make_uint4(e4m3x2_to_f16x2(v.x), e4m3x2_to_f16x2(v.x >> 16),
                                e4m3x2_to_f16x2(v.y), e4m3x2_to_f16x2(v.y >> 16));
    const uint4 hi = make_uint4(e4m3x2_to_f16x2(v.z), e4m3x2_to_f16x2(v.z >> 16),
                                e4m3x2_to_f16x2(v.w), e4m3x2_to_f16x2(v.w >> 16));
    uint8_t* d = dst + (c >> 2) * chunk + r * 128;
    const int ulo = ((2 * (c & 3)) ^ (r & 7)) << 4, uhi = ((2 * (c & 3) + 1) ^ (r & 7)) << 4;
    const bool swap = c & 4;
    *reinterpret_cast<uint4*>(d + (swap ? uhi : ulo)) = swap ? hi : lo;
    *reinterpret_cast<uint4*>(d + (swap ? ulo : uhi)) = swap ? lo : hi;
  }
}

// two neighbouring outputs in one store (the address is a multiple of two)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// A consumer thread's share of a tile's outputs: rows r0 and r0 + 8,
// columns 128 h + 8 j + cq + {0, 1} from acc[64 h + 4 j + 2 hr + c] (the
// wgmma accumulator layout), each out = epi(acc, row_term(row), col); two
// neighbouring columns a store where they can pair.
template <int NB, typename AccT, typename OutT, typename RowTerm, typename Epilogue>
__device__ __forceinline__ void store_tile(const AccT (&acc)[NB * 64], OutT* __restrict__ out,
                                           int r0, int n0, int cq, int M, int N, RowTerm row_term,
                                           Epilogue epi) {
  constexpr int BN = 128 * NB;
  const int ncols = min(BN, N - n0);
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= M) continue;
    const auto rt = row_term(row);
    OutT* orow = out + (size_t)row * N + n0;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cc = 128 * h + 8 * j + cq;
        if (cc >= ncols) continue;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[c] = epi(acc[64 * h + 4 * j + 2 * hr + c], rt, n0 + min(cc + c, ncols - 1));
        if (pairs && cc + 1 < ncols) {
          store2(orow + cc, v[0], v[1]);
        } else {
          orow[cc] = sdnq::from_f32<OutT>(v[0]);
          if (cc + 1 < ncols) orow[cc + 1] = sdnq::from_f32<OutT>(v[1]);
        }
      }
  }
}

// ---- a long contraction's parts (see `part_stages`) --------------------------
// The two consumer warpgroups (256 threads) meet; the producer's warp does
// not take part.
__device__ __forceinline__ void gemm_consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A split tile's slab: its 128 x 128 NB sums row by row.  A consumer
// thread's share (wgmma's layout, as store_tile reads it): local rows rl,
// rl + 8, columns 128 h + 8 j + cq + {0, 1}, two to a store; only the
// tile's rows below its last (`rows`) are written and read, the columns
// past the output as they are.
template <int NB, typename AccT>
__device__ __forceinline__ void slab_store(const AccT (&acc)[NB * 64], AccT* slab, int rl, int cq,
                                           int rows) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rl + 8 * hr >= rows) continue;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 64 * h + 4 * j + 2 * hr;
        AccT* p = slab + (rl + 8 * hr) * (128 * NB) + 128 * h + 8 * j + cq;
        if constexpr (std::is_same<AccT, int>::value)
          *reinterpret_cast<int2*>(p) = make_int2(acc[i], acc[i + 1]);
        else
          *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
      }
  }
}

// Whether this unit is the last of its tile's `parts` to arrive, after
// every consumer thread has stored its slab (all 256 call it; `flag` a
// word of shared memory).  The last sets the counter back to 0, so that the
// next call finds the counters as it needs them.
__device__ __forceinline__ bool last_part(int* counter, int parts, int* flag) {
  __threadfence();
  gemm_consumers_sync();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(counter, 1) == parts - 1;
    if (*flag) *counter = 0;  // every part of the tile has counted itself in
  }
  gemm_consumers_sync();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// The last part's total: its own int32 sums plus the other parts' slabs
// (`slab0` part 0's, parts `stride` ints apart; read through the L2, since
// other SMs wrote them), added in int64, exact, and rounded once to fp32,
// written back into acc as the float's bits (rows below `rows`).
template <int NB>
__device__ __forceinline__ void wide_total(int (&acc)[NB * 64], const int* slab0, size_t stride,
                                           int parts, int part, int rl, int cq, int rows) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rl + 8 * hr >= rows) continue;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 64 * h + 4 * j + 2 * hr;
        const size_t off = (rl + 8 * hr) * (128 * NB) + 128 * h + 8 * j + cq;
        long long s0 = acc[i], s1 = acc[i + 1];
        for (int sp = 0; sp < parts; ++sp) {
          if (sp == part) continue;
          const int2 v = __ldcg(reinterpret_cast<const int2*>(slab0 + sp * stride + off));
          s0 += v.x, s1 += v.y;
        }
        acc[i] = __float_as_int(__ll2float_rn(s0));
        acc[i + 1] = __float_as_int(__ll2float_rn(s1));
      }
  }
}

// ---- host ------------------------------------------------------------------
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Whether a persistent GEMM of mt row tiles and N columns takes 128 x 256
// tiles: yes, unless they fill the card's blocks at most twice and 128 x
// 128 ones finish in fewer rounds (counted in 128 x 128 units): small
// grids, where the rounds weigh most.
inline bool wide_tiles(long long mt, long long N, int sms) {
  const long long t2 = mt * ((N + 255) / 256), t1 = mt * ((N + 127) / 128);
  const long long r2 = (t2 + sms - 1) / sms, r1 = (t1 + sms - 1) / sms;
  return !(r2 <= 2 && r1 < 2 * r2);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up at run time through the
// runtime's entry-point query (the library links the CUDA runtime only)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, K) matrix of `type` (`esize` bytes an element) with rows `ld`
// elements apart, read in boxes of `box_k` elements (128 bytes) x
// `box_rows` rows, 128-byte swizzle, zeros past K and past `rows`
inline bool tensor_map(CUtensorMap* map, const void* base, int rows, int K, int ld, int box_rows,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, int esize = 2,
                int box_k = 64) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (heads, rows, cols) tensor of `type` (`esize` bytes an element), dense,
// read in boxes of box_c columns x box_r rows of one head in the swizzle
// `swz`; zeros past cols and rows (never the next head's rows)
inline bool tensor_map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esize,
                          int cols, int rows, int heads, int box_c, int box_r,
                          CUtensorMapSwizzle swz) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * esize,
                                 static_cast<cuuint64_t>(cols) * rows * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_r), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sdnq
