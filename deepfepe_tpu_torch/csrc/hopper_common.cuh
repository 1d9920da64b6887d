// Hopper building blocks shared by the bf16 conv kernels: PTX wrappers for
// mbarriers, TMA, wgmma and ldmatrix, the 128-byte swizzle, the fused
// affine + ReLU epilogue's arithmetic and lane transpose, and the TMA tensor
// map encoder (cuTensorMapEncodeTiled, from libcuda.so.1 by dlopen). Included
// by conv_formulations.cu (X1-X4) and conv3x3_bf16.cu (K5 and K5b in bf16);
// every definition is internal to the including translation unit.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// --- Hopper primitives (PTX), as in csrc/mlp.cu ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Waits for phase `parity` of a barrier. A load that never lands traps
// after about 4 s instead of hanging the stream; the clock is read only
// once the first try has failed. The loop lives in one asm statement:
// written in C++ (csrc/mlp.cu's form), its branches made ptxas serialise
// the wgmmas of a kernel that waits between them (C7520).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u64 t0, t1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE_%=;\n\t"
      "mov.u64 t0, %%globaltimer;\n\t"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE_%=;\n\t"
      "mov.u64 t1, %%globaltimer;\n\t"
      "sub.u64 t1, t1, t0;\n\t"
      "setp.gt.u64 p, t1, 4000000000;\n\t"
      "@p trap;\n\t"
      "bra WAIT_%=;\n\t"
      "DONE_%=:\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 2-D tensor map into shared memory; completion is counted
// on `bar` in bytes. c0 is the column (innermost) coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first; negative and
// past-the-end coordinates read as zero).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define XCONV_D32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D[64x64] += A[64x16] B[16x64], bf16, f32 in registers; A K-major from
// shared memory by descriptor, B MN-major ([k][n] rows) by descriptor.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n\t}"
      : XCONV_D32
      : "l"(da), "l"(db), "r"(1));
}

// The same with A from registers: the warp's 16 x 16 fragment as ldmatrix
// x4 gives it (rows g, g + 8; k 2t, 2t + 8).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : XCONV_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef XCONV_D32

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int NJ>
__device__ __forceinline__ void keep(float (&acc)[NJ][32]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 32; ++q) asm volatile("" : "+f"(acc[j][q])::"memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// The barrier of one consumer warpgroup (ids 1 to 4; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// Byte offset of the 16-byte chunk `chunk` of 128-byte row r in a tile
// written by TMA with the 128-byte swizzle (the tile 1024-aligned).
__device__ __forceinline__ int swz(int r, int chunk) { return r * 128 + ((chunk ^ (r & 7)) << 4); }

__device__ __forceinline__ float affine_relu(float v, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), t), 0.f);
}

// A quad of lanes holds one row's four 16-byte chunks, lane j word j of
// each (in[c]: its two columns of chunk c). Returns chunk t of the row to
// lane t: word j from lane j's in[t].
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&in)[4], int lane) {
  const int t = lane & 3;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int si = (t - r) & 3, src = (t + r) & 3;
    const uint32_t send = si == 0 ? in[0] : si == 1 ? in[1] : si == 2 ? in[2] : in[3];
    const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
    out[0] = src == 0 ? got : out[0];
    out[1] = src == 1 ? got : out[1];
    out[2] = src == 2 ? got : out[2];
    out[3] = src == 3 ? got : out[3];
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// --- Host side: TMA tensor maps ----------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A map of the bf16 tensor [dims[n-1]]...[dims[0]] (dims innermost first,
// contiguous) in boxes `box`, 128-byte swizzle; out-of-bounds elements,
// negative coordinates included, read as zero.
bool tensor_map(CUtensorMap* m, const void* base, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
