// Hopper (sm_90a) building blocks for hand-written kernels: TMA tensor maps and bulk
// copies, mbarriers, named barriers, register reallocation (setmaxnreg) and warpgroup
// matrix multiplies (wgmma) with their shared-memory descriptors. Included once per
// source; everything sits in an anonymous namespace.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a box is rows of
// 64 bf16 (128 bytes), and the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
// Every tile starts on a 1024-byte boundary, so the swizzle phase is the address's
// own bits and a descriptor may start anywhere inside a row (a k or n offset).
//
// Descriptor layouts (bf16, 128-byte swizzle), in the terms of the PTX ISA:
//   K-major (the reduction dim contiguous, e.g. Q or K for Q.K^T): rows of 64 k
//     values, 8-row groups 1024 bytes apart (SBO = 1024); a k16 step is +32 bytes.
//   MN-major (the M or N dim contiguous, e.g. V for P.V, read with the transpose
//     flag): 64 values of n in a row, rows along k 128 bytes apart, 8-row groups 1024
//     bytes apart (SBO = 1024), the next 64 values of n LBO bytes on (the next box);
//     a k16 step is +2048 bytes.

#pragma once

#include <cuda.h>  // CUtensorMap and the CUDA driver API types (the entry point: below)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, fetched at run time through the runtime
// (no -lcuda at link time).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// cuTensorMapEncodeTiled needs a current context. A host thread that has made no runtime
// call yet (autograd's backward worker, when the caching allocator served every tensor)
// has none; setting the device binds its primary context.
inline cudaError_t bind_current_device() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaSetDevice(device) : err;
}

// A 3-d tiled map over (batch, rows, inner) elements, innermost first, with the 128-byte
// swizzle; a row is `row_bytes` and a batch entry `batch_bytes` apart (both multiples
// of 16); a box is (box_inner, box_rows, 1). Elements past `inner` or `rows` read as
// zeros and are skipped by stores and reductions.
inline cudaError_t make_map_3d_strided(CUtensorMap* map, const void* ptr,
                                       CUtensorMapDataType type, uint64_t inner, uint64_t rows,
                                       uint64_t batch, uint64_t row_bytes, uint64_t batch_bytes,
                                       uint32_t box_inner, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  cudaError_t err = bind_current_device();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {inner, rows, batch};
  const cuuint64_t strides[2] = {row_bytes, batch_bytes};
  const cuuint32_t box[3] = {box_inner, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-d tiled map over contiguous (d3, d2, d1, d0) elements, innermost (d0) first, with
// the 128-byte swizzle; a box is (box0, 1, box2, 1). Elements past d0 in a box read as
// zeros: a (B, S, heads, D) tensor mapped as (B, S, heads, D) with 64-column boxes reads
// a head of D = 96 as two boxes, the second holding 32 columns and 32 zero columns, never
// the next head's.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                               uint32_t elem_bytes, uint64_t d0, uint64_t d1, uint64_t d2,
                               uint64_t d3, uint32_t box0, uint32_t box2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  cudaError_t err = bind_current_device();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const uint64_t row = d0 * elem_bytes;  // contiguous: each stride the one below it x its dim
  const cuuint64_t strides[3] = {row, d1 * row, d2 * d1 * row};
  const cuuint32_t box[4] = {box0, 1, box2, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-d tiled map over (batch, rows, inner) row-major elements, innermost first, with
// the 128-byte swizzle; a box is (box_inner, box_rows, 1). Rows past `rows` read as
// zeros and are skipped by stores and reductions.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                               uint32_t elem_bytes, uint64_t inner, uint64_t rows,
                               uint64_t batch, uint32_t box_inner, uint32_t box_rows) {
  return make_map_3d_strided(map, ptr, type, inner, rows, batch, inner * elem_bytes,
                             rows * inner * elem_bytes, box_inner, box_rows);
}

// ---------------------------------------------------------------- device: barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and the other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bar.sync on a named barrier (1..15) for `threads` threads; 0 is __syncthreads's.
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- device: TMA

// Load one (box_inner, box_rows, 1) box at coordinates (c0, c1, c2) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Load one (box0, 1, box2, 1) box of a 4-d map at coordinates (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Store one box from shared memory into global memory; parts of the box past the
// tensor's edges are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Add one f32 box from shared memory into global memory (element-wise, in L2).
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src,
                                                  int c0, int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed bulk operations have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until the committed bulk operations are complete (visible in global memory).
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Copy 4 bytes from global to shared memory asynchronously (cp.async); `in` false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have landed; the
// barrier's expected count includes it.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------- device: wgmma

// Descriptor of a 128-byte-swizzled bf16 operand at shared address `addr` (see the top).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point, so the compiler neither reads an accumulator before
// the wgmma that writes it has been waited for nor reuses an A fragment early.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define HOPPER_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F16(i) HOPPER_F4(i), HOPPER_F4(i + 4), HOPPER_F4(i + 8), HOPPER_F4(i + 12)
#define HOPPER_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_R32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define HOPPER_R96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "  \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "  \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"

#define HOPPER_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"

// d (64 x N, f32, N/2 registers a thread) (+)= A . B, one k16 step, both operands in
// shared memory. TA / TB: the transpose flags (1 = MN-major). scale_d = 0 overwrites d.
// Accumulator layout: warp w of the warpgroup holds rows 16w + lane/4 (+8), and n8
// chunk j gives registers 4j..4j+3 at columns 8j + 2*(lane%4) (+1), rows g, g, g+8, g+8.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N in {32, 64, 128}");
  if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_R16
        ", %16, %17, p, 1, 1, %19, %20;\n}\n"
        : HOPPER_F16(0)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : HOPPER_F16(0), HOPPER_F16(16)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : HOPPER_F16(0), HOPPER_F16(16), HOPPER_F16(32), HOPPER_F16(48)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// d (64 x N) (+)= A . B, one k16 step, A (64 x 16 bf16) from registers in the mma.sync
// m16n8k16 A layout of each warp's 16 rows, B in shared memory (TB: 1 = MN-major).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256,
                "wgmma_rs: N in {64, 128, 192, 256}");
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_F16(0), HOPPER_F16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_F16(0), HOPPER_F16(16), HOPPER_F16(32), HOPPER_F16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " HOPPER_R96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : HOPPER_F16(0), HOPPER_F16(16), HOPPER_F16(32), HOPPER_F16(48), HOPPER_F16(64),
          HOPPER_F16(80)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_R128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : HOPPER_F16(0), HOPPER_F16(16), HOPPER_F16(32), HOPPER_F16(48), HOPPER_F16(64),
          HOPPER_F16(80), HOPPER_F16(96), HOPPER_F16(112)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

#undef HOPPER_F4
#undef HOPPER_F16
#undef HOPPER_R16
#undef HOPPER_R32
#undef HOPPER_R64
#undef HOPPER_R96
#undef HOPPER_R128

}  // namespace
