// Pieces shared by the two Hopper attention sources, flash_attention.cu and
// ring_chunk.cu: the warp-specialised block's shape and register budget, bf16 packing,
// quad reductions, exp2, the 1024-byte alignment of the dynamic shared memory and the
// swizzled shared-memory offsets of the backward's dS and dQ tiles. Included once per
// source; everything sits in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
// registers a thread after setmaxnreg: 128 x producer + 256 x consumer may not pass the
// 384 x 168 the block is launched with (65,536 / 384, rounded down to a multiple of 8),
// or setmaxnreg.inc waits forever
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168, "setmaxnreg budget");
constexpr int BOX = 64;  // bf16 columns of one 128-byte swizzled box
constexpr int ROW_BYTES = 128;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's period).
// Offsetting the __shared__ array itself keeps its address space visible to the
// compiler, so the accesses through it stay shared-memory loads and stores.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// 2^x in one MUFU.EX2 (exp2f adds a range fix-up for results below 2^-126, which are
// 0 here anyway); 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A consumer warp is done with a stage: one arrival a warp (an mbarrier arrival is an
// atomic on one shared word, so 256 of them a tile would serialise).
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Byte offset of bf16 element (r, c) in a 128-byte-swizzled tile of 64-column rows.
__device__ __forceinline__ uint32_t swz_bf16(int r, int c) {
  return r * ROW_BYTES + ((((c * 2) >> 4) ^ (r & 7)) << 4) + ((c * 2) & 15);
}

// Byte offset of f32 element (r, c) in 128-byte-swizzled boxes of 32 columns, nrows rows each.
__device__ __forceinline__ uint32_t swz_f32(int r, int c, int nrows) {
  const int cb = c & 31;
  return (c >> 5) * nrows * ROW_BYTES + r * ROW_BYTES + ((((cb * 4) >> 4) ^ (r & 7)) << 4) +
         ((cb * 4) & 15);
}

}  // namespace
