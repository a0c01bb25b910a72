// Tiles and tensor-core fragments of the ring kernels (ring_chunk.cu): mma.sync
// m16n8k16 bf16 with f32 accumulation, fragment loaders from shared memory, a tile
// loader and quad reductions; flash_attention.cu takes only the bf16 packing, NEG_INF
// and the quad reductions (its tiles are in hopper.cuh). Included once per source;
// everything sits in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BLOCK_M = 64;  // query rows per tile
constexpr int BLOCK_N = 64;  // keys per tile
constexpr float NEG_INF = -1e30f;
constexpr int LDS = BLOCK_N + 8;  // row stride of the (64 x 64) P / dS tiles

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// c += a * b for one m16n8k16 tile (a row-major 16x16, b col-major 16x8, c 16x8 f32).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment loaders from shared memory. Lane l holds rows g = l/4 (+8) and columns
// t = 2*(l%4) (+1, +8, +9) of the m16n8k16 operand layouts.
//
// A (16x16) whose element (r, c) sits at p[r * rs + c]: pairs are contiguous.
__device__ __forceinline__ void load_a_rows(uint32_t a[4], const bf16* p, int rs, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p + g * rs + t);
  a[1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * rs + t);
  a[2] = *reinterpret_cast<const uint32_t*>(p + g * rs + t + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * rs + t + 8);
}

// A (16x16) whose element (r, c) sits at p[c * cs + r]: the transpose of a stored tile.
__device__ __forceinline__ void load_a_cols(uint32_t a[4], const bf16* p, int cs, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  a[0] = pack_bf16(p[t * cs + g], p[(t + 1) * cs + g]);
  a[1] = pack_bf16(p[t * cs + g + 8], p[(t + 1) * cs + g + 8]);
  a[2] = pack_bf16(p[(t + 8) * cs + g], p[(t + 9) * cs + g]);
  a[3] = pack_bf16(p[(t + 8) * cs + g + 8], p[(t + 9) * cs + g + 8]);
}

// B (16x8, k x n) whose element (k, n) sits at p[n * ns + k]: pairs are contiguous.
__device__ __forceinline__ void load_b_kcontig(uint32_t b[2], const bf16* p, int ns, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p + g * ns + t);
  b[1] = *reinterpret_cast<const uint32_t*>(p + g * ns + t + 8);
}

// B (16x8, k x n) whose element (k, n) sits at p[k * ks + n].
__device__ __forceinline__ void load_b_ncontig(uint32_t b[2], const bf16* p, int ks, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  b[0] = pack_bf16(p[t * ks + g], p[(t + 1) * ks + g]);
  b[1] = pack_bf16(p[(t + 8) * ks + g], p[(t + 9) * ks + g]);
}

// Copy rows [row0, row0 + ROWS) of a (seq, D) slice with the given row stride into a
// shared tile with row stride D + 8, with a block of THREADS threads; rows past
// `nrows` are zero.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_n(bf16* dst, const bf16* src, size_t row_stride,
                                            int row0, int nrows) {
  constexpr int CHUNKS = D / 8;
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
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

}  // namespace
