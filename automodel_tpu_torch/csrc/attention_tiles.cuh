// Pieces shared by the two Hopper attention sources, flash_attention.cu and
// ring_chunk.cu: the warp-specialised block's shape and register budget, bf16 packing,
// quad reductions, exp2, the 1024-byte alignment of the dynamic shared memory, the
// swizzled shared-memory offsets of the backward's dS and dQ tiles, and the consumer
// walk of the q-stationary dQ kernels (flash_dq, ring_dq), templated on the mask of
// each kernel. Included once per source; everything sits in an anonymous namespace.

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

// The tanh logit soft-cap (Gemma-2), for the kernels instantiated with it. A raw score s
// (Q K^T, unscaled) becomes th = tanh(s scale / c), computed as 1 - 2 / (2^(s pre2) + 1)
// with pre2 = 2 scale log2(e) / c; the capped logit c th is c tanh(s scale / c), its log2
// units th * l2 with l2 = c log2(e), and d(c th) / d(s scale) = 1 - th^2. The cap is
// applied to a tile before its mask (a masked score stays -inf; tanh(-inf) c would be
// -c, a weight exp(-c - m) on a masked key). Not tanh.approx.f32: its relative error,
// ~2^-11, is up to 0.025 in a logit at c = 50, past the forward's lse check of 1e-3;
// ex2.approx and the fast divide keep th within ~1e-7 (a few 1e-6 in the logit). Both
// factors come from the host, so they are kernel parameters and take no register.
struct SoftCap {
  float pre2, l2;
  __device__ __forceinline__ float tanh_of(float s) const {
    return 1.f - __fdividef(2.f, fast_exp2(s * pre2) + 1.f);  // 2^inf: th = 1; 2^-inf: -1
  }
};

// 1 - th^2 of a capped score th, 0 for a masked one (-inf; its P is 0 too, and 0 * inf
// would be NaN).
__device__ __forceinline__ float soft_cap_jac(float th) {
  return fmaxf(fmaf(-th, th, 1.f), 0.f);
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

// ------------------------------------------------------------ q-stationary dQ

// Shared-memory layout of the q-stationary dQ kernels (flash_dq, ring_dq): a block owns
// 128 query rows of one (b, h) (64 a consumer warpgroup), holds its Q and dO tiles and
// walks the key tiles of its kv head in order through a ring of K / V stages. Key tiles
// are 64 rows: the consumers then hold S and dP (32 registers each), dS as bf16 A
// fragments (16) and the f32 dQ (64 at D=128, 96 at D=192) with room to spare. Q and K
// are D wide, dO and V DV wide (MLA: D=192, DV=128, where 4 stages would pass the
// 227 KB of shared memory and 3 fit). At D=256 (Gemma) key tiles are 32 rows: Q and dO
// take 128 KB, so three 32 KB K / V stages fit beside them where two of 64 keys would
// not, and the consumers hold dQ (128 registers), S and dP (16 each) and dS (8), 168
// in all, against 208 at 64 keys. The kernel's own per-stage words follow at TAIL_OFF.
// KV_BYTES: one K stage (one V stage too when DV == D).
template <int D, int DV = D>
struct DqTiles {
  static constexpr int DIM = D, DIM_V = DV;
  static constexpr int BM = 128, BN = D == 256 ? 32 : 64;
  static constexpr int STAGES = D == DV && D != 256 ? 4 : 3;
  static constexpr int BOXES = D / BOX, V_BOXES = DV / BOX;
  static constexpr int Q_BYTES = BM * D * 2, DO_BYTES = BM * DV * 2;
  static constexpr int KV_BYTES = BN * D * 2, V_BYTES = BN * DV * 2;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = Q_BYTES + DO_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int TAIL_OFF = V_OFF + STAGES * V_BYTES;
};

// The consumer warpgroup cw's walk of a q-stationary dQ kernel over n key tiles, the
// tile of step `it` in stage it % STAGES (its full barrier arrives when it has landed,
// its empty barrier takes one arrival a consumer warp). For each tile:
//   S = Q K^T over D and dP = dO V^T over DV (shared-memory wgmmas, 64 q rows x 64 keys),
//   mask(it, s) sets the scores of disallowed pairs to -inf (the kernel's mask policy),
//   dS = P o (dP - delta) with P = 2^(S scale log2(e) - lse log2(e)) (SOFTCAP: S is
//   capped before the mask, P = 2^(th l2 - lse log2(e)) and dS takes the factor 1 - th^2;
//   the ring instantiates it without),
//   dQ += dS K (dS from registers as bf16, K through the transpose flag),
// so dQ sums in f32 registers over the key tiles in the order they were walked: the
// same order on every run. The dQ product of tile it - 1 runs on the tensor cores while
// tile it's dS is computed; tile 0 is peeled off so that every wgmma sits in one block
// with its wait (else ptxas serialises the kernel's wgmmas). lse2: lse * log2(e) of
// this thread's two rows; acc comes back unscaled (dQ / scale).
template <class C, bool SOFTCAP = false, class MaskFn>
__device__ __forceinline__ void dq_walk(float (&acc)[C::DIM / 2], int n, unsigned char* smem,
                                        int cw, uint64_t* full, uint64_t* empty,
                                        const float (&lse2)[2], const float (&delta)[2],
                                        float scale_log2, int lane, MaskFn mask,
                                        SoftCap cap = {}) {
  constexpr int D = C::DIM, DV = C::DIM_V, BN = C::BN;
  const uint32_t q_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  const uint32_t do_addr = smem_u32(smem + C::DO_OFF) + cw * 64 * ROW_BYTES;
  float s[BN / 2], dp[BN / 2];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // S and dP of the tile in `stage`, one commit group
  auto issue_sdp = [&](int stage) {
    const uint32_t k_addr = smem_u32(smem + C::K_OFF + stage * C::KV_BYTES);
    const uint32_t v_addr = smem_u32(smem + C::V_OFF + stage * C::V_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * BN * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<BN, 0, 0>(s, desc_sw128(q_addr + off, 16), desc_sw128(k_addr + koff, 16), ks);
    }
#pragma unroll
    for (int ks = 0; ks < DV / 16; ++ks) {
      const uint32_t off = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * BN * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<BN, 0, 0>(dp, desc_sw128(do_addr + off, 16), desc_sw128(v_addr + koff, 16), ks);
    }
    wgmma_commit();
  };
  // dS in place of s (register r: row (r >> 1) & 1 of the thread's two)
  auto ds_step = [&](int it) {
    if constexpr (SOFTCAP) {
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) s[r] = cap.tanh_of(s[r]);
    }
    mask(it, s);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) {
      const int i = (r >> 1) & 1;
      if constexpr (SOFTCAP)
        s[r] = fast_exp2(fmaf(s[r], cap.l2, -lse2[i])) * (dp[r] - delta[i]) * soft_cap_jac(s[r]);
      else
        s[r] = fast_exp2(fmaf(s[r], scale_log2, -lse2[i])) * (dp[r] - delta[i]);
    }
  };
  // dS rounded to bf16 as the A operand: registers 8kk..8kk+7 are keys 16kk..16kk+15
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) pa[kk][f] = pack_f32(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
    }
  };
  auto fence_pa = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
  };
  // dQ += dS K with the K of `stage` (keys x D, D contiguous: the transpose flag)
  auto issue_dq = [&](int stage) {
    const uint32_t k_addr = smem_u32(smem + C::K_OFF + stage * C::KV_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk], desc_sw128(k_addr + kk * 16 * ROW_BYTES, BN * ROW_BYTES), 1);
    wgmma_commit();
  };

  if (n <= 0) return;
  int prev_stage = 0;
  mbar_wait(&full[0], 0);
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  ds_step(0);
  pack();
  for (int it = 1; it < n; ++it) {
    const int stage = it % C::STAGES;
    mbar_wait(&full[stage], (it / C::STAGES) & 1);
    issue_sdp(stage);
    issue_dq(prev_stage);
    wgmma_wait<1>();  // S and dP are done; the previous tile's dQ product runs on
    fence_regs(s);
    fence_regs(dp);
    ds_step(it);
    wgmma_wait<0>();  // the dQ product is done: its stage is free, pa can be rewritten
    fence_regs(acc);
    fence_pa();
    release(&empty[prev_stage], lane);
    pack();
    prev_stage = stage;
  }
  issue_dq(prev_stage);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_pa();
  release(&empty[prev_stage], lane);
}

}  // namespace
