// Flash attention for Hopper (sm_90a): a forward kernel and one backward kernel.
//
// Replaces the Pallas kernels of automodel_tpu/ops/pallas/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (online-softmax forward, emits O and the logsumexp)
//   flash_bwd  <- _dqdkv_kernel (fused dq+dk+dv backward from one s/p recompute),
//                 and by function _dq_kernel + _dkv_kernel (the split backward
//                 the TPU takes past its VMEM budget): here one kernel serves
//                 every sequence length, since dk/dv live in registers per key
//                 tile and dq goes to an f32 buffer by atomicAdd.
//
// Layouts: q/o (B, Sq, H, D), k/v (B, Skv, KH, D), bf16, contiguous; GQA maps q head
// h to kv head h / (H / KH). lse and delta are (B*H, Sq) f32. Segment ids are
// optional int32 (B, Sq) / (B, Skv). Masks: causal (absolute index q >= kv) and
// segment equality, applied per element; key tiles past the causal limit are skipped.
// A row with no allowed key gives O = 0 and lse = -1e30, as the TPU kernel's finalize.
//
// What bounds it. At the Llama-3.2-1B training shape (B=4, S=2048, H=32, KH=8,
// D=64, causal) the forward does 4*B*H*S^2*D/2 = 68.7 GFLOP, 69 us at the
// H100's 989 TFLOP/s dense bf16; the backward does 2.5x that (171.8 GFLOP, 174 us).
// q/k/v/O traffic is ~85 MB, 25 us at 3.35 TB/s. Both kernels are compute-bound.
//
// At the Qwen3-30B-A3B training shape (B=4, S=2048, H=32, KH=4, D=128, causal) the
// forward does 137.5 GFLOP (139 us) and the backward 343.7 GFLOP (348 us), against
// 151 MB of q/k/v/O (45 us): bound by operations as at D=64.
//
// Design, simple first: blocks of 4 warps, 64 query rows (forward) or 64 keys
// (backward) per block, 16 rows per warp. At D=128 the backward's per-warp dK/dV
// for 16 keys x 128 columns would be 128 f32 accumulators a thread before any
// fragment, so D=128 takes flash_bwd_kernel_dsplit instead: 8 warps, each with 16
// keys x 64 columns of dK/dV (the head dim split across two warps), S/dP split 16
// query rows x 32 keys a warp, dQ 16 query rows x 64 columns a warp. D=64 keeps the
// 4-warp kernel. Tiles of 64 go through shared memory and
// every product runs on the tensor cores as mma.sync m16n8k16 bf16 with f32
// accumulation. P is rounded to bf16 before P.V (as the TPU kernel casts p to v's
// dtype); the backward also rounds P and dS to bf16 for its three products.
// What it leaves on the table: fragments are gathered from shared memory with
// scalar loads (no ldmatrix), tiles are loaded synchronously (no cp.async/TMA
// pipeline), no wgmma or warp specialisation, and dq goes through global atomics.

#include "attention_tiles.cuh"

namespace {

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

// load_tile_n for this file's 4-warp blocks.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t row_stride,
                                          int row0, int nrows) {
  load_tile_n<D, ROWS, NUM_THREADS>(dst, src, row_stride, row0, nrows);
}

template <int D>
constexpr int fwd_smem_bytes() {
  return (BLOCK_M + 2 * BLOCK_N) * (D + 8) * 2 + BLOCK_N * 4;
}

// grid (ceil(Sq / BLOCK_M), B * H); warp w owns query rows w*16 .. w*16+15 of the tile.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KH, float scale,
                 int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BLOCK_M * LD;
  bf16* sV = sK + BLOCK_N * LD;
  int* sSegKv = reinterpret_cast<int*>(sV + BLOCK_N * LD);

  const int q_start = blockIdx.x * BLOCK_M;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const bf16* q_base = q + ((size_t)b * Sq * H + h) * D;
  const bf16* k_base = k + ((size_t)b * Skv * KH + kvh) * D;
  const bf16* v_base = v + ((size_t)b * Skv * KH + kvh) * D;

  load_tile<D, BLOCK_M>(sQ, q_base, q_stride, q_start, Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a_rows(qf[ks], sQ + warp * 16 * LD + ks * 16, LD, lane);

  const int row[2] = {q_start + warp * 16 + g, q_start + warp * 16 + g + 8};
  int segr[2] = {0, 0};
  if (seg_q != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) segr[i] = row[i] < Sq ? seg_q[(size_t)b * Sq + row[i]] : -1;
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = causal ? min(Skv, q_start + BLOCK_M) : Skv;
  for (int kv_start = 0; kv_start < kv_end; kv_start += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BLOCK_N>(sK, k_base, kv_stride, kv_start, Skv);
    load_tile<D, BLOCK_N>(sV, v_base, kv_stride, kv_start, Skv);
    if (seg_kv != nullptr) {
      for (int i = threadIdx.x; i < BLOCK_N; i += NUM_THREADS)
        sSegKv[i] = kv_start + i < Skv ? seg_kv[(size_t)b * Skv + kv_start + i] : -2;
    }
    __syncthreads();

    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kb[2];
        load_b_kcontig(kb, sK + n * 8 * LD + ks * 16, LD, lane);
        mma(s[n], qf[ks], kb);
      }
    }

    // scale + mask; allowed bits kept so fully masked rows give p = 0
    uint32_t allowed = 0u;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = kv_start + n * 8 + t + (e & 1);
        bool ok = col < Skv && (!causal || row[i] >= col);
        if (seg_kv != nullptr) ok = ok && segr[i] == sSegKv[col - kv_start];
        const float x = ok ? s[n][e] * scale : NEG_INF;
        s[n][e] = x;
        if (ok) allowed |= 1u << (n * 4 + e);
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = (allowed >> (n * 4 + e)) & 1u ? expf(s[n][e] - m[i]) : 0.f;
        s[n][e] = p;
        rs[i] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the accumulator layout of two adjacent n8 tiles is the A layout of
    // one k16 step, so P goes from registers straight into the product.
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t vb[2];
        load_b_ncontig(vb, sV + kk * 16 * LD + n * 8, LD, lane);
        mma(acc[n], pa, vb);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const bool empty = l[i] == 0.f;
    const float denom = empty ? 1.f : l[i];
    bf16* orow = o + ((size_t)b * Sq + row[i]) * q_stride + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t) =
          pack_f32(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    }
    if ((lane & 3) == 0) lse[(size_t)bh * Sq + row[i]] = empty ? NEG_INF : m[i] + logf(denom);
  }
}

template <int D>
constexpr int bwd_smem_bytes() {
  return (2 * BLOCK_N + 2 * BLOCK_M) * (D + 8) * 2 + 2 * BLOCK_M * LDS * 2 +
         (3 * BLOCK_M + BLOCK_N) * 4;
}

// grid (ceil(Skv / BLOCK_N), B * KH). Each block holds one K/V tile, loops over the
// q heads of its GQA group and over the q tiles from the causal start, and owns its
// dK/dV rows (warp w: keys w*16 .. w*16+15), so the group sum needs no second pass.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int Sq, int Skv, int H, int KH, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BLOCK_N * LD;
  bf16* sQ = sV + BLOCK_N * LD;
  bf16* sdO = sQ + BLOCK_M * LD;
  bf16* sP = sdO + BLOCK_M * LD;
  bf16* sdS = sP + BLOCK_M * LDS;
  float* sLse = reinterpret_cast<float*>(sdS + BLOCK_M * LDS);
  float* sDelta = sLse + BLOCK_M;
  int* sSegQ = reinterpret_cast<int*>(sDelta + BLOCK_M);
  int* sSegKv = sSegQ + BLOCK_M;

  const int kv_start = blockIdx.x * BLOCK_N;
  const int b = blockIdx.y / KH, kvh = blockIdx.y % KH;
  const int groups = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const bool segmented = seg_q != nullptr;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const bf16* k_base = k + ((size_t)b * Skv * KH + kvh) * D;
  const bf16* v_base = v + ((size_t)b * Skv * KH + kvh) * D;
  load_tile<D, BLOCK_N>(sK, k_base, kv_stride, kv_start, Skv);
  load_tile<D, BLOCK_N>(sV, v_base, kv_stride, kv_start, Skv);
  if (segmented) {
    for (int i = threadIdx.x; i < BLOCK_N; i += NUM_THREADS)
      sSegKv[i] = kv_start + i < Skv ? seg_kv[(size_t)b * Skv + kv_start + i] : -2;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  const int m_first = causal ? kv_start / BLOCK_M : 0;
  const int m_tiles = (Sq + BLOCK_M - 1) / BLOCK_M;
  for (int hh = 0; hh < groups; ++hh) {
    const int h = kvh * groups + hh;
    const size_t bh = (size_t)b * H + h;
    const bf16* q_base = q + ((size_t)b * Sq * H + h) * D;
    const bf16* do_base = dout + ((size_t)b * Sq * H + h) * D;
    for (int mt = m_first; mt < m_tiles; ++mt) {
      const int q_start = mt * BLOCK_M;
      __syncthreads();  // the previous tile's readers of sQ/sdO/sP/sdS are done
      load_tile<D, BLOCK_M>(sQ, q_base, q_stride, q_start, Sq);
      load_tile<D, BLOCK_M>(sdO, do_base, q_stride, q_start, Sq);
      for (int i = threadIdx.x; i < BLOCK_M; i += NUM_THREADS) {
        const bool in = q_start + i < Sq;
        sLse[i] = in ? lse[bh * Sq + q_start + i] : 0.f;
        sDelta[i] = in ? delta[bh * Sq + q_start + i] : 0.f;
        if (segmented) sSegQ[i] = in ? seg_q[(size_t)b * Sq + q_start + i] : -1;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T for this warp's 16 query rows x 64 keys
      float s[BLOCK_N / 8][4], dp[BLOCK_N / 8][4];
      uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        load_a_rows(qa[ks], sQ + warp * 16 * LD + ks * 16, LD, lane);
        load_a_rows(da[ks], sdO + warp * 16 * LD + ks * 16, LD, lane);
      }
#pragma unroll
      for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t kb[2], vb[2];
          load_b_kcontig(kb, sK + n * 8 * LD + ks * 16, LD, lane);
          load_b_kcontig(vb, sV + n * 8 * LD + ks * 16, LD, lane);
          mma(s[n], qa[ks], kb);
          mma(dp[n], da[ks], vb);
        }
      }

      // P = exp(S * scale - lse), dS = P * (dP - delta); both to shared as bf16
#pragma unroll
      for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = warp * 16 + g + (e >> 1) * 8;
          const int lc = n * 8 + t + (e & 1);
          const int r = q_start + lr, c = kv_start + lc;
          bool ok = r < Sq && c < Skv && (!causal || r >= c);
          if (segmented) ok = ok && sSegQ[lr] == sSegKv[lc];
          const float p = ok ? expf(s[n][e] * scale - sLse[lr]) : 0.f;
          const float ds = p * (dp[n][e] - sDelta[lr]);
          sP[lr * LDS + lc] = __float2bfloat16(p);
          sdS[lr * LDS + lc] = __float2bfloat16(ds);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for this warp's 16 keys; reduction over q rows
#pragma unroll
      for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
        uint32_t pa[4], sa[4];
        load_a_cols(pa, sP + kk * 16 * LDS + warp * 16, LDS, lane);
        load_a_cols(sa, sdS + kk * 16 * LDS + warp * 16, LDS, lane);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t ob[2], qb[2];
          load_b_ncontig(ob, sdO + kk * 16 * LD + n * 8, LD, lane);
          load_b_ncontig(qb, sQ + kk * 16 * LD + n * 8, LD, lane);
          mma(dv_acc[n], pa, ob);
          mma(dk_acc[n], sa, qb);
        }
      }

      // dQ += dS K for this warp's 16 query rows; summed across key tiles by atomics
      float dq_part[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) dq_part[n][0] = dq_part[n][1] = dq_part[n][2] = dq_part[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        uint32_t sa[4];
        load_a_rows(sa, sdS + warp * 16 * LDS + kk * 16, LDS, lane);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t kb[2];
          load_b_ncontig(kb, sK + kk * 16 * LD + n * 8, LD, lane);
          mma(dq_part[n], sa, kb);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q_start + warp * 16 + g + i * 8;
        if (r >= Sq) continue;
        float* dq_row = dq + ((size_t)b * Sq + r) * q_stride + (size_t)h * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          atomicAdd(dq_row + n * 8 + t, dq_part[n][2 * i] * scale);
          atomicAdd(dq_row + n * 8 + t + 1, dq_part[n][2 * i + 1] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kv_start + warp * 16 + g + i * 8;
    if (c >= Skv) continue;
    const size_t off = ((size_t)b * Skv + c) * kv_stride + (size_t)kvh * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + t) =
          pack_f32(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + t) =
          pack_f32(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

constexpr int DSPLIT_WARPS = 8;
constexpr int DSPLIT_THREADS = DSPLIT_WARPS * 32;

// flash_bwd_kernel for wide heads: the same work per block (one 64-key K/V tile, the
// GQA group's q heads, the q tiles from the causal start) over 8 warps, so that no
// warp holds more than 16 keys x D/2 columns of dK and dV. Warp w: S and dP for query
// rows (w % 4) * 16 and keys (w / 4) * 32; dK/dV for keys (w % 4) * 16 and columns
// (w / 4) * D/2; dQ for query rows (w % 4) * 16 and columns (w / 4) * D/2.
template <int D>
__global__ void __launch_bounds__(DSPLIT_THREADS)
flash_bwd_kernel_dsplit(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int Sq, int Skv, int H, int KH, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int DH = D / 2;  // columns of dK / dV / dQ per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BLOCK_N * LD;
  bf16* sQ = sV + BLOCK_N * LD;
  bf16* sdO = sQ + BLOCK_M * LD;
  bf16* sP = sdO + BLOCK_M * LD;
  bf16* sdS = sP + BLOCK_M * LDS;
  float* sLse = reinterpret_cast<float*>(sdS + BLOCK_M * LDS);
  float* sDelta = sLse + BLOCK_M;
  int* sSegQ = reinterpret_cast<int*>(sDelta + BLOCK_M);
  int* sSegKv = sSegQ + BLOCK_M;

  const int kv_start = blockIdx.x * BLOCK_N;
  const int b = blockIdx.y / KH, kvh = blockIdx.y % KH;
  const int groups = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int r16 = (warp & 3) * 16;         // this warp's 16 query rows, or 16 keys
  const int c32 = (warp >> 2) * 32;        // its 32 keys of S / dP
  const int dcol = (warp >> 2) * DH;       // its D/2 columns of dK / dV / dQ
  const bool segmented = seg_q != nullptr;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const bf16* k_base = k + ((size_t)b * Skv * KH + kvh) * D;
  const bf16* v_base = v + ((size_t)b * Skv * KH + kvh) * D;
  load_tile_n<D, BLOCK_N, DSPLIT_THREADS>(sK, k_base, kv_stride, kv_start, Skv);
  load_tile_n<D, BLOCK_N, DSPLIT_THREADS>(sV, v_base, kv_stride, kv_start, Skv);
  if (segmented) {
    for (int i = threadIdx.x; i < BLOCK_N; i += DSPLIT_THREADS)
      sSegKv[i] = kv_start + i < Skv ? seg_kv[(size_t)b * Skv + kv_start + i] : -2;
  }

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  const int m_first = causal ? kv_start / BLOCK_M : 0;
  const int m_tiles = (Sq + BLOCK_M - 1) / BLOCK_M;
  for (int hh = 0; hh < groups; ++hh) {
    const int h = kvh * groups + hh;
    const size_t bh = (size_t)b * H + h;
    const bf16* q_base = q + ((size_t)b * Sq * H + h) * D;
    const bf16* do_base = dout + ((size_t)b * Sq * H + h) * D;
    for (int mt = m_first; mt < m_tiles; ++mt) {
      const int q_start = mt * BLOCK_M;
      __syncthreads();  // the previous tile's readers of sQ/sdO/sP/sdS are done
      load_tile_n<D, BLOCK_M, DSPLIT_THREADS>(sQ, q_base, q_stride, q_start, Sq);
      load_tile_n<D, BLOCK_M, DSPLIT_THREADS>(sdO, do_base, q_stride, q_start, Sq);
      for (int i = threadIdx.x; i < BLOCK_M; i += DSPLIT_THREADS) {
        const bool in = q_start + i < Sq;
        sLse[i] = in ? lse[bh * Sq + q_start + i] : 0.f;
        sDelta[i] = in ? delta[bh * Sq + q_start + i] : 0.f;
        if (segmented) sSegQ[i] = in ? seg_q[(size_t)b * Sq + q_start + i] : -1;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T for 16 query rows x 32 keys
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t qa[4], da[4];
        load_a_rows(qa, sQ + r16 * LD + ks * 16, LD, lane);
        load_a_rows(da, sdO + r16 * LD + ks * 16, LD, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t kb[2], vb[2];
          load_b_kcontig(kb, sK + (c32 + n * 8) * LD + ks * 16, LD, lane);
          load_b_kcontig(vb, sV + (c32 + n * 8) * LD + ks * 16, LD, lane);
          mma(s[n], qa, kb);
          mma(dp[n], da, vb);
        }
      }

      // P = exp(S * scale - lse), dS = P * (dP - delta); both to shared as bf16
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = r16 + g + (e >> 1) * 8;
          const int lc = c32 + n * 8 + t + (e & 1);
          const int r = q_start + lr, c = kv_start + lc;
          bool ok = r < Sq && c < Skv && (!causal || r >= c);
          if (segmented) ok = ok && sSegQ[lr] == sSegKv[lc];
          const float p = ok ? expf(s[n][e] * scale - sLse[lr]) : 0.f;
          const float ds = p * (dp[n][e] - sDelta[lr]);
          sP[lr * LDS + lc] = __float2bfloat16(p);
          sdS[lr * LDS + lc] = __float2bfloat16(ds);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for 16 keys x D/2 columns
#pragma unroll
      for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
        uint32_t pa[4], sa[4];
        load_a_cols(pa, sP + kk * 16 * LDS + r16, LDS, lane);
        load_a_cols(sa, sdS + kk * 16 * LDS + r16, LDS, lane);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          uint32_t ob[2], qb[2];
          load_b_ncontig(ob, sdO + kk * 16 * LD + dcol + n * 8, LD, lane);
          load_b_ncontig(qb, sQ + kk * 16 * LD + dcol + n * 8, LD, lane);
          mma(dv_acc[n], pa, ob);
          mma(dk_acc[n], sa, qb);
        }
      }

      // dQ += dS K for 16 query rows x D/2 columns; summed across key tiles by atomics
      float dq_part[DH / 8][4];
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) dq_part[n][0] = dq_part[n][1] = dq_part[n][2] = dq_part[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        uint32_t sa[4];
        load_a_rows(sa, sdS + r16 * LDS + kk * 16, LDS, lane);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          uint32_t kb[2];
          load_b_ncontig(kb, sK + kk * 16 * LD + dcol + n * 8, LD, lane);
          mma(dq_part[n], sa, kb);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q_start + r16 + g + i * 8;
        if (r >= Sq) continue;
        float* dq_row = dq + ((size_t)b * Sq + r) * q_stride + (size_t)h * D + dcol;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          atomicAdd(dq_row + n * 8 + t, dq_part[n][2 * i] * scale);
          atomicAdd(dq_row + n * 8 + t + 1, dq_part[n][2 * i + 1] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kv_start + r16 + g + i * 8;
    if (c >= Skv) continue;
    const size_t off = ((size_t)b * Skv + c) * kv_stride + (size_t)kvh * D + dcol;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + t) =
          pack_f32(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + t) =
          pack_f32(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_kv, void* o, float* lse, int B, int Sq, int Skv,
                       int H, int KH, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      seg_q, seg_kv, static_cast<bf16*>(o), lse, Sq, Skv, H, KH, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_kv, const void* dout, const float* lse,
                       const float* delta, float* dq, void* dk, void* dv, int B, int Sq,
                       int Skv, int H, int KH, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  // D > 64 takes the 8-warp kernel (see flash_bwd_kernel_dsplit); only one is built per D
  void (*kernel)(const bf16*, const bf16*, const bf16*, const int*, const int*, const bf16*,
                 const float*, const float*, float*, bf16*, bf16*, int, int, int, int, float,
                 int);
  int threads;
  if constexpr (D > 64) {
    kernel = flash_bwd_kernel_dsplit<D>;
    threads = DSPLIT_THREADS;
  } else {
    kernel = flash_bwd_kernel<D>;
    threads = NUM_THREADS;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BLOCK_N - 1) / BLOCK_N, B * KH);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      seg_q, seg_kv, static_cast<const bf16*>(dout), lse, delta, dq,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H, KH, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t; the caller
// checks inputs (bf16, contiguous, 16-byte aligned, D in {64, 128}, H % KH == 0)
// beforehand.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                         const int* seg_kv, void* o, float* lse, int B, int Sq, int Skv,
                         int H, int KH, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_fwd<64>(q, k, v, seg_q, seg_kv, o, lse, B, Sq, Skv, H, KH, scale,
                               causal, s);
  if (D == 128)
    return (int)launch_fwd<128>(q, k, v, seg_q, seg_kv, o, lse, B, Sq, Skv, H, KH, scale,
                                causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd(const void* q, const void* k, const void* v, const int* seg_q,
                         const int* seg_kv, const void* dout, const float* lse,
                         const float* delta, float* dq, void* dk, void* dv, int B, int Sq,
                         int Skv, int H, int KH, int D, float scale, int causal,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_bwd<64>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq,
                               Skv, H, KH, scale, causal, s);
  if (D == 128)
    return (int)launch_bwd<128>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq,
                                Skv, H, KH, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
