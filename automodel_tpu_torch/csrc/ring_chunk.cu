// Ring (context-parallel) attention chunk kernels for Hopper (sm_90a): one ring step
// forward and one ring step backward.
//
// Replaces the Pallas kernels of automodel_tpu/ops/pallas/ring_chunk.py:
//   ring_fwd  <- _chunk_fwd_kernel: merge the attention of the local q against one
//                visiting kv chunk into the online-softmax carry (acc, m, l)
//   ring_bwd  <- _chunk_bwd_kernel: dq partial plus the chunk's dk / dv from one s / p
//                recompute, given the global lse and delta
//
// Layouts (row form, as the TPU kernels): q (B*H, Sq, D), k / v (B*KH, Skv, D) bf16,
// contiguous; q row b*H + h reads kv row b*KH + h / (H / KH) (GQA). Positions and
// segment ids are int32 (B, Sq) / (B, Skv); segments are optional. The carry acc is
// (B*H, Sq, D) f32 and m / l are (B*H, Sq) f32; lse and delta are (B*H, Sq) f32; dq is
// (B*H, Sq, D) f32 and dk / dv are (B*KH, Skv, D) f32. Dv must equal D here (MLA's
// Dv != D runs in the plain version only).
//
// Masks come from data: global positions and segment ids travel with the chunks, so
// q row r may see key c when (not causal or pq[r] >= pkv[c]) and (no window or
// pq[r] - pkv[c] < window) and (no segments or sq[r] == skv[c]). A masked logit is
// -1e30 and a masked p is 0, as in the TPU kernels: a row with nothing allowed keeps
// m = -1e30, l = 0 and acc = 0, and exp(m_prev - m_new) stays finite.
//
// In place. ring_fwd reads the carry (acc, m, l) at its start and writes the updated,
// unnormalised carry back into the same buffers (the TPU kernel aliases them through
// input_output_aliases). ring_bwd adds dK / dV into dk / dv and dQ into dq, so the
// caller accumulates over the ring steps in f32 without extra buffers.
//
// What bounds it. Per q head a launch does 4*Sq*Skv*D operations forward (Q K^T and
// P V) and 10*Sq*Skv*D backward (S and dP, dV, dK, dQ). At the Llama-3-8B long-context
// step (cp 8 folded on one card, B 1, S_local 4096, H 32, KH 8, D 128) that is 2.2 TFLOP
// forward and 5.5 TFLOP backward a launch, 2.2 / 5.6 ms at the H100's 989 TFLOP/s
// dense bf16, against ~1.5 / ~2.5 GB of operands (0.45 / 0.75 ms at 3.35 TB/s): both
// are bound by operations. Positions are data, so there is no static block skipping:
// a causal ring computes the fully masked (q, kv) tile pairs too, about half of the
// work (a skip decided from each tile's position range is later work).
//
// Design, simple first, on flash_attention.cu's tiles (attention_tiles.cuh):
// ring_fwd runs one block of 4 warps per (64-row q tile, q row b*H + h), 16 rows a warp,
// the carry loaded into the accumulator registers at the start and the key tiles
// looped with their positions and segment ids in shared memory. ring_bwd runs one
// block of 8 warps per (64-key tile, kv row b*KH + kvh), looping over the GQA group's q
// heads and every q tile; dK / dV live in f32 registers split over the head dim (16 keys
// x D/2 a warp, as flash_bwd_kernel_dsplit) and are added into the chunk's dk / dv at
// the end (one block owns a tile, no atomics); dQ goes to dq by atomicAdd. Products
// run as mma.sync m16n8k16 bf16 with f32 accumulation; P (and, backward, dS) is
// rounded to bf16 before its products, as the TPU kernel casts p to v's dtype.

#include "attention_tiles.cuh"

namespace {

constexpr int FWD_THREADS = 128;  // 4 warps x 16 query rows
constexpr int BWD_THREADS = 256;  // 8 warps

struct Mask {
  int causal, has_window, window;
  const int* seg_q;  // nullptr: no segments

  __device__ __forceinline__ bool allowed(int pq, int pkv, int sq, int skv) const {
    bool ok = !causal || pq >= pkv;
    if (has_window) ok = ok && pq - pkv < window;
    if (seg_q != nullptr) ok = ok && sq == skv;
    return ok;
  }
};

template <int D>
constexpr int fwd_smem_bytes() {
  return (BLOCK_M + 2 * BLOCK_N) * (D + 8) * 2 + 2 * BLOCK_N * 4;
}

// grid (ceil(Sq / BLOCK_M), B * H); warp w owns query rows w*16 .. w*16+15 of the tile.
template <int D>
__global__ void __launch_bounds__(FWD_THREADS)
ring_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ pos_q,
                const int* __restrict__ pos_kv, const int* __restrict__ seg_q,
                const int* __restrict__ seg_kv, float* __restrict__ acc_carry,
                float* __restrict__ m_carry, float* __restrict__ l_carry, int Sq, int Skv,
                int H, int KH, float scale, Mask mask) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BLOCK_M * LD;
  bf16* sV = sK + BLOCK_N * LD;
  int* sPkv = reinterpret_cast<int*>(sV + BLOCK_N * LD);
  int* sSkv = sPkv + BLOCK_N;

  const int q_start = blockIdx.x * BLOCK_M;
  const int bn = blockIdx.y;
  const int b = bn / H;
  const int bk = b * KH + (bn % H) / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const bool segmented = seg_q != nullptr;

  const bf16* k_base = k + (size_t)bk * Skv * D;
  const bf16* v_base = v + (size_t)bk * Skv * D;
  load_tile_n<D, BLOCK_M, FWD_THREADS>(sQ, q + (size_t)bn * Sq * D, D, q_start, Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a_rows(qf[ks], sQ + warp * 16 * LD + ks * 16, LD, lane);

  const int row[2] = {q_start + warp * 16 + g, q_start + warp * 16 + g + 8};
  int pq[2] = {0, 0}, sq[2] = {0, 0};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < Sq;
    const size_t r = (size_t)bn * Sq + row[i];
    if (in) {
      pq[i] = pos_q[(size_t)b * Sq + row[i]];
      if (segmented) sq[i] = seg_q[(size_t)b * Sq + row[i]];
      m[i] = m_carry[r];
      l[i] = l_carry[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 a = make_float2(0.f, 0.f);
      if (in) a = *reinterpret_cast<const float2*>(acc_carry + r * D + n * 8 + t);
      acc[n][2 * i] = a.x;
      acc[n][2 * i + 1] = a.y;
    }
  }

  for (int kv_start = 0; kv_start < Skv; kv_start += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_n<D, BLOCK_N, FWD_THREADS>(sK, k_base, D, kv_start, Skv);
    load_tile_n<D, BLOCK_N, FWD_THREADS>(sV, v_base, D, kv_start, Skv);
    for (int i = threadIdx.x; i < BLOCK_N; i += FWD_THREADS) {
      const bool in = kv_start + i < Skv;
      sPkv[i] = in ? pos_kv[(size_t)b * Skv + kv_start + i] : 0;
      sSkv[i] = in && segmented ? seg_kv[(size_t)b * Skv + kv_start + i] : 0;
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

    // scale + mask; allowed bits kept so that masked entries give p = 0
    uint32_t allowed = 0u;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int lc = n * 8 + t + (e & 1);
        const bool ok = kv_start + lc < Skv && mask.allowed(pq[i], sPkv[lc], sq[i], sSkv[lc]);
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

    // acc += P V, P straight from the S accumulators (two n8 tiles = one k16 A operand)
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

  // the updated carry, unnormalised, back into the buffers it was read from
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const size_t r = (size_t)bn * Sq + row[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc_carry + r * D + n * 8 + t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    if ((lane & 3) == 0) {
      m_carry[r] = m[i];
      l_carry[r] = l[i];
    }
  }
}

template <int D>
constexpr int bwd_smem_bytes() {
  return (2 * BLOCK_N + 2 * BLOCK_M) * (D + 8) * 2 + 2 * BLOCK_M * LDS * 2 +
         (4 * BLOCK_M + 2 * BLOCK_N) * 4;
}

// grid (ceil(Skv / BLOCK_N), B * KH). Each block holds one K/V tile of the visiting chunk
// and loops over the q heads of its GQA group and over every q tile (positions are data:
// no causal start). Warp w: S and dP for query rows (w % 4) * 16 and keys (w / 4) * 32;
// dK / dV for keys (w % 4) * 16 and columns (w / 4) * D/2; dQ for query rows (w % 4) * 16
// and columns (w / 4) * D/2.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
ring_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ pos_q,
                const int* __restrict__ pos_kv, const int* __restrict__ seg_q,
                const int* __restrict__ seg_kv, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int Sq,
                int Skv, int H, int KH, float scale, Mask mask) {
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
  int* sPq = reinterpret_cast<int*>(sDelta + BLOCK_M);
  int* sSq = sPq + BLOCK_M;
  int* sPkv = sSq + BLOCK_M;
  int* sSkv = sPkv + BLOCK_N;

  const int kv_start = blockIdx.x * BLOCK_N;
  const int bk = blockIdx.y;
  const int b = bk / KH, kvh = bk % KH;
  const int groups = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int r16 = (warp & 3) * 16;    // this warp's 16 query rows, or 16 keys
  const int c32 = (warp >> 2) * 32;   // its 32 keys of S / dP
  const int dcol = (warp >> 2) * DH;  // its D/2 columns of dK / dV / dQ
  const bool segmented = seg_q != nullptr;

  load_tile_n<D, BLOCK_N, BWD_THREADS>(sK, k + (size_t)bk * Skv * D, D, kv_start, Skv);
  load_tile_n<D, BLOCK_N, BWD_THREADS>(sV, v + (size_t)bk * Skv * D, D, kv_start, Skv);
  for (int i = threadIdx.x; i < BLOCK_N; i += BWD_THREADS) {
    const bool in = kv_start + i < Skv;
    sPkv[i] = in ? pos_kv[(size_t)b * Skv + kv_start + i] : 0;
    sSkv[i] = in && segmented ? seg_kv[(size_t)b * Skv + kv_start + i] : 0;
  }

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  const int m_tiles = (Sq + BLOCK_M - 1) / BLOCK_M;
  for (int hh = 0; hh < groups; ++hh) {
    const size_t bn = (size_t)b * H + kvh * groups + hh;
    const bf16* q_base = q + bn * Sq * D;
    const bf16* do_base = dout + bn * Sq * D;
    for (int mt = 0; mt < m_tiles; ++mt) {
      const int q_start = mt * BLOCK_M;
      __syncthreads();  // the previous tile's readers of sQ/sdO/sP/sdS are done
      load_tile_n<D, BLOCK_M, BWD_THREADS>(sQ, q_base, D, q_start, Sq);
      load_tile_n<D, BLOCK_M, BWD_THREADS>(sdO, do_base, D, q_start, Sq);
      for (int i = threadIdx.x; i < BLOCK_M; i += BWD_THREADS) {
        const bool in = q_start + i < Sq;
        sLse[i] = in ? lse[bn * Sq + q_start + i] : 0.f;
        sDelta[i] = in ? delta[bn * Sq + q_start + i] : 0.f;
        sPq[i] = in ? pos_q[(size_t)b * Sq + q_start + i] : 0;
        sSq[i] = in && segmented ? seg_q[(size_t)b * Sq + q_start + i] : 0;
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

      // P = exp(S * scale - lse) with the global lse, dS = P * (dP - delta); to shared
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = r16 + g + (e >> 1) * 8;
          const int lc = c32 + n * 8 + t + (e & 1);
          const bool ok = q_start + lr < Sq && kv_start + lc < Skv &&
                          mask.allowed(sPq[lr], sPkv[lc], sSq[lr], sSkv[lc]);
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
        float* dq_row = dq + (bn * Sq + r) * D + dcol;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          atomicAdd(dq_row + n * 8 + t, dq_part[n][2 * i] * scale);
          atomicAdd(dq_row + n * 8 + t + 1, dq_part[n][2 * i + 1] * scale);
        }
      }
    }
  }

  // this block owns its keys' rows of dk / dv in this launch: plain read-add-write
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kv_start + r16 + g + i * 8;
    if (c >= Skv) continue;
    const size_t off = ((size_t)bk * Skv + c) * D + dcol;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      float2* pk = reinterpret_cast<float2*>(dk + off + n * 8 + t);
      float2* pv = reinterpret_cast<float2*>(dv + off + n * 8 + t);
      float2 a = *pk, c2 = *pv;
      a.x += dk_acc[n][2 * i] * scale;
      a.y += dk_acc[n][2 * i + 1] * scale;
      c2.x += dv_acc[n][2 * i];
      c2.y += dv_acc[n][2 * i + 1];
      *pk = a;
      *pv = c2;
    }
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_kv, const int* seg_q, const int* seg_kv, float* acc,
                       float* m, float* l, int B, int Sq, int Skv, int H, int KH, float scale,
                       Mask mask, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ring_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  ring_fwd_kernel<D><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      pos_q, pos_kv, seg_q, seg_kv, acc, m, l, Sq, Skv, H, KH, scale, mask);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_kv, const int* seg_q, const int* seg_kv,
                       const void* dout, const float* lse, const float* delta, float* dq,
                       float* dk, float* dv, int B, int Sq, int Skv, int H, int KH, float scale,
                       Mask mask, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ring_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BLOCK_N - 1) / BLOCK_N, B * KH);
  ring_bwd_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      pos_q, pos_kv, seg_q, seg_kv, static_cast<const bf16*>(dout), lse, delta, dq, dk, dv,
      Sq, Skv, H, KH, scale, mask);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t; the caller
// checks inputs (bf16 q/k/v, f32 carries and gradients, int32 positions and segments,
// all contiguous, D in {64, 128}, H % KH == 0) beforehand. seg_q / seg_kv are both
// null or both set; has_window = 0 ignores window.
extern "C" int ring_fwd(const void* q, const void* k, const void* v, const int* pos_q,
                        const int* pos_kv, const int* seg_q, const int* seg_kv, float* acc,
                        float* m, float* l, int B, int Sq, int Skv, int H, int KH, int D,
                        float scale, int causal, int has_window, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, has_window, window, seg_q};
  if (D == 64)
    return (int)launch_fwd<64>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, B, Sq, Skv,
                               H, KH, scale, mask, s);
  if (D == 128)
    return (int)launch_fwd<128>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, B, Sq, Skv,
                                H, KH, scale, mask, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ring_bwd(const void* q, const void* k, const void* v, const int* pos_q,
                        const int* pos_kv, const int* seg_q, const int* seg_kv,
                        const void* dout, const float* lse, const float* delta, float* dq,
                        float* dk, float* dv, int B, int Sq, int Skv, int H, int KH, int D,
                        float scale, int causal, int has_window, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, has_window, window, seg_q};
  if (D == 64)
    return (int)launch_bwd<64>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, dout, lse, delta, dq,
                               dk, dv, B, Sq, Skv, H, KH, scale, mask, s);
  if (D == 128)
    return (int)launch_bwd<128>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, dout, lse, delta, dq,
                                dk, dv, B, Sq, Skv, H, KH, scale, mask, s);
  return (int)cudaErrorInvalidValue;
}
