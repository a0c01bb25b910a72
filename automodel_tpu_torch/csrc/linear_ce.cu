// Fused linear cross-entropy for Hopper (sm_90a): z = logsumexp(h @ w) per token and
// its gradient, with the (tokens, vocab) logits never stored whole in device memory.
//
// Replaces the Pallas kernels of automodel_tpu/ops/pallas/linear_ce.py:
//   lce_fwd <- _fwd_kernel (:105, online logsumexp over vocab tiles; per-(vocab tile,
//              row) maxima `bmax` for the backward's block filter)
//   lce_bwd <- _bwd_dh_kernel (:137, dH = (softmax * dz) @ W^T) and, by function,
//              _bwd_dw_kernel (:163, dW = H^T @ (softmax * dz)), both skipping the
//              blocks the filter marks as insignificant. With dw null, lce_bwd is
//              _bwd_dh_kernel alone (a frozen unembedding, as under LoRA, where JAX's
//              jit drops the dW call): the dlogits recompute and the dH product per
//              chunk, the same launches in the same order, so dH is bitwise the full
//              call's; 4NEV instead of 6NEV.
//
// Layouts: h (N, E) bf16 row-major, N a multiple of 128 (the caller pads tokens with
// zero rows); w bf16 either (E, V) row-major or, with w_vmajor, (V, E) row-major (a
// tied embedding, read in place); E and V any positive size. z (N,) f32; bmax
// (ceil(V/128), N) f32; dz (N,) f32; sig (N/128, ceil(V/128)) int32 or null (null:
// every block is significant); dh (N, E) bf16 and dw bf16 in w's layout.
//
// What bounds it. At the slice shape (N = 8192, E = 2048, V = 128,256) the forward is
// 2NEV = 4.30 TFLOP, 4.35 ms at 989 TFLOP/s dense bf16, against 0.16 ms to read w:
// bound by operations. The backward needs the logits again and two products,
// 6NEV = 12.9 TFLOP, 13.05 ms: also bound by operations (at main path 7's N = 32768,
// E = 4096: 103 TFLOP, 104 ms).
//
// Design. The TPU kernels carry (block_n, E) and (E, block_v) f32 accumulators along a
// sequential grid axis; on Hopper a block has 227 KB of shared memory and blocks run
// in no order, so the backward is reshaped around one recompute of the logits, per
// vocab chunk of Vc columns (Vc chosen by the caller from a memory budget):
//   1. dlogits: S = h . w[:, chunk] recomputed, dl = exp(S - z) * dz rounded to bf16
//      (as the TPU kernel rounds dl to w's dtype) into an (N, Vc) bf16 buffer; a
//      (128-token, 128-vocab) block the filter skips is written as zeros;
//   2. dH (+)= dl . w[:, chunk]^T into an f32 scratch of dH's size, the last chunk
//      writing bf16 dH; K steps over insignificant blocks are skipped;
//   3. dW[:, chunk] = h^T . dl (for the tied (V, E) layout dW[chunk, :] = dl^T . h,
//      written in place), K steps over insignificant blocks skipped.
// 6NEV in all, no second recompute. Device memory beyond inputs and outputs: the
// (N, Vc) chunk buffer (268 MB at the slice shape), the f32 dH scratch when there is
// more than one chunk (67 MB), and the forward's partial (m, l) pairs (2 * N * splits
// f32; on the wgmma route splits = ceil(V / 256): 32.8 MB at the slice shape).
//
// Routes (picked by the wrapper, ops/linear_ce.py, from the shapes before the launch):
//   - lce_fwd_wgmma, when E and V are multiples of 8 (TMA's 16-byte strides): the
//     logits product of dlogits below (h K-major . w MN-major, or K-major tied) on the
//     Hopper core of gemm_sm90.cuh, one 128 x 256 tile a block on the same grouped
//     order, with an epilogue in registers (FwdEpi): each consumer warpgroup's half of
//     the accumulators is one 128-column vocab tile of its 64 rows, so it writes that
//     row's bmax entry, then the tile's (m, l) (one ex2 a logit) as one partial of
//     (ceil(V/256), N); lce_merge_kernel folds them into z. Columns past V, which TMA
//     fills with zeros (logit 0, not -inf), are masked out of both.
//   - lce_bwd_wgmma, on the same condition: the three
//     products on the Hopper core of gemm_sm90.cuh (TMA into 4 mbarrier stages, a
//     producer warpgroup, two wgmma consumer warpgroups, 128 x 256 tiles). The operands
//     are read in place through the descriptors' major-ness: dlogits h (K-major) . w
//     (MN-major, or K-major tied); dH dl (K-major) . w^T (K-major, or MN-major tied);
//     dW h^T (MN-major) . dl (MN-major), or tied dl^T (MN-major) . h (MN-major). The
//     epilogues stage the tile in shared memory and store 16 bytes a thread: exp(s - z)
//     * dz to bf16 for dlogits, the f32 add into the scratch (bf16 at the last chunk)
//     for dH, bf16 for dW. The filter is a K-step predicate both the TMA producer and
//     the consumers follow; a dlogits tile spans two vocab tiles and skips its
//     products when both are insignificant, zeroing either half that is. Blocks run
//     in groups of 16 row tiles, column by column, so that the blocks in flight share
//     their operands in L2.
//   - lce_bwd (mma.sync), any E and V (e.g. GPT-2's V = 50,257): 128 x 128 tiles, 8
//     warps, a three-stage cp.async ring (108 KB), ldmatrix and mma.sync m16n8k16,
//     scalar loads where a row is not 16-byte aligned, scalar bf16 stores.
//   - lce_fwd (mma.sync), any E and V, on that mainloop: a block owns 128 tokens and a
//     contiguous range of vocab tiles (the vocab is split across blocks so that N = 8192
//     gives ~2 blocks per SM), keeps (m, l) per row across its tiles and writes one
//     partial pair per split; lce_merge_kernel folds the splits into z.
// What it leaves on the table: the wgmma route's tiles pay their own prologue and
// epilogue with the tensor cores idle (the most for lce_fwd and dlogits, whose K is
// only E and whose epilogue takes an exp an element; gemm_sm90.cuh: a ping-pong of the
// consumer warpgroups would hide them); lce_fwd writes 8 bytes of partials a token a
// 256-column tile (131 MB at main path 7's shape) where a block walking several tiles
// would keep them in registers; the f32 dH scratch is read and written once per chunk
// (32 times, ~34 GB, at main path 7's N = 32768, where the buffer budget gives
// Vc = 4096).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;           // output tile rows
constexpr int BN = 128;           // output tile columns; also the vocab tile of bmax/sig
constexpr int BK = 64;            // K step
constexpr int STAGES = 3;         // depth of the cp.async ring
constexpr int TOK_TILE = 128;     // token granularity of sig
constexpr int NUM_THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int LDK = BK + 8;       // row stride of a tile stored K-contiguous ([row][k])
constexpr int LDR = 128 + 8;      // row stride of a tile stored row-contiguous ([k][col])
constexpr int STAGE_ELEMS = 128 * LDK;  // >= BK * LDR; one operand of one stage
constexpr int SMEM_BYTES = 2 * STAGES * STAGE_ELEMS * 2;  // A and B rings, dynamic
constexpr float NEG_INF = -1e30f;

static_assert(BK * LDR <= STAGE_ELEMS, "stage buffer too small");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one m16n8k16 tile (a row-major 16x16, b col-major 16x8, c 16x8 f32).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy a ROWS x COLS tile whose element (r, c) is g[(r0 + r) * ldg + c0 + c] into
// shared memory at s[r * LDS + c]; elements with r0 + r >= rlim or c0 + c >= clim are
// zero. `vec`: rows are 16-byte aligned (ldg % 8 == 0, g aligned, c0 % 8 == 0), so
// 16-byte cp.async copies with a zero-filled tail; otherwise plain scalar loads.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t ldg, int r0, int c0,
                                          int rlim, int clim, bool vec) {
  constexpr int CHUNKS = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* dst = s + r * LDS + c;
    if (vec) {
      int n = gr < rlim ? min(max(clim - gc, 0), 8) : 0;
      const bf16* src = n > 0 ? g + (size_t)gr * ldg + gc : g;
      cp_async16(dst, src, n * 2);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = (gr < rlim && gc + j < clim) ? g[(size_t)gr * ldg + gc + j]
                                              : __float2bfloat16(0.f);
      }
    }
  }
}

// One GEMM operand. A is (M x K), B is (K x N). KMAJ: stored with K contiguous, i.e.
// A(m, k) = p[m * ld + k] and B(k, n) = p[n * ld + k]; otherwise A(m, k) = p[k * ld + m]
// and B(k, n) = p[k * ld + n]. `klim` bounds K for this operand, `lim` bounds M or N.
struct Operand {
  const bf16* p;
  size_t ld;
  int lim;
  int klim;
  bool vec;
};

__host__ __device__ __forceinline__ bool aligned16(const bf16* p, size_t ld) {
  return (ld % 8) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool KMAJ>
__device__ __forceinline__ void load_operand(bf16* s, const Operand& op, int rc0, int k0) {
  if (KMAJ)
    load_tile<128, BK, LDK>(s, op.p, op.ld, rc0, k0, op.lim, op.klim, op.vec);
  else
    load_tile<BK, 128, LDR>(s, op.p, op.ld, k0, rc0, op.klim, op.lim, op.vec);
}

// A fragments of one m16k16 step at (m0, k0) of the stage tile.
template <bool KMAJ>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int m0, int k0, int lane) {
  if (KMAJ) {
    ldsm_x4(a, s + (m0 + (lane & 15)) * LDK + k0 + (lane >> 4) * 8);
  } else {
    const int j = lane >> 3, r = lane & 7;
    ldsm_x4_t(a, s + (k0 + (j >> 1) * 8 + r) * LDR + m0 + (j & 1) * 8);
  }
}

// B fragments of two n8 tiles (n0, n0 + 8) of one k16 step: b[0], b[1] for n0 and
// b[2], b[3] for n0 + 8.
template <bool KMAJ>
__device__ __forceinline__ void frag_b(uint32_t b[4], const bf16* s, int n0, int k0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  if (KMAJ)
    ldsm_x4(b, s + (n0 + (j >> 1) * 8 + r) * LDK + k0 + (j & 1) * 8);
  else
    ldsm_x4_t(b, s + (k0 + (j & 1) * 8 + r) * LDR + n0 + (j >> 1) * 8);
}

// Which K steps carry work: all of them, or those whose (token tile, vocab tile) block
// the filter marks significant.
struct KFilter {
  const int* sig;  // (num_t, num_vt) row-major, or null
  int num_vt;
  int mode;        // 0: all; 1: K runs over vocab (row = fixed token tile);
                   // 2: K runs over tokens (column = fixed vocab tile);
                   // 3: K runs over tokens (row = fixed vocab tile)
  int fixed;       // the fixed token tile (mode 1) or vocab tile (modes 2, 3)
  int k_tile0;     // vocab tile of K = 0 (mode 1)
  __device__ __forceinline__ bool active(int kt) const {
    if (sig == nullptr || mode == 0) return true;
    const int kg = (kt * BK) / 128;
    if (mode == 1) return sig[(size_t)fixed * num_vt + k_tile0 + kg] != 0;
    return sig[(size_t)kg * num_vt + fixed] != 0;
  }
  __device__ __forceinline__ int next(int kt, int nk) const {
    while (kt < nk && !active(kt)) ++kt;
    return kt;
  }
};

// acc[mi][ni][e] += A[m0 : m0+128, :K] @ B[:K, n0 : n0+128] for this warp's 64 x 32
// piece: rows wm*64 + mi*16 + g (+8 for e >= 2), columns wn*32 + ni*8 + t (+1 for odd e).
template <bool A_KMAJ, bool B_KMAJ>
__device__ void mainloop(float acc[4][4][4], bf16* smem, const Operand& A, const Operand& B,
                         int m0, int n0, int K, const KFilter& filt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  bf16* sA = smem;                           // STAGES slots of A
  bf16* sB = smem + STAGES * STAGE_ELEMS;    // STAGES slots of B
  const int nk = (K + BK - 1) / BK;
  // K steps in flight: `loaded` issued, `used` consumed; slot of step i is i % STAGES.
  // One commit group per loop turn (empty once K runs out), so wait_group<STAGES-2>
  // at turn i means step i has landed.
  int fetch = filt.next(0, nk), loaded = 0, used = 0;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fetch < nk) {
      load_operand<A_KMAJ>(sA + s * STAGE_ELEMS, A, m0, fetch * BK);
      load_operand<B_KMAJ>(sB + s * STAGE_ELEMS, B, n0, fetch * BK);
      ++loaded;
      fetch = filt.next(fetch + 1, nk);
    }
    cp_async_commit();
  }
  while (used < loaded) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step `used` is visible; every warp is done with step used - 1
    if (fetch < nk) {
      const int slot = (used + STAGES - 1) % STAGES;  // the slot of step used - 1
      load_operand<A_KMAJ>(sA + slot * STAGE_ELEMS, A, m0, fetch * BK);
      load_operand<B_KMAJ>(sB + slot * STAGE_ELEMS, B, n0, fetch * BK);
      ++loaded;
      fetch = filt.next(fetch + 1, nk);
    }
    cp_async_commit();
    const bf16* a_s = sA + (used % STAGES) * STAGE_ELEMS;
    const bf16* b_s = sB + (used % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) frag_a<A_KMAJ>(a[mi], a_s, wm * 64 + mi * 16, ks, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) frag_b<B_KMAJ>(b[nj], b_s, wn * 32 + nj * 16, ks, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    ++used;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller's next mainloop
}

__device__ __forceinline__ void zero_acc(float acc[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// The unembedding as the B operand (K = E, N = V) of the logits product.
template <bool W_VMAJ>
__device__ __forceinline__ Operand w_operand(const bf16* w, int E, int V) {
  const size_t ld = W_VMAJ ? (size_t)E : (size_t)V;
  return Operand{w, ld, V, E, aligned16(w, ld)};
}

// Forward. grid (N / 128, splits): block (t, s) owns tokens [128 t, 128 t + 128) and
// vocab tiles [s * per, min((s + 1) * per, num_vt)).
template <bool W_VMAJ>
__global__ void __launch_bounds__(NUM_THREADS)
lce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w, float* __restrict__ bmax,
               float* __restrict__ part_m, float* __restrict__ part_l, int N, int E, int V,
               int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  __shared__ float red_max[4][BM];
  __shared__ float red_sum[4][BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int m0 = blockIdx.x * BM;
  const int num_vt = (V + BN - 1) / BN;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, num_vt);
  const Operand A{h, (size_t)E, N, E, aligned16(h, E)};
  const Operand B = w_operand<W_VMAJ>(w, E, V);
  const KFilter all{nullptr, 0, 0, 0, 0};

  float m_run = NEG_INF, l_run = 0.f;  // row threadIdx.x (< 128) of the tile
  float acc[4][4][4];
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int n0 = vt * BN;
    zero_acc(acc);
    mainloop<true, W_VMAJ>(acc, smem, A, B, m0, n0, E, all);

    // row maxima over this thread's valid columns, then across the quad and the 4 warps
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x = NEG_INF;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + wn * 32 + ni * 8 + t + c;
            if (col < V) x = fmaxf(x, acc[mi][ni][hf * 2 + c]);
          }
        }
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if ((lane & 3) == 0) red_max[wn][wm * 64 + mi * 16 + g + hf * 8] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm * 64 + mi * 16 + g + hf * 8;
        const float mt = fmaxf(fmaxf(red_max[0][r], red_max[1][r]),
                               fmaxf(red_max[2][r], red_max[3][r]));
        float sum = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n0 + wn * 32 + ni * 8 + t + c;
            if (col < V) sum += expf(acc[mi][ni][hf * 2 + c] - mt);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if ((lane & 3) == 0) red_sum[wn][r] = sum;
      }
    }
    __syncthreads();
    if (threadIdx.x < BM) {
      const int r = threadIdx.x;
      const float mt = fmaxf(fmaxf(red_max[0][r], red_max[1][r]),
                             fmaxf(red_max[2][r], red_max[3][r]));
      const float st = red_sum[0][r] + red_sum[1][r] + red_sum[2][r] + red_sum[3][r];
      if (m0 + r < N) bmax[(size_t)vt * N + m0 + r] = mt;
      const float m_new = fmaxf(m_run, mt);
      l_run = l_run * expf(m_run - m_new) + st * expf(mt - m_new);
      m_run = m_new;
    }
    // red_max / red_sum are rewritten only after the next mainloop's barriers
  }
  if (threadIdx.x < BM && m0 + threadIdx.x < N) {
    part_m[(size_t)blockIdx.y * N + m0 + threadIdx.x] = m_run;
    part_l[(size_t)blockIdx.y * N + m0 + threadIdx.x] = l_run;
  }
}

// z[row] = logsumexp over the splits' partial (m, l); a row whose l is 0 everywhere
// gives -1e30, as the TPU kernel's finalize.
__global__ void lce_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                 float* __restrict__ z, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[(size_t)s * N + row]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s)
    l += part_l[(size_t)s * N + row] * expf(part_m[(size_t)s * N + row] - m);
  z[row] = l == 0.f ? NEG_INF : m + logf(l);
}

// dlogits for one vocab chunk. grid (N / 128, chunk_tiles): tile (t, j) covers vocab
// tile vt0 + j; dl[row, j * 128 + c] = exp(s - z[row]) * dz[row] in bf16, 0 past V or
// where the filter skips the block.
template <bool W_VMAJ>
__global__ void __launch_bounds__(NUM_THREADS)
lce_dlogits_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                   const float* __restrict__ z, const float* __restrict__ dz,
                   const int* __restrict__ sig, bf16* __restrict__ dl, int N, int E, int V,
                   int vt0, size_t ldl) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int m0 = blockIdx.x * BM;
  const int vt = vt0 + blockIdx.y;
  const int n0 = vt * BN;
  const int num_vt = (V + BN - 1) / BN;
  const bool live = sig == nullptr || sig[(size_t)blockIdx.x * num_vt + vt] != 0;

  float acc[4][4][4];
  zero_acc(acc);
  if (live) {
    const Operand A{h, (size_t)E, N, E, aligned16(h, E)};
    const Operand B = w_operand<W_VMAJ>(w, E, V);
    const KFilter all{nullptr, 0, 0, 0, 0};
    mainloop<true, W_VMAJ>(acc, smem, A, B, m0, n0, E, all);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
      if (row >= N) continue;
      const float zr = z[row], dzr = dz[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cl = wn * 32 + ni * 8 + t + c;
          const float x = (live && n0 + cl < V) ? expf(acc[mi][ni][hf * 2 + c] - zr) * dzr : 0.f;
          dl[(size_t)row * ldl + (size_t)blockIdx.y * BN + cl] = __float2bfloat16(x);
        }
      }
    }
  }
}

// C = A @ B over 128 x 128 tiles, grid (ceil(N / 128), ceil(M / 128)). Epilogue: with
// `out` null, acc32[m, n] = acc (+ acc32[m, n] if beta); with `out` set,
// out[m, n] = bf16(acc (+ acc32[m, n] if beta)) for n < out_nlim.
template <bool A_KMAJ, bool B_KMAJ>
__global__ void __launch_bounds__(NUM_THREADS)
lce_gemm_kernel(Operand A, Operand B, int M, int N, int K, KFilter filt,
                float* __restrict__ acc32, size_t ld32, int beta, bf16* __restrict__ out,
                size_t ldc, int out_nlim) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (filt.mode == 1) filt.fixed = m0 / TOK_TILE;
  if (filt.mode == 2) filt.fixed += n0 / BN;
  if (filt.mode == 3) filt.fixed += m0 / BM;

  float acc[4][4][4];
  zero_acc(acc);
  mainloop<A_KMAJ, B_KMAJ>(acc, smem, A, B, m0, n0, K, filt);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + wn * 32 + ni * 8 + t + c;
          if (col >= N) continue;
          float x = acc[mi][ni][hf * 2 + c];
          if (beta) x += acc32[(size_t)row * ld32 + col];
          if (out == nullptr)
            acc32[(size_t)row * ld32 + col] = x;
          else if (col < out_nlim)
            out[(size_t)row * ldc + col] = __float2bfloat16(x);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- wgmma route

static_assert(TOK_TILE == 2 * sm90::BK && BN == 2 * sm90::BK, "a filter tile is two K steps");
static_assert(sm90::BM == TOK_TILE && sm90::BN == 2 * BN, "a core tile is two vocab tiles wide");

// lce_bwd's block filter as the core's K-step predicate. sig (num_t, num_vt) int32, or
// null (every step). A core tile is 128 rows by two 128-column vocab tiles; a K step is
// half a token or vocab tile.
struct SigFilter {
  enum Mode { DLOGITS, DH, DW_COLS, DW_ROWS };
  const int* sig;
  int num_vt;
  int vt_end;  // one past the chunk's last vocab tile
  int mode;
  int t;       // the token tile (DLOGITS, DH)
  int vt;      // the vocab tile of the block's first column (DLOGITS, DW_COLS), row
               // (DW_ROWS) or K step 0 (DH); the chunk's first before at()

  __device__ void at(int m0, int n0) {
    t = m0 / TOK_TILE;
    if (mode == DLOGITS || mode == DW_COLS) vt += n0 / BN;
    if (mode == DW_ROWS) vt += m0 / BN;
  }
  __device__ bool live(int tt, int v) const {
    return sig == nullptr || (v < vt_end && sig[(size_t)tt * num_vt + v] != 0);
  }
  __device__ bool skips() const { return sig != nullptr; }
  __device__ bool active(int k) const {
    switch (mode) {
      case DLOGITS: return live(t, vt) || live(t, vt + 1);  // the whole tile
      case DH: return live(t, vt + k / 2);                   // K runs over vocab
      case DW_COLS: return live(k / 2, vt) || live(k / 2, vt + 1);  // K over tokens
      default: return live(k / 2, vt);
    }
  }
};

// dl[m0 + r, n0 + c] = bf16(exp(s - z) * dz) for the chunk's columns n0 + c < ncols;
// zero past the vocab (vlim) and in a vocab tile the filter skips.
struct DLogitsEpi {
  static constexpr bool F32 = false;
  const float* z;
  const float* dz;
  bf16* dl;
  size_t ldl;
  int vlim, ncols;
  int m0, n0;
  bool live[2];
  __device__ void at(int m, int n, const SigFilter& f) {
    m0 = m, n0 = n;
    live[0] = f.live(f.t, f.vt);
    live[1] = f.live(f.t, f.vt + 1);
  }
  struct Row {
    float z, dz;
  };
  __device__ Row row(int r) const { return {z[m0 + r], dz[m0 + r]}; }
  __device__ float apply(const Row& row, int c, float x) const {
    return (live[c / BN] && n0 + c < vlim) ? __expf(x - row.z) * row.dz : 0.f;
  }
  __device__ void store(int r, int c, const uint4& v) const {
    if (n0 + c < ncols) *reinterpret_cast<uint4*>(dl + (size_t)(m0 + r) * ldl + n0 + c) = v;
  }
};

// dH: acc (+ dh32 if beta) into the f32 scratch, or at the last chunk into bf16 dh.
struct DhEpi {
  static constexpr bool F32 = true;
  float* dh32;
  bf16* dh;
  int E, beta, last;
  int m0, n0;
  __device__ void at(int m, int n, const SigFilter&) { m0 = m, n0 = n; }
  __device__ void store(int r, int c, float4 a, float4 b) const {
    if (n0 + c >= E) return;
    const size_t off = (size_t)(m0 + r) * E + n0 + c;
    if (beta) {
      const float4 p = *reinterpret_cast<const float4*>(dh32 + off);
      const float4 q = *reinterpret_cast<const float4*>(dh32 + off + 4);
      a = make_float4(a.x + p.x, a.y + p.y, a.z + p.z, a.w + p.w);
      b = make_float4(b.x + q.x, b.y + q.y, b.z + q.z, b.w + q.w);
    }
    if (last) {
      *reinterpret_cast<uint4*>(dh + off) =
          uint4{sm90::pack_bf16x2(a.x, a.y), sm90::pack_bf16x2(a.z, a.w),
                sm90::pack_bf16x2(b.x, b.y), sm90::pack_bf16x2(b.z, b.w)};
    } else {
      *reinterpret_cast<float4*>(dh32 + off) = a;
      *reinterpret_cast<float4*>(dh32 + off + 4) = b;
    }
  }
};

// dW: bf16 stores of the tile at (m0, n0) of the chunk's slice of dw.
struct DwEpi : sm90::StoreBf16 {
  __device__ void at(int m, int n, const SigFilter&) { r0 = m, c0 = n; }
};

// 2^x in one MUFU.EX2; the arguments here are <= 0, so the flush of results below
// 2^-126 to 0 loses nothing a sum of such terms could hold.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lce_fwd on the core, in registers: a tile is 128 tokens by two 128-column vocab tiles,
// acc[h] of a consumer warpgroup one vocab tile of its 64 rows. For each row it writes
// the vocab tiles' maxima over columns < V to bmax (ceil(V/128), N), and the tile's
// (m, l) = (max, sum of exp(s - max)) over those columns to the partials
// (ceil(V/256), N), which lce_merge_kernel folds into z. TMA fills columns past V with
// zeros, which would read as logit 0: they are masked, not read.
struct FwdEpi : sm90::RegsEpilogue {
  float* bmax;
  float* part_m;
  float* part_l;
  int N, V;
  int m0, n0;
  __device__ void at(int m, int n, const SigFilter&) { m0 = m, n0 = n; }
  __device__ void regs(float (&acc)[2][64], int cw, int t) const {
    constexpr float LOG2E = 1.4426950408889634f;
    const int warp = t / 32, lane = t % 32, g = lane / 4, tc = (lane % 4) * 2;
    const int ncols = min(V - n0, sm90::BN);  // columns < V in this tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows g and g + 8 of this warp's 16
      const int row = m0 + cw * 64 + warp * 16 + g + 8 * i;
      float mh[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = NEG_INF;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (h * 128 + 8 * j + tc + c < ncols) x = fmaxf(x, acc[h][4 * j + 2 * i + c]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));  // the quad shares the row
        mh[h] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (tc == 0 && h * 128 < ncols) bmax[(size_t)(n0 / BN + h) * N + row] = mh[h];
      }
      const float m = fmaxf(mh[0], mh[1]), ms = m * LOG2E;
      float l = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (h * 128 + 8 * j + tc + c < ncols)
              l += ex2(fmaf(acc[h][4 * j + 2 * i + c], LOG2E, -ms));
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (tc == 0) {
        part_m[(size_t)(n0 / sm90::BN) * N + row] = m;
        part_l[(size_t)(n0 / sm90::BN) * N + row] = l;
      }
    }
  }
};

constexpr int GROUP_ROWS = 16;  // row tiles of a group in the block order below

// One tile of one of lce_bwd's products: grid (ceil(cols / 256), ceil(rows / 128)).
// B's n coordinate is offset by b_n (dlogits: the chunk's first vocab column), its k
// coordinate by b_k0 (dH: the same).
template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(sm90::THREADS, 1)
lce_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                int b_n, int b_k0, int nk, SigFilter filt, Epi epi) {
  // Blocks run in groups of GROUP_ROWS row tiles, column by column, so that the blocks
  // in flight share their A rows and B columns in L2 (row by row, the 132 blocks in
  // flight would stream every column of B, 64 MB of w for dlogits, for one or two row
  // tiles).
  const int num_n = gridDim.x, num_m = gridDim.y;
  const int pid = blockIdx.y * num_n + blockIdx.x;
  const int first = pid / (GROUP_ROWS * num_n) * GROUP_ROWS;
  const int rows = min(num_m - first, GROUP_ROWS);
  const int in_group = pid - first * num_n;
  const int m0 = (first + in_group % rows) * sm90::BM, n0 = in_group / rows * sm90::BN;
  filt.at(m0, n0);
  epi.at(m0, n0, filt);
  sm90::gemm_tile<A_MN, B_MN>(&ta, &tb, sm90::Tile{m0, b_n + n0, b_k0, 0, nk}, filt, epi);
}

template <bool A_MN, bool B_MN, class Epi>
cudaError_t launch_sm90(const CUtensorMap& ta, const CUtensorMap& tb, int cols, int rows,
                        int b_n, int b_k0, int nk, const SigFilter& filt, const Epi& epi,
                        cudaStream_t s) {
  const auto kernel = lce_sm90_kernel<A_MN, B_MN, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((cols + sm90::BN - 1) / sm90::BN, (rows + sm90::BM - 1) / sm90::BM);
  kernel<<<grid, sm90::THREADS, sm90::SMEM, s>>>(ta, tb, b_n, b_k0, nk, filt, epi);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t; the caller
// checks inputs beforehand (see the layout note at the top) and allocates every
// output and scratch buffer.

// z (N,), bmax (ceil(V/128), N); part_m / part_l (splits, N) f32 scratch.
extern "C" int lce_fwd(const void* h, const void* w, float* z, float* bmax, float* part_m,
                       float* part_l, int N, int E, int V, int w_vmajor, int splits,
                       void* stream) {
  if (N % TOK_TILE || E < 1 || V < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_vt = (V + BN - 1) / BN;
  const int per = (num_vt + splits - 1) / splits;
  splits = (num_vt + per - 1) / per;  // no empty split
  const auto kernel = w_vmajor ? lce_fwd_kernel<true> : lce_fwd_kernel<false>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N / BM, splits), NUM_THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), bmax, part_m, part_l, N, E, V,
      per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lce_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part_m, part_l, z, N, splits);
  return (int)cudaGetLastError();
}

// The wgmma route of lce_fwd (E % 8 == 0, V % 8 == 0, h and w 16-byte aligned), with
// lce_fwd's arguments; the partials are one (m, l) pair per 256-column tile, so
// splits must be ceil(V / 256).
extern "C" int lce_fwd_wgmma(const void* h, const void* w, float* z, float* bmax, float* part_m,
                             float* part_l, int N, int E, int V, int w_vmajor, int splits,
                             void* stream) {
  if (N % TOK_TILE || E < 1 || V < 1 || E % 8 || V % 8 ||
      splits != (V + sm90::BN - 1) / sm90::BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // h K-major, w as dlogits reads it (MN-major, or K-major tied)
  CUtensorMap h_k, w_dl;
  const uint64_t wn = (uint64_t)E * V;
  cudaError_t err = sm90::operand_map(&h_k, h, E, N, E, 1, (uint64_t)N * E,
                                      sm90::box_rows(true, false));
  if (err == cudaSuccess)
    err = w_vmajor ? sm90::operand_map(&w_dl, w, E, V, E, 1, wn, sm90::box_rows(false, false))
                   : sm90::operand_map(&w_dl, w, V, E, V, 1, wn, sm90::box_rows(false, true));
  if (err != cudaSuccess) return (int)err;
  const int num_vt = (V + BN - 1) / BN;
  const SigFilter all{nullptr, num_vt, num_vt, SigFilter::DLOGITS, 0, 0};
  const FwdEpi epi{{}, bmax, part_m, part_l, N, V, 0, 0};
  const int e_steps = (E + sm90::BK - 1) / sm90::BK;
  err = w_vmajor ? launch_sm90<false, false>(h_k, w_dl, V, N, 0, 0, e_steps, all, epi, s)
                 : launch_sm90<false, true>(h_k, w_dl, V, N, 0, 0, e_steps, all, epi, s);
  if (err != cudaSuccess) return (int)err;
  lce_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part_m, part_l, z, N, splits);
  return (int)cudaGetLastError();
}

// dh (N, E) bf16; dw bf16 in w's layout, or null for dH alone (no dW product is
// launched). dl: (N, chunk) bf16 scratch, chunk a multiple of 128; dh32: (N, E) f32
// scratch, needed when V > chunk (else may be null). sig may be null. The mma.sync
// route: any E and V.
extern "C" int lce_bwd(const void* h, const void* w, const float* z, const float* dz,
                       const int* sig, void* dh, void* dw, void* dl, float* dh32, int N, int E,
                       int V, int w_vmajor, int chunk, void* stream) {
  if (N % TOK_TILE || E < 1 || V < 1 || chunk < BN || chunk % BN)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (V + chunk - 1) / chunk;
  if (n_chunks > 1 && dh32 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* dlp = static_cast<bf16*>(dl);
  bf16* dwp = static_cast<bf16*>(dw);
  const int num_vt = (V + BN - 1) / BN;
  const int e_tiles = (E + BN - 1) / BN;
  const auto dlogits = w_vmajor ? lce_dlogits_kernel<true> : lce_dlogits_kernel<false>;
  // dH's B operand is w^T: K-major in the (E, V) layout, row-contiguous in (V, E)
  const auto gemm_dh = w_vmajor ? lce_gemm_kernel<true, false> : lce_gemm_kernel<true, true>;
  cudaError_t err = allow_smem(dlogits);
  if (err == cudaSuccess) err = allow_smem(gemm_dh);
  if (err == cudaSuccess) err = allow_smem(lce_gemm_kernel<false, false>);
  if (err != cudaSuccess) return (int)err;
  for (int c = 0; c < n_chunks; ++c) {
    const int v0 = c * chunk;
    const int width = min(chunk, V - v0);       // real vocab columns of this chunk
    const int tiles = (width + BN - 1) / BN;
    const int kpad = tiles * BN;                // columns of dl written for this chunk
    const int vt0 = v0 / BN;
    dlogits<<<dim3(N / BM, tiles), NUM_THREADS, SMEM_BYTES, s>>>(
        hp, wp, z, dz, sig, dlp, N, E, V, vt0, (size_t)chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // dH (+)= dl (N x kpad) @ w[:, v0 : v0 + width]^T
    const bool last = c == n_chunks - 1;
    const Operand a_dl{dlp, (size_t)chunk, N, kpad, aligned16(dlp, chunk)};
    const bf16* w_c = w_vmajor ? wp + (size_t)v0 * E : wp + v0;
    const size_t ld_w = w_vmajor ? (size_t)E : (size_t)V;
    const Operand b_wt{w_c, ld_w, E, width, aligned16(w_c, ld_w)};
    const KFilter f_dh{sig, num_vt, 1, 0, vt0};
    gemm_dh<<<dim3(e_tiles, N / BM), NUM_THREADS, SMEM_BYTES, s>>>(
        a_dl, b_wt, N, E, kpad, f_dh, dh32, (size_t)E, c > 0 ? 1 : 0,
        last ? static_cast<bf16*>(dh) : nullptr, (size_t)E, E);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    if (dwp == nullptr) continue;  // dH alone
    if (w_vmajor) {
      // dW[v0 : v0 + width, :] = dl^T (width x N) @ h (N x E)
      const Operand a_dlt{dlp, (size_t)chunk, kpad, N, aligned16(dlp, chunk)};
      const Operand b_h{hp, (size_t)E, E, N, aligned16(hp, E)};
      const KFilter f_dw{sig, num_vt, 3, vt0, 0};
      lce_gemm_kernel<false, false><<<dim3(e_tiles, tiles), NUM_THREADS, SMEM_BYTES, s>>>(
          a_dlt, b_h, width, E, N, f_dw, nullptr, 0, 0, dwp + (size_t)v0 * E, (size_t)E, E);
    } else {
      // dW[:, v0 : v0 + width] = h^T (E x N) @ dl (N x kpad)
      const Operand a_ht{hp, (size_t)E, E, N, aligned16(hp, E)};
      const Operand b_dl{dlp, (size_t)chunk, kpad, N, aligned16(dlp, chunk)};
      const KFilter f_dw{sig, num_vt, 2, vt0, 0};
      lce_gemm_kernel<false, false><<<dim3(tiles, e_tiles), NUM_THREADS, SMEM_BYTES, s>>>(
          a_ht, b_dl, E, kpad, N, f_dw, nullptr, 0, 0, dwp + v0, (size_t)V, width);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The wgmma route of lce_bwd (E % 8 == 0, V % 8 == 0, h and w 16-byte aligned), with
// lce_bwd's arguments (dw null: dH alone).
extern "C" int lce_bwd_wgmma(const void* h, const void* w, const float* z, const float* dz,
                             const int* sig, void* dh, void* dw, void* dl, float* dh32, int N,
                             int E, int V, int w_vmajor, int chunk, void* stream) {
  if (N % TOK_TILE || E < 1 || V < 1 || E % 8 || V % 8 || chunk < BN || chunk % BN)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (V + chunk - 1) / chunk;
  if (n_chunks > 1 && dh32 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_vt = (V + BN - 1) / BN;
  // h as the K-major A of dlogits, and MN-major (dW's A untied, B tied); w as dlogits'
  // B and as dH's B = w^T
  CUtensorMap h_k, h_mn, w_dl, w_dh;
  const uint64_t hn = (uint64_t)N * E, wn = (uint64_t)E * V;
  cudaError_t err = sm90::operand_map(&h_k, h, E, N, E, 1, hn, sm90::box_rows(true, false));
  if (err == cudaSuccess) err = sm90::operand_map(&h_mn, h, E, N, E, 1, hn, 64);
  if (err == cudaSuccess)
    err = w_vmajor ? sm90::operand_map(&w_dl, w, E, V, E, 1, wn, sm90::box_rows(false, false))
                   : sm90::operand_map(&w_dl, w, V, E, V, 1, wn, sm90::box_rows(false, true));
  if (err == cudaSuccess)
    err = w_vmajor ? sm90::operand_map(&w_dh, w, E, V, E, 1, wn, sm90::box_rows(false, true))
                   : sm90::operand_map(&w_dh, w, V, E, V, 1, wn, sm90::box_rows(false, false));
  if (err != cudaSuccess) return (int)err;
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
    const int v0 = c * chunk;
    const int width = min(chunk, V - v0);  // real vocab columns of this chunk
    const int kpad = (width + BN - 1) / BN * BN;  // columns of dl written for this chunk
    const int vt0 = v0 / BN, vt_end = vt0 + kpad / BN;
    // dl (N, kpad) with rows `chunk` apart: K-major A of dH, MN-major for dW
    CUtensorMap dl_k, dl_mn;
    const uint64_t dln = (uint64_t)N * chunk;
    err = sm90::operand_map(&dl_k, dl, kpad, N, chunk, 1, dln, sm90::box_rows(true, false));
    if (err == cudaSuccess) err = sm90::operand_map(&dl_mn, dl, kpad, N, chunk, 1, dln, 64);
    if (err != cudaSuccess) break;

    const SigFilter f_dl{sig, num_vt, vt_end, SigFilter::DLOGITS, 0, vt0};
    const DLogitsEpi e_dl{z, dz, static_cast<bf16*>(dl), (size_t)chunk, V - v0, kpad};
    const int e_steps = (E + sm90::BK - 1) / sm90::BK;
    err = w_vmajor ? launch_sm90<false, false>(h_k, w_dl, kpad, N, v0, 0, e_steps, f_dl, e_dl, s)
                   : launch_sm90<false, true>(h_k, w_dl, kpad, N, v0, 0, e_steps, f_dl, e_dl, s);
    if (err != cudaSuccess) break;

    const bool last = c == n_chunks - 1;
    const SigFilter f_dh{sig, num_vt, vt_end, SigFilter::DH, 0, vt0};
    const DhEpi e_dh{dh32, static_cast<bf16*>(dh), E, c > 0 ? 1 : 0, last ? 1 : 0};
    const int v_steps = kpad / sm90::BK;
    err = w_vmajor ? launch_sm90<false, true>(dl_k, w_dh, E, N, 0, v0, v_steps, f_dh, e_dh, s)
                   : launch_sm90<false, false>(dl_k, w_dh, E, N, 0, v0, v_steps, f_dh, e_dh, s);
    if (err != cudaSuccess) break;

    if (dw == nullptr) continue;  // dH alone
    const int t_steps = N / sm90::BK;
    bf16* dwp = static_cast<bf16*>(dw);
    if (w_vmajor) {
      // dW[v0 : v0 + width, :] = dl^T (width x N) . h (N x E)
      const SigFilter f_dw{sig, num_vt, vt_end, SigFilter::DW_ROWS, 0, vt0};
      DwEpi e_dw;
      e_dw.out = dwp + (size_t)v0 * E, e_dw.ld = E, e_dw.r_end = width, e_dw.c_end = E;
      err = launch_sm90<true, true>(dl_mn, h_mn, E, width, 0, 0, t_steps, f_dw, e_dw, s);
    } else {
      // dW[:, v0 : v0 + width] = h^T (E x N) . dl (N x kpad)
      const SigFilter f_dw{sig, num_vt, vt_end, SigFilter::DW_COLS, 0, vt0};
      DwEpi e_dw;
      e_dw.out = dwp + v0, e_dw.ld = V, e_dw.r_end = E, e_dw.c_end = width;
      err = launch_sm90<true, true>(h_mn, dl_mn, kpad, E, 0, 0, t_steps, f_dw, e_dw, s);
    }
  }
  return (int)err;
}
