// Flash attention for Hopper (sm_90a): a forward kernel and a backward split in two.
//
// Replaces the Pallas kernels of automodel_tpu/ops/pallas/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (online-softmax forward, emits O and the logsumexp;
//                 sliding window, per-head sink logits and the tanh logit soft-cap as
//                 the TPU kernel has them)
//   flash_dq   <- _dq_kernel (q-stationary dQ: a block walks the key tiles in order
//                 and sums dQ in registers, so dQ is the same on every run)
//   flash_dkv  <- _dkv_kernel (kv-stationary dK, dV; their GQA group sum is in
//                 registers and in a fixed order)
// The pair also stands for _dqdkv_kernel, the fused backward that the TPU package
// picks by default: flash_dq does 3 products a (q, k) pair (S, dP, dQ) and flash_dkv 4
// (S, dP, dV, dK), one recompute of S and dP more than a fused kernel's 5, but a
// fused kernel must sum each key tile's dQ share across blocks, and on the card that
// sum (f32 reduce-adds into a zeroed buffer, then a cast) cost more than the recompute
// and landed in no fixed order.
//
// Layouts: q/o (B, Sq, H, D), k/v (B, Skv, KH, D), bf16, contiguous; GQA maps q head
// h to kv head h / (H / KH). lse and delta are (B*H, Sq) f32. Segment ids are
// optional int32 (B, Sq) / (B, Skv). Masks: causal (absolute index q >= kv), a sliding
// window (q - kv < window, a runtime (has_window, window) pair as the ring kernels take
// it) and segment equality. A row with no allowed key gives O = 0 and lse = -1e30, as the
// TPU kernel's finalize. Sinks (flash_fwd only): an optional f32 (H,) logit a q head,
// folded into the softmax denominator in the epilogue as _fwd_kernel's finalize does
// (m' = max(m, sink), l' = l 2^(m - m') + 2^(sink - m'), O rescaled by the new l), so lse
// holds the sink and the backward kernels need no sink input (a row with no allowed key
// then gives O = 0 and lse = sink). The sink is a raw logit: it takes log2(e) only, never
// the softmax scale. Its gradient, -sum_i 2^(sink - lse_i) delta_i, is a reduction over
// lse and delta outside the kernels (ops/flash_attention.py), as in the TPU package.
//
// What bounds it. At the Llama-3.2-1B training shape (B=4, S=2048, H=32, KH=8, D=64,
// causal) the forward does 4*B*H*S^2*D/2 = 68.7 GFLOP, 69 us at the H100's 989
// TFLOP/s dense bf16; the backward 2.5x that (174 us). q/k/v/O traffic is ~85 MB, 25
// us at 3.35 TB/s. At the Qwen3-30B-A3B shape (KH=4, D=128) the forward does 137.5
// GFLOP (139 us) and the backward 348 us against 45 us of traffic. Both kernels are
// bound by the tensor cores, so the design feeds wgmma from shared memory that TMA
// fills in the background.
//
// Design. The kernels are warp-specialised: 3 warpgroups (384 threads) a block.
// Warpgroup 0 gives up its registers (setmaxnreg.dec) and is the producer: one lane
// issues the TMA loads of 128-byte-swizzled tiles (tensor maps over q, k, v, dO as they
// lie, 4-d (B, S, heads, D), so rows past S read as zeros) into a ring of stages under
// full/empty mbarriers, and the small per-row data (segment ids; in the backward lse
// and delta, by cp.async from a second warp) lands beside them. Warpgroups 1 and 2
// take the registers (setmaxnreg.inc) and compute:
//   forward: a block owns 128 query rows (64 per consumer warpgroup) of one (b, h)
//     and walks key tiles of 128 (64 at D=256). S = Q K^T is a wgmma with both operands
//     in shared memory; the online softmax runs in registers in the log2 domain (log2(e) folded
//     into the scale, one ex2 a score); P is rounded to bf16 in registers (as the TPU
//     kernel casts p to v's dtype) and O += P V is a wgmma with P as the register A
//     operand and V read through the transpose flag. The P.V of key tile i runs on the
//     tensor cores while the softmax of tile i+1 runs. Blocks start with the heaviest
//     causal q tiles.
//   flash_dkv: a block owns 128 keys (64 per consumer warpgroup) of one (b, kv head)
//     and walks the GQA group's q heads and the q tiles of 64 from the causal start,
//     so dK and dV sum in registers. S^T = K Q^T and dP^T = V dO^T are shared-memory
//     wgmmas whose accumulators are already the A layout of dV += P^T dO and dK +=
//     dS^T Q (register A, transposed B). At D=256 a block owns 64 keys and each
//     consumer warpgroup half of their dK / dV columns (struct Bwd).
//   flash_dq: a block owns 128 query rows of one (b, h), loads Q and dO once and walks
//     the key tiles of 64 (32 at D=256) in order to the causal limit
//     (attention_tiles.cuh dq_walk).
// Masks are applied only to tiles that cross the causal diagonal, the window's edge, the
// ragged end, or a segment boundary (the test is in one place: tile_needs_mask); key tiles
// past the causal limit or wholly behind the window are never loaded (the forward and
// flash_dq start their key walk at the window's first tile, flash_dkv ends its q walk at
// the window's last q tile), as _run_block skips such blocks on the TPU.
// Head dims: 64, 128 and 256 run tiles of their own width. At 256 (Gemma-2-9B, Gemma-3)
// a row of a tile is twice as wide as at 128, so shared memory and the consumers' 240
// registers a thread hold half as many rows: the forward walks key tiles of 64 in two
// stages beside Q (O 128 registers, S 32, P 16), flash_dq key tiles of 32 in three stages
// beside Q and dO (dQ 128, S and dP 16 each, dS 8), and flash_dkv splits dK / dV's
// columns between its two consumer warpgroups over 64 keys (each recomputes S^T and dP^T
// over the full D: 6 D products a pair against 4 D). The P.V, dQ, dV and dK products
// are 256 or 128 wide (wgmma_rs takes N = 256). 96 (Phi-3) runs the 128-wide
// instantiations: a 64-column box at column 64 of a head holds its columns 64-95 and 32
// columns past the head's end, which the 4-d map fills with zeros (TMA's out-of-bounds
// fill), never the next head's. Zero columns of Q and K add nothing to S, of dO and V
// nothing to dP, and P.V, dV, dK and dQ come out 128 wide with zeros past column 96,
// which the epilogues leave unstored. So the D=128 design runs unchanged (its stages,
// shared memory and register budget), at 128/96 of the tensor-core work the head needs:
// at most ~75% of a 96-wide bound. The softmax scale is the caller's (1/sqrt(96)).
// The tanh logit soft-cap (Gemma-2, _soft_cap / _soft_cap_jac) is a template flag,
// SOFTCAP, so the uncapped instantiations keep their code. Capped, each score tile is
// mapped to th = tanh(s scale / c) before its mask (attention_tiles.cuh SoftCap), the
// softmax runs on th * c, and the backward's dS takes 1 - th^2. It costs two more MUFU
// operations a score (ex2 and the fast divide's reciprocal) beside the exp2 each kernel
// has (at D=128 one MUFU operation a score takes about half as long as the score's share
// of the forward's products at the card's peak rates; PERF.md has the times).
// What it leaves on the table: the two consumer warpgroups are not scheduled in turns
// (ping-pong), so their softmax and their wgmmas overlap only by chance; in the
// backward each step waits for its own products (at D=128 the registers hold dK and dV,
// or dQ, and leave no room to run a step ahead); the epilogues store straight from
// registers. At D=256 flash_dkv's recomputed S^T and dP^T (a third of its products; one
// warpgroup could own dV and the other dK, with P^T handed over in shared memory) and
// flash_dq's 32-key steps (a wait on a barrier every 32 keys).

#include <climits>

#include "attention_tiles.cuh"

namespace {

constexpr int SEG_PAD_Q = -1;  // segment ids of rows past Sq / keys past Skv
constexpr int SEG_PAD_KV = -2;

// The one place where a tile decides whether it needs per-element masks: a tile of
// query rows [q0, q0 + nq) and keys [k0, k0 + nk) is masked when it crosses the causal
// diagonal or the window's edge (its farthest pair, q0 + nq - 1 against k0, is outside),
// runs past Sq or Skv, or does not hold a single segment id on both sides (q_id, k_id: the
// one id each side holds, or NO_ID).
constexpr int NO_ID = INT_MIN;

__device__ __forceinline__ int one_id(int lo, int hi) { return lo == hi ? lo : NO_ID; }

__device__ __forceinline__ bool tile_needs_mask(int q0, int nq, int k0, int nk, int Sq, int Skv,
                                                bool causal, bool has_window, int window,
                                                bool segmented, int q_id, int k_id) {
  if (causal && k0 + nk - 1 > q0) return true;
  if (has_window && q0 + nq - 1 - k0 >= window) return true;
  if (q0 + nq > Sq || k0 + nk > Skv) return true;
  return segmented && !(q_id != NO_ID && q_id == k_id);
}

// Masks one accumulator tile, branch-free: register 4j + e holds row rows[e >> 1] and
// column col0 + 8j + tc + (e & 1); a pair outside [0, row_end) x [0, col_end), above
// the causal diagonal, behind the window or across a segment boundary gets -inf.
// KEY_ROWS: the rows are keys and the columns queries (the backward's S^T), else the
// reverse.
template <bool KEY_ROWS, int N>
__device__ __forceinline__ void mask_tile(float (&s)[N], const int (&rows)[2], int col0, int tc,
                                          int row_end, int col_end, bool causal, bool has_window,
                                          int window, bool segmented, const int (&row_seg)[2],
                                          const int* col_seg) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int i = (r >> 1) & 1;
    const int c = 8 * (r / 4) + tc + (r & 1);
    const int col = col0 + c;
    bool ok = (rows[i] < row_end) & (col < col_end);
    ok &= !causal | (KEY_ROWS ? col >= rows[i] : rows[i] >= col);
    ok &= !has_window | ((KEY_ROWS ? col - rows[i] : rows[i] - col) < window);
    ok &= !segmented | (row_seg[i] == col_seg[c]);
    s[r] = ok ? s[r] : -INFINITY;
  }
}

// The first key tile of `bn` keys that a q tile starting at q_start can see: keys
// before q_start - window + 1 are behind the window of every row of the tile.
__device__ __forceinline__ int first_key_tile(int q_start, bool has_window, int window, int bn) {
  return has_window ? max(0, q_start - window + 1) / bn : 0;
}

// ------------------------------------------------------------------ forward

template <int D>
struct Fwd {
  static constexpr int DIM = D;
  // D=256: key tiles of 64, so that O (128 registers), S (32) and P (16) fit the
  // consumers' 240 (S and P of 128 keys would take 224 beside O)
  static constexpr int BM = 128, BN = D == 256 ? 64 : 128;
  // K/V stages: 4 x 32 KB at D=64; 3 x 64 KB at D=128, with Q 32 KB just inside 227 KB;
  // 2 x 64 KB at D=256 beside Q's 64 KB
  static constexpr int STAGES = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int BOXES = D / BOX;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int SEG_OFF = V_OFF + STAGES * KV_BYTES;  // per stage: BN ids, one_id
  static constexpr int SEG_STRIDE = BN + 1;
  static constexpr int QSEG_OFF = SEG_OFF + STAGES * SEG_STRIDE * 4;  // 2 wgs x 4 warps x lo, hi
  static constexpr int BAR_OFF = (QSEG_OFF + 2 * 4 * 2 * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

// O += P V for one key tile: P (64 rows x 128 keys) from registers, V (keys x D, D
// contiguous) in shared memory through the transpose flag. The caller fences first.
template <class C>
__device__ __forceinline__ void pv_product(float (&acc)[C::DIM / 2],
                                           const uint32_t (&pa)[C::BN / 16][4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk)
    wgmma_rs<C::DIM, 1>(acc, pa[kk], desc_sw128(v_addr + kk * 16 * ROW_BYTES, C::BN * ROW_BYTES),
                        1);
}

template <class C>
__device__ __forceinline__ void fence_pa(uint32_t (&pa)[C::BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) fence_regs(pa[kk]);
}

// grid (ceil(Sq / 128), B * H), 384 threads; block x takes q tile gridDim.x - 1 - x.
// SOFTCAP: each score is capped (SoftCap) before the mask, and the softmax runs over the
// capped logits, whose log2 is th * cap.l2 (the scale is inside th); without it, cap is
// unused and the code is the uncapped kernel's.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, const float* __restrict__ sinks,
                 bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int KH,
                 int dim, float scale_log2, SoftCap cap, int causal, int has_window,
                 int window) {
  using C = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  int* sSeg = reinterpret_cast<int*>(smem + C::SEG_OFF);
  int* sQSeg = reinterpret_cast<int*>(smem + C::QSEG_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * C::BM;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int kv_end = causal ? min(Skv, q_start + C::BM) : Skv;
  // key tiles first .. the causal limit: step `it` walks tile first + it
  const int first = first_key_tile(q_start, has_window, window, C::BN);
  const int n_tiles = max(0, (kv_end + C::BN - 1) / C::BN - first);
  const bool segmented = seg_q != nullptr;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's lane 0, after the warp's row copies
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::BOXES; ++c)
        tma_load_4d(smem + c * C::BM * ROW_BYTES, &tq, q_full, c * BOX, h, q_start, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % C::STAGES;
      mbar_wait(&empty[stage], ((it / C::STAGES) & 1) ^ 1);
      const int kv_start = (first + it) * C::BN;
      if (segmented) {
        int* ids = sSeg + stage * C::SEG_STRIDE;
        int lo = INT_MAX, hi = INT_MIN;
        for (int i = lane; i < C::BN; i += 32) {
          const int id = kv_start + i < Skv ? seg_kv[(size_t)b * Skv + kv_start + i] : SEG_PAD_KV;
          ids[i] = id;
          lo = min(lo, id);
          hi = max(hi, id);
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane == 0) ids[C::BN] = one_id(lo, hi);
      }
      __syncwarp();  // the lanes' row copies before lane 0's arrival (a release)
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * C::KV_BYTES);
        unsigned char* sk = smem + C::K_OFF + stage * C::KV_BYTES;
        unsigned char* sv = smem + C::V_OFF + stage * C::KV_BYTES;
        for (int c = 0; c < C::BOXES; ++c) {
          tma_load_4d(sk + c * C::BN * ROW_BYTES, &tk, &full[stage], c * BOX, kvh, kv_start, b);
          tma_load_4d(sv + c * C::BN * ROW_BYTES, &tv, &full[stage], c * BOX, kvh, kv_start, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: query rows cw*64 .. cw*64+63 of the tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  const int q0 = q_start + cw * 64;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int segr[2] = {0, 0}, q_id = NO_ID;
  if (segmented) {
#pragma unroll
    for (int i = 0; i < 2; ++i) segr[i] = row[i] < Sq ? seg_q[(size_t)b * Sq + row[i]] : SEG_PAD_Q;
    const int lo = __reduce_min_sync(0xffffffffu, min(segr[0], segr[1]));
    const int hi = __reduce_max_sync(0xffffffffu, max(segr[0], segr[1]));
    if (lane == 0) sQSeg[(cw * 4 + warp) * 2] = lo, sQSeg[(cw * 4 + warp) * 2 + 1] = hi;
    named_sync(1 + cw, 128);
    int q_lo = INT_MAX, q_hi = INT_MIN;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      q_lo = min(q_lo, sQSeg[(cw * 4 + w) * 2]);
      q_hi = max(q_hi, sQSeg[(cw * 4 + w) * 2 + 1]);
    }
    q_id = one_id(q_lo, q_hi);
  }

  const uint32_t q_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // Key tile `it`: S_it = Q K_it^T is issued together with O += P_{it-1} V_{it-1}, so
  // the tensor cores run the previous tile's P.V while this tile's softmax runs. Tile 0
  // is peeled off, so that every P.V and its wait sit in one block (ptxas serialises
  // every wgmma of a kernel when it cannot pair them).
  uint32_t pa[C::BN / 16][4];
  float s[C::BN / 2];
  int prev_stage = 0;

  // S of tile `it` into s (the full barrier of its stage waited for)
  auto issue_s = [&](int it) {
    const uint32_t k_addr = smem_u32(smem + C::K_OFF + (it % C::STAGES) * C::KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * C::BN * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<C::BN, 0, 0>(s, desc_sw128(q_addr + off, 16), desc_sw128(k_addr + koff, 16), ks);
    }
    wgmma_commit();
  };
  // the log2 factor of a score in s: the scale, or (capped) the cap's l2
  const float mul = SOFTCAP ? cap.l2 : scale_log2;
  // (cap,) mask, scale and exponentiate s in place (log2 domain); returns O's rescale factors
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int stage = it % C::STAGES;
    const int kv_start = (first + it) * C::BN;
    const int* ids = sSeg + stage * C::SEG_STRIDE;
    if constexpr (SOFTCAP) {
#pragma unroll
      for (int r = 0; r < C::BN / 2; ++r) s[r] = cap.tanh_of(s[r]);
    }
    if (tile_needs_mask(q0, 64, kv_start, C::BN, Sq, Skv, causal, has_window, window, segmented,
                        q_id, segmented ? ids[C::BN] : NO_ID))
      mask_tile<false>(s, row, kv_start, tc, Sq, Skv, causal, has_window, window, segmented, segr,
                       ids);
    float mx[2] = {-INFINITY, -INFINITY};  // of the unscaled scores (mul is > 0)
#pragma unroll
    for (int r = 0; r < C::BN / 2; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * mul);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing allowed yet
      alpha[i] = fast_exp2(m[i] - m_use[i]);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < C::BN / 2; ++r) {
      s[r] = fast_exp2(fmaf(s[r], mul, -m_use[(r >> 1) & 1]));
      rs[(r >> 1) & 1] += s[r];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // quad-partial; summed at the end
  };
  // O *= alpha, then P (s) rounded to bf16 as the A operand of P.V: registers 8kk..8kk+7
  // are keys 16kk..16kk+15
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) pa[kk][f] = pack_f32(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
    }
  };
  // O += P V with the V of `stage`, issued after a fence
  auto issue_pv = [&](int stage) {
    fence_regs(acc);
    wgmma_fence();
    pv_product<C>(acc, pa, smem_u32(smem + C::V_OFF + stage * C::KV_BYTES));
    wgmma_commit();
  };

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    float alpha[2];
    mbar_wait(&full[0], 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0, alpha);
    rescale_and_pack(alpha);
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int stage = it % C::STAGES;
    float alpha[2];
    mbar_wait(&full[stage], (it / C::STAGES) & 1);
    issue_s(it);
    issue_pv(prev_stage);
    wgmma_wait<1>();  // S is done; the previous tile's P.V runs on
    fence_regs(s);
    softmax(it, alpha);
    wgmma_wait<0>();  // P.V is done: its stage is free, O can be rescaled
    fence_regs(acc);
    fence_pa<C>(pa);
    release(&empty[prev_stage], lane);
    rescale_and_pack(alpha);
    prev_stage = stage;
  }
  if (n_tiles > 0) {
    issue_pv(prev_stage);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_pa<C>(pa);
    release(&empty[prev_stage], lane);
  }

  // the sink (a raw logit) in the log2 domain of m; read here, after the key loop
  const float sink2 = sinks != nullptr ? sinks[h] * LOG2E : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (row[i] >= Sq) continue;
    float inv, lse_i;
    if (sinks != nullptr) {
      // m' = max(m, sink); the keys' share is rescaled by 2^(m - m'), 0 for a row with no
      // allowed key (m = -inf), whose lse is then the sink and whose O is 0
      const float m_eff = fmaxf(m[i], sink2);
      const float alpha = exp2f(m[i] - m_eff);
      const float lt = li * alpha + exp2f(sink2 - m_eff);
      inv = alpha / lt;
      lse_i = (m_eff + log2f(lt)) * LN2;
    } else {
      const bool none = li == 0.f;
      inv = none ? 0.f : 1.f / li;
      lse_i = none ? NEG_INF : (m[i] + log2f(li)) * LN2;
    }
    bf16* orow = o + (((size_t)b * Sq + row[i]) * H + h) * dim;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < dim)  // the tile's columns past a 96-wide head are not the head's
        *reinterpret_cast<uint32_t*>(orow + 8 * j + tc) =
            pack_f32(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if ((lane & 3) == 0) lse[(size_t)bh * Sq + row[i]] = lse_i;
  }
}

// ------------------------------------------------------------------ backward

// D <= 128: a block owns 128 keys, consumer warpgroup w keys w*64 .. w*64+63 and every
// column of their dK and dV. D = 256 (SPLIT_D): dK and dV of 64 keys at 256 columns would
// take 256 registers a thread, over the 240 a consumer has, so a block owns 64 keys and
// warpgroup w owns columns w*128 .. w*128+127 of their dK and dV (64 + 64 registers, as
// at D=128); both warpgroups compute the same S^T and dP^T over the full D (6 D products
// a (q, k) pair where 4 D would do) from one copy of each Q / dO stage.
template <int D>
struct Bwd {
  static constexpr bool SPLIT_D = D == 256;
  static constexpr int BN = SPLIT_D ? 64 : 128, BM = 64;  // keys a block, q rows a step
  static constexpr int DC = SPLIT_D ? D / 2 : D;  // dK / dV columns a consumer warpgroup
  static constexpr int STAGES = 2;
  static constexpr int BOXES = D / BOX;
  static constexpr int KV_BYTES = BN * D * 2, QT_BYTES = BM * D * 2;
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;                   // per stage
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;     // per stage
  // per stage: lse, delta, q segment ids (BM each)
  static constexpr int ROWS_STRIDE = 3 * BM;
  static constexpr int ROWS_OFF = DO_OFF + STAGES * QT_BYTES;
  // the ids of each consumer warpgroup's 64 keys
  static constexpr int KSEG_OFF = ROWS_OFF + STAGES * ROWS_STRIDE * 4;
  static constexpr int BAR_OFF = KSEG_OFF + 2 * 64 * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// grid (ceil(Skv / BN), B * KH), 384 threads. Each block holds one K/V tile of BN keys,
// loops over the q heads of its GQA group and the q tiles from the causal start to the
// window's end (q_end), and owns its dK/dV rows (consumer warpgroup w: keys w*64 ..
// w*64+63, or at D=256 columns w*128 .. w*128+127 of all 64), so the group sum needs no
// second pass. dQ is flash_dq_kernel's. SOFTCAP: P^T from the capped scores, and dS^T
// takes 1 - th^2; dK's store keeps its * scale (d(c th) / d(qk) = scale (1 - th^2)).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H, int KH,
                 int dim, float scale, SoftCap cap, int causal, int has_window, int window) {
  using C = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sRows = reinterpret_cast<float*>(smem + C::ROWS_OFF);
  int* sKSeg = reinterpret_cast<int*>(smem + C::KSEG_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int kv_start = blockIdx.x * C::BN;
  const int b = blockIdx.y / KH, kvh = blockIdx.y % KH;
  const int groups = H / KH;
  const int m_first = causal ? kv_start / C::BM : 0;
  // q rows past the last key's window (q - key < window) see none of the block's keys
  const int q_end = has_window && window < Sq ? min(Sq, kv_start + C::BN - 1 + window) : Sq;
  const bool segmented = seg_q != nullptr;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 33);  // the TMA warp's lane 0 and the row warp's 32 lanes
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: warp 0 issues the TMA loads, warp 1 copies the rows (lse,
    // delta, segment ids) of each q tile; both arrive on the stage's full barrier
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp > 1) return;
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(smem + C::K_OFF + c * C::BN * ROW_BYTES, &tk, kv_full, c * BOX, kvh,
                    kv_start, b);
        tma_load_4d(smem + C::V_OFF + c * C::BN * ROW_BYTES, &tv, kv_full, c * BOX, kvh,
                    kv_start, b);
      }
    }
    int stage = 0, phase = 1;  // the first pass over the stages finds them empty
    for (int h = kvh * groups; h < (kvh + 1) * groups; ++h) {
      for (int q_start = m_first * C::BM; q_start < q_end; q_start += C::BM) {
        mbar_wait(&empty[stage], phase);
        if (warp == 0) {
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[stage], 2 * C::QT_BYTES);
            unsigned char* sq = smem + C::Q_OFF + stage * C::QT_BYTES;
            unsigned char* sdo = smem + C::DO_OFF + stage * C::QT_BYTES;
            for (int c = 0; c < C::BOXES; ++c) {
              tma_load_4d(sq + c * C::BM * ROW_BYTES, &tq, &full[stage], c * BOX, h, q_start, b);
              tma_load_4d(sdo + c * C::BM * ROW_BYTES, &tdo, &full[stage], c * BOX, h, q_start, b);
            }
          }
        } else {
          // asynchronous 4-byte copies, no data through registers; past Sq they fill zeros
          // (such rows are masked). Each lane's arrival counts when its copies land.
          const size_t bh = (size_t)b * H + h;
          float* rows = sRows + stage * C::ROWS_STRIDE;
#pragma unroll
          for (int j = 0; j < C::BM / 32; ++j) {
            const int i = lane + 32 * j;
            const int q = q_start + i;
            const bool in = q < Sq;
            cp_async_4(rows + i, lse + (in ? bh * Sq + q : 0), in);
            cp_async_4(rows + C::BM + i, delta + (in ? bh * Sq + q : 0), in);
            if (segmented)
              cp_async_4(rows + 2 * C::BM + i, seg_q + (in ? (size_t)b * Sq + q : 0), in);
          }
          cp_async_arrive(&full[stage]);
        }
        if (++stage == C::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: keys cw*64 .. cw*64+63 of the tile, or
                          // (SPLIT_D) dK / dV columns cw*DC .. cw*DC+DC-1 of its 64 keys
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  const int key_off = C::SPLIT_D ? 0 : cw * 64;  // this warpgroup's keys in the tile
  const int c0 = C::SPLIT_D ? cw * C::DC : 0;     // its first dK / dV column
  const int k0 = kv_start + key_off;
  const int krow = warp * 16 + g;  // this thread's keys: k0 + krow, k0 + krow + 8
  // the segment ids of this warpgroup's keys wait in shared memory for masked tiles
  // (registers are scarce at D=128); k_id is their one id, or NO_ID
  int* kseg = sKSeg + cw * 64;
  int k_id = NO_ID;
  if (segmented) {
    if (t < 64) kseg[t] = k0 + t < Skv ? seg_kv[(size_t)b * Skv + k0 + t] : SEG_PAD_KV;
    named_sync(1 + cw, 128);
    const int a = kseg[lane], c = kseg[lane + 32];
    k_id = one_id(__reduce_min_sync(0xffffffffu, min(a, c)),
                  __reduce_max_sync(0xffffffffu, max(a, c)));
  }

  const float mul = SOFTCAP ? cap.l2 : scale * LOG2E;  // the log2 factor of a score in s
  const uint32_t k_addr = smem_u32(smem + C::K_OFF), v_addr = smem_u32(smem + C::V_OFF);
  float dk_acc[C::DC / 2], dv_acc[C::DC / 2];
#pragma unroll
  for (int i = 0; i < C::DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  int it = 0;  // steps so far: the stage ring follows it
  for (int h = kvh * groups; h < (kvh + 1) * groups; ++h)
  for (int q_start = m_first * C::BM; q_start < q_end; q_start += C::BM, ++it) {
    const int stage = it % C::STAGES;
    mbar_wait(&full[stage], (it / C::STAGES) & 1);
    const uint32_t q_addr = smem_u32(smem + C::Q_OFF + stage * C::QT_BYTES);
    const uint32_t do_addr = smem_u32(smem + C::DO_OFF + stage * C::QT_BYTES);
    const float* rows = sRows + stage * C::ROWS_STRIDE;
    const int* ids = reinterpret_cast<const int*>(rows + 2 * C::BM);

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 q rows
    float s[C::BM / 2], dp[C::BM / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t aoff = (ks / 4) * C::BN * ROW_BYTES + key_off * ROW_BYTES + (ks % 4) * 32;
      const uint32_t boff = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<C::BM, 0, 0>(s, desc_sw128(k_addr + aoff, 16), desc_sw128(q_addr + boff, 16), ks);
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t aoff = (ks / 4) * C::BN * ROW_BYTES + key_off * ROW_BYTES + (ks % 4) * 32;
      const uint32_t boff = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<C::BM, 0, 0>(dp, desc_sw128(v_addr + aoff, 16), desc_sw128(do_addr + boff, 16),
                            ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T * scale - lse), dS^T = P^T * (dP^T - delta): bf16 A fragments of both
    // (SOFTCAP: S^T capped before the mask, P^T = exp(c th - lse), dS^T times 1 - th^2)
    if constexpr (SOFTCAP) {
#pragma unroll
      for (int r = 0; r < C::BM / 2; ++r) s[r] = cap.tanh_of(s[r]);
    }
    int q_id = NO_ID;  // the q tile's one segment id
    if (segmented) {
      const int a = ids[lane], c = ids[lane + 32];
      q_id = one_id(__reduce_min_sync(0xffffffffu, min(a, c)),
                    __reduce_max_sync(0xffffffffu, max(a, c)));
    }
    if (tile_needs_mask(q_start, C::BM, k0, 64, Sq, Skv, causal, has_window, window, segmented,
                        q_id, k_id)) {
      const int keys[2] = {k0 + krow, k0 + krow + 8};
      const int segk[2] = {kseg[krow], kseg[krow + 8]};
      mask_tile<true>(s, keys, q_start, tc, Skv, Sq, causal, has_window, window, segmented, segk,
                      ids);
    }
    uint32_t pa[C::BM / 16][4], sa[C::BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk) {
      float p[8], ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int qc = 16 * kk + 8 * (e >> 2) + tc + (e & 1);  // q column within the tile
        const int r = 8 * kk + e;                              // accumulator register
        p[e] = fast_exp2(fmaf(s[r], mul, -rows[qc] * LOG2E));
        ds[e] = p[e] * (dp[r] - rows[C::BM + qc]);
        if constexpr (SOFTCAP) ds[e] *= soft_cap_jac(s[r]);
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        pa[kk][f] = pack_f32(p[2 * f], p[2 * f + 1]);
        sa[kk][f] = pack_f32(ds[2 * f], ds[2 * f + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: register A, B (q rows x D, D contiguous) transposed,
    // from the box of column c0 on
    const uint32_t col_off = (c0 / BOX) * C::BM * ROW_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk)
      wgmma_rs<C::DC, 1>(dv_acc, pa[kk],
                         desc_sw128(do_addr + col_off + kk * 16 * ROW_BYTES, C::BM * ROW_BYTES), 1);
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk)
      wgmma_rs<C::DC, 1>(dk_acc, sa[kk],
                         desc_sw128(q_addr + col_off + kk * 16 * ROW_BYTES, C::BM * ROW_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(sa[kk]);
    }
    release(&empty[stage], lane);  // Q and dO of this stage are read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + krow + 8 * i;
    if (key >= Skv) continue;
    const size_t off = (((size_t)b * Skv + key) * KH + kvh) * dim + c0;
#pragma unroll
    for (int j = 0; j < C::DC / 8; ++j) {
      if (c0 + 8 * j >= dim) continue;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + tc) =
          pack_f32(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + tc) =
          pack_f32(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ dQ, q-stationary

template <int D>
struct Dq : DqTiles<D> {
  using T = DqTiles<D>;
  static constexpr int SEG_STRIDE = T::BN + 1;  // per stage: the BN keys' ids, one_id
  static constexpr int SEG_OFF = T::TAIL_OFF;
  static constexpr int QSEG_OFF = SEG_OFF + T::STAGES * SEG_STRIDE * 4;  // 2 wgs x 4 warps x lo, hi
  static constexpr int BAR_OFF = (QSEG_OFF + 2 * 4 * 2 * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * T::STAGES) * 8 + 1024;  // + alignment slack
};
static_assert(Fwd<64>::SMEM <= 232448 && Fwd<128>::SMEM <= 232448 && Fwd<256>::SMEM <= 232448,
              "flash_fwd shared memory");
static_assert(Bwd<64>::SMEM <= 232448 && Bwd<128>::SMEM <= 232448 && Bwd<256>::SMEM <= 232448,
              "flash_dkv shared memory");
static_assert(Dq<64>::SMEM <= 232448 && Dq<128>::SMEM <= 232448 && Dq<256>::SMEM <= 232448,
              "flash_dq shared memory");

// grid (ceil(Sq / 128), B * H), 384 threads; block x takes q tile gridDim.x - 1 - x (the
// heaviest causal tiles first). The producer loads the block's Q and dO once, then the
// key tiles from the window's first (0 without a window) to the causal limit, each with
// its keys' segment ids; the consumers
// run dq_walk with flash's masks (tile_needs_mask, mask_tile) and store dQ * scale in
// q's dtype once. Every dQ element is one block's in-order sum: nothing is added across
// blocks, so dQ is the same on every run. SOFTCAP: dq_walk's capped instantiation.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int Sq, int Skv, int H, int KH, int dim, float scale,
                SoftCap cap, int causal, int has_window, int window) {
  using C = Dq<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  int* sSeg = reinterpret_cast<int*>(smem + C::SEG_OFF);
  int* sQSeg = reinterpret_cast<int*>(smem + C::QSEG_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int kv_end = causal ? min(Skv, q_start + C::BM) : Skv;
  const int first = first_key_tile(q_start, has_window, window, C::BN);
  const int n_tiles = max(0, (kv_end + C::BN - 1) / C::BN - first);
  const bool segmented = seg_q != nullptr;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's lane 0, after the warp's id copies
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(smem + c * C::BM * ROW_BYTES, &tq, q_full, c * BOX, h, q_start, b);
        tma_load_4d(smem + C::DO_OFF + c * C::BM * ROW_BYTES, &tdo, q_full, c * BOX, h, q_start,
                    b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % C::STAGES;
      mbar_wait(&empty[stage], ((it / C::STAGES) & 1) ^ 1);
      const int kv_start = (first + it) * C::BN;
      if (segmented) {
        int* ids = sSeg + stage * C::SEG_STRIDE;
        int lo = INT_MAX, hi = INT_MIN;
        for (int i = lane; i < C::BN; i += 32) {
          const int id = kv_start + i < Skv ? seg_kv[(size_t)b * Skv + kv_start + i] : SEG_PAD_KV;
          ids[i] = id;
          lo = min(lo, id);
          hi = max(hi, id);
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane == 0) ids[C::BN] = one_id(lo, hi);
      }
      __syncwarp();  // the lanes' id copies before lane 0's arrival (a release)
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * C::KV_BYTES);
        unsigned char* sk = smem + C::K_OFF + stage * C::KV_BYTES;
        unsigned char* sv = smem + C::V_OFF + stage * C::KV_BYTES;
        for (int c = 0; c < C::BOXES; ++c) {
          tma_load_4d(sk + c * C::BN * ROW_BYTES, &tk, &full[stage], c * BOX, kvh, kv_start, b);
          tma_load_4d(sv + c * C::BN * ROW_BYTES, &tv, &full[stage], c * BOX, kvh, kv_start, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: query rows cw*64 .. cw*64+63 of the tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  const int q0 = q_start + cw * 64;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int segr[2] = {0, 0}, q_id = NO_ID;
  if (segmented) {
#pragma unroll
    for (int i = 0; i < 2; ++i) segr[i] = row[i] < Sq ? seg_q[(size_t)b * Sq + row[i]] : SEG_PAD_Q;
    const int lo = __reduce_min_sync(0xffffffffu, min(segr[0], segr[1]));
    const int hi = __reduce_max_sync(0xffffffffu, max(segr[0], segr[1]));
    if (lane == 0) sQSeg[(cw * 4 + warp) * 2] = lo, sQSeg[(cw * 4 + warp) * 2 + 1] = hi;
    named_sync(1 + cw, 128);
    int q_lo = INT_MAX, q_hi = INT_MIN;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      q_lo = min(q_lo, sQSeg[(cw * 4 + w) * 2]);
      q_hi = max(q_hi, sQSeg[(cw * 4 + w) * 2 + 1]);
    }
    q_id = one_id(q_lo, q_hi);
  }
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] < Sq) {
      lse2[i] = lse[(size_t)bh * Sq + row[i]] * LOG2E;
      dl[i] = delta[(size_t)bh * Sq + row[i]];
    }
  }

  float acc[D / 2];
  mbar_wait(q_full, 0);
  dq_walk<C, SOFTCAP>(acc, n_tiles, smem, cw, full, empty, lse2, dl, scale * LOG2E, lane,
             [&](int it, float (&s)[C::BN / 2]) {
               const int kv_start = (first + it) * C::BN;
               const int* ids = sSeg + (it % C::STAGES) * C::SEG_STRIDE;
               if (tile_needs_mask(q0, 64, kv_start, C::BN, Sq, Skv, causal, has_window, window,
                                   segmented, q_id, segmented ? ids[C::BN] : NO_ID))
                 mask_tile<false>(s, row, kv_start, tc, Sq, Skv, causal, has_window, window,
                                  segmented, segr, ids);
             },
             cap);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    bf16* drow = dq + (((size_t)b * Sq + row[i]) * H + h) * dim;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < dim)
        *reinterpret_cast<uint32_t*>(drow + 8 * j + tc) =
            pack_f32(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// Tensor maps over a (B, S, heads, dim) bf16 tensor as it lies, 4-d, boxes of 64 columns
// of one head x `rows` rows. A box's columns past dim (the second box of a 96-wide head)
// read as zeros, as do rows past S.
inline cudaError_t bf16_map(CUtensorMap* map, const void* p, int B, int S, int heads, int dim,
                            int rows) {
  return make_map_4d(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dim, heads, S, B, BOX, rows);
}

// D: the tile width the kernel is built for (64, 128 or 256); dim: the tensors' head dim
// (D, or 96 in the 128-wide tiles); SOFTCAP: the capped instantiation, cap its factors.
template <int D, bool SOFTCAP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_kv, const float* sinks, void* o, float* lse, int B, int Sq,
                       int Skv, int H, int KH, int dim, float scale, SoftCap cap, int causal,
                       int has_window, int window, cudaStream_t stream) {
  using C = Fwd<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = bf16_map(&tq, q, B, Sq, H, dim, C::BM);
  if (err == cudaSuccess) err = bf16_map(&tk, k, B, Skv, KH, dim, C::BN);
  if (err == cudaSuccess) err = bf16_map(&tv, v, B, Skv, KH, dim, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, SOFTCAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  flash_fwd_kernel<D, SOFTCAP><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, seg_q, seg_kv, sinks, static_cast<bf16*>(o), lse, Sq, Skv, H, KH, dim,
      scale * LOG2E, cap, causal, has_window, window);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_kv, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Sq, int Skv, int H,
                       int KH, int dim, float scale, SoftCap cap, int causal, int has_window,
                       int window, cudaStream_t stream) {
  using C = Bwd<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bf16_map(&tq, q, B, Sq, H, dim, C::BM);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, B, Sq, H, dim, C::BM);
  if (err == cudaSuccess) err = bf16_map(&tk, k, B, Skv, KH, dim, C::BN);
  if (err == cudaSuccess) err = bf16_map(&tv, v, B, Skv, KH, dim, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dkv_kernel<D, SOFTCAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + C::BN - 1) / C::BN, B * KH);
  flash_dkv_kernel<D, SOFTCAP><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, seg_q, seg_kv, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, H, KH, dim, scale, cap, causal, has_window, window);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* seg_q,
                      const int* seg_kv, const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Sq, int Skv, int H, int KH, int dim, float scale,
                      SoftCap cap, int causal, int has_window, int window, cudaStream_t stream) {
  using C = Dq<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bf16_map(&tq, q, B, Sq, H, dim, C::BM);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, B, Sq, H, dim, C::BM);
  if (err == cudaSuccess) err = bf16_map(&tk, k, B, Skv, KH, dim, C::BN);
  if (err == cudaSuccess) err = bf16_map(&tv, v, B, Skv, KH, dim, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dq_kernel<D, SOFTCAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  flash_dq_kernel<D, SOFTCAP><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, seg_q, seg_kv, lse, delta, static_cast<bf16*>(dq), Sq, Skv, H, KH, dim,
      scale, cap, causal, has_window, window);
  return cudaGetLastError();
}

// The tile width of a head dim: 64, 128 and 256 as they are, 96 in the 128-wide tiles; 0
// for a head dim the kernels do not take.
inline int tile_width(int dim) {
  return dim == 64 ? 64 : dim == 96 || dim == 128 ? 128 : dim == 256 ? 256 : 0;
}

// The cap's two factors (SoftCap) for softmax scale `scale` and cap c = softcap > 0.
inline SoftCap soft_cap(float scale, float softcap) {
  return softcap > 0.f ? SoftCap{2.f * scale * LOG2E / softcap, softcap * LOG2E}
                       : SoftCap{0.f, 0.f};
}

// One of a kernel's six instantiations (tile width 64, 128 or 256, capped or not), called
// as LAUNCH(D, SOFTCAP); an unknown head dim is cudaErrorInvalidValue.
#define FLASH_DISPATCH(dim, softcap, LAUNCH)                                     \
  switch (tile_width(dim) + ((softcap) > 0.f)) {                                  \
    case 64: return (int)LAUNCH(64, false);                                       \
    case 65: return (int)LAUNCH(64, true);                                        \
    case 128: return (int)LAUNCH(128, false);                                     \
    case 129: return (int)LAUNCH(128, true);                                      \
    case 256: return (int)LAUNCH(256, false);                                     \
    case 257: return (int)LAUNCH(256, true);                                      \
  }                                                                               \
  return (int)cudaErrorInvalidValue

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t; the caller
// checks inputs (bf16, contiguous, 16-byte aligned, D in {64, 96, 128, 256}, H % KH == 0)
// beforehand. D is the head dim; the softmax scale comes as given (1/sqrt(96) at D = 96,
// never the tile's). flash_dq writes dq (bf16, q's layout) whole, each row once.
// softcap: the tanh logit cap c (0: none; > 0 runs the capped instantiations);
// has_window = 0 ignores window; sinks: null, or f32 (H,).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                         const int* seg_kv, const float* sinks, void* o, float* lse, int B,
                         int Sq, int Skv, int H, int KH, int D, float scale, float softcap,
                         int causal, int has_window, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SoftCap cap = soft_cap(scale, softcap);
#define LAUNCH(W, CAP)                                                                    \
  launch_fwd<W, CAP>(q, k, v, seg_q, seg_kv, sinks, o, lse, B, Sq, Skv, H, KH, D, scale, cap, \
                     causal, has_window, window, s)
  FLASH_DISPATCH(D, softcap, LAUNCH);
#undef LAUNCH
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const int* seg_q,
                        const int* seg_kv, const void* dout, const float* lse,
                        const float* delta, void* dq, int B, int Sq, int Skv, int H, int KH,
                        int D, float scale, float softcap, int causal, int has_window,
                        int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SoftCap cap = soft_cap(scale, softcap);
#define LAUNCH(W, CAP)                                                                       \
  launch_dq<W, CAP>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, B, Sq, Skv, H, KH, D, scale, \
                    cap, causal, has_window, window, s)
  FLASH_DISPATCH(D, softcap, LAUNCH);
#undef LAUNCH
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const int* seg_q,
                         const int* seg_kv, const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B, int Sq, int Skv, int H,
                         int KH, int D, float scale, float softcap, int causal, int has_window,
                         int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SoftCap cap = soft_cap(scale, softcap);
#define LAUNCH(W, CAP)                                                                      \
  launch_dkv<W, CAP>(q, k, v, seg_q, seg_kv, dout, lse, delta, dk, dv, B, Sq, Skv, H, KH, D, \
                     scale, cap, causal, has_window, window, s)
  FLASH_DISPATCH(D, softcap, LAUNCH);
#undef LAUNCH
}
