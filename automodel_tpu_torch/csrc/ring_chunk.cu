// Ring (context-parallel) attention chunk kernels for Hopper (sm_90a): one ring step
// forward and one ring step backward.
//
// Replaces the Pallas kernels of automodel_tpu/ops/pallas/ring_chunk.py:
//   ring_fwd  <- _chunk_fwd_kernel: merge the attention of the local q against one
//                visiting kv chunk into the online-softmax carry (acc, m, l)
//   ring_bwd  <- _chunk_bwd_kernel: dq partial plus the chunk's dk / dv from one s / p
//                recompute, given the global lse and delta
//   ring_dkv  <- the dk / dv of _chunk_bwd_kernel: ring_bwd_kernel with DQ = false
//   ring_dq   <- the dq of _chunk_bwd_kernel, q-stationary: a block walks the chunk's
//                non-skipped key tiles in order, sums dQ in registers and adds it into
//                the carried dq by one read-modify-write a q tile
// ring_dq + ring_dkv are the deterministic route, taken by the wrapper when
// torch.are_deterministic_algorithms_enabled(), and the only route at Dv != D: ring
// steps run in sequence, so dq sums in the same order on every run. ring_bwd is the
// default at Dv == D because it is faster there: one recompute of S and dP, where the
// split does two.
//
// Layouts (row form, as the TPU kernels): q (B*H, Sq, D), k (B*KH, Skv, D), v (B*KH, Skv,
// Dv) bf16, contiguous, 16-byte aligned; q row b*H + h reads kv row b*KH + h / (H / KH)
// (GQA). Positions and segment ids are int32 (B, Sq) / (B, Skv); segments are optional.
// The carry acc is (B*H, Sq, Dv) f32 and m / l are (B*H, Sq) f32; dO is (B*H, Sq, Dv);
// lse and delta are (B*H, Sq) f32; dq is (B*H, Sq, D) f32, dk (B*KH, Skv, D) f32 and dv
// (B*KH, Skv, Dv) f32. (D, Dv) is (64, 64), (128, 128) or MLA's (192, 128) (DeepSeek-V3,
// Moonlight: 128 + 64 rope columns for q and k, 128 for v); ring_bwd takes the first two.
// The softmax scale is the caller's (DeepSeek's carries YaRN's mscale^2).
//
// Masks come from data: global positions and segment ids travel with the chunks, so
// q row r may see key c when (not causal or pq[r] >= pkv[c]) and (no window or
// pq[r] - pkv[c] < window) and (no segments or sq[r] == skv[c]). A masked logit is
// -inf and a masked p is 0: a row with nothing allowed keeps the carry's m = -1e30,
// l = 0 and acc = 0, as in the TPU kernels.
//
// In place. ring_fwd reads the carry (acc, m, l) and writes the updated, unnormalised
// carry back into the same buffers (the TPU kernel aliases them through
// input_output_aliases). ring_bwd adds dK / dV into dk / dv and dQ into dq, so the
// caller accumulates over the ring steps in f32 without extra buffers.
//
// What bounds it. Per q head a launch does 4*Sq*Skv*D operations forward (Q K^T and
// P V) and 10*Sq*Skv*D backward (S and dP, dV, dK, dQ) over the allowed (q, k) pairs.
// At the Llama-3-8B long-context step (cp 8 folded on one card, B 1, S_local 4096, H 32,
// KH 8, D 128, causal) a launch at the diagonal ring step allows half the pairs: 1.1
// TFLOP forward and 2.7 backward, 1.1 / 2.8 ms at the H100's 989 TFLOP/s dense bf16,
// against ~1.5 / ~2.5 GB of operands and carry (0.45 / 0.75 ms at 3.35 TB/s): both are
// bound by operations. At Dv != D, Q K^T and dP take 2*D and 2*Dv operations a pair, P V
// and dV 2*Dv, dK and dQ 2*D.
//
// MLA's (192, 128). The 3-d row-form maps stay: a 192-wide row is three 64-column boxes
// and a 128-wide one two, so no box reads past a row. ring_fwd keeps 128 q rows, 128-key
// tiles and its registers (S 64 x 128 and acc 64 x Dv = 64 x 128 f32: Q K^T only gets
// longer, 12 k16 steps in place of 8) in 2 K/V stages (Q 48 KB + 2 x (48 + 32) KB = 208
// KB). The fused ring_bwd would need ~288 KB (K and V resident, two Q / dO stages, two
// dS buffers and 96 KB of f32 dQ staging), so Dv != D takes ring_dq + ring_dkv. ring_dkv
// takes 32 q rows a step (dK 96 + dV 64 + S^T 16 + dP^T 16 accumulator registers, 123 KB
// of shared memory); ring_dq keeps 128 q rows and 64-key tiles in 3 stages (Q 48 + dO
// 32 + 3 x (24 + 16) KB = 200 KB; dQ 64 x 192 f32 is 96 registers).
//
// Design: flash_attention.cu's kernels, with data-driven masks.
//  - Tile classes (tile_class, the one place of the rule): a (q tile, kv tile) pair is
//    SKIP when the ranges of positions and segment ids its rows hold (rows inside Sq /
//    Skv only) allow no pair, FULL when they allow every pair and neither tile runs past
//    its chunk, else PARTIAL. All warps of a block first class the tiles it meets
//    (each lane reads a few of a tile's ids, a few shuffles reduce them) and keep only
//    the first and last non-skipped tile and their number, so nothing is stored a tile
//    and a chunk may be of any length. The producer walks that range, classes each tile
//    again (the same rule on the same ids), loads only the non-skipped ones and leaves
//    each one's index and class in a word beside its stage for the consumers; in the
//    forward, whose tiles compute quickly, one warp classes up to 8 tiles ahead of the
//    warp that loads, so that a classing's round trip to memory never waits in front of
//    a load. A skipped tile is neither loaded nor computed, a full tile computes no
//    per-element mask, and a block with nothing to do returns at once without touching
//    the carry or the accumulators. Skipping is exact: a fully masked tile would leave
//    (acc, m, l) unchanged and add 0 to dq / dk / dv. At a causal ring over contiguous
//    shards this skips half of all tile pairs: at step t of cp, t shards see a chunk
//    wholly in their future, and at the diagonal step the upper triangle. Given a counts
//    buffer, the producer adds the tiles of each class it met (those outside its range
//    as skipped), so a caller can hold the device's rule against ops/ring_chunk.py's.
//  - Both kernels are warp-specialised: 3 warpgroups (384 threads) a block; warpgroup 0
//    gives up its registers (setmaxnreg.dec) and issues TMA loads of 128-byte-swizzled
//    tiles from row-form 3-d maps (rows past S read as zeros) into a ring of mbarrier
//    stages; warpgroups 1 and 2 take the registers (setmaxnreg.inc) and run wgmma.
//  - ring_fwd: a block owns 128 query rows (64 a consumer warpgroup) of one (b, h) and
//    walks the non-skipped key tiles of 128. The consumers load the carry into the
//    accumulator registers while the first tiles load (m stays in natural units, so its
//    -1e30 sentinel passes through unchanged; the exponentials run in base 2 from it),
//    run S = Q K^T (shared-memory wgmma) and O += P V (P from registers) as flash does,
//    the P.V of one tile beside the softmax of the next, and write the unnormalised
//    carry back in place. A partial tile reads its keys' ids from global memory (in
//    cache after the classing): shared memory at D=128 holds Q and three K/V stages and
//    little else.
//  - ring_bwd: a block owns 128 keys (64 a consumer warpgroup) of one (b, kv head) and
//    walks the GQA group's q heads and their non-skipped q tiles of 64. S^T = K Q^T and
//    dP^T = V dO^T are shared-memory wgmmas; dV += P^T dO and dK += dS^T Q accumulate in
//    registers; lse, delta and the q tile's ids land beside the tiles by cp.async; dQ =
//    dS K is staged in swizzled shared memory and added into the f32 dq by TMA
//    reduce-adds. At the end dK / dV are added into the chunk's f32 dk / dv (a block
//    owns its keys: no atomics).
// What it leaves on the table: everything flash_attention.cu's header lists (no
// ping-pong of the consumer warpgroups, the backward waits for its own products every
// step, epilogues from registers), plus the classing pass before the first load (one
// round trip to L2 for the block's ids), the backward's second classing of each q tile
// in front of its loads (once a q head of the group; its steps are long enough to hide
// it), and a skip that is only as fine as the 128 x 128 (forward) or 64 x 128
// (backward) tile.

#include <climits>

#include "attention_tiles.cuh"

namespace {

constexpr int SKIP = 0, PARTIAL = 1, FULL = 2;

// The word the producer leaves beside a stage: the tile's index and its class.
__device__ __forceinline__ int tile_word(int j, int cls) { return j * 4 + cls; }

struct Mask {
  int causal, has_window, window, segmented;

  __device__ __forceinline__ bool allowed(int pq, int pkv, int sq, int skv) const {
    bool ok = !causal || pq >= pkv;
    if (has_window) ok = ok && pq - pkv < window;
    if (segmented) ok = ok && sq == skv;
    return ok;
  }
};

// The ranges of positions and segment ids of one tile's rows inside its chunk, and
// whether the tile runs past the chunk.
struct Range {
  int p_lo, p_hi, s_lo, s_hi;
  bool ragged;
};

// Range of rows [start, start + ROWS) of one batch row's ids (rows past len left out),
// by one warp; every lane gets it. seg == nullptr: no segments.
template <int ROWS>
__device__ __forceinline__ Range warp_range(const int* pos, const int* seg, int start, int len,
                                            int lane) {
  int p_lo = INT_MAX, p_hi = INT_MIN, s_lo = INT_MAX, s_hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int r = start + lane + 32 * i;
    if (r < len) {
      const int p = pos[r];
      p_lo = min(p_lo, p);
      p_hi = max(p_hi, p);
      if (seg != nullptr) {
        const int s = seg[r];
        s_lo = min(s_lo, s);
        s_hi = max(s_hi, s);
      }
    }
  }
  return {__reduce_min_sync(0xffffffffu, p_lo), __reduce_max_sync(0xffffffffu, p_hi),
          __reduce_min_sync(0xffffffffu, s_lo), __reduce_max_sync(0xffffffffu, s_hi),
          start + ROWS > len};
}

// The one place of the tile-class rule (ops/ring_chunk.py: tile_class is the same rule
// for the tests): SKIP when no pair of the two tiles is allowed, FULL when every pair is
// and neither tile is ragged, else PARTIAL.
__device__ __forceinline__ int tile_class(const Range& q, const Range& k, const Mask& mask) {
  const long long lo_gap = (long long)q.p_lo - k.p_hi;  // the least pq - pkv of the pairs
  const long long hi_gap = (long long)q.p_hi - k.p_lo;  // the largest
  if ((mask.causal && hi_gap < 0) || (mask.has_window && lo_gap >= mask.window) ||
      (mask.segmented && (q.s_hi < k.s_lo || k.s_hi < q.s_lo)))
    return SKIP;
  const bool full = !q.ragged && !k.ragged && (!mask.causal || lo_gap >= 0) &&
                    (!mask.has_window || hi_gap < mask.window) &&
                    (!mask.segmented ||
                     (q.s_lo == q.s_hi && k.s_lo == k.s_hi && q.s_lo == k.s_lo));
  return full ? FULL : PARTIAL;
}

// The walk of one block, from a pass of all its warps over the tiles it meets: the first
// and last non-skipped tile and the number of non-skipped tiles.
struct Walk {
  int first, last, live;
};

// Every warp of the block classes tiles w, w + 12, ... of the n tiles with `cls(j)`
// (a warp-uniform tile_class); every thread gets the block's walk.
template <typename Cls>
__device__ __forceinline__ Walk block_walk(int n, Walk* sWalk, Cls cls) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) *sWalk = {INT_MAX, -1, 0};
  __syncthreads();
  for (int j = threadIdx.x / 32; j < n; j += THREADS / 32) {
    if (cls(j) != SKIP && lane == 0) {
      atomicMin(&sWalk->first, j);
      atomicMax(&sWalk->last, j);
      atomicAdd(&sWalk->live, 1);
    }
  }
  __syncthreads();
  return *sWalk;
}

// ------------------------------------------------------------------ forward

template <int D, int DV>
struct Fwd {
  static constexpr int BM = 128, BN = 128;
  // K/V stages: 4 x 32 KB at D=64; 3 x 64 KB at D=128, with Q 32 KB just inside 227 KB;
  // 2 x (48 + 32) KB at (192, 128), with Q 48 KB (208 KB; 3 stages would not fit)
  static constexpr int STAGES = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int BOXES = D / BOX, V_BOXES = DV / BOX;
  static constexpr int Q_BYTES = BM * D * 2, K_BYTES = BN * D * 2, V_BYTES = BN * DV * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int RING = 8;  // tile words the classing warp may run ahead
  static constexpr int WORD_OFF = V_OFF + STAGES * V_BYTES;  // one tile word a stage
  static constexpr int RING_OFF = WORD_OFF + (4 * STAGES + 15) / 16 * 16;
  static constexpr int WALK_OFF = RING_OFF + 4 * RING;  // the Walk
  static constexpr int BAR_OFF = WALK_OFF + 16;  // 8-byte aligned for the mbarriers
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES + 2 * RING) * 8 + 1024;  // + slack
};
static_assert(Fwd<64, 64>::SMEM <= 232448 && Fwd<128, 128>::SMEM <= 232448 &&
                  Fwd<192, 128>::SMEM <= 232448, "forward shared memory");
static_assert(Fwd<64, 64>::BAR_OFF % 8 == 0 && Fwd<128, 128>::BAR_OFF % 8 == 0 &&
                  Fwd<192, 128>::BAR_OFF % 8 == 0, "forward barriers");

// Masks one S accumulator tile of a partial key tile: register 4j + 2i + e holds row
// row[i] and key kv_start + 8j + tc + e. The ids come from global memory (in cache after
// the classing), a few keys at a time into a keep-mask, so that they take few registers
// beside the accumulators.
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N], const int (&row)[2], int kv_start,
                                          int tc, int Sq, int Skv, const int* pq, const int* sq,
                                          const int* pkv, const int* skv, const Mask& mask) {
  static_assert(N <= 64, "one keep bit a register");
  int rp[2], rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < Sq;
    rp[i] = in ? __ldg(pq + row[i]) : 0;
    rs[i] = in && mask.segmented ? __ldg(sq + row[i]) : 0;
  }
  uint64_t keep = 0;
#pragma unroll 4
  for (int c = 0; c < N / 2; ++c) {  // key kv_start + 8 * (c / 2) + tc + c % 2
    const int col = kv_start + 8 * (c >> 1) + tc + (c & 1);
    if (col < Skv) {
      const int p = __ldg(pkv + col);
      const int sg = mask.segmented ? __ldg(skv + col) : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row[i] < Sq && mask.allowed(rp[i], p, rs[i], sg))
          keep |= 1ull << (4 * (c >> 1) + 2 * i + (c & 1));
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) s[r] = (keep >> r) & 1 ? s[r] : -INFINITY;
}

// grid (ceil(Sq / 128), B * H), 384 threads; block x takes q tile gridDim.x - 1 - x (the
// heaviest tiles of a causal diagonal step first). counts: null, or SKIP / PARTIAL / FULL
// tallies the producer adds to.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
ring_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const int* __restrict__ pos_q,
                const int* __restrict__ pos_kv, const int* __restrict__ seg_q,
                const int* __restrict__ seg_kv, float* __restrict__ acc_carry,
                float* __restrict__ m_carry, float* __restrict__ l_carry, int* __restrict__ counts,
                int Sq, int Skv, int H, int KH, float scale, Mask mask) {
  using C = Fwd<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  volatile int* sWord = reinterpret_cast<int*>(smem + C::WORD_OFF);
  volatile int* sRing = reinterpret_cast<int*>(smem + C::RING_OFF);
  Walk* sWalk = reinterpret_cast<Walk*>(smem + C::WALK_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;
  uint64_t* ring_full = empty + C::STAGES;
  uint64_t* ring_empty = ring_full + C::RING;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bk = b * KH + (bh % H) / (H / KH);
  const int n_kv = (Skv + C::BN - 1) / C::BN;
  const int* pq_b = pos_q + (size_t)b * Sq;
  const int* pkv_b = pos_kv + (size_t)b * Skv;
  const int* sq_b = mask.segmented ? seg_q + (size_t)b * Sq : nullptr;
  const int* skv_b = mask.segmented ? seg_kv + (size_t)b * Skv : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the bytes to come
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    for (int r = 0; r < C::RING; ++r) {
      mbar_init(&ring_full[r], 1);
      mbar_init(&ring_empty[r], 1);
    }
    fence_barrier_init();
  }
  const Range qr = warp_range<C::BM>(pq_b, sq_b, q_start, Sq, lane);
  auto cls = [&](int j) {
    return tile_class(qr, warp_range<C::BN>(pkv_b, skv_b, j * C::BN, Skv, lane), mask);
  };
  const Walk walk = block_walk(n_kv, sWalk, cls);
  if (counts != nullptr && threadIdx.x == 0)  // the tiles outside the walk are skipped
    atomicAdd(counts + SKIP, n_kv - (walk.live ? walk.last - walk.first + 1 : 0));
  if (walk.live == 0) return;  // no allowed pair: the carry stays as it is

  if (wg == 0) {
    // producer: warp 1 walks the kv tiles from the first to the last non-skipped one,
    // classes each again (the same rule on the same ids) and hands each non-skipped
    // tile's word to warp 0 through a ring of RING words, so that a classing's round
    // trip to memory runs ahead of the loads instead of before each; warp 0's lane 0
    // loads Q, then each word's tile into the next stage, and leaves the word beside it
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 64) return;
    if (threadIdx.x >= 32) {
      int k = 0;
      for (int j = walk.first; j <= walk.last; ++j) {
        const int c = cls(j);
        if (lane != 0) continue;
        if (counts != nullptr) atomicAdd(counts + c, 1);
        if (c == SKIP) continue;
        const int r = k % C::RING;
        mbar_wait(&ring_empty[r], ((k / C::RING) & 1) ^ 1);
        sRing[r] = tile_word(j, c);
        mbar_arrive(&ring_full[r]);
        ++k;
      }
      return;
    }
    if (lane != 0) return;
    mbar_arrive_expect_tx(q_full, C::Q_BYTES);
    for (int x = 0; x < C::BOXES; ++x)
      tma_load_3d(smem + x * C::BM * ROW_BYTES, &tq, q_full, x * BOX, q_start, bh);
    for (int it = 0; it < walk.live; ++it) {
      const int r = it % C::RING;
      mbar_wait(&ring_full[r], (it / C::RING) & 1);
      const int word = sRing[r];
      mbar_arrive(&ring_empty[r]);
      const int j = word >> 2, stage = it % C::STAGES;
      mbar_wait(&empty[stage], ((it / C::STAGES) & 1) ^ 1);
      sWord[stage] = word;
      mbar_arrive_expect_tx(&full[stage], C::K_BYTES + C::V_BYTES);
      unsigned char* sk = smem + C::K_OFF + stage * C::K_BYTES;
      unsigned char* sv = smem + C::V_OFF + stage * C::V_BYTES;
      for (int x = 0; x < C::BOXES; ++x)
        tma_load_3d(sk + x * C::BN * ROW_BYTES, &tk, &full[stage], x * BOX, j * C::BN, bk);
      for (int x = 0; x < C::V_BOXES; ++x)
        tma_load_3d(sv + x * C::BN * ROW_BYTES, &tv, &full[stage], x * BOX, j * C::BN, bk);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: query rows cw*64 .. cw*64+63 of the tile
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  const int q0 = q_start + cw * 64;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = scale * LOG2E;

  // the carry of this thread's rows in the accumulator layout; l is summed over the
  // quad at the end, so only its first lane starts with it; the carry loads run under
  // the first tiles' loads
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < Sq;
    const size_t r = (size_t)bh * Sq + row[i];
    if (in) {
      m[i] = m_carry[r];
      if (tc == 0) l[i] = l_carry[r];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (in) a = *reinterpret_cast<const float2*>(acc_carry + r * DV + 8 * j + tc);
      acc[4 * j + 2 * i] = a.x;
      acc[4 * j + 2 * i + 1] = a.y;
    }
  }

  // Key tile `it` of the walk: S_it = Q K_it^T is issued together with O += P_{it-1}
  // V_{it-1}, so the tensor cores run the previous tile's P.V while this tile's softmax
  // runs. Tile 0 is peeled off, so that every P.V and its wait sit in one block (ptxas
  // serialises every wgmma of a kernel when it cannot pair them).
  const uint32_t q_addr = smem_u32(smem) + cw * 64 * ROW_BYTES;
  uint32_t pa[C::BN / 16][4];
  float s[C::BN / 2];
  int prev_stage = 0;
  int word = 0;  // the tile of the current step and its class
  // S of the tile in `stage` into s (its full barrier waited for)
  auto issue_s = [&](int stage) {
    const uint32_t k_addr = smem_u32(smem + C::K_OFF + stage * C::K_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * C::BN * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<C::BN, 0, 0>(s, desc_sw128(q_addr + off, 16), desc_sw128(k_addr + koff, 16), ks);
    }
    wgmma_commit();
  };
  // mask (partial tiles), scale and exponentiate s in place; returns O's rescale factors.
  // m stays in natural units; p = 2^(s * scale * log2(e) - m * log2(e)).
  auto softmax = [&](float (&alpha)[2]) {  // of the tile of `word`
    if ((word & 3) == PARTIAL)
      mask_keys(s, row, (word >> 2) * C::BN, tc, Sq, Skv, pq_b, sq_b, pkv_b, skv_b, mask);
    float mx[2] = {-INFINITY, -INFINITY};  // of the unscaled scores (the scale is > 0)
#pragma unroll
    for (int r = 0; r < C::BN / 2; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
    float m_log2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale);  // -1e30 while none allowed
      alpha[i] = fast_exp2((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      m_log2[i] = m_new * LOG2E;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < C::BN / 2; ++r) {
      s[r] = fast_exp2(fmaf(s[r], scale_log2, -m_log2[(r >> 1) & 1]));
      rs[(r >> 1) & 1] += s[r];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // quad-partial
  };
  // O *= alpha, then P (s) rounded to bf16 as the A operand of P.V: registers 8kk..8kk+7
  // are keys 16kk..16kk+15
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      acc[4 * jj] *= alpha[0];
      acc[4 * jj + 1] *= alpha[0];
      acc[4 * jj + 2] *= alpha[1];
      acc[4 * jj + 3] *= alpha[1];
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
    const uint32_t v_addr = smem_u32(smem + C::V_OFF + stage * C::V_BYTES);
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      wgmma_rs<DV, 1>(acc, pa[kk], desc_sw128(v_addr + kk * 16 * ROW_BYTES, C::BN * ROW_BYTES), 1);
    wgmma_commit();
  };
  auto fence_pa = [&]() {
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) fence_regs(pa[kk]);
  };

  mbar_wait(q_full, 0);
  {
    float alpha[2];
    mbar_wait(&full[0], 0);
    word = sWord[0];
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(alpha);
    rescale_and_pack(alpha);
  }
  for (int it = 1; it < walk.live; ++it) {
    const int stage = it % C::STAGES;
    float alpha[2];
    mbar_wait(&full[stage], (it / C::STAGES) & 1);
    word = sWord[stage];
    issue_s(stage);
    issue_pv(prev_stage);
    wgmma_wait<1>();  // S is done; the previous tile's P.V runs on
    fence_regs(s);
    softmax(alpha);
    wgmma_wait<0>();  // P.V is done: its stage is free, O can be rescaled
    fence_regs(acc);
    fence_pa();
    release(&empty[prev_stage], lane);
    rescale_and_pack(alpha);
    prev_stage = stage;
  }
  issue_pv(prev_stage);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_pa();
  release(&empty[prev_stage], lane);

  // the updated carry, unnormalised, back into the buffers it was read from
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (row[i] >= Sq) continue;
    const size_t r = (size_t)bh * Sq + row[i];
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj)
      *reinterpret_cast<float2*>(acc_carry + r * DV + 8 * jj + tc) =
          make_float2(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
    if (tc == 0) {
      m_carry[r] = m[i];
      l_carry[r] = li;
    }
  }
}

// ------------------------------------------------------------------ backward

// With DQ, dS^T and the dQ partials are staged in shared memory (the fused ring_bwd, at
// DV == D only: at (192, 128) K and V resident, two Q / dO stages, the dS buffers and
// the f32 dQ staging would take ~288 KB); without (ring_dkv), neither region exists.
// At DV != D a step takes 32 q rows, not 64: dK's 64 x 192 f32 accumulator (96
// registers a thread) and dV's 64 x 128 (64) then leave S^T and dP^T 16 each.
template <int D, int DV, bool DQ>
struct Bwd {
  static constexpr int BN = 128;                // keys a block (64 a consumer warpgroup)
  static constexpr int BM = D == DV ? 64 : 32;  // q rows a step
  static constexpr int STAGES = 2;
  static constexpr int BOXES = D / BOX, V_BOXES = DV / BOX;
  static constexpr int DH = D / 2;  // dQ columns of one consumer warpgroup
  static constexpr int K_BYTES = BN * D * 2, V_BYTES = BN * DV * 2;
  static constexpr int QT_BYTES = BM * D * 2, DOT_BYTES = BM * DV * 2;
  static constexpr int DS_BYTES = BN * BM * 2;   // dS^T (keys x q rows), one buffer
  static constexpr int DQ_BYTES = BM * DH * 4;   // one warpgroup's staged dQ partial
  static constexpr int K_OFF = 0, V_OFF = K_BYTES;
  static constexpr int Q_OFF = K_BYTES + V_BYTES;              // per stage
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;     // per stage
  static constexpr int DS_OFF = DO_OFF + STAGES * DOT_BYTES;   // 2 buffers
  static constexpr int DQ_OFF = DS_OFF + (DQ ? 2 * DS_BYTES : 0);  // 2 warpgroups
  // per stage: lse, delta, q positions, q segment ids (BM each)
  static constexpr int ROWS_STRIDE = 4 * BM;
  static constexpr int ROWS_OFF = DQ_OFF + (DQ ? 2 * DQ_BYTES : 0);
  static constexpr int KIDS_OFF = ROWS_OFF + STAGES * ROWS_STRIDE * 4;  // key positions, ids
  static constexpr int WORD_OFF = KIDS_OFF + 2 * BN * 4;  // tile word and q head a stage
  static constexpr int WALK_OFF = WORD_OFF + (8 * STAGES + 15) / 16 * 16;  // the Walk
  static constexpr int BAR_OFF = WALK_OFF + 16;  // 8-byte aligned for the mbarriers
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};
static_assert(Bwd<64, 64, true>::SMEM <= 232448 && Bwd<128, 128, true>::SMEM <= 232448 &&
                  Bwd<192, 128, false>::SMEM <= 232448, "backward shared memory");
static_assert(Bwd<64, 64, true>::BAR_OFF % 8 == 0 && Bwd<128, 128, true>::BAR_OFF % 8 == 0 &&
                  Bwd<192, 128, false>::BAR_OFF % 8 == 0, "backward barriers");

// Masks one S^T accumulator tile of a partial q tile: register r holds key
// key[(r >> 1) & 1] and q row q_start + c, c = 8 * (r / 4) + tc + (r & 1); the q rows'
// ids sit beside the tile in shared memory.
template <int N>
__device__ __forceinline__ void mask_queries(float (&s)[N], const int (&key)[2],
                                             const int (&kp)[2], const int (&ks)[2],
                                             int q_start, int tc, int Sq, int Skv,
                                             const int* qpos, const int* qseg,
                                             const Mask& mask) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int i = (r >> 1) & 1;
    const int c = 8 * (r / 4) + tc + (r & 1);
    const bool ok = key[i] < Skv && q_start + c < Sq &&
                    mask.allowed(qpos[c], kp[i], mask.segmented ? qseg[c] : 0, ks[i]);
    s[r] = ok ? s[r] : -INFINITY;
  }
}

// grid (ceil(Skv / 128), B * KH), 384 threads. Each block holds one 128-key K/V tile,
// loops over the q heads of its GQA group and their non-skipped q tiles, and owns its
// dK/dV rows (consumer warpgroup w: keys w*64 .. w*64+63), so the group sum needs no
// second pass; with DQ, dq gets the dQ partials by TMA reduce-adds (through tdq); without,
// neither dS is staged nor dQ computed. counts: null, or SKIP / PARTIAL / FULL tallies of
// the q tiles against this key tile (once, not once a head).
template <int D, int DV, bool DQ>
__global__ void __launch_bounds__(THREADS, 1)
ring_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq, const int* __restrict__ pos_q,
                const int* __restrict__ pos_kv, const int* __restrict__ seg_q,
                const int* __restrict__ seg_kv, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                int* __restrict__ counts, int Sq, int Skv, int H, int KH, float scale, Mask mask) {
  using C = Bwd<D, DV, DQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sRows = reinterpret_cast<float*>(smem + C::ROWS_OFF);
  int* sKPos = reinterpret_cast<int*>(smem + C::KIDS_OFF);
  int* sKSeg = sKPos + C::BN;
  volatile int* sWord = reinterpret_cast<int*>(smem + C::WORD_OFF);  // word, head a stage
  Walk* sWalk = reinterpret_cast<Walk*>(smem + C::WALK_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int kv_start = blockIdx.x * C::BN;
  const int bk = blockIdx.y;
  const int b = bk / KH, kvh = bk % KH;
  const int groups = H / KH;
  const int n_q = (Sq + C::BM - 1) / C::BM;
  const int* pq_b = pos_q + (size_t)b * Sq;
  const int* pkv_b = pos_kv + (size_t)b * Skv;
  const int* sq_b = mask.segmented ? seg_q + (size_t)b * Sq : nullptr;
  const int* skv_b = mask.segmented ? seg_kv + (size_t)b * Skv : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 33);  // the producer's lane 0 with the bytes, its 32 lanes' rows
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  // the keys' ids wait in shared memory for the partial tiles
  if (threadIdx.x < C::BN) {
    const int key = kv_start + threadIdx.x;
    sKPos[threadIdx.x] = key < Skv ? pkv_b[key] : 0;
    sKSeg[threadIdx.x] = key < Skv && mask.segmented ? skv_b[key] : 0;
  }
  const Range kr = warp_range<C::BN>(pkv_b, skv_b, kv_start, Skv, lane);
  auto cls = [&](int j) {
    return tile_class(warp_range<C::BM>(pq_b, sq_b, j * C::BM, Sq, lane), kr, mask);
  };
  const Walk walk = block_walk(n_q, sWalk, cls);  // its first barrier also covers the ids
  if (counts != nullptr && threadIdx.x == 0)  // the tiles outside the walk are skipped
    atomicAdd(counts + SKIP, n_q - (walk.live ? walk.last - walk.first + 1 : 0));
  if (walk.live == 0) return;  // no allowed pair: dq, dk and dv stay as they are

  if (wg == 0) {
    // producer: warp 0 walks the GQA group's q heads and, for each, the q tiles from the
    // first to the last non-skipped one, classing each again (the same rule on the same
    // ids). For each non-skipped tile its lane 0 leaves the step's word and head and
    // issues the TMA loads of Q and dO, and every lane copies its rows of lse, delta,
    // positions and segment ids; the stage's full barrier takes all 33 arrivals.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, C::K_BYTES + C::V_BYTES);
      for (int x = 0; x < C::BOXES; ++x)
        tma_load_3d(smem + C::K_OFF + x * C::BN * ROW_BYTES, &tk, kv_full, x * BOX, kv_start, bk);
      for (int x = 0; x < C::V_BOXES; ++x)
        tma_load_3d(smem + C::V_OFF + x * C::BN * ROW_BYTES, &tv, kv_full, x * BOX, kv_start, bk);
    }
    int stage = 0, phase = 1;  // the first pass over the stages finds them empty
    for (int h = kvh * groups; h < (kvh + 1) * groups; ++h) {
      const int bh = b * H + h;
      for (int j = walk.first; j <= walk.last; ++j) {
        const int c = cls(j);
        if (counts != nullptr && lane == 0 && h == kvh * groups) atomicAdd(counts + c, 1);
        if (c == SKIP) continue;
        const int q_start = j * C::BM;
        mbar_wait(&empty[stage], phase);
        if (lane == 0) {
          sWord[2 * stage] = tile_word(j, c);
          sWord[2 * stage + 1] = h;
          mbar_arrive_expect_tx(&full[stage], C::QT_BYTES + C::DOT_BYTES);
          unsigned char* sq = smem + C::Q_OFF + stage * C::QT_BYTES;
          unsigned char* sdo = smem + C::DO_OFF + stage * C::DOT_BYTES;
          for (int x = 0; x < C::BOXES; ++x)
            tma_load_3d(sq + x * C::BM * ROW_BYTES, &tq, &full[stage], x * BOX, q_start, bh);
          for (int x = 0; x < C::V_BOXES; ++x)
            tma_load_3d(sdo + x * C::BM * ROW_BYTES, &tdo, &full[stage], x * BOX, q_start, bh);
        }
        // asynchronous 4-byte copies, no data through registers; past Sq they fill zeros
        // (such rows are masked). Each lane's arrival counts when its copies land.
        float* rows = sRows + stage * C::ROWS_STRIDE;
#pragma unroll
        for (int jj = 0; jj < C::BM / 32; ++jj) {
          const int i = lane + 32 * jj;
          const int q = q_start + i;
          const bool in = q < Sq;
          cp_async_4(rows + i, lse + (in ? (size_t)bh * Sq + q : 0), in);
          cp_async_4(rows + C::BM + i, delta + (in ? (size_t)bh * Sq + q : 0), in);
          cp_async_4(rows + 2 * C::BM + i, pq_b + (in ? q : 0), in);
          if (mask.segmented) cp_async_4(rows + 3 * C::BM + i, sq_b + (in ? q : 0), in);
        }
        cp_async_arrive(&full[stage]);
        if (++stage == C::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: keys cw*64 .. cw*64+63 of the tile
  const int t = threadIdx.x % 128, warp = t / 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  const int k0 = kv_start + cw * 64;
  const int krow = warp * 16 + g;  // this thread's keys: k0 + krow, k0 + krow + 8
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_addr = smem_u32(smem + C::K_OFF), v_addr = smem_u32(smem + C::V_OFF);
  float dk_acc[D / 2], dv_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  // steps so far: the stage ring and the dS buffers follow it
  for (int it = 0; it < groups * walk.live; ++it) {
    const int stage = it % C::STAGES;
    mbar_wait(&full[stage], (it / C::STAGES) & 1);
    const int word = sWord[2 * stage];
    const int cls = word & 3;
    const int q_start = (word >> 2) * C::BM;
    const int bh = b * H + sWord[2 * stage + 1];
    const uint32_t q_addr = smem_u32(smem + C::Q_OFF + stage * C::QT_BYTES);
    const uint32_t do_addr = smem_u32(smem + C::DO_OFF + stage * C::DOT_BYTES);
    const float* rows = sRows + stage * C::ROWS_STRIDE;

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 q rows
    float s[C::BM / 2], dp[C::BM / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t aoff = (ks / 4) * C::BN * ROW_BYTES + cw * 64 * ROW_BYTES + (ks % 4) * 32;
      const uint32_t boff = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<C::BM, 0, 0>(s, desc_sw128(k_addr + aoff, 16), desc_sw128(q_addr + boff, 16),
                            ks);
    }
#pragma unroll
    for (int ks = 0; ks < DV / 16; ++ks) {
      const uint32_t aoff = (ks / 4) * C::BN * ROW_BYTES + cw * 64 * ROW_BYTES + (ks % 4) * 32;
      const uint32_t boff = (ks / 4) * C::BM * ROW_BYTES + (ks % 4) * 32;
      wgmma_ss<C::BM, 0, 0>(dp, desc_sw128(v_addr + aoff, 16), desc_sw128(do_addr + boff, 16),
                            ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T * scale - lse), dS^T = P^T * (dP^T - delta): bf16 A fragments of both
    unsigned char* sds = smem + C::DS_OFF + (it & 1) * C::DS_BYTES;
    if (cls == PARTIAL) {
      const int keys[2] = {k0 + krow, k0 + krow + 8};
      const int kp[2] = {sKPos[cw * 64 + krow], sKPos[cw * 64 + krow + 8]};
      const int kseg[2] = {sKSeg[cw * 64 + krow], sKSeg[cw * 64 + krow + 8]};
      mask_queries(s, keys, kp, kseg, q_start, tc, Sq, Skv,
                   reinterpret_cast<const int*>(rows + 2 * C::BM),
                   reinterpret_cast<const int*>(rows + 3 * C::BM), mask);
    }
    uint32_t pa[C::BM / 16][4], sa[C::BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk) {
      float p[8], ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int qc = 16 * kk + 8 * (e >> 2) + tc + (e & 1);  // q column within the tile
        const int r = 8 * kk + e;                              // accumulator register
        p[e] = fast_exp2(fmaf(s[r], scale_log2, -rows[qc] * LOG2E));
        ds[e] = p[e] * (dp[r] - rows[C::BM + qc]);
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        pa[kk][f] = pack_f32(p[2 * f], p[2 * f + 1]);
        sa[kk][f] = pack_f32(ds[2 * f], ds[2 * f + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: register A, B (q rows x D, D contiguous) transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk)
      wgmma_rs<DV, 1>(dv_acc, pa[kk],
                      desc_sw128(do_addr + kk * 16 * ROW_BYTES, C::BM * ROW_BYTES), 1);
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk)
      wgmma_rs<D, 1>(dk_acc, sa[kk],
                     desc_sw128(q_addr + kk * 16 * ROW_BYTES, C::BM * ROW_BYTES), 1);
    wgmma_commit();
    float dq[DQ ? C::DH / 2 : 1];
    if constexpr (DQ) {
      // while they run, dS^T to shared memory for dQ: sa[kk][f] holds key row
      // krow + 8 * (f & 1), q columns 16kk + 8 * (f >> 1) + tc, +1
#pragma unroll
      for (int kk = 0; kk < C::BM / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          *reinterpret_cast<uint32_t*>(sds + swz_bf16(cw * 64 + krow + 8 * (f & 1),
                                                      16 * kk + 8 * (f >> 1) + tc)) = sa[kk][f];
      }
      fence_proxy_async();
      named_sync(3, 256);  // both warpgroups' dS^T rows are in shared memory

      // dQ[:, cw*DH ..] = dS K: A = dS (q rows x 128 keys) read from dS^T through the
      // transpose flag, B = K (keys x D, D contiguous) transposed, this warpgroup's columns
      const uint32_t ds_addr = smem_u32(sds);
      const uint32_t kcol = (D == 64) ? cw * C::DH * 2 : cw * C::BN * ROW_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        wgmma_ss<C::DH, 1, 1>(dq, desc_sw128(ds_addr + kk * 16 * ROW_BYTES, C::BN * ROW_BYTES),
                              desc_sw128(k_addr + kcol + kk * 16 * ROW_BYTES, C::BN * ROW_BYTES),
                              kk);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if constexpr (DQ) fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(sa[kk]);
    }
    release(&empty[stage], lane);  // Q and dO of this stage are read

    if constexpr (DQ) {
      // stage dQ * scale (swizzled f32 boxes of 32 columns) and add it into dq in one
      // bulk reduce-add; the previous one must have finished reading the buffer
      unsigned char* sdq = smem + C::DQ_OFF + cw * C::DQ_BYTES;
      if (t == 0) bulk_wait_read();
      named_sync(1 + cw, 128);
#pragma unroll
      for (int jj = 0; jj < C::DH / 8; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(sdq + swz_f32(warp * 16 + g + 8 * i, 8 * jj + tc, C::BM)) =
              make_float2(dq[4 * jj + 2 * i] * scale, dq[4 * jj + 2 * i + 1] * scale);
      }
      fence_proxy_async();
      named_sync(1 + cw, 128);
      if (t == 0) {
        for (int c = 0; c < C::DH / 32; ++c)
          tma_reduce_add_3d(&tdq, sdq + c * C::BM * ROW_BYTES, cw * C::DH + c * 32, q_start, bh);
        bulk_commit();
      }
    }
  }
  if (DQ && t == 0) bulk_wait();

  // this block owns its keys' rows of dk / dv in this launch: plain read-add-write
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + krow + 8 * i;
    if (key >= Skv) continue;
    const size_t row = (size_t)bk * Skv + key;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      float2* pk = reinterpret_cast<float2*>(dk + row * D + 8 * jj + tc);
      float2 a = *pk;
      a.x += dk_acc[4 * jj + 2 * i] * scale;
      a.y += dk_acc[4 * jj + 2 * i + 1] * scale;
      *pk = a;
    }
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      float2* pv = reinterpret_cast<float2*>(dv + row * DV + 8 * jj + tc);
      float2 c = *pv;
      c.x += dv_acc[4 * jj + 2 * i];
      c.y += dv_acc[4 * jj + 2 * i + 1];
      *pv = c;
    }
  }
}

// ------------------------------------------------------------------ dQ, q-stationary

template <int D, int DV>
struct Dq : DqTiles<D, DV> {
  using T = DqTiles<D, DV>;
  static constexpr int WORD_OFF = T::TAIL_OFF;  // one tile word a stage
  static constexpr int WALK_OFF = WORD_OFF + (4 * T::STAGES + 15) / 16 * 16;  // the Walk
  static constexpr int BAR_OFF = WALK_OFF + 16;  // 8-byte aligned for the mbarriers
  static constexpr int SMEM = BAR_OFF + (1 + 2 * T::STAGES) * 8 + 1024;  // + slack
};
static_assert(Dq<64, 64>::SMEM <= 232448 && Dq<128, 128>::SMEM <= 232448 &&
                  Dq<192, 128>::SMEM <= 232448, "ring_dq shared memory");
static_assert(Dq<64, 64>::BAR_OFF % 8 == 0 && Dq<128, 128>::BAR_OFF % 8 == 0 &&
                  Dq<192, 128>::BAR_OFF % 8 == 0, "ring_dq barriers");

// grid (ceil(Sq / 128), B * H), 384 threads; block x takes q tile gridDim.x - 1 - x. All
// warps class the 64-key tiles against the block's 128 q rows (block_walk); a block
// with no allowed pair returns and leaves dq as it is. The producer loads Q and dO once,
// then walks the tiles from the first to the last non-skipped one, classes each again,
// and loads the non-skipped ones in order with their word beside the stage; the
// consumers run dq_walk with the ring's masks (none for a full tile, mask_keys for a
// partial one) and add dQ * scale into dq (f32, (B*H, Sq, D)) row by row: the block owns
// those rows in this launch.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
ring_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const int* __restrict__ pos_q, const int* __restrict__ pos_kv,
               const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int Sq, int Skv, int H, int KH, float scale, Mask mask) {
  using C = Dq<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  volatile int* sWord = reinterpret_cast<int*>(smem + C::WORD_OFF);
  Walk* sWalk = reinterpret_cast<Walk*>(smem + C::WALK_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bk = b * KH + (bh % H) / (H / KH);
  const int n_kv = (Skv + C::BN - 1) / C::BN;
  const int* pq_b = pos_q + (size_t)b * Sq;
  const int* pkv_b = pos_kv + (size_t)b * Skv;
  const int* sq_b = mask.segmented ? seg_q + (size_t)b * Sq : nullptr;
  const int* skv_b = mask.segmented ? seg_kv + (size_t)b * Skv : nullptr;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the bytes to come
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  const Range qr = warp_range<C::BM>(pq_b, sq_b, q_start, Sq, lane);
  auto cls = [&](int j) {
    return tile_class(qr, warp_range<C::BN>(pkv_b, skv_b, j * C::BN, Skv, lane), mask);
  };
  const Walk walk = block_walk(n_kv, sWalk, cls);
  if (walk.live == 0) return;  // no allowed pair: dq stays as it is

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES + C::DO_BYTES);
      for (int x = 0; x < C::BOXES; ++x)
        tma_load_3d(smem + x * C::BM * ROW_BYTES, &tq, q_full, x * BOX, q_start, bh);
      for (int x = 0; x < C::V_BOXES; ++x)
        tma_load_3d(smem + C::DO_OFF + x * C::BM * ROW_BYTES, &tdo, q_full, x * BOX, q_start, bh);
    }
    int it = 0;
    for (int j = walk.first; j <= walk.last; ++j) {
      const int c = cls(j);  // the whole warp: its reductions take every lane
      if (c == SKIP) continue;
      const int stage = it % C::STAGES;
      mbar_wait(&empty[stage], ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) {
        sWord[stage] = tile_word(j, c);
        mbar_arrive_expect_tx(&full[stage], C::KV_BYTES + C::V_BYTES);
        unsigned char* sk = smem + C::K_OFF + stage * C::KV_BYTES;
        unsigned char* sv = smem + C::V_OFF + stage * C::V_BYTES;
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_3d(sk + x * C::BN * ROW_BYTES, &tk, &full[stage], x * BOX, j * C::BN, bk);
        for (int x = 0; x < C::V_BOXES; ++x)
          tma_load_3d(sv + x * C::BN * ROW_BYTES, &tv, &full[stage], x * BOX, j * C::BN, bk);
      }
      ++it;
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: query rows cw*64 .. cw*64+63 of the tile
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  const int q0 = q_start + cw * 64;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
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
  dq_walk<C>(acc, walk.live, smem, cw, full, empty, lse2, dl, scale * LOG2E, lane,
             [&](int it, float (&s)[C::BN / 2]) {
               const int word = sWord[it % C::STAGES];
               if ((word & 3) == PARTIAL)
                 mask_keys(s, row, (word >> 2) * C::BN, tc, Sq, Skv, pq_b, sq_b, pkv_b, skv_b,
                           mask);
             });

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    float* drow = dq + ((size_t)bh * Sq + row[i]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float2* p = reinterpret_cast<float2*>(drow + 8 * j + tc);
      float2 a = *p;
      a.x += acc[4 * j + 2 * i] * scale;
      a.y += acc[4 * j + 2 * i + 1] * scale;
      *p = a;
    }
  }
}

// A tensor map over row-form bf16 (batch, rows, D): boxes of 64 columns x `box_rows` rows.
inline cudaError_t rows_map(CUtensorMap* map, const void* p, int batch, int rows, int D,
                            int box_rows) {
  return make_map_3d(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, rows, batch, BOX, box_rows);
}

template <int D, int DV>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_kv, const int* seg_q, const int* seg_kv, float* acc,
                       float* m, float* l, int* counts, int B, int Sq, int Skv, int H, int KH,
                       float scale, Mask mask, cudaStream_t stream) {
  using C = Fwd<D, DV>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = rows_map(&tq, q, B * H, Sq, D, C::BM);
  if (err == cudaSuccess) err = rows_map(&tk, k, B * KH, Skv, D, C::BN);
  if (err == cudaSuccess) err = rows_map(&tv, v, B * KH, Skv, DV, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_fwd_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  ring_fwd_kernel<D, DV><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, pos_q, pos_kv, seg_q, seg_kv, acc, m, l, counts, Sq, Skv, H, KH, scale, mask);
  return cudaGetLastError();
}

// dq == nullptr: dk / dv only (DQ = false, no tdq map)
template <int D, int DV, bool DQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_kv, const int* seg_q, const int* seg_kv,
                       const void* dout, const float* lse, const float* delta, float* dq,
                       float* dk, float* dv, int* counts, int B, int Sq, int Skv, int H, int KH,
                       float scale, Mask mask, cudaStream_t stream) {
  using C = Bwd<D, DV, DQ>;
  CUtensorMap tq, tk, tv, tdo, tdq{};
  cudaError_t err = rows_map(&tq, q, B * H, Sq, D, C::BM);
  if (err == cudaSuccess) err = rows_map(&tdo, dout, B * H, Sq, DV, C::BM);
  if (err == cudaSuccess) err = rows_map(&tk, k, B * KH, Skv, D, C::BN);
  if (err == cudaSuccess) err = rows_map(&tv, v, B * KH, Skv, DV, C::BN);
  if (DQ && err == cudaSuccess)  // f32 boxes of 32 columns (128 bytes) x 64 rows
    err = make_map_3d(&tdq, dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, Sq, (uint64_t)B * H, 32,
                      C::BM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_bwd_kernel<D, DV, DQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + C::BN - 1) / C::BN, B * KH);
  ring_bwd_kernel<D, DV, DQ><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, pos_q, pos_kv, seg_q, seg_kv, lse, delta, dk, dv, counts, Sq, Skv, H,
      KH, scale, mask);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* pos_q,
                      const int* pos_kv, const int* seg_q, const int* seg_kv, const void* dout,
                      const float* lse, const float* delta, float* dq, int B, int Sq, int Skv,
                      int H, int KH, float scale, Mask mask, cudaStream_t stream) {
  using C = Dq<D, DV>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = rows_map(&tq, q, B * H, Sq, D, C::BM);
  if (err == cudaSuccess) err = rows_map(&tdo, dout, B * H, Sq, DV, C::BM);
  if (err == cudaSuccess) err = rows_map(&tk, k, B * KH, Skv, D, C::BN);
  if (err == cudaSuccess) err = rows_map(&tv, v, B * KH, Skv, DV, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_dq_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  ring_dq_kernel<D, DV><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, pos_q, pos_kv, seg_q, seg_kv, lse, delta, dq, Sq, Skv, H, KH, scale, mask);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t; the caller
// checks inputs (bf16 q/k/v, f32 carries and gradients, int32 positions and segments,
// all contiguous and 16-byte aligned, (D, Dv) in {(64, 64), (128, 128), (192, 128)},
// H % KH == 0) beforehand; another pair returns cudaErrorInvalidValue. seg_q / seg_kv
// are both null or both set; has_window = 0 ignores window. ring_bwd takes Dv == D
// only; with a null dq it adds only dk / dv (ring_dq adds dq). tile_counts: null, or
// three int32 the kernel adds its (q tile, kv tile) pairs of each class to (SKIP,
// PARTIAL, FULL; over every q head forward, every kv head backward).
extern "C" int ring_fwd(const void* q, const void* k, const void* v, const int* pos_q,
                        const int* pos_kv, const int* seg_q, const int* seg_kv, float* acc,
                        float* m, float* l, int B, int Sq, int Skv, int H, int KH, int D,
                        int Dv, float scale, int causal, int has_window, int window,
                        int* tile_counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, has_window, window, seg_q != nullptr};
#define RING_FWD(DD, DVV)                                                                   \
  if (D == DD && Dv == DVV)                                                                 \
    return (int)launch_fwd<DD, DVV>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, acc, m, l,       \
                                    tile_counts, B, Sq, Skv, H, KH, scale, mask, s);
  RING_FWD(64, 64)
  RING_FWD(128, 128)
  RING_FWD(192, 128)
#undef RING_FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int ring_bwd(const void* q, const void* k, const void* v, const int* pos_q,
                        const int* pos_kv, const int* seg_q, const int* seg_kv,
                        const void* dout, const float* lse, const float* delta, float* dq,
                        float* dk, float* dv, int B, int Sq, int Skv, int H, int KH, int D,
                        int Dv, float scale, int causal, int has_window, int window,
                        int* tile_counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, has_window, window, seg_q != nullptr};
  if (D == 64 && Dv == 64)
    return (int)launch_bwd<64, 64, true>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, dout, lse, delta,
                                         dq, dk, dv, tile_counts, B, Sq, Skv, H, KH, scale, mask,
                                         s);
  if (D == 128 && Dv == 128)
    return (int)launch_bwd<128, 128, true>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, dout, lse,
                                           delta, dq, dk, dv, tile_counts, B, Sq, Skv, H, KH,
                                           scale, mask, s);
  return (int)cudaErrorInvalidValue;
}

// ring_bwd_kernel without dQ (ring_dq gives it)
extern "C" int ring_dkv(const void* q, const void* k, const void* v, const int* pos_q,
                        const int* pos_kv, const int* seg_q, const int* seg_kv,
                        const void* dout, const float* lse, const float* delta, float* dk,
                        float* dv, int B, int Sq, int Skv, int H, int KH, int D, int Dv,
                        float scale, int causal, int has_window, int window, int* tile_counts,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, has_window, window, seg_q != nullptr};
#define RING_DKV(DD, DVV)                                                                    \
  if (D == DD && Dv == DVV)                                                                  \
    return (int)launch_bwd<DD, DVV, false>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, dout, lse, \
                                           delta, nullptr, dk, dv, tile_counts, B, Sq, Skv, H, \
                                           KH, scale, mask, s);
  RING_DKV(64, 64)
  RING_DKV(128, 128)
  RING_DKV(192, 128)
#undef RING_DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" int ring_dq(const void* q, const void* k, const void* v, const int* pos_q,
                       const int* pos_kv, const int* seg_q, const int* seg_kv, const void* dout,
                       const float* lse, const float* delta, float* dq, int B, int Sq, int Skv,
                       int H, int KH, int D, int Dv, float scale, int causal, int has_window,
                       int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, has_window, window, seg_q != nullptr};
#define RING_DQ(DD, DVV)                                                                    \
  if (D == DD && Dv == DVV)                                                                 \
    return (int)launch_dq<DD, DVV>(q, k, v, pos_q, pos_kv, seg_q, seg_kv, dout, lse, delta, \
                                   dq, B, Sq, Skv, H, KH, scale, mask, s);
  RING_DQ(64, 64)
  RING_DQ(128, 128)
  RING_DQ(192, 128)
#undef RING_DQ
  return (int)cudaErrorInvalidValue;
}
