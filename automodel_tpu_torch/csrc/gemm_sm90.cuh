// One Hopper (sm_90a) GEMM core: a 128 x 256 output tile of C = A . B, bf16 operands
// with f32 accumulation, fed by TMA through a ring of mbarrier stages and computed by
// wgmma. grouped_gemm.cu (`gmm`, forward and dX, and `tgmm`) and linear_ce.cu (the
// logits product of `lce_fwd` and the three products of `lce_bwd`) build their kernels
// on it; the TPU kernels they replace are named there.
// Included once per source; everything sits in sm90:: inside an anonymous namespace.
//
// What bounds a GEMM on this card: 989 TFLOP/s of bf16 tensor-core work, which only
// wgmma reaches, against 3.35 TB/s of device memory. A 128 x 256 tile with K steps of
// 64 does 128 * 256 * 64 * 2 = 4.2 MFLOP for 48 KB of operand loads, 87 FLOP a byte
// loaded, and neighbouring blocks share their row or column block through the 50 MB
// L2, so the products this core serves are bound by operations (or, for the short-K
// down projection of gmm, close to both bounds) and the design keeps wgmma fed.
//
// Design (the shape of the kernels in csrc/flash_attention.cu):
//   - 384 threads a block, one block an SM (193 KB of shared memory), one tile a
//     block; the caller's grid order decides which tiles share operands in L2.
//   - Warpgroup 0 is the producer: it gives registers up (setmaxnreg.dec 40) and one
//     thread issues each K step's TMA loads, 128-byte swizzled, A (128 x 64) and B
//     (64 x 256), into a ring of 4 stages of 48 KB under full / empty mbarriers.
//   - Warpgroups 1 and 2 take the registers (setmaxnreg.inc 232) and own 64 rows each:
//     two wgmma m64n128k16 a k16 step from shared memory into 128 f32 accumulators a
//     thread, one K step's products in flight while the next is issued. A stage is
//     released by one mbarrier arrival a warp.
//   - Either operand is K-major (the reduction dim contiguous) or MN-major (read
//     through wgmma's transpose flag), fixed at compile time, so one core serves
//     x . w, x . w^T, h^T . dl and dl^T . h without a copy.
//   - A K-step predicate (the Filter) lets both sides skip the same steps: the
//     producer loads only the active ones, the consumers count them once up front.
//   - Epilogue: once both consumer warpgroups are done the ring is free; each stages
//     its 64 x 256 tile there, as bf16 after a per-element transform or as f32, and a
//     functor stores it 16 bytes a thread, a warp a whole 512-byte row of the tile. An
//     epilogue derived from RegsEpilogue (lce_fwd's row reductions) takes the
//     accumulators in registers instead and stages nothing.
// Why 128 x 256: a warpgroup's k16 step is 64 x 256 x 16 products for 2 KB of A and
// 8 KB of B read from shared memory, and a 64 x 256 f32 accumulator is 128 registers
// a thread, inside the 232 that setmaxnreg gives the consumers; 128 x 128 tiles would
// do half the work for each A slice read from shared memory and each A tile loaded.
// Why one tile a block: a persistent grid (blocks walking tiles, the producer loading
// the next tile during this one's epilogue) needs the epilogue's staging buffer beside
// the ring, which leaves room for 3 stages instead of 4; on the H100 that version
// measured slower for both gmm and lce_bwd, since both consumer warpgroups run the
// epilogue at once, so the tensor cores idle through it either way. tgmm, whose tiles
// have ~8 K steps, is the exception: its kernel (grouped_gemm.cu) walks tiles on this
// core's pieces (load_stage, stage_products, zero_k_rows for its ragged K) and stores
// by TMA, and measured faster so.
// TMA needs 16-byte-aligned global strides: every operand row must hold a multiple of
// 8 bf16 and start 16-byte aligned. The callers route other shapes, before the launch,
// to their mma.sync kernels.
// What it leaves on the table: the two consumer warpgroups run in step rather than in
// turns (ping-pong, which with a persistent grid would let one warpgroup's epilogue
// overlap the other's products); each tile pays its prologue (the first loads) and
// epilogue; no cluster multicast of a tile that neighbouring blocks share.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {
namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output tile rows: 64 a consumer warpgroup
constexpr int BN = 256;  // output tile columns
constexpr int BK = 64;   // K step: one 128-byte swizzled row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
// registers a thread after setmaxnreg: 128 x producer + 256 x consumer may not pass the
// 384 x 168 the block is launched with, or setmaxnreg.inc waits forever
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168, "setmaxnreg budget");
constexpr int ROW_BYTES = 128;              // one swizzled row: 64 bf16
constexpr int BOX64_BYTES = 64 * ROW_BYTES;  // an MN-major box: 64 k rows of 64 m or n
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = RING_BYTES;
constexpr int COUNT_OFF = BAR_OFF + 2 * STAGES * 8;
constexpr int SMEM = COUNT_OFF + 16 + 1024;  // + alignment slack
constexpr int LDS = BN + 8;  // row stride (elements) of a staged output tile: no bank conflicts
static_assert(2 * 64 * LDS * 4 <= RING_BYTES, "an f32 tile is staged in the ring");

// ---------------------------------------------------------------- host

// The TMA box of an operand: K-major A is one (64 k, 128 m) box, K-major B one (64 k,
// 256 n) box; MN-major operands are (64 m or n, 64 k) boxes, two for A, four for B.
constexpr uint32_t box_rows(bool is_a, bool mn_major) { return mn_major ? 64 : (is_a ? BM : BN); }

// A bf16 operand as a tensor map: `rows` rows of `inner` elements, `ld` elements apart,
// `batch` such matrices `batch_ld` elements apart (1 and rows * ld for a plain matrix).
// For a K-major operand `inner` is K; for an MN-major one it is M or N.
inline cudaError_t operand_map(CUtensorMap* map, const void* p, uint64_t inner, uint64_t rows,
                               uint64_t ld, uint64_t batch, uint64_t batch_ld,
                               uint32_t box_rows) {
  return make_map_3d_strided(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, inner, rows, batch,
                             ld * 2, batch_ld * 2, 64, box_rows);
}

// ---------------------------------------------------------------- device

// The dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's period).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A consumer warp is done with a stage: one arrival a warp.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Where one tile's operands start: A's m coordinate, B's n coordinate and the k
// coordinate of B's K step 0 (A's is 0), B's batch entry, and the K steps of BK.
struct Tile {
  int a_m;
  int b_n;
  int b_k0;
  int batch;
  int nk;
};

// The filter that runs every K step.
struct AllSteps {
  __device__ bool skips() const { return false; }
  __device__ bool active(int) const { return true; }
};

// An epilogue that stores the tile as bf16: element (r, c) of the tile goes to
// out[(r0 + r) * ld + c0 + c] when r0 + r < r_end and c0 + c < c_end (c_end a multiple
// of 8).
struct StoreBf16 {
  static constexpr bool F32 = false;
  bf16* out;
  size_t ld;
  int r0, r_end, c0, c_end;
  struct Row {};
  __device__ Row row(int) const { return {}; }
  __device__ float apply(const Row&, int, float x) const { return x; }
  __device__ void store(int r, int c, const uint4& v) const {
    const int row = r0 + r, col = c0 + c;
    if (row < r_end && col < c_end) *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) = v;
  }
};

// Stage one consumer warpgroup's 64 x BN tile in shared memory and hand it to the
// epilogue 8 columns (16 bytes of bf16, 32 of f32) at a time. Epi::F32: stage f32 and
// call store(r, c, lo, hi) with two float4; else stage bf16 after apply() and call
// store(r, c, uint4). r is the row in the 128-row tile, c the column in the tile.
template <class Epi>
__device__ __forceinline__ void epilogue(float (&acc)[2][64], unsigned char* smem, int cw,
                                         int t, const Epi& epi) {
  const int warp = t / 32, lane = t % 32, g = lane / 4, tc = (lane % 4) * 2;
  named_sync(1, 256);  // both consumer warpgroups are done with the ring
  if constexpr (Epi::F32) {
    float* st = reinterpret_cast<float*>(smem) + cw * 64 * LDS;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(st + (warp * 16 + g + 8 * i) * LDS + h * 128 + 8 * j + tc) =
              make_float2(acc[h][4 * j + 2 * i], acc[h][4 * j + 2 * i + 1]);
  } else {
    bf16* st = reinterpret_cast<bf16*>(smem) + cw * 64 * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const typename Epi::Row row = epi.row(cw * 64 + r);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = h * 128 + 8 * j + tc;
          *reinterpret_cast<uint32_t*>(st + r * LDS + c) =
              pack_bf16x2(epi.apply(row, c, acc[h][4 * j + 2 * i]),
                          epi.apply(row, c + 1, acc[h][4 * j + 2 * i + 1]));
        }
    }
  }
  named_sync(2 + cw, 128);
  constexpr int UNITS = BN / 8;  // 8-column units of a row
  for (int u = t; u < 64 * UNITS; u += 128) {
    const int r = u / UNITS, c = (u % UNITS) * 8;
    if constexpr (Epi::F32) {
      const float* s = reinterpret_cast<const float*>(smem) + (cw * 64 + r) * LDS + c;
      epi.store(cw * 64 + r, c, *reinterpret_cast<const float4*>(s),
                *reinterpret_cast<const float4*>(s + 4));
    } else {
      const bf16* s = reinterpret_cast<const bf16*>(smem) + (cw * 64 + r) * LDS + c;
      epi.store(cw * 64 + r, c, *reinterpret_cast<const uint4*>(s));
    }
  }
}

// An epilogue that takes the accumulators in registers, with no staging: a class
// derived from RegsEpilogue has regs(acc, cw, t) (acc in wgmma_ss's layout, columns
// 0..127 in acc[0] and 128..255 in acc[1]; cw the consumer warpgroup, t its thread).
struct RegsEpilogue {};

// Zero the k rows [from, 64) of one MN-major A box (64 k rows of 128 bytes) that a
// consumer warpgroup is about to read, and make the writes visible to wgmma (the async
// proxy) before any of its 128 threads issues one. A k row is a whole 128-byte row of
// the box whatever the swizzle, which moves 16-byte chunks only within a row. For a
// ragged K (tgmm's last step over an expert's rows, whose box also holds the next
// expert's): with A MN-major, consumer warpgroup cw reads only A box cw.
__device__ __forceinline__ void zero_k_rows(unsigned char* box, int from, int cw, int t) {
  uint4* p = reinterpret_cast<uint4*>(box + from * ROW_BYTES);
  for (int i = t; i < (64 - from) * (ROW_BYTES / 16); i += 128) p[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  named_sync(4 + cw, 128);
}

// The producer's loads of one K step into the stage at `sa` (A, then B at sa + A_BYTES),
// counted on `bar`: A's rows from m coordinate a_m at k coordinate a_k, B's columns
// from n coordinate b_n at k coordinate b_k of batch entry `batch`.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void load_stage(unsigned char* sa, const CUtensorMap* ta,
                                           const CUtensorMap* tb, uint64_t* bar, int a_m,
                                           int a_k, int b_n, int b_k, int batch) {
  unsigned char* sb = sa + A_BYTES;
  mbar_arrive_expect_tx(bar, STAGE_BYTES);
  if (A_MN) {
#pragma unroll
    for (int c = 0; c < BM / 64; ++c)
      tma_load_3d(sa + c * BOX64_BYTES, ta, bar, a_m + 64 * c, a_k, 0);
  } else {
    tma_load_3d(sa, ta, bar, a_k, a_m, 0);
  }
  if (B_MN) {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load_3d(sb + c * BOX64_BYTES, tb, bar, b_n + 64 * c, b_k, batch);
  } else {
    tma_load_3d(sb, tb, bar, b_k, b_n, batch);
  }
}

// One K step's products of consumer warpgroup cw from the stage at shared address a
// (B at a + A_BYTES), issued and committed, not waited for: acc[h] (+)= its 64 rows
// of A . columns 128h .. 128h + 127 of B.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void stage_products(float (&acc)[2][64], uint32_t a, int cw) {
  const uint32_t b = a + A_BYTES;
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    // A: this warpgroup's 64 rows; K-major steps 32 bytes a k16, MN-major 16 rows
    const uint64_t da = A_MN ? desc_sw128(a + cw * BOX64_BYTES + ks * 16 * ROW_BYTES,
                                          BOX64_BYTES)
                             : desc_sw128(a + cw * 64 * ROW_BYTES + ks * 32, 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t db =
          B_MN ? desc_sw128(b + h * 2 * BOX64_BYTES + ks * 16 * ROW_BYTES, BOX64_BYTES)
               : desc_sw128(b + h * 128 * ROW_BYTES + ks * 32, 16);
      wgmma_ss<128, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc[h], da, db, 1);
    }
  }
  wgmma_commit();
}

// One 128 x BN tile of A . B, run by all THREADS threads of the block as the last thing
// the kernel does: ta / tb are __grid_constant__ tensor maps (A_MN / B_MN: the operand
// is MN-major), `filt` picks the K steps, `epi` stores the result (zeros when the
// filter lets no step through).
template <bool A_MN, bool B_MN, class Filter, class Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* ta, const CUtensorMap* tb,
                                          const Tile& tile, const Filter& filt, const Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* count = reinterpret_cast<int*>(smem + COUNT_OFF);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the stage's bytes
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    *count = 0;
    fence_barrier_init();
  }
  __syncthreads();
  // the K steps that carry work, counted once by the whole block
  int n_active = tile.nk;
  if (filt.skips()) {
    int c = 0;
    for (int k = threadIdx.x; k < tile.nk; k += THREADS) c += filt.active(k) ? 1 : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0 && c > 0) atomicAdd(count, c);
    __syncthreads();
    n_active = *count;
  }

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    int cnt = 0;
    for (int k = 0; k < tile.nk; ++k) {
      if (!filt.active(k)) continue;
      const int stage = cnt % STAGES;
      mbar_wait(&empty[stage], ((cnt / STAGES) & 1) ^ 1);  // the first pass finds it empty
      load_stage<A_MN, B_MN>(smem + stage * STAGE_BYTES, ta, tb, &full[stage], tile.a_m, k * BK,
                             tile.b_n, tile.b_k0 + k * BK, tile.batch);
      ++cnt;
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: tile rows cw*64 .. cw*64+63
  const int t = threadIdx.x % 128, lane = t % 32;
  float acc[2][64];  // columns 0..127 and 128..255
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  for (int it = 0; it < n_active; ++it) {
    const int stage = it % STAGES;
    mbar_wait(&full[stage], (it / STAGES) & 1);
    stage_products<A_MN, B_MN>(acc, smem_u32(smem + stage * STAGE_BYTES), cw);
    wgmma_wait<1>();  // the previous step's products are done: its stage is free
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (it > 0) release(&empty[(it - 1) % STAGES], lane);
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  if constexpr (std::is_base_of<RegsEpilogue, Epi>::value)
    epi.regs(acc, cw, t);
  else
    epilogue(acc, smem, cw, t, epi);
}

}  // namespace sm90
}  // namespace
