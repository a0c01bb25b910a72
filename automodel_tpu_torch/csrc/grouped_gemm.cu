// Grouped (ragged) expert GEMM for Hopper (sm_90a): the MoE expert projections over
// token rows sorted by expert, and their weight gradient.
//
// Replaces the Pallas kernels of automodel_tpu/ops/pallas/grouped_gemm.py:
//   gmm  <- _gmm_kernel (:126, out[rows of e] = x[rows of e] @ w[e]); with w read as
//           its transpose in place it is also the dX of the backward (_bwd_rule), so no
//           swapaxes copy of the expert stack is made
//   tgmm <- _tgmm_kernel (:151, dw[e] = x[rows of e]^T @ dout[rows of e]; zeros for an
//           expert with no rows)
//
// Layouts: x (N, K) bf16 row-major, rows sorted so that each expert's rows are
// contiguous; ends (E,) int32 the inclusive prefix sum of group_sizes (expert e owns
// rows [ends[e-1], ends[e]) with ends[-1] = 0), on the device; w (E, K, Nout) bf16
// row-major (forward) or (E, Nout, K) row-major read as its transpose (dX: K = F,
// Nout = D of a (E, D, F) stack); out (N, Nout) bf16. tgmm: x (N, D), dout (N, F),
// dw (E, D, F) bf16. Any N, K, Nout, D, F >= 1 between the two routes below; rows
// past ends[E-1] get zeros in gmm and count for no expert in tgmm. No launch waits for
// the host: every grid comes from the static shapes.
//
// What bounds it. At the Qwen3-30B-A3B slice shape (N = 65,536 routed rows, E = 128)
// the gate_up forward (K = 2048, Nout = 1536) is 2NKNout = 412.3 GFLOP, 0.417 ms at
// 989 TFLOP/s, against x 268 MB + w 805 MB + out 201 MB = 1.27 GB, 0.38 ms at
// 3.35 TB/s: bound by operations, barely. The down projection (K = 768, Nout = 2048)
// is 206 GFLOP (0.208 ms) against 0.77 GB (0.23 ms): bound by bytes. So a block reads
// its expert's weight tile once per 128-row tile, never once per row.
//
// Two routes for each kernel, picked by the wrapper (ops/grouped_gemm.py) from the
// shapes before the launch:
//   - gmm_wgmma, when K and Nout are multiples of 8 (TMA's 16-byte strides): the Hopper
//     core of gemm_sm90.cuh (TMA into 4 mbarrier stages, a producer warpgroup, two
//     wgmma consumer warpgroups, 128 x 256 tiles, 16-byte epilogue stores). x is the
//     K-major A operand; w[e] is B, MN-major in the forward and K-major in dX, the
//     expert picked by the tensor map's batch coordinate. Tiles start at each
//     expert's first row, ceil(size_e / 128) of them an expert, then tiles that zero
//     the rows past ends[E-1]; at most ceil(N / 128) + E tiles, a static grid whose
//     spare blocks exit at once. A block finds its tile from `ends` itself (row_tile:
//     a warp scan of the experts' tile counts), so no schedule is built or stored.
//     Each tile stores only its expert's rows [lo, hi); rows of the next expert that
//     its TMA box also loads are computed and thrown away. That is the schedule's
//     waste: half a tile an expert on average, ~64 of ~576 tiles (11%) at the slice
//     shape, against ~25% for tiles aligned to 128 rows that run one mainloop per
//     expert they overlap. Tail tiles run no K step and store the zero accumulator.
//   - tgmm_wgmma, when D and F are multiples of 8: 128 x 256 tiles of dw[e] on the
//     core's pieces. A = x_e^T and B = dout_e are both MN-major, read in place from
//     the expert's first row (TMA coordinates are per element, so no row alignment is
//     needed); K runs over the expert's rows in steps of 64. TMA fills zeros only past
//     the tensor's edge, so the last step's box also holds the next expert's rows (or
//     the rows past the groups): the consumers zero those k rows of the A tile in
//     shared memory before their wgmma (sm90::zero_k_rows), as _tgmm_kernel masks x.
//     An empty expert runs no K step and stores the zero tile. A tile has only ~8 K
//     steps at the slice shape, so the kernel is persistent (one block an SM walking
//     the tiles; a 3-stage ring beside a staging buffer) and stores dW by TMA: the next
//     tile's loads and products overlap this tile's stores. One tile a block on the
//     core's 4-stage ring, with its staged epilogue, read 1.05x torch._grouped_mm at
//     the gate_up shape, this kernel 0.97-1.06x over four calls (NVIDIA H100 80GB
//     HBM3, 700 W; PERF.md).
//   - gmm and tgmm (mma.sync), for strides TMA cannot map: 128 x 128 tiles, 8 warps, a
//     three-stage cp.async ring (108 KB), ldmatrix and mma.sync m16n8k16. A gmm block
//     owns one 128-row tile, finds its first expert by binary search over `ends` and
//     runs one masked mainloop per expert that overlaps it; a tgmm block owns one
//     (128 x 128 tile of dw[e], e), K over the rows of expert e alone.
// What it leaves on the table: gmm's tiles pay their own prologue and epilogue with
// the tensor cores idle (gemm_sm90.cuh: a ping-pong of the consumer warpgroups would
// hide them), and gmm reads an expert's weight tile once per row tile from L2; tgmm's
// two consumer warpgroups still stage their tile in step, with the tensor cores idle,
// and every tile loads 48 KB of operands from L2 a K step (no cluster multicast of
// the x or dout boxes its neighbours share).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;           // output tile rows
constexpr int BN = 128;           // output tile columns
constexpr int BK = 64;            // K step
constexpr int STAGES = 3;         // depth of the cp.async ring
constexpr int NUM_THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int LDK = BK + 8;       // row stride of a tile stored K-contiguous ([row][k])
constexpr int LDR = 128 + 8;      // row stride of a tile stored row-contiguous ([k][col])
constexpr int STAGE_ELEMS = 128 * LDK;  // >= BK * LDR; one operand of one stage
constexpr int SMEM_BYTES = 2 * STAGES * STAGE_ELEMS * 2;  // A and B rings, dynamic

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
// shared memory at s[r * LDS + c]; elements with r0 + r outside [rlo, rlim) or
// c0 + c >= clim are zero. `vec`: rows are 16-byte aligned (ldg % 8 == 0, g aligned,
// c0 % 8 == 0), so 16-byte cp.async copies with a zero-filled tail; otherwise plain
// scalar loads.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t ldg, int r0, int c0,
                                          int rlo, int rlim, int clim, bool vec) {
  constexpr int CHUNKS = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const bool row_in = gr >= rlo && gr < rlim;
    bf16* dst = s + r * LDS + c;
    if (vec) {
      int n = row_in ? min(max(clim - gc, 0), 8) : 0;
      const bf16* src = n > 0 ? g + (size_t)gr * ldg + gc : g;
      cp_async16(dst, src, n * 2);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = (row_in && gc + j < clim) ? g[(size_t)gr * ldg + gc + j]
                                           : __float2bfloat16(0.f);
      }
    }
  }
}

// One GEMM operand. A is (M x K), B is (K x N). KMAJ: stored with K contiguous, i.e.
// A(m, k) = p[m * ld + k] and B(k, n) = p[n * ld + k]; otherwise A(m, k) = p[k * ld + m]
// and B(k, n) = p[k * ld + n]. M or N index valid in [lo, lim) (lo is honoured for a
// KMAJ operand only), K index valid below klim.
struct Operand {
  const bf16* p;
  size_t ld;
  int lo;
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
    load_tile<128, BK, LDK>(s, op.p, op.ld, rc0, k0, op.lo, op.lim, op.klim, op.vec);
  else
    load_tile<BK, 128, LDR>(s, op.p, op.ld, k0, rc0, 0, op.klim, op.lim, op.vec);
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

// acc[mi][ni][e] += A[m0 : m0+128, :K] @ B[:K, n0 : n0+128] for this warp's 64 x 32
// piece: rows wm*64 + mi*16 + g (+8 for e >= 2), columns wn*32 + ni*8 + t (+1 for odd e).
template <bool A_KMAJ, bool B_KMAJ>
__device__ void mainloop(float acc[4][4][4], bf16* smem, const Operand& A, const Operand& B,
                         int m0, int n0, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  bf16* sA = smem;                           // STAGES slots of A
  bf16* sB = smem + STAGES * STAGE_ELEMS;    // STAGES slots of B
  const int nk = (K + BK - 1) / BK;
  // K step i lives in slot i % STAGES. One commit group per loop turn (empty once K
  // runs out), so wait_group<STAGES-2> at turn i means step i has landed.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_operand<A_KMAJ>(sA + s * STAGE_ELEMS, A, m0, s * BK);
      load_operand<B_KMAJ>(sB + s * STAGE_ELEMS, B, n0, s * BK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt is visible; every warp is done with step kt - 1
    const int fetch = kt + STAGES - 1;
    if (fetch < nk) {
      const int slot = fetch % STAGES;  // the slot of step kt - 1
      load_operand<A_KMAJ>(sA + slot * STAGE_ELEMS, A, m0, fetch * BK);
      load_operand<B_KMAJ>(sB + slot * STAGE_ELEMS, B, n0, fetch * BK);
    }
    cp_async_commit();
    const bf16* a_s = sA + (kt % STAGES) * STAGE_ELEMS;
    const bf16* b_s = sB + (kt % STAGES) * STAGE_ELEMS;
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
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller's next mainloop
}

// out[row, col] = bf16(acc) for row < M, col < N (row-major, leading dimension N).
__device__ __forceinline__ void store_tile(float acc[4][4][4], bf16* __restrict__ out,
                                           int m0, int n0, int M, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const bool pairs = (N % 2) == 0;  // col is even, so (row, col) pairs are 4-byte aligned
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
      if (row >= M) continue;
      bf16* orow = out + (size_t)row * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t;
        const float x0 = acc[mi][ni][hf * 2], x1 = acc[mi][ni][hf * 2 + 1];
        if (pairs) {
          if (col < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < N) orow[col] = __float2bfloat16(x0);
          if (col + 1 < N) orow[col + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// First expert whose row range reaches past `row`: the smallest e with ends[e] > row
// (E when none). Every thread of the block computes the same value.
__device__ __forceinline__ int first_expert(const int* __restrict__ ends, int E, int row) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > row) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// grid (ceil(Nout / 128), ceil(N / 128)). Block (nt, mt) owns out[128 mt : +128,
// 128 nt : +128] and sums one masked product per expert overlapping its rows.
template <bool W_KMAJ>
__global__ void __launch_bounds__(NUM_THREADS)
gmm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const int* __restrict__ ends,
           bf16* __restrict__ out, int N, int K, int Nout, int E) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int row_end = min(m0 + BM, N);
  const size_t w_stride = (size_t)K * Nout;
  const size_t ld_w = W_KMAJ ? (size_t)K : (size_t)Nout;

  float acc[4][4][4];
  zero_acc(acc);
  for (int e = first_expert(ends, E, m0); e < E; ++e) {
    const int start = e > 0 ? ends[e - 1] : 0;
    if (start >= row_end) break;
    const int lo = max(start, m0), hi = min(ends[e], row_end);
    if (hi <= lo) continue;  // an empty expert
    const bf16* we = w + (size_t)e * w_stride;
    const Operand A{x, (size_t)K, lo, hi, K, aligned16(x, K)};
    const Operand B{we, ld_w, 0, Nout, K, aligned16(we, ld_w)};
    mainloop<true, W_KMAJ>(acc, smem, A, B, m0, n0, K);
  }
  store_tile(acc, out, m0, n0, N, Nout);
}

// grid (ceil(F / 128), ceil(D / 128), E). Block (ft, dt, e) owns dw[e][128 dt : +128,
// 128 ft : +128] = x[rows of e]^T @ dout[rows of e].
__global__ void __launch_bounds__(NUM_THREADS)
tgmm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
            const int* __restrict__ ends, bf16* __restrict__ dw, int N, int D, int F) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dyn_smem);
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int start = min(e > 0 ? ends[e - 1] : 0, N);
  const int rows = max(min(ends[e], N) - start, 0);
  const bf16* xe = x + (size_t)start * D;
  const bf16* ge = dout + (size_t)start * F;
  // A = x_e^T: A(d, r) = xe[r * D + d], stored row-contiguous along d; B = dout_e
  const Operand A{xe, (size_t)D, 0, D, rows, aligned16(xe, D)};
  const Operand B{ge, (size_t)F, 0, F, rows, aligned16(ge, F)};

  float acc[4][4][4];
  zero_acc(acc);
  mainloop<false, false>(acc, smem, A, B, m0, n0, rows);
  store_tile(acc, dw + (size_t)e * D * F, m0, n0, D, F);
}

// A wgmma-route tile: rows [lo, hi) of expert e (e == E: rows past ends[E-1]).
struct RowTile {
  int e, lo, hi;
};

// Tile t of the wgmma route, worked out from ends by every warp alike: expert e owns
// ceil(rows_e / 128) tiles from its first row on, in expert order, the last one cut at
// its end; the tiles after them cover the rows past ends[E-1] and then nothing
// (lo == hi). sum_e ceil(s_e / 128) <= ceil(S / 128) + E - 1 and the tail adds
// ceil((N - S) / 128), so ceil(N / 128) + E tiles cover every row. Each lane counts
// the tiles of its run of E / 32 experts, a warp scan places the runs, and the lane
// whose run holds t walks it.
__device__ __forceinline__ RowTile row_tile(const int* __restrict__ ends, int N, int E, int t) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31, per = (E + 31) / 32;
  const int e0 = min(lane * per, E), e1 = min(e0 + per, E);
  int count = 0;
  for (int e = e0; e < e1; ++e) {
    const int start = e > 0 ? min(ends[e - 1], N) : 0;
    count += (min(ends[e], N) - start + sm90::BM - 1) / sm90::BM;
  }
  int incl = count;  // inclusive scan of the runs' tile counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(ALL, incl, o);
    if (lane >= o) incl += v;
  }
  const unsigned owner = __ballot_sync(ALL, t >= incl - count && t < incl);
  if (owner == 0) {  // past every expert's tiles
    const int total = __shfl_sync(ALL, incl, 31);
    const int lo = min(min(ends[E - 1], N) + (t - total) * sm90::BM, N);
    return {E, lo, min(lo + sm90::BM, N)};
  }
  const int src = __ffs(owner) - 1;
  RowTile r{0, 0, 0};
  if (lane == src) {
    int base = incl - count;
    for (int e = e0; e < e1; ++e) {
      const int start = e > 0 ? min(ends[e - 1], N) : 0, end = min(ends[e], N);
      const int tiles = (end - start + sm90::BM - 1) / sm90::BM;
      if (t < base + tiles) {
        r = {e, start + (t - base) * sm90::BM, min(start + (t - base + 1) * sm90::BM, end)};
        break;
      }
      base += tiles;
    }
  }
  return {__shfl_sync(ALL, r.e, src), __shfl_sync(ALL, r.lo, src), __shfl_sync(ALL, r.hi, src)};
}

// wgmma route. grid (ceil(Nout / 256), ceil(N / 128) + E): block (nt, t) takes tile t
// (row_tile) and writes out[lo : hi, 256 nt : +256]; column tiles run fastest, so the
// blocks in flight share x's rows and the expert's weights in L2. Rows past ends[E-1]
// get no products: the epilogue stores zeros. An empty tile exits. W_KMAJ: w is read
// as its transpose (dX).
template <bool W_KMAJ>
__global__ void __launch_bounds__(sm90::THREADS, 1)
gmm_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const int* __restrict__ ends, bf16* __restrict__ out, int N, int K, int Nout,
                int E) {
  const RowTile rt = row_tile(ends, N, E, blockIdx.y);
  if (rt.hi <= rt.lo) return;
  const int n0 = blockIdx.x * sm90::BN;
  const sm90::Tile tile{rt.lo, n0, 0, rt.e, rt.e < E ? (K + sm90::BK - 1) / sm90::BK : 0};
  sm90::gemm_tile<false, !W_KMAJ>(&tx, &tw, tile, sm90::AllSteps{},
                                  sm90::StoreBf16{out, (size_t)Nout, rt.lo, rt.hi, n0, Nout});
}

// wgmma route of tgmm: dw[e] = x_e^T . dout_e in 128 x 256 tiles, (ft, dt, e) with
// column tiles fastest, so that the blocks in flight share expert e's rows of x and
// dout in L2. A = x_e^T and B = dout_e are both MN-major, read in place from the
// expert's first row (TMA coordinates are per element, so `start` needs no alignment);
// K runs over the expert's rows in steps of 64, and the last step's rows of the next
// expert (or past the groups) are zeroed in A's tile (sm90::zero_k_rows), as
// _tgmm_kernel masks x. An empty expert runs no K step and stores the zero tile.
// Persistent: one block an SM walks the tiles, with a 3-stage ring beside a 64 KB
// staging buffer, so the producer loads the next tile's K steps while the consumers
// stage this tile's bf16 dW in 128-byte-swizzled (64 x 64) boxes, which one thread a
// warpgroup stores by TMA (clipped at D and F) without waiting for the writes.
namespace tgmm_sm90 {
constexpr int STAGES = 3;
constexpr int OUT_OFF = STAGES * sm90::STAGE_BYTES;
constexpr int OUT_BYTES = sm90::BM * sm90::BN * 2;  // 8 boxes of 64 rows x 128 bytes
constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "shared memory of one block");

// Tile `tile` of the walk: its dw rows (m0), columns (n0), expert and K range.
struct Work {
  int e, m0, n0, start, rows, nk;
  __device__ Work(int tile, const int* ends, int N, int D, int F) {
    const int nft = (F + sm90::BN - 1) / sm90::BN, ndt = (D + sm90::BM - 1) / sm90::BM;
    e = tile / (nft * ndt);
    m0 = tile / nft % ndt * sm90::BM;
    n0 = tile % nft * sm90::BN;
    start = min(e > 0 ? ends[e - 1] : 0, N);
    rows = max(min(ends[e], N) - start, 0);
    nk = (rows + sm90::BK - 1) / sm90::BK;
  }
};
}  // namespace tgmm_sm90

__global__ void __launch_bounds__(sm90::THREADS, 1)
tgmm_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tw, const int* __restrict__ ends, int N,
                 int D, int F, int E) {
  namespace P = tgmm_sm90;
  constexpr int S = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the stage's bytes
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int tiles = (F + sm90::BN - 1) / sm90::BN * ((D + sm90::BM - 1) / sm90::BM) * E;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<sm90::PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    int cnt = 0;  // K steps loaded so far, over all of this block's tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const P::Work w(tile, ends, N, D, F);
      for (int k = 0; k < w.nk; ++k, ++cnt) {
        const int stage = cnt % S;
        mbar_wait(&empty[stage], ((cnt / S) & 1) ^ 1);  // the first pass finds it empty
        const int k0 = w.start + k * sm90::BK;
        sm90::load_stage<true, true>(smem + stage * sm90::STAGE_BYTES, &tx, &tg, &full[stage],
                                     w.m0, k0, w.n0, k0, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<sm90::CONSUMER_REGS>();
  const int cw = wg - 1;  // consumer warpgroup: tile rows cw*64 .. cw*64+63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tc = (lane % 4) * 2;
  unsigned char* out = smem + P::OUT_OFF + cw * 4 * sm90::BOX64_BYTES;  // this warpgroup's
  int it = 0;  // K steps consumed so far, over all of this block's tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const P::Work w(tile, ends, N, D, F);
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    for (int k = 0; k < w.nk; ++k, ++it) {
      const int stage = it % S;
      mbar_wait(&full[stage], (it / S) & 1);
      unsigned char* sa = smem + stage * sm90::STAGE_BYTES;
      const int valid = w.rows - k * sm90::BK;  // k rows of this step inside the expert
      if (valid < sm90::BK) sm90::zero_k_rows(sa + cw * sm90::BOX64_BYTES, valid, cw, t);
      sm90::stage_products<true, true>(acc, smem_u32(sa), cw);
      wgmma_wait<1>();  // the previous step's products are done: its stage is free
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (k > 0) sm90::release(&empty[(it - 1) % S], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (w.nk > 0) sm90::release(&empty[(it - 1) % S], lane);  // the tile's last stage

    // stage this warpgroup's 64 x 256 bf16 rows as four swizzled (64 x 64) boxes (16-byte
    // chunk c of row r at chunk c ^ (r % 8)); the previous tile's stores must have
    // read them first
    if (t == 0) bulk_wait_read();
    named_sync(2 + cw, 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)  // columns 128h + 8j + tc, tc + 1: box 2h + j / 8
          *reinterpret_cast<uint32_t*>(out + (2 * h + j / 8) * sm90::BOX64_BYTES +
                                       r * sm90::ROW_BYTES + (((j % 8) ^ (r % 8)) << 4) +
                                       tc * 2) =
              sm90::pack_bf16x2(acc[h][4 * j + 2 * i], acc[h][4 * j + 2 * i + 1]);
    }
    fence_proxy_async();
    named_sync(2 + cw, 128);
    if (t == 0) {
      for (int c = 0; c < sm90::BN / 64; ++c)
        tma_store_3d(&tw, out + c * sm90::BOX64_BYTES, w.n0 + 64 * c, w.m0 + 64 * cw, w.e);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t; the caller
// checks inputs beforehand (see the layout note at the top) and allocates the output.

// out (N, Nout) = ragged_dot(x (N, K), w, group_sizes) on the mma.sync route (any
// shape); w_kmajor: w is (E, Nout, K) and is read as its transpose (the dX of the
// backward), else (E, K, Nout).
extern "C" int gmm(const void* x, const void* w, const int* ends, void* out, int N, int K,
                   int Nout, int E, int w_kmajor, void* stream) {
  if (N < 1 || K < 1 || Nout < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const auto kernel = w_kmajor ? gmm_kernel<true> : gmm_kernel<false>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nout + BN - 1) / BN, (N + BM - 1) / BM);
  kernel<<<grid, NUM_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), ends, static_cast<bf16*>(out),
      N, K, Nout, E);
  return (int)cudaGetLastError();
}

// The same product on the wgmma route (K % 8 == 0, Nout % 8 == 0, x and w 16-byte
// aligned), with the same arguments.
extern "C" int gmm_wgmma(const void* x, const void* w, const int* ends, void* out, int N, int K,
                         int Nout, int E, int w_kmajor, void* stream) {
  if (N < 1 || K < 1 || Nout < 1 || E < 1 || K % 8 || Nout % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t err = sm90::operand_map(&tx, x, K, N, K, 1, (uint64_t)N * K,
                                      sm90::box_rows(true, false));
  if (err == cudaSuccess)
    err = w_kmajor ? sm90::operand_map(&tw, w, K, Nout, K, E, (uint64_t)Nout * K,
                                       sm90::box_rows(false, false))
                   : sm90::operand_map(&tw, w, Nout, K, Nout, E, (uint64_t)K * Nout,
                                       sm90::box_rows(false, true));
  const auto kernel = w_kmajor ? gmm_sm90_kernel<true> : gmm_sm90_kernel<false>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nout + sm90::BN - 1) / sm90::BN, (N + sm90::BM - 1) / sm90::BM + E);
  kernel<<<grid, sm90::THREADS, sm90::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, ends, static_cast<bf16*>(out), N, K, Nout, E);
  return (int)cudaGetLastError();
}

// dw (E, D, F): dw[e] = x[rows of e]^T @ dout[rows of e], zeros for an empty expert.
extern "C" int tgmm(const void* x, const void* dout, const int* ends, void* dw, int N, int D,
                    int F, int E, void* stream) {
  if (N < 1 || D < 1 || F < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(tgmm_kernel);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + BN - 1) / BN, (D + BM - 1) / BM, E);
  tgmm_kernel<<<grid, NUM_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dout), ends,
      static_cast<bf16*>(dw), N, D, F);
  return (int)cudaGetLastError();
}

// The same dW on the wgmma route (D % 8 == 0, F % 8 == 0, x and dout 16-byte aligned),
// with the same arguments: min(tiles, SMs) persistent blocks.
extern "C" int tgmm_wgmma(const void* x, const void* dout, const int* ends, void* dw, int N,
                          int D, int F, int E, void* stream) {
  if (N < 1 || D < 1 || F < 1 || E < 1 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  // x and dout MN-major ((64 d or f, 64 rows) boxes); dw (E, D, F) in (64 f, 64 d) boxes
  CUtensorMap tx, tg, tw;
  cudaError_t err = sm90::operand_map(&tx, x, D, N, D, 1, (uint64_t)N * D, 64);
  if (err == cudaSuccess) err = sm90::operand_map(&tg, dout, F, N, F, 1, (uint64_t)N * F, 64);
  if (err == cudaSuccess) err = sm90::operand_map(&tw, dw, F, D, F, E, (uint64_t)D * F, 64);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tgmm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tgmm_sm90::SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (F + sm90::BN - 1) / sm90::BN * ((D + sm90::BM - 1) / sm90::BM) * E;
  tgmm_sm90_kernel<<<min(tiles, sms), sm90::THREADS, tgmm_sm90::SMEM,
                     static_cast<cudaStream_t>(stream)>>>(tx, tg, tw, ends, N, D, F, E);
  return (int)cudaGetLastError();
}
