// Grouped matrix products for Hopper (sm_90a), in plain CUDA C++.
//
// Three kernels, f32 in and out, all on the same 3xTF32 tensor-core tiles:
//
// gmm_equal replaces the TPU kernel src/repro/kernels/gmm/pallas.py::
// _equal_grouped_matmul (body `_kernel`): C[g] = A[g] x B[g] for every group
// g, A (G, M, K), B (G, K, N), C (G, M, N). It is the K-member dynamics
// ensemble's layer product (ensemble_mlp) and, with its operands read
// transposed, that product's backward: dX = dY x W^T and dW = X^T x dY.
//
// gmm_ragged replaces _ragged_grouped_matmul (body `_ragged_kernel`): lhs
// (M, K) with rows sorted by group, rhs (G, K, N), out (M, N), row m of group
// g times rhs[g]. It is the assigned-member forward (ensemble_mlp_select)
// that the assigned predictor runs: B rows of work, not K x B. With rhs
// read transposed in place it is also its own backward's dx = dy x W[g]^T.
//
// gmm_ragged_dw is that product's weight gradient, dW[g] = x[rows of g]^T x
// dy[rows of g], (G, K, N). The reference has no kernel for it: jax.grad
// differentiates the plain product there.
//
// What bounds gmm_equal. At the model learner's shapes (G = 5, M = 256, K
// and N of 23 to 256) a product is 3 to 168 MFLOP over 0.1 to 4 MB: under
// 3 us of HBM bytes or of tensor-core work, so the kernel is bounded by how
// many SMs it keeps busy, by the serial chain of mma steps each warp runs
// and by the latency of a launch and of its first loads (4 to 11 us on the
// H100, torch.bmm's time). At the validation ring's M = 5,000 it is bounded
// by the issue rate of mma.sync: three TF32 passes of the 256-wide layer's
// 3.3 GFLOP ran at ~140 TFLOP/s of TF32 work, under a third of the dense
// TF32 rate that only wgmma reaches.
//
// gmm_equal's design, against each of those:
// * Tensor cores, f32-accurate (3xTF32). Each operand element x is split
//   into big = tf32(x), rounded to nearest, and small = x - big, which the
//   mma reads truncated to TF32 (split_tf32), and every m16n8k8 TF32 mma
//   step accumulates small*big + big*small + big*big in f32, small terms
//   first. The dropped small*small term and the truncation of small leave
//   ~2^-21 relative per product: f32-class, where one TF32 pass leaves
//   ~2^-11. The sum stays in f32 accumulators.
// * Enough blocks. A block owns a bm x bn output tile (64 or 32 each) of
//   one group with 4 warps, each warp a (bm/2) x (bn/2) sub-tile of mma
//   fragments. When the tiles alone do not fill the 132 SMs (M = 256, or
//   N = 23), the contraction is split across a thread-block cluster of
//   `split` (1-4) blocks: each sums its own range of 32-wide contraction
//   tiles, then rank 0 adds the other ranks' partial tiles, read from
//   their shared memory (distributed shared memory), in rank order, and
//   stores the result. One launch, no atomics, no scratch in device
//   memory, and a result that does not depend on the schedule. The
//   planner in ../cuda.py picks (bm, bn, split) from (G, M, N, K).
// * Latency. Tiles come in by cp.async, two stages deep: the next
//   contraction tile loads while the current one is multiplied. Loads are
//   16 bytes where the contiguous dimension is a multiple of 4 (and
//   aligned), else 4 bytes, zero-filled past every edge (K = 30, N = 23,
//   M = 37), so any M, N, K works.
//
// Operand layouts. Each operand's 2-D slice is dense; a flag says whether
// it is stored as given (A: M x K, B: K x N) or transposed (A: K x M, B:
// N x K), and a group stride says where group g starts, in elements. So
// the backward reads W^T and X^T in place, and the first layer's input,
// broadcast to every member, is read with group stride 0 and never copied.
// A shared tile keeps the operand's own contiguous dimension contiguous,
// so 16-byte copies need no transpose: an operand stored contraction-major
// (A as K x M, B as K x N) is staged [32][r + 8] (r = bm or bn), the
// others [r][32 + 4]. Those strides (8 or 4 mod 32 words) put the 32
// lanes' reads of an mma fragment (lane -> row lane/4, column lane%4) on
// 32 distinct banks. The kernels' shared memory is static (under 48 KB) and
// their cluster size portable (<= 8), so a launch sets no attribute; an
// unsplit tile launches without a cluster.
//
// What bounds the ragged kernels. At the assigned predictor's widest
// layer, (5,000 x 256) x (5 x 256 x 256), each of the three products is
// 0.66 GFLOP over 6.4 MB: 1.9 us of HBM bytes against 4.0 us of tensor-core
// work for three TF32 passes at the dense TF32 rate. So they are bounded
// by operations, and on mma.sync by its issue rate, as gmm_equal is at the
// validation ring's M = 5,000. The thin layers (K = 30 or N = 23) do a
// tenth of that work and are bounded by filling the SMs and by latency.
//
// The ragged kernels' design, on gmm_equal's tiles, loads and layouts:
// * gmm_ragged. A block owns a bm x bn output tile and reads the (G + 1)
//   group offsets itself, where the TPU kernel takes them by scalar
//   prefetch: no host sync. It visits only the non-empty groups whose rows
//   [start, end) overlap its tile; for each it stages the A rows outside
//   [start, end) as zeros (cp.async with source size 0) and accumulates in
//   the same registers, and it stores once, so a row is multiplied only by
//   its own group's weights and no block writes rows it does not own. An
//   empty group costs nothing; a tile that straddles a boundary runs the
//   contraction once more per group it touches (at 5 groups and 79 row
//   tiles, at most 4 extra passes). At M = 5,000 the tiles alone give
//   157 to 632 blocks, so there is no split. The planner (../cuda.py
//   plan_ragged) picks (bm, bn) from the output's shape.
// * gmm_ragged_dw. A block owns a bm x bn tile of dW[g]. x is read
//   contraction-major in place (as gmm_equal reads X^T) and dy as given;
//   the contraction runs over the group's own rows [offs[g], offs[g+1]).
//   At (5, 256, 256) there are only 80 such 64 x 64 tiles, and 40 of
//   32 x 32 at K = 30 or N = 23, against 132 SMs, so a group's rows are
//   split across a cluster of `split` (1-8) blocks, each a contiguous run
//   of 32-row tiles, and rank 0 adds the partials in rank order from
//   distributed shared memory, as in gmm_equal: one launch, no atomics, a
//   result that repeats bit for bit. A rank with no rows, and every rank
//   of an empty group, joins the reduction with a zero partial, so an
//   empty group's dW is written as zeros. The planner (plan_ragged_dw)
//   picks (bm, bn, split) from (G, M, K, N), with M / G rows a group.
//
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

namespace cg = cooperative_groups;

constexpr int BK = 32;            // contraction tile
constexpr int THREADS = 128;      // 2 x 2 warps
constexpr int MAX_SPLIT = 4;      // gmm_equal: contraction ranges a cluster
constexpr int MAX_DW_SPLIT = 8;   // gmm_ragged_dw: the portable cluster size

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES (16 or 4) from global to shared, or write zeros if !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small: big = tf32(x) rounded to nearest, ties away (the bits
// of cvt.rna, by integer arithmetic: add half a TF32 ulp to the magnitude
// bits, clear the low 13), and small the exact f32 remainder, handed over
// as f32 bits of which the mma reads the TF32 part (truncated: under
// 2^-21 of x). Three full-rate instructions an element: two cvt.rna
// conversions cost more, and bounded the ragged kernels' mma steps.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a (16 x 8, row) x b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared tile of one operand: R rows of the output side (bm or bn) by BK
// contraction columns. KMAJOR: stored [BK][R + 8] (the operand's memory is
// contiguous along R); else [R][BK + 4] (contiguous along the contraction).
template <int R, bool KMAJOR>
struct Tile {
  static constexpr int STRIDE = KMAJOR ? R + 8 : BK + 4;
  static constexpr int SIZE = KMAJOR ? BK * STRIDE : R * STRIDE;
  __device__ static __forceinline__ int at(int k, int r) {
    return KMAJOR ? k * STRIDE + r : r * STRIDE + k;
  }
};

// A block's accumulators: each of the 4 warps holds a (BM/2) x (BN/2)
// sub-tile as (BM/32) x (BN/16) m16n8 fragments of 4 floats.
template <int BM, int BN>
using Acc = float[BM / 32][BN / 16][4];

// Issue the copies of one tile: rows r0.. inside [rlo, rhi) by contraction
// k0.. (< khi) of an operand whose element (r, k) lies at g[r * ld + k]
// (!KMAJOR) or g[k * ld + r] (KMAJOR); everything else reads 0. vec: ld
// and g are multiples of 4 floats and the contiguous dimension ends at ld,
// so a 16-byte chunk is wholly inside or outside the edge.
template <int R, bool KMAJOR>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int r0, int rlo, int rhi, int k0,
                                          int khi, bool vec) {
  using L = Tile<R, KMAJOR>;
  const int t = threadIdx.x;
  constexpr int CONTIG = KMAJOR ? R : BK;  // contiguous extent of the tile
  if (vec) {
    constexpr int CH = CONTIG / 4;
#pragma unroll
    for (int i = 0; i < R * BK / 4 / THREADS; ++i) {
      const int c = t + i * THREADS;
      const int outer = c / CH, inner = (c % CH) * 4;
      const int kk = KMAJOR ? outer : inner, rr = KMAJOR ? inner : outer;
      const int k = k0 + kk, r = r0 + rr;
      const bool ok = k < khi && r >= rlo && r < rhi;
      const float* src =
          ok ? g + (KMAJOR ? (size_t)k * ld + r : (size_t)r * ld + k) : g;
      cp_async<16>(s + L::at(kk, rr), src, ok);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < R * BK / THREADS; ++i) {
      const int e = t + i * THREADS;
      const int outer = e / CONTIG, inner = e % CONTIG;
      const int kk = KMAJOR ? outer : inner, rr = KMAJOR ? inner : outer;
      const int k = k0 + kk, r = r0 + rr;
      const bool ok = k < khi && r >= rlo && r < rhi;
      const float* src =
          ok ? g + (KMAJOR ? (size_t)k * ld + r : (size_t)r * ld + k) : g;
      cp_async<4>(s + L::at(kk, rr), src, ok);
    }
  }
}

// acc += op(A)[rows m0.. inside [row_lo, row_hi), contraction [k_lo,
// k_hi)] x op(B)[that contraction, columns n0.. < N], in 3xTF32 mma steps
// over BK-wide contraction tiles that come in by cp.async two stages deep.
// TA: A's element (m, k) at ag[k * lda + m], else ag[m * lda + k]; TB: B's
// (k, n) at bg[n * ldb + k], else bg[k * ldb + n]. smem holds the two
// stages; it is free again when this returns.
template <int BM, int BN, bool TA, bool TB>
__device__ __forceinline__ void mma_range(Acc<BM, BN>& acc, float* smem,
                                          const float* ag, int lda, int m0,
                                          int row_lo, int row_hi,
                                          const float* bg, int ldb, int n0,
                                          int N, int k_lo, int k_hi,
                                          bool vec_a, bool vec_b) {
  constexpr int WM = BM / 2, WN = BN / 2;   // warp sub-tile
  constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
  using LA = Tile<BM, TA>;
  using LB = Tile<BN, !TB>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
  const int nk = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  auto stage_a = [&](int s) { return smem + s * LA::SIZE; };
  auto stage_b = [&](int s) { return smem + 2 * LA::SIZE + s * LB::SIZE; };
  auto load = [&](int s, int t) {
    const int k0 = k_lo + t * BK;
    load_tile<BM, TA>(stage_a(s), ag, lda, m0, row_lo, row_hi, k0, k_hi,
                      vec_a);
    load_tile<BN, !TB>(stage_b(s), bg, ldb, n0, 0, N, k0, k_hi, vec_b);
    cp_async_commit();
  };

  if (nk > 0) load(0, 0);
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    if (t + 1 < nk) {
      load(s ^ 1, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* As = stage_a(s);
    const float* Bs = stage_b(s);
    const int k_left = k_hi - (k_lo + t * BK);  // past it the tile holds 0
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      if (kk >= k_left) break;
      unsigned ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm0 + mt * 16 + gid;
        split_tf32(As[LA::at(kk + tig, r)], ab[mt][0], as[mt][0]);
        split_tf32(As[LA::at(kk + tig, r + 8)], ab[mt][1], as[mt][1]);
        split_tf32(As[LA::at(kk + tig + 4, r)], ab[mt][2], as[mt][2]);
        split_tf32(As[LA::at(kk + tig + 4, r + 8)], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn0 + nt * 8 + gid;
        split_tf32(Bs[LB::at(kk + tig, n)], bb[nt][0], bs[nt][0]);
        split_tf32(Bs[LB::at(kk + tig + 4, n)], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(acc[mt][nt], as[mt], bb[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
        }
    }
    __syncthreads();
  }
}

// The cluster's sum of its ranks' partial tiles: every thread holds the
// same fragment positions in every rank, so rank 0 adds the others' sums,
// read from their shared memory, element by element, in rank order. Every
// rank must call it (it holds two cluster barriers). Returns whether this
// block holds the sum and stores it.
template <int BM, int BN>
__device__ __forceinline__ bool cluster_sum(Acc<BM, BN>& acc, float* smem,
                                            int rank, int split) {
  constexpr int MT = BM / 32, NT = BN / 16;
  const int tid = threadIdx.x;
  int j = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) smem[(j++) * THREADS + tid] = acc[mt][nt][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0) {
    for (int r = 1; r < split; ++r) {
      const float* part = cluster.map_shared_rank(smem, r);
      j = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] += part[(j++) * THREADS + tid];
    }
  }
  cluster.sync();  // the other ranks' shared memory lives until read
  return rank == 0;
}

// Store the block's tile at rows m0.. (< M) and columns n0.. (< N) of a
// row-major matrix with ld columns.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(const Acc<BM, BN>& acc, float* c,
                                           int ld, int m0, int M, int n0,
                                           int N) {
  constexpr int WM = BM / 2, WN = BN / 2;
  constexpr int MT = WM / 16, NT = WN / 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + mt * 16 + gid + 8 * h;
        const int n = n0 + wn0 + nt * 8 + tig * 2;
        if (m >= M) continue;
        if (n < N) c[(size_t)m * ld + n] = acc[mt][nt][2 * h];
        if (n + 1 < N) c[(size_t)m * ld + n + 1] = acc[mt][nt][2 * h + 1];
      }
}

// Both operands' two stages, also the cluster's reduction buffer.
template <int BM, int BN, bool TA, bool TB>
struct Smem {
  static constexpr int FLOATS =
      2 * (Tile<BM, TA>::SIZE + Tile<BN, !TB>::SIZE);
  static_assert(BM * BN <= FLOATS, "reduction buffer");
};

// grid (split * tiles, G), cluster (split, 1, 1). Block x is rank
// x % split of the cluster that owns output tile x / split (row-major over
// ceil(M / BM) x tiles_n); it sums contraction tiles
// [rank * nk / split, (rank + 1) * nk / split), nk = ceil(K / BK).
// TA: A stored (K, M); TB: B stored (N, K).
template <int BM, int BN, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS)
    gmm_equal_tc(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int M, int N, int K, long long a_gs,
                 long long b_gs, int tiles_n, int split, int vec_a,
                 int vec_b) {
  __shared__ __align__(16) float smem[Smem<BM, BN, TA, TB>::FLOATS];
  const int rank = blockIdx.x % split;
  const int tile = blockIdx.x / split;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int g = blockIdx.y;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = rank * nk / split, kt1 = (rank + 1) * nk / split;
  Acc<BM, BN> acc = {};
  mma_range<BM, BN, TA, TB>(acc, smem, a + g * a_gs, TA ? M : K, m0, 0, M,
                            b + g * b_gs, TB ? K : N, n0, N, kt0 * BK,
                            min(kt1 * BK, K), vec_a, vec_b);
  if (split > 1 && !cluster_sum<BM, BN>(acc, smem, rank, split)) return;
  store_tile<BM, BN>(acc, c + (size_t)g * M * N, N, m0, M, n0, N);
}

// grid (ceil(M / BM) * tiles_n); block x owns output tile x (row-major).
// offs: (G + 1) row offsets, sorted. TB: rhs stored (N, K) a group.
template <int BM, int BN, bool TB>
__global__ void __launch_bounds__(THREADS)
    gmm_ragged_tc(const float* __restrict__ lhs,
                  const float* __restrict__ rhs, const int* __restrict__ offs,
                  float* __restrict__ out, int G, int M, int N, int K,
                  long long b_gs, int tiles_n, int vec_a, int vec_b) {
  __shared__ __align__(16) float smem[Smem<BM, BN, false, TB>::FLOATS];
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  Acc<BM, BN> acc = {};
  for (int g = 0; g < G; ++g) {
    // uniform across the block: every thread reads the same offsets
    const int start = max(__ldg(offs + g), 0);
    const int end = min(__ldg(offs + g + 1), M);
    if (start >= m0 + BM) break;           // this and every later group
    if (end <= max(start, m0)) continue;   // empty, or ends before the tile
    mma_range<BM, BN, false, TB>(acc, smem, lhs, K, m0, start, end,
                                 rhs + g * b_gs, TB ? K : N, n0, N, 0, K,
                                 vec_a, vec_b);
  }
  store_tile<BM, BN>(acc, out, N, m0, M, n0, N);
}

// grid (split * tiles, G), cluster (split, 1, 1). Block x is rank
// x % split of the cluster that owns tile x / split of dW[g] (row-major
// over ceil(K / BM) x tiles_n); of group g's nt = ceil(rows / BK) row
// tiles it sums [rank * nt / split, (rank + 1) * nt / split).
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
    gmm_ragged_dw_tc(const float* __restrict__ x, const float* __restrict__ dy,
                     const int* __restrict__ offs, float* __restrict__ dw,
                     int M, int K, int N, int tiles_n, int split, int vec_a,
                     int vec_b) {
  __shared__ __align__(16) float smem[Smem<BM, BN, true, false>::FLOATS];
  const int rank = blockIdx.x % split;
  const int tile = blockIdx.x / split;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int g = blockIdx.y;
  const int start = max(__ldg(offs + g), 0);
  const int end = min(__ldg(offs + g + 1), M);
  const int nt = end > start ? (end - start + BK - 1) / BK : 0;
  const int t0 = rank * nt / split, t1 = (rank + 1) * nt / split;
  Acc<BM, BN> acc = {};
  mma_range<BM, BN, true, false>(acc, smem, x, K, m0, 0, K, dy, N, n0, N,
                                 start + t0 * BK, min(start + t1 * BK, end),
                                 vec_a, vec_b);
  if (split > 1 && !cluster_sum<BM, BN>(acc, smem, rank, split)) return;
  store_tile<BM, BN>(acc, dw + (size_t)g * K * N, N, m0, K, n0, N);
}

// Launch `kernel` on a (gx, gy) grid of THREADS-thread blocks, in clusters
// of `cluster` blocks along x when cluster > 1.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), long long gx, unsigned gy,
                   int cluster, cudaStream_t stream, A... args) {
  if (gx <= 0 || gx > 0x7fffffffLL || gy > 65535)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, gy, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // an unsplit tile needs no cluster
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

int tiles(int n, int t) { return (n + t - 1) / t; }

template <int BM, int BN>
struct EqualLaunch {
  static cudaError_t run(int trans_a, int trans_b, const float* a,
                         const float* b, float* c, int G, int M, int N, int K,
                         long long a_gs, long long b_gs, int split, int vec_a,
                         int vec_b, cudaStream_t s) {
    const int tn = tiles(N, BN);
    const long long gx = (long long)tiles(M, BM) * tn * split;
    auto go = [&](auto kernel) {
      return launch(kernel, gx, G, split, s, a, b, c, M, N, K, a_gs, b_gs,
                    tn, split, vec_a, vec_b);
    };
    if (!trans_a && !trans_b) return go(gmm_equal_tc<BM, BN, false, false>);
    if (!trans_a && trans_b) return go(gmm_equal_tc<BM, BN, false, true>);
    if (trans_a && !trans_b) return go(gmm_equal_tc<BM, BN, true, false>);
    return go(gmm_equal_tc<BM, BN, true, true>);
  }
};

template <int BM, int BN>
struct RaggedLaunch {
  static cudaError_t run(int trans_b, const float* lhs, const float* rhs,
                         const int* offs, float* out, int G, int M, int N,
                         int K, long long b_gs, int vec_a, int vec_b,
                         cudaStream_t s) {
    const int tn = tiles(N, BN);
    const long long gx = (long long)tiles(M, BM) * tn;
    auto go = [&](auto kernel) {
      return launch(kernel, gx, 1, 1, s, lhs, rhs, offs, out, G, M, N, K,
                    b_gs, tn, vec_a, vec_b);
    };
    return trans_b ? go(gmm_ragged_tc<BM, BN, true>)
                   : go(gmm_ragged_tc<BM, BN, false>);
  }
};

template <int BM, int BN>
struct RaggedDwLaunch {
  static cudaError_t run(const float* x, const float* dy, const int* offs,
                         float* dw, int G, int M, int K, int N, int split,
                         int vec_a, int vec_b, cudaStream_t s) {
    const int tn = tiles(N, BN);
    const long long gx = (long long)tiles(K, BM) * tn * split;
    return launch(gmm_ragged_dw_tc<BM, BN>, gx, G, split, s, x, dy, offs, dw,
                  M, K, N, tn, split, vec_a, vec_b);
  }
};

// The output tiles the source instantiates: 64 x 64, 64 x 32, 32 x 64,
// 32 x 32; any other is cudaErrorInvalidValue.
template <template <int, int> class L, typename... A>
cudaError_t by_tile(int bm, int bn, A... args) {
  if (bm == 64 && bn == 64) return L<64, 64>::run(args...);
  if (bm == 64 && bn == 32) return L<64, 32>::run(args...);
  if (bm == 32 && bn == 64) return L<32, 64>::run(args...);
  if (bm == 32 && bn == 32) return L<32, 32>::run(args...);
  return cudaErrorInvalidValue;
}

// 16-byte copies need the operand's base, its contiguous extent and its
// group stride to be multiples of 4 floats
bool vec_ok(const void* p, long long ld, long long gs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 &&
         gs % 4 == 0;
}

int result(cudaError_t err) {
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace tc

// C[g] = op(A)[g] x op(B)[g] on (bm x bn) output tiles with the contraction
// split over clusters of `split` blocks, as the planner in ../cuda.py picks
// them. a_group_stride / b_group_stride in elements (0 broadcasts one
// operand to every group). Returns a cudaError_t; cudaErrorInvalidValue for
// a tile the source does not instantiate, a split outside 1..4 or larger
// than the number of contraction tiles, or a grid it cannot launch.
extern "C" int gmm_equal(const float* a, const float* b, float* c, int G,
                         int M, int N, int K, int trans_a, int trans_b,
                         long long a_group_stride, long long b_group_stride,
                         int bm, int bn, int split, void* stream) {
  if (G == 0 || M == 0 || N == 0) return 0;
  const int nk = (K + tc::BK - 1) / tc::BK;
  if (split < 1 || split > tc::MAX_SPLIT || split > (nk > 1 ? nk : 1))
    return (int)cudaErrorInvalidValue;
  return tc::result(tc::by_tile<tc::EqualLaunch>(
      bm, bn, trans_a, trans_b, a, b, c, G, M, N, K, a_group_stride,
      b_group_stride, split,
      (int)tc::vec_ok(a, trans_a ? M : K, a_group_stride),
      (int)tc::vec_ok(b, trans_b ? K : N, b_group_stride),
      static_cast<cudaStream_t>(stream)));
}

// out (M, N) = ragged lhs (M, K) x rhs over the groups of `offs` (device,
// G + 1 int32, sorted): row m of group g times rhs[g], which is stored
// (K, N) or, with trans_b, (N, K), group g at rhs + g * rhs_group_stride.
// Rows no group covers get 0. On (bm x bn) output tiles, as plan_ragged
// picks them; cudaErrorInvalidValue for a tile the source does not
// instantiate or a grid it cannot launch.
extern "C" int gmm_ragged(const float* lhs, const float* rhs, const int* offs,
                          float* out, int G, int M, int N, int K, int trans_b,
                          long long rhs_group_stride, int bm, int bn,
                          void* stream) {
  if (M == 0 || N == 0) return 0;
  return tc::result(tc::by_tile<tc::RaggedLaunch>(
      bm, bn, trans_b, lhs, rhs, offs, out, G, M, N, K, rhs_group_stride,
      (int)tc::vec_ok(lhs, K, 0),
      (int)tc::vec_ok(rhs, trans_b ? K : N, rhs_group_stride),
      static_cast<cudaStream_t>(stream)));
}

// dw (G, K, N): dw[g] = x[rows of g]^T x dy[rows of g], x (M, K) and dy
// (M, N) row-major, the rows of g [offs[g], offs[g + 1]) (device, G + 1
// int32); an empty group gets zeros. On (bm x bn) tiles of dw[g], each
// group's rows split over clusters of `split` blocks, as plan_ragged_dw
// picks them; cudaErrorInvalidValue for a tile the source does not
// instantiate, a split outside 1..8 or a grid it cannot launch.
extern "C" int gmm_ragged_dw(const float* x, const float* dy, const int* offs,
                             float* dw, int G, int M, int K, int N, int bm,
                             int bn, int split, void* stream) {
  if (G == 0 || K == 0 || N == 0) return 0;
  if (split < 1 || split > tc::MAX_DW_SPLIT) return (int)cudaErrorInvalidValue;
  return tc::result(tc::by_tile<tc::RaggedDwLaunch>(
      bm, bn, x, dy, offs, dw, G, M, K, N, split, (int)tc::vec_ok(x, K, 0),
      (int)tc::vec_ok(dy, N, 0), static_cast<cudaStream_t>(stream)));
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
