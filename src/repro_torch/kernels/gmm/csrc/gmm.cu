// Grouped matrix products for Hopper (sm_90a), in plain CUDA C++.
//
// Three kernels, f32 in and out, all on the same 3xTF32 tensor-core tiles,
// and two bf16 routes of the ragged one (gmm_ragged_bf16 and, on TMA and
// wgmma, gmm_ragged_bf16_wgmma, at the end):
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
// gmm_ragged_bf16 is gmm_ragged on bf16 lhs, rhs and out: the route the
// dropless MoE (models/moe.py) runs, three launches a layer, (T*k, d) x
// (E, d, f) twice and (T*k, f) x (E, f, d) once. The TPU kernel is dtype-
// generic: it casts both tiles to f32, dots them into an f32 accumulator
// and rounds the output to lhs.dtype. A bf16 x bf16 product is exact in
// f32, so one mma.sync.m16n8k16 bf16 pass with f32 accumulators computes
// the same thing, the sums in another order; the store rounds to bf16
// (to nearest even). No split of the operands is needed. It keeps
// gmm_ragged's design, block for tile and group loop, on bf16 tiles with a
// 64-wide contraction (four k16 steps a stage, two stages by cp.async;
// 16-byte copies of 8 values where the contiguous extent is a multiple of
// 8 and aligned, else plain loads with zeros past the edges) and the same
// output tiles, as plan_ragged picks them. A shared tile keeps the
// operand's contiguous dimension contiguous, its rows padded by 8 values
// (16 bytes): a fragment's pairs along the contraction are one 32-bit
// load where the contraction is contiguous, two 16-bit loads where it is
// not (rhs stored (K, N)). What bounds it: at the MoE's prefill
// (Moonlight, 3,072 rows over 64 experts) the expert weights' bytes, 0.37
// GB a product against 18 GFLOP; at decode (48 rows) the same bytes of the
// experts the rows use, read by few blocks, each walking its groups one
// after another: latency, not the card's rate. It is forward only, and
// since the wgmma route below it runs only the shapes a tensor map cannot
// address (a row stride that is not a multiple of 16 bytes, as K = 130 or
// N = 70, an unaligned base, K = 0, no group), as plan_ragged_bf16 names
// them before the launch.
//
// gmm_ragged_bf16_wgmma is the bf16 route redesigned for Hopper, what the
// MoE runs. The mma.sync route lost to its bounds on three counts: a block
// owned a fixed output tile and walked, one after another, every group
// whose rows overlap it, re-reading each such expert's whole weight slab
// with the other groups' rows masked to zero (at Moonlight's prefill, ~48
// rows an expert, each expert's weights read about twice and half the MMA
// work masked away; at its decode, 48 rows over ~34 experts, each of 88
// blocks walked ~25 experts with two 4 KB stages in flight: latency);
// and mma.sync from four warps tops out near 134 TFLOP/s (Mixtral's
// prefill). The redesign, against each:
// * A schedule read on the device. A unit is (group g, column tile, row
//   tile t of g's own rows), its rows offs[g] + t * bm.. : every output row
//   belongs to one unit and no unit multiplies another group's rows into
//   its sums (rows of the box past g's end are multiplied by rhs[g] and not
//   stored; row m of the output depends only on row m of lhs). Every block
//   reads the offsets, counts each group's row tiles and takes its unit by
//   a prefix sum in shared memory (G <= 1,024), so one launch sized by the
//   bound (ceil(M / bm) + G + 1) x tiles_n serves any group sizes, a CUDA
//   graph replays it after the sizes change, and a block past the last
//   unit exits. An empty group gives no unit; the rows past offs[G] (and
//   before offs[0]) are units of their own that store zeros. Units are
//   numbered group by group, column tile by column tile, row tile by row
//   tile, so the blocks in flight share an expert's weight slab in L2.
// * TMA into a ring, wgmma out of it. One producer thread issues
//   cp.async.bulk.tensor copies of the lhs box (bm x 64) and expert g's
//   rhs slab (64 x bn) into a ring of 4 stages in dynamic shared memory,
//   128-byte swizzled, completing on an mbarrier a stage; one or two
//   consumer warpgroups (64 rows each) run wgmma.mma_async m64nNk16, bf16
//   in and f32 sums, four a stage, keep one stage's products in flight and
//   free the stage before it through a second mbarrier. rhs stored (K, N)
//   is read N-major in 64-column boxes, its transposed view K-major in one
//   box; past every edge TMA fills zeros. The epilogue rounds to nearest
//   even and stores only the unit's own rows (a TMA store of the whole box
//   would overwrite the next group's rows).
// * Tiles by shape (plan_ragged_bf16 in ../cuda.py): 64 x 128 units where
//   the groups are small (decode and Moonlight's prefill: bytes-bound, so
//   many units and two blocks an SM keep HBM busy), 128 x 256 units on two
//   warpgroups where they are large (Mixtral's ~512-row groups: bounded by
//   the tensor cores). The tensor maps are encoded on the host at each call
//   through cuTensorMapEncodeTiled, looked up through the CUDA runtime
//   so the library needs no -lcuda, and passed as __grid_constant__.
//
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
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

// ------------------------------------------------------------ bf16 route

typedef unsigned short bf16_t;    // a bf16 value's bits
constexpr int BK16 = 64;          // bf16 contraction tile: four k16 steps

// Shared tile of one bf16 operand: R rows of the output side by BK16
// contraction columns. KMAJOR: stored [BK16][R + 8]; else [R][BK16 + 8].
// Rows of 144 or 80 bytes keep every 16-byte copy aligned.
template <int R, bool KMAJOR>
struct Tile16 {
  static constexpr int STRIDE = KMAJOR ? R + 8 : BK16 + 8;
  static constexpr int SIZE = KMAJOR ? BK16 * STRIDE : R * STRIDE;
  __device__ static __forceinline__ int at(int k, int r) {
    return KMAJOR ? k * STRIDE + r : r * STRIDE + k;
  }
};

// load_tile's bf16 form: 16-byte copies of 8 values (vec: ld and g are
// multiples of 8 values, and the contiguous dimension ends at ld), else
// plain loads; everything outside the rows [rlo, rhi) and the contraction
// < khi reads 0.
template <int R, bool KMAJOR>
__device__ __forceinline__ void load_tile16(bf16_t* s, const bf16_t* g,
                                            int ld, int r0, int rlo,
                                            int rhi, int k0, int khi,
                                            bool vec) {
  using L = Tile16<R, KMAJOR>;
  const int t = threadIdx.x;
  constexpr int CONTIG = KMAJOR ? R : BK16;
  if (vec) {
    constexpr int CH = CONTIG / 8;
#pragma unroll
    for (int i = 0; i < R * BK16 / 8 / THREADS; ++i) {
      const int c = t + i * THREADS;
      const int outer = c / CH, inner = (c % CH) * 8;
      const int kk = KMAJOR ? outer : inner, rr = KMAJOR ? inner : outer;
      const int k = k0 + kk, r = r0 + rr;
      const bool ok = k < khi && r >= rlo && r < rhi;
      const bf16_t* src =
          ok ? g + (KMAJOR ? (size_t)k * ld + r : (size_t)r * ld + k) : g;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(s + L::at(kk, rr))),
                   "l"(src), "r"(ok ? 16 : 0));
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < R * BK16 / THREADS; ++i) {
      const int e = t + i * THREADS;
      const int outer = e / CONTIG, inner = e % CONTIG;
      const int kk = KMAJOR ? outer : inner, rr = KMAJOR ? inner : outer;
      const int k = k0 + kk, r = r0 + rr;
      const bool ok = k < khi && r >= rlo && r < rhi;
      s[L::at(kk, rr)] =
          ok ? g[KMAJOR ? (size_t)k * ld + r : (size_t)r * ld + k]
             : (bf16_t)0;
    }
  }
}

// The two values at contraction k and k + 1 of row r, k even, as one mma
// register (k in the low half)
template <int R, bool KMAJOR>
__device__ __forceinline__ unsigned pair16(const bf16_t* s, int k, int r) {
  using L = Tile16<R, KMAJOR>;
  if (KMAJOR)
    return (unsigned)s[L::at(k, r)] | ((unsigned)s[L::at(k + 1, r)] << 16);
  return *reinterpret_cast<const unsigned*>(s + L::at(k, r));
}

// c += a (16 x 16, row) x b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A[rows m0.. inside [row_lo, row_hi), contraction [0, K)] x
// op(B)[that contraction, columns n0.. < N] in bf16 mma steps over
// BK16-wide tiles that come in two stages deep. A (M, K) row-major; TB: B's
// (k, n) at bg[n * ldb + k], else bg[k * ldb + n].
template <int BM, int BN, bool TB>
__device__ __forceinline__ void mma_range16(Acc<BM, BN>& acc, bf16_t* smem,
                                            const bf16_t* ag, int m0,
                                            int row_lo, int row_hi,
                                            const bf16_t* bg, int ldb,
                                            int n0, int N, int K, bool vec_a,
                                            bool vec_b) {
  constexpr int WM = BM / 2, WN = BN / 2;
  constexpr int MT = WM / 16, NT = WN / 8;
  using LA = Tile16<BM, false>;
  using LB = Tile16<BN, !TB>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
  const int nk = (K + BK16 - 1) / BK16;

  auto stage_a = [&](int s) { return smem + s * LA::SIZE; };
  auto stage_b = [&](int s) { return smem + 2 * LA::SIZE + s * LB::SIZE; };
  auto load = [&](int s, int t) {
    const int k0 = t * BK16;
    load_tile16<BM, false>(stage_a(s), ag, K, m0, row_lo, row_hi, k0, K,
                           vec_a);
    load_tile16<BN, !TB>(stage_b(s), bg, ldb, n0, 0, N, k0, K, vec_b);
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
    const bf16_t* As = stage_a(s);
    const bf16_t* Bs = stage_b(s);
    const int k_left = K - t * BK16;  // past it the tile holds 0
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      if (kk >= k_left) break;
      const int k = kk + tig * 2;
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm0 + mt * 16 + gid;
        a[mt][0] = pair16<BM, false>(As, k, r);
        a[mt][1] = pair16<BM, false>(As, k, r + 8);
        a[mt][2] = pair16<BM, false>(As, k + 8, r);
        a[mt][3] = pair16<BM, false>(As, k + 8, r + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn0 + nt * 8 + gid;
        b[nt][0] = pair16<BN, !TB>(Bs, k, n);
        b[nt][1] = pair16<BN, !TB>(Bs, k + 8, n);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
}

// store_tile's bf16 form: each f32 sum rounded to nearest even
template <int BM, int BN>
__device__ __forceinline__ void store_tile16(const Acc<BM, BN>& acc,
                                             bf16_t* c, int ld, int m0,
                                             int M, int n0, int N) {
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
        if (n < N)
          c[(size_t)m * ld + n] =
              __bfloat16_as_ushort(__float2bfloat16_rn(acc[mt][nt][2 * h]));
        if (n + 1 < N)
          c[(size_t)m * ld + n + 1] = __bfloat16_as_ushort(
              __float2bfloat16_rn(acc[mt][nt][2 * h + 1]));
      }
}

template <int BM, int BN, bool TB>
struct Smem16 {
  static constexpr int ELEMS =
      2 * (Tile16<BM, false>::SIZE + Tile16<BN, !TB>::SIZE);
};

// gmm_ragged_tc on bf16: grid (ceil(M / BM) * tiles_n); block x owns
// output tile x (row-major) and visits the groups that overlap its rows.
template <int BM, int BN, bool TB>
__global__ void __launch_bounds__(THREADS)
    gmm_ragged_bf16_tc(const bf16_t* __restrict__ lhs,
                       const bf16_t* __restrict__ rhs,
                       const int* __restrict__ offs,
                       bf16_t* __restrict__ out, int G, int M, int N, int K,
                       long long b_gs, int tiles_n, int vec_a, int vec_b) {
  __shared__ __align__(16) bf16_t smem[Smem16<BM, BN, TB>::ELEMS];
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  Acc<BM, BN> acc = {};
  for (int g = 0; g < G; ++g) {
    const int start = max(__ldg(offs + g), 0);
    const int end = min(__ldg(offs + g + 1), M);
    if (start >= m0 + BM) break;
    if (end <= max(start, m0)) continue;
    mma_range16<BM, BN, TB>(acc, smem, lhs, m0, start, end, rhs + g * b_gs,
                            TB ? K : N, n0, N, K, vec_a, vec_b);
  }
  store_tile16<BM, BN>(acc, out, N, m0, M, n0, N);
}

template <int BM, int BN>
struct RaggedBf16Launch {
  static cudaError_t run(int trans_b, const bf16_t* lhs, const bf16_t* rhs,
                         const int* offs, bf16_t* out, int G, int M, int N,
                         int K, long long b_gs, int vec_a, int vec_b,
                         cudaStream_t s) {
    const int tn = tiles(N, BN);
    const long long gx = (long long)tiles(M, BM) * tn;
    auto go = [&](auto kernel) {
      return launch(kernel, gx, 1, 1, s, lhs, rhs, offs, out, G, M, N, K,
                    b_gs, tn, vec_a, vec_b);
    };
    return trans_b ? go(gmm_ragged_bf16_tc<BM, BN, true>)
                   : go(gmm_ragged_bf16_tc<BM, BN, false>);
  }
};

// 16-byte copies of bf16 need the base, the contiguous extent and the
// group stride to be multiples of 8 values
bool vec16_ok(const void* p, long long ld, long long gs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 &&
         gs % 8 == 0;
}


// ------------------------------------------- bf16 route on TMA and wgmma

constexpr int TMA_BK = 64;             // contraction tile: one 128-byte row
constexpr int MAX_TMA_GROUPS = 1024;   // the block's boundary table

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A wait
// that outlasts 2^26 polls (seconds; a stage takes microseconds) traps, so
// a broken pipeline faults the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// One TMA copy of a box of `map` at coordinates (c0, c1[, c2]), innermost
// first, into shared memory; its bytes complete on `bar`. Out-of-bounds
// elements arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's descriptor of a 128-byte-swizzled operand tile at shared address
// a: lbo and sbo are the byte strides between its 8 x 128-byte core groups
// along the two dimensions, as the layouts in the header give them.
__device__ __forceinline__ uint64_t sw128_desc(unsigned a, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products that own them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) += A (64 x 16, K-major) x B (16 x N), bf16 in; TRANS = 0:
// B K-major, TRANS = 1: B N-major. Thread t of the warpgroup holds, for each
// 8-column block i, d[4i..4i+1] at row 16 (t / 32) + (t % 32) / 4, columns
// 8i + 2 (t % 4) and the next, and d[4i+2..4i+3] eight rows further down.
template <int TRANS>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS));
}

template <int TRANS>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS));
}

template <int BN, int TRANS>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16<TRANS>(d, da, db);
  else
    wgmma_m64n256k16<TRANS>(d, da, db);
}

// A (BM x BN) unit's launch constants: BM / 64 consumer warpgroups and one
// producer warp; a stage holds the lhs box (BM x 64) and the rhs slab
// (64 x BN), 128 bytes a row; the ring, its two barriers a stage and the
// slack to align it to 1024 bytes are dynamic shared memory.
template <int BM, int BN, int STAGES>
struct TmaTile {
  static constexpr int WGS = BM / 64;
  static constexpr int THREADS = 128 * WGS + 32;
  static constexpr int A_BYTES = BM * TMA_BK * 2;
  static constexpr int B_BYTES = BN * TMA_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static constexpr int MIN_BLOCKS = SMEM <= 108 * 1024 ? 2 : 1;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 128 || BN == 256, "wgmma widths");
};

__device__ __forceinline__ int row_tiles(int rows, int bm) {
  return rows > 0 ? (rows + bm - 1) / bm : 0;
}

// grid: (ceil(M / BM) + G + 1) * tiles_n blocks, the bound on the units.
// The rows fall into G + 2 ranges: [0, offs[0]), group g's [offs[g],
// offs[g + 1]) and [offs[G], M), each offset clamped to [0, M]; the first
// and last are the rows no group covers. Range r has ceil(len / BM) row
// tiles, starting at its first row, and a unit is (range, column tile,
// row tile); the units are numbered range by range, column tile by column
// tile, row tile by row tile, and block b takes unit b. Every block reads
// the offsets and finds its unit by a prefix sum, so nothing is read on
// the host. A block past the last unit exits; a unit of an uncovered range
// stores zeros. TB: rhs stored (N, K) a group (read K-major), else (K, N).
template <int BM, int BN, int STAGES, bool TB>
__global__ void __launch_bounds__(TmaTile<BM, BN, STAGES>::THREADS,
                                  TmaTile<BM, BN, STAGES>::MIN_BLOCKS)
    gmm_ragged_bf16_wgmma_tc(const __grid_constant__ CUtensorMap lhs_map,
                             const __grid_constant__ CUtensorMap rhs_map,
                             const int* __restrict__ offs,
                             bf16_t* __restrict__ out, int G, int M, int N,
                             int K, int tiles_n) {
  using T = TmaTile<BM, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int bounds[MAX_TMA_GROUPS + 3];
  __shared__ int warp_sum[T::THREADS / 32];
  __shared__ int unit[3];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // the schedule: this block's unit, from the offsets
  const int R = G + 2;
  for (int j = tid; j <= R; j += T::THREADS)
    bounds[j] = j == 0 ? 0 : j == R ? M : min(max(__ldg(offs + j - 1), 0), M);
  if (tid == 0) unit[0] = -1;
  __syncthreads();
  const int per = (R + T::THREADS - 1) / T::THREADS;
  const int r_lo = min(tid * per, R), r_hi = min(r_lo + per, R);
  int mine = 0;
  for (int r = r_lo; r < r_hi; ++r)
    mine += row_tiles(bounds[r + 1] - bounds[r], BM) * tiles_n;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_sum[w];
  const int u = blockIdx.x;
  if (u >= incl - mine && u < incl) {
    int first = incl - mine;
    for (int r = r_lo; r < r_hi; ++r) {
      const int rows = row_tiles(bounds[r + 1] - bounds[r], BM);
      if (u < first + rows * tiles_n) {
        unit[0] = r;
        unit[1] = (u - first) / rows;
        unit[2] = (u - first) % rows;
        break;
      }
      first += rows * tiles_n;
    }
  }
  __syncthreads();
  const int r = unit[0];
  if (r < 0) return;  // past the last unit
  const int n0 = unit[1] * BN;
  const int m0 = bounds[r] + unit[2] * BM;
  const int m_end = min(bounds[r + 1], m0 + BM);
  const int g = r - 1;
  const int nk = (r == 0 || r == R - 1) ? 0 : (K + TMA_BK - 1) / TMA_BK;

  // the ring, aligned to 1024 bytes as the 128-byte swizzle repeats
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023) & ~1023u;
  unsigned char* tiles_s = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles_s + STAGES *
                                               T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * T::WGS);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * T::WGS) {
    // the producer: one thread keeps the ring's loads in flight
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + s, (kt / STAGES - 1) & 1);
        mbar_expect_tx(full + s, T::STAGE_BYTES);
        unsigned char* a = tiles_s + s * T::A_BYTES;
        unsigned char* b = tiles_s + STAGES * T::A_BYTES + s * T::B_BYTES;
        tma_load(a, &lhs_map, full + s, kt * TMA_BK, m0);
        if (TB) {
          tma_load(b, &rhs_map, full + s, kt * TMA_BK, n0, g);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b + j * 64 * TMA_BK * 2, &rhs_map, full + s,
                     n0 + 64 * j, kt * TMA_BK, g);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of the unit
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + s, (kt / STAGES) & 1);
    const unsigned a = base + s * T::A_BYTES + wg * 64 * 128;
    const unsigned b = base + STAGES * T::A_BYTES + s * T::B_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TMA_BK / 16; ++kk) {
      // K-major: 16 values are 32 bytes along the swizzled row; N-major:
      // 16 contraction rows of 128 bytes, the 64-column boxes 8 KB apart
      const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
      const uint64_t db = TB ? sw128_desc(b + kk * 32, 16, 1024)
                             : sw128_desc(b + kk * 16 * 128,
                                          64 * TMA_BK * 2, 1024);
      wgmma_tile<BN, TB ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % STAGES);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the epilogue: round to nearest even, store the unit's own rows only
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= m_end) continue;
      bf16_t* o = out + (size_t)m * N + n;
      const float lo = acc[4 * i + 2 * h], hi = acc[4 * i + 2 * h + 1];
      if (pairs && n + 1 < N) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        *reinterpret_cast<unsigned*>(o) =
            *reinterpret_cast<const unsigned*>(&v);
      } else {
        if (n < N) o[0] = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
        if (n + 1 < N) o[1] = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return reinterpret_cast<EncodeTiled>(
        e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr);
  }();
  return fn;
}

// A tensor map of bf16 values at `base`: extents innermost first, byte
// strides of the outer dimensions, a box of `box` values, 128-byte swizzle,
// zeros out of bounds.
bool bf16_map(CUtensorMap* map, const void* base, cuuint32_t rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit_strides[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, int STAGES, bool TB>
cudaError_t launch_wgmma(const CUtensorMap& a, const CUtensorMap& b,
                         const int* offs, bf16_t* out, int G, int M, int N,
                         int K, int tiles_n, unsigned blocks,
                         cudaStream_t s) {
  using T = TmaTile<BM, BN, STAGES>;
  // once a process, before its first launch (also outside a graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_ragged_bf16_wgmma_tc<BM, BN, STAGES, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return attr;
  gmm_ragged_bf16_wgmma_tc<BM, BN, STAGES, TB>
      <<<blocks, T::THREADS, T::SMEM, s>>>(a, b, offs, out, G, M, N, K,
                                           tiles_n);
  return cudaGetLastError();
}

template <int BM, int BN, int STAGES>
struct WgmmaLaunch {
  static cudaError_t run(int trans_b, const bf16_t* lhs, const bf16_t* rhs,
                         const int* offs, bf16_t* out, int G, int M, int N,
                         int K, long long b_gs, cudaStream_t s) {
    const int tn = tiles(N, BN);
    const long long blocks = ((long long)tiles(M, BM) + G + 1) * tn;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    CUtensorMap a_map, b_map;
    const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t a_box[2] = {TMA_BK, BM};
    if (!bf16_map(&a_map, lhs, 2, a_dims, a_strides, a_box))
      return cudaErrorInvalidValue;
    // one group's stride is never read; any multiple of 16 bytes will do
    const cuuint64_t gs = 2 * (cuuint64_t)(G > 1 ? b_gs : (long long)K * N);
    if (trans_b) {
      const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N,
                                  (cuuint64_t)G};
      const cuuint64_t strides[2] = {(cuuint64_t)K * 2, gs};
      const cuuint32_t box[3] = {TMA_BK, BN, 1};
      if (!bf16_map(&b_map, rhs, 3, dims, strides, box))
        return cudaErrorInvalidValue;
      return launch_wgmma<BM, BN, STAGES, true>(
          a_map, b_map, offs, out, G, M, N, K, tn, (unsigned)blocks, s);
    }
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
    const cuuint64_t strides[2] = {(cuuint64_t)N * 2, gs};
    const cuuint32_t box[3] = {64, TMA_BK, 1};
    if (!bf16_map(&b_map, rhs, 3, dims, strides, box))
      return cudaErrorInvalidValue;
    return launch_wgmma<BM, BN, STAGES, false>(
        a_map, b_map, offs, out, G, M, N, K, tn, (unsigned)blocks, s);
  }
};

// The (bm, bn, stages) the TMA route instantiates, as cuda.py's BF16_TILES
// lists them; any other is cudaErrorInvalidValue.
template <typename... A>
cudaError_t by_wgmma_tile(int bm, int bn, int stages, A... args) {
  if (bm == 64 && bn == 128 && stages == 4)
    return WgmmaLaunch<64, 128, 4>::run(args...);
  if (bm == 128 && bn == 256 && stages == 4)
    return WgmmaLaunch<128, 256, 4>::run(args...);
  return cudaErrorInvalidValue;
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

// gmm_ragged on bf16 (each value's 16 bits): out (M, N) = ragged lhs (M, K)
// x rhs over the groups of `offs`, as gmm_ragged, with f32 sums rounded to
// bf16 on the store. Rows no group covers get 0.
extern "C" int gmm_ragged_bf16(const unsigned short* lhs,
                               const unsigned short* rhs, const int* offs,
                               unsigned short* out, int G, int M, int N,
                               int K, int trans_b, long long rhs_group_stride,
                               int bm, int bn, void* stream) {
  if (M == 0 || N == 0) return 0;
  return tc::result(tc::by_tile<tc::RaggedBf16Launch>(
      bm, bn, trans_b, lhs, rhs, offs, out, G, M, N, K, rhs_group_stride,
      (int)tc::vec16_ok(lhs, K, 0),
      (int)tc::vec16_ok(rhs, trans_b ? K : N, rhs_group_stride),
      static_cast<cudaStream_t>(stream)));
}

// gmm_ragged_bf16 on the TMA and wgmma route: the same product, on (bm x
// bn) units of one group's own rows fed by `stages` TMA stages, as
// plan_ragged_bf16 picks them. Takes what a tensor map can address: G in
// 1..1024, K > 0 and a multiple of 8, N a multiple of 8 where rhs is stored
// (K, N), lhs and rhs 16-byte aligned, the group stride a multiple of 8
// values; else, or for a tile it does not instantiate, cudaErrorInvalidValue.
extern "C" int gmm_ragged_bf16_wgmma(const unsigned short* lhs,
                                     const unsigned short* rhs,
                                     const int* offs, unsigned short* out,
                                     int G, int M, int N, int K, int trans_b,
                                     long long rhs_group_stride, int bm,
                                     int bn, int stages, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (G < 1 || G > tc::MAX_TMA_GROUPS || K <= 0 || K % 8 != 0 ||
      (!trans_b && N % 8 != 0) ||
      (reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs)) %
              16 != 0 ||
      (G > 1 && rhs_group_stride % 8 != 0))
    return (int)cudaErrorInvalidValue;
  return tc::result(tc::by_wgmma_tile(
      bm, bn, stages, trans_b, lhs, rhs, offs, out, G, M, N, K,
      rhs_group_stride, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
