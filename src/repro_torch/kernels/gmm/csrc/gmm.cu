// Grouped matrix products for Hopper (sm_90a), in plain CUDA C++.
//
// Two kernels, f32 in and out:
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
// that imagination runs: B rows of work, not K x B.
//
// What bounds gmm_equal. At the model learner's shapes (G = 5, M = 256, K
// and N of 23 to 256) a product is 3 to 168 MFLOP over 0.1 to 4 MB: under
// 3 us of HBM bytes or of tensor-core work, so the kernel is bounded by how
// many SMs it keeps busy, by the serial chain of mma steps each warp runs
// and by the latency of a launch and of its first loads (4 to 11 us on the
// H100, torch.bmm's time). At the validation ring's M = 5,000 it is bounded
// by the issue rate of mma.sync: three TF32 passes of the 256-wide layer's
// 3.3 GFLOP ran at ~120 TFLOP/s of TF32 work, a quarter of the dense TF32
// rate that only wgmma reaches.
//
// gmm_equal's design, against each of those:
// * Tensor cores, f32-accurate (3xTF32). Each operand element x is split
//   into big = tf32(x) (cvt.rna) and small = tf32(x - big), and every
//   m16n8k8 TF32 mma step accumulates small*big + big*small + big*big in
//   f32, small terms first. The dropped small*small term and the rounding
//   of small leave ~2^-21 relative per product: f32-class, where one TF32
//   pass leaves ~2^-11. The sum stays in f32 accumulators.
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
// 32 distinct banks. gmm_equal's shared memory is static (under 48 KB) and
// its cluster size portable (<= 8), so a launch sets no attribute; an
// unsplit tile launches without a cluster.
//
// gmm_ragged keeps the first design of this file: f32 FMAs on the CUDA
// cores, one block per 64 x 64 output tile looping over the contraction in
// 32-wide tiles staged in shared memory (row stride 65), each of 256
// threads summing 4 x 4 outputs. It reads the (G + 1) group offsets itself,
// as the TPU kernel takes them by scalar prefetch. A block visits only the
// groups whose rows [start, end) overlap its 64 rows, and zeroes the other
// rows of the A tile, so an empty group costs nothing and a row is
// multiplied only by its own group's weights.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // contraction tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int SA = BM + 1;      // shared row strides: conflict-free
constexpr int SB = BN + 1;

// Stage the A tile (rows m0.., contraction k0..) of A stored (M, K) into
// As[k][m]. Rows outside [row_lo, row_hi) and contraction indices >= K
// read 0.
__device__ __forceinline__ void load_a(float (*As)[SA], const float* a, int K,
                                       int m0, int k0, int row_lo,
                                       int row_hi) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * BK / THREADS; ++i) {
    const int e = t + i * THREADS;
    // keep the memory-contiguous index fastest across the threads
    const int kk = e % BK, mm = e / BK;
    const int m = m0 + mm, k = k0 + kk;
    float v = 0.f;
    if (m >= row_lo && m < row_hi && k < K) v = a[(size_t)m * K + k];
    As[kk][mm] = v;
  }
}

// Stage the B tile (contraction k0.., columns n0..) of B stored (K, N) into
// Bs[k][n].
__device__ __forceinline__ void load_b(float (*Bs)[SB], const float* b, int N,
                                       int K, int n0, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BK * BN / THREADS; ++i) {
    const int e = t + i * THREADS;
    const int kk = e / BN, nn = e % BN;
    const int n = n0 + nn, k = k0 + kk;
    float v = 0.f;
    if (n < N && k < K) v = b[(size_t)k * N + n];
    Bs[kk][nn] = v;
  }
}

// acc += As x Bs for this thread's outputs (rows ty + 16 i, cols tx + 16 j).
__device__ __forceinline__ void fma_tile(const float (*As)[SA],
                                         const float (*Bs)[SB],
                                         float (&acc)[TM][TN], int ty,
                                         int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(float* c, const float (&acc)[TM][TN],
                                           int M, int N, int m0, int n0,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) c[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// grid (ceil(N / BN), ceil(M / BM)); offs: (G + 1) row offsets, offs[0] = 0
__global__ void __launch_bounds__(THREADS)
    gmm_ragged_kernel(const float* __restrict__ lhs,
                      const float* __restrict__ rhs,
                      const int* __restrict__ offs, float* __restrict__ out,
                      int G, int M, int N, int K) {
  __shared__ float As[BK][SA];
  __shared__ float Bs[BK][SB];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TN] = {};
  for (int g = 0; g < G; ++g) {
    const int start = offs[g], end = offs[g + 1];
    // uniform across the block: every thread reads the same offsets
    if (end <= m0 || start >= m0 + BM) continue;
    const float* bg = rhs + (size_t)g * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_a(As, lhs, K, m0, k0, start, end < M ? end : M);
      load_b(Bs, bg, N, K, n0, k0);
      __syncthreads();
      fma_tile(As, Bs, acc, ty, tx);
      __syncthreads();
    }
  }
  store_tile(out, acc, M, N, m0, n0, ty, tx);
}

unsigned ceil_div(int x, int d) { return (unsigned)((x + d - 1) / d); }

}  // namespace

// ------------------------------------------------------------ gmm_equal

namespace tc {

namespace cg = cooperative_groups;

constexpr int BK = 32;         // contraction tile
constexpr int THREADS = 128;   // 2 x 2 warps
constexpr int MAX_SPLIT = 4;   // contraction ranges per cluster

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

// x = big + small: big = tf32(x) rounded to nearest (ties away), small the
// tf32 of the exact f32 remainder
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
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

// Issue the copies of one tile: rows r0.. (< rmax) by contraction k0..
// (< K) of an operand whose element (r, k) lies at g[r * ld + k] (!KMAJOR)
// or g[k * ld + r] (KMAJOR). vec: ld, the group stride and g are multiples
// of 4 floats, so a 16-byte chunk is wholly inside or outside the edge.
template <int R, bool KMAJOR>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int r0, int rmax, int k0, int K,
                                          bool vec) {
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
      const bool ok = k < K && r < rmax;
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
      const bool ok = k < K && r < rmax;
      const float* src =
          ok ? g + (KMAJOR ? (size_t)k * ld + r : (size_t)r * ld + k) : g;
      cp_async<4>(s + L::at(kk, rr), src, ok);
    }
  }
}

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
  constexpr int WM = BM / 2, WN = BN / 2;   // warp sub-tile
  constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
  using LA = Tile<BM, TA>;
  using LB = Tile<BN, !TB>;
  static_assert(BM * BN <= 2 * (LA::SIZE + LB::SIZE), "reduction buffer");
  __shared__ __align__(16) float smem[2 * (LA::SIZE + LB::SIZE)];

  const int rank = blockIdx.x % split;
  const int tile = blockIdx.x / split;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int g = blockIdx.y;
  const float* ag = a + g * a_gs;
  const float* bg = b + g * b_gs;
  const int lda = TA ? M : K, ldb = TB ? K : N;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = rank * nk / split, kt1 = (rank + 1) * nk / split;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;

  auto stage_a = [&](int s) { return smem + s * LA::SIZE; };
  auto stage_b = [&](int s) { return smem + 2 * LA::SIZE + s * LB::SIZE; };
  auto load = [&](int s, int kt) {
    load_tile<BM, TA>(stage_a(s), ag, lda, m0, M, kt * BK, K, vec_a);
    load_tile<BN, !TB>(stage_b(s), bg, ldb, n0, N, kt * BK, K, vec_b);
    cp_async_commit();
  };

  float acc[MT][NT][4] = {};
  if (kt0 < kt1) load(0, kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load(s ^ 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* As = stage_a(s);
    const float* Bs = stage_b(s);
    const int k_left = K - kt * BK;  // past it the tile holds zeros
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

  if (split > 1) {
    // every thread holds the same fragment positions in every rank: rank 0
    // adds the others' partial sums, element by element, in rank order
    float* red = smem;
    int j = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(j++) * THREADS + tid] = acc[mt][nt][e];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r) {
        const float* part = cluster.map_shared_rank(red, r);
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
    if (rank != 0) return;
  }

  float* cg_out = c + (size_t)g * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + mt * 16 + gid + 8 * h;
        const int n = n0 + wn0 + nt * 8 + tig * 2;
        if (m >= M) continue;
        if (n < N) cg_out[(size_t)m * N + n] = acc[mt][nt][2 * h];
        if (n + 1 < N) cg_out[(size_t)m * N + n + 1] = acc[mt][nt][2 * h + 1];
      }
}

template <int BM, int BN, bool TA, bool TB>
cudaError_t launch(const float* a, const float* b, float* c, int G, int M,
                   int N, int K, long long a_gs, long long b_gs, int split,
                   int vec_a, int vec_b, cudaStream_t stream) {
  const int tiles_n = (N + BN - 1) / BN;
  const long long blocks = (long long)((M + BM - 1) / BM) * tiles_n * split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)G, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // an unsplit tile needs no cluster
  return cudaLaunchKernelEx(&cfg, gmm_equal_tc<BM, BN, TA, TB>, a, b, c, M,
                            N, K, a_gs, b_gs, tiles_n, split, vec_a, vec_b);
}

template <int BM, int BN>
cudaError_t launch_layout(int trans_a, int trans_b, const float* a,
                          const float* b, float* c, int G, int M, int N,
                          int K, long long a_gs, long long b_gs, int split,
                          int vec_a, int vec_b, cudaStream_t s) {
  if (!trans_a && !trans_b)
    return launch<BM, BN, false, false>(a, b, c, G, M, N, K, a_gs, b_gs,
                                        split, vec_a, vec_b, s);
  if (!trans_a && trans_b)
    return launch<BM, BN, false, true>(a, b, c, G, M, N, K, a_gs, b_gs,
                                       split, vec_a, vec_b, s);
  if (trans_a && !trans_b)
    return launch<BM, BN, true, false>(a, b, c, G, M, N, K, a_gs, b_gs,
                                       split, vec_a, vec_b, s);
  return launch<BM, BN, true, true>(a, b, c, G, M, N, K, a_gs, b_gs, split,
                                    vec_a, vec_b, s);
}

// 16-byte copies need the operand's base, its contiguous extent and its
// group stride to be multiples of 4 floats
bool vec_ok(const void* p, long long ld, long long gs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 &&
         gs % 4 == 0;
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
  if (G > 65535 || split < 1 || split > tc::MAX_SPLIT ||
      split > (nk > 1 ? nk : 1))
    return (int)cudaErrorInvalidValue;
  const int vec_a = tc::vec_ok(a, trans_a ? M : K, a_group_stride);
  const int vec_b = tc::vec_ok(b, trans_b ? K : N, b_group_stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bm == 64 && bn == 64)
    err = tc::launch_layout<64, 64>(trans_a, trans_b, a, b, c, G, M, N, K,
                                    a_group_stride, b_group_stride, split,
                                    vec_a, vec_b, s);
  else if (bm == 64 && bn == 32)
    err = tc::launch_layout<64, 32>(trans_a, trans_b, a, b, c, G, M, N, K,
                                    a_group_stride, b_group_stride, split,
                                    vec_a, vec_b, s);
  else if (bm == 32 && bn == 64)
    err = tc::launch_layout<32, 64>(trans_a, trans_b, a, b, c, G, M, N, K,
                                    a_group_stride, b_group_stride, split,
                                    vec_a, vec_b, s);
  else if (bm == 32 && bn == 32)
    err = tc::launch_layout<32, 32>(trans_a, trans_b, a, b, c, G, M, N, K,
                                    a_group_stride, b_group_stride, split,
                                    vec_a, vec_b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// out = ragged lhs x rhs over the groups of `offs` (device, G + 1 int32).
extern "C" int gmm_ragged(const float* lhs, const float* rhs, const int* offs,
                          float* out, int G, int M, int N, int K,
                          void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid(ceil_div(N, BN), ceil_div(M, BM));
  gmm_ragged_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lhs, rhs, offs, out, G, M, N, K);
  return (int)cudaGetLastError();
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
