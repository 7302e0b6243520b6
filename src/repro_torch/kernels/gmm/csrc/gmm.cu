// Grouped matrix products for Hopper (sm_90a), in plain CUDA C++.
//
// Two kernels, f32 in and out, f32 FMAs on the CUDA cores (no TF32):
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
// Design. The TPU kernels walk the contraction as a sequential grid axis
// and carry the sum in VMEM scratch; the ragged one also walks the groups
// as a grid axis. GPU blocks run in no order, so here one block owns one
// 64 x 64 output tile (of one group, for gmm_equal) and loops over the
// contraction itself in 32-wide tiles staged in shared memory, with the
// 4 x 4 sums of each of its 256 threads in registers. The TPU kernel pads
// operands to block multiples and slices the result; here loads past an
// edge read 0 and stores past it are dropped, so any M, N, K works (the
// ensemble has K = 30 and N = 23).
//
// Operand layouts. Each operand's 2-D slice is dense; a flag says whether
// it is stored as given (A: M x K, B: K x N) or transposed (A: K x M, B:
// N x K), and a group stride says where group g starts, in elements. So
// the backward reads W^T and X^T in place, and the first layer's input,
// broadcast to every member, is read with group stride 0 and never copied.
// The shared tiles are stored contraction-major with a row stride of 65
// floats, so both the loads (whichever dimension is contiguous in memory)
// and the reads of the inner loop hit distinct banks or one broadcast word.
//
// The ragged kernel reads the (G + 1) group offsets itself, as the TPU
// kernel takes them by scalar prefetch. A block visits only the groups
// whose rows [start, end) overlap its 64 rows, and zeroes the other rows
// of the A tile, so an empty group costs nothing and a row is multiplied
// only by its own group's weights.
//
// What bounds it. At the ensemble's shapes (G = 5, M = 256 or 5,000, K and
// N of 23 to 256) a product is 0.1 to 1.3 GFLOP over 1 to 5 MB: a few
// microseconds of f32 FMAs at the card's 67 TFLOP/s, less of HBM bytes,
// so each launch costs about a launch. Tensor-core tiles (TF32 or
// bf16 mma/wgmma) and a bias + tanh epilogue are the later steps.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // contraction tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int SA = BM + 1;      // shared row strides: conflict-free
constexpr int SB = BN + 1;

// Stage the logical A tile (rows m0.., contraction k0..) into As[k][m].
// Rows outside [row_lo, row_hi) and contraction indices >= K read 0.
// trans_a = 0: A is stored (M, K), element (m, k) at a[m * K + k];
// trans_a = 1: stored (K, M), element at a[k * M + m].
__device__ __forceinline__ void load_a(float (*As)[SA], const float* a,
                                       int trans_a, int M, int K, int m0,
                                       int k0, int row_lo, int row_hi) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * BK / THREADS; ++i) {
    const int e = t + i * THREADS;
    // keep the memory-contiguous index fastest across the threads
    const int kk = trans_a ? e / BM : e % BK;
    const int mm = trans_a ? e % BM : e / BK;
    const int m = m0 + mm, k = k0 + kk;
    float v = 0.f;
    if (m >= row_lo && m < row_hi && k < K)
      v = trans_a ? a[(size_t)k * M + m] : a[(size_t)m * K + k];
    As[kk][mm] = v;
  }
}

// Stage the logical B tile (contraction k0.., columns n0..) into Bs[k][n].
// trans_b = 0: B is stored (K, N); trans_b = 1: stored (N, K).
__device__ __forceinline__ void load_b(float (*Bs)[SB], const float* b,
                                       int trans_b, int N, int K, int n0,
                                       int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BK * BN / THREADS; ++i) {
    const int e = t + i * THREADS;
    const int kk = trans_b ? e % BK : e / BN;
    const int nn = trans_b ? e / BK : e % BN;
    const int n = n0 + nn, k = k0 + kk;
    float v = 0.f;
    if (n < N && k < K)
      v = trans_b ? b[(size_t)n * K + k] : b[(size_t)k * N + n];
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

// grid (ceil(N / BN), ceil(M / BM), G)
__global__ void __launch_bounds__(THREADS)
    gmm_equal_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int M, int N, int K, int trans_a,
                     int trans_b, long long a_gs, long long b_gs) {
  __shared__ float As[BK][SA];
  __shared__ float Bs[BK][SB];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* ag = a + g * a_gs;
  const float* bg = b + g * b_gs;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a(As, ag, trans_a, M, K, m0, k0, 0, M);
    load_b(Bs, bg, trans_b, N, K, n0, k0);
    __syncthreads();
    fma_tile(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  store_tile(c + (size_t)g * M * N, acc, M, N, m0, n0, ty, tx);
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
      load_a(As, lhs, 0, M, K, m0, k0, start, end < M ? end : M);
      load_b(Bs, bg, 0, N, K, n0, k0);
      __syncthreads();
      fma_tile(As, Bs, acc, ty, tx);
      __syncthreads();
    }
  }
  store_tile(out, acc, M, N, m0, n0, ty, tx);
}

unsigned ceil_div(int x, int d) { return (unsigned)((x + d - 1) / d); }

}  // namespace

// C[g] = op(A)[g] x op(B)[g]. a_group_stride / b_group_stride in elements
// (0 broadcasts one operand to every group). Returns a cudaError_t.
extern "C" int gmm_equal(const float* a, const float* b, float* c, int G,
                         int M, int N, int K, int trans_a, int trans_b,
                         long long a_group_stride, long long b_group_stride,
                         void* stream) {
  if (G == 0 || M == 0 || N == 0) return 0;
  dim3 grid(ceil_div(N, BN), ceil_div(M, BM), (unsigned)G);
  gmm_equal_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, N, K, trans_a, trans_b, a_group_stride, b_group_stride);
  return (int)cudaGetLastError();
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
