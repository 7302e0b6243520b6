// Flash attention forward for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/pallas.py::
// flash_attention (body `_kernel`). It computes the same function:
// online-softmax attention with f32 running max m, sum l and accumulator
// acc; q (B, Sq, Hq, D) attends k/v (B, Sk, Hkv, D) with GQA (q head h reads
// kv head h / G), causal masking aligned at the ends (query i sits at
// absolute position i + Sk - Sq), an optional sliding window, and padded kv
// masked out. Masked scores are -1e30 exactly as in the TPU kernel, so
// m/l/acc follow the same recurrence and a row divides by max(l, 1e-30).
// Kv tiles that the causal mask or the window hide from every row of a q
// tile are skipped: a row that sees at least one key gets exactly the result
// of visiting them, because a masked score contributes exp(-1e30 - m) = 0
// once m is real. Under causal masking the wrapper refuses Sq > Sk, the only
// shapes that leave a row with no key at all; without it (cross-attention)
// Sq > Sk runs, the offset Sk - Sq then read by no mask and no tile bound.
//
// The TPU kernel walks kv blocks as the sequential "arbitrary" grid axis and
// carries m/l/acc in VMEM scratch between grid steps. Blocks on the GPU run
// in no order, so here one thread block owns one (batch, q head, 64-row q
// tile) and loops over the kv tiles itself, keeping m/l/acc in registers.
//
// What bounds it. At D = 128 attention does about 4 * D = 512 flops per kv
// element loaded, and a q tile reuses each kv tile 64 times, so the work is
// tensor-core work: at S = 4,096 (causal) 137 GFLOP, 0.14 ms at the card's
// 989 TFLOP/s of dense bf16. This kernel reaches ~230 TFLOP/s there,
// causal or not: mma.sync issued by 8 warps an SM (234 registers a thread
// allow two blocks), with the softmax between the two products on the
// same warps. Halving the shared-memory reads of K and V per product (two
// m16 tiles a warp) gained 2%, so those reads do not bound it; wgmma fed
// by TMA, with warps specialised, is the way past it. At the serving
// buckets (S = 16 to 64) a launch of 32 blocks does a few MFLOP and is
// bounded by its latency.
//
// bf16 inputs (the LM's type) run on the tensor cores, as FlashAttention-2
// lays the work out (namespace tc):
// * 4 warps, each owning 16 rows of the 64-row q tile. The Q fragments are
//   loaded once with ldmatrix and stay in registers for the whole loop.
// * Kv tiles of 64 rows, double-buffered: cp.async brings the next K and V
//   tile into shared memory while the current one is multiplied. Rows past
//   Sk are zero-filled. Shared rows are padded to D + 8 elements, so the 8
//   row addresses of each ldmatrix hit distinct banks; V is read with
//   ldmatrix.trans, which gives the P V product its B fragments directly.
// * Both products are mma.sync.m16n8k16 (bf16 in, f32 accumulate). The
//   scores stay in f32 accumulators; each row's max and sum are reduced
//   over the 4 lanes of its quad by shuffles; exponentials are base 2 with
//   log2(e) folded into the scale. P is rounded to bf16 in registers and
//   fed straight into P V as its A fragment; O stays in f32 registers and
//   is rescaled by alpha. Rounding P to bf16 is the one arithmetic
//   difference from the reference, which multiplies f32 P by V widened to
//   f32; the sum l is taken over the f32 P, as there.
// * Only kv tiles that cross an edge of the mask (Sk, the diagonal, the
//   window) test each score. The last q tiles of every head, which visit
//   the most kv tiles under causal masking, are scheduled first.
// * The dynamic shared-memory limit (85 KB at D = 128) is raised once per
//   kernel and device, not on every launch.
//
// Head dims. Both routes are compiled for D = 32, 64 and 128. A head dim d
// that is a multiple of 8 below 128 runs in the next instance up: its rows
// are read with the row stride of d, the columns d..D-1 of the Q, K and V
// tiles are filled with zeros (they add 0 to every score, and give output
// columns that are never stored), so the result is the one at d exactly;
// only the scale, d^-1/2, comes from the caller. Each instance is built
// twice: exact (d == D, the row strides and the tail tests compile to
// constants) and padded. The world model's heads
// (d = 32; 24 in its examples) take this path; the Pallas kernel takes any
// d, since its block is (block, d).
//
// f32 inputs keep the first design of this file (the port's LM never runs
// attention in f32): f32 FMAs on the CUDA cores, 32-row kv tiles loaded
// synchronously, thread t owning q rows 4*(t/8) .. 4*(t/8)+3 for both
// products (scores at kv columns t%8 + 8j, outputs at head dims t%8 + 8c),
// padded row strides that keep every shared access free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 32;
constexpr int THREADS = 128;            // 16 row groups x 8 column lanes
constexpr int ROWS = 4;                 // q rows per thread
constexpr int KCOLS = BLOCK_K / 8;      // score columns per thread
constexpr int PSTRIDE = BLOCK_K + 2;    // P row stride: conflict-free
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) +
                          BLOCK_K * D + BLOCK_Q * PSTRIDE);
}

template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_fwd_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o,
                               int Sq, int Sk, int Hq, int Hkv, int d_pad,
                               float scale, int causal, int window) {
  constexpr int QS = D + 1;       // Q and K row stride: conflict-free
  constexpr int DC = D / 8;       // output columns per thread
  const int d = PAD ? d_pad : D;  // the head dim; a constant when exact
  extern __shared__ float smem[];
  float* Qs = smem;                  // BLOCK_Q x QS
  float* Ks = Qs + BLOCK_Q * QS;     // BLOCK_K x QS
  float* Vs = Ks + BLOCK_K * QS;     // BLOCK_K x D
  float* Ps = Vs + BLOCK_K * D;      // BLOCK_Q x PSTRIDE

  const int tid = threadIdx.x;
  const int rg = tid >> 3;           // row group
  const int cl = tid & 7;            // column lane
  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = Sk - Sq;

  const size_t q_row = (size_t)Hq * d;
  const size_t k_row = (size_t)Hkv * d;
  const float* qb = q + (size_t)b * Sq * q_row + (size_t)h * d;
  const float* kb = k + (size_t)b * Sk * k_row + (size_t)hk * d;
  const float* vb = v + (size_t)b * Sk * k_row + (size_t)hk * d;
  float* ob = o + (size_t)b * Sq * q_row + (size_t)h * d;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * QS + c] = s < Sq && c < d ? qb[(size_t)s * q_row + c] : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // kv range that some real row of this q tile can see
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BLOCK_Q, Sq) - 1 + offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin -= k_begin % BLOCK_K;

  for (int kt = k_begin; kt < k_end; kt += BLOCK_K) {
    __syncthreads();  // Qs written / last tile's Ks, Vs, Ps all read
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D, c = i % D, s = kt + r;
      const bool ok = s < Sk && c < d;
      Ks[r * QS + c] = ok ? kb[(size_t)s * k_row + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(size_t)s * k_row + c] : 0.f;
    }
    __syncthreads();

    float sc[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qs[(rg * ROWS + i) * QS + e];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = Ks[(cl + 8 * j) * QS + e];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j)
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = rg * ROWS + i;
      const int q_pos = q0 + r + offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int k_pos = kt + cl + 8 * j;
        bool ok = k_pos < Sk;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && k_pos > q_pos - window;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[r * PSTRIDE + cl + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(rg * ROWS + i) * PSTRIDE + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * D + cl + 8 * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int s = q0 + rg * ROWS + i;
    if (s >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (cl + 8 * c < d) ob[(size_t)s * q_row + cl + 8 * c] = acc[i][c] / den;
  }
}

// Raises a kernel's dynamic shared-memory limit once per device, not on
// every launch: each launcher instantiation keeps one SmemOnce.
struct SmemOnce {
  std::mutex mu;
  unsigned long long done = 0;  // one bit per device
};

template <typename Kernel>
cudaError_t allow_smem(SmemOnce& once, Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(once.mu);
  if (once.done >> dev & 1ULL) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) once.done |= 1ULL << dev;
  return err;
}

template <int D, bool PAD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int Hq, int Hkv, int d,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<D, PAD>;
  const size_t smem = smem_bytes<D>();
  static SmemOnce once;
  cudaError_t err = allow_smem(once, kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv,
      d, scale, causal, window);
  return cudaGetLastError();
}

// ------------------------------------------- bf16: tensor-core tiles

namespace tc {

constexpr int BQ = 64;        // q rows per block, 16 per warp
constexpr int BKV = 64;       // kv rows per tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {  // Q, then two stages of K and of V
  return sizeof(__nv_bfloat16) * 5 * BQ * (D + 8);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or zeros if !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane t receives row t/4, columns 2(t%4), 2(t%4)+1 of each
// (of the transpose with .trans)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) x b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU; flushes subnormal results to 0, which the f32 sums
// they feed cannot tell from 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows r0.. (zeros past rmax) of a (rows, d) bf16 slab with row
// stride `stride` elements into a BQ x (D + 8) shared tile; columns d..D-1
// (the head-dim tail of a padded instance) are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int r0, int rmax,
                                          int d) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < BQ * CH / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < rmax && col < d;
    cp_async16(dst + r * (D + 8) + col,
               ok ? src + (size_t)(r0 + r) * stride + col : src, ok);
  }
}

// grid (Hq, B, ceil(Sq / BQ)), the q tile slowest and last tiles first, so
// that the tiles that visit the most kv tiles under causal masking start
// first on every head. scale_log2 = scale * log2(e): scores live in base 2.
template <int D, bool PAD>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                                int Hq, int Hkv, int d_pad, float scale_log2,
                                int causal, int window) {
  const int d = PAD ? d_pad : D;  // the head dim; a constant when exact
  constexpr int ST = D + 8;          // shared row stride: ldmatrix conflict-free
  constexpr int TILE = BQ * ST;
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int NS = BKV / 8;        // score n-tiles per warp
  constexpr int NO = D / 8;          // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TILE;     // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * TILE; // 2 stages

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int offset = Sk - Sq;
  const size_t q_row = (size_t)Hq * d, k_row = (size_t)Hkv * d;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_row + (size_t)h * d;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * k_row + (size_t)hk * d;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * k_row + (size_t)hk * d;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_row + (size_t)h * d;

  // kv range that some real row of this q tile can see
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin -= k_begin % BKV;

  load_rows<D>(Qs, qb, q_row, q0, Sq, d);
  if (k_begin < k_end) {
    load_rows<D>(Ks, kb, k_row, k_begin, Sk, d);
    load_rows<D>(Vs, vb, k_row, k_begin, Sk, d);
  }
  cp_async_commit();

  // this thread's rows: lo = warp * 16 + gid, hi = lo + 8 (of the q tile)
  const int r_lo = q0 + warp * 16 + gid;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  unsigned qf[KS][4];

  int stage = 0;
  for (int kt = k_begin; kt < k_end; kt += BKV, stage ^= 1) {
    if (kt + BKV < k_end) {
      load_rows<D>(Ks + (stage ^ 1) * TILE, kb, k_row, kt + BKV, Sk, d);
      load_rows<D>(Vs + (stage ^ 1) * TILE, vb, k_row, kt + BKV, Sk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == k_begin) {  // Q fragments stay in registers for the loop
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + lane % 8 + (lane / 8 % 2) * 8) * ST +
                            ks * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* Kt = Ks + stage * TILE;
    const __nv_bfloat16* Vt = Vs + stage * TILE;

    // S = Q K^T: 16 rows x 64 kv columns per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned kf[4];  // b0, b1 of n-tile 2np, then of 2np + 1
        ldsm_x4(kf, Kt + (np * 16 + lane % 8 + (lane / 16) * 8) * ST +
                        ks * 16 + (lane / 8 % 2) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }

    // scale and mask; only tiles that cross an edge test each score
    const bool edge = kt + BKV > Sk ||
                      (causal && kt + BKV - 1 > q0 + warp * 16 + offset) ||
                      (window > 0 && kt <= q0 + warp * 16 + 15 + offset - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = kt + j * 8 + tig * 2 + (e & 1);
          const int q_pos = r_lo + (e >> 1) * 8 + offset;
          bool ok = col < Sk;
          if (causal) ok = ok && col <= q_pos;
          if (window > 0) ok = ok && col > q_pos - window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax, rows lo (e = 0, 1) and hi (e = 2, 3); a row's 64
    // scores sit in the 4 lanes of its quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2_approx(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * i] = exp2_approx(s[j][2 * i] - m_new);
        s[j][2 * i + 1] = exp2_approx(s[j][2 * i + 1] - m_new);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P's accumulators, rounded to bf16, are the A fragments
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        unsigned vf[4];  // b0, b1 of d-tile 2dp, then of 2dp + 1
        ldsm_x4_t(vf, Vt + (kc * 16 + lane % 8 + (lane / 8 % 2) * 8) * ST +
                          dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + (size_t)row * q_row + tig * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      if (j * 8 < d)  // d is a multiple of 8: the tail tiles are not stored
        *reinterpret_cast<unsigned*>(orow + j * 8) =
            pack_bf16(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
  }
}

}  // namespace tc

template <int D, bool PAD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int Hq, int Hkv, int d,
                        float scale, int causal, int window,
                        cudaStream_t stream) {
  constexpr size_t smem = tc::smem_bytes<D>();
  static SmemOnce once;
  cudaError_t err =
      allow_smem(once, tc::flash_attention_bf16_kernel<D, PAD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + tc::BQ - 1) / tc::BQ);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  tc::flash_attention_bf16_kernel<D, PAD>
      <<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, Hq, Hkv, d, scale * tc::LOG2E, causal, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D is the head dim: any multiple of 8
// up to 128 runs in the next instance up (32, 64 or 128), its tail loaded
// as zeros and never stored. Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int Hq, int Hkv, int D,
                                   float scale, int causal, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  const int inst = D <= 32 ? 32 : D <= 64 ? 64 : 128;
#define FA_LAUNCH(KIND, I)                                                   \
  if (inst == I && D == I)                                                   \
    return launch_##KIND<I, false>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale, \
                                   causal, window, s);                       \
  if (inst == I)                                                             \
    return launch_##KIND<I, true>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale,  \
                                  causal, window, s);
  if (dtype == 0) {
    FA_LAUNCH(f32, 32)
    FA_LAUNCH(f32, 64)
    FA_LAUNCH(f32, 128)
  }
  if (dtype == 1) {
    FA_LAUNCH(bf16, 32)
    FA_LAUNCH(bf16, 64)
    FA_LAUNCH(bf16, 128)
  }
#undef FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
