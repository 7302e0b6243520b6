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
//
// Design. The TPU kernel walks kv blocks as the sequential "arbitrary" grid
// axis and carries m/l/acc in VMEM scratch between grid steps. Blocks on the
// GPU run in no order, so here one thread block owns one (batch, q head,
// 64-row q tile) and loops over 32-row kv tiles itself, keeping m/l/acc in
// registers. Q stays in shared memory for the whole loop; each kv tile is
// staged in shared memory once and read by all 128 threads. Thread t owns
// q rows 4*(t/8) .. 4*(t/8)+3 for both products: scores at kv columns
// t%8 + 8j, output at head dims t%8 + 8c. So the row max and row sum need
// only a shuffle over the 8 lanes of a row group, and the rescale by
// alpha touches registers only. Kv tiles that the causal mask or the window
// hide from every row of the q tile are skipped: a row that sees at least
// one key gets exactly the result of visiting them, because a masked score
// contributes exp(-1e30 - m) = 0 once m is real. The wrapper refuses
// Sq > Sk, the only shapes that leave a row with no key at all.
//
// What bounds it. At the serving shapes (D = 128, G = 16) attention does
// about 4*D = 512 flops per kv element loaded, above the card's ~295
// flop/byte ridge, so a good kernel is compute-bound on the tensor cores.
// This first version uses f32 FMAs on the CUDA cores (bf16 and f32 inputs
// both widen to f32 on load), so it is bounded by shared-memory loads and
// FMA issue, far from the tensor-core bound. The padded row strides keep
// every shared-memory access free of bank conflicts. Moving the two
// products to mma/wgmma on bf16 tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 32;
constexpr int THREADS = 128;            // 16 row groups x 8 column lanes
constexpr int ROWS = 4;                 // q rows per thread
constexpr int KCOLS = BLOCK_K / 8;      // score columns per thread
constexpr int PSTRIDE = BLOCK_K + 2;    // P row stride: conflict-free
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) +
                          BLOCK_K * D + BLOCK_Q * PSTRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               int Sq, int Sk, int Hq, int Hkv, float scale,
                               int causal, int window) {
  constexpr int QS = D + 1;       // Q and K row stride: conflict-free
  constexpr int DC = D / 8;       // output columns per thread
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

  const size_t q_row = (size_t)Hq * D;
  const size_t k_row = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * k_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Sk * k_row + (size_t)hk * D;
  T* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * QS + c] = s < Sq ? to_float(qb[(size_t)s * q_row + c]) : 0.f;
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
      const bool ok = s < Sk;
      Ks[r * QS + c] = ok ? to_float(kb[(size_t)s * k_row + c]) : 0.f;
      Vs[r * D + c] = ok ? to_float(vb[(size_t)s * k_row + c]) : 0.f;
    }
    __syncthreads();

    float sc[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qs[(rg * ROWS + i) * QS + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = Ks[(cl + 8 * j) * QS + d];
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
      ob[(size_t)s * q_row + cl + 8 * c] = from_float<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                   int causal, int window, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int Hq, int Hkv, int D,
                                   float scale, int causal, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal,
                             window, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal,
                              window, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale,
                                     causal, window, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale,
                                      causal, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
