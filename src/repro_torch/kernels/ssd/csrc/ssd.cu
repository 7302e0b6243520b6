// Mamba-2 SSD chunked scan for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd/pallas.py::ssd_chunked (body
// `_kernel`). It computes the same function as ref.ssd_chunked: per chunk of
// Q steps, with dA_cum the inclusive prefix sum of dt * A and xs = x * dt,
//   y     = (C B^T  .*  L) xs  +  exp(dA_cum) .* (C state^T),
//           L[i, j] = exp(dA_cum_i - dA_cum_j) for i >= j, else 0;
//   state = state * exp(dA_cum[-1]) + sum_j B_j exp(dA_cum[-1] - dA_cum_j) xs_j,
// all in f32. Unlike the TPU kernel it also takes an initial state and gives
// the final one back, so the stateful prefill runs on it too.
//
// Design. The TPU kernel walks (batch, chunk) with the chunk axis sequential
// and carries the whole (H, P, N) state in VMEM; at Mamba2-2.7B that is
// 80 x 64 x 128 x 4 B = 2.6 MB, far above a block's 227 KB of shared memory.
// Here one thread block owns one (batch, head) and loops over the chunks
// itself, keeping that head's f32 state (P x N <= 64 x 128, 32 KB) in shared
// memory across them. Per chunk it stages xs (Q x P), the prefix sums and
// the decay weights in shared memory; B and C pass through in tiles of 32
// state columns. Each tile adds its part of C B^T (Q x Q, 64 registers a
// thread) and of C state^T (Q x P, 32 registers a thread), then updates its
// 32 state columns. The masked, decayed C B^T block goes to shared memory
// once per chunk (66 KB), and a last product forms y. 256 threads; thread
// (ty, tx) = (t / 16, t % 16) owns rows ty + 16 r and columns tx + 16 c of
// each product. Padded row strides keep the shared-memory accesses free of
// bank conflicts (two-way at worst). The block is sized for the largest
// shapes it takes (Q <= 128, P <= 64, N <= 128; 166 KB, granted by
// cudaFuncSetAttribute); smaller ones are zero-padded, which changes no
// result: a padded step has dt = 0, so it neither decays nor feeds the
// state. Steps past L are padded the same way.
//
// What bounds it. At the prefill shape (B 4, L 1,024, H 80, P 64, N 128,
// bf16) the scan moves ~98 MB (x and y dominate) and does ~27 GFLOP if the
// quadratic block is counted whole, so on tensor cores it would sit near the
// card's ridge, bytes-bound at ~29 us. This first version does the products
// as f32 FMAs on the CUDA cores and recomputes C B^T for every head of a
// group, so it is bounded by FMA issue and shared-memory loads; 320 blocks
// of 166 KB run one per SM, in three waves. wgmma tiles with TMA loads and
// C B^T shared across a group's heads are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QM = 128;          // largest chunk
constexpr int PM = 64;           // largest head dim
constexpr int NM = 128;          // largest state size
constexpr int NT = 32;           // state columns per tile
constexpr int PS = PM + 1;       // state row stride (state stored [n][p])
constexpr int QS = QM + 1;       // B/C tile and C B^T row strides
constexpr int SMEM_FLOATS = NM * PS + QM * PM + QM * QS + 2 * NT * QS + 3 * QM;

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
  return __float2bfloat16(x);  // round to nearest even, as .to(bf16) does
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunked_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm,
                       const float* __restrict__ init_state,
                       T* __restrict__ y, float* __restrict__ final_state,
                       int L, int H, int P, int N, int G, int Q) {
  extern __shared__ float smem[];
  float* st = smem;                 // NM x PS: the state, [n][p]
  float* xs = st + NM * PS;         // QM x PM: x * dt, [i][p]
  float* sc = xs + QM * PM;         // QM x QS: masked C B^T, [j][i]
  float* ct = sc + QM * QS;         // NT x QS: C tile, [n][i]
  float* bt = ct + NT * QS;         // NT x QS: B tile, [n][j]
  float* dtv = bt + NT * QS;        // QM: dt of the chunk's steps
  float* cum = dtv + QM;            // QM: inclusive prefix sum of dt * A
  float* wdec = cum + QM;           // QM: exp(cum[-1] - cum[j])

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a_h = A[h];

  for (int k = tid; k < NM * PS; k += THREADS) st[k] = 0.f;
  __syncthreads();
  if (init_state != nullptr) {
    const float* s0 = init_state + (size_t)(b * H + h) * P * N;
    for (int k = tid; k < P * N; k += THREADS)
      st[(k % N) * PS + k / N] = s0[k];
  }
  __syncthreads();

  const int n_chunks = (L + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int l0 = c * Q;
    // steps of the chunk: rows i < Q with l0 + i < L; the rest are padding
    for (int i = tid; i < QM; i += THREADS) {
      const int l = l0 + i;
      dtv[i] = (i < Q && l < L) ? dt[((size_t)b * L + l) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // warp 0: inclusive scan of dt * A, four steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run += dtv[tid * 4 + u] * a_h;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) cum[tid * 4 + u] = excl + v[u];
    }
    __syncthreads();
    const float cum_last = cum[QM - 1];
    for (int i = tid; i < QM; i += THREADS) wdec[i] = expf(cum_last - cum[i]);
    for (int k = tid; k < QM * PM; k += THREADS) {
      const int i = k / PM, p = k % PM, l = l0 + i;
      xs[k] = (i < Q && l < L && p < P)
                  ? to_float(x[(((size_t)b * L + l) * H + h) * P + p]) * dtv[i]
                  : 0.f;
    }
    const float chunk_decay = expf(cum_last);

    float cb[8][8], yo[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) cb[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) yo[r][q] = 0.f;
    }

    for (int n0 = 0; n0 < N; n0 += NT) {
      for (int k = tid; k < QM * NT; k += THREADS) {
        const int i = k / NT, n = k % NT, l = l0 + i;
        const bool ok = i < Q && l < L && n0 + n < N;
        const size_t at = (((size_t)b * L + l) * G + g) * N + n0 + n;
        ct[n * QS + i] = ok ? to_float(Cm[at]) : 0.f;
        bt[n * QS + i] = ok ? to_float(Bm[at]) : 0.f;
      }
      __syncthreads();
      // C B^T and C state^T over this tile's state columns
#pragma unroll 4
      for (int n = 0; n < NT; ++n) {
        float cr[8], br[8], sv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cr[r] = ct[n * QS + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 8; ++q) br[q] = bt[n * QS + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = st[(n0 + n) * PS + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int q = 0; q < 8; ++q) cb[r][q] = fmaf(cr[r], br[q], cb[r][q]);
#pragma unroll
          for (int q = 0; q < 4; ++q) yo[r][q] = fmaf(cr[r], sv[q], yo[r][q]);
        }
      }
      __syncthreads();  // every read of the old state tile is done
      // state update of the tile's columns n0 + ty + 16 r
      float u[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[r][q] = st[(n0 + ty + 16 * r) * PS + tx + 16 * q] * chunk_decay;
#pragma unroll 4
      for (int j = 0; j < QM; ++j) {
        const float w = wdec[j];
        float bw[2], xv[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) bw[r] = bt[(ty + 16 * r) * QS + j] * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xs[j * PM + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) u[r][q] = fmaf(bw[r], xv[q], u[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[(n0 + ty + 16 * r) * PS + tx + 16 * q] = u[r][q];
      __syncthreads();  // the next tile overwrites ct and bt
    }

    // the masked, decayed C B^T block, stored transposed: sc[j][i]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        sc[j * QS + i] = j <= i ? cb[r][q] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float d = expf(cum[ty + 16 * r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) yo[r][q] *= d;
    }
#pragma unroll 4
    for (int j = 0; j < QM; ++j) {
      float sr[8], xv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) sr[r] = sc[j * QS + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[j * PM + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) yo[r][q] = fmaf(sr[r], xv[q], yo[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r, l = l0 + i;
      if (i >= Q || l >= L) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P)
          y[(((size_t)b * L + l) * H + h) * P + p] = from_float<T>(yo[r][q]);
      }
    }
    __syncthreads();  // the next chunk overwrites xs, sc, cum and wdec
  }

  if (final_state != nullptr) {
    float* sf = final_state + (size_t)(b * H + h) * P * N;
    for (int k = tid; k < P * N; k += THREADS) sf[k] = st[(k % N) * PS + k / N];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init_state,
                   void* y, float* final_state, int batch, int L, int H, int P,
                   int N, int G, int Q, cudaStream_t stream) {
  auto kernel = ssd_chunked_kernel<T>;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init_state, static_cast<T*>(y), final_state,
      L, H, P, N, G, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A and the states
// are float32. init_state / final_state may be null. Returns a cudaError_t
// (0 = success).
extern "C" int ssd_chunked_fwd(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init_state, void* y,
                               void* final_state, int dtype, int batch, int L,
                               int H, int P, int N, int G, int Q,
                               void* stream) {
  if (Q < 1 || Q > QM || P < 1 || P > PM || N < 1 || N > NM || G < 1 ||
      H % G != 0 || L < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* s0 = static_cast<const float*>(init_state);
  float* sf = static_cast<float*>(final_state);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bm, Cm, s0, y, sf, batch, L, H, P, N, G,
                         Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, s0, y, sf, batch, L, H, P,
                                 N, G, Q, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
