// Mamba-2 SSD chunked scan for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd/pallas.py::ssd_chunked (body
// `_kernel`). It computes the same function as ref.ssd_chunked: per chunk of
// Q steps, with dA_cum the inclusive prefix sum of dt * A and xs = x * dt,
//   y     = (C B^T  .*  L) xs  +  exp(dA_cum) .* (C state^T),
//           L[i, j] = exp(dA_cum_i - dA_cum_j) for i >= j, else 0;
//   state = state * exp(dA_cum[-1]) + sum_j B_j exp(dA_cum[-1] - dA_cum_j) xs_j.
// Unlike the TPU kernel it also takes an initial state and gives the final
// one back, so the stateful prefill runs on it too. The TPU kernel walks
// (batch, chunk) with the chunk axis sequential and carries the whole
// (H, P, N) state in VMEM; at Mamba2-2.7B that is 2.6 MB, far above a
// block's 227 KB of shared memory. Here one thread block owns one (batch,
// head) and loops over the chunks itself, carrying that head's state.
// Any chunk <= 128, P <= 64, N <= 128 and L are taken: smaller shapes are
// zero-padded to the block's tiles, which changes no result, since a
// padded step has dt = 0 and so neither decays nor feeds the state.
//
// What bounds it. At the prefill shape (B 4, L 1,024, H 80, P 64, N 128,
// bf16) the scan must move ~98 MB (x and y dominate) and do ~27 GFLOP if
// the quadratic block is counted whole: bytes-bound at ~29 us, with the
// tensor cores' time close behind. Two routes:
//
// bf16 (the model's dtype): ssd_chunked_bf16, all four products on
// mma.sync.m16n8k16 tiles (bf16 in, f32 accumulate), fed by ldmatrix.
// * Rounding. x, B and C are bf16 in memory. The f32 values that feed a
//   product are rounded to bf16 once, at the fragment: the masked, decayed
//   C B^T block with dt folded in (M[i, j] = (C B^T)[i, j] L[i, j] dt_j,
//   so y_diag = M x and x itself enters exact), the decay-weighted x of
//   the state update (x_j dt_j exp(dA_cum[-1] - dA_cum_j)), and the
//   state's bf16 copy that C state^T reads. The state itself, the prefix
//   sums and the exponentials stay f32, as do all sums. A CPU model of
//   these rounding points is held against the JAX oracle in
//   tests/test_torch_ssd.py.
// * Registers, not shared memory, carry the state: eight warps each own a
//   16 x 64 tile of the f32 (P x N) state as mma accumulators (32 a
//   thread) across all chunks; its bf16 copy ([p][n], 17 KB) is the only
//   state in shared memory. Warp w owns chunk rows 16w..16w+15 of y: it
//   sums C state^T, then walks only the 16-step key tiles j <= its rows
//   (the causal half), turning each 16 x 16 C B^T block into the A
//   fragment of M x in registers.
// * Two blocks an SM: shared memory is C, B (128 x 136 bf16 each), x (128
//   x 72), the state copy and 2.5 KB of per-step scalars, 108 KB in all,
//   and __launch_bounds__(256, 2) holds registers to 128. The 320 blocks
//   of the prefill shape then run in 1.2 waves over 132 SMs, not 2.4.
// * Loads are cp.async, 16 bytes where rows are 16-byte aligned, with
//   zeros past every edge. The next chunk's C and dt load while the state
//   update runs (C is free by then); its B and x after it, while the
//   block's partner on the SM computes.
//
// f32 (the f32 callers and tests): ssd_chunked_f32, the first design of
// this file, f32 FMAs on the CUDA cores, kept for f32 accuracy (no TF32).
// Per chunk it stages xs (Q x P), the prefix sums and the decay weights in
// shared memory; B and C pass through in tiles of 32 state columns. Each
// tile adds its part of C B^T (Q x Q, 64 registers a thread) and of
// C state^T (Q x P, 32 registers a thread), then updates its 32 state
// columns, held in shared memory. 166 KB of shared memory, one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int QM = 128;          // largest chunk
constexpr int PM = 64;           // largest head dim
constexpr int NM = 128;          // largest state size
constexpr int NT = 32;           // state columns per tile
constexpr int PS = PM + 1;       // state row stride (state stored [n][p])
constexpr int QS = QM + 1;       // B/C tile and C B^T row strides
constexpr int SMEM_FLOATS = NM * PS + QM * PM + QM * QS + 2 * NT * QS + 3 * QM;

__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunked_f32(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm,
                   const float* __restrict__ init_state,
                   float* __restrict__ y, float* __restrict__ final_state,
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
                  ? x[(((size_t)b * L + l) * H + h) * P + p] * dtv[i]
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
        ct[n * QS + i] = ok ? Cm[at] : 0.f;
        bt[n * QS + i] = ok ? Bm[at] : 0.f;
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
          y[(((size_t)b * L + l) * H + h) * P + p] = yo[r][q];
      }
    }
    __syncthreads();  // the next chunk overwrites xs, sc, cum and wdec
  }

  if (final_state != nullptr) {
    float* sf = final_state + (size_t)(b * H + h) * P * N;
    for (int k = tid; k < P * N; k += THREADS) sf[k] = st[(k % N) * PS + k / N];
  }
}


// ---------------------------------------------------------------- bf16 route

namespace tc {

constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SN = NM + 8;       // row stride of C, B and the state copy:
constexpr int SP = PM + 8;       // 16 bytes past a multiple of 128, so the
                                 // 8 rows of an ldmatrix hit distinct banks
constexpr size_t SMEM_BYTES =
    sizeof(__nv_bfloat16) * (2 * QM * SN + QM * SP + PM * SN) +
    sizeof(float) * 5 * QM;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(QM == 16 * WARPS, "a warp owns 16 rows of the chunk");
static_assert(PM == 16 * (WARPS / 2) && NM == 64 * 2,
              "a warp owns a 16 x 64 tile of the state");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (16 or 4) global -> shared, or zeros if !ok
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// 2^x on the SFU; flushes subnormal results to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// (lo * wlo, hi * whi) of a packed bf16 pair, rounded once to bf16
__device__ __forceinline__ unsigned scale_bf16(unsigned v, float wlo,
                                               float whi) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(p) * wlo, __high2float(p) * whi);
}

// Rows i < QM of the chunk starting at step l0 into a [QM][stride] tile:
// row i holds `width` elements of step l0 + i (src + (l0 + i) * row), zeros
// past `width`, for rows i >= Q and for steps >= L. vec: 16-byte copies
// (src, row and width multiples of 8 elements).
template <int W, int STRIDE>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t row, int width, int l0,
                                          int Q, int L, bool vec) {
  const int t = threadIdx.x;
  if (vec) {
    constexpr int CH = W / 8;  // 16-byte chunks per row
#pragma unroll
    for (int e = t; e < QM * CH; e += THREADS) {
      const int i = e / CH, c = (e % CH) * 8;
      const bool ok = i < Q && l0 + i < L && c < width;
      cp_async<16>(dst + i * STRIDE + c,
                   ok ? src + (size_t)(l0 + i) * row + c : src, ok);
    }
  } else {
    for (int e = t; e < QM * W; e += THREADS) {
      const int i = e / W, c = e % W;
      const bool ok = i < Q && l0 + i < L && c < width;
      dst[i * STRIDE + c] =
          ok ? src[(size_t)(l0 + i) * row + c] : __float2bfloat16(0.f);
    }
  }
}

// grid (H, batch), THREADS threads, SMEM_BYTES of dynamic shared memory.
// vec_x / vec_bc: x / B and C may be read by 16-byte copies.
__global__ void __launch_bounds__(THREADS, 2)
    ssd_chunked_bf16(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ init_state,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ final_state, int L, int H, int P,
                    int N, int G, int Q, int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [i][n]
  __nv_bfloat16* Bs = Cs + QM * SN;                                 // [j][n]
  __nv_bfloat16* Xs = Bs + QM * SN;                                 // [j][p]
  __nv_bfloat16* Ss = Xs + QM * SP;  // [p][n]: the state's bf16 copy
  float* dts = reinterpret_cast<float*>(Ss + PM * SN);  // 2 x QM: dt
  float* cum2 = dts + 2 * QM;   // dA_cum * log2(e)
  float* ecum = cum2 + QM;      // exp(dA_cum)
  float* dtw = ecum + QM;       // dt_j exp(dA_cum[-1] - dA_cum_j)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const float a_h = A[h];
  const int n_chunks = (L + Q - 1) / Q;
  const int kn = (N + 15) / 16;        // 16-wide steps over the state size
  const int kp = (P + 15) / 16;        // 16-wide column pairs of P
  const size_t x_row = (size_t)H * P, bc_row = (size_t)G * N;
  const __nv_bfloat16* xb = x + (size_t)b * L * x_row + (size_t)h * P;
  const __nv_bfloat16* Bb = Bm + (size_t)b * L * bc_row + (size_t)g * N;
  const __nv_bfloat16* Cb = Cm + (size_t)b * L * bc_row + (size_t)g * N;
  const float* dtb = dt + (size_t)b * L * H + h;

  auto load_dt = [&](float* dst, int l0) {
    if (tid < QM) {
      const bool ok = tid < Q && l0 + tid < L;
      cp_async<4>(dst + tid, ok ? dtb + (size_t)(l0 + tid) * H : dtb, ok);
    }
  };
  load_rows<NM, SN>(Cs, Cb, bc_row, N, 0, Q, L, vec_bc);
  load_rows<NM, SN>(Bs, Bb, bc_row, N, 0, Q, L, vec_bc);
  load_rows<PM, SP>(Xs, xb, x_row, P, 0, Q, L, vec_x);
  load_dt(dts, 0);
  cp_async_commit();

  // this warp's tile of the f32 state: rows p0 + gid (+ 8), columns
  // n0 + 8 t + 2 tig (+ 1), as mma accumulators
  const int p0 = (warp % 4) * 16, n0 = (warp / 4) * 64;
  float st[8][4];
  const float* s0 = init_state == nullptr
                        ? nullptr
                        : init_state + (size_t)(b * H + h) * P * N;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + gid + (e >> 1) * 8, n = n0 + t * 8 + 2 * tig + (e & 1);
      st[t][e] = (s0 != nullptr && p < P && n < N) ? s0[(size_t)p * N + n]
                                                   : 0.f;
    }
  auto store_state_copy = [&]() {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int n = n0 + t * 8 + 2 * tig;
      *reinterpret_cast<unsigned*>(Ss + (p0 + gid) * SN + n) =
          pack_bf16(st[t][0], st[t][1]);
      *reinterpret_cast<unsigned*>(Ss + (p0 + gid + 8) * SN + n) =
          pack_bf16(st[t][2], st[t][3]);
    }
  };
  store_state_copy();

  for (int c = 0; c < n_chunks; ++c) {
    const int l0 = c * Q;
    const float* dtc = dts + (c & 1) * QM;
    cp_async_wait_all();
    __syncthreads();  // chunk c's tiles are in, the state copy is written
    if (warp == 0) {  // inclusive scan of dt * A, four steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run += dtc[lane * 4 + u] * a_h;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const float excl = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = lane * 4 + u;
        const float cum = excl + v[u];
        cum2[i] = cum * LOG2E;
        ecum[i] = expf(cum);
        dtw[i] = dtc[i] * expf(last - cum);
      }
    }
    __syncthreads();

    // y rows i0.. of this warp: C state^T scaled by exp(dA_cum_i), plus
    // the causal blocks of M x
    const int i0 = warp * 16;
    if (i0 < Q) {
      // C's A fragments (rows i0.., 16 state columns at ks) are read from
      // shared memory where they are used: held for all ks they would
      // push the block past 128 registers
      auto c_frag = [&](unsigned (&cf)[4], int ks) {
        ldsm_x4(cf, Cs + (i0 + lane % 8 + (lane / 8 % 2) * 8) * SN + ks * 16 +
                        (lane / 16) * 8);
      };
      float acc[PM / 8][4];
#pragma unroll
      for (int t = 0; t < PM / 8; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NM / 16; ++ks) {
        if (ks >= kn) break;
        unsigned cf[4];
        c_frag(cf, ks);
#pragma unroll
        for (int pp = 0; pp < PM / 16; ++pp) {
          if (pp >= kp) break;
          unsigned sf[4];  // state copy [p][n]: b0, b1 of p-tiles 2pp, 2pp+1
          ldsm_x4(sf, Ss + (pp * 16 + lane % 8 + (lane / 16) * 8) * SN +
                          ks * 16 + (lane / 8 % 2) * 8);
          mma_bf16(acc[2 * pp], cf, sf[0], sf[1]);
          mma_bf16(acc[2 * pp + 1], cf, sf[2], sf[3]);
        }
      }
      const int r_lo = i0 + gid, r_hi = r_lo + 8;
      const float e_lo = ecum[r_lo], e_hi = ecum[r_hi];
#pragma unroll
      for (int t = 0; t < PM / 8; ++t) {
        acc[t][0] *= e_lo;
        acc[t][1] *= e_lo;
        acc[t][2] *= e_hi;
        acc[t][3] *= e_hi;
      }
      const float c_lo = cum2[r_lo], c_hi = cum2[r_hi];
      for (int jt = 0; jt <= warp && jt * 16 < Q; ++jt) {
        float cb[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < NM / 16; ++ks) {
          if (ks >= kn) break;
          unsigned cf[4], bf[4];  // B [j][n]: b0, b1 of j-tiles 2jt, 2jt+1
          c_frag(cf, ks);
          ldsm_x4(bf, Bs + (jt * 16 + lane % 8 + (lane / 16) * 8) * SN +
                          ks * 16 + (lane / 8 % 2) * 8);
          mma_bf16(cb[0], cf, bf[0], bf[1]);
          mma_bf16(cb[1], cf, bf[2], bf[3]);
        }
        // M[i, j] = (C B^T)[i, j] exp(dA_cum_i - dA_cum_j) dt_j for j <= i;
        // the exponent of a kept entry is <= 0 (A < 0, dt >= 0)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = jt * 16 + t * 8 + 2 * tig + (e & 1);
            const int i = e < 2 ? r_lo : r_hi;
            const float d =
                j <= i ? exp2_approx((e < 2 ? c_lo : c_hi) - cum2[j]) * dtc[j]
                       : 0.f;
            cb[t][e] *= d;
          }
        const unsigned ma[4] = {pack_bf16(cb[0][0], cb[0][1]),
                                pack_bf16(cb[0][2], cb[0][3]),
                                pack_bf16(cb[1][0], cb[1][1]),
                                pack_bf16(cb[1][2], cb[1][3])};
#pragma unroll
        for (int pp = 0; pp < PM / 16; ++pp) {
          if (pp >= kp) break;
          unsigned xf[4];  // x [j][p]: b0, b1 of p-tiles 2pp, 2pp+1
          ldsm_x4_t(xf, Xs + (jt * 16 + lane % 8 + (lane / 8 % 2) * 8) * SP +
                            pp * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * pp], ma, xf[0], xf[1]);
          mma_bf16(acc[2 * pp + 1], ma, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? r_hi : r_lo, l = l0 + i;
        if (i >= Q || l >= L) continue;
        __nv_bfloat16* yrow =
            y + ((size_t)b * L + l) * x_row + (size_t)h * P;
#pragma unroll
        for (int t = 0; t < PM / 8; ++t) {
          const int p = t * 8 + 2 * tig;
          const float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
          if (p + 1 < P && P % 2 == 0) {
            *reinterpret_cast<unsigned*>(yrow + p) = pack_bf16(v0, v1);
          } else {
            if (p < P) yrow[p] = __float2bfloat16(v0);
            if (p + 1 < P) yrow[p + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();  // C and the state copy are read
    const bool more = c + 1 < n_chunks;
    if (more) {  // the next chunk's C and dt load under the state update
      load_rows<NM, SN>(Cs, Cb, bc_row, N, l0 + Q, Q, L, vec_bc);
      load_dt(dts + ((c + 1) & 1) * QM, l0 + Q);
      cp_async_commit();
    }

    // state = state * exp(dA_cum[-1]) + (x .* dtw)^T B over this warp's
    // 16 x 64 tile; (x .* dtw) is rounded once, in the A fragment
    const float decay = ecum[QM - 1];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] *= decay;
    if (p0 < P && n0 < N) {
      for (int jt = 0; jt * 16 < Q; ++jt) {
        unsigned xa[4];  // x^T rows p0.., columns j: (x [j][p]).trans
        ldsm_x4_t(xa, Xs + (jt * 16 + lane % 8 + (lane / 16) * 8) * SP + p0 +
                          (lane / 8 % 2) * 8);
        const int j = jt * 16 + 2 * tig;
        const float w0 = dtw[j], w1 = dtw[j + 1], w8 = dtw[j + 8],
                    w9 = dtw[j + 9];
        xa[0] = scale_bf16(xa[0], w0, w1);
        xa[1] = scale_bf16(xa[1], w0, w1);
        xa[2] = scale_bf16(xa[2], w8, w9);
        xa[3] = scale_bf16(xa[3], w8, w9);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          if (n0 + nn * 16 >= N) break;
          unsigned bf[4];  // B [j][n]: b0, b1 of n-tiles 2nn, 2nn+1
          ldsm_x4_t(bf, Bs + (jt * 16 + lane % 8 + (lane / 8 % 2) * 8) * SN +
                            n0 + nn * 16 + (lane / 16) * 8);
          mma_bf16(st[2 * nn], xa, bf[0], bf[1]);
          mma_bf16(st[2 * nn + 1], xa, bf[2], bf[3]);
        }
      }
    }
    store_state_copy();  // nobody reads the copy until the next chunk
    __syncthreads();     // x and B are read
    if (more) {
      load_rows<NM, SN>(Bs, Bb, bc_row, N, l0 + Q, Q, L, vec_bc);
      load_rows<PM, SP>(Xs, xb, x_row, P, l0 + Q, Q, L, vec_x);
      cp_async_commit();
    }
  }

  if (final_state != nullptr) {
    float* sf = final_state + (size_t)(b * H + h) * P * N;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gid + (e >> 1) * 8,
                  n = n0 + t * 8 + 2 * tig + (e & 1);
        if (p < P && n < N) sf[(size_t)p * N + n] = st[t][e];
      }
  }
}

// 16-byte copies need the base 16-byte aligned and rows of whole chunks
bool vec_ok(const void* p, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && width % 8 == 0;
}

}  // namespace tc

// Above 48 KB a block's dynamic shared memory must be granted, once per
// kernel and device; granting it is not a stream operation.
struct SmemOnce {
  size_t granted[64] = {};
};

template <typename K>
cudaError_t allow_smem(SmemOnce& once, K kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && once.granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) once.granted[dev] = bytes;
  return err;
}

SmemOnce f32_once, bf16_once;
constexpr size_t F32_SMEM_BYTES = SMEM_FLOATS * sizeof(float);

cudaError_t launch_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm,
                       const float* init_state, float* y, float* final_state,
                       int batch, int L, int H, int P, int N, int G, int Q,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(f32_once, ssd_chunked_f32, F32_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  ssd_chunked_f32<<<dim3(H, batch), THREADS, F32_SMEM_BYTES, stream>>>(
      x, dt, A, Bm, Cm, init_state, y, final_state, L, H, P, N, G, Q);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm,
                        const float* init_state, void* y, float* final_state,
                        int batch, int L, int H, int P, int N, int G, int Q,
                        cudaStream_t stream) {
  cudaError_t err = allow_smem(bf16_once, tc::ssd_chunked_bf16,
                               tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int vec_x = tc::vec_ok(x, P) && (H * P) % 8 == 0;
  const int vec_bc = tc::vec_ok(Bm, N) && tc::vec_ok(Cm, N) && (G * N) % 8 == 0;
  tc::ssd_chunked_bf16<<<dim3(H, batch), tc::THREADS, tc::SMEM_BYTES,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), init_state,
      static_cast<__nv_bfloat16*>(y), final_state, L, H, P, N, G, Q, vec_x,
      vec_bc);
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
      H % G != 0 || L < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* s0 = static_cast<const float*>(init_state);
  float* sf = static_cast<float*>(final_state);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), dtf, Af,
                      static_cast<const float*>(Bm),
                      static_cast<const float*>(Cm), s0,
                      static_cast<float*>(y), sf, batch, L, H, P, N, G, Q, s);
  if (dtype == 1)
    return launch_bf16(x, dtf, Af, Bm, Cm, s0, y, sf, batch, L, H, P, N, G, Q,
                       s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of a dtype's route, for the records: out[0] threads a
// block, out[1] its dynamic shared memory in bytes, out[2] blocks an SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, out[3] registers a thread,
// out[4] bytes of local memory a thread (spills). Returns a cudaError_t.
extern "C" int ssd_plan(int dtype, int* out) {
  const void* fn;
  int threads;
  size_t smem;
  cudaError_t err;
  if (dtype == 0) {
    fn = reinterpret_cast<const void*>(ssd_chunked_f32);
    threads = THREADS;
    smem = F32_SMEM_BYTES;
    err = allow_smem(f32_once, ssd_chunked_f32, smem);
  } else if (dtype == 1) {
    fn = reinterpret_cast<const void*>(tc::ssd_chunked_bf16);
    threads = tc::THREADS;
    smem = tc::SMEM_BYTES;
    err = allow_smem(bf16_once, tc::ssd_chunked_bf16, smem);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
