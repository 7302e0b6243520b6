// Fused imagination step for Hopper (sm_90a), in plain CUDA C++.
//
// imag_fused_step replaces the TPU kernel src/repro/kernels/imag/pallas.py::
// fused_step_sorted (body `_fused_kernel`). On rows sorted by their assigned
// ensemble member it runs, for every row b:
//
//   mu   = policy MLP(s[b])                      (tanh hidden, linear out)
//   pre  = mu + exp(log_std) * eps[b],  a = tanh(pre)
//   xn   = ([s[b], a] - mu_in) / sig_in
//   s2   = s[b] + member_mlp[g(b)](xn) * sig_out + mu_out
//
// and writes (s2, a, pre). f32 in and out, f32 FMAs on the CUDA cores (no
// TF32). Member g owns the sorted rows [offs[g], offs[g + 1]).
//
// Design. The TPU kernel's grid (B / bm, K) walks the members of a row block
// in order and carries the normalised input and an accumulator across them
// in VMEM; every member it visits runs the whole block, masked. GPU blocks
// run in no order, so nothing is carried: here the grid is (B / 32, K) and
// block (i, g) owns only the rows of tile i that member g was assigned, the
// contiguous range [max(offs[g], 32 i), min(offs[g + 1], 32 i + 32)). A
// block whose range is empty returns at once, as the TPU kernel skips a
// member that does not touch its tile; every row is thus computed once, its
// policy head included, and an empty member costs nothing. Small batches get
// more blocks than a tile-per-block grid would give them (up to K per tile).
//
// A member does not fit in shared memory: the 256 x 256 f32 middle layer of
// the widest ensemble the repo ships is 256 KB, a block may hold 227 KB. So
// each layer streams its weights through shared memory in tiles of 32
// contraction rows by 256 columns (32 KB), loaded by the whole block with
// neighbouring threads on neighbouring addresses, as gmm.cu stages its
// contraction tiles. The tile's activations stay in shared memory for the
// whole step: X holds [s, a] and then the normalised input, H0 and H1 are
// the ping-pong buffers of the hidden layers, 32 rows by the widest layer
// (32 KB each at width 256). Thread t owns output column t of a 256-column
// pass and keeps its column's sums for all 32 rows of the tile in
// registers (rows the block does not own are computed and dropped, so the
// 32 rows' FMA chains interleave without a branch); it reads a row's
// activations as float4 broadcasts, four FMAs per read. Row strides are
// padded to multiples of 4 with zero weights and zero outputs in the pad,
// so the float4 reads stay aligned and add 0.
//
// What bounds it. At the trainer's shape (B = 64 rows, 5 members of
// 30 -> 256 -> 256 -> 23, policy 23 -> 64 -> 64 -> 7) the step must read
// 5 x 79,639 f32 of member weights and biases (1.59 MB) and 42 KB of
// policy, normaliser, rows and outputs: 0.49 us at 3.35 TB/s, against
// 2 x 64 x 85,120 = 10.9 MFLOP, 0.16 us of f32 FMAs at 67 TFLOP/s. It is
// bound by bytes, and at this shape by far more by latency: ten blocks at
// most, each streaming one member's 318 KB through one SM, a weight tile at
// a time. Each thread reads back only its own column of a staged tile, so
// the next steps are loading the next tile into registers while the
// current one is summed, a split of a layer's columns over a cluster of
// blocks, and keeping a member's weights resident across the horizon.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int BM = 32;          // rows of a tile
constexpr int THREADS = 256;    // one output column per thread per pass
constexpr int KC = 32;          // contraction rows of a staged weight tile
constexpr int MAX_SMEM = 232448;

struct Mlp {
  int n;                        // layers
  int dims[MAX_LAYERS + 1];     // dims[0] in, dims[n] out
  const float* w[MAX_LAYERS];   // (din, dout) row-major, member g at g * w_gs
  const float* b[MAX_LAYERS];   // (dout,), member g at g * b_gs
  long long w_gs[MAX_LAYERS];   // member strides in floats (0: shared)
  long long b_gs[MAX_LAYERS];
};

struct Args {
  const float* s;
  const float* eps;
  const int* offs;
  const float* log_std;
  const float* mu_in;
  const float* sig_in;
  const float* mu_out;
  const float* sig_out;
  float* s2;
  float* a;
  float* pre;
  int B, obs, act;
  int sx;                       // row stride of X
  int sh;                       // row stride of H0, H1
  Mlp pol, dyn;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// out[r][n] = f(sum_k in[r][k] w[k][n] + b[n]) for r < cnt and n < round4
// (dout), f = tanh for a hidden layer; the pad columns come out 0. Reads
// in[r][k] for k < round4(din): the pad holds zeros or finite values that
// meet zero weights. Ends with a barrier, so `out` is ready for every thread.
__device__ void layer(const float* in, int in_stride, int din,
                      const float* __restrict__ w,
                      const float* __restrict__ b, int dout, float* out,
                      int out_stride, int cnt, bool hidden, float* ws) {
  const int t = threadIdx.x;
  const int din4 = round4(din), dout4 = round4(dout);
  for (int n0 = 0; n0 < dout4; n0 += THREADS) {
    const int n = n0 + t;
    const bool col = n < dout;
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < din4; k0 += KC) {
      __syncthreads();  // the last tile's readers are done with ws
      // all 32 loads in flight at once: one memory latency per tile
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const int k = k0 + kk;
        ws[kk * THREADS + t] =
            (col && k < din) ? w[(size_t)k * dout + n] : 0.f;
      }
      __syncthreads();
      const int kend = min(KC, din4 - k0);
      for (int kk = 0; kk < kend; kk += 4) {
        const float w0 = ws[kk * THREADS + t];
        const float w1 = ws[(kk + 1) * THREADS + t];
        const float w2 = ws[(kk + 2) * THREADS + t];
        const float w3 = ws[(kk + 3) * THREADS + t];
        // every row of the tile, not only the block's cnt: a branch per
        // row would keep the rows' FMA chains from interleaving. Rows past
        // cnt read buffer rows holding zeros or stale values, and their
        // sums are never written out.
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float4 h = *reinterpret_cast<const float4*>(
              in + r * in_stride + k0 + kk);
          acc[r] = fmaf(h.x, w0, acc[r]);
          acc[r] = fmaf(h.y, w1, acc[r]);
          acc[r] = fmaf(h.z, w2, acc[r]);
          acc[r] = fmaf(h.w, w3, acc[r]);
        }
      }
    }
    if (n < dout4) {
      const float bias = col ? b[n] : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        if (r < cnt) {
          const float v = acc[r] + bias;
          out[r * out_stride + n] = hidden ? tanhf(v) : v;
        }
      }
    }
  }
  __syncthreads();
}

// Runs an MLP on the block's rows: X -> H0 -> H1 -> H0 ...; returns the
// buffer holding its output (row stride p.sh).
__device__ const float* mlp(const Args& p, const Mlp& m, int g,
                            const float* X, float* H0, float* H1, int cnt,
                            float* ws) {
  const float* in = X;
  int stride = p.sx;
  for (int l = 0; l < m.n; ++l) {
    float* out = (l & 1) ? H1 : H0;
    layer(in, stride, m.dims[l], m.w[l] + g * m.w_gs[l],
          m.b[l] + g * m.b_gs[l], m.dims[l + 1], out, p.sh, cnt,
          l < m.n - 1, ws);
    in = out;
    stride = p.sh;
  }
  return in;
}

// grid (ceil(B / BM), K); dynamic shared memory: X, H0, H1, ws
__global__ void __launch_bounds__(THREADS) imag_fused_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // BM x sx
  float* H0 = X + BM * p.sx;                   // BM x sh
  float* H1 = H0 + BM * p.sh;                  // BM x sh
  float* ws = H1 + BM * p.sh;                  // KC x THREADS
  const int g = blockIdx.y;
  const int tile0 = blockIdx.x * BM;
  const int lo = max(p.offs[g], tile0);
  const int hi = min(min(p.offs[g + 1], tile0 + BM), p.B);
  const int cnt = hi - lo;
  if (cnt <= 0) return;  // member g owns no row of this tile
  const int t = threadIdx.x;
  const int din = p.obs + p.act;

  for (int i = t; i < BM * p.sx; i += THREADS) {  // X = [s, 0], zero pad
    const int r = i / p.sx, c = i % p.sx;
    X[i] = (r < cnt && c < p.obs) ? p.s[(size_t)(lo + r) * p.obs + c] : 0.f;
  }
  __syncthreads();

  // policy head, then the reparameterised sample; a goes beside s in X
  const float* mu = mlp(p, p.pol, 0, X, H0, H1, cnt, ws);
  for (int i = t; i < cnt * p.act; i += THREADS) {
    const int r = i / p.act, j = i % p.act;
    const size_t o = (size_t)(lo + r) * p.act + j;
    const float pr = mu[r * p.sh + j] + expf(p.log_std[j]) * p.eps[o];
    const float av = tanhf(pr);
    p.pre[o] = pr;
    p.a[o] = av;
    X[r * p.sx + p.obs + j] = av;
  }
  __syncthreads();
  for (int i = t; i < cnt * din; i += THREADS) {  // normalise [s, a]
    const int r = i / din, c = i % din;
    X[r * p.sx + c] = (X[r * p.sx + c] - p.mu_in[c]) / p.sig_in[c];
  }
  __syncthreads();

  // member g's MLP, then the denormalised next state
  const float* dyn = mlp(p, p.dyn, g, X, H0, H1, cnt, ws);
  for (int i = t; i < cnt * p.obs; i += THREADS) {
    const int r = i / p.obs, j = i % p.obs;
    const size_t o = (size_t)(lo + r) * p.obs + j;
    p.s2[o] = p.s[o] + dyn[r * p.sh + j] * p.sig_out[j] + p.mu_out[j];
  }
}

bool fill(Mlp* m, int n, const int* dims, const float* const* w,
          const float* const* b, long long stride_members) {
  if (n < 1 || n > MAX_LAYERS) return false;
  m->n = n;
  for (int l = 0; l <= n; ++l) m->dims[l] = dims[l];
  for (int l = 0; l < n; ++l) {
    m->w[l] = w[l];
    m->b[l] = b[l];
    m->w_gs[l] = stride_members ? (long long)dims[l] * dims[l + 1] : 0;
    m->b_gs[l] = stride_members ? dims[l + 1] : 0;
  }
  return true;
}

}  // namespace

// One fused step on B member-sorted rows. pol_w[l] (pol_dims[l],
// pol_dims[l + 1]) and pol_b[l] are the policy's layers; dyn_w[l]
// (K, dyn_dims[l], dyn_dims[l + 1]) and dyn_b[l] (K, dyn_dims[l + 1]) the
// members', all contiguous. offs: (K + 1) int32 on the device, offs[K] == B.
// Returns a cudaError_t.
extern "C" int imag_fused_step(
    const float* s, const float* eps, const int* offs, int n_pol,
    const int* pol_dims, const float* const* pol_w, const float* const* pol_b,
    int n_dyn, const int* dyn_dims, const float* const* dyn_w,
    const float* const* dyn_b, const float* log_std, const float* mu_in,
    const float* sig_in, const float* mu_out, const float* sig_out,
    float* s2, float* a, float* pre, int B, int K, void* stream) {
  Args p{};
  if (!fill(&p.pol, n_pol, pol_dims, pol_w, pol_b, 0) ||
      !fill(&p.dyn, n_dyn, dyn_dims, dyn_w, dyn_b, 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  p.s = s;
  p.eps = eps;
  p.offs = offs;
  p.log_std = log_std;
  p.mu_in = mu_in;
  p.sig_in = sig_in;
  p.mu_out = mu_out;
  p.sig_out = sig_out;
  p.s2 = s2;
  p.a = a;
  p.pre = pre;
  p.B = B;
  p.obs = dyn_dims[n_dyn];
  p.act = pol_dims[n_pol];
  p.sx = round4(p.obs + p.act);
  int widest = 4;
  for (int l = 1; l <= n_pol; ++l)
    if (round4(pol_dims[l]) > widest) widest = round4(pol_dims[l]);
  for (int l = 1; l <= n_dyn; ++l)
    if (round4(dyn_dims[l]) > widest) widest = round4(dyn_dims[l]);
  p.sh = widest;
  const size_t bytes =
      sizeof(float) * ((size_t)BM * (p.sx + 2 * p.sh) + (size_t)KC * THREADS);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // above 48 KB a block's dynamic shared memory must be granted, once per
  // device; granting it is not a stream operation
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > 48 * 1024 && (dev >= 64 || bytes > granted[dev])) {
    err = cudaFuncSetAttribute(imag_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) granted[dev] = bytes;
  }
  dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)K);
  imag_fused_kernel<<<grid, THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* imag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
