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
// and writes (s2, a, pre), f32 in and out, to f32 accuracy (no single TF32
// pass). Member g owns the sorted rows [offs[g], offs[g + 1]).
//
// What bounds it. At the trainer's shape (B = 64 rows, 5 members of
// 30 -> 256 -> 256 -> 23, policy 23 -> 64 -> 64 -> 7) the step must read
// 5 x 79,639 f32 of member weights and biases (1.59 MB) and 42 KB of
// policy, normaliser, rows and outputs: 0.49 us at 3.35 TB/s, against
// 2 x 64 x 85,120 = 10.9 MFLOP, 0.16 us of f32 FMAs at 67 TFLOP/s. It is
// bound by bytes, and in practice by latency: a member's 318 KB must reach
// the SMs and pass three dependent layers in a few microseconds.
//
// Design. The TPU kernel's grid (B / bm, K) walks the members of a row
// block in order, carrying the normalised input and an accumulator in VMEM,
// and streams each member's weights through one core. Here a member's rows
// are cut into tiles of `rows` (16 or 32) sorted rows, and each tile is
// taken by a thread-block cluster of `cluster` (<= 8, the portable size)
// blocks on neighbouring SMs, so a member's weights pass through up to
// eight SMs at once:
// * Weights loaded once. Block r of a cluster owns 1/cluster of every
//   member layer's output columns (a multiple of 8). At its start it issues
//   cp.async copies of the whole policy and of its column slice of every
//   member layer (32 KB of the 256 x 256 layer at cluster 8) into its own
//   shared memory, one commit group a layer, so the later layers arrive
//   while the policy head and the first layer run. Copies are 16 bytes
//   where a layer's rows are whole 16-byte chunks, else 4 (the 23- and
//   7-wide layers), zero-filled past every edge. The grid is (row_clusters
//   x cluster, K): cluster q of member g takes the member's tiles q,
//   q + row_clusters, ..., so a cluster that takes several tiles loads its
//   weights once for all of them.
// * Policy head once per row, split by rows: block r runs the whole policy
//   (loaded by every block) on the tile rows i with i % cluster == r and
//   writes their pre and a.
// * Exchange through distributed shared memory, by pushing: a block writes
//   its rows of xn, and then its columns of each hidden member layer, into
//   every block's full-width copy (its own included), then the cluster
//   barrier; the next layer reads its own copy. Hidden layers alternate
//   between two buffers. Every remote write comes after a barrier that its
//   target passes only once it has read what the write replaces, and
//   before a barrier that the target waits for, so no block is written
//   after it exits. The last layer's columns go straight to s2.
// * Empty members. All blocks of a cluster read the same offsets, so a
//   cluster whose member has fewer tiles than its index exits as a whole,
//   before any cluster barrier.
// * Arithmetic, f32-accurate. The hidden member layers run on the tensor
//   cores in 3xTF32: a tile's 16 rows are the M side of mma.sync.m16n8k8
//   (32 rows, two), a block's columns the N side in tiles of 8, two a
//   warp; the (row tile, column pair) units are spread over the 8 warps,
//   with the
//   contraction split between warps when there are fewer units than warps,
//   the partial sums added through shared memory. Each operand x is split
//   into big = tf32(x) and small = tf32(x - big), and every step
//   accumulates small*big, big*small and big*big in f32: the dropped
//   small*small term leaves ~2^-21 relative a product, where one TF32 pass
//   leaves ~2^-11. The weights are read once a row tile, not once a row.
//   The policy layers (a few own rows) and the thin last layer, whose
//   outputs are too few to fill mma tiles, are f32 dot products on the
//   CUDA cores, one output a thread. Activation rows have an odd multiple
//   of 4 floats as stride and weight rows 8 or 24 mod 32, so fragment
//   reads fall on 32 distinct banks; contraction extents are padded to 8
//   with zero weights.
// The planner in ../cuda.py picks rows, cluster and row_clusters from B, K
// and the widths, and its shared-memory size is the one computed here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_ROWS = 32;
constexpr int MAX_SMEM = 232448;

struct Mlp {
  int n;                        // layers
  int dims[MAX_LAYERS + 1];     // dims[0] in, dims[n] out
  const float* w[MAX_LAYERS];   // (din, dout) row-major, member g at g * w_gs
  const float* b[MAX_LAYERS];   // (dout,), member g at g * b_gs
  long long w_gs[MAX_LAYERS];   // member strides in floats (0: shared)
  long long b_gs[MAX_LAYERS];
  // shared memory: layer l's weights [round8(din)][ldw[l]] at w_at[l] and
  // bias [ld[l]] at b_at[l], in floats; the policy whole (ld = round8(dout)),
  // a member layer as one block's column slice (ld = its slice width)
  int ld[MAX_LAYERS];
  int ldw[MAX_LAYERS];
  int w_at[MAX_LAYERS];
  int b_at[MAX_LAYERS];
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
  int obs, act;
  int rows;                     // rows of a tile
  int cluster;                  // blocks of a cluster
  int row_clusters;             // clusters of a member
  int sx;                       // row stride of X and Pin: round8(obs + act)
  int sh;                       // row stride of H0, H1: the widest cluster
                                // x slice of a hidden member layer
  int sp;                       // row stride of P0, P1: the widest policy
                                // layer (each by stride4)
  // buffers in shared memory (floats): X (rows x sx) xn of every row; H0,
  // H1 (rows x sh) the hidden member layers; P0, P1 the policy's
  // activations of the own rows, P0 then the last member layer's own
  // columns of every row; Pin (own rows x sx) their [s, a]; red the
  // partial sums of a split contraction
  int x_at, h0_at, h1_at, p0_at, p1_at, pin_at, red_at;
  Mlp pol, dyn;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// an activation row stride: round4(x), plus 4 if that is a multiple of 8,
// so the 8 rows of an A fragment fall on distinct banks
__host__ __device__ inline int stride4(int x) {
  const int r = round4(x);
  return r % 8 ? r : r + 4;
}
// the row stride of a weight tile ld wide: 8 or 24 mod 32, so the 32 lanes
// of a B fragment (row lane % 4, column lane / 4) read distinct banks
__host__ __device__ inline int weight_stride(int ld) {
  return ld % 16 ? ld : ld + 8;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or a zero if !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// wait until at most n of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::); break;
    default: asm volatile("cp.async.wait_group 8;\n" ::); break;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Columns [c0, c0 + ld) of layer l's (din, dout) row-major weight (of
// member g) into a [round8(din)][ldw] tile, and the same columns of its
// bias into [ld], zeros past din and dout: 16-byte copies when dout and
// the pointers allow them (c0 and ld are multiples of 8), else 4-byte.
__device__ void load_slice(float* ws, float* bs, const Mlp& m, int l, int g,
                           int c0) {
  const float* w = m.w[l] + g * m.w_gs[l];
  const float* b = m.b[l] + g * m.b_gs[l];
  const int din = m.dims[l], dout = m.dims[l + 1], ld = m.ld[l];
  const int ldw = m.ldw[l], din8 = round8(din);
  const bool vec = dout % 4 == 0 && aligned16(w) && aligned16(b);
  const int step = vec ? 4 : 1;
  // element (k, n) of the tile, row din8 being the bias, THREADS copies a
  // pass, without a division each
  const int per_row = ld / step, dk = THREADS / per_row,
            dn = THREADS % per_row * step;
  int k = threadIdx.x / per_row, n = threadIdx.x % per_row * step;
  while (k <= din8) {
    const bool ok = (k < din || k == din8) && c0 + n < dout;
    float* dst = k < din8 ? ws + k * ldw + n : bs + n;
    const float* src = !ok ? w : k < din8 ? w + (size_t)k * dout + c0 + n
                                          : b + c0 + n;
    if (vec)
      cp_async16(dst, src, ok);
    else
      cp_async4(dst, src, ok);
    k += dk;
    n += dn;
    if (n >= ld) {
      n -= ld;
      ++k;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[m * sout + n] = f(bias[n] + sum_k in[m * sin + k] w[k * ldw + n]) for
// m < rows, n < ld, k < round8(din), one output a thread, four partial
// sums; f = tanh for a hidden layer.
__device__ __forceinline__ void dense_dot(const float* in, int sin, int din,
                                          const float* w, int ldw,
                                          const float* bias, int ld,
                                          float* out, int sout, int rows,
                                          bool hidden) {
  const int din8 = round8(din);
  for (int o = threadIdx.x; o < rows * ld; o += THREADS) {
    const int m = o / ld, n = o % ld;
    const float* h = in + m * sin;
    const float* wn = w + n;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int k = 0; k < din8; k += 4) {
      a0 = fmaf(h[k], wn[k * ldw], a0);
      a1 = fmaf(h[k + 1], wn[(k + 1) * ldw], a1);
      a2 = fmaf(h[k + 2], wn[(k + 2) * ldw], a2);
      a3 = fmaf(h[k + 3], wn[(k + 3) * ldw], a3);
    }
    const float v = ((a0 + a1) + (a2 + a3)) + bias[n];
    out[m * sout + n] = hidden ? tanhf(v) : v;
  }
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

// tanh(bias[n] + sum_k in[m * sin + k] w[k * ldw + n]) for m < rows, n < ld,
// k < round8(din), in 3xTF32 mma tiles (see the header), written to row m,
// column c0 + n of `out` (row stride sout) in every block of the cluster.
// A unit is 16 rows by two 8-column tiles (one if ld is an odd number of
// tiles): the two share each A fragment and give the warp six independent
// accumulators. Rows past `rows` read a real row and are not written.
// Columns past the layer's own come out tanh(0) = 0: their weights and
// biases are zero. red: WARPS x 256 floats of partial sums. Every thread
// of the block must call it; it ends with the block's barrier.
__device__ __forceinline__ void dense_tc(const float* in, int sin, int din,
                                         const float* w, int ldw,
                                         const float* bias, int ld,
                                         float* out, int sout, int c0,
                                         int rows, float* red,
                                         cg::cluster_group& cluster) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int tiles_n = ld / 8, pair = tiles_n % 2 ? 1 : 2;
  const int nu = tiles_n / pair, units = cdiv(rows, 16) * nu;
  const int ksteps = cdiv(din, 8);
  int split = 1;
  while (2 * split * units <= WARPS && 2 * split <= ksteps) split *= 2;
  const int part = warp % split;
  const int nblocks = (int)cluster.num_blocks();
  for (int u0 = 0; u0 < units; u0 += WARPS / split) {
    const int unit = u0 + warp / split;
    const bool live = unit < units && rows > 0;
    const int m0 = live ? unit / nu * 16 : 0;
    const int n0 = live ? unit % nu * 8 * pair : 0;
    const int r0 = m0 + gid, r1 = r0 + 8;
    float acc[2][3][4] = {};
    if (live) {
      const float* a0p = in + min(r0, rows - 1) * sin + tig;
      const float* a1p = in + min(r1, rows - 1) * sin + tig;
      const float* bp = w + tig * ldw + n0 + gid;
      for (int ks = part; ks < ksteps; ks += split) {
        const int k0 = ks * 8;
        unsigned ab[4], as[4];
        split_tf32(a0p[k0], ab[0], as[0]);
        split_tf32(a1p[k0], ab[1], as[1]);
        split_tf32(a0p[k0 + 4], ab[2], as[2]);
        split_tf32(a1p[k0 + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= pair) break;
          unsigned bb[2], bs[2];
          split_tf32(bp[k0 * ldw + 8 * j], bb[0], bs[0]);
          split_tf32(bp[(k0 + 4) * ldw + 8 * j], bb[1], bs[1]);
          mma_tf32(acc[j][0], as, bb);
          mma_tf32(acc[j][1], ab, bs);
          mma_tf32(acc[j][2], ab, bb);
        }
      }
    }
    float v[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = (acc[j][0][e] + acc[j][1][e]) + acc[j][2][e];
    if (split > 1) {  // the unit's first warp adds the others' partials
      if (part != 0)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((warp * 2 + j) * 32 + lane) * 4 + e] = v[j][e];
      __syncthreads();
      if (part == 0)
        for (int q = 1; q < split; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[j][e] += red[(((warp + q) * 2 + j) * 32 + lane) * 4 + e];
    }
    if (live && part == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= pair) break;
        const int n = n0 + 8 * j + 2 * tig;
        const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r1 : r0;
          if (r >= rows) continue;
          const float2 x = make_float2(tanhf(v[j][2 * h] + b0),
                                       tanhf(v[j][2 * h + 1] + b1));
          float* at = out + r * sout + c0 + n;
          for (int q = 0; q < nblocks; ++q)
            *reinterpret_cast<float2*>(cluster.map_shared_rank(at, q)) = x;
        }
      }
    }
    __syncthreads();  // red is free again
  }
}

// grid (row_clusters * cluster, K), cluster (cluster, 1, 1)
__global__ void __launch_bounds__(THREADS) imag_fused_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* X = sm + p.x_at;
  float* Pin = sm + p.pin_at;
  float* red = sm + p.red_at;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.x / c;
  const int g = blockIdx.y;
  const int start = p.offs[g], end = p.offs[g + 1];
  const int tiles = cdiv(end - start, p.rows);
  if (q >= tiles) return;  // the whole cluster: it has read the same offsets
  const int t = threadIdx.x;
  const int obs = p.obs, act = p.act, din = obs + act, sx = p.sx;
  const int np = p.pol.n, nd = p.dyn.n;

  // every block: the whole policy, then its slice of each member layer,
  // a commit group each
  for (int l = 0; l < np; ++l)
    load_slice(sm + p.pol.w_at[l], sm + p.pol.b_at[l], p.pol, l, 0, 0);
  for (int l = 0; l < nd; ++l)
    load_slice(sm + p.dyn.w_at[l], sm + p.dyn.b_at[l], p.dyn, l, g,
               rank * p.dyn.ld[l]);

  for (int tile = q; tile < tiles; tile += p.row_clusters) {
    const int lo = start + tile * p.rows;
    const int cnt = min(p.rows, end - lo);
    const int mine = rank < cnt ? cdiv(cnt - rank, c) : 0;
    // with one member layer no barrier separates its reads of X from the
    // next tile's writes
    if (tile != q && nd == 1) cluster.sync();
    for (int e = t; e < mine * sx; e += THREADS) {  // [s, 0] of own rows
      const int m = e / sx, col = e % sx;
      Pin[m * sx + col] =
          col < obs ? p.s[(size_t)(lo + rank + m * c) * obs + col] : 0.f;
    }
    cp_async_wait(nd);  // the policy is in
    __syncthreads();

    // policy head on the own rows, then the sample; a goes beside s
    const float* in = Pin;
    int sin = sx;
    for (int l = 0; l < np; ++l) {
      float* out = sm + (l & 1 ? p.p1_at : p.p0_at);
      dense_dot(in, sin, p.pol.dims[l], sm + p.pol.w_at[l], p.pol.ldw[l],
                sm + p.pol.b_at[l], p.pol.ld[l], out, p.sp, mine,
                l < np - 1);
      __syncthreads();
      in = out;
      sin = p.sp;
    }
    for (int e = t; e < mine * act; e += THREADS) {
      const int m = e / act, j = e % act;
      const size_t o = (size_t)(lo + rank + m * c) * act + j;
      const float pr = in[m * p.sp + j] + expf(p.log_std[j]) * p.eps[o];
      const float av = tanhf(pr);
      p.pre[o] = pr;
      p.a[o] = av;
      Pin[m * sx + obs + j] = av;
    }
    __syncthreads();
    // xn of the own rows into every block's X
    for (int e = t; e < mine * sx; e += THREADS) {
      const int m = e / sx, col = e % sx;
      const float x =
          col < din ? (Pin[m * sx + col] - p.mu_in[col]) / p.sig_in[col] : 0.f;
      float* at = X + (rank + m * c) * sx + col;
      for (int r = 0; r < c; ++r) *cluster.map_shared_rank(at, r) = x;
    }
    cluster.sync();  // every row's xn is in every block

    // member g's layers, each on this block's columns of every row
    in = X;
    sin = sx;
    for (int l = 0; l < nd; ++l) {
      const int ld = p.dyn.ld[l], c0 = rank * ld;
      cp_async_wait(nd - 1 - l);  // this layer's slice is in
      __syncthreads();
      if (l == nd - 1) {  // the denormalised next state, own columns
        float* out = sm + p.p0_at;
        dense_dot(in, sin, p.dyn.dims[l], sm + p.dyn.w_at[l], p.dyn.ldw[l],
                  sm + p.dyn.b_at[l], ld, out, ld, cnt, false);
        __syncthreads();
        for (int e = t; e < cnt * ld; e += THREADS) {
          const int i = e / ld, j = c0 + e % ld;
          if (j >= obs) continue;
          const size_t o = (size_t)(lo + i) * obs + j;
          p.s2[o] = p.s[o] + out[e] * p.sig_out[j] + p.mu_out[j];
        }
        __syncthreads();  // P0 is read before the next tile's policy
        break;
      }
      float* out = sm + (l & 1 ? p.h1_at : p.h0_at);
      dense_tc(in, sin, p.dyn.dims[l], sm + p.dyn.w_at[l], p.dyn.ldw[l],
               sm + p.dyn.b_at[l], ld, out, p.sh, c0, cnt, red, cluster);
      cluster.sync();  // every block's columns of this layer are in
      in = out;
      sin = p.sh;
    }
  }
}

// Fill m's dimensions and shared-memory layout from offset `at` (floats);
// returns the offset past it, or -1 if m has no layers or too many. w and
// b may be null when only the layout is asked for.
int fill(Mlp* m, int n, const int* dims, const float* const* w,
         const float* const* b, bool members, int cluster, int at) {
  if (n < 1 || n > MAX_LAYERS) return -1;
  m->n = n;
  for (int l = 0; l <= n; ++l) m->dims[l] = dims[l];
  for (int l = 0; l < n; ++l) {
    m->w[l] = w ? w[l] : nullptr;
    m->b[l] = b ? b[l] : nullptr;
    m->w_gs[l] = members ? (long long)dims[l] * dims[l + 1] : 0;
    m->b_gs[l] = members ? dims[l + 1] : 0;
    m->ld[l] = members ? round8(cdiv(dims[l + 1], cluster))
                       : round8(dims[l + 1]);
    m->ldw[l] = weight_stride(m->ld[l]);
    m->w_at[l] = at;
    at += round8(dims[l]) * m->ldw[l];
    m->b_at[l] = at;
    at += m->ld[l];
  }
  return at;
}

// The widths, plan and shared-memory layout of p; returns the dynamic
// shared memory a block needs in bytes, or -1 for a plan or depth the
// kernel does not take.
long long layout(Args* p, int n_pol, const int* pol_dims,
                 const float* const* pol_w, const float* const* pol_b,
                 int n_dyn, const int* dyn_dims, const float* const* dyn_w,
                 const float* const* dyn_b, int rows, int cluster) {
  if (rows < 1 || rows > MAX_ROWS || cluster < 1 || cluster > MAX_CLUSTER)
    return -1;
  int at = fill(&p->pol, n_pol, pol_dims, pol_w, pol_b, false, cluster, 0);
  if (at >= 0)
    at = fill(&p->dyn, n_dyn, dyn_dims, dyn_w, dyn_b, true, cluster, at);
  if (at < 0) return -1;
  p->obs = dyn_dims[n_dyn];
  p->act = pol_dims[n_pol];
  p->rows = rows;
  p->cluster = cluster;
  p->sx = stride4(round8(p->obs + p->act));
  int widest = 4;
  for (int l = 0; l < n_dyn - 1; ++l)
    if (cluster * p->dyn.ld[l] > widest) widest = cluster * p->dyn.ld[l];
  p->sh = stride4(widest);
  widest = 4;
  for (int l = 1; l <= n_pol; ++l)
    if (round8(pol_dims[l]) > widest) widest = round8(pol_dims[l]);
  p->sp = stride4(widest);
  const int own = cdiv(rows, cluster);
  int p0_size = own * p->sp;
  if (rows * p->dyn.ld[n_dyn - 1] > p0_size)
    p0_size = rows * p->dyn.ld[n_dyn - 1];
  p->x_at = at;
  p->h0_at = p->x_at + rows * p->sx;
  p->h1_at = p->h0_at + rows * p->sh;
  p->p0_at = p->h1_at + rows * p->sh;
  p->p1_at = p->p0_at + p0_size;
  p->pin_at = p->p1_at + own * p->sp;
  p->red_at = p->pin_at + own * p->sx;
  return (long long)sizeof(float) * (p->red_at + WARPS * 2 * 32 * 4);
}

}  // namespace

// The dynamic shared memory, in bytes, that a block of imag_fused_step
// needs for these widths and plan (-1 if the kernel does not take them).
extern "C" long long imag_smem_bytes(int n_pol, const int* pol_dims,
                                     int n_dyn, const int* dyn_dims,
                                     int rows, int cluster) {
  Args p{};
  return layout(&p, n_pol, pol_dims, nullptr, nullptr, n_dyn, dyn_dims,
                nullptr, nullptr, rows, cluster);
}

// One fused step on B member-sorted rows. pol_w[l] (pol_dims[l],
// pol_dims[l + 1]) and pol_b[l] are the policy's layers; dyn_w[l]
// (K, dyn_dims[l], dyn_dims[l + 1]) and dyn_b[l] (K, dyn_dims[l + 1]) the
// members', all contiguous. offs: (K + 1) int32 on the device, offs[K] == B.
// rows (<= 32), cluster (1..8) and row_clusters: the launch plan of
// ../cuda.py's planner. Returns a cudaError_t; cudaErrorInvalidValue for a
// plan outside those ranges or whose shared memory exceeds a block's.
extern "C" int imag_fused_step(
    const float* s, const float* eps, const int* offs, int n_pol,
    const int* pol_dims, const float* const* pol_w, const float* const* pol_b,
    int n_dyn, const int* dyn_dims, const float* const* dyn_w,
    const float* const* dyn_b, const float* log_std, const float* mu_in,
    const float* sig_in, const float* mu_out, const float* sig_out,
    float* s2, float* a, float* pre, int B, int K, int rows, int cluster,
    int row_clusters, void* stream) {
  Args p{};
  const long long bytes = layout(&p, n_pol, pol_dims, pol_w, pol_b, n_dyn,
                                 dyn_dims, dyn_w, dyn_b, rows, cluster);
  if (bytes < 0 || bytes > MAX_SMEM || row_clusters < 1 || K > 65535 ||
      (long long)row_clusters * cluster > 0x7fffffffLL)
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
  p.row_clusters = row_clusters;
  // above 48 KB a block's dynamic shared memory must be granted, once per
  // device; granting it is not a stream operation
  static size_t granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > 48 * 1024 && (dev >= 64 || (size_t)bytes > granted[dev])) {
    err = cudaFuncSetAttribute(imag_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) granted[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(row_clusters * cluster), (unsigned)K, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, imag_fused_kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* imag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
