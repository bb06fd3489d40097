// Log-domain Sinkhorn projection for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel hvs_tpu/ops/pallas/sinkhorn_pallas.py::sinkhorn_log_pallas
// (kernel body _sinkhorn_kernel). Per [n, n] fp32 matrix, with x = logits / tau
// and K iterations:
//
//   g_0 = 0
//   for k = 1..K:  f_k = -LSE_j(x_ij + g_{k-1,j})     (row pass)
//                  g_k = -LSE_i(x_ij + f_k,i)         (column pass)
//   f_{K+1} = -LSE_j(x_ij + g_K,j)                    (exact row sums)
//   P = exp(x + f_{K+1} + g_K)
//
// The forward can store every potential (f_1..f_{K+1}, g_0..g_K: 2(K+1)·n
// floats per matrix, 86 KB at n = 512) in a history tensor the wrapper
// allocates. The backward is the gradient of the UNROLLED loop (what jax.grad
// of sinkhorn_log gives, not the implicit fixed-point gradient). It walks the
// passes in reverse and rebuilds each pass's softmax weights exp(x + f + g)
// from the stored potentials:
//
//   dF_i   = sum_j dP_ij P_ij                     dx  = P (dP - dF)
//   dg_K   = sum_i P_ij (dP_ij - dF_i)
//   for k = K..1:
//     B = exp(x + f_k + g_k):      dx -= dg_j B_ij,   df_k,i = -sum_j dg_j B_ij
//     A = exp(x + f_k + g_{k-1}):  dx -= df_i A_ij,   dg_{k-1},j = -sum_i df_i A_ij
//   dlogits = dx / tau
//
// Base 2. Both kernels work on x2 = x·log2(e) = logits·(log2(e) / tau) and on
// base-2 potentials f2 = f·log2(e), g2 = g·log2(e), so that every weight is
// one exp2f (the SFU's ex2): exp(x + f + g) = exp2(x2 + f2 + g2). The history
// holds these base-2 potentials. No other fast math: exp2f and log2f are the
// accurate library versions.
//
// What bounds it on an H100: 2K+2 dependent passes over the matrix (2K in the
// backward), each a reduction along rows or columns with one exponential per
// element. Per matrix the forward does ~(2K+2)·n² exponentials (the SFU
// issues 16 a clock per SM) against 8·n² bytes of device memory (x in, P
// out), so the work is bound by the exponentials, and a matrix has to be
// spread over several SMs for the passes to come near that bound.
//
// Design, for n <= 512 (kClusterMaxN): a thread-block cluster per matrix.
//   * One launch takes a batch of same-width matrices; each is worked on by a
//     cluster of C blocks (C per launch, cudaLaunchKernelEx with a cluster
//     dimension). Block r of the cluster owns rows [r·R, (r+1)·R), R =
//     ceil(n / C), and holds them in shared memory: x2 in the forward, x2 and
//     dx in the backward. Each is read from device memory once and written
//     once; between passes nothing leaves the chip.
//   * Row passes stay inside each block: a warp per row, lanes along the
//     row, the lane's potentials in registers; the row max by shuffles, then
//     one exp2f per element.
//   * Column passes: one thread per (column, row group) loops over the
//     block's rows with a chunked online log-sum-exp (one exp2f per element
//     and one per chunk of 8). Each block leaves its (max, sum) partials in
//     its shared memory; after one cluster barrier every block reads all C
//     blocks' partials through distributed shared memory and merges them in
//     the same order, so every block holds the same, whole g. The partials
//     are double-buffered, so one cluster barrier per column pass is enough.
//     The backward's column sums (dg) follow the same pattern; its row sums
//     (df) stay local.
//   * The caller gives C (1 to 16; 16 is a non-portable size). The wrapper
//     (hvs_tpu_torch/ops/sinkhorn.py, cluster_size) takes the largest C with
//     at least 8 rows per block whose clusters for the whole batch the card
//     holds at once, which the sweep of scripts/torch_sinkhorn_clusters.py
//     found fastest at every width of the flagship (PERF.md): C = 4, 8, 16,
//     8, 16 at n = 32, 64, 128, 256 (15 matrices), 512, in both directions.
//     The x2 slab (plus dx in the backward) must fit the 227 KB a block may
//     use: C >= 8 for the forward at 512, 16 for its backward. Uneven splits
//     mask the last block's rows.
// Above 512 a matrix does not fit even a 16-block cluster (4 MB at 1024), so
// n in (512, 1024] takes the streamed kernels below: one block of 512 threads
// per matrix, every pass re-reading x from L2, the backward accumulating dx
// in place in the output tensor. The rule is by n alone, not a fallback.
//
// Launches allocate nothing and do not synchronise with the host, so they can
// be captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr int kClusterMaxN = 512;  // cluster kernels up to this n, streamed above
constexpr int kMaxPartials = 16;   // cluster blocks x row groups merged per column
constexpr int kChunk = 8;          // rows per online-LSE step in a column pass
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr float kLog2e = 1.4426950408889634f;

// How a cluster of C blocks splits an [n, n] matrix: R rows per block, and
// G row groups per column in a column pass (G·n threads take part, each
// loops over at least 8 rows, and C·G partials are merged per column).
struct Split {
  int c, rows_per, groups;
};

__host__ __device__ inline Split make_split(int n, int c) {
  Split s;
  s.c = c;
  s.rows_per = (n + c - 1) / c;
  int g = kThreads / n;
  if (g > s.rows_per / 8) g = s.rows_per / 8;
  if (g > kMaxPartials / c) g = kMaxPartials / c;
  s.groups = g < 1 ? 1 : g;
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Barrier over every thread of the cluster, releasing this block's shared
// memory writes to the others and acquiring theirs. The column pass before
// each exchange leaves a warp partly idle when G·n is not a multiple of 32;
// the warp is reconverged first, and the barrier is the form without
// .aligned (cluster.sync() of cooperative_groups issues .aligned).
__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release;\n" : : : "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" : : : "memory");
}

// __syncthreads() after a phase that may leave a warp partly idle (rows or
// columns not a multiple of 32): the warp is reconverged first.
__device__ __forceinline__ void block_barrier() {
  __syncwarp();
  __syncthreads();
}

// The block's place in its cluster and its slab of rows.
struct Slab {
  int rank, row0, rows;
};

__device__ __forceinline__ Slab block_slab(const cg::cluster_group& cluster, const Split& s,
                                           int n) {
  Slab b;
  b.rank = static_cast<int>(cluster.block_rank());
  b.row0 = b.rank * s.rows_per;
  const int end = min(n, b.row0 + s.rows_per);
  b.rows = max(0, end - b.row0);
  return b;
}

// dst_i = -LSE2_j(x2_ij + g2_j) for the block's rows, a warp per row; lane
// holds columns lane + 32c (c < CPL). Also into hrow (global) if given.
template <int CPL>
__device__ void row_lse(const float* xs, const float* gs, float* fs, float* hrow, int n,
                        int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) g[c] = lane + 32 * c < n ? gs[lane + 32 * c] : 0.0f;
  for (int il = warp; il < rows; il += kWarps) {
    const float* xr = xs + size_t(il) * n;
    float v[CPL];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      v[c] = lane + 32 * c < n ? xr[lane + 32 * c] + g[c] : -INFINITY;
      mx = fmaxf(mx, v[c]);
    }
    mx = warp_max(mx);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (lane + 32 * c < n) s += exp2f(v[c] - mx);
    s = warp_sum(s);
    if (lane == 0) {
      const float val = -(mx + log2f(s));
      fs[il] = val;
      if (hrow) hrow[il] = val;
    }
  }
}

// Column (max, sum) partials of x2_ij + f2_i over the block's rows: thread t
// < G·n takes column t % n and rows t / n, t / n + G, ...; part[t] = (m, s).
__device__ void col_partials(const float* xs, const float* fs, float2* part, int n, int rows,
                             int groups) {
  const int t = threadIdx.x;
  if (t >= groups * n) return;
  const int j = t % n;
  float m = -INFINITY, s = 0.0f;
  for (int i0 = t / n; i0 < rows; i0 += groups * kChunk) {
    float v[kChunk];
    float cm = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int i = i0 + c * groups;
      v[c] = i < rows ? xs[size_t(i) * n + j] + fs[i] : -INFINITY;
      cm = fmaxf(cm, v[c]);
    }
    const float nm = fmaxf(m, cm);
    s *= exp2f(m - nm);
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (i0 + c * groups < rows) s += exp2f(v[c] - nm);
    m = nm;
  }
  part[t] = make_float2(m, s);
}

// g2_j = -LSE2 over the C·G partials of column j in every block of the
// cluster (read through distributed shared memory, merged in rank order, so
// every block computes the same value). Also into hrow if given.
__device__ void col_merge(const cg::cluster_group& cluster, float2* part, const Split& sp,
                          int n, float* gs, float* hrow) {
  const int j = threadIdx.x;
  if (j >= n) return;
  const int total = sp.c * sp.groups;
  float2 p[kMaxPartials];
#pragma unroll
  for (int q = 0; q < kMaxPartials; ++q) {
    if (q < total) {
      const float2* rp = cluster.map_shared_rank(part, q / sp.groups);
      p[q] = rp[(q % sp.groups) * n + j];
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxPartials; ++q)
    if (q < total) mx = fmaxf(mx, p[q].x);
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxPartials; ++q)
    if (q < total && p[q].y > 0.0f) s += p[q].y * exp2f(p[q].x - mx);
  const float val = -(mx + log2f(s));
  gs[j] = val;
  if (hrow) hrow[j] = val;
}

// dg_j = the sum over the C·G column partial sums of every block, in rank order.
__device__ void merge_sums(const cg::cluster_group& cluster, float* part, const Split& sp, int n,
                           float* dg) {
  const int j = threadIdx.x;
  if (j >= n) return;
  const int total = sp.c * sp.groups;
  float p[kMaxPartials];
#pragma unroll
  for (int q = 0; q < kMaxPartials; ++q) {
    if (q < total) {
      const float* rp = cluster.map_shared_rank(part, q / sp.groups);
      p[q] = rp[(q % sp.groups) * n + j];
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxPartials; ++q)
    if (q < total) s += p[q];
  dg[j] = s;
}

// grid.x = C·batch, cluster (C, 1, 1): matrix blockIdx.x / C, its rows split
// over the cluster. Shared memory: part [2][G·n] float2, x2 [R][n], f2 [R],
// g2 [n].
template <int CPL>
__global__ void __launch_bounds__(kThreads, 1)
    sinkhorn_forward_cluster(const float* __restrict__ logits, float* __restrict__ out,
                             float* __restrict__ hist, int n, int iters, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const Split sp = make_split(n, static_cast<int>(cluster.dim_blocks().x));
  const Slab b = block_slab(cluster, sp, n);
  const int gn = sp.groups * n;
  float2* part = reinterpret_cast<float2*>(smem);
  float* xs = reinterpret_cast<float*>(part + 2 * gn);
  float* fs = xs + size_t(sp.rows_per) * n;
  float* gs = fs + sp.rows_per;

  const size_t mat = blockIdx.x / sp.c;
  const size_t nn = size_t(n) * n;
  const float* lg = logits + mat * nn + size_t(b.row0) * n;
  float* po = out + mat * nn + size_t(b.row0) * n;
  // hist rows: f_1..f_{K+1} at 0..K, g_0..g_K at K+1..2K+1 (base 2).
  float* h = hist ? hist + mat * 2 * (iters + 1) * n : nullptr;
  const bool write_g = h != nullptr && b.rank == 0;

  const size_t slab = size_t(b.rows) * n;
  for (size_t e = threadIdx.x; e < slab; e += kThreads) xs[e] = lg[e] * scale;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    gs[j] = 0.0f;
    if (write_g) h[size_t(iters + 1) * n + j] = 0.0f;
  }
  block_barrier();

  for (int k = 1;; ++k) {
    row_lse<CPL>(xs, gs, fs, h ? h + size_t(k - 1) * n + b.row0 : nullptr, n, b.rows);
    block_barrier();
    if (k == iters + 1) break;
    float2* buf = part + (k & 1) * gn;
    col_partials(xs, fs, buf, n, b.rows, sp.groups);
    cluster_barrier();
    col_merge(cluster, buf, sp, n, gs, write_g ? h + size_t(iters + 1 + k) * n : nullptr);
    block_barrier();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int il = warp; il < b.rows; il += kWarps) {
    const float fi = fs[il];
    for (int j = lane; j < n; j += 32)
      po[size_t(il) * n + j] = exp2f((xs[size_t(il) * n + j] + fi) + gs[j]);
  }
  // The others may still read this block's partials of the last pass.
  cluster_barrier();
}

// As the forward's launch. Shared memory: part [2][G·n], x2 [R][n], dx [R][n],
// f2 [R], df [R], g2 [n], dg [n].
template <int CPL>
__global__ void __launch_bounds__(kThreads, 1)
    sinkhorn_backward_cluster(const float* __restrict__ logits, const float* __restrict__ p,
                              const float* __restrict__ dp, const float* __restrict__ hist,
                              float* __restrict__ dlogits, int n, int iters, float scale,
                              float tau) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const Split sp = make_split(n, static_cast<int>(cluster.dim_blocks().x));
  const Slab b = block_slab(cluster, sp, n);
  const int gn = sp.groups * n;
  const size_t rn = size_t(sp.rows_per) * n;
  float* part = reinterpret_cast<float*>(smem);
  float* xs = part + 2 * gn;
  float* dxs = xs + rn;
  float* fs = dxs + rn;
  float* df = fs + sp.rows_per;
  float* gs = df + sp.rows_per;
  float* dg = gs + n;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const size_t mat = blockIdx.x / sp.c;
  const size_t off = mat * size_t(n) * n + size_t(b.row0) * n;
  const float* lg = logits + off;
  const float* P = p + off;
  const float* dP = dp + off;
  float* out = dlogits + off;
  const float* h = hist + mat * 2 * (iters + 1) * n;
  const size_t slab = size_t(b.rows) * n;

  for (size_t e = t; e < slab; e += kThreads) xs[e] = lg[e] * scale;
  // dF_i = sum_j dP_ij P_ij; dx = P (dP - dF).
  for (int il = warp; il < b.rows; il += kWarps) {
    const size_t base = size_t(il) * n;
    float pv[CPL], dv[CPL];
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      pv[c] = j < n ? P[base + j] : 0.0f;
      dv[c] = j < n ? dP[base + j] : 0.0f;
      s += dv[c] * pv[c];
    }
    s = warp_sum(s);
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (lane + 32 * c < n) dxs[base + lane + 32 * c] = pv[c] * (dv[c] - s);
  }
  block_barrier();

  // dg_K = column sums of dx. Every exchange runs unconditionally (dg_K
  // when K = 0, and dg_0, are not needed): a barrier under a condition that
  // the compiler can merge with a divergent one is reached by a split warp.
  if (t < gn) {
    float s = 0.0f;
    for (int i = t / n; i < b.rows; i += sp.groups) s += dxs[size_t(i) * n + t % n];
    part[t] = s;
  }
  cluster_barrier();
  merge_sums(cluster, part, sp, n, dg);
  int buf = 1;
  block_barrier();

  for (int k = iters; k >= 1; --k) {
    const float* fk = h + size_t(k - 1) * n + b.row0;
    const float* gk = h + size_t(iters + 1 + k) * n;
    for (int i = t; i < b.rows; i += kThreads) fs[i] = fk[i];
    for (int j = t; j < n; j += kThreads) gs[j] = gk[j];
    block_barrier();
    // Column pass k backward: B = exp2(x2 + f2_k + g2_k), a row reduction.
    {
      float g[CPL], d[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        g[c] = j < n ? gs[j] : 0.0f;
        d[c] = j < n ? dg[j] : 0.0f;
      }
      for (int il = warp; il < b.rows; il += kWarps) {
        const size_t base = size_t(il) * n;
        const float fi = fs[il];
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = lane + 32 * c;
          if (j < n) {
            const float delta = -d[c] * exp2f((xs[base + j] + fi) + g[c]);
            dxs[base + j] += delta;
            s += delta;
          }
        }
        s = warp_sum(s);
        if (lane == 0) df[il] = s;
      }
    }
    block_barrier();
    const float* gprev = h + size_t(iters + k) * n;
    for (int j = t; j < n; j += kThreads) gs[j] = gprev[j];
    block_barrier();
    // Row pass k backward: A = exp2(x2 + f2_k + g2_{k-1}), a column reduction.
    if (t < gn) {
      const int j = t % n;
      const float gj = gs[j];
      float s = 0.0f;
#pragma unroll 4
      for (int i = t / n; i < b.rows; i += sp.groups) {
        const size_t e = size_t(i) * n + j;
        const float delta = -df[i] * exp2f((xs[e] + fs[i]) + gj);
        dxs[e] += delta;
        s += delta;
      }
      part[buf * gn + t] = s;
    }
    cluster_barrier();
    merge_sums(cluster, part + buf * gn, sp, n, dg);
    buf ^= 1;
    block_barrier();
  }
  for (size_t e = t; e < slab; e += kThreads) out[e] = dxs[e] / tau;
  // The others may still read this block's partials of the last exchange.
  cluster_barrier();
}

// ---------------------------------------------------------------------------
// Streamed kernels for 512 < n <= 1024: one block of 512 threads per matrix,
// x re-read from L2 on every pass (scaled to x2 as it is read), column
// partials per warp merged through shared memory.

// Adds v to a running base-2 (max, sum) log-sum-exp with one exponential.
__device__ __forceinline__ void lse_add(float& m, float& s, float v) {
  if (v > m) {
    s = s * exp2f(m - v) + 1.0f;
    m = v;
  } else {
    s += exp2f(v - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // both empty
  s = s * exp2f(m - mm) + s2 * exp2f(m2 - mm);
  m = mm;
}

__device__ __forceinline__ void warp_lse(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
  }
}

struct Ctx {
  int n, warp, lane, tid;
};

// dst_i = -LSE2_j(x2_ij + add_j), one warp per row; also into hist if given.
__device__ void streamed_row_lse(const float* X, float scale, const float* add, float* dst,
                                 float* hist, const Ctx& c) {
  for (int i = c.warp; i < c.n; i += kWarps) {
    const size_t base = size_t(i) * c.n;
    float m = -INFINITY, s = 0.0f;
    for (int j = c.lane; j < c.n; j += 32) lse_add(m, s, X[base + j] * scale + add[j]);
    warp_lse(m, s);
    if (c.lane == 0) {
      const float v = -(m + log2f(s));
      dst[i] = v;
      if (hist) hist[i] = v;
    }
  }
}

// dst_j = -LSE2_i(x2_ij + add_i): lanes along columns, warps split the rows,
// partials (pm, ps: [kWarps, n]) merged through shared memory.
__device__ void streamed_col_lse(const float* X, float scale, const float* add, float* dst,
                                 float* hist, float* pm, float* ps, const Ctx& c) {
  for (int j = c.lane; j < c.n; j += 32) {
    float m = -INFINITY, s = 0.0f;
    for (int i = c.warp; i < c.n; i += kWarps)
      lse_add(m, s, X[size_t(i) * c.n + j] * scale + add[i]);
    pm[c.warp * c.n + j] = m;
    ps[c.warp * c.n + j] = s;
  }
  __syncthreads();
  for (int j = c.tid; j < c.n; j += kThreads) {
    float m = -INFINITY, s = 0.0f;
    for (int w = 0; w < kWarps; ++w) lse_merge(m, s, pm[w * c.n + j], ps[w * c.n + j]);
    const float v = -(m + log2f(s));
    dst[j] = v;
    if (hist) hist[j] = v;
  }
}

// Column sums of per-warp partials part [kWarps, n] into dst.
__device__ void streamed_merge_sums(const float* part, float* dst, const Ctx& c) {
  for (int j = c.tid; j < c.n; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[w * c.n + j];
    dst[j] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    sinkhorn_forward_streamed(const float* __restrict__ logits, float* __restrict__ out,
                              float* __restrict__ hist, int n, int iters, float scale) {
  extern __shared__ float ssm[];
  const size_t nn = size_t(n) * n;
  float* fv = ssm;
  float* gv = fv + n;
  float* pm = gv + n;
  float* ps = pm + kWarps * n;
  const Ctx c{n, int(threadIdx.x) / 32, int(threadIdx.x) % 32, int(threadIdx.x)};
  const float* X = logits + blockIdx.x * nn;
  float* po = out + blockIdx.x * nn;
  float* h = hist ? hist + size_t(blockIdx.x) * 2 * (iters + 1) * n : nullptr;

  for (int j = c.tid; j < n; j += kThreads) {
    gv[j] = 0.0f;
    if (h) h[size_t(iters + 1) * n + j] = 0.0f;
  }
  __syncthreads();
  for (int k = 1; k <= iters + 1; ++k) {
    streamed_row_lse(X, scale, gv, fv, h ? h + size_t(k - 1) * n : nullptr, c);
    __syncthreads();
    if (k == iters + 1) break;
    streamed_col_lse(X, scale, fv, gv, h ? h + size_t(iters + 1 + k) * n : nullptr, pm, ps, c);
    __syncthreads();
  }
  for (int i = c.warp; i < n; i += kWarps) {
    const size_t base = size_t(i) * n;
    const float fi = fv[i];
    for (int j = c.lane; j < n; j += 32) po[base + j] = exp2f((X[base + j] * scale + fi) + gv[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
    sinkhorn_backward_streamed(const float* __restrict__ logits, const float* __restrict__ p,
                               const float* __restrict__ dp, const float* __restrict__ hist,
                               float* __restrict__ dlogits, int n, int iters, float scale,
                               float tau) {
  extern __shared__ float ssm[];
  const size_t nn = size_t(n) * n;
  float* fv = ssm;          // f2_k of the pass
  float* gv = fv + n;       // g2_k or g2_{k-1} of the pass
  float* df = gv + n;       // gradient reaching f_k
  float* dg = df + n;       // gradient reaching g_k
  float* part = dg + n;     // [kWarps, n] column partial sums
  const Ctx c{n, int(threadIdx.x) / 32, int(threadIdx.x) % 32, int(threadIdx.x)};
  const size_t off = blockIdx.x * nn;
  const float* X = logits + off;
  const float* P = p + off;
  const float* dP = dp + off;
  float* DX = dlogits + off;  // dx accumulates here, divided by tau at the end
  const float* h = hist + size_t(blockIdx.x) * 2 * (iters + 1) * n;

  // dF_i = sum_j dP_ij P_ij.
  for (int i = c.warp; i < n; i += kWarps) {
    const size_t base = size_t(i) * n;
    float s = 0.0f;
    for (int j = c.lane; j < n; j += 32) s += dP[base + j] * P[base + j];
    s = warp_sum(s);
    if (c.lane == 0) df[i] = s;
  }
  __syncthreads();
  // dx = P (dP - dF); dg_K = column sums of dx.
  for (int j = c.lane; j < n; j += 32) {
    float s = 0.0f;
    for (int i = c.warp; i < n; i += kWarps) {
      const size_t idx = size_t(i) * n + j;
      const float t = P[idx] * (dP[idx] - df[i]);
      DX[idx] = iters == 0 ? t / tau : t;
      s += t;
    }
    part[c.warp * n + j] = s;
  }
  __syncthreads();
  streamed_merge_sums(part, dg, c);

  for (int k = iters; k >= 1; --k) {
    const float* fk = h + size_t(k - 1) * n;
    const float* gk = h + size_t(iters + 1 + k) * n;
    for (int j = c.tid; j < n; j += kThreads) {
      fv[j] = fk[j];
      gv[j] = gk[j];
    }
    __syncthreads();
    // Column pass k backward: B = exp2(x2 + f2_k + g2_k), a row reduction.
    for (int i = c.warp; i < n; i += kWarps) {
      const size_t base = size_t(i) * n;
      const float fi = fv[i];
      float s = 0.0f;
      for (int j = c.lane; j < n; j += 32) {
        const float delta = -dg[j] * exp2f((X[base + j] * scale + fi) + gv[j]);
        DX[base + j] += delta;
        s += delta;
      }
      s = warp_sum(s);
      if (c.lane == 0) df[i] = s;
    }
    __syncthreads();
    const float* gprev = h + size_t(iters + k) * n;
    for (int j = c.tid; j < n; j += kThreads) gv[j] = gprev[j];
    __syncthreads();
    // Row pass k backward: A = exp2(x2 + f2_k + g2_{k-1}), a column reduction.
    for (int j = c.lane; j < n; j += 32) {
      const float gj = gv[j];
      float s = 0.0f;
      for (int i = c.warp; i < n; i += kWarps) {
        const size_t idx = size_t(i) * n + j;
        const float delta = -df[i] * exp2f((X[idx] * scale + fv[i]) + gj);
        const float v = DX[idx] + delta;
        DX[idx] = k == 1 ? v / tau : v;
        s += delta;
      }
      part[c.warp * n + j] = s;
    }
    __syncthreads();
    streamed_merge_sums(part, dg, c);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch plans

int cpl_for(int n) { return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : n <= 256 ? 8 : 16; }

size_t cluster_smem(int n, int c, bool backward) {
  const Split s = make_split(n, c);
  const size_t rn = size_t(s.rows_per) * n;
  const size_t part = size_t(2) * s.groups * n * (backward ? sizeof(float) : sizeof(float2));
  return part + sizeof(float) * (backward ? 2 * rn + 2 * size_t(s.rows_per) + 2 * size_t(n)
                                          : rn + size_t(s.rows_per) + size_t(n));
}

size_t streamed_smem(int n, bool backward) {
  return sizeof(float) * (backward ? 4 * size_t(n) + size_t(kWarps) * n
                                   : 2 * size_t(n) + 2 * size_t(kWarps) * n);
}

// Whether clusters of c blocks can take an [n, n] matrix: 1 <= c <= 16, at
// least one row per block, and the slab fits the shared memory of a block.
bool cluster_fits(int n, int c, bool backward) {
  return c >= 1 && c <= kMaxPartials && c <= n && cluster_smem(n, c, backward) <= kMaxSmem;
}

cudaLaunchConfig_t cluster_config(long long batch, int c, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(c);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

struct ForwardArgs {
  const float* logits;
  float* out;
  float* hist;
  int n, iters;
  float scale;
};

struct BackwardArgs {
  const float* logits;
  const float* p;
  const float* dp;
  const float* hist;
  float* dlogits;
  int n, iters;
  float scale, tau;
};

// Launches the cluster kernel for clusters of c blocks or, with max_active
// given, asks instead how many such clusters the card holds at once.
template <int CPL>
cudaError_t run_cluster(const ForwardArgs& a, int c, long long batch, cudaStream_t stream,
                        int* max_active) {
  const size_t smem = cluster_smem(a.n, c, false);
  cudaError_t err = prepare(sinkhorn_forward_cluster<CPL>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(batch, c, smem, stream, &attr);
  if (max_active)
    return cudaOccupancyMaxActiveClusters(max_active, sinkhorn_forward_cluster<CPL>, &cfg);
  return cudaLaunchKernelEx(&cfg, sinkhorn_forward_cluster<CPL>, a.logits, a.out, a.hist, a.n,
                            a.iters, a.scale);
}

template <int CPL>
cudaError_t run_cluster(const BackwardArgs& a, int c, long long batch, cudaStream_t stream,
                        int* max_active) {
  const size_t smem = cluster_smem(a.n, c, true);
  cudaError_t err = prepare(sinkhorn_backward_cluster<CPL>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(batch, c, smem, stream, &attr);
  if (max_active)
    return cudaOccupancyMaxActiveClusters(max_active, sinkhorn_backward_cluster<CPL>, &cfg);
  return cudaLaunchKernelEx(&cfg, sinkhorn_backward_cluster<CPL>, a.logits, a.p, a.dp, a.hist,
                            a.dlogits, a.n, a.iters, a.scale, a.tau);
}

// The instantiation for the lane's share of a row (CPL columns, n <= 32·CPL).
template <typename Args>
cudaError_t dispatch(const Args& a, int c, long long batch, cudaStream_t stream,
                     int* max_active) {
  switch (cpl_for(a.n)) {
    case 1: return run_cluster<1>(a, c, batch, stream, max_active);
    case 2: return run_cluster<2>(a, c, batch, stream, max_active);
    case 4: return run_cluster<4>(a, c, batch, stream, max_active);
    case 8: return run_cluster<8>(a, c, batch, stream, max_active);
    default: return run_cluster<16>(a, c, batch, stream, max_active);
  }
}

cudaError_t run_streamed(const ForwardArgs& a, long long batch, cudaStream_t stream) {
  const size_t smem = streamed_smem(a.n, false);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_forward_streamed,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sinkhorn_forward_streamed<<<static_cast<unsigned>(batch), kThreads, smem, stream>>>(
      a.logits, a.out, a.hist, a.n, a.iters, a.scale);
  return cudaGetLastError();
}

cudaError_t run_streamed(const BackwardArgs& a, long long batch, cudaStream_t stream) {
  const size_t smem = streamed_smem(a.n, true);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_backward_streamed,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sinkhorn_backward_streamed<<<static_cast<unsigned>(batch), kThreads, smem, stream>>>(
      a.logits, a.p, a.dp, a.hist, a.dlogits, a.n, a.iters, a.scale, a.tau);
  return cudaGetLastError();
}

// The path by n: clusters up to kClusterMaxN, streamed above.
template <typename Args>
int launch(const Args& a, long long batch, int cluster, void* stream, bool backward) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (a.n < 1 || a.n > kMaxN || a.iters < 0 || batch > (1LL << 26))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n > kClusterMaxN) {
    if (cluster > 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(run_streamed(a, batch, s));
  }
  if (!cluster_fits(a.n, cluster, backward)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dispatch(a, cluster, batch, s, nullptr);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device
// pointer to contiguous fp32 data: logits, out, p, dp, dlogits are
// [batch, n, n]; hist is [batch, 2 * (iters + 1), n] of base-2 potentials
// (in the forward it may be null, and then nothing is stored). n <= 512 runs
// the cluster kernels with `cluster` blocks per matrix; 512 < n <= 1024 runs
// the streamed kernels (one block per matrix; `cluster` must be 0 or 1). Each
// returns the CUDA error code of its launch (0 on success).
extern "C" int hvs_sinkhorn_forward(const void* logits, void* out, void* hist, long long batch,
                                    int n, int iters, float tau, int cluster, void* stream) {
  const ForwardArgs a{static_cast<const float*>(logits), static_cast<float*>(out),
                      static_cast<float*>(hist), n, iters, kLog2e / tau};
  return launch(a, batch, cluster, stream, false);
}

extern "C" int hvs_sinkhorn_backward(const void* logits, const void* p, const void* dp,
                                     const void* hist, void* dlogits, long long batch, int n,
                                     int iters, float tau, int cluster, void* stream) {
  const BackwardArgs a{static_cast<const float*>(logits), static_cast<const float*>(p),
                       static_cast<const float*>(dp), static_cast<const float*>(hist),
                       static_cast<float*>(dlogits), n, iters, kLog2e / tau, tau};
  return launch(a, batch, cluster, stream, true);
}

// The plan of a launch at width n with `cluster` blocks per matrix (as in the
// launches; 1 for the streamed kernels): the cluster size, its dynamic shared
// memory per block, and how many such clusters (or, streamed, blocks per SM)
// the card holds at once. Returns a CUDA error code, cudaErrorInvalidValue
// when the matrix does not fit clusters of that size.
extern "C" int hvs_sinkhorn_plan(int n, int backward, int cluster, int* cluster_out,
                                 long long* smem_out, int* max_active_out) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const bool bwd = backward != 0;
  if (n > kClusterMaxN) {
    *cluster_out = 1;
    const size_t smem = streamed_smem(n, bwd);
    *smem_out = static_cast<long long>(smem);
    const void* kernel = bwd ? reinterpret_cast<const void*>(sinkhorn_backward_streamed)
                             : reinterpret_cast<const void*>(sinkhorn_forward_streamed);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(max_active_out, kernel, kThreads, smem));
  }
  if (!cluster_fits(n, cluster, bwd)) return static_cast<int>(cudaErrorInvalidValue);
  *cluster_out = cluster;
  *smem_out = static_cast<long long>(cluster_smem(n, cluster, bwd));
  if (bwd) {
    const BackwardArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, n, 0, 1.0f, 1.0f};
    return static_cast<int>(dispatch(a, cluster, 1, nullptr, max_active_out));
  }
  const ForwardArgs a{nullptr, nullptr, nullptr, n, 0, 1.0f};
  return static_cast<int>(dispatch(a, cluster, 1, nullptr, max_active_out));
}
