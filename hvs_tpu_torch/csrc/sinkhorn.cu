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
// What bounds it on an H100: 2K+2 dependent passes over the matrix (2K in the
// backward), each a reduction along rows or columns with one exponential per
// element. Per matrix the forward does ~(2K+2)·n² exponentials (the SFU
// issues 16 a clock per SM) against 8·n² bytes of device memory (x in, P
// out), so a matrix is bound by the exponentials; one block per matrix uses
// one SM of 132, so a launch of one matrix sits far above the card's bound.
//
// Design (right and simple first):
//   * one block of 512 threads per matrix; a launch covers a batch of
//     matrices of one size (one block each);
//   * row passes: one warp per row, lanes along the row (coalesced), an
//     online (running max, running sum) LSE per lane merged by shuffles;
//   * column passes: lanes along neighbouring columns (coalesced), warps
//     split the rows, per-warp partials merged through shared memory;
//   * n <= 128: x (and, in the backward, dx) stays in shared memory (64 KB
//     each at 128). Above that the fp32 matrix does not fit the 227 KB a block
//     may use (256 KB at 256, 1 MB at 512) and bf16 storage would break the
//     doubly stochastic property, so every pass re-reads x from L2 and the
//     backward accumulates dx in place in the output tensor;
//   * no fast-math: expf/logf are the accurate versions. The online LSE
//     differs from JAX's two-pass LSE by fp32 rounding only.
// A thread-block cluster holding a large matrix in distributed shared memory,
// and one launch for all matrices of a step, are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr int kSmemMaxN = 128;  // x (and dx) live in shared memory up to this n

// Adds v to a running (max, sum) log-sum-exp with one exponential.
__device__ __forceinline__ void lse_add(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.0f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // both empty
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One element of x = logits / tau. In shared memory x is stored already
// divided (div == 1); from device memory it is divided here.
__device__ __forceinline__ float load_x(const float* X, size_t idx, float div) {
  const float v = X[idx];
  return div == 1.0f ? v : v / div;
}

struct Ctx {
  int n, warp, lane, tid;
};

// dst_i = -LSE_j(x_ij + add_j), one warp per row; also into hist if given.
__device__ void row_lse(const float* X, float div, const float* add, float* dst, float* hist,
                        const Ctx& c) {
  for (int i = c.warp; i < c.n; i += kWarps) {
    const size_t base = size_t(i) * c.n;
    float m = -INFINITY, s = 0.0f;
    for (int j = c.lane; j < c.n; j += 32) lse_add(m, s, load_x(X, base + j, div) + add[j]);
    warp_lse(m, s);
    if (c.lane == 0) {
      const float v = -(m + logf(s));
      dst[i] = v;
      if (hist) hist[i] = v;
    }
  }
}

// dst_j = -LSE_i(x_ij + add_i): lanes along columns, warps split the rows,
// partials (pm, ps: [kWarps, n]) merged through shared memory.
__device__ void col_lse(const float* X, float div, const float* add, float* dst, float* hist,
                        float* pm, float* ps, const Ctx& c) {
  for (int j = c.lane; j < c.n; j += 32) {
    float m = -INFINITY, s = 0.0f;
    for (int i = c.warp; i < c.n; i += kWarps) lse_add(m, s, load_x(X, size_t(i) * c.n + j, div) + add[i]);
    pm[c.warp * c.n + j] = m;
    ps[c.warp * c.n + j] = s;
  }
  __syncthreads();
  for (int j = c.tid; j < c.n; j += kThreads) {
    float m = -INFINITY, s = 0.0f;
    for (int w = 0; w < kWarps; ++w) lse_merge(m, s, pm[w * c.n + j], ps[w * c.n + j]);
    const float v = -(m + logf(s));
    dst[j] = v;
    if (hist) hist[j] = v;
  }
}

// Column sums of per-warp partials part [kWarps, n] into dst.
__device__ void merge_sums(const float* part, float* dst, const Ctx& c) {
  for (int j = c.tid; j < c.n; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[w * c.n + j];
    dst[j] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    sinkhorn_forward_kernel(const float* __restrict__ logits, float* __restrict__ out,
                            float* __restrict__ hist, int n, int iters, float tau) {
  extern __shared__ float smem[];
  const size_t nn = size_t(n) * n;
  const bool in_smem = n <= kSmemMaxN;
  float* fv = smem;
  float* gv = fv + n;
  float* pm = gv + n;
  float* ps = pm + kWarps * n;
  float* xs = ps + kWarps * n;
  const Ctx c{n, int(threadIdx.x) / 32, int(threadIdx.x) % 32, int(threadIdx.x)};
  const float* lg = logits + blockIdx.x * nn;
  float* po = out + blockIdx.x * nn;
  // hist rows: f_1..f_{K+1} at 0..K, g_0..g_K at K+1..2K+1.
  float* h = hist ? hist + size_t(blockIdx.x) * 2 * (iters + 1) * n : nullptr;

  if (in_smem)
    for (size_t idx = c.tid; idx < nn; idx += kThreads) xs[idx] = lg[idx] / tau;
  for (int j = c.tid; j < n; j += kThreads) {
    gv[j] = 0.0f;
    if (h) h[size_t(iters + 1) * n + j] = 0.0f;
  }
  __syncthreads();
  const float* X = in_smem ? xs : lg;
  const float div = in_smem ? 1.0f : tau;

  for (int k = 1; k <= iters + 1; ++k) {
    row_lse(X, div, gv, fv, h ? h + size_t(k - 1) * n : nullptr, c);
    __syncthreads();
    if (k == iters + 1) break;
    col_lse(X, div, fv, gv, h ? h + size_t(iters + 1 + k) * n : nullptr, pm, ps, c);
    __syncthreads();
  }
  for (int i = c.warp; i < n; i += kWarps) {
    const size_t base = size_t(i) * n;
    const float fi = fv[i];
    for (int j = c.lane; j < n; j += 32) po[base + j] = expf((load_x(X, base + j, div) + fi) + gv[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
    sinkhorn_backward_kernel(const float* __restrict__ logits, const float* __restrict__ p,
                             const float* __restrict__ dp, const float* __restrict__ hist,
                             float* __restrict__ dlogits, int n, int iters, float tau) {
  extern __shared__ float smem[];
  const size_t nn = size_t(n) * n;
  const bool in_smem = n <= kSmemMaxN;
  float* fv = smem;         // f_k of the pass
  float* gv = fv + n;       // g_k or g_{k-1} of the pass
  float* df = gv + n;       // gradient reaching f_k
  float* dg = df + n;       // gradient reaching g_k
  float* part = dg + n;     // [kWarps, n] column partial sums
  float* xs = part + kWarps * n;
  float* dxs = xs + nn;
  const Ctx c{n, int(threadIdx.x) / 32, int(threadIdx.x) % 32, int(threadIdx.x)};
  const size_t off = blockIdx.x * nn;
  const float* lg = logits + off;
  const float* P = p + off;
  const float* dP = dp + off;
  float* out = dlogits + off;
  const float* h = hist + size_t(blockIdx.x) * 2 * (iters + 1) * n;

  if (in_smem)
    for (size_t idx = c.tid; idx < nn; idx += kThreads) xs[idx] = lg[idx] / tau;
  const float* X = in_smem ? xs : lg;
  float* DX = in_smem ? dxs : out;
  const float div = in_smem ? 1.0f : tau;

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
      if (iters == 0) out[idx] = t / tau;
      else DX[idx] = t;
      s += t;
    }
    part[c.warp * n + j] = s;
  }
  __syncthreads();
  merge_sums(part, dg, c);

  for (int k = iters; k >= 1; --k) {
    const float* fk = h + size_t(k - 1) * n;
    const float* gk = h + size_t(iters + 1 + k) * n;
    for (int j = c.tid; j < n; j += kThreads) {
      fv[j] = fk[j];
      gv[j] = gk[j];
    }
    __syncthreads();
    // Column pass k backward: B = exp(x + f_k + g_k), a row reduction.
    for (int i = c.warp; i < n; i += kWarps) {
      const size_t base = size_t(i) * n;
      const float fi = fv[i];
      float s = 0.0f;
      for (int j = c.lane; j < n; j += 32) {
        const float delta = -dg[j] * expf((load_x(X, base + j, div) + fi) + gv[j]);
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
    // Row pass k backward: A = exp(x + f_k + g_{k-1}), a column reduction.
    for (int j = c.lane; j < n; j += 32) {
      const float gj = gv[j];
      float s = 0.0f;
      for (int i = c.warp; i < n; i += kWarps) {
        const size_t idx = size_t(i) * n + j;
        const float delta = -df[i] * expf((load_x(X, idx, div) + fv[i]) + gj);
        const float v = DX[idx] + delta;
        if (k == 1) out[idx] = v / tau;
        else DX[idx] = v;
        s += delta;
      }
      part[c.warp * n + j] = s;
    }
    __syncthreads();
    merge_sums(part, dg, c);
    __syncthreads();
  }
}

size_t forward_smem(int n) {
  return sizeof(float) * (2 * size_t(n) + 2 * size_t(kWarps) * n +
                          (n <= kSmemMaxN ? size_t(n) * n : 0));
}

size_t backward_smem(int n) {
  return sizeof(float) * (4 * size_t(n) + size_t(kWarps) * n +
                          (n <= kSmemMaxN ? 2 * size_t(n) * n : 0));
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device
// pointer to contiguous fp32 data: logits, out, p, dp, dlogits are
// [batch, n, n]; hist is [batch, 2 * (iters + 1), n] (in the forward it may
// be null, and then nothing is stored). Each returns the CUDA error code of
// its launch (0 on success).
extern "C" int hvs_sinkhorn_forward(const void* logits, void* out, void* hist, long long batch,
                                    int n, int iters, float tau, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (n < 1 || n > kMaxN || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = forward_smem(n);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_forward_kernel<<<static_cast<unsigned>(batch), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(out), static_cast<float*>(hist), n,
      iters, tau);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvs_sinkhorn_backward(const void* logits, const void* p, const void* dp,
                                     const void* hist, void* dlogits, long long batch, int n,
                                     int iters, float tau, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (n < 1 || n > kMaxN || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = backward_smem(n);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_backward_kernel<<<static_cast<unsigned>(batch), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(p),
      static_cast<const float*>(dp), static_cast<const float*>(hist),
      static_cast<float*>(dlogits), n, iters, tau);
  return static_cast<int>(cudaGetLastError());
}
