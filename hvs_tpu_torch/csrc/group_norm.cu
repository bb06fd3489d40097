// GroupNorm on NHWC maps for Hopper (sm_90a): a statistics kernel and an
// apply kernel, run back to back.
//
// It replaces no TPU kernel: on the TPU, XLA fused GroupNorm, its SiLU and the
// folded block tail into the neighbouring convolutions' fusions. In plain
// PyTorch the same functions ran as a chain of fp32 passes over the map (a
// copy, a square, two means, a multiply, an add, casts, the SiLU), about
// 48-60 bytes of device traffic per element.
//
// The map x is [B, HW, C] of a float type T, bf16 on the serve path, fp16 or
// fp32 in a model of that precision (an NHWC map with its spatial axes
// flattened), C a multiple of 4 up to kMaxChannels, cut per image into
// `slices` slices of consecutive rows. Everything in between is fp32; "T(v)"
// below is v rounded to T, which for fp32 is v itself.
//
//   gn_stats   partials[b, s, 0, c] = sum over slice s of x / HW
//              partials[b, s, 1, c] = sum over slice s of x^2 / HW
//              so that their sums over s are the per-channel means of x and x^2.
//   gn_apply   per image: the partials summed to per-channel means, group means
//              of those, rs = rsqrt(E[x^2] - E[x]^2 + eps), s = scale*rs and
//              t = bias - E[x]*s per channel; then y = T(x*s + t) and, with
//              SiLU, T(silu(y)) in fp32 of the rounded y.
//   tail mode  the folded serve tail of a bottleneck block:
//              out = T(silu(y*s + t + shortcut')) in fp32, with s and t
//              [B, C] given (the SE gate already folded in; either may be
//              absent), shortcut' the shortcut map as it is or normalised by
//              its own partials, scale and bias ((o + sc*s2) + t2).
//
// The products and sums are rounded one at a time (__fmul_rn, __fadd_rn),
// never contracted into an fma, in the order of the plain PyTorch version,
// which rounds at the same points; only the statistics' summation order
// differs from it.
//
// What bounds it on an H100: nothing but bytes. GroupNorm + SiLU reads the map
// twice (statistics, then apply) and writes it once: 6 bytes per bf16 element,
// the tail 8 (y, shortcut, out) or 10 with a projected shortcut (its
// statistics); twice that in fp32.
// At 3.35 TB/s that is the least time; there is no arithmetic to speak of.
//
// Design:
//   * a block of 256 threads takes one image and one slice of rows; each
//     thread holds V channels, V = 8 where C allows it and 4 otherwise (one
//     16-byte load or store of 8 bf16, two of 8 fp32, 8 bytes of 4 bf16),
//     and walks the rows of its slice with a stride of 256 / (C/V) rows; the
//     slice count grows with sqrt(HW) (num_slices), so a map of b16 at 640^2
//     spreads over 100 to 1,800 blocks, and every image of a batch is cut
//     alike;
//   * gn_stats sums in fp32 registers, then folds the rows of the block in
//     shared memory as a tree in a fixed order, and writes one partial per
//     (image, slice, channel): no atomics, so the same input gives the same
//     bits on every run and at every batch size;
//   * gn_apply's prologue sums its image's partials (all 256 threads, in a
//     fixed order), forms the group statistics and the per-channel s and t in
//     shared memory, then streams its slice once; launched right after
//     gn_stats on the same stream, it finds maps up to ~50 MB still in L2;
//   * tail mode reads s and t from [B, C] tensors and the shortcut's
//     statistics, when it is normalised, through the same prologue.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using fp16 = __half;

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;  // channels per thread, at most
constexpr int kMaxChannels = 1024;

enum Mode { kNorm = 0, kNormSilu = 1, kTail = 2 };

// The rows of this block's (image, slice) and this thread's place in them.
struct Rows {
  int lanes;          // threads per row: C / V
  int per_pass;       // rows a block covers at once: 256 / lanes
  int lane, row;      // this thread's V-channel group and row (row >= per_pass: idle)
  int begin, end;     // the slice's rows
};

template <int V>
__device__ __forceinline__ Rows rows_of(int hw, int c, int slices) {
  Rows r;
  r.lanes = c / V;
  r.per_pass = kThreads / r.lanes;
  r.lane = threadIdx.x % r.lanes;
  r.row = threadIdx.x / r.lanes;
  const int per_slice = (hw + slices - 1) / slices;
  r.begin = blockIdx.x * per_slice;
  r.end = min(hw, r.begin + per_slice);
  return r;
}

// V channels of T as fp32: load (kNc: through the read-only path), store
// rounded to T, and T's rounding of one value. Word is one aligned access of
// up to 16 bytes; V channels take one or two.
template <int kBytes>
struct Word;
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<16> {
  using type = uint4;
};

template <typename T, int V>
struct Access {
  static constexpr int kBytes = (int)sizeof(T) * V;  // 8, 16 or 32
  using W = typename Word<(kBytes > 16 ? 16 : kBytes)>::type;
  static constexpr int kWords = kBytes > 16 ? kBytes / 16 : 1;

  template <bool kNc>
  static __device__ __forceinline__ void read(const T* p, W* w) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (kNc)
        w[k] = __ldg(reinterpret_cast<const W*>(p) + k);
      else
        w[k] = reinterpret_cast<const W*>(p)[k];
    }
  }
  static __device__ __forceinline__ void write(T* p, const W* w) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) reinterpret_cast<W*>(p)[k] = w[k];
  }
};

__device__ __forceinline__ float2 to_float2(__nv_bfloat162 h) { return __bfloat1622float2(h); }
__device__ __forceinline__ float2 to_float2(__half2 h) { return __half22float2(h); }
__device__ __forceinline__ void from_float2(float a, float b, __nv_bfloat162* h) {
  *h = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void from_float2(float a, float b, __half2* h) {
  *h = __floats2half2_rn(a, b);
}

template <typename T, typename T2, int V>
struct VecHalf {  // a 2-byte type, converted in pairs
  using A = Access<T, V>;
  template <bool kNc>
  static __device__ __forceinline__ void load(const T* p, float* f) {
    typename A::W w[A::kWords];
    A::template read<kNc>(p, w);
    const T2* h = reinterpret_cast<const T2*>(w);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 q = to_float2(h[j]);
      f[2 * j] = q.x;
      f[2 * j + 1] = q.y;
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    typename A::W w[A::kWords];
    T2* h = reinterpret_cast<T2*>(w);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) from_float2(f[2 * j], f[2 * j + 1], h + j);
    A::write(p, w);
  }
};

template <typename T, int V>
struct Vec;

template <int V>
struct Vec<bf16, V> : VecHalf<bf16, __nv_bfloat162, V> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <int V>
struct Vec<fp16, V> : VecHalf<fp16, __half2, V> {
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
};

template <int V>
struct Vec<float, V> {
  using A = Access<float, V>;
  template <bool kNc>
  static __device__ __forceinline__ void load(const float* p, float* f) {
    typename A::W w[A::kWords];
    A::template read<kNc>(p, w);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = reinterpret_cast<const float*>(w)[j];
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    typename A::W w[A::kWords];
#pragma unroll
    for (int j = 0; j < V; ++j) reinterpret_cast<float*>(w)[j] = f[j];
    A::write(p, w);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

// PyTorch's SiLU in fp32: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, int hw, int c,
                    int slices) {
  // [2][per_pass][c]; per_pass * c <= kThreads * V.
  __shared__ float red[2 * kThreads * kMaxVec];
  const Rows r = rows_of<V>(hw, c, slices);
  const int b = blockIdx.y;
  float sum[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sum[j] = sq[j] = 0.0f;
  if (r.row < r.per_pass) {
    const T* base = x + (size_t)b * hw * c + r.lane * V;
#pragma unroll 4
    for (int i = r.begin + r.row; i < r.end; i += r.per_pass) {
      float f[V];
      Vec<T, V>::template load<true>(base + (size_t)i * c, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sum[j] += f[j];
        // x^2 of a bf16 or fp16 is exact in fp32; of an fp32, the fma rounds
        // once where the plain version rounds twice.
        sq[j] = fmaf(f[j], f[j], sq[j]);
      }
    }
  }
  const int plane = r.per_pass * c;
  if (r.row < r.per_pass) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[r.row * c + r.lane * V + j] = sum[j];
      red[plane + r.row * c + r.lane * V + j] = sq[j];
    }
  }
  __syncthreads();
  // Fold the rows as a tree in a fixed order: rows [h, n) onto [0, n - h).
  for (int n = r.per_pass; n > 1;) {
    const int h = (n + 1) / 2;
    const int span = (n - h) * c;
    for (int i = threadIdx.x; i < 2 * span; i += kThreads) {
      const int q = i / span, k = i % span;
      red[q * plane + k] += red[q * plane + h * c + k];
    }
    __syncthreads();
    n = h;
  }
  const float inv = 1.0f / (float)hw;
  float* out = partials + ((size_t)b * slices + blockIdx.x) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) {
    const int q = i / c, ch = i % c;
    out[i] = red[q * plane + ch] * inv;
  }
}

// The per-channel affine (s, t) of GroupNorm on image b, from its partials
// [slices][2][c], into shared memory. Every thread of the block calls it.
__device__ void affine_from_partials(const float* __restrict__ partials, int b, int slices,
                                     int c, int groups, float eps,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias, float* s_out,
                                     float* t_out, float* tmp, float* gstat) {
  const int vals = 2 * c;
  const float* p = partials + (size_t)b * slices * vals;
  // Sum over the slices: `parts` threads per value, each over every parts-th
  // slice, then the parts in order.
  const int parts = max(1, kThreads / vals);
  if (parts == 1) {
    for (int v = threadIdx.x; v < vals; v += kThreads) {
      float acc = 0.0f;
#pragma unroll 4
      for (int s = 0; s < slices; ++s) acc += p[(size_t)s * vals + v];
      tmp[v] = acc;
    }
  } else if (threadIdx.x < parts * vals) {
    const int v = threadIdx.x % vals, part = threadIdx.x / vals;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = part; s < slices; s += parts) acc += p[(size_t)s * vals + v];
    tmp[part * vals + v] = acc;
  }
  __syncthreads();
  if (parts > 1 && threadIdx.x < vals) {
    float acc = tmp[threadIdx.x];
    for (int q = 1; q < parts; ++q) acc += tmp[q * vals + threadIdx.x];
    tmp[threadIdx.x] = acc;
  }
  __syncthreads();
  // Group means of the channel means, then rsqrt(E[x^2] - E[x]^2 + eps).
  const int cg = c / groups;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float m = 0.0f, m2 = 0.0f;
    for (int k = 0; k < cg; ++k) {
      m += tmp[g * cg + k];
      m2 += tmp[c + g * cg + k];
    }
    m = m / (float)cg;
    m2 = m2 / (float)cg;
    gstat[g] = m;
    gstat[groups + g] = rsqrtf(__fadd_rn(__fsub_rn(m2, __fmul_rn(m, m)), eps));
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int g = ch / cg;
    const float s = __fmul_rn(scale[ch], gstat[groups + g]);
    s_out[ch] = s;
    t_out[ch] = __fsub_rn(bias[ch], __fmul_rn(gstat[g], s));
  }
  __syncthreads();
}

template <typename T>
struct ApplyArgs {
  const T* x;  // the map (tail mode: y)
  T* out;
  int hw, c, slices, groups;
  float eps;
  // kNorm / kNormSilu: x's partials and the GroupNorm's scale and bias.
  // kTail: the shortcut's partials, scale and bias (null: added as it is).
  const float* partials;
  const float* scale;
  const float* bias;
  // kTail only: s and t [B, C] (either may be null) and the shortcut map.
  const float* s;
  const float* t;
  const T* shortcut;
};

template <typename T, int V, int kMode>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(const ApplyArgs<T> a) {
  __shared__ float tmp[2 * kMaxChannels];
  __shared__ float gstat[2 * kMaxChannels];
  __shared__ float s_sh[kMaxChannels], t_sh[kMaxChannels];
  const int b = blockIdx.y, c = a.c;
  const bool normed = a.partials != nullptr;
  if (normed)
    affine_from_partials(a.partials, b, a.slices, c, a.groups, a.eps, a.scale, a.bias, s_sh,
                         t_sh, tmp, gstat);
  const Rows r = rows_of<V>(a.hw, c, a.slices);
  if (r.row >= r.per_pass) return;
  const int c0 = r.lane * V;
  float s[V], t[V], s2[V], t2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (kMode == kTail) {
      s[j] = a.s ? a.s[(size_t)b * c + c0 + j] : 1.0f;
      t[j] = a.t ? a.t[(size_t)b * c + c0 + j] : 0.0f;
      s2[j] = normed ? s_sh[c0 + j] : 1.0f;
      t2[j] = normed ? t_sh[c0 + j] : 0.0f;
    } else {
      s[j] = s_sh[c0 + j];
      t[j] = t_sh[c0 + j];
    }
  }
  const size_t off = (size_t)b * a.hw * c + c0;
  const T* xb = a.x + off;
  const T* sb = a.shortcut + (kMode == kTail ? off : 0);
  T* ob = a.out + off;
#pragma unroll 4
  for (int i = r.begin + r.row; i < r.end; i += r.per_pass) {
    const size_t at = (size_t)i * c;
    float f[V], o[V];
    Vec<T, V>::template load<false>(xb + at, f);
    if (kMode == kTail) {
      float sc[V];
      Vec<T, V>::template load<false>(sb + at, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = a.s ? __fmul_rn(f[j], s[j]) : f[j];
        if (a.t) v = __fadd_rn(v, t[j]);
        v = normed ? __fadd_rn(__fadd_rn(v, __fmul_rn(sc[j], s2[j])), t2[j])
                   : __fadd_rn(v, sc[j]);
        o[j] = silu(v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = __fadd_rn(__fmul_rn(f[j], s[j]), t[j]);
        o[j] = kMode == kNormSilu ? silu(Vec<T, V>::round(v)) : v;
      }
    }
    Vec<T, V>::store(ob + at, o);
  }
}

dim3 grid_of(int batch, int slices) { return dim3((unsigned)slices, (unsigned)batch); }

// A launch of one kernel for the map's type and C: `dtype` 0 bf16, 1 fp16,
// 2 fp32 (ops/group_norm.py's DTYPES); V = 8 where 8 divides C, else 4.
template <template <typename, int> class Launch, typename... Args>
int dispatch(int dtype, int c, Args... args) {
  const bool wide = c % 8 == 0;
  switch (dtype) {
    case 0:
      wide ? Launch<bf16, 8>::run(args...) : Launch<bf16, 4>::run(args...);
      break;
    case 1:
      wide ? Launch<fp16, 8>::run(args...) : Launch<fp16, 4>::run(args...);
      break;
    case 2:
      wide ? Launch<float, 8>::run(args...) : Launch<float, 4>::run(args...);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int V>
struct Stats {
  static void run(const void* x, void* partials, int batch, int hw, int c, int slices,
                  cudaStream_t stream) {
    gn_stats_kernel<T, V><<<grid_of(batch, slices), kThreads, 0, stream>>>(
        (const T*)x, (float*)partials, hw, c, slices);
  }
};

template <int kMode>
struct Apply {
  template <typename T, int V>
  struct On {
    static void run(const void* x, void* out, int batch, int hw, int c, int slices, int groups,
                    float eps, const void* partials, const void* scale, const void* bias,
                    const void* s, const void* t, const void* shortcut, cudaStream_t stream) {
      ApplyArgs<T> a{(const T*)x, (T*)out, hw, c, slices, groups, eps, (const float*)partials,
                     (const float*)scale, (const float*)bias, (const float*)s,
                     (const float*)t, (const T*)shortcut};
      gn_apply_kernel<T, V, kMode><<<grid_of(batch, slices), kThreads, 0, stream>>>(a);
    }
  };
};

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for an unknown `dtype`). The wrappers
// (hvs_tpu_torch/ops/group_norm.py) check shapes, types, contiguity and
// alignment first.

extern "C" int hvs_gn_stats(const void* x, void* partials, int batch, int hw, int c,
                            int slices, int dtype, void* stream) {
  return dispatch<Stats>(dtype, c, x, partials, batch, hw, c, slices, (cudaStream_t)stream);
}

extern "C" int hvs_gn_apply(const void* x, void* out, int batch, int hw, int c, int slices,
                            int dtype, const void* partials, const void* scale,
                            const void* bias, int groups, float eps, int silu, void* stream) {
  const void* none = nullptr;
  if (silu)
    return dispatch<Apply<kNormSilu>::On>(dtype, c, x, out, batch, hw, c, slices, groups, eps,
                                          partials, scale, bias, none, none, none,
                                          (cudaStream_t)stream);
  return dispatch<Apply<kNorm>::On>(dtype, c, x, out, batch, hw, c, slices, groups, eps,
                                    partials, scale, bias, none, none, none,
                                    (cudaStream_t)stream);
}

extern "C" int hvs_gn_apply_tail(const void* y, void* out, int batch, int hw, int c,
                                 int slices, int dtype, const void* s, const void* t,
                                 const void* shortcut, const void* sc_partials,
                                 const void* sc_scale, const void* sc_bias, int groups,
                                 float eps, void* stream) {
  return dispatch<Apply<kTail>::On>(dtype, c, y, out, batch, hw, c, slices, groups, eps,
                                    sc_partials, sc_scale, sc_bias, s, t, shortcut,
                                    (cudaStream_t)stream);
}
