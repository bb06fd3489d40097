// Fused mHC block for Hopper (sm_90a), in two modes.
//
// Serve mode replaces the TPU kernel
// hvs_tpu/ops/pallas/mhc_pallas.py::mhc_block_pallas_packed (kernel body
// _mhc_packed_kernel); unfolded mode replaces mhc_block_pallas (kernel body
// _mhc_kernel), the chain of a deterministic training-model forward. Per
// token row of x [n, d] (bf16):
//
//   y   = bf16(LN1(x))                       LN statistics in exact fp32, eps 1e-6
//   y   = bf16(y @ H_pre)                    unfolded mode only (W1 is then unfolded)
//   y   = bf16(gelu(bf16(bf16(y @ W1f) + bf16(b1))))
//   y   = bf16(gelu(bf16(bf16(y @ W2)  + bf16(b2))))
//   y   = bf16(y @ H_post)
//   r   = bf16(x @ H_res)
//   out = bf16(LN2(bf16(r + y)))
//
// Products take bf16 operands and accumulate in fp32; GELU is the tanh form.
// The TPU kernel's token packing (block-diagonal weights, LayerNorm as a
// matmul) exists only for the TPU's 128 lanes and is not carried over: rows
// are read as [n, d] directly.
//
// What bounds it on an H100: 8*n*d^2 FLOP (10*n*d^2 unfolded) against 4*n*d
// bytes of activations (plus 4 or 5 d^2 weights), about 2*d FLOP per byte. That is below the card's
// ridge (~295 FLOP/B) at d <= 128, so there the kernel is memory-bound, and
// above it at d >= 256, where it is bound by the tensor cores.
//
// Design (right and simple first):
//   * one block of 256 threads per tile of BM token rows;
//   * the x tile is read from device memory once into shared memory, and the
//     output is written once; rows past n are zero-filled and never stored;
//   * LayerNorm: one warp per row, shuffle reductions, two-pass fp32 variance;
//   * the bf16 intermediate tile stays in shared memory between the products;
//   * each [d, d] weight streams through shared memory in k-chunks with a
//     two-stage cp.async pipeline (at d >= 256 the five weights exceed the
//     227 KB a block may use, so they come from L2);
//   * fp32 accumulators live in registers as wmma m16n16k16 bf16 fragments;
//     each warp owns a fixed FM x FN grid of 16x16 output tiles, and applies
//     the epilogue (rounding, bias, GELU, residual add) through a 1 KB
//     per-warp shared scratch tile;
//   * unfolded mode is a template flag: one more tile_gemm with a kRound
//     epilogue before the W1 product, so serve mode compiles as before.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

// BM: token rows per block. KC: rows of a weight chunk. WARPS_M: warps along
// the row axis of the output tile (the rest split the d columns).
template <int D> struct Config;
template <> struct Config<32>  { static constexpr int BM = 128, KC = 32, WARPS_M = 8; };
template <> struct Config<64>  { static constexpr int BM = 128, KC = 64, WARPS_M = 4; };
template <> struct Config<128> { static constexpr int BM = 64,  KC = 64, WARPS_M = 4; };
template <> struct Config<256> { static constexpr int BM = 64,  KC = 32, WARPS_M = 2; };
template <> struct Config<512> { static constexpr int BM = 32,  KC = 16, WARPS_M = 2; };

template <int D>
struct Layout {
  static constexpr int BM = Config<D>::BM;
  static constexpr int KC = Config<D>::KC;
  static constexpr int WARPS_M = Config<D>::WARPS_M;
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int FM = BM / 16 / WARPS_M;  // 16-row fragments per warp
  static constexpr int FN = D / 16 / WARPS_N;   // 16-column fragments per warp
  static constexpr int LD = D + 8;              // padded smem row stride (elements)
  static constexpr int PER_LANE = D / 32;       // row elements per lane in LayerNorm
  static constexpr size_t kTileBytes = size_t(BM) * LD * sizeof(bf16);
  static constexpr size_t kChunkBytes = size_t(KC) * LD * sizeof(bf16);
  static constexpr size_t kScratchBytes = size_t(kWarps) * 256 * sizeof(float);
  static constexpr size_t kSmemBytes = 2 * kTileBytes + 2 * kChunkBytes + kScratchBytes;
  static_assert(FM >= 1 && FN >= 1, "warp grid too large for the tile");
  static_assert(BM % (16 * WARPS_M) == 0 && D % (16 * WARPS_N) == 0, "uneven warp grid");
  static_assert(D % KC == 0 && KC % 16 == 0, "k-chunk must tile d");
  static_assert(kTileBytes % 128 == 0 && kChunkBytes % 128 == 0, "smem regions must stay aligned");
};

using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return v * (0.5f * (1.0f + tanhf(k * (v + 0.044715f * (v * v * v)))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// LayerNorm of one smem row held by one warp: values in v (lane + 32*i).
template <int D>
__device__ __forceinline__ void layernorm_row(const bf16* row, const float* __restrict__ scale,
                                              const float* __restrict__ bias, int lane,
                                              float (&v)[Layout<D>::PER_LANE]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < Layout<D>::PER_LANE; ++i) {
    v[i] = __bfloat162float(row[lane + 32 * i]);
    s += v[i];
  }
  const float mu = warp_sum(s) * (1.0f / D);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < Layout<D>::PER_LANE; ++i) {
    v[i] -= mu;
    q += v[i] * v[i];
  }
  const float rs = rsqrtf(warp_sum(q) * (1.0f / D) + kLnEps);
#pragma unroll
  for (int i = 0; i < Layout<D>::PER_LANE; ++i) {
    const int c = lane + 32 * i;
    v[i] = v[i] * rs * scale[c] + bias[c];
  }
}

// Rows [k0, k0 + KC) of a row-major [D, D] weight into a padded smem chunk.
template <int D>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ w, int k0) {
  using L = Layout<D>;
  constexpr int kVecPerRow = D / 8;
  for (int v = threadIdx.x; v < L::KC * kVecPerRow; v += kThreads) {
    const int r = v / kVecPerRow;
    const int c = (v % kVecPerRow) * 8;
    cp_async16(dst + r * L::LD + c, w + size_t(k0 + r) * D + c);
  }
}

// acc = a[BM, D] @ w[D, D] for this warp's output fragments. a is a smem
// tile; w streams from device memory (L2) through two smem chunk buffers.
// Ends with a block barrier, so the caller may overwrite a afterwards.
template <int D>
__device__ __forceinline__ void tile_gemm(const bf16* a, const bf16* __restrict__ w, bf16* chunks,
                                          AccFrag (&acc)[Layout<D>::FM][Layout<D>::FN], int wm,
                                          int wn) {
  using L = Layout<D>;
  constexpr int kChunks = D / L::KC;
  constexpr int kChunkElems = L::KC * L::LD;
#pragma unroll
  for (int i = 0; i < L::FM; ++i)
#pragma unroll
    for (int j = 0; j < L::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_chunk<D>(chunks, w, 0);
  cp_async_commit();
  for (int kc = 0; kc < kChunks; ++kc) {
    const bf16* cur = chunks + (kc & 1) * kChunkElems;
    if (kc + 1 < kChunks) {
      load_chunk<D>(chunks + ((kc + 1) & 1) * kChunkElems, w, (kc + 1) * L::KC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < L::KC; kk += 16) {
      AFrag af[L::FM];
#pragma unroll
      for (int i = 0; i < L::FM; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * L::FM + i) * 16 * L::LD + kc * L::KC + kk, L::LD);
#pragma unroll
      for (int j = 0; j < L::FN; ++j) {
        BFrag bfrag;
        wmma::load_matrix_sync(bfrag, cur + kk * L::LD + (wn * L::FN + j) * 16, L::LD);
#pragma unroll
        for (int i = 0; i < L::FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfrag, acc[i][j]);
      }
    }
    __syncthreads();
  }
}

enum Epilogue { kRound = 0, kBiasGelu = 1, kAddResidual = 2 };

// Writes this warp's fragments into the smem tile dst, rounding to bf16 at
// the same points as the plain version:
//   kRound:       dst = bf16(acc)
//   kBiasGelu:    dst = bf16(gelu(bf16(bf16(acc) + bf16(bias))))
//   kAddResidual: dst = bf16(bf16(acc) + res)
template <int D, int kMode>
__device__ __forceinline__ void epilogue(AccFrag (&acc)[Layout<D>::FM][Layout<D>::FN], bf16* dst,
                                         const bf16* res, const float* __restrict__ bias,
                                         float* scratch, int wm, int wn, int lane) {
  using L = Layout<D>;
  const int r = lane >> 1;        // row within the 16x16 fragment
  const int c = (lane & 1) * 8;   // first of this lane's 8 columns
#pragma unroll
  for (int i = 0; i < L::FM; ++i) {
#pragma unroll
    for (int j = 0; j < L::FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = (wm * L::FM + i) * 16 + r;
      const int col = (wn * L::FN + j) * 16 + c;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = round_bf16(scratch[r * 16 + c + e]);
      if (kMode == kBiasGelu) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = gelu_tanh(round_bf16(v[e] + round_bf16(bias[col + e])));
      } else if (kMode == kAddResidual) {
        const uint4 packed = *reinterpret_cast<const uint4*>(res + row * L::LD + col);
        const bf16* rv = reinterpret_cast<const bf16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rv[e]);
      }
      uint4 outv;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&outv);
#pragma unroll
      for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(dst + row * L::LD + col) = outv;
      __syncwarp();
    }
  }
}

template <int D, bool kUnfolded>
__global__ void __launch_bounds__(kThreads)
    mhc_block_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, long long n,
                     const bf16* __restrict__ h_pre,
                     const bf16* __restrict__ w1f, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ b2,
                     const bf16* __restrict__ h_post, const bf16* __restrict__ h_res,
                     const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                     const float* __restrict__ ln2_s, const float* __restrict__ ln2_b) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(smem + L::kTileBytes);
  bf16* chunks = reinterpret_cast<bf16*>(smem + 2 * L::kTileBytes);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / L::WARPS_N;
  const int wn = warp % L::WARPS_N;
  float* scratch =
      reinterpret_cast<float*>(smem + 2 * L::kTileBytes + 2 * L::kChunkBytes) + warp * 256;
  const long long row0 = static_cast<long long>(blockIdx.x) * L::BM;

  // x tile -> xs, once; rows past n are zeros (finite through LN, never stored).
  constexpr int kVecPerRow = D / 8;
  for (int v = threadIdx.x; v < L::BM * kVecPerRow; v += kThreads) {
    const int r = v / kVecPerRow;
    const int c = (v % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(x + (row0 + r) * D + c);
    *reinterpret_cast<uint4*>(xs + r * L::LD + c) = val;
  }
  __syncthreads();

  float v[L::PER_LANE];
  for (int r = warp; r < L::BM; r += kWarps) {
    layernorm_row<D>(xs + r * L::LD, ln1_s, ln1_b, lane, v);
#pragma unroll
    for (int i = 0; i < L::PER_LANE; ++i) ys[r * L::LD + lane + 32 * i] = __float2bfloat16(v[i]);
  }

  AccFrag acc[L::FM][L::FN];
  tile_gemm<D>(xs, h_res, chunks, acc, wm, wn);  // residual first: frees xs
  epilogue<D, kRound>(acc, xs, nullptr, nullptr, scratch, wm, wn, lane);
  if constexpr (kUnfolded) {
    tile_gemm<D>(ys, h_pre, chunks, acc, wm, wn);
    epilogue<D, kRound>(acc, ys, nullptr, nullptr, scratch, wm, wn, lane);
  }
  tile_gemm<D>(ys, w1f, chunks, acc, wm, wn);
  epilogue<D, kBiasGelu>(acc, ys, nullptr, b1, scratch, wm, wn, lane);
  tile_gemm<D>(ys, w2, chunks, acc, wm, wn);
  epilogue<D, kBiasGelu>(acc, ys, nullptr, b2, scratch, wm, wn, lane);
  tile_gemm<D>(ys, h_post, chunks, acc, wm, wn);
  epilogue<D, kAddResidual>(acc, ys, xs, nullptr, scratch, wm, wn, lane);
  __syncthreads();

  for (int r = warp; r < L::BM; r += kWarps) {
    if (row0 + r >= n) break;
    layernorm_row<D>(ys + r * L::LD, ln2_s, ln2_b, lane, v);
#pragma unroll
    for (int i = 0; i < L::PER_LANE; ++i)
      out[(row0 + r) * D + lane + 32 * i] = __float2bfloat16(v[i]);
  }
}

template <int D, bool kUnfolded>
cudaError_t launch(const void* x, void* out, long long n, const void* h_pre, const void* w1f,
                   const void* b1, const void* w2, const void* b2, const void* h_post,
                   const void* h_res, const void* ln1_s, const void* ln1_b, const void* ln2_s,
                   const void* ln2_b, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = cudaFuncSetAttribute(mhc_block_kernel<D, kUnfolded>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + L::BM - 1) / L::BM;
  mhc_block_kernel<D, kUnfolded><<<static_cast<unsigned>(blocks), kThreads, L::kSmemBytes,
                                   stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), n, static_cast<const bf16*>(h_pre),
      static_cast<const bf16*>(w1f), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(h_post), static_cast<const bf16*>(h_res),
      static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
      static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b));
  return cudaGetLastError();
}

template <bool kUnfolded>
int dispatch(const void* x, void* out, long long n, int d, const void* h_pre, const void* w1,
             const void* b1, const void* w2, const void* b2, const void* h_post,
             const void* h_res, const void* ln1_s, const void* ln1_b, const void* ln2_s,
             const void* ln2_b, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVS_MHC_CASE(D)                                                                    \
  case D:                                                                                  \
    return static_cast<int>(launch<D, kUnfolded>(x, out, n, h_pre, w1, b1, w2, b2, h_post, \
                                                 h_res, ln1_s, ln1_b, ln2_s, ln2_b, s));
  switch (d) {
    HVS_MHC_CASE(32)
    HVS_MHC_CASE(64)
    HVS_MHC_CASE(128)
    HVS_MHC_CASE(256)
    HVS_MHC_CASE(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HVS_MHC_CASE
}

}  // namespace

// Plain C entry points, loaded with ctypes. Every pointer is a device pointer;
// x and out are [n, d] bf16 row-major, the matrices [d, d] bf16 row-major
// (applied as row @ W), the six vectors [d] fp32. Each returns the CUDA error
// code of the launch (0 on success).

// Serve mode: H_pre folded into w1f.
extern "C" int hvs_mhc_block(const void* x, void* out, long long n, int d, const void* w1f,
                             const void* b1, const void* w2, const void* b2, const void* h_post,
                             const void* h_res, const void* ln1_s, const void* ln1_b,
                             const void* ln2_s, const void* ln2_b, void* stream) {
  return dispatch<false>(x, out, n, d, nullptr, w1f, b1, w2, b2, h_post, h_res, ln1_s, ln1_b,
                         ln2_s, ln2_b, stream);
}

// Unfolded mode: y @ H_pre (rounded to bf16), then y @ W1.
extern "C" int hvs_mhc_block_unfolded(const void* x, void* out, long long n, int d,
                                      const void* h_pre, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* h_post,
                                      const void* h_res, const void* ln1_s, const void* ln1_b,
                                      const void* ln2_s, const void* ln2_b, void* stream) {
  return dispatch<true>(x, out, n, d, h_pre, w1, b1, w2, b2, h_post, h_res, ln1_s, ln1_b,
                        ln2_s, ln2_b, stream);
}
