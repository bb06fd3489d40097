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
//   out = bf16(LN2(r + y))                   r + y and LN2 in fp32
//
// Products take bf16 operands and accumulate in fp32; GELU is the tanh form.
// The residual sum is not rounded, as XLA compiles the JAX layer (and the TPU
// kernel): where H_res and H_post are near uniform, the sum's spread across
// channels lies under one bf16 step of its mean, and a rounded sum would leave
// LN2 normalising rounding noise.
// The TPU kernel's token packing (block-diagonal weights, LayerNorm as a
// matmul) exists only for the TPU's 128 lanes and is not carried over: rows
// are read as [n, d] directly.
//
// What bounds it on an H100: 8*n*d^2 FLOP (10*n*d^2 unfolded) against 4*n*d
// bytes of activations (plus 4 or 5 d^2 weights), about 2*d FLOP per byte.
// That is below the card's ridge (~295 FLOP/B) at d <= 128, so there the
// kernel is memory-bound, and above it at d >= 256, where it is bound by the
// tensor cores.
//
// Design:
//   * one block per tile of BM token rows, one tile per width (Config);
//   * the x tile is read from device memory once (cp.async, rows past n
//     zero-filled) and the output is written once, 16 bytes per lane straight
//     from LayerNorm's registers, rows past n never;
//   * LayerNorm: each lane holds 16-byte pieces of a row and a warp
//     normalises several rows at once (8, 4, 2, 2, 1 at d = 32 ... 512),
//     shuffle reductions within the row's lanes, exact two-pass fp32
//     statistics;
//   * the bf16 intermediate tile stays in shared memory between the products;
//   * products are mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//     registers); A operands come from the padded row-major tiles with
//     ldmatrix.x4, B operands from the row-major [k, n] weights with
//     ldmatrix.x4.trans; the +8-element row padding keeps both free of bank
//     conflicts. Each warp owns a fixed WM x WN block of the output tile;
//   * the epilogue (rounding, bias, GELU, residual add) runs on the
//     accumulators in registers, from the mma's documented layout (lane t
//     holds rows t/4 and t/4 + 8 of each 16x8 tile, columns 2(t%4) and
//     2(t%4)+1), and writes bf16 pairs into the shared tile; the last one
//     writes the fp32 residual sum over the whole of shared memory, which is
//     free by then, for LN2;
//   * the [d, d] weights stream from L2 through a ring of kStages k-chunks
//     (cp.async, one block barrier per chunk; 3 stages, 2 where a third
//     would leave room for fewer blocks per SM); the first chunks of
//     the next product are requested before the epilogue of the current one;
//   * registers are capped per tile (kMinBlocks) and the row loops stay
//     rolled, so that two or more blocks share an SM and one block's
//     LayerNorm and epilogues overlap another's products;
//   * unfolded mode is a template flag: one more product with a plain
//     rounding epilogue before the W1 product.
// Holding the weights in shared memory in persistent blocks at d <= 128 was
// built and measured slower (fewer blocks per SM, static tile order), and a
// second, larger row tile at d = 256 chosen by the row count measured no
// faster than this one tile; they and wgmma, TMA and warp specialisation are
// left for later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;
constexpr size_t kMaxBlockSmem = 232448;  // what one block may use on an H100 (227 KB)
constexpr int kMaxDevices = 16;

// The tile of one width. BM: token rows per block (ops/mhc_block.py::ROW_TILE
// lists the same); kThreads: threads per block; kMinBlocks: blocks an SM
// must hold at once (caps the registers per thread). WARPS_M: warps along the
// rows of the tile (the rest split the d columns). KC: weight rows per
// streamed chunk; kStages: chunks in the ring. Chosen by measurement on an
// H100 (PERF.md).
template <int D> struct Config;
template <> struct Config<32> {
  static constexpr int BM = 128, kThreads = 256, kMinBlocks = 4, WARPS_M = 8, KC = 32,
                       kStages = 3;
};
template <> struct Config<64> {
  static constexpr int BM = 128, kThreads = 256, kMinBlocks = 3, WARPS_M = 4, KC = 64,
                       kStages = 3;
};
template <> struct Config<128> {
  static constexpr int BM = 64, kThreads = 256, kMinBlocks = 3, WARPS_M = 4, KC = 64,
                       kStages = 3;
};
template <> struct Config<256> {
  // Two chunks of 32 rows: a third would leave room for one block per SM.
  static constexpr int BM = 64, kThreads = 256, kMinBlocks = 2, WARPS_M = 2, KC = 32,
                       kStages = 2;
};
template <> struct Config<512> {
  // Two stages: a third would take the block past half an SM's shared memory.
  static constexpr int BM = 32, kThreads = 256, kMinBlocks = 2, WARPS_M = 2, KC = 16,
                       kStages = 2;
};

template <int D, bool kUnfolded>
struct Layout {
  using C = Config<D>;
  static constexpr int kD = D, kBM = C::BM;
  static constexpr int kThreads = C::kThreads;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int WARPS_M = C::WARPS_M;
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int WM = kBM / WARPS_M;  // output rows per warp
  static constexpr int WN = D / WARPS_N;   // output columns per warp
  static constexpr int MI = WM / 16;       // 16-row mma tiles per warp
  static constexpr int NI = WN / 8;        // 8-column mma tiles per warp
  static constexpr int LD = D + 8;         // padded smem row stride (elements)
  static constexpr int KC = C::KC;
  static constexpr int kChunks = D / KC;
  static constexpr int kStages = C::kStages;
  static constexpr int kRing = kChunks < kStages ? kChunks : kStages;  // chunk buffers
  static constexpr int kMats = kUnfolded ? 5 : 4;
  static constexpr size_t kTileBytes = size_t(kBM) * LD * sizeof(bf16);
  static constexpr size_t kChunkBytes = size_t(KC) * LD * sizeof(bf16);
  // The x tile (later the residual), the intermediate tile and the ring; at the
  // end the fp32 residual sum [kBM, LD] covers them (it fits at every width).
  static constexpr size_t kSumBytes = size_t(kBM) * LD * sizeof(float);
  static constexpr size_t kStageBytes = 2 * kTileBytes + kRing * kChunkBytes;
  static constexpr size_t kSmemBytes = kStageBytes > kSumBytes ? kStageBytes : kSumBytes;
  static_assert(kWarps % WARPS_M == 0 && kBM % WARPS_M == 0 && D % WARPS_N == 0,
                "uneven warp grid");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "a warp owns whole 16x16 pairs of mma tiles");
  static_assert(D % KC == 0 && KC % 16 == 0 && kStages >= 2, "k-chunks must tile d");
  static_assert(kTileBytes % 128 == 0 && kChunkBytes % 128 == 0,
                "smem regions must stay aligned");
  static_assert(kSmemBytes <= kMaxBlockSmem, "the block's shared memory exceeds 227 KB");
};

enum Epilogue { kRound = 0, kBiasGelu = 1 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// GELU, tanh form, with the exact fp32 tanh (tanhf), its argument and product
// in the order of PyTorch's CUDA gelu(approximate="tanh"), so that the kernel
// and its plain version round the same GELU values to bf16. Where LN2 has a
// large gain (H_post near 1), the hardware tanh's 2^-10.9 relative error
// moved the block's output far from the plain version's (PERF.md).
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k_kappa = 0.044715f;
  const float cube = v * v * v;
  const float inner = k_beta * (v + k_kappa * cube);
  return 0.5f * v * (1.0f + tanhf(inner));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a @ b for one 16x8 tile: a 16x16 (row), b 16x8 (col), fp32 c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + ROWS) of a row-major [n, D] array into a padded smem
// tile with cp.async (the caller commits); rows past n become zeros.
template <int D, int ROWS, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, long long row0,
                                          long long n) {
  constexpr int kVecPerRow = D / 8;
#pragma unroll 1
  for (int v = threadIdx.x; v < ROWS * kVecPerRow; v += kThreads) {
    const int r = v / kVecPerRow;
    const int c = (v % kVecPerRow) * 8;
    const bool in = row0 + r < n;
    cp_async16(dst + r * (D + 8) + c, in ? src + (row0 + r) * D + c : src, in ? 16 : 0);
  }
}

// LayerNorm of every row of the smem tile src (bf16, or fp32 for LN2), rounded
// to bf16, into the smem tile dst or (kToGlobal) into rows first + r < n of
// out. Both tiles have the row stride L::LD elements. A row is held
// by kLanes lanes, each with kVecs 16-byte pieces of it, so a warp normalises
// 32 / kLanes rows at once and each statistic is a log2(kLanes)-step shuffle
// reduction. Exact fp32 statistics, two-pass variance.
template <class L, bool kToGlobal, class T>
__device__ __forceinline__ void layernorm_tile(const T* src, bf16* dst, bf16* __restrict__ out,
                                               long long first, long long n,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias, int warp,
                                               int lane) {
  constexpr int D = L::kD;
  // Lanes per row: a 16-byte piece each up to d = 128, two at d = 256 (two
  // rows per warp, measured faster than one), two at d = 512.
  constexpr int kLanes = D / 8 < 16 ? D / 8 : (D >= 512 ? 32 : 16);
  constexpr int kVecs = D / 8 / kLanes;            // 8-element pieces per lane
  constexpr int kRowsPerWarp = 32 / kLanes;
  static_assert(L::kBM % (L::kWarps * kRowsPerWarp) == 0, "rows must split evenly over warps");
  const int sub = lane / kLanes;  // row of this lane within the warp's rows
  const int sl = lane % kLanes;   // this lane's place within the row
  float sc[kVecs][8], bi[kVecs][8];
#pragma unroll
  for (int p = 0; p < kVecs; ++p) {
    const int c = (p * kLanes + sl) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[p][e] = __ldg(scale + c + e);
      bi[p][e] = __ldg(bias + c + e);
    }
  }
  // Row loops stay rolled: unrolled, they take registers the products need.
#pragma unroll 1
  for (int r = warp * kRowsPerWarp + sub; r < L::kBM; r += L::kWarps * kRowsPerWarp) {
    float v[kVecs][8];
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < kVecs; ++p) {
      const T* piece = src + r * L::LD + (p * kLanes + sl) * 8;
      if constexpr (sizeof(T) == sizeof(float)) {
        const float4 lo = *reinterpret_cast<const float4*>(piece);
        const float4 hi = *reinterpret_cast<const float4*>(piece + 4);
        v[p][0] = lo.x, v[p][1] = lo.y, v[p][2] = lo.z, v[p][3] = lo.w;
        v[p][4] = hi.x, v[p][5] = hi.y, v[p][6] = hi.z, v[p][7] = hi.w;
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(piece);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[p][2 * e] = __low2float(h[e]);
          v[p][2 * e + 1] = __high2float(h[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s += v[p][2 * e] + v[p][2 * e + 1];
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s * (1.0f / D);
    float q = 0.0f;
#pragma unroll
    for (int p = 0; p < kVecs; ++p)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[p][e] -= mu;
        q += v[p][e] * v[p][e];
      }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rs = rsqrtf(q * (1.0f / D) + kLnEps);
#pragma unroll
    for (int p = 0; p < kVecs; ++p) {
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(v[p][2 * e] * rs * sc[p][2 * e] + bi[p][2 * e],
                                     v[p][2 * e + 1] * rs * sc[p][2 * e + 1] + bi[p][2 * e + 1]);
      const int c = (p * kLanes + sl) * 8;
      if constexpr (kToGlobal) {
        if (first + r < n) *reinterpret_cast<uint4*>(out + (first + r) * D + c) = packed;
      } else {
        *reinterpret_cast<uint4*>(dst + r * L::LD + c) = packed;
      }
    }
  }
}

template <class L>
__device__ __forceinline__ void zero(float (&acc)[L::MI][L::NI][4]) {
#pragma unroll
  for (int i = 0; i < L::MI; ++i)
#pragma unroll
    for (int j = 0; j < L::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// acc += a[this warp's rows, 16*KSTEPS columns] @ b[16*KSTEPS rows, this
// warp's columns]. a and b are the shared addresses of this lane's ldmatrix
// row (a_lane and b_lane below) at the first k of the two padded arrays.
template <class L, int KSTEPS>
__device__ __forceinline__ void mma_steps(float (&acc)[L::MI][L::NI][4], uint32_t a, uint32_t b) {
  constexpr uint32_t kRow = L::LD * sizeof(bf16);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t af[L::MI][4];
#pragma unroll
    for (int i = 0; i < L::MI; ++i) ldsm_x4(af[i], a + i * 16 * kRow + ks * 32);
#pragma unroll
    for (int j = 0; j < L::NI / 2; ++j) {
      uint32_t bfr[4];  // k 0-7 / 8-15 of columns j*16 + 0-7, then of + 8-15
      ldsm_x4_trans(bfr, b + ks * 16 * kRow + j * 32);
#pragma unroll
      for (int i = 0; i < L::MI; ++i) {
        mma_bf16(acc[i][2 * j], af[i], bfr[0], bfr[1]);
        mma_bf16(acc[i][2 * j + 1], af[i], bfr[2], bfr[3]);
      }
    }
  }
}

// ldmatrix.x4 takes one row address from each lane: rows 0-15 of a 16-row
// block at column 0 (lanes 0-15) and at column 8 (lanes 16-31). For A that is
// the 16x16 tile (rows, k); for B (rows k, columns n) two 8-column tiles.
template <class L>
__device__ __forceinline__ uint32_t a_lane(const bf16* a, int lane, int row0) {
  return smem_u32(a + (row0 + (lane & 15)) * L::LD + (lane >> 4) * 8);
}

template <class L>
__device__ __forceinline__ uint32_t b_lane(const bf16* b, int lane, int col0) {
  return smem_u32(b + (lane & 15) * L::LD + col0 + (lane >> 4) * 8);
}

// Requests the first kStages - 1 chunks of the [D, D] weight w into the ring
// (one cp.async group per chunk, empty past the last chunk).
template <class L>
__device__ __forceinline__ void prefetch(bf16* ring, const bf16* __restrict__ w) {
  constexpr int D = L::kD;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < L::kChunks) load_rows<D, L::KC, L::kThreads>(ring + s * L::KC * L::LD, w, s * L::KC, D);
    cp_async_commit();
  }
}

// acc = a @ mat[I] with the weight streamed through the ring, whose first
// chunks prefetch requested. One block barrier per chunk: it publishes chunk
// kc and frees the buffer of chunk kc - 1 for chunk kc + kStages - 1. Ends
// with a barrier (the caller may then overwrite a) and requests the first
// chunks of mat[I + 1], if any.
template <class L, int I>
__device__ __forceinline__ void product(float (&acc)[L::MI][L::NI][4], const bf16* a,
                                        const bf16* const (&mat)[L::kMats], bf16* ring, int lane,
                                        int row0, int col0) {
  constexpr int D = L::kD;
  zero<L>(acc);
#pragma unroll 1
  for (int kc = 0; kc < L::kChunks; ++kc) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();
    const int next = kc + L::kStages - 1;
    if (next < L::kChunks)
      load_rows<D, L::KC, L::kThreads>(ring + (next % L::kStages) * L::KC * L::LD, mat[I],
                                       next * L::KC, D);
    cp_async_commit();
    mma_steps<L, L::KC / 16>(
        acc, a_lane<L>(a, lane, row0) + kc * L::KC * sizeof(bf16),
        b_lane<L>(ring + (kc % L::kStages) * L::KC * L::LD, lane, col0));
  }
  __syncthreads();
  if constexpr (I + 1 < L::kMats) prefetch<L>(ring, mat[I + 1]);
}

// Writes this warp's accumulators into the smem tile dst, rounding to bf16
// at the same points as the plain version:
//   kRound:       dst = bf16(acc)
//   kBiasGelu:    dst = bf16(gelu(bf16(bf16(acc) + bf16(bias))))
template <class L, int kMode>
__device__ __forceinline__ void epilogue(const float (&acc)[L::MI][L::NI][4], bf16* dst,
                                         const float* __restrict__ bias, int lane, int row0,
                                         int col0) {
  const int g = lane >> 2;       // row within the 8-row half of a 16x8 tile
  const int t2 = (lane & 3) * 2;  // first of this lane's two columns
#pragma unroll
  for (int j = 0; j < L::NI; ++j) {
    const int col = col0 + j * 8 + t2;
    float b0 = 0.0f, b1 = 0.0f;
    if constexpr (kMode == kBiasGelu) {
      b0 = round_bf16(__ldg(bias + col));
      b1 = round_bf16(__ldg(bias + col + 1));
    }
#pragma unroll
    for (int i = 0; i < L::MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + i * 16 + g + 8 * h;
        float v0 = round_bf16(acc[i][j][2 * h]);
        float v1 = round_bf16(acc[i][j][2 * h + 1]);
        if constexpr (kMode == kBiasGelu) {
          v0 = gelu_tanh(round_bf16(v0 + b0));
          v1 = gelu_tanh(round_bf16(v1 + b1));
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + row * L::LD + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// acc = bf16(acc) + res in fp32, in place: the residual sum that LN2 takes
// unrounded (res: the bf16 tile of x @ H_res).
template <class L>
__device__ __forceinline__ void add_residual(float (&acc)[L::MI][L::NI][4], const bf16* res,
                                             int lane, int row0, int col0) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < L::NI; ++j)
#pragma unroll
    for (int i = 0; i < L::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + i * 16 + g + 8 * h;
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(res + row * L::LD + col0 + j * 8 + t2);
        acc[i][j][2 * h] = round_bf16(acc[i][j][2 * h]) + __low2float(r);
        acc[i][j][2 * h + 1] = round_bf16(acc[i][j][2 * h + 1]) + __high2float(r);
      }
}

// This warp's accumulators into the fp32 smem tile dst (row stride L::LD).
template <class L>
__device__ __forceinline__ void store_f32(const float (&acc)[L::MI][L::NI][4], float* dst,
                                          int lane, int row0, int col0) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < L::NI; ++j)
#pragma unroll
    for (int i = 0; i < L::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + i * 16 + g + 8 * h;
        *reinterpret_cast<float2*>(dst + row * L::LD + col0 + j * 8 + t2) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <int D, bool kUnfolded>
__global__ void __launch_bounds__(Config<D>::kThreads, Config<D>::kMinBlocks)
    mhc_block_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, long long n,
                     const bf16* __restrict__ h_pre,
                     const bf16* __restrict__ w1f, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ b2,
                     const bf16* __restrict__ h_post, const bf16* __restrict__ h_res,
                     const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                     const float* __restrict__ ln2_s, const float* __restrict__ ln2_b) {
  using L = Layout<D, kUnfolded>;
  constexpr int BM = L::kBM, T = L::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (warp / L::WARPS_N) * L::WM;  // this warp's block of the output tile
  const int col0 = (warp % L::WARPS_N) * L::WN;
  const long long first = static_cast<long long>(blockIdx.x) * BM;

  // The chain's matrices in the order the products use them.
  constexpr int kPre = 1, kW1 = kUnfolded ? 2 : 1;
  const bf16* mat[L::kMats];
  mat[0] = h_res;
  if constexpr (kUnfolded) mat[kPre] = h_pre;
  mat[kW1] = w1f;
  mat[kW1 + 1] = w2;
  mat[kW1 + 2] = h_post;

  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = xs + BM * L::LD;
  bf16* ring = ys + BM * L::LD;
  load_rows<D, BM, T>(xs, x, first, n);
  cp_async_commit();
  prefetch<L>(ring, mat[0]);
  cp_async_wait<L::kStages - 1>();  // the x tile; the weight chunks may still fly
  __syncthreads();

  layernorm_tile<L, false>(xs, ys, nullptr, first, n, ln1_s, ln1_b, warp, lane);
  float acc[L::MI][L::NI][4];
  product<L, 0>(acc, xs, mat, ring, lane, row0, col0);  // residual first: frees xs
  epilogue<L, kRound>(acc, xs, nullptr, lane, row0, col0);
  if constexpr (kUnfolded) {
    product<L, kPre>(acc, ys, mat, ring, lane, row0, col0);
    epilogue<L, kRound>(acc, ys, nullptr, lane, row0, col0);
  }
  product<L, kW1>(acc, ys, mat, ring, lane, row0, col0);
  epilogue<L, kBiasGelu>(acc, ys, b1, lane, row0, col0);
  product<L, kW1 + 1>(acc, ys, mat, ring, lane, row0, col0);
  epilogue<L, kBiasGelu>(acc, ys, b2, lane, row0, col0);
  product<L, kW1 + 2>(acc, ys, mat, ring, lane, row0, col0);
  add_residual<L>(acc, xs, lane, row0, col0);
  __syncthreads();  // every residual read: the fp32 sum may now cover xs, ys and the ring
  float* sum = reinterpret_cast<float*>(smem);
  store_f32<L>(acc, sum, lane, row0, col0);
  __syncthreads();
  layernorm_tile<L, true>(sum, nullptr, out, first, n, ln2_s, ln2_b, warp, lane);
}

// Per device: whether the instantiation's shared-memory limit is set.
template <int D, bool kUnfolded>
std::atomic<bool> smem_limit_set[kMaxDevices];

template <int D, bool kUnfolded>
cudaError_t launch(const void* x, void* out, long long n, const void* h_pre,
                   const void* w1f, const void* b1, const void* w2, const void* b2,
                   const void* h_post, const void* h_res, const void* ln1_s, const void* ln1_b,
                   const void* ln2_s, const void* ln2_b, cudaStream_t stream) {
  using L = Layout<D, kUnfolded>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_limit_set<D, kUnfolded>[dev].load()) {
    err = cudaFuncSetAttribute(mhc_block_kernel<D, kUnfolded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmemBytes));
    if (err != cudaSuccess) return err;
    smem_limit_set<D, kUnfolded>[dev].store(true);
  }
  const long long tiles = (n + L::kBM - 1) / L::kBM;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mhc_block_kernel<D, kUnfolded><<<static_cast<unsigned>(tiles), L::kThreads, L::kSmemBytes,
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
// (applied as row @ W), the six vectors [d] fp32. One block runs per tile of
// Config<d>::BM rows. Each returns the CUDA error code of the launch (0 on
// success).

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
