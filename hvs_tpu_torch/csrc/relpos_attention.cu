// Attention with ViTDet's decomposed relative positions for Hopper (sm_90a),
// flash-style: neither the [T, T] logits nor the relative terms reach device
// memory.
//
// It replaces no TPU kernel: the JAX package has no ViTDet. In plain PyTorch
// one global block of ViTDet-B at 1024^2 would write, read, cast and
// softmax fp32 logits of 805 MB a frame, and its relative terms alone are a
// 50 MB fp32 product a frame.
//
// Per problem (image or window n, head h) of a kh x kw grid of T = kh*kw
// tokens, head width 64, for each query t = (y, x) and key s = (ky, kx):
//
//   rel_h[t, ky] = q[t] . table_h[kh - 1 + y - ky]
//   rel_w[t, kx] = q[t] . table_w[kw - 1 + x - kx]
//   logit[t, s]  = (q[t] . k[s]) / 8 + rel_h[t, ky] + rel_w[t, kx]
//   out[t]       = bf16(sum_s softmax_s(logit[t, s]) v[s])
//
// q, k, v are bf16 and the tables fp32 ([2kh - 1, 64] and [2kw - 1, 64],
// contiguous). The relative terms are the fp32 products of q's bf16 values
// (exact in fp32) with the fp32 tables; q k^T accumulates in fp32 on the
// tensor cores, the scale 1/8 is exact, the softmax is an online fp32 one;
// its probabilities are rounded to bf16 for the product with v, their sum is
// not.
//
// Layout: q, k, v [N, kh, kw, H, 64] with element strides (n, y, x, head)
// given and the last 1 (views of the qkv projection's [N, kh, kw, 3, H, 64]
// output are read in place); out a contiguous [N, kh, kw, H, 64] bf16.
// kh, kw <= 64.
//
// What bounds it on an H100: 4*64*H*T^2 flops a problem against bytes that
// grow with T (q, k, v, out), so at T = 4,096 (global) and 196 (window) the
// tensor cores; then the exponentials (T^2 per head, 16 per clock per SM).
//
// Design:
//   * one block of 4 warps per (query tile, problem): blockIdx.x the query
//     tile, so a problem's tiles run side by side and share k and v in L2;
//     the tile is 128 queries, 32 rows a warp, in the aligned case below, and
//     64, 16 rows a warp, in the general one (Shape);
//   * q's tile, then k and v tiles of 64 keys, arrive by cp.async (16 bytes a
//     lane, rows past T zero-filled) into padded smem rows (+8 elements: no
//     bank conflicts for ldmatrix); k and v are double-buffered, the next
//     tile in flight while this one is used;
//   * products are mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//     registers): q fragments by ldmatrix.x4 once, k by ldmatrix.x4 (k's rows
//     are the B operand's columns), v by ldmatrix.x4.trans; the probabilities
//     go from the logits' accumulators straight into the A fragments of the
//     product with v;
//   * the relative terms, computed while the first k and v tile is in flight
//     (relative_term): each warp multiplies the q fragments it holds for q k^T
//     by the table rows its queries need, on the tensor cores. Each fp32
//     table value is split into three bf16 parts whose sum is the value
//     exactly (split3), so every product with q is exact and only the fp32
//     sum differs from an fp32 product, in its order. On CUDA cores the same
//     terms would take ~1 M FMAs a global block; here they take 480 mma a warp
//     (6 % of its q k^T and p v) and ~8 table loads from L1 per 24 mma. The
//     block's rows of rel_w are kept in smem after the k and v tiles, those
//     of rel_h in the q tile's place, which is free once q's fragments are in
//     registers: the aligned block stays at 105 KB, two an SM, the general
//     one at 49 KB for 14 x 14 windows, three an SM;
//   * the bias: a key's (ky, kx) from its index by a float reciprocal of kw
//     (exact for kh, kw <= 64), both terms from smem; where kw is the key tile
//     (64, the global blocks at 1024^2) tile j is grid row ky = j and column c
//     is kx = c: a row's rel_h term is one smem read a tile, rel_w's rows
//     (kw + 8 long) are read 8 bytes a lane without bank conflicts;
//   * keys past T get -inf, so a window's ragged last tile (196 = 3 * 64 + 4)
//     adds nothing; padded queries past T are computed and not written;
//   * the output tile is staged in the q tile's smem and written in 16-byte
//     pieces.
// wgmma, TMA and warp specialisation are left for later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head width
constexpr int kWarps = 4;
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;    // padded smem row, elements
constexpr int kMaxSide = 64;
constexpr int kMaxGridY = 65535;
constexpr int kMaxDevices = 16;
constexpr float kScale = 0.125f;  // 1 / sqrt(64)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// The two cases of the kernel. kAligned: kw is the key tile (64), so key tile
// j is grid row j; its blocks take 128 queries, 32 rows a warp (two 16-row mma
// tiles, so each k and v fragment read from smem serves two products), two
// blocks an SM. The general case (the windows): 64 queries, 16 rows a warp,
// fewer registers, three blocks an SM, so short problems (4 key tiles at 196
// tokens) overlap one another's loads.
template <bool kAligned>
struct Shape {
  static constexpr int kMT = kAligned ? 2 : 1;  // 16-row mma tiles per warp
  static constexpr int kBM = kWarps * kMT * 16;  // queries per block
  static constexpr int kMinBlocks = kAligned ? 2 : 3;
  // Smem: the q tile (bf16), whose place rel_h's rows of kh + 1 (fp32) take
  // once q's fragments are in registers; two k and two v tiles (bf16); rel_w's
  // rows (fp32) of kw + 8 in the aligned case, else kw + 1.
  __host__ __device__ static constexpr int ldw(int kw) { return kAligned ? kw + 8 : kw + 1; }
  __host__ __device__ static constexpr size_t head_bytes(int kh) {
    return cmax(size_t(kBM) * kLd * sizeof(bf16), size_t(kBM) * (kh + 1) * sizeof(float));
  }
  __host__ __device__ static constexpr size_t smem_bytes(int kh, int kw) {
    return head_bytes(kh) + size_t(4 * kBN) * kLd * sizeof(bf16) +
           size_t(kBM) * ldw(kw) * sizeof(float);
  }
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* table_h;
  const float* table_w;
  bf16* out;
  int heads, kh, kw, T;
  long long qs[4];  // q's (and k's, v's) strides over (n, y, x, head), elements
  float inv_kw;
  int g0;  // the first (n, head) problem of this launch
};

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

// c += a @ b for one 16x8 tile: a 16x16 (row), b 16x8 (col), fp32 c. Lane t
// holds c's rows t/4 and t/4 + 8, columns 2(t%4) and 2(t%4) + 1; b's column
// t/4, rows 2(t%4) and 2(t%4) + 1 in b0, 8 more in b1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as three bf16 pairs whose sums are the values exactly: each
// part is the rounding of what the earlier ones left, and an fp32 value's 24
// bits of mantissa fit in three of bf16's 8 (each remainder is exact in fp32).
__device__ __forceinline__ void split3(float2 f, uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    part[i] = *reinterpret_cast<const uint32_t*>(&b);
    const float2 r = __bfloat1622float2(b);
    f.x -= r.x;
    f.y -= r.y;
  }
}

// Offset of token t of problem (n, head) under strides s over (n, y, x, head).
__device__ __forceinline__ long long token_offset(const long long (&s)[4], int n, int head,
                                                  int t, int kw) {
  const int y = t / kw;
  const int x = t - y * kw;
  return n * s[0] + y * s[1] + x * s[2] + head * s[3];
}

// Rows [row0, row0 + 64) of k and v into their smem tiles (the caller commits).
__device__ __forceinline__ void load_kv(bf16* dk, bf16* dv, const Params& p, int n, int head,
                                        int row0) {
#pragma unroll
  for (int i = 0; i < kBN * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = (idx & 7) * 8;
    const int t = row0 + r;
    const bool in = t < p.T;
    const long long off = in ? token_offset(p.qs, n, head, t, p.kw) + c : 0;
    cp_async16(dk + r * kLd + c, p.k + off, in ? 16 : 0);
    cp_async16(dv + r * kLd + c, p.v + off, in ? 16 : 0);
  }
}

// One relative term of this warp's queries into the block's smem rows:
// dst[row * ld + c] = q[t] . table[side - 1 + pos(t) - c] for c in [0, side),
// pos the query's x (along_x, rel_w) or y (rel_h). The warp's queries (rows
// row0 on, first = m0 + row0 on) need the table rows [lo, hi + side - 1],
// lo and hi their least and greatest pos; each 8 of those rows are the B
// operand of mma against the q fragments qf, once for each bf16 part of
// split3, read from the table (L1: every block of a launch reads the same
// one) as 8 bytes a lane. A product whose column falls outside [0, side) is
// dropped. Rows past T get what their zero q gives, or nothing; they are
// never written out.
template <int kMT>
__device__ __forceinline__ void relative_term(float* dst, int ld, const float* __restrict__ table,
                                              int side, bool along_x,
                                              const uint32_t (&qf)[kMT][4][4], int row0, int m0,
                                              const Params& p) {
  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int first = m0 + row0;
  if (first >= p.T) return;
  const int last = min(first + 16 * kMT, p.T) - 1;
  const int yf = first / p.kw, yl = last / p.kw;
  int lo = yf, hi = yl;
  if (along_x) {
    lo = yf == yl ? first - yf * p.kw : 0;
    hi = yf == yl ? last - yl * p.kw : p.kw - 1;
  }
  int pos[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = first + mt * 16 + (lane >> 2) + 8 * h;
      const int y = t / p.kw;
      pos[mt][h] = along_x ? t - y * p.kw : y;
    }
  const int end = hi + side;  // one past the last table row the warp needs
#pragma unroll 1
  for (int r0 = lo; r0 < end; r0 += 8) {
    const int r = r0 + (lane >> 2);  // this lane's column of the B operand
    const float* src = table + r * kD + 2 * quad;
    float acc[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 zero = make_float2(0.0f, 0.0f);
      uint32_t b0[3], b1[3];
      split3(r < end ? __ldg(reinterpret_cast<const float2*>(src + kk * 16)) : zero, b0);
      split3(r < end ? __ldg(reinterpret_cast<const float2*>(src + kk * 16 + 8)) : zero, b1);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt], qf[mt][kk], b0[i], b1[i]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = side - 1 + pos[mt][h] - (r0 + 2 * quad + e);
          if (c >= 0 && c < side)
            dst[(row0 + mt * 16 + (lane >> 2) + 8 * h) * ld + c] = acc[mt][2 * h + e];
        }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, Shape<kAligned>::kMinBlocks)
    relpos_attention_kernel(const Params p) {
  constexpr int kMT = Shape<kAligned>::kMT;
  constexpr int kBM = Shape<kAligned>::kBM;
  constexpr int kWarpRows = 16 * kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  float* srh = reinterpret_cast<float*>(smem);  // in q's place once qf is loaded
  bf16* sk = reinterpret_cast<bf16*>(smem + Shape<kAligned>::head_bytes(p.kh));
  bf16* sv = sk + 2 * kBN * kLd;
  float* srw = reinterpret_cast<float*>(sv + 2 * kBN * kLd);
  const int ldh = p.kh + 1;
  const int ldw = Shape<kAligned>::ldw(p.kw);

  const int g = p.g0 + blockIdx.y;
  const int n = g / p.heads, head = g - n * p.heads;
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  // This lane's rows of the tile: rows[mt][half], half 0 the mma's rows
  // t/4, half 1 rows t/4 + 8.
  int rows[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    rows[mt][0] = warp * kWarpRows + mt * 16 + (lane >> 2);
    rows[mt][1] = rows[mt][0] + 8;
  }
  const int tiles = (p.T + kBN - 1) / kBN;

  // q's tile, then the first k and v tile, in two groups: the terms need q.
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = (idx & 7) * 8;
    const int t = m0 + r;
    const bool in = t < p.T;
    cp_async16(sq + r * kLd + c, p.q + (in ? token_offset(p.qs, n, head, t, p.kw) + c : 0),
               in ? 16 : 0);
  }
  cp_async_commit();
  load_kv(sk, sv, p, n, head, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(qf[mt][kk], smem_u32(sq + (warp * kWarpRows + mt * 16 + (lane & 15)) * kLd +
                                   kk * 16 + (lane >> 4) * 8));
  __syncthreads();  // every warp holds its q fragments: rel_h takes q's place
  relative_term<kMT>(srh, ldh, p.table_h, p.kh, false, qf, warp * kWarpRows, m0, p);
  relative_term<kMT>(srw, ldw, p.table_w, p.kw, true, qf, warp * kWarpRows, m0, p);

  float o[kMT][8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.0f;
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.0f;
  }

#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles)
      load_kv(sk + (buf ^ 1) * kBN * kLd, sv + (buf ^ 1) * kBN * kLd, p, n, head, (j + 1) * kBN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile, and at j = 0 every warp's terms, visible
    const bf16* ck = sk + buf * kBN * kLd;
    const bf16* cv = sv + buf * kBN * kLd;

    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(ck + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                            ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], b[2], b[3]);
        }
      }
    }

    // Scale, the relative terms, and -inf past T.
    if constexpr (kAligned) {
      float rh[kMT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) rh[mt][h] = srh[rows[mt][h] * ldh + j];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + 2 * quad;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 w = *reinterpret_cast<const float2*>(srw + rows[mt][h] * ldw + c);
            s[mt][nt][2 * h] = (s[mt][nt][2 * h] * kScale + rh[mt][h]) + w.x;
            s[mt][nt][2 * h + 1] = (s[mt][nt][2 * h + 1] * kScale + rh[mt][h]) + w.y;
          }
      }
    } else {
      const int key0 = j * kBN;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + nt * 8 + 2 * quad + e;
          if (key < p.T) {
            const int ky = __float2int_rz((static_cast<float>(key) + 0.5f) * p.inv_kw);
            const int kx = key - ky * p.kw;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = rows[mt][h];
                s[mt][nt][2 * h + e] =
                    (s[mt][nt][2 * h + e] * kScale + srh[r * ldh + ky]) + srw[r * ldw + kx];
              }
          } else {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              s[mt][nt][e] = -INFINITY;
              s[mt][nt][2 + e] = -INFINITY;
            }
          }
        }
      }
    }

    // Online softmax over the tile, every row (a row is spread over a quad):
    // the row maxima and the rescaled accumulators first, then per 16 keys
    // their probabilities and at once their product with v, so that the
    // logits' registers free as the probabilities' fill.
    float b[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
      }
      const float mn0 = fmaxf(m_run[mt][0], mx0), mn1 = fmaxf(m_run[mt][1], mx1);
      const float a0 = exp2f((m_run[mt][0] - mn0) * kLog2e);
      const float a1 = exp2f((m_run[mt][1] - mn1) * kLog2e);
      m_run[mt][0] = mn0;
      m_run[mt][1] = mn1;
      b[mt][0] = mn0 * kLog2e;
      b[mt][1] = mn1 * kLog2e;
      l_run[mt][0] *= a0;
      l_run[mt][1] *= a1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[mt][nt][0] *= a0;
        o[mt][nt][1] *= a0;
        o[mt][nt][2] *= a1;
        o[mt][nt][3] *= a1;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pf[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* sv4 = s[mt][2 * t + u];
          const float p0 = exp2f(sv4[0] * kLog2e - b[mt][0]);
          const float p1 = exp2f(sv4[1] * kLog2e - b[mt][0]);
          const float p2 = exp2f(sv4[2] * kLog2e - b[mt][1]);
          const float p3 = exp2f(sv4[3] * kLog2e - b[mt][1]);
          l_run[mt][0] += p0 + p1;
          l_run[mt][1] += p2 + p3;
          pf[mt][2 * u] = pack_bf16(p0, p1);
          pf[mt][2 * u + 1] = pack_bf16(p2, p3);
        }
      }
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_u32(cv + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                   dp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * dp], pf[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * dp + 1], pf[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // Normalise, stage this warp's rows in the q tile, write 16-byte pieces.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float l0 = l_run[mt][0], l1 = l_run[mt][1];
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, d);
      l1 += __shfl_xor_sync(0xffffffffu, l1, d);
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(sq + rows[mt][0] * kLd + c) =
          __floats2bfloat162_rn(o[mt][nt][0] * inv0, o[mt][nt][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(sq + rows[mt][1] * kLd + c) =
          __floats2bfloat162_rn(o[mt][nt][2] * inv1, o[mt][nt][3] * inv1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kWarpRows / 4; ++i) {
    const int idx = lane + 32 * i;
    const int r = warp * kWarpRows + (idx >> 3), c = (idx & 7) * 8;
    const int t = m0 + r;
    if (t < p.T) {
      const long long off = ((static_cast<long long>(n) * p.T + t) * p.heads + head) * kD + c;
      *reinterpret_cast<uint4*>(p.out + off) = *reinterpret_cast<const uint4*>(sq + r * kLd + c);
    }
  }
}

template <bool kAligned>
cudaError_t launch(Params p, int problems, cudaStream_t stream) {
  static std::atomic<bool> smem_limit_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_limit_set[dev].load()) {
    // The most a launch asks for: kh = 64, and kw = 64 aligned, else 63.
    constexpr size_t kMaxSmem =
        Shape<kAligned>::smem_bytes(kMaxSide, kAligned ? kBN : kMaxSide - 1);
    err = cudaFuncSetAttribute(relpos_attention_kernel<kAligned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    smem_limit_set[dev].store(true);
  }
  const dim3 block(kThreads);
  constexpr int kBM = Shape<kAligned>::kBM;
  const unsigned query_tiles = (p.T + kBM - 1) / kBM;
  const size_t smem = Shape<kAligned>::smem_bytes(p.kh, p.kw);
  for (int g0 = 0; g0 < problems; g0 += kMaxGridY) {
    p.g0 = g0;
    const int count = problems - g0 < kMaxGridY ? problems - g0 : kMaxGridY;
    relpos_attention_kernel<kAligned><<<dim3(query_tiles, count), block, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer;
// q's strides are in elements over (n, y, x, head), the last stride 1, and k
// and v share them; the tables are contiguous fp32 [2kh - 1, 64] and
// [2kw - 1, 64] (see the header). Returns the CUDA error code of the launches
// (0 on success).
extern "C" int hvs_relpos_attention(const void* q, const void* k, const void* v,
                                    const void* table_h, const void* table_w, void* out, int n,
                                    int kh, int kw, int heads, long long qs_n, long long qs_y,
                                    long long qs_x, long long qs_h, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxSide || kw > kMaxSide || heads < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.table_h = static_cast<const float*>(table_h);
  p.table_w = static_cast<const float*>(table_w);
  p.out = static_cast<bf16*>(out);
  p.heads = heads;
  p.kh = kh;
  p.kw = kw;
  p.T = kh * kw;
  p.qs[0] = qs_n;
  p.qs[1] = qs_y;
  p.qs[2] = qs_x;
  p.qs[3] = qs_h;
  p.inv_kw = 1.0f / static_cast<float>(kw);
  p.g0 = 0;
  const long long problems = static_cast<long long>(n) * heads;
  if (problems > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = kw == kBN ? launch<true>(p, static_cast<int>(problems), s)
                                    : launch<false>(p, static_cast<int>(problems), s);
  return static_cast<int>(err);
}
