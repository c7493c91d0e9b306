// Tiled GEMMs of the attention block kernels (attention_block_fwd.cu,
// attention_block_bwd.cu): C(z, m, n) = sum_k A(z, m, k) B(z, k, n) with
// f32 accumulation, for float or bfloat16 operands.
//
// The block's six products (q/k/v and the output projection forward;
// dxo, dWo, dW{q,k,v} and dx backward) read their operands in five
// layouts: the rows of x or dout (B, T, D), the head-major (B, H, T_pad,
// dh) q/k/v/o and their gradients, and the weights and their transposes.
// Three routes compute them, chosen from the shape alone by block_route
// (mirrored by ops/attention_block.py:gemm_route):
//
//   * wgmma (bf16, head dim 64 or 128, d_model a multiple of 64): a
//     128 x N output tile per CTA, two consumer warpgroups issuing
//     wgmma.mma_async m64nNk16 (N = 256 where the product's N allows,
//     else 128; f32 accumulators in registers) over 64-deep k stages, fed
//     by one producer warp that keeps TMA loads in flight through a ring
//     of three stages with full and empty mbarriers.
//     Every operand arrives by TMA in its stored layout, as two 64 x 64
//     boxes with 128-byte swizzle; the wgmma descriptor says which
//     operands are MN-major (transposed), so no thread touches a tile.
//     The tensor maps (rank 2 to 4, built on the host per call) replace
//     the index functors below: x and dout as (D, T, B) with the rows
//     past T zero-filled by TMA, the head-major tensors as (dh, T_pad, H,
//     B), the weights as 2-D. M tiles run over the padded grid (b, 128
//     rows of T_pad), so no tile straddles two batch rows; a persistent
//     grid of one CTA per SM walks the tiles, so the next tile's loads
//     overlap this tile's epilogue, which stages a bf16 output through
//     shared memory to store it in 16-byte runs;
//   * mma.sync (other bf16 shapes whose dx K segments, H*dh deep, are
//     whole 32-deep tiles): 64 x 64 tiles, 4 warps of mma.sync m16n8k16,
//     operands staged through registers by the index functors;
//   * SIMT (float32, and bf16 otherwise): 128 x 128 tiles on the CUDA
//     cores, so the f32 sums stay full f32 (TF32 would not be).
//
// The weight gradients are one product over the rows of every batch row
// at once (K = B * T_pad, whose zero rows past T add exact zeros on the
// wgmma route and are skipped on the others), split into a fixed number
// S of K slices (the caller's, from the shape) written as f32 partials
// and summed by the caller in a fixed order: no atomics, so the result
// does not depend on scheduling.
//
// What bounds them: operations (2 M N K per product; the pretraining
// shape's 16 B T D^2 backward FLOP are 0.042 ms at 989 TFLOP/s bf16).
// On the SIMT and mma.sync routes an operand element (i, k) is
//
//   element = base(z, seg)[ioff(z, i) + koff(k)]     (0 where ioff < 0)
//
// `seg` = k / kseg splits K into segments with their own base pointers
// (dx sums three products, dq Wq + dk Wk + dv Wv, over one K); kseg is a
// multiple of the k tile when there is more than one segment. kAlongK
// says which index is adjacent in memory, so the tile loads run along it.
// The epilogue functor receives (z, m, n, sum) for every in-range element;
// on the wgmma route it gives a bf16 output's value(z, n, sum) and the
// address of 8 adjacent outputs (chunk), or takes an f32 partial's two
// adjacent columns (pair).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace blockgemm {

enum Route { kSimt = 0, kMma = 1, kWgmma = 2 };

constexpr int NT = 256;  // threads per CTA of the SIMT variant
constexpr int MBK = 32;  // k per shared-memory tile of the mma.sync variant

// The GEMM route of the block's products, from its shape alone (dtype 0 =
// float32, 1 = bfloat16); ops/attention_block.py:gemm_route mirrors it.
inline int block_route(int dtype, int d_model, int heads, int dh) {
  if (dtype != 1) return kSimt;
  if ((dh == 64 || dh == 128) && d_model % 64 == 0) return kWgmma;
  return (heads * dh) % MBK == 0 ? kMma : kSimt;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
// v rounded to T and back (the TPU kernel's astype before a bias add)
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Rows of a (B, rows, w) tensor on the padded grid: i = b * rows_pad + r,
// zero for r >= rows; k runs along a row.
template <typename T>
struct PaddedRows {
  static constexpr bool kAlongK = true;
  const T* p;
  int rows, rows_pad, w;
  __device__ long long ioff(int, int i) const {
    const int b = i / rows_pad, r = i - b * rows_pad;
    return r < rows ? ((long long)b * rows + r) * w : -1;
  }
  __device__ long long koff(int k) const { return k; }
  __device__ const T* base(int, int) const { return p; }
};

// A (B, H, rows_pad, dh) head-major tensor as rows i = b * rows + r (the
// real rows) and columns k = h * dh + d; one tensor per K segment.
template <typename T>
struct HeadCols {
  static constexpr bool kAlongK = true;
  const T* p[3];
  int rows, rows_pad, heads, lg;  // dh = 1 << lg
  __device__ long long ioff(int, int i) const {
    const int b = i / rows, r = i - b * rows;
    return ((long long)b * heads * rows_pad + r) << lg;
  }
  __device__ long long koff(int k) const {
    return (((long long)(k >> lg) * rows_pad) << lg) + (k & ((1 << lg) - 1));
  }
  __device__ const T* base(int, int seg) const { return p[seg]; }
};

// A (B, H, rows_pad, dh) head-major tensor as columns i = h * dh + d and
// rows k = r of batch row seg (one K segment of rows_pad per batch row);
// tensor p[z].
template <typename T>
struct HeadRows {
  static constexpr bool kAlongK = false;
  const T* p[3];
  int rows_pad, heads, lg;
  __device__ long long ioff(int, int i) const {
    return (((long long)(i >> lg) * rows_pad) << lg) + (i & ((1 << lg) - 1));
  }
  __device__ long long koff(int k) const { return (long long)k << lg; }
  __device__ const T* base(int z, int seg) const {
    return p[z] + (((long long)seg * heads * rows_pad) << lg);
  }
};

// A (B, rows, w) tensor as columns i and rows k of batch row seg (one K
// segment per batch row; the caller's kreal = rows keeps k < rows).
template <typename T>
struct RowCols {
  static constexpr bool kAlongK = false;
  const T* p;
  int rows, w;
  __device__ long long ioff(int, int i) const { return i; }
  __device__ long long koff(int k) const { return (long long)k * w; }
  __device__ const T* base(int, int seg) const {
    return p + (long long)seg * rows * w;
  }
};

// Element (i, k) = W[i * ld + k]: a Dense weight (out, in) as B of x W^T.
// The tensor is p[z] when by_z, else p[seg].
template <typename T>
struct WeightRows {
  static constexpr bool kAlongK = true;
  const T* p[3];
  int ld, by_z;
  __device__ long long ioff(int, int i) const { return (long long)i * ld; }
  __device__ long long koff(int k) const { return k; }
  __device__ const T* base(int z, int seg) const { return p[by_z ? z : seg]; }
};

// Element (i, k) = W[k * ld + i]: a Dense weight as B of dy W; p[seg].
template <typename T>
struct WeightCols {
  static constexpr bool kAlongK = false;
  const T* p[3];
  int ld;
  __device__ long long ioff(int, int i) const { return i; }
  __device__ long long koff(int k) const { return (long long)k * ld; }
  __device__ const T* base(int, int seg) const { return p[seg]; }
};

// Writes row m = b * rows_pad + r, column n = h * dh + d of tensor z into
// the head-major out[z] (B, H, rows_pad, dh): round(sum) + bias[z][n], or
// the sum rounded to T when there is no bias.
template <typename T>
struct HeadOut {
  T* p[3];
  const T* bias[3];
  int rows_pad, heads, lg;
  __device__ long long offset(int m, int n) const {
    const int b = m / rows_pad, r = m - b * rows_pad;
    return ((((long long)b * heads + (n >> lg)) * rows_pad + r) << lg) +
           (n & ((1 << lg) - 1));
  }
  __device__ float value(int z, int n, float v) const {
    return bias[z] ? rounded(v, p[z]) + load(bias[z] + n) : v;
  }
  __device__ void operator()(int z, int m, int n, float v) const {
    store(p[z] + offset(m, n), value(z, n, v));
  }
  // the wgmma route's staged epilogue: 8 outputs from column n (n % 8 ==
  // 0: one head, adjacent in memory)
  static constexpr bool kStaged = true;
  __device__ T* chunk(int z, int m, int n) const {
    return p[z] + offset(m, n);
  }
};

// out[m * ld + n] = sum (+ bias[n]), rounded once to T.
template <typename T>
struct RowOut {
  T* p;
  const T* bias;
  int ld;
  __device__ void operator()(int, int m, int n, float v) const {
    store(p + (long long)m * ld + n, bias ? v + load(bias + n) : v);
  }
};

// RowOut from the padded grid (the wgmma route's staged epilogue): row m
// = b * rows_pad + r is output row b * rows + r, dropped for r >= rows.
template <typename T>
struct PaddedRowOut {
  static constexpr bool kStaged = true;
  T* p;
  const T* bias;
  int ld, rows, rows_pad;
  __device__ float value(int, int n, float v) const {
    return bias ? v + load(bias + n) : v;
  }
  __device__ T* chunk(int, int m, int n) const {
    const int b = m / rows_pad, r = m - b * rows_pad;
    return r < rows ? p + ((long long)b * rows + r) * ld + n : nullptr;
  }
};

// Partial sums in f32: out[z * zstride + m * ld + n], z = the product's z
// times the number of K slices plus the slice.
struct Partial {
  static constexpr bool kStaged = false;
  float* p;
  long long zstride;
  int ld;
  __device__ void operator()(int z, int m, int n, float v) const {
    p[z * zstride + (long long)m * ld + n] = v;
  }
  __device__ void pair(int z, int m, int n, float v0, float v1) const {
    store2(p + z * zstride + (long long)m * ld + n, v0, v1);
  }
};

// The k range [kb, ke) of K slice blockIdx.z % nsplit, whole tiles of tk.
__device__ __forceinline__ void k_slice(int K, int nsplit, int tk, int& kb,
                                        int& ke) {
  const int per = ((K + nsplit - 1) / nsplit + tk - 1) / tk * tk;
  kb = (int)(blockIdx.z % nsplit) * per;
  ke = min(K, kb + per);
}

// Steps (seg, kin) to the next k tile of tk: the next tile of its
// segment, or the next segment's first when the rest of this one is past
// kreal (zeros, skipped); returns the tile's k.
__device__ __forceinline__ int next_tile(int& seg, int& kin, int tk,
                                         int kseg, int kreal) {
  kin += tk;
  if (kin >= kreal) {
    ++seg;
    kin = 0;
  }
  return seg * kseg + kin;
}

// Both variants below take K in segments of kseg (a multiple of their k
// tile when there is more than one), of which the first kreal k are real:
// the rest read as zero and their k tiles are skipped (the weight
// gradients' segments are batch rows of T_pad, kreal = T).

// ------------------------------------ SIMT: float32 (and any dtype)
//
// A 128 x 128 output tile per CTA of 256 threads, each thread 8 x 8
// outputs in two 4 x 4 blocks 64 rows and 64 columns apart (so its
// shared-memory reads are float4s that do not conflict), k tiles of 8
// staged through shared memory as f32 (bf16 converted on load: a bf16
// product is exact in f32). 8 x 8 outputs per 4 float4 reads keep the
// loop on the FMA units; at most 128 registers, two CTAs per SM.

constexpr int SB = 128;  // output rows and columns per CTA
constexpr int SBK = 8;   // k per shared-memory tile

template <typename T, class A, class B, class E>
__global__ void __launch_bounds__(NT, 2)
    gemm_kernel(A a, B b, E e, int M, int N, int K, int kseg, int kreal,
                int nsplit) {
  __shared__ __align__(16) float as[SBK][SB + 4];
  __shared__ __align__(16) float bs[SBK][SB + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int z = blockIdx.z / nsplit;
  const int m0 = blockIdx.y * SB, n0 = blockIdx.x * SB;
  int kb, ke;
  k_slice(K, nsplit, SBK, kb, ke);

  // each thread stages 4 elements of each tile: slot s sits at the
  // thread's place along the contiguous index, and at (thread's row of
  // slots) + s * rows-per-pass along the other
  const int a_c = A::kAlongK ? tid % SBK : tid % SB;
  const int a_r = A::kAlongK ? tid / SBK : tid / SB;
  const int b_c = B::kAlongK ? tid % SBK : tid % SB;
  const int b_r = B::kAlongK ? tid / SBK : tid / SB;
  constexpr int A_PASS = A::kAlongK ? NT / SBK : NT / SB;
  constexpr int B_PASS = B::kAlongK ? NT / SBK : NT / SB;
  // (i, k) of slot s in the tile
  auto a_i = [&](int s) { return A::kAlongK ? a_r + A_PASS * s : a_c; };
  auto a_k = [&](int s) { return A::kAlongK ? a_c : a_r + A_PASS * s; };
  auto b_i = [&](int s) { return B::kAlongK ? b_r + B_PASS * s : b_c; };
  auto b_k = [&](int s) { return B::kAlongK ? b_c : b_r + B_PASS * s; };
  long long aoff[4], boff[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    aoff[s] = m0 + a_i(s) < M ? a.ioff(z, m0 + a_i(s)) : -1;
    boff[s] = n0 + b_i(s) < N ? b.ioff(z, n0 + b_i(s)) : -1;
  }

  // the k tile at (seg, kin): its first lim k are real and in the slice
  float ra[4], rb[4];
  auto fetch = [&](int seg, int kin) {
    const int lim = min(ke - seg * kseg - kin, kreal - kin);
    const T* pa = a.base(z, seg);
    const T* pb = b.base(z, seg);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ra[s] = (aoff[s] >= 0 && a_k(s) < lim)
                  ? load(pa + aoff[s] + a.koff(kin + a_k(s)))
                  : 0.f;
      rb[s] = (boff[s] >= 0 && b_k(s) < lim)
                  ? load(pb + boff[s] + b.koff(kin + b_k(s)))
                  : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int seg = kb / kseg, kin = kb - seg * kseg;
  fetch(seg, kin);
  for (int k0 = kb; k0 < ke;) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      as[a_k(s)][a_i(s)] = ra[s];
      bs[b_k(s)][b_i(s)] = rb[s];
    }
    __syncthreads();
    const int kn = next_tile(seg, kin, SBK, kseg, kreal);
    if (kn < ke) fetch(seg, kin);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
    k0 = kn;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
      const int n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (m < M && n < N) e(blockIdx.z, m, n, acc[i][j]);
    }
}

// ------------------------------------ bf16: mma.sync on the tensor cores
//
// A 64 x 64 output tile, 4 warps (2 x 2) of 32 x 32, k tiles of 32
// kept in shared memory as bf16 rows along k (pitch 40: the fragment
// loads are free of bank conflicts), products by mma.sync m16n8k16 with
// f32 accumulation. Operands are fetched in groups of 8 elements along
// their contiguous index (one 16-byte load when the group is in range
// and aligned, else 8 element loads): every operand above keeps an
// 8-aligned group adjacent in memory when the head dim is a multiple of
// 8. A group along i is transposed into the k-major rows on its store.

constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int MLD = MBK + 8;  // bf16 pitch of a tile row
constexpr int MNT = 128;      // threads per CTA

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t u32_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bits of element j of a group of 8 bf16 held in a uint4
__device__ __forceinline__ unsigned short group_elem(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : (j < 4 ? v.y : (j < 6 ? v.z : v.w));
  return (unsigned short)(w >> (16 * (j & 1)));
}

// The group of 8 elements of an operand that starts at (i, k): along k
// when kAlongK (i fixed), else along i (k fixed). `ioff` is ioff(z, i),
// or -1 for a zero row or i past I; kin is k within its segment, of
// which the next `lim` are real (the rest read as zero).
template <class Op>
__device__ __forceinline__ uint4 load_group(const Op& op,
                                            const __nv_bfloat16* base,
                                            long long ioff, int z, int i,
                                            int I, int kin, int lim) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (Op::kAlongK) {
    if (ioff < 0) return make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat16* p = base + ioff + op.koff(kin);
    if (lim >= 8 && ((uintptr_t)p & 15) == 0)
      return *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < lim)
        w[j / 2] |= (uint32_t)__bfloat16_as_ushort(
                        base[ioff + op.koff(kin + j)])
                    << (16 * (j & 1));
  } else {
    if (lim <= 0) return make_uint4(0u, 0u, 0u, 0u);
    const long long ko = op.koff(kin);
    if (ioff >= 0 && i + 8 <= I) {
      const __nv_bfloat16* p = base + ioff + ko;
      if (((uintptr_t)p & 15) == 0) return *reinterpret_cast<const uint4*>(p);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long io = i + j < I ? op.ioff(z, i + j) : -1;
      if (io >= 0)
        w[j / 2] |= (uint32_t)__bfloat16_as_ushort(base[io + ko])
                    << (16 * (j & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stores a group into a k-major tile (rows i, pitch MLD).
template <bool kAlongK>
__device__ __forceinline__ void store_group(__nv_bfloat16* tile, int i, int k,
                                            const uint4& v) {
  if (kAlongK) {
    *reinterpret_cast<uint4*>(&tile[i * MLD + k]) = v;
  } else {
    unsigned short* t = reinterpret_cast<unsigned short*>(tile);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[(i + j) * MLD + k] = group_elem(v, j);
  }
}

template <class A, class B, class E>
__global__ void __launch_bounds__(MNT) gemm_bf16_mma_kernel(
    A a, B b, E e, int M, int N, int K, int kseg, int kreal, int nsplit) {
  __shared__ __align__(16) __nv_bfloat16 as[BM * MLD];
  __shared__ __align__(16) __nv_bfloat16 bs[BN * MLD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int z = blockIdx.z / nsplit;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int kb, ke;
  k_slice(K, nsplit, MBK, kb, ke);

  // each thread fetches 2 groups of each tile, at fixed tile positions
  int ai[2], ak[2], bi[2], bk[2];
  long long aoff[2], boff[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int gi = tid + MNT * s;
    if (A::kAlongK) {
      ai[s] = gi / (MBK / 8);
      ak[s] = gi % (MBK / 8) * 8;
    } else {
      ak[s] = gi / (BM / 8);
      ai[s] = gi % (BM / 8) * 8;
    }
    if (B::kAlongK) {
      bi[s] = gi / (MBK / 8);
      bk[s] = gi % (MBK / 8) * 8;
    } else {
      bk[s] = gi / (BN / 8);
      bi[s] = gi % (BN / 8) * 8;
    }
    aoff[s] = m0 + ai[s] < M ? a.ioff(z, m0 + ai[s]) : -1;
    boff[s] = n0 + bi[s] < N ? b.ioff(z, n0 + bi[s]) : -1;
  }

  // the k tile at (seg, kin): its first lim k are real and in the slice
  uint4 ra[2], rb[2];
  auto fetch = [&](int seg, int kin) {
    const int lim = min(ke - seg * kseg - kin, kreal - kin);
    const __nv_bfloat16* pa = a.base(z, seg);
    const __nv_bfloat16* pb = b.base(z, seg);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      ra[s] = load_group(a, pa, aoff[s], z, m0 + ai[s], M, kin + ak[s],
                         lim - ak[s]);
      rb[s] = load_group(b, pb, boff[s], z, n0 + bi[s], N, kin + bk[s],
                         lim - bk[s]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  int seg = kb / kseg, kin = kb - seg * kseg;
  fetch(seg, kin);
  for (int k0 = kb; k0 < ke;) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      store_group<A::kAlongK>(as, ai[s], ak[s], ra[s]);
      store_group<B::kAlongK>(bs, bi[s], bk[s], rb[s]);
    }
    __syncthreads();
    const int kn = next_tile(seg, kin, MBK, kseg, kreal);
    if (kn < ke) fetch(seg, kin);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < MBK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* r = &as[(wm * 32 + mi * 16 + g) * MLD + ks + 2 * t4];
        af[mi][0] = u32_at(r);
        af[mi][1] = u32_at(r + 8 * MLD);
        af[mi][2] = u32_at(r + 8);
        af[mi][3] = u32_at(r + 8 * MLD + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const __nv_bfloat16* c = &bs[(wn * 32 + nj * 8 + g) * MLD + ks + 2 * t4];
        const uint32_t b0 = u32_at(c), b1 = u32_at(c + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][nj], af[mi], b0, b1);
      }
    }
    __syncthreads();
    k0 = kn;
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 32 + mi * 16 + g + (q / 2) * 8;
        const int n = n0 + wn * 32 + nj * 8 + 2 * t4 + (q & 1);
        if (m < M && n < N) e(blockIdx.z, m, n, acc[mi][nj][q]);
      }
}

// Launches the product over Z batches of (M, N, K), each split into
// nsplit K slices (grid z = batch * nsplit + slice), on the SIMT or the
// mma.sync route; K in segments of kseg (= K for one, else a multiple of
// the route's k tile), kreal <= kseg of them real. Returns the launch's
// cudaError_t.
template <typename T, class A, class B, class E>
int gemm(int route, const A& a, const B& b, const E& e, int M, int N, int K,
         int kseg, int kreal, int Z, int nsplit, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Z <= 0 || kseg <= 0 || nsplit <= 0 ||
      kreal <= 0 || kreal > kseg)
    return (int)cudaErrorInvalidValue;
  const unsigned gz = (unsigned)(Z * nsplit);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (route == kMma) {
      if (kseg < K && kseg % MBK != 0) return (int)cudaErrorInvalidValue;
      const dim3 grid((unsigned)((N + BN - 1) / BN),
                      (unsigned)((M + BM - 1) / BM), gz);
      gemm_bf16_mma_kernel<A, B, E><<<grid, MNT, 0, stream>>>(
          a, b, e, M, N, K, kseg, kreal, nsplit);
      return (int)cudaGetLastError();
    }
  }
  if (route != kSimt || (kseg < K && kseg % SBK != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + SB - 1) / SB), (unsigned)((M + SB - 1) / SB),
                  gz);
  gemm_kernel<T, A, B, E><<<grid, NT, 0, stream>>>(a, b, e, M, N, K, kseg,
                                                   kreal, nsplit);
  return (int)cudaGetLastError();
}

// ------------------------------------ bf16: wgmma fed by TMA
//
// CTA: warps 0-7 are two consumer warpgroups (rows 0-63 and 64-127 of the
// 128 x BN tile, BN = 128 or 256), warp 8 the producer (one thread issues
// the TMA loads). A stage holds A as two 64 x 64 boxes (the two
// warpgroups' rows, or for an MN-major A their 64-wide M blocks) and B as
// BN / 64 (its 64-wide N blocks), each 8 KB, 128-byte swizzled. The
// producer waits for a stage's empty barrier (one arrival per consumer
// warp once its wgmma has read the stage), arms the full barrier with the
// stage's bytes and issues the boxes; a consumer waits for the full
// barrier, issues four m64nBNk16 (k = 16 each) and releases the stage
// before it once the group before has completed (one group in flight).
// Out-of-range boxes or rows are zero-filled by TMA and still count their
// bytes. BN = 256 takes a quarter off the bytes each product pulls from
// L2 into shared memory against 128, which is what bounds a 128 x 128
// tile here. A bf16 output leaves through shared memory: each warpgroup
// writes its 64 x BN values there, then stores them as 16-byte runs along
// the output's rows (written straight from the accumulators, each store
// instruction puts 4 bytes into 8 rows, half-sector pieces); f32 partials
// are written straight, 8-byte pieces already filling whole sectors.
// Three stages leave room for the staging buffer (a fourth bought no
// time in a trial build).

constexpr int WG_STAGES = 3;
constexpr int WG_BOX = 64 * 64 * 2;   // bytes of one 64 x 64 box
constexpr int WG_A = 2 * WG_BOX;      // A's share of a stage
constexpr int WG_THREADS = 288;       // 2 warpgroups + 1 warp

template <int BN>
struct WgPlan {
  static constexpr int STAGE = WG_A + BN / 64 * WG_BOX;
  static constexpr int BARS = WG_STAGES * STAGE;         // full, empty
  static constexpr int PITCH = BN + 8;                   // staged row, bf16
  static constexpr int EPI = BARS + 2 * WG_STAGES * 8;   // 2 x 64 x PITCH
  static constexpr int SMEM = EPI + 2 * 64 * PITCH * 2 + 1024;
};

// bar.sync on named barrier `id` among the 128 threads of a warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

struct Maps {
  CUtensorMap a[3];  // A's tensor maps, by K segment or by z
  CUtensorMap b[3];  // B's
};

// Each operand kind loads the NB boxes of k stage ks (64 deep) for the
// 64 NB rows or columns from mn0 into dst (box i at dst + i * WG_BOX),
// completing on bar. MN = 1: the operand is MN-major (transposed).

// K-major: the rows of x or dout (B, T, D) on the padded grid (mn0 = b *
// T_pad + r0), map (D, T, B); k stage = columns 64 ks.
struct TmaPaddedRows {
  static constexpr int MN = 0;
  int rows_pad;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m, bar, 64 * ks, r + 64 * i, b);
  }
};

// K-major: a head-major (B, H, T_pad, dh) tensor as rows (b, r) of the
// padded grid and columns k = seg * H dh + h dh + d, map (dh, T_pad, H,
// B) m[seg]; seg_stages = H dh / 64 k stages per segment.
struct TmaHeadCols {
  static constexpr int MN = 0;
  int rows_pad, dh, seg_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / seg_stages, k = 64 * (ks - seg * seg_stages);
    const int h = k / dh, d = k - h * dh;
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + seg, bar, d, r + 64 * i, h, b);
  }
};

// K-major: a Dense weight (N, K) as B of x W^T, map (K, N); m[z] when
// by_z, else m[seg].
struct TmaWeightRows {
  static constexpr int MN = 0;
  int by_z, seg_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int z, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / seg_stages, k = 64 * (ks - seg * seg_stages);
    const CUtensorMap* map = m + (by_z ? z : seg);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, map, bar, k, mn0 + 64 * i);
  }
};

// MN-major: a Dense weight W (K, N) as B of dy W (element (n, k) = W[k,
// n]), map (N, K) m[seg].
struct TmaWeightCols {
  static constexpr int MN = 1;
  int seg_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / seg_stages, k = 64 * (ks - seg * seg_stages);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + seg, bar, mn0 + 64 * i, k);
  }
};

// MN-major: x or dout (B, T, D) as columns i and K rows (b, r), map (D,
// T, B); k stage ks = 64 rows from r0 of batch row b, (b, r0 / 64) = (ks
// / row_tiles, ks % row_tiles), the rows past T zero-filled.
struct TmaRowCols {
  static constexpr int MN = 1;
  int row_tiles;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = ks / row_tiles, r = 64 * (ks - b * row_tiles);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m, bar, mn0 + 64 * i, r, b);
  }
};

// MN-major: a head-major (B, H, T_pad, dh) tensor as columns i = h dh + d
// and K rows (b, r) as TmaRowCols's, map (dh, T_pad, H, B) m[z].
struct TmaHeadRows {
  static constexpr int MN = 1;
  int row_tiles, dh;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int z, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = ks / row_tiles, r = 64 * (ks - b * row_tiles);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int n = mn0 + 64 * i, h = n / dh;
      wg::tma_load(dst + i * WG_BOX, m + z, bar, n - h * dh, r, h, b);
    }
  }
};

// MN-major: tap z of a stride-2 conv's input x (B, T_in, C) as columns i
// (channels) and K rows (b, t) holding x[b, 2 t + z], map m[z] (C, T_out,
// B) from encode_tap_rows; k stage ks as TmaRowCols's.
struct TmaTapRows {
  static constexpr int MN = 1;
  int row_tiles;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int z, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = ks / row_tiles, r = 64 * (ks - b * row_tiles);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + z, bar, mn0 + 64 * i, r, b);
  }
};

// K-major: the forward's A operand of a stride-2, kernel-3 conv over x
// (B, T_in, C): rows (b, t) on the padded grid (mn0 = b * T_pad + r0) and
// columns k = z C + c holding x[b, 2 t + z, c]; k stage ks reads tap z =
// ks / c_stages (c_stages = C / 64) through m[z] (C, T_out, B) from
// encode_tap_rows, channels 64 (ks % c_stages), the rows past T_out
// zero-filled.
struct TmaTapCols {
  static constexpr int MN = 0;
  int rows_pad, c_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int z = ks / c_stages, k = 64 * (ks - z * c_stages);
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + z, bar, k, r + 64 * i, b);
  }
};

// The descriptor of k step kk (16 deep) of a 64-row (A) or BN-column (B)
// operand tile at `tile`: K-major rows of 128 bytes stacked (SBO 1024
// per 8 rows), or MN-major boxes of 64 k rows x 64 values side by side
// (LBO = a box).
template <int MN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return MN ? wg::desc_sw128(tile + 2048 * kk, WG_BOX, 1024)
            : wg::desc_sw128(tile + 32 * kk, 16, 1024);
}

// Tiles t = ((z * S + slice) * mtiles + mt) * ntiles + nt of 128 x BN;
// slice s takes k stages [s * per, min(nk, (s + 1) * per)); the epilogue
// gets z * S + s.
template <int BN, class A, class B, class E>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_gemm_kernel(const __grid_constant__ Maps maps, const A a,
                      const B b, const E e, int M, int N, int Z, int S,
                      int nk) {
  constexpr int STAGE = WgPlan<BN>::STAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + WgPlan<BN>::BARS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);                // full
      wg::mbar_init(bars + 8 * (WG_STAGES + s), 8);  // empty
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int mtiles = (M + 127) / 128, ntiles = (N + BN - 1) / BN;
  const int tiles = Z * S * mtiles * ntiles, per = (nk + S - 1) / S;

  if (warp == 8) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int nt = t % ntiles, mt = t / ntiles % mtiles;
        const int zs = t / ntiles / mtiles, z = zs / S;
        const int kb = (zs - z * S) * per, ke = min(nk, kb + per);
        for (int ks = kb; ks < ke; ++ks) {
          wg::mbar_wait(bars + 8 * (WG_STAGES + stage), phase ^ 1);
          const uint32_t full = bars + 8 * stage;
          const uint32_t sa = base + stage * STAGE;
          wg::mbar_expect_tx(full, STAGE);
          a.template load<2>(maps.a, z, mt * 128, ks, sa, full);
          b.template load<BN / 64>(maps.b, z, nt * BN, ks, sa + WG_A, full);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wi computes rows 64 wi .. 64 wi + 63 of the tile
  const int wi = warp / 4, g = lane / 4, u = lane % 4;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % ntiles, mt = t / ntiles % mtiles;
    const int zs = t / ntiles / mtiles, z = zs / S;
    const int kb = (zs - z * S) * per, ke = min(nk, kb + per);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int ks = kb; ks < ke; ++ks) {
      wg::mbar_wait(bars + 8 * stage, phase);
      const uint32_t sa = base + stage * STAGE + wi * WG_BOX;
      const uint32_t sb = base + stage * STAGE + WG_A;
      wg::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_ss<A::MN, B::MN>(acc, tile_desc<A::MN>(sa, kk),
                                   tile_desc<B::MN>(sb, kk), 1);
      wg::wg_commit();
      wg::wg_wait<1>();  // the stage before is read
      if (prev >= 0 && lane == 0)
        wg::mbar_arrive(bars + 8 * (WG_STAGES + prev));
      prev = stage;
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::wg_wait<0>();
    wg::keep_regs(acc);
    if (prev >= 0 && lane == 0)
      wg::mbar_arrive(bars + 8 * (WG_STAGES + prev));
    // the accumulator: rows 16 (warp % 4) + g (+ 8), columns 8 j + 2 u, +1
    const int rl = 16 * (warp % 4) + g, m0 = mt * 128 + 64 * wi;
    if constexpr (E::kStaged) {
      constexpr int PITCH = WgPlan<BN>::PITCH;
      __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(
                              smem_raw + (base - wg::smem_addr(smem_raw)) +
                              WgPlan<BN>::EPI) +
                          wi * 64 * PITCH;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * u, n = nt * BN + c;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(ep + (rl + 8 * h) * PITCH + c) =
              wg::pack_bf16(e.value(zs, n, acc[4 * j + 2 * h]),
                            e.value(zs, n + 1, acc[4 * j + 2 * h + 1]));
      }
      warpgroup_sync(1 + wi);
      for (int i = threadIdx.x % 128; i < 64 * BN / 8; i += 128) {
        const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
        const int m = m0 + r, n = nt * BN + c;
        if (m >= M || n >= N) continue;
        __nv_bfloat16* dst = e.chunk(zs, m, n);
        if (dst != nullptr)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(ep + r * PITCH + c);
      }
      warpgroup_sync(1 + wi);  // the buffer is read before the next tile
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = nt * BN + 8 * j + 2 * u;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m0 + rl + 8 * h < M && n < N)
            e.pair(zs, m0 + rl + 8 * h, n, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map of rank 2-4 whose boxes are 64 x 64 (x 1 x 1), 128-byte
// swizzled, out-of-range elements read as zero. dims innermost first;
// strides in elements of dims 1 .. rank - 1.
inline int encode(CUtensorMap* map, const void* p, int rank,
                  const uint64_t* dims, const uint64_t* strides) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gd[4], gs[3];
  const cuuint32_t box[4] = {64, 64, 1, 1}, es[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) gd[i] = dims[i];
  for (int i = 0; i + 1 < rank; ++i) gs[i] = strides[i] * 2;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        (cuuint32_t)rank, const_cast<void*>(p), gd, gs, box,
                        es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
// (B, rows, w): map (w, rows, B)
inline int encode_rows(CUtensorMap* map, const void* p, int batch, int rows,
                       int w) {
  const uint64_t dims[3] = {(uint64_t)w, (uint64_t)rows, (uint64_t)batch};
  const uint64_t strides[2] = {(uint64_t)w, (uint64_t)rows * w};
  return encode(map, p, 3, dims, strides);
}
// tap `tap` of a stride-2, kernel-3 VALID conv's input (B, t_in, c): rows
// 2 t + tap for t < T_out = (t_in - 3) / 2 + 1, map (c, T_out, B) from
// p + tap * c with a row stride of 2 c (twice the inner extent, which
// TMA takes as a pitched row)
inline int encode_tap_rows(CUtensorMap* map, const void* p, int batch,
                           int t_in, int c, int tap) {
  const uint64_t dims[3] = {(uint64_t)c, (uint64_t)((t_in - 3) / 2 + 1),
                            (uint64_t)batch};
  const uint64_t strides[2] = {2 * (uint64_t)c, (uint64_t)t_in * c};
  return encode(map, (const __nv_bfloat16*)p + (size_t)tap * c, 3, dims,
                strides);
}
// head-major (B, H, rows_pad, dh): map (dh, rows_pad, H, B)
inline int encode_heads(CUtensorMap* map, const void* p, int batch, int heads,
                        int rows_pad, int dh) {
  const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)rows_pad, (uint64_t)heads,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)dh, (uint64_t)rows_pad * dh,
                               (uint64_t)heads * rows_pad * dh};
  return encode(map, p, 4, dims, strides);
}
// a row-major (outer, inner) matrix: map (inner, outer)
inline int encode_matrix(CUtensorMap* map, const void* p, int outer,
                         int inner) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)outer};
  const uint64_t strides[1] = {(uint64_t)inner};
  return encode(map, p, 2, dims, strides);
}

// Launches the product over Z batches of (M, N, nk 64-deep k stages),
// each split into S K slices, on a persistent grid of at most one CTA per
// SM, in 128 x 256 tiles where N is at least 256, else 128 x 128. Returns
// the launch's cudaError_t.
template <int BN, class A, class B, class E>
int wgmma_launch(const Maps& maps, const A& a, const B& b, const E& e, int M,
                 int N, int Z, int S, int nk, cudaStream_t stream) {
  // the SM count and the shared-memory opt-in are queried once per device
  // (the block's backward is host-bound: its host calls count)
  static int sms[64] = {0};
  static bool opted[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0)
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess && !opted[dev]) {
    err = cudaFuncSetAttribute(wgmma_gemm_kernel<BN, A, B, E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgPlan<BN>::SMEM);
    opted[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)Z * S * ((M + 127) / 128) * ((N + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sms[dev] ? tiles : sms[dev]);
  wgmma_gemm_kernel<BN, A, B, E>
      <<<grid, WG_THREADS, WgPlan<BN>::SMEM, stream>>>(maps, a, b, e, M, N,
                                                        Z, S, nk);
  return (int)cudaGetLastError();
}

template <class A, class B, class E>
int wgmma_gemm(const Maps& maps, const A& a, const B& b, const E& e, int M,
               int N, int Z, int S, int nk, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || Z <= 0 || S <= 0 || nk <= 0)
    return (int)cudaErrorInvalidValue;
  return N >= 256 ? wgmma_launch<256>(maps, a, b, e, M, N, Z, S, nk, stream)
                  : wgmma_launch<128>(maps, a, b, e, M, N, Z, S, nk, stream);
}

inline int log2_exact(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return (1 << lg) == v ? lg : -1;
}

}  // namespace blockgemm
