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
//   * wgmma (bf16, head dim 64 or 128, d_model a multiple of 64): the
//     TMA-fed GEMM of tma_gemm.cuh, its operands as tensor maps in place
//     of the index functors below: x and dout as (D, T, B) with the rows
//     past T zero-filled by TMA, the head-major tensors as (dh, T_pad, H,
//     B), the weights as 2-D; bf16 outputs through HeadOut or
//     tma_gemm.cuh's PaddedRowOut, weight-gradient partials through
//     Partial;
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma_gemm.cuh"

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
  static constexpr bool kStaged = true, kTmaStore = false;
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

inline int log2_exact(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return (1 << lg) == v ? lg : -1;
}

}  // namespace blockgemm
