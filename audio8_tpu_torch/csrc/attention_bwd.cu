// Attention core, backward: dq, dk, dv of
// o = softmax(q k^T * scale, key mask) [hash dropout] v.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_kernel.py:
// _bwd_kernel (driven by _attn_bwd through the same pallas_call as the
// forward). Same function, term by term:
//
//   * p is recomputed from q, k and the forward's row statistics
//     (attention_fwd.cu writes the row max m and the full T_pad-wide row
//     sum l): p = exp(s - m) / l with s = q.k * scale, or -1e9 where the
//     key is invalid. For a row whose keys are all invalid this is the
//     TPU kernel's uniform 1/T_pad, and, as there, ds is NOT zeroed at
//     masked columns, so such a row gets a dq and its keys get dk;
//   * dropout regenerates the forward's mask bit for bit: keep column c
//     of query row r iff murmur(r * T_pad + c ^ (seed + b*H + h)) >=
//     threshold; pd = keep * p / (1 - rate), dp = keep * (dO.v) / (1 -
//     rate);
//   * ds = p * (dp - D) with D = rowsum(dp * p). Since rowsum(dp * p) =
//     rowsum(dpd * pd) = dO . o, D is taken from the forward output o in
//     f32 (FlashAttention-2; for bf16 inputs the forward's f32 copy of o,
//     so D does not inherit o's bf16 rounding), computed once per row by
//     the dq kernel;
//   * dv = pd^T dO, dq = ds k * scale, dk = ds^T q * scale, with pd and
//     ds rounded to the input dtype before the products as in the TPU
//     kernel (a no-op in f32), and f32 accumulation.
//
// What bounds it on H100: the work is five T x T x dh products per head
// plus the recomputed scores; the (T, T) probabilities must not reach
// device memory. Design (FlashAttention-2 shaped, no atomics, so the
// result does not depend on scheduling):
//   1. dq kernel: one CTA per (batch*head, 64-query tile) computes D for
//      its rows, then loops over 64-key tiles: S, dP -> ds (shared
//      memory) -> dq += ds k;
//   2. dk/dv kernel: one CTA per (batch*head, 64-key tile) loops over
//      64-query tiles: S, dP -> pd, ds (shared memory) -> dv += pd^T dO,
//      dk += ds^T q.
// S and dP are recomputed in both (seven products instead of five).
// Two variants of the pair, chosen at launch:
//   * bf16 with 16-byte aligned tensors and dh <= 64: every product on the
//     tensor cores (mma.sync m16n8k16, f32 accumulation), 4 warps of 16
//     rows each, as the forward's mma kernel: S, dP and ds stay in
//     registers and feed the next product as its A operand, only the
//     other side's tiles go through shared memory. The dk/dv kernel
//     computes S^T = K Q^T directly, so P^T and dS^T are A operands too;
//   * otherwise (every f32 call): the CUDA cores (SIMT, f32 accumulation),
//     256 threads, each with a 4x4 block of S and dP and a 4 x dh/16 block
//     of the accumulators. f32 stays off the tensor cores (TF32 is not
//     f32).
// A fused single-pass design and wgmma are later work. The head dim is a
// template parameter (16, 32, 64, 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // key columns per tile
constexpr int NT = 256;  // threads per CTA
constexpr int SLD = BKV + 1;
constexpr float NEG = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rounds a product operand to the input dtype (the TPU kernel's astype).
__device__ __forceinline__ float operand_round(float v, float) { return v; }
__device__ __forceinline__ float operand_round(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ bool hash_keep(uint32_t idx, uint32_t seed,
                                          uint32_t threshold) {
  uint32_t x = idx ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads rows [r0, r0 + 64) of a (t, DH) slab into a (64, DH + 1) f32
// tile, zeros past t.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int t) {
  for (int idx = threadIdx.x; idx < 64 * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    dst[r * (DH + 1) + d] =
        (r0 + r < t) ? to_f32(src[(size_t)(r0 + r) * DH + d]) : 0.f;
  }
}

// s[i][j] = a[ty + 16i] . b[tx + 16j] and dp[i][j] = c[ty + 16i] .
// e[tx + 16j] over DH, for (64, DH + 1) tiles a, b, c, e.
template <int DH>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* e,
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int LD = DH + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * LD + d];
      cv[i] = c[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * LD + d];
      ev[j] = e[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
      }
  }
}

struct Params {
  const uint8_t* key_valid;  // (B, T) or null
  const float* stats;        // (B*H*T, 2): row max, row sum
  float* dvec;               // (B*H*T): D = rowsum(dO * o)
  // f32 copies of dq, dk, dv before their rounding to the input dtype,
  // each (B, H, T, dh) or null (the attention block's bias gradients)
  float* dq32;
  float* dk32;
  float* dv32;
  int n_heads, t, t_pad;
  float scale, inv_keep;
  uint32_t threshold, seed;
  int dropout;
};

// For the 4x4 (query ty + 16i, key tx + 16j) block of one (query tile q0,
// key tile c0) pair: p and ds (and pd when wanted) from the raw products.
template <typename T>
__device__ __forceinline__ void grads_of_block(
    const Params& P, int bh, int q0, int c0, const float (&s)[4][4],
    const float (&dpd)[4][4], const float* m_s, const float* il_s,
    const float* d_s, float* pd_out, float* ds_out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = bh / P.n_heads;
  const uint8_t* kvb = P.key_valid ? P.key_valid + (size_t)b * P.t : nullptr;
  const uint32_t seed_g = P.seed + (uint32_t)bh;
  const T tag{};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tx + 16 * j;
    const bool ok = c < P.t && (kvb == nullptr || kvb[c] != 0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float sv = ok ? s[i][j] * P.scale : NEG;
      const float p = expf(sv - m_s[r]) * il_s[r];
      float pd = p, dp = dpd[i][j];
      if (P.dropout) {
        const bool keep = hash_keep(
            (uint32_t)(q0 + r) * (uint32_t)P.t_pad + (uint32_t)c, seed_g,
            P.threshold);
        pd = keep ? p * P.inv_keep : 0.f;
        dp = keep ? dp * P.inv_keep : 0.f;
      }
      const float ds = p * (dp - d_s[r]);
      if (pd_out) pd_out[r * SLD + tx + 16 * j] = operand_round(pd, tag);
      ds_out[r * SLD + tx + 16 * j] = operand_round(ds, tag);
    }
  }
}

// Row statistics of query rows [q0, q0 + 64): m, 1/l (0 past t, which
// zeroes p there) and D (read from P.dvec unless `compute_d`).
__device__ __forceinline__ void load_row_stats(const Params& P, int bh,
                                               int q0, float* m_s,
                                               float* il_s, float* d_s,
                                               bool read_d) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int rg = q0 + r;
    if (rg < P.t) {
      const size_t row = (size_t)bh * P.t + rg;
      m_s[r] = P.stats[row * 2];
      il_s[r] = 1.f / P.stats[row * 2 + 1];
      if (read_d) d_s[r] = P.dvec[row];
    } else {
      m_s[r] = 0.f;
      il_s[r] = 0.f;
      if (read_d) d_s[r] = 0.f;
    }
  }
}

template <int DH>
__host__ __device__ constexpr int tile_floats() {
  return BQ * (DH + 1);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * tile_floats<DH>() + 2 * BQ * SLD + 3 * BQ);
}

// dq for one 64-query tile; also writes D of its rows.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ o32,
                            const T* __restrict__ dout, T* __restrict__ dq,
                            Params P) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + tile_floats<DH>();
  float* k_s = do_s + tile_floats<DH>();
  float* v_s = k_s + tile_floats<DH>();
  float* ds_s = v_s + tile_floats<DH>();
  float* m_s = ds_s + 2 * BQ * SLD;
  float* il_s = m_s + BQ;
  float* d_s = il_s + BQ;
  constexpr int LD = DH + 1;
  constexpr int DJ = DH / 16;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * P.t * DH;

  load_tile<T, DH>(q_s, q + base, q0, P.t);
  load_tile<T, DH>(do_s, dout + base, q0, P.t);
  load_tile<float, DH>(k_s, o32 + base, q0, P.t);  // o, for D only
  load_row_stats(P, bh, q0, m_s, il_s, d_s, false);
  __syncthreads();
  for (int rr = 0; rr < BQ / 8; ++rr) {
    const int r = warp * (BQ / 8) + rr;
    float acc = 0.f;
    for (int d = lane; d < DH; d += 32) acc += do_s[r * LD + d] * k_s[r * LD + d];
    acc = warp_sum(acc);
    if (lane == 0) {
      d_s[r] = acc;
      if (q0 + r < P.t) P.dvec[(size_t)bh * P.t + q0 + r] = acc;
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = (P.t + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    __syncthreads();  // previous k/v/ds reads (and the D pass) are done
    load_tile<T, DH>(k_s, k + base, c0, P.t);
    load_tile<T, DH>(v_s, v + base, c0, P.t);
    __syncthreads();
    float s[4][4], dpd[4][4];
    two_products<DH>(q_s, k_s, do_s, v_s, s, dpd);
    grads_of_block<T>(P, bh, q0, c0, s, dpd, m_s, il_s, d_s, nullptr, ds_s);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rg = q0 + ty + 16 * i;
    if (rg >= P.t) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = base + (size_t)rg * DH + tx + 16 * j;
      dq[off] = from_f32<T>(acc[i][j] * P.scale);
      if (P.dq32 != nullptr) P.dq32[off] = acc[i][j] * P.scale;
    }
  }
}

// dk and dv for one 64-key tile; reads D from the dq kernel.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    attention_bwd_dkdv_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              T* __restrict__ dk, T* __restrict__ dv,
                              Params P) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + tile_floats<DH>();
  float* q_s = v_s + tile_floats<DH>();
  float* do_s = q_s + tile_floats<DH>();
  float* pd_s = do_s + tile_floats<DH>();
  float* ds_s = pd_s + BQ * SLD;
  float* m_s = ds_s + BQ * SLD;
  float* il_s = m_s + BQ;
  float* d_s = il_s + BQ;
  constexpr int LD = DH + 1;
  constexpr int DJ = DH / 16;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * BKV;
  const size_t base = (size_t)bh * P.t * DH;

  load_tile<T, DH>(k_s, k + base, c0, P.t);
  load_tile<T, DH>(v_s, v + base, c0, P.t);

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_tiles = (P.t + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // previous q/dO/pd/ds reads are done
    load_tile<T, DH>(q_s, q + base, q0, P.t);
    load_tile<T, DH>(do_s, dout + base, q0, P.t);
    load_row_stats(P, bh, q0, m_s, il_s, d_s, true);
    __syncthreads();
    float s[4][4], dpd[4][4];
    two_products<DH>(q_s, k_s, do_s, v_s, s, dpd);
    grads_of_block<T>(P, bh, q0, c0, s, dpd, m_s, il_s, d_s, pd_s, ds_s);
    __syncthreads();
    // key rows ty + 16i of the tile, head-dim columns tx + 16j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pd_s[r * SLD + ty + 16 * i];
        dsv[i] = ds_s[r * SLD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = do_s[r * LD + tx + 16 * j];
        qv[j] = q_s[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          adv[i][j] = fmaf(pv[i], dov[j], adv[i][j]);
          adk[i][j] = fmaf(dsv[i], qv[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cg = c0 + ty + 16 * i;
    if (cg >= P.t) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = base + (size_t)cg * DH + tx + 16 * j;
      dk[off] = from_f32<T>(adk[i][j] * P.scale);
      dv[off] = from_f32<T>(adv[i][j]);
      if (P.dk32 != nullptr) P.dk32[off] = adk[i][j] * P.scale;
      if (P.dv32 != nullptr) P.dv32[off] = adv[i][j];
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, int batch,
           int heads, const Params& P, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((P.t + BQ - 1) / BQ), (unsigned)(batch * heads));
  attention_bwd_dq_kernel<T, DH><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)o, (const T*)dout,
      (T*)dq, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<T, DH><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dk, (T*)dv,
      P);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const void* o, const void* dout, void* dq, void* dk,
                void* dv, int batch, int heads, const Params& P,
                cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------ bf16: mma.sync, registers-resident

constexpr int MT = 128;  // 4 warps of 16 rows

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t u32_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d = a (16x16 bf16, row) . b (16x8 bf16, col) + d, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) of a (t, DH) slab into a (64, DH + 8) shared tile
// with 16-byte copies, zeros past t.
template <int DH>
__device__ __forceinline__ void load_tile_mma(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              int r0, int t) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += MT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(&dst[r * LD + c]) = val;
  }
}

// A-operand fragments of rows r and r + 8 (this lane's group rows) of a
// (t, DH) slab, over the whole head dim; zeros past t.
template <int DH>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DH / 16][4],
                                             const __nv_bfloat16* src, int r,
                                             int t, int t4) {
  auto pair = [&](int row, int c) -> uint32_t {
    return row < t ? u32_at(src + (size_t)row * DH + c) : 0u;
  };
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    const int c = kd * 16 + 2 * t4;
    f[kd][0] = pair(r, c);
    f[kd][1] = pair(r + 8, c);
    f[kd][2] = pair(r, c + 8);
    f[kd][3] = pair(r + 8, c + 8);
  }
}

// acc[n] += A (16 x DH, fragments) . tile^T for the 8 tile rows of each
// n-tile: the B operand's pairs run along a tile row.
template <int DH, int NS>
__device__ __forceinline__ void mma_rows(float (&acc)[NS][4],
                                         const uint32_t (&a)[DH / 16][4],
                                         const __nv_bfloat16* tile, int g,
                                         int t4) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const __nv_bfloat16* tr = tile + (n * 8 + g) * LD + 2 * t4;
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd)
      mma_bf16(acc[n], a[kd], u32_at(tr + kd * 16), u32_at(tr + kd * 16 + 8));
  }
}

// acc[j] += C (16 x 64 accumulators of 8 n-tiles, rounded to bf16) .
// tile (64 x DH): the B operand's pairs run down a tile column.
template <int DH>
__device__ __forceinline__ void mma_cols(float (&acc)[DH / 8][4],
                                         const float (&c)[8][4],
                                         const __nv_bfloat16* tile, int g,
                                         int t4) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint32_t a[4] = {pack_bf16(c[2 * kb][0], c[2 * kb][1]),
                           pack_bf16(c[2 * kb][2], c[2 * kb][3]),
                           pack_bf16(c[2 * kb + 1][0], c[2 * kb + 1][1]),
                           pack_bf16(c[2 * kb + 1][2], c[2 * kb + 1][3])};
    const __nv_bfloat16* tb = tile + (kb * 16 + 2 * t4) * LD + g;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const __nv_bfloat16* tc = tb + j * 8;
      mma_bf16(acc[j], a, pack_bf16(tc[0], tc[LD]),
               pack_bf16(tc[8 * LD], tc[9 * LD]));
    }
  }
}

// dq for 64 query rows (warp w: rows 16w + g and + 8); writes D.
template <int DH>
__global__ void __launch_bounds__(MT)
    attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ o32,
                                const __nv_bfloat16* __restrict__ dout,
                                __nv_bfloat16* __restrict__ dq, Params P) {
  constexpr int LD = DH + 8, KD = DH / 16, ND = DH / 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BKV * LD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int t = P.t;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb =
      P.key_valid ? P.key_valid + (size_t)(bh / P.n_heads) * t : nullptr;
  const uint32_t seed_g = P.seed + (uint32_t)bh;

  uint32_t qf[KD][4], df[KD][4];
  load_a_frags<DH>(qf, q + base, r0, t, t4);
  load_a_frags<DH>(df, dout + base, r0, t, t4);
  float m_r[2], il_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    float acc = 0.f;
    m_r[h] = il_r[h] = 0.f;
    if (row < t) {
      const size_t off = base + (size_t)row * DH;
      for (int d = t4; d < DH; d += 4)
        acc += __bfloat162float(dout[off + d]) * o32[off + d];
      m_r[h] = P.stats[((size_t)bh * t + row) * 2];
      il_r[h] = 1.f / P.stats[((size_t)bh * t + row) * 2 + 1];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    d_r[h] = acc;
    if (t4 == 0 && row < t) P.dvec[(size_t)bh * t + row] = acc;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int n_tiles = (t + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_mma<DH>(k_s, k + base, c0, t);
    load_tile_mma<DH>(v_s, v + base, c0, t);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows<DH, 8>(s, qf, k_s, g, t4);
    mma_rows<DH, 8>(dp, df, v_s, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int c = c0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = c < t && (kvb == nullptr || kvb[c] != 0);
        const float p = expf((ok ? s[n][e] * P.scale : NEG) - m_r[h]) *
                        il_r[h];
        float dpv = dp[n][e];
        if (P.dropout) {
          const bool keep =
              hash_keep((uint32_t)(r0 + 8 * h) * (uint32_t)P.t_pad +
                            (uint32_t)c,
                        seed_g, P.threshold);
          dpv = keep ? dpv * P.inv_keep : 0.f;
        }
        s[n][e] = p * (dpv - d_r[h]);  // ds
      }
    mma_cols<DH>(acc, s, k_s, g, t4);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = base + (size_t)row * DH + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dq + off) =
          pack_bf16(acc[j][2 * h] * P.scale, acc[j][2 * h + 1] * P.scale);
      if (P.dq32 != nullptr) {
        P.dq32[off] = acc[j][2 * h] * P.scale;
        P.dq32[off + 1] = acc[j][2 * h + 1] * P.scale;
      }
    }
  }
}

// dk and dv for 64 keys (warp w: keys 16w + g and + 8), from S^T = K Q^T
// and dP^T = V dO^T; reads D from the dq kernel.
template <int DH>
__global__ void __launch_bounds__(MT)
    attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, Params P) {
  constexpr int LD = DH + 8, KD = DH / 16, ND = DH / 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BQ * LD];
  __shared__ float m_s[BQ], il_s[BQ], d_s[BQ];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int t = P.t;
  const int kr0 = blockIdx.x * BKV + warp * 16 + g;
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb =
      P.key_valid ? P.key_valid + (size_t)(bh / P.n_heads) * t : nullptr;
  const uint32_t seed_g = P.seed + (uint32_t)bh;

  uint32_t kf[KD][4], vf[KD][4];
  load_a_frags<DH>(kf, k + base, kr0, t, t4);
  load_a_frags<DH>(vf, v + base, kr0, t, t4);
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = kr0 + 8 * h;
    key_ok[h] = kr < t && (kvb == nullptr || kvb[kr] != 0);
  }
  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  const int n_tiles = (t + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile_mma<DH>(q_s, q + base, q0, t);
    load_tile_mma<DH>(do_s, dout + base, q0, t);
    load_row_stats(P, bh, q0, m_s, il_s, d_s, true);
    __syncthreads();
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    mma_rows<DH, 8>(st, kf, q_s, g, t4);
    mma_rows<DH, 8>(dpt, vf, do_s, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int ql = n * 8 + 2 * t4 + (e & 1);  // query within the tile
        const float p =
            expf((key_ok[h] ? st[n][e] * P.scale : NEG) - m_s[ql]) * il_s[ql];
        float pd = p, dpv = dpt[n][e];
        if (P.dropout) {
          const bool keep = hash_keep(
              (uint32_t)(q0 + ql) * (uint32_t)P.t_pad +
                  (uint32_t)(kr0 + 8 * h),
              seed_g, P.threshold);
          pd = keep ? p * P.inv_keep : 0.f;
          dpv = keep ? dpv * P.inv_keep : 0.f;
        }
        st[n][e] = pd;
        dpt[n][e] = p * (dpv - d_s[ql]);  // ds^T
      }
    mma_cols<DH>(adv, st, do_s, g, t4);
    mma_cols<DH>(adk, dpt, q_s, g, t4);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = kr0 + 8 * h;
    if (kr >= t) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = base + (size_t)kr * DH + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(adk[j][2 * h] * P.scale, adk[j][2 * h + 1] * P.scale);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(adv[j][2 * h], adv[j][2 * h + 1]);
      if (P.dk32 != nullptr) {
        P.dk32[off] = adk[j][2 * h] * P.scale;
        P.dk32[off + 1] = adk[j][2 * h + 1] * P.scale;
      }
      if (P.dv32 != nullptr) {
        P.dv32[off] = adv[j][2 * h];
        P.dv32[off + 1] = adv[j][2 * h + 1];
      }
    }
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, int batch,
               int heads, const Params& P, cudaStream_t stream) {
  const dim3 grid((unsigned)((P.t + BQ - 1) / BQ), (unsigned)(batch * heads));
  attention_bwd_dq_mma_kernel<DH><<<grid, MT, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)o, (const __nv_bfloat16*)dout,
      (__nv_bfloat16*)dq, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_mma_kernel<DH><<<grid, MT, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, P);
  return (int)cudaGetLastError();
}

// The whole backward on one stream: a8t_attention_bwd's arguments, plus
// optional f32 copies of dq, dk and dv (dq32, dk32, dv32; null = none).
int run_bwd(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* key_valid, const void* stats,
            void* dvec, void* dq, void* dk, void* dv, void* dq32, void* dk32,
            void* dv32, int batch, int heads, int t, int dh, int dtype,
            float scale, float inv_keep, uint32_t threshold, uint32_t seed,
            int dropout, cudaStream_t s) {
  if (batch <= 0 || heads <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  Params P;
  P.key_valid = (const uint8_t*)key_valid;
  P.stats = (const float*)stats;
  P.dvec = (float*)dvec;
  P.dq32 = (float*)dq32;
  P.dk32 = (float*)dk32;
  P.dv32 = (float*)dv32;
  P.n_heads = heads;
  P.t = t;
  P.t_pad = (t + 127) / 128 * 128;
  P.scale = scale;
  P.inv_keep = inv_keep;
  P.threshold = threshold;
  P.seed = seed;
  P.dropout = dropout;
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, o, dout, dq, dk, dv, batch, heads,
                              P, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool aligned16 = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                           (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk |
                           (uintptr_t)dv) % 16) == 0;
  if (aligned16 && dh == 16)
    return launch_mma<16>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
  if (aligned16 && dh == 32)
    return launch_mma<32>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
  if (aligned16 && dh == 64)
    return launch_mma<64>(q, k, v, o, dout, dq, dk, dv, batch, heads, P, s);
  return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, dout, dq, dk, dv, batch,
                                    heads, P, s);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, T, dh) contiguous; o: the forward
// output in f32 (the output itself for f32 inputs, the forward's o32
// copy for bf16); key_valid: (B, T) uint8 or NULL; stats: the forward's
// (B*H*T, 2) f32 row max and row sum; dvec: (B*H*T) f32 scratch.
// dtype: 0 = float32, 1 = bfloat16. inv_keep = 1 / (1 - rate); threshold
// and seed as in the forward (dropout = 0 skips the hash). Returns the
// cudaError_t of the launches.
extern "C" int a8t_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* key_valid, const void* stats,
                                 void* dvec, void* dq, void* dk, void* dv,
                                 int batch, int heads, int t, int dh,
                                 int dtype, float scale, float inv_keep,
                                 uint32_t threshold, uint32_t seed,
                                 int dropout, void* stream) {
  return run_bwd(q, k, v, o, dout, key_valid, stats, dvec, dq, dk, dv,
                 nullptr, nullptr, nullptr, batch, heads, t, dh, dtype, scale,
                 inv_keep, threshold, seed, dropout, (cudaStream_t)stream);
}
