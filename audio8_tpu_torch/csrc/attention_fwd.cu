// Attention core, forward: softmax(q k^T * scale, key mask) [hash dropout] v.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_kernel.py:
// _fwd_kernel (built from _probs and _hash_keep, driven by _attn_fwd /
// attention_core). Same function, term by term:
//
//   * scores in f32; a key column c is invalid when c >= T or
//     key_valid[b, c] == 0, and its score is REPLACED by -1e9 before the
//     row max, as in _probs;
//   * the TPU kernel pads T to T_pad = round_up(T, 128) and softmaxes over
//     all T_pad columns, so a row whose keys are all invalid gives a
//     uniform 1/T_pad. Here only ceil(T/64) key tiles are visited and the
//     missing columns are added to the row sum at the end as
//     (T_pad - visited) * exp(-1e9 - m): zero for a normal row, and the
//     same 1/T_pad weights for an all-invalid row (the zero-length filler
//     rows of a serving batch);
//   * dropout keeps column c of query row r iff
//     murmur(r * T_pad + c ^ (seed + b*H + h)) >= threshold, in uint32
//     arithmetic, exactly as _hash_keep; it applies to the NORMALISED
//     probabilities, so the full un-dropped row sum l is kept and the
//     output is sum(keep * e * v) / (l * (1 - rate));
//   * with bf16 inputs the TPU kernel rounds the probabilities to bf16
//     before P.V; this kernel rounds the un-normalised e = exp(s - m) to
//     bf16 instead (a different rounding point, covered by the stated
//     bf16 tolerance).
//
// With xla = 1 it computes the JAX package's XLA attention instead
// (audio8_tpu/nn/transformer.py:MultiHeadAttention, the path of
// fused_attention=None): padded columns (c >= T) are out of the softmax
// (-inf, no missing term), so a row with no valid key is uniform over its
// T keys; dropout keeps (b, h, r, c) iff murmur((((b*H + h)*T + r)*T + c)
// mod 2^32 ^ seed) >= threshold, one seed per call, as
// nn/dropout.py:_hash_keep_mask over the (B, H, T, T) probabilities; and
// with round_logits the scaled logits are rounded to bf16 before the
// softmax (bf16_softmax under bf16 compute; JAX then runs the softmax in
// bf16, this kernel in f32).
//
// What bounds it on H100: at T' ~ 1500 frames and dh = 64 the work is the
// score and P.V products (4*T^2*dh FLOP per head) with a T^2 probability
// matrix that must never reach device memory (the plain version writes
// and re-reads it several times). The design is FlashAttention-2 shaped:
// one CTA per (batch*head, 64-query tile), a loop over 64-key tiles with
// the online max and sum in f32, and the probabilities never leaving the
// SM. Two variants, chosen at launch:
//   * bf16 with 16-byte aligned tensors: both products on the tensor
//     cores (mma.sync m16n8k16, f32 accumulation), 4 warps of 16 query
//     rows each, scores, probabilities and the output accumulator held in
//     registers (the FlashAttention-2 register layout);
//   * otherwise (every f32 call): the products on the CUDA cores (SIMT,
//     f32 accumulation), 256 threads with 4x4 scores each and the
//     probabilities in shared memory. f32 stays off the tensor cores so
//     that its sums are full f32 (TF32 would not be).
// wgmma/TMA pipelining is later work. The head dim is a template
// parameter (16, 32, 64, 128).
//
// When the caller needs the gradient it passes `stats`, (B*H*T, 2) f32,
// and each kernel writes every real row's softmax statistics there: the
// row max m and the full (un-dropped, T_pad-wide) row sum l, so that the
// backward kernel (attention_bwd.cu) recomputes p = exp(s - m) / l
// without a second pass over the keys. Both are kept apart because
// m + log(l) would lose log(T_pad) against m = -1e9 in f32. For bf16
// inputs it may also pass `o32`, (B, H, T, dh) f32, for the output before
// its rounding to bf16: the backward takes D = rowsum(dO * o) from it, as
// the TPU kernel takes D from f32 probabilities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BKV = 64;   // key columns per tile
constexpr int NT = 256;   // threads per CTA (8 warps)
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

// Rounds a probability to the P.V operand precision of the input dtype.
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

// The scaled logit; with round_logits (the "xla" semantics under
// bf16_softmax) rounded to bf16 as JAX's bf16 einsum output is.
__device__ __forceinline__ float logit(float s, float scale, int round_logits) {
  const float v = s * scale;
  return round_logits ? __bfloat162float(__float2bfloat16(v)) : v;
}

// Score of a key column that is not attended: -1e9 for an invalid key,
// and for a padded column (c >= t) under the "kernel" semantics; -inf
// (out of the softmax) for a padded column under "xla".
__device__ __forceinline__ float masked_score(int c, int t, int xla) {
  return (xla && c >= t) ? -INFINITY : NEG;
}

// First hash index of query row `row`: row * T_pad ("kernel", the TPU
// kernel's per-head mask) or the flat (B, H, T, T) index of (bh, row, 0)
// ("xla", nn/dropout.py's _hash_keep_mask), mod 2^32.
__device__ __forceinline__ uint32_t drop_row(int xla, int bh, int row, int t,
                                             int t_pad) {
  return xla ? ((uint32_t)bh * (uint32_t)t + (uint32_t)row) * (uint32_t)t
             : (uint32_t)row * (uint32_t)t_pad;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1)       // q tile
         + BKV * (DH + 1)    // k tile
         + BKV * DH          // v tile
         + BQ * (BKV + 1)    // scores / probabilities
         + 3 * BQ;           // row max, row sum, rescale factor
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_valid,
                         T* __restrict__ o, float* __restrict__ stats,
                         float* __restrict__ o32, int n_heads, int t,
                         int t_pad,
                         float scale, float inv_keep, uint32_t threshold,
                         uint32_t seed, int dropout, int xla,
                         int round_logits) {
  constexpr int QLD = DH + 1;
  constexpr int KLD = DH + 1;
  constexpr int SLD = BKV + 1;
  constexpr int DJ = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QLD;
  float* v_s = k_s + BKV * KLD;
  float* s_s = v_s + BKV * DH;
  float* m_s = s_s + BQ * SLD;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * t * DH;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const uint8_t* kvb = key_valid ? key_valid + (size_t)b * t : nullptr;
  const uint32_t seed_g = xla ? seed : seed + (uint32_t)bh;
  const T type_tag{};

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    q_s[r * QLD + d] = (q0 + r < t) ? to_f32(qb[(size_t)(q0 + r) * DH + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = (t + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    __syncthreads();  // the previous tile's k/v/p reads are done
    for (int idx = tid; idx < BKV * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH;
      const bool in = c0 + r < t;
      const size_t off = (size_t)(c0 + r) * DH + d;
      k_s[r * KLD + d] = in ? to_f32(kb[off]) : 0.f;
      v_s[r * DH + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = k_s[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      const bool ok = c < t && (kvb == nullptr || kvb[c] != 0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s_s[(ty + 16 * i) * SLD + tx + 16 * j] =
            ok ? logit(s[i][j], scale, round_logits) : masked_score(c, t, xla);
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, a lane two columns
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = s_s + r * SLD;
      const float v0 = row[lane], v1 = row[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(v0, v1)));
      float e0 = expf(v0 - m_new), e1 = expf(v1 - m_new);
      const float sum = warp_sum(e0 + e1);
      if (dropout) {
        const uint32_t rowbase = drop_row(xla, bh, q0 + r, t, t_pad);
        if (!hash_keep(rowbase + (uint32_t)(c0 + lane), seed_g, threshold))
          e0 = 0.f;
        if (!hash_keep(rowbase + (uint32_t)(c0 + lane + 32), seed_g, threshold))
          e1 = 0.f;
      }
      row[lane] = operand_round(e0, type_tag);
      row[lane + 32] = operand_round(e1, type_tag);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V for rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  // columns [n_tiles * BKV, t_pad) are -1e9 in the TPU kernel's softmax
  // and out of the XLA attention's
  const float missing = xla ? 0.f : (float)(t_pad - n_tiles * BKV);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int rg = q0 + r;
    if (rg >= t) continue;
    const float l = l_s[r] + missing * expf(NEG - m_s[r]);
    const float inv = inv_keep / l;
    if (stats != nullptr && tx == 0) {
      stats[((size_t)bh * t + rg) * 2] = m_s[r];
      stats[((size_t)bh * t + rg) * 2 + 1] = l;
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = base + (size_t)rg * DH + tx + 16 * j;
      o[off] = from_f32<T>(acc[i][j] * inv);
      if (o32 != nullptr) o32[off] = acc[i][j] * inv;
    }
  }
}

// ------------------------------------ bf16: mma.sync, registers-resident

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

// d = a (16x16 bf16, row) . b (16x8 bf16, col) + d, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// FlashAttention-2 layout: 4 warps, each owning 16 query rows. A lane
// (group g = lane / 4, t4 = lane % 4) holds rows g and g + 8 of every
// m16n8 accumulator, columns 2*t4 and 2*t4 + 1. The S accumulator of two
// adjacent 8-key tiles IS the A operand of P.V for those 16 keys, so the
// probabilities never leave registers; only the k/v tiles go through
// shared memory.
template <int DH>
__global__ void __launch_bounds__(128)
    attention_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const uint8_t* __restrict__ key_valid,
                                  __nv_bfloat16* __restrict__ o,
                                  float* __restrict__ stats,
                                  float* __restrict__ o32, int n_heads,
                                  int t, int t_pad, float scale,
                                  float inv_keep, uint32_t threshold,
                                  uint32_t seed, int dropout, int xla,
                                  int round_logits) {
  constexpr int LD = DH + 8;  // bf16 row pitch of the k/v tiles
  constexpr int NS = BKV / 8;  // 8-key score tiles per key tile
  constexpr int ND = DH / 8;   // 8-wide output tiles
  constexpr int KD = DH / 16;  // 16-deep steps over the head dim
  __shared__ __align__(16) __nv_bfloat16 k_s[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BKV * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // rows r0 and r0 + 8
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb = key_valid ? key_valid + (size_t)b * t : nullptr;
  const uint32_t seed_g = xla ? seed : seed + (uint32_t)bh;

  auto q2 = [&](int r, int c) -> uint32_t {
    return r < t ? *reinterpret_cast<const uint32_t*>(q + base +
                                                      (size_t)r * DH + c)
                 : 0u;
  };
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * t4;
    qf[kd][0] = q2(r0, c);
    qf[kd][1] = q2(r0 + 8, c);
    qf[kd][2] = q2(r0, c + 8);
    qf[kd][3] = q2(r0 + 8, c + 8);
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  const int n_tiles = (t + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous k/v tile
    constexpr int CH = DH / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < BKV * CH; idx += 128) {
      const int r = idx / CH, c = (idx % CH) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (c0 + r < t) {
        const size_t off = base + (size_t)(c0 + r) * DH + c;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kv4;
      *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T: score tile n covers keys c0 + 8n .. c0 + 8n + 7
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const __nv_bfloat16* kr = &k_s[(n * 8 + g) * LD + 2 * t4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma_bf16(s[n], qf[kd],
                 *reinterpret_cast<const uint32_t*>(kr + kd * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8));
    }

    // scale, key mask, online softmax for rows r0 (e = 0, 1), r0+8 (2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = c < t && (kvb == nullptr || kvb[c] != 0);
        s[n][e] = ok ? logit(s[n][e], scale, round_logits)
                     : masked_score(c, t, xla);
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_r[e / 2]);
        sum[e / 2] += s[n][e];
        if (dropout) {
          const uint32_t c = (uint32_t)(c0 + n * 8 + 2 * t4 + (e & 1));
          if (!hash_keep(drop_row(xla, bh, r0 + (e / 2) * 8, t, t_pad) + c,
                         seed_g, threshold))
            s[n][e] = 0.f;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P . V, 16 keys per step; P (bf16) straight from s
#pragma unroll
    for (int kb = 0; kb < BKV / 16; ++kb) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                              pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                              pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                              pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
      const __nv_bfloat16* vr = &v_s[(kb * 16 + 2 * t4) * LD + g];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        mma_bf16(acc[j], pa, pack_bf16(vc[0], vc[LD]),
                 pack_bf16(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

  // columns [n_tiles * BKV, t_pad) are -1e9 in the TPU kernel's softmax
  // and out of the XLA attention's
  const float missing = xla ? 0.f : (float)(t_pad - n_tiles * BKV);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    if (r >= t) continue;
    const float l = l_r[h] + missing * expf(NEG - m_r[h]);
    const float inv = inv_keep / l;
    if (stats != nullptr && t4 == 0) {
      stats[((size_t)bh * t + r) * 2] = m_r[h];
      stats[((size_t)bh * t + r) * 2 + 1] = l;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = base + (size_t)r * DH + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(o + off) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      if (o32 != nullptr) {
        o32[off] = acc[j][2 * h] * inv;
        o32[off + 1] = acc[j][2 * h + 1] * inv;
      }
    }
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* kv,
               void* o, float* stats, float* o32, int batch, int heads, int t, float scale,
               float inv_keep, uint32_t threshold, uint32_t seed, int dropout,
               int xla, int round_logits, cudaStream_t stream) {
  const int t_pad = (t + 127) / 128 * 128;
  const dim3 grid((unsigned)((t + BQ - 1) / BQ), (unsigned)(batch * heads));
  attention_fwd_bf16_mma_kernel<DH><<<grid, 128, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)kv, (__nv_bfloat16*)o, stats,
      o32, heads,
      t, t_pad, scale, inv_keep, threshold, seed, dropout, xla, round_logits);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kv,
           void* o, float* stats, float* o32, int batch, int heads, int t, float scale, float inv_keep,
           uint32_t threshold, uint32_t seed, int dropout, int xla,
           int round_logits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int t_pad = (t + 127) / 128 * 128;
  const dim3 grid((unsigned)((t + BQ - 1) / BQ), (unsigned)(batch * heads));
  attention_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kv, (T*)o, stats,
      o32, heads,
      t, t_pad, scale, inv_keep, threshold, seed, dropout, xla, round_logits);
  return (int)cudaGetLastError();
}

int dispatch_mma(int dh, const void* q, const void* k, const void* v,
                 const void* kv, void* o, float* stats, float* o32, int batch, int heads, int t,
                 float scale, float inv_keep, uint32_t threshold,
                 uint32_t seed, int dropout, int xla, int round_logits,
                 cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch_mma<16>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                            threshold, seed, dropout, xla, round_logits,
                            stream);
    case 32:
      return launch_mma<32>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                            threshold, seed, dropout, xla, round_logits,
                            stream);
    case 64:
      return launch_mma<64>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                            threshold, seed, dropout, xla, round_logits,
                            stream);
    case 128:
      return launch_mma<128>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                             threshold, seed, dropout, xla, round_logits,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const void* kv, void* o, float* stats, float* o32, int batch, int heads, int t,
                float scale, float inv_keep, uint32_t threshold, uint32_t seed,
                int dropout, int xla, int round_logits,
                cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                           threshold, seed, dropout, xla, round_logits, stream);
    case 32:
      return launch<T, 32>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                           threshold, seed, dropout, xla, round_logits, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                           threshold, seed, dropout, xla, round_logits, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv, o, stats, o32, batch, heads, t, scale, inv_keep,
                            threshold, seed, dropout, xla, round_logits,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The whole forward on one stream; a8t_attention_fwd's arguments.
int run_fwd(const void* q, const void* k, const void* v,
            const void* key_valid, void* o, void* stats, void* o32,
            int batch, int heads, int t, int dh, int dtype, float scale,
            float inv_keep, uint32_t threshold, uint32_t seed, int dropout,
            int xla, int round_logits, cudaStream_t s) {
  if (batch <= 0 || heads <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, key_valid, o, (float*)stats,
                              (float*)o32, batch, heads, t,
                              scale, inv_keep, threshold, seed, dropout, xla,
                              round_logits, s);
  const bool aligned16 =
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16) == 0;
  if (dtype == 1 && aligned16)
    return dispatch_mma(dh, q, k, v, key_valid, o, (float*)stats,
                        (float*)o32, batch, heads, t, scale,
                        inv_keep, threshold, seed, dropout, xla, round_logits,
                        s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, key_valid, o,
                                      (float*)stats, (float*)o32, batch,
                                      heads,
                                      t, scale, inv_keep, threshold, seed,
                                      dropout, xla, round_logits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (B, H, T, dh) contiguous; key_valid: (B, T) uint8 or NULL;
// stats: (B*H*T, 2) f32 row max and row sum, or NULL when not needed;
// o32: (B, H, T, dh) f32 copy of the output before rounding, or NULL.
// dtype: 0 = float32, 1 = bfloat16. inv_keep = 1 / (1 - rate); threshold
// and seed are the uint32 dropout parameters (dropout = 0 skips the hash).
// xla = 0: the TPU kernel's semantics, 1: the XLA attention's;
// round_logits = 1 rounds the scaled logits to bf16 (xla under
// bf16_softmax). Returns the cudaError_t of the launch.
extern "C" int a8t_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* key_valid, void* o,
                                 void* stats, void* o32, int batch,
                                 int heads, int t, int dh, int dtype,
                                 float scale, float inv_keep,
                                 uint32_t threshold, uint32_t seed,
                                 int dropout, int xla, int round_logits,
                                 void* stream) {
  return run_fwd(q, k, v, key_valid, o, stats, o32, batch, heads, t, dh,
                 dtype, scale, inv_keep, threshold, seed, dropout, xla,
                 round_logits, (cudaStream_t)stream);
}
